"""The port's first slice end to end: the LSTM text classifier built in
paddle_tpu, its parameters carried over (tar and numpy), and
paddle_tpu_torch.infer on the CPU against paddle_tpu.infer on the same
ragged batches.

Tolerance on the logits: rtol 1e-4, atol 1e-5 — float32 on both sides,
through bucket padding, two recurrences and a max pooling whose products
sum in another order.
"""

import io
import json
import os
import subprocess
import sys
import tarfile

import jax
import numpy as np
import pytest
import torch

import paddle_tpu as pj
from paddle_tpu.core.layer import layer_name_scope as jax_name_scope
from paddle_tpu.models.text import lstm_text_classification as jax_lstm_cls

import paddle_tpu_torch as pt
from paddle_tpu_torch.core.layer import layer_name_scope as torch_name_scope
from paddle_tpu_torch.core.parameters import Parameters as TParameters
from paddle_tpu_torch.models.text import \
    lstm_text_classification as torch_lstm_cls
from paddle_tpu_torch.utils.error import Error

DICT, EMB, HID = 50, 16, 32
LOGIT_TOL = dict(rtol=1e-4, atol=1e-5)


def _one_layer_model(mod, reverse, act):
    """emb -> simple_lstm -> max pool -> fc, in either package."""
    words = mod.layer.data(name="words",
                           type=mod.data_type.integer_value_sequence(DICT))
    emb = mod.layer.embedding(input=words, size=EMB)
    lstm = mod.networks.simple_lstm(input=emb, size=HID, name="rnn",
                                    reverse=reverse, act=act)
    pooled = mod.layer.pooling(input=lstm, pooling_type=mod.pooling.Max())
    return mod.layer.fc(input=pooled, size=3, act=mod.activation.Linear(),
                        name="output")


def _build(variant):
    """(jax output layer, port output layer) with matching layer names."""
    if variant == "classifier":
        with jax_name_scope():
            jout = jax_lstm_cls(dict_dim=DICT, emb_dim=EMB, hidden=HID)[2]
        with torch_name_scope():
            tout = torch_lstm_cls(dict_dim=DICT, emb_dim=EMB, hidden=HID)[2]
        return jout, tout
    reverse = variant == "reverse"
    act = "relu" if variant == "relu_cell" else None
    with jax_name_scope():
        jout = _one_layer_model(pj, reverse, act)
    with torch_name_scope():
        tout = _one_layer_model(pt, reverse, act)
    return jout, tout


def _numpy_params(topology, seed):
    r = np.random.RandomState(seed)
    return {name: (r.randn(*spec.shape) * 0.3).astype(np.float32)
            for name, spec in sorted(topology.param_specs().items())}


def _batches(seed):
    r = np.random.RandomState(seed)
    out = []
    for B in (7, 1, 12):
        lens = r.randint(1, 12, size=B)
        out.append([(r.randint(0, DICT, size=n).tolist(),) for n in lens])
    return out


def test_parameters_carry_over_by_tar_and_numpy():
    with jax_name_scope():
        jcost = jax_lstm_cls(dict_dim=DICT, emb_dim=EMB, hidden=HID)[3]
    with torch_name_scope():
        tcost = torch_lstm_cls(dict_dim=DICT, emb_dim=EMB, hidden=HID)[3]
    jp = pj.parameters.create(jcost, rng=jax.random.PRNGKey(5))
    buf = io.BytesIO()
    jp.to_tar(buf)
    buf.seek(0)
    from_tar = TParameters.from_tar(buf)
    from_np = TParameters.from_numpy(
        {k: np.asarray(v) for k, v in jp.as_dict().items()})
    want = {n: tuple(jp.get_shape(n)) for n in jp.names()}
    built = {n: tuple(s.shape)
             for n, s in pt.Topology(tcost).param_specs().items()}
    assert built == want
    for p in (from_tar, from_np):
        assert {n: p.get_shape(n) for n in p.names()} == want
        for n in p.names():
            np.testing.assert_array_equal(p.get(n).numpy(), jp.get(n))
    # the tar's model.json rebuilds the same topology in the port
    buf.seek(0)
    with tarfile.open(fileobj=buf) as tar:
        cfg = json.loads(tar.extractfile("model.json").read())
    rebuilt = pt.topology_from_config(cfg)
    assert {n: tuple(s.shape) for n, s in rebuilt.param_specs().items()} \
        == want


def test_port_tar_loads_in_jax_package():
    with torch_name_scope():
        tcost = torch_lstm_cls(dict_dim=DICT, emb_dim=EMB, hidden=HID)[3]
    topo = pt.Topology(tcost)
    d = _numpy_params(topo, 2)
    tp = TParameters.from_numpy(d, topology=topo)
    buf = io.BytesIO()
    tp.to_tar(buf)
    buf.seek(0)
    jp = pj.Parameters.from_tar(buf)
    assert jp.names() == sorted(d)
    for n, v in d.items():
        np.testing.assert_array_equal(jp.get(n), v)
    buf.seek(0)
    with tarfile.open(fileobj=buf) as tar:
        cfg = json.loads(tar.extractfile("model.json").read())
    from paddle_tpu.core.topology import topology_from_config
    assert sorted(topology_from_config(cfg).param_specs()) == sorted(d)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int8])
def test_tar_codec_round_trips_dtypes(dtype):
    r = np.random.RandomState(0)
    t = torch.from_numpy((r.randn(3, 5) * 50).astype(np.float32)).to(dtype)
    p = TParameters()
    p["w"] = t
    p["__hostrows__/skip"] = torch.zeros(2)
    buf = io.BytesIO()
    p.to_tar(buf)
    buf.seek(0)
    q = TParameters.from_tar(buf)
    assert q.names() == ["w"]
    assert q.get("w").dtype == dtype
    assert torch.equal(q.get("w"), t)


@pytest.mark.parametrize("variant", ["classifier", "reverse", "relu_cell"])
def test_infer_matches_jax_package(variant):
    jout, tout = _build(variant)
    topo = pt.Topology(tout)
    d = _numpy_params(topo, 11)
    assert sorted(d) == sorted(pj.Topology(jout).param_specs())
    jp = pj.Parameters.from_dict(d)
    tp = TParameters.from_numpy(d)
    inf = pt.Inference(tout, tp, device="cpu")
    for batch in _batches(3):
        want = pj.infer(output_layer=jout, parameters=jp, input=batch)
        got = inf.infer(batch)
        assert got.shape == want.shape and np.isfinite(got).all()
        np.testing.assert_allclose(got, want, **LOGIT_TOL)
    one = pt.infer(output_layer=tout, parameters=tp, input=batch,
                   device="cpu")
    np.testing.assert_array_equal(one, got)


def test_cost_matches_jax_package():
    """The classifier's cost layer (not reached by infer) on a labelled
    ragged batch, through each package's own feeder and forward."""
    from paddle_tpu.trainer.feeder import DataFeeder as JFeeder
    from paddle_tpu_torch.trainer.feeder import DataFeeder as TFeeder

    with jax_name_scope():
        jcost = jax_lstm_cls(dict_dim=DICT, emb_dim=EMB, hidden=HID)[3]
    with torch_name_scope():
        tcost = torch_lstm_cls(dict_dim=DICT, emb_dim=EMB, hidden=HID)[3]
    jtopo, ttopo = pj.Topology(jcost), pt.Topology(tcost)
    d = _numpy_params(ttopo, 4)
    r = np.random.RandomState(8)
    batch = [(w, int(r.randint(0, 2))) for (w,) in _batches(5)[2]]
    want = jtopo.forward({k: jax.numpy.asarray(v) for k, v in d.items()},
                         JFeeder(jtopo.data_type())(batch))["cost"]
    feeds = {k: a.to("cpu") for k, a in
             TFeeder(ttopo.data_type())(batch).items()}
    with torch.inference_mode():
        got = ttopo.forward({k: torch.from_numpy(v) for k, v in d.items()},
                            feeds)["cost"]
    assert got.value.shape == (len(batch), 1)
    np.testing.assert_allclose(got.value.numpy(), np.asarray(want.value),
                               **LOGIT_TOL)


def test_classification_cost_refuses_softmax_input():
    """A softmax input no longer is refused: it builds the probability-form
    cost (multi-class-cross-entropy), as the JAX package does, and the
    cost matches the JAX package's."""
    def model(mod):
        words = mod.layer.data(
            name="words", type=mod.data_type.integer_value_sequence(DICT))
        lab = mod.layer.data(name="label",
                             type=mod.data_type.integer_value(3))
        pooled = mod.layer.pooling(input=mod.layer.embedding(input=words,
                                                             size=EMB),
                                   pooling_type=mod.pooling.Max())
        out = mod.layer.fc(input=pooled, size=3,
                           act=mod.activation.Softmax())
        return mod.layer.classification_cost(input=out, label=lab)

    with jax_name_scope():
        jcost = model(pj)
    with torch_name_scope():
        tcost = model(pt)
    assert tcost.type == jcost.type == "multi-class-cross-entropy"
    jtopo, ttopo = pj.Topology(jcost), pt.Topology(tcost)
    d = _numpy_params(ttopo, 9)
    r = np.random.RandomState(2)
    batch = [(w, int(r.randint(0, 3))) for (w,) in _batches(4)[0]]
    from paddle_tpu.trainer.feeder import DataFeeder as JFeeder
    from paddle_tpu_torch.trainer.feeder import DataFeeder as TFeeder
    want = jtopo.forward({k: jax.numpy.asarray(v) for k, v in d.items()},
                         JFeeder(jtopo.data_type())(batch))[jcost.name]
    feeds = {k: a.to("cpu") for k, a in
             TFeeder(ttopo.data_type())(batch).items()}
    with torch.inference_mode():
        got = ttopo.forward({k: torch.from_numpy(v) for k, v in d.items()},
                            feeds)[tcost.name]
    np.testing.assert_allclose(got.value.numpy(), np.asarray(want.value),
                               **LOGIT_TOL)


def test_infer_honors_bucket_rounding_flag(monkeypatch):
    """With the bucket_rounding flag set in both packages, the port's
    Inference pads T as the JAX feeder does, and the logits stay those of
    the JAX package."""
    from paddle_tpu.trainer.feeder import DataFeeder as JFeeder
    from paddle_tpu.trainer.feeder import resolve_pack_flags as jresolve
    from paddle_tpu.utils.flags import FLAGS as JFLAGS
    from paddle_tpu_torch import inference as tinference
    from paddle_tpu_torch.utils.flags import FLAGS as TFLAGS

    jout, tout = _build("classifier")
    d = _numpy_params(pt.Topology(tout), 11)
    inf = pt.Inference(tout, TParameters.from_numpy(d), device="cpu")
    jp = pj.Parameters.from_dict(d)
    batch = _batches(3)[0]                       # longest row: 11 steps
    default = inf.infer(batch)

    seen = []
    real_feeder = tinference.DataFeeder

    class Spy(real_feeder):
        def __call__(self, rows):
            feeds = super().__call__(rows)
            seen.append(feeds["words"].value.shape[1])
            return feeds

    monkeypatch.setattr(tinference, "DataFeeder", Spy)
    for flags in (JFLAGS, TFLAGS):
        monkeypatch.setitem(flags._values, "bucket_rounding", 5)
    got = inf.infer(batch)
    want_T = JFeeder(pj.Topology(jout).data_type(),
                     bucket_rounding=jresolve()[2])(batch)["words"] \
        .value.shape[1]
    assert seen == [want_T] == [15]
    np.testing.assert_allclose(got, default, **LOGIT_TOL)
    np.testing.assert_allclose(
        got, pj.infer(output_layer=jout, parameters=jp, input=batch),
        **LOGIT_TOL)


def test_infer_defaults_to_cuda_and_refuses_without_it():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with torch_name_scope():
        tout = torch_lstm_cls(dict_dim=DICT, emb_dim=EMB, hidden=HID)[2]
    tp = TParameters.from_numpy(_numpy_params(pt.Topology(tout), 0))
    with pytest.raises(Error, match="device='cpu'"):
        pt.infer(output_layer=tout, parameters=tp, input=[([1, 2],)])


def test_forward_refuses_training():
    """Training forwards run (tests/test_torch_train.py); one with a
    dropout layer and no generator to draw from is refused."""
    with torch_name_scope():
        words = pt.layer.data(name="words",
                              type=pt.data_type.integer_value_sequence(DICT))
        pooled = pt.layer.pooling(
            input=pt.layer.embedding(input=words, size=EMB),
            pooling_type=pt.pooling.Max())
        tout = pt.layer.fc(input=pooled, size=3,
                           layer_attr=pt.attr.ExtraAttr(drop_rate=0.5))
    topo = pt.Topology(tout)
    params = {k: torch.from_numpy(v)
              for k, v in _numpy_params(topo, 0).items()}
    feeds = {"words": (torch.tensor([[1, 2]], dtype=torch.int32),
                       torch.ones(1, 2))}
    topo.forward(params, feeds)                      # inference: no draw
    with pytest.raises(Error, match="torch.Generator"):
        topo.forward(params, feeds, training=True)


def test_import_leaves_out_jax_and_paddle_tpu():
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = ("import sys, paddle_tpu_torch, paddle_tpu_torch.models.text, "
            "paddle_tpu_torch.layers.recurrent_group, "
            "paddle_tpu_torch.networks, paddle_tpu_torch.kernels.gru, "
            "paddle_tpu_torch.kernels.lstm, paddle_tpu_torch.optimizer, "
            "paddle_tpu_torch.trainer.trainer, paddle_tpu_torch.evaluator, "
            "paddle_tpu_torch.reader.decorator, paddle_tpu_torch.initializer, "
            "paddle_tpu_torch.dataset.synthetic, "
            "paddle_tpu_torch.layers.crf_ctc, paddle_tpu_torch.kernels.crf, "
            "paddle_tpu_torch.kernels.ctc, "
            "paddle_tpu_torch.kernels.vocab_xent, "
            "paddle_tpu_torch.kernels.pool, paddle_tpu_torch.sparse_grad, "
            "paddle_tpu_torch.step_decode, paddle_tpu_torch.io.merged_model, "
            "paddle_tpu_torch.layers.misc, paddle_tpu_torch.layers.attention, "
            "paddle_tpu_torch.layers.math_ops, "
            "paddle_tpu_torch.parallel.ring_attention, "
            "paddle_tpu_torch.trainer.feeder, paddle_tpu_torch.data_type, "
            "paddle_tpu_torch.quant, paddle_tpu_torch.inference; "
            "from paddle_tpu_torch.inference import InferenceMachine; "
            "from paddle_tpu_torch.models.text import nmt_packed_cost, "
            "ngram_lm, ctr_wide_deep; "
            "from paddle_tpu_torch.evaluator import ctc_error, "
            "ctc_edit_distance; "
            "from paddle_tpu_torch.kernels.gru import gru_fwd_op; "
            "from paddle_tpu_torch.io.merged_model import "
            "export_decode_step_artifacts_ex, step_export_meta, "
            "load_step_export, STABLEHLO_STEP_SKIP_REASON; "
            "from paddle_tpu_torch.step_decode import "
            "driver_from_bundle_meta; "
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'paddle_tpu' or "
            "m.startswith('paddle_tpu.')); print(bad)")
    out = subprocess.run([sys.executable, "-c", code], cwd=repo,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_grid_kernel_binds_n_ints_sizes():
    """A kernel's C interface takes its pointers, ``n_ints`` int sizes (three
    by default: B, T, H) and the stream; ``launch`` refuses another count
    of sizes before it loads anything."""
    import ctypes
    import types

    from paddle_tpu_torch.kernels._build import GridKernel

    P, I = ctypes.c_void_p, ctypes.c_int
    for n_ints in (3, 4):
        kern = GridKernel("k", n_ptrs=2, n_ints=n_ints)
        lib = types.SimpleNamespace(k=types.SimpleNamespace(),
                                    k_error_string=types.SimpleNamespace())
        kern._bind(lib)
        assert lib.k.argtypes == [P, P] + [I] * n_ints + [P]
        assert lib.k.restype is I
        assert lib.k_error_string.argtypes == [I]
    kern = GridKernel("k", n_ptrs=2, n_ints=4)
    with pytest.raises(Error, match="3 sizes, expected 4"):
        kern.launch([0, 0], 1, 2, 3, torch.device("cuda"))
    assert kern._lib is None
