"""AOTInductor packages of the port's programs, served with no Python by
the native runner (``paddle_tpu_torch.native``: the C++ ops of
``torch_ops.cc``, the C ABI of ``aoti_runner.cc``, the ``aoti_run``
program), against the JAX package and the port on the CPU.

- The runner's library and ``aoti_run`` link no libpython.
- The C++ plans (``plans.h``) equal ``lstm_fwd_plan`` and ``gru_fwd_plan``
  over a grid of (B, H).
- The LSTM classifier (V 50, E 16, H 16, 2 layers, T 7; f32 and int8): its
  ``cpu`` package (symbolic batch) through ``aoti_run`` at B = 4 and 3,
  every step valid or rows of ragged lengths, gives JAX's forward's and
  (every step valid) ``InferenceMachine(device="cpu")``'s results,
  through the C++ ``lstm_fwd`` (named as an extern node, called twice a
  request); ``bundle_meta`` without ``aoti_platforms`` is the meta it was,
  and with ``("cpu", "cuda")`` on this host gives the ``cpu`` package and
  ``module_errors["cuda"]``.
- A small NMT decode (vocabularies 40, width 16, beam 2, max_length 6, 4
  slots, dense): its ``init`` and ``step`` packages, driven tick by tick
  through ``aoti_run``, equal ``load_step_export(device="cpu")``'s
  outputs and those of JAX's init and step modules on the same inputs,
  ``init`` through the C++ ``gru_fwd``; its whole loop, a
  ``while_loop``, has a package too, which decodes JAX's ids.
- The C++ ops called by name with no package (``native.call_op``) on
  ragged rows, with and without the segment reset and the stash, equal the
  Python ops' CPU implementations.
- Clean refusals: a missing package, the wrong number or dtype of inputs,
  ``cuda`` asked of this host, an op the runner does not register.

Five AOTInductor compiles at once: the classifier's two in this process,
the decode's whole loop and its init and step in two of their own.
Tolerances: 1e-5 (float32 through two compilers' sums); ids, counters
and ticks exact.
"""

import io
import json
import os
import re
import subprocess
import sys
import threading
import zipfile
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pj
from paddle_tpu.core.arg import Arg as JArg
from paddle_tpu.core.layer import layer_name_scope as jax_name_scope
from paddle_tpu.io import merged_model as jmm
from paddle_tpu.models.text import lstm_text_classification as jax_lstm_cls
from paddle_tpu.models.text import nmt_decode_topology as jax_nmt_decode

import paddle_tpu_torch as pt
from paddle_tpu_torch import native
from paddle_tpu_torch import quant as tq
from paddle_tpu_torch.core.layer import layer_name_scope as torch_name_scope
from paddle_tpu_torch.inference import InferenceMachine
from paddle_tpu_torch.io import merged_model as tmm
from paddle_tpu_torch.kernels import gru as tgru, lstm as tlstm
from paddle_tpu_torch.models.text import \
    lstm_text_classification as torch_lstm_cls
from paddle_tpu_torch.models.text import \
    nmt_decode_topology as torch_nmt_decode
from paddle_tpu_torch.utils.error import Error

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
TOL = dict(rtol=1e-5, atol=1e-5)
DICT, T, STATIC_B = 50, 7, 4
NMT_V, NMT_W, BEAM, MAX_LEN, NMT_T, SLOTS = 40, 16, 2, 6, 5, 4
# eos's bias raised so that the decodes end at different ticks
EOS_BIAS = 2.0


def _weights(topo, seed=0, scale=0.3):
    r = np.random.RandomState(seed)
    return {n: (r.randn(*s.shape) * scale).astype(np.float32)
            for n, s in sorted(topo.param_specs().items())}


def _classifier():
    """(JAX topology, port topology, weights): the LSTM classifier at
    V 50, E 16, H 16, 2 layers in both packages."""
    with jax_name_scope():
        jout = jax_lstm_cls(dict_dim=DICT, emb_dim=16, hidden=16,
                            num_layers=2)[2]
    with torch_name_scope():
        tout = torch_lstm_cls(dict_dim=DICT, emb_dim=16, hidden=16,
                              num_layers=2)[2]
    jt = pj.Topology(jout)
    return jt, pt.Topology(tout), _weights(jt)


def _nmt_cfg():
    return dict(src_dict_dim=NMT_V, trg_dict_dim=NMT_V,
                word_vector_dim=NMT_W, encoder_size=NMT_W,
                decoder_size=NMT_W, beam_size=BEAM, max_length=MAX_LEN,
                mode="dense", name="m")


def _nmt_port():
    """The decode's port topology and weights."""
    with torch_name_scope():
        tt = pt.Topology(torch_nmt_decode(**_nmt_cfg()))
    d = _weights(tt, seed=5)
    d["_m_out.wbias"][..., 1] += EOS_BIAS
    return tt, d


def write_nmt_meta(path, which):
    """The decode's ``torch_export`` (``which`` "forward": the whole loop)
    or ``torch_step`` ("step": init and step) bundle meta with ``cpu``
    packages, as JSON at ``path``: run in a process of its own, beside
    the classifier's compiles."""
    tt, d = _nmt_port()
    params = pt.Parameters.from_numpy(d)
    if which == "forward":
        res, reason = tmm.export_forward_aoti_ex(
            tt, params, platforms=("cpu",), seq_len=NMT_T,
            static_batch=SLOTS)
        meta = {"torch_export": tmm.forward_export_meta(res)}
    else:
        res, reason = tmm.export_decode_step_artifacts_ex(
            tt, params, seq_len=NMT_T, slots=SLOTS, aoti_platforms=("cpu",))
        meta = {"torch_step": tmm.step_export_meta(res)}
    assert reason is None, reason
    with open(path, "w") as f:
        json.dump(meta, f)


_NMT_SCRIPT = """
import sys
sys.path.insert(0, sys.argv[1])
import test_torch_aoti
test_torch_aoti.write_nmt_meta(sys.argv[2], sys.argv[3])
"""


def _package_file(tmp, name, package):
    path = str(tmp / f"{name}.pt2")
    with open(path, "wb") as f:
        f.write(package)
    return path


def _bundle_file(tmp, name, topo, params, meta):
    path = str(tmp / f"{name}.ptpu")
    with open(path, "wb") as f:
        tmm.write_bundle(f, topo, params, meta=meta, version=1)
    return path


@pytest.fixture(scope="module")
def work(tmp_path_factory):
    """The cpu runner, the classifier's packages (f32 through bundle_meta
    with cpu and cuda asked, int8 through export_forward_aoti_ex) and the
    decode's meta with its packages, built at once: the decode's whole
    loop and its step in two child processes, the runner on a thread."""
    tmp = tmp_path_factory.mktemp("aoti")
    children = {which: subprocess.Popen(
        [sys.executable, "-c", _NMT_SCRIPT, HERE, str(tmp / f"{which}.json"),
         which], cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for which in ("forward", "step")}
    built = {}

    def build():
        try:
            built["runner"] = native.build_runner("cpu")
        except Exception as e:  # noqa: BLE001 - re-raised below
            built["error"] = e

    thread = threading.Thread(target=build)
    thread.start()
    try:
        jt, tt, weights = _classifier()
        cls = {}
        for mode in ("f32", "int8"):
            if mode == "f32":
                tp, tmeta = pt.Parameters.from_numpy(weights), None
                meta = tmm.bundle_meta(tt, tp, seq_len=T,
                                       static_batch=STATIC_B,
                                       aoti_platforms=("cpu", "cuda"))
            else:
                qd, tmeta = tq.quantize_params(
                    tt, {k: torch.from_numpy(v) for k, v in weights.items()},
                    mode)
                tp = pt.Parameters.from_dict(qd)
                res, reason = tmm.export_forward_aoti_ex(
                    tt, tp, platforms=("cpu",), seq_len=T,
                    static_batch=STATIC_B, qmeta=tmeta)
                assert reason is None, reason
                meta = {"quantize": tmeta,
                        "torch_export": tmm.forward_export_meta(res)}
            package = tmm.aoti_package(meta, "cpu")
            cls[mode] = SimpleNamespace(
                tp=tp, qmeta=tmeta, meta=meta, package=package,
                path=_package_file(tmp, f"cls_{mode}", package),
                bundle=_bundle_file(tmp, f"cls_{mode}", tt, tp, meta))
        thread.join()
        if "error" in built:
            raise built["error"]
        nmt = {}
        for which, child in children.items():
            _out, err = child.communicate(timeout=900)
            assert child.returncode == 0, err
            with open(tmp / f"{which}.json") as f:
                nmt.update(json.load(f))
    finally:
        for child in children.values():
            if child.poll() is None:
                child.kill()
        thread.join()
    return SimpleNamespace(tmp=tmp, runner=built["runner"], jt=jt, tt=tt,
                           weights=weights, cls=cls, nmt=nmt)


def _ids(B, seed=2):
    return np.random.RandomState(seed).randint(0, DICT, (B, T)) \
        .astype(np.int32)


# the valid steps of each row of a ragged request
RAGGED = (T, 4, 1, 6)


def _mask(B, rows):
    lengths = [T] * B if rows == "full" else RAGGED[:B]
    return (np.arange(T)[None, :] < np.array(lengths)[:, None]) \
        .astype(np.float32)


# --- the build ---------------------------------------------------------------

def test_runner_links_no_libpython(work):
    """Neither the runner's library nor aoti_run needs libpython (torch's
    own libraries sit under a python3.x directory, so ``libpython`` is
    what is matched)."""
    for path in (work.runner.lib, work.runner.exe):
        out = subprocess.run(["ldd", str(path)], capture_output=True,
                             text=True, check=True).stdout
        assert "libtorch" in out and "not found" not in out, out
        assert "libpython" not in out, out


def test_cpp_schemas_equal_the_python_ones():
    """torch_ops.cc defines lstm_fwd and gru_fwd with the schemas the
    Python registration defines, letter for letter."""
    src = open(os.path.join(REPO, "paddle_tpu_torch", "native",
                            "torch_ops.cc")).read()
    defs = ["".join(re.findall(r'"([^"]*)"', d))
            for d in re.findall(r"m\.def\(((?:\s*\"[^\"]*\")+)\)", src)]
    assert len(defs) == 2
    for op in (tlstm.lstm_fwd_op, tgru.gru_fwd_op):
        want = str(op._schema)
        assert "paddle_tpu_torch::" + next(
            d for d in defs if d.startswith(op._schema.name.split("::")[1]
                                            + "(")) == want


def _python_plans(B, H):
    lstm = tlstm.lstm_fwd_plan(B, H)
    gru = tgru.gru_fwd_plan(B, H)
    return (None if lstm is None else tuple(lstm)), \
        (gru.path, gru.C, gru.R, gru.smem)


# B from 1 to 2048 and H from 4 to 1024, with the classifier's (64, 512),
# the LSTM's switch to the all-rows kernel (B past 1984 at H = 512; H / 4
# > 132 with H not a multiple of 8), the GRU's cluster against grid at
# H = 256 and 512, H not a multiple of 4, and the plans' limits (588, 644)
PLAN_BATCHES = (1, 2, 3, 8, 15, 16, 17, 31, 32, 33, 63, 64, 65, 100, 127,
                128, 129, 256, 257, 500, 1000, 1024, 1984, 1985, 2000, 2048)
PLAN_HIDDENS = (4, 6, 8, 12, 16, 20, 32, 36, 60, 64, 100, 128, 130, 132,
                200, 240, 256, 260, 264, 272, 384, 512, 516, 528, 532, 576,
                588, 592, 644, 648, 700, 1024)


def test_cpp_plans_equal_the_python_plans(work):
    got = native.plans(PLAN_BATCHES, PLAN_HIDDENS, runner=work.runner)
    seen = {"all_rows": 0, "none": 0, "cluster": 0, "grid": 0}
    for B in PLAN_BATCHES:
        for H in PLAN_HIDDENS:
            lstm, gru = _python_plans(B, H)
            assert got["lstm"][(B, H)] == lstm, (B, H)
            assert got["gru"][(B, H)] == gru, (B, H)
            seen["none" if lstm is None else
                 "all_rows" if lstm[1] == 0 else "x"] = 1
            seen[gru[0]] = 1
    assert all(seen.values()), seen
    assert got["lstm"][(64, 512)] == (16, 16, 128, tlstm.lstm_fwd_plan(
        64, 512).smem)
    assert got["gru"][(32, 256)][0] == "cluster"
    assert got["gru"][(32, 512)][0] == "grid"


def _op_inputs(op, case, B=3, Tn=6, H=8, seed=11):
    """(tensors, ints) of a call of ``op`` ("lstm" or "gru"): rows of 6, 3
    and 1 valid steps; with "reset" a segment restarting in two rows and
    the stash asked; with "plain" no reset and no stash."""
    r = np.random.RandomState(seed)
    x = (r.randn(B, Tn, (4 if op == "lstm" else 3) * H) * 0.5) \
        .astype(np.float32)
    weights = [(r.randn(*s) * 0.5).astype(np.float32) for s in (
        ((H, 4 * H), (7 * H,)) if op == "lstm"
        else ((H, 2 * H), (H, H), (3 * H,)))]
    mask = (np.arange(Tn)[None, :] < np.array([Tn, 3, 1])[:, None]) \
        .astype(np.float32)
    reset = None
    if case == "reset":
        reset = np.zeros((B, Tn), np.float32)
        reset[0, 2] = reset[1, 1] = 1
    stash = int(case == "reset")
    ints = [stash, 0, 0] if op == "lstm" else [stash, 0, 0, 0]
    return [x, *weights, mask, reset], ints


@pytest.mark.parametrize("case", ["reset", "plain"])
@pytest.mark.parametrize("op", ["lstm", "gru"])
def test_cpp_ops_equal_the_python_ops(work, op, case):
    """The C++ lstm_fwd and gru_fwd (called by name in aoti_run, with no
    package) against the Python ops' CPU implementations (the plain
    versions) on the same inputs: the mask-gated carry of ragged rows, the
    segment reset and the stash, to 1e-5; the CPU implementation runs,
    no kernel."""
    tensors, ints = _op_inputs(op, case)
    res = native.call_op(f"paddle_tpu_torch::{op}_fwd", tensors, ints,
                         device="cpu", runner=work.runner)
    assert res["launches"] == {"fused_lstm": 0, "fused_lstm_bf16": 0,
                               "fused_gru": 0,
                               "fused_gru_cluster": 0, "fused_gru_bf16": 0,
                               "fused_gru_cluster_bf16": 0,
                               "lstm_fwd_cpu": int(op == "lstm"),
                               "gru_fwd_cpu": int(op == "gru")}
    python_op = tlstm.lstm_fwd_op if op == "lstm" else tgru.gru_fwd_op
    want = python_op(*[None if t is None else torch.from_numpy(t)
                       for t in tensors], bool(ints[0]), *ints[1:])
    assert len(res["outputs"]) == len(want)
    for got, w in zip(res["outputs"], want):
        assert got.shape == tuple(w.shape)
        np.testing.assert_allclose(got, w.numpy(), **TOL)


@pytest.mark.parametrize("case", ["reset", "plain"])
def test_cpp_gru_op_equals_the_python_op_in_bf16(work, case):
    """The C++ gru_fwd on bf16 tensors (the plain version's bf16 rule: a
    float32 carry, each product's operands rounded to bf16, hs and the
    stash rounded) against the Python op's CPU implementation on the same
    bf16 inputs, as the float32 test above: hs and the stash in bf16 (read
    back widened), within TOL; the CPU implementation runs, no kernel.
    Both run the same ATen operations: measured bit-equal."""
    tensors, ints = _op_inputs("gru", case)
    bf = [None if t is None else torch.from_numpy(t).to(torch.bfloat16)
          for t in tensors]
    # mask and reset stay float32, as the layer hands them over
    bf[4] = torch.from_numpy(tensors[4])
    bf[5] = None if tensors[5] is None else torch.from_numpy(tensors[5])
    res = native.call_op("paddle_tpu_torch::gru_fwd", bf, ints,
                         device="cpu", runner=work.runner)
    assert res["launches"] == {"fused_lstm": 0, "fused_lstm_bf16": 0,
                               "fused_gru": 0,
                               "fused_gru_cluster": 0, "fused_gru_bf16": 0,
                               "fused_gru_cluster_bf16": 0,
                               "lstm_fwd_cpu": 0, "gru_fwd_cpu": 1}
    want = tgru.gru_fwd_op(*bf, bool(ints[0]), *ints[1:])
    assert want[0].dtype == torch.bfloat16
    assert len(res["outputs"]) == len(want)
    for got, w in zip(res["outputs"], want):
        assert got.shape == tuple(w.shape)
        np.testing.assert_allclose(got, w.float().numpy(), **TOL)


@pytest.mark.parametrize("case", ["reset", "plain"])
def test_cpp_lstm_op_equals_the_python_op_in_bf16(work, case):
    """The C++ lstm_fwd on bf16 tensors (the plain version's bf16 rule:
    float32 carries, the product of h_{t-1} rounded to bf16, hs, cs and
    the stash rounded) against the Python op's CPU implementation on the
    same bf16 inputs: hs, cs and the stash in bf16 (read back widened),
    within TOL; the CPU implementation runs, no kernel. Both run the same
    ATen operations."""
    tensors, ints = _op_inputs("lstm", case)
    bf = [None if t is None else torch.from_numpy(t).to(torch.bfloat16)
          for t in tensors]
    # mask and reset stay float32, as the layer's wrapper hands them over
    bf[3] = torch.from_numpy(tensors[3])
    bf[4] = None if tensors[4] is None else torch.from_numpy(tensors[4])
    res = native.call_op("paddle_tpu_torch::lstm_fwd", bf, ints,
                         device="cpu", runner=work.runner)
    assert res["launches"] == {"fused_lstm": 0, "fused_lstm_bf16": 0,
                               "fused_gru": 0, "fused_gru_cluster": 0,
                               "fused_gru_bf16": 0,
                               "fused_gru_cluster_bf16": 0, "lstm_fwd_cpu": 1,
                               "gru_fwd_cpu": 0}
    want = tlstm.lstm_fwd_op(*bf, bool(ints[0]), *ints[1:])
    assert want[0].dtype == torch.bfloat16
    assert len(res["outputs"]) == len(want)
    for got, w in zip(res["outputs"], want):
        assert got.shape == tuple(w.shape)
        np.testing.assert_allclose(got, w.float().numpy(), **TOL)


def test_cpp_bf16_lstm_plans_equal_the_python_plans(work):
    """plans.h's bf16 LSTM forward (H a multiple of 8, W as float and the
    row tile bf16, no all-rows fallback) against kernels/lstm.py
    lstm_fwd_plan(B, H, torch.bfloat16) over the same grid of (B, H)."""
    got = native.plans(PLAN_BATCHES, PLAN_HIDDENS, runner=work.runner)
    seen = set()
    for B in PLAN_BATCHES:
        for H in PLAN_HIDDENS:
            want = tlstm.lstm_fwd_plan(B, H, torch.bfloat16)
            want = None if want is None else tuple(want)
            assert got["lstm_bf16"][(B, H)] == want, (B, H)
            seen.add(want is None)
    assert seen == {True, False}
    assert got["lstm_bf16"][(64, 512)] == (16, 16, 128, 187648)


def test_cpp_bf16_gru_plans_equal_the_python_plans(work):
    """plans.h's bf16 GRU forward (H a multiple of 8, the cluster form's
    bf16 weights and ring and float32 own carry) against kernels/gru.py
    gru_fwd_plan(B, H, torch.bfloat16) over the same grid of (B, H): the
    tagger's (32, 128) a cluster plan of its own shared memory, H = 512
    the grid one (bf16 takes a cluster plan only where the float32 form's
    fits too)."""
    got = native.plans(PLAN_BATCHES, PLAN_HIDDENS, runner=work.runner)
    seen = set()
    for B in PLAN_BATCHES:
        for H in PLAN_HIDDENS:
            want = tgru.gru_fwd_plan(B, H, torch.bfloat16)
            assert got["gru_bf16"][(B, H)] == tuple(want), (B, H)
            seen.add(want.path)
    assert seen == {"cluster", "grid"}
    tagger = tgru.cluster_plan(128, 8, 4, torch.bfloat16)
    assert got["gru_bf16"][(32, 128)] == tuple(tagger)
    assert tagger.smem < tgru.cluster_plan(128, 8, 4).smem
    assert got["gru_bf16"][(32, 512)][0] == "grid"
    assert got["gru_bf16"][(64, 512)][0] == "grid"


def test_call_op_refuses_cleanly(work):
    """aoti_run --op names an op it does not register, and a call short of
    its schema's arguments."""
    tensors, ints = _op_inputs("lstm", "plain")
    with pytest.raises(Error, match="no op paddle_tpu_torch::lstm_fwd_v0 "
                       "is registered"):
        native.call_op("paddle_tpu_torch::lstm_fwd_v0", tensors, ints,
                       device="cpu", runner=work.runner)
    with pytest.raises(Error, match="takes more than the 2 ints given"):
        native.call_op("paddle_tpu_torch::lstm_fwd", tensors, ints[:2],
                       device="cpu", runner=work.runner)


# --- the classifier ----------------------------------------------------------

@pytest.mark.parametrize("rows", ["full", "ragged"])
@pytest.mark.parametrize("mode", ["f32", "int8"])
@pytest.mark.parametrize("B", [STATIC_B, 3])
def test_classifier_package_serves_jax_and_the_machine(work, mode, B, rows):
    """The cpu package through aoti_run at B rows (the batch symbolic),
    every step valid or rows of RAGGED steps (the C++ lstm_fwd's masked
    carry): JAX's forward of the same bundle and the artifact, and with
    every step valid the port's machine (which takes no mask), to 1e-5;
    the C++ lstm_fwd twice a request, no kernel launched on the CPU."""
    c = work.cls[mode]
    sig = c.meta["torch_export"]["signature"]
    assert sig["symbolic_batch"] and sig["quantize"] == mode
    assert tmm.package_extern_ops(c.package) == \
        ["paddle_tpu_torch::lstm_fwd"] * 2
    ids = _ids(B, seed=8)
    mask = _mask(B, rows)
    res = native.run_package(c.path, [ids, mask], device="cpu", reps=2,
                             runner=work.runner)
    assert res["launches"] == {"fused_lstm": 0, "fused_lstm_bf16": 0,
                               "fused_gru": 0,
                               "fused_gru_cluster": 0, "fused_gru_bf16": 0,
                               "fused_gru_cluster_bf16": 0,
                               "lstm_fwd_cpu": 2,
                               "gru_fwd_cpu": 0}
    assert res["launches_total"]["lstm_fwd_cpu"] == 2 * 3
    assert res["timed_runs"] == 2 and res["median_us"] > 0
    (got,) = res["outputs"]
    assert got.shape == (B, 2) and got.dtype == np.float32
    if rows == "full":
        machine = InferenceMachine(c.bundle, device="cpu")
        np.testing.assert_allclose(got, machine.forward({"words": ids}),
                                   **TOL)
    topo, params, _meta = jmm.load_merged_model(c.bundle)
    pd = {k: jnp.asarray(v) for k, v in params.as_dict().items()}
    want = topo.forward(pd, {"words": JArg(jnp.asarray(ids),
                                           jnp.asarray(mask))})
    np.testing.assert_allclose(
        got, np.asarray(want[topo.outputs[0].name].value), **TOL)
    fx = tmm.load_forward_export(c.meta, device="cpu")
    np.testing.assert_allclose(got, fx(ids, mask).numpy(), **TOL)


def test_bundle_meta_packages_only_when_asked(work):
    """Without aoti_platforms, bundle_meta gives the meta it gave before
    the option (no package key, no module_errors); with ("cpu", "cuda") on
    this host, the cpu package and module_errors["cuda"] naming the
    missing card, nothing else changed."""
    c = work.cls["f32"]
    plain = tmm.bundle_meta(work.tt, c.tp, seq_len=T, static_batch=STATIC_B)
    exp = dict(c.meta["torch_export"])
    sig = dict(exp["signature"])
    errors = sig.pop("module_errors")
    assert set(errors) == {"cuda"} and "no CUDA device" in errors["cuda"]
    assert exp.pop("aoti_cpu_b64") and "aoti_cuda_b64" not in exp
    exp["signature"] = sig
    assert plain == dict(c.meta, torch_export=exp)
    assert list(plain["torch_export"]) == ["artifact_b64", "signature",
                                           "static_batch"]
    with pytest.raises(Error, match="no cuda package of its forward: "
                       "Error: no CUDA device"):
        tmm.aoti_package(c.meta, "cuda")
    with pytest.raises(Error, match="aoti_platforms"):
        tmm.aoti_package(plain, "cpu")


# --- the decode --------------------------------------------------------------

def _nmt_requests(seed=3):
    r = np.random.RandomState(seed)
    src = r.randint(2, NMT_V, (SLOTS, NMT_T)).astype(np.int32)
    mask = np.ones((SLOTS, NMT_T), np.float32)
    mask[1, 3:] = 0
    mask[3, 4:] = 0
    return src, mask


def _serve_steps(work):
    """The decode's init and step packages driven through aoti_run for
    MAX_LEN ticks over _nmt_requests: (signature, its state's length,
    run_package's result)."""
    meta = work.nmt
    sig = meta["torch_step"]["signature"]
    assert "module_errors" not in sig
    paths = {}
    for which, ops in (("init", ["paddle_tpu_torch::gru_fwd"] * 2),
                       ("step", [])):
        package = tmm.aoti_package(meta, "cpu", which)
        assert tmm.package_extern_ops(package) == ops
        paths[which] = _package_file(work.tmp, f"nmt_{which}", package)
    src, mask = _nmt_requests()
    n_state = len(sig["state"])
    return sig, n_state, native.run_package(
        paths["init"], [src, mask], device="cpu", step=paths["step"],
        ticks=MAX_LEN, state=n_state, reps=1, runner=work.runner)


def _assert_outputs(names, got, want, what):
    """Integer outputs equal, float ones to TOL."""
    for name, g, w in zip(names, got, want, strict=True):
        w = np.asarray(w)
        assert g.shape == w.shape, (what, name)
        if np.issubdtype(w.dtype, np.floating):
            np.testing.assert_allclose(g, w, err_msg=f"{what} {name}", **TOL)
        else:
            assert np.array_equal(g, w), (what, name)


def test_step_packages_tick_by_tick(work):
    """init, then MAX_LEN ticks of step, through aoti_run, each tick's
    state fed back: every output equal to load_step_export's over the
    same inputs (ids, tokens, counters exact; scores and states to 1e-5);
    init through the C++ gru_fwd (the encoder's two GRUs), the step
    through no op."""
    sig, n_state, res = _serve_steps(work)
    src, mask = _nmt_requests()
    assert res["init"]["launches"]["gru_fwd_cpu"] == 2
    assert res["step"]["launches"]["gru_fwd_cpu"] == 0
    assert len(res["step"]["tick_us"]) == MAX_LEN
    ex = tmm.load_step_export(work.nmt, device="cpu")
    names = sig["init_outputs"]
    want = ex["init"].call(torch.from_numpy(src), torch.from_numpy(mask))
    for name, w, g in zip(names, want, res["init"]["outputs"]):
        np.testing.assert_allclose(g, w.numpy(), err_msg=name, **TOL)
    state = list(want)
    done = []
    for k, got in enumerate(res["step"]["outputs"]):
        want = ex["step"].call(*state)
        for name, w, g in zip(sig["step_outputs"], want, got):
            if w.dtype.is_floating_point:
                np.testing.assert_allclose(g, w.numpy(), err_msg=name, **TOL)
            else:
                assert np.array_equal(g, w.numpy()), (k, name)
        done.append(got[-1].tolist())
        state = list(want[:n_state]) + state[n_state:]
    # the slots end at different ticks, and all by the last
    assert done[-1] == [1] * SLOTS
    assert len({tuple(d) for d in done}) > 2, done


def test_step_packages_hold_jax_step_modules(work):
    """The runner's init and every tick against JAX's init and step
    modules (export_decode_step_stablehlo_ex of the same weights, run on
    the CPU) over the same inputs: the requests for init, then each tick
    the state the runner fed itself; ids, tokens and counters exact,
    floats to 1e-5. Two of the rows are ragged, so the C++ gru_fwd's
    masked carry is held to JAX's encoder."""
    from jax import export as jax_export

    sig, n_state, res = _serve_steps(work)
    with jax_name_scope():
        jt = pj.Topology(jax_nmt_decode(**_nmt_cfg()))
    _tt, d = _nmt_port()
    jstep, reason = jmm.export_decode_step_stablehlo_ex(
        jt, pj.Parameters.from_dict(d), seq_len=NMT_T, slots=SLOTS)
    assert reason is None, reason
    assert [e["name"] for e in jstep["signature"]["state"]] == \
        [e["name"] for e in sig["state"]]
    init, step = (jax_export.deserialize(jstep[w]["artifact"])
                  for w in ("init", "step"))
    src, mask = _nmt_requests()
    init_out = res["init"]["outputs"]
    _assert_outputs(sig["init_outputs"], init_out, init.call(src, mask),
                    "init")
    state = init_out
    for k, got in enumerate(res["step"]["outputs"]):
        _assert_outputs(sig["step_outputs"], got, step.call(*state),
                        f"tick {k}")
        state = got[:n_state] + init_out[n_state:]


def _jax_decode(src, mask):
    """JAX's live decode of the same weights: ids, scores, ticks."""
    with jax_name_scope():
        jt = pj.Topology(jax_nmt_decode(**_nmt_cfg()))
    _tt, d = _nmt_port()
    _o, ctx = jt.forward({k: jnp.asarray(v) for k, v in d.items()},
                         {"src": JArg(jnp.asarray(src), jnp.asarray(mask))},
                         return_ctx=True)
    return (np.asarray(ctx.extras["m_gen:ids"]),
            np.asarray(ctx.extras["m_gen:scores"]),
            int(ctx.extras["m_gen:ticks"]))


def test_whole_loop_package_decodes_jax_ids(work):
    """The whole loop, its early exit a while_loop, compiles into a
    package too (no module_errors): served through aoti_run, ids and
    ticks equal to JAX's live decode and to the artifact's, scores to
    1e-5, the encoder's two GRUs through the C++ gru_fwd."""
    exp = work.nmt["torch_export"]
    assert "module_errors" not in exp["signature"]
    package = tmm.aoti_package(work.nmt, "cpu")
    assert tmm.package_extern_ops(package) == \
        ["paddle_tpu_torch::gru_fwd"] * 2
    path = _package_file(work.tmp, "nmt_whole", package)
    src, mask = _nmt_requests()
    res = native.run_package(path, [src, mask], device="cpu",
                             runner=work.runner)
    assert res["launches"]["gru_fwd_cpu"] == 2
    got = dict(zip((o["name"] for o in exp["signature"]["outputs"]),
                   res["outputs"]))
    ids, scores, ticks = _jax_decode(src, mask)
    assert np.array_equal(got["m_gen:ids"], ids)
    np.testing.assert_allclose(got["m_gen:scores"], scores, **TOL)
    assert int(got["m_gen:ticks"]) == ticks
    fx = tmm.load_forward_export(work.nmt, device="cpu")
    art = dict(zip(got, fx(src, mask)))
    assert np.array_equal(got["m_gen:ids"], art["m_gen:ids"].numpy())
    assert int(art["m_gen:ticks"]) == ticks


# --- refusals ----------------------------------------------------------------

def _unregistered(work):
    """The f32 classifier's package with its op renamed to one the runner
    does not register."""
    buf = io.BytesIO()
    with zipfile.ZipFile(io.BytesIO(work.cls["f32"].package)) as src, \
            zipfile.ZipFile(buf, "w", zipfile.ZIP_STORED) as dst:
        for info in src.infolist():
            data = src.read(info.filename)
            if info.filename.endswith(".wrapper.json"):
                data = data.replace(b"paddle_tpu_torch::lstm_fwd",
                                    b"paddle_tpu_torch::lstm_fwd_v0")
            dst.writestr(info, data)
    return _package_file(work.tmp, "unregistered", buf.getvalue())


REFUSALS = {
    "missing package": (lambda w: str(w.tmp / "nope.pt2"), "cpu", None, 2,
                        "no package at"),
    "too few inputs": (lambda w: w.cls["f32"].path, "cpu", 1, 1,
                       "the package takes 2 inputs, got 1"),
    "wrong dtype": (lambda w: w.cls["f32"].path, "cpu", "f32", 1,
                    r"input 0 must be i32\[b, 7\]"),
    "no card": (lambda w: w.cls["f32"].path, "cuda", None, 2,
                "no CUDA device"),
    "unregistered op": (_unregistered, "cpu", None, 2,
                        "paddle_tpu_torch::lstm_fwd_v0"),
}


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_runner_refuses_cleanly(work, case):
    """Each refusal exits non-zero with a message that names its cause,
    and prints no result."""
    package, device, change, code, message = REFUSALS[case]
    ids = _ids(STATIC_B)
    args = [ids, np.ones(ids.shape, np.float32)]
    if change == 1:
        args = args[:1]
    elif change == "f32":
        args[0] = ids.astype(np.float32)
    with pytest.raises(Error, match=f"aoti_run exited {code}: .*{message}"):
        native.run_package(package(work), args, device=device,
                           runner=work.runner)
