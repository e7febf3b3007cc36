"""Merged-model bundles across the two packages: the port's
``io/merged_model`` writes the JAX package's bytes (f32, bf16, int8), each
package loads, verifies and serves the other's bundles, both draw bundle
versions from one flock counter, the port's ``InferenceMachine`` and its
C-ABI bridge serve them, the forward's ``torch.export`` artifact runs in
a fresh process through the custom op ``paddle_tpu_torch::lstm_fwd``, and
the native ``paddle_tpu_serving`` daemon, built from the repo's sources,
serves port-written bundles.

Tolerances: f32 through both packages' forwards rtol 1e-5, atol 1e-6
(float32 through two recurrences, sums in another order); the port
against itself: equal bits; the daemon against the port's CPU forward:
the JAX package's own tolerances (1e-5 f32, 5e-3 bf16, 2e-2 int8,
tests/test_serving_daemon.py).
"""

import io
import json
import os
import shutil
import subprocess
import sys
import time
import urllib.request

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import paddle_tpu as pj
from paddle_tpu import quant as jq
from paddle_tpu.core.arg import Arg as JArg
from paddle_tpu.core.layer import layer_name_scope as jax_name_scope
from paddle_tpu.inference import InferenceMachine as JaxMachine
from paddle_tpu.io import merged_model as jmm
from paddle_tpu.models.text import lstm_text_classification as jax_lstm_cls

import paddle_tpu_torch as pt
from paddle_tpu_torch import kernels as tk
from paddle_tpu_torch import quant as tq
from paddle_tpu_torch.core.layer import layer_name_scope as torch_name_scope
from paddle_tpu_torch.inference import (InferenceMachine, _capi_create,
                                        _capi_forward)
from paddle_tpu_torch.io import merged_model as tmm
from paddle_tpu_torch.kernels.lstm import fused_lstm_plain
from paddle_tpu_torch.models.text import \
    lstm_text_classification as torch_lstm_cls
from paddle_tpu_torch.utils.error import Error

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(rtol=1e-5, atol=1e-6)
DICT, T = 50, 7


def _weights(topo, seed=0):
    r = np.random.RandomState(seed)
    return {n: (r.randn(*s.shape) * 0.3).astype(np.float32)
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


def _dense_model():
    """A dense-input model both packages' machines serve as they are:
    dense 6 -> fc 16 relu -> fc 3 softmax."""
    from paddle_tpu import activation as ja, data_type as jd, layer as jl
    from paddle_tpu_torch import activation as ta, data_type as td, \
        layer as tl

    def build(layer, data_type, act, scope):
        with scope():
            x = layer.data(name="x", type=data_type.dense_vector(6))
            h = layer.fc(input=x, size=16, act=act.Relu())
            return layer.fc(input=h, size=3, act=act.Softmax(), name="out")

    jt = pj.Topology(build(jl, jd, ja, jax_name_scope))
    return jt, pt.Topology(build(tl, td, ta, torch_name_scope)), \
        _weights(jt, 1)


def _quantized(jt, tt, weights, mode):
    """Both packages' Parameters for ``weights`` in ``mode``, each with its
    package's qmeta (None for f32)."""
    if mode == "f32":
        return (pj.Parameters.from_dict(weights), None,
                pt.Parameters.from_numpy(weights), None)
    jd, jmeta = jq.quantize_params(jt, dict(weights), mode)
    td, tmeta = tq.quantize_params(
        tt, {k: torch.from_numpy(v) for k, v in weights.items()}, mode)
    return (pj.Parameters.from_dict(jd), jmeta,
            pt.Parameters.from_dict(td), tmeta)


def _bundle_bytes(mm, topo, params, meta, version):
    buf = io.BytesIO()
    mm.write_bundle(buf, topo, params, meta=meta, version=version)
    return buf.getvalue()


def _ids(B=4, seed=2):
    return np.random.RandomState(seed).randint(0, DICT, (B, T)) \
        .astype(np.int32)


def _jax_forward(topo, params, feeds):
    """The JAX topology's forward on numpy feeds: (value, mask) tuples or
    arrays."""
    args = {k: JArg(jnp.asarray(v[0]), jnp.asarray(v[1]))
            if isinstance(v, tuple) else jnp.asarray(v)
            for k, v in feeds.items()}
    pd = {k: jnp.asarray(v) for k, v in params.as_dict().items()}
    out = topo.forward(pd, args)[topo.outputs[0].name].value
    return np.asarray(out).reshape(out.shape[0], -1)


@pytest.mark.parametrize("mode", ["f32", "bf16", "int8"])
def test_port_writes_the_jax_bytes(mode):
    jt, tt, weights = _classifier()
    jp, jmeta, tp, tmeta = _quantized(jt, tt, weights, mode)
    assert tmeta == jmeta
    meta = {"quantize": jmeta, "note": "same"} if jmeta else {"note": "x"}
    assert _bundle_bytes(tmm, tt, tp, meta, 7) == \
        _bundle_bytes(jmm, jt, jp, meta, 7)


def _write(path, write, topo, params, meta=None, version=None):
    with open(path, "wb") as f:
        write(f, topo, params, meta=meta, version=version)
    return str(path)


@pytest.mark.parametrize("mode", ["f32", "int8"])
def test_jax_bundle_serves_in_the_port(tmp_path, mode):
    """JAX-written bundles in the port's machine: the dense model against
    JAX's machine; the classifier, which JAX's machine cannot serve (its
    pooling gets no mask from raw ids), against JAX's forward over the
    same bundle with a mask of ones."""
    jt, tt, weights = _dense_model()
    jp, jmeta, _, _ = _quantized(jt, tt, weights, mode)
    path = _write(tmp_path / "dense.ptpu", jmm.write_bundle, jt, jp,
                  {"quantize": jmeta} if jmeta else None, 3)
    x = np.random.RandomState(4).rand(5, 6).astype(np.float32)
    got = InferenceMachine(path, device="cpu").forward({"x": x})
    np.testing.assert_allclose(got, JaxMachine(path).forward({"x": x}),
                               **TOL)
    assert tmm.verify_bundle(path) == jmm.verify_bundle(path)

    jt, tt, weights = _classifier()
    jp, jmeta, _, _ = _quantized(jt, tt, weights, mode)
    path = _write(tmp_path / "cls.ptpu", jmm.write_bundle, jt, jp,
                  {"quantize": jmeta} if jmeta else None, 4)
    ids = _ids()
    topo, params, _meta = jmm.load_merged_model(path)
    want = _jax_forward(topo, params, {
        "words": (ids, np.ones(ids.shape, np.float32))})
    got = InferenceMachine(path, device="cpu").forward({"words": ids})
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("mode", ["f32", "int8"])
def test_port_bundle_serves_in_jax(tmp_path, mode):
    jt, tt, weights = _dense_model()
    _, _, tp, tmeta = _quantized(jt, tt, weights, mode)
    path = _write(tmp_path / "dense.ptpu", tmm.write_bundle, tt, tp,
                  {"quantize": tmeta} if tmeta else None, 3)
    assert jmm.verify_bundle(path)["param_crc32"] == \
        tmm.verify_bundle(path)["param_crc32"]
    x = np.random.RandomState(4).rand(5, 6).astype(np.float32)
    np.testing.assert_allclose(
        JaxMachine(path).forward({"x": x}),
        InferenceMachine(path, device="cpu").forward({"x": x}), **TOL)

    jt, tt, weights = _classifier()
    _, _, tp, tmeta = _quantized(jt, tt, weights, mode)
    path = _write(tmp_path / "cls.ptpu", tmm.write_bundle, tt, tp,
                  {"quantize": tmeta} if tmeta else None, 4)
    ids = _ids()
    topo, params, meta = jmm.load_merged_model(path)
    assert meta == tmm.read_bundle_meta(path)
    want = _jax_forward(topo, params, {
        "words": (ids, np.ones(ids.shape, np.float32))})
    got = InferenceMachine(path, device="cpu").forward({"words": ids})
    np.testing.assert_allclose(got, want, **TOL)


def test_versions_draw_from_one_counter(tmp_path):
    d = str(tmp_path / "pub")
    draws = []
    for i in range(8):
        draws.append((jmm if i % 2 else tmm).next_bundle_version(d))
    assert all(b > a for a, b in zip(draws, draws[1:]))
    floor = draws[-1] + 10 ** 7
    tmm.record_bundle_version(d, floor)
    assert jmm.next_bundle_version(d) > floor
    jmm.record_bundle_version(d, floor + 10 ** 7)
    assert tmm.next_bundle_version(d) > floor + 10 ** 7
    # a lower record leaves the counter where it is
    tmm.record_bundle_version(d, 5)
    assert jmm.next_bundle_version(d) > floor + 10 ** 7
    with open(os.path.join(d, tmm.VERSION_COUNTER_FILE)) as f:
        assert int(f.read()) > floor + 10 ** 7


def test_newest_version_and_torn_bundles(tmp_path):
    jt, tt, weights = _dense_model()
    tp = pt.Parameters.from_numpy(weights)
    _write(tmp_path / "a.ptpu", tmm.write_bundle, tt, tp, None, 5)
    good = _write(tmp_path / "b.ptpu", tmm.write_bundle, tt, tp, None, 9)
    raw = open(good, "rb").read()
    with open(tmp_path / "torn.ptpu", "wb") as f:
        f.write(raw[:20])                     # a header cut short
    for mm in (tmm, jmm):
        assert mm.newest_bundle_version(str(tmp_path)) == 9
        assert mm.newest_bundle_version(str(tmp_path), exclude=good) == 5
    # one flipped byte in the parameter tar fails both packages' checks
    flipped = bytearray(raw)
    flipped[-600] ^= 0x40
    bad = tmp_path / "flipped.ptpu"
    bad.write_bytes(bytes(flipped))
    for mm in (tmm, jmm):
        with pytest.raises(Exception, match="crc mismatch"):
            mm.verify_bundle(str(bad))
        with pytest.raises(Exception, match="truncated"):
            mm.verify_bundle(str(tmp_path / "torn.ptpu"))
    bad.write_bytes(b"NOTABNDL" + raw[8:])
    with pytest.raises(Error, match="not a merged model bundle"):
        tmm.read_bundle_meta(str(bad))
    with pytest.raises(Error, match="positive"):
        _write(tmp_path / "c.ptpu", tmm.write_bundle, tt, tp, None, 0)


def test_machine_share_capi_and_refusals(tmp_path, monkeypatch):
    jt, tt, weights = _dense_model()
    path = _write(tmp_path / "dense.ptpu", tmm.write_bundle, tt,
                  pt.Parameters.from_numpy(weights), None, 3)
    m = InferenceMachine(path, device="cpu")
    clone = m.share()
    assert clone._params.keys() == m._params.keys()
    assert all(clone._params[k].data_ptr() == v.data_ptr()
               for k, v in m._params.items())
    assert m.input_names() == ["x"] and m.out_names == ["out"]
    x = np.random.RandomState(6).rand(3, 6).astype(np.float32)
    want = m.forward({"x": x})
    assert np.array_equal(clone.forward({"x": x}), want)
    assert np.array_equal(m.forward_flat("x", x.astype(np.float64)), want)
    rows, cols, out = _capi_forward(clone, "", x.tobytes(), 3, 6)
    assert (rows, cols) == (3, 3)
    assert np.frombuffer(out, np.float32).reshape(3, 3).tobytes() == \
        want.tobytes()
    # the entry points default to the card and never move to the CPU
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(Error, match="no CUDA device"):
        InferenceMachine(path)
    with pytest.raises(Error, match="no CUDA device"):
        _capi_create(path)


def test_host_table_bundles_raise_naming_the_item(tmp_path):
    from paddle_tpu import attr as jattr, data_type as jd, layer as jl
    from paddle_tpu import pooling as jpool

    with jax_name_scope():
        ids = jl.data(name="ids", type=jd.integer_value_sequence(40))
        emb = jl.embedding(input=ids, size=4, param_attr=jattr.ParamAttr(
            name="_hemb", host_resident=True))
        out = jl.fc(input=jl.pooling(input=emb, pooling_type=jpool.Avg()),
                    size=2)
    jt = pj.Topology(out)
    params = pj.Parameters.from_dict({
        k: v for k, v in _weights(jt).items() if k != "_hemb"})
    path = str(tmp_path / "host.ptpu")
    with open(path, "wb") as f:
        jmm.write_bundle(f, jt, params, version=2, host_tables={
            "_hemb": np.ones((40, 4), np.float32)})
    with pytest.raises(Error, match="queue 1 item 8"):
        InferenceMachine(path, device="cpu")
    _, tt, weights = _dense_model()
    with pytest.raises(Error, match="queue 1 item 8"):
        tmm.write_bundle(io.BytesIO(), tt, pt.Parameters.from_numpy(weights),
                         host_tables={"_hemb": None})


def test_custom_op_cpu_implementation_is_the_plain_version():
    r = np.random.RandomState(7)
    B, Tn, H = 3, 5, 8
    x4, w, b = (torch.from_numpy(r.randn(*s).astype(np.float32))
                for s in ((B, Tn, 4 * H), (H, 4 * H), (7 * H,)))
    mask = torch.ones(B, Tn)
    mask[1, 3:] = 0
    reset = torch.zeros(B, Tn)
    reset[2, 2] = 1
    before = tk.launches["fused_lstm"]
    hs, cs, gates = torch.ops.paddle_tpu_torch.lstm_fwd(
        x4, w, b, mask, reset, True, 0, 0)
    assert all(torch.equal(g, p) for g, p in zip(
        (hs, cs, gates), fused_lstm_plain(x4, w, b, mask, reset, True)))
    hs2, cs2, none = torch.ops.paddle_tpu_torch.lstm_fwd(
        x4, w, b, mask, None, False, 0, 0)
    assert none.numel() == 0
    assert all(torch.equal(g, p) for g, p in zip(
        (hs2, cs2), fused_lstm_plain(x4, w, b, mask)))
    assert tk.launches["fused_lstm"] == before          # no kernel here


_FRESH = """
import json, sys
import numpy as np
import paddle_tpu_torch  # noqa: F401  (registers the custom op)
from paddle_tpu_torch.io.merged_model import (load_forward_export,
                                              read_bundle_meta)
fx = load_forward_export(read_bundle_meta(sys.argv[1]), device="cpu")
ids = np.load(sys.argv[2])
outs = [fx(ids[:B], np.ones((B, ids.shape[1]), np.float32)).numpy().tolist()
        for B in (ids.shape[0], 3)]
print(json.dumps({"outs": outs, "jax": sorted(
    m for m in sys.modules if m.split(".")[0] in ("jax", "paddle_tpu"))}))
"""


@pytest.mark.parametrize("mode", ["f32", "int8"])
def test_forward_artifact_runs_in_a_fresh_process(tmp_path, mode):
    """The classifier's artifact (symbolic batch, static_batch 4, T 7),
    loaded in a process that never built the model, against the port's
    forward of the bundle it rides in; the program holds the custom op
    and, for int8, int8 constants."""
    jt, tt, weights = _classifier()
    _, _, tp, tmeta = _quantized(jt, tt, weights, mode)
    meta = tmm.bundle_meta(tt, tp, qmeta=tmeta, seq_len=T, static_batch=4)
    sig = meta["torch_export"]["signature"]
    assert sig["symbolic_batch"] and sig["quantize"] == mode
    assert [s["name"] for s in sig["inputs"]] == ["words", "words:mask"]
    assert sig["outputs"] == [{"name": "output", "dtype": "f32",
                               "shape": ["b", 2]}]
    assert meta["stablehlo_skip_reason"] == tmm.STABLEHLO_SKIP_REASON
    path = _write(tmp_path / "cls.ptpu", tmm.write_bundle, tt, tp, meta, 2)
    program = torch.export.load(io.BytesIO(__import__("base64").b64decode(
        meta["torch_export"]["artifact_b64"])))
    assert "paddle_tpu_torch.lstm_fwd" in str(program.graph)
    dtypes = {t.dtype for t in program.state_dict.values()}
    assert (torch.int8 in dtypes) == (mode == "int8")
    ids = _ids(4, seed=8)
    np.save(tmp_path / "ids.npy", ids)
    out = subprocess.run(
        [sys.executable, "-c", _FRESH, path, str(tmp_path / "ids.npy")],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["jax"] == []
    m = InferenceMachine(path, device="cpu")
    for got, B in zip(res["outs"], (4, 3)):
        np.testing.assert_allclose(np.array(got, np.float32),
                                   m.forward({"words": ids[:B]}), **TOL)


def test_export_skip_reasons_match_jax():
    """Over the 32 MiB cap both packages give the same reason, and a
    bundle without an artifact says why when it is loaded."""
    from paddle_tpu import data_type as jd, layer as jl
    from paddle_tpu_torch import data_type as td, layer as tl

    def build(layer, data_type, scope):
        with scope():
            x = layer.data(name="x", type=data_type.dense_vector(4100))
            return layer.fc(input=x, size=2100, name="big")

    jt = pj.Topology(build(jl, jd, jax_name_scope))
    tt = pt.Topology(build(tl, td, torch_name_scope))
    big = {"_big.w0": np.zeros((4100, 2100), np.float32),
           "_big.wbias": np.zeros(2100, np.float32)}
    _, jreason = jmm.export_forward_stablehlo_ex(
        jt, pj.Parameters.from_dict(big))
    res, treason = tmm.export_forward_ex(tt, pt.Parameters.from_numpy(big))
    assert res is None and treason == jreason
    assert "32 MiB" in treason
    meta = tmm.bundle_meta(tt, pt.Parameters.from_numpy(big))
    assert meta["torch_export_skip_reason"] == treason
    with pytest.raises(Error, match="too large"):
        tmm.load_forward_export(meta, device="cpu")
    res, reason = tmm.export_forward_ex(tt, pt.Parameters.from_numpy(
        {"_big.w0": big["_big.w0"]}))
    assert res is None and "missing" in reason


@pytest.mark.parametrize("kind", ["gru", "crf"])
def test_export_refuses_a_kernel_without_a_dispatcher_op(kind):
    """A topology whose forward reaches a kernel that is not a dispatcher
    op (here crf_logz) gets a skip reason naming it, not an artifact that
    would run the plain version on the card; a bundle's meta records it.
    The GRU forward is the op ``paddle_tpu_torch::gru_fwd``: a GRU
    topology gets an artifact that holds it."""
    from paddle_tpu_torch import data_type as td, layer as tl

    with torch_name_scope():
        words = tl.data(name="words",
                        type=td.integer_value_sequence(DICT))
        emb = tl.embedding(input=words, size=8)
        if kind == "gru":
            g = tl.grumemory(input=tl.fc(input=emb, size=3 * 8), name="g")
            out = tl.fc(input=tl.last_seq(input=g), size=2, name="out")
        else:
            tags = tl.data(name="tags", type=td.integer_value_sequence(3))
            out = tl.crf(input=tl.fc(input=emb, size=3), label=tags,
                         size=3, name="g")
    tt = pt.Topology(out)
    params = pt.Parameters.from_topology(tt, torch.Generator().manual_seed(0))
    res, reason = tmm.export_forward_ex(tt, params, seq_len=T)
    if kind == "gru":
        assert reason is None, reason
        program = torch.export.load(io.BytesIO(res["artifact"]))
        assert "paddle_tpu_torch.gru_fwd" in str(program.graph)
        return
    assert res is None and f"'g' ({tt.layer_map['g'].type})" in reason
    assert "crf_logz" in reason and "dispatcher op" in reason
    assert tmm.bundle_meta(tt, params)["torch_export_skip_reason"] == reason


def test_from_dict_copies_arrays_and_keeps_tensors():
    """Parameters.from_dict owns a copy of a numpy array, as JAX's does
    (a later write into the caller's array leaves it be), and keeps a
    tensor as it is."""
    a = np.arange(6, dtype=np.float32).reshape(2, 3)
    t = torch.ones(4)
    p = pt.Parameters.from_dict({"a": a, "t": t})
    a[0, 0] = 100.0
    assert float(p.get("a")[0, 0]) == 0.0
    assert p.get("t") is t


# --- the native daemon -------------------------------------------------------

@pytest.fixture(scope="module")
def daemon_binary(tmp_path_factory):
    """paddle_tpu_serving built from the repo's sources in a directory of
    its own (a build in place would race the JAX tests' ``make``)."""
    src = os.path.join(REPO, "paddle_tpu", "native")
    build = tmp_path_factory.mktemp("serving_build")
    for name in os.listdir(src):
        if name == "Makefile" or name.endswith((".cc", ".h")):
            shutil.copy(os.path.join(src, name), build / name)
    r = subprocess.run(["make", "-C", str(build), "serving", "PJRT_INC="],
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-2000:]
    return str(build / "paddle_tpu_serving")


class _Daemon:
    def __init__(self, binary, *flags):
        self.proc = subprocess.Popen(
            [binary, "--port", "0", *flags], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
        line = ""
        for _ in range(32):
            line = self.proc.stdout.readline()
            if "paddle_tpu_serving on port" in line:
                break
        assert "paddle_tpu_serving on port" in line, line
        self.port = int(line.split("port")[1].split()[0])
        deadline = time.time() + 10
        while time.time() < deadline:
            try:
                if self.get("/healthz").startswith("ok"):
                    return
            except OSError:
                time.sleep(0.05)
        raise RuntimeError("daemon did not become healthy")

    def get(self, path):
        with urllib.request.urlopen(
                f"http://127.0.0.1:{self.port}{path}", timeout=30) as r:
            return r.read().decode()

    def post(self, path, obj):
        req = urllib.request.Request(f"http://127.0.0.1:{self.port}{path}",
                                     data=json.dumps(obj).encode())
        with urllib.request.urlopen(req, timeout=60) as r:
            return json.loads(r.read())

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.proc.kill()
        self.proc.wait()


def _multi_input_model():
    """The daemon tests' model: ids + mask and a dense feed, two
    outputs."""
    from paddle_tpu_torch import activation, data_type, layer, pooling

    with torch_name_scope():
        ids = layer.data(name="ids",
                         type=data_type.integer_value_sequence(50))
        den = layer.data(name="den", type=data_type.dense_vector(6))
        emb = layer.embedding(input=ids, size=12)
        pooled = layer.pooling(input=emb, pooling_type=pooling.Avg())
        h = layer.fc(input=[pooled, den], size=16, act=activation.Relu())
        o1 = layer.fc(input=h, size=5, act=activation.Softmax(), name="o1")
        o2 = layer.fc(input=h, size=3, act=activation.Tanh(), name="o2")
    return pt.Topology([o1, o2])


def test_daemon_serves_port_bundles(daemon_binary, tmp_path):
    topo = _multi_input_model()
    params = pt.Parameters.from_numpy(_weights(topo, 9))
    r = np.random.RandomState(0)
    iv = r.randint(0, 50, (3, 6)).astype(np.int32)
    mk = np.ones((3, 6), np.float32)
    mk[1, 4:] = 0
    iv[1, 4:] = 0
    dv = r.rand(3, 6).astype(np.float32)
    with torch.no_grad():
        outs = topo.forward(params.as_dict(), {
            "ids": pt.core.arg.Arg(torch.from_numpy(iv),
                                   torch.from_numpy(mk)),
            "den": torch.from_numpy(dv)})
    golden = {n: outs[n].value.numpy() for n in ("o1", "o2")}
    for mode, tol in (("f32", 1e-5), ("bf16", 5e-3), ("int8", 2e-2)):
        P, qmeta = params, None
        if mode != "f32":
            qd, qmeta = tq.quantize_params(topo, params.as_dict(), mode)
            P = pt.Parameters.from_dict(qd)
        meta = tmm.bundle_meta(topo, P, qmeta=qmeta, seq_len=6)
        path = _write(tmp_path / f"{mode}.ptpu", tmm.write_bundle, topo, P,
                      meta)
        with _Daemon(daemon_binary, "--bundle", path, "--backend",
                     "interp") as d:
            resp = d.post("/v1/infer", {"inputs": {
                "ids": iv.tolist(), "ids:mask": mk.tolist(),
                "den": dv.tolist()}})
            sig = json.loads(d.get("/v1/signature"))
        for name in ("o1", "o2"):
            got = np.array(resp["outputs"][name]["data"], np.float32) \
                .reshape(resp["outputs"][name]["shape"])
            err = np.max(np.abs(got - golden[name]))
            assert err < tol, (mode, name, err)
        assert sig["param_bytes"] == tmm.read_bundle_meta(path)[
            "param_bytes"]
        assert sig["param_bytes"] == tq.param_bytes(P.as_dict())
