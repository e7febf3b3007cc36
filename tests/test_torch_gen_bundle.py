"""Generation bundles across the two packages on the CPU, at
tests/test_export_parity.py's sizes (V 120, K 16, widths 8, beam 2,
max_length 6, T 5, 2 slots).

- The GRU forward as the dispatcher op ``paddle_tpu_torch::gru_fwd``: its
  CPU implementation is the plain version, with and without the stash and
  resets; ``torch.library.opcheck`` passes. A GRU topology's forward
  artifact holds the op and, run in a fresh process, matches JAX's
  ``Topology.forward``; a GRU past the kernel's width (H > 644) traces
  the generic loop, and its artifact holds no op.
- The beam decode's whole loop as one artifact, compact and dense: JAX's
  output names (``:ids``, ``:scores``, ``:ticks``), ids and ticks equal to
  JAX's live decode, scores within 1e-5, at the static and a smaller
  batch.
- The decode step's ``init``/``step`` artifacts: the signature equal to
  JAX's ``export_decode_step_stablehlo_ex``'s, key for key and in order,
  less JAX's per-platform ``module_errors``; a port-written bundle served
  by ``driver_from_bundle_meta(device="cpu")`` decodes JAX's
  ``driver_from_bundle_meta`` ids on the same requests, in drain and in
  continuous mode with admissions in mid-decode; an int8 bundle carries
  both artifacts and decodes the in-process driver's ids over the
  dequantized parameters.
- Skip reasons equal to JAX's: beam-control callbacks, a beam output that
  feeds a layer, the 32 MiB cap; a non-generation bundle carries no step
  key, a generation one the port's ``stablehlo_step_skip_reason``.

Tolerances: scores rtol/atol 1e-5 (float32 through two compilers' sums),
the GRU artifact against JAX rtol 1e-5, atol 1e-6; ids and ticks exact.
"""

import base64
import io
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pj
from paddle_tpu.core.arg import Arg as JArg
from paddle_tpu.core.layer import layer_name_scope as jax_name_scope
from paddle_tpu.io import merged_model as jmm
from paddle_tpu.layers.recurrent_group import \
    BeamSearchControlCallbacks as JCallbacks
from paddle_tpu.models.text import nmt_decode_topology as jax_nmt_decode
from paddle_tpu.step_decode import driver_from_bundle_meta as j_driver

import paddle_tpu_torch as pt
from paddle_tpu_torch import kernels as tk
from paddle_tpu_torch import quant as tq
from paddle_tpu_torch.core.arg import Arg as TArg
from paddle_tpu_torch.core.layer import layer_name_scope as torch_name_scope
from paddle_tpu_torch.io import merged_model as tmm
from paddle_tpu_torch.kernels.gru import fused_gru_plain, gru_fwd_op
from paddle_tpu_torch.layers.recurrent_group import \
    BeamSearchControlCallbacks as TCallbacks
from paddle_tpu_torch.models.text import \
    nmt_decode_topology as torch_nmt_decode
from paddle_tpu_torch.step_decode import (StepDecodeDriver,
                                          driver_from_bundle_meta)
from paddle_tpu_torch.utils.error import Error

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
V, K, T, L, BEAM, SLOTS, STATIC_B = 120, 16, 5, 6, 2, 2, 4
SCORE_TOL = dict(rtol=1e-5, atol=1e-5)
TOL = dict(rtol=1e-5, atol=1e-6)
# the output projection OUT_SCALE times wider and eos's bias raised so
# that the decodes end at different ticks (2 to 6 with these weights)
OUT_SCALE = 10.0
EOS_BIAS = {"compact": 5.0, "dense": 3.0}
N_REQUESTS = 6
OP = "paddle_tpu_torch.gru_fwd"


def _nmt_cfg(mode, **kw):
    return dict(src_dict_dim=V, trg_dict_dim=V, word_vector_dim=8,
                encoder_size=8, decoder_size=8, beam_size=BEAM,
                max_length=L, cand_k=K, mode=mode, name="m", **kw)


def _gens(mode, **kw):
    with jax_name_scope():
        jg = jax_nmt_decode(**_nmt_cfg(mode, **kw))
    with torch_name_scope():
        tg = torch_nmt_decode(**_nmt_cfg(mode, **kw))
    return jg, tg


def _weights(jt, mode):
    d = {k: np.array(v) for k, v in
         jt.init_params(jax.random.PRNGKey(0)).items()}
    d["_m_out.w0"] *= OUT_SCALE
    d["_m_out.wbias"][..., 1] += EOS_BIAS[mode]
    return d


def _requests(n, mode, seed=3):
    r = np.random.RandomState(seed)
    reqs = []
    for _ in range(n):
        feeds = {"src": r.randint(0, V, (T,)).astype(np.int32),
                 "src:mask": np.ones(T, np.float32)}
        if mode != "dense":
            cand = r.choice(V, K, replace=False).astype(np.int32)
            if not (cand == 1).any():
                cand[0] = 1                      # eos in every row
            feeds["cand"] = cand.astype(np.float32)
        reqs.append(feeds)
    return reqs


def _stack(reqs):
    return {k: np.stack([f[k] for f in reqs]) for k in reqs[0]}


def _jax_live(jt, d, reqs):
    a = _stack(reqs)
    feeds = {"src": JArg(jnp.asarray(a["src"]), jnp.asarray(a["src:mask"]))}
    if "cand" in a:
        feeds["cand"] = JArg(jnp.asarray(a["cand"].astype(np.int32)))
    _o, ctx = jt.forward({k: jnp.asarray(v) for k, v in d.items()}, feeds,
                         return_ctx=True)
    return (np.asarray(ctx.extras["m_gen:ids"]),
            np.asarray(ctx.extras["m_gen:scores"]),
            int(ctx.extras["m_gen:ticks"]))


class _Model:
    """One decode mode in both packages: topologies, weights, the port's
    bundle meta (forward and step artifacts) and JAX's exports of the
    same."""

    def __init__(self, mode, tmp):
        self.mode = mode
        jg, tg = _gens(mode)
        self.jt, self.tt = pj.Topology(jg), pt.Topology(tg)
        self.d = _weights(self.jt, mode)
        self.jp = pj.Parameters.from_dict(self.d)
        self.tp = pt.Parameters.from_numpy(self.d)
        self.meta = tmm.bundle_meta(self.tt, self.tp, seq_len=T,
                                    static_batch=STATIC_B, slots=SLOTS)
        self.path = str(tmp / f"{mode}.ptpu")
        with open(self.path, "wb") as f:
            tmm.write_bundle(f, self.tt, self.tp, meta=self.meta, version=1)
        self.jfwd, reason = jmm.export_forward_stablehlo_ex(
            self.jt, self.jp, seq_len=T, static_batch=STATIC_B)
        assert reason is None, reason
        self.jstep, reason = jmm.export_decode_step_stablehlo_ex(
            self.jt, self.jp, seq_len=T, slots=SLOTS)
        assert reason is None, reason


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("gen")
    cache = {}

    def get(mode):
        if mode not in cache:
            cache[mode] = _Model(mode, tmp)
        return cache[mode]
    return get


# --- the op -------------------------------------------------------------------

def _gru_inputs(seed=7, B=3, Tn=5, H=8):
    r = np.random.RandomState(seed)
    x3, wg, wc, b = (torch.from_numpy((r.randn(*s) * 0.5).astype(np.float32))
                     for s in ((B, Tn, 3 * H), (H, 2 * H), (H, H), (3 * H,)))
    mask = torch.ones(B, Tn)
    mask[1, 3:] = 0
    reset = torch.zeros(B, Tn)
    reset[2, 2] = 1
    return x3, wg, wc, b, mask, reset


def test_op_cpu_implementation_is_the_plain_version():
    x3, wg, wc, b, mask, reset = _gru_inputs()
    before = dict(tk.launches)
    for rs in (reset, None):
        hs, gates = gru_fwd_op(x3, wg, wc, b, mask, rs, True, 0, 0, 0)
        want = fused_gru_plain(x3, wg, wc, b, mask, rs, with_gates=True)
        assert torch.equal(hs, want[0]) and torch.equal(gates, want[1])
        hs2, empty = gru_fwd_op(x3, wg, wc, b, mask, rs, False, 0, 0, 0)
        assert empty.numel() == 0
        assert torch.equal(hs2, fused_gru_plain(x3, wg, wc, b, mask, rs))
    # a forced plan is the card's business: the CPU runs the plain version
    hs3, _ = gru_fwd_op(x3, wg, wc, b, mask, reset, False, 2, 2, 4)
    assert torch.equal(hs3, fused_gru_plain(x3, wg, wc, b, mask, reset))
    assert tk.launches == before                    # no kernel here
    for rs, stash in ((reset, True), (None, False)):
        torch.library.opcheck(gru_fwd_op,
                              (x3, wg, wc, b, mask, rs, stash, 0, 0, 0))


def test_every_entry_reaches_the_op():
    """fused_gru_fwd and fused_gru, without a gradient and with one
    (_FusedGRU, forward and backward), each call the op once."""
    from torch.utils._python_dispatch import TorchDispatchMode

    from paddle_tpu_torch.kernels.gru import fused_gru, fused_gru_fwd

    class Ops(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.seen = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.seen.append(str(func))
            return func(*args, **(kwargs or {}))

    x3, wg, wc, b, mask, reset = _gru_inputs()
    wg.requires_grad_(True)
    calls = (lambda: fused_gru_fwd(x3, wg.detach(), wc, b, mask, reset),
             lambda: fused_gru(x3, wg.detach(), wc, b, mask),
             lambda: fused_gru(x3, wg, wc, b, mask, reset).sum().backward())
    for call in calls:
        with Ops() as ops:
            call()
        assert ops.seen.count("paddle_tpu_torch.gru_fwd.default") == 1


# --- a GRU topology's forward artifact ------------------------------------------

def _gru_classifier(layer, data_type, act, scope, H):
    with scope():
        words = layer.data(name="words",
                           type=data_type.integer_value_sequence(50))
        emb = layer.embedding(input=words, size=8)
        fwd = layer.grumemory(input=layer.fc(input=emb, size=3 * H),
                              name="gf")
        bwd = layer.grumemory(input=layer.fc(input=emb, size=3 * H),
                              reverse=True, name="gb")
        return layer.fc(input=[layer.last_seq(input=fwd),
                               layer.first_seq(input=bwd)], size=2,
                        act=act.Softmax(), name="out")


def _gru_models(H):
    from paddle_tpu import activation as ja, data_type as jd, layer as jl
    from paddle_tpu_torch import activation as ta, data_type as td, \
        layer as tl

    jt = pj.Topology(_gru_classifier(jl, jd, ja, jax_name_scope, H))
    tt = pt.Topology(_gru_classifier(tl, td, ta, torch_name_scope, H))
    r = np.random.RandomState(0)
    d = {n: (r.randn(*s.shape) * 0.3).astype(np.float32)
         for n, s in sorted(jt.param_specs().items())}
    return jt, tt, d


def _graph(artifact_b64):
    return str(torch.export.load(io.BytesIO(
        base64.b64decode(artifact_b64))).graph)


_FRESH = """
import json, sys
import numpy as np
import paddle_tpu_torch  # noqa: F401  (registers the custom ops)
from paddle_tpu_torch.io.merged_model import (load_forward_export,
                                              read_bundle_meta)
fx = load_forward_export(read_bundle_meta(sys.argv[1]), device="cpu")
ids, mask = np.load(sys.argv[2]), np.load(sys.argv[3])
outs = [fx(ids[:B], mask[:B]).numpy().tolist() for B in (ids.shape[0], 3)]
print(json.dumps({"outs": outs, "jax": sorted(
    m for m in sys.modules if m.split(".")[0] in ("jax", "paddle_tpu"))}))
"""


def test_gru_artifact_runs_in_a_fresh_process(tmp_path):
    """A bidirectional GRU classifier's artifact (symbolic batch, static
    batch 4, T 7) holds the op; loaded in a process that never built the
    model, it matches JAX's forward at B = 4 and B = 3."""
    jt, tt, d = _gru_models(8)
    meta = tmm.bundle_meta(tt, pt.Parameters.from_numpy(d), seq_len=7,
                           static_batch=4)
    assert "torch_step" not in meta and "torch_step_skip_reason" not in meta
    sig = meta["torch_export"]["signature"]
    assert sig["symbolic_batch"]
    assert _graph(meta["torch_export"]["artifact_b64"]).count(OP) == 2
    path = str(tmp_path / "gru.ptpu")
    with open(path, "wb") as f:
        tmm.write_bundle(f, tt, pt.Parameters.from_numpy(d), meta=meta)
    r = np.random.RandomState(4)
    ids = r.randint(0, 50, (4, 7)).astype(np.int32)
    mask = np.ones((4, 7), np.float32)
    mask[1, 4:] = 0
    mask[3, 2:] = 0
    np.save(tmp_path / "ids.npy", ids)
    np.save(tmp_path / "mask.npy", mask)
    out = subprocess.run(
        [sys.executable, "-c", _FRESH, path, str(tmp_path / "ids.npy"),
         str(tmp_path / "mask.npy")],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["jax"] == []
    for got, B in zip(res["outs"], (4, 3)):
        want = jt.forward({k: jnp.asarray(v) for k, v in d.items()},
                          {"words": JArg(jnp.asarray(ids[:B]),
                                         jnp.asarray(mask[:B]))})
        np.testing.assert_allclose(np.array(got, np.float32),
                                   np.asarray(want["out"].value), **TOL)


def test_gru_past_the_kernel_traces_the_loop():
    """At H = 648 fused_gru_supported refuses, so the card's eager code
    runs the generic loop: the artifact does the same, with no op."""
    from paddle_tpu_torch.kernels.gru import fused_gru_supported

    assert not fused_gru_supported(4, 648) and fused_gru_supported(4, 644)
    _jt, tt, d = _gru_models(648)
    res, reason = tmm.export_forward_ex(tt, pt.Parameters.from_numpy(d),
                                        seq_len=3, static_batch=2)
    assert reason is None, reason
    program = torch.export.load(io.BytesIO(res["artifact"]))
    assert OP not in str(program.graph)


# --- the whole-loop decode artifact -------------------------------------------

def _torch_live(m, reqs):
    """The port's eager decode (the early exit on the host)."""
    a = _stack(reqs)
    feeds = {"src": TArg(torch.from_numpy(a["src"]),
                                    torch.from_numpy(a["src:mask"]))}
    if "cand" in a:
        feeds["cand"] = TArg(torch.from_numpy(
            a["cand"].astype(np.int32)))
    with torch.no_grad():
        _o, ctx = m.tt.forward({k: torch.from_numpy(v)
                                for k, v in m.d.items()}, feeds,
                               return_ctx=True)
    return ctx.extras["m_gen:ticks"]


@pytest.mark.parametrize("mode", ["compact", "dense"])
def test_whole_loop_artifact_matches_jax(models, mode):
    """The decode's whole loop is one artifact with JAX's output names.
    At the static batch its ids and ticks equal JAX's live decode, its
    scores within 1e-5; at B = 3 its rows are those rows (each decodes
    alone); at B = 3 and at B = 1 its ticks are the eager early exit's,
    some of them fewer than max_length."""
    m = models(mode)
    sig = m.meta["torch_export"]["signature"]
    names = [o["name"] for o in sig["outputs"]]
    assert names == [o["name"] for o in m.jfwd["signature"]["outputs"]]
    assert names[-3:] == ["m_gen:ids", "m_gen:scores", "m_gen:ticks"]
    assert sig["outputs"][-1] == {"name": "m_gen:ticks", "dtype": "i32",
                                  "shape": []}
    assert sig["symbolic_batch"]
    fx = tmm.load_forward_export(m.meta, device="cpu")
    assert str(fx._module.graph).count(OP) == 2
    reqs = _requests(STATIC_B, mode)
    a = _stack(reqs)

    def run(rows):
        return dict(zip(names, fx(*[a[s["name"]][rows]
                                    for s in sig["inputs"]])))
    ids, scores, ticks = _jax_live(m.jt, m.d, reqs)
    got = run(slice(None))
    np.testing.assert_array_equal(got["m_gen:ids"].numpy(), ids)
    np.testing.assert_allclose(got["m_gen:scores"].numpy(), scores,
                               **SCORE_TOL)
    assert got["m_gen:ticks"].dtype == torch.int32
    assert int(got["m_gen:ticks"]) == ticks
    got = run(slice(0, 3))
    np.testing.assert_array_equal(got["m_gen:ids"].numpy(), ids[:3])
    np.testing.assert_allclose(got["m_gen:scores"].numpy(), scores[:3],
                               **SCORE_TOL)
    assert int(got["m_gen:ticks"]) == _torch_live(m, reqs[:3])
    solo = []
    for i in range(STATIC_B):
        got = run(slice(i, i + 1))
        np.testing.assert_array_equal(got["m_gen:ids"].numpy(), ids[i:i + 1])
        solo.append(int(got["m_gen:ticks"]))
        assert solo[-1] == _torch_live(m, reqs[i:i + 1])
    assert min(solo) < L, solo


# --- the step artifacts -------------------------------------------------------

@pytest.mark.parametrize("mode", ["compact", "dense"])
def test_step_signature_matches_jax(models, mode):
    m = models(mode)
    got = m.meta["torch_step"]["signature"]
    want = {k: v for k, v in m.jstep["signature"].items()
            if k not in ("modules", "module_errors")}
    assert list(got) == list(want)
    assert got == want
    assert m.meta["torch_step"]["slots"] == SLOTS
    assert m.meta["stablehlo_step_skip_reason"] == \
        tmm.STABLEHLO_STEP_SKIP_REASON
    json.dumps(m.meta["torch_step"]["signature"])


def _drive(driver, reqs):
    hs = [driver.submit(f) for f in reqs]
    driver.run()
    return hs


def test_bundle_round_trip_decodes_jax_ids(models):
    """write_bundle -> read_bundle_meta -> driver_from_bundle_meta on the
    CPU: each request's ids and ticks those of JAX's
    driver_from_bundle_meta on JAX's step export, scores within 1e-5, in
    drain mode and in continuous mode, where a slot freed mid-decode takes
    the next request (compact mode)."""
    mode = "compact"
    m = models(mode)
    meta = tmm.read_bundle_meta(m.path)
    jmeta = jmm.stablehlo_step_meta(m.jstep)
    reqs = _requests(N_REQUESTS, mode)
    for drain in (True, False):
        drv = driver_from_bundle_meta(meta, drain=drain, device="cpu")
        assert drv.device == torch.device("cpu")
        jdrv = j_driver(jmeta, drain=drain)
        got, want = _drive(drv, reqs), _drive(jdrv, reqs)
        assert drv.admissions == jdrv.admissions
        if not drain:
            assert drv.admissions["mid_batch"] >= 1
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.ids, w.ids)
            np.testing.assert_allclose(g.scores, w.scores, **SCORE_TOL)
            assert g.ticks == w.ticks and g.tokens == w.tokens
    ticks = {h.ticks for h in got}
    assert len(ticks) > 1, f"every request ran {ticks} ticks"


def test_int8_bundle_carries_both_artifacts():
    """An int8 dense bundle under the cap: both artifacts, int8 constants
    in each; its step artifacts decode the ids of the in-process driver
    over the dequantized parameters."""
    jg, tg = _gens("dense")
    tt = pt.Topology(tg)
    d = _weights(pj.Topology(jg), "dense")
    qd, qmeta = tq.quantize_params(
        tt, {k: torch.from_numpy(v) for k, v in d.items()}, "int8")
    P = pt.Parameters.from_dict(qd)
    meta = tmm.bundle_meta(tt, P, qmeta=qmeta, seq_len=T,
                           static_batch=STATIC_B, slots=SLOTS)
    assert "torch_export" in meta and "torch_step" in meta
    assert meta["torch_step"]["signature"]["quantize"] == "int8"
    drv = driver_from_bundle_meta(meta, device="cpu")
    for module in (drv._init._fn, drv._step._fn):
        assert torch.int8 in {t.dtype for t in module.buffers()}
    reqs = _requests(N_REQUESTS, "dense")
    got = _drive(drv, reqs)
    deq = tmm.dequantize_bundle_params(P, meta)
    live, reason = tmm.export_decode_step_ex(tt, deq, slots=SLOTS,
                                             seq_len=T, device="cpu")
    assert reason is None, reason
    want = _drive(StepDecodeDriver(live), reqs)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.ids, w.ids)
        np.testing.assert_allclose(g.scores, w.scores, **SCORE_TOL)


# --- skip reasons ---------------------------------------------------------------

def test_skip_reasons_match_jax():
    """beam-control callbacks and a beam output that feeds a layer: the
    port's step artifacts refuse with JAX's reasons; over the 32 MiB cap
    (V 400000) both artifacts do, a bundle records both and its driver
    raises naming the cap; a non-generation bundle carries no step key."""
    cases = {}
    for key, cb in (("jax", JCallbacks), ("torch", TCallbacks)):
        decode = jax_nmt_decode if key == "jax" else torch_nmt_decode
        mod, scope = (pj, jax_name_scope) if key == "jax" else \
            (pt, torch_name_scope)
        with scope():
            g = decode(**_nmt_cfg("compact"))
            g.cfg["ctrl_callbacks"] = cb(norm_or_drop=lambda i, s, n: s)
            cases[key, "callbacks"] = mod.Topology(g)
        with scope():
            g = decode(**_nmt_cfg("compact"))
            cases[key, "feeds_a_layer"] = mod.Topology(
                mod.layer.fc(input=g, size=3, name="after"))
    for name in ("callbacks", "feeds_a_layer"):
        _, want = jmm.export_decode_step_stablehlo_ex(
            cases["jax", name], pj.Parameters.from_dict({}), seq_len=T)
        res, reason = tmm.export_decode_step_artifacts_ex(
            cases["torch", name], pt.Parameters(), seq_len=T)
        assert res is None and want and reason == want, name

    big = dict(_nmt_cfg("compact"), src_dict_dim=400000,
               trg_dict_dim=400000)
    with jax_name_scope():
        jt = pj.Topology(jax_nmt_decode(**big))
    with torch_name_scope():
        tt = pt.Topology(torch_nmt_decode(**big))
    zeros = {n: np.zeros(s.shape, np.float32)
             for n, s in jt.param_specs().items()}
    _, want_fwd = jmm.export_forward_stablehlo_ex(
        jt, pj.Parameters.from_dict(zeros), seq_len=T)
    _, want_step = jmm.export_decode_step_stablehlo_ex(
        jt, pj.Parameters.from_dict(zeros), seq_len=T)
    assert "32 MiB" in want_step
    meta = tmm.bundle_meta(tt, pt.Parameters.from_numpy(zeros), seq_len=T)
    assert meta["torch_export_skip_reason"] == want_fwd
    assert meta["torch_step_skip_reason"] == want_step
    assert "torch_step" not in meta and "torch_export" not in meta
    assert meta["stablehlo_step_skip_reason"] == \
        tmm.STABLEHLO_STEP_SKIP_REASON
    with pytest.raises(Error, match="too large"):
        driver_from_bundle_meta(meta, device="cpu")

    with torch_name_scope():
        x = pt.layer.data(name="x", type=pt.data_type.dense_vector(4))
        plain = pt.Topology(pt.layer.fc(input=x, size=3, name="out"))
    meta = tmm.bundle_meta(plain, pt.Parameters.from_topology(
        plain, torch.Generator().manual_seed(0)))
    assert not {"torch_step", "torch_step_skip_reason",
                "stablehlo_step_skip_reason"} & set(meta)
    with pytest.raises(Error, match="no torch_step"):
        driver_from_bundle_meta(meta, device="cpu")
