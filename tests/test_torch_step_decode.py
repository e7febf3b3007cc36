"""The port's per-slot step decode against the JAX package on the CPU, at
tests/test_export_parity.py's sizes (V 120, K 16, T 5, L 10, widths 8).

- ``BeamStepExport`` (layers/recurrent_group.py): init and every tick on
  the same named state as the JAX package's ``init_fn``/``step_fn``
  (called directly, jitted, not through the StableHLO export), for beam 1
  dense and beam 4 compact: ids, tokens, t, cap, done and emitted exact,
  scores and the rest within 1e-5. The eos bias is picked so that the
  slots end at different ticks, and the test asserts they do: the
  vector-t path runs.
- ``StepDecodeDriver`` (step_decode.py) over ``export_decode_step_ex``
  (io/merged_model.py): drain mode equal to the port's whole-loop decode
  and to the JAX live decode; mid-decode admission equal to each
  request's solo decode; a per-slot cap equal to scheduler-side
  truncation with the neighbours untouched.
- ``beam_step_unsupported``'s reasons equal to JAX's strings; the
  export's signature equal to the JAX step's names, dtypes and shapes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pj
from paddle_tpu.core.arg import Arg as JArg
from paddle_tpu.core.layer import layer_name_scope as jax_name_scope
from paddle_tpu.layers.recurrent_group import \
    BeamSearchControlCallbacks as JCallbacks
from paddle_tpu.layers.recurrent_group import BeamStepExport as JStep
from paddle_tpu.layers.recurrent_group import \
    beam_step_unsupported as j_unsupported
from paddle_tpu.models.text import nmt_decode_topology as jax_nmt_decode

import paddle_tpu_torch as pt
from paddle_tpu_torch.core.arg import Arg as TArg
from paddle_tpu_torch.core.layer import layer_name_scope as torch_name_scope
from paddle_tpu_torch.io.merged_model import export_decode_step_ex
from paddle_tpu_torch.layers.recurrent_group import \
    BeamSearchControlCallbacks as TCallbacks
from paddle_tpu_torch.layers.recurrent_group import BeamStepExport as TStep
from paddle_tpu_torch.layers.recurrent_group import \
    beam_step_unsupported as t_unsupported
from paddle_tpu_torch.models.text import \
    nmt_decode_topology as torch_nmt_decode
from paddle_tpu_torch.step_decode import StepDecodeDriver
from paddle_tpu_torch.utils.error import Error

V, K, T, L = 120, 16, 5, 10
SCORE_TOL = dict(rtol=1e-5, atol=1e-5)
EXACT = ("state:tokens", "state:ids", "state:t", "state:cap", "emitted",
         "done")
# (beam, mode, eos bias): with the output projection OUT_SCALE times
# wider, the bias spreads the slots' end ticks (1 to 10)
CASES = [(1, "dense", 3.0), (4, "compact", 4.0)]
OUT_SCALE = 10.0


def _gens(beam, mode, **kw):
    cfg = dict(src_dict_dim=V, trg_dict_dim=V, word_vector_dim=8,
               encoder_size=8, decoder_size=8, beam_size=beam, max_length=L,
               cand_k=K, mode=mode, name="m", **kw)
    with jax_name_scope():
        jg = jax_nmt_decode(**cfg)
    with torch_name_scope():
        tg = torch_nmt_decode(**cfg)
    return jg, tg


def _weights(jgen, eos_bias, seed=0):
    d = {k: np.array(v) for k, v in
         pj.Topology(jgen).init_params(jax.random.PRNGKey(seed)).items()}
    d["_m_out.w0"] *= OUT_SCALE
    d["_m_out.wbias"][..., 1] += eos_bias
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


def _batch(reqs, arg, conv):
    feeds = {"src": arg(conv(np.stack([f["src"] for f in reqs])),
                        conv(np.stack([f["src:mask"] for f in reqs])))}
    if "cand" in reqs[0]:
        feeds["cand"] = arg(conv(np.stack([f["cand"] for f in reqs])))
    return feeds


def _jax_live(jgen, d, reqs):
    _o, ctx = pj.Topology(jgen).forward(
        {k: jnp.asarray(v) for k, v in d.items()},
        _batch(reqs, JArg, jnp.asarray), return_ctx=True)
    return (np.asarray(ctx.extras["m_gen:ids"]),
            np.asarray(ctx.extras["m_gen:scores"]),
            int(ctx.extras["m_gen:ticks"]))


def _torch_live(tgen, d, reqs):
    with torch.no_grad():
        _o, ctx = pt.Topology(tgen).forward(
            {k: torch.from_numpy(v) for k, v in d.items()},
            _batch(reqs, TArg, torch.from_numpy), return_ctx=True)
    return (ctx.extras["m_gen:ids"].numpy(),
            ctx.extras["m_gen:scores"].numpy(), int(ctx.extras["m_gen:ticks"]))


def _same_state(got, want, names):
    for n in names:
        if n in EXACT:
            np.testing.assert_array_equal(got[n], want[n], err_msg=n)
        else:
            np.testing.assert_allclose(got[n], want[n], **SCORE_TOL,
                                       err_msg=n)


@pytest.mark.parametrize("beam,mode,eos_bias", CASES)
def test_step_matches_jax_tick_by_tick(beam, mode, eos_bias):
    """S requests in one init, then every tick from the same named state
    through both packages' steps, until every slot is done; the slots'
    end ticks differ."""
    S = 4
    jg, tg = _gens(beam, mode)
    d = _weights(jg, eos_bias)
    reqs = _requests(S, mode)
    jex, tex = JStep(pj.Topology(jg)), TStep(pt.Topology(tg))
    assert tex.state_names() == jex.state_names()
    jparams = {k: jnp.asarray(v) for k, v in d.items()}
    tparams = {k: torch.from_numpy(v) for k, v in d.items()}
    jinit = {k: np.asarray(v) for k, v in
             jax.jit(jex.init_fn)(jparams,
                                  _batch(reqs, JArg, jnp.asarray)).items()}
    with torch.no_grad():
        tinit = {k: v.numpy() for k, v in
                 tex.init_fn(tparams,
                             _batch(reqs, TArg, torch.from_numpy)).items()}
    assert set(tinit) == set(jinit)
    for n in jinit:
        assert tinit[n].dtype == jinit[n].dtype and \
            tinit[n].shape == jinit[n].shape, n
    _same_state(tinit, jinit, jinit)

    jstep = jax.jit(jex.step_fn)
    state = jinit
    done_at = [None] * S
    for tick in range(L + 2):
        jout = {k: np.asarray(v) for k, v in
                jstep(jparams, {k: jnp.asarray(v)
                                for k, v in state.items()}).items()}
        with torch.no_grad():
            tout = {k: v.numpy() for k, v in
                    tex.step_fn(tparams, {k: torch.from_numpy(v.copy())
                                          for k, v in state.items()}).items()}
        assert set(tout) == set(jout)
        _same_state(tout, jout, jout)
        for s in range(S):
            if done_at[s] is None and jout["done"][s]:
                done_at[s] = tick + 1
        state = dict(state, **{n: jout[n] for n in jex.state_names()})
    assert None not in done_at
    assert len(set(done_at)) > 1, f"every slot ended at tick {done_at[0]}"


def _export(tg, d, slots):
    res, reason = export_decode_step_ex(
        pt.Topology(tg), pt.Parameters.from_numpy(d), slots=slots,
        seq_len=T, device="cpu")
    assert reason is None, reason
    return res


@pytest.mark.parametrize("beam,mode,eos_bias", CASES)
def test_drain_driver_matches_whole_loop(beam, mode, eos_bias):
    """Drain mode with S co-admitted requests: ids equal to the port's
    whole-loop decode and the JAX live decode, scores within 1e-5, the
    whole loop's ticks the largest slot's; the signature is the JAX
    step's."""
    S = 4
    jg, tg = _gens(beam, mode)
    d = _weights(jg, eos_bias)
    res = _export(tg, d, S)
    sig = res["signature"]
    assert (sig["slots"], sig["beam"], sig["max_length"], sig["eos_id"],
            sig["bos_id"]) == (S, beam, L, 1, 0)
    jex = JStep(pj.Topology(jg))
    assert [e["name"] for e in sig["state"]] == jex.state_names()
    assert all(e["shape"][0] == "b" for e in sig["state"] + sig["enc"])
    assert [e["name"] for e in sig["extra_outputs"]] == ["emitted", "done"]
    assert sig["step_outputs"] == jex.state_names() + ["emitted", "done"]
    reqs = _requests(S, mode)
    jinit = jax.eval_shape(jex.init_fn,
                           {k: jnp.asarray(v) for k, v in d.items()},
                           _batch(reqs, JArg, jnp.asarray))
    tags = {"float32": "f32", "int32": "i32"}
    for e in sig["state"] + sig["enc"]:
        assert e["shape"][1:] == list(jinit[e["name"]].shape[1:]), e
        assert e["dtype"] == tags[jinit[e["name"]].dtype.name], e
    assert sig["init_outputs"] == [e["name"] for e in sig["state"]
                                   + sig["enc"]]

    drv = StepDecodeDriver(res, drain=True)
    handles = [drv.submit(f) for f in reqs]
    drv.run()
    assert drv.admissions == {"fresh": S, "mid_batch": 0}
    got_ids = np.stack([h.ids for h in sorted(handles,
                                              key=lambda h: h.slot)])
    got_sc = np.stack([h.scores for h in sorted(handles,
                                                key=lambda h: h.slot)])
    t_ids, t_sc, t_ticks = _torch_live(tg, d, reqs)
    j_ids, j_sc, j_ticks = _jax_live(jg, d, reqs)
    np.testing.assert_array_equal(got_ids, t_ids)
    np.testing.assert_array_equal(got_ids, j_ids)
    np.testing.assert_allclose(got_sc, t_sc, **SCORE_TOL)
    np.testing.assert_allclose(got_sc, j_sc, **SCORE_TOL)
    assert max(h.ticks for h in handles) == t_ticks == j_ticks
    assert len({h.ticks for h in handles}) > 1
    for h in handles:
        assert h.tokens[-1] == h.ids[np.argmax(h.scores)][h.ticks - 1] \
            or h.ticks == L
        assert h.best_ids[-1] == 1 or len(h.best_ids) == L


def test_mid_decode_admission_matches_solo_decode():
    """A request admitted into a freed slot while others decode gives
    exactly its solo decode's ids, tokens and ticks, and the solo decode
    the whole loop's ids for that request alone."""
    jg, tg = _gens(2, "compact")
    d = _weights(jg, 4.0)
    res = _export(tg, d, 2)
    reqs = _requests(6, "compact")
    drv = StepDecodeDriver(res, drain=False)
    handles = [drv.submit(f) for f in reqs]
    drv.run()
    assert drv.admissions["mid_batch"] >= 1
    for i, h in enumerate(handles):
        solo = StepDecodeDriver(res, drain=False)
        sh = solo.submit(reqs[i])
        solo.run()
        np.testing.assert_array_equal(h.ids, sh.ids)
        np.testing.assert_array_equal(h.tokens, sh.tokens)
        assert h.ticks == sh.ticks
        ids, _sc, ticks = _torch_live(tg, d, [reqs[i]])
        np.testing.assert_array_equal(sh.ids[None], ids)
        assert sh.ticks == ticks


def test_per_slot_cap_matches_scheduler_truncation():
    """submit(max_new=k) stops the slot at k ticks, its tokens the first k
    of the uncapped decode; the neighbours are untouched; a cap above
    max_length changes nothing; the tick budget raises."""
    jg, tg = _gens(2, "compact")
    d = _weights(jg, 4.0)
    res = _export(tg, d, 2)
    reqs = _requests(3, "compact")
    ref = StepDecodeDriver(res, drain=False)
    rh = [ref.submit(f) for f in reqs]
    ref.run()
    assert rh[0].ticks >= 2
    k = rh[0].ticks - 1
    drv = StepDecodeDriver(res, drain=False)
    handles = [drv.submit(reqs[0], max_new=k), drv.submit(reqs[1]),
               drv.submit(reqs[2])]
    drv.run()
    assert handles[0].ticks == k
    np.testing.assert_array_equal(handles[0].tokens, rh[0].tokens[:k])
    for h, r in zip(handles[1:], rh[1:]):
        assert h.ticks == r.ticks
        np.testing.assert_array_equal(h.ids, r.ids)
        np.testing.assert_array_equal(h.tokens, r.tokens)
    roomy = StepDecodeDriver(res, drain=False)
    h2 = roomy.submit(reqs[0], max_new=L + 7)
    roomy.run()
    assert h2.ticks == rh[0].ticks
    np.testing.assert_array_equal(h2.ids, rh[0].ids)
    stuck = StepDecodeDriver(res, drain=False)
    stuck.submit(reqs[0])
    with pytest.raises(RuntimeError, match="did not converge"):
        stuck.run(max_ticks=1)


def _unsupported_cases(key):
    """Generation topologies the step cannot export, built in one
    package, plus one it can."""
    mod, scope = (pj, jax_name_scope) if key == "jax" else \
        (pt, torch_name_scope)
    decode = jax_nmt_decode if key == "jax" else torch_nmt_decode
    cb = JCallbacks if key == "jax" else TCallbacks
    cfg = dict(src_dict_dim=V, trg_dict_dim=V, word_vector_dim=8,
               encoder_size=8, decoder_size=8, beam_size=2, max_length=6,
               cand_k=K, mode="compact", name="m")
    out = {}
    with scope():
        x = mod.layer.data(name="x", type=mod.data_type.dense_vector(4))
        out["no_beam"] = mod.Topology(mod.layer.fc(input=x, size=3,
                                                   name="out"))
    with scope():
        g = decode(**cfg)
        g.cfg["ctrl_callbacks"] = cb(norm_or_drop=lambda i, s, n: s)
        out["callbacks"] = mod.Topology(g)
    with scope():
        g = decode(**cfg)
        g.cfg["num_results_per_sample"] = 2
        out["num_results"] = mod.Topology(g)
    with scope():
        g = decode(**cfg)
        out["feeds_a_layer"] = mod.Topology(mod.layer.fc(input=g, size=3,
                                                         name="after"))
    with scope():
        out["servable"] = mod.Topology(decode(**cfg))
    return out


def test_unsupported_reasons_match_jax():
    """beam_step_unsupported gives the JAX package's strings; the port's
    BeamStepExport and export_decode_step_ex refuse with them."""
    jc, tc = _unsupported_cases("jax"), _unsupported_cases("torch")
    for name in jc:
        want = j_unsupported(jc[name])
        assert t_unsupported(tc[name]) == want, name
        if name == "servable":
            assert want is None
            continue
        assert want
        with pytest.raises(Error, match="decode step export"):
            TStep(tc[name])
        res, reason = export_decode_step_ex(tc[name], pt.Parameters(),
                                            device="cpu")
        assert res is None and reason == want
