"""The port's selective_fc and the selective and compact-K NMT decode
modes against the JAX package on the CPU.

- ``selective_fc`` (layers/misc.py): both packages build the same layer
  with the DSL, take the same numpy-seeded weights and inputs, and give
  the same values and gradients (``jax.grad`` against autograd, w.r.t.
  the parameters and the inputs) at rtol 1e-5 / atol 1e-6: the dense and
  gather paths with the cases of tests/test_selective_fc.py (plain, a -1
  pad next to id 0, an in-row duplicate), a [B, T, K] selection, a
  per-batch selection on a sequence input, pass_generation,
  compact_output (with its per-slot ids), weight_transposed, a dense 0/1
  selection, two inputs, select_unique. Dead slots get zero gradients.
- The decode (networks.gru_encoder_decoder with trg_vocab_select, and
  models.text.nmt_decode_topology) at V = 16 to 50, D = 8: ids equal to
  the live JAX forward's, scores within 1e-5, in selective and compact
  mode; full coverage in compact mode equal to dense; candidate_adjust +
  norm_or_drop in both spaces; num_results_per_sample; early exit equal
  to the full loop; the scoring form's 3D projection; no vocab-wide value
  in a compact decode (a TorchDispatchMode probe, the twin of
  test_selective_decode.py's jaxpr check).

Float32 on both sides; products sum in another order, hence the
tolerances. No test compares against the jax.random golden ids.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode

import paddle_tpu as pj
from paddle_tpu.core.arg import Arg as JArg
from paddle_tpu.core.layer import layer_name_scope as jax_name_scope
from paddle_tpu.models.text import nmt_decode_topology as jax_nmt_decode
from paddle_tpu.utils.error import Error as JError

import paddle_tpu_torch as pt
from paddle_tpu_torch.core.arg import Arg as TArg
from paddle_tpu_torch.core.layer import layer_name_scope as torch_name_scope
from paddle_tpu_torch.models.text import \
    nmt_decode_topology as torch_nmt_decode
from paddle_tpu_torch.utils.error import Error

VAL_TOL = dict(rtol=1e-5, atol=1e-6)
SCORE_TOL = dict(rtol=1e-5, atol=1e-5)
PACKAGES = {"jax": (pj, jax_name_scope), "torch": (pt, torch_name_scope)}

# --- selective_fc ----------------------------------------------------------

C, B, T, D, K = 50, 3, 4, 6, 4
SEQ_MASK = np.array([[1, 1, 1, 1], [1, 1, 0, 0], [1, 0, 0, 0]], np.float32)

# case -> (selection kind, layer knobs); each runs on the dense path
# (gather_min_c above C) and the gather path (0) unless it names one
LAYER_CASES = {
    "plain": ("plain", {}),
    "pad_alias_zero": ("pad_alias_zero", {}),
    "dups": ("dups", {}),
    "seq_selection": ("seq", {}),
    "per_batch_on_seq": ("per_batch", {}),
    "pass_generation": ("pad_alias_zero", dict(pass_generation=True)),
    "weight_transposed": ("dups", dict(weight_transposed=True)),
    "two_inputs": ("dups", dict(n_in=2)),
    "no_bias": ("plain", dict(bias_attr=False)),
    "dense_selection": ("dense", {}),
    "select_unique": ("unique", dict(select_unique=True)),
    "compact": ("dups", dict(compact_output=True)),
    "compact_per_batch": ("per_batch", dict(compact_output=True,
                                            weight_transposed=True)),
}


def _selection(kind, r):
    if kind == "dense":
        return (r.rand(B, C) > 0.6).astype(np.float32)
    if kind == "unique":
        return np.stack([r.choice(C, K, replace=False) for _ in range(B)])
    if kind == "seq":
        sel = r.randint(0, C, (B, T, K))
        sel[0, 0, 0], sel[0, 0, 1] = 0, -1
        sel[1, 1, 2] = sel[1, 1, 1]
        return sel
    sel = r.randint(1, C, (B, K))
    if kind == "pad_alias_zero":
        sel[0, 0] = 0          # a real selection of id 0 ...
        sel[0, 1] = -1         # ... next to a -1 pad (a clip would alias)
        sel[2, 3] = -1         # a row whose pad aliases an unselected 0
    if kind == "dups":
        sel[1, 2] = sel[1, 1]
        sel[2, 0] = -1
    return sel


def _selfc(mod, sel_kind, knobs, gather, k_width):
    knobs = dict(knobs)
    n_in = knobs.pop("n_in", 1)
    seq_x = sel_kind in ("seq", "per_batch")
    dt = mod.data_type
    xs = [mod.layer.data(name=f"x{i}",
                         type=(dt.dense_vector_sequence(D + i) if seq_x
                               else dt.dense_vector(D + i)))
          for i in range(n_in)]
    s = mod.layer.data(name="sel", type=(dt.dense_vector_sequence(k_width)
                                         if sel_kind == "seq"
                                         else dt.dense_vector(k_width)))
    return mod.layer.selective_fc(
        input=xs if n_in > 1 else xs[0], select=s, size=C, name="sf",
        gather_min_c=0 if gather else 10 ** 9, **knobs), seq_x


def _layer_case(case, gather):
    sel_kind, knobs = LAYER_CASES[case]
    r = np.random.RandomState(sorted(LAYER_CASES).index(case))
    sel = _selection(sel_kind, r)
    built = {}
    for key, (mod, scope) in PACKAGES.items():
        with scope():
            built[key] = _selfc(mod, sel_kind, knobs, gather, sel.shape[-1])
    (jout, seq_x), (tout, _) = built["jax"], built["torch"]
    jtopo, ttopo = pj.Topology(jout), pt.Topology(tout)
    shapes = {n: tuple(s.shape) for n, s in jtopo.param_specs().items()}
    assert shapes == {n: tuple(s.shape)
                      for n, s in ttopo.param_specs().items()}
    params = {n: (r.randn(*s) * 0.5).astype(np.float32)
              for n, s in sorted(shapes.items())}
    xs = [r.randn(*((B, T) if seq_x else (B,)), D + i).astype(np.float32)
          for i in range(knobs.get("n_in", 1))]
    return jtopo, ttopo, params, xs, sel, seq_x


def _masks(seq_x, sel):
    x_mask = SEQ_MASK if seq_x else None
    return x_mask, (SEQ_MASK if sel.ndim == 3 else None)


def _jax_run(topo, params, xs, sel, seq_x, ct):
    x_mask, s_mask = _masks(seq_x, sel)
    wrap = lambda v, m: JArg(v, None if m is None else jnp.asarray(m))

    def loss(p, xv):
        feeds = {f"x{i}": wrap(x, x_mask) for i, x in enumerate(xv)}
        feeds["sel"] = wrap(jnp.asarray(sel, jnp.float32), s_mask)
        outs, ctx = topo.forward(p, feeds, return_ctx=True)
        o = outs["sf"].value
        # filled entries (-1e30) carry no loss
        return jnp.sum(jnp.where(o > -1e29, o, 0.0) * ct), \
            (o, ctx.extras.get("selfc_compact"))

    (_, (o, extra)), (gp, gx) = jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True)(
            {k: jnp.asarray(v) for k, v in params.items()},
            [jnp.asarray(x) for x in xs])
    return (np.asarray(o), extra, {k: np.asarray(v) for k, v in gp.items()},
            [np.asarray(g) for g in gx])


def _torch_run(topo, params, xs, sel, seq_x, ct):
    x_mask, s_mask = _masks(seq_x, sel)
    wrap = lambda v, m: TArg(v, None if m is None else torch.from_numpy(m))
    p = {k: torch.tensor(v, requires_grad=True) for k, v in params.items()}
    xv = [torch.tensor(x, requires_grad=True) for x in xs]
    feeds = {f"x{i}": wrap(x, x_mask) for i, x in enumerate(xv)}
    feeds["sel"] = wrap(torch.tensor(sel, dtype=torch.float32), s_mask)
    outs, ctx = topo.forward(p, feeds, return_ctx=True)
    o = outs["sf"].value
    loss = torch.sum(torch.where(o > -1e29, o, 0.0) * torch.from_numpy(ct))
    loss.backward()
    return (o.detach().numpy(), ctx.extras.get("selfc_compact"),
            {k: v.grad.numpy() for k, v in p.items()},
            [x.grad.numpy() for x in xv])


@pytest.mark.parametrize("case,gather", [
    (c, g) for c in LAYER_CASES for g in (False, True)
    if not (LAYER_CASES[c][1].get("compact_output") and not g)])
def test_selective_fc_matches_jax(case, gather):
    jtopo, ttopo, params, xs, sel, seq_x = _layer_case(case, gather)
    out_shape = jtopo.forward(
        {k: jnp.asarray(v) for k, v in params.items()},
        {**{f"x{i}": JArg(jnp.asarray(x)) for i, x in enumerate(xs)},
         "sel": JArg(jnp.asarray(sel, jnp.float32))})["sf"].value.shape
    ct = np.random.RandomState(99).randn(*out_shape).astype(np.float32)
    jo, jextra, jgp, jgx = _jax_run(jtopo, params, xs, sel, seq_x, ct)
    to, textra, tgp, tgx = _torch_run(ttopo, params, xs, sel, seq_x, ct)
    assert to.shape == jo.shape
    np.testing.assert_allclose(to, jo, **VAL_TOL)
    assert set(tgp) == set(jgp)
    for k in jgp:
        np.testing.assert_allclose(tgp[k], jgp[k], err_msg=k, **VAL_TOL)
    for tg, jg in zip(tgx, jgx):
        np.testing.assert_allclose(tg, jg, **VAL_TOL)
    if LAYER_CASES[case][1].get("compact_output"):
        np.testing.assert_array_equal(textra["sf"].numpy(),
                                      np.asarray(jextra["sf"]))
        assert to.shape[-1] == sel.shape[-1]
    else:
        assert textra is None and to.shape[-1] == C


def test_dead_slots_get_zero_gradient():
    """-1 pads (clipped onto id 0) and an id's later slots scatter into
    the dropped scratch column, so they add nothing to any gradient: the
    gather path's gradients equal the dense path's (which counts the
    duplicated id 5 once), and row 0 of the table, which no row selects,
    gets none."""
    sel = np.array([[3, -1, 7, -1], [5, 5, 9, -1]])
    grads = []
    for gather in (False, True):
        with torch_name_scope():
            out, _ = _selfc(pt, "plain", {}, gather, K)
        topo = pt.Topology(out)
        r = np.random.RandomState(0)
        params = {n: (r.randn(*s.shape) * 0.5).astype(np.float32)
                  for n, s in sorted(topo.param_specs().items())}
        x = r.randn(2, D).astype(np.float32)
        ct = r.randn(2, C).astype(np.float32)
        grads.append(_torch_run(topo, params, [x], sel, False, ct)[2])
    dense, gather = grads
    for k in dense:
        np.testing.assert_allclose(gather[k], dense[k], err_msg=k, **VAL_TOL)
    assert not gather["_sf.w0"][0].any() and gather["_sf.wbias"][0] == 0


def test_selective_fc_refusals_match_jax():
    """compact_output needs the gather path; weight_transposed does not
    compose with sparse_update: both packages refuse."""
    for key, (mod, scope) in PACKAGES.items():
        err = JError if key == "jax" else Error
        dt = mod.data_type
        with scope():
            x = mod.layer.data(name="x", type=dt.dense_vector(D))
            s = mod.layer.data(name="sel", type=dt.dense_vector_sequence(K))
            compact = mod.layer.selective_fc(input=x, select=s, size=C,
                                             compact_output=True, name="c")
            s2 = mod.layer.data(name="s2", type=dt.dense_vector(K))
            sparse = mod.layer.selective_fc(
                input=x, select=s2, size=C, gather_min_c=0, name="t",
                weight_transposed=True,
                param_attr=mod.attr.ParamAttr(sparse_update=True))
        for out, sel in ((compact, np.zeros((B, 2, K))),
                         (sparse, np.zeros((B, K)))):
            topo = mod.Topology(out)
            params = topo.init_params(jax.random.PRNGKey(0)) \
                if key == "jax" else topo.init_params()
            name = out.inputs[-1].name
            arr = (jnp.asarray if key == "jax" else torch.tensor)(
                sel.astype(np.float32))
            xv = (jnp.zeros if key == "jax" else torch.zeros)((B, D))
            A = JArg if key == "jax" else TArg
            with pytest.raises(err):
                topo.forward(params, {"x": A(xv), name: A(arr)})


# --- the decode ------------------------------------------------------------

V, DW, EOS = 16, 8, 1


def _gen(key, select=False, K=V, gather_min=None, compact=True,
         early_exit=True, max_length=5, vocab=V, ctrl=None, num_results=1):
    """tests/test_selective_decode.py's generator, in either package."""
    mod, scope = PACKAGES[key]
    with scope():
        src = mod.layer.data(
            name="src", type=mod.data_type.integer_value_sequence(vocab))
        sel = None
        if select:
            sel = mod.layer.data(name="cand",
                                 type=mod.data_type.dense_vector(K))
        gen = mod.networks.gru_encoder_decoder(
            src_word_id=src, src_dict_dim=vocab, trg_dict_dim=vocab,
            word_vector_dim=DW, encoder_size=DW, decoder_size=DW,
            is_generating=True, beam_size=3, max_length=max_length,
            name="g", trg_vocab_select=sel, vocab_select_gather_min=gather_min,
            compact_decode=compact, early_exit=early_exit)
    if ctrl is not None:
        gen.cfg["ctrl_callbacks"] = ctrl[key]
    if num_results != 1:
        gen.cfg["num_results_per_sample"] = num_results
    return gen


def _weights(vocab=V, eos_bias=0.0):
    jtopo = pj.Topology(_gen("jax", vocab=vocab))
    d = {k: np.array(v) for k, v in
         jtopo.init_params(jax.random.PRNGKey(7)).items()}
    d["_g_out.wbias"][EOS] += eos_bias
    return d


SRC = np.array([[3, 5, 2, 9], [1, 2, 0, 4]], np.int32)
SRC_MASK = np.array([[1, 1, 1, 1], [1, 1, 1, 0]], np.float32)


def _decode(key, gen, d, cand=None, rows=2):
    """(ids, scores, ticks, the layer's output Arg as numpy) of one
    forward."""
    src, mask = SRC[:rows], SRC_MASK[:rows]
    if key == "jax":
        feeds = {"src": JArg(jnp.asarray(src), jnp.asarray(mask))}
        if cand is not None:
            feeds["cand"] = JArg(jnp.asarray(cand, jnp.float32))
        topo = pj.Topology(gen)

        @jax.jit
        def run(params, feeds):
            outs, ctx = topo.forward(params, feeds, return_ctx=True)
            return [ctx.extras[f"{gen.name}:{k}"] for k in
                    ("ids", "scores", "ticks")], outs[gen.name]

        (ids, scores, ticks), out = run(
            {k: jnp.asarray(v) for k, v in d.items()}, feeds)
        arr = lambda v: None if v is None else np.asarray(v)
    else:
        feeds = {"src": TArg(torch.from_numpy(src), torch.from_numpy(mask))}
        if cand is not None:
            feeds["cand"] = TArg(torch.tensor(cand, dtype=torch.float32))
        with torch.inference_mode():
            outs, ctx = pt.Topology(gen).forward(
                {k: torch.from_numpy(v) for k, v in d.items()}, feeds,
                return_ctx=True)
        ids, scores, ticks = (ctx.extras[f"{gen.name}:{k}"] for k in
                              ("ids", "scores", "ticks"))
        out = outs[gen.name]
        arr = lambda v: None if v is None else v.numpy()
    return (arr(ids), arr(scores), int(ticks),
            (arr(out.value), arr(out.mask), arr(out.seg_ids)))


def _full_cand(rows=2, vocab=V):
    return np.tile(np.arange(vocab), (rows, 1))


RESTRICTED = np.array([[1, 3, 5, 9, 2, -1], [7, 1, 0, 11, 4, 13]])


def _same(got, want, scores=True):
    np.testing.assert_array_equal(got[0], want[0])
    if scores:
        np.testing.assert_allclose(got[1], want[1], **SCORE_TOL)
    assert got[2] == want[2]


@pytest.mark.parametrize("mode,gather_min", [("selective", 0),
                                             ("selective", None),
                                             ("compact", None)])
@pytest.mark.parametrize("eos_bias", [0.0, 2.0])
def test_decode_matches_jax(mode, gather_min, eos_bias):
    """Restricted candidates (a -1 pad in row 0): the port's ids equal
    the live JAX forward's, scores within 1e-5, the same ticks, and
    every emitted id lies in its row's candidates."""
    d = _weights(eos_bias=eos_bias)
    kw = dict(select=True, K=RESTRICTED.shape[1], gather_min=gather_min,
              compact=mode == "compact", max_length=6)
    want = _decode("jax", _gen("jax", **kw), d, RESTRICTED)
    got = _decode("torch", _gen("torch", **kw), d, RESTRICTED)
    _same(got, want)
    for row, cand in zip(got[0], RESTRICTED):
        assert np.isin(row, cand[cand >= 0]).all()
    assert np.isfinite(got[1]).all()


def test_compact_full_coverage_matches_dense():
    """The whole vocab as the candidate list: the compact decode gives
    the dense decode's ids and scores, and the JAX compact decode's."""
    d = _weights(eos_bias=1.0)
    dense = _decode("torch", _gen("torch"), d)
    compact = _decode("torch", _gen("torch", select=True), d, _full_cand())
    _same(compact, dense)
    _same(compact, _decode("jax", _gen("jax", select=True), d, _full_cand()))


def _ban(banned, space):
    """candidate_adjust banning a vocab id in whichever space the beam
    scores (vocab columns, or candidate slots through state['cand_ids'])."""
    if space == "jax":
        def adjust(t, logp, state):
            ids = state.get("cand_ids")
            col = ids if ids is not None else \
                jnp.arange(logp.shape[-1])[None, :]
            return jnp.where(col == banned, -1e30, logp)
    else:
        def adjust(t, logp, state):
            ids = state.get("cand_ids")
            col = ids if ids is not None else \
                torch.arange(logp.shape[-1])[None, :]
            return torch.where(col == banned, -1e30, logp)
    return adjust


def _norm(space):
    """norm_or_drop: scores over lengths."""
    if space == "jax":
        return lambda ids, scores, lengths: \
            scores / lengths.astype(scores.dtype)
    return lambda ids, scores, lengths: scores / lengths.to(scores.dtype)


def test_callbacks_in_both_spaces():
    """candidate_adjust + norm_or_drop: a full-coverage compact decode
    with both hooks equals the dense decode with the same hooks and the
    JAX compact decode; the banned id never appears."""
    banned = 7
    ctrl = {key: mod.layer.BeamSearchControlCallbacks(
        candidate_adjust=_ban(banned, key), norm_or_drop=_norm(key))
        for key, (mod, _) in PACKAGES.items()}
    d = _weights()
    dense = _decode("torch", _gen("torch", ctrl=ctrl), d)
    compact = _decode("torch", _gen("torch", select=True, ctrl=ctrl), d,
                      _full_cand())
    _same(compact, dense)
    _same(compact, _decode("jax", _gen("jax", select=True, ctrl=ctrl), d,
                           _full_cand()))
    assert not (compact[0] == banned).any()


@pytest.mark.parametrize("select", [False, True])
def test_num_results_per_sample(select):
    """Two results a sample: the nested output (value, mask, seg_ids)
    equals the JAX package's, and in compact mode at full coverage the
    dense decode's."""
    d = _weights(eos_bias=1.0)
    cand = _full_cand() if select else None
    got = _decode("torch", _gen("torch", select=select, num_results=2), d,
                  cand)
    want = _decode("jax", _gen("jax", select=select, num_results=2), d, cand)
    for g, w in zip(got[3], want[3]):
        np.testing.assert_array_equal(g, w)
    assert got[3][0].shape == (2, 2 * 5, 1)
    if select:
        dense = _decode("torch", _gen("torch", num_results=2), d)
        for g, w in zip(got[3], dense[3]):
            np.testing.assert_array_equal(g, w)


def _force_eos_after(tick, space):
    """A length model: every hypothesis is pushed onto eos from tick
    ``tick`` on, in whichever space the beam scores."""
    if space == "jax":
        def adjust(t, logp, state):
            ids = state.get("cand_ids")
            col = ids if ids is not None else \
                jnp.arange(logp.shape[-1])[None, :]
            return jnp.where(t >= tick,
                             jnp.where(col == EOS, 0.0, -50.0), logp)
    else:
        def adjust(t, logp, state):
            if t < tick:
                return logp
            ids = state.get("cand_ids")
            col = ids if ids is not None else \
                torch.arange(logp.shape[-1])[None, :]
            return torch.where(col == EOS, 0.0, -50.0).expand_as(logp)
    return adjust


@pytest.mark.parametrize("mode", ["dense", "selective", "compact"])
def test_early_exit_bit_identical_to_full_loop(mode):
    """The early exit and its closed-form completion give the full
    max_length loop's ids, scores and output bit for bit in all three
    modes while running fewer ticks; the ids equal the JAX package's."""
    ctrl = {key: mod.layer.BeamSearchControlCallbacks(
        candidate_adjust=_force_eos_after(2, key))
        for key, (mod, _) in PACKAGES.items()}
    select = mode != "dense"
    kw = dict(select=select, compact=mode == "compact", max_length=8,
              ctrl=ctrl, gather_min=0 if select else None)
    cand = _full_cand() if select else None
    d = _weights()
    early = _decode("torch", _gen("torch", early_exit=True, **kw), d, cand)
    full = _decode("torch", _gen("torch", early_exit=False, **kw), d, cand)
    np.testing.assert_array_equal(early[0], full[0])
    np.testing.assert_array_equal(early[1], full[1])
    np.testing.assert_array_equal(early[3][0], full[3][0])
    assert full[2] == 8 and early[2] < 8
    _same(early, _decode("jax", _gen("jax", early_exit=True, **kw), d, cand))


@pytest.mark.parametrize("gather_min", [None, 0])
def test_scoring_form_selective_projection_3d(gather_min):
    """Scoring mode with trg_vocab_select: the projection over the [B, T,
    H] hidden sequence with the [B, K] selection at every step (the dense
    mask, or the 3D gather path), probabilities equal to the JAX
    package's and mass only on candidate columns."""
    Bt, Tt, Kc = 2, 3, 6
    built = {}
    for key, (mod, scope) in PACKAGES.items():
        with scope():
            src = mod.layer.data(
                name="src", type=mod.data_type.integer_value_sequence(V))
            trg = mod.layer.data(
                name="trg", type=mod.data_type.integer_value_sequence(V))
            sel = mod.layer.data(name="cand",
                                 type=mod.data_type.dense_vector(Kc))
            emb = mod.layer.embedding(
                input=trg, size=DW, param_attr=mod.attr.ParamAttr(
                    name="_trg_emb"))
            built[key] = mod.networks.gru_encoder_decoder(
                src_word_id=src, trg_embedding=emb, src_dict_dim=V,
                trg_dict_dim=V, word_vector_dim=DW, encoder_size=DW,
                decoder_size=DW, name="g", trg_vocab_select=sel,
                vocab_select_gather_min=gather_min)
    jtopo, ttopo = pj.Topology(built["jax"]), pt.Topology(built["torch"])
    d = {k: np.array(v) for k, v in
         jtopo.init_params(jax.random.PRNGKey(1)).items()}
    r = np.random.RandomState(0)
    cand = np.stack([r.choice(V, Kc, replace=False) for _ in range(Bt)])
    src, trg = r.randint(0, V, (2, Bt, Tt)).astype(np.int32)
    mask = np.array([[1, 1, 1], [1, 1, 0]], np.float32)
    jo = jtopo.forward({k: jnp.asarray(v) for k, v in d.items()}, {
        "src": JArg(jnp.asarray(src), jnp.asarray(mask)),
        "trg": JArg(jnp.asarray(trg), jnp.asarray(mask)),
        "cand": JArg(jnp.asarray(cand, jnp.float32))})["g_out"]
    with torch.inference_mode():
        to = ttopo.forward({k: torch.from_numpy(v) for k, v in d.items()}, {
            "src": TArg(torch.from_numpy(src), torch.from_numpy(mask)),
            "trg": TArg(torch.from_numpy(trg), torch.from_numpy(mask)),
            "cand": TArg(torch.tensor(cand, dtype=torch.float32))})["g_out"]
    out = to.value.numpy()
    assert out.shape == (Bt, Tt, V)
    np.testing.assert_allclose(out, np.asarray(jo.value), **VAL_TOL)
    np.testing.assert_array_equal(to.mask.numpy(), np.asarray(jo.mask))
    for b in range(Bt):
        off = np.setdiff1d(np.arange(V), cand[b])
        assert (out[b][:, off] == 0).all()
        np.testing.assert_allclose(out[b].sum(-1), 1.0, rtol=1e-5)


NMT_SMALL = dict(src_dict_dim=40, trg_dict_dim=30, word_vector_dim=DW,
                 encoder_size=DW, decoder_size=DW, beam_size=3, max_length=6,
                 cand_k=9)


@pytest.mark.parametrize("mode", ["selective", "compact"])
def test_nmt_decode_topology_infer_matches_jax(mode):
    """models.text.nmt_decode_topology in both non-dense modes, served
    through Inference with the cand feed as DataFeeder rows (float32,
    cast to ids by the layer): ids equal to the JAX package's infer,
    parameter names and shapes equal to the dense topology's."""
    jgen = jax_nmt_decode(mode=mode, **NMT_SMALL)
    tgen = torch_nmt_decode(mode=mode, **NMT_SMALL)
    specs = {n: tuple(s.shape) for n, s in
             pt.Topology(tgen).param_specs().items()}
    assert specs == {n: tuple(s.shape) for n, s in
                     pj.Topology(jgen).param_specs().items()}
    assert specs == {n: tuple(s.shape) for n, s in pt.Topology(
        torch_nmt_decode(mode="dense", **NMT_SMALL)).param_specs().items()}
    d = {k: np.array(v) for k, v in
         pj.Topology(jgen).init_params(jax.random.PRNGKey(3)).items()}
    d["_m_out.wbias"][EOS] += 1.5
    r = np.random.RandomState(5)
    batch = []
    for n in (7, 2, 5):
        cand = r.choice(NMT_SMALL["trg_dict_dim"], NMT_SMALL["cand_k"],
                        replace=False)
        if EOS not in cand:
            cand[0] = EOS
        batch.append((r.randint(0, NMT_SMALL["src_dict_dim"], n).tolist(),
                      cand.tolist()))
    feeding = {"src": 0, "cand": 1}
    want = pj.infer(output_layer=jgen, parameters=pj.Parameters.from_dict(d),
                    input=batch, feeding=feeding)
    got = pt.Inference(tgen, pt.Parameters.from_numpy(d),
                       device="cpu").infer(batch, feeding)
    assert got.shape == (len(batch), NMT_SMALL["max_length"])
    np.testing.assert_array_equal(got, np.asarray(want))
    for row, (_, cand) in zip(got, batch):
        assert np.isin(row, cand).all()


class _ShapeProbe(TorchDispatchMode):
    """Records the shape of every tensor an op returns."""

    def __init__(self):
        super().__init__()
        self.shapes = set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in pytree.tree_leaves(out):
            if isinstance(t, torch.Tensor):
                self.shapes.add(tuple(t.shape))
        return out


def test_compact_decode_has_no_vocab_wide_values():
    """The twin of test_compact_jaxpr_has_no_vocab_wide_values: no op of
    a compact-K decode returns a [B*beam, V], [B*beam, V + 1] or [B,
    beam*V] tensor; the selective control does, so the probe sees them."""
    vocab, Kc, beam, Bd = 50, 9, 3, 1
    banned = {(Bd * beam, vocab), (Bd * beam, vocab + 1), (Bd, beam * vocab)}
    d = _weights(vocab=vocab)
    cand = np.array([[1, 3, 5, 9, 2, 7, 11, 30, 49]])

    def shapes(compact):
        gen = _gen("torch", select=True, K=Kc, gather_min=0, compact=compact,
                   vocab=vocab)
        with _ShapeProbe() as probe:
            ids = _decode("torch", gen, d, cand, rows=Bd)[0]
        return probe.shapes, ids

    compact, ids_c = shapes(True)
    assert not compact & banned, \
        f"vocab-wide values in the compact decode: {compact & banned}"
    selective, ids_s = shapes(False)
    assert selective & banned, "the probe saw no vocab-wide value"
    np.testing.assert_array_equal(ids_c, ids_s)
