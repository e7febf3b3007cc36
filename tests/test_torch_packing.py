"""Sequence packing in the port against the JAX package on the CPU
(docs/packing.md: several ragged samples back to back in each row, with
seg_ids numbering them).

Every comparison feeds the same numpy-seeded samples through both
packages, at small widths (V 64, width 32, 2 heads, batches of 16; the
stream of ``tests/test_torch_attention.py``):

- ``_pack_plan`` and the packed feeds' value, mask and seg_ids equal to
  JAX's bit for bit, with ``pack_max_len``, ``bucket_rounding``, row
  rounding with all-padding filler rows, and the feeder's refusals;
- ``segment_start_resets`` (forward and reverse) and
  ``packed_segment_count`` equal to JAX's;
- ``lstmemory`` and ``gated_recurrent`` forward and reverse on packed rows,
  through the kernels' plain versions (default activations) and through
  the time loops, values and gradients against the JAX layers' scans;
- packed ``multi_head_attention``, causal and not, against JAX's, and
  equal to each sample attended alone;
- ``nmt_packed_cost``'s packed loss, gradients and 3 Adam steps through
  ``SGD.train(pack_sequences=True)`` against JAX's at rtol 1e-4 / atol
  1e-6; the packed loss equal to the padded one over the same samples;
- ``SGD.train(pack_sequences=True)`` against the padded trajectory for a
  GRU and an LSTM tagger (costs, evaluator totals, parameters, ``test()``);
- one packed mixed-precision step of ``nmt_packed_cost`` (its encoder at H
  = 128, where the JAX layer takes its Pallas kernel, run in interpret
  mode with the resets) against JAX's, at tests/test_torch_gru_bf16.py's
  tolerances;
- ``chunk`` on packed rows, evaluators that ignore nested seg_ids, the
  guard rails with JAX's messages, and ``sort_within_buffer``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pj
import paddle_tpu.kernels.gru as jax_gru
from paddle_tpu.core.arg import Arg as JArg
from paddle_tpu.core.arg import packed_segment_count as jax_count
from paddle_tpu.core.arg import segment_start_resets as jax_resets
from paddle_tpu.core.layer import layer_name_scope as jax_name_scope
from paddle_tpu.models.text import nmt_packed_cost as jax_packed_cost
from paddle_tpu.reader.decorator import sort_within_buffer as jax_sort
from paddle_tpu.trainer.feeder import DataFeeder as JFeeder
from paddle_tpu.trainer.feeder import _pack_plan as jax_plan
from paddle_tpu.utils.error import Error as JError

import paddle_tpu_torch as pt
from paddle_tpu_torch import kernels as tk
from paddle_tpu_torch.core.arg import Arg as TArg
from paddle_tpu_torch.core.arg import packed_segment_count, \
    segment_start_resets
from paddle_tpu_torch.core.layer import ForwardContext
from paddle_tpu_torch.core.layer import layer_name_scope as torch_name_scope
from paddle_tpu_torch.layers.recurrent import _packed_resets
from paddle_tpu_torch.models.text import nmt_packed_cost as torch_packed_cost
from paddle_tpu_torch.reader.decorator import sort_within_buffer
from paddle_tpu_torch.trainer import make_train_step as torch_train_step
from paddle_tpu_torch.trainer.feeder import DataFeeder as TFeeder
from paddle_tpu_torch.trainer.feeder import _pack_plan
from paddle_tpu_torch.utils.error import Error

TOL = dict(rtol=1e-5, atol=1e-6)
PTOL = dict(rtol=1e-4, atol=1e-6)
PACKAGES = {"jax": (pj, jax_name_scope), "torch": (pt, torch_name_scope)}
V, WIDTH, NH, NB = 64, 32, 2, 16
PACKED = dict(src_dict_dim=V, trg_dict_dim=V, word_vector_dim=WIDTH,
              encoder_size=WIDTH, decoder_size=WIDTH, num_heads=NH)
FEEDING = {"src": 0, "trg": 1, "trg_next": 2}
BF16 = torch.bfloat16


def _both(build):
    """build(mod) in each package's name scope: (jax, torch)."""
    out = []
    for key in ("jax", "torch"):
        mod, scope = PACKAGES[key]
        with scope():
            out.append(build(mod))
    return out


def _packed_samples(seed, n=NB, lo=4, hi=12):
    """bench_nmt_packed's stream: source lengths lo..hi, the target's
    within 2 of it, at least 3; ids uniform in V."""
    r = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        ts = int(r.randint(lo, hi + 1))
        tt = max(3, ts + int(r.randint(-2, 3)))
        out.append((r.randint(0, V, ts).tolist(), r.randint(0, V, tt).tolist(),
                    r.randint(0, V, tt).tolist()))
    return out


def _init(jtopo, seed=2):
    return {k: np.array(v) for k, v in
            jtopo.init_params(jax.random.PRNGKey(seed)).items()}


def _on_cpu(feeds):
    return {k: a.to("cpu") for k, a in feeds.items()}


def _torch_params(init, grad=False):
    return {k: torch.from_numpy(v.copy()).requires_grad_(grad)
            for k, v in init.items()}


# --- the feeder -------------------------------------------------------------

@pytest.mark.parametrize("lengths,caps", [
    ({"a": [5, 3, 7, 2, 6], "b": [4, 4, 7, 1, 5]}, {"a": 8, "b": 8}),
    ({"a": [3, 3, 3, 3, 3, 3]}, {"a": 7}),
    ({"a": [1, 9, 2, 8, 3, 7, 4], "b": [2, 2, 9, 1, 6, 6, 3]},
     {"a": 10, "b": 12})])
def test_pack_plan_equals_jax(lengths, caps):
    plan = _pack_plan(lengths, caps)
    assert plan == jax_plan(lengths, caps)
    assert sorted(i for row in plan for i in row) == \
        list(range(len(lengths["a"])))
    for row in plan:
        for s in lengths:
            assert sum(lengths[s][i] for i in row) <= caps[s]


def _dense_samples(seed, n=9, dim=3):
    r = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        t = int(r.randint(1, 7))
        out.append((r.randn(t, dim).astype(np.float32).tolist(),
                    r.randint(0, V, t).tolist()))
    return out


@pytest.mark.parametrize("kw", [
    dict(), dict(pack_row_rounding=1), dict(pack_max_len=24),
    dict(pack_max_len=13, pack_row_rounding=3),
    dict(pack_max_len=5, pack_row_rounding=1),     # longer samples bump T
    dict(bucket_rounding=6, pack_row_rounding=2)])
def test_packed_feeds_equal_jax_bit_for_bit(kw):
    """Index slots (the NMT stream) and a dense slot beside an index one:
    value, mask, seg_ids and the plan, filler rows included."""
    cases = [(lambda mod: [("src", mod.data_type.integer_value_sequence(V)),
                           ("trg", mod.data_type.integer_value_sequence(V)),
                           ("trg_next",
                            mod.data_type.integer_value_sequence(V))],
              _packed_samples(5), FEEDING),
             (lambda mod: [("x", mod.data_type.dense_vector_sequence(3)),
                           ("y", mod.data_type.integer_value_sequence(V))],
              _dense_samples(6), {"x": 0, "y": 1})]
    for types, batch, feeding in cases:
        jf = JFeeder(types(pj), feeding, pack_sequences=True, **kw)
        tf = TFeeder(types(pt), feeding, pack_sequences=True, **kw)
        jfeeds, tfeeds = jf(batch), tf(batch)
        assert tf.last_pack_plan == jf.last_pack_plan
        for k in jfeeds:
            for part in ("value", "mask", "seg_ids"):
                want = np.asarray(getattr(jfeeds[k], part))
                got = getattr(tfeeds[k], part)
                assert got.dtype == want.dtype, (k, part)
                np.testing.assert_array_equal(got, want, err_msg=f"{k}.{part}")
        R = tfeeds[k].value.shape[0]
        assert R % kw.get("pack_row_rounding", 8) == 0
        for r in range(len(tf.last_pack_plan), R):        # filler rows
            assert (tfeeds[k].mask[r] == 0).all()
            assert (tfeeds[k].seg_ids[r] == -1).all()
        seg = torch.from_numpy(tfeeds[k].seg_ids)
        assert float(packed_segment_count(seg)) == len(batch) == float(
            jax_count(jnp.asarray(tfeeds[k].seg_ids)))


@pytest.mark.parametrize("types,batch,at_init", [
    ("index", [([1, 2],), ([],)], False),          # a zero-length sample
    ("non_sequence", None, True),
    ("nested", None, True),
    ("sparse", None, True)])
def test_packed_feeder_refuses_as_jax_does(types, batch, at_init):
    def slots(mod):
        dt = mod.data_type
        return {"index": [("w", dt.integer_value_sequence(V))],
                "non_sequence": [("w", dt.integer_value_sequence(V)),
                                 ("y", dt.integer_value(3))],
                "nested": [("w", dt.integer_value_sub_sequence(V))],
                "sparse": [("w", dt.sparse_binary_vector_sequence(V))]
                }[types]
    msgs = []
    for mod, feeder, err in ((pj, JFeeder, JError), (pt, TFeeder, Error)):
        with pytest.raises(err) as e:
            f = feeder(slots(mod), pack_sequences=True)
            assert not at_init
            f(batch)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]
    assert ("zero-length" if types == "index" else "cannot be packed") \
        in msgs[1]


def test_segment_start_resets_and_count_equal_jax():
    seg = np.array([[0, 0, 1, 1, 1, -1], [0, 1, 2, -1, -1, -1],
                    [-1, -1, -1, -1, -1, -1], [0, 0, 0, 0, 0, 0]], np.int32)
    mask = (seg >= 0).astype(np.float32)
    for reverse in (False, True):
        want = np.asarray(jax_resets(jnp.asarray(seg), jnp.asarray(mask),
                                     reverse=reverse))
        got = segment_start_resets(torch.from_numpy(seg),
                                   torch.from_numpy(mask), reverse=reverse)
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        segment_start_resets(torch.from_numpy(seg), torch.from_numpy(mask))
        .numpy()[:2], [[1, 0, 1, 0, 0, 0], [1, 1, 1, 0, 0, 0]])
    np.testing.assert_array_equal(
        segment_start_resets(torch.from_numpy(seg), torch.from_numpy(mask),
                             reverse=True).numpy()[:2],
        [[0, 1, 0, 0, 1, 0], [1, 1, 1, 0, 0, 0]])
    assert float(packed_segment_count(torch.from_numpy(seg))) == 6.0 == \
        float(jax_count(jnp.asarray(seg)))


# --- the recurrent layers ----------------------------------------------------

RH = 8


def _recurrent_model(cell):
    """One layer each way over the same input: (rnn_fwd, rnn_rev)."""
    def build(mod):
        D = RH * (4 if cell == "lstm" else 3)
        x = mod.layer.data(name="x",
                           type=mod.data_type.dense_vector_sequence(D))
        rnn = mod.layer.lstmemory if cell == "lstm" else mod.layer.grumemory
        return [rnn(input=x, reverse=rev, name=name)
                for rev, name in ((False, "rnn_fwd"), (True, "rnn_rev"))]
    return _both(build)


@pytest.mark.parametrize("cell", ["lstm", "gru"])
def test_recurrent_layers_on_packed_rows_match_jax(cell):
    """Forward and reverse layers on packed rows: fused_lstm / fused_gru
    (their plain versions here) with the reset input against the JAX
    layers' scans with the same resets. A reverse layer's reset marks
    segment ends, flipped with the inputs: a flipped segment-start vector
    would cut the carry one step off."""
    jl, tl = _recurrent_model(cell)
    jtopo, ttopo = pj.Topology(jl), pt.Topology(tl)
    init = {k: v * 3 for k, v in _init(jtopo, 4).items()}
    D = RH * (4 if cell == "lstm" else 3)
    r = np.random.RandomState(7)
    batch = [(r.randn(int(t), D).astype(np.float32).tolist(),)
             for t in r.randint(1, 8, size=11)]
    jfeeds = JFeeder(jtopo.data_type(), {"x": 0}, pack_sequences=True,
                     pack_max_len=12, pack_row_rounding=2)(batch)
    tfeeds = _on_cpu(TFeeder(ttopo.data_type(), {"x": 0},
                             pack_sequences=True, pack_max_len=12,
                             pack_row_rounding=2)(batch))
    names = ("rnn_fwd", "rnn_rev")
    proj = {n: r.randn(*tfeeds["x"].mask.shape, RH).astype(np.float32)
            for n in names}

    @jax.jit
    def jloss(p, x, mask, seg):
        outs = jtopo.forward(p, {"x": JArg(x, mask, seg)})
        return sum(jnp.sum(outs[n].value * proj[n]) for n in names), \
            [outs[n].value for n in names]

    (_, jouts), (jgp, jgx) = jax.value_and_grad(jloss, argnums=(0, 1),
                                                has_aux=True)(
        {k: jnp.asarray(v) for k, v in init.items()},
        jnp.asarray(jfeeds["x"].value), jnp.asarray(jfeeds["x"].mask),
        jnp.asarray(jfeeds["x"].seg_ids))
    params = _torch_params(init, grad=True)
    x = tfeeds["x"].value.clone().requires_grad_(True)
    outs = ttopo.forward(params, {"x": TArg(x, tfeeds["x"].mask,
                                            tfeeds["x"].seg_ids)})
    sum((outs[n].value * torch.from_numpy(proj[n])).sum()
        for n in names).backward()
    for n, jout in zip(names, jouts):
        np.testing.assert_allclose(outs[n].value.detach().numpy(),
                                   np.asarray(jout), err_msg=n, **TOL)
        np.testing.assert_array_equal(outs[n].seg_ids, tfeeds["x"].seg_ids)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(jgx), **TOL)
    for k in init:
        np.testing.assert_allclose(params[k].grad.numpy(),
                                   np.asarray(jgp[k]), err_msg=k, **TOL)
    # the resets matter: the same rows unpacked give other outputs
    flat = ttopo.forward(params, {"x": TArg(x, tfeeds["x"].mask)})
    for n in names:
        assert not torch.allclose(flat[n].value, outs[n].value, atol=1e-3)


@pytest.mark.parametrize("cell", ["lstm", "gru"])
def test_time_loops_reset_where_the_kernels_do(cell):
    """The layers' time loops (any activations) zero the carry at the same
    steps as the kernels' plain versions: at default activations the two
    agree on packed rows, and a reset moved one step does not."""
    from paddle_tpu_torch import activation as act
    from paddle_tpu_torch.kernels.gru import fused_gru_plain
    from paddle_tpu_torch.kernels.lstm import fused_lstm_plain
    from paddle_tpu_torch.layers.recurrent import _gru_loop, _lstm_loop

    r = np.random.RandomState(3)
    seg = torch.tensor([[0, 0, 0, 1, 1, 2, 2, 2, 2, -1],
                        [0, 1, 1, 1, 1, 1, 2, 3, -1, -1]], dtype=torch.int32)
    mask = (seg >= 0).to(torch.float32)
    B, T = seg.shape
    g = lambda *shape: torch.from_numpy(                 # noqa: E731
        r.randn(*shape).astype(np.float32))
    tanh, sig = act.Tanh(), act.Sigmoid()
    for reverse in (False, True):
        reset = segment_start_resets(seg, mask, reverse)
        if reverse:
            reset = torch.flip(reset, dims=[1])
            m = torch.flip(mask, dims=[1])
        else:
            m = mask
        moved = torch.roll(reset, 1, dims=1) * m
        if cell == "lstm":
            x4, w, b = g(B, T, 4 * RH), g(RH, 4 * RH), g(7 * RH)
            want = fused_lstm_plain(x4, w, b, m, reset)[0]
            run = lambda rs: _lstm_loop(                 # noqa: E731
                x4, m, w, b, tanh, tanh, sig, rs)[0]
        else:
            x3, wg, wc, b = g(B, T, 3 * RH), g(RH, 2 * RH), g(RH, RH), \
                g(3 * RH)
            want = fused_gru_plain(x3, wg, wc, b, m, reset)
            run = lambda rs: _gru_loop(                  # noqa: E731
                x3, m, wg, wc, b, sig, tanh, rs)
        np.testing.assert_allclose(run(reset).numpy(), want.numpy(),
                                   rtol=1e-5, atol=1e-6)
        assert not torch.allclose(run(moved), want, atol=1e-3)


def test_recurrent_layer_refuses_a_packed_input_without_seg_ids():
    ctx = ForwardContext(packed=True)
    a = TArg(torch.zeros(2, 4, 8), torch.ones(2, 4))
    with pytest.raises(Error, match="lost its seg_ids"):
        _packed_resets(a, ctx, False)
    assert _packed_resets(a, ForwardContext(), False) is None


# --- attention ---------------------------------------------------------------

def _attention_model(causal):
    def build(mod):
        w = mod.layer.data(name="w",
                           type=mod.data_type.integer_value_sequence(V))
        emb = mod.layer.embedding(input=w, size=8, name="emb")
        att = mod.layer.multi_head_attention(query=emb, size=8, num_heads=2,
                                             causal=causal, name="att")
        return mod.layer.fc(input=att, size=5, act=mod.activation.Softmax(),
                            name="out")
    return _both(build)


@pytest.mark.parametrize("causal", [False, True])
def test_packed_attention_matches_jax_and_each_sample_alone(causal):
    jout, tout = _attention_model(causal)
    jtopo, ttopo = pj.Topology(jout), pt.Topology(tout)
    init = _init(jtopo, 5)
    batch = [(s[0],) for s in _packed_samples(8, n=9)]
    jfeeds = JFeeder(jtopo.data_type(), {"w": 0}, pack_sequences=True)(batch)
    tf = TFeeder(ttopo.data_type(), {"w": 0}, pack_sequences=True)
    tfeeds = _on_cpu(tf(batch))
    r = np.random.RandomState(1)
    proj = r.randn(*tfeeds["w"].value.shape, 5).astype(np.float32)

    def jloss(p, feeds):
        out = jtopo.forward(p, feeds)["out"].value
        return jnp.sum(out * proj), out

    (jval, jout), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        {k: jnp.asarray(v) for k, v in init.items()},
        {k: JArg(jnp.asarray(a.value), jnp.asarray(a.mask),
                 jnp.asarray(a.seg_ids)) for k, a in jfeeds.items()})
    params = _torch_params(init, grad=True)
    out = ttopo.forward(params, tfeeds)["out"]
    tval = (out.value * torch.from_numpy(proj)).sum()
    tval.backward()
    np.testing.assert_allclose(out.value.detach().numpy(), np.asarray(jout),
                               **TOL)
    np.testing.assert_allclose(float(tval.detach()), float(jval), rtol=1e-5)
    for k in init:
        np.testing.assert_allclose(params[k].grad.numpy(),
                                   np.asarray(jgrads[k]), err_msg=k, **TOL)
    # each packed segment equals its sample attended in a row of its own
    padded = ttopo.forward(_torch_params(init), _on_cpu(
        TFeeder(ttopo.data_type(), {"w": 0})(batch)))["out"].value
    seg = tfeeds["w"].seg_ids.numpy()
    for row, members in enumerate(tf.last_pack_plan):
        for s, i in enumerate(members):
            idx = np.flatnonzero(seg[row] == s)
            np.testing.assert_allclose(out.value[row, idx].detach().numpy(),
                                       padded[i, :len(idx)].numpy(),
                                       rtol=2e-5, atol=2e-6)


def test_packed_attention_without_seg_ids_raises_as_jax_does():
    """A packed context needs seg_ids on both sides; with them the layer
    runs (the refusal it had before packing is gone)."""
    jout, tout = _attention_model(False)
    jtopo, ttopo = pj.Topology(jout), pt.Topology(tout)
    init = _init(jtopo, 5)
    layer = next(l for l in ttopo.layers if l.name == "att")
    params = {s: torch.from_numpy(init[n]) for s, n in
              ttopo.layer_params("att").items()}
    x = TArg(torch.randn(2, 5, 8), torch.ones(2, 5))
    seg = torch.zeros(2, 5, dtype=torch.int32)
    layer.forward(params, [TArg(x.value, x.mask, seg)],
                  ForwardContext(packed=True))
    with pytest.raises(Error) as e:
        layer.forward(params, [x], ForwardContext(packed=True))
    jlayer = next(l for l in jtopo.layers if l.name == "att")

    class Ctx:
        packed, mesh = True, None

    with pytest.raises(JError) as je:
        jlayer.forward({s: jnp.asarray(init[n]) for s, n in
                        jtopo.layer_param_map("att").items()},
                       [JArg(jnp.zeros((2, 5, 8)), jnp.ones((2, 5)))], Ctx())
    assert str(e.value) == str(je.value)


# --- nmt_packed_cost ----------------------------------------------------------

@pytest.fixture(scope="module")
def nmt():
    """Both packages' nmt_packed_cost, the JAX initial parameters, one
    batch of the stream packed by each feeder, and the JAX packed loss's
    value and gradient."""
    jcost, tcost = _both(lambda mod: (
        jax_packed_cost if mod is pj else torch_packed_cost)(**PACKED))
    jtopo, ttopo = pj.Topology(jcost), pt.Topology(tcost)
    init = _init(jtopo)
    batch = _packed_samples(2)
    jfeeds = JFeeder(jtopo.data_type(), FEEDING, pack_sequences=True)(batch)
    tfeeds = _on_cpu(TFeeder(ttopo.data_type(), FEEDING,
                             pack_sequences=True)(batch))
    jloss_fn = jtopo.loss_fn(jcost)
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p, feeds: jloss_fn(p, feeds, training=False)[0]))(
        {k: jnp.asarray(v) for k, v in init.items()}, jfeeds)
    return dict(jcost=jcost, tcost=tcost, jtopo=jtopo, ttopo=ttopo,
                init=init, batch=batch, tfeeds=tfeeds, jloss=float(jloss),
                jgrads={k: np.asarray(v) for k, v in jgrads.items()})


def test_nmt_packed_loss_and_gradients_match_jax(nmt):
    params = _torch_params(nmt["init"], grad=True)
    loss = nmt["ttopo"].loss_fn(nmt["tcost"])
    assert loss._feeds_packed(nmt["tfeeds"])
    tloss, (_outs, _aux) = loss(params, nmt["tfeeds"], training=False)
    tloss.backward()
    assert nmt["tfeeds"]["src"].value.shape[0] < len(nmt["batch"])
    np.testing.assert_allclose(float(tloss.detach()), nmt["jloss"],
                               rtol=1e-5)
    for k, want in nmt["jgrads"].items():
        np.testing.assert_allclose(params[k].grad.numpy(), want, err_msg=k,
                                   rtol=1e-4, atol=1e-7)
        assert params[k].grad.abs().sum() > 0, k


def test_nmt_packed_loss_equals_padded_loss(nmt):
    """The loss divides by the published sequence count, not the rows: the
    packed loss and gradients are the padded ones over the same samples
    (JAX tests/test_packing.py:551)."""
    topo, loss = nmt["ttopo"], nmt["ttopo"].loss_fn(nmt["tcost"])
    padded = _on_cpu(TFeeder(topo.data_type(), FEEDING)(nmt["batch"]))
    assert not loss._feeds_packed(padded)
    pp, pu = (_torch_params(nmt["init"], grad=True) for _ in range(2))
    (cp, (_, _)), (cu, (_, _)) = (loss(pp, nmt["tfeeds"], training=False),
                                  loss(pu, padded, training=False))
    cp.backward()
    cu.backward()
    np.testing.assert_allclose(float(cp.detach()), float(cu.detach()),
                               rtol=1e-5)
    for k in pp:
        np.testing.assert_allclose(pp[k].grad.numpy(), pu[k].grad.numpy(),
                                   err_msg=k, rtol=1e-4, atol=1e-7)


def test_nmt_packed_adam_steps_match_jax(nmt):
    """3 Adam steps (bench_nmt_packed's lr 5e-4) of packed batches through
    both trainers; T and R change from batch to batch."""
    batches = [_packed_samples(10 + i) for i in range(3)]
    reader = lambda: iter(batches)                       # noqa: E731
    jev, tev = [], []
    init = nmt["init"]
    jtr = pj.SGD(nmt["jcost"], pj.Parameters.from_dict(init),
                 pj.optimizer.Adam(learning_rate=5e-4))
    jtr.train(reader, num_passes=1, event_handler=jev.append,
              feeding=FEEDING, pipeline_depth=0, pack_sequences=True)
    ttr = pt.SGD(nmt["tcost"], pt.Parameters.from_numpy(init),
                 pt.optimizer.Adam(learning_rate=5e-4), device="cpu")
    ttr.train(reader, num_passes=1, event_handler=tev.append,
              feeding=FEEDING, pack_sequences=True)
    jc = [e.cost for e in jev if isinstance(e, pj.event.EndIteration)]
    tc = [e.cost for e in tev if isinstance(e, pt.event.EndIteration)]
    assert len(tc) == len(jc) == 3
    np.testing.assert_allclose(tc, jc, **PTOL)
    for k in init:
        got = ttr.parameters.get(k).numpy()
        np.testing.assert_allclose(got, np.asarray(jtr.parameters.get(k)),
                                   err_msg=k, **PTOL)
        assert not np.array_equal(got, init[k]), f"{k} never moved"


# --- SGD.train: packed against padded ----------------------------------------

TV, TC = 40, 5


def _tagger_samples(seed=0, n=48, lo=2, hi=12):
    r = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        t = int(r.randint(lo, hi))
        out.append((r.randint(0, TV, t).tolist(), r.randint(0, TC, t).tolist()))
    return out


def _tagger(cell):
    """emb -> GRU or LSTM -> fc softmax -> per-token xent, with a token
    error and a chunk evaluator (JAX tests/test_packing.py's tagger)."""
    with torch_name_scope():
        w = pt.layer.data(name="w", type=pt.data_type.integer_value_sequence(
            TV))
        lab = pt.layer.data(name="l",
                            type=pt.data_type.integer_value_sequence(TC))
        emb = pt.layer.embedding(input=w, size=8, name="emb")
        rnn = pt.networks.simple_gru if cell == "gru" else \
            pt.networks.simple_lstm
        h = rnn(input=emb, size=8, name="g")
        out = pt.layer.fc(input=h, size=TC, act=pt.activation.Softmax(),
                          name="out")
        cost = pt.layer.classification_cost(input=out, label=lab,
                                            name="cost")
    init = {k: v.numpy() for k, v in
            pt.Topology(cost).init_params(torch.Generator().manual_seed(3))
            .items()}
    evs = {"err": pt.evaluator.classification_error(input="out", label="l"),
           "chunk": pt.evaluator.chunk(input="out", label="l",
                                       chunk_scheme="IOB",
                                       num_chunk_types=2)}
    return pt.SGD(cost, pt.Parameters.from_numpy(init),
                  pt.optimizer.Adam(learning_rate=1e-2), evaluators=evs,
                  device="cpu")


@pytest.mark.parametrize("cell", ["gru", "lstm"])
def test_packed_training_follows_the_padded_trajectory(cell):
    """The same sample stream packed and padded (JAX tests/test_packing.py
    :534): per-batch costs and final parameters allclose, evaluator totals
    equal (chunk decodes each packed segment alone), and test() alike."""
    samples = _tagger_samples()
    reader = pt.batch(lambda: iter(samples), 16)
    runs = []
    for pack in (False, True):
        tr = _tagger(cell)
        costs = []
        tr.train(reader, num_passes=2, pack_sequences=pack,
                 event_handler=lambda e: costs.append(e.cost) if isinstance(
                     e, pt.event.EndIteration) else None)
        test = tr.test(reader, pack_sequences=pack)
        runs.append((costs, {k: dict(ev._acc) for k, ev in
                             tr.evaluators.items()},
                     tr.parameters.as_dict(), test))
    (c0, a0, p0, t0), (c1, a1, p1, t1) = runs
    assert len(c0) == len(c1) == 6
    np.testing.assert_allclose(c1, c0, rtol=2e-4, atol=2e-5)
    for name in a0:
        for k in a0[name]:
            np.testing.assert_array_equal(a1[name][k], a0[name][k],
                                          err_msg=f"{name}/{k}")
    for k in p0:
        np.testing.assert_allclose(np.asarray(p1[k]), np.asarray(p0[k]),
                                   rtol=2e-4, atol=2e-5, err_msg=k)
    np.testing.assert_allclose(t1.cost, t0.cost, rtol=2e-4)
    assert t1.metrics == t0.metrics


# --- mixed precision ---------------------------------------------------------

BF16_WIDTHS = dict(src_dict_dim=V, trg_dict_dim=V, word_vector_dim=16,
                   encoder_size=128, decoder_size=32, num_heads=NH)


class _jax_kernel_path:
    """The JAX layer's kernel path on the CPU: jax.default_backend reports
    "tpu" and fused_gru runs in interpret mode."""

    def __enter__(self):
        self.backend, self.fused = jax.default_backend, jax_gru.fused_gru
        fused = self.fused
        jax.default_backend = lambda: "tpu"
        jax_gru.fused_gru = lambda x3, wg, wc, b, m, r=None, i=False: fused(
            x3, wg, wc, b, m, r, True)

    def __exit__(self, *exc):
        jax.default_backend, jax_gru.fused_gru = self.backend, self.fused


def test_packed_mixed_precision_step_matches_jax():
    """loss_fn(compute_dtype=bf16) of nmt_packed_cost on packed rows: the
    encoder's two GRUs (H = 128, 8 rows) through the port's bf16 plain
    versions and the JAX Pallas kernel in interpret mode, both with the
    resets (the reverse one's flipped segment ends); the decoder (H = 32)
    through the port's plain version and JAX's scan. The cost within 1e-3
    relative, each gradient within 2e-2 of its largest, and two Adam
    steps' costs within 1e-3 (tests/test_torch_gru_bf16.py's limits for
    nmt_attention_cost), the second step on the same batch."""
    jcost, tcost = _both(lambda mod: (
        jax_packed_cost if mod is pj else torch_packed_cost)(**BF16_WIDTHS))
    jtopo, ttopo = pj.Topology(jcost), pt.Topology(tcost)
    init = _init(jtopo, 3)
    batch = _packed_samples(20)
    jfeeds = JFeeder(jtopo.data_type(), FEEDING, pack_sequences=True,
                     pack_max_len=16)(batch)
    tfeeds = _on_cpu(TFeeder(ttopo.data_type(), FEEDING, pack_sequences=True,
                             pack_max_len=16)(batch))
    assert tfeeds["src"].value.shape == (8, 16)
    jp = {k: jnp.asarray(v) for k, v in init.items()}
    with _jax_kernel_path():
        # make_train_step's step, its gradient jitted once for both steps
        loss = jtopo.loss_fn(compute_dtype=jnp.bfloat16)
        vg = jax.jit(jax.value_and_grad(
            lambda p, feeds: loss(p, feeds, jax.random.PRNGKey(0)),
            has_aux=True))
        (jcost_v, _), jgrads = vg(jp, jfeeds)
        opt = pj.optimizer.Adam(learning_rate=5e-3)
        p1, _ = opt.update(jgrads, opt.init(jp), jp, jtopo.lr_mults(),
                           jtopo.static_map())
        jcosts = [float(jcost_v), float(vg(p1, jfeeds)[0][0])]
    tloss = ttopo.loss_fn(compute_dtype=BF16)
    leaves = _torch_params(init, grad=True)
    cost, _ = tloss(leaves, tfeeds)
    cost.backward()
    assert abs(float(cost.detach()) - float(jcost_v)) <= \
        1e-3 * abs(float(jcost_v))
    for k, want in jgrads.items():
        want = np.asarray(want)
        got = leaves[k].grad
        assert got.dtype == torch.float32, k
        assert np.abs(got.numpy() - want).max() <= \
            2e-2 * np.abs(want).max(), k
    opt = pt.optimizer.Adam(learning_rate=5e-3)
    step = torch_train_step(tloss, opt, ttopo.static_map(), ttopo.lr_mults())
    params = _torch_params(init)
    state, costs = opt.init(params), []
    for _ in range(2):
        params, state, c, _ = step(params, state, tfeeds)
        costs.append(float(c))
    np.testing.assert_allclose(costs, jcosts, rtol=1e-3)


# --- evaluators ---------------------------------------------------------------

def _id_arg(mod_arg, conv, rows, seg=None):
    T = max(len(r) for r in rows)
    val = np.zeros((len(rows), T), np.int32)
    mask = np.zeros((len(rows), T), np.float32)
    for i, r in enumerate(rows):
        val[i, :len(r)] = r
        mask[i, :len(r)] = 1
    return mod_arg(conv(val), conv(mask),
                   None if seg is None else conv(np.asarray(seg, np.int32)))


def test_chunk_splits_packed_rows_as_jax_does():
    """Two sequences in one packed row give the unpacked totals (JAX
    tests/test_packing.py:783): a chunk never spans the boundary."""
    seq_a, seq_b = [0, 1, 4, 0, 1], [1, 3, 0]     # b opens with I-0
    lab_a, lab_b = [0, 1, 4, 2, 3], [1, 1, 4]
    seg = [[0] * 5 + [1] * 3]
    accs = []
    for mod, arg, conv in ((pj, JArg, jnp.asarray),
                           (pt, TArg, torch.from_numpy)):
        ev_u = mod.evaluator.chunk(input="p", label="l", chunk_scheme="IOB",
                                   num_chunk_types=2)
        ev_u.accumulate(ev_u.compute({"p": _id_arg(arg, conv, [seq_a, seq_b]),
                                      "l": _id_arg(arg, conv, [lab_a, lab_b])}))
        ev_p = mod.evaluator.chunk(input="p", label="l", chunk_scheme="IOB",
                                   num_chunk_types=2)
        ev_p.packed_feed = True
        ev_p.accumulate(ev_p.compute(
            {"p": _id_arg(arg, conv, [seq_a + seq_b], seg),
             "l": _id_arg(arg, conv, [lab_a + lab_b], seg)}))
        assert ev_p._acc == ev_u._acc
        # without the split a B-0 chunk would straddle the boundary
        ev_n = mod.evaluator.chunk(input="p", label="l", chunk_scheme="IOB",
                                   num_chunk_types=2)
        ev_n.accumulate(ev_n.compute(
            {"p": _id_arg(arg, conv, [seq_a + seq_b], seg),
             "l": _id_arg(arg, conv, [lab_a + lab_b], seg)}))
        assert ev_n._acc != ev_u._acc
        accs.append((ev_p._acc, ev_n._acc))
    assert accs[0] == accs[1]


def test_evaluators_ignore_nested_seg_ids_without_packed_feed():
    """Nested outputs carry seg_ids but are not packed: unless the trainer
    sets packed_feed, chunk keeps its per-row decode and ctc_error does not
    refuse (JAX tests/test_packing.py:819)."""
    seg = [[0, 0, 1, 1]]
    pred, lab = [[0, 1, 0, 1]], [[0, 1, 1, 1]]
    for mod, arg, conv in ((pj, JArg, jnp.asarray),
                           (pt, TArg, torch.from_numpy)):
        ev = mod.evaluator.chunk(input="p", label="l", chunk_scheme="IOB",
                                 num_chunk_types=1)
        assert ev.packed_feed is False
        outs = {"p": _id_arg(arg, conv, pred, seg),
                "l": _id_arg(arg, conv, lab, seg)}
        ev.accumulate(ev.compute(outs))
        plain = mod.evaluator.chunk(input="p", label="l", chunk_scheme="IOB",
                                    num_chunk_types=1)
        plain.accumulate(plain.compute({"p": _id_arg(arg, conv, pred),
                                        "l": _id_arg(arg, conv, lab)}))
        assert ev._acc == plain._acc
        ctc = mod.evaluator.ctc_error(input="o", label="l")
        ctc.compute({"o": arg(conv(np.zeros((1, 4, 3), np.float32)),
                              conv(np.ones((1, 4), np.float32)),
                              conv(np.asarray(seg, np.int32))),
                     "l": _id_arg(arg, conv, [[1, 2]])})


def test_trainer_tells_the_evaluators_a_packed_feed():
    from paddle_tpu_torch.trainer.trainer import _compute_metrics

    tr = _tagger("gru")
    samples = _tagger_samples(n=6)
    for pack in (True, False):
        feeds = _on_cpu(TFeeder(tr.topology.data_type(),
                                pack_sequences=pack)(samples))
        params = _torch_params({k: v.numpy() for k, v in
                                tr.parameters.as_dict().items()})
        outs = tr.topology.forward(params, feeds)
        _compute_metrics(tr.evaluators, outs, tr._loss, feeds)
        assert all(ev.packed_feed is pack for ev in tr.evaluators.values())


# --- the guard rails ------------------------------------------------------------

def _guard_models():
    """(name, build(mod), samples, feeding): each model reaches a layer
    that refuses packed rows (JAX tests/test_packing.py:675-780)."""
    def pooled(level):
        def build(mod):
            w = mod.layer.data(name="w",
                               type=mod.data_type.integer_value_sequence(V))
            emb = mod.layer.embedding(input=w, size=8, name="emb")
            pool = mod.layer.pooling(input=emb,
                                     pooling_type=mod.pooling.Max(),
                                     agg_level=level, name="pool")
            return mod.layer.fc(input=pool, size=2,
                                act=mod.activation.Softmax(), name="out")
        return build

    def group(mod):
        w = mod.layer.data(name="w",
                           type=mod.data_type.integer_value_sequence(V))
        emb = mod.layer.embedding(input=w, size=8, name="emb")

        def step(x):
            mem = mod.layer.memory(name="m", size=8)
            return mod.layer.fc(input=[x, mem], size=8,
                                act=mod.activation.Tanh(), name="m")

        return mod.layer.recurrent_group(step=step, input=[emb], name="grp")

    def ctc(mod):
        frames = mod.layer.data(
            name="x", type=mod.data_type.dense_vector_sequence(6))
        lab = mod.layer.data(name="l",
                             type=mod.data_type.integer_value_sequence(5))
        return mod.layer.ctc(input=frames, label=lab, size=6, name="ctc")

    def crf_decoding(mod):
        x = mod.layer.data(name="x",
                           type=mod.data_type.dense_vector_sequence(6))
        emit = mod.layer.fc(input=x, size=5, name="emit")
        return mod.layer.crf_decoding(input=emit, size=5, name="dec")

    words = [([1, 2, 3],), ([4, 5],)]
    return [("pooling", pooled("to_no_sequence"), words, {"w": 0}),
            ("to_sequence pooling", pooled("to_sequence"), words, {"w": 0}),
            ("recurrent_group", group, words, {"w": 0}),
            ("ctc", ctc, [([[0.1] * 6] * 4, [1, 2]), ([[0.2] * 6] * 3, [3])],
             {"x": 0, "l": 1}),
            ("crf_decoding", crf_decoding,
             [([[0.1] * 6] * 4,), ([[0.2] * 6] * 3,)], {"x": 0})]


@pytest.mark.parametrize("case", range(5), ids=[
    "pooling", "to_sequence", "recurrent_group", "ctc", "crf_decoding"])
def test_guard_rails_refuse_packed_rows_with_jax_messages(case):
    name, build, samples, feeding = _guard_models()[case]
    jout, tout = _both(build)
    jtopo, ttopo = pj.Topology(jout), pt.Topology(tout)
    init = _init(jtopo, 0)
    jfeeds = JFeeder(jtopo.data_type(), feeding, pack_sequences=True)(samples)
    with pytest.raises(JError) as je:
        jtopo.forward({k: jnp.asarray(v) for k, v in init.items()}, jfeeds)
    tfeeds = _on_cpu(TFeeder(ttopo.data_type(), feeding,
                             pack_sequences=True)(samples))
    with pytest.raises(Error) as te:
        ttopo.forward(_torch_params(init), tfeeds)
    assert "packed" in str(te.value)
    assert str(te.value) == str(je.value), name
    # unpacked, the same model runs
    ttopo.forward(_torch_params(init), _on_cpu(
        TFeeder(ttopo.data_type(), feeding)(samples)))


def test_sequence_layer_guards_fire_on_a_packed_context():
    """The row-level sequence layers and beam search refuse a packed
    context by its flag alone, with JAX's messages."""
    from paddle_tpu.core.layer import LAYER_REGISTRY as JREG
    from paddle_tpu_torch.core.layer import LAYER_REGISTRY as TREG

    class Cfg:
        name = "l0"

        def __init__(self, type_):
            self.type = type_

        def attr(self, key, default=None):
            return default

    class JCtx:
        packed = True

    jins = [JArg(jnp.zeros((1, 3, 2)), jnp.ones((1, 3)))] * 3
    tins = [TArg(torch.zeros(1, 3, 2), torch.ones(1, 3))] * 3
    for type_ in ("seqlastins", "expand", "seqconcat", "seqreshape",
                  "seq_slice", "subseq", "kmax_seq_score", "beam_search"):
        cfg = Cfg(type_)
        with pytest.raises(JError) as je:
            JREG.get(type_).forward(cfg, {}, jins, JCtx())
        with pytest.raises(Error) as te:
            TREG.get(type_).forward(cfg, {}, tins,
                                    ForwardContext(packed=True))
        assert "packed sequence rows" in str(te.value)
        assert str(te.value) == str(je.value), type_


def test_packed_loss_reaches_the_ctc_guard_and_warp_ctc_names_ctc():
    """warp_ctc refuses as JAX's does: its message names the ctc layer."""
    jout, tout = _both(lambda mod: mod.layer.warp_ctc(
        input=mod.layer.data(name="x",
                             type=mod.data_type.dense_vector_sequence(6)),
        label=mod.layer.data(name="l",
                             type=mod.data_type.integer_value_sequence(5)),
        size=6, name="wctc"))
    samples = [([[0.1] * 6] * 4, [1, 2]), ([[0.2] * 6] * 3, [3])]
    jtopo, ttopo = pj.Topology(jout), pt.Topology(tout)
    with pytest.raises(JError) as je:
        jtopo.loss_fn()({}, JFeeder(jtopo.data_type(), {"x": 0, "l": 1},
                                    pack_sequences=True)(samples))
    with pytest.raises(Error) as te:
        ttopo.loss_fn()({}, _on_cpu(TFeeder(ttopo.data_type(),
                                            {"x": 0, "l": 1},
                                            pack_sequences=True)(samples)))
    assert str(te.value) == str(je.value)
    assert str(te.value).startswith("ctc layer wctc: packed")


# --- launch counts ---------------------------------------------------------------

def test_reset_launches_count_beside_launches():
    tk.reset_launch_counts()
    tk.count_launch("fused_gru")
    tk.count_launch("fused_gru", torch.zeros(1, 1))
    tk.count_launch("fused_lstm_bwd_bf16", torch.zeros(1, 1))
    assert tk.launches["fused_gru"] == 2 and \
        tk.reset_launches["fused_gru"] == 1
    assert tk.reset_launches["fused_lstm_bwd_bf16"] == 1
    assert set(tk.reset_launches) == set(tk.launches)
    tk.reset_launch_counts()
    assert not any(tk.launches.values()) and \
        not any(tk.reset_launches.values())


# --- sort_within_buffer -------------------------------------------------------------

def _windows(data, size, key=None):
    got = list(sort_within_buffer(lambda: iter(data), size, key)())
    want = list(jax_sort(lambda: iter(data), size, key)())
    assert got == want
    return got


def test_sort_within_buffer_windows_equal_jax():
    data = [[1] * t for t in (5, 2, 9, 1, 7, 3, 8, 4)]
    got = _windows(data, 4)
    assert [len(x) for x in got] == [1, 2, 5, 9, 3, 4, 7, 8]
    assert sorted(len(x) for x in got) == sorted(len(x) for x in data)
    # tuple samples sort by their first sized slot, not the slot count
    tup = [([1] * t, t % 5) for t in (5, 2, 9, 1, 3)]
    assert [len(s[0]) for s in _windows(tup, 4)] == [1, 2, 5, 9, 3]
    assert [len(s[0]) for s in _windows(tup, 2, key=lambda s: -len(s[0]))] \
        == [5, 2, 9, 1, 3]
    with pytest.raises(TypeError, match="no sized slot"):
        list(sort_within_buffer(lambda: iter([(1, 2)]), 2)())


def test_sort_within_buffer_cuts_padding_waste():
    r = np.random.RandomState(0)
    lens = [int(r.randint(1, 33)) for _ in range(64)]
    base = lambda: iter([([1] * t,) for t in lens])     # noqa: E731
    sorted_reader = sort_within_buffer(base, 32)
    types = [("w", pt.data_type.integer_value_sequence(V))]

    def waste(reader, **kw):
        feeder = TFeeder(types, **kw)
        fracs = []
        for b in pt.batch(reader, 8)():
            m = feeder(b)["w"].mask
            fracs.append(1 - m.sum() / m.size)
        return float(np.mean(fracs))

    assert waste(sorted_reader) < waste(base)
