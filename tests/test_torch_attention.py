"""The port's multi-head attention and ``nmt_packed_cost`` against the JAX
package on the CPU.

- ``multi_head_attention`` (layers/attention.py): self- and
  cross-attention, causal and not, with and without ``bias_attr``, on a
  ragged batch whose keys are padded (one cross row has no valid key: a
  uniform row in both packages), and a key/value feed without a mask (the
  ``reference_attention`` branch): outputs and every gradient at rtol 1e-5
  / atol 1e-6, with the JAX initial parameters carried over as numpy.
- A float64 ``torch.autograd.gradcheck`` of the layer at size 8, 2 heads
  (the twin of tests/test_gradcheck_registry.py's case): the scores
  stay float64.
- ``parallel/ring_attention.reference_attention`` against JAX's, with and
  without ``causal`` and segment ids.
- ``seq_parallel="ring"`` without a mesh gives the plain answer in both
  packages; a packed context attends within each segment as JAX's does,
  and raises with JAX's message without the key/value seg_ids.
- ``models.text.nmt_packed_cost`` at bench_nmt_packed's quick widths
  (bench.py: B 16, V 64, width 32, 2 heads, lengths 4 to 12): the
  softmax output ``mp_out`` at atol 1e-5; the loss and every gradient;
  3 Adam steps through ``SGD.train`` (costs and parameters) at rtol 1e-4.
  Its three GRUs run the fused_gru Function (its plain versions here).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pj
from paddle_tpu.core.arg import Arg as JArg
from paddle_tpu.core.layer import layer_name_scope as jax_name_scope
from paddle_tpu.models.text import nmt_packed_cost as jax_packed_cost
from paddle_tpu.parallel.ring_attention import \
    reference_attention as jax_reference
from paddle_tpu.trainer.feeder import DataFeeder as JFeeder

import paddle_tpu_torch as pt
from paddle_tpu_torch.core.arg import Arg as TArg
from paddle_tpu_torch.core.layer import ForwardContext
from paddle_tpu_torch.core.layer import layer_name_scope as torch_name_scope
from paddle_tpu_torch.models.text import nmt_packed_cost as torch_packed_cost
from paddle_tpu_torch.parallel.ring_attention import \
    reference_attention as torch_reference
from paddle_tpu_torch.trainer.feeder import DataFeeder as TFeeder
from paddle_tpu_torch.utils.error import Error

TOL = dict(rtol=1e-5, atol=1e-6)
PACKAGES = {"jax": (pj, jax_name_scope), "torch": (pt, torch_name_scope)}
B, TQ, TK, DQ, DKV, SIZE, HEADS = 4, 6, 5, 8, 6, 8, 2


def _mha(key, cross, causal, bias, seq_parallel=None):
    mod, scope = PACKAGES[key]
    with scope():
        q = mod.layer.data(name="q",
                           type=mod.data_type.dense_vector_sequence(DQ))
        kv = mod.layer.data(name="kv",
                            type=mod.data_type.dense_vector_sequence(DKV)) \
            if cross else None
        out = mod.layer.multi_head_attention(
            query=q, key_value=kv, size=SIZE, num_heads=HEADS, causal=causal,
            seq_parallel=seq_parallel, name="attn",
            bias_attr=None if bias else False)
    return mod.Topology(out), out


def _seq(r, T, D, lengths):
    v = r.randn(B, T, D).astype(np.float32)
    m = (np.arange(T)[None, :] < np.asarray(lengths)[:, None]).astype(
        np.float32)
    return v, m


def _feeds(cross, masked=True):
    """A ragged batch; the padded steps hold values too (masking, not
    zeros, must hide them). A cross row with no valid key."""
    r = np.random.RandomState(3)
    feeds = {"q": _seq(r, TQ, DQ, [6, 3, 1, 5])}
    if cross:
        feeds["kv"] = _seq(r, TK, DKV, [5, 2, 0, 4])
    if not masked:
        feeds = {k: (v, None) for k, (v, _m) in feeds.items()}
    return feeds


def _init(topo):
    return {k: np.array(v) for k, v in
            topo.init_params(jax.random.PRNGKey(5)).items()}


def _jax_run(topo, out, init, feeds):
    jf = {k: JArg(jnp.asarray(v), None if m is None else jnp.asarray(m))
          for k, (v, m) in feeds.items()}
    w = np.random.RandomState(9).randn(B, TQ, SIZE).astype(np.float32)

    def f(params):
        y = topo.forward(params, jf)[out.name].value
        return (y * w).sum(), y

    (_, y), g = jax.value_and_grad(f, has_aux=True)(
        {k: jnp.asarray(v) for k, v in init.items()})
    return np.asarray(y), {k: np.asarray(v) for k, v in g.items()}, w


def _torch_run(topo, out, init, feeds, w):
    tf = {k: TArg(torch.from_numpy(v),
                  None if m is None else torch.from_numpy(m))
          for k, (v, m) in feeds.items()}
    params = {k: torch.from_numpy(v.copy()).requires_grad_(True)
              for k, v in init.items()}
    y = topo.forward(params, tf)[out.name].value
    (y * torch.from_numpy(w)).sum().backward()
    return y.detach().numpy(), {k: p.grad.numpy() for k, p in params.items()}


CASES = [(cross, causal, bias) for cross in (False, True)
         for causal in (False, True) for bias in (False, True)]


@pytest.mark.parametrize("cross,causal,bias", CASES)
def test_multi_head_attention_matches_jax(cross, causal, bias):
    jtopo, jout = _mha("jax", cross, causal, bias)
    ttopo, tout = _mha("torch", cross, causal, bias)
    init = _init(jtopo)
    assert sorted(ttopo.param_specs()) == sorted(init)
    assert ("_attn.wbias" in init) == bias
    feeds = _feeds(cross)
    jy, jg, w = _jax_run(jtopo, jout, init, feeds)
    ty, tg = _torch_run(ttopo, tout, init, feeds, w)
    assert ty.shape == (B, TQ, SIZE)
    np.testing.assert_allclose(ty, jy, **TOL)
    # the query's padding gives zeros
    assert not ty[feeds["q"][1] == 0].any()
    for k in jg:
        np.testing.assert_allclose(tg[k], jg[k], err_msg=k, **TOL)


@pytest.mark.parametrize("causal", [False, True])
def test_unmasked_key_value_takes_reference_attention(causal):
    """A key/value feed without a mask: the reference_attention branch in
    both packages."""
    jtopo, jout = _mha("jax", True, causal, True)
    ttopo, tout = _mha("torch", True, causal, True)
    init = _init(jtopo)
    feeds = _feeds(True, masked=False)
    jy, jg, w = _jax_run(jtopo, jout, init, feeds)
    ty, tg = _torch_run(ttopo, tout, init, feeds, w)
    np.testing.assert_allclose(ty, jy, **TOL)
    for k in jg:
        np.testing.assert_allclose(tg[k], jg[k], err_msg=k, **TOL)


def test_multi_head_attention_float64_gradcheck():
    """The layer at size 8, 2 heads, float64 on a ragged batch: the
    masked branch keeps the scores in float64, so finite differences see
    no float32 rounding."""
    with torch_name_scope():
        q = pt.layer.data(name="q", type=pt.data_type.dense_vector_sequence(8))
        out = pt.layer.multi_head_attention(query=q, size=8, num_heads=2)
    topo = pt.Topology(out)
    init = {k: v.to(torch.float64) for k, v in topo.init_params().items()}
    names = sorted(init)
    r = np.random.RandomState(0)
    m = np.ones((3, 4))
    m[0, -1] = 0
    m[1, -2:] = 0
    x = torch.from_numpy(r.randn(3, 4, 8) * 0.5 * m[..., None])
    mask = torch.from_numpy(m)

    def f(x, *ws):
        y = topo.forward(dict(zip(names, ws)), {"q": TArg(x, mask)})[
            out.name].value
        assert y.dtype == torch.float64
        return y

    args = [x.requires_grad_(True)] + [init[k].requires_grad_(True)
                                       for k in names]
    assert torch.autograd.gradcheck(f, args, eps=1e-6, atol=1e-5)


@pytest.mark.parametrize("causal,segs", [(False, False), (True, False),
                                         (False, True), (True, True)])
def test_reference_attention_matches_jax(causal, segs):
    r = np.random.RandomState(1)
    q = r.randn(2, 6, 3, 4).astype(np.float32)
    k = r.randn(2, 6, 3, 4).astype(np.float32)
    v = r.randn(2, 6, 3, 4).astype(np.float32)
    seg = np.array([[0, 0, 1, 1, 1, -1], [0, 1, 2, 2, -1, -1]], np.int32)
    kw = dict(seg_q=seg, seg_kv=seg) if segs else {}
    want = jax_reference(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                         causal=causal,
                         **{n: jnp.asarray(a) for n, a in kw.items()})
    got = torch_reference(torch.from_numpy(q), torch.from_numpy(k),
                          torch.from_numpy(v), causal=causal,
                          **{n: torch.from_numpy(a) for n, a in kw.items()})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # an explicit scale
    got2 = torch_reference(torch.from_numpy(q), torch.from_numpy(k),
                           torch.from_numpy(v), causal=causal, scale=0.3)
    want2 = jax_reference(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                          causal=causal, scale=0.3)
    np.testing.assert_allclose(got2.numpy(), np.asarray(want2), **TOL)


@pytest.mark.parametrize("backend", ["ring", "ulysses"])
def test_seq_parallel_without_a_mesh_is_the_plain_layer(backend):
    jtopo, jout = _mha("jax", True, False, True, seq_parallel=backend)
    ttopo, tout = _mha("torch", True, False, True, seq_parallel=backend)
    plain, pout = _mha("torch", True, False, True)
    init = _init(jtopo)
    feeds = _feeds(True)
    jy, _jg, w = _jax_run(jtopo, jout, init, feeds)
    ty, _tg = _torch_run(ttopo, tout, init, feeds, w)
    py, _pg = _torch_run(plain, pout, init, feeds, w)
    np.testing.assert_array_equal(ty, py)
    np.testing.assert_allclose(ty, jy, **TOL)


def test_packed_context_raises():
    """A packed context attends within each segment (the block-diagonal
    mask of packing, which replaced the layer's old refusal) as the JAX
    layer does, and raises with the JAX layer's message when the key/value
    input lost its seg_ids."""
    jtopo, _jout = _mha("jax", True, False, True)
    topo, out = _mha("torch", True, False, True)
    layer = next(l for l in topo.layers if l.name == "attn")
    jlayer = next(l for l in jtopo.layers if l.name == "attn")
    init = _init(jtopo)
    params = {s: torch.from_numpy(v) for s, v in
              ((n.split(".")[-1], v) for n, v in init.items())}
    jparams = {s: jnp.asarray(v) for s, v in
               ((n.split(".")[-1], v) for n, v in init.items())}
    feeds = _feeds(True)
    segs = {}
    for n in ("q", "kv"):
        m = feeds[n][1]
        # two packed sequences a row: the valid steps' first half and rest
        half = (np.cumsum(m, axis=1) > m.sum(1, keepdims=True) / 2)
        segs[n] = np.where(m > 0, half.astype(np.int32), -1).astype(np.int32)
    ins = [TArg(torch.from_numpy(feeds[n][0]), torch.from_numpy(feeds[n][1]),
                torch.from_numpy(segs[n])) for n in ("q", "kv")]
    jins = [JArg(jnp.asarray(feeds[n][0]), jnp.asarray(feeds[n][1]),
                 jnp.asarray(segs[n])) for n in ("q", "kv")]

    class Ctx:
        packed, mesh = True, None

    layer.forward(params, ins, ForwardContext())          # unpacked: runs
    got = layer.forward(params, ins, ForwardContext(packed=True)).value
    want = jlayer.forward(jparams, jins, Ctx()).value
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    unpacked = layer.forward(params, ins, ForwardContext()).value
    assert not torch.allclose(got, unpacked, atol=1e-4)
    ins[1] = TArg(ins[1].value, ins[1].mask)
    jins[1] = JArg(jins[1].value, jins[1].mask)
    with pytest.raises(Error, match="packed feeds need seg_ids") as te:
        layer.forward(params, ins, ForwardContext(packed=True))
    with pytest.raises(pj.utils.error.Error) as je:
        jlayer.forward(jparams, jins, Ctx())
    assert str(te.value) == str(je.value)


# --- nmt_packed_cost --------------------------------------------------------

V, WIDTH, NH, NB = 64, 32, 2, 16
PACKED = dict(src_dict_dim=V, trg_dict_dim=V, word_vector_dim=WIDTH,
              encoder_size=WIDTH, decoder_size=WIDTH, num_heads=NH)
FEEDING = {"src": 0, "trg": 1, "trg_next": 2}
PTOL = dict(rtol=1e-4, atol=1e-6)


def _packed_models():
    with jax_name_scope():
        jcost = jax_packed_cost(**PACKED)
    with torch_name_scope():
        tcost = torch_packed_cost(**PACKED)
    return jcost, tcost


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


@pytest.fixture(scope="module")
def packed():
    jcost, tcost = _packed_models()
    jtopo = pj.Topology(jcost)
    init = {k: np.array(v) for k, v in
            jtopo.init_params(jax.random.PRNGKey(2)).items()}
    return jcost, tcost, jtopo, init


def test_nmt_packed_names_and_forward_match_jax(packed):
    jcost, tcost, jtopo, init = packed
    ttopo = pt.Topology(tcost)
    assert sorted(ttopo.param_specs()) == sorted(init)
    assert [l.name for l in ttopo.layers] == [l.name for l in jtopo.layers]
    batch = _packed_samples(0)
    jfeeds = JFeeder(jtopo.data_type(), FEEDING)(batch)
    tfeeds = TFeeder(ttopo.data_type(), FEEDING)(batch)
    for k in jfeeds:
        np.testing.assert_array_equal(tfeeds[k].value,
                                      np.asarray(jfeeds[k].value))
    jout = jtopo.forward({k: jnp.asarray(v) for k, v in init.items()},
                         jfeeds)["mp_out"]
    tout = ttopo.forward({k: torch.from_numpy(v) for k, v in init.items()},
                         {k: a.to("cpu") for k, a in tfeeds.items()})["mp_out"]
    assert tout.value.shape == (NB, 16, V)
    np.testing.assert_allclose(tout.value.numpy(), np.asarray(jout.value),
                               rtol=0, atol=1e-5)
    np.testing.assert_array_equal(tout.mask.numpy(), np.asarray(jout.mask))


def test_nmt_packed_serves_through_infer(packed):
    """``infer`` on the scoring output gives the JAX forward's
    probabilities for the valid steps."""
    jcost, tcost, jtopo, init = packed
    out_layer = tcost.inputs[0]
    assert out_layer.name == "mp_out"
    batch = [s[:2] for s in _packed_samples(1, n=5)]
    got = pt.infer(output_layer=out_layer,
                   parameters=pt.Parameters.from_numpy(init),
                   input=batch, feeding={"src": 0, "trg": 1}, device="cpu")
    jfeeds = JFeeder(pj.Topology(jcost.inputs[0]).data_type(),
                     {"src": 0, "trg": 1})(batch)
    want = pj.Topology(jcost.inputs[0]).forward(
        {k: jnp.asarray(v) for k, v in init.items()}, jfeeds)["mp_out"]
    np.testing.assert_allclose(np.asarray(got).reshape(-1),
                               np.asarray(want.value).reshape(-1),
                               rtol=0, atol=1e-5)


def test_nmt_packed_loss_and_gradients_match_jax(packed):
    jcost, tcost, jtopo, init = packed
    ttopo = pt.Topology(tcost)
    batch = _packed_samples(2)
    jfeeds = JFeeder(jtopo.data_type(), FEEDING)(batch)
    jloss_fn = jtopo.loss_fn(jcost)
    jloss, jgrads = jax.value_and_grad(
        lambda p: jloss_fn(p, jfeeds, training=False)[0])(
        {k: jnp.asarray(v) for k, v in init.items()})
    tfeeds = {k: a.to("cpu") for k, a in
              TFeeder(ttopo.data_type(), FEEDING)(batch).items()}
    params = {k: torch.from_numpy(v.copy()).requires_grad_(True)
              for k, v in init.items()}
    tloss, _ = ttopo.loss_fn(tcost)(params, tfeeds, training=False)
    tloss.backward()
    np.testing.assert_allclose(float(tloss.detach()), float(jloss),
                               rtol=1e-5)
    for k in init:
        np.testing.assert_allclose(params[k].grad.numpy(),
                                   np.asarray(jgrads[k]), err_msg=k,
                                   rtol=1e-4, atol=1e-7)
        assert params[k].grad.abs().sum() > 0, k


def test_nmt_packed_adam_steps_match_jax(packed):
    """3 Adam steps (bench_nmt_packed's lr 5e-4) through both trainers;
    the port's three GRUs run the fused_gru Function."""
    jcost, tcost, jtopo, init = packed
    batches = [_packed_samples(10 + i) for i in range(3)]
    reader = lambda: iter(batches)                       # noqa: E731
    jev, tev = [], []
    jtr = pj.SGD(jcost, pj.Parameters.from_dict(init),
                 pj.optimizer.Adam(learning_rate=5e-4))
    jtr.train(reader, num_passes=1, event_handler=jev.append,
              feeding=FEEDING, pipeline_depth=0)
    ttr = pt.SGD(tcost, pt.Parameters.from_numpy(init),
                 pt.optimizer.Adam(learning_rate=5e-4), device="cpu")
    ttr.train(reader, num_passes=1, event_handler=tev.append, feeding=FEEDING)
    jc = [e.cost for e in jev if isinstance(e, pj.event.EndIteration)]
    tc = [e.cost for e in tev if isinstance(e, pt.event.EndIteration)]
    assert len(tc) == len(jc) == 3
    np.testing.assert_allclose(tc, jc, rtol=1e-4)
    for k in init:
        got = ttr.parameters.get(k).numpy()
        np.testing.assert_allclose(got, np.asarray(jtr.parameters.get(k)),
                                   err_msg=k, **PTOL)
        assert not np.array_equal(got, init[k]), f"{k} never moved"


def test_nmt_packed_grus_take_the_fused_gru_function(packed):
    _j, tcost, _t, init = packed
    topo = pt.Topology(tcost)
    params = {k: torch.from_numpy(v).requires_grad_(True)
              for k, v in init.items()}
    feeds = {k: a.to("cpu") for k, a in
             TFeeder(topo.data_type(), FEEDING)(_packed_samples(3)).items()}
    outs = topo.forward(params, feeds, training=True)
    grus = [l.name for l in topo.layers if l.type == "gated_recurrent"]
    assert sorted(grus) == ["mp_dec", "mp_enc_bwd", "mp_enc_fwd"]
    for name in grus:
        seen, stack = set(), [outs[name].value.grad_fn]
        while stack:
            f = stack.pop()
            if f is None or f in seen:
                continue
            seen.add(f)
            stack.extend(n for n, _ in f.next_functions)
        assert "_FusedGRUBackward" in {type(f).__name__ for f in seen}, name
