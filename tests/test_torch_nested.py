"""Nested sequences in the port against the JAX package on the CPU.

Both packages build the same model with the DSL, take the same
numpy-seeded weights (``Parameters.from_numpy`` of the JAX dict) and the
same inputs (nested rows through both ``DataFeeder``s, or the same
hand-built padded arrays), and give the same values and gradients
(``jax.grad`` against autograd) at rtol 1e-5 / atol 1e-6, V = 50, D = 8,
H = 8:

- the feeder's nested ``value``, ``mask`` and ``seg_ids``, with and
  without ``bucket_rounding``;
- ``seg_ids`` passed on by ``embedding``, ``fc``, ``lstmemory``,
  ``gated_recurrent``, ``concat`` and ``addto`` (the port dropped them);
- a nested model's loss trains (the port refused every feed with
  seg_ids) with JAX's costs, and a packed feed still raises (at the
  pooling layer, with JAX's message);
- pooling ``to_sequence`` in its four strategies, with an empty segment,
  a padded row and an all-padding row;
- the JAX sequence layers one by one, and ``seqlastins`` under
  ``to_sequence`` (a reference-side quirk: one step a row);
- ``SubsequenceInput`` groups: an accumulator, ``gru_step`` against
  ``gated_recurrent`` run on each sub-sequence, a ``boot_layer`` memory;
- the hierarchical classifier (words -> lstm -> max to_sequence ->
  lstm -> max -> fc) through both ``infer``s, and its config round trip.

Float32 on both sides; products and sums run in another order, hence the
tolerances. No test compares against the jax.random golden ids.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pj
from paddle_tpu.core.arg import Arg as JArg
from paddle_tpu.core.layer import Layer as JLayer
from paddle_tpu.core.layer import layer_name_scope as jax_name_scope
from paddle_tpu.core.topology import topology_from_config as jax_from_config
from paddle_tpu.trainer.feeder import DataFeeder as JFeeder

import paddle_tpu_torch as pt
from paddle_tpu_torch.core.arg import Arg as TArg
from paddle_tpu_torch.core.arg import row_offset_segment_ids
from paddle_tpu_torch.core.layer import Layer as TLayer
from paddle_tpu_torch.core.layer import layer_name_scope as torch_name_scope
from paddle_tpu_torch.core.parameters import Parameters as TParameters
from paddle_tpu_torch.core.topology import \
    topology_from_config as torch_from_config
from paddle_tpu_torch.trainer.feeder import DataFeeder as TFeeder
from paddle_tpu_torch.utils.error import Error

V, D, H = 50, 8, 8
TOL = dict(rtol=1e-5, atol=1e-6)
LAYER = {"jax": JLayer, "torch": TLayer}


def _both(build):
    """build(mod, Layer) in each package's name scope: (jax, torch)."""
    with jax_name_scope():
        j = build(pj, JLayer)
    with torch_name_scope():
        t = build(pt, TLayer)
    return j, t


def _weights(topology, seed, scale=0.3):
    r = np.random.RandomState(seed)
    return {name: (r.randn(*spec.shape) * scale).astype(np.float32)
            for name, spec in sorted(topology.param_specs().items())}


def _paragraphs(seed, B, max_sent=4, max_words=5, first_full=True):
    """B rows of 1..max_sent sentences of 1..max_words word ids; the first
    row is max_sent sentences of max_words words (sets T)."""
    r = np.random.RandomState(seed)
    rows = []
    for b in range(B):
        n = max_sent if (b == 0 and first_full) else r.randint(1, max_sent + 1)
        rows.append([r.randint(0, V, size=max_words if (b == 0 and first_full)
                               else r.randint(1, max_words + 1)).tolist()
                     for _ in range(n)])
    return rows


def _args(np_feeds):
    """{name: (value, mask, seg)} numpy -> ({jax Args}, {torch Args})."""
    def conv(A, fn):
        return {k: A(*(None if x is None else fn(x) for x in v))
                for k, v in np_feeds.items()}
    return conv(JArg, jnp.asarray), conv(TArg, torch.from_numpy)


def _forward(j, t, d, jfeeds, tfeeds):
    """Both topologies' forwards from the numpy weights d."""
    jo = j.forward({k: jnp.asarray(v) for k, v in d.items()}, jfeeds)
    with torch.no_grad():
        to = t.forward({k: torch.from_numpy(v) for k, v in d.items()},
                       tfeeds)
    return jo, to


def _assert_args(ja, ta, seg=True):
    np.testing.assert_allclose(ta.value.numpy(), np.asarray(ja.value), **TOL)
    for field in ("mask",) + (("seg_ids",) if seg else ()):
        jv, tv = getattr(ja, field), getattr(ta, field)
        assert (jv is None) == (tv is None), field
        if jv is not None:
            np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def _grads(j, t, d, jfeeds, tfeeds, names, seed=5):
    """Gradients of sum(out * cotangent) over the outputs ``names``, with
    respect to every parameter, in both packages."""
    jo, _ = _forward(j, t, d, jfeeds, tfeeds)
    r = np.random.RandomState(seed)
    cot = {n: r.randn(*np.asarray(jo[n].value).shape).astype(np.float32)
           for n in names}

    def jloss(p):
        o = j.forward(p, jfeeds)
        return sum((o[n].value * cot[n]).sum() for n in names)

    jg = jax.grad(jloss)({k: jnp.asarray(v) for k, v in d.items()})
    tp = {k: torch.from_numpy(v).requires_grad_() for k, v in d.items()}
    o = t.forward(tp, tfeeds)
    sum((o[n].value * torch.from_numpy(cot[n])).sum() for n in names) \
        .backward()
    assert sorted(jg) == sorted(tp)
    for k in jg:
        np.testing.assert_allclose(tp[k].grad.numpy(), np.asarray(jg[k]),
                                   err_msg=k, **TOL)


# --- the feeder --------------------------------------------------------------

def _nested_rows(kind, seed):
    r = np.random.RandomState(seed)
    rows = []
    for n_sent in (3, 1, 2):
        sents = []
        for _ in range(n_sent):
            L = int(r.randint(1, 5))
            sents.append(r.randint(0, V, size=L).tolist() if kind == "index"
                         else r.randn(L, D).astype(np.float32).tolist())
        rows.append(sents)
    return rows


@pytest.mark.parametrize("rounding", [None, 3])
@pytest.mark.parametrize("kind", ["index", "dense"])
def test_feeder_nested_matches_jax(kind, rounding):
    jt = (pj.data_type.integer_value_sub_sequence(V) if kind == "index"
          else pj.data_type.dense_vector_sub_sequence(D))
    tt = (pt.data_type.integer_value_sub_sequence(V) if kind == "index"
          else pt.data_type.dense_vector_sub_sequence(D))
    assert tt.seq_type == 2 and tt.is_nested and tt.dim == jt.dim
    rows = [(r,) for r in _nested_rows(kind, 3)]
    ja = JFeeder([("x", jt)], bucket_rounding=rounding)(rows)["x"]
    ta = TFeeder([("x", tt)], bucket_rounding=rounding)(rows)["x"]
    assert ta.seg_ids.dtype == np.int32
    for field in ("value", "mask", "seg_ids"):
        want = np.asarray(getattr(ja, field))
        got = np.asarray(getattr(ta, field))
        assert got.dtype == want.dtype, field
        np.testing.assert_array_equal(got, want, err_msg=field)
    # padding is -1, each step its sentence's index
    assert (ta.seg_ids[ta.mask == 0] == -1).all()
    assert ta.seg_ids[0, :ta.mask[0].sum().astype(int)].max() == 2


def test_row_offset_segment_ids():
    seg = torch.tensor([[0, 0, 1, -1], [0, 2, 2, -1]], dtype=torch.int32)
    got = row_offset_segment_ids(seg, 3)
    assert got.dtype == torch.int64
    assert got.tolist() == [0, 0, 1, 0, 3, 5, 5, 3]


# --- fault 1: seg_ids through the time-preserving layers -------------------

def _pass_through_model(mod, Layer):
    x = mod.layer.data(name="para",
                       type=mod.data_type.integer_value_sub_sequence(V))
    emb = mod.layer.embedding(input=x, size=D, name="emb")
    f4 = mod.layer.fc(input=emb, size=4 * H, name="f4",
                      act=mod.activation.Linear())
    lstm = mod.layer.lstmemory(input=f4, name="lstm")
    f3 = mod.layer.fc(input=emb, size=3 * H, name="f3",
                      act=mod.activation.Linear())
    gru = mod.layer.grumemory(input=f3, name="gru")
    cat = mod.layer.concat(input=[lstm, gru], name="cat")
    add = mod.layer.addto(input=[lstm, gru], name="add")
    return [cat, add]


PASS_THROUGH = ("emb", "f4", "lstm", "f3", "gru", "cat", "add")


@pytest.fixture(scope="module")
def pass_through():
    jl, tl = _both(_pass_through_model)
    j, t = pj.Topology(jl), pt.Topology(tl)
    d = _weights(j, 11)
    rows = [(r,) for r in _paragraphs(12, 4)]
    jfeeds = JFeeder(j.data_type())(rows)
    tfeeds = TFeeder(t.data_type())(rows)
    jfeeds = {k: JArg(*(None if x is None else jnp.asarray(x)
                        for x in (a.value, a.mask, a.seg_ids)))
              for k, a in jfeeds.items()}
    tfeeds = {k: a.to("cpu") for k, a in tfeeds.items()}
    return j, t, d, jfeeds, tfeeds


@pytest.mark.parametrize("name", PASS_THROUGH)
def test_seg_ids_pass_through(pass_through, name):
    j, t, d, jfeeds, tfeeds = pass_through
    jo, to = _forward(j, t, d, jfeeds, tfeeds)
    assert jo[name].seg_ids is not None
    _assert_args(jo[name], to[name])


def test_seg_ids_layers_gradients(pass_through):
    _grads(*pass_through, names=["cat", "add"])


# --- fault 2: a nested model trains --------------------------------------

def _classifier(mod, Layer, hidden=H):
    """The hierarchical classifier: words -> simple_lstm -> max over each
    sentence -> simple_lstm over the sentences -> max -> fc(2)."""
    x = mod.layer.data(name="para",
                       type=mod.data_type.integer_value_sub_sequence(V))
    lbl = mod.layer.data(name="label", type=mod.data_type.integer_value(2))
    emb = mod.layer.embedding(input=x, size=D)
    words = mod.networks.simple_lstm(input=emb, size=hidden)
    sents = mod.layer.pooling(input=words, pooling_type=mod.pooling.Max(),
                              agg_level=mod.layer.AggregateLevel.TO_SEQUENCE)
    para = mod.networks.simple_lstm(input=sents, size=hidden)
    top = mod.layer.pooling(input=para, pooling_type=mod.pooling.Max())
    out = mod.layer.fc(input=top, size=2, act=mod.activation.Softmax())
    cost = mod.layer.classification_cost(input=out, label=lbl)
    return words, sents, out, cost


def _train_batches(seed, n=3, B=4):
    r = np.random.RandomState(seed)
    return [[(p, int(r.randint(0, 2))) for p in _paragraphs(seed + i, B)]
            for i in range(n)]


def test_nested_model_trains_like_jax():
    (jw, js, jout, jcost), (tw, ts, tout, tcost) = _both(_classifier)
    init = _weights(pj.Topology(jcost), 21)
    batches = _train_batches(22)
    reader = lambda: iter(batches)                      # noqa: E731
    feeding = {"para": 0, "label": 1}
    jc, tc = [], []
    jtr = pj.SGD(jcost, pj.Parameters.from_dict(init),
                 pj.optimizer.Adam(learning_rate=1e-2))
    jtr.train(reader, num_passes=1, feeding=feeding, pipeline_depth=0,
              event_handler=lambda e: isinstance(e, pj.event.EndIteration)
              and jc.append(e.cost))
    ttr = pt.SGD(tcost, TParameters.from_numpy(init),
                 pt.optimizer.Adam(learning_rate=1e-2), device="cpu")
    ttr.train(reader, num_passes=1, feeding=feeding,
              event_handler=lambda e: isinstance(e, pt.event.EndIteration)
              and tc.append(e.cost))
    assert len(tc) == len(jc) == 3
    np.testing.assert_allclose(tc, jc, **TOL)
    jfinal, tfinal = jtr.parameters.as_dict(), ttr.parameters.as_dict()
    for k in jfinal:
        np.testing.assert_allclose(np.asarray(tfinal[k]),
                                   np.asarray(jfinal[k]), rtol=0, atol=1e-5,
                                   err_msg=k)


def test_packed_feed_still_raises():
    """seg_ids on a plain sequence feed mean packed rows, which a pooling
    over the whole row would mix: the pooling layer refuses them with the
    JAX layer's message (a nested feed's seg_ids pool per sub-sequence)."""
    def build(mod, Layer):
        x = mod.layer.data(name="w",
                           type=mod.data_type.integer_value_sequence(V))
        emb = mod.layer.embedding(input=x, size=D)
        pool = mod.layer.pooling(input=emb, pooling_type=mod.pooling.Sum())
        return mod.layer.fc(input=pool, size=1, act=mod.activation.Linear())
    jout, tout = _both(build)
    t = pt.Topology(tout)
    w = _weights(t, 1)
    d = {k: torch.from_numpy(v) for k, v in w.items()}
    ids = torch.tensor([[1, 2, 3, 4]], dtype=torch.int32)
    mask = torch.ones(1, 4)
    seg = torch.tensor([[0, 0, 1, 1]], dtype=torch.int32)
    loss = t.loss_fn()
    loss(d, {"w": TArg(ids, mask)})                    # plain: trains
    with pytest.raises(Error, match="packed sequence rows are not "
                       "supported") as te:
        loss(d, {"w": TArg(ids, mask, seg)})
    with pytest.raises(pj.utils.error.Error) as je:
        pj.Topology(jout).loss_fn()(
            {k: jnp.asarray(v) for k, v in w.items()},
            {"w": JArg(jnp.asarray(ids.numpy()), jnp.asarray(mask.numpy()),
                       jnp.asarray(seg.numpy()))})
    assert str(te.value) == str(je.value)


# --- sub-sequence pooling ----------------------------------------------------

# rows: segments 0, 2, 3 (1 empty) then padding; one row of two segments,
# padded; one all-padding row
POOL_SEG = np.array([[0, 0, 2, 2, 2, 3, -1, -1],
                     [0, 1, 1, 1, -1, -1, -1, -1],
                     [-1] * 8], np.int32)
POOL_MASK = (POOL_SEG >= 0).astype(np.float32)
POOLS = {"max": "Max", "average": "Avg", "sum": "Sum",
         "squarerootn": "SquareRootN"}


@pytest.mark.parametrize("how", sorted(POOLS))
def test_to_sequence_pooling_matches_jax(how):
    def build(mod, Layer):
        x = mod.layer.data(name="x",
                           type=mod.data_type.dense_vector_sub_sequence(D))
        f = mod.layer.fc(input=x, size=D, name="f",
                         act=mod.activation.Tanh())
        pt_ = getattr(mod.pooling, POOLS[how])()
        sub = mod.layer.pooling(input=f, pooling_type=pt_, name="sub",
                                agg_level=mod.layer.AggregateLevel
                                .TO_SEQUENCE)
        whole = mod.layer.pooling(input=f, pooling_type=pt_, name="whole")
        return [sub, whole]
    (jl, tl) = _both(build)
    j, t = pj.Topology(jl), pt.Topology(tl)
    assert t.info("sub").is_seq and not t.info("whole").is_seq
    d = _weights(j, 31)
    value = np.random.RandomState(32).randn(3, 8, D).astype(np.float32)
    jfeeds, tfeeds = _args({"x": (value, POOL_MASK, POOL_SEG)})
    jo, to = _forward(j, t, d, jfeeds, tfeeds)
    for name in ("sub", "whole"):
        _assert_args(jo[name], to[name])
    sub = to["sub"]
    assert sub.value.shape == (3, 8, D)
    np.testing.assert_array_equal(sub.mask[:, :5].numpy(),
                                  [[1, 0, 1, 1, 0], [1, 1, 0, 0, 0],
                                   [0, 0, 0, 0, 0]])
    assert (sub.value[0, 1] == 0).all() and (sub.value[2] == 0).all()
    _grads(j, t, d, jfeeds, tfeeds, ["sub", "whole"])


def test_to_sequence_on_a_plain_sequence_pools_the_row():
    """No seg_ids: the row-level branch, as in the JAX package."""
    def build(mod, Layer):
        x = mod.layer.data(name="x",
                           type=mod.data_type.dense_vector_sequence(D))
        return mod.layer.pooling(input=x, pooling_type=mod.pooling.Max(),
                                 agg_level=mod.layer.AggregateLevel
                                 .TO_SEQUENCE, name="p")
    jl, tl = _both(build)
    j, t = pj.Topology(jl), pt.Topology(tl)
    value = np.random.RandomState(2).randn(3, 8, D).astype(np.float32)
    jfeeds, tfeeds = _args({"x": (value, POOL_MASK, None)})
    jo, to = _forward(j, t, {}, jfeeds, tfeeds)
    assert to["p"].value.shape == (3, D)
    _assert_args(jo["p"], to["p"])


# --- the sequence layers ----------------------------------------------------

SEQ_MASK = np.array([[1, 1, 1, 1, 1, 0], [1, 1, 1, 0, 0, 0],
                     [1, 0, 0, 0, 0, 0]], np.float32)
SEQ_SEG = np.array([[0, 0, 1, 2, 2, -1], [0, 1, 1, -1, -1, -1],
                    [0, -1, -1, -1, -1, -1]], np.int32)


def _ints(name, mod):
    return mod.layer.data(name=name, type=mod.data_type.dense_vector(1))


def _seq_cases():
    """name -> (build(mod, Layer, x, xn) -> layer, compare seg_ids)."""
    dv = lambda mod, n, k: mod.layer.data(                 # noqa: E731
        name=n, type=mod.data_type.dense_vector(k))
    return {
        "featmap_expand_col": lambda mod, L, x, xn: L(
            "featmap_expand", [xn], num_filters=3),
        "featmap_expand_row": lambda mod, L, x, xn: L(
            "featmap_expand", [x], num_filters=2, as_col_vector=False),
        "seq_concat": lambda mod, L, x, xn: mod.layer.seq_concat(x, xn),
        "seq_reshape": lambda mod, L, x, xn: mod.layer.seq_reshape(
            x, reshape_size=4),
        "seq_slice": lambda mod, L, x, xn: mod.layer.seq_slice(
            x, starts=_ints("starts", mod), ends=_ints("ends", mod)),
        "seq_slice_starts": lambda mod, L, x, xn: mod.layer.seq_slice(
            x, starts=_ints("starts", mod)),
        "sub_seq": lambda mod, L, x, xn: mod.layer.sub_seq(
            x, _ints("offsets", mod), _ints("sizes", mod)),
        "sub_nested_seq": lambda mod, L, x, xn: mod.layer.sub_nested_seq(
            xn, dv(mod, "sel", 2)),
        "kmax_seq_score": lambda mod, L, x, xn: mod.layer.kmax_seq_score(
            mod.layer.data(name="scores",
                           type=mod.data_type.dense_vector_sequence(1)),
            beam_size=3),
        "eos": lambda mod, L, x, xn: mod.layer.eos(
            mod.layer.data(name="ids",
                           type=mod.data_type.integer_value_sequence(V)),
            eos_id=3),
        "get_output_state": lambda mod, L, x, xn: mod.layer.get_output(
            mod.layer.lstmemory(input=mod.layer.fc(
                input=xn, size=4 * D, act=mod.activation.Linear()),
                name="lstm_g"), arg_name="state"),
        "get_output_value": lambda mod, L, x, xn: mod.layer.get_output(xn),
        "expand_nested": lambda mod, L, x, xn: mod.layer.expand(
            dv(mod, "vec", D), expand_as=xn),
        "last_seq_to_sequence": lambda mod, L, x, xn: mod.layer.last_seq(
            xn, agg_level=mod.layer.AggregateLevel.TO_SEQUENCE),
        "first_seq_to_sequence": lambda mod, L, x, xn: mod.layer.first_seq(
            xn, agg_level=mod.layer.AggregateLevel.TO_SEQUENCE),
    }


def _seq_feeds(seed):
    r = np.random.RandomState(seed)
    x = r.randn(3, 6, D).astype(np.float32)
    scores = np.round(r.randn(3, 6, 1), 1).astype(np.float32)
    scores[0, 1] = scores[0, 3]                       # a tie
    ids = r.randint(0, 5, size=(3, 6)).astype(np.int32)
    ids[0, 2] = 3
    return {
        "x": (x, SEQ_MASK, None), "xn": (x, SEQ_MASK, SEQ_SEG),
        "starts": (np.array([[1], [0], [0]], np.float32), None, None),
        "ends": (np.array([[4], [2], [1]], np.float32), None, None),
        "offsets": (np.array([[2], [1], [0]], np.float32), None, None),
        "sizes": (np.array([[3], [2], [1]], np.float32), None, None),
        "sel": (np.array([[2, 0], [1, -1], [-1, -1]], np.float32), None,
                None),
        "scores": (scores, SEQ_MASK, None), "ids": (ids, SEQ_MASK, None),
        "vec": (r.randn(3, D).astype(np.float32), None, None),
    }


@pytest.mark.parametrize("case", sorted(_seq_cases()))
def test_sequence_layer_matches_jax(case):
    build_case = _seq_cases()[case]

    def build(mod, Layer):
        x = mod.layer.data(name="x",
                           type=mod.data_type.dense_vector_sequence(D))
        xn = mod.layer.data(name="xn",
                            type=mod.data_type.dense_vector_sub_sequence(D))
        return build_case(mod, Layer, x, xn)
    jl, tl = _both(build)
    j, t = pj.Topology(jl), pt.Topology(tl)
    assert t.info(tl) == t.info(tl).replace(**{
        k: getattr(j.info(jl), k) for k in ("size", "is_seq", "is_nested")})
    d = _weights(j, 41)
    needed = {n for n, _ in t.data_type()}
    jfeeds, tfeeds = _args({k: v for k, v in _seq_feeds(42).items()
                            if k in needed})
    jo, to = _forward(j, t, d, jfeeds, tfeeds)
    ja, ta = jo[jl.name], to[tl.name]
    assert ta.value.numpy().dtype == np.asarray(ja.value).dtype
    _assert_args(ja, ta)
    if case == "last_seq_to_sequence":
        # the quirk: one step a row (its last), not one a sub-sequence
        assert t.info(tl).is_seq and ta.value.shape == (3, D)
        np.testing.assert_array_equal(ta.value.numpy(),
                                      _seq_feeds(42)["x"][0][[0, 1, 2],
                                                             [4, 2, 0]])


# --- SubsequenceInput groups ---------------------------------------------------

def test_nested_group_resets_memory_per_subsequence():
    """The accumulator: a running sum that starts again at each
    sub-sequence, in both packages and against numpy."""
    def build(mod, Layer):
        x = mod.layer.data(name="xn",
                           type=mod.data_type.dense_vector_sub_sequence(D))

        def step(x_t):
            m = mod.layer.memory(name="accn", size=D)
            return mod.layer.addto(input=[x_t, m], name="accn",
                                   bias_attr=False)
        return mod.layer.recurrent_group(
            step=step, input=mod.layer.SubsequenceInput(x), name="g")
    jl, tl = _both(build)
    j, t = pj.Topology(jl), pt.Topology(tl)
    assert t.info(tl).is_nested and j.info(jl).is_nested
    value = np.random.RandomState(21).randn(3, 6, D).astype(np.float32)
    jfeeds, tfeeds = _args({"xn": (value, SEQ_MASK, SEQ_SEG)})
    jo, to = _forward(j, t, {}, jfeeds, tfeeds)
    _assert_args(jo["g"], to["g"])
    want = np.zeros_like(value)
    for b in range(3):
        acc = np.zeros(D, np.float32)
        for s in range(6):
            if SEQ_MASK[b, s] == 0:
                continue
            if s == 0 or SEQ_SEG[b, s] != SEQ_SEG[b, s - 1]:
                acc = np.zeros(D, np.float32)
            acc = acc + value[b, s]
            want[b, s] = acc
    np.testing.assert_allclose(to["g"].value.numpy(), want, **TOL)


def _gru_group_model(mod, Layer, boot):
    x = mod.layer.data(name="xn",
                       type=mod.data_type.dense_vector_sub_sequence(3 * H))
    flat = mod.layer.data(name="xf",
                          type=mod.data_type.dense_vector_sequence(3 * H))
    boot_layer = None
    if boot:
        v = mod.layer.data(name="v", type=mod.data_type.dense_vector(D))
        boot_layer = mod.layer.fc(input=v, size=H, name="boot",
                                  act=mod.activation.Tanh())

    def step(x_t):
        m = mod.layer.memory(name="gn", size=H, boot_layer=boot_layer)
        return mod.layer.gru_step(input=x_t, output_mem=m, size=H, name="gn")
    g = mod.layer.recurrent_group(step=step, name="g",
                                  input=mod.layer.SubsequenceInput(x))
    mono = mod.layer.grumemory(input=flat, name="mono")
    return [g, mono]


@pytest.mark.parametrize("boot", [False, True], ids=["zeros", "boot_layer"])
def test_nested_group_gru_matches_per_subsequence_runs(boot):
    """gru_step in a SubsequenceInput group == gated_recurrent run on each
    sub-sequence as a row of its own (from the memory's boot value);
    values and gradients against the JAX group."""
    jl, tl = _both(lambda mod, L: _gru_group_model(mod, L, boot))
    j, t = pj.Topology(jl), pt.Topology(tl)
    d = _weights(j, 51)
    for s in ("w0", "w1", "wbias"):
        d[f"_mono.{s}"] = d[f"_gn.{s}"]
    r = np.random.RandomState(52)
    value = r.randn(3, 6, 3 * H).astype(np.float32)
    vec = r.randn(3, D).astype(np.float32)
    # the sub-sequences laid out one a row, padded to 2 steps
    subs = [(b, s) for b in range(3) for s in sorted(
        set(SEQ_SEG[b][SEQ_SEG[b] >= 0]))]
    flat = np.zeros((len(subs), 2, 3 * H), np.float32)
    fmask = np.zeros((len(subs), 2), np.float32)
    for i, (b, s) in enumerate(subs):
        steps = np.flatnonzero(SEQ_SEG[b] == s)
        flat[i, :len(steps)] = value[b, steps]
        fmask[i, :len(steps)] = 1
    feeds = {"xn": (value, SEQ_MASK, SEQ_SEG), "xf": (flat, fmask, None)}
    if boot:
        feeds["v"] = (vec, None, None)
    jfeeds, tfeeds = _args(feeds)
    jo, to = _forward(j, t, d, jfeeds, tfeeds)
    _assert_args(jo["g"], to["g"])
    if not boot:
        got = to["g"].value.numpy()
        for i, (b, s) in enumerate(subs):
            steps = np.flatnonzero(SEQ_SEG[b] == s)
            np.testing.assert_allclose(
                got[b, steps], to["mono"].value.numpy()[i, :len(steps)],
                **TOL)
    _grads(j, t, d, jfeeds, tfeeds, ["g", "mono"])


def test_nested_group_refusals():
    def build(mod, Layer, x_type, reverse=False):
        x = mod.layer.data(name="x", type=x_type(mod))
        return mod.layer.recurrent_group(
            step=lambda x_t: mod.layer.fc(input=x_t, size=D, name="h"),
            input=mod.layer.SubsequenceInput(x), reverse=reverse)
    seq = lambda mod: mod.data_type.dense_vector_sequence(D)  # noqa: E731
    nested = lambda mod: mod.data_type.dense_vector_sub_sequence(D)  # noqa
    value = np.zeros((1, 2, D), np.float32)
    with torch_name_scope():
        t = pt.Topology(build(pt, TLayer, seq))
    d = {k: torch.from_numpy(v) for k, v in _weights(t, 1).items()}
    with pytest.raises(Error, match="SubsequenceInput needs a nested input"):
        t.forward(d, {"x": TArg(torch.from_numpy(value), torch.ones(1, 2))})
    with torch_name_scope():
        t = pt.Topology(build(pt, TLayer, nested, reverse=True))
    with pytest.raises(Error, match="reverse"):
        t.forward(d, {"x": TArg(torch.from_numpy(value), torch.ones(1, 2),
                                torch.zeros(1, 2, dtype=torch.int32))})


# --- the hierarchical classifier ---------------------------------------------

def test_hierarchical_classifier_logits_match_jax():
    (jw, js, jout, jcost), (tw, ts, tout, tcost) = _both(_classifier)
    d = _weights(pj.Topology(jout), 61)
    tparams = TParameters.from_numpy(d)
    jparams = pj.Parameters.from_dict(d)
    for seed, B in ((62, 5), (63, 1), (64, 9)):
        rows = [(p,) for p in _paragraphs(seed, B)]
        want = pj.infer(output_layer=jout, parameters=jparams, input=rows)
        got = pt.infer(output_layer=tout, parameters=tparams, input=rows,
                       device="cpu")
        assert got.shape == (B, 2)
        np.testing.assert_allclose(got, np.asarray(want), **TOL)
    # the pooled sentences: one step a sentence, the mask their count
    t = pt.Topology([ts])
    feeds = {k: a.to("cpu") for k, a in TFeeder(t.data_type())(rows).items()}
    with torch.no_grad():
        out = t.forward({k: torch.from_numpy(v) for k, v in d.items()
                         if k in t.param_specs()}, feeds)[ts.name]
    assert out.seg_ids is None
    np.testing.assert_array_equal(out.mask.sum(1).numpy(),
                                  [len(p) for p, in rows])


def test_word_lstm_is_the_same_nested_or_flat():
    """Nested-ness changes pooling and groups, never the recurrence: the
    word-level lstmemory over nested rows equals, bit for bit, the same
    rows fed as a plain sequence."""
    def build(mod, Layer, nested):
        kind = (mod.data_type.integer_value_sub_sequence if nested
                else mod.data_type.integer_value_sequence)
        x = mod.layer.data(name="para", type=kind(V))
        emb = mod.layer.embedding(input=x, size=D)
        return mod.networks.simple_lstm(input=emb, size=H)
    with torch_name_scope():
        tn = pt.Topology(build(pt, TLayer, True))
    with torch_name_scope():
        tf = pt.Topology(build(pt, TLayer, False))
    d = {k: torch.from_numpy(v) for k, v in _weights(tn, 71).items()}
    paras = _paragraphs(72, 6)
    nested = {k: a.to("cpu") for k, a in
              TFeeder(tn.data_type())([(p,) for p in paras]).items()}
    flat = {k: a.to("cpu") for k, a in TFeeder(tf.data_type())(
        [([w for s in p for w in s],) for p in paras]).items()}
    with torch.no_grad():
        a = tn.forward(d, nested)[tn.outputs[0].name]
        b = tf.forward(d, flat)[tf.outputs[0].name]
    assert torch.equal(a.value, b.value) and torch.equal(a.mask, b.mask)
    assert a.seg_ids is not None and b.seg_ids is None


def test_nested_config_round_trip():
    (jw, js, jout, jcost), (tw, ts, tout, tcost) = _both(_classifier)
    jcfg = pj.Topology(jout).serialize()
    tcfg = pt.Topology(tout).serialize()
    assert tcfg == jcfg
    para = next(le for le in tcfg["layers"] if le["name"] == "para")
    assert para["cfg"]["input_type"]["seq_type"] == 2
    d = _weights(pj.Topology(jout), 81)
    rows = [(p,) for p in _paragraphs(82, 4)]
    for cfg in (tcfg, jcfg):
        t = torch_from_config(cfg)
        j = jax_from_config(cfg)
        assert t.data_layers[0].attr("input_type").is_nested
        assert j.data_layers[0].attr("input_type").is_nested
        got = pt.infer(output_layer=t.outputs[0],
                       parameters=TParameters.from_numpy(d), input=rows,
                       device="cpu")
        want = pj.infer(output_layer=j.outputs[0],
                        parameters=pj.Parameters.from_dict(d), input=rows)
        np.testing.assert_allclose(got, np.asarray(want), **TOL)
