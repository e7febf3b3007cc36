"""The port's CRF sequence taggers against the JAX package: the two
v1_api_demo/sequence_tagging models (models.text.linear_crf_tagger and
rnn_crf_tagger) built small in both packages, the JAX package's initial
parameters carried over as numpy, and ``paddle_tpu_torch.SGD(...).train(
device="cpu")`` against ``paddle_tpu.SGD(...).train(pipeline_depth=0)`` on
the same batches; Viterbi serving through ``infer``; the context
projection; the chunk evaluator.

The JAX side computes the partition function with its lax.scan (its CPU
path); the port once with CRF_IMPL="scan" (its time loop under autograd)
and once with "kernel" (the crf_logz Function on its kernels' plain
versions). Every batch pads to T=8. Tolerances: costs rtol 1e-5; final
parameters rtol 1e-5 / atol 1e-6 with Momentum and atol 1e-5 with Adam
(tests/test_torch_nmt_train.py's); tags equal.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pj
import paddle_tpu.evaluator as jev
import paddle_tpu.layers.basic as jbasic
from paddle_tpu.core.arg import Arg as JArg
from paddle_tpu.core.topology import topology_from_config as jax_from_config
from paddle_tpu.core.layer import layer_name_scope as jax_name_scope
from paddle_tpu.models import text as jtext

import paddle_tpu_torch as pt
import paddle_tpu_torch.evaluator as tev
import paddle_tpu_torch.layers.basic as tbasic
import paddle_tpu_torch.layers.crf_ctc as tc
from paddle_tpu_torch.core.arg import Arg as TArg
from paddle_tpu_torch.core.layer import layer_name_scope as torch_name_scope
from paddle_tpu_torch.core.parameters import Parameters as TParameters
from paddle_tpu_torch.models import text as ttext
from paddle_tpu_torch.trainer.feeder import DataFeeder as TFeeder
from paddle_tpu_torch.utils.error import Error

V = 60
WIDTHS = {"linear_crf_tagger": dict(word_dim=V, label_dim=7, emb_dim=16),
          "rnn_crf_tagger": dict(word_dim=V, label_dim=5, emb_dim=16,
                                 hidden=16)}
FEEDING = {"words": 0, "labels": 1}

OPTIMIZERS = {
    "momentum": (lambda m: m.optimizer.Momentum(momentum=0.9,
                                                learning_rate=0.05),
                 dict(rtol=1e-5, atol=1e-6)),
    "adam": (lambda m: m.optimizer.Adam(learning_rate=5e-3),
             dict(rtol=0, atol=1e-5)),
}


def _models(kind):
    with jax_name_scope():
        j = getattr(jtext, kind)(**WIDTHS[kind])
    with torch_name_scope():
        t = getattr(ttext, kind)(**WIDTHS[kind])
    return j, t


def _outputs(model):
    """The cost and, for the linear tagger, the decoder sharing its w0."""
    return [model[3]] + list(model[4:])


def _init(jmodel, seed=3):
    topo = pj.Topology(_outputs(jmodel))
    return {k: np.array(v) for k, v in
            topo.init_params(jax.random.PRNGKey(seed)).items()}


def _batches(L, n=3, B=6, seed=5):
    """n batches of B (words, labels) rows, 3..8 long with one of 8 a
    batch (T pads to 8)."""
    r = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        lens = r.randint(3, 9, size=B)
        lens[0] = 8
        out.append([(r.randint(0, V, size=k).tolist(),
                     r.randint(0, L, size=k).tolist()) for k in lens])
    return out


@pytest.mark.parametrize("kind", sorted(WIDTHS))
def test_parameter_names_match_jax(kind):
    j, t = _models(kind)
    jspecs = pj.Topology(_outputs(j)).param_specs()
    tspecs = pt.Topology(_outputs(t)).param_specs()
    assert sorted(jspecs) == sorted(tspecs)
    assert "_crf_cost.w0" in tspecs
    for k in jspecs:
        assert tuple(jspecs[k].shape) == tuple(tspecs[k].shape), k
    if kind == "linear_crf_tagger":
        # the decoder shares the cost's transition weights
        topo = pt.Topology(_outputs(t))
        assert topo._layer_params["crf_decode"]["w0"] == "_crf_cost.w0"


@pytest.mark.parametrize("impl", ["scan", "kernel"])
@pytest.mark.parametrize("kind", sorted(WIDTHS))
def test_forward_cost_matches_jax(kind, impl, monkeypatch):
    monkeypatch.setattr(tc, "CRF_IMPL", impl)
    j, t = _models(kind)
    init = _init(j)
    batch = _batches(WIDTHS[kind]["label_dim"], n=1)[0]
    jtopo, ttopo = pj.Topology(_outputs(j)), pt.Topology(_outputs(t))
    jfeeds = pj.trainer.feeder.DataFeeder(jtopo.data_type(), FEEDING)(batch)
    tfeeds = TFeeder(ttopo.data_type(), FEEDING)(batch)
    jout = jtopo.forward({k: jnp.asarray(v) for k, v in init.items()},
                         jfeeds)
    tout = ttopo.forward({k: torch.from_numpy(v) for k, v in init.items()},
                         {k: a.to("cpu") for k, a in tfeeds.items()})
    name = j[3].name
    np.testing.assert_allclose(tout[name].value.numpy(),
                               np.asarray(jout[name].value), rtol=1e-5)


def test_crf_weight_input_is_ignored_in_both_packages():
    """A reference-side divergence the port copies (ROADMAP.md §3): the
    JAX ``crf`` layer takes a ``weight`` input (layer.crf(weight=...)
    appends it as a third input) and never reads it, so a per-sequence
    weight leaves the cost as it is. Pinned in both packages, so that the
    port is not "fixed" alone."""
    L = 5
    r = np.random.RandomState(2)
    T, B = 6, 3
    emit = r.randn(B, T, L).astype(np.float32)
    labels = r.randint(0, L, (B, T)).astype(np.int32)
    mask = (np.arange(T)[None] < np.asarray([[6], [4], [2]])).astype(
        np.float32)
    weight = np.asarray([[0.5], [2.0], [0.0]], np.float32)
    w0 = (r.randn(L + 2, L) * 0.5).astype(np.float32)
    costs = {}
    for name, pkg, arg, conv in (("jax", pj, JArg, jnp.asarray),
                                 ("torch", pt, TArg, torch.from_numpy)):
        feat = pkg.layer.data(name="feat",
                              type=pkg.data_type.dense_vector_sequence(L))
        tags = pkg.layer.data(name="tags",
                              type=pkg.data_type.integer_value_sequence(L))
        wt = pkg.layer.data(name="wt", type=pkg.data_type.dense_vector(1))
        plain = pkg.layer.crf(input=feat, label=tags, size=L, name="plain",
                              param_attr=pkg.attr.ParamAttr(name="w"))
        weighted = pkg.layer.crf(input=feat, label=tags, size=L, weight=wt,
                                 name="weighted",
                                 param_attr=pkg.attr.ParamAttr(name="w"))
        assert len(weighted.inputs) == 3
        topo = pkg.Topology([plain, weighted])
        outs = topo.forward({"w": conv(w0)}, {
            "feat": arg(conv(emit), conv(mask)),
            "tags": arg(conv(labels), conv(mask)),
            "wt": arg(conv(weight))})
        costs[name] = [np.asarray(outs[n].value) for n in ("plain",
                                                            "weighted")]
        np.testing.assert_array_equal(costs[name][1], costs[name][0])
    np.testing.assert_allclose(costs["torch"][0], costs["jax"][0], rtol=1e-5)


def _record(events):
    def handler(ev):
        events.append(ev)
    return handler


@pytest.mark.parametrize("opt", sorted(OPTIMIZERS))
@pytest.mark.parametrize("kind", sorted(WIDTHS))
def test_train_trajectory_matches_jax(kind, opt, monkeypatch):
    make_opt, param_tol = OPTIMIZERS[opt]
    j, t = _models(kind)
    init = _init(j)
    batches = _batches(WIDTHS[kind]["label_dim"])
    reader = lambda: iter(batches)                      # noqa: E731
    kw = dict(num_passes=2, feeding=FEEDING)

    jevents = []
    jtr = pj.SGD(j[3], pj.Parameters.from_dict(init), make_opt(pj),
                 extra_layers=_outputs(j)[1:])
    jtr.train(reader, event_handler=_record(jevents), pipeline_depth=0, **kw)
    jcosts = [e.cost for e in jevents if isinstance(e, pj.event.EndIteration)]
    jfinal = jtr.parameters.as_dict()
    for impl in ("scan", "kernel"):
        monkeypatch.setattr(tc, "CRF_IMPL", impl)
        tevents = []
        ttr = pt.SGD(t[3], TParameters.from_numpy(init), make_opt(pt),
                     extra_layers=_outputs(t)[1:], device="cpu")
        ttr.train(reader, event_handler=_record(tevents), **kw)
        tcosts = [e.cost for e in tevents
                  if isinstance(e, pt.event.EndIteration)]
        assert len(tcosts) == len(jcosts) == 2 * len(batches)
        np.testing.assert_allclose(tcosts, jcosts, rtol=1e-5, err_msg=impl)
        # the second pass over the same batches costs less
        assert sum(tcosts[len(batches):]) < sum(tcosts[:len(batches)])
        tfinal = ttr.parameters.as_dict()
        assert sorted(tfinal) == sorted(jfinal) == sorted(init)
        for k in jfinal:
            np.testing.assert_allclose(tfinal[k].numpy(),
                                       np.asarray(jfinal[k]),
                                       err_msg=f"{impl} {k}", **param_tol)
            assert not np.array_equal(tfinal[k].numpy(), init[k]), \
                f"{k} never moved"


def _decoding(seed=4):
    """Both packages' linear tagger, the same parameters (with the
    transitions drawn wider, so Viterbi paths vary), and a ragged batch."""
    j, t = _models("linear_crf_tagger")
    init = _init(j, seed)
    init["_crf_cost.w0"] = init["_crf_cost.w0"] * 4.0
    rows = [(words,) for words, _ in _batches(7, n=1, seed=seed)[0]]
    return j, t, init, rows


def test_infer_crf_decoding_matches_jax():
    j, t, init, rows = _decoding()
    jtags = pj.infer(j[4], pj.Parameters.from_dict(init), rows)
    ttags = pt.infer(t[4], TParameters.from_numpy(init), rows, device="cpu")
    assert ttags.dtype == np.int32 and ttags.shape == (len(rows), 8)
    np.testing.assert_array_equal(ttags, np.asarray(jtags))
    assert len(np.unique(ttags)) > 2
    # the Viterbi scores, from the decoder's ctx.extras
    ttopo, jtopo = pt.Topology(t[4]), pj.Topology(j[4])
    tfeeds = {k: a.to("cpu") for k, a in
              TFeeder(ttopo.data_type())(rows).items()}
    _, ctx = ttopo.forward({k: torch.from_numpy(v) for k, v in init.items()},
                           tfeeds, return_ctx=True)
    jfeeds = pj.trainer.feeder.DataFeeder(jtopo.data_type())(rows)
    _, jctx = jtopo.forward({k: jnp.asarray(v) for k, v in init.items()},
                            jfeeds, return_ctx=True)
    np.testing.assert_allclose(ctx.extras["crf_decode:score"].numpy(),
                               np.asarray(jctx.extras["crf_decode:score"]),
                               rtol=1e-5)


def test_chunk_evaluator_on_decoded_tags_matches_jax():
    """The chunk evaluator (IOB over 3 chunk types and "other") of each
    package on its own package's decode of the same batch."""
    j, t, init, rows = _decoding(seed=6)
    labels = [labs for _, labs in _batches(7, n=1, seed=6)[0]]
    batch = [(w, lab) for (w,), lab in zip(rows, labels)]
    jtopo, ttopo = pj.Topology(_outputs(j)), pt.Topology(_outputs(t))
    jouts = jtopo.forward({k: jnp.asarray(v) for k, v in init.items()},
                          pj.trainer.feeder.DataFeeder(
                              jtopo.data_type(), FEEDING)(batch))
    touts = ttopo.forward({k: torch.from_numpy(v) for k, v in init.items()},
                          {k: a.to("cpu") for k, a in TFeeder(
                              ttopo.data_type(), FEEDING)(batch).items()})
    jchunk = jev.chunk("crf_decode", "labels", "IOB", num_chunk_types=3)
    tchunk = tev.chunk("crf_decode", "labels", "IOB", num_chunk_types=3)
    jchunk.accumulate(jchunk.compute(jouts))
    tchunk.accumulate(tchunk.compute(touts))
    assert tchunk._acc == jchunk._acc and tchunk._acc["ng"] > 0
    assert tchunk.stats() == jchunk.stats()


@pytest.mark.parametrize("scheme,types,excluded", [
    ("IOB", 2, None), ("IOE", 2, None), ("IOBES", 2, None),
    ("plain", 3, None), ("IOB", 3, [1])])
def test_chunk_schemes_match_jax(scheme, types, excluded):
    n_tags = {"IOB": 2, "IOE": 2, "IOBES": 4, "plain": 1}[scheme]
    r = np.random.RandomState(len(scheme) + types)
    B, T = 6, 12
    ids = r.randint(0, n_tags * (types + 1), size=(2, B, T))
    lens = r.randint(1, T + 1, size=B)
    mask = (np.arange(T)[None] < lens[:, None]).astype(np.float32)
    kw = dict(chunk_scheme=scheme, num_chunk_types=types,
              excluded_chunk_types=excluded)
    jchunk, tchunk = jev.chunk("p", "l", **kw), tev.chunk("p", "l", **kw)
    for _ in range(2):     # accumulates across batches
        jchunk.accumulate({"pred": ids[0], "lab": ids[1], "mask": mask})
        tchunk.accumulate({"pred": torch.from_numpy(ids[0]),
                           "lab": torch.from_numpy(ids[1]),
                           "mask": torch.from_numpy(mask)})
    assert tchunk._acc == jchunk._acc
    assert tchunk.value() == jchunk.value()
    with pytest.raises(Error, match="Unknown chunk scheme"):
        tev.chunk("p", "l", chunk_scheme="BIO")


@pytest.mark.parametrize("start,length", [(-2, 5), (0, 3), (-3, 2)])
def test_context_projection_matches_jax_on_a_ragged_batch(start, length):
    """The JAX package zeroes a shifted copy only past the edge of the
    padded array, not at each row's own length; the port copies that."""
    r = np.random.RandomState(length)
    B, T, D = 3, 8, 4
    v = r.randn(B, T, D).astype(np.float32)
    mask = (np.arange(T)[None] < np.array([[8], [5], [2]])).astype(np.float32)
    want = np.asarray(jbasic._apply_context_projection(
        jnp.asarray(v), jnp.asarray(mask), start, length))
    got = tbasic._apply_context_projection(torch.from_numpy(v),
                                           torch.from_numpy(mask), start,
                                           length)
    np.testing.assert_array_equal(got.numpy(), want)
    if start + length - 1 > 0:
        # row 1 (5 steps long): its last step sees padding row 5
        o = start + length - 1
        np.testing.assert_array_equal(got[1, 4, (length - 1) * D:].numpy(),
                                      v[1, 4 + o])


def test_mixed_layer_round_trips_through_serialize():
    """A mixed layer with a context projection: serialize -> JSON ->
    either package's topology_from_config gives the same forward."""
    def build(pkg):
        w = pkg.layer.data(name="w",
                           type=pkg.data_type.integer_value_sequence(20))
        emb = pkg.layer.embedding(input=w, size=4)
        return pkg.layer.mixed(size=12, name="ctx",
                               input=[pkg.layer.context_projection(emb, 3)])

    with torch_name_scope():
        tout = build(pt)
    with jax_name_scope():
        jout = build(pj)
    conf = json.loads(json.dumps(pt.Topology(tout).serialize()))
    assert conf == json.loads(json.dumps(pj.Topology(jout).serialize()))
    ids = np.random.RandomState(0).randint(0, 20, (2, 6)).astype(np.int32)
    mask = np.ones((2, 6), np.float32)
    mask[1, 4:] = 0
    table = np.random.RandomState(1).randn(20, 4).astype(np.float32)
    params = {"___embedding_0__.w0": table}
    got = pt.topology_from_config(conf).forward(
        {k: torch.from_numpy(v) for k, v in params.items()},
        {"w": (torch.from_numpy(ids), torch.from_numpy(mask))})["ctx"]
    want = jax_from_config(conf).forward(
        {k: jnp.asarray(v) for k, v in params.items()},
        {"w": JArg(jnp.asarray(ids), jnp.asarray(mask))})["ctx"]
    assert got.value.shape == (2, 6, 12)
    np.testing.assert_allclose(got.value.numpy(), np.asarray(want.value),
                               rtol=1e-6)


def test_mixed_refuses_projections_not_ported():
    w = pt.layer.data(name="w", type=pt.data_type.integer_value_sequence(5))
    emb = pt.layer.embedding(input=w, size=4)
    bad = pt.layer.mixed(size=4, input=[{"kind": "full_matrix",
                                         "input": emb, "size": 4}])
    with pytest.raises(Error, match="'full_matrix' projection is not "
                                    "ported yet"):
        pt.Topology(bad)
    with pytest.raises(Error, match="context-manager form"):
        pt.layer.mixed(size=4)


def test_sequence_tagging_crf_trains_end_to_end():
    """Port twin of tests/test_crf_ctc.py's: the linear CRF tagger trains
    through SGD.train on ragged batches and its cost falls."""
    from paddle_tpu_torch import optimizer

    L = 5
    word, lab, feat, crf, decode = ttext.linear_crf_tagger(
        word_dim=V, label_dim=L, emb_dim=16)
    params = pt.parameters_create(pt.Topology([crf, decode]))
    trainer = pt.SGD(cost=crf, parameters=params,
                     update_equation=optimizer.Adam(learning_rate=5e-2),
                     extra_layers=[decode], device="cpu")

    def reader():
        r = np.random.RandomState(0)
        for _ in range(128):
            n = int(r.randint(3, 9))
            words = r.randint(0, V, size=n)
            yield list(words), list(words % L)   # a deterministic tag a word

    costs = []

    def handler(ev):
        if isinstance(ev, pt.event.EndIteration):
            costs.append(ev.cost)

    trainer.train(pt.batch(reader, 16), num_passes=6, event_handler=handler)
    assert np.mean(costs[-4:]) < 0.5 * np.mean(costs[:4]), (
        costs[:4], costs[-4:])


def test_sequence_tagging_acceptance_chunk_f1():
    """Port twin of tests/test_chunk_evaluator.py's sequence_tagging
    acceptance: crf + crf_decoding sharing 'crfw', chunk evaluator (IOB),
    trained on a learnable synthetic IOB stream; chunk F1 above 0.9."""
    from paddle_tpu_torch import data_type, layer, optimizer
    from paddle_tpu_torch.attr import ParamAttr

    num_types, num_labels = 2, 5            # B-0 I-0 B-1 I-1 O
    r = np.random.RandomState(0)

    def sample():
        T = r.randint(4, 9)
        tags = []
        while len(tags) < T:
            ty = r.randint(0, num_types + 1)
            if ty == num_types:
                tags.append(2 * num_types)
            else:
                n = min(r.randint(1, 3), T - len(tags))
                tags += [ty * 2] + [ty * 2 + 1] * (n - 1)
        feats = np.eye(num_labels, dtype=np.float32)[tags]
        noise = r.randn(len(tags), num_labels).astype(np.float32) * 0.1
        return feats + noise, np.array(tags, np.int32)

    feats = layer.data(name="features",
                       type=data_type.dense_vector_sequence(num_labels))
    lab = layer.data(name="chunk",
                     type=data_type.integer_value_sequence(num_labels))
    crf_in = layer.fc(input=feats, size=num_labels, bias_attr=False,
                      act=pt.activation.Linear(),
                      param_attr=ParamAttr(initial_std=0.1))
    crf = layer.crf(input=crf_in, label=lab, size=num_labels,
                    param_attr=ParamAttr(name="crfw", initial_std=0))
    decode = layer.crf_decoding(input=crf_in, size=num_labels, name="dec",
                                param_attr=ParamAttr(name="crfw"))
    params = pt.parameters.create(crf, decode)
    ev = tev.chunk(input="dec", label="chunk", chunk_scheme="IOB",
                   num_chunk_types=num_types)
    trainer = pt.SGD(cost=crf, parameters=params,
                     update_equation=optimizer.Adam(learning_rate=0.05),
                     extra_layers=[decode], evaluators={"chunk_f1": ev},
                     device="cpu")
    data = [sample() for _ in range(48)]
    feeding = {"features": 0, "chunk": 1}

    def reader():
        yield from data

    f1 = []

    def handler(event):
        if isinstance(event, pt.event.EndPass):
            res = trainer.test(reader=pt.batch(reader, 16), feeding=feeding)
            f1.append(res.metrics["chunk_f1"])

    trainer.train(reader=pt.batch(reader, 16), num_passes=6,
                  feeding=feeding, event_handler=handler)
    assert f1[-1] > 0.9, f1
