"""The port's CTC layers, decoder and evaluator against the JAX package's,
and a CTC model trained by both: frames (dense_vector_sequence) -> fc
(linear) -> ``warp_ctc`` against an integer label sequence, with a
``ctc_error`` evaluator on the fc output, built small (7 features, 6
classes) in both packages; the JAX package's initial parameters carried
over as numpy, and ``paddle_tpu_torch.SGD(...).train(device="cpu")``
against ``paddle_tpu.SGD(...).train(pipeline_depth=0)`` on the same
batches.

The JAX side computes the CTC loss with its lax.scan (its CPU path); the
port once with CTC_IMPL="scan" (its time loop under autograd) and once
with "kernel" (the ctc_fb Function on its kernels' plain versions).
Every batch pads to T=8. Tolerances: costs rtol 1e-5; final parameters
rtol 1e-5 / atol 1e-6 with Momentum and atol 1e-5 with Adam
(tests/test_torch_crf_tagger.py's); layer outputs rtol 1e-5; decoded ids
and ``ctc_error`` values equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pj
import paddle_tpu.evaluator as jev
import paddle_tpu.layers.crf_ctc as jc
from paddle_tpu.core.arg import Arg as JArg
from paddle_tpu.core.layer import Layer as JLayer
from paddle_tpu.core.layer import layer_name_scope as jax_name_scope
from paddle_tpu.trainer.feeder import DataFeeder as JFeeder
from paddle_tpu.utils.error import Error as JError

import paddle_tpu_torch as pt
import paddle_tpu_torch.evaluator as tev
import paddle_tpu_torch.layers.crf_ctc as tc
from paddle_tpu_torch.core.arg import Arg as TArg
from paddle_tpu_torch.core.layer import ForwardContext
from paddle_tpu_torch.core.layer import Layer as TLayer
from paddle_tpu_torch.core.layer import layer_name_scope as torch_name_scope
from paddle_tpu_torch.core.parameters import Parameters as TParameters
from paddle_tpu_torch.trainer.feeder import DataFeeder as TFeeder
from paddle_tpu_torch.utils.error import Error

F, C = 7, 6
FEEDING = {"frames": 0, "labels": 1}
VALUE_TOL = dict(rtol=1e-5)

OPTIMIZERS = {
    "momentum": (lambda m: m.optimizer.Momentum(momentum=0.9,
                                                learning_rate=0.05),
                 dict(rtol=1e-5, atol=1e-6)),
    "adam": (lambda m: m.optimizer.Adam(learning_rate=5e-3),
             dict(rtol=0, atol=1e-5)),
}


def _build(pkg, kind="warp_ctc", blank=0, **attrs):
    """frames -> fc (linear) -> the CTC cost; ``attrs`` (norm_by_times,
    coeff) go on the cost layer as it is built by the core Layer."""
    frames = pkg.layer.data(name="frames",
                            type=pkg.data_type.dense_vector_sequence(F))
    labels = pkg.layer.data(name="labels",
                            type=pkg.data_type.integer_value_sequence(C))
    out = pkg.layer.fc(input=frames, size=C, act=pkg.activation.Linear())
    if attrs:
        layer_cls = JLayer if pkg is pj else TLayer
        cost = layer_cls(kind, [out, labels], name="cost", size=C,
                         blank=blank, **attrs)
    else:
        cost = getattr(pkg.layer, kind)(input=out, label=labels, size=C,
                                        blank=blank, name="cost")
    return out, cost


def _models(**kw):
    with jax_name_scope():
        j = _build(pj, **kw)
    with torch_name_scope():
        t = _build(pt, **kw)
    return j, t


def _init(jcost, seed=3):
    topo = pj.Topology(jcost)
    return {k: np.array(v) for k, v in
            topo.init_params(jax.random.PRNGKey(seed)).items()}


def _batches(n=3, B=5, blank=0, seed=5):
    """n batches of B (frames [len, F] numpy, labels) rows: frames 5..8
    long with one of 8 a batch (T pads to 8), labels 1..2 long, never the
    blank; every batch has one label with a repeated id."""
    r = np.random.RandomState(seed)
    ids = np.asarray([c for c in range(C) if c != blank])
    out = []
    for _ in range(n):
        lens = r.randint(5, 9, size=B)
        lens[0] = 8
        rows = []
        for i, k in enumerate(lens):
            lab = ids[r.randint(0, C - 1, size=r.randint(1, 3))].tolist()
            if i == 1:
                lab = [lab[0], lab[0]]
            rows.append((r.randn(k, F).astype(np.float32), lab))
        out.append(rows)
    return out


def _forward_both(j, t, init, batch):
    jtopo, ttopo = pj.Topology(j[1]), pt.Topology(t[1])
    jout = jtopo.forward({k: jnp.asarray(v) for k, v in init.items()},
                         JFeeder(jtopo.data_type(), FEEDING)(batch))
    tout = ttopo.forward({k: torch.from_numpy(v) for k, v in init.items()},
                         {k: a.to("cpu") for k, a in
                          TFeeder(ttopo.data_type(), FEEDING)(batch).items()})
    return jout, tout


def test_parameter_names_match_jax():
    j, t = _models()
    jspecs = pj.Topology(j[1]).param_specs()
    tspecs = pt.Topology(t[1]).param_specs()
    assert sorted(jspecs) == sorted(tspecs) and len(tspecs) == 2
    for k in jspecs:
        assert tuple(jspecs[k].shape) == tuple(tspecs[k].shape), k


@pytest.mark.parametrize("impl", ["scan", "kernel"])
@pytest.mark.parametrize("kind,blank", [("ctc", 0), ("warp_ctc", 0),
                                        ("ctc", C - 1), ("warp_ctc", C - 1)])
def test_layers_match_jax(kind, blank, impl, monkeypatch):
    monkeypatch.setattr(tc, "CTC_IMPL", impl)
    j, t = _models(kind=kind, blank=blank)
    init = _init(j[1])
    batch = _batches(n=1, blank=blank)[0]
    jout, tout = _forward_both(j, t, init, batch)
    want = np.asarray(jout["cost"].value)
    assert want.shape == (5, 1) and np.isfinite(want).all()
    np.testing.assert_allclose(tout["cost"].value.detach().numpy(), want,
                               **VALUE_TOL)


@pytest.mark.parametrize("attrs", [dict(norm_by_times=True),
                                   dict(coeff=2.5),
                                   dict(norm_by_times=True, coeff=0.5)])
def test_norm_by_times_and_coeff_match_jax(attrs):
    j, t = _models(kind="ctc", **attrs)
    init = _init(j[1])
    batch = _batches(n=1, seed=8)[0]
    jout, tout = _forward_both(j, t, init, batch)
    np.testing.assert_allclose(tout["cost"].value.detach().numpy(),
                               np.asarray(jout["cost"].value), **VALUE_TOL)


def test_packed_rows_are_refused():
    """As tests/test_packing.py:748 checks the JAX layers: a packed feed
    makes both CTC layers raise rather than align the concatenation of
    several sequences as one. The port's layers are driven with a packed
    context directly, then a real packed feed goes through ``loss_fn``
    into the same refusal, with the JAX layer's message; ctc_error refuses
    packed rows in both packages."""
    for kind in ("ctc", "warp_ctc"):
        with jax_name_scope():
            _, jcost = _build(pj, kind=kind)
        jtopo = pj.Topology(jcost)
        feeds = JFeeder(jtopo.data_type(), FEEDING, pack_sequences=True)(
            _batches(n=1)[0][:2])
        with pytest.raises(JError, match="packed"):
            jtopo.forward(jtopo.init_params(jax.random.PRNGKey(0)), feeds)

        with torch_name_scope():
            _, tcost = _build(pt, kind=kind)
        ctx = ForwardContext()
        ctx.packed = True
        ins = [TArg(torch.zeros(1, 4, C), torch.ones(1, 4)),
               TArg(torch.ones(1, 2, dtype=torch.int32), torch.ones(1, 2))]
        with pytest.raises(Error, match="packed sequence rows"):
            tcost.forward({}, ins, ctx)
        ttopo = pt.Topology(tcost)
        packed = {k: a.to("cpu") for k, a in
                  TFeeder(ttopo.data_type(), FEEDING, pack_sequences=True)(
                      _batches(n=1)[0][:2]).items()}
        with pytest.raises(Error, match="packed sequence rows") as te:
            ttopo.loss_fn()(ttopo.init_params(), packed)
        with pytest.raises(JError) as je:
            jtopo.loss_fn()(jtopo.init_params(jax.random.PRNGKey(0)), feeds)
        assert str(te.value) == str(je.value)

    for ev_mod, arg, conv, err in ((jev, JArg, jnp.asarray, JError),
                                   (tev, TArg, torch.from_numpy, Error)):
        ev = ev_mod.ctc_error(input="out", label="lab")
        ev.packed_feed = True
        outs = {"out": arg(conv(np.zeros((1, 4, 3), np.float32)),
                           conv(np.ones((1, 4), np.float32)),
                           conv(np.zeros((1, 4), np.int32))),
                "lab": arg(conv(np.ones((1, 2), np.int32)),
                           conv(np.ones((1, 2), np.float32)))}
        with pytest.raises(err, match="packed"):
            ev.compute(outs)


def _decode_case(seed):
    """Logits with exact ties and runs: small integers, so argmax ties
    are real and the first maximum must win in both packages."""
    r = np.random.RandomState(seed)
    logits = r.randint(0, 3, (4, 9, 5)).astype(np.float32)
    mask = np.ones((4, 9), np.float32)
    mask[1, 6:] = 0
    mask[3, 2:] = 0
    return logits, mask


@pytest.mark.parametrize("blank", [0, 4])
@pytest.mark.parametrize("seed", [0, 1])
def test_greedy_decode_matches_jax(seed, blank):
    logits, mask = _decode_case(seed)
    j_ids, j_mask = jc.ctc_greedy_decode(jnp.asarray(logits),
                                         jnp.asarray(mask), blank)
    ids, out_mask = tc.ctc_greedy_decode(torch.from_numpy(logits),
                                         torch.from_numpy(mask), blank)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(j_ids))
    np.testing.assert_array_equal(out_mask.numpy(), np.asarray(j_mask))


def test_greedy_decode_collapses_repeats_and_drops_blanks():
    """The twin of tests/test_crf_ctc.py's test_ctc_greedy_decode:
    frames argmax [1,1,0,2,2] -> [1,2]."""
    logits = np.full((1, 5, 3), -5.0, np.float32)
    for t, c in enumerate([1, 1, 0, 2, 2]):
        logits[0, t, c] = 5.0
    ids, mask = tc.ctc_greedy_decode(torch.from_numpy(logits),
                                     torch.ones(1, 5))
    assert ids[0, :2].tolist() == [1, 2] and (ids[0, 2:] == -1).all()
    assert mask[0].tolist() == [1, 1, 0, 0, 0]


def test_ctc_error_evaluator_twin():
    """The twin of tests/test_detection_evaluators.py:100 in both
    packages: argmax [1,1,0,2] decodes to [1,2]; against the label [1,2]
    the error is 0, against [1,1] it is 1/2."""
    logits = np.full((1, 4, 3), -5.0, np.float32)
    for t, c in enumerate([1, 1, 0, 2]):
        logits[0, t, c] = 5.0
    for ev_mod, arg, conv in ((jev, JArg, jnp.asarray),
                              (tev, TArg, torch.from_numpy)):
        ev = ev_mod.ctc_error(input="out", label="lab")
        outs = {"out": arg(conv(logits), conv(np.ones((1, 4), np.float32))),
                "lab": arg(conv(np.asarray([[1, 2]], np.int32)),
                           conv(np.ones((1, 2), np.float32)))}
        ev.reset()
        ev.accumulate(ev.compute(outs))
        assert ev.value() == pytest.approx(0.0)
        ev.reset()
        outs["lab"] = arg(conv(np.asarray([[1, 1]], np.int32)),
                          conv(np.ones((1, 2), np.float32)))
        ev.accumulate(ev.compute(outs))
        assert ev.value() == pytest.approx(0.5)


def test_ctc_error_matches_jax_on_a_ragged_batch():
    """Both packages' ctc_error over two batches of tied, ragged logits
    against ragged labels: the same accumulated counts."""
    jerr, terr = jev.ctc_error("out", "lab"), tev.ctc_error("out", "lab")
    r = np.random.RandomState(3)
    for seed in (0, 1):
        logits, mask = _decode_case(seed)
        lab = r.randint(1, 5, (4, 3)).astype(np.int32)
        lmask = (np.arange(3)[None] < np.asarray([[3], [1], [2], [3]])
                 ).astype(np.float32)
        jerr.accumulate(jerr.compute({
            "out": JArg(jnp.asarray(logits), jnp.asarray(mask)),
            "lab": JArg(jnp.asarray(lab), jnp.asarray(lmask))}))
        terr.accumulate(terr.compute({
            "out": TArg(torch.from_numpy(logits), torch.from_numpy(mask)),
            "lab": TArg(torch.from_numpy(lab), torch.from_numpy(lmask))}))
    assert terr._acc == jerr._acc and terr._acc["dist"] > 0
    assert terr.value() == jerr.value()


def test_edit_distance_matches_jax():
    r = np.random.RandomState(0)
    for _ in range(300):
        a = r.randint(0, 4, r.randint(0, 12)).tolist()
        b = r.randint(0, 4, r.randint(0, 12)).tolist()
        assert tev._edit_distance(a, b) == jev._edit_distance(a, b), (a, b)


def _record(events):
    def handler(ev):
        events.append(ev)
    return handler


@pytest.mark.parametrize("opt", sorted(OPTIMIZERS))
def test_train_trajectory_matches_jax(opt, monkeypatch):
    """Two passes over three batches: each step's cost and ctc_error, and
    the final parameters, of the port (CTC_IMPL "scan" and "kernel")
    against the JAX SGD.train."""
    make_opt, param_tol = OPTIMIZERS[opt]
    j, t = _models()
    init = _init(j[1])
    batches = _batches()
    reader = lambda: iter(batches)                      # noqa: E731
    kw = dict(num_passes=2, feeding=FEEDING)

    jevents = []
    jtr = pj.SGD(j[1], pj.Parameters.from_dict(init), make_opt(pj),
                 evaluators={"cer": jev.ctc_error(input=j[0],
                                                  label="labels")})
    jtr.train(reader, event_handler=_record(jevents), pipeline_depth=0, **kw)
    jsteps = [(e.cost, e.metrics["cer"]) for e in jevents
              if isinstance(e, pj.event.EndIteration)]
    jfinal = jtr.parameters.as_dict()
    for impl in ("scan", "kernel"):
        monkeypatch.setattr(tc, "CTC_IMPL", impl)
        tevents = []
        ttr = pt.SGD(t[1], TParameters.from_numpy(init), make_opt(pt),
                     evaluators={"cer": tev.ctc_error(input=t[0],
                                                      label="labels")},
                     device="cpu")
        ttr.train(reader, event_handler=_record(tevents), **kw)
        tsteps = [(e.cost, e.metrics["cer"]) for e in tevents
                  if isinstance(e, pt.event.EndIteration)]
        assert len(tsteps) == len(jsteps) == 2 * len(batches)
        np.testing.assert_allclose([c for c, _ in tsteps],
                                   [c for c, _ in jsteps], rtol=1e-5,
                                   err_msg=impl)
        assert [m for _, m in tsteps] == [m for _, m in jsteps], impl
        # the second pass over the same batches costs less
        costs = [c for c, _ in tsteps]
        assert sum(costs[len(batches):]) < sum(costs[:len(batches)])
        tfinal = ttr.parameters.as_dict()
        assert sorted(tfinal) == sorted(jfinal) == sorted(init)
        for k in jfinal:
            np.testing.assert_allclose(tfinal[k].numpy(),
                                       np.asarray(jfinal[k]),
                                       err_msg=f"{impl} {k}", **param_tol)
            assert not np.array_equal(tfinal[k].numpy(), init[k]), \
                f"{k} never moved"
