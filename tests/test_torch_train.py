"""The port's training slice against the JAX package: the LSTM text
classifier trained by ``paddle_tpu_torch.SGD(...).train(device="cpu")``
and by ``paddle_tpu.SGD(...).train(pipeline_depth=0)`` from the same
parameters on the same batches; the optimizers' rules one by one; the
readers, the synthetic dataset, the initializer and dropout.

The JAX side trains through its lax.scan LSTM (the CPU path of its
layer), the port through the fused_lstm Function's plain forward and
backward. Tolerances: costs and final parameters rtol 1e-5 / atol 1e-6
with Momentum (linear in the gradient); with Adam, costs rtol 1e-5 and
parameters atol 1e-5 (g / sqrt(v) can turn float32 rounding of a tiny
gradient into a full-size step). Measured on these inputs: parameters
within 3e-8 (Momentum) and 1.2e-7 (Adam), costs within 1e-7 relative.
Evaluator values are counts of argmax mismatches: equal.
"""

import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pj
from paddle_tpu.core.layer import layer_name_scope as jax_name_scope
from paddle_tpu.models.text import lstm_text_classification as jax_lstm_cls

import paddle_tpu_torch as pt
from paddle_tpu_torch.core.layer import layer_name_scope as torch_name_scope
from paddle_tpu_torch.core.parameters import Parameters as TParameters
from paddle_tpu_torch.models.text import \
    lstm_text_classification as torch_lstm_cls
from paddle_tpu_torch.utils.error import Error

DICT, EMB, HID, LAYERS = 50, 16, 8, 2


def _models():
    with jax_name_scope():
        jm = jax_lstm_cls(dict_dim=DICT, emb_dim=EMB, hidden=HID,
                          num_layers=LAYERS)
    with torch_name_scope():
        tm = torch_lstm_cls(dict_dim=DICT, emb_dim=EMB, hidden=HID,
                            num_layers=LAYERS)
    return jm, tm      # (words, label, output, cost) each


def _batches(seed, n=3, B=4):
    """Ragged rows of 1..15 ids, one of 15 per batch: every batch pads to
    T=16, so each package builds one step shape."""
    r = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        lens = r.randint(1, 16, size=B)
        lens[0] = 15
        out.append([(r.randint(0, DICT, size=k).tolist(),
                     int(r.randint(0, 2))) for k in lens])
    return out


def _jax_params(cost):
    jp = pj.parameters.create(cost, rng=jax.random.PRNGKey(7))
    return {k: np.asarray(v) for k, v in jp.as_dict().items()}


def _record(events):
    def handler(ev):
        events.append(ev)
    return handler


def _shape(events):
    return [(type(e).__name__, getattr(e, "pass_id", None),
             getattr(e, "batch_id", None)) for e in events]


OPTIMIZERS = {
    "momentum": (lambda m: m.optimizer.Momentum(momentum=0.9,
                                                learning_rate=0.1),
                 dict(rtol=1e-5, atol=1e-6)),
    "adam": (lambda m: m.optimizer.Adam(learning_rate=1e-2),
             dict(rtol=0, atol=1e-5)),
}


@pytest.mark.parametrize("opt", sorted(OPTIMIZERS))
def test_train_trajectory_matches_jax(opt):
    make_opt, param_tol = OPTIMIZERS[opt]
    (jw, jl, jout, jcost), (tw, tl, tout, tcost) = _models()
    init = _jax_params(jcost)
    batches = _batches(1)
    reader = lambda: iter(batches)                      # noqa: E731

    jev, tev = [], []
    jtr = pj.SGD(jcost, pj.Parameters.from_dict(init), make_opt(pj),
                 evaluators={"err": pj.evaluator.classification_error(
                     jout, jl)})
    jtr.train(reader, num_passes=2, event_handler=_record(jev),
              pipeline_depth=0)
    ttr = pt.SGD(tcost, TParameters.from_numpy(init), make_opt(pt),
                 evaluators={"err": pt.evaluator.classification_error(
                     tout, tl)}, device="cpu")
    out = ttr.train(reader, num_passes=2, event_handler=_record(tev))
    assert out is ttr.parameters

    assert _shape(tev) == _shape(jev)
    assert len(tev) == 2 * (2 + 2 * len(batches))
    for je, te in zip(jev, tev):
        if hasattr(je, "cost"):
            assert np.isfinite(te.cost)
            np.testing.assert_allclose(te.cost, je.cost, rtol=1e-5)
        if hasattr(je, "metrics"):
            assert te.metrics.keys() == je.metrics.keys()
            for k in je.metrics:
                assert te.metrics[k] == pytest.approx(je.metrics[k],
                                                      abs=1e-12)
    jfinal = jtr.parameters.as_dict()
    tfinal = ttr.parameters.as_dict()
    assert sorted(tfinal) == sorted(jfinal)
    for k in jfinal:
        assert tfinal[k].device.type == "cpu"
        np.testing.assert_allclose(tfinal[k].numpy(), np.asarray(jfinal[k]),
                                   err_msg=k, **param_tol)
        assert not np.allclose(tfinal[k].numpy(), init[k]) or \
            k.endswith("wbias"), f"{k} never moved"

    jt = jtr.test(reader)
    tt = ttr.test(reader)
    np.testing.assert_allclose(tt.cost, jt.cost, rtol=1e-5)
    assert tt.metrics == pytest.approx(jt.metrics)
    # test() leaves the train loop's evaluator state alone
    assert ttr.evaluators["err"].value() == tev[-1].metrics["err"]


def test_sgd_defaults_to_cuda_and_refuses_without_it():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    _, (tw, tl, tout, tcost) = _models()
    params = pt.parameters.create(tcost)
    with pytest.raises(Error, match="device='cpu'"):
        pt.SGD(tcost, params, pt.optimizer.Adam())
    pt.SGD(tcost, params, pt.optimizer.Adam(), device="cpu")


@pytest.mark.parametrize("option,value", [
    ("host_store", object()), ("host_staleness", "async"),
    ("host_tables", ["x"]), ("publish_every_n_batches", 2)])
def test_train_refuses_unported_options(option, value):
    """Publishing (queue 1 item 2.4) is still refused, naming the item.
    The host-table options are ported (tests/test_torch_host_table.py):
    on this classifier, which has no host-resident table, ``host_store``
    and ``host_staleness`` select nothing and the run trains as without
    them, as in the JAX package; ``host_tables=["x"]`` names a parameter
    no embedding reads and raises JAX's refusal."""
    _, (tw, tl, tout, tcost) = _models()
    tr = pt.SGD(tcost, pt.parameters.create(tcost), pt.optimizer.Adam(),
                device="cpu")
    if option.startswith("publish"):
        with pytest.raises(Error, match="not ported.*queue 1 item 2.4"):
            tr.train(lambda: iter(_batches(0, 1)), **{option: value})
    elif option == "host_tables":
        with pytest.raises(Error, match="'x' has no embedding consumer"):
            tr.train(lambda: iter(_batches(0, 1)), **{option: value})
    else:
        seen = []
        tr.train(lambda: iter(_batches(0, 1)), event_handler=seen.append,
                 **{option: value})
        assert tr._host_rt is None and tr._host_tables == ()
        assert sum(isinstance(e, pt.event.EndIteration) for e in seen) == 1
    with pytest.raises(TypeError):
        tr.train(lambda: iter(_batches(0, 1)), no_such_option=1)


@pytest.mark.parametrize("flag,value", [
    ("test_period", 10), ("show_parameter_stats_period", 5),
    ("log_period", 10)])
def test_train_refuses_unported_loop_flags(flag, value):
    """The JAX train loop's flags log_period, show_parameter_stats_period
    and test_period are ported: the port defines them with JAX's
    defaults, and a run under another value trains as before, now with
    its mid-pass TestResult, log line or stat dump
    (tests/test_torch_train_loop.py holds those against JAX's)."""
    from paddle_tpu_torch.utils.flags import FLAGS

    assert {n: FLAGS.get(n) for n in ("log_period",
                                      "show_parameter_stats_period",
                                      "test_period")} == {
        "log_period": 100, "show_parameter_stats_period": 0,
        "test_period": 0}
    _, (tw, tl, tout, tcost) = _models()
    tr = pt.SGD(tcost, pt.parameters.create(tcost), pt.optimizer.Adam(),
                device="cpu")
    seen = []
    saved = FLAGS.get(flag)
    FLAGS.set(flag, value)
    try:
        tr.train(lambda: iter(_batches(0, 12)), event_handler=seen.append,
                 test_reader=lambda: iter(_batches(1, 1)))
    finally:
        FLAGS.set(flag, saved)
    assert sum(isinstance(e, pt.event.EndIteration) for e in seen) == 12
    # the pass-end test, and with test_period the one after batch 10
    tests = [i for i, e in enumerate(seen)
             if isinstance(e, pt.event.TestResult)]
    assert len(tests) == (2 if flag == "test_period" else 1)
    if flag == "test_period":
        assert seen[tests[0] - 1].batch_id == 9


def test_sgd_refuses_unported_modes():
    _, (tw, tl, tout, tcost) = _models()
    params = pt.parameters.create(tcost)
    with pytest.raises(Error, match="not ported"):
        pt.SGD(tcost, params, pt.optimizer.Momentum(), device="cpu",
               mesh=object())
    # gradient accumulation and Polyak averaging are ported
    tr = pt.SGD(tcost, params, pt.optimizer.Adam(
        model_average=pt.optimizer.ModelAverage()), device="cpu",
        num_batches_per_send_parameter=2)
    assert tr._accum_steps == 2


def test_train_any_pipeline_depth_same_trajectory():
    _, (tw, tl, tout, tcost) = _models()
    init = {k: v.numpy() for k, v in
            pt.parameters.create(tcost).as_dict().items()}
    batches = _batches(2)
    costs = []
    for depth in (0, 4):
        ev = []
        tr = pt.SGD(tcost, TParameters.from_numpy(init),
                    pt.optimizer.Momentum(momentum=0.9, learning_rate=0.1),
                    device="cpu")
        tr.train(lambda: iter(batches), event_handler=_record(ev),
                 pipeline_depth=depth)
        costs.append([e.cost for e in ev if hasattr(e, "cost")])
    assert costs[0] == costs[1]


def test_save_parameter_to_tar_round_trips():
    _, (tw, tl, tout, tcost) = _models()
    tr = pt.SGD(tcost, pt.parameters.create(tcost),
                pt.optimizer.Momentum(learning_rate=0.1), device="cpu")
    tr.train(lambda: iter(_batches(3, 1)))
    buf = io.BytesIO()
    tr.save_parameter_to_tar(buf)
    buf.seek(0)
    back = TParameters.from_tar(buf)
    for k in tr.parameters.names():
        assert torch.equal(back.get(k), tr.parameters.get(k))


# --- optimizers ----------------------------------------------------------

RULES = {
    "sgd": lambda m: m.optimizer.Momentum(learning_rate=0.1),
    "momentum": lambda m: m.optimizer.Momentum(momentum=0.9,
                                               learning_rate=0.1),
    "nesterov": lambda m: m.optimizer.Momentum(momentum=0.9, nesterov=True,
                                               learning_rate=0.05),
    "adagrad": lambda m: m.optimizer.AdaGrad(learning_rate=0.1),
    "decayed_adagrad": lambda m: m.optimizer.DecayedAdaGrad(
        learning_rate=0.1),
    "adadelta": lambda m: m.optimizer.AdaDelta(learning_rate=1.0),
    "rmsprop": lambda m: m.optimizer.RMSProp(learning_rate=0.01),
    "adam": lambda m: m.optimizer.Adam(learning_rate=0.01),
    "adamax": lambda m: m.optimizer.AdaMax(learning_rate=0.01),
    "l2_clip": lambda m: m.optimizer.Momentum(
        momentum=0.5, learning_rate=0.1,
        regularization=m.optimizer.L2Regularization(0.01),
        gradient_clipping_threshold=0.5),
    "l1_global_clip": lambda m: m.optimizer.Adam(
        learning_rate=0.01, regularization=m.optimizer.L1Regularization(0.01),
        gradient_clipping_threshold=1.0, global_clipping=True),
    "poly_schedule": lambda m: m.optimizer.Momentum(
        learning_rate=0.1, learning_rate_decay_a=0.5,
        learning_rate_decay_b=0.75, learning_rate_schedule="poly"),
    "discexp_schedule": lambda m: m.optimizer.AdaGrad(
        learning_rate=0.1, learning_rate_decay_a=0.5,
        learning_rate_decay_b=2.0, learning_rate_schedule="discexp"),
}


@pytest.mark.parametrize("rule", sorted(RULES))
def test_optimizer_rule_matches_jax(rule):
    """Five updates of every dense rule on the same params and grads, with
    a static parameter and an lr multiplier: new params and the
    canonical state layout agree with the JAX package's."""
    r = np.random.RandomState(3)
    params = {"a": r.randn(4, 3).astype(np.float32),
              "b": r.randn(5).astype(np.float32),
              "frozen": r.randn(2).astype(np.float32)}
    static = {"frozen": True}
    lr_mults = {"b": 0.5}
    jopt, topt = RULES[rule](pj), RULES[rule](pt)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    js, ts = jopt.init(jp), topt.init(tp)
    for _ in range(5):
        g = {k: (r.randn(*v.shape) * 2).astype(np.float32)
             for k, v in params.items()}
        jp, js = jopt.update({k: jnp.asarray(v) for k, v in g.items()}, js,
                             jp, lr_mults, static)
        tp, ts = topt.update({k: torch.from_numpy(v) for k, v in g.items()},
                             ts, tp, lr_mults, static)
    assert sorted(ts) == sorted(js)
    assert int(ts["__step__"]) == int(js["__step__"]) == 5
    for k in params:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                   rtol=1e-5, atol=1e-6, err_msg=k)
        assert sorted(ts[k]) == sorted(js[k])
        for slot in js[k]:
            np.testing.assert_allclose(ts[k][slot].numpy(),
                                       np.asarray(js[k][slot]), rtol=1e-5,
                                       atol=1e-6, err_msg=f"{k}.{slot}")
    np.testing.assert_array_equal(tp["frozen"].numpy(), params["frozen"])


@pytest.mark.parametrize("schedule", ["constant", "poly", "exp", "discexp",
                                      "linear"])
def test_lr_schedule_matches_jax(schedule):
    a, b = (0.5, 3.0) if schedule != "linear" else (0.01, 0.02)
    jf = pj.optimizer.lr_schedule(0.1, a, b, schedule)
    tf = pt.optimizer.lr_schedule(0.1, a, b, schedule)
    for t in (1, 2, 5, 17):
        assert tf(t) == pytest.approx(float(jf(t)), rel=1e-6)


def test_unported_optimizer_parts_raise():
    """Polyak averaging is ported: the state gains ``__avg__`` (the
    parameters at init) and ``__avg_n__`` (0, float32 on the host), and
    settings() configures an optimizer as JAX's does. The sparse-row
    catch-up is ported too (tests/test_torch_sparse_grad.py): init gives a
    table its t0 slot and the base rule is the identity."""
    opt = pt.optimizer.Adam(model_average=pt.optimizer.ModelAverage())
    st = opt.init({"w": torch.ones(3, 2)})
    assert torch.equal(st["__avg__"]["w"], torch.ones(3, 2))
    assert st["__avg_n__"].dtype == torch.float32
    assert float(st["__avg_n__"]) == 0.0
    assert opt.apply_average(st, {"w": None}) == {"w": st["__avg__"]["w"]}
    set_ = pt.optimizer.settings(
        learning_rate=0.5, learning_method=pt.optimizer.Momentum,
        model_average=pt.optimizer.ModelAverage(),
        gradient_clipping_threshold=2.0)
    jset = pj.optimizer.settings(
        learning_rate=0.5, learning_method=pj.optimizer.Momentum,
        model_average=pj.optimizer.ModelAverage(),
        gradient_clipping_threshold=2.0)
    assert set_.lr_fn(3) == pytest.approx(float(jset.lr_fn(3)))
    assert set_.clip_threshold == jset.clip_threshold == 2.0
    assert set_.model_average is not None
    st = pt.optimizer.Adam().init({"w": torch.zeros(3, 2)},
                                  sparse_catchup_for=["w"])
    assert st["w"]["t0"].dtype == torch.int32
    assert st["w"]["t0"].tolist() == [0, 0, 0]
    rows, slots = torch.ones(2, 2), {"accum": torch.ones(2, 2)}
    p, s = pt.optimizer.AdaGrad().catch_up_rows(rows, slots,
                                                torch.tensor([3, 1]), 0.1)
    assert p is rows and s is slots


# --- readers, dataset, initializer, parameters, dropout ------------------

def test_readers_match_jax():
    def nums(n):
        return lambda: iter(range(n))

    def letters():
        return iter("abcdefg")

    cases = [
        lambda m: m.reader.minibatch_batch(nums(7), 3),
        lambda m: m.reader.minibatch_batch(nums(7), 3, drop_last=True),
        lambda m: m.batch(nums(5), 2),
        lambda m: m.reader.firstn(nums(9), 4),
        lambda m: m.reader.chain(nums(3), nums(2)),
        lambda m: m.reader.compose(nums(4), letters),
        lambda m: m.reader.map_readers(lambda a, b: a * 10 + b, nums(4),
                                       nums(4)),
        lambda m: m.reader.buffered(nums(20), 3),
    ]
    for make in cases:
        assert list(make(pt)()) == list(make(pj)())
    shuffled = list(pt.reader.shuffle(nums(50), 8)())
    assert sorted(shuffled) == list(range(50))


def test_synthetic_classification_matches_jax():
    for kw in (dict(seq=True, max_len=12, vocab=DICT), dict(seq=False)):
        j = list(pj.dataset.synthetic.classification(6, 3, 10, seed=4,
                                                     **kw)())
        t = list(pt.dataset.synthetic.classification(6, 3, 10, seed=4,
                                                     **kw)())
        assert len(t) == len(j) == 10
        for (tx, ty), (jx, jy) in zip(t, j):
            assert ty == jy
            np.testing.assert_array_equal(np.asarray(tx), np.asarray(jx))


def test_classifier_learns_synthetic_data_on_cpu():
    """End to end through the public names: pt.batch over the synthetic
    reader, parameters.create, SGD with Adam; the pass cost falls."""
    _, (tw, tl, tout, tcost) = _models()
    data = pt.dataset.synthetic.classification(1, 2, 48, seed=1, seq=True,
                                               max_len=10, vocab=DICT)
    tr = pt.SGD(tcost, pt.parameters.create(
        tcost, generator=torch.Generator().manual_seed(3)),
        pt.optimizer.Adam(learning_rate=0.02), device="cpu")
    passes = []
    tr.train(pt.batch(data, 16), num_passes=6, event_handler=lambda e:
             passes.append(e.cost) if isinstance(e, pt.event.EndIteration)
             else None)
    first, last = np.mean(passes[:3]), np.mean(passes[-3:])
    assert np.isfinite(passes).all() and last < first


def test_init_params_from_generator():
    _, (tw, tl, tout, tcost) = _models()
    topo = pt.Topology(tcost)
    a = topo.init_params(torch.Generator().manual_seed(5))
    b = pt.parameters.create(tcost, generator=torch.Generator()
                             .manual_seed(5))
    assert sorted(a) == sorted(topo.param_specs()) == b.names()
    for name, spec in topo.param_specs().items():
        assert tuple(a[name].shape) == spec.shape
        assert torch.equal(a[name], b.get(name))
        if spec.is_bias:
            assert not a[name].any()
    emb = a[next(n for n in a if n.startswith("___embedding"))]
    assert abs(float(emb.std()) - 1 / np.sqrt(EMB)) < 0.05


def test_initializer_strategies():
    from paddle_tpu_torch.attr import ParamAttr
    from paddle_tpu_torch.initializer import init_array

    g = torch.Generator().manual_seed(0)
    u = init_array(g, (2000,), ParamAttr(initial_min=-0.5, initial_max=0.5),
                   1)
    assert float(u.min()) >= -0.5 and float(u.max()) <= 0.5
    c = init_array(g, (3,), ParamAttr(initial_strategy="constant",
                                      initial_value=2.0), 1)
    assert torch.equal(c, torch.full((3,), 2.0))
    n = init_array(g, (4000,), ParamAttr(initial_mean=1.0, initial_std=0.1),
                   1)
    assert abs(float(n.mean()) - 1.0) < 0.01
    with pytest.raises(ValueError):
        init_array(g, (2,), ParamAttr(initial_max=1.0), 1)


def _dropout_model():
    words = pt.layer.data(name="words",
                          type=pt.data_type.integer_value_sequence(DICT))
    emb = pt.layer.embedding(input=words, size=EMB)
    pooled = pt.layer.pooling(input=emb, pooling_type=pt.pooling.Max())
    return pt.layer.fc(input=pooled, size=32, act=pt.activation.Linear(),
                       layer_attr=pt.attr.ExtraAttr(drop_rate=0.5))


def test_dropout_draws_from_the_generator():
    with torch_name_scope():
        out = _dropout_model()
    topo = pt.Topology(out)
    params = topo.init_params()
    from paddle_tpu_torch.trainer.feeder import DataFeeder
    feeds = {k: a.to("cpu") for k, a in
             DataFeeder(topo.data_type())([([1, 2, 3],), ([4],)]).items()}

    def run(seed, training=True):
        g = torch.Generator().manual_seed(seed)
        return topo.forward(params, feeds, training=training,
                            generator=g)[out.name].value

    plain = run(0, training=False)
    a, b, c = run(1), run(1), run(2)
    assert torch.equal(a, b) and not torch.equal(a, c)
    kept = a != 0
    assert 0.2 < float(kept.float().mean()) < 0.8
    torch.testing.assert_close(a[kept], 2 * plain[kept])


def test_training_lstmemory_takes_the_function():
    """In training the classifier's LSTM layers run the fused_lstm
    Function (its gradient is the backward's), not the generic loop."""
    _, (tw, tl, tout, tcost) = _models()
    topo = pt.Topology(tcost)
    params = {k: v.requires_grad_(True) for k, v in
              topo.init_params().items()}
    from paddle_tpu_torch.trainer.feeder import DataFeeder
    feeds = {k: a.to("cpu") for k, a in
             DataFeeder(topo.data_type())([([1, 2, 3], 0), ([4], 1)]).items()}
    outs = topo.forward(params, feeds, training=True)
    lstm_outs = [outs[l.name].value for l in topo.layers
                 if l.type == "lstmemory"]
    assert len(lstm_outs) == LAYERS
    names = set()
    for v in lstm_outs:
        fn = v.grad_fn
        while fn is not None and "FusedLSTM" not in type(fn).__name__:
            fn = fn.next_functions[0][0] if fn.next_functions else None
        names.add(type(fn).__name__)
    assert names == {"_FusedLSTMBackward"}


def test_loss_refuses_packed_feeds():
    """The classifier pools each row to one vector, which would mix the
    sequences of a packed row: its loss refuses a packed feed at the
    pooling layer with the JAX layer's message, and the packing feeder
    refuses its non-sequence label slot (packing itself trains since the
    port has it: tests/test_torch_packing.py)."""
    from paddle_tpu.core.arg import Arg as JArg
    from paddle_tpu.utils.error import Error as JError
    from paddle_tpu_torch.core.arg import Arg

    (jw, jl, jout, jcost), (tw, tl, tout, tcost) = _models()
    topo = pt.Topology(tcost)
    loss = topo.loss_fn()
    feeds = {"words": Arg(torch.zeros(1, 2, dtype=torch.int32),
                          torch.ones(1, 2), torch.zeros(1, 2,
                                                        dtype=torch.int32)),
             "label": Arg(torch.zeros(1, 1, dtype=torch.int32))}
    with pytest.raises(Error, match="packed sequence rows are not "
                       "supported") as te:
        loss(topo.init_params(), feeds)
    jtopo = pj.Topology(jcost)
    with pytest.raises(JError) as je:
        jtopo.loss_fn()(jtopo.init_params(jax.random.PRNGKey(0)),
                        {"words": JArg(jnp.zeros((1, 2), jnp.int32),
                                       jnp.ones((1, 2)),
                                       jnp.zeros((1, 2), jnp.int32)),
                         "label": JArg(jnp.zeros((1, 1), jnp.int32))})
    assert str(te.value) == str(je.value)
    with pytest.raises(Error, match="cannot be packed"):
        pt.SGD(tcost, pt.parameters.create(tcost), pt.optimizer.Adam(),
               device="cpu").train(lambda: iter(_batches(0, 1)),
                                   pack_sequences=True)
