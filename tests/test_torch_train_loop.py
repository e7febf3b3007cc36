"""The port's long-run train loop against the JAX package's, on the CPU at
small widths (the LSTM text classifier at vocab 200, H 16, 2 layers;
the runs that cross a checkpoint between the packages are in
tests/test_torch_checkpoint.py):

- gradient accumulation (N = 3 over 7 batches, the pass-end tail) within
  1e-5 of JAX's;
- the pipelined loop at depth 1, 2 and 3, with a mid-pass test, a step
  snapshot and a preemption: events, costs, evaluator values, snapshot
  bytes, parameters and ``__avg__`` equal to the bit;
- a preempted and resumed run through ``checkpointable(shuffle(...))``,
  dropout on, bit-equal to the uninterrupted run;
- ``log_period``'s lines and the parameter stats dump against JAX's,
  the ``paddle_train_*`` / ``paddle_feed_*`` series against JAX's
  registry, the staging arena, ``check_gradient`` against JAX's verdict.

Tolerances: bit-equality between the port's own runs; 1e-5 against the
JAX package (its lax.scan LSTM against the port's plain fused_lstm).
"""

import logging
import re
import threading

import jax
import numpy as np
import pytest
import torch

import paddle_tpu as pj
from paddle_tpu.core.layer import layer_name_scope as jax_name_scope
from paddle_tpu.models.text import lstm_text_classification as jax_lstm_cls
from paddle_tpu.utils.flags import FLAGS as JFLAGS

import paddle_tpu_torch as pt
from paddle_tpu_torch.core.layer import layer_name_scope as torch_name_scope
from paddle_tpu_torch.core.parameters import Parameters as TParameters
from paddle_tpu_torch.io import checkpoint
from paddle_tpu_torch.models.text import \
    lstm_text_classification as torch_lstm_cls
from paddle_tpu_torch.utils.error import Error
from paddle_tpu_torch.utils.flags import FLAGS

DICT, EMB, HID, LAYERS = 200, 16, 16, 2
TOL = dict(rtol=1e-5, atol=1e-5)


def _models():
    with jax_name_scope():
        jm = jax_lstm_cls(dict_dim=DICT, emb_dim=EMB, hidden=HID,
                          num_layers=LAYERS)
    with torch_name_scope():
        tm = torch_lstm_cls(dict_dim=DICT, emb_dim=EMB, hidden=HID,
                            num_layers=LAYERS)
    return jm, tm      # (words, label, output, cost) each


def _batches(seed, n=6, B=4):
    """Distinct ragged batches of 1..15 ids, one of 15 a batch (T = 16)."""
    r = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        lens = r.randint(1, 16, size=B)
        lens[0] = 15
        out.append([(r.randint(0, DICT, size=k).tolist(),
                     int(r.randint(0, 2))) for k in lens])
    return out


def _init(jcost):
    jp = pj.parameters.create(jcost, rng=jax.random.PRNGKey(7))
    return {k: np.asarray(v) for k, v in jp.as_dict().items()}


def _adam(m, average=True):
    return m.optimizer.Adam(
        learning_rate=1e-2,
        model_average=m.optimizer.ModelAverage() if average else None)


@pytest.fixture
def flags():
    """Set port and JAX flags for one test; restored after it."""
    saved = []

    def set_(name, value):
        for f in (FLAGS, JFLAGS):
            saved.append((f, name, f.get(name)))
            f.set(name, value)

    yield set_
    for f, name, value in reversed(saved):
        f.set(name, value)


def _close(a, b, err_msg="", **tol):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), err_msg=err_msg,
                               **(tol or TOL))


def test_accumulation_matches_jax():
    (jw, jl, jout, jcost), (tw, tl, tout, tcost) = _models()
    init = _init(jcost)
    batches = _batches(3, 7)

    def momentum(m):
        return m.optimizer.Momentum(momentum=0.9, learning_rate=0.1)

    jev, tev = [], []
    jtr = pj.SGD(jcost, pj.Parameters.from_dict(init), momentum(pj),
                 num_batches_per_send_parameter=3)
    jtr.train(lambda: iter(batches), pipeline_depth=0,
              event_handler=jev.append)
    ttr = pt.SGD(tcost, TParameters.from_numpy(init), momentum(pt),
                 num_batches_per_send_parameter=3, device="cpu")
    ttr.train(lambda: iter(batches), event_handler=tev.append)
    jc = [e.cost for e in jev if hasattr(e, "cost")]
    tc = [e.cost for e in tev if hasattr(e, "cost")]
    assert len(tc) == len(jc) == 7
    _close(tc, jc)
    # two full updates and the pass-end update of the last batch
    assert int(ttr._opt_state["__step__"]) == int(
        jtr._opt_state["__step__"]) == 3
    jfinal = jtr.parameters.as_dict()
    for k, v in ttr.parameters.as_dict().items():
        _close(v, jfinal[k], err_msg=k)
    with pytest.raises(Error, match="queue 1 item 7"):
        pt.SGD(tcost, TParameters.from_numpy(init), momentum(pt),
               mesh=object(), device="cpu")


def _record(events):
    def handler(ev):
        events.append((type(ev).__name__, getattr(ev, "pass_id", None),
                       getattr(ev, "batch_id", None),
                       getattr(ev, "cost", None),
                       dict(getattr(ev, "metrics", {}) or {})))
    return handler


def test_pipeline_depths_bit_equal(tmp_path, flags):
    """Depth 1, 2 and 3 over distinct batches, with a test every 3
    batches, a snapshot every 4 and a preemption at batch 6 of pass 1
    (asked for as the reader yields it, at the dispatch frontier): the
    same events and values, the same snapshot bytes, the same final
    parameters and Polyak average, bit for bit."""
    _, (tw, tl, tout, tcost) = _models()
    init = {k: v.numpy() for k, v in
            pt.parameters.create(tcost).as_dict().items()}
    batches = _batches(4, 8)
    flags("test_period", 3)
    runs = []
    for depth in (1, 2, 3):
        stop = threading.Event()

        def reader():
            for i, b in enumerate(batches):
                if i == 6 and len(seen) > 20:
                    stop.set()
                yield b

        seen = []
        tr = pt.SGD(tcost, TParameters.from_numpy(init), _adam(pt),
                    evaluators={"err": pt.evaluator.classification_error(
                        tout, tl)}, device="cpu")
        snaps = tmp_path / f"d{depth}"
        tr.train(reader, num_passes=3, event_handler=_record(seen),
                 test_reader=lambda: iter(batches[:2]), pipeline_depth=depth,
                 save_every_n_batches=4, snapshot_dir=str(snaps),
                 preempt_event=stop, use_staging_arena=depth == 3)
        assert tr.preempted
        files = {p.relative_to(snaps).as_posix(): p.read_bytes()
                 for p in sorted(snaps.rglob("*"))
                 if p.is_file() and p.name != "train_state.pkl"}
        runs.append((seen, files, tr.parameters.as_dict(),
                     tr._opt_state["__avg__"]))
    base = runs[0]
    kinds = [e[0] for e in base[0]]
    assert kinds.count("TestResult") >= 4 and "EndPass" in kinds
    # every 4 batches and at the preemption, the newest 3 kept
    assert sorted({f.split("/")[0] for f in base[1]}) == \
        ["step-0000000008", "step-0000000012", "step-0000000015"]
    for seen, files, params, avg in runs[1:]:
        assert seen == base[0]
        assert files == base[1]
        for k in base[2]:
            assert torch.equal(params[k], base[2][k]), k
            assert torch.equal(avg[k], base[3][k]), k


def _dropout_model():
    """embedding -> LSTM -> max pool -> dropout 0.5 -> fc -> cost: a
    model whose trajectory depends on the dropout generator."""
    with torch_name_scope():
        words = pt.layer.data(name="words",
                              type=pt.data_type.integer_value_sequence(DICT))
        lab = pt.layer.data(name="label", type=pt.data_type.integer_value(2))
        emb = pt.layer.embedding(input=words, size=EMB)
        cur = pt.networks.simple_lstm(input=emb, size=HID)
        pooled = pt.layer.pooling(input=cur,
                                  pooling_type=pt.pooling.Max())
        drop = pt.layer.dropout(input=pooled, dropout_rate=0.5)
        out = pt.layer.fc(input=drop, size=2, act=pt.activation.Linear())
        cost = pt.layer.classification_cost(input=out, label=lab)
    return out, lab, cost


def test_preempt_resume_bit_equal(tmp_path):
    out, lab, cost = _dropout_model()
    init = {k: v.numpy() for k, v in
            pt.parameters.create(cost).as_dict().items()}
    samples = [s for b in _batches(5, 6) for s in b]

    def reader():
        return pt.reader.checkpointable(
            pt.batch(pt.reader.shuffle(lambda: iter(samples), 10), 4),
            seed=3)

    def trainer(params):
        return pt.SGD(cost, params, _adam(pt), device="cpu",
                      evaluators={"err": pt.evaluator.classification_error(
                          out, lab)})

    whole = trainer(TParameters.from_numpy(init))
    ends = []
    whole.train(reader(), num_passes=2, pipeline_depth=2,
                event_handler=lambda e: ends.append(e.metrics)
                if isinstance(e, pt.event.EndPass) else None)

    snaps = str(tmp_path / "snaps")
    stop = threading.Event()

    def handler(e):
        if isinstance(e, pt.event.EndIteration) and e.pass_id == 1 \
                and e.batch_id == 2:
            stop.set()

    cut = trainer(TParameters.from_numpy(init))
    cut.train(reader(), num_passes=2, pipeline_depth=2, event_handler=handler,
              save_every_n_batches=2, snapshot_dir=snaps,
              preempt_event=stop)
    assert cut.preempted
    params, resume = pt.SGD.load_step_resume(snaps)
    assert resume["pass_id"] == 1 and resume["generator"] is not None
    again = trainer(params)
    resumed_ends = []
    again.train(reader(), num_passes=2, pipeline_depth=3,
                resume_state=resume, save_every_n_batches=2,
                snapshot_dir=snaps,
                event_handler=lambda e: resumed_ends.append(e.metrics)
                if isinstance(e, pt.event.EndPass) else None)
    assert resumed_ends == ends[1:]
    for k, v in whole.parameters.as_dict().items():
        assert torch.equal(again.parameters.get(k), v), k
    assert checkpoint.list_step_snapshots(snaps) == []


_NUM = re.compile(r"-?\d+\.\d+(?:e[-+]\d+)?")


def test_log_lines_and_stats_match_jax(caplog, flags):
    (jw, jl, jout, jcost), (tw, tl, tout, tcost) = _models()
    init = _init(jcost)
    batches = _batches(7, 6)
    flags("log_period", 2)
    flags("show_parameter_stats_period", 3)
    caplog.set_level(logging.INFO, logger="paddle_tpu")
    caplog.set_level(logging.INFO, logger="paddle_tpu_torch")
    lines = {}
    for name, m, cost, out, lab, params, kw in (
            ("jax", pj, jcost, jout, jl, pj.Parameters.from_dict(init), {}),
            ("port", pt, tcost, tout, tl, TParameters.from_numpy(init),
             {"device": "cpu"})):
        caplog.clear()
        tr = m.SGD(cost, params, _adam(m, average=False),
                   evaluators={"err": m.evaluator.classification_error(
                       out, lab)}, **kw)
        tr.train(lambda: iter(batches), pipeline_depth=2,
                 event_handler=lambda e: None)
        lines[name] = [r.getMessage() for r in caplog.records
                       if r.name == ("paddle_tpu" if name == "jax"
                                     else "paddle_tpu_torch")
                       and ("batch" in r.getMessage()
                            or "param " in r.getMessage())]
    # 3 log lines, 2 dumps of the 9 parameters
    assert len(lines["port"]) == len(lines["jax"]) == 3 + 2 * 9
    for t, j in zip(lines["port"], lines["jax"]):
        assert _NUM.sub("#", t) == _NUM.sub("#", j)
        _close([float(x) for x in _NUM.findall(t)],
               [float(x) for x in _NUM.findall(j)], rtol=1e-4, atol=1e-6)


def test_train_series_match_jax():
    """The paddle_train_* and paddle_feed_* series: the JAX package's
    names, types, labels and help, and the port's loop counts into
    them."""
    import paddle_tpu.trainer.feeder  # noqa: F401  (registers the series)
    import paddle_tpu.trainer.trainer  # noqa: F401
    from paddle_tpu.observability import metrics as jm
    from paddle_tpu_torch.observability import metrics as tm

    js, ts = jm.default_registry.snapshot(), tm.default_registry.snapshot()
    names = sorted(n for n in js if n.startswith(("paddle_train_",
                                                  "paddle_feed_")))
    assert len(names) == 11
    assert names == sorted(n for n in ts if n.startswith((
        "paddle_train_", "paddle_feed_")))
    for n in names:
        for key in ("type", "labelnames", "help"):
            assert ts[n][key] == js[n][key], (n, key)
    _, (tw, tl, tout, tcost) = _models()
    batches = _batches(8, 3)
    count = tm.default_registry.counter("paddle_train_batches_total")
    before = count.value
    pt.SGD(tcost, pt.parameters.create(tcost), _adam(pt),
           device="cpu").train(lambda: iter(batches),
                               event_handler=lambda e: None)
    assert count.value == before + 3
    pad = tm.default_registry.snapshot()["paddle_feed_padded_len"]["series"]
    assert pad[(("feed", "words"), ("packed", "0"))] == 16


def test_staging_arena(tmp_path):
    """The arena's buffers are reused by (tag, gen, shape, dtype) and
    rotate through generations; a feeder on it gives the plain feeder's
    arrays; SGD.train on it is bit-equal to SGD.train without it."""
    from paddle_tpu_torch.io.staging import StagingArena
    from paddle_tpu_torch.trainer.feeder import DataFeeder

    a = StagingArena(arena_bytes=1024)
    x = a.buffer("w:v", (4, 8), np.int32, gen=0)
    x[:] = 5
    assert np.shares_memory(x, a.buffer("w:v", (4, 8), np.int32, gen=0))
    assert not x.any()                      # zeroed on reuse
    assert not np.shares_memory(x, a.buffer("w:v", (4, 8), np.int32, gen=1))
    assert a.stats() == {"used": 256, "peak": 256, "buffers": 2}
    with pytest.raises(Error, match="exhausted"):
        a.buffer("big", (1024,), np.float32)
    a.close()
    with pytest.raises(RuntimeError, match="closed"):
        a.buffer("w:v", (4, 8), np.int32)

    _, (tw, tl, tout, tcost) = _models()
    types = pt.Topology(tcost).data_type()
    batches = _batches(9, 4)
    plain, staged = DataFeeder(types), DataFeeder(
        types, use_staging_arena=True, rotate_buffers=2)
    held = []
    for b in batches:
        want, got = plain(b), staged(b)
        held.append(got["words"].value)
        for k in want:
            np.testing.assert_array_equal(got[k].value, want[k].value)
            np.testing.assert_array_equal(got[k].mask, want[k].mask)
    assert np.shares_memory(held[0], held[2])
    assert not np.shares_memory(held[0], held[1])

    init = {k: v.numpy() for k, v in
            pt.parameters.create(tcost).as_dict().items()}
    costs = []
    for arena in (False, True):
        ev = []
        pt.SGD(tcost, TParameters.from_numpy(init), _adam(pt),
               device="cpu").train(lambda: iter(batches), pipeline_depth=3,
                                   use_staging_arena=arena,
                                   event_handler=ev.append)
        costs.append([e.cost for e in ev if hasattr(e, "cost")])
    assert costs[0] == costs[1]


@pytest.mark.cuda
def test_staging_arena_pins_on_cuda():
    """On CUDA the arena's buffers are page-locked, and a depth-3 run on
    the staging arena is bit-equal to the synchronous run."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc (the port's CUDA kernels)")
    from paddle_tpu_torch.io.staging import StagingArena

    a = StagingArena(pin_memory=True)
    assert torch.from_numpy(a.buffer("x:v", (8, 8), np.int32)).is_pinned()
    _, (tw, tl, tout, tcost) = _models()
    init = {k: v.numpy() for k, v in
            pt.parameters.create(tcost).as_dict().items()}
    batches = _batches(10, 6)
    costs = []
    for depth, arena in ((1, False), (3, True)):
        ev = []
        pt.SGD(tcost, TParameters.from_numpy(init), _adam(pt)).train(
            lambda: iter(batches), pipeline_depth=depth,
            use_staging_arena=arena, event_handler=ev.append)
        costs.append([e.cost for e in ev if hasattr(e, "cost")])
    assert costs[0] == costs[1]


def test_check_gradient_matches_jax():
    from paddle_tpu.trainer.checkgrad import check_gradient as jax_check
    from paddle_tpu.trainer.feeder import DataFeeder as JFeeder
    from paddle_tpu_torch.trainer.checkgrad import check_gradient
    from paddle_tpu_torch.trainer.feeder import DataFeeder

    (jw, jl, jout, jcost), (tw, tl, tout, tcost) = _models()
    init = _init(jcost)
    batch = _batches(11, 1)[0]
    jtopo, ttopo = pj.Topology(jcost), pt.Topology(tcost)
    jok, jrep = jax_check(jtopo, jcost.name, init,
                          JFeeder(jtopo.data_type())(batch))
    tok, trep = check_gradient(
        ttopo, tcost.name,
        {k: torch.from_numpy(v.copy()) for k, v in init.items()},
        DataFeeder(ttopo.data_type())(batch))
    assert tok == jok is True
    assert sorted(trep) == sorted(jrep)
    for k in jrep:
        for f in ("analytic", "numeric"):
            assert trep[k][f] == pytest.approx(jrep[k][f], rel=1e-6,
                                               abs=1e-9), (k, f)
    # a difference past rtol fails the check
    params = {k: torch.from_numpy(v.copy()) for k, v in init.items()}
    tok, trep = check_gradient(ttopo, tcost.name, params,
                               DataFeeder(ttopo.data_type())(batch),
                               eps=1e-1, rtol=1e-12)
    assert not tok
