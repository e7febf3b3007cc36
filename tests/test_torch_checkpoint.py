"""The port's checkpoints (``paddle_tpu_torch.io.checkpoint``) against the
JAX package's: the same optimizer state written by either package gives
the same bytes on disk (params.tar, opt_state.pkl, meta.json), a
checkpoint written by one loads in the other, and the port's loader
refuses torn, garbage, future-format and uncommitted checkpoints, falls
back past a torn newest snapshot and prunes, as the JAX package's does
(the port twins of tests/test_checkpoint_robust.py and
tests/test_checkpoint_atomic.py). Also the fault injection copy
(``distributed.faults``) and the ``paddle_checkpoint_*`` series.

Two trainings cross a checkpoint (the LSTM text classifier at vocab 200,
H 16, 2 layers, Adam with ModelAverage): the JAX package trains 3
batches, writes a checkpoint and trains 3 more, while the port loads the
checkpoint and trains the same 3 (parameters, ``__avg__`` and
``test()``'s averaged cost within 1e-5); and the port resumes a JAX step
snapshot, whose JAX key it refuses until ``generator=`` is given.
"""

import json
import os
import pickle
import tarfile
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pj
from paddle_tpu.core.layer import layer_name_scope as jax_name_scope
from paddle_tpu.distributed import faults as jfaults
from paddle_tpu.io import checkpoint as jckpt
from paddle_tpu.models.text import lstm_text_classification as jax_lstm_cls

import paddle_tpu_torch as pt
from paddle_tpu_torch.core.layer import layer_name_scope as torch_name_scope
from paddle_tpu_torch.core.parameters import Parameters as TParameters
from paddle_tpu_torch.distributed import faults
from paddle_tpu_torch.io import checkpoint
from paddle_tpu_torch.io.checkpoint import CheckpointError
from paddle_tpu_torch.models.text import \
    lstm_text_classification as torch_lstm_cls
from paddle_tpu_torch.utils.error import Error

DICT, EMB, HID, LAYERS = 200, 16, 16, 2
TOL = dict(rtol=1e-5, atol=1e-5)


def _states(n_updates=2, seed=0):
    """Adam with ModelAverage, the same updates in each package: (JAX
    params, JAX state, port params, port state). On these inputs the two
    are bit-equal."""
    r = np.random.RandomState(seed)
    params = {"a": r.randn(4, 3).astype(np.float32),
              "b": r.randn(5).astype(np.float32)}
    jo = pj.optimizer.Adam(learning_rate=0.01,
                           model_average=pj.optimizer.ModelAverage())
    to = pt.optimizer.Adam(learning_rate=0.01,
                           model_average=pt.optimizer.ModelAverage())
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    js, ts = jo.init(jp), to.init(tp)
    for _ in range(n_updates):
        g = {k: r.randn(*v.shape).astype(np.float32)
             for k, v in params.items()}
        jp, js = jo.update({k: jnp.asarray(v) for k, v in g.items()}, js, jp)
        tp, ts = to.update({k: torch.from_numpy(v) for k, v in g.items()},
                           ts, tp)
    return jp, js, tp, ts


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def test_same_state_same_bytes(tmp_path):
    jp, js, tp, ts = _states()
    jckpt.save_checkpoint(str(tmp_path / "j"), pj.Parameters.from_dict(
        {k: np.asarray(v) for k, v in jp.items()}), js, {"pass_id": 1})
    checkpoint.save_checkpoint(str(tmp_path / "t"), TParameters.from_dict(
        dict(tp)), ts, {"pass_id": 1})
    for f in ("params.tar", "opt_state.pkl", "meta.json"):
        assert (tmp_path / "j" / f).read_bytes() == \
            (tmp_path / "t" / f).read_bytes(), f


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_checkpoint_crosses_packages(tmp_path, writer):
    """Written by one package, loaded by the other: parameters bit-equal,
    the optimizer state's layout and values equal (``__step__`` int32,
    ``__avg_n__`` float32, 0-d), the meta and train state read back."""
    jp, js, tp, ts = _states(3)
    path = str(tmp_path / "ck")
    ts_in = {"reader_state": {"epoch": 1, "consumed": 5, "seed": 9},
             "pass_cost": 1.5, "pass_batches": 2}
    if writer == "port":
        checkpoint.save_checkpoint(path, TParameters.from_dict(dict(tp)), ts,
                                   {"pass_id": 2}, train_state=ts_in)
        params, opt, meta = jckpt.load_checkpoint(path)
        want_p = {k: v.numpy() for k, v in tp.items()}
        want_s = _flat(ts)
    else:
        jckpt.save_checkpoint(path, pj.Parameters.from_dict(
            {k: np.asarray(v) for k, v in jp.items()}), js, {"pass_id": 2},
            train_state=ts_in)
        params, opt, meta = checkpoint.load_checkpoint(path)
        want_p = {k: np.asarray(v) for k, v in jp.items()}
        want_s = _flat(js)
    assert meta["pass_id"] == 2
    assert meta["format_version"] == checkpoint.FORMAT_VERSION \
        == jckpt.FORMAT_VERSION
    assert meta["train_state"] == ts_in
    assert sorted(params.names()) == sorted(want_p)
    for k, v in want_p.items():
        np.testing.assert_array_equal(np.asarray(params.get(k)), v)
    got_s = _flat(opt)
    assert sorted(got_s) == sorted(want_s)
    for k, v in want_s.items():
        assert got_s[k].dtype == v.dtype and got_s[k].shape == v.shape, k
        np.testing.assert_array_equal(got_s[k], v, err_msg=k)
    assert got_s["__step__"].dtype == np.int32
    assert got_s["__avg_n__"].dtype == np.float32
    assert got_s["__avg_n__"].shape == ()


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_pass_dirs_and_state_snapshots_cross_packages(tmp_path, writer):
    """A pass directory (``save_pass``) and a series of state snapshots
    (``save_state_snapshot`` with pruning) written by one package, read by
    the other: the pass loads bit-equal, the newest two state snapshots
    are kept, and with the newest torn the reader falls back to the one
    before it."""
    jp, js, tp, ts = _states(2)
    save_dir = str(tmp_path / "run")
    if writer == "port":
        w, r = checkpoint, jckpt
        w.save_pass(save_dir, 4, TParameters.from_dict(dict(tp)), ts)
        want_p = {k: v.numpy() for k, v in tp.items()}
    else:
        w, r = jckpt, checkpoint
        w.save_pass(save_dir, 4, pj.Parameters.from_dict(
            {k: np.asarray(v) for k, v in jp.items()}), js)
        want_p = {k: np.asarray(v) for k, v in jp.items()}
    params, opt, meta = r.load_pass(save_dir, 4)
    assert meta["pass_id"] == 4
    for k, v in want_p.items():
        np.testing.assert_array_equal(np.asarray(params.get(k)), v)
    assert int(np.asarray(opt["__step__"])) == 2
    for seq in (3, 5, 9):
        w.save_state_snapshot(save_dir, seq, {"seq": seq, "rows": [seq] * 3},
                              prefix="svc", meta={"who": writer}, keep=2)
    assert [s for s, _ in r.list_state_snapshots(save_dir, "svc")] == [5, 9]
    newest = r.list_state_snapshots(save_dir, "svc")[-1][1]
    assert r.validate_state_snapshot(newest)["who"] == writer
    assert r.load_latest_state_snapshot(save_dir, "svc")[2] == \
        {"seq": 9, "rows": [9, 9, 9]}
    with open(os.path.join(newest, "state.pkl"), "r+b") as f:
        f.truncate(5)
    with pytest.raises(r.CheckpointError, match="checksum"):
        r.validate_state_snapshot(newest)
    seq, _path, payload = r.load_latest_state_snapshot(save_dir, "svc")
    assert (seq, payload) == (5, {"seq": 5, "rows": [5, 5, 5]})


def _params(val=0.0):
    return TParameters.from_dict({"w": np.full((2, 3), val, np.float32)})


def _tear(path, keep):
    blob = open(path, "rb").read()
    with open(path, "wb") as f:
        f.write(blob[:keep])


def _case_missing(tmp_path):
    with pytest.raises(CheckpointError, match="nope"):
        checkpoint.load_checkpoint(str(tmp_path / "nope"))
    os.makedirs(tmp_path / "empty")
    with pytest.raises(CheckpointError, match="params.tar"):
        checkpoint.load_checkpoint(str(tmp_path / "empty"))


def _case_truncated(tmp_path):
    path = str(tmp_path / "ckpt")
    checkpoint.save_checkpoint(path, _params(1.0), None, {"pass_id": 0})
    tar = os.path.join(path, "params.tar")
    with tarfile.open(tar) as t:
        m = t.getmember("w")
        cut = m.offset_data + m.size // 2
    _tear(tar, cut)
    with pytest.raises(CheckpointError, match="params.tar"):
        checkpoint.load_checkpoint(path)


def _case_garbage(tmp_path):
    path = str(tmp_path / "ckpt")
    os.makedirs(path)
    with open(os.path.join(path, "params.tar"), "wb") as f:
        f.write(b"this is not a tar file at all")
    with pytest.raises(CheckpointError):
        checkpoint.load_checkpoint(path)


def _case_future_format(tmp_path):
    path = str(tmp_path / "ckpt")
    checkpoint.save_checkpoint(
        path, _params(), None,
        {"format_version": checkpoint.FORMAT_VERSION + 7})
    with pytest.raises(CheckpointError, match="format"):
        checkpoint.load_checkpoint(path)
    with pytest.raises(jckpt.CheckpointError, match="format"):
        jckpt.load_checkpoint(path)


def _case_pre_versioning(tmp_path):
    path = str(tmp_path / "ckpt")
    checkpoint.save_checkpoint(path, _params(2.0), None, {"pass_id": 0})
    mpath = os.path.join(path, "meta.json")
    meta = json.load(open(mpath))
    del meta["format_version"]
    with open(mpath, "w") as f:
        json.dump(meta, f)
    loaded, _, _ = checkpoint.load_checkpoint(path)
    np.testing.assert_array_equal(loaded.get("w").numpy(),
                                  np.full((2, 3), 2.0, np.float32))


def _case_missing_meta(tmp_path):
    path = str(tmp_path / "ckpt")
    checkpoint.save_checkpoint(path, _params(2.0), None, {"pass_id": 0})
    os.remove(os.path.join(path, "meta.json"))
    with pytest.raises(CheckpointError, match="meta.json"):
        checkpoint.load_checkpoint(path)


def _case_torn_train_state(tmp_path):
    path = str(tmp_path / "ckpt")
    ts = {"torch_generator": {"device": "cpu",
                              "state": np.arange(4, dtype=np.uint8)},
          "reader_state": {"epoch": 1, "consumed": 5, "seed": 9}}
    checkpoint.save_checkpoint(path, _params(),
                               {"w": {"m": torch.ones(3)}},
                               {"pass_id": 1, "batch_id": 4}, train_state=ts)
    _, _, meta = checkpoint.load_checkpoint(path)
    np.testing.assert_array_equal(
        meta["train_state"]["torch_generator"]["state"], np.arange(4))
    with open(os.path.join(path, "train_state.pkl"), "ab") as f:
        f.write(b"garbage")
    with pytest.raises(CheckpointError, match="train_state"):
        checkpoint.load_checkpoint(path)


def _case_fallback(tmp_path):
    d = str(tmp_path)
    checkpoint.save_step(d, 2, _params(2.0), None, {"pass_id": 0,
                                                    "batch_id": 1})
    checkpoint.save_step(d, 4, _params(4.0), None, {"pass_id": 0,
                                                    "batch_id": 3})
    step, path = checkpoint.find_latest_step(d)
    assert step == 4
    _tear(os.path.join(path, "params.tar"), 20)
    step, path = checkpoint.find_latest_step(d)
    assert step == 2
    assert jckpt.find_latest_step(d)[0] == 2
    loaded, _, _ = checkpoint.load_checkpoint(path)
    np.testing.assert_array_equal(loaded.get("w").numpy(),
                                  np.full((2, 3), 2.0, np.float32))


def _case_pruning(tmp_path):
    d = str(tmp_path)
    for s in (2, 4, 6, 8):
        checkpoint.save_step(d, s, _params(float(s)), keep=2)
    assert [s for s, _ in checkpoint.list_step_snapshots(d)] == [6, 8]
    assert [s for s, _ in jckpt.list_step_snapshots(d)] == [6, 8]
    checkpoint.clear_step_snapshots(d)
    assert checkpoint.list_step_snapshots(d) == []
    assert checkpoint.find_latest_step(d) is None


def _case_all_torn(tmp_path):
    d = str(tmp_path)
    checkpoint.save_step(d, 2, _params())
    _, path = checkpoint.find_latest_step(d)
    with open(os.path.join(path, "params.tar"), "wb") as f:
        f.write(b"xx")
    assert checkpoint.find_latest_step(d) is None


def _case_no_temp_litter(tmp_path):
    path = str(tmp_path / "ckpt")
    state = {"w": {"mom": torch.ones((2, 3))},
             "__step__": torch.tensor(3, dtype=torch.int32)}
    checkpoint.save_checkpoint(path, _params(), state, {"pass_id": 1})
    assert not [f for f in os.listdir(path) if ".tmp." in f]
    _, ost, meta = checkpoint.load_checkpoint(path)
    assert meta["pass_id"] == 1
    np.testing.assert_array_equal(ost["w"]["mom"], np.ones((2, 3)))


def _case_crashed_writer(tmp_path):
    path = str(tmp_path / "ckpt")
    checkpoint.save_checkpoint(path, _params(), None, {"pass_id": 1})
    before = open(os.path.join(path, "params.tar"), "rb").read()

    class Boom(TParameters):
        def to_tar(self, f):
            f.write(b"partial garbage")
            raise IOError("disk full mid-write")

    with pytest.raises(IOError):
        checkpoint.save_checkpoint(
            path, Boom.from_dict({"w": np.zeros((2, 3), np.float32)}),
            None, {"pass_id": 2})
    assert open(os.path.join(path, "params.tar"), "rb").read() == before
    assert not [f for f in os.listdir(path) if ".tmp." in f]
    assert checkpoint.load_checkpoint(path)[2]["pass_id"] == 1


def _case_mixed_writer(tmp_path):
    path = str(tmp_path / "ckpt")
    checkpoint.save_checkpoint(path, _params(),
                               {"w": {"mom": torch.ones((2, 3))}}, {})
    with open(os.path.join(path, "opt_state.pkl"), "wb") as f:
        f.write(pickle.dumps({"w": {"mom": np.zeros((2, 3))}}))
    with pytest.raises(CheckpointError):
        checkpoint.load_checkpoint(path)


def _case_torn_fault(tmp_path):
    """A ``torn`` fault at the writer's ``checkpoint.write`` point: the
    save raises, the half-written temp file is gone, the newest valid
    snapshot is the previous one."""
    d = str(tmp_path)
    checkpoint.save_step(d, 2, _params(2.0), None, {"batch_id": 1})
    plan = faults.FaultPlan([faults.FaultSpec("checkpoint.write", "torn")])
    with plan.installed():
        with pytest.raises(faults.TornWriteError):
            checkpoint.save_step(d, 4, _params(4.0), None, {"batch_id": 3})
    assert plan.fired() == [("checkpoint.write", 1, "torn")]
    assert checkpoint.find_latest_step(d)[0] == 2
    assert not [f for f in os.listdir(os.path.join(d, "step-0000000004"))
                if ".tmp." in f]


ROBUST_CASES = {
    "missing": _case_missing, "truncated": _case_truncated,
    "garbage": _case_garbage, "future_format": _case_future_format,
    "pre_versioning": _case_pre_versioning,
    "missing_meta": _case_missing_meta,
    "torn_train_state": _case_torn_train_state,
    "fallback_past_torn_newest": _case_fallback, "pruning": _case_pruning,
    "all_torn": _case_all_torn, "no_temp_litter": _case_no_temp_litter,
    "crashed_writer": _case_crashed_writer,
    "mixed_writer": _case_mixed_writer, "torn_fault": _case_torn_fault,
}


@pytest.mark.parametrize("case", sorted(ROBUST_CASES))
def test_checkpoint_robust(tmp_path, case):
    ROBUST_CASES[case](tmp_path)


def test_fault_plan_matches_jax(tmp_path):
    """The port's faults copy: the same plan JSON, ordinals and firing
    transcript as the JAX package's."""
    specs = [("reader.next", "drop", 2, 2), ("checkpoint.write", "delay", 1,
                                             1)]
    plans = [m.FaultPlan([m.FaultSpec(p, a, at=at, count=c, seconds=0.0)
                          for p, a, at, c in specs], seed=3)
             for m in (faults, jfaults)]
    plans[0].to_json(str(tmp_path / "plan.json"))
    back = jfaults.FaultPlan.from_json(str(tmp_path / "plan.json"))
    assert [s.to_dict() for s in back.specs] == \
        [s.to_dict() for s in plans[0].specs]
    for plan in plans:
        errs = []
        for point in ["reader.next"] * 4 + ["checkpoint.write"]:
            try:
                plan.fire(point)
            except ConnectionError:
                errs.append(point)
        assert errs == ["reader.next", "reader.next"]
    assert plans[0].fired() == plans[1].fired()
    assert plans[0].counters() == plans[1].counters()
    with pytest.raises(ValueError):
        faults.FaultSpec("x", "explode")
    os.environ[faults.PLAN_ENV] = str(tmp_path / "plan.json")
    try:
        assert faults.install_from_env() is not None
        assert faults.active() is not None
    finally:
        faults.clear()
        del os.environ[faults.PLAN_ENV]


def test_checkpoint_series_match_jax(tmp_path):
    """``paddle_checkpoint_*``: the JAX package's names, types and labels,
    counted by the port's writer, validator and loader."""
    from paddle_tpu.observability import metrics as jm
    from paddle_tpu_torch.observability import metrics as tm

    js, ts = jm.default_registry.snapshot(), tm.default_registry.snapshot()
    names = [n for n in js if n.startswith("paddle_checkpoint_")]
    assert len(names) == 3
    for n in names:
        assert ts[n]["type"] == js[n]["type"], n
        assert ts[n]["labelnames"] == js[n]["labelnames"], n
        assert ts[n]["help"] == js[n]["help"], n
    ops = tm.default_registry.counter("paddle_checkpoint_ops_total",
                                      labels=("op", "ok"))
    before = ops.labels(op="save", ok="true").value
    checkpoint.save_checkpoint(str(tmp_path / "ck"), _params(), None, {})
    assert ops.labels(op="save", ok="true").value == before + 1


# --- training across a checkpoint ------------------------------------------

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


def _adam(m):
    return m.optimizer.Adam(learning_rate=1e-2,
                            model_average=m.optimizer.ModelAverage())


def _close(a, b, err_msg=""):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), err_msg=err_msg,
                               **TOL)


def test_averaged_training_continues_jax_checkpoint(tmp_path):
    (jw, jl, jout, jcost), (tw, tl, tout, tcost) = _models()
    init = _init(jcost)
    first, second = _batches(1, 3), _batches(2, 3)
    jtr = pj.SGD(jcost, pj.Parameters.from_dict(init), _adam(pj),
                 evaluators={"err": pj.evaluator.classification_error(
                     jout, jl)})
    jtr.train(lambda: iter(first), pipeline_depth=0,
              event_handler=lambda e: None)
    path = str(tmp_path / "pass-00000")
    jckpt.save_checkpoint(path, jtr.parameters, jtr._opt_state,
                          {"pass_id": 0})
    jtr.train(lambda: iter(second), pipeline_depth=0,
              event_handler=lambda e: None)

    params, opt_state, meta = checkpoint.load_checkpoint(path)
    ttr = pt.SGD(tcost, params, _adam(pt),
                 evaluators={"err": pt.evaluator.classification_error(
                     tout, tl)}, device="cpu")
    costs = []
    ttr.train(lambda: iter(second), event_handler=lambda e: costs.append(
        getattr(e, "cost", None)),
        resume_state={"opt_state": opt_state, "pass_id": 0, "batch_id": -1,
                      "global_step": 3})
    jfinal = jtr.parameters.as_dict()
    for k, v in ttr.parameters.as_dict().items():
        _close(v, jfinal[k], err_msg=k)
        _close(ttr._opt_state["__avg__"][k], jtr._opt_state["__avg__"][k],
               err_msg=k)
    assert float(ttr._opt_state["__avg_n__"]) == 6.0
    assert int(ttr._opt_state["__step__"]) == 6
    jt, tt = jtr.test(lambda: iter(first)), ttr.test(lambda: iter(first))
    _close(tt.cost, jt.cost)
    assert tt.metrics == pytest.approx(jt.metrics)
    # the averaged weights, swapped in and back out
    live = {k: v.clone() for k, v in ttr.parameters.as_dict().items()}
    with ttr.averaged_parameters() as avg:
        for k, v in avg.as_dict().items():
            assert torch.equal(v, ttr._opt_state["__avg__"][k])
    for k, v in ttr.parameters.as_dict().items():
        assert torch.equal(v, live[k])


def test_port_resumes_a_jax_snapshot(tmp_path):
    """A JAX step snapshot resumed by the port: its JAX key cannot
    continue the port's generator, so train() refuses it by name until
    generator= is given; then the run matches JAX's uninterrupted one."""
    (jw, jl, jout, jcost), (tw, tl, tout, tcost) = _models()
    init = _init(jcost)
    batches = _batches(6, 5)
    snaps = str(tmp_path / "snaps")
    stop = threading.Event()

    def jreader():
        for i, b in enumerate(batches):
            if i == 3:
                stop.set()
            yield b

    jtr = pj.SGD(jcost, pj.Parameters.from_dict(init), _adam(pj))
    jtr.train(jreader, pipeline_depth=0, save_every_n_batches=2,
              snapshot_dir=snaps, preempt_event=stop,
              event_handler=lambda e: None)
    params, resume = pt.SGD.load_step_resume(snaps)
    # the JAX package finishes its own run from the same snapshot (its
    # resume continues the uninterrupted trajectory)
    jparams, jresume = pj.SGD.load_step_resume(snaps)
    jtr.parameters = jparams
    jtr.train(lambda: iter(batches), pipeline_depth=0, resume_state=jresume,
              event_handler=lambda e: None)

    assert resume["rng"] is not None and resume["generator"] is None
    tr = pt.SGD(tcost, params, _adam(pt), device="cpu")
    with pytest.raises(Error, match="JAX PRNG key.*generator="):
        tr.train(lambda: iter(batches), resume_state=resume)
    tr.train(lambda: iter(batches), resume_state=resume,
             generator=torch.Generator().manual_seed(0),
             event_handler=lambda e: None)
    jfinal = jtr.parameters.as_dict()
    for k, v in tr.parameters.as_dict().items():
        _close(v, jfinal[k], err_msg=k)
        _close(tr._opt_state["__avg__"][k], jtr._opt_state["__avg__"][k],
               err_msg=k)


def test_jax_resumes_a_port_snapshot(tmp_path):
    """The other direction: a port step snapshot (evaluator partial sums
    included) resumed by the JAX package, whose run then ends where the
    port's uninterrupted run does; the port's generator state is ignored
    there (the JAX loop starts its key from the seed flag)."""
    (jw, jl, jout, jcost), (tw, tl, tout, tcost) = _models()
    init = _init(jcost)
    batches = _batches(8, 5)
    snaps = str(tmp_path / "snaps")
    stop = threading.Event()

    def reader():
        for i, b in enumerate(batches):
            if i == 2:
                stop.set()
            yield b

    def port_trainer():
        return pt.SGD(tcost, TParameters.from_numpy(init), _adam(pt),
                      evaluators={"err": pt.evaluator.classification_error(
                          tout, tl)}, device="cpu")

    whole, ends = port_trainer(), []
    whole.train(lambda: iter(batches), event_handler=lambda e: ends.append(
        e.metrics) if isinstance(e, pt.event.EndPass) else None)
    port_trainer().train(reader, save_every_n_batches=2, snapshot_dir=snaps,
                         preempt_event=stop, event_handler=lambda e: None)
    jparams, jresume = pj.SGD.load_step_resume(snaps)
    assert jresume["batch_id"] == 2 and jresume["rng"] is None
    jtr = pj.SGD(jcost, jparams, _adam(pj),
                 evaluators={"err": pj.evaluator.classification_error(
                     jout, jl)})
    jends = []
    jtr.train(lambda: iter(batches), pipeline_depth=0, resume_state=jresume,
              event_handler=lambda e: jends.append(e.metrics)
              if isinstance(e, pj.event.EndPass) else None)
    assert jends == ends
    for k, v in whole.parameters.as_dict().items():
        _close(v, jtr.parameters.get(k), err_msg=k)
        _close(whole._opt_state["__avg__"][k], jtr._opt_state["__avg__"][k],
               err_msg=k)
