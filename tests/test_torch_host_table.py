"""The port's host-resident embedding tables (``paddle_tpu_torch/
host_table.py``, ``SGD.train(host_tables=...)``) against the JAX package
on the CPU, at ``bench.py --model ctr --quick``'s widths: wide 256, deep
512 (lazy: 50,000), emb 4, max_ids 4, hidden 8, B = 8, cache 64.

- ``make_row_init``: rows bit-equal to JAX's for the normal, uniform,
  zero and constant strategies at ids up to 99,999,999, and the same
  bytes under two ``PYTHONHASHSEED`` values.
- ``HostRowStore.apply_sparse`` (repeated and negative ids, catch-up
  gaps) against JAX's store on the same calls, SGD, Momentum, AdaGrad and
  Adam, dense and lazy: rows and slots to 1e-6, t0 equal.
- ``ctr_wide_deep`` trained host-backed by both ``SGD.train``s from the
  same parameters, SGD and AdaGrad at depths 0 and 2 (costs rtol 1e-5,
  final tables atol 1e-6), and lazily (100M-row mode at 50,000 rows, the
  same rows from both packages' ``make_row_init``).
- In the port: host-backed equal to device-resident bit for bit on the
  CPU; exact staleness at depth 2 equal to depth 1 bit for bit, its
  conflict drains counted; snapshot and resume equal to the unbroken run,
  and a JAX step snapshot's ``host_tables`` resumed in the port.
- The PTPUROWS sidecar and a bundle carrying it byte-equal to JAX's
  writer's, each package reading the other's.
- JAX's refusals made alike; ``host_table_min_rows`` and
  ``host_cache_rows`` as JAX reads them; the step's device parameters of a
  host table the cache's shape; ``debug_nans`` raising
  ``FloatingPointError`` in both packages with the flag and in neither
  without; the ``paddle_embcache_*`` series; the init of the other
  parameters (docs/torch_embedding_cache.md).
"""

import io
import os
import subprocess
import sys
import tarfile

import jax
import numpy as np
import pytest
import torch

import paddle_tpu as pj
from paddle_tpu import host_table as jht
from paddle_tpu.core.layer import layer_name_scope as jax_name_scope
from paddle_tpu.io import merged_model as jmm
from paddle_tpu.models import text as jtext
from paddle_tpu.utils.flags import FLAGS as JFLAGS

import paddle_tpu_torch as pt
from paddle_tpu_torch import host_table as tht
from paddle_tpu_torch.core.layer import layer_name_scope as torch_name_scope
from paddle_tpu_torch.io import merged_model as tmm
from paddle_tpu_torch.models import text as ttext
from paddle_tpu_torch.utils.error import Error
from paddle_tpu_torch.utils.flags import FLAGS

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WIDE, DEEP, LAZY, EMB, K, HIDDEN, B, CACHE = 256, 512, 50_000, 4, 4, 8, 8, 64
FEEDING = {"wide_ids": 0, "deep_ids": 1, "click": 2}
TABLES = ["_deep_emb", "_wide_w"]
COST_TOL = dict(rtol=1e-5, atol=0)
ROW_TOL = dict(rtol=0, atol=1e-6)
OPTS = {"sgd": lambda m: m.optimizer.SGD(learning_rate=0.05),
        "momentum": lambda m: m.optimizer.Momentum(momentum=0.9,
                                                   learning_rate=0.05),
        "adagrad": lambda m: m.optimizer.AdaGrad(learning_rate=0.05),
        "adam": lambda m: m.optimizer.Adam(learning_rate=0.01)}
PACKAGES = {"jax": (pj, jtext, jax_name_scope, {}),
            "torch": (pt, ttext, torch_name_scope, {"device": "cpu"})}


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


def _batches(n, seed=0, deep=DEEP):
    """bench_ctr's make_reader rows: 1..K unique wide and deep ids and a
    click, B to a batch."""
    r = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        rows = []
        for _i in range(B):
            wk, dk = r.randint(1, K + 1), r.randint(1, K + 1)
            rows.append((np.unique(r.randint(0, WIDE, wk)).tolist(),
                         np.unique(r.randint(0, deep, dk)).tolist(),
                         int(r.randint(0, 2))))
        out.append(rows)
    return out


def _cost(pkg, deep=DEEP, host_resident=False):
    mod, text, scope, _ = PACKAGES[pkg]
    with scope():
        return text.ctr_wide_deep(wide_dim=WIDE, deep_vocab=deep,
                                  emb_dim=EMB, max_ids=K, hidden=HIDDEN,
                                  host_resident=host_resident)[3]


def _init(deep=DEEP, host_resident=False):
    """JAX's init of the model, as numpy: both packages start from it."""
    topo = pj.Topology(_cost("jax", deep, host_resident))
    return {k: np.array(v) for k, v in
            topo.init_params(jax.random.PRNGKey(7)).items()}


def _trainer(pkg, init, opt="sgd", deep=DEEP, host_resident=False, **kw):
    mod, _text, _scope, dev = PACKAGES[pkg]
    params = (pj.Parameters.from_dict(init) if pkg == "jax"
              else pt.Parameters.from_numpy(init))
    return mod.SGD(_cost(pkg, deep, host_resident), params,
                   OPTS[opt](mod), **dev, **kw)


def _train(tr, batches, **kw):
    costs = []
    mod = pj if isinstance(tr, pj.SGD) else pt

    def handler(ev):
        if isinstance(ev, mod.event.EndIteration):
            costs.append(ev.cost)

    tr.train(lambda: iter(batches), num_passes=1, event_handler=handler,
             feeding=FEEDING, **kw)
    return costs


def _host_rows(tr):
    """{table: whole table} of dense stores, {table: (ids, rows)} of lazy
    ones, after every flush."""
    tr._host_rt.barrier()
    out = {}
    for p, s in tr._host_rt.tables.items():
        snap = s.dense_snapshot()
        if snap is None:
            st = s.state_dict()
            snap = (st["row_ids"], st["row_values"])
        out[p] = snap
    return out


def _close(*trainers):
    for tr in trainers:
        if tr._host_rt is not None:
            tr._host_rt.close()


# --- the row init -----------------------------------------------------------

INIT_ATTRS = {"normal": {}, "uniform": dict(initial_strategy="uniform",
                                            initial_mean=0.1,
                                            initial_std=0.3),
              "zero": dict(initial_strategy="zero"),
              "constant": dict(initial_strategy="constant",
                               initial_value=0.25)}
INIT_IDS = np.array([0, 1, 7, 12345, 50_000_000, 99_999_998, 99_999_999])


@pytest.mark.parametrize("strategy", sorted(INIT_ATTRS))
def test_make_row_init_bit_equal_to_jax(strategy):
    kw = INIT_ATTRS[strategy]
    j = jht.make_row_init(pj.attr.ParamAttr(name="_t", **kw), 16, 7,
                          "_t")(INIT_IDS, (4, 3))
    t = tht.make_row_init(pt.attr.ParamAttr(name="_t", **kw), 16, 7,
                          "_t")(INIT_IDS, (4, 3))
    assert t.dtype == j.dtype == np.float32 and t.shape == j.shape
    assert t.tobytes() == j.tobytes()
    if strategy == "normal":
        # the default std 1/sqrt(fan_in), rows distinct
        assert 0.1 < float(t.std()) < 0.5
        assert not np.array_equal(t[0], t[1])


def test_make_row_init_stable_across_hash_seeds():
    script = ("import numpy as np\n"
              "from paddle_tpu_torch.attr import ParamAttr\n"
              "from paddle_tpu_torch.host_table import make_row_init\n"
              "init = make_row_init(ParamAttr(name='_t'), 16, 7, '_t')\n"
              "print(init(np.array([0, 3, 99999983]), (4,)).tobytes().hex())"
              "\n")
    outs = set()
    for hs in ("0", "424242"):
        env = dict(os.environ, PYTHONHASHSEED=hs)
        outs.add(subprocess.check_output([sys.executable, "-c", script],
                                         env=env, cwd=REPO).strip())
    want = jht.make_row_init(pj.attr.ParamAttr(name="_t"), 16, 7, "_t")(
        np.array([0, 3, 99999983]), (4,)).tobytes().hex().encode()
    assert outs == {want}


# --- the store --------------------------------------------------------------

STORE_CALLS = [  # (step, ids): repeats, negative ids, gaps of 1 to 4
    (1, [3, 3, -1, 7, 0]), (2, [7, 9, 9, 9]), (3, [1, 3, 30, -5]),
    (7, [3, 9, 39]), (8, [0, 7, 7, 12])]


@pytest.mark.parametrize("backing", ["dense", "lazy"])
@pytest.mark.parametrize("opt", sorted(OPTS))
def test_store_apply_sparse_matches_jax(opt, backing):
    V, D = 40, 3
    r = np.random.RandomState(5)
    table = r.randn(V, D).astype(np.float32)

    def store(mod, ht):
        kw = ({"dense": table} if backing == "dense" else
              {"row_init": ht.make_row_init(mod.attr.ParamAttr(), D, 1,
                                            "_t")})
        return ht.HostRowStore("_t", (V, D), OPTS[opt](mod), lr_mult=0.5,
                               **kw)

    js, ts = store(pj, jht), store(pt, tht)
    for step, ids in STORE_CALLS:
        vals = r.randn(len(ids), D).astype(np.float32)
        js.apply_sparse(np.array(ids), vals, step)
        ts.apply_sparse(np.array(ids), vals, step)
    np.testing.assert_allclose(ts.gather(np.arange(V)),
                               js.gather(np.arange(V)), **ROW_TOL)
    assert ts.touched_rows == js.touched_rows == 8
    assert ts.version == js.version == len(STORE_CALLS)
    jd, td = js.state_dict(), ts.state_dict()
    assert sorted(td) == sorted(jd) and td["shape"] == jd["shape"]
    for k, v in jd.items():
        if isinstance(v, dict):
            assert sorted(td[k]) == sorted(v), k
            for slot, arr in v.items():
                assert np.asarray(td[k][slot]).dtype == np.asarray(arr).dtype
                np.testing.assert_allclose(td[k][slot], arr, err_msg=slot,
                                           **ROW_TOL)
        elif isinstance(v, np.ndarray):
            assert td[k].dtype == v.dtype, k
            if v.dtype.kind in "iu":
                np.testing.assert_array_equal(td[k], v, err_msg=k)
            else:
                np.testing.assert_allclose(td[k], v, err_msg=k, **ROW_TOL)


# --- training against the JAX package ---------------------------------------

@pytest.mark.parametrize("depth", [0, 2])
@pytest.mark.parametrize("opt", ["sgd", "adagrad"])
def test_host_backed_ctr_matches_jax(opt, depth):
    init, batches = _init(), _batches(6)
    runs = {}
    for pkg in PACKAGES:
        tr = _trainer(pkg, init, opt)
        runs[pkg] = (_train(tr, batches, host_tables=TABLES,
                            host_cache_rows=CACHE, pipeline_depth=depth),
                     _host_rows(tr))
        _close(tr)
    (jc, jrows), (tc, trows) = runs["jax"], runs["torch"]
    assert len(tc) == len(jc) == 6
    np.testing.assert_allclose(tc, jc, **COST_TOL)
    for p in TABLES:
        np.testing.assert_allclose(trows[p], jrows[p], err_msg=p, **ROW_TOL)
        assert not np.array_equal(trows[p], init[p]), f"{p} never moved"


def test_lazy_host_tables_match_jax():
    """``host_resident=True`` at 50,000 deep rows: no table is
    materialized, the rows come from ``make_row_init`` in both packages,
    and the runs agree; the port's step sees [cache_rows, D] tables."""
    init, batches = _init(LAZY, True), _batches(5, deep=LAZY)
    assert not set(TABLES) & set(init)
    jt = _trainer("jax", init, deep=LAZY, host_resident=True)
    tt = _trainer("torch", init, deep=LAZY, host_resident=True)
    jc = _train(jt, batches, pipeline_depth=2)
    tc = _train(tt, batches, pipeline_depth=2)
    np.testing.assert_allclose(tc, jc, **COST_TOL)
    jrows, trows = _host_rows(jt), _host_rows(tt)
    for p in TABLES:
        np.testing.assert_array_equal(trows[p][0], jrows[p][0])
        np.testing.assert_allclose(trows[p][1], jrows[p][1], err_msg=p,
                                   **ROW_TOL)
    assert len(trows["_deep_emb"][0]) > B
    # a second call reuses the runtime; the step's parameters of a host
    # table are the cache, never [V, D]
    shapes = []
    step = tt._train_step

    def spy(params, *a, **kw):
        shapes.append({p: tuple(params[p].shape) for p in TABLES})
        return step(params, *a, **kw)

    tt._train_step = spy
    rt = tt._host_rt
    _train(tt, _batches(2, seed=3, deep=LAZY), host_cache_rows=CACHE)
    assert tt._host_rt is rt
    assert shapes == [{"_deep_emb": (CACHE, EMB), "_wide_w": (CACHE, 1)}] * 2
    assert all(p not in tt._device_params() for p in TABLES)
    _close(jt, tt)


# --- the port's own equivalences ----------------------------------------------

@pytest.mark.parametrize("opt", ["sgd", "adagrad"])
def test_host_backed_equals_device_resident_bitwise(opt):
    """On the CPU the host-backed run is the device-resident one bit for
    bit: the same gathered rows, the same per-slot gradient sums, the same
    update rule on the same values (the card is held to 1e-5 / 1e-6 by
    chip_smoke.py phase 6g)."""
    init, batches = _init(), _batches(6)
    dev = _trainer("torch", init, opt)
    host = _trainer("torch", init, opt)
    dc = _train(dev, batches)
    hc = _train(host, batches, host_tables=TABLES, host_cache_rows=CACHE)
    assert hc == dc
    for p in TABLES:
        # SGD.train wrote the store's table back into the parameters
        assert torch.equal(host.parameters.get(p), dev.parameters.get(p)), p
    _close(host)


def _drains():
    from paddle_tpu_torch.observability.metrics import default_registry

    entry = default_registry.snapshot()[
        "paddle_embcache_conflict_drains_total"]
    return sum(entry["series"].values())


def test_exact_staleness_depth2_equals_depth1():
    """bench_ctr's rows share wide ids from batch to batch, so exact mode
    drains the pipeline on a conflict, and depth 2 is depth 1 bit for
    bit."""
    init, batches = _init(), _batches(8, seed=2)
    runs = {}
    for depth in (1, 2):
        before = _drains()
        tr = _trainer("torch", init)
        runs[depth] = (_train(tr, batches, host_tables=TABLES,
                              pipeline_depth=depth), _host_rows(tr),
                       _drains() - before)
        _close(tr)
    assert runs[1][2] == 0 and runs[2][2] > 0
    assert runs[2][0] == runs[1][0]
    for p in TABLES:
        np.testing.assert_array_equal(runs[2][1][p], runs[1][1][p])


def test_async_staleness_trains():
    tr = _trainer("torch", _init())
    before = _drains()
    costs = _train(tr, _batches(5), host_tables=TABLES, pipeline_depth=3,
                   host_staleness="async")
    assert len(costs) == 5 and np.isfinite(costs).all()
    assert _drains() == before
    assert not np.array_equal(_host_rows(tr)["_deep_emb"], _init()[
        "_deep_emb"])
    _close(tr)


class _Crash(RuntimeError):
    pass


def _crash_after(n, mod):
    seen = []

    def handler(ev):
        if isinstance(ev, mod.event.EndIteration):
            seen.append(ev.cost)
            if len(seen) >= n:
                raise _Crash()
    return handler


def test_snapshot_resume_equals_unbroken(tmp_path):
    init, batches = _init(), _batches(8, seed=4)
    whole = _trainer("torch", init, "adagrad")
    want = _train(whole, batches, host_tables=TABLES, host_cache_rows=CACHE)
    snaps = str(tmp_path / "snaps")
    cut = _trainer("torch", init, "adagrad")
    with pytest.raises(_Crash):
        cut.train(lambda: iter(batches), feeding=FEEDING,
                  event_handler=_crash_after(5, pt), host_tables=TABLES,
                  host_cache_rows=CACHE, save_every_n_batches=2,
                  snapshot_dir=snaps)
    _close(cut)
    params, resume = pt.SGD.load_step_resume(snaps)
    assert resume["host_tables"] and resume["global_step"] == 4
    again = _trainer("torch", init, "adagrad")
    for name in params.names():
        again.parameters.set(name, params.get(name))
    got = _train(again, batches, host_tables=TABLES, host_cache_rows=CACHE,
                 resume_state=resume)
    assert got == want[4:]
    for p in TABLES:
        np.testing.assert_array_equal(_host_rows(again)[p],
                                      _host_rows(whole)[p])
    _close(whole, again)


def test_jax_snapshot_resumes_in_port(tmp_path):
    """A JAX step snapshot's ``host_tables`` entry (numpy arrays under the
    same keys) loads into the port's stores; with ``generator=`` (a JAX
    key cannot continue a torch.Generator) the port finishes the run as
    JAX's unbroken one does: the loaded state bit for bit, the resumed
    costs to 1e-5 relative and the rows to 1e-5 (AdaGrad's g / sqrt(accum)
    lets the packages' float32 roundings of a gradient sum part by 2.1e-6
    in 1 of the 2048 deep-table values after the 8 steps; the same-package
    resume above is exact)."""
    init, batches = _init(), _batches(8, seed=5)
    whole = _trainer("jax", init, "adagrad")
    want = _train(whole, batches, host_tables=TABLES, host_cache_rows=CACHE,
                  pipeline_depth=0)
    snaps = str(tmp_path / "snaps")
    cut = _trainer("jax", init, "adagrad")
    with pytest.raises(_Crash):
        cut.train(lambda: iter(batches), feeding=FEEDING,
                  event_handler=_crash_after(5, pj), host_tables=TABLES,
                  host_cache_rows=CACHE, save_every_n_batches=2,
                  snapshot_dir=snaps, pipeline_depth=0)
    _close(cut)
    params, resume = pt.SGD.load_step_resume(snaps)
    assert resume["host_tables"] and resume["generator"] is None
    for p, st in resume["host_tables"].items():
        store = tht.HostRowStore(p, st["shape"], OPTS["adagrad"](pt),
                                 dense=np.zeros(st["shape"], np.float32))
        store.load_state(st)
        got = store.state_dict()
        for k in ("dense", "t0"):
            np.testing.assert_array_equal(got[k], st[k])
        np.testing.assert_array_equal(got["dense_slots"]["accum"],
                                      st["dense_slots"]["accum"])
    port = _trainer("torch", init, "adagrad")
    for name in params.names():
        port.parameters.set(name, params.get(name))
    got = _train(port, batches, host_tables=TABLES, host_cache_rows=CACHE,
                 resume_state=resume, generator=torch.Generator())
    np.testing.assert_allclose(got, want[4:], **COST_TOL)
    jrows, trows = _host_rows(whole), _host_rows(port)
    for p in TABLES:
        np.testing.assert_allclose(trows[p], jrows[p], err_msg=p, atol=1e-5)
        assert torch.equal(port.parameters.get(p),
                           torch.from_numpy(trows[p])), p
    _close(whole, port)


# --- the sidecar and bundles ----------------------------------------------------

def _stores(mod, ht, V=64, D=3):
    """A dense and a lazy store of one package holding the same rows: the
    lazy one's touched rows loaded from a fixed state dict."""
    r = np.random.RandomState(9)
    dense = ht.HostRowStore("_a", (V, D), mod.optimizer.SGD(),
                            dense=r.randn(V, D).astype(np.float32))
    lazy = ht.HostRowStore("_b", (V, D), mod.optimizer.SGD())
    ids = np.array([2, 5, 6, 40, 63])
    lazy.load_state({"name": "_b", "shape": (V, D), "version": 3,
                     "scalar_slots": {}, "row_ids": ids,
                     "row_values": r.randn(len(ids), D).astype(np.float32),
                     "row_slots": {}, "row_t0": np.full(len(ids), 3)})
    return dense, lazy


def test_sidecar_bytes_equal_jax_both_ways(tmp_path):
    jstores, tstores = _stores(pj, jht), _stores(pt, tht)
    for js, ts, block_rows in zip(jstores, tstores, (16, 2)):
        jbuf, tbuf = io.BytesIO(), io.BytesIO()
        jids, jn, jblocks = jht.store_row_blocks(js, block_rows)
        tids, tn, tblocks = tht.store_row_blocks(ts, block_rows)
        jht.write_rows_sidecar(jbuf, 64, 3, jids, jblocks, jn, block_rows)
        assert tht.write_rows_sidecar(tbuf, 64, 3, tids, tblocks, tn,
                                      block_rows) == len(jbuf.getvalue())
        assert tbuf.getvalue() == jbuf.getvalue()
        for reader in (jht.read_rows_sidecar, tht.read_rows_sidecar):
            ids, rows, info = reader(tbuf.getvalue())
            assert info["n_rows"] == tn and info["block_rows"] == block_rows
    with pytest.raises(Error, match=r"block \d+ crc mismatch"):
        torn = bytearray(tbuf.getvalue())
        torn[-40] ^= 1
        tht.read_rows_sidecar(bytes(torn))
    # a bundle of the host-resident model: tables from a store, an array
    # and None, in both writers
    jtopo = pj.Topology(_cost("jax", host_resident=True))
    ttopo = pt.Topology(_cost("torch", host_resident=True))
    init = _init(host_resident=True)
    deep = jht.HostRowStore("_deep_emb", (DEEP, EMB), pj.optimizer.SGD(),
                            row_init=jht.make_row_init(
                                pj.attr.ParamAttr(), EMB, 1, "_deep_emb"))
    deep.apply_sparse(np.array([4, 100, 511]),
                      np.ones((3, EMB), np.float32), 1)
    tdeep = tht.HostRowStore("_deep_emb", (DEEP, EMB), pt.optimizer.SGD())
    tdeep.load_state(deep.state_dict())
    wide = np.linspace(-1, 1, WIDE, dtype=np.float32).reshape(WIDE, 1)
    for tables in ({"_deep_emb": deep, "_wide_w": wide},
                   {"_deep_emb": None, "_wide_w": wide}):
        ttables = {k: (tdeep if v is deep else v) for k, v in tables.items()}
        jpath, tpath = str(tmp_path / "j.ptpu"), str(tmp_path / "t.ptpu")
        with open(jpath, "wb") as f:
            jmm.write_bundle(f, jtopo, pj.Parameters.from_dict(init),
                             version=5, host_tables=tables)
        with open(tpath, "wb") as f:
            tmm.write_bundle(f, ttopo, pt.Parameters.from_numpy(init),
                             version=5, host_tables=ttables)
        assert open(tpath, "rb").read() == open(jpath, "rb").read()
    meta = jmm.verify_bundle(tpath)
    assert meta == tmm.verify_bundle(jpath)
    assert meta["host_tables"]["_deep_emb"]["rows"] == 0
    assert meta["host_tables"]["_wide_w"]["feeds"] == ["wide_ids"]
    # each package's reader on the other's rows
    jpath2 = str(tmp_path / "j2.ptpu")
    with open(jpath2, "wb") as f:
        jmm.write_bundle(f, jtopo, pj.Parameters.from_dict(init), version=6,
                         host_tables={"_deep_emb": deep, "_wide_w": wide})
    n = len(open(jpath2, "rb").read(16)[8:16])
    with open(jpath2, "rb") as f:
        f.seek(8)
        f.seek(16 + int.from_bytes(f.read(n), "little"))
        with tarfile.open(fileobj=f, mode="r") as tar:
            entries = {m.name: tar.extractfile(m).read()
                       for m in tar.getmembers()
                       if m.name.startswith("__hostrows__/")}
    ids, rows, info = tht.read_rows_sidecar(entries["__hostrows__/_deep_emb"])
    np.testing.assert_array_equal(ids, [4, 100, 511])
    np.testing.assert_array_equal(rows, deep.gather(ids))
    ids, rows, _ = tht.read_rows_sidecar(entries["__hostrows__/_wide_w"])
    assert ids is None and np.array_equal(rows, wide)
    _topo, params, tmeta = tmm.load_merged_model(jpath2)
    assert tmeta["host_tables"] == jmm.read_bundle_meta(jpath2)["host_tables"]
    assert sorted(params.names()) == sorted(init)


# --- refusals, flags and selection -----------------------------------------------

def _refusal_topology(pkg, kind):
    mod, _text, scope, _ = PACKAGES[pkg]
    L, dt, attr = mod.layer, mod.data_type, mod.attr.ParamAttr
    with scope():
        ids = L.data(name="ids", type=dt.integer_value_sequence(50))
        lab = L.data(name="lab", type=dt.integer_value(2))
        host = attr(name="_h", host_resident=True)
        if kind == "fc consumer":
            x = L.data(name="x", type=dt.dense_vector(8))
            feat = L.fc(input=x, size=4, param_attr=host)
        elif kind == "not a data layer":
            feat = L.embedding(input=L.fc(input=L.embedding(
                input=ids, size=4), size=50), size=4, param_attr=host)
        elif kind == "two host tables":
            feat = L.concat(input=[
                L.embedding(input=ids, size=4, param_attr=host),
                L.embedding(input=ids, size=4, param_attr=attr(
                    name="_h2", host_resident=True))])
        else:                                   # shared feed
            feat = L.concat(input=[
                L.embedding(input=ids, size=4, param_attr=host),
                L.embedding(input=ids, size=4)])
        out = L.fc(input=L.pooling(input=feat, pooling_type=mod.pooling.Avg())
                   if kind != "fc consumer" else feat, size=2)
        return mod.Topology(L.classification_cost(input=out, label=lab))


REFUSALS = {"fc consumer": "only embedding lookups",
            "not a data layer": "must consume a data layer directly",
            "two host tables": "feeds two host-resident tables",
            "shared feed": "is also consumed by"}


@pytest.mark.parametrize("kind", sorted(REFUSALS))
def test_topology_refusals_match_jax(kind):
    for pkg in PACKAGES:
        topo = _refusal_topology(pkg, kind)
        with pytest.raises(Exception, match=REFUSALS[kind]):
            topo.host_table_feeds(topo.host_param_names())


TRAINER_REFUSALS = {
    "global_clipping": (dict(opt=dict(gradient_clipping_threshold=1.0,
                                      global_clipping=True)),
                        NotImplementedError, "global_clipping"),
    "model_average": (dict(opt=dict(model_average="avg")),
                      NotImplementedError, "model_average"),
    "accumulation": (dict(sgd=dict(num_batches_per_send_parameter=2)),
                     NotImplementedError, "gradient accumulation"),
    "attr table off": (dict(host_resident=True, train=dict(host_tables=[])),
                       Exception, "never materialized")}


@pytest.mark.parametrize("kind", sorted(TRAINER_REFUSALS))
def test_trainer_refusals_match_jax(kind):
    spec, exc, match = TRAINER_REFUSALS[kind]
    hr = spec.get("host_resident", False)
    init = _init(host_resident=hr)
    for pkg in PACKAGES:
        mod, _text, _scope, dev = PACKAGES[pkg]
        opt_kw = dict(spec.get("opt", {}))
        if opt_kw.get("model_average"):
            opt_kw["model_average"] = mod.optimizer.ModelAverage(0.5)
        params = (pj.Parameters.from_dict(init) if pkg == "jax"
                  else pt.Parameters.from_numpy(init))
        tr = mod.SGD(_cost(pkg, host_resident=hr), params,
                     mod.optimizer.SGD(learning_rate=0.05, **opt_kw),
                     **dev, **spec.get("sgd", {}))
        kw = spec.get("train", {"host_tables": TABLES})
        with pytest.raises(exc, match=match):
            _train(tr, _batches(1), **kw)
        _close(tr)


def test_host_table_min_rows_and_cache_flags_as_jax(flags):
    jtopo, ttopo = pj.Topology(_cost("jax")), pt.Topology(_cost("torch"))
    for min_rows in (0, 100, 300, 1000):
        assert ttopo.host_param_names(min_rows) == \
            jtopo.host_param_names(min_rows)
    assert ttopo.host_param_names(300) == ["_deep_emb"]
    assert {n: FLAGS.get(n) for n in ("host_table_min_rows",
                                      "host_cache_rows", "debug_nans")} == \
        {n: JFLAGS.get(n) for n in ("host_table_min_rows",
                                    "host_cache_rows", "debug_nans")} == \
        {"host_table_min_rows": 0, "host_cache_rows": 0, "debug_nans": False}
    flags("host_table_min_rows", 300)
    flags("host_cache_rows", 2 * CACHE)
    init, batches = _init(), _batches(2)
    costs = {}
    for pkg in PACKAGES:
        tr = _trainer(pkg, init)
        costs[pkg] = _train(tr, batches, pipeline_depth=0)
        assert tuple(tr._host_tables) == ("_deep_emb",)
        assert tr._host_rt._fixed_cap == 2 * CACHE
        assert tr._host_rt.tables["_deep_emb"].touched_rows > 0
        _close(tr)
    np.testing.assert_allclose(costs["torch"], costs["jax"], **COST_TOL)


def test_fixed_cache_overflow_raises():
    for pkg in PACKAGES:
        tr = _trainer(pkg, _init())
        with pytest.raises(Exception, match="host_cache_rows=4; raise"):
            _train(tr, _batches(1), host_tables=TABLES, host_cache_rows=4)
        _close(tr)


def test_second_train_call_and_host_mode_off():
    """A second train() with the same tables reuses the runtime and takes
    the new knobs; host_tables=[] writes the tables back and trains them
    on the device (the optimizer's slots handed back), as in JAX."""
    tr = _trainer("torch", _init(), "adagrad")
    _train(tr, _batches(2), host_tables=TABLES, host_cache_rows=CACHE)
    rt = tr._host_rt
    _train(tr, _batches(2, seed=1), host_tables=TABLES,
           host_cache_rows=2 * CACHE, host_staleness="async",
           host_flush_inflight=2)
    assert tr._host_rt is rt and rt._fixed_cap == 2 * CACHE
    assert rt.staleness == "async" and rt._queue.maxsize == 2
    synced = tr.parameters.get("_deep_emb").clone()
    accum = rt.tables["_deep_emb"].dense_slot_snapshot()["accum"]
    _train(tr, _batches(2, seed=2), host_tables=[])
    assert tr._host_rt is None and not rt._worker.is_alive()
    assert not tr._static["_deep_emb"]
    assert not torch.equal(tr.parameters.get("_deep_emb"), synced)
    assert tr._opt_state["_deep_emb"]["accum"].shape == accum.shape


# --- debug_nans ---------------------------------------------------------------

def _nan_model(pkg):
    mod, _text, scope, _ = PACKAGES[pkg]
    with scope():
        x = mod.layer.data(name="x", type=mod.data_type.dense_vector(4))
        lab = mod.layer.data(name="lab", type=mod.data_type.integer_value(2))
        out = mod.layer.fc(input=x, size=2, act=mod.activation.Softmax())
        return mod.layer.classification_cost(input=out, label=lab)


@pytest.mark.parametrize("on", [False, True])
def test_debug_nans_raises_in_both_packages(flags, on):
    batch = [([1.0, float("nan"), 0.5, 0.0], 1), ([0.0, 1.0, 2.0, 3.0], 0)]
    init = {k: np.array(v) for k, v in pj.Topology(_nan_model("jax"))
            .init_params(jax.random.PRNGKey(1)).items()}
    flags("debug_nans", on)
    try:
        for pkg in PACKAGES:
            mod, _text, _scope, dev = PACKAGES[pkg]
            params = (pj.Parameters.from_dict(init) if pkg == "jax"
                      else pt.Parameters.from_numpy(init))
            tr = mod.SGD(_nan_model(pkg), params,
                         mod.optimizer.SGD(learning_rate=0.1), **dev)

            def run():
                tr.train(lambda: iter([batch]), pipeline_depth=0)

            if on:
                with pytest.raises(FloatingPointError) as err:
                    run()
                if pkg == "torch":
                    assert "global step 1" in str(err.value)
                    assert "non-finite gradient" in str(err.value)
            else:
                run()
    finally:
        jax.config.update("jax_debug_nans", False)


# --- the series and the init ------------------------------------------------------

def test_embcache_series_match_jax():
    from paddle_tpu.observability.metrics import default_registry as jreg
    from paddle_tpu_torch.observability.metrics import \
        default_registry as treg

    def series(reg):
        return {n: (e["type"], tuple(e["labelnames"]))
                for n, e in reg.snapshot().items()
                if n.startswith("paddle_embcache_")}

    assert series(treg) == series(jreg) and len(series(treg)) == 10


def test_init_skips_host_tables_and_keeps_other_models_draws():
    """A model with no host-resident table draws as it always has (each
    parameter from one generator in name order); ``host_resident=True``
    materializes neither table, keeps the draws of the parameters named
    before ``_deep_emb`` and moves those after it (the JAX package folds
    a key per parameter, so nothing moves there)."""
    from paddle_tpu_torch.initializer import init_array

    topo = pt.Topology(_cost("torch"))
    gen = torch.Generator().manual_seed(3)
    want = {n: init_array(gen, s.shape, s.attr, s.fan_in, s.dtype, s.is_bias)
            for n, s in sorted(topo.param_specs().items())}
    got = topo.init_params(torch.Generator().manual_seed(3))
    assert sorted(got) == sorted(want)
    assert all(torch.equal(got[k], want[k]) for k in want)
    lazy = pt.Topology(_cost("torch", host_resident=True)).init_params(
        torch.Generator().manual_seed(3))
    assert sorted(lazy) == sorted(set(want) - set(TABLES))
    for k in lazy:
        # (a zero bias draws nothing)
        assert torch.equal(lazy[k], want[k]) == (
            k < "_deep_emb" or not want[k].any()), k
