"""The port's sparse-row training against the JAX package on the CPU: the
twin of tests/test_selective_sparse_grad.py and tests/test_sparse_catchup.py
(without the jaxpr and 8-device sharding tests).

- ``dedup_rows`` and ``dedup_rows_np`` (sparse_grad.py) against JAX's on
  the same fixtures: duplicates and pads, one id everywhere, an empty
  touched set, the wide-and-deep pair, random cases. Rows exact, values
  within 1e-6.
- The sparse-dW gather step (``make_train_step`` over a ``sparse_update``
  selective_fc, the JAX step with ``sparse_update=True`` beside it, so
  the sparse path is held against the sparse path): the densified
  gradients handed to the optimizer at every step and the parameters
  after 3 steps, for SGD, AdaGrad and Adam, rtol 1e-5 / atol 1e-6. The
  port's table reaches the optimizer as a SparseRowGrad; the same steps
  through ``SGD.train``.
- ``_update_sparse`` with the ``t0`` catch-up for the seven rules of
  test_sparse_catchup.py against the JAX trajectory, and the tail-caught-
  up table against the JAX dense run: rtol 3e-5 / atol 1e-6 (that file's
  tolerance).
- No [C, D] gradient: a TorchDispatchMode sees every op of the CPU step,
  and no op but the in-place row write (and the table's detach views)
  returns a [C, D] tensor; the plain gather step's control does.
- The crossover constants under the protocol, the refusals (a table two
  gathers reach, weight_transposed with sparse_update) and
  ``global_norm_clip`` over a SparseRowGrad.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode

import paddle_tpu as pj
from paddle_tpu import optimizer as jopt
from paddle_tpu.core.arg import Arg as JArg
from paddle_tpu.core.layer import layer_name_scope as jax_name_scope
from paddle_tpu.sparse_grad import SparseRowGrad as JSparse
from paddle_tpu.sparse_grad import dedup_rows as j_dedup
from paddle_tpu.sparse_grad import dedup_rows_np as j_dedup_np
from paddle_tpu.trainer.trainer import make_train_step as j_make_step
from paddle_tpu.utils.error import Error as JError

import paddle_tpu_torch as pt
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.core.arg import Arg as TArg
from paddle_tpu_torch.core.layer import layer_name_scope as torch_name_scope
from paddle_tpu_torch.layers import misc
from paddle_tpu_torch.sparse_grad import SparseRowGrad as TSparse
from paddle_tpu_torch.sparse_grad import dedup_rows as t_dedup
from paddle_tpu_torch.sparse_grad import dedup_rows_np as t_dedup_np
from paddle_tpu_torch.trainer.trainer import make_train_step as t_make_step
from paddle_tpu_torch.utils.error import Error

TOL = dict(rtol=1e-5, atol=1e-6)
CATCHUP_TOL = dict(rtol=3e-5, atol=1e-6)
PACKAGES = {"jax": (pj, jax_name_scope), "torch": (pt, torch_name_scope)}

# --- dedup_rows --------------------------------------------------------------


def _dedup_case(name):
    if name == "dups_pads":
        return (np.array([3, -1, 3, 0, 7, 3], np.int32),
                np.array([[1.], [99.], [10.], [2.], [4.], [100.]], np.float32))
    if name == "all_one_id":
        return (np.full(8, 5, np.int32),
                np.arange(16, dtype=np.float32).reshape(8, 2))
    if name == "empty_set":
        return np.full(6, -1, np.int32), np.full((6, 3), 7.0, np.float32)
    if name == "wide":
        return (np.array([7, 2, 7, -1], np.int32),
                np.array([[1.0], [2.0], [10.0], [99.0]], np.float32))
    if name == "deep":
        return (np.array([7, 7, 3], np.int32),
                np.array([[5.0, 5.0], [0.5, 0.5], [1.0, 1.0]], np.float32))
    r = np.random.RandomState(int(name.split("_")[1]))
    M, C = int(r.randint(1, 24)), int(r.randint(2, 12))
    return (r.randint(-1, C, M).astype(np.int32),
            r.randn(M, 3).astype(np.float32))


DEDUP_CASES = ["dups_pads", "all_one_id", "empty_set", "wide", "deep"] + [
    f"random_{i}" for i in range(5)]


@pytest.mark.parametrize("case", DEDUP_CASES)
def test_dedup_rows_matches_jax(case):
    """The fixed-length dedup gives JAX's rows and sums slot for slot;
    every live id once; the host twin JAX's compact result."""
    rows, vals = _dedup_case(case)
    jr, jv = j_dedup(jnp.asarray(rows), jnp.asarray(vals))
    tr, tv = t_dedup(torch.from_numpy(rows), torch.from_numpy(vals))
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    assert tr.dtype == torch.int32 and tr.shape == (rows.shape[0],)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), **TOL)
    live = tr.numpy()[tr.numpy() >= 0]
    assert len(live) == len(set(live.tolist()))
    assert set(live.tolist()) == set(rows[rows >= 0].tolist())
    ju, js = j_dedup_np(rows, vals)
    tu, ts = t_dedup_np(rows, vals)
    np.testing.assert_array_equal(tu, ju)
    assert tu.dtype == np.int64
    np.testing.assert_allclose(ts, js, **TOL)
    # the dense view of the carrier: the scatter-add of every live slot
    C = int(max(rows.max(), 0)) + 1
    dense = TSparse(torch.from_numpy(rows), torch.from_numpy(vals),
                    (C,) + vals.shape[1:]).dense()
    want = JSparse(jnp.asarray(rows), jnp.asarray(vals),
                   (C,) + vals.shape[1:]).dense()
    np.testing.assert_allclose(dense.numpy(), np.asarray(want), **TOL)


# --- the sparse-dW gather step ----------------------------------------------

C, B, K, D = 50, 4, 4, 6
OPTS = {"sgd": lambda m: m.SGD(learning_rate=0.1),
        "adagrad": lambda m: m.AdaGrad(learning_rate=0.1),
        "adam": lambda m: m.Adam(learning_rate=0.05)}
TABLE = "_sf.w0"


def _build(key, sparse=True, gather=True, C=C, D=D, transposed=False):
    """tests/test_selective_sparse_grad.py's model in either package."""
    mod, scope = PACKAGES[key]
    with scope():
        x = mod.layer.data(name="x", type=mod.data_type.dense_vector(D))
        s = mod.layer.data(name="sel", type=mod.data_type.dense_vector(K))
        lab = mod.layer.data(name="lab", type=mod.data_type.dense_vector(C))
        out = mod.layer.selective_fc(
            input=x, select=s, size=C, name="sf",
            param_attr=mod.attr.ParamAttr(sparse_update=sparse),
            pass_generation=True,          # fill 0: a square error is finite
            weight_transposed=transposed,
            gather_min_c=(1 if gather else 10 ** 9) if gather is not None
            else None)
        cost = mod.layer.square_error_cost(input=out, label=lab, name="cost")
    return mod.Topology(cost), cost


def _weights(C=C, D=D):
    topo, _ = _build("jax", C=C, D=D)
    return {k: np.array(v) for k, v in
            topo.init_params(jax.random.PRNGKey(0)).items()}


def _step_feeds(i, C=C, D=D):
    """Selections with in-row duplicates, -1 pads, id 0 and ids shared
    across rows."""
    r = np.random.RandomState(20 + i)
    if i == 0:
        sel = np.array([[1, 7, 7, -1], [0, 0, 19, 3], [5, 2, 2, 2],
                        [C - 1, 11, 30, 6]], np.int32)
    else:
        sel = r.randint(-1, C, (B, K)).astype(np.int32)
        sel[0, 1] = sel[0, 0]
        sel[2, 0] = sel[1, 3]
    return {"x": r.randn(B, D).astype(np.float32), "sel": sel,
            "lab": r.randn(B, C).astype(np.float32)}


def _record(opt, seen, densify):
    """Wrap opt.update to record the densified gradients it is handed."""
    real = opt.update

    def update(grads, *a, **kw):
        seen.append({k: densify(g) for k, g in grads.items()})
        return real(grads, *a, **kw)

    opt.update = update
    return opt


def _jax_steps(make_opt, feeds, n=3, sparse=True, gather=True):
    topo, cost = _build("jax", sparse, gather)
    seen = []
    opt = _record(make_opt(jopt), seen, lambda g: np.asarray(
        g.dense() if isinstance(g, JSparse) else g))
    params = {k: jnp.asarray(v) for k, v in _weights().items()}
    st = opt.init(params)
    step = j_make_step(topo.loss_fn(cost), opt, topo.static_map(),
                       donate=False, jit_compile=False)
    costs = []
    for i in range(n):
        f = {k: JArg(jnp.asarray(v)) for k, v in feeds[i].items()}
        params, st, c, _ = step(params, st, jax.random.PRNGKey(1), f)
        costs.append(float(c))
    return costs, {k: np.asarray(v) for k, v in params.items()}, seen


def _torch_steps(make_opt, feeds, n=3, sparse=True, gather=True):
    topo, cost = _build("torch", sparse, gather)
    seen, kinds = [], []

    def densify(g):
        kinds.append(type(g))
        return (g.dense() if isinstance(g, TSparse) else g).numpy()

    opt = _record(make_opt(topt), seen, densify)
    params = {k: torch.from_numpy(v) for k, v in _weights().items()}
    st = opt.init(params)
    step = t_make_step(topo.loss_fn(cost), opt, topo.static_map())
    costs = []
    for i in range(n):
        f = {k: TArg(torch.from_numpy(v)) for k, v in feeds[i].items()}
        params, st, c, _ = step(params, st, f)
        costs.append(float(c))
    return costs, {k: v.numpy() for k, v in params.items()}, seen, kinds


@pytest.mark.parametrize("opt", sorted(OPTS))
def test_sparse_step_matches_jax_sparse_step(opt):
    """Three sparse steps in both packages: costs, the densified gradients
    handed to the optimizer at each step, the parameters after them; the
    port hands the table over as a SparseRowGrad."""
    feeds = [_step_feeds(i) for i in range(3)]
    jc, jp, jseen = _jax_steps(OPTS[opt], feeds)
    tc, tp, tseen, _ = _torch_steps(OPTS[opt], feeds)
    np.testing.assert_allclose(tc, jc, rtol=1e-5)
    for js, ts in zip(jseen, tseen):
        assert set(ts) == set(js)
        for k in js:
            np.testing.assert_allclose(ts[k], js[k], **TOL, err_msg=k)
    assert set(tp) == set(jp)
    for k in jp:
        np.testing.assert_allclose(tp[k], jp[k], **TOL, err_msg=k)


def test_sparse_step_hands_a_sparse_row_grad():
    """The table's gradient is a SparseRowGrad whose dense view is the
    plain gather step's dense gradient; the bias's is dense. With plain
    SGD the parameters equal the plain gather step's and the dense-mask
    step's."""
    feeds = [_step_feeds(i) for i in range(3)]
    _c, sp, sseen, kinds = _torch_steps(OPTS["sgd"], feeds)
    assert kinds.count(TSparse) == 3        # the table's, once a step
    _c, gp, gseen, gkinds = _torch_steps(OPTS["sgd"], feeds, sparse=False)
    _c, dp, _s, _k = _torch_steps(OPTS["sgd"], feeds, sparse=False,
                                  gather=False)
    assert TSparse not in gkinds
    for a, b in zip(sseen, gseen):
        for k in a:
            np.testing.assert_allclose(a[k], b[k], **TOL, err_msg=k)
    for k in sp:
        np.testing.assert_allclose(sp[k], gp[k], **TOL, err_msg=k)
        np.testing.assert_allclose(sp[k], dp[k], **TOL, err_msg=k)


def _train_rows(n=3):
    rows = []
    for i in range(n):
        f = _step_feeds(i)
        rows.append([(f["x"][b], f["sel"][b].astype(np.float32), f["lab"][b])
                     for b in range(B)])
    return rows


def test_sgd_train_takes_the_sparse_path():
    """SGD.train on its own hands the optimizer a SparseRowGrad and trains
    the JAX SGD.train's parameters (Momentum with momentum, lazily)."""
    make = lambda m: m.Momentum(learning_rate=0.1, momentum=0.9)
    batches = _train_rows()
    feeding = {"x": 0, "sel": 1, "lab": 2}
    jtopo, jcost = _build("jax")
    jparams = pj.Parameters.from_dict(_weights())
    pj.SGD(cost=jcost, parameters=jparams, update_equation=make(jopt)).train(
        lambda: iter(batches), num_passes=1, feeding=feeding,
        event_handler=lambda e: None, pipeline_depth=0)
    _t, tcost = _build("torch")
    seen = []
    opt = _record(make(topt), seen, type)
    tparams = pt.Parameters.from_numpy(_weights())
    pt.SGD(cost=tcost, parameters=tparams, update_equation=opt,
           device="cpu").train(lambda: iter(batches), num_passes=1,
                               feeding=feeding, event_handler=lambda e: None)
    assert [s[TABLE] for s in seen] == [TSparse] * 3
    for k in jparams.names():
        np.testing.assert_allclose(tparams.get(k).numpy(),
                                   np.asarray(jparams.get(k)), **TOL,
                                   err_msg=k)


def test_cpu_training_leaves_the_callers_tensors_alone():
    """SGD(device="cpu").train writes the parameters back at update_from
    only, as the JAX package does: a tensor held from Parameters.get and
    the numpy array handed to Parameters.set keep their values, for the
    sparse-row table (written in place by the sparse update's index_copy_)
    and a dense parameter; the trained store equals the JAX package's."""
    batches = _train_rows()
    feeding = {"x": 0, "sel": 1, "lab": 2}
    dense = next(k for k in _weights() if k != TABLE)
    _t, tcost = _build("torch")
    tparams = pt.Parameters.from_numpy(_weights())
    handed = {k: _weights()[k] for k in (TABLE, dense)}
    for k, a in handed.items():
        tparams.set(k, a)
    held = {k: tparams.get(k) for k in handed}
    before = {k: a.copy() for k, a in handed.items()}
    trainer = pt.SGD(cost=tcost, parameters=tparams,
                     update_equation=topt.SGD(learning_rate=0.1),
                     device="cpu")
    trainer.train(lambda: iter(batches), num_passes=1, feeding=feeding,
                  event_handler=lambda e: None)
    _j, jcost = _build("jax")
    jparams = pj.Parameters.from_dict(_weights())
    pj.SGD(cost=jcost, parameters=jparams,
           update_equation=jopt.SGD(learning_rate=0.1)).train(
        lambda: iter(batches), num_passes=1, feeding=feeding,
        event_handler=lambda e: None, pipeline_depth=0)
    for k in handed:
        np.testing.assert_array_equal(handed[k], before[k], err_msg=k)
        np.testing.assert_array_equal(held[k].numpy(), before[k], err_msg=k)
        # the trainer's result is in the store, and it trained
        assert not np.array_equal(tparams.get(k).numpy(), before[k]), k
        np.testing.assert_allclose(tparams.get(k).numpy(),
                                   np.asarray(jparams.get(k)), **TOL,
                                   err_msg=k)


def test_parameters_set_keeps_a_buffer_of_its_own():
    """After set, writing into the caller's array (or tensor) leaves the
    parameter as it was. (The JAX package's jnp.asarray may share an
    aligned numpy array's memory on the CPU backend, so its side is not
    asserted here.)"""
    p = pt.Parameters()
    a = np.arange(6, dtype=np.float32).reshape(2, 3)
    p.set("w", a)
    a[0, 0] = 100.0
    assert float(p.get("w")[0, 0]) == 0.0
    t = torch.ones(3)
    p.set("b", t)
    t.add_(1.0)
    np.testing.assert_array_equal(p.get("b").numpy(), np.ones(3))


# --- the catch-up ------------------------------------------------------------

CATCHUP = {
    "momentum": lambda m: m.Momentum(momentum=0.9, learning_rate=0.05),
    "nesterov": lambda m: m.Momentum(momentum=0.9, nesterov=True,
                                     learning_rate=0.05),
    "adam": lambda m: m.Adam(learning_rate=0.01),
    "decayed_adagrad": lambda m: m.DecayedAdaGrad(rho=0.9,
                                                  learning_rate=0.05),
    "adadelta": lambda m: m.AdaDelta(rho=0.9, learning_rate=0.5),
    "rmsprop": lambda m: m.RMSProp(rho=0.9, learning_rate=0.02),
    "adamax": lambda m: m.AdaMax(learning_rate=0.01),
}


@pytest.mark.parametrize("name", sorted(CATCHUP))
def test_sparse_catchup_matches_jax(name):
    """_update_sparse with the t0 slot: the table, its slots and t0 after
    every step equal the JAX trajectory; the table caught up to the end
    equals the JAX dense run."""
    rows, dim, steps = 16, 3, 25
    r = np.random.RandomState(11)
    table0 = r.randn(rows, dim).astype(np.float32)
    stream = [(r.choice(rows, 3, replace=False),
               r.randn(3, dim).astype(np.float32)) for _ in range(steps)]

    jo = CATCHUP[name](jopt)
    jp = {"w": jnp.asarray(table0)}
    js = jo.init(jp, sparse_catchup_for=["w"])
    upd = jax.jit(lambda g, s, p: jo.update(g, s, p))
    dense_o = CATCHUP[name](jopt)
    dp = {"w": jnp.asarray(table0)}
    ds = dense_o.init(dp)
    dense_upd = jax.jit(lambda g, s, p: dense_o.update(g, s, p))

    to = CATCHUP[name](topt)
    tp = {"w": torch.from_numpy(table0.copy())}
    ts = to.init(tp, sparse_catchup_for=["w"])
    assert ts["w"]["t0"].dtype == torch.int32
    for ids, gs in stream:
        jp, js = upd({"w": JSparse(jnp.asarray(ids, jnp.int32),
                                   jnp.asarray(gs), (rows, dim))}, js, jp)
        g = np.zeros((rows, dim), np.float32)
        g[ids] = gs
        dp, ds = dense_upd({"w": jnp.asarray(g)}, ds, dp)
        tp, ts = to.update({"w": TSparse(torch.from_numpy(ids.astype(
            np.int32)), torch.from_numpy(gs), (rows, dim))}, ts, tp)
        np.testing.assert_allclose(tp["w"].numpy(), np.asarray(jp["w"]),
                                   **CATCHUP_TOL)
        for k, v in js["w"].items():
            np.testing.assert_allclose(ts["w"][k].numpy(), np.asarray(v),
                                       **CATCHUP_TOL, err_msg=k)
    # the rows untouched after their last update, caught up to the end
    slots = {k: v for k, v in ts["w"].items() if k != "t0"}
    gap = torch.clamp(steps - ts["w"]["t0"], min=0)
    got, _ = to.catch_up_rows(tp["w"], slots, gap, to.lr_fn(steps))
    np.testing.assert_allclose(got.numpy(), np.asarray(dp["w"]),
                               **CATCHUP_TOL)


@pytest.mark.parametrize("block", [1 << 25, 40])
@pytest.mark.parametrize("name", ["adam", "adamax"])
def test_replayed_catchup_matches_jax(name, block, monkeypatch):
    """Adam's and AdaMax's catch-up over gaps of 0 to 300 steps (rows
    first touched late among them) against JAX's step-by-step replay: the
    blocks of skipped steps summed on the device, one block for all
    (the default size) or many blocks that drop rows as their gaps run
    out (40 elements a block)."""
    monkeypatch.setattr(topt, "_REPLAY_BLOCK", block)
    r = np.random.RandomState(5)
    n, dim, t = 12, 3, 400.0
    gap = np.concatenate([[0, 1, 300], r.randint(0, 300, n - 3)]).astype(
        np.int32)
    p = r.randn(n, dim).astype(np.float32)
    slot2 = "v" if name == "adam" else "u"
    slots = {"m": (r.randn(n, dim) * 0.1).astype(np.float32),
             slot2: (r.rand(n, dim) * 0.01).astype(np.float32)}
    slots["m"][3] = slots[slot2][3] = 0.0       # a row never touched
    jo, to = CATCHUP[name](jopt), CATCHUP[name](topt)
    jp, js = jo.catch_up_rows(
        jnp.asarray(p), {**{k: jnp.asarray(v) for k, v in slots.items()},
                         "t": jnp.float32(t)}, jnp.asarray(gap), 0.01)
    tp, ts = to.catch_up_rows(
        torch.from_numpy(p), {**{k: torch.from_numpy(v)
                                 for k, v in slots.items()},
                              "t": torch.tensor(t)},
        torch.from_numpy(gap), 0.01)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), **CATCHUP_TOL)
    for k in slots:
        np.testing.assert_allclose(ts[k].numpy(), np.asarray(js[k]),
                                   **CATCHUP_TOL, err_msg=k)
    np.testing.assert_array_equal(tp[3].numpy(), p[3])


def test_catchup_without_t0_keeps_lazy_semantics():
    """No t0 slot: a momentum row's skipped steps are not replayed (one
    decay between its touches), as in the JAX package."""
    opt = topt.Momentum(momentum=0.9, learning_rate=0.1)
    params = {"w": torch.ones(6, 2)}
    state = opt.init(params)
    g = torch.ones(1, 2)
    for ids in ([0], [1], [1], [1], [0]):
        params, state = opt.update(
            {"w": TSparse(torch.tensor(ids, dtype=torch.int32), g, (6, 2))},
            state, params)
    np.testing.assert_allclose(state["w"]["mom"][0].numpy(),
                               np.full(2, -0.19), rtol=1e-6)
    assert "t0" not in state["w"]


def test_global_norm_clip_counts_sparse_values():
    """global_norm_clip over a SparseRowGrad and a dense gradient: the
    value block counts in the norm and is scaled, as in JAX."""
    r = np.random.RandomState(2)
    rows = np.array([3, -1, 3, 0], np.int32)
    vals = r.randn(4, 5).astype(np.float32)
    dense = r.randn(7).astype(np.float32)
    jg = jopt.global_norm_clip({"t": JSparse(jnp.asarray(rows),
                                             jnp.asarray(vals), (9, 5)),
                                "b": jnp.asarray(dense)}, 1.0)
    tg = topt.global_norm_clip({"t": TSparse(torch.from_numpy(rows),
                                             torch.from_numpy(vals), (9, 5)),
                                "b": torch.from_numpy(dense)}, 1.0)
    assert isinstance(tg["t"], TSparse) and tg["t"].shape == (9, 5)
    np.testing.assert_array_equal(tg["t"].rows.numpy(), rows)
    np.testing.assert_allclose(tg["t"].values.numpy(),
                               np.asarray(jg["t"].values), **TOL)
    np.testing.assert_allclose(tg["b"].numpy(), np.asarray(jg["b"]), **TOL)


# --- no [C, D] gradient --------------------------------------------------------

class _OpProbe(TorchDispatchMode):
    """Records (op, shape) of every tensor an op returns."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in pytree.tree_leaves(out):
            if isinstance(t, torch.Tensor):
                self.ops.append((str(func), tuple(t.shape)))
        return out


def _table_ops(sparse):
    topo, cost = _build("torch", sparse=sparse)
    opt = topt.AdaGrad(learning_rate=0.1)
    params = {k: torch.from_numpy(v) for k, v in _weights().items()}
    st = opt.init(params)
    step = t_make_step(topo.loss_fn(cost), opt, topo.static_map())
    feeds = {k: TArg(torch.from_numpy(v)) for k, v in _step_feeds(0).items()}
    with _OpProbe() as probe:
        step(params, st, feeds)
    return [op for op, shape in probe.ops if shape == (C, D)]


def test_no_dense_gradient_in_the_sparse_step():
    """Every [C, D] tensor an op of the sparse step returns is the table
    or a slot written in place by index_copy_, or the table's detach (a
    view, no new buffer): no zero buffer, no index_put, no product at the
    table's shape. The plain gather step's control builds them."""
    allowed = {"aten.index_copy_.default", "aten.detach.default"}
    sparse = _table_ops(True)
    assert "aten.index_copy_.default" in sparse
    offenders = sorted(set(sparse) - allowed)
    assert not offenders, f"[C, D] tensors in the sparse step: {offenders}"
    control = _table_ops(False)
    assert set(control) - allowed, \
        "the plain step's control built no [C, D] tensor: the probe is broken"


# --- the crossover and the refusals -------------------------------------------

BIG_C = 1 << 18


@pytest.mark.parametrize("sparse", [True, False])
def test_crossover_under_the_protocol(sparse):
    """With the protocol on and every weight sparse_update, C = 2^18 takes
    the gather path (_SELFC_GATHER_MIN_C_SPARSE) and the table trains as a
    SparseRowGrad; without sparse_update the same C stays on the dense
    path (_SELFC_GATHER_MIN_C), as in the JAX package."""
    assert misc._SELFC_GATHER_MIN_C == 1 << 21
    assert misc._SELFC_GATHER_MIN_C_SPARSE == BIG_C
    Dn = 2
    topo, cost = _build("torch", sparse=sparse, gather=None, C=BIG_C, D=Dn)
    seen = []
    opt = _record(topt.SGD(learning_rate=0.1), seen, type)
    params = topo.init_params(torch.Generator().manual_seed(0))
    r = np.random.RandomState(0)
    feeds = {"x": TArg(torch.from_numpy(r.randn(B, Dn).astype(np.float32))),
             "sel": TArg(torch.from_numpy(r.randint(0, BIG_C, (B, K))
                                          .astype(np.int32))),
             "lab": TArg(torch.zeros(B, BIG_C))}
    t_make_step(topo.loss_fn(cost), opt, topo.static_map())(
        params, opt.init(params), feeds)
    assert seen[0][TABLE] is (TSparse if sparse else torch.Tensor)


def _two_gathers(key):
    """One sparse_update table read by two selective_fc gathers."""
    mod, scope = PACKAGES[key]
    with scope():
        x = mod.layer.data(name="x", type=mod.data_type.dense_vector(D))
        s = mod.layer.data(name="sel", type=mod.data_type.dense_vector(K))
        lab = mod.layer.data(name="lab", type=mod.data_type.dense_vector(C))
        pa = mod.attr.ParamAttr(name="shared_w", sparse_update=True)
        outs = [mod.layer.selective_fc(input=x, select=s, size=C,
                                       name=f"sf{i}", param_attr=pa,
                                       bias_attr=False, pass_generation=True,
                                       gather_min_c=1) for i in range(2)]
        costs = [mod.layer.square_error_cost(input=o, label=lab,
                                             name=f"c{i}")
                 for i, o in enumerate(outs)]
    return mod.Topology(costs)


def test_refusals_match_jax():
    """A table that two gathers reach in one forward raises in both
    packages' steps; so does weight_transposed with sparse_update."""
    f = _step_feeds(0)
    w = {"shared_w": np.random.RandomState(0).randn(C, D).astype(np.float32)}
    jt = _two_gathers("jax")
    jo = jopt.SGD(learning_rate=0.1)
    jw = {k: jnp.asarray(v) for k, v in w.items()}
    with pytest.raises(JError, match="sparse param shared_w"):
        j_make_step(jt.loss_fn(), jo, jt.static_map(), donate=False,
                    jit_compile=False)(
            jw, jo.init(jw), jax.random.PRNGKey(0),
            {k: JArg(jnp.asarray(v)) for k, v in f.items()})
    tt = _two_gathers("torch")
    to = topt.SGD(learning_rate=0.1)
    tw = {k: torch.from_numpy(v) for k, v in w.items()}
    with pytest.raises(Error, match="sparse param shared_w gathered twice"):
        t_make_step(tt.loss_fn(), to, tt.static_map())(
            tw, to.init(tw), {k: TArg(torch.from_numpy(v))
                              for k, v in f.items()})
    for key, err in (("jax", JError), ("torch", Error)):
        topo, _ = _build(key, transposed=True)
        params = (topo.init_params(jax.random.PRNGKey(0)) if key == "jax"
                  else topo.init_params())
        arg = JArg if key == "jax" else TArg
        conv = jnp.asarray if key == "jax" else torch.from_numpy
        with pytest.raises(err, match="weight_transposed does not compose"):
            topo.forward(params, {k: arg(conv(v)) for k, v in f.items()})
