"""The port's sparse input kinds, ``fc``'s sparse inputs, ``resize`` and
the two models that use them against the JAX package on the CPU.

- ``DataFeeder`` for ``sparse_binary_vector`` (ids padded with -1 and cut
  at ``max_ids``), ``sparse_float_vector`` (the [B, K, 2] float32 stack of
  (id, value)) and ``dense_array``: arrays equal to the JAX feeder's; ids
  >= 2^24 of a ``sparse_value`` slot and the sparse kinds' sequence forms
  are refused (the JAX feeder fails on both too).
- ``fc`` over ``sparse_binary`` and ``sparse_value`` inputs, beside a
  dense one: outputs and gradients at rtol 1e-5 / atol 1e-6; a sparse
  sequence input is refused by both; ``gather_rows``.
- ``resize`` over [B, D] and [B, T, D] inputs.
- ``models.text.ngram_lm`` and ``ctr_wide_deep`` at small widths (the
  CTR model at tests/test_trainer_mnist.py's): the forward, and 3 steps
  through ``SGD.train`` (Adam; and SGD for the CTR model) at rtol 1e-4.
  The CTR tables carry ``sparse_update`` yet train through a dense
  gradient, as in the JAX package: no SparseRowGrad reaches the optimizer.
  ``ctr_wide_deep(host_resident=True)`` builds with JAX's parameter specs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pj
from paddle_tpu.core.arg import Arg as JArg
from paddle_tpu.core.layer import layer_name_scope as jax_name_scope
from paddle_tpu.layers.basic import gather_rows as jax_gather_rows
from paddle_tpu.models import text as jtext
from paddle_tpu.trainer.feeder import DataFeeder as JFeeder

import paddle_tpu_torch as pt
from paddle_tpu_torch.core.arg import Arg as TArg
from paddle_tpu_torch.core.layer import layer_name_scope as torch_name_scope
from paddle_tpu_torch.layers.basic import gather_rows as torch_gather_rows
from paddle_tpu_torch.models import text as ttext
from paddle_tpu_torch.sparse_grad import SparseRowGrad
from paddle_tpu_torch.trainer.feeder import DataFeeder as TFeeder
from paddle_tpu_torch.utils.error import Error

TOL = dict(rtol=1e-5, atol=1e-6)
STEP_TOL = dict(rtol=1e-4, atol=1e-6)
PACKAGES = {"jax": (pj, jax_name_scope), "torch": (pt, torch_name_scope)}


# --- the feeder --------------------------------------------------------------

def _kinds(mod):
    dt = mod.data_type
    return {"binary": dt.sparse_binary_vector(100, max_ids=4),
            "value": dt.sparse_float_vector(100, max_ids=4),
            "array": dt.dense_array(3)}


ROWS = {
    # an empty row, a row cut at max_ids, duplicates and id 0
    "binary": [[5, 9], [], [1, 2, 3, 4, 5, 6], [0, 0, 99]],
    "value": [[(5, 0.5), (9, -2.0)], [], [(i, i / 10) for i in range(6)],
              [(0, 1.0), (99, 3.25)]],
    "array": [[1.0, 2.0, 3.0], [0.0, -1.0, 0.5], [4.0, 4.0, 4.0],
              [1.5, 2.5, 3.5]],
}


@pytest.mark.parametrize("kind", sorted(ROWS))
def test_feeder_sparse_kinds_match_jax(kind):
    jt, tt = _kinds(pj)[kind], _kinds(pt)[kind]
    assert (tt.dim, tt.seq_type, tt.kind, tt.max_ids) == \
        (jt.dim, jt.seq_type, jt.kind, jt.max_ids)
    j = JFeeder([("x", jt)])([(r,) for r in ROWS[kind]])["x"]
    t = TFeeder([("x", tt)])([(r,) for r in ROWS[kind]])["x"]
    want = np.asarray(j.value)
    assert t.value.dtype == want.dtype and t.value.shape == want.shape
    np.testing.assert_array_equal(t.value, want)
    assert t.mask is None and j.mask is None
    if kind == "binary":
        assert t.value.shape == (4, 4)
        np.testing.assert_array_equal(t.value[1], [-1] * 4)
        np.testing.assert_array_equal(t.value[2], [1, 2, 3, 4])
    if kind == "value":
        assert t.value.shape == (4, 4, 2) and t.value.dtype == np.float32
        np.testing.assert_array_equal(t.value[0, :, 0], [5, 9, -1, -1])
        np.testing.assert_array_equal(t.value[0, :, 1], [0.5, -2.0, 0, 0])


def test_feeder_refuses_ids_past_float32_exactness():
    rows = [([(1 << 24, 1.0)],)]
    with pytest.raises(Error, match="2\\^24"):
        TFeeder([("x", pt.data_type.sparse_float_vector(1 << 25,
                                                        max_ids=2))])(rows)
    with pytest.raises(Exception, match="2\\^24"):
        JFeeder([("x", pj.data_type.sparse_float_vector(1 << 25,
                                                        max_ids=2))])(rows)
    # the largest exact id passes
    ok = TFeeder([("x", pt.data_type.sparse_float_vector(
        1 << 25, max_ids=2))])([([((1 << 24) - 1, 1.0)],)])["x"]
    assert int(ok.value[0, 0, 0]) == (1 << 24) - 1


@pytest.mark.parametrize("kind", [
    "sparse_binary_vector_sequence", "sparse_float_vector_sequence",
    "sparse_binary_vector_sub_sequence", "sparse_float_vector_sub_sequence"])
def test_feeder_refuses_sparse_sequences(kind):
    """Neither package has a padded format for sparse sequences: the JAX
    feeder fails on them, the port refuses them by name."""
    pair = "float" in kind
    step = [(3, 1.0)] if pair else [3]
    row = [step, step] if "sub" not in kind else [[step], [step, step]]
    with pytest.raises(Error, match="sparse sequence"):
        TFeeder([("x", getattr(pt.data_type, kind)(10, max_ids=2))])(
            [(row,)])
    with pytest.raises(Exception):
        JFeeder([("x", getattr(pj.data_type, kind)(10, max_ids=2))])([(row,)])


# --- fc over sparse inputs ---------------------------------------------------

C, K, OUT = 20, 5, 6


def _sparse_fc(key, kind):
    mod, scope = PACKAGES[key]
    dt = mod.data_type
    with scope():
        sp = mod.layer.data(name="sp", type=(
            dt.sparse_binary_vector(C, max_ids=K) if kind == "binary"
            else dt.sparse_float_vector(C, max_ids=K)))
        x = mod.layer.data(name="x", type=dt.dense_vector(3))
        out = mod.layer.fc(input=[sp, x], size=OUT,
                           act=mod.activation.Linear(), name="f")
    return mod.Topology(out), out


def _sparse_rows(kind, seed=0, B=4):
    r = np.random.RandomState(seed)
    rows = []
    for b in range(B):
        ids = r.randint(0, C, size=r.randint(0, K + 2)).tolist()
        if kind == "binary":
            rows.append((ids, r.randn(3).astype(np.float32).tolist()))
        else:
            rows.append(([(i, float(r.randn())) for i in ids],
                         r.randn(3).astype(np.float32).tolist()))
    rows[0] = ([1, 1, 7] if kind == "binary" else [(1, 2.0), (1, -0.5)],
               rows[0][1])
    return rows


@pytest.mark.parametrize("kind", ["binary", "value"])
def test_fc_sparse_inputs_match_jax(kind):
    jtopo, jout = _sparse_fc("jax", kind)
    ttopo, tout = _sparse_fc("torch", kind)
    init = {k: np.array(v) for k, v in
            jtopo.init_params(jax.random.PRNGKey(1)).items()}
    feeding = {"sp": 0, "x": 1}
    rows = _sparse_rows(kind)
    jf = JFeeder(jtopo.data_type(), feeding)(rows)
    tf = {k: a.to("cpu") for k, a in
          TFeeder(ttopo.data_type(), feeding)(rows).items()}
    w = np.random.RandomState(4).randn(4, OUT).astype(np.float32)

    def jf_loss(p):
        y = jtopo.forward(p, jf)[jout.name].value
        return (y * w).sum(), y

    (_, jy), jg = jax.value_and_grad(jf_loss, has_aux=True)(
        {k: jnp.asarray(v) for k, v in init.items()})
    params = {k: torch.from_numpy(v.copy()).requires_grad_(True)
              for k, v in init.items()}
    ty = ttopo.forward(params, tf)[tout.name].value
    (ty * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(jy), **TOL)
    for k in init:
        np.testing.assert_allclose(params[k].grad.numpy(),
                                   np.asarray(jg[k]), err_msg=k, **TOL)
    # the sparse rows: a sum of W's rows (valued), padding contributing none
    W = init["_f.w0"]
    ids = tf["sp"].value if kind == "binary" else tf["sp"].value[..., 0]
    vals = None if kind == "binary" else tf["sp"].value[..., 1]
    want = torch_gather_rows(torch.from_numpy(W), ids, vals)
    row0 = (W[1] + W[1] + W[7]) if kind == "binary" else \
        (2.0 * W[1] - 0.5 * W[1])
    np.testing.assert_allclose(want[0].numpy(), row0, **TOL)


def test_gather_rows_matches_jax():
    r = np.random.RandomState(2)
    table = r.randn(9, 4).astype(np.float32)
    ids = np.array([[0, 8, -1], [3, 3, 3], [-1, -1, -1]], np.int32)
    vals = r.randn(3, 3).astype(np.float32)
    for v in (None, vals):
        want = jax_gather_rows(jnp.asarray(table), jnp.asarray(ids),
                               None if v is None else jnp.asarray(v))
        got = torch_gather_rows(torch.from_numpy(table),
                                torch.from_numpy(ids),
                                None if v is None else torch.from_numpy(v))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert not torch_gather_rows(torch.from_numpy(table),
                                 torch.from_numpy(ids))[2].any()


def test_mixed_precision_keeps_sparse_value_ids_exact():
    """loss_fn(compute_dtype=bfloat16) leaves a sparse_value feed float32:
    its ids (here 257, 301 and 511, which bf16 rounds to 256, 300 and 512)
    select exactly their rows of the table, so the gradient reaches those
    rows and no other; the value channel is rounded to bf16 in fc."""
    ids, vals = [257, 301, 511], [0.5, -1.25, 2.0]
    assert [float(torch.tensor(float(i)).to(torch.bfloat16))
            for i in ids] != [float(i) for i in ids]
    with torch_name_scope():
        sp = pt.layer.data(name="sp", type=pt.data_type.sparse_float_vector(
            600, max_ids=4))
        out = pt.layer.fc(input=sp, size=OUT, act=pt.activation.Linear(),
                          bias_attr=False, name="f")
    topo = pt.Topology(out)
    fed = TFeeder([("sp", pt.data_type.sparse_float_vector(
        600, max_ids=4))])([(list(zip(ids, vals)),)])["sp"]
    feeds = {"sp": TArg(torch.from_numpy(fed.value))}
    (name,) = topo.param_specs()
    table = torch.randn(600, OUT, generator=torch.Generator().manual_seed(0))
    params = {name: table.clone().requires_grad_(True)}
    loss, (outs, _aux) = topo.loss_fn(compute_dtype=torch.bfloat16)(
        params, feeds)
    loss.backward()
    want = sum(table[i].to(torch.bfloat16) * torch.tensor(
        v, dtype=torch.bfloat16) for i, v in zip(ids, vals))
    torch.testing.assert_close(outs["f"].value[0].float(), want.float(),
                               rtol=1e-2, atol=1e-2)
    touched = params[name].grad.abs().sum(1).nonzero().flatten().tolist()
    assert touched == ids


def test_fc_refuses_sparse_sequence_inputs():
    """A sparse sequence data layer into fc: both packages refuse it."""
    for key in ("jax", "torch"):
        mod, scope = PACKAGES[key]
        with scope():
            sp = mod.layer.data(name="sp", type=(
                mod.data_type.sparse_binary_vector_sequence(C, max_ids=K)))
            out = mod.layer.fc(input=sp, size=OUT, name="f")
        topo = mod.Topology(out)
        ids = np.zeros((2, 3, K), np.int32)
        mask = np.ones((2, 3), np.float32)
        if key == "jax":
            p = topo.init_params(jax.random.PRNGKey(0))
            with pytest.raises(Exception, match="sparse sequence"):
                topo.forward(p, {"sp": JArg(jnp.asarray(ids),
                                            jnp.asarray(mask))})
        else:
            with pytest.raises(Error, match="sparse sequence"):
                topo.forward(topo.init_params(), {"sp": TArg(
                    torch.from_numpy(ids), torch.from_numpy(mask))})


# --- resize ------------------------------------------------------------------

@pytest.mark.parametrize("seq", [False, True])
def test_resize_matches_jax(seq):
    outs = {}
    r = np.random.RandomState(6)
    v = r.randn(3, 4, 6).astype(np.float32) if seq else \
        r.randn(3, 12).astype(np.float32)
    m = np.ones((3, 4), np.float32) if seq else None
    for key in ("jax", "torch"):
        mod, scope = PACKAGES[key]
        with scope():
            x = mod.layer.data(name="x", type=(
                mod.data_type.dense_vector_sequence(6) if seq
                else mod.data_type.dense_vector(12)))
            out = mod.layer.resize(input=x, size=4, name="rs")
        topo = mod.Topology(out)
        if key == "jax":
            a = JArg(jnp.asarray(v), None if m is None else jnp.asarray(m))
            outs[key] = np.asarray(topo.forward({}, {"x": a})["rs"].value)
        else:
            a = TArg(torch.from_numpy(v),
                     None if m is None else torch.from_numpy(m))
            got = topo.forward({}, {"x": a})["rs"]
            assert got.mask is None
            outs[key] = got.value.numpy()
    assert outs["torch"].shape == (v.size // 4, 4)
    np.testing.assert_array_equal(outs["torch"], outs["jax"])


# --- ngram_lm and ctr_wide_deep ----------------------------------------------

NGRAM = dict(dict_dim=50, emb_dim=8, hidden=16, context=4)
NGRAM_FEEDING = {f"w{i}": i for i in range(4)} | {"next_word": 4}
CTR = dict(wide_dim=500, deep_vocab=300, emb_dim=8, max_ids=8, hidden=32)
CTR_FEEDING = {"wide_ids": 0, "deep_ids": 1, "click": 2}


def _ngram_batches(n=3, B=8, seed=0):
    r = np.random.RandomState(seed)
    return [[tuple(int(i) for i in r.randint(0, NGRAM["dict_dim"], 5))
             for _ in range(B)] for _ in range(n)]


def _ctr_batches(n=3, B=16, seed=0):
    """tests/test_trainer_mnist.py's CTR stream, with rows of 1 to K ids
    (padding and the full row both occur)."""
    r = np.random.RandomState(seed)
    W, D, Kc = CTR["wide_dim"], CTR["deep_vocab"], CTR["max_ids"]
    out = []
    for _ in range(n):
        rows = []
        for _ in range(B):
            wide = sorted(r.choice(W, size=r.randint(1, Kc + 1),
                                   replace=False).tolist())
            deep = sorted(r.choice(D, size=r.randint(1, Kc + 1),
                                   replace=False).tolist())
            rows.append((wide, deep, int(sum(i < W // 2 for i in wide)
                                         > len(wide) // 2)))
        out.append(rows)
    return out


MODELS = {
    "ngram": (lambda m: m.ngram_lm(**NGRAM), NGRAM_FEEDING, _ngram_batches),
    "ctr": (lambda m: m.ctr_wide_deep(**CTR), CTR_FEEDING, _ctr_batches),
}


def _model_pair(name):
    build = MODELS[name][0]
    with jax_name_scope():
        j = build(jtext)
    with torch_name_scope():
        t = build(ttext)
    return j, t              # (inputs, label, output, cost) each


@pytest.mark.parametrize("name", sorted(MODELS))
def test_model_forward_matches_jax(name):
    (_ji, _jl, jout, jcost), (_ti, _tl, tout, tcost) = _model_pair(name)
    feeding, batches = MODELS[name][1], MODELS[name][2]()
    jtopo, ttopo = pj.Topology(jcost), pt.Topology(tcost)
    init = {k: np.array(v) for k, v in
            jtopo.init_params(jax.random.PRNGKey(3)).items()}
    assert sorted(ttopo.param_specs()) == sorted(init)
    jf = JFeeder(jtopo.data_type(), feeding)(batches[0])
    tf = {k: a.to("cpu") for k, a in
          TFeeder(ttopo.data_type(), feeding)(batches[0]).items()}
    jo = jtopo.forward({k: jnp.asarray(v) for k, v in init.items()}, jf)
    to = ttopo.forward({k: torch.from_numpy(v) for k, v in init.items()}, tf)
    for lname in (jout.name, jcost.name):
        want = np.asarray(jo[lname].value)
        got = to[lname].value.numpy()
        assert got.shape == want.shape, lname
        np.testing.assert_allclose(got, want, err_msg=lname, **TOL)
    if name == "ngram":
        # integer_value ids arrive [B, 1]: [B, 1, E] embeddings, as JAX
        emb = next(l.name for l in ttopo.layers if l.type == "embedding")
        assert tuple(to[emb].value.shape) == (8, 1, NGRAM["emb_dim"])
        assert tuple(to[jout.name].value.shape) == (8, 1, NGRAM["dict_dim"])


OPTIMIZERS = {"adam": lambda m: m.optimizer.Adam(learning_rate=5e-3),
              "sgd": lambda m: m.optimizer.SGD(learning_rate=0.05)}
RUNS = [("ngram", "adam"), ("ctr", "adam"), ("ctr", "sgd")]


@pytest.mark.parametrize("name,opt", RUNS)
def test_model_steps_match_jax(name, opt):
    (_ji, _jl, _jo, jcost), (_ti, _tl, _to, tcost) = _model_pair(name)
    feeding, batches = MODELS[name][1], MODELS[name][2]()
    init = {k: np.array(v) for k, v in
            pj.Topology(jcost).init_params(jax.random.PRNGKey(3)).items()}
    reader = lambda: iter(batches)                       # noqa: E731
    jev, tev, kinds = [], [], []
    jtr = pj.SGD(jcost, pj.Parameters.from_dict(init), OPTIMIZERS[opt](pj))
    jtr.train(reader, num_passes=1, event_handler=jev.append,
              feeding=feeding, pipeline_depth=0)
    topt = OPTIMIZERS[opt](pt)
    update = topt.update

    def record(grads, *a, **kw):
        kinds.extend(type(g) for g in grads.values())
        return update(grads, *a, **kw)

    topt.update = record
    ttr = pt.SGD(tcost, pt.Parameters.from_numpy(init), topt, device="cpu")
    ttr.train(reader, num_passes=1, event_handler=tev.append, feeding=feeding)
    jc = [e.cost for e in jev if isinstance(e, pj.event.EndIteration)]
    tc = [e.cost for e in tev if isinstance(e, pt.event.EndIteration)]
    assert len(tc) == len(jc) == 3
    np.testing.assert_allclose(tc, jc, rtol=1e-4)
    # the sparse_update tables train through a dense gradient
    assert kinds and SparseRowGrad not in kinds
    for k in init:
        got = ttr.parameters.get(k).numpy()
        np.testing.assert_allclose(got, np.asarray(jtr.parameters.get(k)),
                                   err_msg=k, **STEP_TOL)
        assert not np.array_equal(got, init[k]), f"{k} never moved"


def test_ctr_host_resident_raises():
    """``ctr_wide_deep(host_resident=True)`` builds, as JAX's does: both
    tables carry the attribute, ``host_param_names`` selects them, the
    specs equal JAX's, and ``parameters.create`` materializes neither
    (tests/test_torch_host_table.py trains it)."""
    with jax_name_scope():
        jcost = jtext.ctr_wide_deep(**CTR, host_resident=True)[3]
    with torch_name_scope():
        tcost = ttext.ctr_wide_deep(**CTR, host_resident=True)[3]
    jtopo, ttopo = pj.Topology(jcost), pt.Topology(tcost)
    assert ttopo.host_param_names() == jtopo.host_param_names() == \
        ["_deep_emb", "_wide_w"]
    assert {k: tuple(v.shape) for k, v in ttopo.param_specs().items()} == \
        {k: tuple(v.shape) for k, v in jtopo.param_specs().items()}
    params = pt.parameters.create(tcost)
    assert sorted(params.names()) == sorted(
        jtopo.init_params(jax.random.PRNGKey(0)))
    assert "_deep_emb" not in params and "_wide_w" not in params
