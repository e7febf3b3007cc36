"""The port's image layers (``paddle_tpu_torch/layers/conv.py``,
``layers/norm.py``, the 4-D handling of ``layers/basic.py`` and
``layers/cost.py``, ``Inference``'s flattening) against the JAX package's.

Each model is built in both packages inside their name scopes, its
parameters drawn once with numpy from a seed and given to both; the same
numpy inputs go through ``Topology.forward`` of each. Values, and the
gradients of ``sum(out * w)`` (w a fixed random tensor of the output's
shape) with respect to every parameter and every floating feed, must
agree in float32 on the CPU within rtol 1e-5 and atol 1e-5 (the same
arithmetic summed in another order; the JAX stem convolution runs as a
space-to-depth rewrite). Max-pool inputs lie on an integer grid, so that
windows tie: under ``MAXPOOL_BWD = "sas"`` (both packages' default) the
first maximum of a window takes its gradient, under ``"eq"`` every tied
one does; both packages' switches are set with ``monkeypatch``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pj
from paddle_tpu.core.arg import Arg as JArg
from paddle_tpu.core.layer import layer_name_scope as jax_name_scope
from paddle_tpu.core.topology import Topology as JTopology
from paddle_tpu.layers import conv as jconv

import paddle_tpu_torch as pt
from paddle_tpu_torch import kernels as tkernels
from paddle_tpu_torch.core.arg import Arg as TArg
from paddle_tpu_torch.core.layer import layer_name_scope as torch_name_scope
from paddle_tpu_torch.core.parameters import Parameters as TParameters
from paddle_tpu_torch.core.topology import Topology as TTopology
from paddle_tpu_torch.layers import conv as tconv
from paddle_tpu_torch.trainer.feeder import DataFeeder
from paddle_tpu_torch.utils.error import Error

TOL = dict(rtol=1e-5, atol=1e-5)


def _both(build):
    with jax_name_scope():
        j = build(pj)
    with torch_name_scope():
        t = build(pt)
    return j, t


def _weights(topo, seed):
    """Every parameter from numpy: std 1/sqrt(fan_in), biases 0.3, the
    moving variances in [0.5, 2]."""
    r = np.random.RandomState(seed)
    out = {}
    for name, spec in sorted(topo.param_specs().items()):
        if name.endswith(".wvar"):
            v = r.uniform(0.5, 2.0, spec.shape)
        else:
            v = r.randn(*spec.shape) * (0.3 if spec.is_bias else
                                        1.0 / np.sqrt(spec.fan_in))
        out[name] = v.astype(np.float32)
    return out


def _compare(build, feeds, training=False, seed=0, grads=True):
    """Forward (and, with ``grads``, the gradients of sum(out * w)) of the
    model ``build`` makes, in both packages, on ``feeds`` {name: value or
    (value, mask)}. Returns the port's aux updates (the moving
    statistics' EMA)."""
    jout, tout = _both(build)
    jt, tt = JTopology(jout), TTopology(tout)
    weights = _weights(tt, seed)
    assert set(weights) == set(jt.param_specs())
    feeds = {k: (v if isinstance(v, tuple) else (v, None))
             for k, v in feeds.items()}
    floating = [k for k, (v, _m) in feeds.items() if v.dtype.kind == "f"]

    def jax_out(p, fvals):
        jf = {k: (JArg(fvals[k] if k in fvals else jnp.asarray(v),
                       None if m is None else jnp.asarray(m)))
              for k, (v, m) in feeds.items()}
        outs, ctx = jt.forward(p, jf, training=training,
                               rng=jax.random.PRNGKey(0), return_ctx=True)
        return outs[jout.name].value, jt.aux_updates(ctx)

    jp = {k: jnp.asarray(v) for k, v in weights.items()}
    jfv = {k: jnp.asarray(feeds[k][0]) for k in floating}
    jy, jaux = jax_out(jp, jfv)
    tp = {k: torch.from_numpy(v.copy()).requires_grad_(grads)
          for k, v in weights.items()}
    tf = {k: TArg(torch.from_numpy(v.copy()).requires_grad_(
        grads and k in floating), None if m is None else torch.from_numpy(m))
        for k, (v, m) in feeds.items()}
    touts, tctx = tt.forward(tp, tf, training=training,
                             generator=torch.Generator().manual_seed(0),
                             return_ctx=True)
    ty = touts[tout.name].value
    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(jy), **TOL)
    taux = tt.aux_updates(tctx)
    assert set(taux) == set(jaux)
    for k in jaux:
        np.testing.assert_allclose(taux[k].numpy(), np.asarray(jaux[k]),
                                   **TOL)
    if grads:
        w = np.random.RandomState(seed + 1).randn(*ty.shape).astype(
            np.float32)
        jg_p, jg_f = jax.grad(
            lambda p, f: (jax_out(p, f)[0] * w).sum(), argnums=(0, 1))(
            jp, jfv)
        (ty * torch.from_numpy(w)).sum().backward()
        for k in weights:
            got = tp[k].grad
            got = np.zeros_like(weights[k]) if got is None else got.numpy()
            np.testing.assert_allclose(got, np.asarray(jg_p[k]), **TOL,
                                       err_msg=k)
        for k in floating:
            np.testing.assert_allclose(tf[k].value.grad.numpy(),
                                       np.asarray(jg_f[k]), **TOL,
                                       err_msg=k)
    return taux


def _image(b, c, h, w, seed=0, grid=False):
    r = np.random.RandomState(seed)
    x = r.randint(0, 3, (b, c * h * w)) if grid else r.randn(b, c * h * w)
    return x.astype(np.float32)


# --- convolutions -----------------------------------------------------------

# (c, h, w, img_conv kwargs): stride, padding, rectangular windows,
# groups, per-position bias, no bias, the stem geometry (c <= 4, stride
# 2: JAX's space-to-depth path), transposed forms (3x3/p1 and the DCGAN
# 4x4/p1 geometry out = (in - 1)s + k - 2p)
CONV_CASES = {
    "3x3_s1_p1": (3, 8, 8, dict(filter_size=3, num_filters=4, padding=1)),
    "3x3_s2_p0": (5, 9, 9, dict(filter_size=3, num_filters=4, stride=2)),
    "5x3_rect": (2, 9, 11, dict(filter_size=3, filter_size_y=5,
                                num_filters=3, stride=2, stride_y=1,
                                padding=1, padding_y=2)),
    "groups": (4, 6, 6, dict(filter_size=3, num_filters=6, groups=2,
                             padding=1)),
    "per_position_bias": (3, 6, 6, dict(filter_size=3, num_filters=4,
                                        shared_biases=False)),
    "no_bias": (3, 6, 6, dict(filter_size=1, num_filters=5,
                              bias_attr=False)),
    "stem_7x7_s2_p3": (3, 16, 16, dict(filter_size=7, num_filters=8,
                                       stride=2, padding=3,
                                       bias_attr=False)),
    "stem_c4_3x3_s2_p1": (4, 8, 8, dict(filter_size=3, num_filters=5,
                                        stride=2, padding=1)),
    "transposed_3x3_s2_p1": (3, 5, 5, dict(filter_size=3, num_filters=4,
                                           stride=2, padding=1, trans=True)),
    "transposed_4x4_s2_p1": (4, 4, 4, dict(filter_size=4, num_filters=3,
                                           stride=2, padding=1, trans=True)),
}


@pytest.mark.parametrize("case", sorted(CONV_CASES))
def test_conv_matches_jax(case):
    c, h, w, kw = CONV_CASES[case]

    def build(m):
        x = m.layer.data(name="x", type=m.data_type.dense_vector(c * h * w))
        conv = m.layer.img_conv(input=x, num_channels=c, img_size=w,
                                img_size_y=h, act=m.activation.Tanh(), **kw)
        # a second conv reads the first's carried NHWC value
        return m.layer.img_conv(input=conv, filter_size=1, num_filters=2,
                                act=m.activation.Linear())

    _compare(build, {"x": _image(2, c, h, w)})


def test_conv_geometry_is_written_into_the_config():
    """Shape inference writes the resolved geometry back (the reference
    config parser's size propagation), as the JAX layer does."""
    def build(m):
        x = m.layer.data(name="x", type=m.data_type.dense_vector(3 * 8 * 8),
                         shape=(3, 8, 8))
        return m.layer.img_conv(input=x, filter_size=3, num_filters=4,
                                stride=2)

    jout, tout = _both(build)
    jt, tt = JTopology(jout), TTopology(tout)
    assert tt.info(tout).shape == jt.info(jout).shape == (4, 3, 3)
    assert tout.out_info() == tt.info(tout)
    for key in ("num_channels", "img_size_y", "img_size"):
        assert tout.cfg[key] == jout.cfg[key]
    assert tt.serialize()["layers"] == jt.serialize()["layers"]


# --- pools ------------------------------------------------------------------

# (c, h, w, img_pool kwargs): max and avg, ceil (the reference default)
# and floor, padding, exclude_mode, stride 1, rectangular windows, the
# stem geometry (3x3, stride 2, pad 1, floor, even H and W)
POOL_CASES = {
    "max_ceil": (3, 7, 7, dict(pool_size=3, stride=2)),
    "max_floor_p1": (3, 7, 9, dict(pool_size=3, stride=2, padding=1,
                                   ceil_mode=False)),
    "max_ceil_p1": (2, 8, 8, dict(pool_size=3, stride=2, padding=1)),
    "max_s1_p1": (2, 5, 5, dict(pool_size=3, stride=1, padding=1)),
    "max_rect": (2, 9, 8, dict(pool_size=2, pool_size_y=3, stride=2,
                               stride_y=1, padding_y=1)),
    "max_stem": (4, 8, 10, dict(pool_size=3, stride=2, padding=1,
                                ceil_mode=False)),
    "avg_ceil": (3, 7, 7, dict(pool_size=3, stride=2)),
    "avg_ceil_p1_exclude": (2, 8, 8, dict(pool_size=3, stride=2,
                                          padding=1)),
    "avg_ceil_p1_include": (2, 8, 8, dict(pool_size=3, stride=2, padding=1,
                                          exclude_mode=False)),
    "avg_floor_p1": (3, 7, 9, dict(pool_size=3, stride=2, padding=1,
                                   ceil_mode=False)),
    "avg_global": (4, 4, 4, dict(pool_size=4, stride=1)),
}


def _pool_model(c, h, w, kw, kind):
    def build(m):
        x = m.layer.data(name="x", type=m.data_type.dense_vector(c * h * w))
        ptype = m.pooling.Max() if kind == "max" else m.pooling.Avg()
        return m.layer.img_pool(input=x, num_channels=c, img_size=w,
                                img_size_y=h, pool_type=ptype, **kw)
    return build


# the switch is the max pool's: avg pools run under the default only
POOL_RUNS = [(case, mode) for case in sorted(POOL_CASES)
             for mode in (("sas", "eq") if case.startswith("max")
                          else ("sas",))]


@pytest.mark.parametrize("case,mode", POOL_RUNS)
def test_pool_matches_jax(case, mode, monkeypatch):
    monkeypatch.setattr(jconv, "MAXPOOL_BWD", mode)
    monkeypatch.setattr(tconv, "MAXPOOL_BWD", mode)
    c, h, w, kw = POOL_CASES[case]
    kind = case.split("_")[0]
    tkernels.reset_launch_counts()
    _compare(_pool_model(c, h, w, kw, kind), {"x": _image(2, c, h, w,
                                                         grid=True)})
    # on the CPU the stem's "eq" path runs the kernel's plain version
    assert tkernels.launches["maxpool_bwd"] == 0


def test_pool_modes_differ_on_ties(monkeypatch):
    """On an input where windows tie, "eq" credits every tied maximum and
    "sas" one: the two gradients differ, and "eq"'s sum is larger."""
    c, h, w, kw = POOL_CASES["max_stem"]
    _jout, tout = _both(_pool_model(c, h, w, kw, "max"))
    tt = TTopology(tout)
    x = _image(2, c, h, w, grid=True)
    grads = {}
    for mode in ("sas", "eq"):
        monkeypatch.setattr(tconv, "MAXPOOL_BWD", mode)
        xt = torch.from_numpy(x).requires_grad_(True)
        tt.forward({}, {"x": xt})[tout.name].value.sum().backward()
        grads[mode] = xt.grad
    assert not torch.equal(grads["sas"], grads["eq"])
    assert float(grads["eq"].sum()) > float(grads["sas"].sum())


def test_stem_pool_eq_widens_bf16(monkeypatch):
    """Under "eq" the stem geometry goes through kernels/pool.
    maxpool_3x3s2p1 in the input's dtype: since the bf16 form of its
    kernel, a bf16 input is no longer widened around it (the Function's
    saved tensor is bf16), y equals the bf16 max and dx is the float32 eq
    backward rounded once (JAX's _maxpool_eq_bwd on the same bf16
    values)."""
    monkeypatch.setattr(jconv, "MAXPOOL_BWD", "eq")
    monkeypatch.setattr(tconv, "MAXPOOL_BWD", "eq")
    c, h, w, kw = POOL_CASES["max_stem"]
    jout, tout = _both(_pool_model(c, h, w, kw, "max"))
    jt, tt = JTopology(jout), TTopology(tout)
    r = np.random.RandomState(3)
    x = (r.randint(0, 5, (2, c * h * w)) * 0.375).astype(np.float32)
    g = r.randn(2, h // 2, w // 2, c).astype(np.float32)
    xb = torch.from_numpy(x).to(torch.bfloat16).requires_grad_(True)
    y = tt.forward({}, {"x": xb})[tout.name].value
    assert y.dtype == torch.bfloat16
    seen, stack, saved = set(), [y.grad_fn], []
    while stack:
        f = stack.pop()
        if f is None or f in seen:
            continue
        seen.add(f)
        if type(f).__name__ == "_MaxPoolBackward":
            saved += [t.dtype for t in f.saved_tensors]
        stack.extend(n for n, _ in f.next_functions)
    assert saved == [torch.bfloat16]
    (y * torch.from_numpy(g).to(torch.bfloat16)).sum().backward()

    def jf(v):
        return (jt.forward({}, {"x": v})[jout.name].value
                * jnp.asarray(g, jnp.bfloat16)).sum()

    jx = jnp.asarray(x, jnp.bfloat16)
    jy = jt.forward({}, {"x": jx})[jout.name].value
    jdx = jax.grad(jf)(jx)
    np.testing.assert_array_equal(y.float().detach().numpy(),
                                  np.asarray(jy, np.float32))
    np.testing.assert_array_equal(xb.grad.float().numpy(),
                                  np.asarray(jdx, np.float32))


def test_stem_pool_eq_keeps_float64_on_the_cpu(monkeypatch):
    """A float64 CPU input at the stem geometry under "eq" is not narrowed
    to the kernel's float32: the plain eq Function runs in float64 and
    gives the kernel's plain version's dx on these exact grid values."""
    from paddle_tpu_torch.kernels.pool import maxpool_3x3s2p1_bwd_plain

    monkeypatch.setattr(tconv, "MAXPOOL_BWD", "eq")
    c, h, w, kw = POOL_CASES["max_stem"]
    _jout, tout = _both(_pool_model(c, h, w, kw, "max"))
    tt = TTopology(tout)
    x = torch.from_numpy(_image(2, c, h, w, grid=True)).double()
    x = x.reshape(2, c, h, w).permute(0, 2, 3, 1).contiguous()
    x.requires_grad_(True)
    y = tt.forward({}, {"x": TArg(x)})[tout.name].value
    g = torch.from_numpy(
        np.random.RandomState(4).randint(-4, 5, tuple(y.shape)) * 0.25)
    y.backward(g)
    assert y.dtype == x.grad.dtype == torch.float64
    torch.testing.assert_close(
        x.grad, maxpool_3x3s2p1_bwd_plain(x.detach(), g.float()).double(),
        rtol=0, atol=0)


def test_stem_pool_eq_off_the_cpu_refuses_what_the_kernel_cannot_take(
        monkeypatch):
    """Off the CPU the stem geometry under "eq" runs maxpool_bwd or
    raises: a float64 tensor (on the meta device here, which runs no
    arithmetic) is refused, naming the kernel, instead of taking the plain
    eq Function."""
    monkeypatch.setattr(tconv, "MAXPOOL_BWD", "eq")
    c, h, w, kw = POOL_CASES["max_stem"]
    _jout, tout = _both(_pool_model(c, h, w, kw, "max"))
    tt = TTopology(tout)
    x = torch.empty(2, h, w, c, dtype=torch.float64, device="meta")
    with pytest.raises(Error, match="maxpool_bwd"):
        tt.forward({}, {"x": TArg(x)})


# --- batch norm -------------------------------------------------------------

def _bn_conv(m, use_global=False):
    """conv 3 -> 4 channels (NHWC) into batch_norm."""
    x = m.layer.data(name="x", type=m.data_type.dense_vector(3 * 6 * 6))
    c = m.layer.img_conv(input=x, num_channels=3, img_size=6, filter_size=3,
                         num_filters=4, padding=1, act=m.activation.Linear(),
                         bias_attr=False)
    return m.layer.batch_norm(input=c, act=m.activation.Relu(),
                              use_global_stats=use_global,
                              moving_average_fraction=0.8)


def _bn_flat_image(m):
    """batch_norm on a flat CHW image (num_channels given): per channel."""
    x = m.layer.data(name="x", type=m.data_type.dense_vector(4 * 5 * 5))
    return m.layer.batch_norm(input=x, num_channels=4)


def _bn_vector(m):
    """batch_norm on a plain feature vector: per feature."""
    x = m.layer.data(name="x", type=m.data_type.dense_vector(7))
    return m.layer.batch_norm(input=x, act=m.activation.Tanh())


def _bn_sequence(m):
    """batch_norm on a ragged [B, T, D] sequence: mask-weighted stats."""
    x = m.layer.data(name="x", type=m.data_type.dense_vector_sequence(6))
    return m.layer.batch_norm(input=x)


def _seq_feed():
    r = np.random.RandomState(4)
    mask = np.zeros((3, 5), np.float32)
    for b, n in enumerate((5, 2, 3)):
        mask[b, :n] = 1
    # padding rows far off: they must not move the statistics
    v = r.randn(3, 5, 6).astype(np.float32) + 40 * (1 - mask)[..., None]
    return (v.astype(np.float32), mask)


BN_CASES = {
    "nhwc_train": (_bn_conv, lambda: {"x": _image(3, 3, 6, 6)}, True),
    "nhwc_infer": (_bn_conv, lambda: {"x": _image(3, 3, 6, 6)}, False),
    "nhwc_global_stats_train": (lambda m: _bn_conv(m, True),
                                lambda: {"x": _image(3, 3, 6, 6)}, True),
    "flat_image_train": (_bn_flat_image, lambda: {"x": _image(3, 4, 5, 5)},
                         True),
    "flat_image_infer": (_bn_flat_image, lambda: {"x": _image(3, 4, 5, 5)},
                         False),
    "vector_train": (_bn_vector, lambda: {"x": _image(6, 7, 1, 1)}, True),
    "sequence_train": (_bn_sequence, lambda: {"x": _seq_feed()}, True),
    "sequence_infer": (_bn_sequence, lambda: {"x": _seq_feed()}, False),
}


@pytest.mark.parametrize("case", sorted(BN_CASES))
def test_batch_norm_matches_jax(case):
    """Values, gradients and, in training, the moving statistics' EMA
    (Topology.aux_updates): none under use_global_stats or inference."""
    build, feeds, training = BN_CASES[case]
    aux = _compare(build, feeds(), training=training)
    assert bool(aux) == (training and "global" not in case)


def _w_tensors(weights):
    return {k: torch.from_numpy(v.copy()) for k, v in weights.items()}


def test_batch_norm_params_and_initial_values_match_jax():
    jout, tout = _both(_bn_conv)
    jt, tt = JTopology(jout), TTopology(tout)
    jinit = jt.init_params(jax.random.PRNGKey(0))
    tinit = tt.init_params()
    for k, spec in tt.param_specs().items():
        if k.endswith(("wmean", "wvar", "wbias", ".w0")) and "batch" in k:
            np.testing.assert_array_equal(tinit[k].numpy(),
                                          np.asarray(jinit[k]))
        assert spec.attr.is_static == k.endswith(("wmean", "wvar"))
    assert tt.static_map() == jt.static_map()


def test_cmrnorm_matches_jax():
    """img_cmrnorm after a conv (carried NHWC) and on a flat CHW input
    (num_channels and img_size given); its output is flat CHW."""
    def build(m):
        x = m.layer.data(name="x", type=m.data_type.dense_vector(6 * 5 * 5))
        n1 = m.layer.img_cmrnorm(input=x, size=3, num_channels=6, img_size=5)
        c = m.layer.img_conv(input=n1, num_channels=6, img_size=5,
                             filter_size=3, num_filters=7, padding=1)
        return m.layer.img_cmrnorm(input=c, size=5, scale=0.01, power=0.75)

    _compare(build, {"x": _image(2, 6, 5, 5) * 3})


# --- image values through the existing layers -------------------------------

def _conv(m, x, c, s, nf, name=None):
    return m.layer.img_conv(input=x, num_channels=c, img_size=s,
                            filter_size=3, num_filters=nf, padding=1,
                            act=m.activation.Linear(), name=name)


def test_fc_flattens_images_to_chw():
    def build(m):
        x = m.layer.data(name="x", type=m.data_type.dense_vector(2 * 4 * 4))
        return m.layer.fc(input=_conv(m, x, 2, 4, 3), size=5)
    _compare(build, {"x": _image(3, 2, 4, 4)})


def test_addto_all_images_and_mixed():
    """Two images stay 4-D; an image plus a flat CHW operand lifts the
    flat one (the ResNet residual), and with a bias stored flat CHW."""
    def build(m):
        x = m.layer.data(name="x", type=m.data_type.dense_vector(3 * 4 * 4))
        a, b = _conv(m, x, 3, 4, 2), _conv(m, x, 3, 4, 2)
        both = m.layer.addto(input=[a, b], act=m.activation.Relu())
        mixed = m.layer.addto(input=[both, m.layer.fc(input=x, size=32)],
                              bias_attr=m.attr.ParamAttr())
        flat_first = m.layer.addto(input=[m.layer.fc(input=x, size=32),
                                          mixed])
        return m.layer.fc(input=[mixed, flat_first], size=4)
    _compare(build, {"x": _image(2, 3, 4, 4)})


def test_concat_images_and_flat():
    """Images of one H, W concat along the channels, 4-D; an image and a
    flat operand concat flat, CHW first."""
    def build(m):
        x = m.layer.data(name="x", type=m.data_type.dense_vector(3 * 4 * 4))
        a, b = _conv(m, x, 3, 4, 2), _conv(m, x, 3, 4, 5)
        chans = m.layer.concat(input=[a, b])
        # concat's info has no shape (as in the JAX package): the pool is
        # told its geometry
        pooled = m.layer.img_pool(input=chans, pool_size=2, stride=2,
                                  num_channels=7, img_size=4,
                                  pool_type=m.pooling.Max())
        return m.layer.concat(input=[pooled, m.layer.fc(input=x, size=3)])
    _compare(build, {"x": _image(2, 3, 4, 4)})


def test_cost_flattens_images():
    """A classification cost over a 4-D conv output (nf * oh * ow
    classes) flattens it to CHW first."""
    def build(m):
        x = m.layer.data(name="x", type=m.data_type.dense_vector(2 * 3 * 3))
        y = m.layer.data(name="y", type=m.data_type.integer_value(12))
        c = m.layer.img_conv(input=x, num_channels=2, img_size=3,
                             filter_size=2, num_filters=3,
                             act=m.activation.Linear())
        return m.layer.classification_cost(input=c, label=y)
    r = np.random.RandomState(5)
    _compare(build, {"x": _image(4, 2, 3, 3),
                     "y": r.randint(0, 12, (4, 1)).astype(np.int32)})


def test_inference_flattens_images_to_chw():
    """paddle.infer of a 4-D output returns the reference's [B, C*H*W]
    rows in CHW order, as the JAX Inference does."""
    def build(m):
        x = m.layer.data(name="x", type=m.data_type.dense_vector(3 * 5 * 5))
        c = _conv(m, x, 3, 5, 4)
        return m.layer.img_pool(input=c, pool_size=2, stride=2,
                                pool_type=m.pooling.Max())
    jout, tout = _both(build)
    weights = _weights(TTopology(tout), 0)
    rows = [(row,) for row in _image(3, 3, 5, 5)]
    want = pj.infer(output_layer=jout,
                    parameters=pj.parameters.Parameters.from_dict(weights),
                    input=rows)
    got = pt.infer(output_layer=tout,
                   parameters=TParameters.from_numpy(weights), input=rows,
                   device="cpu")
    assert got.shape == (3, 4 * 3 * 3)
    np.testing.assert_allclose(got, np.asarray(want), **TOL)


def test_feeds_flat_and_nhwc_agree():
    """The DataFeeder gives flat CHW image rows; a 4-D NHWC feed (the
    bench's) of the same images gives the same output."""
    def build(m):
        x = m.layer.data(name="x", type=m.data_type.dense_vector(3 * 4 * 4))
        return m.layer.fc(input=_conv(m, x, 3, 4, 2), size=3)
    _jout, tout = _both(build)
    tt = TTopology(tout)
    params = _w_tensors(_weights(tt, 0))
    x = _image(2, 3, 4, 4)
    flat = DataFeeder(tt.data_type())([(row,) for row in x])["x"]
    assert tuple(flat.value.shape) == (2, 48)
    a = tt.forward(params, {"x": TArg(torch.from_numpy(flat.value))})
    nhwc = torch.from_numpy(x.reshape(2, 3, 4, 4).transpose(0, 2, 3, 1)
                            .copy())
    b = tt.forward(params, {"x": TArg(nhwc)})
    torch.testing.assert_close(a[tout.name].value, b[tout.name].value)


def test_dropout_layer():
    """dropout is an addto with drop_rate: identity at inference, and in
    training each kept value scaled by 1 / (1 - rate)."""
    def build(m):
        x = m.layer.data(name="x", type=m.data_type.dense_vector(64))
        return m.layer.dropout(x, 0.5)
    jout, tout = _both(build)
    assert (tout.type, tout.extra.drop_rate) == (jout.type,
                                                 jout.extra.drop_rate)
    tt = TTopology(tout)
    x = torch.from_numpy(_image(4, 64, 1, 1) + 5.0)
    torch.testing.assert_close(tt.forward({}, {"x": x})[tout.name].value, x)
    y = tt.forward({}, {"x": x}, training=True,
                   generator=torch.Generator().manual_seed(0))[
        tout.name].value
    kept = y != 0
    assert 0 < int(kept.sum()) < y.numel()
    torch.testing.assert_close(y[kept], 2 * x[kept])


@pytest.mark.parametrize("preset", ["simple_img_conv_pool",
                                    "img_conv_bn_pool"])
def test_network_presets_match_jax(preset):
    def build(m):
        x = m.layer.data(name="x", type=m.data_type.dense_vector(3 * 8 * 8))
        f = getattr(m.networks, preset)
        return f(input=x, filter_size=3, num_filters=4, pool_size=2,
                 num_channel=3, img_size=8, conv_padding=1, pool_stride=2,
                 act=m.activation.Relu(), pool_type=m.pooling.Max(),
                 name="blk")
    _compare(build, {"x": _image(3, 3, 8, 8)}, training=True)


# --- on the card ------------------------------------------------------------

def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc (the port's CUDA kernels)")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_stem_pool_eq_launches_the_kernel_on_the_card(dtype, monkeypatch):
    """Under "eq" the stem geometry's backward on a CUDA tensor is one
    maxpool_bwd launch (bf16 widened around it), equal to the plain
    version on the card."""
    _needs_card()
    from paddle_tpu_torch.kernels.pool import maxpool_3x3s2p1_bwd_plain

    monkeypatch.setattr(tconv, "MAXPOOL_BWD", "eq")
    c, h, w, kw = POOL_CASES["max_stem"]
    _jout, tout = _both(_pool_model(c, h, w, kw, "max"))
    tt = TTopology(tout)
    x = torch.from_numpy(_image(2, c, h, w, grid=True)).cuda()
    x = x.reshape(2, c, h, w).permute(0, 2, 3, 1).contiguous().to(dtype)
    x.requires_grad_(True)
    tkernels.reset_launch_counts()
    y = tt.forward({}, {"x": TArg(x)})[tout.name].value
    g = torch.randn(y.shape, device="cuda").to(dtype)
    y.backward(g)
    torch.cuda.synchronize()
    assert tkernels.launches["maxpool_bwd"] == 1
    torch.testing.assert_close(
        x.grad, maxpool_3x3s2p1_bwd_plain(x.detach(), g), rtol=0, atol=0)


@pytest.mark.cuda
def test_stem_pool_eq_refuses_float64_on_the_card(monkeypatch):
    """A float64 CUDA input at the stem geometry under "eq" raises, naming
    maxpool_bwd (the kernel takes float32): it never runs the plain eq
    backward on the card, and launches nothing."""
    _needs_card()
    monkeypatch.setattr(tconv, "MAXPOOL_BWD", "eq")
    c, h, w, kw = POOL_CASES["max_stem"]
    _jout, tout = _both(_pool_model(c, h, w, kw, "max"))
    tt = TTopology(tout)
    x = torch.from_numpy(_image(2, c, h, w, grid=True)).double().cuda()
    x = x.reshape(2, c, h, w).permute(0, 2, 3, 1).contiguous()
    tkernels.reset_launch_counts()
    with pytest.raises(Error, match="maxpool_bwd"):
        tt.forward({}, {"x": TArg(x)})
    assert tkernels.launches["maxpool_bwd"] == 0
