"""The port's image models (``paddle_tpu_torch/models/resnet.py``,
``models/image_bench.py``) and mixed precision against the JAX package's,
on the CPU.

``resnet_cost(depth=50, img_size=32, num_classes=10)`` is built once in
both packages (a module fixture), its parameters drawn once by the port's
initializer and carried to JAX as numpy arrays.

- Inference output at B = 2 in float32: rtol 1e-5, atol 1e-5.
- Training, in float32 at B = 8: the first loss within rtol 1e-3 and the
  moving statistics' first EMA within 1e-3 of their largest value. At
  B = 2 the last stage's batch norms normalise 2 values a channel (1 x 1
  maps), and there rounding decides the output: the port's float32 loss
  is 37% off its own float64 one, JAX's float32 activations in that stage
  up to 1.4x their largest value off the float64 ones, and even the two
  packages' float64 losses differ by 1.2e-4; so no training comparison
  runs at B = 2. At B = 8 the float32 gradients of either package still
  differ from the float64 ones by 17% (JAX) and 24% (the port) of a
  parameter's largest gradient (the batch norms of the 1 x 1 stage), so
  the trajectory is compared in float64:
- 3 Momentum(0.1, 0.9) steps (bench_resnet50's optimizer) in float64 at
  B = 8 (JAX under ``jax.enable_x64``): every cost within rtol 1e-8 (the
  random labels at lr 0.1 send the loss from 2.1 to 61), every parameter
  and moving statistic within 1e-6 of its largest value (measured 1.9e-7).
- One bf16 mixed-precision step (``loss_fn(compute_dtype=bf16)`` in both)
  of a one-bottleneck ResNet (the stem, its pool, one bottleneck, the
  average pool, fc) at B = 8, 32 x 32, whose batch norms each see at
  least 128 values a channel: the loss within rtol 1e-2, the moving
  statistics within 1e-2 of their largest value, and the update of all
  learned parameters together within 8e-2 of JAX's in L2 norm. bf16 keeps
  8 bits and the two packages round in other places: measured, the port's
  update is 3.6% from JAX's, and JAX's own bf16 update 11% from its
  float32 one (41% on the stem batch norm's bias, a sum that cancels).
- ``smallnet_mnist_cifar`` (B = 4) forward and one Momentum step in
  float32: rtol 1e-5, atol 1e-5; ``alexnet`` and ``googlenet`` forward at
  B = 1: rtol 1e-4, atol 1e-5 (deeper sums).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pj
from paddle_tpu.core.layer import layer_name_scope as jax_name_scope
from paddle_tpu.core.topology import Topology as JTopology
from paddle_tpu.models import image_bench as jbench
from paddle_tpu.models import resnet as jresnet
from paddle_tpu.trainer.trainer import make_train_step as jax_step

import paddle_tpu_torch as pt
from paddle_tpu_torch.core.layer import layer_name_scope as torch_name_scope
from paddle_tpu_torch.core.parameters import Parameters as TParameters
from paddle_tpu_torch.core.topology import Topology as TTopology
from paddle_tpu_torch.flops import device_peak_flops, train_flops
from paddle_tpu_torch.models import image_bench as tbench
from paddle_tpu_torch.models import resnet as tresnet
from paddle_tpu_torch.trainer.trainer import make_train_step as torch_step

TOL = dict(rtol=1e-5, atol=1e-5)
IMG = 32
CLASSES = 10


def _both(build_jax, build_torch):
    with jax_name_scope():
        j = build_jax()
    with torch_name_scope():
        t = build_torch()
    return j, t


@pytest.fixture(scope="module")
def resnet():
    """(JAX topology, port topology, the port's cost layer, the JAX cost
    layer, the initial weights as numpy arrays)."""
    (ji, jl, jo, jc), (ti, tl, to, tc) = _both(
        lambda: jresnet.resnet_cost(50, IMG, CLASSES),
        lambda: tresnet.resnet_cost(50, IMG, CLASSES))
    jt, tt = JTopology(jc), TTopology(tc)
    weights = {k: v.numpy() for k, v in tt.init_params(
        torch.Generator().manual_seed(0)).items()}
    return dict(jt=jt, tt=tt, jc=jc, tc=tc, jo=jo, to=to, weights=weights)


def _images(B, seed):
    r = np.random.RandomState(seed)
    return (r.rand(B, 3 * IMG * IMG).astype(np.float32),
            r.randint(0, CLASSES, (B, 1)).astype(np.int32))


def _rel(a, b):
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def test_resnet50_parameters_match_jax(resnet):
    jt, tt = resnet["jt"], resnet["tt"]
    js, ts = jt.param_specs(), tt.param_specs()
    assert set(js) == set(ts)
    assert all(tuple(js[k].shape) == tuple(ts[k].shape) for k in js)
    assert tt.static_map() == jt.static_map()
    assert sum(int(np.prod(s.shape)) for s in ts.values()) == 23_581_642
    assert tt.serialize()["layers"] == jt.serialize()["layers"]
    # the initial moving statistics and scales are JAX's
    w = resnet["weights"]
    for k in ts:
        if k.endswith("_bn.w0") or k.endswith(".wvar"):
            assert (w[k] == 1).all()
        if k.endswith(".wmean") or k.endswith("_bn.wbias"):
            assert (w[k] == 0).all()


def test_resnet50_inference_matches_jax(resnet):
    """paddle.infer (the moving statistics) at B = 2 in float32, rows
    through the DataFeeder."""
    x, _y = _images(2, 0)
    rows = [(row,) for row in x]
    w = resnet["weights"]
    want = pj.infer(output_layer=resnet["jo"],
                    parameters=pj.parameters.Parameters.from_dict(w),
                    input=rows)
    got = pt.infer(output_layer=resnet["to"],
                   parameters=TParameters.from_numpy(w), input=rows,
                   device="cpu")
    assert got.shape == (2, CLASSES)
    np.testing.assert_allclose(got, np.asarray(want), **TOL)


def test_resnet50_training_loss_and_ema_match_jax_float32(resnet):
    jt, tt = resnet["jt"], resnet["tt"]
    x, y = _images(8, 1)
    w = resnet["weights"]
    jcost, (_o, jaux) = jt.loss_fn(resnet["jc"])(
        {k: jnp.asarray(v) for k, v in w.items()},
        {"image": jnp.asarray(x), "label": jnp.asarray(y)},
        rng=jax.random.PRNGKey(0))
    with torch.no_grad():
        tcost, (_o, taux) = tt.loss_fn(resnet["tc"])(
            {k: torch.from_numpy(v) for k, v in w.items()},
            {"image": torch.from_numpy(x), "label": torch.from_numpy(y)})
    assert tcost.dtype == torch.float32
    np.testing.assert_allclose(float(tcost), float(jcost), rtol=1e-3)
    assert set(taux) == set(jaux)
    assert len(taux) == 2 * 53                 # 53 batch norms, mean + var
    for k in jaux:
        assert _rel(taux[k].numpy(), np.asarray(jaux[k])) <= 1e-3, k


def test_resnet50_three_momentum_steps_match_jax_float64(resnet):
    """bench_resnet50's Momentum(0.1, 0.9), 3 steps at B = 8 on fresh
    batches: costs, parameters and moving statistics (which moved)."""
    jt, tt = resnet["jt"], resnet["tt"]
    w64 = {k: v.astype(np.float64) for k, v in resnet["weights"].items()}
    batches = [_images(8, 10 + i) for i in range(3)]
    with jax.enable_x64(True):
        opt = pj.optimizer.Momentum(learning_rate=0.1, momentum=0.9)
        step = jax_step(jt.loss_fn(resnet["jc"]), opt, jt.static_map(),
                        donate=False)
        p = {k: jnp.asarray(v) for k, v in w64.items()}
        state, jcosts = opt.init(p), []
        for i, (x, y) in enumerate(batches):
            p, state, c, _m = step(p, state, jax.random.PRNGKey(i),
                                   {"image": jnp.asarray(x, jnp.float64),
                                    "label": jnp.asarray(y)})
            jcosts.append(float(c))
        jp = {k: np.asarray(v) for k, v in p.items()}
    opt = pt.optimizer.Momentum(learning_rate=0.1, momentum=0.9)
    step = torch_step(tt.loss_fn(resnet["tc"]), opt, tt.static_map())
    p = {k: torch.from_numpy(v.copy()) for k, v in w64.items()}
    state, tcosts = opt.init(p), []
    for x, y in batches:
        p, state, c, _m = step(p, state, {
            "image": torch.from_numpy(x.astype(np.float64)),
            "label": torch.from_numpy(y)})
        tcosts.append(float(c))
    np.testing.assert_allclose(tcosts, jcosts, rtol=1e-8)
    stats = [k for k in jp if k.endswith((".wmean", ".wvar"))]
    assert len(stats) == 2 * 53
    for k, v in jp.items():
        assert p[k].dtype == torch.float64
        assert _rel(p[k].numpy(), v) <= 1e-6, k
    # the EMA reached the parameters
    assert all(np.abs(jp[k] - w64[k]).max() > 1e-3 for k in stats)


def _mini_resnet(m, res):
    """The stem (7x7/2 conv, batch norm, 3x3/2 max pool, ReLU), one
    bottleneck with its projection, the average pool and fc."""
    img = m.layer.data(name="image",
                       type=m.data_type.dense_vector(3 * IMG * IMG),
                       shape=(3, IMG, IMG))
    lab = m.layer.data(name="label", type=m.data_type.integer_value(CLASSES))
    c1 = res.conv_bn(img, 16, 7, 2, 3, False, "stem")
    p0 = m.layer.img_pool(input=c1, pool_size=3, stride=2, padding=1,
                          pool_type=m.pooling.Max(), ceil_mode=False)
    p1 = m.layer.addto(input=[p0], act=m.activation.Relu(), bias_attr=False)
    b = res.bottleneck(p1, 16, 8, 2, "blk")
    pooled = m.layer.img_pool(input=b, pool_size=4, stride=1,
                              pool_type=m.pooling.Avg())
    out = m.layer.fc(input=pooled, size=CLASSES, act=m.activation.Linear())
    return m.layer.classification_cost(input=out, label=lab)


def test_mixed_precision_step_matches_jax():
    """One SGD step with loss_fn(compute_dtype=bfloat16): float32 masters,
    bf16 compute, float32 moving statistics."""
    jc, tc = _both(lambda: _mini_resnet(pj, jresnet),
                   lambda: _mini_resnet(pt, tresnet))
    jt, tt = JTopology(jc), TTopology(tc)
    w = {k: v.numpy() for k, v in tt.init_params(
        torch.Generator().manual_seed(2)).items()}
    x, y = _images(8, 3)
    jopt = pj.optimizer.Momentum(learning_rate=0.1, momentum=0.9)
    jstep = jax_step(jt.loss_fn(jc, compute_dtype=jnp.bfloat16), jopt,
                     jt.static_map(), donate=False)
    jp0 = {k: jnp.asarray(v) for k, v in w.items()}
    jp, _s, jcost, _m = jstep(jp0, jopt.init(jp0), jax.random.PRNGKey(0),
                              {"image": jnp.asarray(x),
                               "label": jnp.asarray(y)})
    topt = pt.optimizer.Momentum(learning_rate=0.1, momentum=0.9)
    tstep = torch_step(tt.loss_fn(tc, compute_dtype=torch.bfloat16), topt,
                       tt.static_map())
    tp0 = {k: torch.from_numpy(v.copy()) for k, v in w.items()}
    tp, _s, tcost, _m = tstep(tp0, topt.init(tp0), {
        "image": torch.from_numpy(x), "label": torch.from_numpy(y)})
    np.testing.assert_allclose(float(tcost), float(jcost), rtol=1e-2)
    assert all(v.dtype == torch.float32 for v in tp.values())  # masters
    learned = [k for k in w if not k.endswith((".wmean", ".wvar"))]
    for k in w:
        if k not in learned:
            # the EMA of statistics taken in float32 from bf16 values
            assert _rel(tp[k].numpy(), np.asarray(jp[k])) <= 1e-2, k

    def update(p):
        return np.concatenate([(np.asarray(p[k]) - w[k]).ravel()
                               for k in learned])

    got, want = update({k: v.numpy() for k, v in tp.items()}), update(jp)
    assert np.linalg.norm(got - want) <= 8e-2 * np.linalg.norm(want)


def test_sgd_trains_mixed_precision():
    """SGD(mixed_precision=True).train on flat image rows: finite costs,
    float32 parameters, moving statistics moved."""
    tc = _both(lambda: None, lambda: _mini_resnet(pt, tresnet))[1]
    params = pt.parameters.create(tc)
    before = {k: v.clone() for k, v in params.as_dict().items()}
    x, y = _images(8, 4)
    rows = [(a, int(b[0])) for a, b in zip(x, y)]
    costs = []
    trainer = pt.SGD(tc, params, pt.optimizer.Momentum(
        learning_rate=0.01, momentum=0.9), mixed_precision=True,
        device="cpu")
    trainer.train(lambda: iter([rows, rows]), event_handler=lambda e:
                  costs.append(e.cost) if hasattr(e, "cost") else None)
    assert len(costs) == 2 and all(np.isfinite(costs))
    after = trainer.parameters.as_dict()
    assert all(v.dtype == torch.float32 for v in after.values())
    stats = [k for k in after if k.endswith((".wmean", ".wvar"))]
    assert stats and all(not torch.equal(after[k], before[k])
                         for k in stats)


def test_smallnet_forward_and_step_match_jax():
    (_ji, _jl, jo, jc), (_ti, _tl, to, tc) = _both(
        jbench.smallnet_mnist_cifar, tbench.smallnet_mnist_cifar)
    jt, tt = JTopology(jc), TTopology(tc)
    w = {k: v.numpy() for k, v in tt.init_params(
        torch.Generator().manual_seed(3)).items()}
    r = np.random.RandomState(5)
    x = r.rand(4, 3 * 32 * 32).astype(np.float32)
    y = r.randint(0, 10, (4, 1)).astype(np.int32)
    jouts = jt.forward({k: jnp.asarray(v) for k, v in w.items()},
                       {"image": jnp.asarray(x), "label": jnp.asarray(y)})
    touts = tt.forward({k: torch.from_numpy(v) for k, v in w.items()},
                       {"image": torch.from_numpy(x),
                        "label": torch.from_numpy(y)})
    np.testing.assert_allclose(touts[to.name].value.numpy(),
                               np.asarray(jouts[jo.name].value), **TOL)
    jopt = pj.optimizer.Momentum(learning_rate=0.01, momentum=0.9)
    jp0 = {k: jnp.asarray(v) for k, v in w.items()}
    jp, _s, jcost, _m = jax_step(jt.loss_fn(jc), jopt, jt.static_map(),
                                 donate=False)(
        jp0, jopt.init(jp0), jax.random.PRNGKey(0),
        {"image": jnp.asarray(x), "label": jnp.asarray(y)})
    topt = pt.optimizer.Momentum(learning_rate=0.01, momentum=0.9)
    tp0 = {k: torch.from_numpy(v.copy()) for k, v in w.items()}
    tp, _s, tcost, _m = torch_step(tt.loss_fn(tc), topt, tt.static_map())(
        tp0, topt.init(tp0), {"image": torch.from_numpy(x),
                              "label": torch.from_numpy(y)})
    np.testing.assert_allclose(float(tcost), float(jcost), **TOL)
    for k in w:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), **TOL,
                                   err_msg=k)


@pytest.mark.parametrize("model", ["alexnet", "googlenet"])
def test_image_bench_forward_matches_jax(model):
    (_ji, _jl, jo, jc), (_ti, _tl, to, tc) = _both(
        getattr(jbench, model), getattr(tbench, model))
    jt, tt = JTopology(jc), TTopology(tc)
    assert {k: tuple(s.shape) for k, s in tt.param_specs().items()} == \
        {k: tuple(s.shape) for k, s in jt.param_specs().items()}
    w = {k: v.numpy() for k, v in tt.init_params(
        torch.Generator().manual_seed(4)).items()}
    size = tt.info(tt.data_layers[0]).size
    x = np.random.RandomState(6).rand(1, size).astype(np.float32)
    y = np.zeros((1, 1), np.int32)
    jouts = jt.forward({k: jnp.asarray(v) for k, v in w.items()},
                       {"image": jnp.asarray(x), "label": jnp.asarray(y)})
    with torch.no_grad():
        touts = tt.forward({k: torch.from_numpy(v) for k, v in w.items()},
                           {"image": torch.from_numpy(x),
                            "label": torch.from_numpy(y)})
    np.testing.assert_allclose(touts[to.name].value.numpy(),
                               np.asarray(jouts[jo.name].value), rtol=1e-4,
                               atol=1e-5)


def test_flops_match_jax(resnet):
    """The port's flops.py counts the JAX package's FLOPs for ResNet-50,
    and knows no peak for the CPU."""
    from paddle_tpu import flops as jflops

    assert train_flops(resnet["tt"], 256) == jflops.train_flops(
        resnet["jt"], 256)
    assert device_peak_flops("cpu") is None
