"""The port's cost ``coeff`` against the JAX package: a cost layer's
per-sample cost is scaled by its config's ``coeff`` (the JAX package's
``register_cost``, ``paddle_tpu/layers/cost.py``). Each model is built in
the JAX package, serialized, rebuilt in the port through
``topology_from_config`` and given the JAX initial parameters through
``Parameters.from_numpy``; the loss and every parameter's gradient must
agree in float32 on the CPU (rtol 1e-5, atol 1e-7: the same arithmetic,
summed in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pj
from paddle_tpu.core.layer import Layer as JLayer
from paddle_tpu.core.layer import layer_name_scope as jax_name_scope

import paddle_tpu_torch as pt
from paddle_tpu_torch.core.layer import layer_name_scope as torch_name_scope
from paddle_tpu_torch.core.parameters import Parameters as TParameters
from paddle_tpu_torch.core.topology import topology_from_config

B, D, C = 5, 8, 4
COEFFS = [0.5, 2.0, 1.0]


def _xent(m, c, name):
    """fc 8 -> 4 softmax into ``cross_entropy_cost(coeff=c)``."""
    x = m.layer.data(name="x", type=m.data_type.dense_vector(D))
    y = m.layer.data(name="y", type=m.data_type.integer_value(C))
    p = m.layer.fc(input=x, size=C, act=m.activation.Softmax(), name="fc")
    return m.layer.cross_entropy_cost(input=p, label=y, coeff=c, name=name)


def _fused_xent(m, c, name):
    """fc 8 -> 4 linear into a ``softmax_with_cross_entropy`` layer with
    ``coeff=c`` (no DSL function makes one: the layer is built
    directly)."""
    x = m.layer.data(name="x", type=m.data_type.dense_vector(D))
    y = m.layer.data(name="y", type=m.data_type.integer_value(C))
    z = m.layer.fc(input=x, size=C, act=m.activation.Linear(), name="fc")
    return JLayer("softmax_with_cross_entropy", [z, y], name=name, coeff=c)


MODELS = {"cross_entropy_cost": _xent, "softmax_with_cross_entropy":
          _fused_xent}


def _feeds(seed=0):
    r = np.random.RandomState(seed)
    return (r.randn(B, D).astype(np.float32),
            r.randint(0, C, size=(B, 1)).astype(np.int32))


@pytest.mark.parametrize("coeff", COEFFS)
@pytest.mark.parametrize("model", sorted(MODELS))
def test_cost_coeff_matches_jax(model, coeff):
    with jax_name_scope():
        jcost = MODELS[model](pj, coeff, "cost")
    jtopo = pj.Topology(jcost)
    init = {k: np.array(v) for k, v in
            jtopo.init_params(jax.random.PRNGKey(7)).items()}
    x, y = _feeds()

    jloss_fn = jtopo.loss_fn()

    def jscalar(params):
        return jloss_fn(params, {"x": jnp.asarray(x), "y": jnp.asarray(y)},
                        training=False)[0]

    jparams = {k: jnp.asarray(v) for k, v in init.items()}
    jloss, jgrads = jax.value_and_grad(jscalar)(jparams)

    ttopo = topology_from_config(jtopo.serialize())
    tparams = {k: v.clone().requires_grad_(True) for k, v in
               TParameters.from_numpy(init).as_dict().items()}
    tloss, _ = ttopo.loss_fn()(tparams, {"x": torch.from_numpy(x),
                                         "y": torch.from_numpy(y)},
                               training=False)
    tloss.backward()

    np.testing.assert_allclose(tloss.item(), float(jloss), rtol=1e-5)
    assert sorted(tparams) == sorted(jgrads)
    for k in tparams:
        np.testing.assert_allclose(tparams[k].grad.numpy(),
                                   np.asarray(jgrads[k]), rtol=1e-5,
                                   atol=1e-7, err_msg=k)

    # the loss scales with coeff: the same model at coeff 1 gives loss/c
    with jax_name_scope():
        jref = pj.Topology(MODELS[model](pj, 1.0, "cost"))
    ref = jref.loss_fn()(jparams, {"x": jnp.asarray(x), "y": jnp.asarray(y)},
                         training=False)[0]
    np.testing.assert_allclose(tloss.item(), coeff * float(ref), rtol=1e-5)


@pytest.mark.parametrize("coeff", COEFFS)
def test_cross_entropy_cost_config_matches_jax(coeff):
    """The port's own ``cross_entropy_cost(coeff=c)`` serializes to the JAX
    package's config."""
    with jax_name_scope():
        jcfg = pj.Topology(_xent(pj, coeff, "cost")).serialize()
    with torch_name_scope():
        tcfg = pt.Topology(_xent(pt, coeff, "cost")).serialize()
    assert tcfg == jcfg
    cost = next(le for le in tcfg["layers"] if le["name"] == "cost")
    assert cost["type"] == "multi-class-cross-entropy"
    assert cost["cfg"]["coeff"] == coeff
