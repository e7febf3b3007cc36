"""The port's ``quant.py`` against the JAX package's: int8 codes and scales
byte for byte (ties to even, a zero-range channel, an all-negative one,
either channel axis), bf16 bits, ``param_bytes``, ``quantizable_params``
(a parameter shared with conflicting axes stays float32), the qmeta
record, the widening back to float32 and the refusals' texts.

Everything here is exact: both packages take the same float32 steps.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import paddle_tpu as pj
from paddle_tpu import quant as jq
from paddle_tpu.core.layer import layer_name_scope as jax_name_scope
from paddle_tpu.models.text import lstm_text_classification as jax_lstm_cls

import paddle_tpu_torch as pt
from paddle_tpu_torch import quant as tq
from paddle_tpu_torch.core.layer import layer_name_scope as torch_name_scope
from paddle_tpu_torch.models.text import \
    lstm_text_classification as torch_lstm_cls


def _channels(axis):
    """[6, 5] (axis 0) or [5, 6] (axis 1) float32 whose channels along
    ``axis`` are: one of zero range, one all negative, one whose codes
    hit x.5 exactly (absmax 127, so scale 1), and three random ones."""
    a = np.random.RandomState(3).randn(6, 5).astype(np.float32)
    a[0] = 0.0
    a[1] = -np.abs(a[1]) - 0.25
    a[2] = [127.0, 2.5, -3.5, 0.5, -1.5]
    return a.T.copy() if axis == 1 else a


def _np(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


@pytest.mark.parametrize("axis", [0, 1])
def test_int8_codes_and_scales_are_jax_bytes(axis):
    a = _channels(axis)
    jcodes, jscale = jq.quantize_array_int8(a, axis)
    tcodes, tscale = tq.quantize_array_int8(torch.from_numpy(a), axis)
    assert tcodes.dtype == torch.int8 and tscale.dtype == torch.float32
    assert _np(tcodes).tobytes() == np.asarray(jcodes).tobytes()
    assert _np(tscale).tobytes() == np.asarray(jscale).tobytes()
    # the cases the data was built for: codes of channel c along axis
    codes = _np(tcodes).T if axis == 1 else _np(tcodes)
    assert not codes[0].any() and _np(tscale)[0] == 0
    assert (codes[1] < 0).all()
    assert codes[2].tolist() == [127, 2, -4, 0, -2]
    # a numpy input gives the same bytes
    ncodes, _ = tq.quantize_array_int8(a, axis)
    assert _np(ncodes).tobytes() == _np(tcodes).tobytes()
    back = tq.dequantize_array_int8(tcodes, tscale, axis)
    want = jq.dequantize_array_int8(jcodes, jscale, axis)
    assert _np(back).tobytes() == np.asarray(want).tobytes()


def test_int8_of_a_vector_scales_each_element():
    a = np.array([0.0, -2.0, 3.0], np.float32)
    for got, want in zip(tq.quantize_array_int8(a, 0),
                         jq.quantize_array_int8(a, 0)):
        assert _np(got).tobytes() == np.asarray(want).tobytes()


def test_bf16_bits_are_jax_bits():
    r = np.random.RandomState(4)
    # magnitudes over 16 decades, signed zeros and two exact ties
    a = np.concatenate([
        (r.randn(200) * 10.0 ** r.randint(-8, 8, 200)).astype(np.float32),
        np.array([0.0, -0.0, 1.0 + 2 ** -8, 1.0 + 3 * 2 ** -8], np.float32)])
    jbits = np.asarray(jnp.asarray(a).astype(jnp.bfloat16)).view(np.uint16)
    tbits = torch.from_numpy(a).to(torch.bfloat16).view(torch.int16).numpy() \
        .view(np.uint16)
    assert np.array_equal(tbits, jbits)


def _models():
    with jax_name_scope():
        jout = jax_lstm_cls(dict_dim=50, emb_dim=16, hidden=16,
                            num_layers=2)[2]
    with torch_name_scope():
        tout = torch_lstm_cls(dict_dim=50, emb_dim=16, hidden=16,
                              num_layers=2)[2]
    jt, tt = pj.Topology(jout), pt.Topology(tout)
    r = np.random.RandomState(5)
    weights = {n: (r.randn(*s.shape) * 0.3).astype(np.float32)
               for n, s in sorted(jt.param_specs().items())}
    weights["_output.w0"][:, 0] = 0.0          # a zero-range fc channel
    return jt, tt, weights


def test_layer_param_map_and_quantizable_params_match_jax():
    jt, tt, _ = _models()
    for l in jt.layers:
        assert tt.layer_param_map(l.name) == jt.layer_param_map(l.name)
    assert tq.quantizable_params(tt) == jq.quantizable_params(jt)
    assert set(tq.quantizable_params(tt)) == {
        "___embedding_0__.w0", "_lstm_cls_l0_transform.w0",
        "_lstm_cls_l1_transform.w0", "_output.w0"}


def test_shared_parameter_with_conflicting_axes_stays_f32():
    """An embedding table shared with an fc weight of the same shape wants
    axis 0 and axis 1: neither package quantizes it."""
    from paddle_tpu import attr as jattr, data_type as jdt, layer as jl
    from paddle_tpu_torch import attr as tattr, data_type as tdt, \
        layer as tl

    def build(layer, data_type, attr, scope):
        with scope():
            ids = layer.data(name="ids",
                             type=data_type.integer_value_sequence(8))
            dense = layer.data(name="dense", type=data_type.dense_vector(8))
            emb = layer.embedding(input=ids, size=4,
                                  param_attr=attr.ParamAttr(name="shared"))
            fc = layer.fc(input=dense, size=4,
                          param_attr=attr.ParamAttr(name="shared"))
            out = layer.fc(input=[layer.pooling(input=emb), fc], size=2)
        return out

    jt = pj.Topology(build(jl, jdt, jattr, jax_name_scope))
    tt = pt.Topology(build(tl, tdt, tattr, torch_name_scope))
    assert tq.quantizable_params(tt) == jq.quantizable_params(jt)
    assert "shared" not in tq.quantizable_params(tt)


@pytest.mark.parametrize("mode", ["bf16", "int8"])
def test_quantize_params_matches_jax(mode):
    jt, tt, weights = _models()
    jd, jmeta = jq.quantize_params(jt, dict(weights), mode)
    td, tmeta = tq.quantize_params(
        tt, {k: torch.from_numpy(v) for k, v in weights.items()}, mode)
    assert tmeta == jmeta
    assert list(td) == list(jd)
    for name in jd:
        want = np.asarray(jd[name])
        got = td[name]
        assert tq.dtype_tag(got) == jq.dtype_tag(want), name
        assert got.shape == want.shape, name
        assert got.contiguous().view(torch.uint8).numpy().tobytes() == \
            want.tobytes(), name
    assert tq.param_bytes(td) == jq.param_bytes(jd)
    assert tq.param_bytes(weights) == jq.param_bytes(weights)
    jback = jq.dequantize_params(jd, jmeta)
    tback = tq.dequantize_params(td, tmeta)
    assert list(tback) == list(jback)
    for name in jback:
        assert tback[name].dtype == torch.float32
        assert tback[name].numpy().tobytes() == \
            np.asarray(jback[name], np.float32).tobytes(), name
    assert tq.dequantize_params(td, None).keys() == td.keys()


def test_refusals_match_jax():
    from paddle_tpu import data_type as jdt, layer as jl
    from paddle_tpu_torch import data_type as tdt, layer as tl

    def build(layer, data_type, scope):
        with scope():
            x = layer.data(name="x",
                           type=data_type.dense_vector_sequence(16))
            return layer.lstmemory(input=x)

    jt = pj.Topology(build(jl, jdt, jax_name_scope))
    tt = pt.Topology(build(tl, tdt, torch_name_scope))
    for mode, says in (("int8", "layer kinds found: data, lstmemory"),
                       ("fp8", "unknown quantize mode 'fp8'")):
        with pytest.raises(ValueError) as jerr:
            jq.quantize_params(jt, {}, mode)
        with pytest.raises(ValueError) as terr:
            tq.quantize_params(tt, {}, mode)
        assert str(terr.value) == str(jerr.value)
        assert says in str(terr.value)
