"""The port's fused GRU forward (paddle_tpu_torch.kernels.gru) against the
JAX package's Pallas kernel, run in interpret mode as
tests/test_gru_kernel.py runs it, and against the JAX gru_cell
recurrence; and the port's grumemory layer against the JAX layer.

Inputs are drawn with numpy and handed to both. Tolerance: rtol = atol =
2e-5, as tests/test_gru_kernel.py uses — both sides are float32 with the
same arithmetic order per step; only the order inside the two recurrent
products can differ.

The kernel itself runs only on a card: the ``cuda`` test compares it with
the plain version there and skips elsewhere.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pj
from paddle_tpu import activation as jam
from paddle_tpu.core.layer import layer_name_scope as jax_name_scope
from paddle_tpu.kernels.gru import fused_gru as jax_fused_gru
from paddle_tpu.layers.recurrent import gru_cell as jax_gru_cell
from paddle_tpu.trainer.feeder import DataFeeder as JFeeder

import paddle_tpu_torch as pt
from paddle_tpu_torch import kernels as tk
from paddle_tpu_torch.core.layer import layer_name_scope as torch_name_scope
from paddle_tpu_torch.kernels.gru import (fused_gru, fused_gru_plain,
                                          fused_gru_supported)
from paddle_tpu_torch.trainer.feeder import DataFeeder as TFeeder
from paddle_tpu_torch.utils.error import Error

TOL = dict(rtol=2e-5, atol=2e-5)


def _data(B, T, H, case, seed):
    r = np.random.RandomState(seed)
    x3 = (r.randn(B, T, 3 * H) * 0.3).astype(np.float32)
    wg = (r.randn(H, 2 * H) * 0.1).astype(np.float32)
    wc = (r.randn(H, H) * 0.1).astype(np.float32)
    b = (r.randn(3 * H) * 0.1).astype(np.float32)
    if case == "zero_bias":
        b[:] = 0
    lens = r.randint(1, T + 1, size=B)
    lens[0] = T
    mask = (np.arange(T)[None] < lens[:, None]).astype(np.float32)
    reset = None
    if case == "reset":
        reset = (r.rand(B, T) < 0.25).astype(np.float32) * mask
        reset[:, 0] = 0
    return x3, wg, wc, b, mask, reset


def _jax_scan(x3, wg, wc, b, mask, reset):
    """The JAX layer's recurrence, step by step, over gru_cell."""
    B, T, H3 = x3.shape
    H = H3 // 3
    sig, tanh = jam.resolve("sigmoid"), jam.resolve("tanh")
    h = jnp.zeros((B, H))
    hs = []
    for t in range(T):
        if reset is not None:
            h = (1.0 - reset[:, t][:, None]) * h
        hn = jax_gru_cell(jnp.asarray(x3[:, t]), h, jnp.asarray(wg),
                          jnp.asarray(wc), jnp.asarray(b), sig, tanh, H)
        m = mask[:, t][:, None]
        h = m * hn + (1 - m) * h
        hs.append(h)
    return np.stack(hs, 1)


def _plain(*arrays):
    """The port's fused_gru on CPU tensors: its plain version."""
    return fused_gru(*[None if a is None else torch.from_numpy(a)
                       for a in arrays]).numpy()


@pytest.mark.parametrize("B,T,H,case", [
    (8, 12, 128, "ragged"), (16, 7, 128, "ragged"), (8, 3, 256, "ragged"),
    (8, 12, 128, "reset"), (16, 7, 128, "zero_bias")])
def test_plain_matches_jax_kernel_and_scan(B, T, H, case):
    x3, wg, wc, b, mask, reset = _data(B, T, H, case, B * 100 + T + H)
    hs = _plain(x3, wg, wc, b, mask, reset)
    jr = None if reset is None else jnp.asarray(reset)
    hs_k = jax_fused_gru(jnp.asarray(x3), jnp.asarray(wg), jnp.asarray(wc),
                         jnp.asarray(b), jnp.asarray(mask), jr, True)
    np.testing.assert_allclose(hs, np.asarray(hs_k), **TOL)
    np.testing.assert_allclose(hs, _jax_scan(x3, wg, wc, b, mask, reset),
                               **TOL)


@pytest.mark.parametrize("case", ["ragged", "reset"])
def test_plain_matches_jax_scan_at_odd_batch(case):
    x3, wg, wc, b, mask, reset = _data(3, 9, 32, case, 5)
    np.testing.assert_allclose(_plain(x3, wg, wc, b, mask, reset),
                               _jax_scan(x3, wg, wc, b, mask, reset), **TOL)


def test_wrapper_runs_plain_version_on_cpu_without_counting():
    x3, wg, wc, b, mask, reset = _data(3, 7, 8, "reset", 0)
    args = [torch.from_numpy(a) for a in (x3, wg, wc, b, mask, reset)]
    before = tk.launches["fused_gru"]
    assert torch.equal(fused_gru(*args), fused_gru_plain(*args))
    assert tk.launches["fused_gru"] == before


@pytest.mark.parametrize("bad", ["x3_rank", "wg_shape", "wc_shape",
                                 "bias_shape", "mask_shape", "reset_shape",
                                 "empty_T"])
def test_wrapper_refuses_bad_shapes(bad):
    B, T, H = 2, 3, 4
    x3 = torch.zeros(B, T, 3 * H)
    wg, wc = torch.zeros(H, 2 * H), torch.zeros(H, H)
    b = torch.zeros(3 * H)
    mask = torch.ones(B, T)
    reset = None
    if bad == "x3_rank":
        x3 = torch.zeros(B, 3 * H)
    elif bad == "wg_shape":
        wg = torch.zeros(2 * H, H)
    elif bad == "wc_shape":
        wc = torch.zeros(H, 2 * H)
    elif bad == "bias_shape":
        b = torch.zeros(2 * H)
    elif bad == "mask_shape":
        mask = torch.ones(T, B)
    elif bad == "reset_shape":
        reset = torch.zeros(B, T + 1)
    elif bad == "empty_T":
        x3, mask = torch.zeros(B, 0, 3 * H), torch.ones(B, 0)
    with pytest.raises(Error):
        fused_gru(x3, wg, wc, b, mask, reset)


def test_support_predicate_for_hopper():
    # H/4 co-resident blocks of H x 12 floats of Wg, Wc + a 32-row tile;
    # the TPU's B % 8 and H % 128 gates do not apply
    assert fused_gru_supported(64, 512)
    assert fused_gru_supported(1, 512)
    assert fused_gru_supported(5, 128)
    assert fused_gru_supported(3, 32)
    assert fused_gru_supported(64, 644)
    assert not fused_gru_supported(64, 648)      # blocks no longer co-reside
    assert not fused_gru_supported(64, 1024)
    assert not fused_gru_supported(64, 130)      # H % 4
    assert not fused_gru_supported(0, 128)


def _gru_model(mod, reverse, act):
    words = mod.layer.data(name="words",
                           type=mod.data_type.integer_value_sequence(30))
    emb = mod.layer.embedding(input=words, size=12)
    return mod.networks.simple_gru(input=emb, size=16, name="rnn",
                                   reverse=reverse, act=act)


@pytest.mark.parametrize("reverse,act", [(False, None), (True, None),
                                         (True, "relu")])
def test_grumemory_layer_matches_jax(reverse, act):
    """grumemory through each package's feeder and forward on ragged
    lengths; relu takes the generic time loop in both."""
    with jax_name_scope():
        jout = _gru_model(pj, reverse, act)
    with torch_name_scope():
        tout = _gru_model(pt, reverse, act)
    jtopo, ttopo = pj.Topology(jout), pt.Topology(tout)
    assert sorted(jtopo.param_specs()) == sorted(ttopo.param_specs())
    r = np.random.RandomState(3)
    d = {n: (r.randn(*s.shape) * 0.3).astype(np.float32)
         for n, s in sorted(ttopo.param_specs().items())}
    lens = [1, 9, 4, 7, 2]
    batch = [(r.randint(0, 30, size=n).tolist(),) for n in lens]
    want = jtopo.forward({k: jnp.asarray(v) for k, v in d.items()},
                         JFeeder(jtopo.data_type())(batch))["rnn"]
    feeds = {k: a.to("cpu") for k, a in
             TFeeder(ttopo.data_type())(batch).items()}
    with torch.inference_mode():
        got = ttopo.forward({k: torch.from_numpy(v) for k, v in d.items()},
                            feeds)["rnn"]
    np.testing.assert_allclose(got.value.numpy(), np.asarray(want.value),
                               **TOL)
    np.testing.assert_array_equal(got.mask.numpy(), np.asarray(want.mask))


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,H,case", [(64, 100, 512, "ragged"),
                                        (5, 37, 128, "reset"),
                                        (1, 100, 512, "ragged")])
def test_kernel_matches_plain_on_card(B, T, H, case):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    x3, wg, wc, b, mask, reset = _data(B, T, H, case, 7)
    args = [None if a is None else torch.from_numpy(a).cuda()
            for a in (x3, wg, wc, b, mask, reset)]
    before = tk.launches["fused_gru"]
    hs = fused_gru(*args)
    torch.cuda.synchronize()
    assert tk.launches["fused_gru"] == before + 1
    # float32 on both sides; the sums over H run in another order
    torch.testing.assert_close(hs, fused_gru_plain(*args), rtol=1e-4,
                               atol=1e-4)
