"""The port's fused LSTM forward (paddle_tpu_torch.kernels.lstm) against
the JAX package's Pallas kernel, run in interpret mode as
tests/test_kernels.py runs it, and against the JAX lstm_cell recurrence.

Inputs are drawn with numpy and handed to both. Tolerance: rtol = atol =
1e-5 — both sides are float32 with the same arithmetic order per step;
only the order inside the [B, H] x [H, 4H] products can differ.

The kernel itself runs only on a card: the ``cuda`` test compares it with
the plain version there and skips elsewhere.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu import activation as jam
from paddle_tpu.kernels.lstm import fused_lstm as jax_fused_lstm
from paddle_tpu.layers.recurrent import lstm_cell as jax_lstm_cell

from paddle_tpu_torch import kernels as tk
from paddle_tpu_torch.kernels.lstm import (fused_lstm, fused_lstm_plain,
                                           fused_lstm_supported)
from paddle_tpu_torch.utils.error import Error

TOL = dict(rtol=1e-5, atol=1e-5)
SHAPES = [(8, 5, 128), (8, 13, 128), (3, 24, 32)]
CASES = ["ragged", "reset", "zero_bias"]


def _data(B, T, H, case, seed):
    r = np.random.RandomState(seed)
    x4 = (r.randn(B, T, 4 * H) * 0.5).astype(np.float32)
    w = (r.randn(H, 4 * H) * 0.1).astype(np.float32)
    b = (r.randn(7 * H) * 0.2).astype(np.float32)
    if case == "zero_bias":
        b[:] = 0
    lens = r.randint(1, T + 1, size=B)
    lens[0] = T
    mask = (np.arange(T)[None] < lens[:, None]).astype(np.float32)
    reset = None
    if case == "reset":
        reset = (r.rand(B, T) < 0.25).astype(np.float32) * mask
        reset[:, 0] = 0
    return x4, w, b, mask, reset


def _jax_scan(x4, w, b, mask, reset):
    """The JAX layer's recurrence, step by step, over lstm_cell."""
    B, T, H4 = x4.shape
    H = H4 // 4
    tanh = jam.resolve("tanh")
    h = jnp.zeros((B, H))
    c = jnp.zeros((B, H))
    hs, cs = [], []
    for t in range(T):
        if reset is not None:
            p = 1.0 - reset[:, t][:, None]
            h, c = p * h, p * c
        hn, cn = jax_lstm_cell(jnp.asarray(x4[:, t]), h, c, jnp.asarray(w),
                               jnp.asarray(b), tanh, tanh, H)
        m = mask[:, t][:, None]
        h = m * hn + (1 - m) * h
        c = m * cn + (1 - m) * c
        hs.append(h)
        cs.append(c)
    return np.stack(hs, 1), np.stack(cs, 1)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("B,T,H", SHAPES)
def test_plain_matches_jax_kernel_and_scan(B, T, H, case):
    x4, w, b, mask, reset = _data(B, T, H, case, B * 100 + T + H)
    t = lambda a: None if a is None else torch.from_numpy(a)
    hs, cs = fused_lstm_plain(t(x4), t(w), t(b), t(mask), t(reset))
    jr = None if reset is None else jnp.asarray(reset)
    hs_k, cs_k = jax_fused_lstm(jnp.asarray(x4), jnp.asarray(w),
                                jnp.asarray(b), jnp.asarray(mask), jr, True)
    np.testing.assert_allclose(hs.numpy(), np.asarray(hs_k), **TOL)
    np.testing.assert_allclose(cs.numpy(), np.asarray(cs_k), **TOL)
    hs_s, cs_s = _jax_scan(x4, w, b, mask, reset)
    np.testing.assert_allclose(hs.numpy(), hs_s, **TOL)
    np.testing.assert_allclose(cs.numpy(), cs_s, **TOL)


def test_wrapper_runs_plain_version_on_cpu_without_counting():
    x4, w, b, mask, reset = _data(3, 7, 8, "reset", 0)
    args = [torch.from_numpy(a) for a in (x4, w, b, mask, reset)]
    before = tk.launches["fused_lstm"]
    hs, cs = fused_lstm(*args)
    hp, cp = fused_lstm_plain(*args)
    assert torch.equal(hs, hp) and torch.equal(cs, cp)
    assert tk.launches["fused_lstm"] == before


@pytest.mark.parametrize("bad", ["x4_rank", "w_shape", "bias_shape",
                                 "mask_shape", "reset_shape", "empty_T"])
def test_wrapper_refuses_bad_shapes(bad):
    B, T, H = 2, 3, 4
    x4 = torch.zeros(B, T, 4 * H)
    w = torch.zeros(H, 4 * H)
    b = torch.zeros(7 * H)
    mask = torch.ones(B, T)
    reset = None
    if bad == "x4_rank":
        x4 = torch.zeros(B, 4 * H)
    elif bad == "w_shape":
        w = torch.zeros(4 * H, H)
    elif bad == "bias_shape":
        b = torch.zeros(4 * H)
    elif bad == "mask_shape":
        mask = torch.ones(T, B)
    elif bad == "reset_shape":
        reset = torch.zeros(B, T + 1)
    elif bad == "empty_T":
        x4, mask = torch.zeros(B, 0, 4 * H), torch.ones(B, 0)
    with pytest.raises(Error):
        fused_lstm(x4, w, b, mask, reset)


def test_support_predicate_for_hopper():
    # H/4 co-resident blocks of H x 16 floats of W + a 32-row h tile
    assert fused_lstm_supported(64, 512)
    assert fused_lstm_supported(1, 128)
    assert fused_lstm_supported(3, 32)
    assert fused_lstm_supported(64, 588)
    assert not fused_lstm_supported(64, 592)     # blocks no longer co-reside
    assert not fused_lstm_supported(64, 1280)
    assert not fused_lstm_supported(64, 130)     # H % 4
    assert not fused_lstm_supported(0, 128)


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,H,case", [(64, 100, 512, "ragged"),
                                        (5, 37, 128, "reset"),
                                        (1, 100, 512, "ragged")])
def test_kernel_matches_plain_on_card(B, T, H, case):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    x4, w, b, mask, reset = _data(B, T, H, case, 7)
    args = [None if a is None else torch.from_numpy(a).cuda()
            for a in (x4, w, b, mask, reset)]
    before = tk.launches["fused_lstm"]
    hs, cs = fused_lstm(*args)
    torch.cuda.synchronize()
    assert tk.launches["fused_lstm"] == before + 1
    hp, cp = fused_lstm_plain(*args)
    # float32 on both sides; the sums over H run in another order
    torch.testing.assert_close(hs, hp, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(cs, cp, rtol=1e-4, atol=1e-4)
