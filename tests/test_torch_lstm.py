"""The port's fused LSTM forward (paddle_tpu_torch.kernels.lstm) against
the JAX package's Pallas kernel, run in interpret mode as
tests/test_kernels.py runs it, and against the JAX lstm_cell recurrence.

Inputs are drawn with numpy and handed to both. Tolerance: rtol = atol =
1e-5 — both sides are float32 with the same arithmetic order per step;
only the order inside the [B, H] x [H, 4H] products can differ.

The kernel itself runs only on a card: the ``cuda`` tests compare it with
the plain version there and skip elsewhere. Its plan (``lstm_fwd_plan``:
U units and R rows a block, from the shape alone) is checked here.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu import activation as jam
from paddle_tpu.kernels.lstm import fused_lstm as jax_fused_lstm
from paddle_tpu.layers.recurrent import lstm_cell as jax_lstm_cell

from paddle_tpu_torch import kernels as tk
from paddle_tpu_torch.kernels import lstm as tl
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
    # serving's batches and a large one, by (U, R) blocks or 4-unit ones
    assert fused_lstm_supported(4096, 512)
    assert fused_lstm_supported(17, 512)
    assert fused_lstm_supported(1, 512)


# --- the forward's plan -------------------------------------------------------

# an H100's SMs and shared memory a block, which every plan must keep within
SMS, SMEM_PER_BLOCK = 132, 227 * 1024


def _parent_supported(B, H):
    """fused_lstm_supported when every block owned 4 units and staged
    every row in 32-row tiles: H/4 blocks of W's 16 columns, a 32-row tile
    of h_{t-1} and its pre-activations, two a 228 KiB SM at most 8."""
    smem = 4 * ((16 + 32) * (H + 4) + 32 * 16)
    per_sm = min(8, 228 * 1024 // (smem + 1024))
    return (B >= 1 and H >= 4 and H % 4 == 0 and smem <= SMEM_PER_BLOCK
            and H // 4 <= SMS * per_sm)


@pytest.mark.parametrize("B,H,U,R,blocks", [
    (64, 512, 16, 16, 128),     # the classifier: 32 unit x 4 row groups
    (1, 512, 16, 16, 32),       # serving's single row
    (17, 512, 16, 16, 64),
    (128, 512, 16, 32, 128),    # two 16-row tiles a block
    (1024, 512, 8, 512, 128),   # U = 16 does not hold 1024 rows' carries
    (4096, 512, 4, 0, 128),     # no (U, R) blocks fit: 4 units, every row
    (64, 100, 4, 64, 25),       # H not a multiple of 8
    (64, 588, 4, 0, 147),       # 147 unit groups of 4: two blocks an SM
])
def test_fwd_plan_picks_units_and_rows_from_the_shape(monkeypatch, B, H, U,
                                                      R, blocks):
    def no_device(*a, **k):
        raise AssertionError("the plan asked the device")

    monkeypatch.setattr(torch.cuda, "get_device_properties", no_device)
    monkeypatch.setattr(torch.cuda, "is_available", no_device)
    plan = tl.lstm_fwd_plan(B, H)
    assert (plan.U, plan.R, plan.blocks) == (U, R, blocks)
    assert plan == tl.fwd_plan(B, H, U, R)
    assert plan.smem <= SMEM_PER_BLOCK
    if R:
        assert plan.blocks == H // U * -(-B // R) <= SMS
        assert R % (256 // U) == 0


def test_fwd_plan_stages_a_quarter_of_the_parents_bytes():
    """At the classifier's shape a step stages each row of h_{t-1} once
    for each of the H / U blocks that share it: 4 MiB for U = 16 where the
    parent's blocks of 4 units staged 16."""
    B, H = 64, 512
    plan = tl.lstm_fwd_plan(B, H)
    assert B * H * 4 * (H // plan.U) == 4 * 2**20
    assert B * H * 4 * (H // 4) == 16 * 2**20


def test_fwd_plan_takes_the_parents_shapes_and_fits():
    """The forward takes exactly the (B, H) the parent took, by blocks
    that exist and fit at once; (U, R) blocks wherever they fit, the most
    units a block first."""
    taken = 0
    for H in range(4, 1300, 4):
        for B in (1, 2, 5, 16, 17, 64, 100, 256, 1024, 1984, 1985, 2048,
                  4096, 7168):
            plan = tl.lstm_fwd_plan(B, H)
            assert (plan is not None) == _parent_supported(B, H), (B, H)
            if plan is None:
                continue
            taken += 1
            assert plan.smem <= SMEM_PER_BLOCK
            assert plan == tl.fwd_plan(B, H, plan.U, plan.R)
            larger = [U for U in (16, 8, 4) if H % U == 0 and
                      (plan.R == 0 or U > plan.U)]
            assert all(tl._fwd_fits(B, H, U, R) is None for U in larger
                       for R in range(256 // U, B + 256 // U, 256 // U))
    assert taken > 1800


@pytest.mark.parametrize("U,H,R", [(32, 512, 16), (16, 520, 16),
                                   (16, 512, 8), (8, 512, 16), (8, 512, 0),
                                   (16, 4096, 16)])
def test_fwd_plan_refuses_what_the_kernel_lacks(U, H, R):
    """No instance of U = 32; U must divide H; R a multiple of 256 / U,
    or 0 with U = 4; the blocks must fit at once (H = 4096: W's columns
    alone exceed a block's shared memory)."""
    with pytest.raises(Error, match="no forward"):
        tl.fwd_plan(64, H, U, R)


def test_forced_fwd_plan_runs_the_plain_version_on_cpu():
    x4, w, b, mask, reset = (None if a is None else torch.from_numpy(a)
                             for a in _data(3, 6, 16, "reset", 2))
    want = fused_lstm_plain(x4, w, b, mask, reset, True)
    for plan in (tl.fwd_plan(3, 16, 4, 64), tl.fwd_plan(3, 16, 4, 0)):
        got = tl.fused_lstm_fwd(x4, w, b, mask, reset, stash=True, plan=plan)
        assert all(torch.equal(g, r) for g, r in zip(got, want))


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


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,H,U,R,case", [
    (64, 100, 512, 16, 16, "ragged"),    # the plan's at the classifier's
    (1, 100, 512, 16, 16, "ragged"),
    (40, 30, 512, 16, 32, "reset"),      # two row tiles a block
    (70, 20, 256, 8, 64, "ragged"),
    (5, 37, 100, 4, 64, "reset"),
    (300, 12, 512, 4, 0, "ragged"),      # 4 units, every row
])
def test_fwd_kernel_instances_match_plain_on_card(B, T, H, U, R, case):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    x4, w, b, mask, reset = _data(B, T, H, case, 11)
    args = [None if a is None else torch.from_numpy(a).cuda()
            for a in (x4, w, b, mask, reset)]
    plan = tl.fwd_plan(B, H, U, R)
    got = tl.fused_lstm_fwd(*args, stash=True, plan=plan)
    again = tl.fused_lstm_fwd(*args, stash=True, plan=plan)
    torch.cuda.synchronize()
    assert all(torch.equal(g, a) for g, a in zip(got, again))
    want = fused_lstm_plain(*args, with_gates=True)
    for g, r in zip(got, want):
        torch.testing.assert_close(g, r, rtol=1e-4, atol=1e-4)
