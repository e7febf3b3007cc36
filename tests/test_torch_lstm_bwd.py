"""The port's fused LSTM backward (paddle_tpu_torch.kernels.lstm) against
the JAX package's: ``jax.grad`` through ``paddle_tpu.kernels.lstm.
fused_lstm`` run in interpret mode (its custom_vjp launches the Pallas
``_bwd_kernel``, or ``_bwd_kernel_nodw`` when ``_FORCE_SPLIT_BWD`` is
set), as tests/test_kernels.py runs it.

Inputs and upstream gradients are drawn with numpy and handed to both.
Tolerance: rtol = atol = 1e-4 on dx4, dW and db, as tests/test_kernels.py
holds the Pallas backward to the scan; the differences measured on these
inputs stay near 3e-6 or below (float32 on both sides; the dW and db sums
run over (row, step) in another order).

The kernels run only on a card: the ``cuda`` tests hold them against the
plain version there and skip elsewhere.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu.kernels.lstm as jax_lstm

from paddle_tpu_torch import kernels as tk
from paddle_tpu_torch.kernels import lstm as tl
from paddle_tpu_torch.utils.error import Error

TOL = dict(rtol=1e-4, atol=1e-4)


def _data(B, T, H, case, seed):
    """x4, W, bias, mask, reset (or None), g_hs, g_cs. Ragged rows; the
    upstream gradient of hs is zero past each row's end, as the layer's
    mask multiply makes it."""
    r = np.random.RandomState(seed)
    x4 = (r.randn(B, T, 4 * H) * 0.5).astype(np.float32)
    w = (r.randn(H, 4 * H) * 0.1).astype(np.float32)
    b = (r.randn(7 * H) * 0.2).astype(np.float32)
    lens = r.randint(1, T + 1, size=B)
    lens[0] = T
    mask = (np.arange(T)[None] < lens[:, None]).astype(np.float32)
    reset = None
    if case == "reset":
        reset = (r.rand(B, T) < 0.25).astype(np.float32) * mask
        reset[:, 0] = 0
    g_hs = (r.randn(B, T, H) * mask[..., None]).astype(np.float32)
    g_cs = (r.randn(B, T, H) * 0.5).astype(np.float32)
    return x4, w, b, mask, reset, g_hs, g_cs


def _t(a):
    return None if a is None else torch.from_numpy(a)


def _jax_grads(x4, w, b, mask, reset, g_hs, g_cs):
    """(dx4, dW, db) of sum(hs*g_hs) + sum(cs*g_cs) through the JAX
    package's fused_lstm, in interpret mode."""
    jr = None if reset is None else jnp.asarray(reset)

    def loss(x4, w, b):
        hs, cs = jax_lstm.fused_lstm(x4, w, b, jnp.asarray(mask), jr, True)
        return (hs * g_hs).sum() + (cs * g_cs).sum()

    g = jax.grad(loss, argnums=(0, 1, 2))(jnp.asarray(x4), jnp.asarray(w),
                                         jnp.asarray(b))
    return [np.asarray(a) for a in g]


def _port_grads(x4, w, b, mask, reset, g_hs, g_cs):
    """The same through the port's autograd Function (CPU: the plain
    forward with its stash, then fused_lstm_bwd_plain)."""
    x4_, w_, b_ = (torch.from_numpy(a).requires_grad_(True)
                   for a in (x4, w, b))
    hs, cs = tl.fused_lstm(x4_, w_, b_, _t(mask), _t(reset))
    ((hs * _t(g_hs)).sum() + (cs * _t(g_cs)).sum()).backward()
    return [a.grad.numpy() for a in (x4_, w_, b_)]


@pytest.mark.parametrize("B,T,H,case,split", [
    (8, 5, 128, "ragged", False),     # T below the Pallas backward chunk
    (8, 13, 128, "ragged", True),
    (8, 13, 128, "reset", False),
    (8, 5, 128, "reset", True),
    (3, 7, 8, "ragged", False),
    (3, 7, 8, "reset", True),
])
def test_function_grad_matches_jax_kernel(monkeypatch, B, T, H, case,
                                          split):
    monkeypatch.setattr(jax_lstm, "_FORCE_SPLIT_BWD", split)
    monkeypatch.setattr(tl, "_FORCE_SPLIT_BWD", split)
    data = _data(B, T, H, case, B * 100 + T + H)
    want = _jax_grads(*data)
    got = _port_grads(*data)
    for name, g, w in zip(("dx4", "dW", "db"), got, want):
        assert np.isfinite(g).all(), name
        np.testing.assert_allclose(g, w, err_msg=name, **TOL)


@pytest.mark.parametrize("case", ["ragged", "reset"])
def test_stash_matches_jax_kernel_gates(case):
    """The plain forward's gate stash is the Pallas forward's, padded
    steps included (the backward multiplies by the mask there)."""
    x4, w, b, mask, reset = _data(4, 9, 16, case, 3)[:5]
    jr = None if reset is None else jnp.asarray(reset)
    res = jax_lstm._fwd_res(jnp.asarray(x4), jnp.asarray(w), jnp.asarray(b),
                            jnp.asarray(mask), jr, True)
    want = np.swapaxes(np.asarray(res[2]), 0, 1)[:, :9]
    _, _, gates = tl.fused_lstm_plain(_t(x4), _t(w), _t(b), _t(mask),
                                      _t(reset), with_gates=True)
    np.testing.assert_allclose(gates.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("case", ["ragged", "reset"])
def test_plain_bwd_matches_autograd_of_plain_forward(case):
    """fused_lstm_bwd_plain (a reverse loop over the stash) against
    autograd through the plain forward, in float64, to 1e-10."""
    x4, w, b, mask, reset, g_hs, g_cs = (
        None if a is None else torch.from_numpy(a).double()
        for a in _data(3, 11, 8, case, 5))
    x4_, w_, b_ = (a.clone().requires_grad_(True) for a in (x4, w, b))
    hs, cs, gates = tl.fused_lstm_plain(x4_, w_, b_, mask, reset, True)
    ((hs * g_hs).sum() + (cs * g_cs).sum()).backward()
    got = tl.fused_lstm_bwd_plain(w, b, mask, reset, gates.detach(),
                                  hs.detach(), cs.detach(), g_hs, g_cs)
    for name, g, want in zip(("dx4", "dW", "db"), got,
                             (x4_.grad, w_.grad, b_.grad)):
        torch.testing.assert_close(g, want, rtol=1e-10, atol=1e-10,
                                   msg=name)


@pytest.mark.parametrize("case", ["ragged", "reset"])
def test_split_dw_db_matches_in_kernel_sums(case):
    """The split form's dW/db, formed from dpre by one matmul and
    reductions (the CUDA path after lstm_bwd_nodw), equal the in-loop
    sums of the plain backward."""
    x4, w, b, mask, reset, g_hs, g_cs = (_t(a) for a in
                                         _data(5, 9, 16, case, 9))
    hs, cs, gates = tl.fused_lstm_plain(x4, w, b, mask, reset, True)
    dx4, dw, db = tl.fused_lstm_bwd_plain(w, b, mask, reset, gates, hs, cs,
                                          g_hs, g_cs)
    dw2, db2 = tl.split_dw_db(dx4, hs, cs, reset)
    torch.testing.assert_close(dw2, dw, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(db2, db, rtol=1e-5, atol=1e-5)


def test_function_gradcheck_float64():
    x4, w, b, mask, reset = (None if a is None else
                             torch.from_numpy(a).double()
                             for a in _data(2, 5, 4, "reset", 1)[:5])
    args = tuple(a.clone().requires_grad_(True) for a in (x4, w, b))
    assert torch.autograd.gradcheck(
        lambda x4, w, b: tl.fused_lstm(x4, w, b, mask, reset), args)


def test_cpu_gradient_launches_no_kernel():
    x4, w, b, mask, reset, g_hs, g_cs = _data(3, 6, 8, "ragged", 2)
    before = dict(tk.launches)
    _port_grads(x4, w, b, mask, reset, g_hs, g_cs)
    assert tk.launches == before


def test_no_grad_forward_keeps_no_stash():
    """Without grad the wrapper takes the serving path (no Function, no
    gate stash); with it the outputs carry the Function's graph."""
    x4, w, b, mask = (_t(a) for a in _data(2, 4, 8, "ragged", 4)[:4])
    w.requires_grad_(True)
    with torch.no_grad():
        hs, _ = tl.fused_lstm(x4, w, b, mask)
    assert hs.grad_fn is None
    hs, _ = tl.fused_lstm(x4, w, b, mask)
    assert type(hs.grad_fn).__name__ == "_FusedLSTMBackward"


def test_bwd_support_predicates_for_hopper():
    # H/4 blocks of W's 4 rows + a 16-row tile of 4H floats + carries
    assert tl.fused_lstm_bwd_supported(64, 512)
    assert tl.fused_lstm_bwd_supported(1, 128)
    assert tl.fused_lstm_bwd_supported(64, 528)
    assert not tl.fused_lstm_bwd_supported(64, 532)   # 133 blocks, 1 per SM
    assert not tl.fused_lstm_bwd_supported(64, 1280)
    assert not tl.fused_lstm_bwd_supported(0, 128)
    assert not tl.fused_lstm_bwd_supported(4, 130)
    # the in-kernel dW adds [H, 16] floats a block: it leaves the split
    # form the large batches
    assert tl._use_in_kernel_dw(64, 512)
    assert tl._use_in_kernel_dw(1024, 512)
    assert not tl._use_in_kernel_dw(2048, 512)
    assert tl.fused_lstm_bwd_supported(2048, 512)


def test_force_split_switch(monkeypatch):
    monkeypatch.setattr(tl, "_FORCE_SPLIT_BWD", True)
    assert not tl._use_in_kernel_dw(64, 512)


def test_bwd_wrapper_refuses_cpu_cuda_mix():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    x4, w, b, mask, reset, g_hs, g_cs = (_t(a) for a in
                                         _data(2, 3, 4, "ragged", 0))
    hs, cs, gates = tl.fused_lstm_plain(x4, w, b, mask, None, True)
    with pytest.raises(Error):
        tl.fused_lstm_bwd(w, b, mask, None, gates, hs.to("meta"), cs, g_hs)


def _cuda_case(B, T, H, case, seed):
    torch.backends.cuda.matmul.allow_tf32 = False
    data = _data(B, T, H, case, seed)
    return [None if a is None else torch.from_numpy(a).cuda() for a in data]


@pytest.mark.cuda
@pytest.mark.parametrize("split", [False, True])
@pytest.mark.parametrize("B,T,H,case", [(64, 100, 512, "ragged"),
                                        (5, 37, 128, "reset"),
                                        (1, 100, 512, "ragged")])
def test_bwd_kernels_match_plain_on_card(monkeypatch, B, T, H, case, split):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    monkeypatch.setattr(tl, "_FORCE_SPLIT_BWD", split)
    x4, w, b, mask, reset, g_hs, g_cs = _cuda_case(B, T, H, case, 7)
    hs, cs, gates = tl.fused_lstm_fwd(x4, w, b, mask, reset, True)
    name = "fused_lstm_bwd_nodw" if split else "fused_lstm_bwd"
    before = tk.launches[name]
    got = tl.fused_lstm_bwd(w, b, mask, reset, gates, hs, cs, g_hs, g_cs)
    torch.cuda.synchronize()
    assert tk.launches[name] == before + 1
    want = tl.fused_lstm_bwd_plain(w, b, mask, reset, gates, hs, cs, g_hs,
                                   g_cs)
    # float32 on both sides; the products and the dW/db sums run in
    # another order
    for g, w_ in zip(got, want):
        scale = max(1.0, float(w_.abs().max()))
        assert float((g - w_).abs().max()) <= 1e-4 * scale


@pytest.mark.cuda
def test_forward_stash_matches_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    x4, w, b, mask, reset = _cuda_case(16, 40, 256, "reset", 3)[:5]
    hs, cs, gates = tl.fused_lstm_fwd(x4, w, b, mask, reset, True)
    hp, cp, gp = tl.fused_lstm_plain(x4, w, b, mask, reset, True)
    torch.cuda.synchronize()
    for g, w_ in ((hs, hp), (cs, cp), (gates, gp)):
        torch.testing.assert_close(g, w_, rtol=1e-4, atol=1e-4)
