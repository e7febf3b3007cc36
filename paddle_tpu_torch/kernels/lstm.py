"""Fused LSTM: the Hopper kernels' wrappers, their plain versions and the
autograd Function that joins them.

Counterpart of ``paddle_tpu/kernels/lstm.py`` ``fused_lstm`` and its
``custom_vjp``. Three kernels, each one cooperative launch over the whole
masked recurrence (their source notes give the design and the bound on an
H100):

- ``csrc/lstm_fwd.cu`` ``lstm_fwd``: the forward; when training it also
  writes the stash of post-activation gates the backward reads;
- ``csrc/lstm_bwd.cu`` ``lstm_bwd``: the reverse recurrence with dW and db
  accumulated in the kernel (the TPU's ``_bwd_kernel``);
- ``csrc/lstm_bwd.cu`` ``lstm_bwd_nodw``: the split form that writes
  dpre (= dx4) only; one matmul and a few reductions outside form dW and
  db (the TPU's ``_bwd_kernel_nodw``).

Semantics match ``layers/recurrent.py`` ``lstm_cell`` with the default
activations: gate order [i, f, c, o], peephole biases packed at
bias[4H:7H], mask-gated carry, optional segment-start ``reset`` that
zeroes the carry entering a step (and gates the carry's gradient handed
back across it). ``mask`` and ``reset`` get no gradient.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from paddle_tpu_torch import kernels as _kernels
from paddle_tpu_torch.kernels import _build
from paddle_tpu_torch.utils.error import enforce

# hidden units per block and the block's shape, as in csrc/lstm_fwd.cu and
# csrc/lstm_bwd.cu
UNITS_PER_BLOCK = 4
_THREADS = 256
_ROWS = 32
_NCOL = 4 * UNITS_PER_BLOCK
_BWD_ROWS = 16
_DW_ROWS_PER_THREAD = 3

# an H100 SXM, the card the support predicates are derived for
_SMS = 132
_SMEM_PER_SM = 228 * 1024
_SMEM_PER_BLOCK = 227 * 1024
_SMEM_RESERVED_PER_BLOCK = 1024

# test hook: force the split backward (lstm_bwd_nodw) whatever the shape,
# as paddle_tpu/kernels/lstm.py _FORCE_SPLIT_BWD does
_FORCE_SPLIT_BWD = False


def _smem_bytes(H: int) -> int:
    return 4 * ((_NCOL + _ROWS) * (H + 4) + _ROWS * _NCOL)


def _bwd_smem_bytes(B: int, H: int, dw: bool) -> int:
    """csrc/lstm_bwd.cu smem_bytes: W's 4 rows, a 16-row tile of dpre,
    the tile's dh carry and dpre columns, the dc and dh carries of every
    batch row, and (dw) the block's [H, 16] dW columns."""
    U, H4 = UNITS_PER_BLOCK, 4 * H
    return 4 * (U * (H4 + 16) + _BWD_ROWS * (H4 + 4) + _BWD_ROWS * U
                + _BWD_ROWS * _NCOL + 2 * B * U + (H * _NCOL if dw else 0))


def _coresident(H: int, smem: int) -> bool:
    """H / 4 blocks of ``smem`` bytes each all resident on an H100."""
    if smem > _SMEM_PER_BLOCK:
        return False
    per_sm = min(2048 // _THREADS,
                 _SMEM_PER_SM // (smem + _SMEM_RESERVED_PER_BLOCK))
    return H // UNITS_PER_BLOCK <= _SMS * per_sm


def _shape_ok(B: int, H: int) -> bool:
    return B >= 1 and H >= UNITS_PER_BLOCK and H % UNITS_PER_BLOCK == 0


def fused_lstm_supported(B: int, H: int) -> bool:
    """Whether the forward kernel takes hidden size H on an H100: H/4
    blocks, each holding H x 16 floats of W plus a 32-row tile of h_{t-1}
    in shared memory, must all be resident at once (a cooperative launch).
    That holds up to H = 588; any B >= 1 is tiled in 32-row slices."""
    return _shape_ok(B, H) and _coresident(H, _smem_bytes(H))


def _bwd_fits(B: int, H: int, dw: bool) -> bool:
    return _shape_ok(B, H) and _coresident(H, _bwd_smem_bytes(B, H, dw))


def fused_lstm_bwd_supported(B: int, H: int) -> bool:
    """Whether one of the backward kernels takes (B, H) on an H100: H/4
    blocks that each hold W's 4 rows (4 x 4H floats), a 16-row tile of
    dpre (16 x 4H) and 8 floats of carries per batch row, all resident at
    once. At H=512 that is one block of about 164 KiB per SM (up to
    H = 528: 132 SMs)."""
    return _bwd_fits(B, H, False)


def _use_in_kernel_dw(B: int, H: int) -> bool:
    """The in-kernel-dW backward (lstm_bwd) when its block, which adds its
    [H, 16] dW columns to the above, still fits, and its threads can hold
    a tile's dW sums in registers (3 rows of 16 each: H <= 768); else the
    split one."""
    return (not _FORCE_SPLIT_BWD and H <= _DW_ROWS_PER_THREAD * _THREADS
            and _bwd_fits(B, H, True))


# --- plain versions ----------------------------------------------------------

def _cell(x4_t, h, c, w, bias, H):
    pre = x4_t + torch.matmul(h, w)
    pre = pre + bias[:4 * H]
    pi, pf, po = bias[4 * H:5 * H], bias[5 * H:6 * H], bias[6 * H:7 * H]
    i = torch.sigmoid(pre[:, :H] + pi * c)
    f = torch.sigmoid(pre[:, H:2 * H] + pf * c)
    g = torch.tanh(pre[:, 2 * H:3 * H])
    c_new = f * c + i * g
    o = torch.sigmoid(pre[:, 3 * H:] + po * c_new)
    return o * torch.tanh(c_new), c_new, torch.cat([i, f, g, o], -1)


def fused_lstm_plain(x4, w, bias, mask, reset=None, with_gates=False):
    """The forward kernel's function as a PyTorch time loop (same arguments
    and results as :func:`fused_lstm`); ``with_gates`` also returns the
    gate stash [B, T, 4H] the backward reads."""
    B, T, H4 = x4.shape
    H = H4 // 4
    mask = mask.to(x4.dtype)
    h = x4.new_zeros(B, H)
    c = x4.new_zeros(B, H)
    hs, cs, gates = [], [], []
    for t in range(T):
        if reset is not None:
            p = 1.0 - reset[:, t, None].to(x4.dtype)
            h = p * h
            c = p * c
        h_new, c_new, g4 = _cell(x4[:, t], h, c, w, bias, H)
        m = mask[:, t, None]
        h = m * h_new + (1.0 - m) * h
        c = m * c_new + (1.0 - m) * c
        hs.append(h)
        cs.append(c)
        gates.append(g4)
    out = torch.stack(hs, 1), torch.stack(cs, 1)
    return out + (torch.stack(gates, 1),) if with_gates else out


def _prev_states(hs, cs, reset):
    """h_{t-1} and c_{t-1} as the forward cell consumed them: zero at t=0,
    and gated by (1 - reset[t]) where a segment starts."""
    zero = hs.new_zeros(hs.shape[0], 1, hs.shape[2])
    hs_prev = torch.cat([zero, hs[:, :-1]], 1)
    cs_prev = torch.cat([zero, cs[:, :-1]], 1)
    if reset is not None:
        p = 1.0 - reset[..., None].to(hs.dtype)
        hs_prev, cs_prev = hs_prev * p, cs_prev * p
    return hs_prev, cs_prev


def fused_lstm_bwd_plain(w, bias, mask, reset, gates, hs, cs, g_hs,
                         g_cs=None):
    """The backward kernels' function as a reverse PyTorch time loop over
    the forward's stash, written from the TPU's ``_bwd_kernel``: returns
    (dx4 [B, T, 4H], dW [H, 4H], db [7H]) for upstream gradients g_hs and
    g_cs (None: zero) of hs and cs."""
    B, T, H = hs.shape
    pi, pf, po = bias[4 * H:5 * H], bias[5 * H:6 * H], bias[6 * H:7 * H]
    mask = mask.to(hs.dtype)
    hs_prev, cs_prev = _prev_states(hs, cs, reset)
    dh = hs.new_zeros(B, H)
    dc = hs.new_zeros(B, H)
    dw = w.new_zeros(H, 4 * H)
    db = bias.new_zeros(7 * H)
    dx4 = hs.new_empty(B, T, 4 * H)
    for t in reversed(range(T)):
        m = mask[:, t, None]
        dh_t = g_hs[:, t] + dh
        dc_t = dc if g_cs is None else g_cs[:, t] + dc
        # forward gating: h_t = m*h_new + (1-m)*h_prev, the same for c
        dh_new, dc_in = m * dh_t, m * dc_t
        dh_pass, dc_pass = (1.0 - m) * dh_t, (1.0 - m) * dc_t
        i, f, g, o = torch.split(gates[:, t], H, dim=-1)
        c_new, c_prev = cs[:, t], cs_prev[:, t]
        tanh_c = torch.tanh(c_new)
        do_ = dh_new * tanh_c * o * (1.0 - o)
        dc_new = dh_new * o * (1.0 - tanh_c * tanh_c) + dc_in + do_ * po
        di_ = dc_new * g * i * (1.0 - i)
        df_ = dc_new * c_prev * f * (1.0 - f)
        dg_ = dc_new * i * (1.0 - g * g)
        dc = dc_new * f + di_ * pi + df_ * pf + dc_pass
        dpre = torch.cat([di_, df_, dg_, do_], -1)
        dh = torch.matmul(dpre, w.t()) + dh_pass
        if reset is not None:
            p = 1.0 - reset[:, t, None].to(hs.dtype)
            dh, dc = p * dh, p * dc
        dw = dw + torch.matmul(hs_prev[:, t].t(), dpre)
        db = db + torch.cat([dpre.sum(0), (di_ * c_prev).sum(0),
                             (df_ * c_prev).sum(0), (do_ * c_new).sum(0)])
        dx4[:, t] = dpre
    return dx4, dw, db


# --- the kernels' wrappers -----------------------------------------------------

def _check_shapes(x4, w, bias, mask, reset) -> Tuple[int, int, int]:
    enforce(x4.dim() == 3 and x4.shape[2] % 4 == 0,
            f"fused_lstm: x4 must be [B, T, 4H], got {tuple(x4.shape)}")
    B, T, H4 = x4.shape
    H = H4 // 4
    enforce(B >= 1 and T >= 1 and H >= 1,
            f"fused_lstm: empty input {tuple(x4.shape)}")
    enforce(tuple(w.shape) == (H, H4),
            f"fused_lstm: w must be [{H}, {H4}], got {tuple(w.shape)}")
    enforce(tuple(bias.shape) == (7 * H,),
            f"fused_lstm: bias must be [{7 * H}], got {tuple(bias.shape)}")
    enforce(tuple(mask.shape) == (B, T),
            f"fused_lstm: mask must be [{B}, {T}], got {tuple(mask.shape)}")
    enforce(reset is None or tuple(reset.shape) == (B, T),
            f"fused_lstm: reset must be None or [{B}, {T}]")
    return B, T, H


def _ptr(a: Optional[torch.Tensor]):
    return None if a is None else a.data_ptr()


_FWD = _build.CooperativeKernel("lstm_fwd", n_ptrs=8, units=UNITS_PER_BLOCK)
_BWD = _build.CooperativeKernel("lstm_bwd", n_ptrs=12, units=UNITS_PER_BLOCK)
_BWD_NODW = _build.CooperativeKernel("lstm_bwd_nodw", n_ptrs=12,
                                     units=UNITS_PER_BLOCK,
                                     source="lstm_bwd")


def fused_lstm_fwd(x4, w, bias, mask, reset=None, stash: bool = False):
    """(hs, cs, gates or None): the forward kernel's wrapper, with the gate
    stash [B, T, 4H] when ``stash`` (training); the plain version for CPU
    tensors. No gradient: :func:`fused_lstm` is the differentiable form."""
    B, T, H = _check_shapes(x4, w, bias, mask, reset)
    if x4.device.type == "cpu":
        if stash:
            return fused_lstm_plain(x4, w, bias, mask, reset, True)
        return fused_lstm_plain(x4, w, bias, mask, reset) + (None,)
    _build.check_cuda_tensors("fused_lstm", [x4, w, bias, mask] + (
        [reset] if reset is not None else []))
    hs = torch.empty((B, T, H), device=x4.device, dtype=torch.float32)
    cs = torch.empty_like(hs)
    gates = torch.empty_like(x4) if stash else None
    _FWD.launch([x4.data_ptr(), w.data_ptr(), bias.data_ptr(),
                 mask.data_ptr(), _ptr(reset), hs.data_ptr(), cs.data_ptr(),
                 _ptr(gates)], B, T, H, x4.device)
    _kernels.launches["fused_lstm"] += 1
    return hs, cs, gates


def _bwd_launch(kernel, counter, w, bias, mask, reset, gates, hs, cs,
                g_hs, g_cs, dw, db):
    B, T, H = hs.shape
    _build.check_cuda_tensors(counter, [
        a for a in (w, bias, mask, reset, gates, hs, cs, g_hs, g_cs)
        if a is not None])
    dx4 = torch.empty_like(gates)
    kernel.launch([w.data_ptr(), bias.data_ptr(), mask.data_ptr(),
                   _ptr(reset), gates.data_ptr(), hs.data_ptr(),
                   cs.data_ptr(), g_hs.data_ptr(), _ptr(g_cs),
                   dx4.data_ptr(), _ptr(dw), _ptr(db)], B, T, H, hs.device)
    _kernels.launches[counter] += 1
    return dx4


def fused_lstm_bwd_nodw(w, bias, mask, reset, gates, hs, cs, g_hs,
                        g_cs=None):
    """dx4 (= dpre) only: the split backward's kernel, ``lstm_bwd_nodw``,
    for CUDA tensors; the plain version's dx4 for CPU tensors."""
    if hs.device.type == "cpu":
        return fused_lstm_bwd_plain(w, bias, mask, reset, gates, hs, cs,
                                    g_hs, g_cs)[0]
    return _bwd_launch(_BWD_NODW, "fused_lstm_bwd_nodw", w, bias, mask,
                       reset, gates, hs, cs, g_hs, g_cs, None, None)


def fused_lstm_bwd(w, bias, mask, reset, gates, hs, cs, g_hs, g_cs=None):
    """(dx4, dW, db) of :func:`fused_lstm` from its stash and the upstream
    gradients (g_cs None: zero). CPU tensors run
    :func:`fused_lstm_bwd_plain`. CUDA tensors launch ``lstm_bwd`` (dW and
    db in the kernel) when ``_use_in_kernel_dw`` says its blocks fit, else
    the split form: :func:`fused_lstm_bwd_nodw`, then
    :func:`split_dw_db`."""
    B, T, H = hs.shape
    if hs.device.type == "cpu":
        return fused_lstm_bwd_plain(w, bias, mask, reset, gates, hs, cs,
                                    g_hs, g_cs)
    if _use_in_kernel_dw(B, H):
        dw, db = torch.empty_like(w), torch.empty_like(bias)
        dx4 = _bwd_launch(_BWD, "fused_lstm_bwd", w, bias, mask, reset,
                          gates, hs, cs, g_hs, g_cs, dw, db)
        return dx4, dw, db
    dx4 = fused_lstm_bwd_nodw(w, bias, mask, reset, gates, hs, cs, g_hs,
                              g_cs)
    return (dx4,) + split_dw_db(dx4, hs, cs, reset)


def split_dw_db(dx4, hs, cs, reset=None):
    """dW and db from the split backward's dpre (= dx4), as the JAX
    package forms them outside ``_bwd_kernel_nodw``: one matmul
    h_prev^T @ dpre over every (row, step) and the bias reductions (dpre
    is zero at padded steps, so padding adds nothing)."""
    B, T, H = hs.shape
    hs_prev, cs_prev = _prev_states(hs, cs, reset)
    dpre = dx4.reshape(B * T, 4 * H)
    dw = torch.matmul(hs_prev.reshape(B * T, H).t(), dpre)
    cp = cs_prev.reshape(B * T, H)
    db = torch.cat([dpre.sum(0), (dpre[:, :H] * cp).sum(0),
                    (dpre[:, H:2 * H] * cp).sum(0),
                    (dpre[:, 3 * H:] * cs.reshape(B * T, H)).sum(0)])
    return dw, db


class _FusedLSTM(torch.autograd.Function):
    """fused_lstm with its gradient: the forward stashes the gates, the
    backward runs :func:`fused_lstm_bwd` over them."""

    @staticmethod
    def forward(ctx, x4, w, bias, mask, reset):
        ctx.set_materialize_grads(False)
        stash = any(ctx.needs_input_grad[:3])
        hs, cs, gates = fused_lstm_fwd(x4, w, bias, mask, reset, stash)
        if stash:
            ctx.save_for_backward(w, bias, mask, reset, gates, hs, cs)
        return hs, cs

    @staticmethod
    def backward(ctx, g_hs, g_cs):
        w, bias, mask, reset, gates, hs, cs = ctx.saved_tensors
        g_hs = torch.zeros_like(hs) if g_hs is None else g_hs.contiguous()
        g_cs = None if g_cs is None else g_cs.contiguous()
        dx4, dw, db = fused_lstm_bwd(w, bias, mask, reset, gates, hs, cs,
                                     g_hs, g_cs)
        return dx4, dw, db, None, None


def fused_lstm(x4, w, bias, mask, reset=None):
    """Fused LSTM over a padded batch.

    x4    [B, T, 4H]  pre-projected input (i, f, c, o gate order)
    w     [H, 4H]     recurrent weights
    bias  [7H]        gate biases + peepholes (pass zeros when bias-free)
    mask  [B, T]      1.0 valid / 0.0 padding
    reset [B, T]|None segment-start resets (1.0 zeroes the incoming h/c
                      carry at that step; must satisfy reset <= mask)
    Returns (hs, cs): [B, T, H] each (not mask-multiplied: carries hold).

    Differentiable in x4, w and bias: with grad enabled and any of them
    requiring it, the forward keeps the gate stash and the backward runs
    :func:`fused_lstm_bwd`. CPU tensors run the plain versions. CUDA
    tensors launch the kernels: float32, contiguous, on one device, H a
    multiple of 4, with all H/4 blocks co-resident; anything else raises.
    """
    _check_shapes(x4, w, bias, mask, reset)
    if torch.is_grad_enabled() and any(
            a.requires_grad for a in (x4, w, bias)):
        return _FusedLSTM.apply(x4, w, bias, mask, reset)
    return fused_lstm_fwd(x4, w, bias, mask, reset)[:2]
