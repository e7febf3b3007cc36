"""Fused LSTM forward: the Hopper kernel's wrapper and its plain version.

Counterpart of ``paddle_tpu/kernels/lstm.py`` ``fused_lstm`` (forward
only: the backward kernels come with training). The kernel,
``csrc/lstm_fwd.cu``, runs the whole masked recurrence in one cooperative
launch; its source note gives the design and its bound on an H100.

Semantics match ``layers/recurrent.py`` ``lstm_cell`` with the default
activations: gate order [i, f, c, o], peephole biases packed at
bias[4H:7H], mask-gated carry, optional segment-start ``reset`` that
zeroes the carry entering a step.
"""

from __future__ import annotations

from typing import Tuple

import torch

from paddle_tpu_torch import kernels as _kernels
from paddle_tpu_torch.kernels import _build
from paddle_tpu_torch.utils.error import enforce

# hidden units per block and the block's shape, as in csrc/lstm_fwd.cu
UNITS_PER_BLOCK = 4
_THREADS = 256
_ROWS = 32
_NCOL = 4 * UNITS_PER_BLOCK

# an H100 SXM, the card the support predicate is derived for
_SMS = 132
_SMEM_PER_SM = 228 * 1024
_SMEM_PER_BLOCK = 227 * 1024
_SMEM_RESERVED_PER_BLOCK = 1024


def _smem_bytes(H: int) -> int:
    return 4 * ((_NCOL + _ROWS) * (H + 4) + _ROWS * _NCOL)


def fused_lstm_supported(B: int, H: int) -> bool:
    """Whether the kernel takes hidden size H on an H100: H/4 blocks, each
    holding H x 16 floats of W plus a 32-row tile of h_{t-1} in shared
    memory, must all be resident at once (a cooperative launch). That
    holds up to H = 588; any B >= 1 is tiled in 32-row slices."""
    U = UNITS_PER_BLOCK
    if B < 1 or H < U or H % U:
        return False
    smem = _smem_bytes(H)
    if smem > _SMEM_PER_BLOCK:
        return False
    per_sm = min(2048 // _THREADS,
                 _SMEM_PER_SM // (smem + _SMEM_RESERVED_PER_BLOCK))
    return H // U <= _SMS * per_sm


def _cell(x4_t, h, c, w, bias, H):
    pre = x4_t + torch.matmul(h, w)
    pre = pre + bias[:4 * H]
    pi, pf, po = bias[4 * H:5 * H], bias[5 * H:6 * H], bias[6 * H:7 * H]
    i = torch.sigmoid(pre[:, :H] + pi * c)
    f = torch.sigmoid(pre[:, H:2 * H] + pf * c)
    g = torch.tanh(pre[:, 2 * H:3 * H])
    c_new = f * c + i * g
    o = torch.sigmoid(pre[:, 3 * H:] + po * c_new)
    return o * torch.tanh(c_new), c_new


def fused_lstm_plain(x4, w, bias, mask, reset=None):
    """The kernel's function as a PyTorch time loop (same arguments and
    results as :func:`fused_lstm`)."""
    B, T, H4 = x4.shape
    H = H4 // 4
    mask = mask.to(x4.dtype)
    h = x4.new_zeros(B, H)
    c = x4.new_zeros(B, H)
    hs, cs = [], []
    for t in range(T):
        if reset is not None:
            p = 1.0 - reset[:, t, None].to(x4.dtype)
            h = p * h
            c = p * c
        h_new, c_new = _cell(x4[:, t], h, c, w, bias, H)
        m = mask[:, t, None]
        h = m * h_new + (1.0 - m) * h
        c = m * c_new + (1.0 - m) * c
        hs.append(h)
        cs.append(c)
    return torch.stack(hs, 1), torch.stack(cs, 1)


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


_KERNEL = _build.CooperativeKernel("lstm_fwd", n_ptrs=7,
                                   units=UNITS_PER_BLOCK)


def fused_lstm(x4, w, bias, mask, reset=None):
    """Fused LSTM over a padded batch.

    x4    [B, T, 4H]  pre-projected input (i, f, c, o gate order)
    w     [H, 4H]     recurrent weights
    bias  [7H]        gate biases + peepholes (pass zeros when bias-free)
    mask  [B, T]      1.0 valid / 0.0 padding
    reset [B, T]|None segment-start resets (1.0 zeroes the incoming h/c
                      carry at that step; must satisfy reset <= mask)
    Returns (hs, cs): [B, T, H] each (not mask-multiplied: carries hold).

    CPU tensors run :func:`fused_lstm_plain`. CUDA tensors launch the
    kernel: float32, contiguous, on one device, H a multiple of 4, with
    all H/4 blocks co-resident; anything else raises.
    """
    B, T, H = _check_shapes(x4, w, bias, mask, reset)
    if x4.device.type == "cpu":
        return fused_lstm_plain(x4, w, bias, mask, reset)
    inputs = [x4, w, bias, mask]
    _build.check_cuda_tensors("fused_lstm", inputs + (
        [reset] if reset is not None else []))
    hs = torch.empty((B, T, H), device=x4.device, dtype=torch.float32)
    cs = torch.empty_like(hs)
    _KERNEL.launch([a.data_ptr() for a in inputs]
                   + [reset.data_ptr() if reset is not None else None,
                      hs.data_ptr(), cs.data_ptr()], B, T, H, x4.device)
    _kernels.launches["fused_lstm"] += 1
    return hs, cs
