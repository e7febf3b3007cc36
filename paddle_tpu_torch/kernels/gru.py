"""Fused GRU forward: the Hopper kernel's wrapper and its plain version.

Counterpart of ``paddle_tpu/kernels/gru.py`` ``fused_gru`` (forward only:
the backward kernel comes with training). The kernel, ``csrc/gru_fwd.cu``,
runs the whole masked recurrence in one cooperative launch, two grid
barriers a step; its source note gives the design and its bound on an
H100.

Semantics match ``layers/recurrent.py`` ``gru_cell`` with the default
activations: gates [z, r] from x3[:, :2H] + h@Wg + b[:2H], candidate
tanh(x3[:, 2H:] + (r*h)@Wc + b[2H:]), h' = z*h + (1-z)*c, mask-gated
carry, optional segment-start ``reset`` that zeroes the carry entering a
step.
"""

from __future__ import annotations

from typing import Tuple

import torch

from paddle_tpu_torch import kernels as _kernels
from paddle_tpu_torch.kernels import _build
from paddle_tpu_torch.utils.error import enforce

# hidden units per block and the block's shape, as in csrc/gru_fwd.cu
UNITS_PER_BLOCK = 4
_THREADS = 256
_NCOL = 3 * UNITS_PER_BLOCK          # 2U columns of Wg + U of Wc
_ROWS = _THREADS // (2 * UNITS_PER_BLOCK)

# an H100 SXM, the card the support predicate is derived for
_SMS = 132
_SMEM_PER_SM = 228 * 1024
_SMEM_PER_BLOCK = 227 * 1024
_SMEM_RESERVED_PER_BLOCK = 1024


def _smem_bytes(H: int) -> int:
    return 4 * ((_NCOL + _ROWS) * (H + 4) + _ROWS * 2 * UNITS_PER_BLOCK)


def fused_gru_supported(B: int, H: int) -> bool:
    """Whether the kernel takes hidden size H on an H100: H/4 blocks, each
    holding H x 12 floats of Wg and Wc plus a 32-row tile in shared
    memory, must all be resident at once (a cooperative launch). That
    holds up to H = 644; any B >= 1 is tiled in 32-row slices."""
    U = UNITS_PER_BLOCK
    if B < 1 or H < U or H % U:
        return False
    smem = _smem_bytes(H)
    if smem > _SMEM_PER_BLOCK:
        return False
    per_sm = min(2048 // _THREADS,
                 _SMEM_PER_SM // (smem + _SMEM_RESERVED_PER_BLOCK))
    return H // U <= _SMS * per_sm


def fused_gru_plain(x3, wg, wc, bias, mask, reset=None):
    """The kernel's function as a PyTorch time loop (same arguments and
    result as :func:`fused_gru`)."""
    B, T, H3 = x3.shape
    H = H3 // 3
    mask = mask.to(x3.dtype)
    h = x3.new_zeros(B, H)
    hs = []
    for t in range(T):
        if reset is not None:
            h = (1.0 - reset[:, t, None].to(x3.dtype)) * h
        x = x3[:, t]
        g = (x[:, :2 * H] + torch.matmul(h, wg)) + bias[:2 * H]
        z = torch.sigmoid(g[:, :H])
        r = torch.sigmoid(g[:, H:])
        c = torch.tanh((x[:, 2 * H:] + torch.matmul(r * h, wc))
                       + bias[2 * H:])
        h_new = z * h + (1.0 - z) * c
        m = mask[:, t, None]
        h = m * h_new + (1.0 - m) * h
        hs.append(h)
    return torch.stack(hs, 1)


def _check_shapes(x3, wg, wc, bias, mask, reset) -> Tuple[int, int, int]:
    enforce(x3.dim() == 3 and x3.shape[2] % 3 == 0,
            f"fused_gru: x3 must be [B, T, 3H], got {tuple(x3.shape)}")
    B, T, H3 = x3.shape
    H = H3 // 3
    enforce(B >= 1 and T >= 1 and H >= 1,
            f"fused_gru: empty input {tuple(x3.shape)}")
    enforce(tuple(wg.shape) == (H, 2 * H),
            f"fused_gru: wg must be [{H}, {2 * H}], got {tuple(wg.shape)}")
    enforce(tuple(wc.shape) == (H, H),
            f"fused_gru: wc must be [{H}, {H}], got {tuple(wc.shape)}")
    enforce(tuple(bias.shape) == (H3,),
            f"fused_gru: bias must be [{H3}], got {tuple(bias.shape)}")
    enforce(tuple(mask.shape) == (B, T),
            f"fused_gru: mask must be [{B}, {T}], got {tuple(mask.shape)}")
    enforce(reset is None or tuple(reset.shape) == (B, T),
            f"fused_gru: reset must be None or [{B}, {T}]")
    return B, T, H


_KERNEL = _build.CooperativeKernel("gru_fwd", n_ptrs=8,
                                   units=UNITS_PER_BLOCK)


def fused_gru(x3, wg, wc, bias, mask, reset=None):
    """Fused GRU over a padded batch.

    x3    [B, T, 3H]  pre-projected input ([z-gate | r-gate | candidate])
    wg    [H, 2H]     gate recurrent weights
    wc    [H, H]      candidate recurrent weights
    bias  [3H]        (pass zeros when bias-free)
    mask  [B, T]      1.0 valid / 0.0 padding
    reset [B, T]|None segment-start resets (1.0 zeroes the incoming h
                      carry at that step; must satisfy reset <= mask)
    Returns hs [B, T, H] (not mask-multiplied: carries hold).

    CPU tensors run :func:`fused_gru_plain`. CUDA tensors launch the
    kernel: float32, contiguous, on one device, H a multiple of 4, with
    all H/4 blocks co-resident; anything else raises.
    """
    B, T, H = _check_shapes(x3, wg, wc, bias, mask, reset)
    if x3.device.type == "cpu":
        return fused_gru_plain(x3, wg, wc, bias, mask, reset)
    inputs = [x3, wg, wc, bias, mask]
    _build.check_cuda_tensors("fused_gru", inputs + (
        [reset] if reset is not None else []))
    hs = torch.empty((B, T, H), device=x3.device, dtype=torch.float32)
    # r*h_{t-1} and z of the current step, exchanged between blocks
    scratch = torch.empty((2, B, H), device=x3.device, dtype=torch.float32)
    _KERNEL.launch([a.data_ptr() for a in inputs]
                   + [reset.data_ptr() if reset is not None else None,
                      hs.data_ptr(), scratch.data_ptr()], B, T, H, x3.device)
    _kernels.launches["fused_gru"] += 1
    return hs
