"""Fused GRU: the Hopper kernels' wrappers, their plain versions and the
autograd Function that joins them.

Counterpart of ``paddle_tpu/kernels/gru.py`` ``fused_gru`` and its
``custom_vjp``. Three kernels (their source notes give the design and the
bound on an H100):

- ``csrc/gru_fwd.cu`` ``gru_fwd``: the whole masked recurrence in one
  cooperative launch, two grid barriers a step; when training it also
  writes the z|r|c stash the backward reads;
- ``csrc/gru_bwd.cu`` ``gru_bwd``: the reverse recurrence, dx3 =
  [dz_pre | dr_pre | dc_pre], one cooperative launch, two grid barriers a
  step;
- ``csrc/gru_bwd.cu`` ``gru_bwd_dw``: dWg, dWc and db from dx3, the stash
  and hs, one launch after it. Together the two backward kernels compute
  what the TPU's ``_bwd_kernel`` does in one.

Semantics match ``layers/recurrent.py`` ``gru_cell`` with the default
activations: gates [z, r] from x3[:, :2H] + h@Wg + b[:2H], candidate
tanh(x3[:, 2H:] + (r*h)@Wc + b[2H:]), h' = z*h + (1-z)*c, mask-gated
carry, optional segment-start ``reset`` that zeroes the carry entering a
step (and gates the carry's gradient handed back across it). ``mask`` and
``reset`` get no gradient.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from paddle_tpu_torch import kernels as _kernels
from paddle_tpu_torch.kernels import _build
from paddle_tpu_torch.utils.error import enforce

# hidden units per block and the blocks' shapes, as in csrc/gru_fwd.cu and
# csrc/gru_bwd.cu
UNITS_PER_BLOCK = 4
_THREADS = 256
_NCOL = 3 * UNITS_PER_BLOCK          # 2U columns of Wg + U of Wc
_ROWS = _THREADS // (2 * UNITS_PER_BLOCK)
_BWD_ROWS = 16

# an H100 SXM, the card the support predicates are derived for
_SMS = 132
_SMEM_PER_SM = 228 * 1024
_SMEM_PER_BLOCK = 227 * 1024
_SMEM_RESERVED_PER_BLOCK = 1024


def _smem_bytes(H: int) -> int:
    return 4 * ((_NCOL + _ROWS) * (H + 4) + _ROWS * 2 * UNITS_PER_BLOCK)


def _bwd_smem_bytes(B: int, H: int) -> int:
    """csrc/gru_bwd.cu smem_bytes: Wc's and Wg's rows of the block's 4
    units, a 16-row tile of 2H floats and the dh carry of every batch
    row."""
    U = UNITS_PER_BLOCK
    return 4 * (U * (H + 4) + U * (2 * H + 4) + _BWD_ROWS * (2 * H + 4)
                + B * U)


def _coresident(B: int, H: int, smem: int) -> bool:
    """H / 4 blocks of ``smem`` bytes each all resident on an H100."""
    U = UNITS_PER_BLOCK
    if B < 1 or H < U or H % U or smem > _SMEM_PER_BLOCK:
        return False
    per_sm = min(2048 // _THREADS,
                 _SMEM_PER_SM // (smem + _SMEM_RESERVED_PER_BLOCK))
    return H // U <= _SMS * per_sm


def fused_gru_supported(B: int, H: int) -> bool:
    """Whether the forward kernel takes hidden size H on an H100: H/4
    blocks, each holding H x 12 floats of Wg and Wc plus a 32-row tile in
    shared memory, must all be resident at once (a cooperative launch).
    That holds up to H = 644; any B >= 1 is tiled in 32-row slices."""
    return _coresident(B, H, _smem_bytes(H))


def fused_gru_bwd_supported(B: int, H: int) -> bool:
    """Whether the backward's recurrence kernel takes (B, H) on an H100:
    H/4 blocks that each hold Wc's and Wg's 4 rows (12 x H floats), a
    16-row tile of 2H floats and 4 floats of dh carry per batch row, all
    resident at once. At H=512 a block takes about 88 KiB plus 16 bytes a
    batch row, so two share an SM up to B = 1576 and one up to B = 8872.
    At B=64 that holds up to H = 648 (two an SM while a block stays under
    113 KiB). The dW kernel takes any shape."""
    return _coresident(B, H, _bwd_smem_bytes(B, H))


# --- plain versions ----------------------------------------------------------

def fused_gru_plain(x3, wg, wc, bias, mask, reset=None, with_gates=False):
    """The forward kernel's function as a PyTorch time loop (same arguments
    and result as :func:`fused_gru`); ``with_gates`` also returns the
    z|r|c stash [B, T, 3H] the backward reads."""
    B, T, H3 = x3.shape
    H = H3 // 3
    mask = mask.to(x3.dtype)
    h = x3.new_zeros(B, H)
    hs, gates = [], []
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
        gates.append(torch.cat([z, r, c], -1))
    if with_gates:
        return torch.stack(hs, 1), torch.stack(gates, 1)
    return torch.stack(hs, 1)


def _prev_states(hs, reset):
    """h_{t-1} as the forward cell consumed it: zero at t=0, and gated by
    (1 - reset[t]) where a segment starts."""
    zero = hs.new_zeros(hs.shape[0], 1, hs.shape[2])
    hs_prev = torch.cat([zero, hs[:, :-1]], 1)
    if reset is not None:
        hs_prev = hs_prev * (1.0 - reset[..., None].to(hs.dtype))
    return hs_prev


def fused_gru_bwd_plain(wg, wc, mask, reset, gates, hs, g_hs):
    """The backward's function as a reverse PyTorch time loop over the
    forward's stash, written from the TPU's ``_bwd_kernel``: returns
    (dx3 [B, T, 3H], dWg [H, 2H], dWc [H, H], db [3H]) for the upstream
    gradient g_hs of hs."""
    B, T, H = hs.shape
    mask = mask.to(hs.dtype)
    hs_prev = _prev_states(hs, reset)
    dh = hs.new_zeros(B, H)
    dwg = wg.new_zeros(H, 2 * H)
    dwc = wc.new_zeros(H, H)
    db = hs.new_zeros(3 * H)
    dx3 = hs.new_empty(B, T, 3 * H)
    for t in reversed(range(T)):
        m = mask[:, t, None]
        dh_t = g_hs[:, t] + dh
        dh_new = m * dh_t
        dh_pass = (1.0 - m) * dh_t
        z, r, c = torch.split(gates[:, t], H, dim=-1)
        h_prev = hs_prev[:, t]
        dz = dh_new * (h_prev - c)
        dc_pre = dh_new * (1.0 - z) * (1.0 - c * c)
        drh = torch.matmul(dc_pre, wc.t())
        dz_pre = dz * z * (1.0 - z)
        dr_pre = (drh * h_prev) * r * (1.0 - r)
        dg = torch.cat([dz_pre, dr_pre], -1)
        dh = dh_new * z + drh * r + dh_pass + torch.matmul(dg, wg.t())
        if reset is not None:
            dh = (1.0 - reset[:, t, None].to(hs.dtype)) * dh
        dwg = dwg + torch.matmul(h_prev.t(), dg)
        dwc = dwc + torch.matmul((r * h_prev).t(), dc_pre)
        dpre3 = torch.cat([dg, dc_pre], -1)
        db = db + dpre3.sum(0)
        dx3[:, t] = dpre3
    return dx3, dwg, dwc, db


def gru_dw_db_plain(dx3, gates, hs, reset=None):
    """The dW kernel's function in PyTorch: dWg, dWc and db from dx3, the
    stash and hs, one product over every (row, step) pair each (dx3 is
    zero at padded steps, so padding adds nothing)."""
    B, T, H = hs.shape
    hs_prev = _prev_states(hs, reset).reshape(B * T, H)
    d = dx3.reshape(B * T, 3 * H)
    r = gates.reshape(B * T, 3 * H)[:, H:2 * H]
    dwg = torch.matmul(hs_prev.t(), d[:, :2 * H])
    dwc = torch.matmul((r * hs_prev).t(), d[:, 2 * H:])
    return dwg, dwc, d.sum(0)


# --- the kernels' wrappers -----------------------------------------------------

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


def _check_bwd(wg, wc, mask, reset, gates, hs, g_hs) -> Tuple[int, int, int]:
    enforce(hs.dim() == 3 and hs.shape[0] >= 1 and hs.shape[1] >= 1
            and hs.shape[2] >= 1,
            f"fused_gru_bwd: hs must be [B, T, H], got {tuple(hs.shape)}")
    B, T, H = hs.shape
    for name, a, shape in (("wg", wg, (H, 2 * H)), ("wc", wc, (H, H)),
                           ("mask", mask, (B, T)),
                           ("gates", gates, (B, T, 3 * H)),
                           ("g_hs", g_hs, (B, T, H))):
        enforce(tuple(a.shape) == shape,
                f"fused_gru_bwd: {name} must be {list(shape)}, got "
                f"{list(a.shape)}")
    enforce(reset is None or tuple(reset.shape) == (B, T),
            f"fused_gru_bwd: reset must be None or [{B}, {T}]")
    dtypes = {a.dtype for a in (wg, wc, gates, hs, g_hs)}
    enforce(len(dtypes) == 1 and next(iter(dtypes)).is_floating_point,
            f"fused_gru_bwd: weights, stash, hs and g_hs must share one "
            f"floating dtype, got {sorted(str(d) for d in dtypes)}")
    return B, T, H


def _ptr(a: Optional[torch.Tensor]):
    return None if a is None else a.data_ptr()


_FWD = _build.CooperativeKernel("gru_fwd", n_ptrs=9, units=UNITS_PER_BLOCK)
_BWD = _build.CooperativeKernel("gru_bwd", n_ptrs=8, units=UNITS_PER_BLOCK)
_BWD_DW = _build.GridKernel("gru_bwd_dw", n_ptrs=7, source="gru_bwd")


def fused_gru_fwd(x3, wg, wc, bias, mask, reset=None, stash: bool = False):
    """(hs, gates or None): the forward kernel's wrapper, with the z|r|c
    stash [B, T, 3H] when ``stash`` (training); the plain version for CPU
    tensors. No gradient: :func:`fused_gru` is the differentiable form."""
    B, T, H = _check_shapes(x3, wg, wc, bias, mask, reset)
    if x3.device.type == "cpu":
        if stash:
            return fused_gru_plain(x3, wg, wc, bias, mask, reset, True)
        return fused_gru_plain(x3, wg, wc, bias, mask, reset), None
    _build.check_cuda_tensors("fused_gru", [x3, wg, wc, bias, mask] + (
        [reset] if reset is not None else []))
    hs = torch.empty((B, T, H), device=x3.device, dtype=torch.float32)
    gates = torch.empty_like(x3) if stash else None
    # r*h_{t-1} and z of the current step, exchanged between blocks
    scratch = torch.empty((2, B, H), device=x3.device, dtype=torch.float32)
    _FWD.launch([x3.data_ptr(), wg.data_ptr(), wc.data_ptr(),
                 bias.data_ptr(), mask.data_ptr(), _ptr(reset),
                 hs.data_ptr(), _ptr(gates), scratch.data_ptr()],
                B, T, H, x3.device)
    _kernels.launches["fused_gru"] += 1
    return hs, gates


def fused_gru_bwd_dx3(wg, wc, mask, reset, gates, hs, g_hs):
    """dx3 = [dz_pre | dr_pre | dc_pre] only: the recurrence kernel,
    ``gru_bwd``, for CUDA tensors; the plain version's dx3 for CPU
    tensors."""
    B, T, H = _check_bwd(wg, wc, mask, reset, gates, hs, g_hs)
    if hs.device.type == "cpu":
        return fused_gru_bwd_plain(wg, wc, mask, reset, gates, hs, g_hs)[0]
    _build.check_cuda_tensors("fused_gru_bwd", [
        a for a in (wg, wc, mask, reset, gates, hs, g_hs) if a is not None])
    dx3 = torch.empty_like(gates)
    _BWD.launch([wg.data_ptr(), wc.data_ptr(), mask.data_ptr(), _ptr(reset),
                 gates.data_ptr(), hs.data_ptr(), g_hs.data_ptr(),
                 dx3.data_ptr()], B, T, H, hs.device)
    _kernels.launches["fused_gru_bwd"] += 1
    return dx3


def fused_gru_bwd_dw(dx3, gates, hs, reset=None):
    """(dWg, dWc, db) from dx3, the stash and hs: the dW kernel,
    ``gru_bwd_dw``, for CUDA tensors; :func:`gru_dw_db_plain` for CPU
    tensors."""
    enforce(hs.dim() == 3, f"fused_gru_bwd_dw: hs must be [B, T, H], got "
            f"{tuple(hs.shape)}")
    B, T, H = hs.shape
    for name, a in (("dx3", dx3), ("gates", gates)):
        enforce(tuple(a.shape) == (B, T, 3 * H),
                f"fused_gru_bwd_dw: {name} must be [{B}, {T}, {3 * H}], "
                f"got {list(a.shape)}")
    enforce(reset is None or tuple(reset.shape) == (B, T),
            f"fused_gru_bwd_dw: reset must be None or [{B}, {T}]")
    if hs.device.type == "cpu":
        return gru_dw_db_plain(dx3, gates, hs, reset)
    _build.check_cuda_tensors("fused_gru_bwd_dw", [
        a for a in (dx3, gates, hs, reset) if a is not None])
    enforce(H % UNITS_PER_BLOCK == 0,
            f"fused_gru_bwd_dw: H={H} is not a multiple of "
            f"{UNITS_PER_BLOCK}")
    opts = dict(device=hs.device, dtype=torch.float32)
    dwg = torch.empty((H, 2 * H), **opts)
    dwc = torch.empty((H, H), **opts)
    db = torch.empty((3 * H,), **opts)
    _BWD_DW.launch([_ptr(reset), gates.data_ptr(), hs.data_ptr(),
                    dx3.data_ptr(), dwg.data_ptr(), dwc.data_ptr(),
                    db.data_ptr()], B, T, H, hs.device)
    _kernels.launches["fused_gru_bwd_dw"] += 1
    return dwg, dwc, db


def fused_gru_bwd(wg, wc, mask, reset, gates, hs, g_hs):
    """(dx3, dWg, dWc, db) of :func:`fused_gru` from its stash and the
    upstream gradient g_hs. CPU tensors run :func:`fused_gru_bwd_plain`.
    CUDA tensors launch the recurrence kernel, then the dW kernel
    (:func:`fused_gru_bwd_dx3`, :func:`fused_gru_bwd_dw`)."""
    _check_bwd(wg, wc, mask, reset, gates, hs, g_hs)
    if hs.device.type == "cpu":
        return fused_gru_bwd_plain(wg, wc, mask, reset, gates, hs, g_hs)
    dx3 = fused_gru_bwd_dx3(wg, wc, mask, reset, gates, hs, g_hs)
    return (dx3,) + fused_gru_bwd_dw(dx3, gates, hs, reset)


class _FusedGRU(torch.autograd.Function):
    """fused_gru with its gradient: the forward stashes z|r|c, the
    backward runs :func:`fused_gru_bwd` over them."""

    @staticmethod
    def forward(ctx, x3, wg, wc, bias, mask, reset):
        ctx.set_materialize_grads(False)
        stash = any(ctx.needs_input_grad[:4])
        hs, gates = fused_gru_fwd(x3, wg, wc, bias, mask, reset, stash)
        if stash:
            ctx.save_for_backward(wg, wc, mask, reset, gates, hs)
        return hs

    @staticmethod
    def backward(ctx, g_hs):
        if g_hs is None:
            return None, None, None, None, None, None
        wg, wc, mask, reset, gates, hs = ctx.saved_tensors
        dx3, dwg, dwc, db = fused_gru_bwd(wg, wc, mask, reset, gates, hs,
                                          g_hs.contiguous())
        return dx3, dwg, dwc, db, None, None


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

    Differentiable in x3, wg, wc and bias: with grad enabled and any of
    them requiring it, the forward keeps the z|r|c stash and the backward
    runs :func:`fused_gru_bwd`. CPU tensors run the plain versions. CUDA
    tensors launch the kernels: float32, contiguous, on one device, H a
    multiple of 4, with all H/4 blocks co-resident; anything else raises.
    """
    _check_shapes(x3, wg, wc, bias, mask, reset)
    if torch.is_grad_enabled() and any(
            a.requires_grad for a in (x3, wg, wc, bias)):
        return _FusedGRU.apply(x3, wg, wc, bias, mask, reset)
    return fused_gru_fwd(x3, wg, wc, bias, mask, reset)[0]
