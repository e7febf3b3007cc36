"""Fused LSTM: the Hopper kernels' wrappers, their plain versions and the
autograd Function that joins them.

Counterpart of ``paddle_tpu/kernels/lstm.py`` ``fused_lstm`` and its
``custom_vjp``. Four kernels (their source notes give the design and the
bound on an H100):

- ``csrc/lstm_fwd.cu`` ``lstm_fwd``: the forward, one cooperative launch
  over the whole masked recurrence, whose blocks own (unit group, row
  group) pairs: :func:`lstm_fwd_plan` picks U units and R rows a block
  from (B, H) alone (the first port's kernel of 4 units and every row
  where no such blocks fit); when training it also writes the stash of
  post-activation gates the backward reads. Every path launches it
  through the custom op ``paddle_tpu_torch::lstm_fwd`` (registered when
  this module is imported), so that ``torch.export`` keeps it in a
  traced forward: its CPU implementation is the plain version;
- ``csrc/lstm_bwd.cu`` ``lstm_bwd``: the reverse recurrence, dx4 = dpre,
  one cooperative launch whose blocks own (unit group, row group) pairs:
  :func:`lstm_bwd_plan` picks U units and R rows a block from (B, H)
  alone;
- ``csrc/lstm_bwd.cu`` ``lstm_bwd_dw``: dW and db from dx4, hs and cs, one
  launch after it, on the tensor cores (3xTF32 ``mma.sync``), its (row,
  step) pairs split S ways (:func:`lstm_dw_splits`, from the shape alone);
  where S > 1, ``lstm_bwd_dw_reduce`` sums the S partials in split order.
  With the recurrence they compute what the TPU's ``_bwd_kernel`` does in
  one. The split form (the TPU's ``_bwd_kernel_nodw``) runs the recurrence
  alone and forms dW and db outside, by one matmul and a few reductions
  (:func:`split_dw_db`), as the JAX package does.

The forward, the recurrence and the dW kernel also have a bf16 form, the
TPU kernels' arithmetic on bf16 operands (the JAX package's
mixed-precision path): ``lstm_fwd_bf16``, ``lstm_bwd_bf16`` (which in the
default form also sums db from the unrounded dpre) and
``lstm_bwd_dw_bf16`` (one bf16 ``mma.sync`` pass, dW only; its partials
go to the same sum). bf16 CUDA tensors launch them, counted as
``fused_lstm_bf16``, ``fused_lstm_bwd_bf16`` (``fused_lstm_bwd_nodw_bf16``
under the split form) and ``fused_lstm_bwd_dw_bf16``; mask and reset go
to them as float32. float16, float64 and mixed dtypes raise on the card.
The plain versions follow the same bf16 rule (``_arith``). The two
backward forms give different db on bf16, as in the JAX package: the
default form sums the unrounded dpre, the split form the rounded dx4.

Semantics match ``layers/recurrent.py`` ``lstm_cell`` with the default
activations: gate order [i, f, c, o], peephole biases packed at
bias[4H:7H], mask-gated carry, optional segment-start ``reset`` that
zeroes the carry entering a step (and gates the carry's gradient handed
back across it). ``mask`` and ``reset`` get no gradient.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from paddle_tpu_torch import kernels as _kernels
from paddle_tpu_torch.kernels import _build
from paddle_tpu_torch.utils.error import enforce

# the forward (csrc/lstm_fwd.cu) and the backward's recurrence
# (csrc/lstm_bwd.cu lstm_bwd): 256 threads a block in 8 warps; U units a
# block, its rows in tiles of 256 / U (a (row, unit) pair a thread); the
# forward's first kernel of 4 units and every row (R = 0 in a plan) in
# 32-row tiles; the recurrence's ring of 2 stages of 8192 floats of dpre
_UNITS = (16, 8, 4)
_WARPS = 8
UNITS_PER_BLOCK = 4
_THREADS = 256
_ROWS = 32
_NCOL = 4 * UNITS_PER_BLOCK
_BWD_NS = 2
_BWD_STAGE = 8192

# the dW kernel (csrc/lstm_bwd.cu lstm_bwd_dw): 64 x 64 output tiles, pairs
# staged 32 at a time; its pairs are split so that some _DW_BLOCKS blocks
# run, two an SM of an H100
_DW_TILE = 64
_DW_CHUNK = 32

# an H100 SXM, the card the support predicates are derived for
_SMS = 132
_SMEM_PER_SM = 228 * 1024
_SMEM_PER_BLOCK = 227 * 1024
_SMEM_RESERVED_PER_BLOCK = 1024
_DW_BLOCKS = 2 * _SMS

# test hook: force the split backward (the recurrence, then split_dw_db)
# whatever the shape, as paddle_tpu/kernels/lstm.py _FORCE_SPLIT_BWD does
_FORCE_SPLIT_BWD = False


def _smem_bytes(H: int) -> int:
    """csrc/lstm_fwd.cu all_rows_smem_bytes: W's 16 columns and a 32-row
    tile of h_{t-1} [H+4] each, the tile's pre-activations."""
    return 4 * ((_NCOL + _ROWS) * (H + 4) + _ROWS * _NCOL)


def _coresident(H: int, smem: int) -> bool:
    """H / 4 blocks of ``smem`` bytes each all resident on an H100."""
    if smem > _SMEM_PER_BLOCK:
        return False
    per_sm = min(2048 // _THREADS,
                 _SMEM_PER_SM // (smem + _SMEM_RESERVED_PER_BLOCK))
    return H // UNITS_PER_BLOCK <= _SMS * per_sm


def _shape_ok(B: int, H: int) -> bool:
    return B >= 1 and H >= UNITS_PER_BLOCK and H % UNITS_PER_BLOCK == 0


def _units_and_rows(B: int, H: int, fits):
    """The plans' rule, ``fits(B, H, U, R)`` giving the blocks of U units
    and R rows or None: the most units a block that divide H, then the
    most row groups, each R rows, a multiple of the 256 / U rows of a
    tile."""
    for U in _UNITS:
        if H % U:
            continue
        tiles = -(-B // (_THREADS // U))
        for groups in range(tiles, 0, -1):
            plan = fits(B, H, U, -(-tiles // groups) * (_THREADS // U))
            if plan is not None:
                return plan
    return None


def _bf16(dtype) -> bool:
    return dtype == torch.bfloat16


def _fwd_smem_bytes(H: int, U: int, R: int, dtype=torch.float32) -> int:
    """csrc/lstm_fwd.cu smem_bytes: W's 4U columns as float, each (H/4 |
    1) float4s long, a tile of RT = 256 / U rows of h_{t-1} of the dtype
    (float32 rows as long as W's; bf16 rows (H/8 | 1) 16-byte runs), the 8
    warps' partial sums [RT][4U + U/2] and the cell and hidden carries of
    the block's R x U pairs."""
    ld = 4 * ((H // 4) | 1)
    RT = _THREADS // U
    tile = 2 * RT * 8 * ((H // 8) | 1) if _bf16(dtype) else 4 * RT * ld
    return 4 * (4 * U * ld + _WARPS * RT * (4 * U + U // 2)
                + 2 * R * U) + tile


class LstmFwdPlan(NamedTuple):
    """The forward's blocks for a shape: U hidden units and R batch rows a
    block, ``blocks`` = (H / U) x ceil(B / R) of them, ``smem`` bytes of
    shared memory each; R = 0 is the first port's kernel, H / 4 blocks of
    U = 4 units that each take every row."""
    U: int
    R: int
    blocks: int
    smem: int


def _fwd_fits(B: int, H: int, U: int, R: int,
              dtype=torch.float32) -> Optional[LstmFwdPlan]:
    if not (B >= 1 and U in _UNITS and H >= U and H % U == 0 and R >= 1
            and R % (_THREADS // U) == 0
            and not (_bf16(dtype) and H % 8)):
        return None
    smem = _fwd_smem_bytes(H, U, R, dtype)
    blocks = H // U * -(-B // R)
    # one block an SM: 256 threads of 202 to 216 registers (the float32
    # and bf16 instances as built), so registers, not shared memory, keep
    # out a second
    if smem > _SMEM_PER_BLOCK or blocks > _SMS:
        return None
    return LstmFwdPlan(U, R, blocks, smem)


def _all_rows_plan(B: int, H: int) -> Optional[LstmFwdPlan]:
    """The first port's kernel at (B, H), where its H / 4 blocks (each a
    32-row tile of h_{t-1} and 16 columns of W) are all resident at once:
    H up to 588, any B."""
    if not (_shape_ok(B, H) and _coresident(H, _smem_bytes(H))):
        return None
    return LstmFwdPlan(UNITS_PER_BLOCK, 0, H // UNITS_PER_BLOCK,
                       _smem_bytes(H))


def fwd_plan(B: int, H: int, U: int, R: int,
             dtype=torch.float32) -> LstmFwdPlan:
    """The forward with U units and R rows a block at (B, H) (R = 0: the
    first port's kernel, U = 4, which has no bf16 form); raises where the
    kernel has no such instance (U of 4, 8, 16 dividing H; R a multiple of
    256 / U; for bf16 H a multiple of 8) or its blocks do not fit an H100
    at once."""
    all_rows = R == 0 and U == UNITS_PER_BLOCK
    enforce(not (all_rows and _bf16(dtype)),
            "fused_lstm: the forward of 4 units and every row (R = 0) has "
            "no bf16 form")
    plan = _all_rows_plan(B, H) if all_rows else _fwd_fits(B, H, U, R, dtype)
    enforce(plan is not None,
            f"fused_lstm: no forward of U={U} units and R={R} rows a block "
            f"at B={B}, H={H} whose blocks fit an H100 at once")
    return plan


def lstm_fwd_plan(B: int, H: int,
                  dtype=torch.float32) -> Optional[LstmFwdPlan]:
    """The forward's blocks for (B, H), from the shape alone and the
    H100's shared memory, or None where the forward does not take the
    shape. It takes the shapes it took before, no more and no fewer: those
    whose H / 4 blocks of the first port's kernel (4 units and a 32-row
    tile of every row) fit at once, H a multiple of 4 up to 588, any B.
    There it takes the backward's rule (:func:`lstm_bwd_plan`): the most
    units a block that divide H (16, else 8, else 4: the fewer blocks
    share a row of h, the fewer bytes a step stages), then the most row
    groups whose blocks are resident at once, one an SM, each R rows, a
    multiple of the 256 / U rows of a tile. The classifier's (64, 512)
    takes U = 16, R = 16: 32 x 4 = 128 blocks of 199 KiB. Where no such
    blocks fit (B past 1984 at H = 512; H / 4 > 132 with H not a multiple
    of 8), the first port's kernel (R = 0). The bf16 form (``dtype``
    torch.bfloat16) takes H a multiple of 8 and the same rule with its own
    shared memory (W widened to float, the row tile bf16), and no
    fallback: the first port's kernel has no bf16 form. The classifier's
    (64, 512) takes U = 16, R = 16 there too, 128 blocks of 183 KiB; (64,
    128) takes U = 16, R = 16, 32 blocks of 75 KiB."""
    if _bf16(dtype):
        if B < 1 or H < 8 or H % 8:
            return None
        return _units_and_rows(B, H, lambda *a: _fwd_fits(*a, dtype=dtype))
    all_rows = _all_rows_plan(B, H)
    if all_rows is None:
        return None
    return _units_and_rows(B, H, _fwd_fits) or all_rows


def fused_lstm_supported(B: int, H: int, dtype=torch.float32) -> bool:
    """Whether the forward takes (B, H) on an H100 for tensors of
    ``dtype`` (float32 or bf16): :func:`lstm_fwd_plan` has blocks that
    fit."""
    return lstm_fwd_plan(B, H, dtype) is not None


def _bwd_smem_bytes(H: int, U: int, R: int, dtype=torch.float32) -> int:
    """csrc/lstm_bwd.cu smem_bytes: W's U rows [U][4H+4] as float, the
    ring of dpre [2][RT][KC+4] floats or, for bf16, [2][RT][KC+8] bf16 (RT
    = 256 / U rows, KC = 8192 / RT columns), the warps' sums [8][256] and
    the dc and dh pass-through carries of the block's R x U pairs."""
    RT = _THREADS // U
    KC = _BWD_STAGE // RT
    if _bf16(dtype):
        return (4 * (U * (4 * H + 4) + _WARPS * _THREADS + 2 * R * U)
                + 2 * _BWD_NS * RT * (KC + 8))
    return 4 * (U * (4 * H + 4) + _BWD_NS * RT * (KC + 4)
                + _WARPS * _THREADS + 2 * R * U)


class LstmBwdPlan(NamedTuple):
    """The backward recurrence's blocks for a shape: U hidden units and R
    batch rows a block, ``blocks`` = (H / U) x ceil(B / R) of them, ``smem``
    bytes of shared memory each."""
    U: int
    R: int
    blocks: int
    smem: int


def _bwd_fits(B: int, H: int, U: int, R: int,
              dtype=torch.float32) -> Optional[LstmBwdPlan]:
    if not (B >= 1 and U in _UNITS and H >= U and H % U == 0 and R >= 1
            and R % (_THREADS // U) == 0
            and not (_bf16(dtype) and H % 8)):
        return None
    smem = _bwd_smem_bytes(H, U, R, dtype)
    blocks = H // U * -(-B // R)
    # one block an SM: 256 threads of up to 255 registers (the float32 and
    # bf16 instances take 156 to 234), so registers, not shared memory,
    # keep out a second
    if smem > _SMEM_PER_BLOCK or blocks > _SMS:
        return None
    return LstmBwdPlan(U, R, blocks, smem)


def bwd_plan(B: int, H: int, U: int, R: int,
             dtype=torch.float32) -> LstmBwdPlan:
    """The recurrence with U units and R rows a block at (B, H); raises
    where the kernel has no such instance (U of 4, 8, 16 dividing H; R a
    multiple of 256 / U; for bf16 H a multiple of 8) or its blocks do not
    fit an H100 at once (one an SM)."""
    plan = _bwd_fits(B, H, U, R, dtype)
    enforce(plan is not None,
            f"fused_lstm_bwd: no recurrence of U={U} units and R={R} rows a "
            f"block at B={B}, H={H} whose blocks fit an H100 at once")
    return plan


def lstm_bwd_plan(B: int, H: int,
                  dtype=torch.float32) -> Optional[LstmBwdPlan]:
    """The recurrence's blocks for (B, H), from the shape alone and the
    H100's shared memory, or None where none fit. The most units a block
    that divide H (16, else 8, else 4: the fewer blocks share a row's
    dpre, the fewer bytes a step stages), then the most row groups whose
    blocks are resident at once, one an SM, each R rows, a multiple of
    the 256 / U rows of a tile. The classifier's (64, 512) takes U = 16,
    R = 16: 32 x 4 = 128 blocks of 203 KiB. It takes every (B, H) the
    backward took with 4 units a block (H <= 528 at B = 64, B up to 2088
    at H = 512): past what U = 16 holds, a smaller U or more rows a
    block. The bf16 form (``dtype`` torch.bfloat16) takes H a multiple of
    8 and the same rule with its own shared memory (W widened to float,
    the ring bf16): (64, 512) takes U = 16, R = 16 there too, 128 blocks
    of 171 KiB."""
    if B < 1 or H < 4 or H % 4 or (_bf16(dtype) and H % 8):
        return None
    return _units_and_rows(B, H, lambda *a: _bwd_fits(*a, dtype=dtype))


def fused_lstm_bwd_supported(B: int, H: int, dtype=torch.float32) -> bool:
    """Whether the backward's recurrence takes (B, H) on an H100 for
    tensors of ``dtype`` (float32 or bf16): :func:`lstm_bwd_plan` has
    blocks that fit. The dW kernel takes every such shape."""
    return lstm_bwd_plan(B, H, dtype) is not None


def _use_in_kernel_dw(B: int, H: int) -> bool:
    """dW and db by the dW kernel (``lstm_bwd_dw``, the TPU's in-kernel
    form) rather than :func:`split_dw_db`'s matmul: wherever it takes the
    shape (H a multiple of 4, every shape the recurrence takes), unless
    ``_FORCE_SPLIT_BWD`` asks for the split form. A Hopper rule, not the
    TPU's VMEM arithmetic: on bf16 the two forms' db differ, so where the
    JAX package takes its split form (large H) and this rule does not, the
    port's db follows the in-kernel rule (the unrounded dpre)."""
    return not _FORCE_SPLIT_BWD and _shape_ok(B, H)


def lstm_dw_splits(N: int, H: int) -> int:
    """S, the ways the dW kernel splits its N = B*T (row, step) pairs: from
    the shape alone, so the answer does not depend on the card. Enough
    splits for _DW_BLOCKS blocks of 4H/64 x H/64 output tiles, at most one
    a 32-pair chunk: 2 at H = 512 (256 tiles), 17 at H = 128 (16 tiles),
    1 below 33 pairs."""
    tiles = -(-4 * H // _DW_TILE) * -(-H // _DW_TILE)
    return max(1, min(-(-_DW_BLOCKS // tiles), -(-N // _DW_CHUNK)))


# --- plain versions ----------------------------------------------------------

def _arith(dtype):
    """(the dtype the plain versions compute in, the rounding a product's
    operand takes). For bf16 tensors, the TPU kernel's arithmetic on bf16
    operands: the carries, the gates and every sum in float32, each
    product's operands rounded to bf16 (a product of two bf16 values is
    exact in float32, so this is ``preferred_element_type=float32``). Any
    other dtype computes in itself and rounds nothing."""
    if dtype == torch.bfloat16:
        return torch.float32, lambda a: a.to(torch.bfloat16).float()
    return dtype, lambda a: a


def _cell(x4_t, h, c, w, bias, H, rnd=lambda a: a):
    pre = x4_t + torch.matmul(rnd(h), w)
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
    gate stash [B, T, 4H] the backward reads. On bf16 operands (the TPU
    kernel's rule, ``_arith``): float32 h and c carries, the product of
    h_{t-1} rounded to bf16 and bf16 W summed in float32, the bias widened,
    the peepholes on the float32 c, and hs, cs and the stash rounded to
    bf16 on output."""
    B, T, H4 = x4.shape
    H = H4 // 4
    cd, rnd = _arith(x4.dtype)
    out = x4.dtype
    x4, w, bias = (a.to(cd) for a in (x4, w, bias))
    mask = mask.to(cd)
    h = x4.new_zeros(B, H)
    c = x4.new_zeros(B, H)
    hs, cs, gates = [], [], []
    for t in range(T):
        if reset is not None:
            p = 1.0 - reset[:, t, None].to(cd)
            h = p * h
            c = p * c
        h_new, c_new, g4 = _cell(x4[:, t], h, c, w, bias, H, rnd)
        m = mask[:, t, None]
        h = m * h_new + (1.0 - m) * h
        c = m * c_new + (1.0 - m) * c
        hs.append(h)
        cs.append(c)
        gates.append(g4)
    res = torch.stack(hs, 1).to(out), torch.stack(cs, 1).to(out)
    return res + (torch.stack(gates, 1).to(out),) if with_gates else res


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
    g_cs (None: zero) of hs and cs. On bf16 operands (``_arith``, the
    in-kernel form): the stash, hs and cs read as stored (bf16), float32
    dh and dc carries, dpre rounded to bf16 as the operand of the dh
    product and of dW, db the float32 sum of the UNROUNDED dpre (and of
    the peepholes' di*c_prev, df*c_prev, do*c), dx4 rounded to bf16 on
    output; dW and db stay float32 sums (:class:`_FusedLSTM` casts them to
    the parameters' dtype)."""
    B, T, H = hs.shape
    cd, rnd = _arith(hs.dtype)
    out = hs.dtype
    w, bias, gates, hs, cs, g_hs = (a.to(cd) for a in (w, bias, gates, hs,
                                                        cs, g_hs))
    g_cs = None if g_cs is None else g_cs.to(cd)
    pi, pf, po = bias[4 * H:5 * H], bias[5 * H:6 * H], bias[6 * H:7 * H]
    mask = mask.to(cd)
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
        dh = torch.matmul(rnd(dpre), w.t()) + dh_pass
        if reset is not None:
            p = 1.0 - reset[:, t, None].to(cd)
            dh, dc = p * dh, p * dc
        dw = dw + torch.matmul(rnd(hs_prev[:, t]).t(), rnd(dpre))
        db = db + torch.cat([dpre.sum(0), (di_ * c_prev).sum(0),
                             (df_ * c_prev).sum(0), (do_ * c_new).sum(0)])
        dx4[:, t] = dpre
    return dx4.to(out), dw, db


def split_dw_db(dx4, hs, cs, reset=None):
    """dW and db from the backward's dpre (= dx4), as the JAX package forms
    them outside ``_bwd_kernel_nodw``: one matmul h_prev^T @ dpre over
    every (row, step) and the bias reductions (dpre is zero at padded
    steps, so padding adds nothing). The split form's dW and db on the
    card, and the dW kernel's plain version. On bf16 operands, float32
    sums of the values as stored (the bf16 dot with float32 results, and
    db from the ROUNDED dx4 widened, as the JAX package's split form)."""
    B, T, H = hs.shape
    cd, _ = _arith(hs.dtype)
    dx4, hs, cs = dx4.to(cd), hs.to(cd), cs.to(cd)
    return _dw_db(dx4.reshape(B * T, 4 * H),
                  *(a.reshape(B * T, H) for a in _prev_states(hs, cs, reset)),
                  cs.reshape(B * T, H))


def _dw_db(dpre, h_prev, c_prev, c):
    """(dW, db) over the pairs of the [N, 4H] and [N, H] rows given."""
    H = h_prev.shape[1]
    return torch.matmul(h_prev.t(), dpre), torch.cat([
        dpre.sum(0), (dpre[:, :H] * c_prev).sum(0),
        (dpre[:, H:2 * H] * c_prev).sum(0), (dpre[:, 3 * H:] * c).sum(0)])


def _split_pairs(N: int, S: int):
    """The dW kernel's split of N pairs into S runs of whole 32-pair
    chunks: (first pair, end) of each."""
    C = -(-N // _DW_CHUNK)
    return [(C * s // S * _DW_CHUNK, min(N, C * (s + 1) // S * _DW_CHUNK))
            for s in range(S)]


def _dw_views(flat, H: int):
    """(dW [H, 4H], db [7H] or None) as views of one [4H^2 + 7H] buffer,
    the layout the dW kernel writes ([4H^2], no db, for the bf16
    kernel)."""
    return (flat[:4 * H * H].view(H, 4 * H),
            flat[4 * H * H:] if flat.numel() > 4 * H * H else None)


def lstm_dw_partials_plain(dx4, hs, cs, reset, S: int):
    """The dW kernel's partials [S, 4H^2 + 7H]: :func:`split_dw_db` over
    each split's pairs (:func:`_split_pairs`), flattened as [dW | db];
    [S, 4H^2], no db, on bf16 operands (float32 sums of the values as
    stored: the bf16 recurrence sums db)."""
    B, T, H = hs.shape
    N = B * T
    cd, _ = _arith(hs.dtype)
    bf16 = hs.dtype == torch.bfloat16
    dx4, hs, cs = dx4.to(cd), hs.to(cd), cs.to(cd)
    prev = [a.reshape(N, H) for a in _prev_states(hs, cs, reset)]
    rows = (dx4.reshape(N, 4 * H), *prev, cs.reshape(N, H))
    parts = []
    for p0, p1 in _split_pairs(N, S):
        dw, db = _dw_db(*(a[p0:p1] for a in rows))
        parts.append(dw.reshape(-1) if bf16 else
                     torch.cat([dw.reshape(-1), db]))
    return torch.stack(parts)


def lstm_dw_reduce_plain(part) -> torch.Tensor:
    """The dW sum kernel's function: the partials summed in split
    order."""
    out = part[0].clone()
    for s in range(1, part.shape[0]):
        out += part[s]
    return out


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


_FWD = _build.GridKernel("lstm_fwd", n_ptrs=8, n_ints=5)
_BWD = _build.GridKernel("lstm_bwd", n_ptrs=9, n_ints=5)
_BWD_DW = _build.GridKernel("lstm_bwd_dw", n_ptrs=5, source="lstm_bwd",
                            n_ints=4)
_BWD_DW_REDUCE = _build.GridKernel("lstm_bwd_dw_reduce", n_ptrs=2,
                                   source="lstm_bwd", n_ints=2)
# the bf16 forms (the TPU kernels' arithmetic on bf16 operands), from the
# same sources
_FWD_BF16 = _build.GridKernel("lstm_fwd_bf16", n_ptrs=8, source="lstm_fwd",
                              n_ints=5)
_BWD_BF16 = _build.GridKernel("lstm_bwd_bf16", n_ptrs=10, source="lstm_bwd",
                              n_ints=5)
_BWD_DW_BF16 = _build.GridKernel("lstm_bwd_dw_bf16", n_ptrs=4,
                                 source="lstm_bwd", n_ints=4)


def fused_lstm_fwd(x4, w, bias, mask, reset=None, stash: bool = False,
                   plan: Optional[LstmFwdPlan] = None):
    """(hs, cs, gates or None): the forward kernel's wrapper, with the gate
    stash [B, T, 4H] when ``stash`` (training), launched with the blocks
    of ``plan`` (by default :func:`lstm_fwd_plan`'s); the plain version for
    CPU tensors. It calls the custom op ``paddle_tpu_torch::lstm_fwd``,
    so that ``torch.export`` keeps the kernel in a traced forward. No
    gradient: :func:`fused_lstm` is the differentiable form."""
    units, rows = (plan.U, plan.R) if plan is not None else (0, 0)
    hs, cs, gates = lstm_fwd_op(x4, w, bias, mask, reset, stash, units, rows)
    return hs, cs, (gates if stash else None)


# The forward as one dispatcher op, ``paddle_tpu_torch::lstm_fwd``: (hs,
# cs, gates), gates [B, T, 4H] when ``stash``, else empty. It is defined
# on a plain ``torch.library.Library`` with an implementation for each
# device and a fake, and no autograd kernel (:class:`_FusedLSTM` is the
# differentiable form), so an eager call meets no Python layer before
# its implementation. The CPU implementation is the plain version; the
# CUDA one launches ``lstm_fwd`` with U = ``units`` units and R =
# ``rows`` rows a block, or, where ``units`` is 0, the blocks of
# :func:`lstm_fwd_plan` at the batch it is given; the fake gives the
# shapes ``torch.export`` traces. Both implementations check the shapes.
# ``native/torch_ops.cc`` defines the same schema in C++, with a CPU and a
# CUDA implementation of its own, for the native runner's processes,
# which have no Python (tests/test_torch_aoti.py holds the two equal).
_LIB = torch.library.Library("paddle_tpu_torch", "FRAGMENT")
_LIB.define("lstm_fwd(Tensor x4, Tensor w, Tensor bias, Tensor mask, "
            "Tensor? reset, bool stash, int units, int rows) "
            "-> (Tensor, Tensor, Tensor)")


def _lstm_fwd_cpu(x4, w, bias, mask, reset, stash, units, rows):
    _check_shapes(x4, w, bias, mask, reset)
    out = fused_lstm_plain(x4, w, bias, mask, reset, stash)
    return out if stash else out + (x4.new_empty(0),)


def _lstm_fwd_cuda(x4, w, bias, mask, reset, stash, units, rows):
    B, T, H = _check_shapes(x4, w, bias, mask, reset)
    bf16 = _build.bf16_form("fused_lstm", [x4, w, bias])
    dtype = x4.dtype
    plan = fwd_plan(B, H, units, rows, dtype) if units else \
        lstm_fwd_plan(B, H, dtype)
    enforce(not (bf16 and H % 8),
            f"fused_lstm: the bf16 form takes H a multiple of 8, got H={H}")
    enforce(plan is not None,
            f"fused_lstm: no forward whose blocks fit an H100 at once at "
            f"B={B}, H={H} for {dtype}")
    if bf16:
        mask, reset = _build.flag(mask), _build.flag(reset)
    _build.check_kernel_tensors("fused_lstm", [x4, w, bias], [mask, reset],
                                bf16, H)
    hs = torch.empty((B, T, H), device=x4.device, dtype=dtype)
    cs = torch.empty_like(hs)
    gates = torch.empty_like(x4) if stash else x4.new_empty(0)
    (_FWD_BF16 if bf16 else _FWD).launch(
        [x4.data_ptr(), w.data_ptr(), bias.data_ptr(), mask.data_ptr(),
         _ptr(reset), hs.data_ptr(), cs.data_ptr(),
         gates.data_ptr() if stash else None], B, T, H, plan.U, plan.R,
        x4.device)
    _kernels.count_launch("fused_lstm_bf16" if bf16 else "fused_lstm",
                          reset)
    return hs, cs, gates


def _lstm_fwd_fake(x4, w, bias, mask, reset, stash, units, rows):
    B, T, H4 = x4.shape
    hs = x4.new_empty((B, T, H4 // 4))
    return hs, torch.empty_like(hs), \
        torch.empty_like(x4) if stash else x4.new_empty(0)


_LIB.impl("lstm_fwd", _lstm_fwd_cpu, "CPU")
_LIB.impl("lstm_fwd", _lstm_fwd_cuda, "CUDA")
torch.library.register_fake("paddle_tpu_torch::lstm_fwd", _lstm_fwd_fake,
                            lib=_LIB)
lstm_fwd_op = torch.ops.paddle_tpu_torch.lstm_fwd.default


def lstm_bwd_recurrence(w, bias, mask, reset, gates, hs, cs, g_hs,
                        g_cs=None, plan: Optional[LstmBwdPlan] = None,
                        with_db: bool = True):
    """(dx4, db): dx4 (= dpre) by the recurrence kernel with the blocks of
    ``plan`` (by default :func:`lstm_bwd_plan`'s) for CUDA tensors,
    ``lstm_bwd``, or for bf16 tensors its bf16 form ``lstm_bwd_bf16``; the
    plain version for CPU tensors. db [7H] float32, the sum of the
    UNROUNDED dpre and of the peepholes' gradients, comes from the
    recurrence for bf16 tensors where ``with_db`` (the default backward:
    the bf16 kernel sums it as it goes) and is None otherwise: the float32
    dW kernel sums db from dx4, and the split form from the rounded dx4
    (:func:`split_dw_db`). Counted as ``fused_lstm_bwd`` (or
    ``fused_lstm_bwd_bf16``) with db, as ``fused_lstm_bwd_nodw`` (or
    ``fused_lstm_bwd_nodw_bf16``) without."""
    B, T, H = hs.shape
    data = [a for a in (w, bias, gates, hs, cs, g_hs, g_cs) if a is not None]
    if hs.device.type == "cpu":
        dx4, _, db = fused_lstm_bwd_plain(w, bias, mask, reset, gates, hs,
                                          cs, g_hs, g_cs)
        keep = with_db and hs.dtype == torch.bfloat16
        return dx4, (db if keep else None)
    counter = "fused_lstm_bwd" if with_db else "fused_lstm_bwd_nodw"
    bf16 = _build.bf16_form(counter, data)
    if bf16:
        mask, reset = _build.flag(mask), _build.flag(reset)
    _build.check_kernel_tensors(counter, data, [mask, reset], bf16, H)
    plan = plan or lstm_bwd_plan(B, H, hs.dtype)
    enforce(plan is not None,
            f"{counter}: no recurrence whose blocks fit an H100 at once at "
            f"B={B}, H={H} for {hs.dtype}")
    dx4 = torch.empty_like(gates)
    ptrs = [w.data_ptr(), bias.data_ptr(), mask.data_ptr(), _ptr(reset),
            gates.data_ptr(), cs.data_ptr(), g_hs.data_ptr(), _ptr(g_cs),
            dx4.data_ptr()]
    if not bf16:
        _BWD.launch(ptrs, B, T, H, plan.U, plan.R, hs.device)
        _kernels.count_launch(counter, reset)
        return dx4, None
    # db [7H], then each row's sums over the steps [B][7H]
    db = torch.empty((1 + B) * 7 * H, device=hs.device,
                     dtype=torch.float32) if with_db else None
    _BWD_BF16.launch(ptrs + [_ptr(db)], B, T, H, plan.U, plan.R, hs.device)
    _kernels.count_launch(counter + "_bf16", reset)
    return dx4, (db[:7 * H] if with_db else None)


def fused_lstm_bwd_nodw(w, bias, mask, reset, gates, hs, cs, g_hs,
                        g_cs=None, plan: Optional[LstmBwdPlan] = None):
    """dx4 (= dpre) only, the split backward's kernel: for CUDA tensors the
    recurrence ``lstm_bwd`` (``lstm_bwd_bf16`` for bf16 tensors, its db
    not summed) with the blocks of ``plan`` (by default
    :func:`lstm_bwd_plan`'s); the plain version's dx4 for CPU tensors."""
    return lstm_bwd_recurrence(w, bias, mask, reset, gates, hs, cs, g_hs,
                               g_cs, plan, with_db=False)[0]


def _check_dw(dx4, hs, cs, reset) -> Tuple[int, int, int]:
    enforce(hs.dim() == 3, f"fused_lstm_bwd_dw: hs must be [B, T, H], got "
            f"{tuple(hs.shape)}")
    B, T, H = hs.shape
    enforce(tuple(cs.shape) == (B, T, H),
            f"fused_lstm_bwd_dw: cs must be [{B}, {T}, {H}], got "
            f"{list(cs.shape)}")
    enforce(tuple(dx4.shape) == (B, T, 4 * H),
            f"fused_lstm_bwd_dw: dx4 must be [{B}, {T}, {4 * H}], got "
            f"{list(dx4.shape)}")
    enforce(reset is None or tuple(reset.shape) == (B, T),
            f"fused_lstm_bwd_dw: reset must be None or [{B}, {T}]")
    return B, T, H


def lstm_dw_partials(dx4, hs, cs, reset, S: int) -> torch.Tensor:
    """The dW kernel, ``lstm_bwd_dw``, with its pairs split S ways: the
    partials [S, 4H^2 + 7H] ([dW | db] of each split) for CUDA tensors;
    :func:`lstm_dw_partials_plain` for CPU tensors. bf16 tensors launch
    its bf16 form ``lstm_bwd_dw_bf16`` (one bf16 ``mma.sync`` pass), whose
    partials are [S, 4H^2]: no db. At S = 1 the one partial is the
    outputs."""
    B, T, H = _check_dw(dx4, hs, cs, reset)
    enforce(1 <= S <= -(-B * T // _DW_CHUNK),
            f"fused_lstm_bwd_dw: S={S} splits of {-(-B * T // _DW_CHUNK)} "
            f"chunks of pairs")
    if hs.device.type == "cpu":
        return lstm_dw_partials_plain(dx4, hs, cs, reset, S)
    bf16 = _build.bf16_form("fused_lstm_bwd_dw", [dx4, hs, cs])
    if bf16:
        reset = _build.flag(reset)
    _build.check_kernel_tensors("fused_lstm_bwd_dw", [dx4, hs, cs], [reset],
                                bf16, H)
    enforce(H % 4 == 0, f"fused_lstm_bwd_dw: H={H} is not a multiple of 4")
    enforce(all(a.data_ptr() % 16 == 0 for a in (dx4, hs, cs)),
            "fused_lstm_bwd_dw: dx4, hs and cs must be 16-byte aligned")
    part = torch.empty((S, 4 * H * H + (0 if bf16 else 7 * H)),
                       device=hs.device, dtype=torch.float32)
    if bf16:
        _BWD_DW_BF16.launch([_ptr(reset), hs.data_ptr(), dx4.data_ptr(),
                             part.data_ptr()], B, T, H, S, hs.device)
        _kernels.count_launch("fused_lstm_bwd_dw_bf16", reset)
        return part
    _BWD_DW.launch([_ptr(reset), hs.data_ptr(), cs.data_ptr(), dx4.data_ptr(),
                    part.data_ptr()], B, T, H, S, hs.device)
    _kernels.count_launch("fused_lstm_bwd_dw", reset)
    return part


def lstm_dw_reduce(part) -> torch.Tensor:
    """The partials [S, F] summed in split order: the kernel
    ``lstm_bwd_dw_reduce`` for CUDA tensors, :func:`lstm_dw_reduce_plain`
    for CPU tensors."""
    enforce(part.dim() == 2 and min(part.shape) >= 1,
            f"lstm_dw_reduce: partials must be [S, F], got "
            f"{list(part.shape)}")
    if part.device.type == "cpu":
        return lstm_dw_reduce_plain(part)
    _build.check_cuda_tensors("lstm_dw_reduce", [part])
    S, F = part.shape
    out = torch.empty(F, device=part.device, dtype=torch.float32)
    _BWD_DW_REDUCE.launch([part.data_ptr(), out.data_ptr()], F, S,
                          part.device)
    _kernels.launches["fused_lstm_bwd_dw_reduce"] += 1
    return out


def fused_lstm_bwd_dw(dx4, hs, cs, reset=None):
    """(dW, db) from dx4, hs and cs: for CUDA tensors the dW kernel with
    its pairs split :func:`lstm_dw_splits` ways, then, where that is more
    than one, the sum of its partials (the outputs are views of one
    buffer); :func:`split_dw_db` for CPU tensors. For bf16 tensors dW is
    the float32 sum and db is None (the bf16 recurrence sums it:
    :func:`lstm_bwd_recurrence`)."""
    B, T, H = _check_dw(dx4, hs, cs, reset)
    if hs.device.type == "cpu":
        dw, db = split_dw_db(dx4, hs, cs, reset)
        return dw, (None if hs.dtype == torch.bfloat16 else db)
    S = lstm_dw_splits(B * T, H)
    part = lstm_dw_partials(dx4, hs, cs, reset, S)
    return _dw_views(part[0] if S == 1 else lstm_dw_reduce(part), H)


def fused_lstm_bwd(w, bias, mask, reset, gates, hs, cs, g_hs, g_cs=None):
    """(dx4, dW, db) of :func:`fused_lstm` from its stash and the upstream
    gradients (g_cs None: zero). CPU tensors run
    :func:`fused_lstm_bwd_plain` (for bf16 under the forced split form,
    its dx4 and :func:`split_dw_db`'s dW and db). CUDA tensors launch the
    recurrence, then (``_use_in_kernel_dw``, every shape unless the split
    form is forced) the dW kernel and its sum (:func:`fused_lstm_bwd_dw`),
    else the split form: :func:`fused_lstm_bwd_nodw`, then
    :func:`split_dw_db`. bf16 tensors launch the bf16 forms, the default
    form's db from the recurrence; dW and db come back as float32 sums,
    which :class:`_FusedLSTM` casts to the parameters' dtype."""
    B, T, H = hs.shape
    in_kernel = _use_in_kernel_dw(B, H)
    if hs.device.type == "cpu":
        out = fused_lstm_bwd_plain(w, bias, mask, reset, gates, hs, cs,
                                   g_hs, g_cs)
        if in_kernel or hs.dtype != torch.bfloat16:
            return out
        return (out[0],) + split_dw_db(out[0], hs, cs, reset)
    if in_kernel:
        dx4, db = lstm_bwd_recurrence(w, bias, mask, reset, gates, hs, cs,
                                      g_hs, g_cs)
        dw, db_dw = fused_lstm_bwd_dw(dx4, hs, cs, reset)
        return dx4, dw, (db_dw if db is None else db)
    dx4 = fused_lstm_bwd_nodw(w, bias, mask, reset, gates, hs, cs, g_hs,
                              g_cs)
    return (dx4,) + split_dw_db(dx4, hs, cs, reset)


class _FusedLSTM(torch.autograd.Function):
    """fused_lstm with its gradient: the forward stashes the gates, the
    backward runs :func:`fused_lstm_bwd` over them and returns dW and db
    in the parameters' dtypes (the TPU kernel's ``astype``)."""

    @staticmethod
    def forward(ctx, x4, w, bias, mask, reset):
        ctx.set_materialize_grads(False)
        stash = any(ctx.needs_input_grad[:3])
        hs, cs, gates = fused_lstm_fwd(x4, w, bias, mask, reset, stash)
        if stash:
            ctx.save_for_backward(w, bias, mask, reset, gates, hs, cs)
            ctx.bias_dtype = bias.dtype
        return hs, cs

    @staticmethod
    def backward(ctx, g_hs, g_cs):
        w, bias, mask, reset, gates, hs, cs = ctx.saved_tensors
        g_hs = torch.zeros_like(hs) if g_hs is None else g_hs.contiguous()
        g_cs = None if g_cs is None else g_cs.contiguous()
        dx4, dw, db = fused_lstm_bwd(w, bias, mask, reset, gates, hs, cs,
                                     g_hs, g_cs)
        return dx4, dw.to(w.dtype), db.to(ctx.bias_dtype), None, None


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
    multiple of 4, with the forward's and the recurrence's plans' blocks
    all co-resident (the dW kernel also takes 16-byte aligned dx4,
    hs and cs, as fresh tensors are). bf16 x4, w and bias (mixed
    precision) launch the kernels' bf16 forms (H a multiple of 8), and the
    gradients come back in the parameters' dtype; anything else raises.
    """
    _check_shapes(x4, w, bias, mask, reset)
    if torch.is_grad_enabled() and any(
            a.requires_grad for a in (x4, w, bias)):
        return _FusedLSTM.apply(x4, w, bias, mask, reset)
    return fused_lstm_fwd(x4, w, bias, mask, reset)[:2]
