"""Fused GRU: the Hopper kernels' wrappers, their plain versions and the
autograd Function that joins them.

Counterpart of ``paddle_tpu/kernels/gru.py`` ``fused_gru`` and its
``custom_vjp``. Six kernels (their source notes give the design and the
bound on an H100):

- ``csrc/gru_fwd.cu`` ``gru_fwd_cluster`` and ``gru_fwd``: the whole masked
  recurrence in one launch, when training also the z|r|c stash the
  backward reads. :func:`gru_fwd_plan` picks one from (B, H) alone: the
  cluster kernel (thread-block clusters, the rows' state exchanged through
  distributed shared memory, two cluster barriers a step) where the
  weights and rows fit a cluster, as at the RNN CRF tagger's H = 128; else
  the grid kernel (one cooperative launch, two grid barriers a step), as
  at the NMT encoder's H = 512;
- ``csrc/gru_bwd.cu`` ``gru_bwd_cluster`` and ``gru_bwd``: the reverse
  recurrence, dx3 = [dz_pre | dr_pre | dc_pre]. :func:`gru_bwd_plan` picks
  one from (B, H) alone, as the forward's plan: the cluster kernel (the
  rows' dc_pre, dz_pre and dr_pre exchanged through distributed shared
  memory, two cluster barriers a step) where the weights' rows and the
  rows fit a cluster, as at the tagger's H = 128; else the grid kernel
  (one cooperative launch, two grid barriers a step, its row tiles staged
  through two stages), as at H = 512;
- ``csrc/gru_bwd.cu`` ``gru_bwd_dw``: dWg, dWc and db from dx3, the stash
  and hs, one launch after it, on the tensor cores (3xTF32 ``mma.sync``),
  its (row, step) pairs split S ways over the grid (:func:`gru_dw_splits`,
  from the shape alone); where S > 1, ``gru_bwd_dw_reduce`` sums the S
  partials in split order. Together the backward kernels compute what the
  TPU's ``_bwd_kernel`` does in one.

Semantics match ``layers/recurrent.py`` ``gru_cell`` with the default
activations: gates [z, r] from x3[:, :2H] + h@Wg + b[:2H], candidate
tanh(x3[:, 2H:] + (r*h)@Wc + b[2H:]), h' = z*h + (1-z)*c, mask-gated
carry, optional segment-start ``reset`` that zeroes the carry entering a
step (and gates the carry's gradient handed back across it). ``mask`` and
``reset`` get no gradient.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

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

# the dW kernel (csrc/gru_bwd.cu gru_bwd_dw): 64 x 64 output tiles, pairs
# staged 32 at a time; its pairs are split so that some _DW_BLOCKS blocks
# run, two an SM of an H100
_DW_TILE = 64
_DW_CHUNK = 32
_DW_BLOCKS = 2 * _SMS


# the cluster forward (csrc/gru_fwd.cu gru_fwd_cluster): 256 threads a
# block, at most 16 blocks a cluster, a ring of 3 steps of inputs; its
# instances' rows a cluster. The plan takes 8 blocks a cluster where they
# split H, else units a block of _CL_UNITS, and at most _CL_MAX_CLUSTERS
# clusters, one a GPC of the H100's 8 (tools/torch_gru_fwd_cluster.py
# sweeps C and R)
_CL_THREADS = 256
_CL_MAX_BLOCKS = 16
_CL_NS = 3
_CL_ROWS = (1, 2, 4, 8, 16)
_CL_BLOCKS = 8
_CL_UNITS = (16, 8, 4)
_CL_MAX_CLUSTERS = 8


def _smem_bytes(H: int) -> int:
    return 4 * ((_NCOL + _ROWS) * (H + 4) + _ROWS * 2 * UNITS_PER_BLOCK)


def _cluster_smem_bytes(H: int, C: int, R: int) -> int:
    """csrc/gru_fwd.cu cluster_smem_bytes: the block's Wg and Wc columns
    [H][3U], the R rows' h_{t-1} and r*h_{t-1} [H][R] each, the k-parts'
    sums [256][R], z [R][U], the biases [3U] and 3 steps of x3's 3U
    columns, mask and reset for the R rows (U = H / C)."""
    U = H // C
    return 4 * (3 * U * H + 2 * H * R + _CL_THREADS * R + R * U + 3 * U
                + _CL_NS * (3 * U * R + 2 * R))


class GruFwdPlan(NamedTuple):
    """The forward kernel for a shape: ``path`` "cluster" (C blocks a
    cluster, R batch rows a cluster) or "grid" (C = R = 0); ``smem`` a
    block's shared memory in bytes."""
    path: str
    C: int
    R: int
    smem: int


def grid_plan(H: int) -> GruFwdPlan:
    """The grid kernel (one cooperative launch of H / 4 blocks)."""
    return GruFwdPlan("grid", 0, 0, _smem_bytes(H))


def _cluster_fits(H: int, C: int, R: int) -> bool:
    """Whether the cluster kernel has an instance of C blocks a cluster and
    R rows a cluster at H (U = H / C units a block, a multiple of 4, 2U
    dividing 256), within a block's shared memory."""
    return (1 <= C <= _CL_MAX_BLOCKS and H % C == 0 and (H // C) % 4 == 0
            and _CL_THREADS % (2 * (H // C)) == 0 and R in _CL_ROWS
            and _cluster_smem_bytes(H, C, R) <= _SMEM_PER_BLOCK)


def cluster_plan(H: int, C: int, R: int) -> GruFwdPlan:
    """The cluster kernel with C blocks a cluster and R rows a cluster;
    raises where the kernel has no such instance or its shared memory
    exceeds a block's."""
    enforce(_cluster_fits(H, C, R),
            f"fused_gru: no cluster kernel of C={C} blocks and R={R} rows "
            f"at H={H} within {_SMEM_PER_BLOCK} bytes of shared memory")
    return GruFwdPlan("cluster", C, R, _cluster_smem_bytes(H, C, R))


def gru_fwd_plan(B: int, H: int) -> GruFwdPlan:
    """The forward kernel for (B, H), from the shape alone and the H100's
    shared memory. The cluster kernel where it fits: C = 8 blocks a
    cluster where they split H (U = H / 8 a multiple of 4, 2U dividing
    256), else U = 16, 8 or 4 units a block in at most 16 blocks; R the
    fewest rows a cluster (an instance's: 1, 2, 4, 8, 16) that keep the
    clusters to 8, one a GPC, or 16 rows where up to a wave of one block
    an SM needs more clusters; the block's W columns, its two row tiles,
    partial sums and input ring within 227 KiB. That is every H up to 256
    that is a multiple of 16 (of 8 up to 128, of 4 up to 64), for B up to
    132 / C clusters of 16 rows (256 at C = 8); the RNN CRF tagger's (32,
    128) takes C = 8, R = 4. The grid kernel takes the rest (H = 512 among
    them). It narrows nothing: every shape the grid kernel takes
    (:func:`fused_gru_supported`) stays taken."""
    shape = _cluster_shape(B, H, _cluster_fits)
    return cluster_plan(H, *shape) if shape else grid_plan(H)


def _cluster_shape(B: int, H: int, fits) -> Optional[Tuple[int, int]]:
    """(C, R) of the cluster rule both plans share, or None where no
    cluster kernel fits (``fits(H, C, R)``): C = 8 blocks a cluster, else
    U = 16, 8 or 4 units a block; R the fewest rows a cluster that keep
    the clusters to 8, or 16 rows; at most one block an SM in all."""
    for C in [_CL_BLOCKS] + [H // U for U in _CL_UNITS if H % U == 0]:
        R = next((R for R in _CL_ROWS if -(-B // R) <= _CL_MAX_CLUSTERS),
                 _CL_ROWS[-1])
        if -(-B // R) * C <= _SMS and fits(H, C, R):
            return C, R
    return None


def _bwd_smem_bytes(B: int, H: int) -> int:
    """csrc/gru_bwd.cu smem_bytes: Wc's and Wg's rows of the block's 4
    units, two 16-row tile stages of H floats and the dh carry of every
    batch row."""
    U = UNITS_PER_BLOCK
    return 4 * (U * (H + 4) + U * (2 * H + 4) + 2 * _BWD_ROWS * H + B * U)


def _bwd_cluster_smem_bytes(H: int, C: int, R: int) -> int:
    """csrc/gru_bwd.cu cluster_smem_bytes: the block's Wc and Wg rows
    [H][U] and [2H][U], the R rows' dc_pre and dz_pre [H][2R] and dr_pre
    [H][R], two sets of the k-parts' sums [256][R], and 3 steps of g_hs,
    z, r, c and hs[t-1] of the block's U = H / C units, mask and reset,
    for the R rows."""
    U = H // C
    return 4 * (3 * U * H + 3 * H * R + 2 * _CL_THREADS * R
                + _CL_NS * (5 * U * R + 2 * R))


class GruBwdPlan(NamedTuple):
    """The backward's recurrence kernel for a shape: ``path`` "cluster" (C
    blocks a cluster, R batch rows a cluster) or "grid" (C = R = 0);
    ``smem`` a block's shared memory in bytes."""
    path: str
    C: int
    R: int
    smem: int


def bwd_grid_plan(B: int, H: int) -> GruBwdPlan:
    """The grid kernel (one cooperative launch of H / 4 blocks)."""
    return GruBwdPlan("grid", 0, 0, _bwd_smem_bytes(B, H))


def _bwd_cluster_fits(H: int, C: int, R: int) -> bool:
    """Whether the cluster backward has an instance of C blocks a cluster
    and R rows a cluster at H (U = H / C units a block, a multiple of 4
    dividing 256), within a block's shared memory."""
    return (1 <= C <= _CL_MAX_BLOCKS and H % C == 0 and (H // C) % 4 == 0
            and _CL_THREADS % (H // C) == 0 and R in _CL_ROWS
            and _bwd_cluster_smem_bytes(H, C, R) <= _SMEM_PER_BLOCK)


def bwd_cluster_plan(H: int, C: int, R: int) -> GruBwdPlan:
    """The cluster backward with C blocks a cluster and R rows a cluster;
    raises where the kernel has no such instance or its shared memory
    exceeds a block's."""
    enforce(_bwd_cluster_fits(H, C, R),
            f"fused_gru_bwd: no cluster kernel of C={C} blocks and R={R} "
            f"rows at H={H} within {_SMEM_PER_BLOCK} bytes of shared memory")
    return GruBwdPlan("cluster", C, R, _bwd_cluster_smem_bytes(H, C, R))


def gru_bwd_plan(B: int, H: int) -> GruBwdPlan:
    """The backward's recurrence kernel for (B, H), from the shape alone and
    the H100's shared memory, by :func:`gru_fwd_plan`'s rule: the cluster
    kernel where it fits, C = 8 blocks a cluster where they split H (U =
    H / 8 a multiple of 4), else U = 16, 8 or 4 units a block in at most
    16 blocks; R the fewest rows a cluster that keep the clusters to 8, or
    16 rows where up to a wave of one block an SM needs more; the block's
    weight rows, its row states, partial sums and input ring within 227
    KiB. The RNN CRF tagger's (32, 128) takes C = 8, R = 4; H = 512 the
    grid kernel. It narrows nothing: every shape the grid kernel took
    (:func:`fused_gru_bwd_supported`) stays taken."""
    shape = _cluster_shape(B, H, _bwd_cluster_fits)
    return bwd_cluster_plan(H, *shape) if shape else bwd_grid_plan(B, H)


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
    """Whether the backward's grid kernel takes (B, H) on an H100: H/4
    blocks that each hold Wc's and Wg's 4 rows (12 x H floats), two
    16-row tile stages of H floats and 4 floats of dh carry per batch row,
    all resident at once. At H=512 a block takes about 88 KiB plus 16
    bytes a batch row, so two share an SM up to B = 1592 and one up to B =
    8888. At B=64 that holds up to H = 648 (two an SM while a block stays
    under 113 KiB). :func:`gru_bwd_plan` picks the cluster kernel for some
    of the shapes this accepts. The dW kernel takes every shape this
    accepts (any B and T, H % 4 == 0)."""
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


def gru_dw_splits(N: int, H: int) -> int:
    """S, the ways the dW kernel splits its N = B*T (row, step) pairs: from
    the shape alone, so the answer does not depend on the card. Enough
    splits for _DW_BLOCKS blocks of (2H/64 + H/64) x H/64 output tiles,
    at most one a 32-pair chunk: 22 at the tagger's (16384 pairs, H =
    128, 12 tiles), 2 at H = 512 (192 tiles), 1 below 33 pairs."""
    tiles = (-(-2 * H // _DW_TILE) + -(-H // _DW_TILE)) * -(-H // _DW_TILE)
    return max(1, min(-(-_DW_BLOCKS // tiles), -(-N // _DW_CHUNK)))


def _split_pairs(N: int, S: int):
    """The kernel's split of N pairs into S runs of whole 32-pair chunks:
    (first pair, end) of each."""
    C = -(-N // _DW_CHUNK)
    return [(C * s // S * _DW_CHUNK, min(N, C * (s + 1) // S * _DW_CHUNK))
            for s in range(S)]


def _dw_flat(dwg, dwc, db):
    return torch.cat([dwg.reshape(-1), dwc.reshape(-1), db])


def _dw_views(flat, H: int):
    """(dWg [H, 2H], dWc [H, H], db [3H]) as views of one [3H^2 + 3H]
    buffer, the layout the dW kernel writes."""
    return (flat[:2 * H * H].view(H, 2 * H),
            flat[2 * H * H:3 * H * H].view(H, H), flat[3 * H * H:])


def gru_dw_partials_plain(dx3, gates, hs, reset, S: int):
    """The dW kernel's partials [S, 3H^2 + 3H]: :func:`gru_dw_db_plain`
    over each split's pairs (:func:`_split_pairs`), flattened as
    [dWg | dWc | db]."""
    B, T, H = hs.shape
    N = B * T
    hs_prev = _prev_states(hs, reset).reshape(N, H)
    d = dx3.reshape(N, 3 * H)
    r = gates.reshape(N, 3 * H)[:, H:2 * H]
    parts = []
    for p0, p1 in _split_pairs(N, S):
        a, dd = hs_prev[p0:p1], d[p0:p1]
        parts.append(_dw_flat(torch.matmul(a.t(), dd[:, :2 * H]),
                              torch.matmul((r[p0:p1] * a).t(), dd[:, 2 * H:]),
                              dd.sum(0)))
    return torch.stack(parts)


def gru_dw_reduce_plain(part) -> torch.Tensor:
    """The dW sum kernel's function: the partials summed in split
    order."""
    out = part[0].clone()
    for s in range(1, part.shape[0]):
        out += part[s]
    return out


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
_FWD_CLUSTER = _build.GridKernel("gru_fwd_cluster", n_ptrs=8, source="gru_fwd",
                                 n_ints=5)
_BWD = _build.CooperativeKernel("gru_bwd", n_ptrs=8, units=UNITS_PER_BLOCK)
_BWD_CLUSTER = _build.GridKernel("gru_bwd_cluster", n_ptrs=8,
                                 source="gru_bwd", n_ints=5)
_BWD_DW = _build.GridKernel("gru_bwd_dw", n_ptrs=5, source="gru_bwd",
                            n_ints=4)
_BWD_DW_REDUCE = _build.GridKernel("gru_bwd_dw_reduce", n_ptrs=2,
                                   source="gru_bwd", n_ints=2)


# a plan as the op's ints: ``path`` _AUTO (the plan of the batch given),
# _GRID or _CLUSTER (with C blocks and R rows a cluster)
_AUTO, _GRID, _CLUSTER = 0, 1, 2


def fused_gru_fwd(x3, wg, wc, bias, mask, reset=None, stash: bool = False,
                  plan: Optional[GruFwdPlan] = None):
    """(hs, gates or None): the forward kernels' wrapper, with the z|r|c
    stash [B, T, 3H] when ``stash`` (training); the plain version for CPU
    tensors. CUDA tensors launch the kernel of ``plan`` (by default
    :func:`gru_fwd_plan` of the shape): ``gru_fwd_cluster`` or ``gru_fwd``.
    It calls the custom op ``paddle_tpu_torch::gru_fwd``, so that
    ``torch.export`` keeps the kernel in a traced forward. No gradient:
    :func:`fused_gru` is the differentiable form."""
    if plan is None:
        path, C, R = _AUTO, 0, 0
    else:
        path, C, R = (_CLUSTER if plan.path == "cluster" else _GRID,
                      plan.C, plan.R)
    hs, gates = gru_fwd_op(x3, wg, wc, bias, mask, reset, stash, path, C, R)
    return hs, (gates if stash else None)


# The forward as one dispatcher op, ``paddle_tpu_torch::gru_fwd``: (hs,
# gates), gates the z|r|c stash [B, T, 3H] when ``stash``, else empty. As
# ``lstm_fwd`` (kernels/lstm.py), it is defined on a plain
# ``torch.library.Library`` with an implementation for each device and a
# fake, and no autograd kernel (:class:`_FusedGRU` is the differentiable
# form). The CPU implementation is the plain version; the CUDA one
# launches the kernel of the plan ``path``, ``C``, ``R`` (see _AUTO), by
# default :func:`gru_fwd_plan`'s at the batch it is given, so that a
# traced batch stays symbolic and a run picks the cluster or the grid
# kernel by its own B; the fake gives the shapes ``torch.export`` traces.
# Both implementations check the shapes.
_LIB = torch.library.Library("paddle_tpu_torch", "FRAGMENT")
_LIB.define("gru_fwd(Tensor x3, Tensor wg, Tensor wc, Tensor bias, "
            "Tensor mask, Tensor? reset, bool stash, int path, int C, int R) "
            "-> (Tensor, Tensor)")


def _gru_fwd_cpu(x3, wg, wc, bias, mask, reset, stash, path, C, R):
    _check_shapes(x3, wg, wc, bias, mask, reset)
    if stash:
        return fused_gru_plain(x3, wg, wc, bias, mask, reset, True)
    return fused_gru_plain(x3, wg, wc, bias, mask, reset), x3.new_empty(0)


def _gru_fwd_cuda(x3, wg, wc, bias, mask, reset, stash, path, C, R):
    B, T, H = _check_shapes(x3, wg, wc, bias, mask, reset)
    _build.check_cuda_tensors("fused_gru", [x3, wg, wc, bias, mask] + (
        [reset] if reset is not None else []))
    plan = gru_fwd_plan(B, H) if path == _AUTO else \
        cluster_plan(H, C, R) if path == _CLUSTER else grid_plan(H)
    hs = torch.empty((B, T, H), device=x3.device, dtype=torch.float32)
    gates = torch.empty_like(x3) if stash else x3.new_empty(0)
    ptrs = [x3.data_ptr(), wg.data_ptr(), wc.data_ptr(), bias.data_ptr(),
            mask.data_ptr(), _ptr(reset), hs.data_ptr(),
            gates.data_ptr() if stash else None]
    if plan.path == "cluster":
        _FWD_CLUSTER.launch(ptrs, B, T, H, plan.C, plan.R, x3.device)
        _kernels.launches["fused_gru_cluster"] += 1
        return hs, gates
    # r*h_{t-1} and z of the current step, exchanged between blocks
    scratch = torch.empty((2, B, H), device=x3.device, dtype=torch.float32)
    _FWD.launch(ptrs + [scratch.data_ptr()], B, T, H, x3.device)
    _kernels.launches["fused_gru"] += 1
    return hs, gates


def _gru_fwd_fake(x3, wg, wc, bias, mask, reset, stash, path, C, R):
    B, T, H3 = x3.shape
    return x3.new_empty((B, T, H3 // 3)), \
        torch.empty_like(x3) if stash else x3.new_empty(0)


_LIB.impl("gru_fwd", _gru_fwd_cpu, "CPU")
_LIB.impl("gru_fwd", _gru_fwd_cuda, "CUDA")
torch.library.register_fake("paddle_tpu_torch::gru_fwd", _gru_fwd_fake,
                            lib=_LIB)
gru_fwd_op = torch.ops.paddle_tpu_torch.gru_fwd.default


def fused_gru_bwd_dx3(wg, wc, mask, reset, gates, hs, g_hs,
                      plan: Optional[GruBwdPlan] = None):
    """dx3 = [dz_pre | dr_pre | dc_pre] only: for CUDA tensors the
    recurrence kernel of ``plan`` (by default :func:`gru_bwd_plan` of the
    shape), ``gru_bwd_cluster`` or ``gru_bwd``; the plain version's dx3 for
    CPU tensors."""
    B, T, H = _check_bwd(wg, wc, mask, reset, gates, hs, g_hs)
    if hs.device.type == "cpu":
        return fused_gru_bwd_plain(wg, wc, mask, reset, gates, hs, g_hs)[0]
    _build.check_cuda_tensors("fused_gru_bwd", [
        a for a in (wg, wc, mask, reset, gates, hs, g_hs) if a is not None])
    plan = plan or gru_bwd_plan(B, H)
    dx3 = torch.empty_like(gates)
    ptrs = [wg.data_ptr(), wc.data_ptr(), mask.data_ptr(), _ptr(reset),
            gates.data_ptr(), hs.data_ptr(), g_hs.data_ptr(), dx3.data_ptr()]
    if plan.path == "cluster":
        _BWD_CLUSTER.launch(ptrs, B, T, H, plan.C, plan.R, hs.device)
        _kernels.launches["fused_gru_bwd_cluster"] += 1
        return dx3
    _BWD.launch(ptrs, B, T, H, hs.device)
    _kernels.launches["fused_gru_bwd"] += 1
    return dx3


def _check_dw(dx3, gates, hs, reset) -> Tuple[int, int, int]:
    enforce(hs.dim() == 3, f"fused_gru_bwd_dw: hs must be [B, T, H], got "
            f"{tuple(hs.shape)}")
    B, T, H = hs.shape
    for name, a in (("dx3", dx3), ("gates", gates)):
        enforce(tuple(a.shape) == (B, T, 3 * H),
                f"fused_gru_bwd_dw: {name} must be [{B}, {T}, {3 * H}], "
                f"got {list(a.shape)}")
    enforce(reset is None or tuple(reset.shape) == (B, T),
            f"fused_gru_bwd_dw: reset must be None or [{B}, {T}]")
    return B, T, H


def gru_dw_partials(dx3, gates, hs, reset, S: int) -> torch.Tensor:
    """The dW kernel, ``gru_bwd_dw``, with its pairs split S ways: the
    partials [S, 3H^2 + 3H] ([dWg | dWc | db] of each split) for CUDA
    tensors; :func:`gru_dw_partials_plain` for CPU tensors. At S = 1 the
    one partial is the outputs."""
    B, T, H = _check_dw(dx3, gates, hs, reset)
    enforce(1 <= S <= -(-B * T // _DW_CHUNK),
            f"fused_gru_bwd_dw: S={S} splits of {-(-B * T // _DW_CHUNK)} "
            f"chunks of pairs")
    if hs.device.type == "cpu":
        return gru_dw_partials_plain(dx3, gates, hs, reset, S)
    _build.check_cuda_tensors("fused_gru_bwd_dw", [
        a for a in (dx3, gates, hs, reset) if a is not None])
    enforce(H % UNITS_PER_BLOCK == 0,
            f"fused_gru_bwd_dw: H={H} is not a multiple of "
            f"{UNITS_PER_BLOCK}")
    enforce(all(a.data_ptr() % 16 == 0 for a in (dx3, gates, hs)),
            "fused_gru_bwd_dw: dx3, gates and hs must be 16-byte aligned")
    part = torch.empty((S, 3 * H * H + 3 * H), device=hs.device,
                       dtype=torch.float32)
    _BWD_DW.launch([_ptr(reset), gates.data_ptr(), hs.data_ptr(),
                    dx3.data_ptr(), part.data_ptr()], B, T, H, S, hs.device)
    _kernels.launches["fused_gru_bwd_dw"] += 1
    return part


def gru_dw_reduce(part) -> torch.Tensor:
    """The partials [S, F] summed in split order: the kernel
    ``gru_bwd_dw_reduce`` for CUDA tensors, :func:`gru_dw_reduce_plain`
    for CPU tensors."""
    enforce(part.dim() == 2 and min(part.shape) >= 1,
            f"gru_dw_reduce: partials must be [S, F], got {list(part.shape)}")
    if part.device.type == "cpu":
        return gru_dw_reduce_plain(part)
    _build.check_cuda_tensors("gru_dw_reduce", [part])
    S, F = part.shape
    out = torch.empty(F, device=part.device, dtype=torch.float32)
    _BWD_DW_REDUCE.launch([part.data_ptr(), out.data_ptr()], F, S,
                          part.device)
    _kernels.launches["fused_gru_bwd_dw_reduce"] += 1
    return out


def fused_gru_bwd_dw(dx3, gates, hs, reset=None):
    """(dWg, dWc, db) from dx3, the stash and hs: for CUDA tensors the dW
    kernel with its pairs split :func:`gru_dw_splits` ways, then, where
    that is more than one, the sum of its partials (the outputs are views
    of one buffer); :func:`gru_dw_db_plain` for CPU tensors."""
    B, T, H = _check_dw(dx3, gates, hs, reset)
    if hs.device.type == "cpu":
        return gru_dw_db_plain(dx3, gates, hs, reset)
    S = gru_dw_splits(B * T, H)
    part = gru_dw_partials(dx3, gates, hs, reset, S)
    return _dw_views(part[0] if S == 1 else gru_dw_reduce(part), H)


def fused_gru_bwd(wg, wc, mask, reset, gates, hs, g_hs):
    """(dx3, dWg, dWc, db) of :func:`fused_gru` from its stash and the
    upstream gradient g_hs. CPU tensors run :func:`fused_gru_bwd_plain`.
    CUDA tensors launch the recurrence kernel :func:`gru_bwd_plan` picks,
    then the dW kernel (:func:`fused_gru_bwd_dx3`,
    :func:`fused_gru_bwd_dw`)."""
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
    multiple of 4; the forward's kernel is :func:`gru_fwd_plan`'s and the
    backward's recurrence :func:`gru_bwd_plan`'s, the grid kernels need
    all H/4 blocks co-resident (the dW kernel also takes 16-byte aligned
    dx3, stash and hs, as fresh tensors are); anything else raises.
    """
    _check_shapes(x3, wg, wc, bias, mask, reset)
    if torch.is_grad_enabled() and any(
            a.requires_grad for a in (x3, wg, wc, bias)):
        return _FusedGRU.apply(x3, wg, wc, bias, mask, reset)
    return fused_gru_fwd(x3, wg, wc, bias, mask, reset)[0]
