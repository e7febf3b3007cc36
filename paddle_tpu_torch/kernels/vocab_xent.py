"""Fused vocabulary projection + softmax cross-entropy: the Hopper
kernels' wrappers, their plain versions and the autograd Function that
joins them.

Counterpart of ``paddle_tpu/kernels/vocab_xent.py`` ``vocab_xent`` and its
``custom_vjp``: the per-row NLL of ``x @ w + b`` against integer labels,
without an [N, V] logits buffer in device memory. A library function, as
in the JAX package: no layer calls it. Five kernels in
``csrc/vocab_xent.cu`` (its source note gives the design and the bound on
an H100):

- ``vocab_xent_fwd`` and ``vocab_xent_fwd_reduce``: each row's online
  (max, sumexp, gold logit) over S vocabulary slices, then the slices
  combined into lse and nll;
- ``vocab_xent_bwd_dx`` and ``vocab_xent_bwd_dx_reduce``: dx = dlog @ wᵀ
  per slice, a block 64 rows, then the slices summed in order (not
  launched where one slice fills the card);
- ``vocab_xent_bwd_dw``: dW = xᵀ @ dlog and db, a block a column tile.

All three kernels run their products on the tensor cores in three TF32
passes (the forward since it took dx's logits pipeline).

Each backward kernel recomputes the logits, as the TPU's do. Nothing is
padded: the kernels mask their ragged edges, so the TPU's padding of N to
256 and V to 2048, and its lse guard of padded rows, are not copied.

The plain versions run the same function over vocabulary chunks of 2048
columns (the TPU kernel's), so they too keep no [N, V] buffer. Types
follow the JAX package: the sums in ``promote(x.dtype, float32)``, w cast
to x's type, dx, dW and db cast back to x's, w's and b's. The kernels take
float32 only.
"""

from __future__ import annotations

from typing import Tuple

import torch

from paddle_tpu_torch import kernels as _kernels
from paddle_tpu_torch.kernels import _build
from paddle_tpu_torch.kernels._util import NEG
from paddle_tpu_torch.utils.error import enforce

# the plain versions' vocabulary chunk (the TPU kernel's _VC)
_VC = 2048
# csrc/vocab_xent.cu: the forward's and dx's blocks take 64 rows; their
# vocabulary slices are whole 128-column tiles
_ROWS, _COLS = 64, 128
# the forward's slices: some eight waves of its blocks, two an SM (its
# ring of 110.6 KB), so that the last wave is a small share, with at
# least _FWD_MIN_TILES column tiles a slice; its partials are 12 bytes a
# row and slice (tools/torch_vocab_xent_slices.py sweeps S). The dx kernel
# runs one block of 64 rows and 512 columns of D an SM: its slices fill
# one wave, their partials [S, N, D] held under _DX_PARTIAL_BYTES
_FWD_BLOCKS_PER_SM = 16
_FWD_MIN_TILES = 4
_DX_DC = 512
_DX_PARTIAL_BYTES = 64 * 2**20


def _acc_dtype(x: torch.Tensor) -> torch.dtype:
    return torch.promote_types(x.dtype, torch.float32)


def _ids(labels: torch.Tensor, V: int) -> torch.Tensor:
    """Labels as int64 ids, -1 where out of [0, V): such a label matches
    no column (gold 0, as JAX's one-hot gives), and nothing indexes with
    it. A float carrier truncates toward zero, as JAX's astype does."""
    lab = labels.long()
    return torch.where((lab >= 0) & (lab < V), lab, torch.full_like(lab, -1))


def _chunk_logits(x, w, b, v0, v1, dt):
    return (x.to(dt) @ w[:, v0:v1].to(x.dtype).to(dt)) + b[v0:v1].to(dt)


def _slice_columns(V: int, S: int):
    """The column ranges of S vocabulary slices: whole 128-column tiles of
    the kernels', split as csrc/vocab_xent.cu slice_tiles splits them."""
    nvt = -(-V // _COLS)
    return [(s * nvt // S * _COLS, min(V, (s + 1) * nvt // S * _COLS))
            for s in range(S)]


def _chunks(v_lo: int, v_hi: int):
    return [(v0, min(v_hi, v0 + _VC)) for v0 in range(v_lo, v_hi, _VC)]


# --- plain versions ----------------------------------------------------------

def vocab_xent_fwd_partials_plain(x, w, b, labels, S: int) -> torch.Tensor:
    """The forward kernel's function: partials [3, S, N], each row's
    online (max, sumexp, gold logit) over each slice's columns, a
    vocabulary chunk at a time."""
    N, V = x.shape[0], w.shape[1]
    dt = _acc_dtype(x)
    lab = _ids(labels, V)
    part = torch.empty(3, S, N, dtype=dt, device=x.device)
    for s, (v_lo, v_hi) in enumerate(_slice_columns(V, S)):
        m = torch.full((N,), NEG, dtype=dt, device=x.device)
        l = torch.zeros(N, dtype=dt, device=x.device)
        g = torch.zeros(N, dtype=dt, device=x.device)
        for v0, v1 in _chunks(v_lo, v_hi):
            logits = _chunk_logits(x, w, b, v0, v1, dt)
            m_new = torch.maximum(m, logits.max(1).values)
            l = l * torch.exp(m - m_new) + torch.exp(
                logits - m_new[:, None]).sum(1)
            m = m_new
            col = torch.arange(v0, v1, device=x.device)
            g = g + (logits * (col[None, :] == lab[:, None]).to(dt)).sum(1)
        part[0, s], part[1, s], part[2, s] = m, l, g
    return part


def vocab_xent_fwd_reduce_plain(part) -> Tuple[torch.Tensor, torch.Tensor]:
    """The combine kernel's function: (nll, lse) [N] from the partials."""
    m = part[0].max(0).values
    l = (part[1] * torch.exp(part[0] - m)).sum(0)
    lse = m + torch.log(torch.clamp(l, min=1e-30))
    return lse - part[2].sum(0), lse


def vocab_xent_plain(x, w, b, labels) -> Tuple[torch.Tensor, torch.Tensor]:
    """The forward's function: (nll, lse) [N], one slice."""
    return vocab_xent_fwd_reduce_plain(
        vocab_xent_fwd_partials_plain(x, w, b, labels, 1))


def _dlogs(x, w, b, labels, lse, ct, v_lo, v_hi):
    """(v0, v1, dlog) of each vocabulary chunk of columns [v_lo, v_hi):
    dlog = (exp(logits - lse) - onehot) * ct, recomputed."""
    dt = _acc_dtype(x)
    lab = _ids(labels, w.shape[1])
    lse_col, ct_col = lse.to(dt)[:, None], ct.to(dt)[:, None]
    for v0, v1 in _chunks(v_lo, v_hi):
        logits = _chunk_logits(x, w, b, v0, v1, dt)
        col = torch.arange(v0, v1, device=x.device)
        onehot = (col[None, :] == lab[:, None]).to(dt)
        yield v0, v1, (torch.exp(logits - lse_col) - onehot) * ct_col


def vocab_xent_bwd_dx_partials_plain(x, w, b, labels, lse, ct, S: int):
    """The dx kernel's function: partials [S, N, D], dlog @ wᵀ over each
    slice's columns, in the accumulate type."""
    N, D = x.shape
    dt = _acc_dtype(x)
    wc = w.to(x.dtype)
    part = torch.zeros(S, N, D, dtype=dt, device=x.device)
    for s, (v_lo, v_hi) in enumerate(_slice_columns(w.shape[1], S)):
        for v0, v1, dlog in _dlogs(x, w, b, labels, lse, ct, v_lo, v_hi):
            part[s] += dlog.to(wc.dtype).to(dt) @ wc[:, v0:v1].to(dt).T
    return part


def vocab_xent_bwd_dx_reduce_plain(part) -> torch.Tensor:
    """The dx combine kernel's function: the partials summed in slice
    order."""
    dx = part[0].clone()
    for s in range(1, part.shape[0]):
        dx += part[s]
    return dx


def vocab_xent_bwd_dw_plain(x, w, b, labels, lse, ct):
    """The dW kernel's function: (dW [D, V], db [V]) in the accumulate
    type."""
    D, V = w.shape
    dt = _acc_dtype(x)
    dw = torch.empty(D, V, dtype=dt, device=x.device)
    db = torch.empty(V, dtype=dt, device=x.device)
    for v0, v1, dlog in _dlogs(x, w, b, labels, lse, ct, 0, V):
        dw[:, v0:v1] = x.to(dt).T @ dlog.to(x.dtype).to(dt)
        db[v0:v1] = dlog.sum(0)
    return dw, db


def vocab_xent_bwd_plain(x, w, b, labels, lse, ct):
    """The backward's function: (dx, dW, db) in x's, w's and b's types."""
    dx = vocab_xent_bwd_dx_partials_plain(x, w, b, labels, lse, ct, 1)[0]
    dw, db = vocab_xent_bwd_dw_plain(x, w, b, labels, lse, ct)
    return dx.to(x.dtype), dw.to(w.dtype), db.to(b.dtype)


# --- the kernels' wrappers ---------------------------------------------------

def _check(where, x, w, b, labels, **rows) -> Tuple[int, int, int]:
    """(N, D, V) of x [N, D] and w [D, V]; raise unless b is [V], labels
    and each of ``rows`` (lse, ct) [N], and labels an integer or float
    tensor on x's device."""
    enforce(x.dim() == 2 and w.dim() == 2 and min(x.shape) >= 1
            and w.shape[1] >= 1 and w.shape[0] == x.shape[1],
            f"{where}: x must be a non-empty [N, D] and w [D, V], got "
            f"{list(x.shape)} and {list(w.shape)}")
    N, D = x.shape
    V = w.shape[1]
    shapes = [("b", b, (V,)), ("labels", labels, (N,))]
    shapes += [(name, a, (N,)) for name, a in rows.items()]
    for name, a, shape in shapes:
        enforce(tuple(a.shape) == shape,
                f"{where}: {name} must be {list(shape)}, got {list(a.shape)}")
    enforce(labels.dtype in (torch.int32, torch.int64)
            or labels.is_floating_point(),
            f"{where}: labels must be int32, int64 or a float carrier of "
            f"ids, got {labels.dtype}")
    enforce(labels.device == x.device,
            f"{where}: labels on {labels.device}, x on {x.device}")
    return N, D, V


def _check_slices(where, S, V) -> None:
    enforce(1 <= S <= -(-V // _COLS),
            f"{where}: S={S} slices of {-(-V // _COLS)} column tiles")


def _sms(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def fwd_slices(x, w) -> int:
    """The forward's slices on x's device (1 off the card): about
    _FWD_BLOCKS_PER_SM blocks of 64 rows an SM, each slice at least
    _FWD_MIN_TILES column tiles; then the fewest slices that hold no more
    tiles each, so that they come out even (47 slices of 5 tiles over 512
    rows at V = 30000, not 58 of 4 or 5). At least 1."""
    if x.device.type != "cuda":
        return 1
    nvt = -(-w.shape[1] // _COLS)
    row_tiles = -(-x.shape[0] // _ROWS)
    S = max(1, min(nvt // _FWD_MIN_TILES,
                   _FWD_BLOCKS_PER_SM * _sms(x.device) // row_tiles))
    return -(-nvt // -(-nvt // S))


def dx_slices(x, w) -> int:
    """The dx kernel's slices on x's device (1 off the card): as many as
    keep its blocks (row tiles x D chunks x S) within one wave of one an
    SM, at least 1, their partials held under _DX_PARTIAL_BYTES. At S = 1
    the one partial is dx itself."""
    if x.device.type != "cuda":
        return 1
    N, D = x.shape
    blocks = -(-N // _ROWS) * -(-D // _DX_DC)
    S = min(-(-w.shape[1] // _COLS), _sms(x.device) // blocks,
            _DX_PARTIAL_BYTES // (4 * N * D))
    return max(1, S)


def _card_labels(where, x, w, b, labels, V, *rows) -> torch.Tensor:
    """Check the float tensors for the kernels; the labels as the
    contiguous int32 ids they read."""
    _build.check_cuda_tensors(where, [x, w, b, *rows])
    return _ids(labels, V).to(torch.int32).contiguous()


def _ptrs(*tensors):
    return [a.data_ptr() for a in tensors]


_FWD = _build.GridKernel("vocab_xent_fwd", n_ptrs=5, source="vocab_xent",
                         n_ints=4)
_FWD_REDUCE = _build.GridKernel("vocab_xent_fwd_reduce", n_ptrs=3,
                                source="vocab_xent", n_ints=2)
_DX = _build.GridKernel("vocab_xent_bwd_dx", n_ptrs=7, source="vocab_xent",
                        n_ints=4)
_DX_REDUCE = _build.GridKernel("vocab_xent_bwd_dx_reduce", n_ptrs=2,
                               source="vocab_xent", n_ints=3)
_DW = _build.GridKernel("vocab_xent_bwd_dw", n_ptrs=8, source="vocab_xent")


def vocab_xent_fwd_partials(x, w, b, labels, S: int) -> torch.Tensor:
    """Partials [3, S, N]: the kernel ``vocab_xent_fwd`` for CUDA tensors,
    :func:`vocab_xent_fwd_partials_plain` for CPU tensors."""
    N, D, V = _check("vocab_xent_fwd", x, w, b, labels)
    _check_slices("vocab_xent_fwd", S, V)
    if x.device.type == "cpu":
        return vocab_xent_fwd_partials_plain(x, w, b, labels, S)
    lab = _card_labels("vocab_xent_fwd", x, w, b, labels, V)
    part = torch.empty(3, S, N, device=x.device)
    _FWD.launch(_ptrs(x, w, b, lab, part), N, D, V, S, x.device)
    _kernels.launches["vocab_xent_fwd"] += 1
    return part


def vocab_xent_fwd_reduce(part) -> Tuple[torch.Tensor, torch.Tensor]:
    """(nll, lse) [N] from partials [3, S, N]: the kernel
    ``vocab_xent_fwd_reduce`` for CUDA tensors,
    :func:`vocab_xent_fwd_reduce_plain` for CPU tensors."""
    enforce(part.dim() == 3 and part.shape[0] == 3 and part.shape[1] >= 1,
            f"vocab_xent_fwd_reduce: partials must be [3, S, N], got "
            f"{list(part.shape)}")
    if part.device.type == "cpu":
        return vocab_xent_fwd_reduce_plain(part)
    _build.check_cuda_tensors("vocab_xent_fwd_reduce", [part])
    _, S, N = part.shape
    nll = torch.empty(N, device=part.device)
    lse = torch.empty(N, device=part.device)
    _FWD_REDUCE.launch(_ptrs(part, nll, lse), N, S, part.device)
    _kernels.launches["vocab_xent_fwd_reduce"] += 1
    return nll, lse


def vocab_xent_bwd_dx_partials(x, w, b, labels, lse, ct, S: int):
    """dx partials [S, N, D]: the kernel ``vocab_xent_bwd_dx`` for CUDA
    tensors, :func:`vocab_xent_bwd_dx_partials_plain` for CPU tensors."""
    N, D, V = _check("vocab_xent_bwd_dx", x, w, b, labels, lse=lse, ct=ct)
    _check_slices("vocab_xent_bwd_dx", S, V)
    if x.device.type == "cpu":
        return vocab_xent_bwd_dx_partials_plain(x, w, b, labels, lse, ct, S)
    lab = _card_labels("vocab_xent_bwd_dx", x, w, b, labels, V, lse, ct)
    part = torch.empty(S, N, D, device=x.device)
    _DX.launch(_ptrs(x, w, b, lab, lse, ct, part), N, D, V, S, x.device)
    _kernels.launches["vocab_xent_bwd_dx"] += 1
    return part


def vocab_xent_bwd_dx_reduce(part) -> torch.Tensor:
    """dx [N, D] from partials [S, N, D]: the kernel
    ``vocab_xent_bwd_dx_reduce`` for CUDA tensors,
    :func:`vocab_xent_bwd_dx_reduce_plain` for CPU tensors."""
    enforce(part.dim() == 3 and min(part.shape) >= 1,
            f"vocab_xent_bwd_dx_reduce: partials must be [S, N, D], got "
            f"{list(part.shape)}")
    if part.device.type == "cpu":
        return vocab_xent_bwd_dx_reduce_plain(part)
    _build.check_cuda_tensors("vocab_xent_bwd_dx_reduce", [part])
    S, N, D = part.shape
    dx = torch.empty(N, D, device=part.device)
    _DX_REDUCE.launch(_ptrs(part, dx), N, D, S, part.device)
    _kernels.launches["vocab_xent_bwd_dx_reduce"] += 1
    return dx


def vocab_xent_bwd_dw(x, w, b, labels, lse, ct):
    """(dW [D, V], db [V]): the kernel ``vocab_xent_bwd_dw`` for CUDA
    tensors, :func:`vocab_xent_bwd_dw_plain` for CPU tensors."""
    N, D, V = _check("vocab_xent_bwd_dw", x, w, b, labels, lse=lse, ct=ct)
    if x.device.type == "cpu":
        return vocab_xent_bwd_dw_plain(x, w, b, labels, lse, ct)
    lab = _card_labels("vocab_xent_bwd_dw", x, w, b, labels, V, lse, ct)
    dw = torch.empty(D, V, device=x.device)
    db = torch.empty(V, device=x.device)
    _DW.launch(_ptrs(x, w, b, lab, lse, ct, dw, db), N, D, V, x.device)
    _kernels.launches["vocab_xent_bwd_dw"] += 1
    return dw, db


def vocab_xent_fwd(x, w, b, labels) -> Tuple[torch.Tensor, torch.Tensor]:
    """(nll, lse) [N]: the partials over :func:`fwd_slices` slices, then
    their combine (the kernels for CUDA tensors, the plain versions for
    CPU tensors)."""
    return vocab_xent_fwd_reduce(vocab_xent_fwd_partials(
        x, w, b, labels, fwd_slices(x, w)))


def vocab_xent_bwd(x, w, b, labels, lse, ct):
    """(dx, dW, db) in x's, w's and b's types: the dx partials over
    :func:`dx_slices` slices and their sum (none where S = 1: the one
    partial is dx), then dW and db (the kernels for CUDA tensors, the
    plain versions for CPU tensors)."""
    S = dx_slices(x, w)
    part = vocab_xent_bwd_dx_partials(x, w, b, labels, lse, ct, S)
    dx = part[0] if S == 1 else vocab_xent_bwd_dx_reduce(part)
    del part
    dw, db = vocab_xent_bwd_dw(x, w, b, labels, lse, ct)
    return dx.to(x.dtype), dw.to(w.dtype), db.to(b.dtype)


class _VocabXent(torch.autograd.Function):
    """vocab_xent with its gradient: the forward keeps lse, the backward
    recomputes the logits from it. Labels get no gradient."""

    @staticmethod
    def forward(ctx, x, w, b, labels):
        nll, lse = vocab_xent_fwd(x, w, b, labels)
        ctx.save_for_backward(x, w, b, labels, lse)
        return nll

    @staticmethod
    def backward(ctx, ct):
        x, w, b, labels, lse = ctx.saved_tensors
        dx, dw, db = vocab_xent_bwd(x, w, b, labels, lse, ct.contiguous())
        return dx, dw, db, None


def vocab_xent(x, w, b, labels):
    """Per-row softmax cross-entropy NLL [N] of x @ w + b against labels,
    without an [N, V] logits buffer.

    x [N, D]; w [D, V]; b [V]; labels [N] integer ids (int32 or int64) or
    JAX's float carrier of them (exact below 2**24); a label outside
    [0, V) matches no column, so its row's NLL is the lse. Differentiable
    in x, w and b. CPU tensors run the plain versions. CUDA tensors launch
    the kernels: float32, contiguous, on one device; anything else
    raises."""
    _check("vocab_xent", x, w, b, labels)
    return _VocabXent.apply(x, w, b, labels)
