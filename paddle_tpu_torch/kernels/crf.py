"""Linear-chain CRF log-partition: the Hopper kernels' wrappers, their
plain versions and the autograd Function that joins them.

Counterpart of ``paddle_tpu/kernels/crf.py`` ``crf_logz`` and its
``custom_vjp``. Four kernels in ``csrc/crf.cu`` (its source note gives
the design and the bound on an H100):

- ``crf_fwd``: the alpha recursion, one batch row over the W warps of a
  block that :func:`crf_fwd_plan` picks (exp(trans) in registers, one
  block barrier a step), writing alphas [T, B, L] at every step;
- ``crf_bwd``: the beta recursion in reverse, one warp per batch row,
  writing betas [T, B, L] at every step;
- ``crf_bwd_marginals``: from the alphas and the betas, every step at
  once, the unary posteriors (d_em) and each row's ct-weighted pairwise
  marginals [B, L, L], summed over the steps in a fixed order;
- ``crf_bwd_reduce``: d_trans, the rows' pairwise marginals summed in a
  fixed order, times exp(trans).

Together the three backward kernels compute what the TPU's
``_bwd_kernel`` does in one time loop (:func:`crf_bwd_plain`): only the
beta recursion is serial. The wrapper forms logz = LSE(alphas[T-1] +
end), d_start and d_end in PyTorch, as the JAX package forms them outside
its kernels.

The kernels take float32. :func:`crf_logz` takes bf16 emissions and
parameters too, as the JAX kernels do: it widens them to float32 around
the same kernels (the JAX kernels compute in ``promote_types(em.dtype,
float32)``), returns log Z in float32 and the gradients in their inputs'
dtypes.
"""

from __future__ import annotations

import warnings
from typing import NamedTuple, Tuple

import torch

from paddle_tpu_torch import kernels as _kernels
from paddle_tpu_torch.kernels import _build
from paddle_tpu_torch.kernels._util import NEG
from paddle_tpu_torch.utils.error import enforce

# the most tags the kernels take: the bound of the first port's backward,
# which held two L x L float matrices in a block's shared memory (227 KiB
# on an H100 SXM); the kernels' cases on the card reach it (chip_smoke.py)
_MAX_TAGS = 169

# the backward's exponent clip (csrc/crf.cu): exact while every |trans| < 80
_TRANS_BOUND = 80.0


# csrc/crf.cu CRF_FWD_INSTANCES: the forward's (K, W, IS) instances, K =
# ceil(L / 32) tags a lane, W warps a row, IS = _fwd_slice(L, W) rows of
# exp(trans) a warp in registers; the plan's W and, at L = 67 and 169, the
# others that tools/torch_crf_fwd_step_cost.py times beside it
_FWD_INSTANCES = ((1, 4, 4), (1, 4, 8), (2, 4, 12), (2, 4, 16), (3, 1, 68),
                  (3, 2, 36), (3, 4, 20), (3, 4, 24), (3, 8, 12), (4, 4, 28),
                  (4, 4, 32), (4, 8, 16), (5, 8, 20), (6, 8, 24),
                  (6, 16, 12))


class CrfFwdPlan(NamedTuple):
    """The forward's block for L tags: W warps a batch row, each holding
    IS = 4 ceil(L / 4W) rows of exp(trans - mt) for its lanes' K =
    ceil(L / 32) tags in registers."""
    W: int
    K: int
    IS: int


def _fwd_slice(L: int, W: int) -> int:
    """csrc/crf.cu fwd_slice: a warp's rows of exp(trans), L over W warps
    rounded up to a multiple of 4."""
    return 4 * -(-L // (4 * W))


def fwd_plan(L: int, W: int) -> CrfFwdPlan:
    """The forward with W warps a row at L tags; raises where csrc/crf.cu
    has no such instance."""
    enforce(1 <= L <= _MAX_TAGS, f"crf_fwd: L={L} is outside 1..{_MAX_TAGS}")
    plan = CrfFwdPlan(W, -(-L // 32), _fwd_slice(L, W))
    enforce(plan[1:] + (W,) in [(k, c, w) for k, w, c in _FWD_INSTANCES],
            f"crf_fwd: no instance of W={W} warps a row at L={L} "
            "(csrc/crf.cu CRF_FWD_INSTANCES)")
    return plan


def crf_fwd_plan(B: int, L: int) -> CrfFwdPlan:
    """The forward's block for (B, L), from L alone: W = 4 warps a row up
    to L = 128 (at most 32 rows x 4 tags, 128 floats of exp(trans) a
    lane), 8 above (L = 169: 24 rows x 6 tags). W = 4 was the fastest of
    1, 2, 4 and 8 at L = 45, 67 and 100, W = 8 of 8 and 16 at L = 169
    (PERF.md, PR 16)."""
    return fwd_plan(L, 4 if L <= 128 else 8)


def _bwd_smem_bytes(L: int) -> int:
    """csrc/crf.cu bwd_smem_bytes, the beta recursion's shared memory:
    exp(trans - mt), L rows each padded to a multiple of 4 floats whose
    float4 count is odd, and one such row for exp(v - mx). The forward
    takes at most 37 KiB, the marginals kernel 20 KiB."""
    return 4 * (L + 1) * 4 * ((-(-L // 4)) | 1)


def crf_kernel_supported(B: int, L: int) -> bool:
    """Whether the kernels take B rows of L tags on an H100: any B >= 1
    and any T, L up to 169 (:data:`_MAX_TAGS`)."""
    return B >= 1 and 1 <= L <= _MAX_TAGS


def _check_trans_bound(trans: torch.Tensor) -> None:
    """Warn when a transition matrix on the CPU breaks the backward's
    bound (every |trans| < 80, see csrc/crf.cu). On the card the check
    would cost a device-to-host sync in every training step, so it is
    skipped there and the bound is documented at :func:`crf_logz`.
    NEG-magnitude entries are dead-state sentinels (their marginals are
    exactly zero) and are ignored."""
    if trans.device.type != "cpu":
        return
    a = trans.detach().abs()
    mx = float(torch.where(a >= -NEG / 2, torch.zeros_like(a), a).max())
    if mx >= _TRANS_BOUND:
        warnings.warn(
            f"crf_logz: max |trans| = {mx:.1f} >= {_TRANS_BOUND:.0f}; the "
            "backward's exponent clip truncates pairwise marginals beyond "
            "this bound, so d_trans may be inexact. Rescale or regularise "
            "the transition weights (|trans| < 80 is the supported range).",
            RuntimeWarning, stacklevel=3)


# --- plain versions ----------------------------------------------------------

def crf_alphas_plain(em, mask_tb, start, trans):
    """The forward kernel's function as a PyTorch time loop: alphas
    [T, B, L] from em [T, B, L], mask_tb [T, B], start [L], trans [L, L]."""
    T = em.shape[0]
    mt = trans.max()
    etr = torch.exp(trans - mt)
    a = start[None, :] + em[0]
    out = [a]
    for t in range(1, T):
        mx = a.max(dim=-1, keepdim=True).values
        prod = torch.matmul(torch.exp(a - mx), etr)
        nxt = torch.log(torch.clamp(prod, min=1e-30)) + mx + mt + em[t]
        keep = (1.0 - mask_tb[t, :, None]) > 0
        a = torch.where(keep, a, nxt)        # select, not blend: inf-safe
        out.append(a)
    return torch.stack(out)


def crf_bwd_plain(em, mask_tb, end, trans, alphas, logz, ct):
    """The backward kernel's function as a reverse PyTorch time loop,
    written from the TPU's ``_bwd_kernel`` with its clips: returns d_em
    [T, B, L] (unary posteriors times m and ct) and the rows' ct-weighted
    pairwise marginals [B, L, L]."""
    T, B, L = em.shape
    mt = trans.max()
    etr_t = torch.exp(trans - mt).t()
    lz, c = logz[:, None], ct[:, None]
    beta = end[None, :].expand(B, L)
    partial = em.new_zeros(B, L, L)
    d_em = torch.empty_like(em)
    neg_row = em.new_full((B, L), NEG)
    for t in reversed(range(T)):
        m = mask_tb[t, :, None]
        e = em[t]
        post = torch.exp(torch.clamp(alphas[t] + beta - lz, -80.0, 0.0))
        d_em[t] = post * m * c
        a_prev = alphas[t - 1] if t > 0 else neg_row
        s = torch.clamp(a_prev.max(dim=-1, keepdim=True).values, min=-1e29)
        ea = torch.exp(a_prev - s) * m
        eb = torch.exp(torch.clamp(e + beta - lz + s, -80.0, 80.0)) * c
        partial = partial + ea[:, :, None] * eb[:, None, :]
        v = e + beta
        mx = v.max(dim=-1, keepdim=True).values
        prod = torch.matmul(torch.exp(v - mx), etr_t)
        prev = torch.log(torch.clamp(prod, min=1e-30)) + mx + mt
        beta = torch.where(m > 0, prev, beta)  # select, not blend: inf-safe
    return d_em, partial


def crf_betas_plain(em, mask_tb, end, trans):
    """The recursion kernel's function: betas [T, B, L], beta_t of every
    step as :func:`crf_bwd_plain`'s loop forms it (beta_{T-1} = end; a
    masked step keeps beta)."""
    T, B, L = em.shape
    mt = trans.max()
    etr_t = torch.exp(trans - mt).t()
    beta = end[None, :].expand(B, L)
    betas = torch.empty_like(em)
    for t in reversed(range(T)):
        betas[t] = beta
        m = mask_tb[t, :, None]
        v = em[t] + beta
        mx = v.max(dim=-1, keepdim=True).values
        prod = torch.matmul(torch.exp(v - mx), etr_t)
        prev = torch.log(torch.clamp(prod, min=1e-30)) + mx + mt
        beta = torch.where(m > 0, prev, beta)  # select, not blend: inf-safe
    return betas


def crf_marginals_plain(em, mask_tb, alphas, betas, logz, ct):
    """The marginals kernel's function: (d_em [T, B, L], pairwise
    marginals [B, L, L]) from the alphas and the betas, the steps summed
    in :func:`crf_bwd_plain`'s order (t descending). Composed with
    :func:`crf_betas_plain` it is :func:`crf_bwd_plain`."""
    T, B, L = em.shape
    lz, c = logz[:, None], ct[:, None]
    partial = em.new_zeros(B, L, L)
    d_em = torch.empty_like(em)
    neg_row = em.new_full((B, L), NEG)
    for t in reversed(range(T)):
        m = mask_tb[t, :, None]
        beta = betas[t]
        post = torch.exp(torch.clamp(alphas[t] + beta - lz, -80.0, 0.0))
        d_em[t] = post * m * c
        a_prev = alphas[t - 1] if t > 0 else neg_row
        s = torch.clamp(a_prev.max(dim=-1, keepdim=True).values, min=-1e29)
        ea = torch.exp(a_prev - s) * m
        eb = torch.exp(torch.clamp(em[t] + beta - lz + s, -80.0, 80.0)) * c
        partial = partial + ea[:, :, None] * eb[:, None, :]
    return d_em, partial


def crf_dtrans_plain(partial, trans):
    """The reduction kernel's function: the rows' pairwise marginals
    summed, times exp(trans)."""
    return partial.sum(dim=0) * torch.exp(trans)


# --- the kernels' wrappers ---------------------------------------------------

def _check(where, em, mask_tb, **arrays) -> Tuple[int, int, int]:
    """(T, B, L) of em [T, B, L]; raise unless mask_tb is [T, B] and each
    of ``arrays`` has its shape: trans [L, L], start and end [L], alphas
    and betas [T, B, L], logz and ct [B]."""
    enforce(em.dim() == 3 and min(em.shape) >= 1,
            f"{where}: em must be a non-empty [T, B, L], got "
            f"{tuple(em.shape)}")
    T, B, L = em.shape
    want = {"mask_tb": (T, B), "trans": (L, L), "start": (L,), "end": (L,),
            "alphas": (T, B, L), "betas": (T, B, L), "logz": (B,),
            "ct": (B,)}
    for name, a in dict(mask_tb=mask_tb, **arrays).items():
        enforce(tuple(a.shape) == want[name],
                f"{where}: {name} must be {list(want[name])}, got "
                f"{list(a.shape)}")
    return T, B, L


def _check_card(name, tensors, B, L) -> None:
    _build.check_cuda_tensors(name, tensors)
    enforce(crf_kernel_supported(B, L),
            f"{name}: B={B}, L={L} is outside the kernels' shapes "
            "(crf_kernel_supported)")


_FWD = _build.GridKernel("crf_fwd", n_ptrs=5, source="crf", n_ints=4)
_BWD = _build.GridKernel("crf_bwd", n_ptrs=5, source="crf")
_MARGINALS = _build.GridKernel("crf_bwd_marginals", n_ptrs=8, source="crf")
_REDUCE = _build.GridKernel("crf_bwd_reduce", n_ptrs=3, source="crf")


def crf_alphas(em, mask_tb, start, trans, plan=None):
    """alphas [T, B, L]: the forward kernel, ``crf_fwd``, with the block of
    ``plan`` (by default :func:`crf_fwd_plan`'s), for CUDA tensors;
    :func:`crf_alphas_plain` for CPU tensors."""
    T, B, L = _check("crf_fwd", em, mask_tb, trans=trans, start=start)
    if em.device.type == "cpu":
        return crf_alphas_plain(em, mask_tb, start, trans)
    _check_card("crf_fwd", [em, mask_tb, start, trans], B, L)
    plan = plan or crf_fwd_plan(B, L)
    alphas = torch.empty_like(em)
    _FWD.launch([em.data_ptr(), mask_tb.data_ptr(), start.data_ptr(),
                 trans.data_ptr(), alphas.data_ptr()], B, T, L, plan.W,
                em.device)
    _kernels.launches["crf_fwd"] += 1
    return alphas


def crf_betas(em, mask_tb, end, trans):
    """betas [T, B, L]: the recursion kernel, ``crf_bwd``, for CUDA
    tensors; :func:`crf_betas_plain` for CPU tensors."""
    T, B, L = _check("crf_bwd", em, mask_tb, trans=trans, end=end)
    if em.device.type == "cpu":
        return crf_betas_plain(em, mask_tb, end, trans)
    _check_card("crf_bwd", [em, mask_tb, end, trans], B, L)
    betas = torch.empty_like(em)
    _BWD.launch([em.data_ptr(), mask_tb.data_ptr(), end.data_ptr(),
                 trans.data_ptr(), betas.data_ptr()], B, T, L, em.device)
    _kernels.launches["crf_bwd"] += 1
    return betas


def crf_marginals(em, mask_tb, alphas, betas, logz, ct):
    """(d_em [T, B, L], pairwise marginals [B, L, L]) for the cotangent
    ct [B] of logz: the marginals kernel, ``crf_bwd_marginals``, for CUDA
    tensors; :func:`crf_marginals_plain` for CPU tensors."""
    T, B, L = _check("crf_bwd_marginals", em, mask_tb, alphas=alphas,
                     betas=betas, logz=logz, ct=ct)
    if em.device.type == "cpu":
        return crf_marginals_plain(em, mask_tb, alphas, betas, logz, ct)
    _check_card("crf_bwd_marginals",
                [em, mask_tb, alphas, betas, logz, ct], B, L)
    d_em = torch.empty_like(em)
    partial = torch.empty((B, L, L), device=em.device, dtype=torch.float32)
    _MARGINALS.launch([em.data_ptr(), mask_tb.data_ptr(), alphas.data_ptr(),
                       betas.data_ptr(), logz.data_ptr(), ct.data_ptr(),
                       d_em.data_ptr(), partial.data_ptr()], B, T, L,
                      em.device)
    _kernels.launches["crf_bwd_marginals"] += 1
    return d_em, partial


def crf_bwd(em, mask_tb, end, trans, alphas, logz, ct):
    """(d_em [T, B, L], pairwise marginals [B, L, L]) for the cotangent
    ct [B] of logz: the beta recursion (:func:`crf_betas`), then the
    marginals (:func:`crf_marginals`): the kernels for CUDA tensors, their
    plain versions for CPU tensors."""
    _check("crf_bwd", em, mask_tb, trans=trans, end=end, alphas=alphas,
           logz=logz, ct=ct)
    return crf_marginals(em, mask_tb, alphas,
                         crf_betas(em, mask_tb, end, trans), logz, ct)


def crf_bwd_reduce(partial, trans):
    """d_trans [L, L] from the rows' pairwise marginals: the reduction
    kernel, ``crf_bwd_reduce``, for CUDA tensors; :func:`crf_dtrans_plain`
    for CPU tensors."""
    enforce(partial.dim() == 3 and tuple(partial.shape[1:]) == tuple(
        trans.shape) and trans.dim() == 2 and trans.shape[0] == trans.shape[1],
            f"crf_bwd_reduce: partial [B, L, L] and trans [L, L] expected, "
            f"got {list(partial.shape)} and {list(trans.shape)}")
    if partial.device.type == "cpu":
        return crf_dtrans_plain(partial, trans)
    B, L = partial.shape[0], partial.shape[1]
    _check_card("crf_bwd_reduce", [partial, trans], B, L)
    d_trans = torch.empty_like(trans)
    _REDUCE.launch([partial.data_ptr(), trans.data_ptr(), d_trans.data_ptr()],
                   B, 1, L, partial.device)
    _kernels.launches["crf_bwd_reduce"] += 1
    return d_trans


def _logz(alphas, end):
    """LSE(alphas[T-1] + end) over the tags: [B]."""
    terminal = alphas[-1] + end[None, :]
    mx = terminal.max(dim=-1, keepdim=True).values
    return (mx + torch.log(torch.exp(terminal - mx).sum(-1,
                                                        keepdim=True)))[:, 0]


class _CrfLogZ(torch.autograd.Function):
    """crf_logz with its gradient: the forward keeps the alphas, the
    backward runs :func:`crf_bwd` and :func:`crf_bwd_reduce` over them."""

    @staticmethod
    def forward(ctx, em, mask_tb, start, end, trans):
        ctx.set_materialize_grads(False)
        alphas = crf_alphas(em, mask_tb, start, trans)
        logz = _logz(alphas, end)
        ctx.save_for_backward(em, mask_tb, end, trans, alphas, logz)
        return logz

    @staticmethod
    def backward(ctx, ct):
        if ct is None:
            return None, None, None, None, None
        em, mask_tb, end, trans, alphas, logz = ctx.saved_tensors
        ct = ct.contiguous()
        d_em, partial = crf_bwd(em, mask_tb, end, trans, alphas, logz, ct)
        d_trans = crf_bwd_reduce(partial, trans)
        # d start = the unary posterior at t=0; d end = the posterior at the
        # last valid step, exp(alpha_last + end - logz)
        d_start = d_em[0].sum(dim=0)
        post_end = torch.exp(torch.clamp(alphas[-1] + end[None, :]
                                         - logz[:, None], -80.0, 0.0))
        d_end = (post_end * ct[:, None]).sum(dim=0)
        return d_em, None, d_start, d_end, d_trans


def crf_logz(em, mask_tb, start, end, trans):
    """[B] log partition function of a linear-chain CRF.

    em [T, B, L] time-major emissions; mask_tb [T, B]; start and end [L];
    trans [L, L]. Differentiable in em, start, end and trans through
    explicit forward-backward marginals, when grad is enabled and any of
    them requires it; otherwise only the forward runs. CPU tensors run the
    plain versions. CUDA tensors launch the kernels: contiguous, on one
    device, in the shapes ``crf_kernel_supported`` takes; anything else
    raises.

    The JAX kernels' dtype rule (``promote_types(em.dtype, float32)``): em,
    start, end and trans share one dtype, float32 or bf16 (float64 on the
    CPU), and are widened to float32 at entry (float64 stays), the mask
    (0/1) too; alpha_0 = start + em[0] is formed in em's dtype, as the
    JAX forward kernel forms it, then widened; the recursions run in
    float32, the plain versions on the CPU and the float32 kernels on the
    card, and log Z comes back in float32. The gradients come back in
    their inputs' dtypes (bf16 d_em rounded once from the float32
    marginals), through the widening's own gradient. Float16 or a mix of
    data dtypes raises.

    Numerical bound: the backward clips its pairwise-marginal exponents at
    +/-80, which is exact only for ``max |trans| < 80``: transition
    magnitudes at or beyond 80 truncate d_trans. A transition matrix on
    the CPU that breaks the bound raises a RuntimeWarning; on the card the
    check is skipped (it would cost a device-to-host sync each step).
    """
    _check("crf_logz", em, mask_tb, trans=trans, start=start, end=end)
    _check_trans_bound(trans)
    dt = _build.widened_dtype("crf_logz", [em, start, end, trans], [mask_tb])
    # alpha_0 = start + em[0], formed in em's dtype
    a0 = (start + em[0]).to(dt) if em.dtype != dt else None
    em, mask_tb, start, end, trans = (
        a.to(dt) for a in (em, mask_tb, start, end, trans))
    if a0 is not None:
        # alpha_0 enters as the first emissions, with a zero start; its
        # gradient reaches start and em[0] in float32 (a0 - s, of two
        # nearby floats, is exact, and so is s + (a0 - s) = a0)
        s = start + em[0]
        em = torch.cat([(s + (a0 - s).detach())[None], em[1:]])
        start = torch.zeros_like(start)
    if torch.is_grad_enabled() and any(
            a.requires_grad for a in (em, start, end, trans)):
        return _CrfLogZ.apply(em, mask_tb, start, end, trans)
    return _logz(crf_alphas(em, mask_tb, start, trans), end)
