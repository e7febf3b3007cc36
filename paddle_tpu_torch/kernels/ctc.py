"""CTC forward-backward: the Hopper kernels' wrappers, their plain
versions and the autograd Function that joins them.

Counterpart of ``paddle_tpu/kernels/ctc.py`` ``ctc_fb`` and its
``custom_vjp``. Two kernels in ``csrc/ctc.cu`` (its source note gives the
design and the bound on an H100):

- ``ctc_fwd``: the alpha recursion over the S = 2U+1 blank-interleaved
  states, one warp a batch row, writing alphas [T, B, S] at every step;
- ``ctc_bwd``: the beta recursion in reverse and the posterior marginals
  d_em = -exp(clip(alpha + beta - ll, -80, 0)) * m, before the multiply
  by the cotangent.

The class-axis gather to the extended label sequence and the log-softmax
stay outside the kernels (``ctc_nll_kernel``), so autograd routes the
marginals back into the [B, T, C] logits through them, as in the JAX
package. Nothing is padded: the kernels take B and S as they are.
"""

from __future__ import annotations

from typing import Tuple

import torch

from paddle_tpu_torch import kernels as _kernels
from paddle_tpu_torch.kernels import _build
from paddle_tpu_torch.kernels._util import NEG
from paddle_tpu_torch.utils.error import enforce

# csrc/ctc.cu: one warp a row, lane l holding 2K consecutive states in
# registers (K = 1, 2, 4 or 8, the least that covers S), no shared memory;
# at K = 8 a lane keeps 16 states and 64 prefetched values, and the
# backward takes all 255 registers a thread may have (spilling 64 bytes):
# K = 16 would spill the ring
_LANES, _MAX_K = 32, 8
_MAX_S = 2 * _LANES * _MAX_K


def ctc_kernel_supported(B: int, S: int) -> bool:
    """Whether the kernels take B rows of S extended states on an H100:
    one warp a row, whose 32 lanes hold up to 16 states each in registers.
    That holds up to S = 512 (U = 255 labels), for any B >= 1 and any T."""
    return B >= 1 and 1 <= S <= _MAX_S


# --- plain versions ----------------------------------------------------------

def _shift_right(x, k):
    """x[..., s] -> x[..., s-k], NEG shifted in."""
    return torch.cat([x.new_full(x.shape[:-1] + (k,), NEG), x[..., :-k]], -1)


def _shift_left(x, k):
    return torch.cat([x[..., k:], x.new_full(x.shape[:-1] + (k,), NEG)], -1)


def _lse3(a, b, c):
    """LSE of three terms as the TPU kernels form it: the max, floored at
    -1e29 inside the exponents so that all-NEG states give log(0)."""
    mx = torch.maximum(torch.maximum(a, b), c)
    mx_s = torch.clamp(mx, min=-1e29)
    return mx + torch.log(torch.exp(a - mx_s) + torch.exp(b - mx_s)
                          + torch.exp(c - mx_s))


def ctc_alphas_plain(em, mask_tb, skip, ok):
    """The forward kernel's function as a PyTorch time loop: alphas
    [T, B, S] from em [T, B, S], mask_tb [T, B], skip and ok [B, S]."""
    T, B, S = em.shape
    live, can_skip = ok > 0, skip > 0
    neg = torch.full_like(em[0], NEG)
    first = torch.arange(S, device=em.device)[None, :] < 2
    a = torch.where(first & live, em[0], neg)
    out = [a]
    for t in range(1, T):
        a1 = _shift_right(a, 1)
        a2 = torch.where(can_skip, _shift_right(a, 2), neg)
        nxt = _lse3(a, a1, a2) + em[t]
        # all-dead states give log(0) = -inf: clamp, keep everything finite
        nxt = torch.where(live, torch.clamp(nxt, min=NEG), neg)
        keep = (1.0 - mask_tb[t, :, None]) > 0
        a = torch.where(keep, a, nxt)        # select, not blend: inf-safe
        out.append(a)
    return torch.stack(out)


def ctc_bwd_plain(em, mask_tb, skip, ok, beta_init, alphas, ll):
    """The backward kernel's function as a reverse PyTorch time loop:
    d_em [T, B, S], the negated posterior marginals times the mask (before
    the multiply by the cotangent), from ll [B] = log P(labels)."""
    T = em.shape[0]
    live, can_skip = ok > 0, skip > 0
    neg = torch.full_like(em[0], NEG)
    lz = ll[:, None]
    beta = beta_init
    d_em = torch.empty_like(em)
    for t in reversed(range(T)):
        m = mask_tb[t, :, None]
        # beta = log P(emissions after t | state at t): the posterior at t
        post = torch.exp(torch.clamp(alphas[t] + beta - lz, -80.0, 0.0))
        d_em[t] = -(post * m)
        # beta_{t-1}[s] = LSE over s, s+1, s+2 (where the TARGET can skip)
        # of beta_t + em_t
        be = torch.where(live, beta + em[t], neg)
        b1 = _shift_left(be, 1)
        b2 = _shift_left(torch.where(can_skip, be, neg), 2)
        prev = torch.where(live, torch.clamp(_lse3(be, b1, b2), min=NEG), neg)
        beta = torch.where(m > 0, prev, beta)  # select, not blend: inf-safe
    return d_em


# --- the kernels' wrappers ---------------------------------------------------

def _check(where, em, mask_tb, skip, ok, **rows) -> Tuple[int, int, int]:
    """(T, B, S) of em [T, B, S]; raise unless mask_tb is [T, B], skip, ok
    and each of ``rows`` (beta_init) [B, S]."""
    enforce(em.dim() == 3 and min(em.shape) >= 1,
            f"{where}: em must be a non-empty [T, B, S], got "
            f"{tuple(em.shape)}")
    T, B, S = em.shape
    shapes = [("mask_tb", mask_tb, (T, B)), ("skip", skip, (B, S)),
              ("ok", ok, (B, S))]
    shapes += [(name, a, (B, S)) for name, a in rows.items()]
    for name, a, shape in shapes:
        enforce(tuple(a.shape) == shape,
                f"{where}: {name} must be {list(shape)}, got {list(a.shape)}")
    return T, B, S


def _check_card(name, tensors, B, S) -> None:
    _build.check_cuda_tensors(name, tensors)
    enforce(ctc_kernel_supported(B, S),
            f"{name}: B={B}, S={S} is outside the kernels' shapes "
            "(ctc_kernel_supported)")


_FWD = _build.GridKernel("ctc_fwd", n_ptrs=5, source="ctc")
_BWD = _build.GridKernel("ctc_bwd", n_ptrs=8, source="ctc")


def ctc_alphas(em, mask_tb, skip, ok):
    """alphas [T, B, S]: the forward kernel, ``ctc_fwd``, for CUDA
    tensors; :func:`ctc_alphas_plain` for CPU tensors."""
    T, B, S = _check("ctc_fwd", em, mask_tb, skip, ok)
    if em.device.type == "cpu":
        return ctc_alphas_plain(em, mask_tb, skip, ok)
    _check_card("ctc_fwd", [em, mask_tb, skip, ok], B, S)
    alphas = torch.empty_like(em)
    _FWD.launch([em.data_ptr(), mask_tb.data_ptr(), skip.data_ptr(),
                 ok.data_ptr(), alphas.data_ptr()], B, T, S, em.device)
    _kernels.launches["ctc_fwd"] += 1
    return alphas


def ctc_bwd(em, mask_tb, skip, ok, beta_init, alphas, ll):
    """d_em [T, B, S] (before the multiply by the cotangent): the backward
    kernel, ``ctc_bwd``, for CUDA tensors; :func:`ctc_bwd_plain` for CPU
    tensors."""
    T, B, S = _check("ctc_bwd", em, mask_tb, skip, ok, beta_init=beta_init)
    for name, a, shape in (("alphas", alphas, (T, B, S)), ("ll", ll, (B,))):
        enforce(tuple(a.shape) == shape,
                f"ctc_bwd: {name} must be {list(shape)}, got {list(a.shape)}")
    if em.device.type == "cpu":
        return ctc_bwd_plain(em, mask_tb, skip, ok, beta_init, alphas, ll)
    _check_card("ctc_bwd", [em, mask_tb, skip, ok, beta_init, alphas, ll],
                B, S)
    d_em = torch.empty_like(em)
    _BWD.launch([em.data_ptr(), mask_tb.data_ptr(), skip.data_ptr(),
                 ok.data_ptr(), beta_init.data_ptr(), alphas.data_ptr(),
                 ll.data_ptr(), d_em.data_ptr()], B, T, S, em.device)
    _kernels.launches["ctc_bwd"] += 1
    return d_em


def _loglik(alphas, beta_init):
    """ll [B] off the last alpha row (masked steps carry, so row T-1 holds
    each row's last valid alpha), at the terminal states of beta_init."""
    terminal = torch.where(beta_init > NEG / 2, alphas[-1],
                           torch.full_like(beta_init, NEG))
    mx = terminal.max(dim=-1, keepdim=True).values
    mx_s = torch.clamp(mx, min=-1e29)
    return (mx + torch.log(torch.exp(terminal - mx_s).sum(
        -1, keepdim=True)))[:, 0]


class _CtcFB(torch.autograd.Function):
    """ctc_fb with its gradient: the forward keeps the alphas, the
    backward runs :func:`ctc_bwd` over them and multiplies by ct."""

    @staticmethod
    def forward(ctx, em, mask_tb, skip, ok, beta_init):
        ctx.set_materialize_grads(False)
        alphas = ctc_alphas(em, mask_tb, skip, ok)
        ll = _loglik(alphas, beta_init)
        ctx.save_for_backward(em, mask_tb, skip, ok, beta_init, alphas, ll)
        return -ll

    @staticmethod
    def backward(ctx, ct):
        if ct is None:
            return None, None, None, None, None
        d_em = ctc_bwd(*ctx.saved_tensors)
        return d_em * ct[None, :, None], None, None, None, None


def ctc_fb(em, mask_tb, skip, ok, beta_init):
    """[B] negative log-likelihood from gathered extended emissions.

    em [T, B, S] log p at the extended labels (time-major); mask_tb [T, B]
    1.0 at valid steps; skip [B, S] 1.0 where the s-2 -> s transition is
    legal; ok [B, S] 1.0 inside each row's 2*ulen+1 states; beta_init
    [B, S] 0.0 at the terminal states, NEG elsewhere. Differentiable in em,
    through the explicit posterior marginals, when grad is enabled and em
    requires it; otherwise only the forward runs. CPU tensors run the
    plain versions. CUDA tensors launch the kernels: float32, contiguous,
    on one device, in the shapes ``ctc_kernel_supported`` takes; anything
    else raises."""
    _check("ctc_fb", em, mask_tb, skip, ok, beta_init=beta_init)
    if torch.is_grad_enabled() and em.requires_grad:
        return _CtcFB.apply(em, mask_tb, skip, ok, beta_init)
    return -_loglik(ctc_alphas(em, mask_tb, skip, ok), beta_init)


def extended_labels(labels, label_mask, blank, S):
    """The blank-interleaved sequence and its masks, for [B, U] labels:
    (ext [B, S] class ids, ok, skip, slen [B]), ok and skip boolean."""
    B = labels.shape[0]
    ext = torch.full((B, S), blank, dtype=torch.int64, device=labels.device)
    ext[:, 1::2] = labels.long()
    slen = 2 * label_mask.sum(-1).long() + 1
    pos = torch.arange(S, device=labels.device)[None, :]
    ok = pos < slen[:, None]
    ext_prev2 = torch.cat([torch.full_like(ext[:, :2], -1), ext[:, :-2]], 1)
    skip = (ext != blank) & (ext != ext_prev2)
    return ext, ok, skip, slen


def ctc_nll_kernel(logits, labels, in_mask, label_mask, blank=0):
    """[B] CTC negative log-likelihood through the ``ctc_fb`` Function:
    the counterpart of ``ctc_nll_pallas``. logits [B, T, C]; labels
    [B, U]; in_mask [B, T]; label_mask [B, U]. The log-softmax, the
    extended labels and the gather to [B, T, S] stay outside the kernels,
    so autograd routes the marginals back through them; nothing is
    padded."""
    logp = torch.log_softmax(logits, dim=-1)
    B, T, _ = logp.shape
    S = 2 * labels.shape[1] + 1
    ext, ok, skip, slen = extended_labels(labels, label_mask, blank, S)
    skip = skip & ok
    pos = torch.arange(S, device=logits.device)[None, :]
    terminal = (pos == torch.clamp(slen - 1, min=0)[:, None]) | (
        (pos == torch.clamp(slen - 2, min=0)[:, None]) & (slen >= 2)[:, None])
    dt = logp.dtype
    em = torch.gather(logp, 2, ext[:, None, :].expand(B, T, S))
    beta_init = torch.where(terminal, 0.0, NEG).to(dt)
    return ctc_fb(em.transpose(0, 1).contiguous(),
                  in_mask.transpose(0, 1).to(dt).contiguous(),
                  skip.to(dt), ok.to(dt), beta_init)
