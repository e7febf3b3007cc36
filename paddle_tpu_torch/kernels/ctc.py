"""CTC forward-backward: the Hopper kernels' wrappers, their plain
versions and the autograd Function that joins them.

Counterpart of ``paddle_tpu/kernels/ctc.py`` ``ctc_fb`` and its
``custom_vjp``. Three kernels in ``csrc/ctc.cu`` (its source note gives
the design and the bound on an H100):

- ``ctc_fwd``: the alpha recursion over the S = 2U+1 blank-interleaved
  states, one warp a batch row, writing alphas [T, B, S] at every step;
- ``ctc_bwd``: the beta recursion in reverse, one warp a batch row,
  writing betas [T, B, S] at every step;

  in both, lane l holds the :func:`ctc_states_per_lane` consecutive states
  from N l in registers;
- ``ctc_bwd_marginals``: from the alphas and the betas, every (t, b, s)
  at once, the posterior marginals d_em = -exp(clip(alpha + beta - ll,
  -80, 0)) * m times the cotangent.

Together the two backward kernels compute what the TPU's ``_bwd_kernel``
does in one time loop (:func:`ctc_bwd_plain`, then the multiply by the
cotangent): only the beta recursion is serial.

The class-axis gather to the extended label sequence and the log-softmax
stay outside the kernels (``ctc_nll_kernel``), so autograd routes the
marginals back into the [B, T, C] logits through them, as in the JAX
package. Nothing is padded: the kernels take B and S as they are.

The kernels take float32. :func:`ctc_fb` takes bf16 emissions too, as the
JAX kernels do: it widens them to float32 around the same kernels (the
JAX kernels compute in ``promote_types(em.dtype, float32)``), returns the
NLL in float32 and d_em in bf16.
"""

from __future__ import annotations

from typing import Tuple

import torch

from paddle_tpu_torch import kernels as _kernels
from paddle_tpu_torch.kernels import _build
from paddle_tpu_torch.kernels._util import NEG
from paddle_tpu_torch.utils.error import enforce

# csrc/ctc.cu's instances: the states a lane of its recursions, in
# registers, no shared memory; at 16 a lane keeps a ring of 4 steps of em
# (64 values): a ring of 8 would spill
_LANE_N = (2, 3, 4, 6, 8, 12, 16)


def ctc_states_per_lane(S: int) -> int:
    """N, the consecutive states each of a warp's 32 lanes holds in both
    recursion kernels for S states: ceil(S / 32) rounded up to 2, 3, 4, 6,
    8, 12 or 16 (``states_per_lane`` in csrc/ctc.cu; 3 at the CTC path's
    S = 65); 0 past 512 states, which no instance covers."""
    need = -(-S // 32)
    return next((n for n in _LANE_N if n >= need), 0)


def ctc_kernel_supported(B: int, S: int) -> bool:
    """Whether the kernels take B rows of S extended states on an H100:
    one warp a row, whose 32 lanes hold up to 16 states each in registers.
    That holds up to S = 512 (U = 255 labels), for any B >= 1 and any T."""
    return B >= 1 and S >= 1 and ctc_states_per_lane(S) > 0


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


def ctc_betas_plain(em, mask_tb, skip, ok, beta_init):
    """The recursion kernel's function: betas [T, B, S], beta at every
    step before it is folded with em[t], as :func:`ctc_bwd_plain`'s loop
    forms it (beta_{T-1} = beta_init; a masked step keeps beta)."""
    live, can_skip = ok > 0, skip > 0
    neg = torch.full_like(em[0], NEG)
    beta = beta_init
    betas = torch.empty_like(em)
    for t in reversed(range(em.shape[0])):
        betas[t] = beta
        be = torch.where(live, beta + em[t], neg)
        b1 = _shift_left(be, 1)
        b2 = _shift_left(torch.where(can_skip, be, neg), 2)
        prev = torch.where(live, torch.clamp(_lse3(be, b1, b2), min=NEG), neg)
        beta = torch.where(mask_tb[t, :, None] > 0, prev, beta)
    return betas


def ctc_marginals_plain(alphas, betas, mask_tb, ll, ct=None):
    """The marginals kernel's function: d_em [T, B, S] = -exp(clip(alpha
    + beta - ll, -80, 0)) * m, times ct [B] where given. Composed with
    :func:`ctc_betas_plain` (ct absent) it is :func:`ctc_bwd_plain`."""
    post = torch.exp(torch.clamp(alphas + betas - ll[None, :, None], -80.0,
                                 0.0))
    d_em = -(post * mask_tb[:, :, None])
    return d_em if ct is None else d_em * ct[None, :, None]


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
_BWD = _build.GridKernel("ctc_bwd", n_ptrs=6, source="ctc")
_MARGINALS = _build.GridKernel("ctc_bwd_marginals", n_ptrs=6, source="ctc")


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


def ctc_betas(em, mask_tb, skip, ok, beta_init):
    """betas [T, B, S]: the recursion kernel, ``ctc_bwd``, for CUDA
    tensors; :func:`ctc_betas_plain` for CPU tensors."""
    T, B, S = _check("ctc_bwd", em, mask_tb, skip, ok, beta_init=beta_init)
    if em.device.type == "cpu":
        return ctc_betas_plain(em, mask_tb, skip, ok, beta_init)
    _check_card("ctc_bwd", [em, mask_tb, skip, ok, beta_init], B, S)
    betas = torch.empty_like(em)
    _BWD.launch([em.data_ptr(), mask_tb.data_ptr(), skip.data_ptr(),
                 ok.data_ptr(), beta_init.data_ptr(), betas.data_ptr()],
                B, T, S, em.device)
    _kernels.launches["ctc_bwd"] += 1
    return betas


def ctc_marginals(alphas, betas, mask_tb, ll, ct=None):
    """d_em [T, B, S], times the cotangent ct [B] where given: the
    marginals kernel, ``ctc_bwd_marginals``, for CUDA tensors;
    :func:`ctc_marginals_plain` for CPU tensors."""
    enforce(alphas.dim() == 3 and min(alphas.shape) >= 1,
            f"ctc_bwd_marginals: alphas must be a non-empty [T, B, S], got "
            f"{tuple(alphas.shape)}")
    T, B, S = alphas.shape
    rows = [("betas", betas, (T, B, S)), ("mask_tb", mask_tb, (T, B)),
            ("ll", ll, (B,))] + ([] if ct is None else [("ct", ct, (B,))])
    for name, a, shape in rows:
        enforce(tuple(a.shape) == shape,
                f"ctc_bwd_marginals: {name} must be {list(shape)}, got "
                f"{list(a.shape)}")
    if alphas.device.type == "cpu":
        return ctc_marginals_plain(alphas, betas, mask_tb, ll, ct)
    _check_card("ctc_bwd_marginals", [a for _, a, _ in rows] + [alphas], B,
                S)
    d_em = torch.empty_like(alphas)
    _MARGINALS.launch([alphas.data_ptr(), betas.data_ptr(),
                       mask_tb.data_ptr(), ll.data_ptr(),
                       None if ct is None else ct.data_ptr(),
                       d_em.data_ptr()], B, T, S, alphas.device)
    _kernels.launches["ctc_bwd_marginals"] += 1
    return d_em


def ctc_bwd(em, mask_tb, skip, ok, beta_init, alphas, ll, ct=None):
    """d_em [T, B, S], times the cotangent ct [B] where given: the beta
    recursion (:func:`ctc_betas`), then the marginals
    (:func:`ctc_marginals`): the kernels for CUDA tensors, their plain
    versions for CPU tensors."""
    T, B, S = _check("ctc_bwd", em, mask_tb, skip, ok, beta_init=beta_init)
    for name, a, shape in (("alphas", alphas, (T, B, S)), ("ll", ll, (B,))):
        enforce(tuple(a.shape) == shape,
                f"ctc_bwd: {name} must be {list(shape)}, got {list(a.shape)}")
    return ctc_marginals(alphas, ctc_betas(em, mask_tb, skip, ok, beta_init),
                         mask_tb, ll, ct)


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
    backward runs :func:`ctc_bwd` over them with the cotangent."""

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
        d_em = ctc_bwd(*ctx.saved_tensors, ct=ct.contiguous())
        return d_em, None, None, None, None


def ctc_fb(em, mask_tb, skip, ok, beta_init):
    """[B] negative log-likelihood from gathered extended emissions.

    em [T, B, S] log p at the extended labels (time-major); mask_tb [T, B]
    1.0 at valid steps; skip [B, S] 1.0 where the s-2 -> s transition is
    legal; ok [B, S] 1.0 inside each row's 2*ulen+1 states; beta_init
    [B, S] 0.0 at the terminal states, NEG elsewhere. Differentiable in em,
    through the explicit posterior marginals, when grad is enabled and em
    requires it; otherwise only the forward runs. CPU tensors run the
    plain versions. CUDA tensors launch the kernels: contiguous, on one
    device, in the shapes ``ctc_kernel_supported`` takes; anything else
    raises.

    The JAX kernels' dtype rule (``promote_types(em.dtype, float32)``): em
    and beta_init share one dtype, float32 or bf16 (float64 on the CPU),
    and are widened to float32 at entry (float64 stays), the 0/1 mask,
    skip and ok too; the recursions run in float32 and the NLL comes back
    in float32, d_em in em's dtype (bf16 rounded once from the float32
    marginals), through the widening's own gradient. Float16 or a mix of
    data dtypes raises."""
    _check("ctc_fb", em, mask_tb, skip, ok, beta_init=beta_init)
    dt = _build.widened_dtype("ctc_fb", [em, beta_init], [mask_tb, skip, ok])
    em, mask_tb, skip, ok, beta_init = (
        a.to(dt) for a in (em, mask_tb, skip, ok, beta_init))
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


def _log_softmax(logits):
    """The log-softmax over classes. On bf16 logits, rounded where the JAX
    package's ``jax.nn.log_softmax`` rounds on bf16 (XLA's CPU fusion):
    the shifted logits, the float32 sum of their exps, its log and the
    result, each to bf16."""
    if logits.dtype != torch.bfloat16:
        return torch.log_softmax(logits, dim=-1)
    shifted = logits - logits.detach().max(dim=-1, keepdim=True).values
    total = torch.exp(shifted.float()).sum(-1, keepdim=True)
    return shifted - torch.log(total.to(logits.dtype))


def ctc_nll_kernel(logits, labels, in_mask, label_mask, blank=0):
    """[B] CTC negative log-likelihood through the ``ctc_fb`` Function:
    the counterpart of ``ctc_nll_pallas``. logits [B, T, C]; labels
    [B, U]; in_mask [B, T]; label_mask [B, U]. The log-softmax, the
    extended labels and the gather to [B, T, S] stay outside the kernels,
    so autograd routes the marginals back through them; nothing is
    padded. bf16 logits give bf16 emissions, which ``ctc_fb`` widens."""
    logp = _log_softmax(logits)
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
