"""The port's CTC loss (layers/crf_ctc.py ``ctc_nll``) and its CTC
forward-backward Function (kernels/ctc.py) against the JAX package's.

The same numpy inputs go through ``paddle_tpu.layers.crf_ctc.ctc_nll``
(the lax.scan) and ``paddle_tpu.kernels.ctc`` (the Pallas kernels in
interpret mode) and their counterparts in the port, whose ``ctc_fb``
Function runs its kernels' plain versions on the CPU. The cases mirror
``tests/test_crf_ctc.py`` (brute force, a repeated label, label padding,
an empty label, finite differences) and ``tests/test_ctc_kernel.py``.
Tolerances: values rtol 1e-5 / atol 1e-5, gradients rtol 1e-4 / atol
1e-5 (``tests/test_ctc_kernel.py``'s own); brute force rel 1e-6 in
float64.

The kernels run only on a card: the ``cuda`` test holds them against the
plain versions there (``chip_smoke.py`` does so at the main path's
shapes).
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu.kernels.ctc as jk
import paddle_tpu.layers.crf_ctc as jc

import paddle_tpu_torch.layers.crf_ctc as tc
from paddle_tpu_torch import kernels as tkernels
from paddle_tpu_torch.kernels import ctc as tk
from paddle_tpu_torch.utils.error import Error

VALUE_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)


def _case(B=4, T=13, C=11, U=5, seed=0, blank=0):
    """logits [B,T,C], labels [B,U] (never the blank), in_mask, label_mask;
    row 0 is full length with a full label."""
    r = np.random.RandomState(seed)
    logits = r.randn(B, T, C).astype(np.float32)
    ids = [c for c in range(C) if c != blank]
    labels = np.asarray(ids, np.int32)[r.randint(0, C - 1, (B, U))]
    lens = r.randint(max(2 * U + 1, 2), T + 1, B)
    lens[0] = T
    ulens = r.randint(1, U + 1, B)
    ulens[0] = U
    im = (np.arange(T)[None] < lens[:, None]).astype(np.float32)
    lm = (np.arange(U)[None] < ulens[:, None]).astype(np.float32)
    return logits, labels, im, lm


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _brute_ctc_nll(logp, label, blank=0):
    """-log of the summed probability of every frame path that collapses
    to ``label`` (logp [T, C])."""
    T, C = logp.shape
    total = -np.inf
    for frames in itertools.product(range(C), repeat=T):
        out, prev = [], None
        for f in frames:
            if f != blank and f != prev:
                out.append(f)
            prev = f
        if out == list(label):
            total = np.logaddexp(total, sum(logp[t, frames[t]]
                                            for t in range(T)))
    return -total


def _port_losses():
    return {"scan": tc.ctc_nll, "kernel": tk.ctc_nll_kernel}


@pytest.mark.parametrize("impl", ["scan", "kernel"])
@pytest.mark.parametrize("label", [[1, 2], [1, 1], [2]])
def test_matches_bruteforce(impl, label):
    """Every path enumerated, in float64; [1, 1] forces a blank between
    the repeats (the skip rule)."""
    T, C = 5, 3
    logits = np.random.RandomState(4).randn(1, T, C)
    logp = torch.log_softmax(torch.from_numpy(logits), -1)[0].numpy()
    got = _port_losses()[impl](*_t(logits, np.asarray([label]),
                                   np.ones((1, T)),
                                   np.ones((1, len(label)))))
    assert float(got[0]) == pytest.approx(_brute_ctc_nll(logp, label),
                                          rel=1e-6)


@pytest.mark.parametrize("impl", ["scan", "kernel"])
def test_label_padding_and_empty_label(impl):
    """[1, pad] equals a standalone [1]; an empty label (slen = 1) is the
    all-blank path only: exactly -sum_t logp(blank), with no second
    terminal state (the JAX package's log 2 fix)."""
    T, C = 5, 3
    logits = np.random.RandomState(5).randn(2, T, C)
    logp = torch.log_softmax(torch.from_numpy(logits), -1).numpy()
    got = _port_losses()[impl](*_t(logits, np.asarray([[1, 0], [0, 0]]),
                                   np.ones((2, T)),
                                   np.asarray([[1.0, 0.0], [0.0, 0.0]])))
    assert float(got[0]) == pytest.approx(_brute_ctc_nll(logp[0], [1]),
                                          rel=1e-6)
    assert float(got[1]) == pytest.approx(-logp[1, :, 0].sum(), rel=1e-6)


@pytest.mark.parametrize("blank", [0, 10])
@pytest.mark.parametrize("seed", [0, 3])
def test_scan_matches_jax_values_and_gradients(seed, blank):
    logits, labels, im, lm = _case(seed=seed, blank=blank)
    want = np.asarray(jc.ctc_nll(*_j(logits, labels, im, lm), blank))
    g_want = jax.grad(lambda l: jc.ctc_nll(l, *_j(labels, im, lm),
                                           blank).sum())(jnp.asarray(logits))
    x, *rest = _t(logits, labels, im, lm)
    x.requires_grad_(True)
    got = tc.ctc_nll(x, *rest, blank)
    got.sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), want, **VALUE_TOL)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(g_want),
                               **GRAD_TOL)


def test_scan_gradient_matches_finite_differences():
    """Float64, central differences at a few entries (test_crf_ctc.py's
    test_ctc_grad_finite): a repeated label, label and frame padding."""
    T, C = 6, 4
    r = np.random.RandomState(6)
    logits = torch.from_numpy(r.randn(2, T, C)).requires_grad_(True)
    labels, lm, im = _t(np.asarray([[1, 2, 3], [2, 2, 0]]),
                        np.asarray([[1.0, 1, 1], [1, 1, 0]]),
                        np.asarray([[1.0] * 6, [1.0] * 5 + [0.0]]))

    def f(x):
        return tc.ctc_nll(x, labels, im, lm).sum()

    f(logits).backward()
    g = logits.grad.numpy()
    assert np.isfinite(g).all()
    eps = 1e-5
    for idx in [(0, 0, 1), (1, 3, 2), (1, 5, 0)]:
        e = torch.zeros_like(logits)
        e[idx] = eps
        with torch.no_grad():
            fd = (float(f(logits + e)) - float(f(logits - e))) / (2 * eps)
        assert fd == pytest.approx(float(g[idx]), rel=1e-4, abs=1e-7)


@pytest.mark.parametrize("case", [dict(seed=0), dict(seed=1, B=3, T=16, U=7),
                                  dict(seed=2, B=1, T=9, C=5, U=2),
                                  dict(seed=3, blank=10)])
def test_kernel_path_matches_pallas_and_scan(case):
    """ctc_nll_kernel (the plain versions) against ctc_nll_pallas in
    interpret mode and the JAX scan, values and jax.grad gradients
    (tests/test_ctc_kernel.py's test_pallas_matches_scan_values_and_grads)."""
    blank = case.get("blank", 0)
    logits, labels, im, lm = _case(**case)
    jl, jlab, jim, jlm = _j(logits, labels, im, lm)
    pallas = jax.vjp(lambda l: jk.ctc_nll_pallas(
        l, jlab, jim, jlm, blank, interpret=True), jl)
    scan = jax.vjp(lambda l: jc.ctc_nll(l, jlab, jim, jlm, blank), jl)
    x, *rest = _t(logits, labels, im, lm)
    x.requires_grad_(True)
    got = tk.ctc_nll_kernel(x, *rest, blank)
    got.sum().backward()
    for want, vjp in (pallas, scan):
        g, = vjp(jnp.ones_like(want))
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   **VALUE_TOL)
        np.testing.assert_allclose(x.grad.numpy(), np.asarray(g),
                                   **GRAD_TOL)


def test_kernel_path_repeated_and_empty_labels_match_pallas():
    """Repeated labels turn the skip off (tests/test_ctc_kernel.py's
    test_pallas_repeated_labels); an empty label leaves one terminal
    state (test_pallas_empty_label)."""
    r = np.random.RandomState(1)
    logits = r.randn(3, 12, 6).astype(np.float32)
    labels = np.asarray([[2, 2, 3], [4, 4, 4], [1, 2, 0]], np.int32)
    im = np.ones((3, 12), np.float32)
    lm = np.asarray([[1, 1, 1], [1, 1, 1], [0, 0, 0]], np.float32)
    want = jk.ctc_nll_pallas(*_j(logits, labels, im, lm), interpret=True)
    got = tk.ctc_nll_kernel(*_t(logits, labels, im, lm))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **VALUE_TOL)


def _kernel_args(logits, labels, im, lm, blank=0):
    """The Function's arguments for a [B,T,C] case, built by the port
    (em [T,B,S], mask [T,B], skip, ok, beta_init) as float32 tensors."""
    lt, labt, imt, lmt = _t(logits, labels, im, lm)
    S = 2 * labels.shape[1] + 1
    ext, ok, skip, slen = tk.extended_labels(labt, lmt, blank, S)
    em = torch.gather(torch.log_softmax(lt, -1), 2,
                      ext[:, None, :].expand(-1, lt.shape[1], S))
    pos = torch.arange(S)[None, :]
    beta_init = torch.where(
        (pos == (slen - 1)[:, None]) | ((pos == (slen - 2)[:, None])
                                         & (slen >= 2)[:, None]),
        0.0, tk.NEG)
    return (em.transpose(0, 1).contiguous(), imt.t().contiguous(),
            (skip & ok).float(), ok.float(), beta_init)


def test_plain_alphas_match_pallas_forward():
    """ctc_alphas_plain against the JAX ``_alphas`` (the Pallas forward
    in interpret mode), and ll against ``_ctc_fb_fwd``'s."""
    logits, labels, im, lm = _case(seed=2, B=3, T=11, U=4)
    em, m_tb, skip, ok, beta_init = _kernel_args(logits, labels, im, lm)
    T = em.shape[0]
    j_alphas = np.asarray(jk._alphas(*_j(em, m_tb, skip, ok), True)[0])[:T]
    alphas = tk.ctc_alphas_plain(em, m_tb, skip, ok)
    np.testing.assert_allclose(alphas.numpy(), j_alphas, **VALUE_TOL)
    j_nll, res = jk._ctc_fb_fwd(*_j(em, m_tb, skip, ok, beta_init), True)
    np.testing.assert_allclose(-tk._loglik(alphas, beta_init).numpy(),
                               np.asarray(j_nll), **VALUE_TOL)
    np.testing.assert_allclose(tk._loglik(alphas, beta_init).numpy(),
                               np.asarray(res[-1])[:, 0], **VALUE_TOL)


def test_plain_backward_matches_pallas_backward():
    """ctc_bwd_plain's marginals against ``_ctc_fb_bwd``'s d_em (the
    Pallas backward in interpret mode) with a cotangent of ones."""
    logits, labels, im, lm = _case(seed=4)
    args = _kernel_args(logits, labels, im, lm)
    _, res = jk._ctc_fb_fwd(*_j(*args), True)
    j_dem = jk._ctc_fb_bwd(True, res, jnp.ones(args[0].shape[1]))[0]
    alphas = tk.ctc_alphas_plain(*args[:4])
    d_em = tk.ctc_bwd(*args, alphas, tk._loglik(alphas, args[4]))
    np.testing.assert_allclose(d_em.numpy(), np.asarray(j_dem), **GRAD_TOL)


def test_gradcheck_f64_on_the_plain_versions():
    """torch.autograd.gradcheck of the ctc_fb Function (its backward is
    ctc_bwd_plain on the CPU) in float64, against finite differences in
    em, with a repeated label, a short row and a short label."""
    logits, labels, im, lm = _case(B=3, T=7, C=5, U=2, seed=5)
    labels[1] = [3, 3]
    args = [a.double() for a in _kernel_args(logits, labels, im, lm)]
    em = args[0].requires_grad_(True)
    assert torch.autograd.gradcheck(
        lambda e: tk.ctc_fb(e, *args[1:]), (em,), eps=1e-6, atol=1e-6,
        rtol=1e-5)


def test_no_grad_runs_the_forward_only(monkeypatch):
    logits, labels, im, lm = _case(seed=2)
    x, *rest = _t(logits, labels, im, lm)
    x.requires_grad_(True)
    monkeypatch.setattr(tk._CtcFB, "apply", None)     # would raise if used
    with torch.no_grad():
        nll = tk.ctc_nll_kernel(x, *rest)
    assert nll.grad_fn is None and nll.shape == (4,)


@pytest.mark.parametrize("blank", [0, 10])
def test_values_match_torch_ctc_loss(blank):
    """An independent check: F.ctc_loss's values (reduction "none") on
    the same log-softmax output, against both port paths."""
    logits, labels, im, lm = _case(B=5, T=17, U=4, seed=7, blank=blank)
    lt, labt, imt, lmt = _t(logits, labels, im, lm)
    want = torch.nn.functional.ctc_loss(
        torch.log_softmax(lt, -1).transpose(0, 1), labt,
        imt.sum(1).long(), lmt.sum(1).long(), blank=blank, reduction="none")
    for got in (tc.ctc_nll(lt, labt, imt, lmt, blank),
                tk.ctc_nll_kernel(lt, labt, imt, lmt, blank)):
        np.testing.assert_allclose(got.numpy(), want.numpy(), **VALUE_TOL)


def test_switch():
    """"auto" takes the scan on every device (the JAX package's auto
    never takes its CTC kernel); "kernel" and "scan" force a path."""
    assert tc.CTC_IMPL == "auto" and not tc._ctc_use_kernel()
    old = tc.CTC_IMPL
    try:
        tc.CTC_IMPL = "kernel"
        assert tc._ctc_use_kernel()
        tc.CTC_IMPL = "scan"
        assert not tc._ctc_use_kernel()
        tc.CTC_IMPL = "pallas"
        with pytest.raises(Error, match="CTC_IMPL"):
            tc._ctc_use_kernel()
    finally:
        tc.CTC_IMPL = old


def test_kernel_supported_from_registers():
    """One warp a row, 2K states a lane for K up to 8: S up to 512."""
    assert tk.ctc_kernel_supported(32, 41)
    assert tk.ctc_kernel_supported(1, 511)
    assert tk.ctc_kernel_supported(1, 512)
    assert not tk.ctc_kernel_supported(32, 513)
    assert not tk.ctc_kernel_supported(0, 41)
    assert not tk.ctc_kernel_supported(4, 0)


def test_wrappers_refuse_non_cuda_devices():
    """A tensor that is not on the CPU either launches the kernel or
    raises: never the plain version."""
    T, B, S = 4, 2, 5
    meta = dict(device="meta")
    em = torch.empty(T, B, S, **meta)
    mask = torch.empty(T, B, **meta)
    rows = torch.empty(B, S, **meta)
    before = dict(tkernels.launches)
    with pytest.raises(Error, match="no kernel for device"):
        tk.ctc_alphas(em, mask, rows, rows)
    with pytest.raises(Error, match="no kernel for device"):
        tk.ctc_bwd(em, mask, rows, rows, rows, em, torch.empty(B, **meta))
    with pytest.raises(Error, match="mask_tb must be"):
        tk.ctc_alphas(em, torch.empty(B, T, **meta), rows, rows)
    assert tkernels.launches == before


@pytest.mark.cuda
def test_kernels_refuse_shapes_outside_the_predicate():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc (the port's CUDA kernels)")
    em = torch.zeros(4, 2, 513, device="cuda")
    mask = torch.ones(4, 2, device="cuda")
    rows = torch.ones(2, 513, device="cuda")
    with pytest.raises(Error, match="ctc_kernel_supported"):
        tk.ctc_alphas(em, mask, rows, rows)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(512, 32, 20), (37, 5, 3), (600, 2, 200)])
def test_kernels_match_plain_on_the_card(shape):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc (the port's CUDA kernels)")
    T, B, U = shape
    logits, labels, im, lm = _case(B=B, T=T, C=64, U=U, seed=11)
    args = [a.cuda() for a in _kernel_args(logits, labels, im, lm)]
    alphas = tk.ctc_alphas(*args[:4])
    want = tk.ctc_alphas_plain(*args[:4])
    live = want > tk.NEG / 2
    scale = max(1.0, want[live].abs().max().item())
    assert (alphas - want).abs().max().item() <= 1e-5 * scale
    ll = tk._loglik(want, args[4])
    d_em = tk.ctc_bwd(*args, want, ll)
    w_dem = tk.ctc_bwd_plain(*args, want, ll)
    torch.cuda.synchronize()
    assert (d_em - w_dem).abs().max().item() <= 1e-3
