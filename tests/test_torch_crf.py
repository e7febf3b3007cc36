"""The port's CRF log-partition (kernels/crf.py) and CRF layers
(layers/crf_ctc.py) against the JAX package's.

The same numpy inputs go through ``paddle_tpu.kernels.crf`` /
``paddle_tpu.layers.crf_ctc`` (the Pallas kernels in interpret mode, or
the lax.scan) and their counterparts in the port, whose ``crf_logz``
Function runs its kernels' plain versions on the CPU. Each test mirrors
one of ``tests/test_crf_kernel.py``. Tolerances: logz and alphas rtol 1e-5
/ atol 1e-5, gradients rtol 1e-4 / atol 1e-5 (the JAX test's own); Viterbi
tags equal, scores within 1e-5.

The kernels run only on a card: the ``cuda`` test holds them against the
plain versions there (``chip_smoke.py`` does so at the main path's
shapes).
"""

import types
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu.kernels.crf as jk
import paddle_tpu.layers.crf_ctc as jc

import paddle_tpu_torch.layers.crf_ctc as tc
from paddle_tpu_torch import kernels as tkernels
from paddle_tpu_torch.kernels import crf as tk
from paddle_tpu_torch.utils.error import Error

LOGZ_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)


def _case(B=4, T=13, L=7, seed=0):
    r = np.random.RandomState(seed)
    emit = r.randn(B, T, L).astype(np.float32)
    labels = r.randint(0, L, (B, T)).astype(np.int32)
    lens = r.randint(2, T + 1, B)
    lens[0] = T
    mask = (np.arange(T)[None] < lens[:, None]).astype(np.float32)
    w = (r.randn(L + 2, L) * 0.5).astype(np.float32)
    return emit, labels, mask, w


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _time_major(emit, mask, w):
    """The kernel-level arguments (em [T,B,L], mask [T,B], start, end,
    trans) of a [B,T,L] case, as numpy."""
    return (np.swapaxes(emit, 0, 1).copy(), np.swapaxes(mask, 0, 1).copy(),
            w[0], w[1], w[2:])


@pytest.mark.parametrize("shape", [(4, 13, 7, 0), (3, 9, 32, 1),
                                   (1, 20, 5, 2)])
def test_plain_alphas_and_logz_match_pallas_and_scan(shape):
    B, T, L, seed = shape
    emit, _, mask, w = _case(B, T, L, seed)
    em, m_tb, start, end, trans = _time_major(emit, mask, w)
    j_alphas = np.asarray(jk._alpha_call(
        jnp.asarray(em), jnp.asarray(m_tb), jnp.asarray(start),
        jnp.asarray(trans), True)[0])[:T]
    t_alphas = tk.crf_alphas_plain(*_t(em, m_tb, start, trans))
    np.testing.assert_allclose(t_alphas.numpy(), j_alphas, **LOGZ_TOL)
    want_pallas = np.asarray(jc.crf_logz_pallas(
        jnp.asarray(emit), jnp.asarray(mask), jnp.asarray(w), interpret=True))
    want_scan = np.asarray(jc.crf_logz_scan(
        jnp.asarray(emit), jnp.asarray(mask), jnp.asarray(w)))
    te, tm, tw = _t(emit, mask, w)
    for got in (tc.crf_logz_kernel(te, tm, tw), tc.crf_logz_scan(te, tm, tw),
                tk.crf_logz(*_t(em, m_tb, start, end, trans))):
        np.testing.assert_allclose(got.numpy(), want_pallas, **LOGZ_TOL)
        np.testing.assert_allclose(got.numpy(), want_scan, **LOGZ_TOL)


@pytest.mark.parametrize("seed", [0, 5])
def test_function_gradients_match_pallas_backward(seed):
    """Non-uniform and negative cotangents exercise the ct-weighted
    pairwise marginals; the JAX side is jax.grad through the interpret-
    mode Pallas backward."""
    emit, _, mask, w = _case(seed=seed)
    ct = np.asarray([1.0, -2.0, 0.5, 3.0], np.float32)
    jm = jnp.asarray(mask)
    g_em, g_w = jax.grad(
        lambda e, w: (jc.crf_logz_pallas(e, jm, w, True) * ct).sum(),
        argnums=(0, 1))(jnp.asarray(emit), jnp.asarray(w))
    te, tm, tw = _t(emit, mask, w)
    te.requires_grad_(True)
    tw.requires_grad_(True)
    (tc.crf_logz_kernel(te, tm, tw) * torch.from_numpy(ct)).sum().backward()
    np.testing.assert_allclose(te.grad.numpy(), np.asarray(g_em),
                               err_msg="d_emit", **GRAD_TOL)
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(g_w),
                               err_msg="d_w", **GRAD_TOL)


def test_plain_backward_matches_pallas_outputs():
    """crf_bwd_plain's d_em and the reduced pairwise marginals against
    the Pallas backward's own outputs (d_em, d_trans)."""
    emit, _, mask, w = _case(seed=3)
    em, m_tb, start, end, trans = _time_major(emit, mask, w)
    ct = np.asarray([0.5, -1.0, 2.0, 1.5], np.float32)
    _, res = jk._crf_fwd(*(jnp.asarray(a) for a in
                           (em, m_tb, start, end, trans)), True)
    j_dem, _, _, _, j_dtrans = jk._crf_bwd(True, res, jnp.asarray(ct))
    targs = _t(em, m_tb, start, end, trans)
    alphas = tk.crf_alphas_plain(targs[0], targs[1], targs[2], targs[4])
    logz = tk._logz(alphas, targs[3])
    d_em, partial = tk.crf_bwd(targs[0], targs[1], targs[3], targs[4],
                               alphas, logz, torch.from_numpy(ct))
    np.testing.assert_allclose(d_em.numpy(), np.asarray(j_dem), **GRAD_TOL)
    np.testing.assert_allclose(tk.crf_bwd_reduce(partial, targs[4]).numpy(),
                               np.asarray(j_dtrans), **GRAD_TOL)


def test_dtrans_with_disfavored_transitions():
    """Peaked alphas + a strongly NEGATIVE transition forced by the
    emissions: the pairwise factor's exponent goes positive (bounded by
    -trans); d_trans must match the JAX scan's gradient anyway."""
    B, T, L = 2, 6, 4
    r = np.random.RandomState(7)
    emit = (r.randn(B, T, L) * 0.3).astype(np.float32)
    emit[:, :, 0] += 6.0                      # alphas peak on state 0
    emit[:, 3, 1] += 14.0                     # ...but t=3 forces state 1
    mask = np.ones((B, T), np.float32)
    w = (r.randn(L + 2, L) * 0.2).astype(np.float32)
    w[2 + 0, 1] = -6.0                        # trans[0 -> 1] strongly neg
    want = jax.grad(lambda w: jc.crf_logz_scan(
        jnp.asarray(emit), jnp.asarray(mask), w).sum())(jnp.asarray(w))
    te, tm, tw = _t(emit, mask, w)
    tw.requires_grad_(True)
    tc.crf_logz_kernel(te, tm, tw).sum().backward()
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(want), **GRAD_TOL)


@pytest.mark.parametrize("impl", ["scan", "kernel"])
def test_crf_nll_switch_and_parity(impl, monkeypatch):
    emit, labels, mask, w = _case(seed=1)
    want = np.asarray(jc.crf_nll(jnp.asarray(emit), jnp.asarray(labels),
                                 jnp.asarray(mask), jnp.asarray(w)))
    monkeypatch.setattr(tc, "CRF_IMPL", impl)
    calls, real = [], tc.crf_logz_kernel
    monkeypatch.setattr(tc, "crf_logz_kernel",
                        lambda *a: calls.append(1) or real(*a))
    got = tc.crf_nll(*_t(emit, labels, mask, w))
    np.testing.assert_allclose(got.numpy(), want, **LOGZ_TOL)
    assert len(calls) == (impl == "kernel")


def test_gradcheck_f64_on_the_plain_versions():
    """torch.autograd.gradcheck of the crf_logz Function (its backward
    is crf_bwd_plain + crf_dtrans_plain on the CPU) in float64, against
    finite differences, in em, start, end and trans."""
    r = np.random.RandomState(3)
    T, B, L = 9, 2, 5
    em = torch.from_numpy(r.randn(T, B, L)).requires_grad_(True)
    mask = torch.from_numpy((np.arange(T)[:, None] <
                             np.array([[9, 6]])).astype(np.float64))
    w = r.randn(L + 2, L) * 0.5
    start, end, trans = (torch.from_numpy(a.copy()).requires_grad_(True)
                         for a in (w[0], w[1], w[2:]))
    assert torch.autograd.gradcheck(
        lambda e, s, n, t: tk.crf_logz(e, mask, s, n, t),
        (em, start, end, trans), eps=1e-6, atol=1e-6, rtol=1e-5)


def test_trans_bound_warns_on_the_cpu():
    """The backward clips pairwise exponents at +/-80, exact only for
    max |trans| < 80: a CPU transition matrix that breaks it warns;
    compliant calls and NEG dead-state sentinels stay silent. On another
    device the check is skipped (it would cost a device-to-host sync)."""
    T, B, L = 4, 2, 3
    r = np.random.RandomState(1)
    em, = _t(r.randn(T, B, L).astype(np.float32))
    mask = torch.ones(T, B)
    start = end = torch.zeros(L)
    ok, = _t(r.randn(L, L).astype(np.float32))
    with warnings.catch_warnings():
        warnings.simplefilter("error")          # any warning -> failure
        tk.crf_logz(em, mask, start, end, ok)
        sentinel = ok.clone()
        sentinel[-1, :] = tk.NEG
        tk.crf_logz(em, mask, start, end, sentinel)
    bad = ok.clone()
    bad[0, 1] = -120.0
    with pytest.warns(RuntimeWarning, match=r"\|trans\|"):
        tk.crf_logz(em, mask, start, end, bad)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        tk._check_trans_bound(bad.to("meta"))


def test_no_grad_runs_the_forward_only(monkeypatch):
    emit, _, mask, w = _case(seed=2)
    te, tm, tw = _t(emit, mask, w)
    tw.requires_grad_(True)
    monkeypatch.setattr(tk._CrfLogZ, "apply", None)   # would raise if used
    with torch.no_grad():
        logz = tc.crf_logz_kernel(te, tm, tw)
    assert logz.grad_fn is None and logz.shape == (4,)


@pytest.mark.parametrize("seed", [0, 4])
def test_crf_decode_matches_jax(seed):
    emit, _, mask, w = _case(B=5, T=11, L=6, seed=seed)
    j_tags, j_score = jc.crf_decode(jnp.asarray(emit), jnp.asarray(mask),
                                    jnp.asarray(w))
    tags, score = tc.crf_decode(*_t(emit, mask, w))
    np.testing.assert_array_equal(tags.numpy(), np.asarray(j_tags))
    np.testing.assert_allclose(score.numpy(), np.asarray(j_score), **LOGZ_TOL)


def test_crf_decode_tie_rule_is_the_first_maximum():
    """Exact ties everywhere (integer scores): both packages take the
    first maximum."""
    r = np.random.RandomState(9)
    emit = r.randint(0, 2, (3, 8, 4)).astype(np.float32)
    mask = np.ones((3, 8), np.float32)
    mask[2, 5:] = 0
    w = r.randint(-1, 2, (6, 4)).astype(np.float32)
    j_tags, j_score = jc.crf_decode(jnp.asarray(emit), jnp.asarray(mask),
                                    jnp.asarray(w))
    tags, score = tc.crf_decode(*_t(emit, mask, w))
    np.testing.assert_array_equal(tags.numpy(), np.asarray(j_tags))
    np.testing.assert_array_equal(score.numpy(), np.asarray(j_score))


def _layers(pkg, core_layer, L, with_label):
    feat = pkg.layer.data(name="feat",
                          type=pkg.data_type.dense_vector_sequence(L))
    lab = pkg.layer.data(name="tags",
                         type=pkg.data_type.integer_value_sequence(L))
    err = core_layer.Layer("crf_error", [feat, lab], name="err", size=L)
    dec = pkg.layer.crf_decoding(input=feat, size=L, name="dec",
                                 label=lab if with_label else None)
    cost = pkg.layer.crf(input=feat, label=lab, size=L, name="cost")
    return err, dec, cost


@pytest.mark.parametrize("with_label", [False, True])
def test_crf_layers_match_jax(with_label):
    """crf, crf_decoding (tags, or 0/1 errors with a label input) and
    crf_error in both packages on the same ragged batch."""
    import paddle_tpu as pj
    import paddle_tpu.core.layer as j_core_layer
    import paddle_tpu_torch as pt
    import paddle_tpu_torch.core.layer as t_core_layer
    from paddle_tpu.core.arg import Arg as JArg
    from paddle_tpu_torch.core.arg import Arg as TArg

    L = 5
    emit, labels, mask, _ = _case(B=3, T=6, L=L, seed=8)
    outs = {}
    names = {}
    for name, pkg, core, arg, conv in (
            ("jax", pj, j_core_layer, JArg, jnp.asarray),
            ("torch", pt, t_core_layer, TArg, torch.from_numpy)):
        layers = _layers(pkg, core, L, with_label)
        topo = pkg.Topology(list(layers))
        w = np.random.RandomState(1).randn(L + 2, L).astype(np.float32) * 0.5
        params = {n: conv(w) for n in topo.param_specs()}
        feeds = {"feat": arg(conv(emit), conv(mask)),
                 "tags": arg(conv(labels), conv(mask))}
        o = topo.forward(params, feeds)
        outs[name] = [np.asarray(o[l.name].value) for l in layers]
        names[name] = sorted(topo.param_specs())
    assert names["torch"] == names["jax"] == ["_cost.w0", "_dec.w0",
                                              "_err.w0"]
    for got, want in zip(outs["torch"], outs["jax"]):
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, **LOGZ_TOL)


def test_switch_predicate():
    """"auto": the kernels for CUDA tensors at T >= 256 whose shape they
    take, the scan otherwise (on the CPU always); "kernel" / "scan" force
    one path."""
    def fake(B, T, L, device):
        return types.SimpleNamespace(shape=(B, T, L),
                                     device=torch.device(device))

    assert tc.CRF_IMPL == "auto" and tc._CRF_KERNEL_MIN_T == 256
    assert tc._crf_use_kernel(fake(32, 512, 67, "cuda"))
    assert tc._crf_use_kernel(fake(32, 256, 67, "cuda"))
    assert not tc._crf_use_kernel(fake(32, 255, 67, "cuda"))
    assert not tc._crf_use_kernel(fake(32, 512, 67, "cpu"))
    assert not tc._crf_use_kernel(fake(32, 512, 170, "cuda"))
    old = tc.CRF_IMPL
    try:
        tc.CRF_IMPL = "kernel"
        assert tc._crf_use_kernel(fake(2, 8, 5, "cpu"))
        tc.CRF_IMPL = "scan"
        assert not tc._crf_use_kernel(fake(32, 512, 67, "cuda"))
        tc.CRF_IMPL = "pallas"
        with pytest.raises(Error, match="CRF_IMPL"):
            tc._crf_use_kernel(fake(2, 8, 5, "cpu"))
    finally:
        tc.CRF_IMPL = old


def test_kernel_supported_from_shared_memory():
    assert tk.crf_kernel_supported(32, 67)
    assert tk.crf_kernel_supported(1, 169)
    assert not tk.crf_kernel_supported(32, 170)
    assert not tk.crf_kernel_supported(0, 67)
    assert tk._bwd_smem_bytes(169) <= 227 * 1024 < tk._bwd_smem_bytes(170)


def test_wrappers_refuse_non_cuda_devices():
    """A tensor that is not on the CPU either launches the kernel or
    raises: never the plain version."""
    T, B, L = 4, 2, 3
    meta = dict(device="meta")
    em = torch.empty(T, B, L, **meta)
    mask = torch.empty(T, B, **meta)
    vec = torch.empty(L, **meta)
    trans = torch.empty(L, L, **meta)
    before = dict(tkernels.launches)
    with pytest.raises(Error, match="no kernel for device"):
        tk.crf_alphas(em, mask, vec, trans)
    with pytest.raises(Error, match="no kernel for device"):
        tk.crf_bwd(em, mask, vec, trans, em, torch.empty(B, **meta),
                   torch.empty(B, **meta))
    with pytest.raises(Error, match="no kernel for device"):
        tk.crf_bwd_reduce(torch.empty(B, L, L, **meta), trans)
    assert tkernels.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(32, 512, 67), (5, 37, 45)])
def test_kernels_match_plain_on_the_card(shape):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc (the port's CUDA kernels)")
    torch.backends.cuda.matmul.allow_tf32 = False
    B, T, L = shape
    emit, _, mask, w = _case(B, T, L, seed=11)
    em, m_tb, start, end, trans = (a.cuda() for a in _t(
        *_time_major(emit, mask, w)))
    ct = torch.from_numpy(np.random.RandomState(2).randn(B)
                          .astype(np.float32)).cuda()
    alphas = tk.crf_alphas(em, m_tb, start, trans)
    want = tk.crf_alphas_plain(em, m_tb, start, trans)
    torch.testing.assert_close(alphas, want, rtol=0, atol=1e-4)
    logz = tk._logz(want, end)
    d_em, partial = tk.crf_bwd(em, m_tb, end, trans, want, logz, ct)
    w_dem, w_partial = tk.crf_bwd_plain(em, m_tb, end, trans, want, logz, ct)
    torch.cuda.synchronize()
    for got, ref in ((d_em, w_dem), (partial, w_partial),
                     (tk.crf_bwd_reduce(partial, trans),
                      tk.crf_dtrans_plain(w_partial, trans))):
        scale = max(1.0, ref.abs().max().item())
        assert (got - ref).abs().max().item() <= 1e-4 * scale
