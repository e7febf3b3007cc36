"""The port's fused vocabulary projection + softmax cross-entropy
(``paddle_tpu_torch/kernels/vocab_xent.py``) against the JAX package's.

The same numpy inputs go through ``paddle_tpu.kernels.vocab_xent.
vocab_xent(..., interpret=True)`` (the Pallas kernels in interpret mode, as
``tests/test_vocab_xent.py`` runs them) and the port's ``vocab_xent``,
whose Function runs its kernels' plain versions on the CPU. Tolerances are
``tests/test_vocab_xent.py``'s own: nll rtol/atol 1e-5, dx, dW and db rtol
1e-4, atol 1e-5. The interpret-mode results are shared through
module-scoped fixtures (a call costs seconds).

Labels outside [0, V) match no column in the port (gold 0, nll = lse).
JAX agrees for labels < 0 and past its padded vocabulary (V rounded up to
2048), and gives nll = lse - NEG = 1e30 for a label in [V, padded V): its
one-hot there picks a padded column's NEG logit. Its gradients agree
either way (the padded columns of w are zero). The port does not copy the
padding; ``test_labels_in_the_tpu_padding_get_the_lse`` pins the
difference.

The kernels run only on a card: the ``cuda`` tests hold them against the
plain versions there (``chip_smoke.py`` does so at the NMT projection's
shape). ``test_tf32_split_keeps_dw_within_tolerance`` and
``test_tf32_split_keeps_dx_within_tolerance`` and
``test_tf32_split_keeps_forward_within_tolerance`` model the three
kernels' tensor-core arithmetic (three TF32 passes) on the CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.kernels.vocab_xent import vocab_xent as jax_vocab_xent

from paddle_tpu_torch import kernels as tkernels
from paddle_tpu_torch.kernels import vocab_xent as tv
from paddle_tpu_torch.utils.error import Error

VALUE_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)


def _case(N, D, V, seed, w_scale=0.1):
    r = np.random.RandomState(seed)
    x = r.randn(N, D).astype(np.float32)
    w = (r.randn(D, V) * w_scale).astype(np.float32)
    b = (r.randn(V) * 0.1).astype(np.float32)
    lab = r.randint(0, V, N).astype(np.float32)
    ct = r.randn(N).astype(np.float32)
    return x, w, b, lab, ct


def _jax(x, w, b, lab, ct):
    """nll and (dx, dW, db) of sum(nll * ct) through the Pallas kernels in
    interpret mode."""
    lab_j, ct_j = jnp.asarray(lab), jnp.asarray(ct)
    nll, vjp = jax.vjp(
        lambda x, w, b: jax_vocab_xent(x, w, b, lab_j, True),
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    return np.asarray(nll), [np.asarray(g) for g in vjp(ct_j)]


def _port(x, w, b, lab, ct, labels=None):
    """The same through the port's Function on the CPU."""
    tx, tw, tb = [torch.tensor(a, requires_grad=True) for a in (x, w, b)]
    nll = tv.vocab_xent(tx, tw, tb, torch.tensor(lab) if labels is None
                        else labels)
    (nll * torch.from_numpy(ct)).sum().backward()
    return nll.detach().numpy(), [a.grad.numpy() for a in (tx, tw, tb)]


@pytest.fixture(scope="module")
def small():
    """tests/test_vocab_xent.py's case: (37, 16, 300), one vocab chunk."""
    case = _case(37, 16, 300, seed=0)
    return case, _jax(*case)


@pytest.fixture(scope="module")
def chunks():
    """(300, 8, 4100): the online log-sum-exp crosses two 2048-column
    chunks into a ragged third; row 0's label is -1, row 1's past the TPU's
    padded vocabulary (6144), row 2's inside its padding (4100)."""
    case = _case(300, 8, 4100, seed=1)
    case[3][:3] = [-1, 6144 + 3, 4100]
    return case, _jax(*case)


def _assert_grads(got, want):
    for name, g, w in zip(("dx", "dW", "db"), got, want):
        np.testing.assert_allclose(g, w, err_msg=name, **GRAD_TOL)


def test_values_and_grads_match_the_pallas_kernels(small):
    case, (j_nll, j_grads) = small
    nll, grads = _port(*case)
    np.testing.assert_allclose(nll, j_nll, **VALUE_TOL)
    _assert_grads(grads, j_grads)


def test_several_vocab_chunks_and_out_of_range_labels(chunks):
    """Every row's nll but row 2's (see the module note), and the whole
    gradient, against JAX across three vocab chunks; rows 0 and 1 (labels
    -1 and 6147) have gold 0 in both."""
    case, (j_nll, j_grads) = chunks
    nll, grads = _port(*case)
    keep = np.arange(len(nll)) != 2
    np.testing.assert_allclose(nll[keep], j_nll[keep], **VALUE_TOL)
    _assert_grads(grads, j_grads)
    x, w, b = (torch.from_numpy(a) for a in case[:3])
    lse = torch.logsumexp(x @ w + b, 1).numpy()
    np.testing.assert_allclose(nll[:2], lse[:2], **VALUE_TOL)


def test_labels_in_the_tpu_padding_get_the_lse(chunks):
    """A label in [V, padded V) matches no column in the port (nll = lse);
    the JAX package's padded NEG column gives it 1e30."""
    case, (j_nll, _) = chunks
    nll, _ = _port(*case)
    x, w, b = (torch.from_numpy(a) for a in case[:3])
    lse = torch.logsumexp(x @ w + b, 1).numpy()
    np.testing.assert_allclose(nll[2], lse[2], **VALUE_TOL)
    assert j_nll[2] == pytest.approx(1e30)


def test_plain_versions_match_a_dense_reference_across_chunks():
    """The chunked plain forward and backward against the materialized
    logits' log_softmax under autograd, in float64, at (50, 6, 5000)."""
    x, w, b, lab, ct = _case(50, 6, 5000, seed=2)
    lab[:2] = [-3, 5000]
    args = [torch.tensor(a, dtype=torch.float64) for a in (x, w, b)]
    labels, ct64 = torch.tensor(lab), torch.tensor(ct, dtype=torch.float64)
    nll, lse = tv.vocab_xent_plain(*args, labels)
    dx, dw, db = tv.vocab_xent_bwd_plain(*args, labels, lse, ct64)
    ref = [a.clone().requires_grad_(True) for a in args]
    logits = ref[0] @ ref[1] + ref[2]
    ids = labels.long()
    inside = (ids >= 0) & (ids < 5000)
    gold = logits.gather(1, ids.clamp(0, 4999)[:, None])[:, 0]
    want = torch.logsumexp(logits, 1) - torch.where(
        inside, gold, torch.zeros_like(gold))
    (want * ct64).sum().backward()
    torch.testing.assert_close(nll, want.detach(), rtol=1e-12, atol=1e-12)
    for got, r in zip((dx, dw, db), ref):
        torch.testing.assert_close(got, r.grad, rtol=1e-10, atol=1e-12)


def test_bias_of_100_keeps_gradients_finite():
    """A bias of 100 on some columns: nll and every gradient finite and
    equal to the dense float64 reference's."""
    x, w, b, lab, ct = _case(29, 8, 700, seed=3)
    b[::7] = 100.0
    nll, grads = _port(x, w, b, lab, ct)
    assert np.isfinite(nll).all()
    assert all(np.isfinite(g).all() for g in grads)
    ref = [torch.tensor(a, dtype=torch.float64, requires_grad=True)
           for a in (x, w, b)]
    logits = ref[0] @ ref[1] + ref[2]
    want = torch.logsumexp(logits, 1) - logits.gather(
        1, torch.tensor(lab).long()[:, None])[:, 0]
    (want * torch.tensor(ct, dtype=torch.float64)).sum().backward()
    np.testing.assert_allclose(nll, want.detach().numpy(), rtol=1e-5,
                               atol=1e-4)
    for g, r in zip(grads, ref):
        np.testing.assert_allclose(g, r.grad.numpy(), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("S", [2, 3, 8])
def test_slices_combine_to_the_one_slice_result(S):
    """The kernels' vocabulary slices (whole 128-column tiles): the plain
    partials of S slices, combined, give the plain forward's nll and lse,
    and the dx partials summed its dx."""
    x, w, b, lab, ct = (torch.from_numpy(a) for a in _case(40, 6, 1000, 6))
    nll, lse = tv.vocab_xent_plain(x, w, b, lab)
    part = tv.vocab_xent_fwd_partials(x, w, b, lab, S)
    assert part.shape == (3, S, 40)
    got_nll, got_lse = tv.vocab_xent_fwd_reduce(part)
    torch.testing.assert_close(got_nll, nll, **VALUE_TOL)
    torch.testing.assert_close(got_lse, lse, **VALUE_TOL)
    dx = tv.vocab_xent_bwd_plain(x, w, b, lab, lse, ct)[0]
    dx_part = tv.vocab_xent_bwd_dx_partials(x, w, b, lab, lse, ct, S)
    torch.testing.assert_close(tv.vocab_xent_bwd_dx_reduce(dx_part), dx,
                               **GRAD_TOL)
    with pytest.raises(Error, match="S=9 slices of 8 column tiles"):
        tv.vocab_xent_fwd_partials(x, w, b, lab, 9)


@pytest.mark.parametrize("dtype", [torch.int32, torch.int64, torch.float32])
def test_integer_and_float_carrier_labels_agree(small, dtype):
    case, (j_nll, j_grads) = small
    labels = torch.tensor(case[3]).to(dtype)
    nll, grads = _port(*case, labels=labels)
    np.testing.assert_allclose(nll, j_nll, **VALUE_TOL)
    _assert_grads(grads, j_grads)
    ref_nll, ref_grads = _port(*case)
    np.testing.assert_array_equal(nll, ref_nll)
    for g, r in zip(grads, ref_grads):
        np.testing.assert_array_equal(g, r)


def test_gradcheck_f64_plain_path():
    """The twin of tests/test_vocab_xent.py test_fd_check_f64: finite
    differences in float64 through the port's Function on the CPU."""
    r = np.random.RandomState(3)
    N, D, V = 5, 4, 9
    x, w, b = (torch.tensor(a, dtype=torch.float64, requires_grad=True)
               for a in (r.randn(N, D), r.randn(D, V) * 0.3,
                         r.randn(V) * 0.3))
    lab = torch.tensor(r.randint(0, V, N), dtype=torch.float64)
    assert torch.autograd.gradcheck(
        lambda x, w, b: tv.vocab_xent(x, w, b, lab), (x, w, b),
        eps=1e-6, atol=1e-7, rtol=1e-5)


def test_float64_result_types():
    """nll in promote(x, float32); each gradient in its input's type."""
    x, w, b, lab, ct = _case(6, 3, 11, seed=4)
    tx = torch.tensor(x, dtype=torch.float64, requires_grad=True)
    tw, tb = (torch.tensor(a, requires_grad=True) for a in (w, b))
    nll = tv.vocab_xent(tx, tw, tb, torch.tensor(lab))
    assert nll.dtype == torch.float64
    nll.sum().backward()
    assert (tx.grad.dtype, tw.grad.dtype, tb.grad.dtype) == (
        torch.float64, torch.float32, torch.float32)


def test_wrappers_refuse_non_cuda_devices():
    """A tensor that is not on the CPU either launches the kernels or
    raises: never the plain version."""
    meta = dict(device="meta")
    x, w, b = (torch.empty(4, 3, **meta), torch.empty(3, 5, **meta),
               torch.empty(5, **meta))
    lab, row = torch.empty(4, dtype=torch.int64, **meta), torch.empty(4, **meta)
    before = dict(tkernels.launches)
    with pytest.raises(Error, match="no kernel for device"):
        tv.vocab_xent_fwd(x, w, b, lab)
    with pytest.raises(Error, match="no kernel for device"):
        tv.vocab_xent_bwd(x, w, b, lab, row, row)
    with pytest.raises(Error, match="no kernel for device"):
        tv.vocab_xent(x, w, b, lab)
    assert tkernels.launches == before


def test_shapes_and_labels_are_checked():
    x, w, b = torch.zeros(4, 3), torch.zeros(3, 5), torch.zeros(5)
    with pytest.raises(Error, match="labels must be \\[4\\]"):
        tv.vocab_xent(x, w, b, torch.zeros(3, dtype=torch.int64))
    with pytest.raises(Error, match="b must be \\[5\\]"):
        tv.vocab_xent(x, w, torch.zeros(4), torch.zeros(4, dtype=torch.int64))
    with pytest.raises(Error, match="w \\[D, V\\]"):
        tv.vocab_xent(x, torch.zeros(2, 5), b, torch.zeros(4))
    with pytest.raises(Error, match="labels must be int32, int64"):
        tv.vocab_xent(x, w, b, torch.zeros(4, dtype=torch.bool))
    with pytest.raises(Error, match="labels on meta"):
        tv.vocab_xent(x, w, b, torch.zeros(4, device="meta"))


def _tf32(a):
    """float32 rounded to TF32 as cvt.rna.tf32.f32 does: to nearest, ties
    away from zero, on the bits (the low 13 mantissa bits cleared)."""
    u = np.asarray(a, np.float32).view(np.uint32).astype(np.uint64)
    return ((u + 0x1000) & 0xFFFFE000).astype(np.uint32).view(np.float32)


def _split(a):
    big = _tf32(a)
    return big, _tf32(a - big)


def _trunc32(v):
    """float64 to float32 toward zero: the tensor cores' float32 sums."""
    f = v.astype(np.float32)
    over = np.abs(f.astype(np.float64)) > np.abs(v)
    return np.where(over, np.nextafter(f, np.float32(0)), f)


def _tc_steps(terms, k_steps):
    """A fresh accumulator through ``terms`` (pairs of operands) at each
    of the depth steps ``k_steps``, every MMA's sum truncated to
    float32."""
    acc = None
    for k in k_steps:
        for p, q in terms:
            step = p[:, k].astype(np.float64) @ q[k].astype(np.float64)
            acc = _trunc32(step if acc is None else acc.astype(np.float64)
                           + step)
    return acc


def _tc_product(a, b, passes):
    """a @ b as the tensor cores form it: depth steps of 8, each pass's
    products exact and every step's sum truncated to float32; ``passes``
    1 (big·big) or 3 (big·small, small·big, big·big)."""
    (ab, as_), (bb, bs) = _split(a), _split(b)
    terms = [(ab, bb)] if passes == 1 else [(ab, bs), (as_, bb), (ab, bb)]
    return _tc_steps(terms, [slice(k, k + 8) for k in range(0, a.shape[1], 8)])


@pytest.mark.parametrize("passes, sums", [
    (1, "float32"), (3, "float32"), (3, "tensor cores, a tile at a time")])
def test_tf32_split_keeps_dw_within_tolerance(passes, sums):
    """dW = xᵀ @ dlog through both of its products (the logits x @ w + b,
    then xᵀ @ dlog) with TF32 operands, against float64, at (384, 200,
    3000) with chip_smoke.py's scales: one pass misses the card's
    tolerance (1e-4 of max(1, max|dW|)); the three-pass split keeps 1e-5,
    with float32 sums and with the kernel's own arithmetic (sums truncated
    at every MMA, each 64-row tile's xᵀ @ dlog in fresh accumulators,
    added in float32)."""
    N, D, V = 384, 200, 3000
    r = np.random.RandomState(7)
    x = r.randn(N, D).astype(np.float32)
    w = (r.randn(D, V) / np.sqrt(D)).astype(np.float32)
    b = (r.randn(V) * 0.1).astype(np.float32)
    lab, ct = r.randint(0, V, N), r.randn(N).astype(np.float32)
    onehot = np.arange(V)[None, :] == lab[:, None]

    def dlog(logits, lse, rows=slice(None)):
        return (np.exp(logits - lse[rows, None]) - onehot[rows]) \
            * ct[rows, None]

    def f32_product(a, b_):
        (ab, as_), (bb, bs) = _split(a), _split(b_)
        return ab @ bb if passes == 1 else ab @ bs + as_ @ bb + ab @ bb

    logits64 = x.astype(np.float64) @ w + b
    lse64 = np.log(np.exp(logits64).sum(1))
    want = x.T.astype(np.float64) @ dlog(logits64, lse64)
    lse = lse64.astype(np.float32)
    if sums == "float32":
        dl = dlog(f32_product(x, w) + b, lse).astype(np.float32)
        got = f32_product(x.T.copy(), dl)
    else:
        got = np.zeros((D, V), np.float32)
        for r0 in range(0, N, 64):
            rows = slice(r0, r0 + 64)
            dl = dlog(_tc_product(x[rows], w, passes) + b, lse,
                      rows).astype(np.float32)
            got = got + _tc_product(x[rows].T.copy(), dl, passes)
    err = np.abs(got - want).max() / max(1.0, np.abs(want).max())
    if passes == 1:
        assert err > 1e-4
    else:
        assert err <= 1e-5


def _trunc_tf32(a):
    """float32 as the tensor cores read a TF32 operand: the low 13
    mantissa bits dropped."""
    u = np.asarray(a, np.float32).view(np.uint32)
    return (u & np.uint32(0xFFFFE000)).view(np.float32)


def _split_as_read(a):
    """The dx kernel's split: big = a with its low 13 mantissa bits
    cleared, small = a - big kept in float32 and truncated by the tensor
    cores."""
    big = _trunc_tf32(a)
    return big, _trunc_tf32(a - big)


@pytest.mark.parametrize("passes, sums", [
    (1, "float32"), (3, "float32"), (3, "tensor cores, as the kernel"),
    (3, "tensor cores, kept in the MMAs")])
def test_tf32_split_keeps_dx_within_tolerance(passes, sums):
    """dx = dlog @ wᵀ through both of its products (the logits x @ w + b,
    then dlog @ wᵀ) with TF32 operands, against float64, at (384, 200,
    3000) with chip_smoke.py's scales: one pass misses the card's
    tolerance (1e-4 of max(1, max|dx|)); the three-pass split keeps 1e-5,
    with float32 sums and with the dx kernel's own arithmetic: operands
    split by truncation, small parts kept in float32 and truncated by the
    tensor cores; the logits' big·big pass in one accumulator and the two
    small passes in another, each over all of D, added in float32; each
    8-column step of dlog @ wᵀ in fresh accumulators (every MMA's sum
    truncated), added to dx in float32. The same arithmetic with dx's
    sums kept inside the MMAs over all of V drifts past 1e-5: the reason
    for the fresh accumulators."""
    N, D, V = 384, 200, 3000
    r = np.random.RandomState(7)
    x = r.randn(N, D).astype(np.float32)
    w = (r.randn(D, V) / np.sqrt(D)).astype(np.float32)
    b = (r.randn(V) * 0.1).astype(np.float32)
    lab, ct = r.randint(0, V, N), r.randn(N).astype(np.float32)
    onehot = np.arange(V)[None, :] == lab[:, None]

    def dlog(logits, lse):
        return (np.exp(logits - lse[:, None]) - onehot) * ct[:, None]

    logits64 = x.astype(np.float64) @ w + b
    lse64 = np.log(np.exp(logits64).sum(1))
    want = dlog(logits64, lse64) @ w.T.astype(np.float64)
    lse = lse64.astype(np.float32)
    if sums == "float32":
        def product(a, b_):
            (ab, as_), (bb, bs) = _split(a), _split(b_)
            return ab @ bb if passes == 1 else ab @ bs + as_ @ bb + ab @ bb

        dl = dlog(product(x, w) + b, lse).astype(np.float32)
        got = product(dl, w.T.copy())
    else:
        (xb, xs), (wb, ws) = _split_as_read(x), _split_as_read(w)
        steps = [slice(k, k + 8) for k in range(0, D, 8)]
        small = _tc_steps([(xb, ws), (xs, wb)], steps)
        big = _tc_steps([(xb, wb)], steps)
        dl = dlog(small + big + b, lse).astype(np.float32)
        (db_, ds_), (tb, ts) = _split_as_read(dl), _split_as_read(w.T)
        terms = [(ds_, tb), (db_, ts), (db_, tb)]
        steps = [slice(c, c + 8) for c in range(0, V, 8)]
        if sums.endswith("in the MMAs"):
            got = _tc_steps(terms, steps)
        else:
            got = np.zeros((N, D), np.float32)
            for c in steps:
                got = got + _tc_steps(terms, [c])
    err = np.abs(got - want).max() / max(1.0, np.abs(want).max())
    if sums.endswith("in the MMAs"):
        assert err > 1e-5
    elif passes == 1:
        assert err > 1e-4
    else:
        assert err <= 1e-5


@pytest.mark.parametrize("passes, sums, bias", [
    (1, "float32", "randn 0.1"), (3, "float32", "randn 0.1"),
    (3, "tensor cores, as the kernel", "randn 0.1"),
    (3, "tensor cores, as the kernel", "100 every 97th column")])
def test_tf32_split_keeps_forward_within_tolerance(passes, sums, bias):
    """lse and nll of x @ w + b with the logits formed from TF32 operands,
    against float64, at (384, 200, 3000) with chip_smoke.py's scales (b
    randn * 0.1, and its case of a bias of 100 on every 97th column).
    Tolerance: |got - want| <= 1e-5 + 1e-5 |want|, tests/test_vocab_xent.py's
    for nll. One pass misses it (some 1e-3 off); three passes keep it,
    with float32 sums and with the forward kernel's own arithmetic: dx's
    split by truncation, the big·big pass in one accumulator and the two
    small passes in another over all of D, every MMA's sum truncated to
    float32, the two added in float32, then the bias; each row's online
    (max, sumexp, gold) over 64-column tiles in float32."""
    N, D, V = 384, 200, 3000
    r = np.random.RandomState(11)
    x = r.randn(N, D).astype(np.float32)
    w = (r.randn(D, V) / np.sqrt(D)).astype(np.float32)
    b = (r.randn(V) * 0.1).astype(np.float32)
    if bias.startswith("100"):
        b[::97] = 100.0
    lab = r.randint(0, V, N)
    rows = np.arange(N)

    logits64 = x.astype(np.float64) @ w + b
    m64 = logits64.max(1)
    lse64 = m64 + np.log(np.exp(logits64 - m64[:, None]).sum(1))
    nll64 = lse64 - logits64[rows, lab]

    (xb, xs), (wb, ws) = _split_as_read(x), _split_as_read(w)
    if sums == "float32":
        prod = xb.astype(np.float64) @ wb
        if passes == 3:
            prod = prod + xb.astype(np.float64) @ ws + xs.astype(
                np.float64) @ wb
        logits = prod.astype(np.float32) + b
    else:
        steps = [slice(k, k + 8) for k in range(0, D, 8)]
        small = _tc_steps([(xb, ws), (xs, wb)], steps)
        big = _tc_steps([(xb, wb)], steps)
        logits = (small + big) + b
    m = np.full(N, -1e30, np.float32)
    l = np.zeros(N, np.float32)
    gold = np.zeros(N, np.float32)
    for c0 in range(0, V, 64):
        tile = logits[:, c0:c0 + 64]
        m_new = np.maximum(m, tile.max(1))
        l = l * np.exp(m - m_new) + np.exp(tile - m_new[:, None]).sum(1)
        m = m_new
        cols = np.arange(c0, c0 + tile.shape[1])
        gold = gold + np.where(cols[None, :] == lab[:, None], tile, 0).sum(1)
    lse = m + np.log(l)
    nll = lse - gold
    for got, want in ((lse, lse64), (nll, nll64)):
        within = np.abs(got - want) <= 1e-5 + 1e-5 * np.abs(want)
        if passes == 1:
            assert not within.all()
        else:
            assert within.all(), np.abs(got - want).max()


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc (the port's CUDA kernels)")


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(37, 16, 300), (300, 200, 4100),
                                   (1, 8, 30001), (256, 1000, 5000),
                                   (1, 1000, 5000), (130, 520, 700),
                                   (64, 37, 257), (700, 512, 3000)])
def test_kernels_match_plain_on_the_card(shape):
    _needs_card()
    x, w, b, lab, ct = _case(*shape, seed=5)
    lab[0] = -1
    args = [torch.from_numpy(a).cuda() for a in (x, w, b)]
    labels, ctc = torch.from_numpy(lab).cuda(), torch.from_numpy(ct).cuda()
    nll, lse = tv.vocab_xent_fwd(*args, labels)
    want_nll, want_lse = tv.vocab_xent_plain(*args, labels)
    torch.cuda.synchronize()
    assert (nll - want_nll).abs().max().item() <= 1e-4
    assert (lse - want_lse).abs().max().item() <= 1e-4
    got = tv.vocab_xent_bwd(*args, labels, want_lse, ctc)
    want = tv.vocab_xent_bwd_plain(*args, labels, want_lse, ctc)
    torch.cuda.synchronize()
    for g, w_ in zip(got, want):
        assert (g - w_).abs().max().item() <= 1e-4 * max(
            1.0, w_.abs().max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(7680, 512, 30000), (512, 512, 30000)])
def test_forward_matches_plain_at_the_main_paths_shapes(shape):
    """The tensor-core forward at chip_smoke.py's two main paths' shapes
    (bench_nmt's output projection, and over 512 of its rows), over the
    wrapper's slices: each partial (max, sumexp, gold) within 1e-4 of its
    largest value, as chip_smoke.py holds them, nll and lse within 1e-4,
    and two launches bit-equal."""
    _needs_card()
    N, D, V = shape
    x, w, b, lab, _ = _case(N, D, V, seed=12, w_scale=1 / np.sqrt(D))
    x, w, b, lab = [torch.from_numpy(a).cuda() for a in (x, w, b, lab)]
    S = tv.fwd_slices(x, w)
    part = tv.vocab_xent_fwd_partials(x, w, b, lab, S)
    again = tv.vocab_xent_fwd_partials(x, w, b, lab, S)
    want = tv.vocab_xent_fwd_partials_plain(x, w, b, lab, S)
    torch.cuda.synchronize()
    assert torch.equal(part, again)
    for g, w_ in zip(part, want):
        assert (g - w_).abs().max().item() <= 1e-4 * max(
            1.0, w_.abs().max().item())
    for g, w_ in zip(tv.vocab_xent_fwd_reduce(part),
                     tv.vocab_xent_plain(x, w, b, lab)):
        assert (g - w_).abs().max().item() <= 1e-4


@pytest.mark.cuda
def test_dw_kernel_is_deterministic_on_the_card():
    """Two launches of the dW/db kernel give the same bits (no atomics)."""
    _needs_card()
    x, w, b, lab, ct = _case(700, 96, 3000, seed=8)
    args = [torch.from_numpy(a).cuda() for a in (x, w, b, lab, ct)]
    lse = tv.vocab_xent_plain(*args[:4])[1]
    first = tv.vocab_xent_bwd_dw(*args[:4], lse, args[4])
    second = tv.vocab_xent_bwd_dw(*args[:4], lse, args[4])
    torch.cuda.synchronize()
    for a, b_ in zip(first, second):
        assert torch.equal(a, b_)


@pytest.mark.cuda
@pytest.mark.parametrize("S,N,D", [(16, 512, 512), (2, 7680, 512),
                                   (19, 37, 21), (3, 5, 7)])
def test_dx_sum_is_bit_equal_to_plain_on_the_card(S, N, D):
    """The dx sum kernel adds the slices' partials in slice order, as its
    plain version does: the same bits, at the second main path's S = 16
    on [16, 512, 512], past one group of 16 loads (S = 19), and where
    N * D is no multiple of 4 (float loads)."""
    _needs_card()
    part = torch.from_numpy(np.random.RandomState(S).randn(S, N, D)
                            .astype(np.float32)).cuda()
    got = tv.vocab_xent_bwd_dx_reduce(part)
    torch.cuda.synchronize()
    assert torch.equal(got, tv.vocab_xent_bwd_dx_reduce_plain(part))


@pytest.mark.cuda
def test_dx_kernel_is_deterministic_on_the_card():
    """Two launches of the dx kernel give the same bits (no atomics), at
    one slice and at several."""
    _needs_card()
    x, w, b, lab, ct = _case(700, 520, 3000, seed=9)
    args = [torch.from_numpy(a).cuda() for a in (x, w, b, lab, ct)]
    lse = tv.vocab_xent_plain(*args[:4])[1]
    for S in (1, 3):
        first = tv.vocab_xent_bwd_dx_partials(*args[:4], lse, args[4], S)
        second = tv.vocab_xent_bwd_dx_partials(*args[:4], lse, args[4], S)
        torch.cuda.synchronize()
        assert torch.equal(first, second)


@pytest.mark.cuda
def test_kernels_refuse_bf16():
    _needs_card()
    x = torch.zeros(4, 3, device="cuda", dtype=torch.bfloat16)
    w = torch.zeros(3, 5, device="cuda", dtype=torch.bfloat16)
    b = torch.zeros(5, device="cuda")
    with pytest.raises(Error, match="takes float32"):
        tv.vocab_xent(x, w, b, torch.zeros(4, device="cuda",
                                           dtype=torch.int64))
