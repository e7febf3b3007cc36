"""The port's fused GRU backward (paddle_tpu_torch.kernels.gru) against the
JAX package's: ``jax.grad`` through ``paddle_tpu.kernels.gru.fused_gru``
run in interpret mode (its custom_vjp launches the Pallas ``_bwd_kernel``),
as tests/test_gru_kernel.py runs it; and the port's gated_recurrent
layer's gradient against the JAX layer's.

Inputs and upstream gradients are drawn with numpy and handed to both.
Tolerance: rtol = atol = 1e-4 on dx3, dWg, dWc and db (float32 on both
sides; the products and the dW and db sums run in another order). The
differences measured on these inputs stay below 2e-6.

The kernels run only on a card: the ``cuda`` tests hold them against the
plain versions there and skip elsewhere.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pj
import paddle_tpu.kernels.gru as jax_gru
from paddle_tpu.core.layer import layer_name_scope as jax_name_scope
from paddle_tpu.trainer.feeder import DataFeeder as JFeeder

import paddle_tpu_torch as pt
from paddle_tpu_torch import kernels as tk
from paddle_tpu_torch.core.layer import layer_name_scope as torch_name_scope
from paddle_tpu_torch.kernels import gru as tg
from paddle_tpu_torch.trainer.feeder import DataFeeder as TFeeder
from paddle_tpu_torch.utils.error import Error

TOL = dict(rtol=1e-4, atol=1e-4)
NAMES = ("dx3", "dWg", "dWc", "db")


def _data(B, T, H, case, seed):
    """x3, Wg, Wc, bias, mask, reset (or None), g_hs. Ragged rows; the
    upstream gradient of hs is zero past each row's end, as the layer's
    mask multiply makes it."""
    r = np.random.RandomState(seed)
    x3 = (r.randn(B, T, 3 * H) * 0.5).astype(np.float32)
    wg = (r.randn(H, 2 * H) * 0.1).astype(np.float32)
    wc = (r.randn(H, H) * 0.1).astype(np.float32)
    b = (r.randn(3 * H) * 0.2).astype(np.float32)
    lens = r.randint(1, T + 1, size=B)
    lens[0] = T
    mask = (np.arange(T)[None] < lens[:, None]).astype(np.float32)
    reset = None
    if case == "reset":
        reset = (r.rand(B, T) < 0.25).astype(np.float32) * mask
        reset[:, 0] = 0
    g_hs = (r.randn(B, T, H) * mask[..., None]).astype(np.float32)
    return x3, wg, wc, b, mask, reset, g_hs


def _t(a):
    return None if a is None else torch.from_numpy(a)


def _jax_grads(x3, wg, wc, b, mask, reset, g_hs):
    """(dx3, dWg, dWc, db) of sum(hs*g_hs) through the JAX package's
    fused_gru, in interpret mode."""
    jr = None if reset is None else jnp.asarray(reset)

    def loss(x3, wg, wc, b):
        hs = jax_gru.fused_gru(x3, wg, wc, b, jnp.asarray(mask), jr, True)
        return (hs * g_hs).sum()

    g = jax.grad(loss, argnums=(0, 1, 2, 3))(
        jnp.asarray(x3), jnp.asarray(wg), jnp.asarray(wc), jnp.asarray(b))
    return [np.asarray(a) for a in g]


def _port_grads(x3, wg, wc, b, mask, reset, g_hs):
    """The same through the port's autograd Function (CPU: the plain
    forward with its stash, then fused_gru_bwd_plain)."""
    leaves = [torch.from_numpy(a).requires_grad_(True)
              for a in (x3, wg, wc, b)]
    hs = tg.fused_gru(*leaves, _t(mask), _t(reset))
    (hs * _t(g_hs)).sum().backward()
    return [a.grad.numpy() for a in leaves]


@pytest.mark.parametrize("B,T,H,case", [
    (8, 3, 128, "ragged"),     # T below the Pallas backward chunk (4)
    (8, 11, 128, "ragged"),    # T above the forward chunk (8)
    (8, 6, 128, "reset"),
    (8, 9, 128, "reset"),
    (3, 7, 8, "ragged"),
    (5, 11, 12, "reset"),
])
def test_function_grad_matches_jax_kernel(B, T, H, case):
    data = _data(B, T, H, case, B * 100 + T + H)
    want = _jax_grads(*data)
    got = _port_grads(*data)
    for name, g, w in zip(NAMES, got, want):
        assert np.isfinite(g).all(), name
        np.testing.assert_allclose(g, w, err_msg=name, **TOL)


@pytest.mark.parametrize("case", ["ragged", "reset"])
def test_stash_matches_jax_kernel_gates(case):
    """The plain forward's z|r|c stash is the Pallas forward's, padded
    steps included (the backward multiplies by the mask there)."""
    x3, wg, wc, b, mask, reset = _data(4, 9, 16, case, 3)[:6]
    jr = None if reset is None else jnp.asarray(reset)
    res = jax_gru._fwd_res(jnp.asarray(x3), jnp.asarray(wg), jnp.asarray(wc),
                           jnp.asarray(b), jnp.asarray(mask), jr, True)
    want = np.swapaxes(np.asarray(res[1]), 0, 1)[:, :9]
    hs, gates = tg.fused_gru_plain(_t(x3), _t(wg), _t(wc), _t(b), _t(mask),
                                   _t(reset), with_gates=True)
    np.testing.assert_allclose(gates.numpy(), want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(hs.numpy(), np.asarray(res[0]), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("case", ["ragged", "reset"])
def test_plain_bwd_matches_autograd_of_plain_forward(case):
    """fused_gru_bwd_plain (a reverse loop over the stash) against
    autograd through the plain forward, in float64, to 1e-10."""
    x3, wg, wc, b, mask, reset, g_hs = (
        None if a is None else torch.from_numpy(a).double()
        for a in _data(3, 11, 8, case, 5))
    leaves = [a.clone().requires_grad_(True) for a in (x3, wg, wc, b)]
    hs, gates = tg.fused_gru_plain(*leaves, mask, reset, with_gates=True)
    (hs * g_hs).sum().backward()
    got = tg.fused_gru_bwd_plain(wg, wc, mask, reset, gates.detach(),
                                 hs.detach(), g_hs)
    for name, g, leaf in zip(NAMES, got, leaves):
        torch.testing.assert_close(g, leaf.grad, rtol=1e-10, atol=1e-10,
                                   msg=name)


@pytest.mark.parametrize("case", ["ragged", "reset"])
def test_dw_plain_matches_in_loop_sums(case):
    """The dW kernel's plain version (one product over every (row, step)
    pair from dx3) equals the reverse loop's per-step sums."""
    x3, wg, wc, b, mask, reset, g_hs = (_t(a) for a in
                                        _data(5, 9, 16, case, 9))
    hs, gates = tg.fused_gru_plain(x3, wg, wc, b, mask, reset, True)
    dx3, dwg, dwc, db = tg.fused_gru_bwd_plain(wg, wc, mask, reset, gates,
                                               hs, g_hs)
    for got, want in zip(tg.fused_gru_bwd_dw(dx3, gates, hs, reset),
                         (dwg, dwc, db)):
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    # padded steps carry no gradient
    assert not dx3[mask == 0].any()


@pytest.mark.parametrize("case", ["ragged", "reset"])
def test_dw_split_partials_sum_to_the_plain_dw(case):
    """The dW kernel's split (its partials' plain version and their sum in
    split order) gives :func:`gru_dw_db_plain`'s dWg, dWc and db at every
    split count, down to one 32-pair chunk a split; the splits cover the
    pairs in whole chunks."""
    x3, wg, wc, b, mask, reset, g_hs = (_t(a) for a in
                                        _data(5, 41, 16, case, 11))
    hs, gates = tg.fused_gru_plain(x3, wg, wc, b, mask, reset, True)
    dx3 = tg.fused_gru_bwd_plain(wg, wc, mask, reset, gates, hs, g_hs)[0]
    want = tg._dw_flat(*tg.gru_dw_db_plain(dx3, gates, hs, reset))
    N = 5 * 41
    for S in (1, 2, 3, 7):
        spans = tg._split_pairs(N, S)
        assert spans[0][0] == 0 and spans[-1][1] == N
        assert all(p1 == q0 for (_, p1), (q0, _) in zip(spans, spans[1:]))
        assert all(p0 % 32 == 0 and p1 > p0 for p0, p1 in spans)
        part = tg.gru_dw_partials(dx3, gates, hs, reset, S)
        assert tuple(part.shape) == (S, 3 * 16 * 16 + 3 * 16)
        torch.testing.assert_close(tg.gru_dw_reduce(part), want, rtol=1e-5,
                                   atol=1e-5)
    with pytest.raises(Error, match="S=8 splits of 7 chunks"):
        tg.gru_dw_partials(dx3, gates, hs, reset, 8)


def test_dw_reduce_plain_sums_in_split_order():
    part = torch.tensor([[1e8, 1.0], [1.0, 2.0], [-1e8, 3.0]])
    # (1e8 + 1) - 1e8 in float32 is 0: the order shows
    assert tg.gru_dw_reduce_plain(part).tolist() == [0.0, 6.0]


def test_dw_splits_come_from_the_shape_and_fill_the_card(monkeypatch):
    """S depends on (B*T, H) alone, never on a device: the tagger's
    (32, 512, 128) gives its 12 output tiles at least two blocks an SM of
    an H100 (264), H = 512 gives S of 1 or 2, and a split holds at least
    one 32-pair chunk."""
    def no_device(*a, **k):
        raise AssertionError("the split count asked the device")

    monkeypatch.setattr(torch.cuda, "get_device_properties", no_device)
    monkeypatch.setattr(torch.cuda, "is_available", no_device)
    S = tg.gru_dw_splits(32 * 512, 128)
    assert S == 22 and 12 * S >= 264
    for B, T in ((64, 100), (256, 30), (64, 32)):
        assert tg.gru_dw_splits(B * T, 512) in (1, 2)
        assert (16 + 8) * 8 * tg.gru_dw_splits(B * T, 512) >= 264
    assert tg.gru_dw_splits(32, 128) == 1
    assert tg.gru_dw_splits(33, 128) == 2
    assert tg.gru_dw_splits(7, 4) == 1
    assert all(tg.gru_dw_splits(N, H) <= -(-N // 32)
               for N in (1, 31, 32, 100, 1000) for H in (4, 64, 128, 512))


def test_dw_split_matches_jax_kernel_at_h128_with_reset():
    """dWg, dWc and db as the card computes them at H = 128 (the tagger's
    width): the split partials (here 10 of them) summed in order, against
    ``jax.grad`` through the Pallas backward in interpret mode."""
    x3, wg, wc, b, mask, reset, g_hs = _data(8, 40, 128, "reset", 21)
    want = _jax_grads(x3, wg, wc, b, mask, reset, g_hs)
    tx = [_t(a) for a in (x3, wg, wc, b, mask, reset, g_hs)]
    hs, gates = tg.fused_gru_plain(*tx[:6], True)
    dx3 = tg.fused_gru_bwd_plain(tx[1], tx[2], tx[4], tx[5], gates, hs,
                                 tx[6])[0]
    S = tg.gru_dw_splits(8 * 40, 128)
    assert S == 10
    got = tg._dw_views(tg.gru_dw_reduce(
        tg.gru_dw_partials(dx3, gates, hs, tx[5], S)), 128)
    for name, g, w in zip(NAMES[1:], got, want[1:]):
        np.testing.assert_allclose(g.numpy(), w, err_msg=name, **TOL)


# --- a numpy model of the dW kernel's arithmetic ----------------------------

def _trunc_tf32(a):
    """float32 as the tensor cores read a TF32 operand: the low 13
    mantissa bits dropped."""
    u = np.asarray(a, np.float32).view(np.uint32)
    return (u & np.uint32(0xFFFFE000)).view(np.float32)


def _split_as_read(a):
    """The kernel's split_big: big = a with its low 13 mantissa bits
    cleared, small = a - big kept in float32 and truncated by the tensor
    cores."""
    big = _trunc_tf32(a)
    return big, _trunc_tf32(a - big)


def _trunc32(v):
    """float64 to float32 toward zero: the tensor cores' float32 sums."""
    f = v.astype(np.float32)
    over = np.abs(f.astype(np.float64)) > np.abs(v)
    return np.where(over, np.nextafter(f, np.float32(0)), f)


def _tc_chunk(at, d, p0, p1):
    """A^T D over pairs [p0, p1) as the kernel forms one chunk: a fresh
    accumulator through depth steps of 8 pairs, three passes a step
    (big·small, small·big, big·big), every MMA's sum truncated."""
    (ab, as_), (db, ds) = at, d
    acc = None
    for k in range(p0, p1, 8):
        s = slice(k, min(k + 8, p1))
        for p, q in ((ab, ds), (as_, db), (ab, db)):
            step = p[:, s].astype(np.float64) @ q[s].astype(np.float64)
            acc = _trunc32(step if acc is None
                           else acc.astype(np.float64) + step)
    return acc


def _dw_model(a, d, S, kept_in_mmas=False):
    """The dW kernel on A [N, k] and D [N, j]: each split's chunks of 32
    pairs in fresh accumulators added in float32 (or, with
    ``kept_in_mmas``, one accumulator through all of a split's pairs),
    then the partials summed in split order in float32."""
    N = a.shape[0]
    at = tuple(x.T.copy() for x in _split_as_read(a))
    ds = _split_as_read(d)
    out = None
    for p0, p1 in tg._split_pairs(N, S):
        if kept_in_mmas:
            tot = _tc_chunk(at, ds, p0, p1)
        else:
            tot = np.zeros((a.shape[1], d.shape[1]), np.float32)
            for c in range(p0, p1, 32):
                tot = tot + _tc_chunk(at, ds, c, min(c + 32, p1))
        out = tot if out is None else out + tot
    return out


@pytest.mark.parametrize("B,T,H,cols", [(32, 512, 128, 32),
                                        (64, 100, 512, 16)])
def test_dw_kernel_arithmetic_keeps_the_card_tolerance(B, T, H, cols):
    """The dW kernel's arithmetic, modelled in numpy, against float64 at
    the tagger's 16384 pairs (H = 128, 22 splits) and at (64, 100, 512)'s
    6400 pairs (2 splits), on ragged rows with resets: operands split as
    split_big reads them, A = h_prev * (1 - reset) (times r for dWc)
    formed in float32, every MMA's sum truncated, each 32-pair chunk in
    fresh accumulators, the splits summed in order. It stays within the
    card test's 1e-4 of max(1, max|dW|) (some 1e-6 here). The same
    arithmetic with each split's sum kept inside the MMAs drifts further.
    Only ``cols`` of the k rows and of each part's columns are modelled
    (the pairs, whose sum is what drifts, are all there), to keep the
    model's float64 products small."""
    r = np.random.RandomState(B + T + H)
    N = B * T
    lens = r.randint(T // 2, T + 1, size=B)
    lens[0] = T
    mask = (np.arange(T)[None] < lens[:, None]).astype(np.float32)
    reset = ((r.rand(B, T) < 0.05) * mask).astype(np.float32)
    hs = np.tanh(r.randn(B, T, cols)).astype(np.float32)
    rg = (1 / (1 + np.exp(-r.randn(N, cols)))).astype(np.float32)
    d = (r.randn(N, 2 * cols) * mask.reshape(N, 1) * 0.3).astype(np.float32)
    h_prev = np.concatenate([np.zeros((B, 1, cols), np.float32),
                             hs[:, :-1]], 1).reshape(N, cols)
    h_prev = (h_prev * (1 - reset.reshape(N, 1))).astype(np.float32)
    a_c = (rg * h_prev).astype(np.float32)
    S = tg.gru_dw_splits(N, H)
    assert S == (22 if H == 128 else 2)
    err, drift = 0.0, 0.0
    for a, dd in ((h_prev, d[:, :cols]), (a_c, d[:, cols:])):
        want = a.astype(np.float64).T @ dd.astype(np.float64)
        scale = max(1.0, np.abs(want).max())
        err = max(err, np.abs(_dw_model(a, dd, S) - want).max() / scale)
        drift = max(drift, np.abs(_dw_model(a, dd, S, True) - want).max()
                    / scale)
    assert err <= 1e-5
    assert drift > err


# --- the recurrence's two kernels and the plan between them ------------------

# an H100's shared memory a block, which every plan must keep within
SMEM_PER_BLOCK = 227 * 1024


def _parent_bwd_supported(B, H):
    """fused_gru_bwd_supported before the grid kernel took two tile stages
    of H floats in place of one of 2H: the shapes the port took then."""
    smem = 4 * (4 * (H + 4) + 4 * (2 * H + 4) + 16 * (2 * H + 4) + 4 * B)
    per_sm = min(8, 228 * 1024 // (smem + 1024))
    return (B >= 1 and H >= 4 and H % 4 == 0 and smem <= SMEM_PER_BLOCK
            and H // 4 <= 132 * per_sm)


def test_bwd_plan_takes_the_cluster_path_at_the_taggers_shape():
    """The RNN CRF tagger's (B, H) = (32, 128) takes the cluster backward,
    as its forward takes the cluster forward; the NMT encoder's H = 512
    the grid kernel."""
    # 8 blocks of 16 units, 8 clusters of 4 rows
    assert tg.gru_bwd_plan(32, 128) == tg.bwd_cluster_plan(128, 8, 4)
    for B in (64, 256, 1, 5, 16):
        assert tg.gru_bwd_plan(B, 512) == tg.bwd_grid_plan(B, 512)


def test_bwd_plan_narrows_nothing_and_fits_shared_memory(monkeypatch):
    """Every (B, H) the backward took at the parent (H a multiple of 4 up
    to 648 where H/4 blocks co-reside) is still taken, by a kernel that
    exists, within a block's 227 KiB; the plan is a function of the shape
    and never asks a device."""
    def no_device(*a, **k):
        raise AssertionError("the plan asked the device")

    monkeypatch.setattr(torch.cuda, "get_device_properties", no_device)
    monkeypatch.setattr(torch.cuda, "is_available", no_device)
    taken = 0
    for H in range(4, 649, 4):
        for B in (1, 5, 32, 64, 256):
            plan = tg.gru_bwd_plan(B, H)
            assert plan == tg.gru_bwd_plan(B, H)
            assert plan.smem <= SMEM_PER_BLOCK
            if plan.path == "cluster":
                assert plan == tg.bwd_cluster_plan(H, plan.C, plan.R)
                assert -(-B // plan.R) * plan.C <= 132
            else:
                assert plan == tg.bwd_grid_plan(B, H)
            if _parent_bwd_supported(B, H):
                taken += 1
                assert tg.fused_gru_bwd_supported(B, H)
    # all but B = 256 at H = 636..648, where H/4 blocks do not co-reside
    assert taken == 162 * 5 - 4


@pytest.mark.parametrize("H,C,R", [(128, 3, 8), (128, 32, 8), (128, 8, 3),
                                   (120, 8, 8), (96, 1, 4), (1024, 16, 1)])
def test_bwd_cluster_plan_refuses_what_the_kernel_lacks(H, C, R):
    # C must divide H into a multiple of 4 units dividing 256, at most 16
    # blocks; R an instance's; the shared memory a block's
    with pytest.raises(Error):
        tg.bwd_cluster_plan(H, C, R)


def test_forced_bwd_plans_run_the_plain_version_on_cpu():
    x3, wg, wc, b, mask, reset, g_hs = (_t(a) for a in
                                        _data(5, 7, 64, "reset", 1))
    hs, gates = tg.fused_gru_plain(x3, wg, wc, b, mask, reset, True)
    want = tg.fused_gru_bwd_plain(wg, wc, mask, reset, gates, hs, g_hs)[0]
    before = dict(tk.launches)
    for plan in (tg.bwd_grid_plan(5, 64), tg.bwd_cluster_plan(64, 4, 8),
                 tg.gru_bwd_plan(5, 64)):
        got = tg.fused_gru_bwd_dx3(wg, wc, mask, reset, gates, hs, g_hs,
                                   plan=plan)
        assert torch.equal(got, want)
    assert tk.launches == before


def _parts_product(a, w, parts):
    """a [B, K] @ w[N, K]^T as the cluster kernel sums it in float32: part
    p's chain over k = p, p + parts, ... in k order, then the parts added
    in part order."""
    acc = np.zeros((a.shape[0], w.shape[0], parts), np.float32)
    for i in range(a.shape[1] // parts):
        ks = slice(i * parts, (i + 1) * parts)
        acc = acc + a[:, None, ks] * w[None, :, ks]
    out = acc[..., 0]
    for p in range(1, parts):
        out = out + acc[..., p]
    return out


def _cluster_bwd_model(wg, wc, mask, reset, gates, hs, g_hs, C):
    """dx3 as the cluster backward with C blocks a cluster forms it, in
    float32 numpy: per step, dc_pre and dz_pre, then drh and the dz half
    of the dh product (both from the first exchange), then dr_pre and the
    dr half; each product's k split in 256 / (H / C) parts; the carry
    (dh_new*z + dh_pass + drh*r) + (dz half + dr half), times the keep."""
    B, T, H = hs.shape
    parts = 256 // (H // C)
    dx3 = np.zeros((B, T, 3 * H), np.float32)
    carry = np.zeros((B, H), np.float32)
    for t in reversed(range(T)):
        m = mask[:, t, None]
        keep = 1 - reset[:, t, None] if reset is not None else \
            np.ones_like(m)
        h_prev = hs[:, t - 1] * keep if t > 0 else np.zeros_like(carry)
        z, r, c = np.split(gates[:, t], 3, axis=-1)
        dh_t = g_hs[:, t] + carry
        dh_new = m * dh_t
        dz = dh_new * (h_prev - c) * z * (1 - z)
        dc = dh_new * (1 - z) * (1 - c * c)
        part = dh_new * z + (1 - m) * dh_t
        dx3[:, t, :H], dx3[:, t, 2 * H:] = dz, dc
        if t == 0:
            break
        drh = _parts_product(dc, wc, parts)
        dz_half = _parts_product(dz, wg[:, :H], parts)
        dr = drh * h_prev * r * (1 - r)
        dx3[:, t, H:2 * H] = dr
        part = part + drh * r
        carry = (part + (dz_half + _parts_product(dr, wg[:, H:], parts))) \
            * keep
    return dx3


@pytest.mark.parametrize("B,T,H,case", [(8, 9, 128, "reset"),
                                        (32, 16, 128, "ragged")])
def test_cluster_kernel_arithmetic_matches_jax_kernel(B, T, H, case):
    """The cluster backward's summation order, modelled in float32 numpy
    (the plan's C at the shape, so 16 k-parts at H = 128; the dh product
    in its dz and dr halves), against ``jax.grad`` through the Pallas
    backward in interpret mode: dx3, and dWg, dWc and db formed from it,
    within 1e-4."""
    x3, wg, wc, b, mask, reset, g_hs = _data(B, T, H, case, B * T + H)
    want = _jax_grads(x3, wg, wc, b, mask, reset, g_hs)
    plan = tg.gru_bwd_plan(B, H)
    assert plan.path == "cluster" and plan.C == 8
    hs, gates = (a.numpy() for a in tg.fused_gru_plain(
        _t(x3), _t(wg), _t(wc), _t(b), _t(mask), _t(reset), True))
    dx3 = _cluster_bwd_model(wg, wc, mask, reset, gates, hs, g_hs, plan.C)
    got = [dx3] + [a.numpy() for a in tg.gru_dw_db_plain(
        _t(dx3), _t(gates), _t(hs), _t(reset))]
    for name, g, w in zip(NAMES, got, want):
        assert np.isfinite(g).all(), name
        np.testing.assert_allclose(g, w, err_msg=name, **TOL)


def test_library_path_hashes_the_headers_a_source_includes(tmp_path,
                                                           monkeypatch):
    """A library's name hashes its source and every header the source
    includes with quotes, nested ones too: an edit to a header rebuilds
    every library that includes it. Both GRU sources and the LSTM
    backward include csrc/hopper.cuh, the helpers they share; the GRU's and
    the LSTM's backward csrc/dw_tf32.cuh, their dW kernels' 3xTF32 core."""
    from paddle_tpu_torch.kernels import _build

    assert [f.name for f in _build._included(_build.CSRC / "gru_fwd.cu")] \
        == ["gru_fwd.cu", "hopper.cuh"]
    for name in ("gru_bwd", "lstm_bwd"):
        assert [f.name for f in _build._included(_build.CSRC / f"{name}.cu")] \
            == [f"{name}.cu", "dw_tf32.cuh", "hopper.cuh"]
    (tmp_path / "k.cu").write_text('#include <cuda_runtime.h>\n'
                                   '#include "a.cuh"\n')
    (tmp_path / "a.cuh").write_text('#pragma once\n  # include "b.cuh"\n')
    (tmp_path / "b.cuh").write_text("// one\n")
    (tmp_path / "c.cu").write_text("// no header\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    first, other = _build.library_path("k"), _build.library_path("c")
    assert _build.library_path("k") == first
    (tmp_path / "b.cuh").write_text("// two\n")
    second = _build.library_path("k")
    assert second != first and second.name.startswith("libk-")
    (tmp_path / "a.cuh").write_text('#pragma once\n#include "b.cuh"\n')
    assert _build.library_path("k") not in (first, second)
    assert _build.library_path("c") == other


def test_function_gradcheck_float64():
    x3, wg, wc, b, mask, reset = (None if a is None else
                                  torch.from_numpy(a).double()
                                  for a in _data(2, 5, 4, "reset", 1)[:6])
    args = tuple(a.clone().requires_grad_(True) for a in (x3, wg, wc, b))
    assert torch.autograd.gradcheck(
        lambda x3, wg, wc, b: tg.fused_gru(x3, wg, wc, b, mask, reset), args)


def test_cpu_gradient_launches_no_kernel():
    data = _data(3, 6, 8, "ragged", 2)
    before = dict(tk.launches)
    _port_grads(*data)
    assert tk.launches == before


def test_no_grad_forward_keeps_no_stash():
    """Without grad the wrapper takes the serving path (no Function, no
    stash); with it the output carries the Function's graph."""
    x3, wg, wc, b, mask = (_t(a) for a in _data(2, 4, 8, "ragged", 4)[:5])
    wc.requires_grad_(True)
    with torch.no_grad():
        hs = tg.fused_gru(x3, wg, wc, b, mask)
    assert hs.grad_fn is None
    assert type(tg.fused_gru(x3, wg, wc, b, mask).grad_fn).__name__ == \
        "_FusedGRUBackward"


def test_bwd_support_predicate_for_hopper():
    # H/4 blocks of Wc's and Wg's 4 rows + a 16-row tile of 2H floats +
    # 4 floats of dh carry a batch row
    assert tg.fused_gru_bwd_supported(64, 512)
    assert tg.fused_gru_bwd_supported(256, 512)     # bench_nmt's batch
    assert tg.fused_gru_bwd_supported(1, 4)
    assert tg.fused_gru_bwd_supported(5, 12)
    # two blocks share an SM while one takes under 113 KiB
    assert tg.fused_gru_bwd_supported(64, 648)
    assert not tg.fused_gru_bwd_supported(64, 652)
    assert not tg.fused_gru_bwd_supported(64, 1024)
    # the dh carry grows with B: one block an SM, then none
    assert tg.fused_gru_bwd_supported(1024, 512)
    assert not tg.fused_gru_bwd_supported(1024, 600)
    assert not tg.fused_gru_bwd_supported(40000, 512)
    assert not tg.fused_gru_bwd_supported(0, 128)
    assert not tg.fused_gru_bwd_supported(4, 130)   # H % 4


def _bwd_args(**bad):
    B, T, H = 2, 3, 4
    args = dict(wg=torch.zeros(H, 2 * H), wc=torch.zeros(H, H),
                mask=torch.ones(B, T), reset=None,
                gates=torch.zeros(B, T, 3 * H), hs=torch.zeros(B, T, H),
                g_hs=torch.zeros(B, T, H))
    args.update(bad)
    return args


@pytest.mark.parametrize("bad", [
    dict(wg=torch.zeros(8, 4)), dict(wc=torch.zeros(4, 8)),
    dict(mask=torch.ones(3, 2)), dict(reset=torch.zeros(2, 4)),
    dict(gates=torch.zeros(2, 3, 8)), dict(g_hs=torch.zeros(2, 3, 5)),
    dict(hs=torch.zeros(2, 0, 4)),
    dict(g_hs=torch.zeros(2, 3, 4, dtype=torch.float64)),
    dict(wg=torch.zeros(4, 8, dtype=torch.int32)),
])
def test_bwd_wrapper_refuses_bad_shapes_and_dtypes(bad):
    with pytest.raises(Error):
        tg.fused_gru_bwd(**_bwd_args(**bad))


def test_bwd_wrappers_refuse_non_cuda_devices():
    """Tensors on another device than the CPU go to the kernels, which
    take CUDA tensors only: the wrappers raise, they never fall back."""
    args = _bwd_args(hs=torch.zeros(2, 3, 4, device="meta"))
    with pytest.raises(Error):
        tg.fused_gru_bwd(**args)
    with pytest.raises(Error):
        tg.fused_gru_bwd_dw(torch.zeros(2, 3, 12), torch.zeros(2, 3, 12),
                            torch.zeros(2, 3, 4, device="meta"))
    with pytest.raises(Error):
        tg.fused_gru_bwd_dw(torch.zeros(2, 3, 12), torch.zeros(2, 3, 9),
                            torch.zeros(2, 3, 4))


def _gru_model(mod, reverse):
    words = mod.layer.data(name="words",
                           type=mod.data_type.integer_value_sequence(30))
    emb = mod.layer.embedding(input=words, size=12)
    return mod.networks.simple_gru(input=emb, size=16, name="rnn",
                                   reverse=reverse)


@pytest.mark.parametrize("reverse", [False, True])
def test_gated_recurrent_layer_grad_matches_jax(reverse):
    """The gradient of sum(out * cot) through each package's embedding ->
    fc -> gated_recurrent on ragged lengths, every parameter: the port's
    through the fused_gru Function, the JAX layer's through its scan."""
    with jax_name_scope():
        jout = _gru_model(pj, reverse)
    with torch_name_scope():
        tout = _gru_model(pt, reverse)
    jtopo, ttopo = pj.Topology(jout), pt.Topology(tout)
    assert sorted(jtopo.param_specs()) == sorted(ttopo.param_specs())
    r = np.random.RandomState(4)
    d = {n: (r.randn(*s.shape) * 0.3).astype(np.float32)
         for n, s in sorted(ttopo.param_specs().items())}
    batch = [(r.randint(0, 30, size=n).tolist(),) for n in (1, 9, 4, 7, 2)]
    jfeeds = JFeeder(jtopo.data_type())(batch)
    T = jfeeds["words"].value.shape[1]
    cot = r.randn(len(batch), T, 16).astype(np.float32)

    def jloss(params):
        out = jtopo.forward(params, jfeeds, training=True,
                            rng=jax.random.PRNGKey(0))["rnn"]
        return (out.value * cot).sum()

    want = jax.grad(jloss)({k: jnp.asarray(v) for k, v in d.items()})
    tparams = {k: torch.from_numpy(v).requires_grad_(True)
               for k, v in d.items()}
    feeds = {k: a.to("cpu") for k, a in
             TFeeder(ttopo.data_type())(batch).items()}
    out = ttopo.forward(tparams, feeds, training=True)["rnn"]
    (out.value * torch.from_numpy(cot)).sum().backward()
    assert {"_rnn.w0", "_rnn.w1", "_rnn.wbias"} <= set(d)
    for k in d:
        np.testing.assert_allclose(tparams[k].grad.numpy(),
                                   np.asarray(want[k]), err_msg=k, **TOL)


def _cuda_case(B, T, H, case, seed):
    torch.backends.cuda.matmul.allow_tf32 = False
    return [None if a is None else torch.from_numpy(a).cuda()
            for a in _data(B, T, H, case, seed)]


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,H,case", [(64, 32, 512, "ragged"),
                                        (5, 37, 128, "reset"),
                                        (1, 100, 512, "ragged"),
                                        (32, 512, 128, "ragged"),
                                        (32, 512, 128, "reset")])
def test_bwd_kernels_match_plain_on_card(B, T, H, case):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    x3, wg, wc, b, mask, reset, g_hs = _cuda_case(B, T, H, case, 7)
    hs, gates = tg.fused_gru_fwd(x3, wg, wc, b, mask, reset, True)
    before = dict(tk.launches)
    got = tg.fused_gru_bwd(wg, wc, mask, reset, gates, hs, g_hs)
    torch.cuda.synchronize()
    # the recurrence through the kernel the plan picks
    ran = "fused_gru_bwd_cluster" \
        if tg.gru_bwd_plan(B, H).path == "cluster" else "fused_gru_bwd"
    assert tk.launches[ran] == before[ran] + 1
    assert tk.launches["fused_gru_bwd_dw"] == before["fused_gru_bwd_dw"] + 1
    assert tk.launches["fused_gru_bwd_dw_reduce"] == \
        before["fused_gru_bwd_dw_reduce"] + int(tg.gru_dw_splits(B * T, H) > 1)
    want = tg.fused_gru_bwd_plain(wg, wc, mask, reset, gates, hs, g_hs)
    # float32 on both sides; the products and the dW/db sums run in
    # another order
    for g, w_ in zip(got, want):
        scale = max(1.0, float(w_.abs().max()))
        assert float((g - w_).abs().max()) <= 1e-4 * scale


@pytest.mark.cuda
def test_forward_stash_matches_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    x3, wg, wc, b, mask, reset = _cuda_case(16, 40, 256, "reset", 3)[:6]
    hs, gates = tg.fused_gru_fwd(x3, wg, wc, b, mask, reset, True)
    hp, gp = tg.fused_gru_plain(x3, wg, wc, b, mask, reset, True)
    torch.cuda.synchronize()
    for g, w_ in ((hs, hp), (gates, gp)):
        torch.testing.assert_close(g, w_, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,H", [(32, 512, 128), (64, 100, 512)])
def test_dw_kernel_is_deterministic_on_card(B, T, H):
    """Two launches of the dW kernel (and its sum) give the same bits: no
    atomics, every sum in a fixed order."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    x3, wg, wc, b, mask, reset, g_hs = _cuda_case(B, T, H, "reset", 8)
    hs, gates = tg.fused_gru_fwd(x3, wg, wc, b, mask, reset, True)
    dx3 = tg.fused_gru_bwd_dx3(wg, wc, mask, reset, gates, hs, g_hs)
    first = tg.fused_gru_bwd_dw(dx3, gates, hs, reset)
    second = tg.fused_gru_bwd_dw(dx3, gates, hs, reset)
    torch.cuda.synchronize()
    assert all(torch.equal(a, c) for a, c in zip(first, second))


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,H,case", [(32, 512, 128, "ragged"),
                                        (32, 512, 128, "reset"),
                                        (5, 37, 128, "reset"),
                                        (64, 100, 256, "ragged")])
def test_bwd_cluster_kernel_matches_plain_on_card(B, T, H, case):
    """The cluster backward (the plan's at these shapes, the tagger's
    first): dx3 against the plain version's, relative to its largest
    value; two launches bit-equal; one launch counted."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    assert tg.gru_bwd_plan(B, H).path == "cluster"
    x3, wg, wc, b, mask, reset, g_hs = _cuda_case(B, T, H, case, 9)
    hs, gates = tg.fused_gru_fwd(x3, wg, wc, b, mask, reset, True)
    before = tk.launches["fused_gru_bwd_cluster"]
    got = tg.fused_gru_bwd_dx3(wg, wc, mask, reset, gates, hs, g_hs)
    torch.cuda.synchronize()
    assert tk.launches["fused_gru_bwd_cluster"] == before + 1
    want = tg.fused_gru_bwd_plain(wg, wc, mask, reset, gates, hs, g_hs)[0]
    scale = max(1.0, float(want.abs().max()))
    assert float((got - want).abs().max()) <= 1e-4 * scale
    again = tg.fused_gru_bwd_dx3(wg, wc, mask, reset, gates, hs, g_hs)
    torch.cuda.synchronize()
    assert torch.equal(got, again)


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,H", [(32, 512, 128), (5, 37, 128)])
def test_bwd_grid_kernel_forced_matches_plain_on_card(B, T, H):
    """The grid backward forced at the cluster kernel's shapes: the same
    dx3 within the tolerance, one launch of it counted."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    x3, wg, wc, b, mask, reset, g_hs = _cuda_case(B, T, H, "reset", 10)
    hs, gates = tg.fused_gru_fwd(x3, wg, wc, b, mask, reset, True)
    before = tk.launches["fused_gru_bwd"]
    got = tg.fused_gru_bwd_dx3(wg, wc, mask, reset, gates, hs, g_hs,
                               plan=tg.bwd_grid_plan(B, H))
    torch.cuda.synchronize()
    assert tk.launches["fused_gru_bwd"] == before + 1
    want = tg.fused_gru_bwd_plain(wg, wc, mask, reset, gates, hs, g_hs)[0]
    scale = max(1.0, float(want.abs().max()))
    assert float((got - want).abs().max()) <= 1e-4 * scale
