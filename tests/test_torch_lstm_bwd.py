"""The port's fused LSTM backward (paddle_tpu_torch.kernels.lstm) against
the JAX package's: ``jax.grad`` through ``paddle_tpu.kernels.lstm.
fused_lstm`` run in interpret mode (its custom_vjp launches the Pallas
``_bwd_kernel``, or ``_bwd_kernel_nodw`` when ``_FORCE_SPLIT_BWD`` is
set), as tests/test_kernels.py runs it.

Inputs and upstream gradients are drawn with numpy and handed to both.
Tolerance: rtol = atol = 1e-4 on dx4, dW and db, as tests/test_kernels.py
holds the Pallas backward to the scan; the differences measured on these
inputs stay near 3e-6 or below (float32 on both sides; the dW and db sums
run over (row, step) in another order).

The kernels run only on a card: the ``cuda`` tests hold them against the
plain version there and skip elsewhere.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu.kernels.lstm as jax_lstm

from paddle_tpu_torch import kernels as tk
from paddle_tpu_torch.kernels import lstm as tl
from paddle_tpu_torch.utils.error import Error

TOL = dict(rtol=1e-4, atol=1e-4)


def _data(B, T, H, case, seed):
    """x4, W, bias, mask, reset (or None), g_hs, g_cs. Ragged rows; the
    upstream gradient of hs is zero past each row's end, as the layer's
    mask multiply makes it."""
    r = np.random.RandomState(seed)
    x4 = (r.randn(B, T, 4 * H) * 0.5).astype(np.float32)
    w = (r.randn(H, 4 * H) * 0.1).astype(np.float32)
    b = (r.randn(7 * H) * 0.2).astype(np.float32)
    lens = r.randint(1, T + 1, size=B)
    lens[0] = T
    mask = (np.arange(T)[None] < lens[:, None]).astype(np.float32)
    reset = None
    if case == "reset":
        reset = (r.rand(B, T) < 0.25).astype(np.float32) * mask
        reset[:, 0] = 0
    g_hs = (r.randn(B, T, H) * mask[..., None]).astype(np.float32)
    g_cs = (r.randn(B, T, H) * 0.5).astype(np.float32)
    return x4, w, b, mask, reset, g_hs, g_cs


def _t(a):
    return None if a is None else torch.from_numpy(a)


def _jax_grads(x4, w, b, mask, reset, g_hs, g_cs):
    """(dx4, dW, db) of sum(hs*g_hs) + sum(cs*g_cs) through the JAX
    package's fused_lstm, in interpret mode."""
    jr = None if reset is None else jnp.asarray(reset)

    def loss(x4, w, b):
        hs, cs = jax_lstm.fused_lstm(x4, w, b, jnp.asarray(mask), jr, True)
        return (hs * g_hs).sum() + (cs * g_cs).sum()

    g = jax.grad(loss, argnums=(0, 1, 2))(jnp.asarray(x4), jnp.asarray(w),
                                         jnp.asarray(b))
    return [np.asarray(a) for a in g]


def _port_grads(x4, w, b, mask, reset, g_hs, g_cs):
    """The same through the port's autograd Function (CPU: the plain
    forward with its stash, then fused_lstm_bwd_plain)."""
    x4_, w_, b_ = (torch.from_numpy(a).requires_grad_(True)
                   for a in (x4, w, b))
    hs, cs = tl.fused_lstm(x4_, w_, b_, _t(mask), _t(reset))
    ((hs * _t(g_hs)).sum() + (cs * _t(g_cs)).sum()).backward()
    return [a.grad.numpy() for a in (x4_, w_, b_)]


@pytest.mark.parametrize("B,T,H,case,split", [
    (8, 5, 128, "ragged", False),     # T below the Pallas backward chunk
    (8, 13, 128, "ragged", True),
    (8, 13, 128, "reset", False),
    (8, 5, 128, "reset", True),
    (3, 7, 8, "ragged", False),
    (3, 7, 8, "reset", True),
])
def test_function_grad_matches_jax_kernel(monkeypatch, B, T, H, case,
                                          split):
    monkeypatch.setattr(jax_lstm, "_FORCE_SPLIT_BWD", split)
    monkeypatch.setattr(tl, "_FORCE_SPLIT_BWD", split)
    data = _data(B, T, H, case, B * 100 + T + H)
    want = _jax_grads(*data)
    got = _port_grads(*data)
    for name, g, w in zip(("dx4", "dW", "db"), got, want):
        assert np.isfinite(g).all(), name
        np.testing.assert_allclose(g, w, err_msg=name, **TOL)


@pytest.mark.parametrize("case", ["ragged", "reset"])
def test_stash_matches_jax_kernel_gates(case):
    """The plain forward's gate stash is the Pallas forward's, padded
    steps included (the backward multiplies by the mask there)."""
    x4, w, b, mask, reset = _data(4, 9, 16, case, 3)[:5]
    jr = None if reset is None else jnp.asarray(reset)
    res = jax_lstm._fwd_res(jnp.asarray(x4), jnp.asarray(w), jnp.asarray(b),
                            jnp.asarray(mask), jr, True)
    want = np.swapaxes(np.asarray(res[2]), 0, 1)[:, :9]
    _, _, gates = tl.fused_lstm_plain(_t(x4), _t(w), _t(b), _t(mask),
                                      _t(reset), with_gates=True)
    np.testing.assert_allclose(gates.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("case", ["ragged", "reset"])
def test_plain_bwd_matches_autograd_of_plain_forward(case):
    """fused_lstm_bwd_plain (a reverse loop over the stash) against
    autograd through the plain forward, in float64, to 1e-10."""
    x4, w, b, mask, reset, g_hs, g_cs = (
        None if a is None else torch.from_numpy(a).double()
        for a in _data(3, 11, 8, case, 5))
    x4_, w_, b_ = (a.clone().requires_grad_(True) for a in (x4, w, b))
    hs, cs, gates = tl.fused_lstm_plain(x4_, w_, b_, mask, reset, True)
    ((hs * g_hs).sum() + (cs * g_cs).sum()).backward()
    got = tl.fused_lstm_bwd_plain(w, b, mask, reset, gates.detach(),
                                  hs.detach(), cs.detach(), g_hs, g_cs)
    for name, g, want in zip(("dx4", "dW", "db"), got,
                             (x4_.grad, w_.grad, b_.grad)):
        torch.testing.assert_close(g, want, rtol=1e-10, atol=1e-10,
                                   msg=name)


@pytest.mark.parametrize("case", ["ragged", "reset"])
def test_split_dw_db_matches_in_kernel_sums(case):
    """The split form's dW/db, formed from dpre by one matmul and
    reductions (the CUDA path after lstm_bwd_nodw), equal the in-loop
    sums of the plain backward."""
    x4, w, b, mask, reset, g_hs, g_cs = (_t(a) for a in
                                         _data(5, 9, 16, case, 9))
    hs, cs, gates = tl.fused_lstm_plain(x4, w, b, mask, reset, True)
    dx4, dw, db = tl.fused_lstm_bwd_plain(w, b, mask, reset, gates, hs, cs,
                                          g_hs, g_cs)
    dw2, db2 = tl.split_dw_db(dx4, hs, cs, reset)
    torch.testing.assert_close(dw2, dw, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(db2, db, rtol=1e-5, atol=1e-5)


def test_function_gradcheck_float64():
    x4, w, b, mask, reset = (None if a is None else
                             torch.from_numpy(a).double()
                             for a in _data(2, 5, 4, "reset", 1)[:5])
    args = tuple(a.clone().requires_grad_(True) for a in (x4, w, b))
    assert torch.autograd.gradcheck(
        lambda x4, w, b: tl.fused_lstm(x4, w, b, mask, reset), args)


def test_cpu_gradient_launches_no_kernel():
    x4, w, b, mask, reset, g_hs, g_cs = _data(3, 6, 8, "ragged", 2)
    before = dict(tk.launches)
    _port_grads(x4, w, b, mask, reset, g_hs, g_cs)
    assert tk.launches == before


def test_no_grad_forward_keeps_no_stash():
    """Without grad the wrapper takes the serving path (no Function, no
    gate stash); with it the outputs carry the Function's graph."""
    x4, w, b, mask = (_t(a) for a in _data(2, 4, 8, "ragged", 4)[:4])
    w.requires_grad_(True)
    with torch.no_grad():
        hs, _ = tl.fused_lstm(x4, w, b, mask)
    assert hs.grad_fn is None
    hs, _ = tl.fused_lstm(x4, w, b, mask)
    assert type(hs.grad_fn).__name__ == "_FusedLSTMBackward"


def test_bwd_support_predicates_for_hopper():
    # the recurrence's plan: H a multiple of 4 whose blocks co-reside
    assert tl.fused_lstm_bwd_supported(64, 512)
    assert tl.fused_lstm_bwd_supported(1, 128)
    assert tl.fused_lstm_bwd_supported(64, 528)
    assert not tl.fused_lstm_bwd_supported(64, 532)   # 133 blocks, 1 per SM
    assert not tl.fused_lstm_bwd_supported(64, 1280)
    assert not tl.fused_lstm_bwd_supported(0, 128)
    assert not tl.fused_lstm_bwd_supported(4, 130)
    # dW and db go to the dW kernel at every shape the recurrence takes,
    # the large batches too; the split form only when forced
    assert tl._use_in_kernel_dw(64, 512)
    assert tl._use_in_kernel_dw(1024, 512)
    assert tl._use_in_kernel_dw(2048, 512)
    assert not tl._use_in_kernel_dw(4, 130)
    assert tl.fused_lstm_bwd_supported(2048, 512)


def test_force_split_switch(monkeypatch):
    monkeypatch.setattr(tl, "_FORCE_SPLIT_BWD", True)
    assert not tl._use_in_kernel_dw(64, 512)


# --- the recurrence's plan ----------------------------------------------------

# an H100's SMs and shared memory a block, which every plan must keep within
SMS, SMEM_PER_BLOCK = 132, 227 * 1024


def _parent_bwd_supported(B, H):
    """fused_lstm_bwd_supported when a block owned 4 units and every batch
    row (W's 4 rows, a 16-row tile of 4H floats, 8 floats of carries a
    row): the shapes the port took then."""
    smem = 4 * (4 * (4 * H + 16) + 16 * (4 * H + 4) + 64 + 256 + 8 * B)
    per_sm = min(8, 228 * 1024 // (smem + 1024))
    return (B >= 1 and H >= 4 and H % 4 == 0 and smem <= SMEM_PER_BLOCK
            and H // 4 <= SMS * per_sm)


@pytest.mark.parametrize("B,H,U,R,blocks", [
    (64, 512, 16, 16, 128),     # the classifier: 32 unit x 4 row groups
    (1, 512, 16, 16, 32),
    (5, 128, 16, 16, 8),
    (200, 512, 16, 64, 128),    # four 16-row tiles a block
    (2048, 512, 8, 1024, 128),  # U = 16 does not hold 2048 rows' carries
    (64, 100, 4, 64, 25),       # H not a multiple of 8
])
def test_bwd_plan_picks_units_and_rows_from_the_shape(monkeypatch, B, H, U,
                                                      R, blocks):
    def no_device(*a, **k):
        raise AssertionError("the plan asked the device")

    monkeypatch.setattr(torch.cuda, "get_device_properties", no_device)
    monkeypatch.setattr(torch.cuda, "is_available", no_device)
    plan = tl.lstm_bwd_plan(B, H)
    assert (plan.U, plan.R, plan.blocks) == (U, R, blocks)
    assert plan == tl.bwd_plan(B, H, U, R)
    assert plan.blocks == H // U * -(-B // R)
    assert R % (256 // U) == 0
    # the blocks co-reside, one an SM (203 KiB at the classifier's shape)
    assert plan.smem <= SMEM_PER_BLOCK and plan.blocks <= SMS


def test_bwd_plan_stages_a_quarter_of_the_parents_bytes():
    """At the classifier's shape a step stages each row's 4H floats of dpre
    once for each of the H / U blocks that share it: 16 MiB for U = 16
    where the parent's blocks of 4 units staged 64."""
    B, H = 64, 512
    plan = tl.lstm_bwd_plan(B, H)
    assert B * 4 * H * 4 * (H // plan.U) == 16 * 2**20
    assert B * 4 * H * 4 * (H // 4) == 64 * 2**20


def test_bwd_plan_narrows_nothing_and_fits_shared_memory():
    """Every (B, H) the parent took is still taken, by blocks that exist
    and fit at once; the most units a block win, then the most row
    groups."""
    taken = 0
    for H in range(4, 1300, 4):
        for B in (1, 2, 5, 16, 17, 64, 100, 256, 1024, 2048, 2088, 2089,
                  4096, 7000, 7168):
            plan = tl.lstm_bwd_plan(B, H)
            if _parent_bwd_supported(B, H):
                assert plan is not None, (B, H)
                taken += 1
            if plan is None:
                continue
            assert plan.smem <= SMEM_PER_BLOCK
            assert plan == tl.bwd_plan(B, H, plan.U, plan.R)
            assert all(H % U for U in (16, 8, 4) if U > plan.U) or \
                all(tl._bwd_fits(B, H, U, R) is None
                    for U in (16, 8) if U > plan.U and H % U == 0
                    for R in range(256 // U, B + 256 // U, 256 // U))
    assert taken > 1600


@pytest.mark.parametrize("U,H,R", [(32, 512, 16), (16, 520, 16),
                                   (16, 512, 8), (8, 512, 16), (4, 2048, 64)])
def test_bwd_plan_refuses_what_the_kernel_lacks(U, H, R):
    """No instance of U = 32; U must divide H; R a multiple of 256 / U;
    the blocks must fit at once (H = 2048 at U = 4: 512 blocks)."""
    with pytest.raises(Error, match="no recurrence"):
        tl.bwd_plan(64, H, U, R)


def test_forced_plan_runs_the_plain_version_on_cpu():
    x4, w, b, mask, reset, g_hs, g_cs = (_t(a) for a in
                                         _data(3, 6, 16, "reset", 2))
    hs, cs, gates = tl.fused_lstm_plain(x4, w, b, mask, reset, True)
    want = tl.fused_lstm_bwd_plain(w, b, mask, reset, gates, hs, cs, g_hs,
                                   g_cs)[0]
    got = tl.fused_lstm_bwd_nodw(w, b, mask, reset, gates, hs, cs, g_hs, g_cs,
                                 plan=tl.bwd_plan(3, 16, 4, 64))
    assert torch.equal(got, want)


# --- the dW kernel's split and its plain models ------------------------------

def test_dw_splits_come_from_the_shape_and_fill_the_card(monkeypatch):
    """S depends on (B*T, H) alone, never on a device: H = 512 gives 256
    output tiles, S = 2 (at least two blocks an SM of an H100, 264); a
    split holds at least one 32-pair chunk."""
    def no_device(*a, **k):
        raise AssertionError("the split count asked the device")

    monkeypatch.setattr(torch.cuda, "get_device_properties", no_device)
    monkeypatch.setattr(torch.cuda, "is_available", no_device)
    for B, T in ((64, 100), (64, 128), (1, 100)):
        assert tl.lstm_dw_splits(B * T, 512) == 2
        assert 32 * 8 * tl.lstm_dw_splits(B * T, 512) >= 264
    assert tl.lstm_dw_splits(5 * 37, 128) == 6     # 16 tiles; 6 chunks
    assert tl.lstm_dw_splits(4096, 128) == 17
    assert tl.lstm_dw_splits(32, 512) == 1
    assert tl.lstm_dw_splits(33, 512) == 2
    assert all(tl.lstm_dw_splits(N, H) <= -(-N // 32)
               for N in (1, 31, 32, 100, 1000) for H in (4, 64, 128, 512))


def test_dw_reduce_plain_sums_in_split_order():
    part = torch.tensor([[1e8, 1.0], [1.0, 2.0], [-1e8, 3.0]])
    # (1e8 + 1) - 1e8 in float32 is 0: the order shows
    assert tl.lstm_dw_reduce_plain(part).tolist() == [0.0, 6.0]


@pytest.mark.parametrize("case", ["ragged", "reset"])
def test_dw_split_partials_sum_to_split_dw_db(case):
    """The dW kernel's split (its partials' plain version and their sum in
    split order) gives :func:`split_dw_db`'s dW and db at every split
    count, down to one 32-pair chunk a split; the splits cover the pairs
    in whole chunks; the CPU's dW function is split_dw_db."""
    x4, w, b, mask, reset, g_hs, g_cs = (_t(a) for a in
                                         _data(5, 41, 16, case, 11))
    hs, cs, gates = tl.fused_lstm_plain(x4, w, b, mask, reset, True)
    dx4 = tl.fused_lstm_bwd_plain(w, b, mask, reset, gates, hs, cs, g_hs,
                                  g_cs)[0]
    dw, db = tl.split_dw_db(dx4, hs, cs, reset)
    want = torch.cat([dw.reshape(-1), db])
    N = 5 * 41
    for S in (1, 2, 3, 7):
        spans = tl._split_pairs(N, S)
        assert spans[0][0] == 0 and spans[-1][1] == N
        assert all(p1 == q0 for (_, p1), (q0, _) in zip(spans, spans[1:]))
        assert all(p0 % 32 == 0 and p1 > p0 for p0, p1 in spans)
        part = tl.lstm_dw_partials(dx4, hs, cs, reset, S)
        assert tuple(part.shape) == (S, 4 * 16 * 16 + 7 * 16)
        got = tl.lstm_dw_reduce(part)
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
        assert [a.shape for a in tl._dw_views(got, 16)] == [(16, 64), (112,)]
    for got, w_ in zip(tl.fused_lstm_bwd_dw(dx4, hs, cs, reset), (dw, db)):
        assert torch.equal(got, w_)
    with pytest.raises(Error, match="S=8 splits of 7 chunks"):
        tl.lstm_dw_partials(dx4, hs, cs, reset, 8)


@pytest.mark.parametrize("B,T,H,case,S", [
    (8, 13, 128, "ragged", 1),
    (8, 13, 128, "reset", 2),
    (8, 40, 128, "reset", 10),
    (3, 7, 8, "ragged", 1),
    (3, 37, 8, "reset", 4),
])
def test_dw_partials_match_jax_kernel(B, T, H, case, S):
    """dW and db as the card forms them, the dW kernel's partials' plain
    version summed by its sum's, against ``jax.grad`` through the JAX
    ``fused_lstm`` with the Pallas backward (``_bwd_call``, dW and db in
    its body) in interpret mode, on the JAX gradient's own dx4 (= dpre),
    within 1e-5."""
    data = _data(B, T, H, case, B * 10 + T + H + S)
    want = _jax_grads(*data)
    x4, w, b, mask, reset = (_t(a) for a in data[:5])
    hs, cs = tl.fused_lstm_plain(x4, w, b, mask, reset)
    part = tl.lstm_dw_partials_plain(torch.from_numpy(np.array(want[0])), hs, cs,
                                     reset, S)
    assert part.shape[0] == S
    got = tl._dw_views(tl.lstm_dw_reduce_plain(part), H)
    for name, g, w_ in zip(("dW", "db"), got, want[1:]):
        np.testing.assert_allclose(g.numpy(), w_, rtol=1e-5, atol=1e-5,
                                   err_msg=name)


def test_bwd_wrapper_refuses_cpu_cuda_mix():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    x4, w, b, mask, reset, g_hs, g_cs = (_t(a) for a in
                                         _data(2, 3, 4, "ragged", 0))
    hs, cs, gates = tl.fused_lstm_plain(x4, w, b, mask, None, True)
    with pytest.raises(Error):
        tl.fused_lstm_bwd(w, b, mask, None, gates, hs.to("meta"), cs, g_hs)


def _cuda_case(B, T, H, case, seed):
    torch.backends.cuda.matmul.allow_tf32 = False
    data = _data(B, T, H, case, seed)
    return [None if a is None else torch.from_numpy(a).cuda() for a in data]


@pytest.mark.cuda
@pytest.mark.parametrize("split", [False, True])
@pytest.mark.parametrize("B,T,H,case", [(64, 128, 512, "ragged"),
                                        (64, 100, 512, "ragged"),
                                        (5, 37, 128, "reset"),
                                        (1, 100, 512, "ragged"),
                                        (200, 20, 512, "ragged"),
                                        (64, 20, 528, "reset")])
def test_bwd_kernels_match_plain_on_card(monkeypatch, B, T, H, case, split):
    """Both forms against the plain version: the recurrence (then the dW
    kernel and its sum, or split_dw_db's matmul when split), each
    counted; two launches give the same bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    monkeypatch.setattr(tl, "_FORCE_SPLIT_BWD", split)
    x4, w, b, mask, reset, g_hs, g_cs = _cuda_case(B, T, H, case, 7)
    hs, cs, gates = tl.fused_lstm_fwd(x4, w, b, mask, reset, True)
    before = dict(tk.launches)
    got = tl.fused_lstm_bwd(w, b, mask, reset, gates, hs, cs, g_hs, g_cs)
    again = tl.fused_lstm_bwd(w, b, mask, reset, gates, hs, cs, g_hs, g_cs)
    torch.cuda.synchronize()
    rose = {k: tk.launches[k] - before[k] for k in before}
    S = tl.lstm_dw_splits(B * T, H)
    assert (rose["fused_lstm_bwd_nodw"], rose["fused_lstm_bwd"],
            rose["fused_lstm_bwd_dw"], rose["fused_lstm_bwd_dw_reduce"]) == (
        (2, 0, 0, 0) if split else (0, 2, 2, 2 * int(S > 1)))
    assert all(torch.equal(g, a) for g, a in zip(got, again))
    want = tl.fused_lstm_bwd_plain(w, b, mask, reset, gates, hs, cs, g_hs,
                                   g_cs)
    # float32 on both sides; the products and the dW/db sums run in
    # another order (dW in three TF32 passes)
    for g, w_ in zip(got, want):
        scale = max(1.0, float(w_.abs().max()))
        assert float((g - w_).abs().max()) <= 1e-4 * scale


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,H,case", [(64, 128, 512, "ragged"),
                                        (5, 37, 128, "reset"),
                                        (3, 37, 100, "reset")])
def test_dw_kernel_matches_plain_on_card(B, T, H, case):
    """The dW kernel's partials and their sum against their plain versions
    (the sum bit for bit), two launches bit-equal; H = 100 puts gate
    boundaries inside a 64-column tile."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    x4, w, b, mask, reset, g_hs, g_cs = _cuda_case(B, T, H, case, 5)
    hs, cs, gates = tl.fused_lstm_fwd(x4, w, b, mask, reset, True)
    dx4 = tl.fused_lstm_bwd_nodw(w, b, mask, reset, gates, hs, cs, g_hs, g_cs)
    S = tl.lstm_dw_splits(B * T, H)
    part = tl.lstm_dw_partials(dx4, hs, cs, reset, S)
    assert torch.equal(part, tl.lstm_dw_partials(dx4, hs, cs, reset, S))
    want = tl.lstm_dw_partials_plain(dx4, hs, cs, reset, S)
    scale = max(1.0, float(want.abs().max()))
    assert float((part - want).abs().max()) <= 1e-4 * scale
    assert torch.equal(tl.lstm_dw_reduce(part), tl.lstm_dw_reduce_plain(part))


@pytest.mark.cuda
def test_forward_stash_matches_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    x4, w, b, mask, reset = _cuda_case(16, 40, 256, "reset", 3)[:5]
    hs, cs, gates = tl.fused_lstm_fwd(x4, w, b, mask, reset, True)
    hp, cp, gp = tl.fused_lstm_plain(x4, w, b, mask, reset, True)
    torch.cuda.synchronize()
    for g, w_ in ((hs, hp), (cs, cp), (gates, gp)):
        torch.testing.assert_close(g, w_, rtol=1e-4, atol=1e-4)
