"""The GRU kernels' bf16 form (paddle_tpu_torch.kernels.gru) against the
JAX package's kernel on bf16 operands, and the NMT model trained under
mixed precision.

The JAX reference is ``paddle_tpu.kernels.gru.fused_gru`` in interpret
mode (its Pallas ``_fwd_kernel`` and, through its custom_vjp,
``_bwd_kernel``) on bf16 inputs: a float32 carry, each product's operands
rounded to bf16 with float32 accumulation, hs and the stash rounded on
store, db the float32 sum of the unrounded pre-activation gradients. The
port's plain versions follow that rule (``_arith``); on the card the
kernels ``gru_fwd_bf16``, ``gru_bwd_bf16`` and ``gru_bwd_dw_bf16`` do, and
the ``cuda`` tests hold them against the plain versions there.

Tolerances, in units of one bf16 ulp of the larger magnitude: at most 1
ulp apart, and at least 99.9% of the elements bit-equal, for hs, the
stash and dx3 (dx3 and the gradients against their largest value, as
stated in each test). The products of two bf16 values are exact in
float32, so only the order of the float32 sums differs. Measured on these
inputs: the stash bit-equal, hs off by one ulp at one element of 16384.
A loop that rounds every operation to bf16 (the plain version's
arithmetic before it took the kernel's rule) leaves some 60% of hs
elements off, by up to 7.8e-3.

The model tests force the JAX layer onto its kernel path on the CPU as
on a TPU: ``jax.default_backend`` reports "tpu" and ``fused_gru`` runs in
interpret mode (only ``layers/recurrent.py`` and ``layers/crf_ctc.py``
read the backend, and ``nmt_attention_cost`` has no LSTM or CRF).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pj
import paddle_tpu.kernels.gru as jax_gru
from paddle_tpu.core.layer import layer_name_scope as jax_name_scope
from paddle_tpu.models.text import nmt_attention_cost as jax_nmt_cost
from paddle_tpu.trainer.feeder import DataFeeder as JFeeder
from paddle_tpu.trainer.trainer import make_train_step as jax_train_step

import paddle_tpu_torch as pt
from paddle_tpu_torch import kernels as tk
from paddle_tpu_torch.core.arg import Arg
from paddle_tpu_torch.core.layer import layer_name_scope as torch_name_scope
from paddle_tpu_torch.core.parameters import Parameters as TParameters
from paddle_tpu_torch.kernels import gru as tg
from paddle_tpu_torch.models.text import nmt_attention_cost as torch_nmt_cost
from paddle_tpu_torch.trainer import make_train_step as torch_train_step
from paddle_tpu_torch.trainer.feeder import DataFeeder as TFeeder
from paddle_tpu_torch.utils.error import Error

BF16 = torch.bfloat16
MAX_ULPS, MIN_BIT_EQUAL = 1.0, 0.999


def _data(B, T, H, case, seed=0):
    """x3, Wg, Wc, bias, mask, reset (or None), g_hs as float32 numpy
    arrays, each exactly a bf16 value; ragged rows, one of them a single
    step; with "reset", segment starts inside the rows."""
    r = np.random.RandomState(seed)
    bf = lambda a: torch.from_numpy(a.astype(np.float32)).to(BF16) \
        .float().numpy()                                   # noqa: E731
    x3 = bf(r.randn(B, T, 3 * H) * 0.5)
    wg = bf(r.randn(H, 2 * H) / np.sqrt(H))
    wc = bf(r.randn(H, H) / np.sqrt(H))
    b = bf(r.randn(3 * H) * 0.1)
    lens = r.randint(1, T + 1, size=B)
    lens[0], lens[1] = T, 1
    mask = (np.arange(T)[None] < lens[:, None]).astype(np.float32)
    reset = None
    if case == "reset":
        reset = (r.rand(B, T) < 0.2).astype(np.float32) * mask
        reset[:, 0] = 0
    g_hs = bf(r.randn(B, T, H) * mask[..., None])
    return x3, wg, wc, b, mask, reset, g_hs


def _jb(a):
    return None if a is None else jnp.asarray(a).astype(jnp.bfloat16)


def _tb(a):
    return None if a is None else torch.from_numpy(a).to(BF16)


def _t(a):
    return None if a is None else torch.from_numpy(a)


def _np(a):
    """A bf16 (or float32) array or tensor as float32 numpy."""
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _ulps(got, want):
    """(largest distance in bf16 ulps of the larger magnitude, share of
    bit-equal elements)."""
    got, want = _np(got), _np(want)
    big = np.maximum(np.maximum(np.abs(got), np.abs(want)), 2.0 ** -126)
    ulp = 2.0 ** (np.floor(np.log2(big)) - 7)
    return float((np.abs(got - want) / ulp).max()), float(
        (got == want).mean())


def _assert_bf16_close(name, got, want, of_largest=False,
                       min_share=MIN_BIT_EQUAL):
    """At most MAX_ULPS bf16 ulps apart, of each element's magnitude or,
    ``of_largest``, of the largest |want| (2^-8 of it), and at least
    ``min_share`` of the elements bit-equal."""
    if of_largest:
        g, w = _np(got), _np(want)
        ulps = float(np.abs(g - w).max() / (np.abs(w).max() * 2.0 ** -8))
        share = float((g == w).mean())
    else:
        ulps, share = _ulps(got, want)
    assert ulps <= MAX_ULPS and share >= min_share, \
        f"{name}: {ulps:.2f} ulps apart, {share:.4%} bit-equal"


def _jax_forward(x3, wg, wc, b, mask, reset):
    """hs [B, T, H] and the stash [B, T, 3H] of the Pallas forward in
    interpret mode on bf16 operands."""
    T = x3.shape[1]
    jr = None if reset is None else jnp.asarray(reset)
    hs, gates, *_ = jax_gru._fwd_res(_jb(x3), _jb(wg), _jb(wc), _jb(b),
                                     jnp.asarray(mask), jr, True)
    return hs, jnp.swapaxes(gates, 0, 1)[:, :T]


def _all_bf16_loop(x3, wg, wc, b, mask, reset):
    """The GRU recurrence with every operation in bf16: a bf16 carry and
    bf16 products rounded to bf16 (the plain version's arithmetic before
    it took the kernel's rule)."""
    x3, wg, wc, b = (_tb(a) for a in (x3, wg, wc, b))
    B, T, H3 = x3.shape
    H = H3 // 3
    h = torch.zeros(B, H, dtype=BF16)
    hs = []
    for t in range(T):
        if reset is not None:
            h = (1 - torch.from_numpy(reset[:, t, None]).to(BF16)) * h
        x = x3[:, t]
        g = (x[:, :2 * H] + h @ wg) + b[:2 * H]
        z, r = torch.sigmoid(g[:, :H]), torch.sigmoid(g[:, H:])
        c = torch.tanh((x[:, 2 * H:] + (r * h) @ wc) + b[2 * H:])
        m = torch.from_numpy(mask[:, t, None]).to(BF16)
        h = m * (z * h + (1 - z) * c) + (1 - m) * h
        hs.append(h)
    return torch.stack(hs, 1)


@pytest.fixture(scope="module", params=["ragged", "reset"])
def case(request):
    """The inputs at (8, 16, 128) and the JAX kernel's forward and
    gradient (jax.vjp of its custom_vjp) on them, in interpret mode."""
    x3, wg, wc, b, mask, reset, g_hs = _data(8, 16, 128, request.param)
    hs, gates = _jax_forward(x3, wg, wc, b, mask, reset)
    jr = None if reset is None else jnp.asarray(reset)
    _, vjp = jax.vjp(lambda *a: jax_gru.fused_gru(*a, jnp.asarray(mask), jr,
                                                   True),
                     _jb(x3), _jb(wg), _jb(wc), _jb(b))
    grads = vjp(_jb(g_hs))
    return dict(inputs=(x3, wg, wc, b, mask, reset, g_hs), hs=hs,
                gates=gates, grads=grads)


def test_plain_bf16_forward_matches_jax_kernel(case):
    """hs and the z|r|c stash of fused_gru_plain on bf16 tensors against
    the Pallas forward: within one ulp, >= 99.9% bit-equal (measured: the
    stash bit-equal, hs 99.994%, one ulp at most), and both in bf16."""
    x3, wg, wc, b, mask, reset, _ = case["inputs"]
    hs, gates = tg.fused_gru_plain(_tb(x3), _tb(wg), _tb(wc), _tb(b),
                                   _t(mask), _t(reset), with_gates=True)
    assert hs.dtype == gates.dtype == BF16
    _assert_bf16_close("hs", hs, case["hs"])
    _assert_bf16_close("stash", gates, case["gates"])


def test_all_bf16_loop_misses_the_kernel_rule(case):
    """Rounding every operation to bf16 does not compute the TPU kernel's
    function: the bound above fails (measured: 59% to 61% of hs off, by up
    to 7.8e-3), so the test above tells the two rules apart."""
    x3, wg, wc, b, mask, reset, _ = case["inputs"]
    ulps, share = _ulps(_all_bf16_loop(x3, wg, wc, b, mask, reset),
                        case["hs"])
    assert ulps > MAX_ULPS and share < 0.9


def test_pinned_rule_holds_for_the_jax_kernel(case):
    """chip_smoke.py's limit of the bf16 rule where its operands are
    pinned, on the Pallas kernel's own results: z|r recomputed from its
    hs, and dx3 from its dx3 (the rounded operands of the dh products) and
    stash, at least 99.9% bit-equal; the float32 arithmetic on the same
    values (the plain versions on float32, rounded to bf16) below it
    (measured: 99.997%, and 99.994% to 100%; the float32 arithmetic 97.0%
    to 97.5%, and 80.6% to 83.7%)."""
    import chip_smoke as cs

    x3, wg, wc, b, mask, reset, g_hs = case["inputs"]
    hs, gates, dx3 = (torch.from_numpy(_np(a)).to(BF16) for a in
                      (case["hs"], case["gates"], case["grads"][0]))
    H = hs.shape[2]
    share = lambda a, w: (a == w).float().mean().item()  # noqa: E731
    fwd = lambda hs: cs.gru_rule_fwd_pinned(  # noqa: E731
        _tb(x3), _tb(wg), _tb(wc), _tb(b), _t(reset), hs)
    bwd = lambda dx3: cs.gru_rule_bwd_pinned(  # noqa: E731
        _tb(wg), _tb(wc), _t(mask), _t(reset), gates, hs, _tb(g_hs), dx3)
    assert share(fwd(hs), gates[..., :2 * H]) >= cs.RULE_SHARE
    assert share(bwd(dx3), dx3) >= cs.RULE_SHARE
    f32 = [_t(a) for a in (x3, wg, wc, b)]
    c_hs, c_gates = (a.to(BF16) for a in tg.fused_gru_plain(
        *f32, _t(mask), _t(reset), with_gates=True))
    c_dx3 = tg.fused_gru_bwd_plain(f32[1], f32[2], _t(mask), _t(reset),
                                   gates.float(), hs.float(),
                                   _t(g_hs))[0].to(BF16)
    assert share(fwd(c_hs), c_gates[..., :2 * H]) < cs.RULE_SHARE
    assert share(bwd(c_dx3), c_dx3) < cs.RULE_SHARE


def test_plain_bf16_backward_matches_jax_vjp(case):
    """fused_gru_bwd_plain on the bf16 stash and hs against jax.vjp of the
    Pallas kernel. dx3 (bf16): within one ulp of its largest value, >=
    99.9% bit-equal (measured: 0.022 ulps, 99.947%; an element where
    dr_pre's product sum cancels can be some ulps of its own magnitude
    off, so the ulp is the largest value's). dWg, dWc and db, the float32
    sums (db of the unrounded dpre3), against JAX's, which rounds them to
    bf16: within one ulp of the largest value (2^-8 of it), JAX's rounding
    and the order of the sums (measured: 0.77 at most)."""
    x3, wg, wc, b, mask, reset, g_hs = case["inputs"]
    hs, gates = tg.fused_gru_plain(_tb(x3), _tb(wg), _tb(wc), _tb(b),
                                   _t(mask), _t(reset), with_gates=True)
    dx3, dwg, dwc, db = tg.fused_gru_bwd_plain(
        _tb(wg), _tb(wc), _t(mask), _t(reset), gates, hs, _tb(g_hs))
    assert dx3.dtype == BF16
    assert dwg.dtype == dwc.dtype == db.dtype == torch.float32
    _assert_bf16_close("dx3", dx3, case["grads"][0], of_largest=True)
    for name, got, want in zip(("dWg", "dWc", "db"), (dwg, dwc, db),
                               case["grads"][1:]):
        w = _np(want)
        ulps = np.abs(got.numpy() - w).max() / (np.abs(w).max() * 2.0 ** -8)
        assert ulps <= MAX_ULPS, f"{name}: {ulps:.3f} ulps of the largest"


def test_function_gradient_in_the_parameters_dtype(case):
    """Autograd through the _FusedGRU Function on bf16 leaves (the CPU's
    plain forward and backward) gives JAX's bf16 gradients, in bf16: each
    within one ulp of its largest value and >= 99% bit-equal (both sides
    round float32 sums, summed in another order, to bf16; measured: 0.69
    ulps at most, 99.48% bit-equal at least)."""
    x3, wg, wc, b, mask, reset, g_hs = case["inputs"]
    leaves = [_tb(a).requires_grad_(True) for a in (x3, wg, wc, b)]
    hs = tg.fused_gru(*leaves, _t(mask), _t(reset))
    assert hs.dtype == BF16
    (hs.float() * _t(g_hs)).sum().backward()
    for name, leaf, want in zip(("dx3", "dWg", "dWc", "db"), leaves,
                                case["grads"]):
        assert leaf.grad.dtype == BF16, name
        _assert_bf16_close(name, leaf.grad, want, of_largest=True,
                           min_share=0.99)


def test_plain_dw_follows_the_bf16_rule(case):
    """gru_dw_db_plain and the split partials on bf16 tensors: dWg and dWc
    as the backward's in-loop sums (float32, no db: the recurrence sums
    it), the partials [S, 3H^2] summed in split order equal to them."""
    x3, wg, wc, b, mask, reset, g_hs = case["inputs"]
    hs, gates = tg.fused_gru_plain(_tb(x3), _tb(wg), _tb(wc), _tb(b),
                                   _t(mask), _t(reset), with_gates=True)
    dx3, dwg, dwc, _ = tg.fused_gru_bwd_plain(
        _tb(wg), _tb(wc), _t(mask), _t(reset), gates, hs, _tb(g_hs))
    gwg, gwc, gdb = tg.gru_dw_db_plain(dx3, gates, hs, _t(reset))
    assert gdb is None
    np.testing.assert_allclose(gwg.numpy(), dwg.numpy(), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(gwc.numpy(), dwc.numpy(), rtol=1e-5,
                               atol=1e-5)
    H = hs.shape[2]
    part = tg.gru_dw_partials(dx3, gates, hs, _t(reset), 3)
    assert tuple(part.shape) == (3, 3 * H * H)
    summed = tg._dw_views(tg.gru_dw_reduce(part), H)
    assert summed[2] is None
    np.testing.assert_allclose(summed[0].numpy(), gwg.numpy(), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(summed[1].numpy(), gwc.numpy(), rtol=1e-5,
                               atol=1e-5)


def test_recurrence_gives_db_by_dtype(case):
    """db comes from one place for each dtype: gru_bwd_recurrence returns
    the plain backward's dx3 and, for bf16 tensors, its db (the sum of the
    unrounded dpre3, as the bf16 kernel writes it), where gru_dw_db_plain
    gives none; for float32 it returns db None and gru_dw_db_plain sums
    db from dx3."""
    x3, wg, wc, b, mask, reset, g_hs = case["inputs"]
    for dt in (BF16, torch.float32):
        args = [torch.from_numpy(a).to(dt) for a in (x3, wg, wc, b)]
        hs, gates = tg.fused_gru_plain(*args, _t(mask), _t(reset),
                                       with_gates=True)
        bwd = (args[1], args[2], _t(mask), _t(reset), gates, hs,
               torch.from_numpy(g_hs).to(dt))
        want = tg.fused_gru_bwd_plain(*bwd)
        dx3, db = tg.gru_bwd_recurrence(*bwd)
        assert torch.equal(dx3, want[0])
        db_dw = tg.gru_dw_db_plain(dx3, gates, hs, _t(reset))[2]
        if dt == BF16:
            assert db_dw is None and torch.equal(db, want[3])
        else:
            assert db is None
            np.testing.assert_allclose(db_dw.numpy(), want[3].numpy(),
                                       rtol=1e-5, atol=1e-5)


def test_float32_plain_versions_are_unchanged():
    """On float32 tensors the plain versions compute in float32 and round
    nothing: the forward equals the cell loop written out."""
    x3, wg, wc, b, mask, reset, _ = _data(3, 5, 8, "reset", seed=4)
    got = tg.fused_gru_plain(*(_t(a) for a in (x3, wg, wc, b, mask, reset)))
    h = torch.zeros(3, 8)
    want = []
    for t in range(5):
        h = (1.0 - _t(reset)[:, t, None]) * h
        x = _t(x3)[:, t]
        g = (x[:, :16] + h @ _t(wg)) + _t(b)[:16]
        z, r = torch.sigmoid(g[:, :8]), torch.sigmoid(g[:, 8:])
        c = torch.tanh((x[:, 16:] + (r * h) @ _t(wc)) + _t(b)[16:])
        m = _t(mask)[:, t, None]
        h = m * (z * h + (1.0 - z) * c) + (1.0 - m) * h
        want.append(h)
    assert got.dtype == torch.float32
    assert torch.equal(got, torch.stack(want, 1))


# --- refusals -----------------------------------------------------------------

def _meta(*shapes, dtype=BF16):
    return [torch.zeros(s, dtype=dtype, device="meta") for s in shapes]


def test_bf16_at_a_cluster_plan_raises():
    """Since the cluster kernels have their bf16 forms, a bf16 tensor off
    the CPU whose plan is a cluster one (the tagger's H = 128) goes on to
    the cluster kernel's bf16 form, forward and backward, forced plans
    too, and raises only where that kernel cannot run: on the meta device
    here, which it does not take (the old refusal, "no bf16 form yet", is
    gone). H not a multiple of 8 has no bf16 cluster plan to force."""
    B, T, H = 4, 6, 128
    x3, wg, wc, b = _meta((B, T, 3 * H), (H, 2 * H), (H, H), (3 * H,))
    mask = torch.ones(B, T, device="meta")
    assert tg.gru_fwd_plan(B, H, BF16).path == "cluster"
    assert tg.gru_bwd_plan(B, H, BF16).path == "cluster"
    for path, C, R in ((0, 0, 0), (tg._CLUSTER, 8, 4)):
        with pytest.raises(Error, match="no kernel for device meta"):
            tg._gru_fwd_cuda(x3, wg, wc, b, mask, None, True, path, C, R)
    gates, hs, g_hs = _meta((B, T, 3 * H), (B, T, H), (B, T, H))
    with pytest.raises(Error, match="no kernel for device meta"):
        tg.fused_gru_bwd_dx3(wg, wc, mask, None, gates, hs, g_hs)
    with pytest.raises(Error, match="no kernel for device meta"):
        tg.fused_gru_bwd(wg, wc, mask, None, gates, hs, g_hs)
    with pytest.raises(Error, match="bf16 form: H a multiple of 8"):
        tg.cluster_plan(100, 5, 4, BF16)
    with pytest.raises(Error, match="bf16 form: H a multiple of 8"):
        tg.bwd_cluster_plan(100, 5, 4, BF16)


def test_bf16_cluster_plans():
    """gru_fwd_plan and gru_bwd_plan take a dtype: at the tagger's (32,
    128) bf16 takes C = 8 blocks and R = 4 rows a cluster, as float32
    does, in the bf16 forms' own (smaller) shared memory, and the plans
    name the bf16 cluster instances; bf16 takes a cluster plan only where
    the float32 form's fits too (H = 512 takes the grid kernels), and
    every float32 plan is unchanged."""
    fwd, bwd = tg.gru_fwd_plan(32, 128, BF16), tg.gru_bwd_plan(32, 128, BF16)
    assert fwd == tg.cluster_plan(128, 8, 4, BF16)
    assert bwd == tg.bwd_cluster_plan(128, 8, 4, BF16)
    assert fwd.smem < tg.gru_fwd_plan(32, 128).smem
    assert bwd.smem < tg.gru_bwd_plan(32, 128).smem
    assert tg.fwd_kernel(fwd, BF16) == "fused_gru_cluster_bf16"
    assert tg.bwd_kernel(bwd, BF16) == "fused_gru_bwd_cluster_bf16"
    assert tg.fwd_kernel(fwd) == "fused_gru_cluster"
    assert tg.fwd_kernel(tg.grid_plan(512), BF16) == "fused_gru_bf16"
    assert tg.bwd_kernel(tg.bwd_grid_plan(64, 512), BF16) == \
        "fused_gru_bwd_bf16"
    assert set(tk.launches) >= {"fused_gru_cluster_bf16",
                                "fused_gru_bwd_cluster_bf16"}
    assert tg.gru_fwd_plan(32, 512) == tg.grid_plan(512)
    assert tg._cluster_smem_bytes(128, 8, 16, BF16) < \
        tg._cluster_smem_bytes(128, 8, 16)
    assert tg.gru_fwd_plan(32, 512, BF16).path == "grid"
    assert tg.gru_fwd_plan(8, 512, BF16).path == "grid"
    assert tg.gru_bwd_plan(32, 512, BF16) == \
        tg.bwd_grid_plan(32, 512, BF16)
    for B in (1, 7, 32, 33, 64, 100, 256):
        for H in (8, 64, 100, 128, 200, 256, 512, 516):
            for plan in (tg.gru_fwd_plan(B, H, BF16),
                         tg.gru_bwd_plan(B, H, BF16)):
                assert plan.smem <= tg._SMEM_PER_BLOCK
                assert plan.path == "grid" or H % 8 == 0
            assert (tg.gru_fwd_plan(B, H, BF16).path == "cluster") == (
                tg.gru_fwd_plan(B, H).path == "cluster" and H % 8 == 0)


@pytest.mark.parametrize("dtypes", [
    (torch.float16,) * 4, (torch.float64,) * 4,
    (BF16, torch.float32, BF16, BF16), (torch.float32, BF16, BF16, BF16)])
def test_other_dtypes_raise_off_the_cpu(dtypes):
    """float16, float64 and mixed dtypes off the CPU raise before any
    kernel, naming the dtypes; nothing is widened or narrowed around a
    kernel."""
    B, T, H = 2, 3, 512
    shapes = ((B, T, 3 * H), (H, 2 * H), (H, H), (3 * H,))
    x3, wg, wc, b = (torch.zeros(s, dtype=d, device="meta")
                     for s, d in zip(shapes, dtypes))
    mask = torch.ones(B, T, device="meta")
    with pytest.raises(Error, match="float32 tensors, or bfloat16"):
        tg._gru_fwd_cuda(x3, wg, wc, b, mask, None, True, 0, 0, 0)
    gates, hs, g_hs = (torch.zeros(s, dtype=dtypes[0], device="meta")
                       for s in ((B, T, 3 * H), (B, T, H), (B, T, H)))
    with pytest.raises(Error, match="dtype"):
        tg.fused_gru_bwd_dx3(wg, wc, mask, None, gates, hs, g_hs)


def test_bf16_support_predicates():
    """The bf16 forms take H a multiple of 8; the backward's shared memory
    is its own (bf16 tiles, db's per-row sums), so a large batch it no
    longer fits is refused and the layer keeps the generic loop there."""
    assert tg.fused_gru_supported(256, 512, BF16)
    assert tg.fused_gru_bwd_supported(256, 512, BF16)
    assert tg.fused_gru_supported(4, 516) and \
        not tg.fused_gru_supported(4, 516, BF16)
    assert tg.fused_gru_bwd_supported(4, 516) and \
        not tg.fused_gru_bwd_supported(4, 516, BF16)
    smem = tg._bwd_smem_bytes(256, 512, BF16)
    assert smem < tg._bwd_smem_bytes(256, 512)
    assert tg._bwd_smem_bytes(4000, 512, BF16) > \
        tg._bwd_smem_bytes(4000, 512)
    assert tg.fused_gru_bwd_supported(4000, 512) and \
        not tg.fused_gru_bwd_supported(4000, 512, BF16)


# --- the NMT model under mixed precision ----------------------------------------

SRC, TRG = 40, 30
# encoder_size 128 and B = 8: the JAX kernel takes H % 128 == 0, B % 8 == 0
WIDTHS = dict(word_vector_dim=16, encoder_size=128, decoder_size=32)
FEEDING = {"src": 0, "trg": 1, "trg_next": 2}
B_NMT, ROUNDING = 8, 8


@pytest.fixture(scope="module")
def nmt():
    """Both packages' nmt_attention_cost, the JAX package's initial
    parameters, one seq_pairs batch fed by each feeder, and the JAX loss's
    value and gradient under loss_fn(compute_dtype=bf16) through its
    kernel path, plus its encoder outputs through the kernel and the
    scan."""
    with jax_name_scope():
        jcost = jax_nmt_cost(SRC, TRG, **WIDTHS)
    with torch_name_scope():
        tcost = torch_nmt_cost(SRC, TRG, **WIDTHS)
    jtopo, ttopo = pj.Topology(jcost), pt.Topology(tcost)
    init = {k: np.array(v) for k, v in
            jtopo.init_params(jax.random.PRNGKey(3)).items()}
    batches = [list(pt.dataset.synthetic.seq_pairs(
        SRC, TRG, B_NMT, max_len=ROUNDING, seed=s)()) for s in (5, 6)]
    jfeeds = [JFeeder(jtopo.data_type(), FEEDING,
                      bucket_rounding=ROUNDING)(b) for b in batches]
    tfeeds = [{k: a.to("cpu") for k, a in
               TFeeder(ttopo.data_type(), FEEDING,
                       bucket_rounding=ROUNDING)(b).items()}
              for b in batches]
    out = dict(jcost=jcost, tcost=tcost, jtopo=jtopo, ttopo=ttopo,
               init=init, batches=batches, jfeeds=jfeeds, tfeeds=tfeeds)
    jp = {k: jnp.asarray(v) for k, v in init.items()}
    bf_params = {k: v.astype(jnp.bfloat16) for k, v in jp.items()}

    def encoder():
        outs = jtopo.forward(bf_params, jfeeds[0], training=True,
                             rng=jax.random.PRNGKey(0))
        return [np.asarray(outs[n].value.astype(jnp.float32))
                for n in ("m_enc_fwd", "m_enc_bwd")]

    out["scan_encoder"] = encoder()
    with _jax_kernel_path():
        out["kernel_encoder"] = encoder()
        loss = jtopo.loss_fn(compute_dtype=jnp.bfloat16)
        (cost, _), grads = jax.value_and_grad(
            lambda p: loss(p, jfeeds[0], jax.random.PRNGKey(0)),
            has_aux=True)(jp)
        out["jax_cost"] = float(cost)
        out["jax_grads"] = {k: np.asarray(v) for k, v in grads.items()}
        opt = pj.optimizer.Adam(learning_rate=5e-3)
        step = jax_train_step(loss, opt, jtopo.static_map(), donate=False)
        params, state = jp, opt.init(jp)
        costs = []
        for feeds in jfeeds:
            params, state, c, _ = step(params, state,
                                       jax.random.PRNGKey(0), feeds)
            costs.append(float(c))
        out["jax_costs"] = costs
    return out


class _jax_kernel_path:
    """The JAX layer's kernel path on the CPU: jax.default_backend reports
    "tpu" and fused_gru runs in interpret mode."""

    def __enter__(self):
        self.backend, self.fused = jax.default_backend, jax_gru.fused_gru
        fused = self.fused
        jax.default_backend = lambda: "tpu"
        jax_gru.fused_gru = lambda x3, wg, wc, b, m, r=None, i=False: fused(
            x3, wg, wc, b, m, r, True)

    def __exit__(self, *exc):
        jax.default_backend, jax_gru.fused_gru = self.backend, self.fused


def test_nmt_encoder_takes_the_kernel_rule_under_bf16(nmt):
    """The encoder's two GRUs of nmt_attention_cost on bf16 parameters and
    feeds: the port (fused_gru's plain version) against the JAX layer's
    kernel path within one ulp, >= 99.9% bit-equal (measured: all
    bit-equal); the JAX layer's scan (its CPU path) misses that bound
    (measured: some 45% of the elements off, by up to 410 ulps), so the
    test tells the kernel's rule from the scan's at the model."""
    params = {k: torch.from_numpy(v).to(BF16) for k, v in nmt["init"].items()}
    feeds = {k: (Arg(a.value.to(BF16), a.mask, a.seg_ids)
                 if a.value.is_floating_point() else a)
             for k, a in nmt["tfeeds"][0].items()}
    outs = nmt["ttopo"].forward(params, feeds, training=True)
    for i, name in enumerate(("m_enc_fwd", "m_enc_bwd")):
        got = outs[name].value
        assert got.dtype == BF16
        _assert_bf16_close(name, got, nmt["kernel_encoder"][i])
        ulps, share = _ulps(nmt["scan_encoder"][i], nmt["kernel_encoder"][i])
        assert ulps > MAX_ULPS and share < MIN_BIT_EQUAL, name


def test_nmt_bf16_loss_gradients_and_adam_step_match_jax(nmt):
    """loss_fn(compute_dtype=bf16) of the port (CPU: the GRU's plain bf16
    versions through the _FusedGRU Function) against the JAX package's
    through its kernel path: the cost within 1e-3 relative (measured
    3.3e-6), each parameter's gradient within 2e-2 of its largest
    (measured 1.6e-2), and two Adam steps' costs within 1e-3 relative
    (measured 3.4e-6 and 1.8e-5).

    The gradients cannot be held tighter, and so cannot tell the kernel's
    rule from the scan's (1.5e-2 apart) at the model: the other layers
    round bf16 at other places in the two packages (XLA fuses chains of
    elementwise operations in float32), which moves the gradients as much.
    The encoder test above and the kernel-level tests tell the rules apart.
    Adam's first update, lr * g / (|g| + eps), carries only the gradient's
    signs, so the costs after it are checked instead of the parameters."""
    topo = nmt["ttopo"]
    loss = topo.loss_fn(compute_dtype=BF16)
    leaves = {k: torch.from_numpy(v).requires_grad_(True)
              for k, v in nmt["init"].items()}
    cost, _ = loss(leaves, nmt["tfeeds"][0])
    cost.backward()
    assert abs(float(cost.detach()) - nmt["jax_cost"]) <= \
        1e-3 * abs(nmt["jax_cost"])
    for k, want in nmt["jax_grads"].items():
        got = leaves[k].grad
        assert got.dtype == torch.float32, k
        assert np.abs(got.numpy() - want).max() <= \
            2e-2 * np.abs(want).max(), k
    opt = pt.optimizer.Adam(learning_rate=5e-3)
    step = torch_train_step(loss, opt, topo.static_map(), topo.lr_mults())
    params = {k: torch.from_numpy(v) for k, v in nmt["init"].items()}
    state = opt.init(params)
    costs = []
    for feeds in nmt["tfeeds"]:
        params, state, c, _ = step(params, state, feeds)
        costs.append(float(c))
    np.testing.assert_allclose(costs, nmt["jax_costs"], rtol=1e-3)


def test_mixed_precision_sgd_trains_nmt_on_the_cpu(nmt):
    """SGD(mixed_precision=True).train(device="cpu") on the NMT model:
    finite costs, float32 masters, and the encoder's two GRUs through the
    _FusedGRU Function (its backward is the bf16 kernels' on a card)."""
    trainer = pt.SGD(nmt["tcost"], TParameters.from_numpy(nmt["init"]),
                     pt.optimizer.Adam(learning_rate=5e-3),
                     mixed_precision=True, device="cpu")
    costs = []
    trainer.train(lambda: iter(nmt["batches"]), num_passes=1,
                  feeding=FEEDING, bucket_rounding=ROUNDING,
                  event_handler=lambda e: costs.append(e.cost) if isinstance(
                      e, pt.event.EndIteration) else None)
    assert len(costs) == 2 and np.isfinite(costs).all()
    for k in nmt["init"]:
        assert trainer.parameters.get(k).dtype == torch.float32, k
    params = {k: torch.from_numpy(v).requires_grad_(True)
              for k, v in nmt["init"].items()}
    cost, _ = nmt["ttopo"].loss_fn(compute_dtype=BF16)(params,
                                                       nmt["tfeeds"][0])
    seen, stack, names = set(), [cost.grad_fn], []
    while stack:
        f = stack.pop()
        if f is None or f in seen:
            continue
        seen.add(f)
        names.append(type(f).__name__)
        stack.extend(n for n, _ in f.next_functions)
    assert names.count("_FusedGRUBackward") == 2


# --- on the card ----------------------------------------------------------------

def _cuda_case(B, T, H, case, seed):
    x3, wg, wc, b, mask, reset, g_hs = _data(B, T, H, case, seed)
    dev = lambda a: None if a is None else _tb(a).cuda()   # noqa: E731
    return ([dev(a) for a in (x3, wg, wc, b)], _t(mask).cuda(),
            None if reset is None else _t(reset).cuda(), dev(g_hs))


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,H,case", [(64, 100, 512, "reset"),
                                        (256, 30, 512, "ragged")])
def test_bf16_kernels_match_plain_on_card(B, T, H, case):
    """gru_fwd_bf16, gru_bwd_bf16 and gru_bwd_dw_bf16 against the plain
    versions on the card (their float32 products with TF32 off): hs, the
    stash and dx3 within one bf16 ulp of the largest value (2^-8 to 2^-7
    of it); of their largest, in float32, dWg and dWc within 1e-5 on the
    kernel's dx3 and 2e-3 against the plain loop's own, db within 4e-4
    (chip_smoke.py's limits: sound runs read 4.7e-7, 6.5e-4 and 1.5e-4 at
    most, db summed from the bf16 dx3 and dWc from an unrounded r*h_prev
    about 1e-3); one launch of each bf16 kernel and none of a float32
    one."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    (x3, wg, wc, b), mask, reset, g_hs = _cuda_case(B, T, H, case, 1)
    before = dict(tk.launches)
    hs, gates = tg.fused_gru_fwd(x3, wg, wc, b, mask, reset, stash=True)
    got = tg.fused_gru_bwd(wg, wc, mask, reset, gates, hs, g_hs)
    rose = {k: tk.launches[k] - before[k] for k in before}
    assert rose["fused_gru_bf16"] == rose["fused_gru_bwd_bf16"] == \
        rose["fused_gru_bwd_dw_bf16"] == 1
    assert rose["fused_gru"] == rose["fused_gru_bwd"] == \
        rose["fused_gru_bwd_dw"] == 0
    want_hs, want_gates = tg.fused_gru_plain(x3, wg, wc, b, mask, reset,
                                             with_gates=True)
    want = tg.fused_gru_bwd_plain(wg, wc, mask, reset, gates, hs, g_hs)
    for g, w in ((hs, want_hs), (gates, want_gates), (got[0], want[0])):
        big = w.float().abs().max().item()
        assert (g.float() - w.float()).abs().max().item() <= \
            2.0 ** (np.floor(np.log2(big)) - 7)
    rel = lambda g, w: ((g - w).abs().max() / w.abs().max()).item()  # noqa
    assert all(g.dtype == torch.float32 for g in got[1:])
    on_dx3 = tg.gru_dw_db_plain(got[0], gates, hs, reset)
    assert max(rel(got[1], on_dx3[0]), rel(got[2], on_dx3[1])) <= 1e-5
    assert max(rel(got[1], want[1]), rel(got[2], want[2])) <= 2e-3
    assert rel(got[3], want[3]) <= 4e-4


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["ragged", "reset"])
def test_bf16_cluster_kernels_match_plain_on_card(case):
    """At the tagger's (32, 512, 128) the bf16 plans are cluster ones:
    gru_fwd_cluster_bf16 and gru_bwd_cluster_bf16 against the plain
    versions on the same bf16 inputs (TF32 off): hs, the stash and dx3
    within one bf16 ulp of the largest; db (the recurrence's sum of the
    unrounded dpre3, its clusters' partials summed in order) within 4e-4
    of the plain loop's (chip_smoke.py's limits); the rule where its
    operands are pinned (z|r from the kernel's hs, dx3 from its dx3) at
    least 99.9% bit-equal; one launch of each cluster bf16 kernel, of the
    dW kernel's bf16 form and none of the grid ones."""
    import chip_smoke as cs

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    (x3, wg, wc, b), mask, reset, g_hs = _cuda_case(32, 512, 128, case, 2)
    before = dict(tk.launches)
    hs, gates = tg.fused_gru_fwd(x3, wg, wc, b, mask, reset, stash=True)
    got = tg.fused_gru_bwd(wg, wc, mask, reset, gates, hs, g_hs)
    rose = {k: tk.launches[k] - before[k] for k in before}
    assert rose["fused_gru_cluster_bf16"] == \
        rose["fused_gru_bwd_cluster_bf16"] == \
        rose["fused_gru_bwd_dw_bf16"] == 1
    assert rose["fused_gru_bf16"] == rose["fused_gru_bwd_bf16"] == 0
    want_hs, want_gates = tg.fused_gru_plain(x3, wg, wc, b, mask, reset,
                                             with_gates=True)
    want = tg.fused_gru_bwd_plain(wg, wc, mask, reset, gates, hs, g_hs)
    for g, w in ((hs, want_hs), (gates, want_gates), (got[0], want[0])):
        big = w.float().abs().max().item()
        assert (g.float() - w.float()).abs().max().item() <= \
            2.0 ** (np.floor(np.log2(big)) - 7)
    rel = lambda g, w: ((g - w).abs().max() / w.abs().max()).item()  # noqa
    assert rel(got[3], want[3]) <= 4e-4
    share = lambda a, w: (a == w).float().mean().item()  # noqa: E731
    assert share(cs.gru_rule_fwd_pinned(x3, wg, wc, b, reset, hs),
                 gates[..., :256]) >= cs.RULE_SHARE
    assert share(cs.gru_rule_bwd_pinned(wg, wc, mask, reset, gates, hs, g_hs,
                                        got[0]), got[0]) >= cs.RULE_SHARE
