"""The LSTM kernels' bf16 form (paddle_tpu_torch.kernels.lstm) against the
JAX package's kernel on bf16 operands, and the LSTM classifier trained
under mixed precision.

The JAX reference is ``paddle_tpu.kernels.lstm.fused_lstm`` in interpret
mode (its Pallas ``_fwd_kernel`` and, through its custom_vjp,
``_bwd_kernel`` or, with its ``_FORCE_SPLIT_BWD`` set, ``_bwd_kernel_nodw``
and the dW/db formed outside) on bf16 inputs: float32 h and c carries,
each product's operands rounded to bf16 with float32 accumulation, hs, cs
and the stash rounded on store; in the default form db is the float32 sum
of the unrounded dpre, in the split form of the rounded dx4. The port's
plain versions follow that rule (``_arith``), each backward form its own;
on the card the kernels ``lstm_fwd_bf16``, ``lstm_bwd_bf16`` and
``lstm_bwd_dw_bf16`` do, and the ``cuda`` tests hold them against the
plain versions there.

Tolerances, in units of one bf16 ulp: at most 1 ulp of each element's
magnitude (the forward) or of the largest value (the gradients), and at
least 99.9% of the elements bit-equal where both sides round to bf16. The
products of two bf16 values are exact in float32, so only the order of
the float32 sums differs. Measured on these inputs: hs and cs bit-equal,
the stash off by one ulp at one element of 24576, dx4 within 0.53 ulps of
its largest, dW and db within 0.89. A loop that rounds every operation to
bf16 misses those bounds (some 40% of hs off).

The model tests force the JAX layer onto its kernel path on the CPU as
on a TPU: ``jax.default_backend`` reports "tpu" and ``fused_lstm`` runs in
interpret mode (only ``layers/recurrent.py`` and ``layers/crf_ctc.py``
read the backend, and the classifier has no GRU or CRF).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pj
import paddle_tpu.kernels.lstm as jax_lstm
from paddle_tpu.core.layer import layer_name_scope as jax_name_scope
from paddle_tpu.models.text import lstm_text_classification as jax_lstm_cls
from paddle_tpu.trainer.feeder import DataFeeder as JFeeder
from paddle_tpu.trainer.trainer import make_train_step as jax_train_step

import paddle_tpu_torch as pt
from paddle_tpu_torch import kernels as tk
from paddle_tpu_torch.core.layer import layer_name_scope as torch_name_scope
from paddle_tpu_torch.core.parameters import Parameters as TParameters
from paddle_tpu_torch.kernels import lstm as tl
from paddle_tpu_torch.models.text import \
    lstm_text_classification as torch_lstm_cls
from paddle_tpu_torch.trainer import make_train_step as torch_train_step
from paddle_tpu_torch.trainer.feeder import DataFeeder as TFeeder
from paddle_tpu_torch.utils.error import Error

BF16 = torch.bfloat16
MAX_ULPS, MIN_BIT_EQUAL = 1.0, 0.999
FORMS = ("in-kernel", "split")


def _data(B, T, H, case, seed=0):
    """x4, W, bias, mask, reset (or None), g_hs, g_cs as float32 numpy
    arrays, each exactly a bf16 value; ragged rows, one of them a single
    step; with "reset", segment starts inside the rows."""
    r = np.random.RandomState(seed)
    bf = lambda a: torch.from_numpy(a.astype(np.float32)).to(BF16) \
        .float().numpy()                                   # noqa: E731
    x4 = bf(r.randn(B, T, 4 * H) * 0.5)
    w = bf(r.randn(H, 4 * H) / np.sqrt(H))
    b = bf(r.randn(7 * H) * 0.1)
    lens = r.randint(1, T + 1, size=B)
    lens[0], lens[1] = T, 1
    mask = (np.arange(T)[None] < lens[:, None]).astype(np.float32)
    reset = None
    if case == "reset":
        reset = (r.rand(B, T) < 0.2).astype(np.float32) * mask
        reset[:, 0] = 0
    g_hs = bf(r.randn(B, T, H) * mask[..., None])
    g_cs = bf(r.randn(B, T, H) * mask[..., None] * 0.5)
    return x4, w, b, mask, reset, g_hs, g_cs


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


def _of_largest(got, want):
    """The largest distance in bf16 ulps of the largest |want| (2^-8 of
    it)."""
    g, w = _np(got), _np(want)
    return float(np.abs(g - w).max() / (np.abs(w).max() * 2.0 ** -8))


def _assert_bf16_close(name, got, want, of_largest=False,
                       min_share=MIN_BIT_EQUAL):
    """At most MAX_ULPS bf16 ulps apart, of each element's magnitude or,
    ``of_largest``, of the largest |want|, and at least ``min_share`` of
    the elements bit-equal."""
    ulps, share = _ulps(got, want)
    if of_largest:
        ulps = _of_largest(got, want)
    assert ulps <= MAX_ULPS and share >= min_share, \
        f"{name}: {ulps:.2f} ulps apart, {share:.4%} bit-equal"


class _split_form:
    """Both packages' split backward forced (each module's
    ``_FORCE_SPLIT_BWD``), for the length of a with-block; with ``on``
    False the default form."""

    def __init__(self, on):
        self.on = on

    def __enter__(self):
        self.saved = jax_lstm._FORCE_SPLIT_BWD, tl._FORCE_SPLIT_BWD
        jax_lstm._FORCE_SPLIT_BWD = tl._FORCE_SPLIT_BWD = self.on

    def __exit__(self, *exc):
        jax_lstm._FORCE_SPLIT_BWD, tl._FORCE_SPLIT_BWD = self.saved


def _jax_grads(inputs, split):
    """dx4, dW and db (bf16) of jax.vjp of the Pallas kernel in interpret
    mode, in the default form or the split one."""
    x4, w, b, mask, reset, g_hs, g_cs = inputs
    jr = None if reset is None else jnp.asarray(reset)
    with _split_form(split):
        _, vjp = jax.vjp(lambda *a: jax_lstm.fused_lstm(
            *a, jnp.asarray(mask), jr, True), _jb(x4), _jb(w), _jb(b))
        return vjp((_jb(g_hs), _jb(g_cs)))


@pytest.fixture(scope="module", params=["ragged", "reset"])
def case(request):
    """The inputs at (8, 12, 128), the JAX kernel's forward (hs, cs and
    the stash) and its gradients in both backward forms, in interpret
    mode."""
    inputs = _data(8, 12, 128, request.param)
    x4, w, b, mask, reset, _, _ = inputs
    T = x4.shape[1]
    jr = None if reset is None else jnp.asarray(reset)
    hs, cs, gates, *_ = jax_lstm._fwd_res(_jb(x4), _jb(w), _jb(b),
                                          jnp.asarray(mask), jr, True)
    return dict(inputs=inputs, hs=hs, cs=cs,
                gates=jnp.swapaxes(gates, 0, 1)[:, :T],
                grads={form: _jax_grads(inputs, form == "split")
                       for form in FORMS})


def _port_forward(inputs):
    x4, w, b, mask, reset, _, _ = inputs
    return tl.fused_lstm_plain(_tb(x4), _tb(w), _tb(b), _t(mask), _t(reset),
                               with_gates=True)


def _port_backward(inputs, split):
    """(dx4, dW, db) of fused_lstm_bwd on the CPU (the plain versions) in
    the default form or the split one, on the plain forward's stash."""
    x4, w, b, mask, reset, g_hs, g_cs = inputs
    hs, cs, gates = _port_forward(inputs)
    with _split_form(split):
        return tl.fused_lstm_bwd(_tb(w), _tb(b), _t(mask), _t(reset), gates,
                                 hs, cs, _tb(g_hs), _tb(g_cs))


def _all_bf16_loop(x4, w, b, mask, reset):
    """The LSTM recurrence with every operation in bf16: bf16 carries and
    bf16 products rounded to bf16."""
    x4, w, b = (_tb(a) for a in (x4, w, b))
    B, T, H4 = x4.shape
    H = H4 // 4
    h = torch.zeros(B, H, dtype=BF16)
    c = torch.zeros(B, H, dtype=BF16)
    hs = []
    for t in range(T):
        if reset is not None:
            p = 1 - torch.from_numpy(reset[:, t, None]).to(BF16)
            h, c = p * h, p * c
        pre = (x4[:, t] + h @ w) + b[:4 * H]
        i = torch.sigmoid(pre[:, :H] + b[4 * H:5 * H] * c)
        f = torch.sigmoid(pre[:, H:2 * H] + b[5 * H:6 * H] * c)
        c_new = f * c + i * torch.tanh(pre[:, 2 * H:3 * H])
        o = torch.sigmoid(pre[:, 3 * H:] + b[6 * H:] * c_new)
        m = torch.from_numpy(mask[:, t, None]).to(BF16)
        h = m * (o * torch.tanh(c_new)) + (1 - m) * h
        c = m * c_new + (1 - m) * c
        hs.append(h)
    return torch.stack(hs, 1)


def test_plain_bf16_forward_matches_jax_kernel(case):
    """hs, cs and the stash of fused_lstm_plain on bf16 tensors against
    the Pallas forward: within one ulp, >= 99.9% bit-equal (measured: hs
    and cs bit-equal, the stash one ulp off at one element), all bf16."""
    hs, cs, gates = _port_forward(case["inputs"])
    assert hs.dtype == cs.dtype == gates.dtype == BF16
    _assert_bf16_close("hs", hs, case["hs"])
    _assert_bf16_close("cs", cs, case["cs"])
    _assert_bf16_close("stash", gates, case["gates"])


def test_all_bf16_loop_misses_the_kernel_rule(case):
    """Rounding every operation to bf16 does not compute the TPU kernel's
    function: the bound above fails, so the test above tells the two
    rules apart."""
    x4, w, b, mask, reset, _, _ = case["inputs"]
    ulps, share = _ulps(_all_bf16_loop(x4, w, b, mask, reset), case["hs"])
    assert ulps > MAX_ULPS and share < 0.9


@pytest.mark.parametrize("form", FORMS)
def test_plain_bf16_backward_matches_jax_vjp(case, form):
    """fused_lstm_bwd on the CPU (the plain versions) against jax.vjp of
    the Pallas kernel, form against form (both packages' split forced
    together). dx4 (bf16): within one ulp of its largest value, >= 99.9%
    bit-equal (measured: 0.53 ulps, 99.45% of the elements in the ragged
    case, so the share is the dx4 of the reset case's: 99.998%). dW and db,
    the float32 sums, against JAX's, which rounds them to bf16: within one
    ulp of the largest value, JAX's rounding and the order of the sums
    (measured: 0.89 at most)."""
    dx4, dw, db = _port_backward(case["inputs"], form == "split")
    want = case["grads"][form]
    assert dx4.dtype == BF16 and dw.dtype == db.dtype == torch.float32
    assert _of_largest(dx4, want[0]) <= MAX_ULPS
    for name, got, w in (("dW", dw, want[1]), ("db", db, want[2])):
        ulps = _of_largest(got, w)
        assert ulps <= MAX_ULPS, f"{name}: {ulps:.3f} ulps of the largest"


def test_backward_forms_differ_in_db_only(case):
    """On bf16 the two backward forms give the same dx4, the same dW (to
    the order of its float32 sums) and different db, in both packages: the default form sums the unrounded
    dpre, the split form the rounded dx4. The port's two db differ by
    some 1e-3 of the largest (measured 1.1e-3 and 1.6e-3); JAX's, rounded
    to bf16, in over a quarter of the elements (measured 38% and 39%).
    The tests above compare each form with its own."""
    ins, spl = (_port_backward(case["inputs"], s) for s in (False, True))
    assert torch.equal(ins[0], spl[0])
    # dW: the same bf16 products, summed per step or in one matmul
    np.testing.assert_allclose(ins[1].numpy(), spl[1].numpy(), rtol=1e-5,
                               atol=1e-6)
    gap = float((ins[2] - spl[2]).abs().max() / ins[2].abs().max())
    assert gap > 1e-4, gap
    jin, jspl = (_np(case["grads"][f][2]) for f in FORMS)
    assert (jin != jspl).mean() > 0.25
    # float32 has one db: on the CPU both forms run the plain backward
    x4, w, b, mask, reset, g_hs, g_cs = (
        None if a is None else a.astype(np.float32)
        for a in case["inputs"])
    hs, cs, gates = tl.fused_lstm_plain(*(_t(a) for a in (x4, w, b, mask,
                                                           reset)),
                                        with_gates=True)
    f32 = []
    for split in (False, True):
        with _split_form(split):
            f32.append(tl.fused_lstm_bwd(_t(w), _t(b), _t(mask), _t(reset),
                                         gates, hs, cs, _t(g_hs), _t(g_cs)))
    assert all(torch.equal(a, b) for a, b in zip(*f32))


def test_function_gradient_in_the_parameters_dtype(case):
    """Autograd through the _FusedLSTM Function on bf16 leaves (the CPU's
    plain forward and backward) gives JAX's bf16 gradients, in bf16: each
    within one ulp of its largest value and >= 95% bit-equal (both sides
    round float32 sums, summed in another order, to bf16, and dW's sums of
    96 products a step cross rounding boundaries; measured: 0.90 ulps at
    most, 97.2% of dW bit-equal at least)."""
    x4, w, b, mask, reset, g_hs, g_cs = case["inputs"]
    leaves = [_tb(a).requires_grad_(True) for a in (x4, w, b)]
    hs, cs = tl.fused_lstm(*leaves, _t(mask), _t(reset))
    assert hs.dtype == cs.dtype == BF16
    ((hs.float() * _t(g_hs)).sum() + (cs.float() * _t(g_cs)).sum()) \
        .backward()
    for name, leaf, want in zip(("dx4", "dW", "db"), leaves,
                                case["grads"]["in-kernel"]):
        assert leaf.grad.dtype == BF16, name
        _assert_bf16_close(name, leaf.grad, want, of_largest=True,
                           min_share=0.95)


def test_plain_dw_follows_the_bf16_rule(case):
    """On bf16 tensors the dW function's plain versions are float32 sums
    of the values as stored: split_dw_db's dW equals the backward loop's
    in-loop sum; the partials are [S, 4H^2] (no db: the bf16 recurrence
    sums it) and, summed in split order, equal it; fused_lstm_bwd_dw gives
    db None. On float32 the partials keep their [S, 4H^2 + 7H] layout."""
    x4, w, b, mask, reset, g_hs, g_cs = case["inputs"]
    hs, cs, gates = _port_forward(case["inputs"])
    dx4, dw, _ = tl.fused_lstm_bwd_plain(_tb(w), _tb(b), _t(mask),
                                         _t(reset), gates, hs, cs, _tb(g_hs),
                                         _tb(g_cs))
    sdw, sdb = tl.split_dw_db(dx4, hs, cs, _t(reset))
    assert sdw.dtype == sdb.dtype == torch.float32
    np.testing.assert_allclose(sdw.numpy(), dw.numpy(), rtol=1e-5,
                               atol=1e-5)
    H = hs.shape[2]
    part = tl.lstm_dw_partials(dx4, hs, cs, _t(reset), 3)
    assert tuple(part.shape) == (3, 4 * H * H)
    summed, none = tl._dw_views(tl.lstm_dw_reduce(part), H)
    assert none is None
    np.testing.assert_allclose(summed.numpy(), sdw.numpy(), rtol=1e-5,
                               atol=1e-5)
    assert tl.fused_lstm_bwd_dw(dx4, hs, cs, _t(reset))[1] is None
    f32 = [a.float() for a in (dx4, hs, cs)]
    assert tuple(tl.lstm_dw_partials(*f32, _t(reset), 3).shape) == \
        (3, 4 * H * H + 7 * H)


def test_recurrence_gives_db_by_dtype(case):
    """db comes from one place for each dtype and form:
    lstm_bwd_recurrence returns the plain backward's dx4 and, for bf16
    tensors in the default form, its db (the sum of the unrounded dpre, as
    the bf16 kernel writes it); in the split form, and for float32, db
    None (the split form's from split_dw_db, float32's from the dW
    kernel)."""
    x4, w, b, mask, reset, g_hs, g_cs = case["inputs"]
    for dt in (BF16, torch.float32):
        args = [torch.from_numpy(a).to(dt) for a in (x4, w, b)]
        hs, cs, gates = tl.fused_lstm_plain(*args, _t(mask), _t(reset),
                                            with_gates=True)
        bwd = (args[1], args[2], _t(mask), _t(reset), gates, hs, cs,
               torch.from_numpy(g_hs).to(dt), torch.from_numpy(g_cs).to(dt))
        want = tl.fused_lstm_bwd_plain(*bwd)
        dx4, db = tl.lstm_bwd_recurrence(*bwd)
        assert torch.equal(dx4, want[0])
        assert torch.equal(tl.fused_lstm_bwd_nodw(*bwd), want[0])
        assert tl.lstm_bwd_recurrence(*bwd, with_db=False)[1] is None
        if dt == BF16:
            assert torch.equal(db, want[2])
        else:
            assert db is None


def test_float32_plain_versions_are_unchanged():
    """On float32 tensors the plain versions compute in float32 and round
    nothing: the forward equals the cell loop written out, bit for bit,
    and the backward keeps float32 dx4."""
    x4, w, b, mask, reset, g_hs, _ = _data(3, 5, 8, "reset", seed=4)
    x4, w, b, mask, reset = (_t(a) for a in (x4, w, b, mask, reset))
    hs, cs, gates = tl.fused_lstm_plain(x4, w, b, mask, reset,
                                        with_gates=True)
    H = 8
    h, c = torch.zeros(3, H), torch.zeros(3, H)
    want = []
    for t in range(5):
        p = 1.0 - reset[:, t, None]
        h, c = p * h, p * c
        pre = (x4[:, t] + h @ w) + b[:4 * H]
        i = torch.sigmoid(pre[:, :H] + b[4 * H:5 * H] * c)
        f = torch.sigmoid(pre[:, H:2 * H] + b[5 * H:6 * H] * c)
        c_new = f * c + i * torch.tanh(pre[:, 2 * H:3 * H])
        o = torch.sigmoid(pre[:, 3 * H:] + b[6 * H:] * c_new)
        m = mask[:, t, None]
        h = m * (o * torch.tanh(c_new)) + (1.0 - m) * h
        c = m * c_new + (1.0 - m) * c
        want.append(h)
    assert hs.dtype == torch.float32
    assert torch.equal(hs, torch.stack(want, 1))
    dx4 = tl.fused_lstm_bwd_plain(w, b, mask, reset, gates, hs, cs,
                                  _t(g_hs))[0]
    assert dx4.dtype == torch.float32


# --- refusals and predicates -----------------------------------------------------

def _meta(dtypes, B=2, T=3, H=512):
    shapes = ((B, T, 4 * H), (H, 4 * H), (7 * H,))
    return [torch.zeros(s, dtype=d, device="meta")
            for s, d in zip(shapes, dtypes)]


@pytest.mark.parametrize("dtypes", [
    (torch.float16,) * 3, (torch.float64,) * 3,
    (BF16, torch.float32, BF16), (torch.float32, BF16, BF16)])
def test_other_dtypes_raise_off_the_cpu(dtypes):
    """float16, float64 and mixed dtypes off the CPU raise before any
    kernel, naming the dtypes, in the forward, the recurrence and the dW
    kernel; nothing is widened or narrowed around a kernel."""
    B, T, H = 2, 3, 512
    x4, w, b = _meta(dtypes)
    mask = torch.ones(B, T, device="meta")
    with pytest.raises(Error, match="float32 tensors, or bfloat16"):
        tl._lstm_fwd_cuda(x4, w, b, mask, None, True, 0, 0)
    gates = torch.zeros(B, T, 4 * H, dtype=dtypes[0], device="meta")
    hs, cs, g_hs = (torch.zeros(B, T, H, dtype=dtypes[0], device="meta")
                    for _ in range(3))
    with pytest.raises(Error, match="float32 tensors, or bfloat16"):
        tl.fused_lstm_bwd(w, b, mask, None, gates, hs, cs, g_hs)
    with pytest.raises(Error, match="float32 tensors, or bfloat16"):
        tl.fused_lstm_bwd_nodw(w, b, mask, None, gates, hs, cs, g_hs)
    if dtypes[0] not in (BF16, torch.float32):
        with pytest.raises(Error, match="float32 tensors, or bfloat16"):
            tl.lstm_dw_partials(gates, hs, cs, None, 1)


def test_bf16_refusals_before_launch():
    """A bf16 tensor goes to the bf16 forms or raises before a launch: H
    not a multiple of 8, and the forward of 4 units and every row (R = 0),
    which has no bf16 form; at a shape they take, the kernels ask for
    CUDA tensors."""
    B, T = 2, 3
    mask = torch.ones(B, T, device="meta")
    x4, w, b = _meta((BF16,) * 3, H=20)
    with pytest.raises(Error, match="multiple of 8"):
        tl._lstm_fwd_cuda(x4, w, b, mask, None, True, 0, 0)
    x4, w, b = _meta((BF16,) * 3)
    with pytest.raises(Error, match="R = 0.*no bf16 form"):
        tl._lstm_fwd_cuda(x4, w, b, mask, None, True, 4, 0)
    with pytest.raises(Error, match="no kernel for device meta"):
        tl._lstm_fwd_cuda(x4, w, b, mask, None, True, 0, 0)


def test_bf16_support_predicates():
    """The bf16 forms take H a multiple of 8 and their own shared memory
    (W as float, bf16 row tiles and ring): the classifier's (64, 512) and
    (64, 128) take the float32 forms' U = 16, R = 16 with smaller blocks;
    no all-rows fallback, so a shape only that kernel takes (H = 260) is
    refused and the layer keeps its loop there."""
    for B, H in ((64, 512), (64, 128), (8, 128)):
        f, b = tl.lstm_fwd_plan(B, H, BF16), tl.lstm_bwd_plan(B, H, BF16)
        assert (f.U, f.R) == tuple(tl.lstm_fwd_plan(B, H)[:2])
        assert (b.U, b.R) == tuple(tl.lstm_bwd_plan(B, H)[:2])
        assert f.smem < tl.lstm_fwd_plan(B, H).smem
        assert b.smem < tl.lstm_bwd_plan(B, H).smem
        assert tl.fused_lstm_supported(B, H, BF16)
        assert tl.fused_lstm_bwd_supported(B, H, BF16)
    assert tl.lstm_fwd_plan(64, 512, BF16).smem == 187648
    assert tl.lstm_bwd_plan(64, 512, BF16).smem == 174848
    assert tl.fused_lstm_supported(64, 260) and \
        not tl.fused_lstm_supported(64, 260, BF16)
    assert tl.fused_lstm_bwd_supported(64, 260) and \
        not tl.fused_lstm_bwd_supported(64, 260, BF16)
    assert tl.lstm_fwd_plan(2048, 512).R == 0
    assert tl.lstm_fwd_plan(2048, 512, BF16)[:2] == (8, 1024)
    with pytest.raises(Error, match="no bf16 form"):
        tl.fwd_plan(64, 512, 4, 0, BF16)
    assert tl.bwd_plan(64, 512, 16, 16, BF16).smem == 174848


# --- the classifier under mixed precision ------------------------------------------

DICT, EMB, HID, LAYERS = 50, 16, 128, 2
# hidden 128 and B = 8: the JAX kernel takes H % 128 == 0, B % 8 == 0
B_CLS = 8


def _cls_batches(seed, n=2):
    """Ragged rows of 1..15 ids, one of 15 per batch (T pads to 16)."""
    r = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        lens = r.randint(1, 16, size=B_CLS)
        lens[0] = 15
        out.append([(r.randint(0, DICT, size=k).tolist(),
                     int(r.randint(0, 2))) for k in lens])
    return out


class _jax_kernel_path:
    """The JAX layer's kernel path on the CPU: jax.default_backend reports
    "tpu" and fused_lstm runs in interpret mode."""

    def __enter__(self):
        self.backend, self.fused = jax.default_backend, jax_lstm.fused_lstm
        fused = self.fused
        jax.default_backend = lambda: "tpu"
        jax_lstm.fused_lstm = lambda x4, w, b, m, r=None, i=False: fused(
            x4, w, b, m, r, True)

    def __exit__(self, *exc):
        jax.default_backend, jax_lstm.fused_lstm = self.backend, self.fused


@pytest.fixture(scope="module")
def cls():
    """Both packages' classifier, the JAX package's initial parameters,
    two batches fed by each feeder, and the JAX loss's value and gradient
    under loss_fn(compute_dtype=bf16) through its kernel path, its LSTM
    outputs there and through its scan, and two Adam steps' costs."""
    with jax_name_scope():
        jcost = jax_lstm_cls(dict_dim=DICT, emb_dim=EMB, hidden=HID,
                             num_layers=LAYERS)[3]
    with torch_name_scope():
        tcost = torch_lstm_cls(dict_dim=DICT, emb_dim=EMB, hidden=HID,
                               num_layers=LAYERS)[3]
    jtopo, ttopo = pj.Topology(jcost), pt.Topology(tcost)
    init = {k: np.array(v) for k, v in
            jtopo.init_params(jax.random.PRNGKey(3)).items()}
    batches = _cls_batches(5)
    jfeeds = [JFeeder(jtopo.data_type())(b) for b in batches]
    tfeeds = [{k: a.to("cpu") for k, a in
               TFeeder(ttopo.data_type())(b).items()} for b in batches]
    out = dict(tcost=tcost, ttopo=ttopo, init=init, batches=batches,
               tfeeds=tfeeds)
    jp = {k: jnp.asarray(v) for k, v in init.items()}
    bf_params = {k: v.astype(jnp.bfloat16) for k, v in jp.items()}
    names = [f"lstm_cls_l{i}" for i in range(LAYERS)]

    def lstms():
        outs = jtopo.forward(bf_params, jfeeds[0], training=True,
                             rng=jax.random.PRNGKey(0))
        return [np.asarray(outs[n].value.astype(jnp.float32))
                for n in names]

    out["scan_lstms"] = lstms()
    with _jax_kernel_path():
        out["kernel_lstms"] = lstms()
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
    out["names"] = names
    return out


def test_classifier_lstms_take_the_kernel_rule_under_bf16(cls):
    """The classifier's two lstmemory layers on bf16 parameters and
    feeds: the port (fused_lstm's plain version) against the JAX layer's
    kernel path within one ulp of the largest value, >= 99.5% bit-equal
    (measured: the first layer one ulp off at one element of 8192, the
    second, whose input that element and the fc before it move, 0.59
    ulps of its largest and 99.80% bit-equal); the JAX layer's scan (its
    CPU path) misses that bound (measured: 2.4 and 3.0 ulps of the
    largest, 57% and 50% bit-equal), so the test tells the kernel's rule
    from the scan's at the model."""
    params = {k: torch.from_numpy(v).to(BF16) for k, v in cls["init"].items()}
    outs = cls["ttopo"].forward(params, cls["tfeeds"][0], training=True)
    for i, name in enumerate(cls["names"]):
        got = outs[name].value
        assert got.dtype == BF16
        _assert_bf16_close(name, got, cls["kernel_lstms"][i],
                           of_largest=True, min_share=0.995)
        scan, kernel = cls["scan_lstms"][i], cls["kernel_lstms"][i]
        assert _of_largest(scan, kernel) > MAX_ULPS and \
            _ulps(scan, kernel)[1] < 0.995, name


def test_classifier_bf16_loss_gradients_and_adam_steps_match_jax(cls):
    """loss_fn(compute_dtype=bf16) of the port (CPU: the LSTM's plain bf16
    versions through the _FusedLSTM Function) against the JAX package's
    through its kernel path: the cost within 1e-3 relative, each
    parameter's gradient within 2e-2 of its largest (the other layers
    round bf16 at other places in the two packages, as the NMT model's
    test says), and two Adam steps' costs within 1e-3 relative."""
    topo = cls["ttopo"]
    loss = topo.loss_fn(compute_dtype=BF16)
    leaves = {k: torch.from_numpy(v).requires_grad_(True)
              for k, v in cls["init"].items()}
    cost, _ = loss(leaves, cls["tfeeds"][0])
    cost.backward()
    assert abs(float(cost.detach()) - cls["jax_cost"]) <= \
        1e-3 * abs(cls["jax_cost"])
    for k, want in cls["jax_grads"].items():
        got = leaves[k].grad
        assert got.dtype == torch.float32, k
        assert np.abs(got.numpy() - want).max() <= \
            2e-2 * np.abs(want).max(), k
    opt = pt.optimizer.Adam(learning_rate=5e-3)
    step = torch_train_step(loss, opt, topo.static_map(), topo.lr_mults())
    params = {k: torch.from_numpy(v) for k, v in cls["init"].items()}
    state = opt.init(params)
    costs = []
    for feeds in cls["tfeeds"]:
        params, state, c, _ = step(params, state, feeds)
        costs.append(float(c))
    np.testing.assert_allclose(costs, cls["jax_costs"], rtol=1e-3)


def test_mixed_precision_sgd_trains_the_classifier_on_the_cpu(cls):
    """SGD(mixed_precision=True).train(device="cpu") on the classifier:
    finite costs, float32 masters, and the two LSTMs through the
    _FusedLSTM Function (its backward is the bf16 kernels' on a card)."""
    trainer = pt.SGD(cls["tcost"], TParameters.from_numpy(cls["init"]),
                     pt.optimizer.Adam(learning_rate=5e-3),
                     mixed_precision=True, device="cpu")
    costs = []
    trainer.train(lambda: iter(cls["batches"]), num_passes=1,
                  event_handler=lambda e: costs.append(e.cost) if isinstance(
                      e, pt.event.EndIteration) else None)
    assert len(costs) == 2 and np.isfinite(costs).all()
    for k in cls["init"]:
        assert trainer.parameters.get(k).dtype == torch.float32, k
    params = {k: torch.from_numpy(v).requires_grad_(True)
              for k, v in cls["init"].items()}
    cost, _ = cls["ttopo"].loss_fn(compute_dtype=BF16)(params,
                                                       cls["tfeeds"][0])
    seen, stack, names = set(), [cost.grad_fn], []
    while stack:
        f = stack.pop()
        if f is None or f in seen:
            continue
        seen.add(f)
        names.append(type(f).__name__)
        stack.extend(n for n, _ in f.next_functions)
    assert names.count("_FusedLSTMBackward") == 2


# --- on the card ----------------------------------------------------------------

def _cuda_case(B, T, H, case, seed):
    x4, w, b, mask, reset, g_hs, g_cs = _data(B, T, H, case, seed)
    dev = lambda a: None if a is None else _tb(a).cuda()   # noqa: E731
    return ([dev(a) for a in (x4, w, b)], _t(mask).cuda(),
            None if reset is None else _t(reset).cuda(), dev(g_hs),
            dev(g_cs))


@pytest.mark.cuda
@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("B,T,H,case", [(64, 100, 512, "reset"),
                                        (64, 100, 512, "ragged")])
def test_bf16_kernels_match_plain_on_card(B, T, H, case, form):
    """lstm_fwd_bf16, lstm_bwd_bf16 and lstm_bwd_dw_bf16 against the plain
    versions on the card (their float32 products with TF32 off): hs, cs,
    the stash and dx4 within one bf16 ulp of the largest value; of their
    largest, in float32, dW within 1e-5 on the kernel's dx4, db within
    4e-4 (chip_smoke.py's limits: sound runs read 7.2e-7 and 1.9e-4 at
    most, dW with h_prev unrounded and db from the bf16 dx4 some 1e-3);
    one launch of each bf16 kernel of the form and none of a float32
    one."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    (x4, w, b), mask, reset, g_hs, g_cs = _cuda_case(B, T, H, case, 1)
    before = dict(tk.launches)
    hs, cs, gates = tl.fused_lstm_fwd(x4, w, b, mask, reset, stash=True)
    with _split_form(form == "split"):
        got = tl.fused_lstm_bwd(w, b, mask, reset, gates, hs, cs, g_hs, g_cs)
    rose = {k: tk.launches[k] - before[k] for k in before}
    rec = "fused_lstm_bwd_nodw_bf16" if form == "split" else \
        "fused_lstm_bwd_bf16"
    assert rose["fused_lstm_bf16"] == rose[rec] == 1
    assert rose["fused_lstm_bwd_dw_bf16"] == int(form != "split")
    assert rose["fused_lstm"] == rose["fused_lstm_bwd"] == \
        rose["fused_lstm_bwd_nodw"] == rose["fused_lstm_bwd_dw"] == 0
    want = tl.fused_lstm_plain(x4, w, b, mask, reset, with_gates=True)
    want_bwd = tl.fused_lstm_bwd_plain(w, b, mask, reset, gates, hs, cs,
                                       g_hs, g_cs)
    for g, wv in zip((hs, cs, gates, got[0]), want + want_bwd[:1]):
        big = wv.float().abs().max().item()
        assert (g.float() - wv.float()).abs().max().item() <= \
            2.0 ** (np.floor(np.log2(big)) - 7)
    rel = lambda g, w: ((g - w).abs().max() / w.abs().max()).item()  # noqa
    on_dx4 = tl.split_dw_db(got[0], hs, cs, reset)
    assert rel(got[1], on_dx4[0]) <= 1e-5
    if form == "split":
        assert rel(got[2], on_dx4[1]) <= 1e-5
    else:
        assert rel(got[2], want_bwd[2]) <= 4e-4
