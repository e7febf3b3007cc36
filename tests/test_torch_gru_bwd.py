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
                                        (1, 100, 512, "ragged")])
def test_bwd_kernels_match_plain_on_card(B, T, H, case):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    x3, wg, wc, b, mask, reset, g_hs = _cuda_case(B, T, H, case, 7)
    hs, gates = tg.fused_gru_fwd(x3, wg, wc, b, mask, reset, True)
    before = dict(tk.launches)
    got = tg.fused_gru_bwd(wg, wc, mask, reset, gates, hs, g_hs)
    torch.cuda.synchronize()
    assert tk.launches["fused_gru_bwd"] == before["fused_gru_bwd"] + 1
    assert tk.launches["fused_gru_bwd_dw"] == before["fused_gru_bwd_dw"] + 1
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
