"""The CRF and CTC Functions on bf16 inputs (paddle_tpu_torch.kernels.crf
``crf_logz`` and kernels.ctc ``ctc_fb`` / ``ctc_nll_kernel``) against the
JAX package's kernels in interpret mode, and the RNN CRF tagger and the
CTC model under mixed precision against the JAX package's kernel path.

The JAX kernels compute in ``promote_types(em.dtype, float32)``: on bf16
emissions the recursions run in float32, log Z and the NLL come back in
float32, and d_em comes back in the emissions' dtype (d_trans, d_start and
d_end in their parameters'). The port widens at the Functions' entry to
the same effect. The controls run the same Functions' recursions in bf16
(``_CrfLogZ`` and ``_CtcFB`` applied to bf16 tensors with no widening,
the port's behaviour before it took the rule) and must miss the bounds.

Tolerances: log Z and the NLL within 1e-5 relative (float32 sums in
another order); d_em and d logits within one bf16 ulp of the largest
magnitude, at least 99% of the elements bit-equal (each element is one
float32 marginal rounded once, and a marginal that lands on a rounding
boundary may round the other way).

The model tests force the JAX layers onto their kernel paths on the CPU,
as on a TPU: ``jax.default_backend`` reports "tpu", ``fused_gru`` runs in
interpret mode, the CRF takes ``CRF_IMPL = "pallas"`` with
``crf_logz_pallas(..., interpret=True)`` and the CTC ``CTC_IMPL =
"pallas"`` with ``ctc_nll_pallas(..., interpret=True)``. JAX's own scan
cannot run the CRF under bf16 (its carry changes dtype), which is why.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pj
import paddle_tpu.kernels.crf as jax_crf
import paddle_tpu.kernels.ctc as jax_ctc
import paddle_tpu.kernels.gru as jax_gru
import paddle_tpu.layers.crf_ctc as jax_crf_ctc
from paddle_tpu.core.layer import layer_name_scope as jax_name_scope
from paddle_tpu.models import text as jtext
from paddle_tpu.trainer.feeder import DataFeeder as JFeeder
from paddle_tpu.trainer.trainer import make_train_step as jax_train_step

import paddle_tpu_torch as pt
import paddle_tpu_torch.layers.crf_ctc as tc
from paddle_tpu_torch.core.layer import layer_name_scope as torch_name_scope
from paddle_tpu_torch.core.parameters import Parameters as TParameters
from paddle_tpu_torch.kernels import crf as tcrf
from paddle_tpu_torch.kernels import ctc as tctc
from paddle_tpu_torch.models import text as ttext
from paddle_tpu_torch.trainer import make_train_step as torch_train_step
from paddle_tpu_torch.trainer.feeder import DataFeeder as TFeeder
from paddle_tpu_torch.utils.error import Error

BF16 = torch.bfloat16
LOGZ_RTOL, MAX_ULPS, MIN_BIT_EQUAL = 1e-5, 1.0, 0.99


def _bf(a):
    """A float32 numpy array rounded to bf16 values (still float32)."""
    return torch.from_numpy(np.asarray(a, np.float32)).to(BF16).float() \
        .numpy()


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _of_largest(got, want):
    """(max |got - want| in bf16 ulps of the largest |want| (2^-8 of it),
    the share of bit-equal elements)."""
    g, w = _np(got), _np(want)
    return float(np.abs(g - w).max() / (np.abs(w).max() * 2.0 ** -8)), \
        float((g == w).mean())


def _rel(got, want):
    g, w = _np(got), _np(want)
    return float((np.abs(g - w) / np.abs(w)).max())


# --- the CRF Function --------------------------------------------------------

def _crf_data(T=64, B=4, L=7, seed=0):
    """em [T, B, L], mask [T, B] (one row ragged), start, end [L], trans
    [L, L], ct [B], each exactly a bf16 value; log Z reaches some 165."""
    r = np.random.RandomState(seed)
    em = _bf(r.randn(T, B, L) * 2.0)
    mask = np.ones((T, B), np.float32)
    mask[T // 3:, 1] = 0
    start, end = _bf(r.randn(L)), _bf(r.randn(L))
    trans = _bf(r.randn(L, L))
    ct = _bf(r.randn(B))
    return em, mask, start, end, trans, ct


@pytest.fixture(scope="module")
def crf_case():
    """The inputs and JAX's crf_logz in interpret mode on their bf16
    values: log Z and its vjp for the cotangent ct."""
    em, mask, start, end, trans, ct = _crf_data()
    jb = lambda a: jnp.asarray(a).astype(jnp.bfloat16)  # noqa: E731
    logz, vjp = jax.vjp(
        lambda e, s, n, t: jax_crf.crf_logz(e, jb(mask), s, n, t, True),
        jb(em), jb(start), jb(end), jb(trans))
    grads = vjp(jnp.asarray(ct))
    return dict(inputs=(em, mask, start, end, trans, ct), logz=logz,
                grads=grads)


def _crf_port(inputs, fn=tcrf.crf_logz):
    em, mask, start, end, trans, ct = inputs
    leaves = [torch.from_numpy(a).to(BF16).requires_grad_(True)
              for a in (em, start, end, trans)]
    logz = fn(leaves[0], torch.from_numpy(mask).to(BF16), *leaves[1:])
    logz.backward(torch.from_numpy(ct))
    return logz, [a.grad for a in leaves]


def test_crf_logz_takes_the_jax_dtype_rule(crf_case):
    """bf16 em, start, end, trans and mask: log Z float32 within 1e-5 of
    JAX's, d_em bf16 within one ulp of its largest magnitude and >= 99%
    bit-equal, d_start, d_end and d_trans bf16 within one ulp of their
    largest."""
    assert crf_case["logz"].dtype == jnp.float32
    logz, grads = _crf_port(crf_case["inputs"])
    assert logz.dtype == torch.float32
    assert _rel(logz, crf_case["logz"]) <= LOGZ_RTOL
    for name, got, want in zip(("d_em", "d_start", "d_end", "d_trans"),
                               grads, crf_case["grads"]):
        assert got.dtype == BF16 and want.dtype == jnp.bfloat16, name
        ulps, share = _of_largest(got, want)
        assert ulps <= MAX_ULPS, (name, ulps)
        if name == "d_em":
            assert share >= MIN_BIT_EQUAL, (name, share)


def _crf_in_bf16(em, mask, start, end, trans):
    """The Function's recursions on the bf16 tensors as they are: the
    plain versions in bf16, the port's behaviour before the rule."""
    return tcrf._CrfLogZ.apply(em, mask, start, end, trans)


def test_crf_bf16_recursion_misses_the_bounds(crf_case):
    """The control: the recursion in bf16 gives log Z in bf16, far past
    1e-5 of JAX's (measured 9.3 apart at 165), and d_em past one ulp."""
    logz, grads = _crf_port(crf_case["inputs"], _crf_in_bf16)
    assert logz.dtype == BF16
    assert _rel(logz, crf_case["logz"]) > LOGZ_RTOL
    ulps, share = _of_largest(grads[0], crf_case["grads"][0])
    assert ulps > MAX_ULPS


def test_crf_logz_keeps_float32_and_float64():
    """float32 inputs give the float32 Function's results bit for bit (no
    cast in the way); float64 stays float64 (the gradient checks')."""
    em, mask, start, end, trans, _ = _crf_data(T=9, B=3, L=5, seed=2)
    args = [torch.from_numpy(a) for a in (em, mask, start, end, trans)]
    want = tcrf._CrfLogZ.apply(*args)
    assert torch.equal(tcrf.crf_logz(*args), want)
    got = tcrf.crf_logz(*(a.double() for a in args))
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5)


@pytest.mark.parametrize("dtypes", [
    (torch.float16,) * 5, (BF16, BF16, BF16, BF16, torch.float32),
    (torch.float32, torch.float32, BF16, torch.float32, torch.float32),
    (BF16, torch.float16, BF16, BF16, BF16)])
def test_crf_logz_refuses_other_dtypes(dtypes):
    """float16, a mix of data dtypes, and a float16 mask raise before
    anything runs, on the CPU too."""
    em, mask, start, end, trans, _ = _crf_data(T=5, B=2, L=3)
    args = [torch.from_numpy(a).to(d) for a, d in
            zip((em, mask, start, end, trans), dtypes)]
    with pytest.raises(Error, match="crf_logz: the"):
        tcrf.crf_logz(*args)


# --- the CTC Function --------------------------------------------------------

def _ctc_data(B=4, T=64, C=12, U=8, seed=1):
    """logits [B, T, C] (bf16 values), labels [B, U] never the blank 0,
    ragged frames and labels, a repeated label; ct [B]."""
    r = np.random.RandomState(seed)
    logits = _bf(r.randn(B, T, C) * 2.0)
    labels = r.randint(1, C, size=(B, U)).astype(np.int32)
    labels[2, 1] = labels[2, 0]
    ulen = r.randint(1, U + 1, size=B)
    tlen = r.randint(T // 4, T + 1, size=B)
    ulen[0], tlen[0], ulen[2] = U, T, max(ulen[2], 2)
    label_mask = (np.arange(U)[None] < ulen[:, None]).astype(np.float32)
    in_mask = (np.arange(T)[None] < tlen[:, None]).astype(np.float32)
    ct = _bf(r.randn(B))
    return logits, labels, in_mask, label_mask, ct


@pytest.fixture(scope="module")
def ctc_case():
    logits, labels, in_mask, label_mask, ct = _ctc_data()
    nll, vjp = jax.vjp(
        lambda x: jax_ctc.ctc_nll_pallas(
            x, jnp.asarray(labels), jnp.asarray(in_mask).astype(jnp.bfloat16),
            jnp.asarray(label_mask), 0, True),
        jnp.asarray(logits).astype(jnp.bfloat16))
    (grad,) = vjp(jnp.asarray(ct))
    return dict(inputs=(logits, labels, in_mask, label_mask, ct), nll=nll,
                grad=grad)


def _ctc_port(inputs):
    logits, labels, in_mask, label_mask, ct = inputs
    x = torch.from_numpy(logits).to(BF16).requires_grad_(True)
    nll = tctc.ctc_nll_kernel(x, torch.from_numpy(labels),
                              torch.from_numpy(in_mask).to(BF16),
                              torch.from_numpy(label_mask))
    nll.backward(torch.from_numpy(ct))
    return nll, x.grad


# d logits: JAX's backward on the CPU sums the log-softmax's cotangent over
# the classes in bf16, one add at a time (XLA's CPU reduction of a bf16
# array inside the vjp), where the port sums in float32 and rounds once;
# that alone leaves d logits up to some 1.6 ulps of the largest apart and
# some 80% bit-equal (measured 1.55 and 80.9% here). The bound is 2 ulps of
# the largest: the bf16 recursion misses it by hundreds
D_LOGITS_ULPS = 2.0


def test_ctc_nll_kernel_takes_the_jax_dtype_rule(ctc_case):
    """bf16 logits: the NLL float32 within 1e-5 of JAX's
    ctc_nll_pallas(interpret=True) (the log-softmax rounded where JAX's
    rounds on bf16), d logits bf16 within D_LOGITS_ULPS bf16 ulps of its
    largest magnitude. d_em itself is held to one ulp and 99% bit-equal
    by test_ctc_fb_matches_jax_on_the_same_emissions."""
    assert ctc_case["nll"].dtype == jnp.float32
    nll, grad = _ctc_port(ctc_case["inputs"])
    assert nll.dtype == torch.float32 and grad.dtype == BF16
    assert _rel(nll, ctc_case["nll"]) <= LOGZ_RTOL
    ulps, share = _of_largest(grad, ctc_case["grad"])
    assert ulps <= D_LOGITS_ULPS, (ulps, share)


def test_ctc_bf16_recursion_misses_the_bounds(ctc_case, monkeypatch):
    """The control: ctc_fb's recursion in bf16 (the Function applied to
    the bf16 tensors as they are) misses both bounds."""
    monkeypatch.setattr(tctc, "ctc_fb", lambda *a: tctc._CtcFB.apply(*a))
    nll, grad = _ctc_port(ctc_case["inputs"])
    assert nll.dtype == BF16
    assert _rel(nll, ctc_case["nll"]) > LOGZ_RTOL
    ulps, _ = _of_largest(grad, ctc_case["grad"])
    assert ulps > D_LOGITS_ULPS


def test_ctc_fb_matches_jax_on_the_same_emissions(ctc_case):
    """ctc_fb on the bf16 extended emissions that ctc_nll_kernel gathers,
    against JAX's ctc_fb(interpret=True) on the same values: the NLL in
    float32 within 1e-5, d_em in bf16 within one ulp of its largest."""
    logits, labels, in_mask, label_mask, ct = ctc_case["inputs"]
    lab, lm = torch.from_numpy(labels), torch.from_numpy(label_mask)
    B, T, _ = logits.shape
    S = 2 * labels.shape[1] + 1
    ext, ok, skip, slen = tctc.extended_labels(lab, lm, 0, S)
    logp = torch.log_softmax(torch.from_numpy(logits), -1).to(BF16)
    em = torch.gather(logp, 2, ext[:, None, :].expand(B, T, S)) \
        .transpose(0, 1).contiguous()
    pos = torch.arange(S)[None, :]
    beta_init = torch.where((pos == slen[:, None] - 1) | (
        (pos == slen[:, None] - 2) & (slen >= 2)[:, None]), 0.0,
        tctc.NEG).to(BF16)
    flags = [torch.from_numpy(in_mask.T.copy()), (skip & ok).float(),
             ok.float()]
    e = em.clone().requires_grad_(True)
    nll = tctc.ctc_fb(e, *flags, beta_init)
    nll.backward(torch.from_numpy(ct))
    jnll, vjp = jax.vjp(lambda x: jax_ctc.ctc_fb(
        x, *(jnp.asarray(f.numpy()) for f in flags),
        jnp.asarray(beta_init.float().numpy()).astype(jnp.bfloat16), True),
        jnp.asarray(em.float().numpy()).astype(jnp.bfloat16))
    (jd,) = vjp(jnp.asarray(ct))
    assert nll.dtype == torch.float32 and e.grad.dtype == BF16
    assert _rel(nll, jnll) <= LOGZ_RTOL
    ulps, share = _of_largest(e.grad, jd)
    assert ulps <= MAX_ULPS and share >= MIN_BIT_EQUAL, (ulps, share)


@pytest.mark.parametrize("what", ["float16", "mixed"])
def test_ctc_fb_refuses_other_dtypes(what):
    em = torch.zeros(4, 2, 5, dtype=torch.float16 if what == "float16"
                     else BF16)
    ones = torch.ones(2, 5)
    beta = torch.zeros(2, 5)                  # float32 beside bf16 em
    with pytest.raises(Error, match="ctc_fb: the kernels take"):
        tctc.ctc_fb(em, torch.ones(4, 2), ones, ones, beta.to(em.dtype)
                    if what == "float16" else beta)


# --- the models under mixed precision ----------------------------------------

class _jax_kernel_path:
    """The JAX layers' kernel paths on the CPU: jax.default_backend
    reports "tpu", fused_gru runs in interpret mode, the CRF takes
    crf_logz_pallas and the CTC ctc_nll_pallas, both in interpret mode."""

    def __init__(self, monkeypatch):
        self.mp = monkeypatch

    def __enter__(self):
        mp = self.mp
        fused, crf_p, ctc_p = (jax_gru.fused_gru, jax_crf_ctc.crf_logz_pallas,
                               jax_ctc.ctc_nll_pallas)
        mp.setattr(jax, "default_backend", lambda: "tpu")
        mp.setattr(jax_gru, "fused_gru",
                   lambda x3, wg, wc, b, m, r=None, i=False: fused(
                       x3, wg, wc, b, m, r, True))
        mp.setattr(jax_crf_ctc, "CRF_IMPL", "pallas")
        mp.setattr(jax_crf_ctc, "crf_logz_pallas",
                   lambda e, m, w, i=False: crf_p(e, m, w, True))
        mp.setattr(jax_crf_ctc, "CTC_IMPL", "pallas")
        mp.setattr(jax_ctc, "ctc_nll_pallas",
                   lambda *a: ctc_p(*a[:5], True))
        return self

    def __exit__(self, *exc):
        self.mp.undo()


TAGGER = dict(word_dim=60, label_dim=5, emb_dim=16, hidden=16)
TAGGER_FEEDING = {"words": 0, "labels": 1}
CTC_F, CTC_C = 7, 6
CTC_FEEDING = {"frames": 0, "labels": 1}
T_LONG = 64


def _tagger_batches(n=3, B=4, seed=5):
    """n batches of B (words, labels) rows, 40..64 long with one of 64 a
    batch (T pads to 64)."""
    r = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        lens = r.randint(40, T_LONG + 1, size=B)
        lens[0] = T_LONG
        out.append([(r.randint(0, TAGGER["word_dim"], size=k).tolist(),
                     r.randint(0, TAGGER["label_dim"], size=k).tolist())
                    for k in lens])
    return out


def _ctc_model(pkg):
    frames = pkg.layer.data(name="frames",
                            type=pkg.data_type.dense_vector_sequence(CTC_F))
    labels = pkg.layer.data(name="labels",
                            type=pkg.data_type.integer_value_sequence(CTC_C))
    out = pkg.layer.fc(input=frames, size=CTC_C, act=pkg.activation.Linear())
    return pkg.layer.warp_ctc(input=out, label=labels, size=CTC_C, blank=0,
                              name="cost")


def _ctc_batches(n=3, B=4, seed=5):
    """n batches of B (frames [len, F], labels) rows, 40..64 frames with
    one of 64 a batch, 2..8 labels never the blank."""
    r = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        lens = r.randint(40, T_LONG + 1, size=B)
        lens[0] = T_LONG
        out.append([(r.randn(k, CTC_F).astype(np.float32),
                     r.randint(1, CTC_C, size=r.randint(2, 9)).tolist())
                    for k in lens])
    return out


def _model(kind):
    """(JAX cost, port cost, outputs' names, batches, feeding)."""
    if kind == "tagger":
        with jax_name_scope():
            j = jtext.rnn_crf_tagger(**TAGGER)[3]
        with torch_name_scope():
            t = ttext.rnn_crf_tagger(**TAGGER)[3]
        return j, t, _tagger_batches(), TAGGER_FEEDING
    with jax_name_scope():
        j = _ctc_model(pj)
    with torch_name_scope():
        t = _ctc_model(pt)
    return j, t, _ctc_batches(), CTC_FEEDING


@pytest.fixture(scope="module", params=["tagger", "ctc"])
def model(request):
    """Both packages' model, the JAX initial parameters, the batches fed by
    each feeder (T = 64), and the JAX loss under loss_fn(compute_dtype=
    bf16) through its kernel path: its value and gradient on the first
    batch and the costs of an Adam step on each batch."""
    kind = request.param
    jcost, tcost, batches, feeding = _model(kind)
    jtopo, ttopo = pj.Topology(jcost), pt.Topology(tcost)
    init = {k: np.array(v) for k, v in
            jtopo.init_params(jax.random.PRNGKey(3)).items()}
    jfeeds = [JFeeder(jtopo.data_type(), feeding)(b) for b in batches]
    tfeeds = [{k: a.to("cpu") for k, a in
               TFeeder(ttopo.data_type(), feeding)(b).items()}
              for b in batches]
    out = dict(kind=kind, tcost=tcost, ttopo=ttopo, init=init,
               batches=batches, feeding=feeding, tfeeds=tfeeds)
    mp = pytest.MonkeyPatch()
    with _jax_kernel_path(mp):
        jp = {k: jnp.asarray(v) for k, v in init.items()}
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


# the model tolerances: the cost within COST_RTOL relative, each
# parameter's gradient within GRAD_RTOL of its largest, the Adam steps'
# costs within COST_RTOL (the other layers round bf16 at other places in
# the two packages, as tests/test_torch_gru_bf16.py states for the NMT
# model, so the gradients are held no tighter)
COST_RTOL, GRAD_RTOL = 1e-3, 2e-2


def test_model_bf16_loss_gradients_and_adam_step_match_jax(model,
                                                           monkeypatch):
    """loss_fn(compute_dtype=bf16) of the port, its CRF or CTC through the
    widened Function (CRF_IMPL / CTC_IMPL "kernel": the plain versions
    on the CPU), against the JAX package's kernel path: the cost, every
    parameter's gradient (float32, on the float32 masters) and three
    Adam steps' costs."""
    monkeypatch.setattr(tc, "CRF_IMPL", "kernel")
    monkeypatch.setattr(tc, "CTC_IMPL", "kernel")
    topo = model["ttopo"]
    loss = topo.loss_fn(compute_dtype=BF16)
    leaves = {k: torch.from_numpy(v).requires_grad_(True)
              for k, v in model["init"].items()}
    cost, _ = loss(leaves, model["tfeeds"][0])
    cost.backward()
    assert abs(float(cost.detach()) - model["jax_cost"]) <= \
        COST_RTOL * abs(model["jax_cost"])
    for k, want in model["jax_grads"].items():
        got = leaves[k].grad
        assert got.dtype == torch.float32, k
        assert np.abs(got.numpy() - want).max() <= \
            GRAD_RTOL * np.abs(want).max(), k
    opt = pt.optimizer.Adam(learning_rate=5e-3)
    step = torch_train_step(loss, opt, topo.static_map(), topo.lr_mults())
    params = {k: torch.from_numpy(v) for k, v in model["init"].items()}
    state = opt.init(params)
    costs = []
    for feeds in model["tfeeds"]:
        params, state, c, _ = step(params, state, feeds)
        costs.append(float(c))
    np.testing.assert_allclose(costs, model["jax_costs"], rtol=COST_RTOL)


def test_mixed_precision_sgd_trains_the_model_on_the_cpu(model,
                                                          monkeypatch):
    """SGD(mixed_precision=True).train(device="cpu"): finite costs, float32
    masters, the cost through the widened Function (one _CrfLogZBackward
    or _CtcFBBackward in the graph) and, for the tagger, its two GRUs
    through _FusedGRU."""
    monkeypatch.setattr(tc, "CRF_IMPL", "kernel")
    monkeypatch.setattr(tc, "CTC_IMPL", "kernel")
    trainer = pt.SGD(model["tcost"], TParameters.from_numpy(model["init"]),
                     pt.optimizer.Adam(learning_rate=5e-3),
                     mixed_precision=True, device="cpu")
    costs = []
    trainer.train(lambda: iter(model["batches"]), num_passes=1,
                  feeding=model["feeding"],
                  event_handler=lambda e: costs.append(e.cost) if isinstance(
                      e, pt.event.EndIteration) else None)
    assert len(costs) == 3 and np.isfinite(costs).all()
    for k in model["init"]:
        assert trainer.parameters.get(k).dtype == torch.float32, k
    params = {k: torch.from_numpy(v).requires_grad_(True)
              for k, v in model["init"].items()}
    cost, _ = model["ttopo"].loss_fn(compute_dtype=BF16)(
        params, model["tfeeds"][0])
    seen, stack, names = set(), [cost.grad_fn], []
    while stack:
        f = stack.pop()
        if f is None or f in seen:
            continue
        seen.add(f)
        names.append(type(f).__name__)
        stack.extend(n for n, _ in f.next_functions)
    tagger = model["kind"] == "tagger"
    assert names.count("_CrfLogZBackward" if tagger
                       else "_CtcFBBackward") == 1
    assert names.count("_FusedGRUBackward") == (2 if tagger else 0)


# --- on the card -------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("fn", ["crf", "ctc"])
def test_widened_functions_on_card(fn):
    """On bf16 CUDA tensors the widened Functions launch the float32
    kernels (one launch each of the forward's and the backward's) and
    agree with the CPU's run on the same values: log Z / NLL within 1e-5,
    d_em within one bf16 ulp of its largest."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    from paddle_tpu_torch import kernels as tk
    before = dict(tk.launches)
    if fn == "crf":
        inputs = _crf_data(T=128, B=8, L=67)
        cpu = _crf_port(inputs)

        def card():
            em, mask, start, end, trans, ct = inputs
            leaves = [torch.from_numpy(a).to(BF16).cuda().requires_grad_(True)
                      for a in (em, start, end, trans)]
            out = tcrf.crf_logz(leaves[0],
                                torch.from_numpy(mask).to(BF16).cuda(),
                                *leaves[1:])
            out.backward(torch.from_numpy(ct).cuda())
            return out, leaves[0].grad
        got, d_em = card()
        kernels = ("crf_fwd", "crf_bwd", "crf_bwd_marginals",
                   "crf_bwd_reduce")
        want, want_d = cpu[0], cpu[1][0]
    else:
        inputs = _ctc_data(B=8, T=128, C=30, U=12)
        want, want_d = _ctc_port(inputs)
        logits, labels, in_mask, label_mask, ct = inputs
        x = torch.from_numpy(logits).to(BF16).cuda().requires_grad_(True)
        got = tctc.ctc_nll_kernel(x, torch.from_numpy(labels).cuda(),
                                  torch.from_numpy(in_mask).to(BF16).cuda(),
                                  torch.from_numpy(label_mask).cuda())
        got.backward(torch.from_numpy(ct).cuda())
        d_em = x.grad
        kernels = ("ctc_fwd", "ctc_bwd", "ctc_bwd_marginals")
    rose = {k: tk.launches[k] - before[k] for k in kernels}
    assert all(v == 1 for v in rose.values()), rose
    assert got.dtype == torch.float32 and d_em.dtype == BF16
    assert _rel(got.cpu(), want) <= LOGZ_RTOL
    ulps, _ = _of_largest(d_em.cpu(), want_d)
    assert ulps <= MAX_ULPS
