"""Times two checkouts of the port against each other on one NVIDIA GPU:
the GRU forward with its training stash (``fused_gru_fwd``, the kernel
each checkout picks) and the backward's recurrence on that stash
(``fused_gru_bwd_dx3``, the kernel each checkout picks; the upstream
gradient randn on the valid steps) at the RNN CRF tagger's (32, 512,
128), rows 256..512 long, and the NMT encoder's (64, 100, 512), rows
25..100 long, and (256, 30, 512); the ``vocab_xent`` forward (its partials and their
combine) at bench_nmt's output projection (7680, 512, 30000) and over
512 of its rows; the LSTM forward (``fused_lstm_fwd``, with the training
stash and without, serving's launch) and the backward's two forms on the
forward kernel's stash (``fused_lstm_bwd``, the default form with dW and
db, and ``fused_lstm_bwd_nodw``, the split form's recurrence alone; the
upstream gradient of hs randn on the valid steps) at (64, 100, 512), rows
25..100 long, and the classifier's (64, 128, 512), rows 5..100 long; the
CRF forward (``crf_alphas``) and backward (``crf_bwd``: d_em and the
rows' pairwise marginals from the forward kernel's alphas) at the
taggers' (B, T, L) = (32, 512, 67) with bench_crf's rows, 256..512 long;
the CTC forward (``ctc_alphas``) and backward (``ctc_bwd``: d_em from the
forward kernel's alphas, without a cotangent) at the CTC path's (B, T, S)
= (32, 512, 65) (log-softmax of randn logits over 128 classes at rows'
extended labels, 1..20 labels padded to 32, rows T/4..T frames long, one
of T); the max-pool backward (``maxpool_3x3s2p1_bwd``, the plan each
checkout picks) at bench_resnet50's stem pool [256, 112, 112, 64], x and
dy randn from a card generator seeded 1234; the LSTM classifier's B = 64
request and its B = 1 request
(models.text.lstm_text_classification at bench_lstm's 30000/512/512 x 2
through ``Inference.infer``, rows 5..100 ids long, one of 100): the
median host time of 11 after a warm-up; the LSTM forward's host time a
call (``fused_lstm_fwd`` without the stash, serving's launch, 200 calls
enqueued back to back: the wrapper's cost, not the kernel's) at the
classifier's (64, 128, 512) and (1, 128, 512), outside and inside
``torch.inference_mode()`` (serving runs inside); the GRU forward's host
time a call the same way (``fused_gru_fwd`` without the stash) at the
generation bundles' encoder shape (8, 16, 512) and the NMT training
step's (64, 30, 512), rows T/4..T long; and three
Adam training steps: the RNN CRF tagger's (models.text.rnn_crf_tagger at
5000/67/64/128, B=32, rows 256..512 long, T=512), the LSTM
classifier's (B=64, rows 5..100 long, T=128) and the CTC model's (161
frame features -> fc 128 -> warp_ctc with CTC_IMPL = "kernel", B=32, rows
41..512 frames long, one of 512, 1..20 labels): for each the median
host time of the last 4 of 6 steps through SGD.train, and one step's
device time under torch.profiler (the sum of its device items' own
time).

Each measurement runs in a process of its own, with the checkout's root
first on sys.path, so each builds and imports its own paddle_tpu_torch; the
processes take turns, ROUNDS times (``--rounds``, 1 by default): the
other checkout, this one, this one, the other. ``--requests`` measures
only the LSTM and GRU forwards' host time a call and the classifier's
requests.
Every input comes from numpy seed 1234, the same in both. Kernel times
are device times: a spin (torch.cuda._sleep) holds the stream while the
host enqueues the calls. Prints the card's name and power limit, a line a
process, then one JSON object.

    python3 tools/torch_ab_checkouts.py OTHER_CHECKOUT [--rounds N]
        [--requests]
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

SEED = 1234
ITERS = 20
GRU_SHAPES = ((32, 512, 128, 256), (64, 100, 512, 25), (256, 30, 512, 30))
XENT_SHAPES = ((7680, 512, 30000), (512, 512, 30000))
LSTM_SHAPES = ((64, 100, 512, 25), (64, 128, 512, 5))
TAGGER = dict(word_dim=5000, label_dim=67, emb_dim=64, hidden=128)
TAGGER_B, TAGGER_T, TAGGER_STEPS = 32, 512, 6
CLASSIFIER = dict(dict_dim=30000, emb_dim=512, hidden=512, num_layers=2)
CLASSIFIER_B, CLASSIFIER_MAX_LEN = 64, 100
CRF_SHAPE = (32, 512, 67)
CTC_SHAPE = (32, 512, 65)
CTC_FEATURES, CTC_CLASSES, CTC_U = 161, 128, 20
POOL_SHAPE = (256, 112, 112, 64)
REQUESTS = 11
HOST_US_BATCHES = (64, 1)
GRU_HOST_US_SHAPES = ((8, 16, 512), (64, 30, 512))


def cuda_ms(fn, iters: int = ITERS) -> float:
    """Mean device time of fn over iters calls, after one warm-up, the
    calls queued behind a spin of as long as one call took (at most 50
    ms)."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    once = time.perf_counter() - t0
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(min(once * iters, 0.05) * 2e9))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def gru_inputs(B, T, H, low, r):
    """x3, Wg, Wc, bias and mask of rows low..T long, on the card."""
    import torch

    lengths = r.randint(low, T + 1, size=B)
    lengths[0] = T
    w = (r.randn(H, 3 * H) / np.sqrt(H)).astype(np.float32)
    arrays = [(r.randn(B, T, 3 * H) * 0.5).astype(np.float32),
              np.ascontiguousarray(w[:, :2 * H]),
              np.ascontiguousarray(w[:, 2 * H:]),
              (r.randn(3 * H) * 0.1).astype(np.float32),
              (np.arange(T)[None] < lengths[:, None]).astype(np.float32)]
    return [torch.from_numpy(a).cuda() for a in arrays]


def xent_inputs(N, D, V, r):
    """x, w, b and labels as chip_smoke.py's phase 9 draws them."""
    import torch

    arrays = [r.randn(N, D).astype(np.float32),
              (r.randn(D, V) / np.sqrt(D)).astype(np.float32),
              (r.randn(V) * 0.1).astype(np.float32), r.randint(0, V, N)]
    return [torch.from_numpy(a).cuda() for a in arrays]


def lstm_fwd_inputs(B, T, H, low, r):
    """x4, W, bias and mask of rows low..T long, and the upstream gradient
    of hs (randn on the valid steps), on the card."""
    import torch

    lengths = r.randint(low, T + 1, size=B)
    lengths[0] = T
    mask = (np.arange(T)[None] < lengths[:, None]).astype(np.float32)
    return [torch.from_numpy(a).cuda() for a in (
        (r.randn(B, T, 4 * H) * 0.5).astype(np.float32),
        (r.randn(H, 4 * H) / np.sqrt(H)).astype(np.float32),
        (r.randn(7 * H) * 0.1).astype(np.float32), mask,
        (r.randn(B, T, H) * mask[..., None]).astype(np.float32))]


def lstm_inputs(B, T, H, low, r):
    """The LSTM backward's inputs on the card: the forward kernel's stash
    of rows low..T long and the upstream gradient of hs."""
    from paddle_tpu_torch.kernels import lstm as tl

    x4, w, bias, mask, g_hs = lstm_fwd_inputs(B, T, H, low, r)
    hs, cs, gates = tl.fused_lstm_fwd(x4, w, bias, mask, stash=True)
    return w, bias, mask, None, gates, hs, cs, g_hs


def crf_inputs(r):
    """crf_bwd's inputs at CRF_SHAPE, as chip_smoke.py's phase 7 draws
    them: em randn, rows T/2..T long (one of T), a (L+2) x L weight of std
    0.5, the forward kernel's alphas, logz and a cotangent randn; and
    start, crf_fwd's other input."""
    import torch

    from paddle_tpu_torch.kernels import crf as tc

    B, T, L = CRF_SHAPE
    lengths = r.randint(T // 2, T + 1, size=B)
    lengths[0] = T
    w = (r.randn(L + 2, L) * 0.5).astype(np.float32)
    em, mask, start, end, trans = [torch.from_numpy(np.ascontiguousarray(
        a)).cuda() for a in (
        r.randn(T, B, L).astype(np.float32),
        (np.arange(T)[:, None] < lengths[None, :]).astype(np.float32),
        w[0], w[1], w[2:])]
    alphas = tc.crf_alphas(em, mask, start, trans)
    ct = torch.from_numpy(r.randn(B).astype(np.float32)).cuda()
    return (em, mask, end, trans, alphas, tc._logz(alphas, end), ct), start


def ctc_inputs(r):
    """ctc_bwd's inputs at CTC_SHAPE: em [T, B, S], the mask, skip, ok,
    beta_init, the forward kernel's alphas and ll."""
    import torch

    from paddle_tpu_torch.kernels import ctc as tk

    B, T, S = CTC_SHAPE
    U = (S - 1) // 2
    lengths = r.randint(T // 4, T + 1, size=B)
    lengths[0] = T
    ulens = r.randint(1, CTC_U + 1, size=B)
    ulens[0] = CTC_U
    labels, label_mask, in_mask, logits = [torch.from_numpy(a).cuda() for a in (
        r.randint(1, CTC_CLASSES, size=(B, U)),
        (np.arange(U)[None] < ulens[:, None]).astype(np.float32),
        (np.arange(T)[None] < lengths[:, None]).astype(np.float32),
        r.randn(B, T, CTC_CLASSES).astype(np.float32))]
    ext, ok, skip, slen = tk.extended_labels(labels, label_mask, 0, S)
    pos = torch.arange(S, device=ext.device)[None, :]
    terminal = (pos == (slen - 1)[:, None]) | (
        (pos == (slen - 2)[:, None]) & (slen >= 2)[:, None])
    em = torch.gather(torch.log_softmax(logits, -1), 2,
                      ext[:, None, :].expand(B, T, S))
    em, mask = em.transpose(0, 1).contiguous(), in_mask.t().contiguous()
    skip, ok = (skip & ok).float(), ok.float()
    beta_init = torch.where(terminal, 0.0, tk.NEG)
    alphas = tk.ctc_alphas(em, mask, skip, ok)
    return em, mask, skip, ok, beta_init, alphas, tk._loglik(alphas,
                                                             beta_init)


def ctc_step(pt, r):
    """The same for the CTC model: TAGGER_STEPS Adam steps of 161 frame
    features -> fc 128 (linear) -> warp_ctc (blank 0) with CTC_IMPL =
    "kernel", B=32 rows of 41..512 frames (one of 512) and 1..20 labels
    (one of 20)."""
    from paddle_tpu_torch.core.layer import layer_name_scope
    from paddle_tpu_torch.layers import crf_ctc

    with layer_name_scope():
        frames = pt.layer.data(
            name="frames",
            type=pt.data_type.dense_vector_sequence(CTC_FEATURES))
        labels = pt.layer.data(
            name="labels",
            type=pt.data_type.integer_value_sequence(CTC_CLASSES))
        out = pt.layer.fc(input=frames, size=CTC_CLASSES,
                          act=pt.activation.Linear())
        cost = pt.layer.warp_ctc(input=out, label=labels, size=CTC_CLASSES,
                                 blank=0)
    weights = draw_weights(pt, cost, r)
    batches = []
    for _ in range(TAGGER_STEPS):
        lens = r.randint(2 * CTC_U + 1, TAGGER_T + 1, size=TAGGER_B)
        lens[0] = TAGGER_T
        ulens = r.randint(1, CTC_U + 1, size=TAGGER_B)
        ulens[0] = CTC_U
        batches.append([(r.randn(k, CTC_FEATURES).astype(np.float32),
                         r.randint(1, CTC_CLASSES, size=u).tolist())
                        for k, u in zip(lens, ulens)])
    old = crf_ctc.CTC_IMPL
    crf_ctc.CTC_IMPL = "kernel"
    try:
        return train_steps(pt, cost, weights, batches,
                           {"frames": 0, "labels": 1})
    finally:
        crf_ctc.CTC_IMPL = old


def classifier_request(pt, r, B=CLASSIFIER_B):
    """The median host time of REQUESTS B-row requests of the LSTM
    classifier at bench_lstm's widths through Inference.infer on the card
    (it returns host numpy: the time includes the device's work), after a
    warm-up."""
    from paddle_tpu_torch.core.layer import layer_name_scope
    from paddle_tpu_torch.models.text import lstm_text_classification

    with layer_name_scope():
        out = lstm_text_classification(**CLASSIFIER)[2]
    weights = draw_weights(pt, out, r)
    lens = r.randint(5, CLASSIFIER_MAX_LEN + 1, size=B)
    lens[0] = CLASSIFIER_MAX_LEN
    batch = [(r.randint(0, CLASSIFIER["dict_dim"], size=k).tolist(),)
             for k in lens]
    inf = pt.Inference(out, pt.Parameters.from_numpy(weights), device="cuda")
    inf.infer(batch)
    ms = []
    for _ in range(REQUESTS):
        t0 = time.perf_counter()
        inf.infer(batch)
        ms.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(ms))


def host_us(fn, calls: int = 200) -> float:
    """The host's microseconds a call of fn, enqueued back to back without
    a synchronize (after one warm-up call): the wrapper's own cost, not
    the device's."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    us = (time.perf_counter() - t0) * 1e6 / calls
    torch.cuda.synchronize()
    return us


def tagger_step(pt, r):
    """The median host time of the last 4 of TAGGER_STEPS Adam steps of
    rnn_crf_tagger through SGD.train, and one step's device time."""
    from paddle_tpu_torch.core.layer import layer_name_scope
    from paddle_tpu_torch.models.text import rnn_crf_tagger

    with layer_name_scope():
        cost = rnn_crf_tagger(**TAGGER)[3]
    weights = draw_weights(pt, cost, r)
    batches = []
    for _ in range(TAGGER_STEPS):
        lens = r.randint(TAGGER_T // 2, TAGGER_T + 1, size=TAGGER_B)
        lens[0] = TAGGER_T
        batches.append([(r.randint(0, TAGGER["word_dim"], size=k).tolist(),
                         r.randint(0, TAGGER["label_dim"], size=k).tolist())
                        for k in lens])
    return train_steps(pt, cost, weights, batches, {"words": 0, "labels": 1})


def classifier_step(pt, r):
    """The same for the LSTM classifier: TAGGER_STEPS Adam steps of
    lstm_text_classification at bench_lstm's widths, B=64 rows of
    5..100 ids (one of 100 a batch, T bucketed to 128), random labels."""
    from paddle_tpu_torch.core.layer import layer_name_scope
    from paddle_tpu_torch.models.text import lstm_text_classification

    with layer_name_scope():
        cost = lstm_text_classification(**CLASSIFIER)[3]
    weights = draw_weights(pt, cost, r)
    batches = []
    for _ in range(TAGGER_STEPS):
        lens = r.randint(5, CLASSIFIER_MAX_LEN + 1, size=CLASSIFIER_B)
        lens[0] = CLASSIFIER_MAX_LEN
        batches.append([(r.randint(0, CLASSIFIER["dict_dim"],
                                   size=k).tolist(), int(r.randint(0, 2)))
                        for k in lens])
    return train_steps(pt, cost, weights, batches, None)


def draw_weights(pt, cost, r):
    """The model's weights from ``r``: std 1/sqrt(fan_in), biases 0.1."""
    weights = {}
    for name, spec in sorted(pt.Topology(cost).param_specs().items()):
        std = 0.1 if spec.is_bias else 1.0 / np.sqrt(spec.fan_in)
        weights[name] = (r.randn(*spec.shape) * std).astype(np.float32)
    return weights


def train_steps(pt, cost, weights, batches, feeding):
    """The median host time of the last 4 Adam steps over ``batches``
    through SGD.train (each step ends in a read of the cost, a device
    sync), and the device time of one more step of the last batch under
    torch.profiler."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from paddle_tpu_torch.trainer import make_train_step
    from paddle_tpu_torch.trainer.feeder import DataFeeder

    topo = pt.Topology(cost)
    trainer = pt.SGD(cost, pt.Parameters.from_numpy(weights),
                     pt.optimizer.Adam(learning_rate=1e-3), device="cuda")
    ms = []

    def handler(ev):
        if isinstance(ev, pt.event.BeginIteration):
            ms.append(time.perf_counter())
        elif isinstance(ev, pt.event.EndIteration):
            ms[-1] = (time.perf_counter() - ms[-1]) * 1e3

    trainer.train(lambda: iter(batches), num_passes=1, event_handler=handler,
                  feeding=feeding)

    optimizer = pt.optimizer.Adam(learning_rate=1e-3)
    step = make_train_step(topo.loss_fn(cost), optimizer, topo.static_map(),
                           topo.lr_mults())
    params = {k: torch.from_numpy(v).cuda() for k, v in weights.items()}
    state = optimizer.init(params)
    feeds = {k: a.to("cuda") for k, a in
             DataFeeder(topo.data_type(), feeding)(batches[-1]).items()}
    float(step(params, state, feeds)[2])
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        float(step(params, state, feeds)[2])
    device_ms = sum(e.self_device_time_total for e in prof.key_averages()
                    if e.device_type == DeviceType.CUDA) / 1e3
    return float(np.median(ms[-4:])), device_ms


def requests(pt, r) -> dict:
    """The LSTM forward's host microseconds a call at HOST_US_BATCHES rows
    of the classifier's T = 128, H = 512, and the GRU forward's at
    GRU_HOST_US_SHAPES, outside and inside inference mode, and the
    classifier's requests of 64 rows and of 1."""
    import torch

    from paddle_tpu_torch.kernels import gru as tg
    from paddle_tpu_torch.kernels import lstm as tl

    out = {}
    for B in HOST_US_BATCHES:
        x4, w, bias, mask, _ = lstm_fwd_inputs(B, 128, 512, 5, r)
        out[f"fused_lstm forward, host us a call {B}x128x512"] = host_us(
            lambda: tl.fused_lstm_fwd(x4, w, bias, mask))
        with torch.inference_mode():
            out[f"fused_lstm forward, host us a call {B}x128x512, "
                "inference mode"] = host_us(
                    lambda: tl.fused_lstm_fwd(x4, w, bias, mask))
        del x4, w, bias, mask
    for B, T, H in GRU_HOST_US_SHAPES:
        args = gru_inputs(B, T, H, T // 4, r)
        out[f"fused_gru forward, host us a call {B}x{T}x{H}"] = host_us(
            lambda: tg.fused_gru_fwd(*args))
        with torch.inference_mode():
            out[f"fused_gru forward, host us a call {B}x{T}x{H}, "
                "inference mode"] = host_us(lambda: tg.fused_gru_fwd(*args))
        del args
    out["lstm classifier request B=64"] = classifier_request(pt, r)
    out["lstm classifier request B=1"] = classifier_request(pt, r, 1)
    return out


def measure(only_requests: bool) -> dict:
    """This process's checkout's times, as one dict: every measurement,
    or only :func:`requests`'."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.kernels import crf as tc
    from paddle_tpu_torch.kernels import ctc as tk
    from paddle_tpu_torch.kernels import gru as tg
    from paddle_tpu_torch.kernels import lstm as tl
    from paddle_tpu_torch.kernels import pool as tp
    from paddle_tpu_torch.kernels import vocab_xent as tv

    r = np.random.RandomState(SEED)
    if only_requests:
        return requests(pt, r)
    out = {}
    for B, T, H, low in GRU_SHAPES:
        args = gru_inputs(B, T, H, low, r)
        out[f"fused_gru forward {B}x{T}x{H}"] = cuda_ms(
            lambda: tg.fused_gru_fwd(*args, stash=True))
        x3, wg, wc, bias, mask = args
        hs, gates = tg.fused_gru_fwd(*args, stash=True)
        g_hs = torch.from_numpy((r.randn(B, T, H) * mask.cpu().numpy()[
            ..., None]).astype(np.float32)).cuda()
        out[f"fused_gru backward recurrence {B}x{T}x{H}"] = cuda_ms(
            lambda: tg.fused_gru_bwd_dx3(wg, wc, mask, None, gates, hs,
                                         g_hs))
    for N, D, V in XENT_SHAPES:
        x, w, b, lab = xent_inputs(N, D, V, r)
        out[f"vocab_xent forward {N}x{D}x{V}"] = cuda_ms(
            lambda: tv.vocab_xent_fwd(x, w, b, lab), 10)
        del x, w, b, lab
    for B, T, H, low in LSTM_SHAPES:
        x4, w, bias, mask, _ = lstm_fwd_inputs(B, T, H, low, r)
        out[f"fused_lstm forward {B}x{T}x{H}"] = cuda_ms(
            lambda: tl.fused_lstm_fwd(x4, w, bias, mask))
        out[f"fused_lstm forward with the stash {B}x{T}x{H}"] = cuda_ms(
            lambda: tl.fused_lstm_fwd(x4, w, bias, mask, stash=True))
        del x4, w, bias, mask
    for B, T, H, low in LSTM_SHAPES:
        args = lstm_inputs(B, T, H, low, r)
        out[f"fused_lstm_bwd (default form) {B}x{T}x{H}"] = cuda_ms(
            lambda: tl.fused_lstm_bwd(*args))
        out[f"fused_lstm_bwd_nodw (split form's recurrence) {B}x{T}x{H}"] = \
            cuda_ms(lambda: tl.fused_lstm_bwd_nodw(*args))
        del args
    args, start = crf_inputs(r)
    out["crf_fwd {}x{}x{}".format(*CRF_SHAPE)] = cuda_ms(
        lambda: tc.crf_alphas(args[0], args[1], start, args[3]))
    out["crf_bwd {}x{}x{}".format(*CRF_SHAPE)] = cuda_ms(
        lambda: tc.crf_bwd(*args))
    del args
    args = ctc_inputs(r)
    out["ctc_fwd {}x{}x{}".format(*CTC_SHAPE)] = cuda_ms(
        lambda: tk.ctc_alphas(*args[:4]))
    out["ctc_bwd (+ marginals) {}x{}x{}".format(*CTC_SHAPE)] = cuda_ms(
        lambda: tk.ctc_bwd(*args))
    del args
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    B, H, W, C = POOL_SHAPE
    x = torch.randn(B, H, W, C, generator=gen, device="cuda")
    dy = torch.randn(B, H // 2, W // 2, C, generator=gen, device="cuda")
    out["maxpool_bwd {}x{}x{}x{}".format(*POOL_SHAPE)] = cuda_ms(
        lambda: tp.maxpool_3x3s2p1_bwd(x, dy))
    del x, dy
    out.update(requests(pt, r))
    host_ms, device_ms = tagger_step(pt, r)
    out["rnn_crf_tagger Adam step"] = host_ms
    out["rnn_crf_tagger step, device"] = device_ms
    host_ms, device_ms = classifier_step(pt, r)
    out["lstm classifier Adam step"] = host_ms
    out["lstm classifier step, device"] = device_ms
    host_ms, device_ms = ctc_step(pt, r)
    out["ctc Adam step"] = host_ms
    out["ctc step, device"] = device_ms
    return out


def main() -> int:
    if len(sys.argv) >= 2 and sys.argv[1] == "--measure":
        import torch

        if not torch.cuda.is_available():
            print("torch_ab_checkouts: no CUDA device", file=sys.stderr)
            return 1
        print(json.dumps(measure("--requests" in sys.argv[2:])))
        return 0
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("other", help="the other checkout's root")
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--requests", action="store_true",
                    help="only the LSTM and GRU forwards' host cost and "
                         "the classifier's requests")
    args = ap.parse_args()
    this = Path(__file__).resolve().parents[1]
    other = Path(args.other).resolve()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    runs = []
    for _ in range(args.rounds):
        for label, root in (("other", other), ("this", this),
                            ("this", this), ("other", other)):
            proc = subprocess.run(
                [sys.executable, "-c",
                 "import runpy, sys; sys.path.insert(0, sys.argv[1]); "
                 "sys.argv = [sys.argv[2], '--measure'] + sys.argv[3:]; "
                 "runpy.run_path(sys.argv[0], run_name='__main__')",
                 str(root), str(Path(__file__).resolve())]
                + (["--requests"] if args.requests else []),
                cwd=root, capture_output=True, text=True, timeout=900)
            if proc.returncode != 0:
                print(proc.stdout, proc.stderr, file=sys.stderr)
                raise SystemExit(f"the {label} checkout's run failed")
            times = json.loads(proc.stdout.strip().splitlines()[-1])
            runs.append(dict(checkout=label, root=str(root), times=times))
            print(f"{label} ({root}): " + ", ".join(
                f"{k} {v:.4f} {'us' if 'host us' in k else 'ms'}"
                for k, v in times.items()), flush=True)
    print(json.dumps({"card": card, "runs": runs}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
