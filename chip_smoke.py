#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/H100 port (paddle_tpu_torch).

    python3 chip_smoke.py

Needs one CUDA GPU (Hopper: the kernels build for sm_90a) and nvcc; run
from the root of a checkout. It exits nonzero, and prints no result,
without a CUDA device or outside the repository. Phases:

1. the card's name and power limit; build every kernel from csrc/;
2. kernels: each kernel against its plain PyTorch version on the card, at
   the shapes the main path gives it and a few more, with times;
3. the slice: the LSTM text classifier at full width (dict 30000, emb
   128, hidden 512, 2 layers; weights random from a seed) serves four
   request batches through ``paddle_tpu_torch.infer`` on the card; the
   logits are held against the port's CPU run, and the launch counts
   show the main path went through the kernels; one request runs again
   under torch.profiler to show where its time goes.

The line before the last is one JSON object with every kernel's numbers;
the last is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

# float32 products on the card run in full float32: the plain versions
# and the CPU reference then do the same arithmetic as the kernels
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

# an H100 SXM's published peaks (dense): memory rate and float32 rate
# outside the tensor cores, the units of each kernel's bound
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12

# kernel vs plain version on the card: both float32, the sums over H run
# in another order; over T=100 steps the gap stays near 1e-6
KERNEL_ATOL = 1e-4
# port on the card vs the port on the CPU: two recurrences, a pooling
# and an fc, every sum in another order
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)

DICT, EMB, HIDDEN, LAYERS = 30000, 128, 512, 2
REQUEST_BATCHES = (64, 1, 17, 64)
SEED = 1234


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int) -> float:
    """Mean device time of fn over iters calls, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def lstm_inputs(B, T, H, lengths, with_reset, seed):
    r = np.random.RandomState(seed)
    mask = (np.arange(T)[None] < np.asarray(lengths)[:, None])
    arrays = [(r.randn(B, T, 4 * H) * 0.5).astype(np.float32),
              (r.randn(H, 4 * H) / np.sqrt(H)).astype(np.float32),
              (r.randn(7 * H) * 0.1).astype(np.float32),
              mask.astype(np.float32)]
    if with_reset:
        arrays.append((r.rand(B, T) < 0.1).astype(np.float32) * arrays[3])
    return [torch.from_numpy(a).cuda() for a in arrays]


def lstm_bound(x4, w, bias, mask, reset):
    """Least time an H100 needs for fused_lstm on these inputs: the
    recurrent product's 2*H*4H flops for every valid (row, step), in
    float32 on the CUDA cores (the gate math adds under 1% at H=512),
    against reading each input once and writing hs and cs once."""
    B, T, H4 = x4.shape
    H = H4 // 4
    flops = 2.0 * H * H4 * float(mask.sum().item())
    nbytes = 4.0 * (x4.numel() + w.numel() + bias.numel() + mask.numel()
                    + (reset.numel() if reset is not None else 0)
                    + 2 * B * T * H)
    t_ops = flops / F32_FLOPS_PER_S * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes")


def make_requests(bucket):
    r = np.random.RandomState(SEED)
    batches = []
    for B in REQUEST_BATCHES:
        lens = r.randint(5, 101, size=B)
        lens[0] = 100
        batches.append([(r.randint(0, DICT, size=n).tolist(),)
                        for n in lens])
    shapes = [(len(b), bucket(max(len(s[0]) for s in b), True)) for b in
              batches]
    return batches, shapes


def kernel_phase(fused_lstm, fused_lstm_plain, main_shapes):
    """fused_lstm against fused_lstm_plain on the card. Returns the row of
    the (64, 100, 512) case, the shape PERF.md reports."""
    cases = [(64, 100, 512, "ragged"), (5, 37, 128, "reset"),
             (1, 100, 512, "full")]
    cases += [(B, T, HIDDEN, "main path") for B, T in main_shapes]
    report = None
    print("kernel fused_lstm vs fused_lstm_plain "
          f"(pass: max_abs_err <= {KERNEL_ATOL})")
    for i, (B, T, H, kind) in enumerate(cases):
        r = np.random.RandomState(i)
        lengths = np.full(B, T) if kind == "full" else \
            np.maximum(1, r.randint(T // 4, T + 1, size=B))
        lengths[0] = T
        args = lstm_inputs(B, T, H, lengths, kind == "reset", SEED + i)
        if len(args) == 4:
            args.append(None)
        hs, cs = fused_lstm(*args)
        torch.cuda.synchronize()
        hp, cp = fused_lstm_plain(*args)
        err = max((hs - hp).abs().max().item(), (cs - cp).abs().max().item())
        ok = bool(np.isfinite(err)) and err <= KERNEL_ATOL
        ms = cuda_ms(lambda: fused_lstm(*args), 20)
        plain_ms = cuda_ms(lambda: fused_lstm_plain(*args), 3)
        bound_ms, bound_by = lstm_bound(*args)
        print(f"  B={B} T={T} H={H} {kind}: max_abs_err={err:.3e} "
              f"ms={ms:.4f} plain_ms={plain_ms:.4f} bound_ms={bound_ms:.4f} "
              f"({bound_by}) {'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            raise SystemExit(f"fused_lstm disagrees with its plain version "
                             f"at B={B} T={T} H={H}: {err}")
        if (B, T, H) == (64, 100, 512):
            report = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                          bound_ms=bound_ms, bound_by=bound_by)
    return report


def where_time_goes(on_card, batch):
    """One request under torch.profiler: device time by kernel, and the
    device's busy share of the request's wall time (the profiler's own
    overhead lengthens that wall time)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        on_card.infer(batch)
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = sorted(((e.self_device_time_total / 1e3, e.count, e.key)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA), reverse=True)
    busy = sum(r[0] for r in rows)
    print(f"where the time goes, one B={len(batch)} request under the "
          f"profiler: wall {wall_ms:.3f} ms, device busy {busy:.3f} ms "
          f"({100 * busy / wall_ms:.1f}%)")
    for ms, n, key in rows[:8]:
        print(f"  {ms:9.3f} ms  x{n:<4d} {key[:80]}")


def slice_phase(pt, kernels, requests):
    """The full-width classifier serving the request batches on the card;
    returns the launch counts of that run."""
    from paddle_tpu_torch.core.layer import layer_name_scope
    from paddle_tpu_torch.models.text import lstm_text_classification

    with layer_name_scope():
        out = lstm_text_classification(dict_dim=DICT, emb_dim=EMB,
                                       hidden=HIDDEN, num_layers=LAYERS)[2]
    topo = pt.Topology(out)
    r = np.random.RandomState(SEED)
    weights = {name: (r.randn(*spec.shape) * (
        0.1 if spec.is_bias else 1.0 / np.sqrt(spec.fan_in)))
        .astype(np.float32)
        for name, spec in sorted(topo.param_specs().items())}
    params = pt.Parameters.from_numpy(weights)
    on_card = pt.Inference(out, params, device="cuda")
    on_cpu = pt.Inference(out, params, device="cpu")
    on_card.infer(requests[1])                 # warm-up (cuBLAS, allocator)
    torch.cuda.synchronize()

    kernels.reset_launch_counts()
    results = []
    for batch in requests:
        before = dict(kernels.launches)
        t0 = time.perf_counter()
        logits = on_card.infer(batch)          # returns host numpy: synced
        ms = (time.perf_counter() - t0) * 1e3
        rose = kernels.launches["fused_lstm"] - before["fused_lstm"]
        results.append((batch, logits, ms, rose))
    counts = dict(kernels.launches)

    for batch, logits, ms, rose in results:
        ref = on_cpu.infer(batch)
        err = float(np.abs(logits - ref).max())
        print(f"  batch B={len(batch)}: {ms:.3f} ms on the card, "
              f"fused_lstm launches +{rose}, max |logit - cpu| = {err:.3e}")
        if logits.shape != (len(batch), 2) or not np.isfinite(logits).all():
            raise SystemExit(f"bad logits: shape {logits.shape}")
        if not np.allclose(logits, ref, **LOGIT_TOL):
            raise SystemExit(f"card and CPU logits differ by {err}")
        if rose != LAYERS:
            raise SystemExit(f"fused_lstm launched {rose} times for one "
                             f"batch, expected {LAYERS}")
    where_time_goes(on_card, requests[0])
    return counts


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import kernels
    from paddle_tpu_torch.kernels import _build
    from paddle_tpu_torch.kernels.lstm import fused_lstm, fused_lstm_plain
    from paddle_tpu_torch.trainer.feeder import _bucket

    # phase 1: the card and the build
    print(card_line(), flush=True)
    t0 = time.perf_counter()
    _build.build(kernels.SOURCES)
    print(f"built {list(kernels.SOURCES)} in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    for name in kernels.SOURCES:
        log = _build.library_path(name).with_suffix(".log")
        for line in log.read_text().splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")

    # phase 2: kernels against their plain versions
    requests, main_shapes = make_requests(_bucket)
    lstm = kernel_phase(fused_lstm, fused_lstm_plain, sorted(set(main_shapes)))

    # phase 3: the main path
    print(f"slice: lstm_text_classification {DICT}/{EMB}/{HIDDEN} x{LAYERS}"
          f" serving batches {list(REQUEST_BATCHES)}", flush=True)
    counts = slice_phase(pt, kernels, requests)
    for name, n in counts.items():
        if n == 0:
            raise SystemExit(f"kernel {name} never launched on the main path")

    print(json.dumps({"kernels": [{
        "name": "fused_lstm", "route": "cuda",
        "source": "paddle_tpu_torch/csrc/lstm_fwd.cu",
        "replaces": "paddle_tpu/kernels/lstm.py:142",
        "launches": counts["fused_lstm"],
        "max_abs_err": lstm["max_abs_err"], "ms": lstm["ms"],
        "plain_ms": lstm["plain_ms"], "bound_ms": lstm["bound_ms"],
        "bound_by": lstm["bound_by"], "library_ms": None}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
