"""Times the port's GRU forward kernels on an NVIDIA GPU: the cluster
kernel (csrc/gru_fwd.cu ``gru_fwd_cluster``) at each number of blocks a
cluster C and rows a cluster R, beside the grid kernel (``gru_fwd``): the
evidence for ``kernels/gru.gru_fwd_plan``.

At the RNN CRF tagger's (B, T, H) = (32, 512, 128) (models/text.py
rnn_crf_tagger's hidden 128 on bench_crf's batches: rows 256..512 long),
and at hidden 256 on the same batches and on (64, 100, 256) (rows 25..100
long), on inputs drawn as chip_smoke.py draws them (numpy seed 1234:
x3 randn * 0.5, W randn / sqrt(H), bias randn * 0.1), it times the grid
kernel and the cluster kernel at every (C, R) of CLUSTERS and ROWS that
it has, each with the training stash, and holds hs and the stash of each
against the plain version's (within 1e-4). Times are device times: a spin
holds the stream while the host enqueues the calls. Prints the card's
name and power limit, a line a setting (ms and us a time step), then one
JSON object.

    python3 tools/torch_gru_fwd_cluster.py
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

# (B, T, H, shortest row)
SHAPES = ((32, 512, 128, 256), (32, 512, 256, 256), (64, 100, 256, 25))
CLUSTERS = (4, 8, 16)
ROWS = (1, 2, 4, 8, 16)
SEED = 1234
ITERS = 20
TOL = 1e-4


def cuda_ms(fn, iters: int = ITERS) -> float:
    """Mean device time of fn over iters calls, after one warm-up, the
    calls queued behind a spin (as chip_smoke.py's cuda_ms)."""
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


def inputs(B, T, H, low):
    """x3, Wg, Wc, bias and mask of a ragged batch (rows low..T long, the
    first T) on the card."""
    r = np.random.RandomState(SEED)
    lengths = r.randint(low, T + 1, size=B)
    lengths[0] = T
    w = (r.randn(H, 3 * H) / np.sqrt(H)).astype(np.float32)
    arrays = [(r.randn(B, T, 3 * H) * 0.5).astype(np.float32),
              np.ascontiguousarray(w[:, :2 * H]),
              np.ascontiguousarray(w[:, 2 * H:]),
              (r.randn(3 * H) * 0.1).astype(np.float32),
              (np.arange(T)[None] < lengths[:, None]).astype(np.float32)]
    return [torch.from_numpy(a).cuda() for a in arrays]


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_gru_fwd_cluster: no CUDA device", file=sys.stderr)
        return 1
    from paddle_tpu_torch.kernels import gru as tg
    from paddle_tpu_torch.utils.error import Error

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(card)
    out = {"card": card, "shapes": []}
    for B, T, H, low in SHAPES:
        args = inputs(B, T, H, low)
        want = tg.fused_gru_plain(*args, with_gates=True)
        chosen = tg.gru_fwd_plan(B, H)
        plans = [tg.grid_plan(H)]
        for C in CLUSTERS:
            for R in ROWS:
                try:
                    plans.append(tg.cluster_plan(H, C, R))
                except Error:
                    pass
        rows = []
        for plan in plans:
            got = tg.fused_gru_fwd(*args, stash=True, plan=plan)
            torch.cuda.synchronize()
            err = max((g - w).abs().max().item() for g, w in zip(got, want))
            if not err <= TOL:
                raise SystemExit(f"{plan} at {(B, T, H)} differs from the "
                                 f"plain version by {err:.3e}")
            ms = cuda_ms(lambda: tg.fused_gru_fwd(*args, stash=True,
                                                  plan=plan))
            rows.append(dict(path=plan.path, C=plan.C, R=plan.R,
                             smem=plan.smem, ms=ms, us_a_step=ms * 1e3 / T,
                             max_abs_err=err))
            mark = " (the plan's choice)" if plan == chosen else ""
            print(f"(B, T, H) = {(B, T, H)} {plan.path} C={plan.C} "
                  f"R={plan.R}{mark}: {ms:.4f} ms, {ms * 1e3 / T:.3f} us a "
                  f"step; hs and stash within {err:.2e} of plain",
                  flush=True)
        out["shapes"].append(dict(B=B, T=T, H=H, chosen=chosen._asdict(),
                                  rows=rows))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
