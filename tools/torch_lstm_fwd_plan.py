"""Times the port's LSTM forward (csrc/lstm_fwd.cu ``lstm_fwd``) on an
NVIDIA GPU at each number of units U and rows R a block that fits, and the
4-unit kernel that stages every row (R = 0): the evidence for
``kernels/lstm.lstm_fwd_plan``.

At the classifier's training shape (B, T, H) = (64, 128, 512) (bench_lstm:
B = 64, hidden 512; rows 5..100 long, T bucketed to 128), at (64, 100,
512) (rows 25..100 long, the shape PERF.md reports) and at its serving
batches of 1 and 17 rows (T = 100, rows 25..100 long), on inputs drawn as
chip_smoke.py draws them (numpy seed 1234: x4 randn * 0.5, W randn /
sqrt(H), bias randn * 0.1), the forward runs at every (U, R) of UNITS and
rows a multiple of 256 / U whose blocks fit an H100 at once, with the
stash (training's launch) and without (serving's). Each (hs, cs, stash) is
held against the plain version's (within 1e-4) and two launches must give
the same bits. Times are device times: a spin holds the stream while the
host enqueues the calls. Prints the card's name and power limit, a line a
setting (ms, us a time step, blocks; the plan's choice marked), then one
JSON object.

    python3 tools/torch_lstm_fwd_plan.py
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
sys.path.insert(0, str(Path(__file__).resolve().parent))

from torch_gru_fwd_cluster import cuda_ms  # noqa: E402

# (B, T, H, shortest row)
SHAPES = ((64, 128, 512, 5), (64, 100, 512, 25), (1, 100, 512, 25),
          (17, 100, 512, 25))
UNITS = (16, 8, 4)
SEED = 1234
ATOL = 1e-4


def inputs(B, T, H, low):
    """x4, W, bias and mask, on the card."""
    r = np.random.RandomState(SEED)
    lengths = r.randint(low, T + 1, size=B)
    lengths[0] = T
    arrays = [(r.randn(B, T, 4 * H) * 0.5).astype(np.float32),
              (r.randn(H, 4 * H) / np.sqrt(H)).astype(np.float32),
              (r.randn(7 * H) * 0.1).astype(np.float32),
              (np.arange(T)[None] < lengths[:, None]).astype(np.float32)]
    return [torch.from_numpy(a).cuda() for a in arrays]


def plans(B, H, tl, Error):
    """Every plan the kernels have at (B, H): each (U, R) that fits, and
    the 4-unit kernel's."""
    out = []
    for U in UNITS:
        rt = 256 // U
        for R in [0] + list(range(rt, -(-B // rt) * rt + 1, rt)):
            try:
                out.append(tl.fwd_plan(B, H, U, R))
            except Error:
                pass
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_lstm_fwd_plan: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    from paddle_tpu_torch.kernels import lstm as tl
    from paddle_tpu_torch.utils.error import Error

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(card)
    out = {"card": card, "shapes": []}
    for B, T, H, low in SHAPES:
        x4, w, bias, mask = inputs(B, T, H, low)
        want = tl.fused_lstm_plain(x4, w, bias, mask, with_gates=True)
        chosen = tl.lstm_fwd_plan(B, H)
        rows = []
        for plan in plans(B, H, tl, Error):
            got = tl.fused_lstm_fwd(x4, w, bias, mask, stash=True, plan=plan)
            again = tl.fused_lstm_fwd(x4, w, bias, mask, stash=True,
                                      plan=plan)
            torch.cuda.synchronize()
            err = max((g - r).abs().max().item() for g, r in zip(got, want))
            if not err <= ATOL:
                raise SystemExit(f"{plan} at {(B, T, H)} differs from the "
                                 f"plain version by {err:.3e}")
            if not all(torch.equal(g, a) for g, a in zip(got, again)):
                raise SystemExit(f"two launches of {plan} at {(B, T, H)} "
                                 f"differ")
            ms = cuda_ms(lambda: tl.fused_lstm_fwd(x4, w, bias, mask,
                                                   plan=plan))
            ms_stash = cuda_ms(lambda: tl.fused_lstm_fwd(
                x4, w, bias, mask, stash=True, plan=plan))
            rows.append(dict(plan._asdict(), ms=ms, ms_stash=ms_stash,
                             us_a_step=ms * 1e3 / T, max_abs_err=err))
            mark = " (the plan's choice)" if plan == chosen else ""
            print(f"(B, T, H) = {(B, T, H)} U={plan.U} R={plan.R} "
                  f"{plan.blocks} blocks{mark}: {ms:.4f} ms, "
                  f"{ms * 1e3 / T:.3f} us a step; with the stash "
                  f"{ms_stash:.4f} ms; within {err:.2e} of plain",
                  flush=True)
        best = min(rows, key=lambda row: row["ms"])
        print(f"(B, T, H) = {(B, T, H)}: the fastest U={best['U']} "
              f"R={best['R']}, the plan's U={chosen.U} R={chosen.R}",
              flush=True)
        out["shapes"].append(dict(B=B, T=T, H=H, chosen=chosen._asdict(),
                                  rows=rows))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
