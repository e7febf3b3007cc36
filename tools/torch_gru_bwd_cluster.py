"""Times the port's GRU backward recurrence kernels on an NVIDIA GPU: the
cluster kernel (csrc/gru_bwd.cu ``gru_bwd_cluster``) at each number of
blocks a cluster C and rows a cluster R, beside the grid kernel
(``gru_bwd``): the evidence for ``kernels/gru.gru_bwd_plan``.

At the RNN CRF tagger's (B, T, H) = (32, 512, 128) (models/text.py
rnn_crf_tagger's hidden 128 on bench_crf's batches: rows 256..512 long),
and at hidden 256 on the same batches and on (64, 100, 256) (rows 25..100
long), on inputs drawn as chip_smoke.py draws them (numpy seed 1234:
x3 randn * 0.5, W randn / sqrt(H), bias randn * 0.1, the upstream
gradient randn on the valid steps), the forward kernel's hs and stash
feed the grid kernel and the cluster kernel at every (C, R) of CLUSTERS
and ROWS that it has; each one's dx3 is held against the plain version's
(within 1e-4 of its largest value) and two launches of each cluster
setting must give the same bits. Times are device times: a spin holds the
stream while the host enqueues the calls. Prints the card's name and
power limit, a line a setting (ms and us a time step), then one JSON
object.

    python3 tools/torch_gru_bwd_cluster.py
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

from torch_gru_fwd_cluster import cuda_ms, inputs  # noqa: E402

# (B, T, H, shortest row)
SHAPES = ((32, 512, 128, 256), (32, 512, 256, 256), (64, 100, 256, 25))
CLUSTERS = (4, 8, 16)
ROWS = (1, 2, 4, 8, 16)
SEED = 1234
RTOL = 1e-4


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_gru_bwd_cluster: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    from paddle_tpu_torch.kernels import gru as tg
    from paddle_tpu_torch.utils.error import Error

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(card)
    out = {"card": card, "shapes": []}
    for B, T, H, low in SHAPES:
        x3, wg, wc, bias, mask = inputs(B, T, H, low)
        hs, gates = tg.fused_gru_fwd(x3, wg, wc, bias, mask, stash=True)
        r = np.random.RandomState(SEED + 1)
        g_hs = torch.from_numpy((r.randn(B, T, H) * mask.cpu().numpy()[
            ..., None]).astype(np.float32)).cuda()
        args = (wg, wc, mask, None, gates, hs, g_hs)
        want = tg.fused_gru_bwd_plain(*args)[0]
        scale = max(1.0, want.abs().max().item())
        chosen = tg.gru_bwd_plan(B, H)
        plans = [tg.bwd_grid_plan(B, H)]
        for C in CLUSTERS:
            for R in ROWS:
                try:
                    plans.append(tg.bwd_cluster_plan(H, C, R))
                except Error:
                    pass
        rows = []
        for plan in plans:
            got = tg.fused_gru_bwd_dx3(*args, plan=plan)
            again = tg.fused_gru_bwd_dx3(*args, plan=plan)
            torch.cuda.synchronize()
            err = (got - want).abs().max().item()
            if not err <= RTOL * scale:
                raise SystemExit(f"{plan} at {(B, T, H)} differs from the "
                                 f"plain version by {err:.3e}")
            if plan.path == "cluster" and not torch.equal(got, again):
                raise SystemExit(f"two launches of {plan} at {(B, T, H)} "
                                 f"differ")
            ms = cuda_ms(lambda: tg.fused_gru_bwd_dx3(*args, plan=plan))
            rows.append(dict(path=plan.path, C=plan.C, R=plan.R,
                             smem=plan.smem, ms=ms, us_a_step=ms * 1e3 / T,
                             max_abs_err=err))
            mark = " (the plan's choice)" if plan == chosen else ""
            print(f"(B, T, H) = {(B, T, H)} {plan.path} C={plan.C} "
                  f"R={plan.R}{mark}: {ms:.4f} ms, {ms * 1e3 / T:.3f} us a "
                  f"step; dx3 within {err:.2e} of plain", flush=True)
        out["shapes"].append(dict(B=B, T=T, H=H, chosen=chosen._asdict(),
                                  rows=rows))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
