"""Times the port's GRU dW kernel (csrc/gru_bwd.cu ``gru_bwd_dw``, 3xTF32
mma.sync) against the number of splits S of its (row, step) pairs, on an
NVIDIA GPU: the evidence for ``kernels/gru.gru_dw_splits``.

At the two training paths' widths, the NMT encoder's (B, T, H) = (64,
100, 512) and the RNN CRF tagger's (32, 512, 128), on inputs drawn as
chip_smoke.py draws them (numpy seed 1234: a forward kernel's stash, the
recurrence kernel's dx3), it times at each S of SPLITS the dW kernel
alone and, where S > 1, with the sum of its partials
(``gru_bwd_dw_reduce``), and holds each S's (dWg, dWc, db) against S =
1's (the same sums in another grouping, within 1e-5 of their largest
value). Times are device times: a spin holds the stream while the host
enqueues the calls. Prints the card's name and power limit, a line a
setting, then one JSON object.

    python3 tools/torch_gru_dw_splits.py
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

SHAPES = ((64, 100, 512), (32, 512, 128))
SPLITS = (1, 2, 3, 4, 6, 8, 11, 16, 22, 33, 44)
SEED = 1234
ITERS = 20


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


def inputs(B, T, H):
    """dx3, the z|r|c stash and hs of a ragged batch (rows T/4..T long),
    from the GRU kernels themselves."""
    from paddle_tpu_torch.kernels import gru as tg

    r = np.random.RandomState(SEED)
    lengths = np.maximum(1, r.randint(T // 4, T + 1, size=B))
    lengths[0] = T
    mask = (np.arange(T)[None] < lengths[:, None]).astype(np.float32)
    w = (r.randn(H, 3 * H) / np.sqrt(H)).astype(np.float32)
    arrays = [(r.randn(B, T, 3 * H) * 0.5).astype(np.float32),
              np.ascontiguousarray(w[:, :2 * H]),
              np.ascontiguousarray(w[:, 2 * H:]),
              (r.randn(3 * H) * 0.1).astype(np.float32), mask,
              (r.randn(B, T, H) * mask[..., None]).astype(np.float32)]
    x3, wg, wc, b, m, g_hs = (torch.from_numpy(a).cuda() for a in arrays)
    hs, gates = tg.fused_gru_fwd(x3, wg, wc, b, m, None, stash=True)
    dx3 = tg.fused_gru_bwd_dx3(wg, wc, m, None, gates, hs, g_hs)
    return dx3, gates, hs


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_gru_dw_splits: no CUDA device", file=sys.stderr)
        return 1
    from paddle_tpu_torch.kernels import gru as tg

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(card)
    out = {"card": card, "shapes": []}
    for B, T, H in SHAPES:
        dx3, gates, hs = inputs(B, T, H)
        ref = tg.gru_dw_partials(dx3, gates, hs, None, 1)[0]
        scale = max(1.0, ref.abs().max().item())
        chosen = tg.gru_dw_splits(B * T, H)
        rows = []
        for S in SPLITS:
            part = tg.gru_dw_partials(dx3, gates, hs, None, S)
            got = part[0] if S == 1 else tg.gru_dw_reduce(part)
            err = (got - ref).abs().max().item() / scale
            if not err <= 1e-5:
                raise SystemExit(f"S={S} at {(B, T, H)} differs from S=1 by "
                                 f"{err:.3e} of the largest value")
            kernel = cuda_ms(lambda: tg.gru_dw_partials(dx3, gates, hs, None,
                                                        S))
            total = kernel if S == 1 else cuda_ms(
                lambda: tg.gru_dw_reduce(tg.gru_dw_partials(
                    dx3, gates, hs, None, S)))
            rows.append(dict(S=S, kernel_ms=kernel, with_sum_ms=total,
                             rel_err=err))
            mark = " (the wrapper's choice)" if S == chosen else ""
            print(f"(B, T, H) = {(B, T, H)} S={S}{mark}: the dW kernel "
                  f"{kernel:.4f} ms, with its sum "
                  f"{total:.4f} ms; within {err:.2e} of S=1", flush=True)
        out["shapes"].append(dict(B=B, T=T, H=H, chosen=chosen, rows=rows))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
