"""Times the port's sliced vocab_xent kernels against the number of
vocabulary slices S, on an NVIDIA GPU.

At bench_nmt's output projection (bench.py:245: N = 256 x 30, D = 512,
V = 30000; x randn, w randn / sqrt(D), b randn * 0.1, labels uniform,
numpy seed 1234, as chip_smoke.py's phase 9 draws them) it times
``vocab_xent_fwd`` and its combine ``vocab_xent_fwd_reduce`` at each S of
FWD_S, and ``vocab_xent_bwd_dx`` and its sum ``vocab_xent_bwd_dx_reduce``
at each S of DX_S; at the same projection over 512 rows (chip_smoke.py's
second main path) the forward at each S of FWD_S_SLICED. At S = 1 the dx
kernel's one partial is dx itself, so its sum is not needed and is not
counted. Each S's outputs are held against the first S's (the same sums
in another grouping). Times are device times: a spin holds the stream
while the host enqueues the calls. Prints the card's name and power
limit, a line a setting, then one JSON object.

    python3 tools/torch_vocab_xent_slices.py
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

N, D, V = 7680, 512, 30000
FWD_S = (1, 2, 4, 8, 12, 17, 24, 34)
N_SLICED = 512
FWD_S_SLICED = (16, 33, 47, 58, 66, 117)
DX_S = (1, 2, 3, 4, 6)
SEED = 1234
ITERS = 10


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


def fwd_sweep(tv, x, w, b, lab, slices):
    """The forward and its combine at each S of ``slices`` on these rows:
    a row a setting, and (nll, lse) of the first S."""
    rows, ref = [], None
    for S in slices:
        part = tv.vocab_xent_fwd_partials(x, w, b, lab, S)
        nll, lse = tv.vocab_xent_fwd_reduce(part)
        ref = ref if ref is not None else (nll, lse)
        err = max((nll - ref[0]).abs().max().item(),
                  (lse - ref[1]).abs().max().item())
        ms = cuda_ms(lambda: tv.vocab_xent_fwd_partials(x, w, b, lab, S))
        reduce_ms = cuda_ms(lambda: tv.vocab_xent_fwd_reduce(part))
        rows.append(dict(N=x.shape[0], S=S, blocks=-(-x.shape[0] // 64) * S,
                         ms=ms, reduce_ms=reduce_ms, total_ms=ms + reduce_ms,
                         max_abs_err_vs_first=err))
        print(f"  fwd N={x.shape[0]} S={S:3d}: {ms:.4f} ms + combine "
              f"{reduce_ms:.4f} ms = {ms + reduce_ms:.4f} ms; nll/lse vs "
              f"S={slices[0]} {err:.2e}", flush=True)
    return rows, ref


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_vocab_xent_slices: no CUDA device", file=sys.stderr)
        return 1
    from paddle_tpu_torch.kernels import vocab_xent as tv

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(card)
    r = np.random.RandomState(SEED)
    x = r.randn(N, D).astype(np.float32)
    w = (r.randn(D, V) / np.sqrt(D)).astype(np.float32)
    b = (r.randn(V) * 0.1).astype(np.float32)
    labels = r.randint(0, V, N)
    ct = r.randn(N).astype(np.float32)
    x, w, b, lab, ct = [torch.from_numpy(a).cuda()
                        for a in (x, w, b, labels, ct)]
    chosen = dict(fwd=tv.fwd_slices(x, w), dx=tv.dx_slices(x, w))
    print(f"(N, D, V) = {(N, D, V)}; the wrappers choose S = {chosen}")

    fwd, ref = fwd_sweep(tv, x, w, b, lab, FWD_S)
    sliced = fwd_sweep(tv, x[:N_SLICED], w, b, lab[:N_SLICED],
                       FWD_S_SLICED)[0]
    chosen["fwd_sliced"] = tv.fwd_slices(x[:N_SLICED], w)

    lse = ref[1]
    dx_rows, dx_ref = [], None
    for S in DX_S:
        part = tv.vocab_xent_bwd_dx_partials(x, w, b, lab, lse, ct, S)
        dx = part[0] if S == 1 else tv.vocab_xent_bwd_dx_reduce(part)
        dx_ref = dx_ref if dx_ref is not None else dx.clone()
        err = ((dx - dx_ref).abs().max() / dx_ref.abs().max()).item()
        ms = cuda_ms(lambda: tv.vocab_xent_bwd_dx_partials(
            x, w, b, lab, lse, ct, S))
        reduce_ms = 0.0 if S == 1 else cuda_ms(
            lambda: tv.vocab_xent_bwd_dx_reduce(part))
        dx_rows.append(dict(S=S, blocks=-(-N // 64) * S, ms=ms,
                            reduce_ms=reduce_ms, total_ms=ms + reduce_ms,
                            rel_err_vs_S1=err))
        print(f"  dx  S={S:3d}: {ms:.4f} ms + sum {reduce_ms:.4f} ms = "
              f"{ms + reduce_ms:.4f} ms; dx vs S=1 {err:.2e} of its largest",
              flush=True)
        del part, dx

    print(json.dumps(dict(card=card, shape=[N, D, V], chosen=chosen,
                          fwd=fwd, fwd_sliced=sliced, dx=dx_rows)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
