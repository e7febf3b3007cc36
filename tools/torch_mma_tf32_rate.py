"""Measures what ``mma.sync.m16n8k8`` with TF32 operands gives on the
card: its rate with 8 independent accumulators a warp at 4, 8 and 16
warps an SM (one block an SM, every SM), and its latency as one chain of
dependent MMAs in one warp. The ceiling of the port's tensor-core
``vocab_xent_bwd_dw`` kernel (csrc/vocab_xent.cu), which issues nothing
else on the tensor cores, against the published 495 TFLOP/s dense TF32 of
an H100 SXM (a rate for its warpgroup MMA). Builds tools/mma_tf32_rate.cu
with nvcc into build/, prints the card's name and power limit, a line a
setting, then one JSON object.

    python3 tools/torch_mma_tf32_rate.py
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

ITERS = 4096
FLOPS_PER_MMA = 2 * 16 * 8 * 8


def build() -> ctypes.CDLL:
    from paddle_tpu_torch.kernels import _build

    out = ROOT / "build" / "tools" / "libmma_tf32_rate.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(out),
                    str(ROOT / "tools" / "mma_tf32_rate.cu")], check=True,
                   timeout=300)
    lib = ctypes.CDLL(str(out))
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.mma_tf32_rate.argtypes = [P, P, I, I, I, I, P]
    lib.mma_tf32_rate.restype = I
    return lib


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_mma_tf32_rate: no CUDA device", file=sys.stderr)
        return 1
    from chip_smoke import TF32_FLOPS_PER_S, card_line, cuda_ms

    card = card_line()
    print(card)
    lib = build()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    fragments = torch.randint(0, 2**31 - 1, (256,), dtype=torch.int32,
                              device="cuda")
    out = torch.empty(sms * 1024, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream

    def run(blocks, warps, chains):
        err = lib.mma_tf32_rate(fragments.data_ptr(), out.data_ptr(), blocks,
                                32 * warps, chains, ITERS, stream)
        if err:
            raise SystemExit(f"mma_tf32_rate launch failed: {err}")

    rows = []
    for warps in (4, 8, 16):
        ms = cuda_ms(lambda: run(sms, warps, 8), 5)
        flops = sms * warps * 8 * ITERS * FLOPS_PER_MMA
        rate = flops / ms / 1e9
        rows.append(dict(warps_per_sm=warps, chains=8, ms=ms,
                         tflops=rate, share_of_peak=rate * 1e12
                         / TF32_FLOPS_PER_S))
        print(f"  {warps:2d} warps an SM x 8 chains: {rate:.1f} TFLOP/s "
              f"({rate * 1e12 / TF32_FLOPS_PER_S:.3f} of "
              f"{TF32_FLOPS_PER_S / 1e12:.0f})", flush=True)
    ms = cuda_ms(lambda: run(1, 1, 1), 5)
    latency_ns = ms * 1e6 / ITERS
    print(f"  one warp, one chain: {latency_ns:.2f} ns an MMA "
          f"(dependent)", flush=True)
    print(json.dumps(dict(card=card, sms=sms, iters=ITERS, rate=rows,
                          dependent_mma_ns=latency_ns)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
