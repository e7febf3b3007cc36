"""Where a step of the port's CRF beta recursion (csrc/crf.cu
``crf_bwd_kernel<K>``, one warp a batch row) goes on an NVIDIA GPU:
clock64() sums by phase.

A copy of csrc/ under build/ gets clock64() reads at the phase
boundaries of the committed kernel (inserted at fixed anchors of its
text; the tool stops if one is missing) and lane 0 of every warp adds
each phase's cycles over the time loop: the set-up (exp(trans - mt) into
shared memory, once), then per step the inputs and stores (the next
step's em and mask in flight, the betas stored), the max (v = em + beta
and its warp max by shuffles), the exps (exp(v - mx) into shared memory
between two __syncwarp()), the product (the lane's K dot products over
the float4 columns) and the log. The instrumented build is launched
through the port's wrapper at the taggers' (B, T, L) = (32, 512, 67)
with bench_crf's rows, 256..512 long (inputs as chip_smoke.py's phase 7
draws them: numpy seed 1234), and at (4, 64, 169) (K = 6), held against
the plain version and timed by device time. Row 0 is T long, so its
warp runs a product at each of its T - 1 steps; the tool prints its
cycles a step by phase, the set-up's, and the clock rate they imply.
Prints the card's name and power limit first.

    python3 tools/torch_crf_bwd_step_cost.py
"""

from __future__ import annotations

import ctypes
import json
import shutil
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

PHASES = ("inputs and stores", "max", "exps", "product", "log")
CASES = [(32, 512, 67), (4, 64, 169)]
TIC = "{{ unsigned long long c_ = clock64(); ck[{}] += c_ - ck0; ck0 = c_; }}\n"
GATE = ("    if (t > 0 && m > 0.f) {              // m is the same for the "
        "whole warp\n")
# (text of the committed source, what it becomes); ck[0] is the set-up,
# ck[1..5] the phases of PHASES
PROBES = [
    ("namespace {\n\n__device__ __forceinline__ float warp_max",
     "__device__ unsigned long long g_clk[65536][7];\n\nnamespace {\n\n"
     "__device__ __forceinline__ float warp_max"),
    ("  const size_t step = (size_t)B * L;\n\n  float mt = -INFINITY;\n",
     "  const size_t step = (size_t)B * L;\n"
     "  unsigned long long ck[6] = {0, 0, 0, 0, 0, 0};\n"
     "  const unsigned long long ck_start = clock64();\n"
     "  unsigned long long ck0 = ck_start;\n\n  float mt = -INFINITY;\n"),
    ("  const float4* ev4 = reinterpret_cast<const float4*>(ev);\n"
     "  for (int t = T - 1; t >= 0; --t) {\n",
     "  const float4* ev4 = reinterpret_cast<const float4*>(ev);\n"
     + TIC.format(0) + "  for (int t = T - 1; t >= 0; --t) {\n"),
    (GATE, TIC.format(1) + GATE),
    ("      mx = warp_max(mx);\n", "      mx = warp_max(mx);\n"
     + TIC.format(2)),
    ("        if (live[k]) ev[lane + 32 * k] = expf(v[k] - mx);\n"
     "      __syncwarp();\n",
     "        if (live[k]) ev[lane + 32 * k] = expf(v[k] - mx);\n"
     "      __syncwarp();\n" + TIC.format(3)),
    ("          p[k][3] = fmaf(x.w, w.w, p[k][3]);\n        }\n      }\n",
     "          p[k][3] = fmaf(x.w, w.w, p[k][3]);\n        }\n      }\n"
     + TIC.format(4)),
    ("                             1e-30f)) + mx + mt;\n    }\n  }\n}\n",
     "                             1e-30f)) + mx + mt;\n" + TIC.format(5)
     + "    }\n  }\n  if (lane == 0) {\n"
     "    for (int i = 0; i < 6; ++i) g_clk[blockIdx.x][i] = ck[i];\n"
     "    g_clk[blockIdx.x][6] = clock64() - ck_start;\n  }\n}\n"),
    ("extern \"C\" {\n",
     "extern \"C\" {\n\nint crf_bwd_clocks(unsigned long long* out, int n) "
     "{\n  return (int)cudaMemcpyFromSymbol(out, g_clk, "
     "sizeof(unsigned long long) * 7 * n);\n}\n"),
]


def instrumented(src: str) -> str:
    for old, new in PROBES:
        if src.count(old) != 1:
            raise SystemExit(f"csrc/crf.cu: the anchor {old!r} is not there "
                             f"once; update this tool")
        src = src.replace(old, new)
    return src


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_crf_bwd_step_cost: no CUDA device", file=sys.stderr)
        return 1
    from paddle_tpu_torch.kernels import _build
    from paddle_tpu_torch.kernels import crf as tk

    print(cs.card_line(), flush=True)
    copy = ROOT / "build" / "crf_bwd_step_cost"
    copy.mkdir(parents=True, exist_ok=True)
    for f in _build.CSRC.glob("*.cuh"):
        shutil.copy(f, copy)
    (copy / "crf.cu").write_text(
        instrumented((_build.CSRC / "crf.cu").read_text()))
    args = {}
    for i, (B, T, L) in enumerate(CASES):
        r = np.random.RandomState(i)
        lengths = r.randint(T // 2, T + 1, size=B)
        lengths[0] = T
        args[(B, T, L)] = cs.crf_inputs(B, T, L, lengths, cs.SEED + i)
    _build.CSRC = copy
    _build._libs.clear()
    tk._BWD._lib = None
    out = {"card": cs.card_line(), "shapes": []}
    for (B, T, L), (em, mask, start, end, trans) in args.items():
        want = tk.crf_betas_plain(em, mask, end, trans)
        ms = cs.cuda_ms(lambda: tk.crf_betas(em, mask, end, trans), 20)
        got = tk.crf_betas(em, mask, end, trans)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        if not err <= cs.CRF_FWD_RTOL * max(1.0, want.abs().max().item()):
            raise SystemExit(f"the instrumented kernel is off the plain "
                             f"version at {(B, T, L)}: {err:.3e}")
        buf = (ctypes.c_ulonglong * (7 * B))()
        fn = _build._libs["crf"].crf_bwd_clocks
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int]
        if fn(ctypes.addressof(buf), B) != 0:
            raise SystemExit("reading the clock sums failed")
        row = np.array(buf, dtype=np.float64).reshape(B, 7)[0]
        step = row[1:6] / (T - 1)
        ghz = row[6] / (ms * 1e-3) / 1e9
        print(f"(B, T, L) = {(B, T, L)}: {ms:.4f} ms, row 0 {row[6]:.0f} "
              f"cycles ({ghz:.3f} GHz over the kernel's time), set-up "
              f"{row[0]:.0f}, a step {step.sum():.0f}: " + ", ".join(
                  f"{n} {v:.0f} ({100 * v / step.sum():.1f}%)"
                  for n, v in zip(PHASES, step)), flush=True)
        out["shapes"].append(dict(B=B, T=T, L=L, ms=ms, ghz=ghz,
                                  setup=row[0], cycles=dict(
                                      zip(PHASES, step.tolist()))))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
