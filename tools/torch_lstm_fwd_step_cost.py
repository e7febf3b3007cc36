"""Where a step of the port's LSTM forward (csrc/lstm_fwd.cu
``lstm_fwd_kernel<U>``) goes on an NVIDIA GPU: clock64() sums by phase.

A copy of csrc/ under build/ gets clock64() reads at the phase
boundaries of the committed kernel (inserted at fixed anchors of its
text; the tool stops if one is missing) and thread 0 of every block adds
each phase's cycles over the time loop: the wait for the stage (its
warp's cp.async waits for the two halves of its slice of h_{t-1}), the
product (the two halves' FMAs and issuing the copies), the partial
sums (the warps' sums into shared memory, the barrier, each pair's sum in
warp order), the cell (the gate math and the stores), and grid.sync().
Thread 0 is in warp 0, so the waits are warp 0's. The instrumented build
is launched through the port's wrapper with the plan's blocks, at the
classifier's shapes (inputs as chip_smoke.py's phase 2 draws them: numpy
seed 1234 + case, rows T/4..T long), held against the plain version, and
timed by device time; the clock rate the sums imply is printed beside
them. Prints the card's name and power limit, and per shape the mean over
blocks of each phase's cycles a step.

    python3 tools/torch_lstm_fwd_step_cost.py
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

PHASES = ("wait for the stage", "product", "partial sums", "cell",
          "grid.sync")
CASES = [(64, 100, 512, "ragged"), (64, 128, 512, "ragged"),
         (1, 100, 512, "ragged"), (17, 100, 512, "ragged")]
TIC = "{{ unsigned long long c_ = clock64(); ck[{}] += c_ - ck0; ck0 = c_; }}\n"
SYNC = ("    if (t + 1 < T) grid.sync();  // hs[:, t] complete before any "
        "block\n  }                              // stages it\n")
# (text of the committed source, what it becomes)
PROBES = [
    ("namespace cg = cooperative_groups;\n",
     "namespace cg = cooperative_groups;\n\n"
     "__device__ unsigned long long g_clk[1024][6];\n"),
    ("  StepIn nx = step_inputs(x4, mask, reset, b0 + o_r, o_j, 0, T, H,\n"
     "                          b0 + o_r < B);\n  __syncthreads();\n",
     "  StepIn nx = step_inputs(x4, mask, reset, b0 + o_r, o_j, 0, T, H,\n"
     "                          b0 + o_r < B);\n  __syncthreads();\n"
     "  unsigned long long ck[5] = {0, 0, 0, 0, 0};\n"
     "  const unsigned long long ck_start = clock64();\n"
     "  unsigned long long ck0 = ck_start;\n"),
    ("    if (t > 0) stage_tile(0, t);\n",
     "    if (t > 0) stage_tile(0, t);\n" + TIC.format(1)),
    ("        __syncwarp();        // ... the whole warp's copies of it\n",
     "        __syncwarp();        // ... the whole warp's copies of it\n"
     + TIC.format(0)),
    ("        product<U>(acc, hst, wst, LD4, rg, cl, kb, km);\n",
     "        product<U>(acc, hst, wst, LD4, rg, cl, kb, km);\n"
     + TIC.format(1)),
    ("        cp_async_wait<0>();\n        __syncwarp();\n",
     "        cp_async_wait<0>();\n        __syncwarp();\n" + TIC.format(0)),
    ("        if (i + 1 < tiles) stage_tile(i + 1, t);\n",
     "        if (i + 1 < tiles) stage_tile(i + 1, t);\n" + TIC.format(1)),
    ("          for (int g = 0; g < 4; ++g) s[g] += pq[g * U];\n        }\n"
     "      }\n",
     "          for (int g = 0; g < 4; ++g) s[g] += pq[g * U];\n        }\n"
     "      }\n" + TIC.format(2)),
    ("        cs[bt * H + o_j] = c_t;\n      }\n    }\n",
     "        cs[bt * H + o_j] = c_t;\n      }\n    }\n" + TIC.format(3)),
    (SYNC,
     SYNC.replace("  }                              // stages it\n", "")
     + TIC.format(4) + "  }\n"
     "  if (threadIdx.x == 0) {\n"
     "    unsigned long long* o = g_clk[blockIdx.y * gridDim.x + "
     "blockIdx.x];\n"
     "    for (int i = 0; i < 5; ++i) o[i] = ck[i];\n"
     "    o[5] = clock64() - ck_start;\n  }\n"),
    ("extern \"C\" {\n",
     "extern \"C\" {\n\nint lstm_fwd_clocks(unsigned long long* out, int n) "
     "{\n  return (int)cudaMemcpyFromSymbol(out, g_clk, "
     "sizeof(unsigned long long) * 6 * n);\n}\n"),
]


def instrumented(src: str) -> str:
    for old, new in PROBES:
        if src.count(old) != 1:
            raise SystemExit(f"csrc/lstm_fwd.cu: the anchor {old!r} is not "
                             f"there once; update this tool")
        src = src.replace(old, new)
    return src


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_lstm_fwd_step_cost: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    from paddle_tpu_torch.kernels import _build
    from paddle_tpu_torch.kernels import lstm as tl

    print(cs.card_line(), flush=True)
    copy = ROOT / "build" / "lstm_fwd_step_cost"
    copy.mkdir(parents=True, exist_ok=True)
    for f in _build.CSRC.glob("*.cuh"):
        shutil.copy(f, copy)
    (copy / "lstm_fwd.cu").write_text(
        instrumented((_build.CSRC / "lstm_fwd.cu").read_text()))
    args = {}
    for i, (B, T, H, kind) in enumerate(CASES):
        r = np.random.RandomState(i)
        lengths = np.maximum(1, r.randint(T // 4, T + 1, size=B))
        lengths[0] = T
        args[(B, T, H)] = cs.lstm_args(B, T, H, lengths, False, cs.SEED + i)
    _build.CSRC = copy
    _build._libs.clear()
    tl._FWD._lib = None
    out = {"card": cs.card_line(), "shapes": []}
    for (B, T, H), a in args.items():
        want = tl.fused_lstm_plain(*a)
        ms = cs.cuda_ms(lambda: tl.fused_lstm_fwd(*a), 20)
        got = tl.fused_lstm_fwd(*a)
        torch.cuda.synchronize()
        err = max((g - w).abs().max().item() for g, w in zip(got, want))
        if not err <= cs.KERNEL_ATOL:
            raise SystemExit(f"the instrumented kernel is off the plain "
                             f"version at {(B, T, H)}: {err:.3e}")
        plan = tl.lstm_fwd_plan(B, H)
        buf = (ctypes.c_ulonglong * (6 * plan.blocks))()
        fn = _build._libs["lstm_fwd"].lstm_fwd_clocks
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int]
        if fn(ctypes.addressof(buf), plan.blocks) != 0:
            raise SystemExit("reading the clock sums failed")
        c = np.array(buf, dtype=np.float64).reshape(plan.blocks, 6) / T
        step = c.mean(0)
        ghz = step[5] * T / (ms * 1e-3) / 1e9
        print(f"(B, T, H) = {(B, T, H)}, U={plan.U} R={plan.R}: {ms:.4f} ms, "
              f"{ms * 1e3 / T:.3f} us a step, {step[5]:.0f} cycles a step "
              f"({ghz:.3f} GHz): " + ", ".join(
                  f"{n} {v:.0f} ({100 * v / step[5]:.1f}%)"
                  for n, v in zip(PHASES, step)), flush=True)
        out["shapes"].append(dict(B=B, T=T, H=H, ms=ms, ghz=ghz, cycles=dict(
            zip(PHASES + ("all",), step.tolist()))))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
