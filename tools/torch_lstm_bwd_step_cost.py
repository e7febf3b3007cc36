"""Where a step of the port's LSTM backward recurrence (csrc/lstm_bwd.cu
``lstm_bwd``) goes on an NVIDIA GPU: clock64() sums by phase.

A copy of csrc/ under build/ gets clock64() reads at the phase
boundaries of the committed kernel (inserted at fixed anchors of its
text; the tool stops if one is missing) and thread 0 of every block adds
each phase's cycles over the time loop: the wait for a chunk of dpre
(cp.async wait and the barrier after it), the product (the chunks' FMAs,
their copies' issue and the barrier that frees a stage), the k-part sums
(shuffles, the warps' sums and the barrier between), the cell gradient,
and grid.sync(). The instrumented build is launched through the port's
wrapper with the plan's blocks, at the shapes of chip_smoke.py's phase 2
(inputs as it draws them: numpy seed 1234 + case, rows T/4..T long, all T
in the case "full"), held against the plain version, and timed by device
time; the clock rate the sums imply is printed beside them. Where a
block holds one tile of rows the phases are exact; with several, a
tile's cell gradient falls in the next tile's product. The
instrumented kernel is some 5% slower than the committed one. Prints the
card's name and power limit, and per shape the mean over blocks of each
phase's cycles a step.

    python3 tools/torch_lstm_bwd_step_cost.py
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

PHASES = ("wait for a chunk", "product", "k-part sums", "cell", "grid.sync")
CASES = [(64, 100, 512, "ragged"), (1, 100, 512, "full"),
         (64, 128, 512, "ragged"), (200, 30, 512, "ragged")]
TIC = "{{ unsigned long long c_ = clock64(); ck[{}] += c_ - ck0; ck0 = c_; }}\n"
SYNC = ("    if (t > 0) grid.sync();  // dx4[:, t] complete before any block "
        "reads it\n")
# (text of the committed source, what it becomes)
PROBES = [
    ("namespace cg = cooperative_groups;\n",
     "namespace cg = cooperative_groups;\n\n"
     "__device__ unsigned long long g_clk[1024][6];\n"),
    ("                          T - 1, T, H, b0 + o_r < B);\n"
     "  __syncthreads();\n",
     "                          T - 1, T, H, b0 + o_r < B);\n"
     "  __syncthreads();\n"
     "  unsigned long long ck[5] = {0, 0, 0, 0, 0};\n"
     "  const unsigned long long ck_start = clock64();\n"
     "  unsigned long long ck0 = ck_start;\n"),
    ("          if (q + NS - 1 < total) stage(q + NS - 1, t);\n"
     "          cp_async_commit();\n",
     "          if (q + NS - 1 < total) stage(q + NS - 1, t);\n"
     "          cp_async_commit();\n" + TIC.format(1)),
    ("          __syncthreads();          // ... everyone's\n",
     "          __syncthreads();          // ... everyone's\n" + TIC.format(0)),
    ("          __syncthreads();          // the stage takes chunk q + NS "
     "next\n        }\n",
     "          __syncthreads();          // the stage takes chunk q + NS "
     "next\n        }\n" + TIC.format(1)),
    ("        dh = (s + dhp_s[pr]) * (1.f - x.rn);\n",
     "        dh = (s + dhp_s[pr]) * (1.f - x.rn);\n" + TIC.format(2)),
    ("        out[3 * H + o_j] = d_o;\n      }\n    }\n" + SYNC + "  }\n",
     "        out[3 * H + o_j] = d_o;\n      }\n    }\n" + TIC.format(3)
     + SYNC + TIC.format(4) + "  }\n"
     "  if (threadIdx.x == 0) {\n"
     "    unsigned long long* o = g_clk[blockIdx.y * gridDim.x + "
     "blockIdx.x];\n"
     "    for (int i = 0; i < 5; ++i) o[i] = ck[i];\n"
     "    o[5] = clock64() - ck_start;\n  }\n"),
    ("extern \"C\" {\n",
     "extern \"C\" {\n\nint lstm_bwd_clocks(unsigned long long* out, int n) "
     "{\n  return (int)cudaMemcpyFromSymbol(out, g_clk, "
     "sizeof(unsigned long long) * 6 * n);\n}\n"),
]


def instrumented(src: str) -> str:
    for old, new in PROBES:
        if src.count(old) != 1:
            raise SystemExit(f"csrc/lstm_bwd.cu: the anchor {old!r} is not "
                             f"there once; update this tool")
        src = src.replace(old, new)
    return src


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_lstm_bwd_step_cost: no CUDA device", file=sys.stderr)
        return 1
    from paddle_tpu_torch.kernels import _build
    from paddle_tpu_torch.kernels import lstm as tl

    print(cs.card_line(), flush=True)
    copy = ROOT / "build" / "lstm_bwd_step_cost"
    copy.mkdir(parents=True, exist_ok=True)
    for f in _build.CSRC.glob("*.cuh"):
        shutil.copy(f, copy)
    (copy / "lstm_bwd.cu").write_text(
        instrumented((_build.CSRC / "lstm_bwd.cu").read_text()))
    args = {}
    for i, (B, T, H, kind) in enumerate(CASES):
        r = np.random.RandomState(i)
        lengths = np.full(B, T) if kind == "full" else \
            np.maximum(1, r.randint(T // 4, T + 1, size=B))
        lengths[0] = T
        args[(B, T, H)] = cs.lstm_bwd_args(B, T, H, lengths, False,
                                           cs.SEED + i)
    _build.CSRC = copy
    _build._libs.clear()
    tl._BWD._lib = None
    out = {"card": cs.card_line(), "shapes": []}
    for (B, T, H), a in args.items():
        want = tl.fused_lstm_bwd_plain(*a)[0]
        ms = cs.cuda_ms(lambda: tl.fused_lstm_bwd_nodw(*a), 20)
        got = tl.fused_lstm_bwd_nodw(*a)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        if not err <= 1e-4 * max(1.0, want.abs().max().item()):
            raise SystemExit(f"the instrumented kernel is off the plain "
                             f"version at {(B, T, H)}: {err:.3e}")
        plan = tl.lstm_bwd_plan(B, H)
        buf = (ctypes.c_ulonglong * (6 * plan.blocks))()
        fn = _build._libs["lstm_bwd"].lstm_bwd_clocks
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
