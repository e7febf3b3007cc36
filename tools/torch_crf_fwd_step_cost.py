"""The port's CRF forward (csrc/crf.cu ``crf_fwd_kernel<K, W, IS>``, one
batch row over W warps) on an NVIDIA GPU: its time at every W it has an
instance for, and where a step goes, by clock64() sums by phase.

Sweep: at each of chip_smoke.py's CRF cases (B, T, L) (inputs as its
phase 7 draws them: numpy seed 1234, rows T/2..T long for the kind
"documents", T/4..T otherwise, row 0 T long), the forward with every W of
csrc/crf.cu's instances for that L, each held against
``crf_alphas_plain`` (CRF_FWD_RTOL) with two launches bit-equal, timed by
device time; ``crf_fwd_plan``'s W is marked.

Step cost: a copy of csrc/ under build/ gets clock64() reads at the phase
boundaries of the committed kernel (inserted at fixed anchors of its
text; the tool stops if one is missing), and thread 0 of every block
(warp 0, whose row 0 is T long) adds each phase's cycles over the time
loop: the set-up (mt, the warp's rows of exp(trans - mt) into registers,
once), then per step the inputs and stores (the ring of em and the mask,
the last step's alphas stored), the max (one redux.sync), the exps
(exp(alpha - mx) into the warp's row of shared memory between two
__syncwarp()), the product (the warp's partials from registers), the
barrier (the partials stored, the block barrier) and the sum and log
(the W partials summed, alpha formed). It prints row 0's cycles a step by
phase for each (case, W) of the sweep, and the clock rate they imply.
Prints the card's name and power limit first, then one JSON object.

    python3 tools/torch_crf_fwd_step_cost.py
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

PHASES = ("inputs and stores", "max", "exps", "product", "barrier",
          "sum and log")
TIC = "{{ unsigned long long c_ = clock64(); ck[{}] += c_ - ck0; ck0 = c_; }}\n"
# (text of the committed source, what it becomes); ck[0] is the set-up,
# ck[1..6] the phases of PHASES
PROBES = [
    ("namespace {\n\n__device__ __forceinline__ float warp_max",
     "__device__ unsigned long long g_clk[65536][8];\n\nnamespace {\n\n"
     "__device__ __forceinline__ float warp_max"),
    ("  const int i0 = w * IS;\n",
     "  const int i0 = w * IS;\n"
     "  unsigned long long ck[7] = {0, 0, 0, 0, 0, 0, 0};\n"
     "  const unsigned long long ck_start = clock64();\n"
     "  unsigned long long ck0 = ck_start;\n"),
    ("  int par = 0;\n  for (int t0 = 1; t0 < T; t0 += PF) {\n",
     "  int par = 0;\n" + TIC.format(0)
     + "  for (int t0 = 1; t0 < T; t0 += PF) {\n"),
    ("        mring[jj] = mask[(size_t)tn * B + b];\n      }\n",
     "        mring[jj] = mask[(size_t)tn * B + b];\n      }\n"
     + TIC.format(1)),
    ("        mx = warp_max_redux(mx);\n",
     "        mx = warp_max_redux(mx);\n" + TIC.format(2)),
    ("          ea[w][lane + 32 * k] = expf(a[k] - mx);\n"
     "        __syncwarp();\n",
     "          ea[w][lane + 32 * k] = expf(a[k] - mx);\n"
     "        __syncwarp();\n" + TIC.format(3)),
    ("            p[NC - 1][k] = fmaf(x.w, et[4 * q + 3][k], p[NC - 1][k]);"
     "\n          }\n        }\n",
     "            p[NC - 1][k] = fmaf(x.w, et[4 * q + 3][k], p[NC - 1][k]);"
     "\n          }\n        }\n" + TIC.format(4)),
    ("        __syncthreads();                 // the step's one block barrier"
     "\n",
     "        __syncthreads();                 // the step's one block barrier"
     "\n" + TIC.format(5)),
    ("          a[k] = live[k] ? nx : -INFINITY;\n        }\n",
     "          a[k] = live[k] ? nx : -INFINITY;\n        }\n"
     + TIC.format(6)),
    ("          alphas[t * step + row + lane + 32 * k] = a[k];\n    }\n  }\n",
     "          alphas[t * step + row + lane + 32 * k] = a[k];\n    }\n  }\n"
     "  if (threadIdx.x == 0) {\n"
     "    for (int i = 0; i < 7; ++i) g_clk[blockIdx.x][i] = ck[i];\n"
     "    g_clk[blockIdx.x][7] = clock64() - ck_start;\n  }\n"),
    ("extern \"C\" {\n",
     "extern \"C\" {\n\nint crf_fwd_clocks(unsigned long long* out, int n) "
     "{\n  return (int)cudaMemcpyFromSymbol(out, g_clk, "
     "sizeof(unsigned long long) * 8 * n);\n}\n"),
]


def instrumented(src: str) -> str:
    for old, new in PROBES:
        if src.count(old) != 1:
            raise SystemExit(f"csrc/crf.cu: the anchor {old!r} is not there "
                             f"once; update this tool")
        src = src.replace(old, new)
    return src


def plans(L):
    """Every forward the kernels have at L: each instance's W that holds
    L's slice."""
    from paddle_tpu_torch.kernels import crf as tk

    ws = sorted({w for k, w, c in tk._FWD_INSTANCES
                 if k == -(-L // 32) and c == tk._fwd_slice(L, w)})
    return [tk.fwd_plan(L, w) for w in ws]


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_crf_fwd_step_cost: no CUDA device", file=sys.stderr)
        return 1
    from paddle_tpu_torch.kernels import _build
    from paddle_tpu_torch.kernels import crf as tk

    print(cs.card_line(), flush=True)
    cases = []
    for i, (B, T, L, kind) in enumerate(cs.CRF_CASES):
        r = np.random.RandomState(i)
        low = T // 2 if kind == "documents" else T // 4
        lengths = np.full(B, T) if kind == "full" else \
            np.maximum(1, r.randint(low, T + 1, size=B))
        lengths[0] = T
        em, mask, start, _end, trans = cs.crf_inputs(B, T, L, lengths,
                                                     cs.SEED + i)
        cases.append(((B, T, L), (em, mask, start, trans),
                      tk.crf_alphas_plain(em, mask, start, trans)))
    out = {"card": cs.card_line(), "sweep": [], "step_cost": []}

    def run_all(probed):
        for (B, T, L), args, want in cases:
            chosen = tk.crf_fwd_plan(B, L)
            for plan in plans(L):
                got = tk.crf_alphas(*args, plan=plan)
                again = tk.crf_alphas(*args, plan=plan)
                torch.cuda.synchronize()
                err = (got - want).abs().max().item() / cs.largest(want)
                if not (err <= cs.CRF_FWD_RTOL and torch.equal(got, again)):
                    raise SystemExit(f"crf_fwd W={plan.W} at {(B, T, L)}: "
                                     f"{err:.3e} relative, or two launches "
                                     "differ")
                ms = cs.cuda_ms(lambda: tk.crf_alphas(*args, plan=plan), 20)
                line = (f"(B, T, L) = {(B, T, L)} W={plan.W} IS={plan.IS}"
                        f"{' (the plan)' if plan == chosen else ''}: "
                        f"{ms:.4f} ms, {ms / (T - 1) * 1e3:.3f} us a step, "
                        f"error {err:.1e}")
                if not probed:
                    print(line, flush=True)
                    out["sweep"].append(dict(B=B, T=T, L=L, W=plan.W,
                                             plan=plan == chosen, ms=ms,
                                             err=err))
                    continue
                buf = (ctypes.c_ulonglong * (8 * B))()
                fn = _build._libs["crf"].crf_fwd_clocks
                fn.argtypes = [ctypes.c_void_p, ctypes.c_int]
                if fn(ctypes.addressof(buf), B) != 0:
                    raise SystemExit("reading the clock sums failed")
                row = np.array(buf, dtype=np.float64).reshape(B, 8)[0]
                step = row[1:7] / (T - 1)
                ghz = row[7] / (ms * 1e-3) / 1e9
                print(f"  probed {line}; row 0 {row[7]:.0f} cycles ({ghz:.3f}"
                      f" GHz), set-up {row[0]:.0f}, a step {step.sum():.0f}: "
                      + ", ".join(f"{n} {v:.0f} ({100 * v / step.sum():.1f}%)"
                                  for n, v in zip(PHASES, step)), flush=True)
                out["step_cost"].append(dict(
                    B=B, T=T, L=L, W=plan.W, ms=ms, ghz=ghz, setup=row[0],
                    cycles=dict(zip(PHASES, step.tolist()))))

    run_all(False)
    copy = ROOT / "build" / "crf_fwd_step_cost"
    copy.mkdir(parents=True, exist_ok=True)
    for f in _build.CSRC.glob("*.cuh"):
        shutil.copy(f, copy)
    (copy / "crf.cu").write_text(
        instrumented((_build.CSRC / "crf.cu").read_text()))
    _build.CSRC = copy
    _build._libs.clear()
    tk._FWD._lib = None
    run_all(True)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
