"""Where a step of the port's CTC alpha recursion (csrc/ctc.cu
``ctc_fwd_kernel<N>``, one warp a batch row) goes on an NVIDIA GPU, and
what each of its design levers is worth.

Step cost: a copy of ``ctc.cu`` under build/ gets clock64() reads at the
phase boundaries of the forward kernel (inserted at fixed anchors of its
text; the tool stops if one is missing), and lane 0 of every warp adds
each phase's cycles over the time loop: the inputs and stores (the ring
of em and the mask, the alphas' stores), the two shuffles, the lse3s.
The anchors are the same in the committed kernel (N states a lane,
``lse3_top``) and in the one before it (2K states a lane, a three-exp
lse3, 4 rows a block; ``--csrc DIR`` points at that checkout's
``paddle_tpu_torch/csrc``). The copy is launched at the CTC training
path's (B, T, S) = (32, 512, 65) and at (4, 1100, 512), inputs as
chip_smoke.py's phase 8 draws them (numpy seed 1234, rows T/4..T long,
row 0 T long), held against ``ctc_alphas_plain`` and timed by device
time; the tool prints row 0's cycles a step by phase and the clock rate
they imply.

Levers (``--levers``, the committed kernel only): copies of ``ctc.cu``
with one design choice turned back at a time (states a lane the next
power of two, not ceil(S / 32); lse3 with the exp of its largest term; a
ring of 4 steps of em, not 8, where N <= 4; 4 rows a block, not 1), each
built, held against ``ctc_alphas_plain`` and timed beside the committed
kernel at (32, 512, 65), (32, 512, 41) and (16, 600, 201). The constants
are shared with the backward's recursion, which this tool does not time.
Prints the card's name and power limit first, then one JSON object.

    python3 tools/torch_ctc_fwd_step_cost.py [--csrc DIR] [--levers]
"""

from __future__ import annotations

import argparse
import ctypes
import json
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(Path(__file__).resolve().parent))

import chip_smoke as cs  # noqa: E402
from torch_ctc_bwd_step_cost import (HEAD, STORE, TIC, build_all,  # noqa: E402
                                     held, replaced)

CASES = [(32, 512, 65), (4, 1100, 512)]
LEVER_CASES = [(32, 512, 65), (32, 512, 41), (16, 600, 201)]
PHASES = ("inputs and stores", "shuffles", "lse3")
READER = ("extern \"C\" {\n\nint ctc_fwd_clocks(unsigned long long* out, "
          "int n) {\n  return (int)cudaMemcpyFromSymbol(out, g_clk, "
          "sizeof(unsigned long long) * 8 * n);\n}\n")
CK = ("  unsigned long long ck[7] = {0, 0, 0, 0, 0, 0, 0};\n"
      "  const unsigned long long ck_start = clock64();\n"
      "  unsigned long long ck0 = ck_start;\n")
SETUP = ("  const size_t step = (size_t)B * S;      // one step of em / alphas\n"
         "\n  bool in[N], live[N], can_skip[N];\n  float a[N];\n")
LOOP = "  for (int t0 = 1; t0 < T; t0 += PF) {\n"
RELOAD = ("        mring[j] = mask[(size_t)tn * B + b];\n      }\n"
          "      if (!(1.f - m > 0.f)) {")
SHFL = "        if (lane == 0) p1 = p2 = NEG;\n"
LSE = ("          nx[k] = live[k] ? fmaxf(v, NEG) : NEG;\n"
       "        }\n")
END = ("        if (in[k]) alphas[t * step + row + k] = a[k];\n"
       "    }\n  }\n}\n")
# ck[0] is the set-up, ck[1] the inputs and the stores, ck[2] the
# shuffles, ck[3] the lse3s
PROBES = [
    ("namespace {\n\nconstexpr float NEG", HEAD),
    (SETUP, SETUP + CK),
    (LOOP, TIC.format(0) + LOOP),
    (RELOAD, RELOAD.replace("      }\n      if", "      }\n" + TIC.format(1)
                            + "      if")),
    (SHFL, SHFL + TIC.format(2)),
    (LSE, LSE + TIC.format(3)),
    (END, "        if (in[k]) alphas[t * step + row + k] = a[k];\n"
     + TIC.format(1) + "    }\n  }\n" + STORE + "}\n"),
    ("extern \"C\" {\n", READER),
]
# the levers: (name, anchor in the committed source, what it becomes)
LEVERS = [
    ("states a lane the next power of two",
     "constexpr int LANE_N[] = {2, 3, 4, 6, 8, 12, 16};",
     "constexpr int LANE_N[] = {2, 4, 8, 16};"),
    ("lse3 with the exp of its largest term",
     "(mx >= -1e29f ? 1.f : 0.f) + expf(lo - ms) +\n"
     "                   expf(mid - ms))",
     "expf(x - ms) + expf(y - ms) +\n                   expf(z - ms))"),
    ("a ring of 4 steps", "constexpr int RING = 8;",
     "constexpr int RING = 4;"),
    ("4 rows a block", "constexpr int WARPS = 1;", "constexpr int WARPS = 4;"),
]


def launcher(lib):
    """fn(em, mask, skip, ok) -> alphas from the library's ctc_fwd."""
    P, I = ctypes.c_void_p, ctypes.c_int
    fn = lib.ctc_fwd
    fn.argtypes = [P] * 5 + [I] * 3 + [P]
    fn.restype = I

    def run(em, mask, skip, ok):
        T, B, S = em.shape
        out = torch.empty_like(em)
        err = fn(*[a.data_ptr() for a in (em, mask, skip, ok, out)], B, T, S,
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise SystemExit(f"ctc_fwd launch failed: CUDA error {err}")
        return out
    return run


def inputs(B, T, S, i):
    r = np.random.RandomState(i)
    lengths = np.maximum(1, r.randint(T // 4, T + 1, size=B))
    lengths[0] = T
    kind = "path" if (B, T, S) == cs.CTC_REPORT else "ragged"
    return cs.ctc_fwd_args(B, T, S, lengths, kind, cs.SEED + i)


def step_cost(csrc: Path, out: dict) -> None:
    from paddle_tpu_torch.kernels import ctc as tk

    src = (csrc / "ctc.cu").read_text()
    lib = build_all({"probed": replaced(src, PROBES, str(csrc))},
                    "ctc_fwd_step_cost")["probed"]
    run = launcher(lib)
    print(f"ctc_fwd as in {csrc}", flush=True)
    for i, (B, T, S) in enumerate(CASES):
        args = inputs(B, T, S, i)
        ms = cs.cuda_ms(lambda: run(*args), 20)
        held(f"the probed kernel at {(B, T, S)}", run(*args),
             tk.ctc_alphas_plain(*args), cs.CTC_FWD_RTOL)
        buf = (ctypes.c_ulonglong * (8 * B))()
        fn = lib.ctc_fwd_clocks
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int]
        if fn(ctypes.addressof(buf), B) != 0:
            raise SystemExit("reading the clock sums failed")
        row = np.array(buf, dtype=np.float64).reshape(B, 8)[0]
        step = row[1:1 + len(PHASES)] / (T - 1)
        ghz = row[7] / (ms * 1e-3) / 1e9
        print(f"  (B, T, S) = {(B, T, S)}: {ms:.4f} ms, row 0 {row[7]:.0f} "
              f"cycles ({ghz:.3f} GHz over the kernel's time), set-up "
              f"{row[0]:.0f}, a step {step.sum():.0f}: " + ", ".join(
                  f"{p} {v:.0f} ({100 * v / step.sum():.1f}%)"
                  for p, v in zip(PHASES, step)), flush=True)
        out["step_cost"].append(dict(csrc=str(csrc), B=B, T=T, S=S, ms=ms,
                                     ghz=ghz, setup=row[0], cycles=dict(
                                         zip(PHASES, step.tolist()))))


def levers(out: dict) -> None:
    from paddle_tpu_torch.kernels import _build
    from paddle_tpu_torch.kernels import ctc as tk

    src = (_build.CSRC / "ctc.cu").read_text()
    texts = {"committed": src}
    for i, (name, old, new) in enumerate(LEVERS):
        texts[f"lever{i}"] = replaced(src, [(old, new)], name)
    libs = build_all(texts, "ctc_fwd_step_cost")
    names = ["committed"] + [name for name, _, _ in LEVERS]
    print("levers of the forward: ms (max error of its largest value)",
          flush=True)
    for i, (B, T, S) in enumerate(LEVER_CASES):
        args = inputs(B, T, S, i)
        want = tk.ctc_alphas_plain(*args)
        times = {}
        for label, key in zip(names, texts):
            run = launcher(libs[key])
            err = held(f"{label} at {(B, T, S)}", run(*args), want,
                       cs.CTC_FWD_RTOL)
            times[label] = dict(ms=cs.cuda_ms(lambda: run(*args), 20),
                                err=err)
        print(f"  (B, T, S) = {(B, T, S)}: " + "; ".join(
            f"{k} {v['ms']:.4f} ({v['err']:.1e})" for k, v in times.items()),
              flush=True)
        out["levers"].append(dict(B=B, T=T, S=S, times=times))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--csrc", type=Path, default=None)
    ap.add_argument("--levers", action="store_true")
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_ctc_fwd_step_cost: no CUDA device", file=sys.stderr)
        return 1
    from paddle_tpu_torch.kernels import _build

    print(cs.card_line(), flush=True)
    out = {"card": cs.card_line(), "step_cost": [], "levers": []}
    step_cost(opts.csrc or _build.CSRC, out)
    if opts.levers:
        levers(out)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
