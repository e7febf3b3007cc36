"""Where a step of the port's CTC beta recursion (csrc/ctc.cu
``ctc_bwd_kernel<N>``, one warp a batch row) goes on an NVIDIA GPU, and
what each of its design levers is worth.

Step cost: a copy of ``ctc.cu`` under build/ gets clock64() reads at the
phase boundaries of the kernel (inserted at fixed anchors of its text; the
tool stops if one is missing), and lane 0 of every warp adds each phase's
cycles over the time loop. Two forms of the kernel are known: the
committed one (the recursion alone: the inputs and the betas' stores,
be and the three shuffles, the lse3s) and the one before it, which also
formed the posteriors in its loop (``--csrc DIR`` points at that
checkout's ``paddle_tpu_torch/csrc``; its phases: the inputs, d_em, be
and the shuffles, the lse3s). The copy is launched at the CTC training
path's (B, T, S) = (32, 512, 65) and at (4, 1100, 512), inputs as
chip_smoke.py's phase 8 draws them (numpy seed 1234, rows T/4..T long,
row 0 T long), held against the plain version and timed by device time;
the tool prints row 0's cycles a step by phase and the clock rate they
imply.

Levers (``--levers``, the committed kernel only): copies of ``ctc.cu``
with one design choice turned back at a time (states a lane the next
power of two, not ceil(S / 32); 4 rows a block, not 1; a ring of 4 steps
of em, not 8, where N <= 4; lse3 with the exp of its largest term), and
one that the kernel does not take (the SFU's __logf in lse3), each built,
held against ``ctc_betas_plain`` and timed beside the committed kernel at
(32, 512, 65), (32, 512, 41) and (16, 600, 201). Prints the card's name
and power limit first, then one JSON object.

    python3 tools/torch_ctc_bwd_step_cost.py [--csrc DIR] [--levers]
"""

from __future__ import annotations

import argparse
import ctypes
import json
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

CASES = [(32, 512, 65), (4, 1100, 512)]
LEVER_CASES = [(32, 512, 65), (32, 512, 41), (16, 600, 201)]
TIC = "{{ unsigned long long c_ = clock64(); ck[{}] += c_ - ck0; ck0 = c_; }}\n"
HEAD = ("__device__ unsigned long long g_clk[65536][8];\n\n"
        "namespace {\n\nconstexpr float NEG")
READER = ("extern \"C\" {\n\nint ctc_bwd_clocks(unsigned long long* out, "
          "int n) {\n  return (int)cudaMemcpyFromSymbol(out, g_clk, "
          "sizeof(unsigned long long) * 8 * n);\n}\n")
CK = ("  unsigned long long ck[7] = {0, 0, 0, 0, 0, 0, 0};\n"
      "  const unsigned long long ck_start = clock64();\n"
      "  unsigned long long ck0 = ck_start;\n")
STORE = ("  if (lane == 0) {\n"
         "    for (int i = 0; i < 7; ++i) g_clk[b][i] = ck[i];\n"
         "    g_clk[b][7] = clock64() - ck_start;\n  }\n")
LOOP = "  for (int t0 = T - 1; t0 >= 0; t0 -= PF) {\n"
LSE = ("          beta[k] = live[k] ? fmaxf(v, NEG) : NEG;\n"
       "        }\n")
SHFL = "        if (lane == 31) n0 = q0 = q1 = NEG;\n"
# each form: (phases after the set-up, [(anchor, replacement)]); ck[0] is
# the set-up, ck[1..] the phases
FORMS = {
    "split": (("inputs and stores", "be and shuffles", "lse3"), [
        ("namespace {\n\nconstexpr float NEG", HEAD),
        ("  const size_t step = (size_t)B * S;\n\n"
         "  bool in[N], live[N], can_skip[N];\n  float beta[N];\n",
         "  const size_t step = (size_t)B * S;\n" + CK + "\n"
         "  bool in[N], live[N], can_skip[N];\n  float beta[N];\n"),
        (LOOP, TIC.format(0) + LOOP),
        ("        if (in[k]) betas[t * step + row + k] = beta[k];\n",
         "        if (in[k]) betas[t * step + row + k] = beta[k];\n"
         + TIC.format(1)),
        (SHFL, SHFL + TIC.format(2)),
        (LSE, LSE + TIC.format(3)),
        ("      }\n    }\n  }\n}\n\n// d_em = -exp",
         "      }\n    }\n  }\n" + STORE + "}\n\n// d_em = -exp"),
        ("extern \"C\" {\n", READER),
    ]),
    "fused": (("inputs", "d_em", "be and shuffles", "lse3"), [
        ("namespace {\n\nconstexpr float NEG", HEAD),
        ("  const size_t step = (size_t)B * S;\n  const float lz = ll[b];\n",
         "  const size_t step = (size_t)B * S;\n  const float lz = ll[b];\n"
         + CK),
        (LOOP, TIC.format(0) + LOOP),
        ("        mring[j] = mask[(size_t)tn * B + b];\n      }\n"
         "      // the posterior at t",
         "        mring[j] = mask[(size_t)tn * B + b];\n      }\n"
         + TIC.format(1) + "      // the posterior at t"),
        ("              -(expf(fminf(fmaxf(al[k] + beta[k] - lz, -80.f), "
         "0.f)) * m);\n",
         "              -(expf(fminf(fmaxf(al[k] + beta[k] - lz, -80.f), "
         "0.f)) * m);\n" + TIC.format(2)),
        (SHFL, SHFL + TIC.format(3)),
        (LSE, LSE + TIC.format(4)),
        ("      }\n    }\n  }\n}\n\n}  // namespace",
         "      }\n    }\n  }\n" + STORE + "}\n\n}  // namespace"),
        ("extern \"C\" {\n", READER),
    ]),
}
# the levers: (name, anchor in the committed source, what it becomes)
LEVERS = [
    ("states a lane the next power of two",
     "constexpr int LANE_N[] = {2, 3, 4, 6, 8, 12, 16};",
     "constexpr int LANE_N[] = {2, 4, 8, 16};"),
    ("4 rows a block", "constexpr int WARPS = 1;", "constexpr int WARPS = 4;"),
    ("a ring of 4 steps", "constexpr int RING = 8;",
     "constexpr int RING = 4;"),
    ("lse3 with the exp of its largest term",
     "(mx >= -1e29f ? 1.f : 0.f) + expf(lo - ms) +\n"
     "                   expf(mid - ms))",
     "expf(x - ms) + expf(y - ms) +\n                   expf(z - ms))"),
    ("the SFU's __logf", "  return mx + logf((mx >= -1e29f",
     "  return mx + __logf((mx >= -1e29f"),
]


def replaced(src: str, pairs, where: str) -> str:
    for old, new in pairs:
        if src.count(old) != 1:
            raise SystemExit(f"{where}: the anchor {old!r} is not there "
                             f"once; update this tool")
        src = src.replace(old, new)
    return src


def build_all(sources, where="ctc_bwd_step_cost"):
    """Compile each {name: text} as build/<where>/<name>/ctc.cu with the
    port's nvcc flags, all at once; returns {name: CDLL}."""
    from paddle_tpu_torch.kernels import _build

    procs = {}
    for name, text in sources.items():
        d = ROOT / "build" / where / name
        d.mkdir(parents=True, exist_ok=True)
        for f in _build.CSRC.glob("*.cuh"):
            shutil.copy(f, d)
        (d / "ctc.cu").write_text(text)
        procs[name] = (d, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(d / "libctc.so"),
             str(d / "ctc.cu")], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (d, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"{name}: nvcc exit {proc.returncode}\n{log}")
        libs[name] = ctypes.CDLL(str(d / "libctc.so"))
    return libs


def launcher(lib, form):
    """fn(em, mask, skip, ok, beta_init, alphas, ll) -> output of the
    library's ctc_bwd (betas for the committed form, d_em before)."""
    P, I = ctypes.c_void_p, ctypes.c_int
    fn = lib.ctc_bwd
    n_ptrs = 6 if form == "split" else 8
    fn.argtypes = [P] * n_ptrs + [I] * 3 + [P]
    fn.restype = I

    def run(em, mask, skip, ok, beta_init, alphas, ll):
        T, B, S = em.shape
        out = torch.empty_like(em)
        ptrs = [em, mask, skip, ok, beta_init] + (
            [] if form == "split" else [alphas, ll]) + [out]
        err = fn(*[a.data_ptr() for a in ptrs], B, T, S,
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise SystemExit(f"ctc_bwd launch failed: CUDA error {err}")
        return out
    return run


def inputs(B, T, S, i):
    r = np.random.RandomState(i)
    lengths = np.maximum(1, r.randint(T // 4, T + 1, size=B))
    lengths[0] = T
    kind = "path" if (B, T, S) == cs.CTC_REPORT else "ragged"
    return cs.ctc_bwd_args(B, T, S, lengths, kind, cs.SEED + i)


def held(name, got, want, rtol):
    err = (got - want).abs().max().item() / cs.largest(want)
    if not err <= rtol:
        raise SystemExit(f"{name} is off its plain version: {err:.3e} of "
                         f"its largest value")
    return err


def step_cost(csrc: Path, out: dict) -> None:
    from paddle_tpu_torch.kernels import ctc as tk

    src = (csrc / "ctc.cu").read_text()
    form = "split" if "lse3_top" in src else "fused"   # after or before
    phases, pairs = FORMS[form]
    lib = build_all({"probed": replaced(src, pairs, str(csrc))})["probed"]
    run = launcher(lib, form)
    print(f"ctc_bwd as in {csrc} ({form} form)", flush=True)
    for i, (B, T, S) in enumerate(CASES):
        args = inputs(B, T, S, i)
        em, mask, skip, ok, beta_init, alphas, ll = args
        if form == "split":
            want = tk.ctc_betas_plain(em, mask, skip, ok, beta_init)
            rtol = cs.CTC_FWD_RTOL
        else:
            want = tk.ctc_bwd_plain(*args)
            rtol = cs.CTC_BWD_RTOL
        ms = cs.cuda_ms(lambda: run(*args), 20)
        held(f"the probed kernel at {(B, T, S)}", run(*args), want, rtol)
        n = len(phases) + 2
        buf = (ctypes.c_ulonglong * (8 * B))()
        fn = lib.ctc_bwd_clocks
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int]
        if fn(ctypes.addressof(buf), B) != 0:
            raise SystemExit("reading the clock sums failed")
        row = np.array(buf, dtype=np.float64).reshape(B, 8)[0]
        step = row[1:n - 1] / (T - 1)
        ghz = row[7] / (ms * 1e-3) / 1e9
        print(f"  (B, T, S) = {(B, T, S)}: {ms:.4f} ms, row 0 {row[7]:.0f} "
              f"cycles ({ghz:.3f} GHz over the kernel's time), set-up "
              f"{row[0]:.0f}, a step {step.sum():.0f}: " + ", ".join(
                  f"{p} {v:.0f} ({100 * v / step.sum():.1f}%)"
                  for p, v in zip(phases, step)), flush=True)
        out["step_cost"].append(dict(form=form, B=B, T=T, S=S, ms=ms,
                                     ghz=ghz, setup=row[0], cycles=dict(
                                         zip(phases, step.tolist()))))


def levers(out: dict) -> None:
    from paddle_tpu_torch.kernels import _build
    from paddle_tpu_torch.kernels import ctc as tk

    src = (_build.CSRC / "ctc.cu").read_text()
    texts = {"committed": src}
    for i, (name, old, new) in enumerate(LEVERS):
        texts[f"lever{i}"] = replaced(src, [(old, new)], name)
    libs = build_all(texts)
    names = ["committed"] + [name for name, _, _ in LEVERS]
    print("levers of the recursion: ms (max error of its largest value)",
          flush=True)
    for i, (B, T, S) in enumerate(LEVER_CASES):
        em, mask, skip, ok, beta_init, alphas, ll = inputs(B, T, S, i)
        want = tk.ctc_betas_plain(em, mask, skip, ok, beta_init)
        times = {}
        for label, key in zip(names, texts):
            run = launcher(libs[key], "split")
            args = (em, mask, skip, ok, beta_init, alphas, ll)
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
        print("torch_ctc_bwd_step_cost: no CUDA device", file=sys.stderr)
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
