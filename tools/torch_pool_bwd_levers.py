"""What each design choice of the port's max-pool backward (csrc/pool.cu
``maxpool_bwd`` and its bf16 form ``maxpool_bwd_bf16``) is worth on an
NVIDIA GPU, at bench_resnet50's stem pool, x [256, 112, 112, 64].

Times, each by device time after it is held bit for bit against
``maxpool_3x3s2p1_bwd_plain`` on the same inputs (chip_smoke.py's pool
inputs, seed 1234): the committed kernel in its plan
(``maxpool_bwd_plan``: the strip kernel, 8 window columns a strip); the
thread kernel (plan ``THREAD``, the kernel before the strips, kept for
C % 4 != 0 and misaligned views); and copies of ``pool.cu`` under
build/ with one choice turned at a time: 4 and 16 window columns a strip
against 8, a 32-channel slice a block (8 float4s) against all 64, 3
ring stages against 2, and plain float4 loads through registers against
``cp.async`` for the staging. Then the bf16 form on the same values in
bf16, held against the plain version the same way: committed (3 ring
stages), and copies with 2, 4, 5 and 6 stages, and with 16 window
columns a strip (3 and 4 stages). Beside each form the copy floor
(csrc/pool_copy_floor.cu: x and dy read once, dx written once, in
16-byte vectors) over its bytes, the card's achievable rate for the
bytes the function must move, and the bytes bound at 3.35 TB/s. Prints
the card's name and power limit first, then one JSON object.

    python3 tools/torch_pool_bwd_levers.py
"""

from __future__ import annotations

import ctypes
import json
import shutil
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

F32_STAGES = "  static constexpr int STAGES = 2;\n"
BF16_STAGES = "  static constexpr int STAGES = 3;\n"
TW = ("constexpr int TW = 8;", "constexpr int TW = 16;")

# the copies: (name, anchor in the committed source, what it becomes)
COPIES = [
    ("TW = 4", "constexpr int TW = 8;", "constexpr int TW = 4;"),
    ("TW = 16", "constexpr int TW = 8;", "constexpr int TW = 16;"),
    ("a 32-channel slice", "constexpr int LANES = 16;",
     "constexpr int LANES = 8;"),
    ("3 ring stages", F32_STAGES, F32_STAGES.replace("2", "3")),
    ("float4 loads through registers",
     "  cp_async16(reinterpret_cast<float*>(dst),\n"
     "             reinterpret_cast<const float*>(src));\n",
     "  *dst = *src;\n"),
]


# the bf16 form's copies: (name, [(anchor, what it becomes)])
BF16_COPIES = [(f"{n} ring stages", [(BF16_STAGES,
                                       BF16_STAGES.replace("3", str(n)))])
               for n in (2, 4, 5, 6)] + [
    ("TW = 16", [TW]),
    ("TW = 16, 4 ring stages", [TW, (BF16_STAGES,
                                     BF16_STAGES.replace("3", "4"))])]


def build_copies():
    """Each of COPIES and BF16_COPIES as build/pool_bwd_levers/<i>/pool.cu,
    built with the port's nvcc flags, all at once; returns [CDLL], those
    of COPIES first."""
    from paddle_tpu_torch.kernels import _build

    src = (_build.CSRC / "pool.cu").read_text()
    procs = []
    copies = [(name, [(old, new)]) for name, old, new in COPIES] + BF16_COPIES
    for i, (name, edits) in enumerate(copies):
        text = src
        for old, new in edits:
            if text.count(old) != 1:
                raise SystemExit(f"{name}: the anchor {old!r} is not in "
                                 f"pool.cu once; update this tool")
            text = text.replace(old, new)
        d = ROOT / "build" / "pool_bwd_levers" / str(i)
        d.mkdir(parents=True, exist_ok=True)
        for f in _build.CSRC.glob("*.cuh"):
            shutil.copy(f, d)
        (d / "pool.cu").write_text(text)
        procs.append((name, d, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(d / "libpool.so"),
             str(d / "pool.cu")], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)))
    libs = []
    for name, d, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"{name}: nvcc exit {proc.returncode}\n{log}")
        libs.append(ctypes.CDLL(str(d / "libpool.so")))
    return libs


def launcher(lib, plan):
    """fn(x, dy) -> dx from a copy's maxpool_bwd in ``plan``, or its
    maxpool_bwd_bf16 for ``plan`` None."""
    P, I = ctypes.c_void_p, ctypes.c_int
    fn = lib.maxpool_bwd if plan is not None else lib.maxpool_bwd_bf16
    fn.argtypes = [P] * 3 + [I] * (4 + (plan is not None)) + [P]
    fn.restype = I

    def run(x, dy):
        dx = torch.empty_like(x)
        err = fn(x.data_ptr(), dy.data_ptr(), dx.data_ptr(), *x.shape,
                 *([] if plan is None else [plan]),
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise SystemExit(f"maxpool_bwd launch failed: CUDA error {err}")
        return dx
    return run


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_pool_bwd_levers: no CUDA device", file=sys.stderr)
        return 1
    from paddle_tpu_torch.kernels import pool as tp

    print(cs.card_line(), flush=True)
    libs = build_copies()
    x, dy = cs.pool_inputs(*cs.POOL_REPORT, "randn", cs.SEED)
    want = tp.maxpool_3x3s2p1_bwd_plain(x, dy)
    committed = tp.maxpool_bwd_plan(x.shape, [x.data_ptr(), dy.data_ptr(),
                                              0])
    runs = {f"committed (plan {committed}, TW = 8)":
            lambda x, dy: tp.maxpool_3x3s2p1_bwd(x, dy),
            f"the thread kernel (plan {tp.THREAD})":
            lambda x, dy: tp.maxpool_3x3s2p1_bwd(x, dy, plan=tp.THREAD)}
    for (name, _, _), lib in zip(COPIES, libs):
        runs[name] = launcher(lib, committed)
    times, bounds = {}, {}
    floor = cs.copy_floor()
    for form in ("float32", "bf16"):
        if form == "bf16":
            x, dy = x.to(torch.bfloat16), dy.to(torch.bfloat16)
            want = tp.maxpool_3x3s2p1_bwd_plain(x, dy)
            runs = {"bf16 committed (3 ring stages)":
                    lambda x, dy: tp.maxpool_3x3s2p1_bwd(x, dy)}
            for (name, _), lib in zip(BF16_COPIES, libs[len(COPIES):]):
                runs[f"bf16 {name}"] = launcher(lib, None)
        for name, run in runs.items():
            if not torch.equal(run(x, dy), want):
                raise SystemExit(f"{name} differs from the plain version")
            times[name] = cs.cuda_ms(lambda: run(x, dy), 20)
            print(f"  {name}: {times[name]:.4f} ms", flush=True)
        # the copy floor moves the same bytes: bf16 tensors as floats
        xv, dyv = x.view(torch.float32), dy.view(torch.float32)
        times[f"{form} copy floor"] = cs.cuda_ms(lambda: floor(xv, dyv), 20)
        bounds[form] = cs.crf_bound(0.0, [x, dy], [x])[0]
        print(f"  {form} copy floor: {times[f'{form} copy floor']:.4f} ms; "
              f"the bytes bound {bounds[form]:.4f} ms", flush=True)
    print(json.dumps({"card": cs.card_line(), "shape": cs.POOL_REPORT,
                      "bound_ms": bounds, "ms": times}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
