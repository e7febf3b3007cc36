"""Times the AOTInductor compiles of chip_smoke.py phase 3c's cuda packages
on the machine with the card: with ``--alone`` first the f32
classifier's alone, then all five at once, each in a spawned worker
process (the phase's layout), once with one
Inductor and Triton cache directory each and once with the shared
default. A worker reports its trace and compile seconds, its wall
seconds and the CPU seconds of the process and of the children it waited
for (Inductor's compile pool is not among them, so the CPU figure is a
floor). The evidence for how the phase schedules its compiles.

    python3 tools/torch_aoti_compile_times.py [--alone]

Prints the card's name and power limit, a line a compile, then one JSON
object.
"""

from __future__ import annotations

import concurrent.futures
import json
import multiprocessing
import os
import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402


def timed_compile(task, own_cache):
    """cs.aoti_compile(task), in a cache directory of its own where
    ``own_cache``: (task, trace s, compile s, wall s, CPU s, reason)."""
    if own_cache:
        d = tempfile.mkdtemp(prefix="aoti_cache_")
        os.environ["TORCHINDUCTOR_CACHE_DIR"] = os.path.join(d, "inductor")
        os.environ["TRITON_CACHE_DIR"] = os.path.join(d, "triton")
    t0, c0 = time.perf_counter(), os.times()
    _meta, reason, trace_s, compile_s = cs.aoti_compile(task)
    c1 = os.times()
    cpu = sum(getattr(c1, k) - getattr(c0, k) for k in
              ("user", "system", "children_user", "children_system"))
    return task, trace_s, compile_s, time.perf_counter() - t0, cpu, reason


def run(tasks, own_cache):
    """The tasks at once, a worker each: their rows and the wall s."""
    t0 = time.perf_counter()
    with concurrent.futures.ProcessPoolExecutor(
            len(tasks),
            mp_context=multiprocessing.get_context("spawn")) as pool:
        rows = [f.result() for f in [pool.submit(timed_compile, t, own_cache)
                                     for t in tasks]]
    return rows, time.perf_counter() - t0


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_aoti_compile_times: no CUDA device", file=sys.stderr)
        return 1
    print(cs.card_line(), flush=True)
    out = {}
    layouts = [("alone", [cs.AOTI_TASKS[0]], True)] \
        if "--alone" in sys.argv else []
    layouts += [("at once, own caches", list(cs.AOTI_TASKS), True),
                ("at once, shared cache", list(cs.AOTI_TASKS), False)]
    for label, tasks, own in layouts:
        rows, wall = run(tasks, own)
        print(f"{label}: wall {wall:.1f} s", flush=True)
        for task, trace_s, compile_s, w, cpu, reason in rows:
            print(f"  {task}: trace {trace_s:.1f} s, compile {compile_s:.1f} "
                  f"s, wall {w:.1f} s, CPU {cpu:.1f} s"
                  + (f"; {reason}" if reason else ""), flush=True)
            out.setdefault(label, []).append(
                {"task": list(task), "trace_s": trace_s,
                 "compile_s": compile_s, "wall_s": w, "cpu_s": cpu})
        out.setdefault("wall_s", {})[label] = wall
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
