"""The native runner: the port's AOTInductor packages served with no
Python on the request path (counterpart of the JAX package's PJRT runner,
``paddle_tpu/native/pjrt_runner.cc``).

Four sources in this folder:

- ``torch_ops.cc``: ``paddle_tpu_torch::lstm_fwd`` and ``::gru_fwd``
  registered in C++ (the schemas of ``kernels/lstm.py`` and
  ``kernels/gru.py``), a CPU implementation of each (the plain versions'
  math in ATen) and, in the cuda flavour, a CUDA one that launches the
  kernel of ``csrc/lstm_fwd.cu`` or ``csrc/gru_fwd.cu`` at the plan
  ``plans.h`` resolves for the batch it is given; each kernel's launches
  counted (``ptpu_aoti_launches``);
- ``plans.h``: those plans, the rules of ``lstm_fwd_plan`` and
  ``gru_fwd_plan`` in C++ (the tests hold the two equal);
- ``aoti_runner.cc``: the C ABI of ``aoti_capi.h`` on
  ``torch::inductor::AOTIModelPackageLoader``;
- ``aoti_run.cc``: a small program over that ABI (see its header).

:func:`build_runner` compiles them with g++ at first use into
``build/paddle_tpu_torch/`` (a library and the ``aoti_run`` executable,
named by a hash of the sources, the flags, the flavour and
``torch.__version__``, the compiler's log beside them), as
``kernels/_build.py`` builds the kernels. The ``cpu`` flavour links
libtorch alone; the ``cuda`` flavour also libtorch_cuda and the kernel
libraries ``kernels/_build.py`` builds with nvcc
(``liblstm_fwd-*.so``, ``libgru_fwd-*.so``), so each ``.cu`` file is
compiled in one place; its own sources are host code, compiled by g++
against CUDA's headers. Neither links libpython. The ops' C++ registration
collides with the Python one, so the runner always runs in a process of
its own: :func:`run_package` starts ``aoti_run`` (and :func:`call_op`
calls one op through it, with no package).
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from paddle_tpu_torch.kernels import _build
from paddle_tpu_torch.utils.error import Error

SRC = Path(__file__).resolve().parent
SOURCES = ("torch_ops.cc", "aoti_runner.cc", "aoti_run.cc", "plans.h",
           "aoti_capi.h")
# the kernel libraries the cuda flavour's ops call (csrc/<name>.cu)
KERNELS = ("lstm_fwd", "gru_fwd")
CXXFLAGS = ("-std=c++20", "-O2", "-fPIC", "-Wall", "-Wno-unused-parameter")
CUDA_HOME = os.environ.get("CUDA_HOME") or "/usr/local/cuda"

NP_DTYPES = {"f32": np.float32, "i32": np.int32, "i64": np.int64,
             "pred": np.bool_, "u8": np.uint8, "f64": np.float64}
_TAG_OF = {np.dtype(v): k for k, v in NP_DTYPES.items()}

_lock = threading.Lock()


class Runner(NamedTuple):
    """A built runner: its flavour, the library of the C ABI, the
    ``aoti_run`` program, the build log and the seconds the build took (0
    where it was built already)."""
    flavour: str
    lib: Path
    exe: Path
    log: Path
    seconds: float


def _flavour(device) -> str:
    kind = torch.device(device).type
    if kind not in ("cpu", "cuda"):
        raise Error(f"no native runner for device {device}: cpu or cuda")
    return kind


def _torch_dirs():
    root = Path(torch.__file__).resolve().parent
    return ([root / "include", root / "include" / "torch" / "csrc" / "api"
             / "include"], root / "lib")


def _flags(flavour: str):
    """(compile flags, the library's link flags)."""
    incs, libdir = _torch_dirs()
    cflags = [*CXXFLAGS, f"-D_GLIBCXX_USE_CXX11_ABI="
              f"{int(torch._C._GLIBCXX_USE_CXX11_ABI)}"]
    cflags += [f"-I{d}" for d in incs]
    # --no-as-needed: libtorch_cuda registers the CUDA backend and the
    # package loader's CUDA runner when it loads, with no symbol asked of it
    libs = [f"-L{libdir}", f"-Wl,-rpath,{libdir}", "-Wl,--no-as-needed",
            "-ltorch", "-ltorch_cpu", "-lc10"]
    if flavour == "cuda":
        cflags += ["-DPTPU_WITH_CUDA", f"-I{CUDA_HOME}/include"]
        libs += ["-ltorch_cuda", "-lc10_cuda"]
        libs += [str(_build.library_path(k)) for k in KERNELS]
    return cflags, libs


def openmp_cxx() -> Optional[str]:
    """A C++ compiler whose OpenMP is installed: ``$CXX`` where it finds
    its ``libgomp.spec``, else the first ``g++`` or ``c++`` on ``PATH``
    that does (so ``$CXX`` is passed over where it has no OpenMP), or
    None. AOTInductor links every package with ``-fopenmp``."""
    path = os.environ.get("PATH", "").split(os.pathsep)
    for cxx in [os.environ.get("CXX")] + [os.path.join(d, n) for d in path
                                          for n in ("g++", "c++")]:
        cxx = shutil.which(cxx) if cxx else None
        if cxx is None:
            continue
        try:
            spec = subprocess.run([cxx, "-print-file-name=libgomp.spec"],
                                  capture_output=True, text=True,
                                  timeout=60).stdout.strip()
        except (OSError, subprocess.SubprocessError):
            continue
        if os.path.isabs(spec) and os.path.exists(spec):
            return cxx
    return None


def _runner_paths(device="cuda") -> Runner:
    """Where :func:`build_runner` puts the ``device`` flavour's library and
    program, named by a hash of the sources, the flags and torch's
    version."""
    flavour = _flavour(device)
    cflags, libs = _flags(flavour)
    h = hashlib.sha256(" ".join([flavour, torch.__version__, *cflags,
                                 *libs]).encode())
    for name in SOURCES:
        h.update(name.encode() + b"\0" + (SRC / name).read_bytes())
    tag = h.hexdigest()[:16]
    d = _build.BUILD_DIR
    return Runner(flavour, d / f"libptpu_aoti_{flavour}-{tag}.so",
                  d / f"aoti_run_{flavour}-{tag}",
                  d / f"aoti_run_{flavour}-{tag}.log", 0.0)


def _compile(cmds, log):
    """Run the commands at once; raise with the log if any fails."""
    procs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True))
             for cmd in cmds]
    failed = False
    for cmd, proc in procs:
        out, _ = proc.communicate()
        log.append("$ " + " ".join(cmd) + "\n" + out)
        failed |= proc.returncode != 0
    if failed:
        raise Error("native runner build failed", "\n".join(log))


def build_runner(device="cuda") -> Runner:
    """The native runner's ``device`` flavour (``cuda``, the default, or
    ``cpu``), compiled on first use: g++ compiles the three sources at
    once, links the library, then ``aoti_run`` against it. The cuda
    flavour first builds its kernel libraries (nvcc). A failed build
    raises with the compiler's log and leaves nothing built."""
    import time

    with _lock:
        paths = _runner_paths(device)
        if paths.lib.exists() and paths.exe.exists():
            return paths
        t0 = time.perf_counter()
        if paths.flavour == "cuda":
            _build.build(KERNELS)
        cxx = shutil.which(os.environ.get("CXX", "g++"))
        if cxx is None:
            raise Error("g++ not found: the native runner is built from "
                        "source at first use")
        cflags, libs = _flags(paths.flavour)
        _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        log = []
        with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as tmp:
            tmp = Path(tmp)
            objs = {n: tmp / (Path(n).stem + ".o")
                    for n in ("torch_ops.cc", "aoti_runner.cc", "aoti_run.cc")}
            try:
                _compile([[cxx, *cflags, "-c", str(SRC / n), "-o", str(o)]
                          for n, o in objs.items()], log)
                lib = tmp / paths.lib.name
                _compile([[cxx, "-shared", f"-Wl,-soname,{lib.name}", "-o",
                           str(lib), str(objs["torch_ops.cc"]),
                           str(objs["aoti_runner.cc"]), *libs]], log)
                exe = tmp / paths.exe.name
                _compile([[cxx, "-o", str(exe), str(objs["aoti_run.cc"]),
                           str(lib), f"-Wl,-rpath,{_build.BUILD_DIR}"]], log)
            finally:
                paths.log.write_text("\n".join(log))
            os.replace(lib, paths.lib)
            os.replace(exe, paths.exe)
        return paths._replace(seconds=time.perf_counter() - t0)


def _aoti_run(argv: Sequence[str], runner: Optional[Runner], device) -> dict:
    """The last line of ``aoti_run argv``'s output, a JSON object, by
    ``runner`` (default: :func:`build_runner`'s for ``device``); raises
    with its message where it exits non-zero."""
    runner = runner if runner is not None else build_runner(device)
    proc = subprocess.run([str(runner.exe), *map(str, argv)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise Error(f"aoti_run exited {proc.returncode}: "
                    f"{proc.stderr.strip() or proc.stdout.strip()}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def _write_input(tmp: Path, i: int, a) -> str:
    """Input ``i`` (an array or a tensor) written to ``tmp``: its
    ``--in TYPE:DIMS:FILE``. A bf16 tensor (numpy has no bf16) goes as
    its bits, tag ``bf16``."""
    tag = None
    if isinstance(a, torch.Tensor) and a.dtype == torch.bfloat16:
        a, tag = a.cpu().contiguous().view(torch.int16), "bf16"
    a = np.ascontiguousarray(
        a.cpu().numpy() if isinstance(a, torch.Tensor) else a)
    if tag is None and a.dtype not in _TAG_OF:
        raise Error(f"input {i}: no runner dtype for {a.dtype}")
    path = tmp / f"in{i}.bin"
    a.tofile(path)
    return f"{tag or _TAG_OF[a.dtype]}:{'x'.join(map(str, a.shape))}:{path}"


def _read(path: Path, entry: dict) -> np.ndarray:
    """A result as an array; a bf16 one widened to float32 (exactly)."""
    if entry["dtype"] == "bf16":
        bits = np.fromfile(path, dtype=np.uint16).astype(np.uint32) << 16
        return bits.view(np.float32).reshape(entry["shape"])
    return np.fromfile(path, dtype=NP_DTYPES[entry["dtype"]]).reshape(
        entry["shape"])


def run_package(package, inputs, device="cuda", reps: int = 0,
                step=None, ticks: int = 0, state: int = 0,
                runner: Optional[Runner] = None) -> dict:
    """Serve the package file ``package`` on ``device`` through
    ``aoti_run`` in a process of its own, over ``inputs`` (arrays in the
    signature's order): its results, the kernel launches of the first run
    and in all, and the median host microseconds of ``execute_n`` over
    ``reps`` more runs. With ``step`` (a decode's step package; then
    ``package`` is its init), ``ticks`` ticks, the first ``state`` results
    of each fed back: ``{"init": ..., "step": ..., "ticks": n}``, the
    step's ``outputs`` a list of each tick's results. ``runner`` defaults
    to :func:`build_runner`'s. Raises with aoti_run's message where it
    exits non-zero."""
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        argv = ["--package", package, "--device", str(device), "--out", tmp,
                "--reps", reps]
        for i, a in enumerate(inputs):
            argv += ["--in", _write_input(tmp, i, a)]
        if step is not None:
            argv += ["--step", step, "--ticks", ticks, "--state", state]
        res = _aoti_run(argv, runner, device)
        if step is None:
            res["outputs"] = [_read(tmp / f"r{i}.bin", e)
                              for i, e in enumerate(res["outputs"])]
            return res
        init, stp = res["init"], res["step"]
        init["outputs"] = [_read(tmp / f"init_r{i}.bin", e)
                           for i, e in enumerate(init["outputs"])]
        stp["outputs"] = [[_read(tmp / f"t{k}_r{i}.bin", e)
                           for i, e in enumerate(stp["outputs"])]
                          for k in range(ticks)]
        return res


def call_op(op: str, inputs, ints: Sequence[int] = (), device="cuda",
            runner: Optional[Runner] = None) -> dict:
    """Call the op ``op`` (``"paddle_tpu_torch::lstm_fwd"``, say) as the
    runner registers it in C++, with no package, on ``device`` through
    ``aoti_run --op`` in a process of its own: ``inputs`` are its Tensor
    arguments in the schema's order (None for a None ``Tensor?``),
    ``ints`` its int and bool ones. Returns ``{"outputs": [arrays],
    "launches": {...}}``, the kernel launches of the call. Raises with
    aoti_run's message where it exits non-zero."""
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        argv = ["--op", op, "--device", str(device), "--out", tmp]
        for i, a in enumerate(inputs):
            argv += ["--in", "none" if a is None else _write_input(tmp, i, a)]
        for v in ints:
            argv += ["--int", int(v)]
        res = _aoti_run(argv, runner, device)
        res["outputs"] = [_read(tmp / f"r{i}.bin", e)
                          for i, e in enumerate(res["outputs"])]
        return res


def plans(batches: Sequence[int], hiddens: Sequence[int],
          runner: Optional[Runner] = None) -> dict:
    """The C++ plans (plans.h) at every (B, H), from ``aoti_run
    --plans``: ``{"lstm": {(B, H): (U, R, blocks, smem) or None},
    "lstm_bf16": the same for the bf16 form, "gru": {(B, H): (path, C, R,
    smem)}, "gru_bf16": the same for the bf16 forms}``."""
    res = _aoti_run(["--plans", ",".join(map(str, batches)),
                     ",".join(map(str, hiddens))], runner, "cpu")
    return {k: {(b, h): (tuple(p) if p is not None else None)
                for b, h, p in res[k]}
            for k in ("lstm", "lstm_bf16", "gru", "gru_bf16")}
