"""Builds the port's CUDA kernels from the sources in ``csrc/`` and binds
them.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for sm_90a into a shared
library with a plain C interface, loaded through ctypes. Libraries go to
``build/paddle_tpu_torch/`` at the root of the checkout, named by a hash
of the source, the headers it includes (``#include "..."``, as
``csrc/hopper.cuh`` and ``csrc/dw_tf32.cuh``) and the flags, so an edited
source or header builds anew and an unchanged one is built once. Nothing is built at import time: the first
call of a kernel's wrapper (or ``build``) compiles it.

``GridKernel`` binds the C interface the port's kernels share and
``CooperativeKernel`` the recurrent ones' (one cooperative launch of
H / units-per-block blocks); one source may hold several kernels
(``csrc/lstm_bwd.cu`` holds three, ``csrc/gru_bwd.cu`` four).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence

import torch

from paddle_tpu_torch.utils.error import Error, enforce

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "paddle_tpu_torch"
# -Xptxas -v reports registers, shared memory and spills into the build log
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# a quoted include, which nvcc resolves beside the including file
_INCLUDE = re.compile(r'^[ \t]*#[ \t]*include[ \t]*"([^"]+)"', re.M)

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    for cand in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise Error("nvcc not found (looked on PATH and in $CUDA_HOME/bin): the "
                "port's CUDA kernels are built from source at first use")


def _included(src: Path) -> List[Path]:
    """``src`` and every file it includes with quotes, recursively, each
    once, in the order first met."""
    files: List[Path] = []
    todo = [src]
    while todo:
        f = todo.pop(0)
        if f in files:
            continue
        files.append(f)
        todo += [f.parent / m for m in _INCLUDE.findall(f.read_text())]
    return files


def library_path(name: str) -> Path:
    """The library of ``csrc/<name>.cu``, named by a hash of the source,
    the headers it includes and the flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in _included(CSRC / f"{name}.cu"):
        h.update(f.name.encode() + b"\0" + f.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names: Iterable[str]) -> None:
    """Compile every named source that is not built yet: one nvcc per
    source, all started together. The compiler's output goes to a
    ``.log`` beside the library."""
    todo = [(n, library_path(n)) for n in names]
    todo = [(n, out) for n, out in todo if not out.exists()]
    if not todo:
        return
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    for name, out in todo:
        tmp = out.with_name(f"{out.name}.tmp{os.getpid()}")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs.append((name, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    failed = []
    for name, out, tmp, proc in procs:
        log, _ = proc.communicate()
        out.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exit {proc.returncode}\n{log}")
        else:
            os.replace(tmp, out)
    if failed:
        raise Error("kernel build failed", *failed)


def load(name: str) -> ctypes.CDLL:
    """The built library for ``csrc/<name>.cu``, compiled on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build([name])
            lib = _libs[name] = ctypes.CDLL(str(library_path(name)))
        return lib


def check_cuda_tensors(kernel: str, tensors: Sequence[torch.Tensor],
                       dtype: torch.dtype = torch.float32) -> None:
    """Raise unless every tensor is ``dtype`` (float32 unless a kernel's
    bf16 form asks for torch.bfloat16), contiguous and on the first one's
    CUDA device: what the port's kernels take."""
    dev = tensors[0].device
    enforce(dev.type == "cuda", f"{kernel}: no kernel for device {dev}")
    for a in tensors:
        enforce(a.device == dev, f"{kernel}: tensors on {a.device} and {dev}")
        enforce(a.dtype == dtype,
                f"{kernel}: the kernel takes {str(dtype).split('.')[-1]}, "
                f"got {a.dtype}")
        enforce(a.is_contiguous(),
                f"{kernel}: the kernel takes contiguous tensors")


def bf16_form(kernel: str, data: Sequence[torch.Tensor]) -> bool:
    """Whether a kernel's bf16 form takes ``data`` (True) or its float32
    form (False): one dtype across them, float32 or bf16; else raise, as
    for float16, float64 or mixed dtypes. Asked before the device and the
    plan are checked, so that a refusal names the dtype."""
    dtypes = sorted({str(a.dtype) for a in data})
    enforce(dtypes in (["torch.float32"], ["torch.bfloat16"]),
            f"{kernel}: the kernels take float32 tensors, or bfloat16 ones "
            f"(their bf16 forms), of one dtype; got {dtypes}")
    return data[0].dtype == torch.bfloat16


_WIDENED = (torch.float32, torch.bfloat16, torch.float64)


def widened_dtype(kernel: str, data: Sequence[torch.Tensor],
                  flags: Sequence[torch.Tensor]) -> torch.dtype:
    """The dtype a float32 kernel's Function computes in for ``data`` (the
    JAX kernels' ``promote_types(em.dtype, float32)``): float32 for float32
    or bf16 data, float64 for float64 (the CPU's gradient checks). The
    data share one of these dtypes; the ``flags`` (0/1 masks, exact in
    any of them) may take another. Else raise, as for float16 or a mix of
    data dtypes."""
    dtypes = sorted({str(a.dtype) for a in data})
    enforce(len(dtypes) == 1 and data[0].dtype in _WIDENED,
            f"{kernel}: the kernels take float32 or bfloat16 data (float64 "
            f"on the CPU), of one dtype; got {dtypes}")
    bad = sorted({str(f.dtype) for f in flags if f.dtype not in _WIDENED})
    enforce(not bad, f"{kernel}: the 0/1 flags take float32, bfloat16 or "
            f"float64; got {bad}")
    return torch.float64 if data[0].dtype == torch.float64 else torch.float32


def flag(a: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """A 0/1 mask or reset as the bf16 forms take it: float32 (exact)."""
    return None if a is None else a.to(torch.float32)


def check_kernel_tensors(kernel: str, data: Sequence[torch.Tensor],
                         flags: Sequence[Optional[torch.Tensor]],
                         bf16: bool, H: int) -> None:
    """A recurrent kernel's inputs, all contiguous on one CUDA device:
    ``data`` and the ``flags`` (mask and reset, None skipped) float32, or
    for the bf16 forms ``data`` bf16 and the flags float32, H a multiple
    of 8 (16-byte runs of bf16)."""
    flags = [f for f in flags if f is not None]
    if not bf16:
        check_cuda_tensors(kernel, list(data) + flags)
        return
    enforce(H % 8 == 0, f"{kernel}: the bf16 form takes H a multiple of 8, "
            f"got H={H}")
    check_cuda_tensors(kernel, data, torch.bfloat16)
    if flags:
        check_cuda_tensors(kernel, flags)
        enforce(flags[0].device == data[0].device,
                f"{kernel}: tensors on {flags[0].device} and "
                f"{data[0].device}")


class GridKernel:
    """A kernel of a ``csrc/<source>.cu`` library (``source`` defaults to
    ``name``) with the C interface of the port's kernels:

        int <name>(void* ptrs..., int sizes..., void* stream)
        const char* <name>_error_string(int err)

    ``n_ints`` sizes (by default three: B, T, H), from which the C
    function sizes its grid; ``launch`` raises when the launch fails."""

    def __init__(self, name: str, n_ptrs: int,
                 source: Optional[str] = None, n_ints: int = 3):
        self.name, self.n_ptrs, self.n_ints = name, n_ptrs, n_ints
        self.source = source or name
        self._lib = None

    def _bind(self, lib: ctypes.CDLL) -> None:
        P, I = ctypes.c_void_p, ctypes.c_int
        fn = getattr(lib, self.name)
        fn.argtypes = [P] * self.n_ptrs + [I] * self.n_ints + [P]
        fn.restype = I
        err = getattr(lib, f"{self.name}_error_string")
        err.argtypes = [I]
        err.restype = ctypes.c_char_p

    def _bound(self) -> ctypes.CDLL:
        if self._lib is None:
            lib = load(self.source)
            self._bind(lib)
            self._lib = lib
        return self._lib

    def _error(self, err: int) -> str:
        text = getattr(self._bound(), f"{self.name}_error_string")(err)
        return f"CUDA error {err} ({text.decode()})"

    def _check(self, lib, sizes: Sequence[int], dev: int) -> None:
        """Raise before a launch the kernel cannot take (nothing here)."""

    def launch(self, ptrs: Sequence, *args) -> None:
        """``launch(ptrs, size..., device)``: launch on the current stream
        of ``device`` with ``n_ints`` sizes; ``ptrs`` are data pointers
        (None for an absent optional input)."""
        *sizes, device = args
        enforce(len(ptrs) == self.n_ptrs,
                f"{self.name}: {len(ptrs)} pointers, expected {self.n_ptrs}")
        enforce(len(sizes) == self.n_ints,
                f"{self.name}: {len(sizes)} sizes, expected {self.n_ints}")
        lib = self._bound()
        dev = device.index if device.index is not None \
            else torch.cuda.current_device()
        with torch.cuda.device(dev):
            self._check(lib, sizes, dev)
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = getattr(lib, self.name)(*ptrs, *sizes, stream)
        if err:
            raise Error(f"{self.name}: launch failed: " + self._error(err))


class CooperativeKernel(GridKernel):
    """A :class:`GridKernel` whose launch is cooperative, H / ``units``
    blocks that must all be resident at once (the recurrent kernels); its
    library also has

        int <name>_max_coresident_blocks(int B, int H)

    ``launch`` asks it first (once per B, H and device) and raises when
    the blocks cannot all be resident."""

    def __init__(self, name: str, n_ptrs: int, units: int,
                 source: Optional[str] = None):
        super().__init__(name, n_ptrs, source)
        self.units = units
        self._capacity: Dict[tuple, int] = {}

    def _bind(self, lib: ctypes.CDLL) -> None:
        super()._bind(lib)
        cap = getattr(lib, f"{self.name}_max_coresident_blocks")
        cap.argtypes = [ctypes.c_int, ctypes.c_int]
        cap.restype = ctypes.c_int

    def _check(self, lib, sizes: Sequence[int], dev: int) -> None:
        B, _, H = sizes
        enforce(H % self.units == 0,
                f"{self.name}: H={H} is not a multiple of {self.units}")
        cap = self._capacity.get((B, H, dev))
        if cap is None:
            cap = getattr(lib, f"{self.name}_max_coresident_blocks")(B, H)
            if cap < 0:
                raise Error(f"{self.name}: occupancy query failed: "
                            + self._error(-cap))
            self._capacity[(B, H, dev)] = cap
        enforce(H // self.units <= cap,
                f"{self.name}: B={B}, H={H} needs {H // self.units} "
                f"co-resident blocks, the device holds {cap}")
