"""Host staging arena for batch assembly (counterpart of
``paddle_tpu/io/staging.py``).

The DataFeeder builds identically shaped numpy buffers every batch; with
the arena it writes into reusable buffers instead, so steady-state batch
assembly allocates nothing (the reference's Matrix pool,
paddle/memory + Vector::resizeOrCreate). Where the JAX package carved
them from its native buddy allocator, the port's buffers are torch
tensors: page-locked (``pin_memory=True``) for a trainer on CUDA, so the
host-to-device copy of a batch runs asynchronously on a copy stream
(``non_blocking=True``), and plain host tensors for one on the CPU.
Pinned allocation either works or raises; there is no pageable fallback.

Buffers are keyed by (tag, gen, shape, dtype), as the JAX package keys
them: the same feed slot reuses the same memory every batch. The
pipelined trainer rotates ``gen`` through ``pipeline_depth``
generations and, before the feeder rewrites a generation, waits on that
generation's copy event (docs/torch_train_loop.md), so an in-flight copy
never reads a buffer being refilled.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from paddle_tpu_torch.utils.error import Error

#: the arena's default budget (bytes of live buffers), as the JAX arena's
DEFAULT_ARENA_BYTES = 1 << 26


class StagingArena:
    """Reusable batch-buffer pool: page-locked host tensors when
    ``pin_memory`` (a CUDA trainer's), plain host tensors otherwise."""

    def __init__(self, arena_bytes: int = DEFAULT_ARENA_BYTES,
                 pin_memory: bool = False):
        self.arena_bytes = int(arena_bytes)
        self.pin_memory = bool(pin_memory)
        self._bufs: Dict[Tuple, Tuple[torch.Tensor, np.ndarray]] = {}
        self._used = 0
        self._peak = 0
        self._closed = False

    def buffer(self, tag: str, shape, dtype, gen: int = 0) -> np.ndarray:
        """A numpy view of an arena tensor; the same (tag, gen, shape,
        dtype) returns the SAME storage every call (zeroed). ``gen`` is
        the buffer generation: callers assembling ahead of consumption
        (the pipelined feeder) cycle it so that live batches never
        alias."""
        dtype = np.dtype(dtype)
        if self._closed:
            raise RuntimeError("staging arena is closed")
        key = (tag, int(gen), tuple(int(d) for d in shape), dtype.str)
        entry = self._bufs.get(key)
        if entry is None:
            nbytes = int(np.prod(shape, dtype=np.int64)) * dtype.itemsize
            if self._used + nbytes > self.arena_bytes:
                raise Error(
                    f"staging arena exhausted for {key}: {self._used} of "
                    f"{self.arena_bytes} bytes live; make a larger arena "
                    "(StagingArena(arena_bytes=...)) or lower the "
                    "pipeline depth")
            t = torch.empty(tuple(shape),
                            dtype=torch.from_numpy(np.empty(0, dtype)).dtype,
                            pin_memory=self.pin_memory)
            entry = (t, t.numpy())
            self._bufs[key] = entry
            self._used += nbytes
            self._peak = max(self._peak, self._used)
        arr = entry[1]
        arr.fill(0)
        return arr

    def full(self, tag: str, shape, fill, dtype, gen: int = 0) -> np.ndarray:
        arr = self.buffer(tag, shape, dtype, gen=gen)
        arr.fill(fill)
        return arr

    def stats(self) -> Dict[str, int]:
        return {"used": self._used, "peak": self._peak,
                "buffers": len(self._bufs)}

    def close(self):
        """Drop every buffer. Views still held by callers keep their
        memory alive but are no longer the arena's; further buffer()
        calls raise."""
        self._bufs.clear()
        self._used = 0
        self._closed = True


_shared: Dict[bool, StagingArena] = {}


def shared_arena(pin_memory: bool = False) -> StagingArena:
    """The process-wide arena of pinned (``pin_memory``) or plain host
    buffers, made at first use."""
    arena = _shared.get(bool(pin_memory))
    if arena is None or arena._closed:
        arena = _shared[bool(pin_memory)] = StagingArena(
            pin_memory=pin_memory)
    return arena
