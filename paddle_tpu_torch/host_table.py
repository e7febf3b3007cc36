"""Host-resident embedding tables: a host row store and a device row cache
(counterpart of ``paddle_tpu/host_table.py``; the reference's "model too
big for one box" sparse story, SURVEY §2.3: 100M+-row tables on parameter
servers, each batch prefetching only the rows it touches, sparse gradients
pushed back, per-row optimizer state caught up lazily on touch —
SparseRemoteParameterUpdater, MAT_SPARSE_ROW_PREFETCH,
ParameterOptimizer.h:100 t0Vec_).

- ``HostRowStore``: the table and its per-row optimizer slots in host
  RAM, as numpy arrays: a dense backing (the whole table, the exactness
  mode) or lazily materialized rows (a 100M-row vocabulary never exists
  anywhere at once). A flush applies per-row gradients through the same
  ``Optimizer.update_one`` rule the device runs, on CPU tensors, after
  ``catch_up_rows`` replays each row's skipped zero-gradient steps.
- ``HostTableRuntime``: the trainer's coordinator. ``stage()`` runs in the
  pipelined loop's feed phase: it extracts the batch's touched ids,
  remaps the id feeds into cache-slot space, gathers the touched rows
  (reusing rows still resident from the previous batch) and hands back a
  ``[cache_rows, D]`` block that the trainer copies to the device as the
  table's parameter; the step never sees a ``[V, D]`` value.
  ``flush_async()`` pushes a drained batch's cache-row gradients back to
  the store through a bounded worker queue.
- The PTPUROWS sidecar (``write_rows_sidecar`` / ``read_rows_sidecar``):
  the row-addressable on-disk form a bundle carries, byte for byte the
  JAX package's.

Staleness: with ``staleness="exact"`` (default) the trainer drains the
pipeline whenever batch N+1 touches a row an in-flight batch touched, so
every gather sees every earlier flush and host-backed training follows the
device-resident trajectory. ``staleness="async"`` skips the drain and
accepts up to depth-1 batches of row staleness (the reference async
pserver's semantics).

Not ported: ``PServerRowStore`` and the row deltas
(``write_row_delta``/``read_row_delta``), which come with the async
pserver and the publisher (ROADMAP queue 1 items 8 and 2.4).
docs/torch_embedding_cache.md has the flow and the knobs.
"""

from __future__ import annotations

import logging
import queue
import struct
import threading
import time
import zlib
from itertools import repeat
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from paddle_tpu_torch.core.arg import Arg
from paddle_tpu_torch.observability import metrics as _obs
from paddle_tpu_torch.optimizer import clip_by_value
from paddle_tpu_torch.sparse_grad import dedup_rows_np
from paddle_tpu_torch.utils.error import enforce

logger = logging.getLogger("paddle_tpu_torch")

# --- observability (host side only), the JAX package's series ------------
_M_HIT_RATE = _obs.gauge(
    "paddle_embcache_hit_rate",
    "Fraction of the last staged batch's unique rows served from the "
    "still-resident previous cache (no store gather)", labels=("table",))
_M_UNIQUE_ROWS = _obs.gauge(
    "paddle_embcache_unique_rows",
    "Unique rows the last staged batch touches in this table",
    labels=("table",))
_M_ROWS_GATHERED = _obs.counter(
    "paddle_embcache_rows_gathered_total",
    "Rows fetched from the host store (cache misses)", labels=("table",))
_M_ROWS_FLUSHED = _obs.counter(
    "paddle_embcache_rows_flushed_total",
    "Per-row gradients flushed back to the store", labels=("table",))
_M_PREFETCH_SECONDS = _obs.histogram(
    "paddle_embcache_prefetch_seconds",
    "stage() wall time per batch: id-set extraction + slot remap + row "
    "gather (the host work the pipeline hides under device compute)",
    labels=("table",))
_M_PREFETCH_OVERLAP = _obs.histogram(
    "paddle_embcache_prefetch_overlap_seconds",
    "The portion of stage() time spent while a dispatched step was "
    "still in flight — prefetch work actually hidden under compute "
    "(0 when the loop runs synchronously)", labels=("table",))
_M_FLUSH_SECONDS = _obs.histogram(
    "paddle_embcache_flush_seconds",
    "Store-side per-flush apply latency (catch-up + row update + "
    "scatter)", labels=("table",))
_M_FLUSH_QUEUE_DEPTH = _obs.gauge(
    "paddle_embcache_flush_queue_depth",
    "Flush entries enqueued but not yet applied to the store")
_M_CONFLICT_DRAINS = _obs.counter(
    "paddle_embcache_conflict_drains_total",
    "Pipeline drains forced by exact-staleness row conflicts (batch "
    "N+1 touches a row an in-flight batch also touched)")
_M_CACHE_GROWTH = _obs.counter(
    "paddle_embcache_cache_regrows_total",
    "Auto-sized cache capacity growths (each a new cache shape)",
    labels=("table",))


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p <<= 1
    return p


_U64 = np.uint64


def _splitmix64(z: np.ndarray) -> np.ndarray:
    """Vectorized splitmix64 finalizer — a counter-based bijective mixer
    over uint64 (wrapping arithmetic is the point)."""
    z = (z + _U64(0x9E3779B97F4A7C15)).astype(np.uint64)
    z = ((z ^ (z >> _U64(30))) * _U64(0xBF58476D1CE4E5B9)).astype(np.uint64)
    z = ((z ^ (z >> _U64(27))) * _U64(0x94D049BB133111EB)).astype(np.uint64)
    return (z ^ (z >> _U64(31))).astype(np.uint64)


def make_row_init(attr, fan_in: int, seed: int, name: str
                  ) -> Callable[[np.ndarray], np.ndarray]:
    """Deterministic per-row initializer of a lazily materialized table:
    row r of table ``name`` is the same values within and across runs and
    processes (a resume regenerates never-touched rows), and bit-equal to
    the JAX package's, drawn from the ParamAttr's distribution family from
    a counter-based stream of its own (a 100M-row table is exactly where
    materializing the whole array to slice one row is off the table).
    Vectorized: a first-touch gather of thousands of rows mixes one
    [n, D] counter block."""
    mean = attr.initial_mean if attr.initial_mean is not None else 0.0
    std = (attr.initial_std if attr.initial_std is not None
           else 1.0 / np.sqrt(max(fan_in, 1)))
    strat = attr.initial_strategy or "normal"
    # a stable per-table base (crc32, not Python's hash(), which
    # PYTHONHASHSEED randomizes between processes)
    base = _U64(zlib.crc32(f"{seed}:{name}".encode()) & 0xFFFFFFFF)

    def _uniforms(ids: np.ndarray, k: int) -> np.ndarray:
        # counter = (table base, row id, value index) -> u64 -> (0, 1];
        # the row id is mixed once first so rows r and r+1 do not share
        # overlapping counter ranges
        row_key = _splitmix64(ids.astype(np.uint64) ^ (base << _U64(32)))
        ctr = row_key[:, None] + np.arange(k, dtype=np.uint64)[None, :]
        bits = _splitmix64(ctr)
        return ((bits >> _U64(11)).astype(np.float64) + 1.0) / (1 << 53)

    def init(ids: np.ndarray, dim: Tuple[int, ...],
             dtype=np.float32) -> np.ndarray:
        ids = np.asarray(ids, np.int64)
        shape = (len(ids),) + tuple(dim)
        if strat == "zero":
            return np.zeros(shape, dtype)
        if strat == "constant":
            return np.full(shape, attr.initial_value, dtype)
        k = int(np.prod(dim, dtype=np.int64)) if dim else 1
        if strat == "uniform":
            out = (mean - std) + 2.0 * std * _uniforms(ids, k)
        else:
            # Box-Muller over two uniform planes of one 2k-wide block
            u = _uniforms(ids, 2 * k)
            z = (np.sqrt(-2.0 * np.log(u[:, :k]))
                 * np.cos(2.0 * np.pi * u[:, k:]))
            out = mean + std * z
        return out.reshape(shape).astype(dtype)

    return init


class HostRowStore:
    """Host-RAM table with per-row lazy optimizer state.

    Two backings:
    - ``dense=np[V, D]``: the whole table in host memory, the exactness
      mode (its rows are the parameters' values);
    - lazy (``dense=None``): rows materialize on first touch from
      ``row_init`` (default zeros); only written rows are kept, in arrays
      that grow by doubling, behind an id -> slot map.

    ``apply_sparse(ids, values, step)`` sums repeated ids, gathers the
    rows and their slot rows, replays the skipped zero-gradient steps
    through the optimizer's ``catch_up_rows`` (gap = step - 1 - t0, the
    reference's t0Vec_ catch-up), runs ``update_one`` on the [n, D] block
    as CPU tensors and scatters back. Thread-safe; the flush worker is the
    usual caller. ``state_dict`` is the JAX package's layout (numpy arrays
    under the same keys), so either package's snapshot loads in the other.
    """

    def __init__(self, name: str, shape: Tuple[int, ...], optimizer,
                 dense: Optional[np.ndarray] = None,
                 row_init: Optional[Callable] = None,
                 lr_mult: float = 1.0, dtype=np.float32):
        self.name = name
        self.shape = tuple(int(d) for d in shape)
        self.optimizer = optimizer
        self.lr_mult = float(lr_mult)
        self.dtype = np.dtype(dtype)
        self._lock = threading.RLock()
        self.version = 0
        self._row_init = row_init
        # the slot layout from the optimizer's own init rule on a one-row
        # probe: row-shaped slots are kept per row, the others (Adam's
        # shared t) per table
        probe = optimizer.init_one(torch.zeros((1,) + self.shape[1:]))
        self._row_slot_names = sorted(
            k for k, v in probe.items()
            if tuple(v.shape) == (1,) + self.shape[1:])
        self._scalar_slots = {k: v.numpy().copy() for k, v in probe.items()
                              if k not in self._row_slot_names}
        if dense is not None:
            enforce(tuple(dense.shape) == self.shape,
                    f"host table {name}: dense backing shape "
                    f"{tuple(dense.shape)} != declared {self.shape}")
            # a row's slot is its id
            self._dense = np.array(dense, self.dtype)
            self._index: Optional[Dict[int, int]] = None
            self._alloc(self.shape[0])
            self._vals = self._dense
        else:
            self._dense = None
            self._index = {}
            self._alloc(0)

    def _alloc(self, n: int):
        self._vals = np.zeros((n,) + self.shape[1:], self.dtype)
        self._slot_vals = {k: np.zeros((n,) + self.shape[1:], np.float32)
                           for k in self._row_slot_names}
        self._t0 = np.zeros(n, np.int64)

    def _lookup(self, ids: np.ndarray, create: bool = False) -> np.ndarray:
        """The slots of ``ids`` (unique) in the backing arrays: the ids in a
        dense backing; in a lazy one -1 for a row never written, or, with
        ``create``, a new slot (the arrays grow by doubling)."""
        if self._index is None:
            return ids
        index = self._index
        slots = np.fromiter(map(index.get, ids.tolist(), repeat(-1)),
                            np.int64, len(ids))
        new = np.flatnonzero(slots < 0) if create else ()
        if len(new):
            first = len(index)
            if first + len(new) > len(self._t0):
                old = (self._vals, self._slot_vals, self._t0)
                self._alloc(max(first + len(new), 2 * len(self._t0), 1024))
                self._vals[:first] = old[0][:first]
                for k, v in old[1].items():
                    self._slot_vals[k][:first] = v[:first]
                self._t0[:first] = old[2][:first]
            for j, r in enumerate(ids[new].tolist()):
                index[r] = first + j
            slots[new] = np.arange(first, first + len(new))
        return slots

    # --- reads ------------------------------------------------------------
    def _rows_at(self, ids: np.ndarray, slots: np.ndarray) -> np.ndarray:
        if self._index is None:
            return self._vals[slots]
        out = np.empty((len(ids),) + self.shape[1:], self.dtype)
        have = slots >= 0
        out[have] = self._vals[slots[have]]
        if not have.all():
            miss = ~have
            out[miss] = (self._row_init(ids[miss], self.shape[1:], self.dtype)
                         if self._row_init is not None else 0.0)
        return out

    def _slot_at(self, k: str, slots: np.ndarray) -> np.ndarray:
        out = np.zeros((len(slots),) + self.shape[1:], np.float32)
        have = slots >= 0
        out[have] = self._slot_vals[k][slots[have]]
        return out

    def _t0_at(self, slots: np.ndarray) -> np.ndarray:
        out = np.zeros(len(slots), np.int64)
        have = slots >= 0
        out[have] = self._t0[slots[have]]
        return out

    def gather(self, ids: np.ndarray) -> np.ndarray:
        """Rows at ``ids`` (unique, all >= 0) as one [n, D] block."""
        ids = np.asarray(ids, np.int64)
        with self._lock:
            return self._rows_at(ids, self._lookup(ids))

    def dense_snapshot(self) -> Optional[np.ndarray]:
        """The whole trained table of a dense backing, else None (a lazy
        table is never materialized whole). The trainer writes it back
        into its Parameters at pass boundaries."""
        with self._lock:
            return None if self._dense is None else self._dense.copy()

    def seed_slots(self, slots: Dict[str, np.ndarray], t0: int = 0):
        """Adopt a device run's optimizer slots when the table moves from
        device to host training mid-life: row slots copy in whole, scalar
        slots copy through, and every row is stamped current through step
        ``t0`` so the catch-up replays none of the steps the device run
        already applied."""
        with self._lock:
            enforce(self._dense is not None,
                    f"host table {self.name}: cannot seed optimizer "
                    "slots into a lazily-backed store")
            for k in self._row_slot_names:
                if k in slots and tuple(np.shape(slots[k])) == self.shape:
                    self._slot_vals[k] = np.asarray(
                        slots[k], np.float32).copy()
            for k in self._scalar_slots:
                if k in slots:
                    self._scalar_slots[k] = np.asarray(slots[k]).copy()
            self._t0[:] = int(t0)

    def dense_slot_snapshot(self) -> Optional[Dict[str, np.ndarray]]:
        """The whole optimizer slots of a dense backing (row and scalar
        slots), else None: the trainer hands them back to the device
        optimizer when a later train() turns host mode off."""
        with self._lock:
            if self._dense is None:
                return None
            out = {k: v.copy() for k, v in self._slot_vals.items()}
            out.update({k: np.asarray(v).copy()
                        for k, v in self._scalar_slots.items()})
            return out

    @property
    def touched_rows(self) -> int:
        with self._lock:
            if self._index is None:
                return int((self._t0 > 0).sum())
            return len(self._index)

    # --- the sparse update ------------------------------------------------
    def apply_sparse(self, ids: np.ndarray, values: np.ndarray, step: int):
        """Apply per-row gradients ``values[i]`` to rows ``ids[i]`` as
        training step ``step`` (the 1-based global batch number: it sets
        the learning rate and the catch-up gap). Repeated ids are summed
        first; negative ids are dropped."""
        ids, values = dedup_rows_np(ids, values)
        n = len(ids)
        if n == 0:
            return
        opt = self.optimizer
        with self._lock, torch.no_grad():
            slots = self._lookup(ids)
            p_rows = torch.from_numpy(self._rows_at(ids, slots))
            s_rows = {k: torch.from_numpy(self._slot_at(k, slots))
                      for k in self._row_slot_names}
            s_rows.update({k: torch.from_numpy(v.copy())
                           for k, v in self._scalar_slots.items()})
            if "t" in s_rows:
                # the Adam family's shared step counter is the GLOBAL
                # batch count (the dense semantics): a table whose flush
                # skipped a batch must not see a lagging t
                s_rows["t"] = torch.tensor(float(step - 1))
            lr = float(opt.lr_fn(step))
            plr = lr * self.lr_mult
            vals = torch.from_numpy(np.ascontiguousarray(
                values.reshape((n,) + self.shape[1:]), self.dtype))
            if opt.clip_threshold and not opt.global_clipping:
                vals = clip_by_value(vals, opt.clip_threshold)
            if opt.regularization is not None:
                vals = opt.regularization.apply(vals, p_rows, lr)
            gap = torch.from_numpy(np.maximum(step - 1 - self._t0_at(slots),
                                              0))
            p_rows, s_rows = opt.catch_up_rows(p_rows, s_rows, gap, plr)
            new_p, new_s = opt.update_one(vals, p_rows, dict(s_rows), plr)
            slots = self._lookup(ids, create=True)
            self._vals[slots] = new_p.numpy()
            for k in self._row_slot_names:
                self._slot_vals[k][slots] = new_s[k].numpy()
            self._t0[slots] = step
            for k in self._scalar_slots:
                if k in new_s:
                    self._scalar_slots[k] = new_s[k].numpy().copy()
            self.version += 1
        _M_ROWS_FLUSHED.labels(table=self.name).inc(n)

    # --- snapshot ---------------------------------------------------------
    def state_dict(self) -> dict:
        """Step-snapshot payload: a dense backing saves the whole table and
        slots, a lazy one only its written rows (the others regenerate
        from row_init)."""
        with self._lock:
            d = {"name": self.name, "shape": self.shape,
                 "version": self.version,
                 "scalar_slots": {k: np.asarray(v)
                                  for k, v in self._scalar_slots.items()}}
            if self._index is None:
                d["dense"] = self._dense.copy()
                d["dense_slots"] = {k: v.copy()
                                    for k, v in self._slot_vals.items()}
                d["t0"] = self._t0.copy()
                return d
            ids = np.array(sorted(self._index), np.int64)
            slots = self._lookup(ids)
            d["row_ids"] = ids
            d["row_values"] = self._vals[slots]
            d["row_slots"] = {k: v[slots]
                              for k, v in self._slot_vals.items()}
            d["row_t0"] = self._t0[slots]
            return d

    def load_state(self, d: dict):
        enforce(tuple(d["shape"]) == self.shape,
                f"host table snapshot shape {tuple(d['shape'])} != "
                f"{self.shape}")
        with self._lock:
            self.version = int(d.get("version", 0))
            self._scalar_slots = {k: np.asarray(v).copy()
                                  for k, v in d["scalar_slots"].items()}
            if "dense" in d:
                enforce(self._dense is not None,
                        "dense host-table snapshot into a lazy store")
                self._dense[...] = d["dense"]
                for k, v in d["dense_slots"].items():
                    self._slot_vals[k][...] = v
                self._t0[...] = d["t0"]
                return
            enforce(self._dense is None,
                    "lazy host-table snapshot into a dense store")
            ids = np.asarray(d["row_ids"], np.int64)
            self._index = {r: i for i, r in enumerate(ids.tolist())}
            self._alloc(len(ids))
            self._vals[...] = np.asarray(d["row_values"], self.dtype) \
                .reshape(self._vals.shape)
            for k in self._row_slot_names:
                if k in d["row_slots"]:
                    self._slot_vals[k][...] = d["row_slots"][k]
            self._t0[...] = d["row_t0"]


# --- the serving row sidecar ----------------------------------------------
#
# PTPUROWS, the row-addressable on-disk form of a host table: a 48-byte
# header, an optional sorted u64 id array (omitted when the rows are the
# contiguous prefix 0..n-1), the f32 row data, then one crc32 per
# block_rows-sized block of row data, so that a server can validate a block
# on first touch without reading the whole section. Ids absent from the
# section serve as ZERO rows ("missing": "zero" in meta.host_tables). The
# writer streams block by block: no [V, D] array exists on either side.
#
#   0   magic[8]      b"PTPUROWS"
#   8   u32 version   1
#   12  u32 width     row element count (prod of shape[1:])
#   16  u64 vocab     declared table rows V
#   24  u64 n_rows    rows present in this section
#   32  u32 block_rows
#   36  u32 flags     bit0: contiguous ids 0..n_rows-1 (id array omitted)
#   40  u32 ids_crc   crc32 of the id array bytes (0 when contiguous)
#   44  u32 header_crc  crc32 of bytes [0, 44)

HOSTROWS_MAGIC = b"PTPUROWS"
HOSTROWS_VERSION = 1
HOSTROWS_HEADER_BYTES = 48
HOSTROWS_BLOCK_ROWS = 4096
HOSTROWS_FLAG_CONTIGUOUS = 1


def _crc(b: bytes, crc: int = 0) -> int:
    return zlib.crc32(b, crc) & 0xFFFFFFFF


def _array_blocks(rows: np.ndarray, block_rows: int):
    for i in range(0, len(rows), block_rows):
        yield rows[i:i + block_rows]


def write_rows_sidecar(f, vocab: int, width: int,
                       ids: Optional[np.ndarray], block_iter, n_rows: int,
                       block_rows: int = HOSTROWS_BLOCK_ROWS) -> int:
    """Stream a PTPUROWS section to the file object ``f``: ``n_rows`` rows
    of ``width`` f32 elements, delivered by ``block_iter`` as consecutive
    [k, width] blocks of exactly ``block_rows`` rows (the last may be
    short). ``ids=None`` declares the contiguous prefix 0..n_rows-1 (a
    dense table; the id array is omitted). Returns the bytes written."""
    flags = 0
    ids_bytes = b""
    if ids is None:
        flags |= HOSTROWS_FLAG_CONTIGUOUS
    else:
        ids = np.asarray(ids, np.int64)
        enforce(len(ids) == n_rows,
                f"rows sidecar: {len(ids)} ids for {n_rows} rows")
        enforce(len(ids) == 0 or (np.all(np.diff(ids) > 0) and ids[0] >= 0),
                "rows sidecar ids must be sorted, unique and non-negative")
        ids_bytes = ids.astype("<u8").tobytes()
    head = HOSTROWS_MAGIC + struct.pack(
        "<IIQQIII", HOSTROWS_VERSION, int(width), int(vocab), int(n_rows),
        int(block_rows), flags, _crc(ids_bytes))
    f.write(head + struct.pack("<I", _crc(head)))
    f.write(ids_bytes)
    written = HOSTROWS_HEADER_BYTES + len(ids_bytes)
    block_crcs: List[int] = []
    seen = 0
    for block in block_iter:
        b = np.ascontiguousarray(np.asarray(block, np.float32)
                                 .reshape(-1, width)).astype("<f4").tobytes()
        seen += len(b) // (4 * width)
        block_crcs.append(_crc(b))
        f.write(b)
        written += len(b)
    enforce(seen == n_rows,
            f"rows sidecar: block stream delivered {seen} rows, "
            f"declared {n_rows}")
    crc_bytes = np.array(block_crcs, "<u4").tobytes()
    f.write(crc_bytes)
    return written + len(crc_bytes)


def read_rows_sidecar(buf: bytes
                      ) -> Tuple[Optional[np.ndarray], np.ndarray, dict]:
    """Parse and validate a whole PTPUROWS section: (ids or None, rows
    [n, width] f32, header info). Every block's crc is checked."""
    enforce(len(buf) >= HOSTROWS_HEADER_BYTES
            and buf[:8] == HOSTROWS_MAGIC,
            "not a PTPUROWS rows section")
    (version, width, vocab, n_rows, block_rows, flags, ids_crc,
     header_crc) = struct.unpack("<IIQQIIII", buf[8:HOSTROWS_HEADER_BYTES])
    enforce(_crc(buf[:44]) == header_crc, "rows sidecar: header crc "
            "mismatch (torn or corrupt section)")
    enforce(version == HOSTROWS_VERSION,
            f"rows sidecar: unsupported version {version}")
    off = HOSTROWS_HEADER_BYTES
    ids = None
    if not flags & HOSTROWS_FLAG_CONTIGUOUS:
        ids_bytes = buf[off:off + 8 * n_rows]
        enforce(len(ids_bytes) == 8 * n_rows and _crc(ids_bytes) == ids_crc,
                "rows sidecar: id array truncated or crc mismatch")
        ids = np.frombuffer(ids_bytes, "<u8").astype(np.int64)
        off += 8 * n_rows
    data_bytes = 4 * width * n_rows
    n_blocks = (n_rows + block_rows - 1) // block_rows if n_rows else 0
    enforce(len(buf) >= off + data_bytes + 4 * n_blocks,
            "rows sidecar: data truncated")
    data = buf[off:off + data_bytes]
    crcs = np.frombuffer(
        buf[off + data_bytes:off + data_bytes + 4 * n_blocks], "<u4")
    for b in range(n_blocks):
        lo = b * block_rows * 4 * width
        hi = min((b + 1) * block_rows, n_rows) * 4 * width
        enforce(_crc(data[lo:hi]) == int(crcs[b]),
                f"rows sidecar: block {b} crc mismatch")
    rows = np.frombuffer(data, "<f4").reshape(n_rows, width).copy()
    info = {"version": version, "width": int(width), "vocab": int(vocab),
            "n_rows": int(n_rows), "block_rows": int(block_rows),
            "flags": int(flags)}
    return ids, rows, info


def store_row_blocks(store: HostRowStore,
                     block_rows: int = HOSTROWS_BLOCK_ROWS):
    """(ids or None, n_rows, block iterator) for spooling ``store`` into a
    PTPUROWS section. A dense backing streams contiguous [block, D] slices
    (ids omitted); a lazy one its touched rows in id order. Never-touched
    ids are not written and serve as zero rows: exact where the table's
    row_init is zeros, approximate otherwise."""
    enforce(store.dtype == np.dtype(np.float32),
            f"host table {store.name}: rows sidecar is f32-only "
            f"(store dtype {store.dtype})")
    width = int(np.prod(store.shape[1:], dtype=np.int64))
    if store._dense is not None:
        n = int(store.shape[0])

        def dense_blocks():
            for i in range(0, n, block_rows):
                with store._lock:
                    yield store._dense[i:i + block_rows].reshape(-1, width)

        return None, n, dense_blocks()
    with store._lock:
        ids = np.array(sorted(store._index), np.int64)
        slots = store._lookup(ids)

    def lazy_blocks():
        for i in range(0, len(ids), block_rows):
            with store._lock:
                yield store._vals[slots[i:i + block_rows]].reshape(-1, width)

    return ids, len(ids), lazy_blocks()


# --- the trainer's runtime --------------------------------------------------

class _StagedBatch:
    """One staged batch: slot-remapped feeds, the [cache_rows, D] cache of
    each table, and the unique ids the flush maps cache rows back to."""

    __slots__ = ("feeds", "caches", "unique", "events")

    def __init__(self, feeds, caches, unique):
        self.feeds = feeds
        self.caches = caches       # {pname: np [cap, D]}
        self.unique = unique       # {pname: np [n] int64 ids}
        self.events: List[threading.Event] = []

    def flushed(self) -> bool:
        return all(e.is_set() for e in self.events)


def _overlaps(unique: Dict[str, np.ndarray], staged: _StagedBatch) -> bool:
    for pname, ids in unique.items():
        prev = staged.unique.get(pname)
        if prev is not None and len(prev) and len(ids) \
                and np.intersect1d(ids, prev, assume_unique=True).size:
            return True
    return False


class HostTableRuntime:
    """Trainer-side coordinator: stage (prefetch) / flush / barrier.

    ``stage()`` runs in the feed phase of the pipelined loop, so batch
    N+1's id extraction and row gather run while step N computes on the
    device. ``flush_async()`` runs when a batch is drained (its gradients
    have reached the host then), through a bounded FIFO worker, so store
    writes never block the dispatch path."""

    def __init__(self, tables: Dict[str, HostRowStore],
                 feeds_of: Dict[str, List[str]],
                 cache_rows: int = 0, staleness: str = "exact",
                 flush_inflight: int = 4):
        enforce(staleness in ("exact", "async"),
                f"host_staleness must be exact|async, got {staleness!r}")
        self.tables = dict(tables)
        self.feeds_of = {p: list(f) for p, f in feeds_of.items()}
        self.staleness = staleness
        self._fixed_cap = int(cache_rows or 0)
        self._cap: Dict[str, int] = {}
        self._lock = threading.Lock()
        self._resident: Dict[str, Tuple[np.ndarray, np.ndarray]] = {}
        self._dirty: Dict[str, List[np.ndarray]] = {p: [] for p in tables}
        self._pending: List[Tuple[_StagedBatch, threading.Event]] = []
        self._peeked: Optional[Tuple[int, Dict[str, np.ndarray]]] = None
        self._error: Optional[BaseException] = None
        self._start_worker(flush_inflight)

    def _start_worker(self, flush_inflight: int):
        self._queue: "queue.Queue" = queue.Queue(
            maxsize=max(1, int(flush_inflight)))
        self._worker = threading.Thread(target=self._flush_worker,
                                        daemon=True, name="host-table-flush")
        self._worker.start()

    # --- feed analysis ----------------------------------------------------
    def _ids_of(self, feeds) -> Dict[str, np.ndarray]:
        out = {}
        for pname, fnames in self.feeds_of.items():
            parts = []
            for fn in fnames:
                a = feeds[fn]
                parts.append(np.asarray(a.value if isinstance(a, Arg) else a)
                             .reshape(-1))
            ids = np.concatenate(parts) if len(parts) > 1 else parts[0]
            out[pname] = np.unique(ids[ids >= 0]).astype(np.int64)
        return out

    def peek_conflicts(self, feeds) -> bool:
        """True when (in exact mode) this batch touches a row that an
        in-flight (dispatched, not yet flushed) batch also touched: the
        trainer must drain the pipeline before staging, so that the
        gather sees the earlier batch's update."""
        self._raise_if_failed()
        unique = self._ids_of(feeds)
        self._peeked = (id(feeds), unique)
        if self.staleness != "exact":
            return False
        with self._lock:
            pend = [s for s, _e in self._pending if not s.flushed()]
        if any(_overlaps(unique, s) for s in pend):
            _M_CONFLICT_DRAINS.inc()
            return True
        return False

    def _capacity(self, pname: str, n: int) -> int:
        if self._fixed_cap:
            enforce(n <= self._fixed_cap,
                    f"host table {pname}: batch touches {n} unique rows "
                    f"but host_cache_rows={self._fixed_cap}; raise the "
                    "cache or shrink the batch")
            return self._fixed_cap
        cap = self._cap.get(pname, 0)
        if n > cap or pname not in self._cap:
            # a first batch that touches no row of this table still needs
            # a usable capacity: the smallest bucket
            new_cap = max(cap, _next_pow2(max(n, 8)))
            if pname in self._cap and n > cap:
                _M_CACHE_GROWTH.labels(table=pname).inc()
                logger.warning("host table %s: device row cache grown to "
                               "%d rows", pname, new_cap)
            self._cap[pname] = new_cap
        return self._cap[pname]

    # --- the prefetch -----------------------------------------------------
    def stage(self, feeds, overlapped: bool = False) -> _StagedBatch:
        """Remap this batch's id feeds into cache-slot space and build the
        [cache_rows, D] cache block of each table. In exact mode it first
        waits for any pending flush touching the same rows (after the
        trainer's drain, just the worker finishing its queue)."""
        self._raise_if_failed()
        if self._peeked is not None and self._peeked[0] == id(feeds):
            unique = self._peeked[1]
        else:
            unique = self._ids_of(feeds)
        self._peeked = None
        if self.staleness == "exact":
            self._wait_conflicting(unique)
        new_feeds = dict(feeds)
        caches = {}
        for pname, ids in unique.items():
            t0 = time.perf_counter()
            store = self.tables[pname]
            cap = self._capacity(pname, len(ids))
            cache = np.zeros((cap,) + store.shape[1:], np.float32)
            n = len(ids)
            hits = 0
            if n:
                with self._lock:
                    prev = self._resident.get(pname)
                    dirty = (np.concatenate(self._dirty[pname])
                             if self._dirty[pname] else None)
                    self._dirty[pname] = []
                miss = np.ones(n, bool)
                if prev is not None:
                    prev_ids, prev_rows = prev
                    pos = np.searchsorted(prev_ids, ids)
                    ok = pos < len(prev_ids)
                    hit = np.zeros(n, bool)
                    hit[ok] = prev_ids[pos[ok]] == ids[ok]
                    if dirty is not None and hit.any():
                        hit &= ~np.isin(ids, dirty)
                    if hit.any():
                        cache[:n][hit] = prev_rows[pos[hit]]
                        miss = ~hit
                        hits = int(hit.sum())
                if miss.any():
                    cache[:n][miss] = store.gather(ids[miss])
                    _M_ROWS_GATHERED.labels(table=pname).inc(
                        int(miss.sum()))
                with self._lock:
                    self._resident[pname] = (ids, cache[:n].copy())
            # remap every feed of this table into slot space
            for fn in self.feeds_of[pname]:
                a = new_feeds[fn]
                v = np.asarray(a.value if isinstance(a, Arg) else a)
                flat = v.reshape(-1)
                slots = np.clip(np.searchsorted(ids, flat), 0,
                                max(n - 1, 0))
                ok = (flat >= 0) & (n > 0)
                if n:
                    ok &= ids[slots] == flat
                slot_v = np.where(ok, slots, -1).astype(np.int32) \
                    .reshape(v.shape)
                new_feeds[fn] = (Arg(slot_v, a.mask, a.seg_ids)
                                 if isinstance(a, Arg) else slot_v)
            caches[pname] = cache
            dt = time.perf_counter() - t0
            _M_UNIQUE_ROWS.labels(table=pname).set(n)
            _M_HIT_RATE.labels(table=pname).set(hits / n if n else 0.0)
            _M_PREFETCH_SECONDS.labels(table=pname).observe(dt)
            _M_PREFETCH_OVERLAP.labels(table=pname).observe(
                dt if overlapped else 0.0)
        return _StagedBatch(new_feeds, caches, unique)

    def mark_dispatched(self, staged: _StagedBatch):
        """Record a dispatched batch's touched rows: until its flush is
        applied, exact mode treats them as in flight."""
        ev = threading.Event()
        staged.events.append(ev)
        with self._lock:
            self._pending.append((staged, ev))
            self._pending = [(s, e) for s, e in self._pending
                             if not s.flushed() or e is ev]

    # --- the flush --------------------------------------------------------
    def flush_async(self, staged: _StagedBatch,
                    host_grads: Dict[str, np.ndarray], step: int):
        """Enqueue a drained batch's per-row gradients for the store.
        Bounded: blocks while ``flush_inflight`` batches are already
        queued (back-pressure instead of unbounded host memory)."""
        self._raise_if_failed()
        ev = staged.events[-1] if staged.events else threading.Event()
        work = []
        for pname, grad in host_grads.items():
            ids = staged.unique.get(pname)
            if ids is None or not len(ids):
                continue
            work.append((pname, ids, np.asarray(grad)[:len(ids)]))
        self._queue.put((work, step, ev))
        _M_FLUSH_QUEUE_DEPTH.set(self._queue.qsize())

    def _flush_worker(self):
        while True:
            item = self._queue.get()
            if item is None:
                self._queue.task_done()
                return
            work, step, ev = item
            try:
                for pname, ids, values in work:
                    t0 = time.perf_counter()
                    self.tables[pname].apply_sparse(ids, values, step)
                    with self._lock:
                        self._dirty[pname].append(ids)
                    _M_FLUSH_SECONDS.labels(table=pname).observe(
                        time.perf_counter() - t0)
            except BaseException as e:            # surfaced at next call
                self._error = e
                logger.error("host-table flush failed: %s", e)
            finally:
                ev.set()
                self._queue.task_done()
                _M_FLUSH_QUEUE_DEPTH.set(self._queue.qsize())

    def _wait_conflicting(self, unique: Dict[str, np.ndarray]):
        with self._lock:
            pend = list(self._pending)
        for s, ev in pend:
            if not ev.is_set() and _overlaps(unique, s):
                ev.wait()
                self._raise_if_failed()

    def barrier(self):
        """Wait until every enqueued flush has been applied (the snapshot,
        pass-end and evaluation boundaries)."""
        self._queue.join()
        self._raise_if_failed()

    def _raise_if_failed(self):
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError(
                f"host-table flush worker failed: {err}") from err

    def reconfigure(self, cache_rows: Optional[int] = None,
                    staleness: Optional[str] = None,
                    flush_inflight: Optional[int] = None):
        """Apply changed knobs to a live runtime: a second train() on the
        same trainer reuses the runtime (the store holds the trained rows)
        but takes that call's sizing and staleness."""
        self.barrier()
        if staleness is not None:
            enforce(staleness in ("exact", "async"),
                    f"host_staleness must be exact|async, got {staleness!r}")
            self.staleness = staleness
        if cache_rows is not None and int(cache_rows or 0) != self._fixed_cap:
            self._fixed_cap = int(cache_rows or 0)
            with self._lock:
                # the resident caches were sized for the old capacity
                self._cap.clear()
                self._resident.clear()
                for p in self._dirty:
                    self._dirty[p] = []
        if flush_inflight is not None \
                and max(1, int(flush_inflight)) != self._queue.maxsize:
            # the worker blocks in get() on the old queue: stop it (the
            # queue is empty after the barrier) and start a new one
            self.close()
            self._start_worker(flush_inflight)

    # --- lifecycle / snapshot --------------------------------------------
    def close(self):
        if self._worker.is_alive():
            self._queue.put(None)
            self._worker.join(timeout=5)

    def state_dict(self) -> dict:
        self.barrier()
        return {p: t.state_dict() for p, t in self.tables.items()}

    def load_state(self, d: dict):
        self.barrier()
        for pname, st in (d or {}).items():
            if pname in self.tables:
                self.tables[pname].load_state(st)
        # resident rows may predate the restored state
        with self._lock:
            self._resident.clear()
            for p in self._dirty:
                self._dirty[p] = []


def build_runtime(topology, optimizer, pnames: Sequence[str],
                  parameters=None, cache_rows: int = 0,
                  staleness: str = "exact", flush_inflight: int = 4,
                  store_factory: Optional[Callable] = None,
                  seed: int = 1) -> HostTableRuntime:
    """A HostTableRuntime for the ``pnames`` host-resident tables of a
    topology: each table's id feeds from its embedding consumers, and its
    backing: dense from ``parameters`` where the table is materialized
    there (the exactness mode), else lazy rows from ``make_row_init``; or
    ``store_factory(pname, spec)``."""
    feeds_of = topology.host_table_feeds(pnames)
    specs = topology.param_specs()
    lr_mults = topology.lr_mults()
    tables = {}
    for pname in pnames:
        spec = specs[pname]
        if store_factory is not None:
            tables[pname] = store_factory(pname, spec)
            continue
        dense = None
        if parameters is not None and pname in parameters:
            dense = parameters[pname].detach().cpu().numpy()
        row_init = None if dense is not None else make_row_init(
            spec.attr, spec.fan_in, seed, pname)
        tables[pname] = HostRowStore(
            pname, spec.shape, optimizer, dense=dense, row_init=row_init,
            lr_mult=lr_mults.get(pname, 1.0))
    return HostTableRuntime(tables, feeds_of, cache_rows=cache_rows,
                            staleness=staleness,
                            flush_inflight=flush_inflight)
