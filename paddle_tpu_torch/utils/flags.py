"""Process-level flag registry (counterpart of
``paddle_tpu/utils/flags.py``; analog of paddle/utils/Flags.cpp). The port
defines the flags it reads so far, with the JAX package's defaults and
help strings: the feeder's packing and bucketing knobs, the train
loop's (its periodic log, stat dump and test, its pipeline depth and
staging arena, the dropout seed and the checkpoint directory), the
host-resident tables' selection threshold and cache size, and
``debug_nans``.
"""

from __future__ import annotations

import threading
from typing import Any, Dict


class _Flags:
    def __init__(self):
        self._defs: Dict[str, Any] = {}
        self._values: Dict[str, Any] = {}
        self._lock = threading.Lock()

    def define(self, name: str, default: Any, help_str: str = ""):
        with self._lock:
            self._defs[name] = (default, help_str)
            self._values.setdefault(name, default)

    def __getattr__(self, name: str):
        values = object.__getattribute__(self, "_values")
        if name in values:
            return values[name]
        raise AttributeError(f"unknown flag {name!r}")

    def get(self, name: str, default: Any = None):
        return self._values.get(name, default)

    def set(self, name: str, value: Any):
        with self._lock:
            self._values[name] = value


FLAGS = _Flags()


def define_flag(name, default, help_str=""):
    FLAGS.define(name, default, help_str)


define_flag("pack_sequences", False,
            "pack several ragged samples per feed row with segment ids")
define_flag("pack_max_len", 0,
            "packed row capacity T (0 = auto: 2x the batch's longest "
            "sample, bucketed)")
define_flag("bucket_rounding", 0,
            "pad sequence T to a multiple of N instead of the next power "
            "of two (0 = power-of-two)")
define_flag("log_period", 100, "batches between log lines")
define_flag("show_parameter_stats_period", 0,
            "batches between parameter stat dumps")
define_flag("test_period", 0, "batches between test runs (0 = per pass)")
define_flag("seed", 1,
            "global RNG seed (deterministic by default, like gserver)")
define_flag("save_dir", "", "checkpoint output dir")
define_flag("pipeline_depth", 2,
            "train-loop software pipeline depth: up to depth-1 dispatched "
            "steps stay in flight while the host feeds the next batch; "
            "0/1 = strictly synchronous (docs/torch_train_loop.md)")
define_flag("use_staging_arena", False,
            "assemble host batches in reusable staging buffers "
            "(io/staging.py, page-locked on CUDA, zero steady-state "
            "allocation); generation-rotated under pipelining")
define_flag("host_table_min_rows", 0,
            "sparse_update tables with at least this many rows train "
            "host-resident: host-RAM store + per-batch device row cache "
            "(0 = only ParamAttr(host_resident=True) tables; "
            "docs/torch_embedding_cache.md)")
define_flag("host_cache_rows", 0,
            "device row-cache capacity per host-resident table (rows; "
            "0 = auto: power-of-two bucket of the batch's unique-id "
            "count, grown on demand)")
define_flag("debug_nans", False,
            "SGD.train raises FloatingPointError at the first step whose "
            "cost or gradients are not finite (the FP-trap analog, "
            "TrainerMain.cpp:49); read when the trainer is built")
