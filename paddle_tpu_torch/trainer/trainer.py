"""SGD trainer: the event-loop training entry point (counterpart of
``paddle_tpu/trainer/trainer.py``; analog of python/paddle/v2/trainer.py
SGD.train with BeginPass/BeginIteration/EndIteration/EndPass events and
of TrainerInternal::trainOneBatch: forward, backward, update, metrics).

A step is eager PyTorch on the trainer's device: the loss's forward (the
recurrent layers through the ``fused_lstm`` / ``fused_gru`` kernels),
``loss.backward()`` (their backward kernels; autograd elsewhere, across a
recurrent group's tick loop too), the optimizer update, the batch-norm
moving statistics written into the parameters, and the evaluators'
statistics. ``SGD(mixed_precision=True)`` computes in bf16 over float32
masters (``Topology.loss_fn(compute_dtype=torch.bfloat16)``). The LSTM
and GRU kernels have bf16 forms (forward, backward recurrence and dW, the
GRU's grid and cluster kernels alike), as has the stem pool's backward;
the CRF and CTC Functions widen bf16 emissions to float32 around their
float32 kernels, as the JAX kernels compute (log Z and the NLL float32,
the gradients in their inputs' dtypes). ``vocab_xent``'s kernels, on no
layer's path, raise on a bf16 CUDA tensor. A ``sparse_update`` table
read through a selective_fc gather trains on its touched rows alone
(``make_train_step``). ``pack_sequences=True`` packs several ragged
samples into each row (docs/packing.md): the recurrent layers reset their
carry at each packed sequence (the kernels' reset input), attention keeps
to each sequence, and the loss divides by sequences, so the trajectory is
the padded run's.

The loop is the JAX package's long-run loop (docs/torch_train_loop.md):

- pipelined: ``pipeline_depth`` (None: the flag, default 2) keeps up to
  depth - 1 steps in flight. Their costs, metrics and parameter stats
  are copied to the host without blocking and read in batch order when a
  step is drained, so events, evaluator values and logs are the
  synchronous loop's. On CUDA a batch's host-to-device copy runs on a
  copy stream the compute stream waits on; with the staging arena
  (``use_staging_arena``) it copies from page-locked buffers rotated
  through ``depth`` generations;
- ``num_batches_per_send_parameter`` = N accumulates N batches'
  gradients into one update, with a pass-end update of a partial tail;
- ``save_every_n_batches`` step snapshots (io/checkpoint.py), resume from
  ``load_step_resume``, ``preempt_event``; snapshot, test and preemption
  boundaries drain the pipeline first;
- Polyak averaging (``optimizer.ModelAverage``): ``test`` evaluates the
  averaged weights and ``averaged_parameters()`` swaps them in;
- the flags ``log_period``, ``show_parameter_stats_period`` and
  ``test_period``, and the ``paddle_train_*`` metrics
  (observability/metrics.py), under the JAX package's names.

Host-resident embedding tables (``host_tables``, ``host_cache_rows``,
``host_store``, ``host_staleness``, ``host_flush_inflight`` and the
``host_table_min_rows`` / ``host_cache_rows`` flags;
docs/torch_embedding_cache.md): the table lives in a host row store
(host_table.py), the feed phase stages each batch's touched rows into a
``[cache_rows, D]`` cache that rides the feeds' host-to-device copy, the
step trains on the cache alone, and each drained batch's cache-row
gradients flush back to the store. The ``debug_nans`` flag, read when the
trainer is built, makes a step raise ``FloatingPointError`` at a
non-finite cost or gradient.

Not ported yet, and refused when asked for: continuous publishing
(ROADMAP queue 1 item 2.4) and meshes (item 7).
"""

from __future__ import annotations

import contextlib
import copy
import logging
import time
from collections import deque
from typing import Dict, Optional, Sequence, Union

import numpy as np
import torch

from paddle_tpu_torch.core.arg import Arg
from paddle_tpu_torch.core.parameters import Parameters
from paddle_tpu_torch.core.topology import Topology
from paddle_tpu_torch.observability import metrics as obs_metrics
from paddle_tpu_torch.optimizer import Optimizer
from paddle_tpu_torch.sparse_grad import SparseRowGrad
from paddle_tpu_torch.trainer import event as v2_event
from paddle_tpu_torch.trainer.feeder import DataFeeder, resolve_pack_flags
from paddle_tpu_torch.utils.device import resolve_device
from paddle_tpu_torch.utils.error import Error, enforce
from paddle_tpu_torch.utils.flags import FLAGS
from paddle_tpu_torch.utils.stat import timer_scope

logger = logging.getLogger("paddle_tpu_torch")

# --- train-loop telemetry: the JAX package's series, host-side only -------
_M_STEP_SECONDS = obs_metrics.histogram(
    "paddle_train_step_seconds",
    "Per-batch wall time by phase: data_wait (reader next), feed (host "
    "batch->device args + prefetch device_put), dispatch (jitted step "
    "enqueue), drain (blocked fetching that batch's cost), compute "
    "(dispatch+drain — non-overlapped device time once pipelined)",
    labels=("phase",))
_M_BATCHES = obs_metrics.counter(
    "paddle_train_batches_total", "Batches trained by SGD.train")
_M_EXAMPLES = obs_metrics.counter(
    "paddle_train_examples_total", "Examples consumed by SGD.train")
_M_EXAMPLES_PER_SEC = obs_metrics.gauge(
    "paddle_train_examples_per_sec",
    "Examples/sec over the wall clock between consecutive steady-state "
    "drained batches (overlap-aware; the pre-pipeline "
    "n/(wait+feed+compute) double-counted once phases overlapped; "
    "back-to-back boundary drains don't update rate gauges)")
_M_INFLIGHT = obs_metrics.gauge(
    "paddle_train_inflight_batches",
    "Dispatched-but-undrained train steps (<= pipeline_depth - 1; 0 "
    "means the loop is running synchronously or fully drained)")
_M_TFLOPS = obs_metrics.gauge(
    "paddle_train_achieved_tflops_per_sec",
    "Analytic model TFLOP/s of the last compute phase (flops.py)")
_M_MFU = obs_metrics.gauge(
    "paddle_train_mfu",
    "Model FLOP utilization of the last step vs the chip's published "
    "peak (unset on platforms without one, e.g. the CPU test mesh)")
_M_SNAPSHOTS = obs_metrics.counter(
    "paddle_train_step_snapshots_total", "Mid-pass step snapshots written")
_M_PREEMPTIONS = obs_metrics.counter(
    "paddle_train_preemptions_total",
    "Preemption requests honored at a batch boundary")

# SGD.train options of the JAX package this port does not have yet, with
# the value that leaves them off and the ROADMAP queue 1 item that ports
# them
_UNPORTED_TRAIN = {
    "publish_every_n_batches": (0, "2.4"), "publish_dir": (None, "2.4"),
    "publish_url": (None, "2.4"), "publisher": (None, "2.4"),
    "publish_topology": (None, "2.4"),
    "publish_rows_every_n_batches": (0, "2.4"),
}

#: the train_state key of the port's dropout generator; a JAX snapshot's
#: "rng" (a JAX key) cannot continue a torch.Generator
GENERATOR_KEY = "torch_generator"


def _refuse_unported(where: str, kw: dict, known) -> None:
    for name, value in kw.items():
        if name not in known:
            raise TypeError(f"{where}() got an unexpected keyword argument "
                            f"{name!r}")
        default, item = known[name]
        if value != default:
            raise Error(f"{where}: {name}={value!r} is not ported yet "
                        f"(ROADMAP.md, queue 1 item {item})")


class _TimedBatches:
    """Iterator adapter timing each ``next`` on the reader: the
    consumer-side data-wait half of the step-time split."""

    __slots__ = ("_it", "last_wait")

    def __init__(self, it):
        self._it = it
        self.last_wait = 0.0

    def __iter__(self):
        return self

    def __next__(self):
        t0 = time.perf_counter()
        item = next(self._it)
        self.last_wait = time.perf_counter() - t0
        _M_STEP_SECONDS.labels(phase="data_wait").observe(self.last_wait)
        return item


class _InFlight:
    """One dispatched, undrained step: what the drain side needs to fire
    batch N's events once the dispatch frontier has moved on. ``cost``,
    ``metrics`` and ``param_stats`` are host copies started without
    blocking (on CUDA) and complete once ``ready`` (a CUDA event, None
    elsewhere) has fired."""

    __slots__ = ("batch_id", "cost", "metrics", "n_examples", "dispatch_s",
                 "step_flops", "param_stats", "ready", "host_token",
                 "host_grads")

    def __init__(self, batch_id, cost, metrics, n_examples, dispatch_s,
                 step_flops, param_stats=None, ready=None, host_token=None,
                 host_grads=None):
        self.batch_id = batch_id
        self.cost = cost
        self.metrics = metrics
        self.n_examples = n_examples
        self.dispatch_s = dispatch_s
        self.step_flops = step_flops
        self.param_stats = param_stats
        self.ready = ready
        # host-resident tables: the staged batch and its cache-row
        # gradients, flushed to the store when the step is drained
        self.host_token = host_token
        self.host_grads = host_grads


def _compute_metrics(evaluators, outs, loss, feeds):
    """Every evaluator's statistics of the batch. Each evaluator's
    ``packed_feed`` is set first from the loss's packed check (the one
    that sets ``ctx.packed``): seg_ids alone cannot tell packed rows from
    nested feeds, whose evaluators keep their per-row counting."""
    fp = getattr(loss, "_feeds_packed", None)
    packed = bool(fp(feeds)) if fp is not None else False
    with torch.no_grad():
        metrics = {}
        for name, ev in evaluators.items():
            ev.packed_feed = packed
            metrics[name] = ev.compute(outs)
        return metrics


def _host_async(tree):
    """``tree`` with every CUDA tensor copied to pinned host memory
    without blocking (complete once an event recorded after it fires)."""
    if isinstance(tree, dict):
        return {k: _host_async(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_host_async(v) for v in tree)
    if isinstance(tree, torch.Tensor) and tree.is_cuda:
        return tree.detach().to("cpu", non_blocking=True)
    return tree


def _device_tree(tree, device):
    """A canonical (numpy) optimizer state as the loop keeps it: arrays
    as tensors on ``device``, but ``__step__`` and ``__avg_n__`` on the
    host (``Optimizer.init``'s placement) and the accumulation wrapper's
    counter ``k`` a host int."""
    def conv(t):
        out = {}
        for k, v in t.items():
            if isinstance(v, dict):
                out[k] = conv(v)
            elif k in ("__step__", "__avg_n__"):
                out[k] = torch.from_numpy(np.array(v, copy=True))
            elif isinstance(v, np.ndarray):
                out[k] = torch.from_numpy(np.array(v, copy=True)).to(device)
            else:
                out[k] = v
        return out

    out = conv(tree)
    if "opt" in out and "k" in out:
        out["k"] = int(out["k"])
    return out


def _check_finite(cost, grads):
    """The ``debug_nans`` check of one step: raise ``FloatingPointError``
    when the cost or a gradient holds a NaN or an infinity, naming the
    first such parameter in name order. One device read for all of
    them."""
    names = sorted(grads)
    vals = [g.values if isinstance(g, SparseRowGrad) else g
            for g in (grads[k] for k in names)]
    ok = torch.stack([torch.isfinite(cost.detach()).all()]
                     + [torch.isfinite(v).all() for v in vals]).cpu()
    if bool(ok.all()):
        return
    bad = next((k for k, good in zip(names, ok[1:].tolist()) if not good),
               None)
    raise FloatingPointError(
        f"debug_nans: cost {float(cost.detach()):g}"
        + (f", first non-finite gradient: {bad!r}" if bad is not None
           else ", every gradient finite"))


def make_train_step(loss, optimizer: Optimizer, static: Dict[str, bool],
                    lr_mults: Optional[Dict[str, float]] = None,
                    evaluators=None, accum_steps: int = 1,
                    host_tables: Sequence[str] = (),
                    debug_nans: bool = False):
    """The train step (TrainerInternal::trainOneBatch): forward,
    ``loss.backward()``, the optimizer update and the evaluators'
    statistics. ``step(params, opt_state, feeds, generator=None) ->
    (new_params, new_opt_state, cost, metrics)``; params are plain tensors
    on one device, and the returned ones are new tensors, but for the
    tables a sparse-row gradient updates in place. Static parameters get
    no gradient; the loss's aux updates (batch-norm's moving statistics,
    ``Topology.aux_updates``) replace theirs after the optimizer step.

    Sparse-row gradients (the reference's SparseRowMatrix sgdUpdate):
    when the loss comes from Topology.loss_fn over a model with
    ``sparse_update`` parameters, the forward runs the protocol
    (core/layer.py ForwardContext.sparse_rows), and a table that a
    selective_fc gather read reaches the optimizer as
    ``SparseRowGrad(rows, leaf.grad)``: no [C, D] gradient or zero buffer
    exists in the step. Caveat, as in the JAX package: such a table must
    be read only through that gather in the step; a second, dense use
    contributes no gradient.

    ``accum_steps`` = N > 1 is the reference's local gradient
    accumulation (``num_batches_per_send_parameter``,
    TrainerInternal.cpp:245-252): the state is JAX's ``{"opt", "acc",
    "k"}``, the gradients of N consecutive batches sum into ``acc`` and
    the N-th applies ONE update from their mean. ``k`` is a host int, so
    deciding to apply needs no device read. As in the JAX package the
    accumulator is dense: sparse-row gradients are off.

    ``host_tables`` (docs/torch_embedding_cache.md) names parameters whose
    entry in ``params`` is the [cache_rows, D] device row cache of a
    host-resident table. They are static to the optimizer (the host store
    applies their update), but their gradients, dense over the cache, are
    taken and returned as a fifth output ``{name: [cache_rows, D]}``.
    ``debug_nans`` adds a check after the backward that raises
    ``FloatingPointError`` at a non-finite cost or gradient (one device
    read a step); without it the step has no check and no read."""
    evaluators = dict(evaluators or {})
    host_tables = tuple(host_tables)
    if host_tables and accum_steps > 1:
        raise NotImplementedError(
            "host-resident tables do not compose with gradient "
            "accumulation (accum_steps > 1): the dense accumulator would "
            "span cache generations whose slot->row maps differ")
    if host_tables and optimizer.clip_threshold and optimizer.global_clipping:
        raise NotImplementedError(
            "host-resident tables do not compose with global_clipping: "
            "cache grads are popped before the global-norm computation, "
            "so the table would train unclipped and every other param "
            "would see a different clip scale than HBM-resident training")
    if host_tables and optimizer.model_average is not None:
        raise NotImplementedError(
            "host-resident tables do not compose with model_average: the "
            "Polyak window has no slot for a table that never lives in "
            "device memory (per-batch cache slots cannot be averaged)")
    sparse_capable = getattr(loss, "_sparse_capable", False) \
        and accum_steps <= 1
    # the parameters that take no gradient: static ones, but not the
    # host tables' caches
    frozen = {k for k, v in static.items() if v and k not in host_tables}

    def grads_of(params, feeds, generator):
        leaves = {k: (v if k in frozen else
                      v.detach().requires_grad_(True))
                  for k, v in params.items()}
        sparse = {} if sparse_capable else None
        kw = {"sparse_rows": sparse} if sparse_capable else {}
        cost, (outs, aux) = loss(leaves, feeds, generator=generator,
                                 training=True, **kw)
        cost.backward()
        grads = {}
        for k, v in leaves.items():
            if k in frozen:
                continue
            if sparse and k in sparse:
                rows, leaf = sparse[k]
                rows = rows.reshape(-1)
                g = leaf.grad if leaf.grad is not None else \
                    torch.zeros_like(leaf)
                grads[k] = SparseRowGrad(
                    rows, g.reshape(rows.shape[0], -1).to(params[k].dtype),
                    tuple(params[k].shape))
            else:
                # a parameter the loss does not reach gets a zero gradient,
                # as jax.grad gives it (its optimizer state still steps)
                grads[k] = v.grad if v.grad is not None else \
                    torch.zeros_like(v)
        if debug_nans:
            _check_finite(cost, grads)
        return cost, outs, aux, grads

    def step(params, opt_state, feeds, generator=None):
        cost, outs, aux, grads = grads_of(params, feeds, generator)
        host_grads = {k: grads.pop(k) for k in host_tables if k in grads}
        new_params, new_opt_state = optimizer.update(grads, opt_state,
                                                     params, lr_mults, static)
        new_params.update(aux)
        metrics = _compute_metrics(evaluators, outs, loss, feeds)
        if host_tables:
            return (new_params, new_opt_state, cost.detach(), metrics,
                    host_grads)
        return new_params, new_opt_state, cost.detach(), metrics

    if accum_steps <= 1:
        return step

    def accum_step(params, acc_state, feeds, generator=None):
        opt_state, acc, k = (acc_state["opt"], acc_state["acc"],
                             acc_state["k"])
        cost, outs, aux, grads = grads_of(params, feeds, generator)
        with torch.no_grad():
            # JAX's acc covers every parameter; a static one adds zeros
            acc = {n: a + grads[n] if n in grads else a
                   for n, a in acc.items()}
        k += 1
        if k >= accum_steps:
            with torch.no_grad():
                mean = {n: a / float(accum_steps) for n, a in acc.items()}
            new_params, opt_state = optimizer.update(
                mean, opt_state, params, lr_mults, static)
            acc = {n: torch.zeros_like(a) for n, a in acc.items()}
            k = 0
        else:
            new_params = dict(params)
        # batch-norm's moving statistics still fold in every batch
        new_params.update(aux)
        metrics = _compute_metrics(evaluators, outs, loss, feeds)
        return (new_params, {"opt": opt_state, "acc": acc, "k": k},
                cost.detach(), metrics)

    return accum_step


def init_accum_state(opt_state, params):
    """Initial optimizer + accumulator state of an accumulating step."""
    with torch.no_grad():
        return {"opt": opt_state,
                "acc": {k: torch.zeros_like(v) for k, v in params.items()},
                "k": 0}


class SGD:
    """paddle.v2.trainer.SGD analog. Trains on ``device`` ("cuda" unless
    the caller asks for another); without a GPU the CUDA default raises
    rather than moving to the CPU."""

    def __init__(self, cost, parameters: Parameters,
                 update_equation: Optimizer,
                 extra_layers: Optional[Sequence] = None,
                 is_local: bool = True, mesh=None,
                 evaluators: Optional[Dict[str, object]] = None,
                 donate_params: bool = True, mixed_precision: bool = False,
                 num_batches_per_send_parameter: int = 1,
                 device: Union[str, torch.device] = "cuda"):
        enforce(mesh is None, "SGD: meshes (data parallelism) are not "
                "ported yet (ROADMAP.md, queue 1 item 7)")
        self.device = resolve_device(device)
        self.topology = Topology([cost] + list(extra_layers or []))
        self.cost_name = cost.name if hasattr(cost, "name") else cost
        self.parameters = parameters
        self.optimizer = update_equation
        self.evaluators = dict(evaluators or {})
        # local gradient accumulation (num_batches_per_send_parameter,
        # TrainerInternal.cpp:245-252): N batches' grads -> one update
        self._accum_steps = max(1, int(num_batches_per_send_parameter))
        # mixed precision: bf16 compute over float32 master weights
        self._loss = self.topology.loss_fn(
            cost, compute_dtype=torch.bfloat16 if mixed_precision else None)
        self._static = self.topology.static_map()
        self._lr_mults = self.topology.lr_mults()
        # the FP-trap analog (TrainerMain.cpp:49), read here as the JAX
        # package reads it, but scoped to this trainer's steps
        self._debug_nans = bool(FLAGS.get("debug_nans", False))
        # host-resident embedding tables (docs/torch_embedding_cache.md):
        # the runtime is built by train(); () = every table on the device
        self._host_rt = None
        self._host_tables: tuple = ()
        self._train_step = self._build_train_step()
        self._opt_state = None
        self._batch_counter = 0
        self.preempted = False
        # analytic FLOPs per batch shape, for the MFU gauge (None: the
        # topology cannot be priced)
        self._flops_cache: Dict[tuple, Optional[float]] = {}
        # the pipelined loop's H2D copy stream (CUDA), made at first use,
        # and each staging generation's last copy event
        self._copy_stream = None
        self._copy_events: Dict[int, object] = {}

    def _build_train_step(self):
        return make_train_step(self._loss, self.optimizer, self._static,
                               self._lr_mults, self.evaluators,
                               accum_steps=self._accum_steps,
                               host_tables=self._host_tables,
                               debug_nans=self._debug_nans)

    def _device_params(self) -> Dict[str, torch.Tensor]:
        # a copy on every device: the sparse-row update writes rows in
        # place, and the caller's tensors change only at update_from. A
        # host-resident table never goes to the device: its cache does
        return {k: v.to(self.device, copy=True)
                for k, v in self.parameters.as_dict().items()
                if k not in self._host_tables}

    def _caches_to_device(self, caches) -> Dict[str, torch.Tensor]:
        return {k: torch.from_numpy(c).to(self.device)
                for k, c in caches.items()}

    # --- host-resident tables (docs/torch_embedding_cache.md) -------------
    def _strip_host(self, params: Dict[str, torch.Tensor]):
        """``params`` without the host tables' entries (they hold the
        batch's device cache, not the table)."""
        if not self._host_tables:
            return params
        return {k: v for k, v in params.items()
                if k not in self._host_tables}

    def _sync_host_tables_back(self):
        """Write each dense-backed store's trained table into
        ``self.parameters`` (EndPass handlers, checkpoints and Inference
        read them there); a lazy store has no dense twin, and its rows
        stay in the store (and in step snapshots)."""
        if self._host_rt is None:
            return
        for name, store in self._host_rt.tables.items():
            snap = getattr(store, "dense_snapshot", lambda: None)()
            if snap is not None:
                self.parameters.set(name, torch.from_numpy(snap))

    def _teardown_host_tables(self):
        """Undo a host-table run on this trainer: land every flush, write
        dense-backed tables (rows and optimizer slots) back for the device
        path, stop the flush worker, and restore the static flags and the
        train step. No-op when host mode was never on."""
        if self._host_rt is not None:
            self._host_rt.barrier()
            self._sync_host_tables_back()
            for pname, store in self._host_rt.tables.items():
                snap = getattr(store, "dense_slot_snapshot",
                               lambda: None)()
                if snap is not None and self._opt_state is not None \
                        and pname in self._opt_state:
                    self._opt_state[pname] = {
                        k: torch.from_numpy(np.array(v)).to(self.device)
                        for k, v in snap.items()}
            self._host_rt.close()
        if self._host_tables:
            orig = self.topology.static_map()
            for pname in self._host_tables:
                self._static[pname] = orig.get(pname, False)
            self._host_tables = ()
            self._train_step = self._build_train_step()
        self._host_rt = None

    def _setup_host_tables(self, host_tables, host_cache_rows, host_store,
                           host_staleness, host_flush_inflight):
        """Resolve and build the host-table runtime of a train run (the
        JAX package's rules): ``host_tables`` None selects the
        ``ParamAttr(host_resident=True)`` tables and, with the
        ``host_table_min_rows`` flag, the sparse_update tables that large;
        ``host_cache_rows`` None reads its flag. Returns the table names,
        () when host mode is off."""
        from paddle_tpu_torch.host_table import build_runtime

        if host_tables is None:
            min_rows = int(FLAGS.get("host_table_min_rows", 0) or 0)
            host_tables = self.topology.host_param_names(min_rows)
        host_tables = tuple(sorted(host_tables))
        for pname in self.topology.host_param_names(0):
            enforce(pname in host_tables or pname in self.parameters,
                    f"table {pname!r} is ParamAttr(host_resident=True) "
                    "and was never materialized on device; it cannot "
                    "train with host mode disabled for it (include it "
                    "in host_tables or drop the attr)")
        if self._host_rt is not None and self._host_tables != host_tables:
            # a store with no dense twin cannot be written back into the
            # parameters: dropping it would abandon its trained rows
            for pname, store in self._host_rt.tables.items():
                if getattr(store, "dense_snapshot", None) is not None:
                    continue
                enforce(pname in host_tables and callable(host_store),
                        f"host table {pname!r} is backed by a store with "
                        "no dense twin; its rows cannot be synced back "
                        "into trainer parameters — keep it in host_tables "
                        "with the same host_store")
        if not host_tables:
            self._teardown_host_tables()
            return ()
        if host_cache_rows is None:
            host_cache_rows = int(FLAGS.get("host_cache_rows", 0) or 0)
        if host_staleness is None:
            host_staleness = "exact"
        if self._host_rt is not None and self._host_tables == host_tables:
            # the same tables again: the store holds the trained rows;
            # apply this call's knobs
            self._host_rt.reconfigure(cache_rows=host_cache_rows,
                                      staleness=host_staleness,
                                      flush_inflight=host_flush_inflight)
            return host_tables
        self._teardown_host_tables()
        self._host_tables = host_tables
        # the cache is fed every batch and updated on the host: the device
        # optimizer never touches it
        for pname in host_tables:
            self._static[pname] = True
        self._train_step = self._build_train_step()
        self._host_rt = build_runtime(
            self.topology, self.optimizer, host_tables,
            parameters=self.parameters, cache_rows=host_cache_rows,
            staleness=host_staleness, flush_inflight=host_flush_inflight,
            store_factory=host_store if callable(host_store) else None,
            seed=FLAGS.get("seed", 1))
        return host_tables

    def _feeder(self, feeding, bucket_rounding, pack_sequences=None,
                pack_max_len=None, pack_row_rounding=None, **arena):
        """The DataFeeder of a train or test run, the flags resolved as the
        JAX package resolves them (``resolve_pack_flags``)."""
        pack, pack_max_len, bucket_rounding = resolve_pack_flags(
            pack_sequences, pack_max_len, bucket_rounding)
        return DataFeeder(self.topology.data_type(), feeding,
                          bucket_rounding=bucket_rounding,
                          pack_sequences=pack, pack_max_len=pack_max_len,
                          pack_row_rounding=pack_row_rounding, **arena)

    def _copy_to_device(self, host_feeds, gen, caches):
        """The pipelined loop's host-to-device copy of a batch (CUDA): on
        the copy stream, non-blocking (asynchronous from the staging
        arena's pinned buffers), the compute stream waiting on its event
        and every copied tensor recorded on the compute stream so the
        caching allocator keeps it until the step using it has run. The
        event is kept as generation ``gen``'s. ``caches`` (host tables'
        row caches, numpy) ride the same copy. Returns (feeds, caches)."""
        if self._copy_stream is None:
            self._copy_stream = torch.cuda.Stream(device=self.device)
        compute = torch.cuda.current_stream(self.device)

        def move(t):
            if t is None:
                return None
            t = torch.as_tensor(t).to(self.device, non_blocking=True)
            t.record_stream(compute)
            return t

        with torch.cuda.stream(self._copy_stream):
            feeds = {k: Arg(move(a.value), move(a.mask), move(a.seg_ids))
                     for k, a in host_feeds.items()}
            caches = {k: move(c) for k, c in caches.items()}
            done = torch.cuda.Event()
            done.record(self._copy_stream)
        compute.wait_event(done)
        self._copy_events[gen] = done
        return feeds, caches

    def _flops_for(self, key: tuple, feeds) -> Optional[float]:
        """Cached train FLOPs of one batch of this shape (flops.py), None
        when the topology cannot be priced; never raises into the loop."""
        if key in self._flops_cache:
            return self._flops_cache[key]
        try:
            from paddle_tpu_torch.flops import train_flops

            batch, seq = 1, 1
            for v in feeds.values():
                shp = np.shape(v.value)
                if shp:
                    batch = int(shp[0])
                if v.mask is not None and len(shp) > 1:
                    seq = max(seq, int(shp[1]))
            val = train_flops(self.topology, batch, seq)
        except Exception:
            val = None
        self._flops_cache[key] = val
        return val

    @staticmethod
    def _shape_key(feeds) -> tuple:
        return tuple(sorted((k, tuple(np.shape(v.value)),
                             v.mask is not None) for k, v in feeds.items()))

    @staticmethod
    def _param_stats(params):
        """The show_parameter_stats_period dump's avg and max |value| of
        every parameter, reduced on the device: only two scalars a
        parameter cross to the host, at drain."""
        with torch.no_grad():
            return {k: (v.abs().float().mean(), v.abs().max())
                    for k, v in params.items()}

    def _flush_accum(self, params, acc_state):
        """Apply a pending partial accumulation (k < N tail batches)."""
        k = int(acc_state["k"])
        if k == 0:
            return params, acc_state
        with torch.no_grad():
            mean = {n: a / float(k) for n, a in acc_state["acc"].items()}
        new_params, new_opt = self.optimizer.update(
            mean, acc_state["opt"], params, self._lr_mults, self._static)
        zero = {n: torch.zeros_like(a) for n, a in acc_state["acc"].items()}
        return new_params, {"opt": new_opt, "acc": zero, "k": 0}

    def _canonical_opt_state(self, opt_state):
        """The in-loop state as a snapshot holds it: the accumulation
        counter as JAX's int32 0-d array."""
        if self._accum_steps > 1:
            return {**opt_state, "k": np.asarray(opt_state["k"], np.int32)}
        return opt_state

    # --- crash-safe step snapshots ---------------------------------------
    def _save_step_snapshot(self, snapshot_dir, params, opt_state,
                            generator, pass_id, batch_id, reader, pass_cost,
                            pass_batches, keep):
        """Write snapshot_dir/step-<global_step>: params, the whole
        in-loop optimizer state (with the accumulation wrapper) and a
        train_state pickle with what replay needs: the dropout
        generator's state, the evaluators' partial sums, the reader's
        position and the pass's running cost. The atomic writer keeps the
        previous snapshot loadable if this one is torn."""
        from paddle_tpu_torch.io import checkpoint as ckpt

        self.parameters.update_from(self._strip_host(params))
        host_opt = ckpt.host_tree(self._canonical_opt_state(opt_state))
        ev_states = {name: {k: (v.detach().cpu().numpy()
                                if isinstance(v, torch.Tensor)
                                else copy.deepcopy(v))
                            for k, v in ev.__dict__.items()}
                     for name, ev in self.evaluators.items()}
        reader_state = reader.state() if hasattr(reader, "state") else None
        train_state = {GENERATOR_KEY: {
                           "device": generator.device.type,
                           "state": generator.get_state().numpy()},
                       "evaluators": ev_states,
                       "reader_state": reader_state,
                       "pass_cost": float(pass_cost),
                       "pass_batches": int(pass_batches)}
        if self._host_rt is not None:
            # the host tables' rows and per-row slots, after a barrier:
            # every drained batch's update is in
            train_state["host_tables"] = self._host_rt.state_dict()
        meta = {"pass_id": int(pass_id), "batch_id": int(batch_id),
                "accum_steps": self._accum_steps}
        path = ckpt.save_step(snapshot_dir, self._batch_counter,
                              self.parameters, host_opt, meta, train_state,
                              keep=keep)
        _M_SNAPSHOTS.inc()
        logger.info("step snapshot %s (pass %d batch %d)", path, pass_id,
                    batch_id)
        return path

    @staticmethod
    def load_step_resume(save_dir):
        """The newest VALID step snapshot under ``save_dir`` as
        (Parameters, resume_state) for ``train(..., resume_state=...)``,
        or None when there is none. Torn or corrupt snapshots are skipped
        with a warning. The resume state's ``generator`` is the port's
        generator state, or None in a JAX package's snapshot, whose
        ``rng`` (a JAX key) a torch.Generator cannot continue."""
        from paddle_tpu_torch.io import checkpoint as ckpt

        found = ckpt.find_latest_step(save_dir)
        if found is None:
            return None
        step, path = found
        params, opt_state, meta = ckpt.load_checkpoint(path)
        ts = meta.get("train_state") or {}
        resume_state = {
            "pass_id": int(meta.get("pass_id", 0)),
            "batch_id": int(meta.get("batch_id", -1)),
            "global_step": int(meta.get("global_step", step)),
            "opt_state": opt_state,
            "generator": ts.get(GENERATOR_KEY),
            "rng": ts.get("rng"),
            "evaluators": ts.get("evaluators"),
            "reader_state": ts.get("reader_state"),
            "pass_cost": float(ts.get("pass_cost", 0.0)),
            "pass_batches": int(ts.get("pass_batches", 0)),
            "host_tables": ts.get("host_tables"),
            "path": path,
        }
        return params, resume_state

    def _resume_generator(self, resume, generator):
        """The dropout generator of a train run: the caller's, else the
        snapshot's state restored, else seeded from the ``seed`` flag. A
        JAX snapshot carries a JAX key, which cannot continue a
        torch.Generator: without ``generator=`` it raises."""
        if generator is not None:
            return generator
        gen = torch.Generator(device=self.device)
        saved = resume.get("generator")
        if saved is not None:
            enforce(saved["device"] == self.device.type,
                    f"SGD.train: the snapshot's generator state is a "
                    f"{saved['device']} generator's; this trainer runs on "
                    f"{self.device.type} (pass generator=)")
            gen.set_state(torch.from_numpy(np.array(saved["state"])))
            return gen
        if resume.get("rng") is not None:
            raise Error(
                "SGD.train: resume_state carries a JAX PRNG key ('rng', "
                f"from {resume.get('path', 'a JAX snapshot')}) and no "
                f"'{GENERATOR_KEY}' state; a JAX key cannot continue a "
                "torch.Generator, so dropout would not replay: pass "
                "generator= to resume from it")
        return gen.manual_seed(int(FLAGS.get("seed", 1)))

    # --- public API -------------------------------------------------------
    def train(self, reader, num_passes: int = 1, event_handler=None,
              feeding=None, test_reader=None, start_pass: int = 0,
              save_every_n_batches: int = 0, snapshot_dir: str = None,
              resume_state: dict = None, preempt_event=None,
              keep_snapshots: int = 3, pipeline_depth: Optional[int] = None,
              use_staging_arena: Optional[bool] = None,
              bucket_rounding: Optional[int] = None,
              pack_sequences: Optional[bool] = None,
              pack_max_len: Optional[int] = None,
              pack_row_rounding: Optional[int] = None,
              host_tables: Optional[Sequence[str]] = None,
              host_cache_rows: Optional[int] = None,
              host_store=None, host_staleness: Optional[str] = None,
              host_flush_inflight: int = 4,
              generator: Optional[torch.Generator] = None, **unported):
        """Train over ``num_passes`` passes of ``reader`` (a reader of
        batches), firing the v2 events through ``event_handler``.
        ``start_pass`` resumes pass numbering: the caller has loaded the
        matching checkpoint.

        ``pipeline_depth`` (None: the flag, default 2) keeps up to
        depth - 1 steps in flight; 0 or 1 is the synchronous loop. The
        events, costs, evaluator values and logs are the synchronous
        loop's at any depth. ``use_staging_arena`` (None: the flag,
        default off) assembles batches in reusable buffers, page-locked
        on CUDA, rotated through ``depth`` generations.

        ``save_every_n_batches`` > 0 with a ``snapshot_dir`` writes a step
        snapshot every N batches and at preemption, keeping the newest
        ``keep_snapshots``; ``resume_state`` (from ``load_step_resume``)
        restores parameters, optimizer state, the dropout generator, the
        evaluators and a ``checkpointable`` reader's position, so the run
        continues the uninterrupted trajectory. ``preempt_event`` (a
        threading.Event) asks for snapshot-then-return at the next batch
        boundary; ``self.preempted`` reports it. A finished run clears
        its step snapshots. A JAX snapshot's generator is a JAX key: to
        resume one, pass ``generator=``.

        ``pack_sequences``, ``pack_max_len`` (None: their flags),
        ``pack_row_rounding`` and ``bucket_rounding`` are the
        DataFeeder's knobs (docs/packing.md); the tests use them too.
        ``generator`` feeds dropout (default: seeded from the ``seed``
        flag on the trainer's device).

        Host-resident tables (docs/torch_embedding_cache.md):
        ``host_tables`` (None: the ``ParamAttr(host_resident=True)``
        tables plus the ``host_table_min_rows`` flag's selection; []
        turns host mode off) names embedding tables kept in a host row
        store, not on the device. Each batch the feed phase stages the
        touched rows into a ``host_cache_rows``-row device cache (None:
        the flag; 0 sizes it to the batch), the step sees only the cache,
        and the cache-row gradients flush back to the store through a
        worker queue at most ``host_flush_inflight`` deep, with lazy
        per-row catch-up. ``host_staleness="exact"`` (default) drains the
        pipeline where a batch touches a row an in-flight batch touched,
        so the trajectory is the device-resident one; ``"async"``
        accepts up to depth - 1 batches of row staleness. ``host_store``
        may be a callable ``(pname, spec) -> store``."""
        _refuse_unported("SGD.train", unported, _UNPORTED_TRAIN)
        if event_handler is None:
            event_handler = _default_event_handler
        self.preempted = False
        if pipeline_depth is None:
            pipeline_depth = FLAGS.get("pipeline_depth", 2)
        depth = max(1, int(pipeline_depth))
        if use_staging_arena is None:
            use_staging_arena = bool(FLAGS.get("use_staging_arena", False))
        cuda = self.device.type == "cuda"
        pipelined_copy = cuda and depth > 1
        pack = dict(pack_sequences=pack_sequences, pack_max_len=pack_max_len,
                    pack_row_rounding=pack_row_rounding)
        feeder = self._feeder(feeding, bucket_rounding, **pack,
                              use_staging_arena=use_staging_arena,
                              rotate_buffers=depth, pin_memory=cuda)
        self._copy_events = {}
        host_tables = self._setup_host_tables(
            host_tables, host_cache_rows, host_store, host_staleness,
            host_flush_inflight)
        host_rt = self._host_rt
        params = self._device_params()
        resume = dict(resume_state or {})
        resume_batch = int(resume.get("batch_id", -1)) if resume else -1
        if resume:
            start_pass = int(resume.get("pass_id", start_pass))
            self._batch_counter = int(resume.get("global_step",
                                                 self._batch_counter))
        if resume.get("opt_state") is not None:
            opt_state = _device_tree(resume["opt_state"], self.device)
            if self._accum_steps > 1 and "opt" not in opt_state:
                opt_state = init_accum_state(opt_state, params)
            elif self._accum_steps <= 1 and "opt" in opt_state:
                enforce(int(opt_state["k"]) == 0,
                        "SGD.train: the snapshot holds a partial gradient "
                        "accumulation; resume it with the same "
                        "num_batches_per_send_parameter")
                opt_state = opt_state["opt"]
            self._opt_state = (opt_state["opt"] if self._accum_steps > 1
                               else opt_state)
        else:
            if self._opt_state is None:
                self._opt_state = self.optimizer.init(params)
            opt_state = self._opt_state
            if self._accum_steps > 1:
                opt_state = init_accum_state(opt_state, params)
        for pname in host_tables:
            prev = self._opt_state.get(pname)
            if prev:
                # host mode on a trainer with device optimizer state: the
                # table's [V, D] slots go to the store, stamped current
                seed = getattr(host_rt.tables[pname], "seed_slots", None)
                if seed is not None:
                    seed({k: v.detach().cpu().numpy()
                          for k, v in prev.items()}, t0=self._batch_counter)
                else:
                    logger.warning(
                        "host table %s: existing device optimizer slots "
                        "cannot be seeded into this store backing and are "
                        "discarded", pname)
            # the cache's state key, empty: its slots live in the store
            self._opt_state[pname] = {}
        generator = self._resume_generator(resume, generator)
        if resume.get("host_tables") is not None and host_rt is not None:
            # the snapshot's store rows and per-row slots
            host_rt.load_state(resume["host_tables"])
        reader_restored = False
        if resume.get("reader_state") is not None \
                and hasattr(reader, "restore"):
            reader.restore(resume["reader_state"])
            reader_restored = True
        log_period = FLAGS.get("log_period", 100)
        stats_period = FLAGS.get("show_parameter_stats_period", 0)
        test_period = FLAGS.get("test_period", 0)
        # dispatch-frontier global step: runs ahead of _batch_counter
        # (which advances at drain) by the in-flight count
        disp_step = self._batch_counter
        test_kw = dict(bucket_rounding=bucket_rounding, **pack)

        def sync_back():
            self.parameters.update_from(self._strip_host(params))
            if host_rt is not None:
                # every flushed row lands in the store, and dense tables
                # re-enter the parameters
                host_rt.barrier()
                self._sync_host_tables_back()
            self._opt_state = (opt_state["opt"] if self._accum_steps > 1
                               else opt_state)

        for pass_id in range(start_pass, num_passes):
            resuming_here = bool(resume) and pass_id == start_pass \
                and resume_batch >= 0
            event_handler(v2_event.BeginPass(pass_id))
            if resuming_here and resume.get("evaluators"):
                for name, st in resume["evaluators"].items():
                    if name in self.evaluators:
                        self.evaluators[name].__dict__.clear()
                        self.evaluators[name].__dict__.update(st)
            else:
                for ev in self.evaluators.values():
                    ev.reset()
            pass_cost = resume.get("pass_cost", 0.0) if resuming_here else 0.0
            pass_batches = (resume.get("pass_batches", 0)
                            if resuming_here else 0)
            tested_at = None
            batch_start = resume_batch + 1 if resuming_here else 0
            batch_iter = reader()
            if resuming_here and batch_start > 0 and not reader_restored:
                # a plain reader: skip the trained prefix (its input I/O
                # replays, no compute); a checkpointable one skipped it
                for _ in range(batch_start):
                    if next(batch_iter, _DRAINED) is _DRAINED:
                        break
            snapshots_on = bool(save_every_n_batches and snapshot_dir)
            timed_iter = _TimedBatches(batch_iter)
            inflight: deque = deque()
            drain_clock = [time.perf_counter()]

            def drain_one(steady=True):
                nonlocal pass_cost, pass_batches
                ent = inflight.popleft()
                _M_INFLIGHT.set(len(inflight))
                if depth > 1:
                    # pipelined: Begin and End both fire at drain, so the
                    # event sequence is the synchronous loop's
                    event_handler(v2_event.BeginIteration(pass_id,
                                                          ent.batch_id))
                t_dr = time.perf_counter()
                with timer_scope("drainBatch"):
                    if ent.ready is not None:
                        ent.ready.synchronize()
                    cost = float(ent.cost)
                drain_s = time.perf_counter() - t_dr
                _M_STEP_SECONDS.labels(phase="drain").observe(drain_s)
                _M_STEP_SECONDS.labels(phase="compute").observe(
                    ent.dispatch_s + drain_s)
                _M_BATCHES.inc()
                now = time.perf_counter()
                wall_s = now - drain_clock[0]
                drain_clock[0] = now
                if ent.n_examples:
                    _M_EXAMPLES.inc(ent.n_examples)
                    if steady and wall_s > 0:
                        _M_EXAMPLES_PER_SEC.set(ent.n_examples / wall_s)
                if ent.step_flops and steady:
                    from paddle_tpu_torch.flops import mfu as _mfu

                    denom = wall_s if depth > 1 else ent.dispatch_s + drain_s
                    if denom > 0:
                        per_sec = ent.step_flops / denom
                        _M_TFLOPS.set(per_sec / 1e12)
                        m = _mfu(per_sec, self.device)
                        if m is not None:
                            _M_MFU.set(m)
                pass_cost += cost
                pass_batches += 1
                self._batch_counter += 1
                if ent.host_grads is not None:
                    # the step has finished: its cache-row gradients go to
                    # the store as global step _batch_counter (the lr
                    # schedule and the catch-up gaps read it)
                    host_rt.flush_async(
                        ent.host_token,
                        {k: v.detach().cpu().numpy()
                         for k, v in ent.host_grads.items()},
                        self._batch_counter)
                result = {}
                for name, ev in self.evaluators.items():
                    ev.accumulate(ent.metrics[name])
                    result[name] = ev.value()
                event_handler(v2_event.EndIteration(pass_id, ent.batch_id,
                                                    cost, result))
                if log_period and (ent.batch_id + 1) % log_period == 0:
                    logger.info("pass %d batch %d cost=%.6f %s", pass_id,
                                ent.batch_id + 1, cost,
                                " ".join(f"{k}={v:.5f}"
                                         for k, v in result.items()))
                if ent.param_stats is not None:
                    # TrainerInternal.cpp:186-215 show_parameter_stats_period
                    for pname in sorted(ent.param_stats):
                        avg, mx = ent.param_stats[pname]
                        logger.info("  param %s: avg_abs=%.6g max_abs=%.6g",
                                    pname, float(avg), float(mx))

            def drain_all():
                while inflight:
                    drain_one(steady=False)

            for batch_id, data_batch in enumerate(timed_iter,
                                                  start=batch_start):
                if depth <= 1:
                    event_handler(v2_event.BeginIteration(pass_id, batch_id))
                t_feed = time.perf_counter()
                with timer_scope("feedBatch"):
                    # the generation this batch assembles into
                    gen = feeder.next_gen
                    if pipelined_copy and use_staging_arena:
                        # its last copy must have landed before the rewrite
                        done = self._copy_events.get(gen)
                        if done is not None:
                            done.synchronize()
                    host_feeds = feeder(data_batch)
                    staged = None
                    if host_rt is not None:
                        # exact staleness: drain when this batch touches a
                        # row an in-flight batch touched (its flush must
                        # land before the gather); then the touched ids,
                        # the slot remap and the row gather, host work
                        # beside the previous step's compute
                        if inflight and host_rt.peek_conflicts(host_feeds):
                            drain_all()
                        staged = host_rt.stage(host_feeds,
                                               overlapped=bool(inflight))
                        host_feeds = staged.feeds
                    # the host tables' row caches, the tables' parameters
                    # in this step
                    caches = {} if staged is None else staged.caches
                    if pipelined_copy:
                        feeds, caches = self._copy_to_device(host_feeds, gen,
                                                             caches)
                    else:
                        if use_staging_arena and not cuda:
                            # a host tensor would alias the arena buffer the
                            # feeder refills while the step is in flight
                            feeds = {k: Arg(*(None if t is None else
                                              torch.tensor(t) for t in
                                              (a.value, a.mask, a.seg_ids)))
                                     for k, a in host_feeds.items()}
                        else:
                            feeds = {k: a.to(self.device)
                                     for k, a in host_feeds.items()}
                        caches = self._caches_to_device(caches)
                    params.update(caches)
                feed_s = time.perf_counter() - t_feed
                _M_STEP_SECONDS.labels(phase="feed").observe(feed_s)
                key = self._shape_key(host_feeds)
                t_cmp = time.perf_counter()
                ready = None
                hgrads = None
                with timer_scope("trainBatch"):
                    try:
                        out = self._train_step(params, opt_state, feeds,
                                               generator)
                    except FloatingPointError as e:
                        raise FloatingPointError(
                            f"SGD.train: pass {pass_id} batch {batch_id} "
                            f"(global step {disp_step + 1}): {e}") from None
                    if staged is not None:
                        params, opt_state, cost, metrics, hgrads = out
                        host_rt.mark_dispatched(staged)
                    else:
                        params, opt_state, cost, metrics = out
                    disp_step += 1
                    stats = None
                    if stats_period and disp_step % stats_period == 0:
                        stats = self._param_stats(params)
                    if depth <= 1:
                        # synchronous: the read forces the step to finish,
                        # so the span means executed, not enqueued
                        cost = float(cost)
                    elif cuda:
                        cost, metrics, stats, hgrads = _host_async(
                            (cost, metrics, stats, hgrads))
                        ready = torch.cuda.Event()
                        ready.record()
                dispatch_s = time.perf_counter() - t_cmp
                _M_STEP_SECONDS.labels(phase="dispatch").observe(dispatch_s)
                inflight.append(_InFlight(
                    batch_id, cost, metrics,
                    len(data_batch) if hasattr(data_batch, "__len__") else 0,
                    dispatch_s, self._flops_for(key, host_feeds), stats,
                    ready, staged, hgrads))
                _M_INFLIGHT.set(len(inflight))
                while len(inflight) > depth - 1:
                    drain_one()
                # boundaries are decided at the dispatch frontier and
                # drain the queue fully first, so each sees the state the
                # synchronous loop has at batch N
                if (test_period and test_reader is not None
                        and disp_step % test_period == 0):
                    # mid-pass evaluation (the reference Tester's periodic
                    # mode, Trainer.h:43-132)
                    drain_all()
                    sync_back()
                    event_handler(self.test(test_reader, feeding, **test_kw))
                    tested_at = self._batch_counter
                    drain_clock[0] = time.perf_counter()
                wrote_snapshot = False
                if snapshots_on \
                        and (batch_id + 1) % save_every_n_batches == 0:
                    drain_all()
                    self._save_step_snapshot(
                        snapshot_dir, params, opt_state, generator, pass_id,
                        batch_id, reader, pass_cost, pass_batches,
                        keep_snapshots)
                    wrote_snapshot = True
                    drain_clock[0] = time.perf_counter()
                if preempt_event is not None and preempt_event.is_set():
                    # preemption: snapshot at this boundary and return; the
                    # restarted process resumes from here, losing nothing
                    drain_all()
                    if snapshots_on and not wrote_snapshot:
                        self._save_step_snapshot(
                            snapshot_dir, params, opt_state, generator,
                            pass_id, batch_id, reader, pass_cost,
                            pass_batches, keep_snapshots)
                    sync_back()
                    self.preempted = True
                    _M_PREEMPTIONS.inc()
                    logger.warning(
                        "preempted at pass %d batch %d: %s, exiting train "
                        "loop", pass_id, batch_id,
                        "step snapshot written" if snapshots_on
                        else "NO snapshot (snapshots disabled) — mid-pass "
                             "progress is lost")
                    return self.parameters
            drain_all()
            # pass-end update of a partial accumulation (the reference
            # sends the pending gradients at finishTrainPass)
            if self._accum_steps > 1:
                params, opt_state = self._flush_accum(params, opt_state)
            sync_back()
            result = {name: ev.value() for name, ev in self.evaluators.items()}
            if test_reader is not None and not (
                    tested_at == self._batch_counter
                    and self._accum_steps == 1):
                # skipped only where a mid-pass test already evaluated
                # these weights
                event_handler(self.test(test_reader, feeding, **test_kw))
            event_handler(v2_event.EndPass(pass_id, result))
        if save_every_n_batches and snapshot_dir:
            # a finished run's step snapshots are recovery scratch; the
            # pass-level checkpoints are the durable artifacts
            from paddle_tpu_torch.io import checkpoint as ckpt

            ckpt.clear_step_snapshots(snapshot_dir)
        return self.parameters

    def test(self, reader, feeding=None,
             pack_sequences: Optional[bool] = None,
             pack_max_len: Optional[int] = None,
             pack_row_rounding: Optional[int] = None,
             bucket_rounding: Optional[int] = None) -> "v2_event.TestResult":
        """Mean cost and evaluator values over ``reader``'s batches at the
        current parameters, or their Polyak average where the optimizer
        keeps one (the apply/restore window, ParameterUpdaterBase.h:23),
        fed as ``train`` feeds them; the train loop's evaluator state is
        kept."""
        feeder = self._feeder(feeding, bucket_rounding, pack_sequences,
                              pack_max_len, pack_row_rounding)
        params = self._device_params()
        if self._opt_state is not None:
            params = {**params, **self.optimizer.apply_average(
                self._opt_state, params)}
        if self._host_rt is not None:
            # evaluation sees every drained batch's row update
            self._host_rt.barrier()
        saved = {k: copy.deepcopy(v.__dict__)
                 for k, v in self.evaluators.items()}
        try:
            for ev in self.evaluators.values():
                ev.reset()
            total_cost, n = 0.0, 0
            with torch.no_grad():
                for data_batch in reader():
                    host_feeds = feeder(data_batch)
                    if self._host_rt is not None:
                        # each batch's row cache, staged as in training
                        # (forward only: nothing flushes back)
                        staged = self._host_rt.stage(host_feeds)
                        host_feeds = staged.feeds
                        params.update(self._caches_to_device(staged.caches))
                    feeds = {k: a.to(self.device)
                             for k, a in host_feeds.items()}
                    cost, (outs, _aux) = self._loss(params, feeds,
                                                    training=False)
                    total_cost += float(cost)
                    n += 1
                    metrics = _compute_metrics(self.evaluators, outs,
                                               self._loss, feeds)
                    for name, ev in self.evaluators.items():
                        ev.accumulate(metrics[name])
            result = {name: ev.value() for name, ev in self.evaluators.items()}
        finally:
            for k, v in self.evaluators.items():
                v.__dict__.clear()
                v.__dict__.update(saved[k])
        return v2_event.TestResult(total_cost / max(n, 1), result)

    def averaged_parameters(self):
        """The apply/restore window (ParameterUpdaterBase.h:23): a context
        manager that swaps the Polyak-averaged weights into
        ``self.parameters`` (for evaluation or a checkpoint) and restores
        the training weights on exit; without averaging it yields the
        parameters as they are."""

        @contextlib.contextmanager
        def _window():
            if self._opt_state is None or getattr(
                    self.optimizer, "model_average", None) is None:
                yield self.parameters
                return
            backup = self.parameters.as_dict()
            self.parameters.update_from(
                self.optimizer.apply_average(self._opt_state, backup))
            try:
                yield self.parameters
            finally:
                self.parameters.update_from(backup)

        return _window()

    def save_parameter_to_tar(self, f):
        self.parameters.to_tar(f)


#: sentinel for skipping an exhausted reader on resume
_DRAINED = object()


def _default_event_handler(ev):
    if isinstance(ev, v2_event.EndPass):
        logger.info("Pass %d done. %s", ev.pass_id,
                    " ".join(f"{k}={v:.5f}" for k, v in ev.metrics.items()))
