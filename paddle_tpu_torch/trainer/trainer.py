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

Not ported yet, and refused when asked for: host-resident tables
(ROADMAP queue 1 item 8), continuous publishing (item 2.4) and meshes
(item 7).
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
    "host_tables": (None, "8"), "host_cache_rows": (None, "8"),
    "host_store": (None, "8"), "host_staleness": (None, "8"),
    "host_flush_inflight": (4, "8"),
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
                 "step_flops", "param_stats", "ready")

    def __init__(self, batch_id, cost, metrics, n_examples, dispatch_s,
                 step_flops, param_stats=None, ready=None):
        self.batch_id = batch_id
        self.cost = cost
        self.metrics = metrics
        self.n_examples = n_examples
        self.dispatch_s = dispatch_s
        self.step_flops = step_flops
        self.param_stats = param_stats
        self.ready = ready


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


def make_train_step(loss, optimizer: Optimizer, static: Dict[str, bool],
                    lr_mults: Optional[Dict[str, float]] = None,
                    evaluators=None, accum_steps: int = 1):
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
    accumulator is dense: sparse-row gradients are off."""
    evaluators = dict(evaluators or {})
    sparse_capable = getattr(loss, "_sparse_capable", False) \
        and accum_steps <= 1

    def grads_of(params, feeds, generator):
        leaves = {k: (v if static.get(k) else
                      v.detach().requires_grad_(True))
                  for k, v in params.items()}
        sparse = {} if sparse_capable else None
        kw = {"sparse_rows": sparse} if sparse_capable else {}
        cost, (outs, aux) = loss(leaves, feeds, generator=generator,
                                 training=True, **kw)
        cost.backward()
        grads = {}
        for k, v in leaves.items():
            if static.get(k):
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
        return cost, outs, aux, grads

    def step(params, opt_state, feeds, generator=None):
        cost, outs, aux, grads = grads_of(params, feeds, generator)
        new_params, new_opt_state = optimizer.update(grads, opt_state,
                                                     params, lr_mults, static)
        new_params.update(aux)
        metrics = _compute_metrics(evaluators, outs, loss, feeds)
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
        self._train_step = make_train_step(self._loss, self.optimizer,
                                           self._static, self._lr_mults,
                                           self.evaluators,
                                           accum_steps=self._accum_steps)
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

    def _device_params(self) -> Dict[str, torch.Tensor]:
        # a copy on every device: the sparse-row update writes rows in
        # place, and the caller's tensors change only at update_from
        return {k: v.to(self.device, copy=True)
                for k, v in self.parameters.as_dict().items()}

    def _feeds(self, feeder, data_batch):
        return {k: a.to(self.device) for k, a in feeder(data_batch).items()}

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

    def _copy_to_device(self, host_feeds, gen):
        """The pipelined loop's host-to-device copy of a batch (CUDA): on
        the copy stream, non-blocking (asynchronous from the staging
        arena's pinned buffers), the compute stream waiting on its event
        and every copied tensor recorded on the compute stream so the
        caching allocator keeps it until the step using it has run. The
        event is kept as generation ``gen``'s."""
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
            done = torch.cuda.Event()
            done.record(self._copy_stream)
        compute.wait_event(done)
        self._copy_events[gen] = done
        return feeds

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

        self.parameters.update_from(params)
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
        flag on the trainer's device)."""
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
        generator = self._resume_generator(resume, generator)
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
            self.parameters.update_from(params)
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
                    if pipelined_copy:
                        feeds = self._copy_to_device(host_feeds, gen)
                    elif use_staging_arena and not cuda:
                        # a host tensor would alias the arena buffer the
                        # feeder refills while the step is in flight
                        feeds = {k: Arg(*(None if t is None else
                                          torch.tensor(t) for t in
                                          (a.value, a.mask, a.seg_ids)))
                                 for k, a in host_feeds.items()}
                    else:
                        feeds = {k: a.to(self.device)
                                 for k, a in host_feeds.items()}
                feed_s = time.perf_counter() - t_feed
                _M_STEP_SECONDS.labels(phase="feed").observe(feed_s)
                key = self._shape_key(host_feeds)
                t_cmp = time.perf_counter()
                ready = None
                with timer_scope("trainBatch"):
                    params, opt_state, cost, metrics = self._train_step(
                        params, opt_state, feeds, generator)
                    disp_step += 1
                    stats = None
                    if stats_period and disp_step % stats_period == 0:
                        stats = self._param_stats(params)
                    if depth <= 1:
                        # synchronous: the read forces the step to finish,
                        # so the span means executed, not enqueued
                        cost = float(cost)
                    elif cuda:
                        cost, metrics, stats = _host_async(
                            (cost, metrics, stats))
                        ready = torch.cuda.Event()
                        ready.record()
                dispatch_s = time.perf_counter() - t_cmp
                _M_STEP_SECONDS.labels(phase="dispatch").observe(dispatch_s)
                inflight.append(_InFlight(
                    batch_id, cost, metrics,
                    len(data_batch) if hasattr(data_batch, "__len__") else 0,
                    dispatch_s, self._flops_for(key, host_feeds), stats,
                    ready))
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
        saved = {k: copy.deepcopy(v.__dict__)
                 for k, v in self.evaluators.items()}
        try:
            for ev in self.evaluators.values():
                ev.reset()
            total_cost, n = 0.0, 0
            with torch.no_grad():
                for data_batch in reader():
                    feeds = self._feeds(feeder, data_batch)
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
