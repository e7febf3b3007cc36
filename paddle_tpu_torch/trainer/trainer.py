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
the padded run's. The loop is synchronous: each batch's cost is
read back before the next batch is fed. The JAX package's pipelined loop
gives the same trajectory by its own contract (events, costs and
evaluator values are those of the synchronous loop), so
``pipeline_depth`` is accepted and the loop runs synchronously whatever
its value.

Not ported yet, and refused when asked for: step snapshots and resume,
preemption, host-resident tables, continuous publishing, the staging
arena, gradient accumulation, meshes, Polyak averaging, the
``paddle_train_*`` metrics and the flags
``log_period``, ``show_parameter_stats_period`` and ``test_period`` at
any value but their defaults.
"""

from __future__ import annotations

import copy
import logging
from typing import Dict, Optional, Sequence, Union

import torch

from paddle_tpu_torch.core.parameters import Parameters
from paddle_tpu_torch.core.topology import Topology
from paddle_tpu_torch.optimizer import Optimizer
from paddle_tpu_torch.sparse_grad import SparseRowGrad
from paddle_tpu_torch.trainer import event as v2_event
from paddle_tpu_torch.trainer.feeder import DataFeeder, resolve_pack_flags
from paddle_tpu_torch.utils.device import resolve_device
from paddle_tpu_torch.utils.error import Error, enforce

logger = logging.getLogger("paddle_tpu_torch")

# SGD.train / SGD.test options of the JAX package this port does not have
# yet, with the value that leaves them off
_UNPORTED_TRAIN = {
    "save_every_n_batches": 0, "snapshot_dir": None, "resume_state": None,
    "preempt_event": None, "keep_snapshots": 3, "use_staging_arena": None,
    "host_tables": None, "host_cache_rows": None, "host_store": None,
    "host_staleness": None, "host_flush_inflight": 4,
    "publish_every_n_batches": 0, "publish_dir": None, "publish_url": None,
    "publisher": None, "publish_topology": None,
    "publish_rows_every_n_batches": 0,
}
# the JAX train loop's flag-driven features, with the values that leave
# them as the port's loop runs (no log line, stat dump or mid-pass test)
_UNPORTED_FLAGS = {"log_period": 100, "show_parameter_stats_period": 0,
                   "test_period": 0}


def _refuse_unported(where: str, kw: dict, known) -> None:
    for name, value in kw.items():
        if name not in known:
            raise TypeError(f"{where}() got an unexpected keyword argument "
                            f"{name!r}")
        if value != known[name]:
            raise Error(f"{where}: {name}={value!r} is not ported yet "
                        "(ROADMAP.md, M8)")


def _refuse_unported_flags(where: str) -> None:
    from paddle_tpu_torch.utils.flags import FLAGS

    for name, default in _UNPORTED_FLAGS.items():
        value = FLAGS.get(name, default)
        if value != default:
            raise Error(f"{where}: the flag {name}={value!r} is not ported "
                        f"yet (ROADMAP.md, queue 1 item 6); only {default!r}"
                        " runs")


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


def make_train_step(loss, optimizer: Optimizer, static: Dict[str, bool],
                    lr_mults: Optional[Dict[str, float]] = None,
                    evaluators=None):
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
    contributes no gradient."""
    evaluators = dict(evaluators or {})
    sparse_capable = getattr(loss, "_sparse_capable", False)

    def step(params, opt_state, feeds, generator=None):
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
        new_params, new_opt_state = optimizer.update(grads, opt_state,
                                                     params, lr_mults, static)
        new_params.update(aux)
        metrics = _compute_metrics(evaluators, outs, loss, feeds)
        return new_params, new_opt_state, cost.detach(), metrics

    return step


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
                "ported yet")
        enforce(int(num_batches_per_send_parameter) == 1,
                "SGD: gradient accumulation (num_batches_per_send_parameter"
                " > 1) is not ported yet")
        self.device = resolve_device(device)
        self.topology = Topology([cost] + list(extra_layers or []))
        self.cost_name = cost.name if hasattr(cost, "name") else cost
        self.parameters = parameters
        self.optimizer = update_equation
        self.evaluators = dict(evaluators or {})
        # mixed precision: bf16 compute over float32 master weights
        self._loss = self.topology.loss_fn(
            cost, compute_dtype=torch.bfloat16 if mixed_precision else None)
        self._static = self.topology.static_map()
        self._lr_mults = self.topology.lr_mults()
        self._train_step = make_train_step(self._loss, self.optimizer,
                                           self._static, self._lr_mults,
                                           self.evaluators)
        self._opt_state = None
        self._batch_counter = 0

    def _device_params(self) -> Dict[str, torch.Tensor]:
        # a copy on every device: the sparse-row update writes rows in
        # place, and the caller's tensors change only at update_from
        return {k: v.to(self.device, copy=True)
                for k, v in self.parameters.as_dict().items()}

    def _feeds(self, feeder, data_batch):
        return {k: a.to(self.device) for k, a in feeder(data_batch).items()}

    def _feeder(self, feeding, bucket_rounding, pack_sequences=None,
                pack_max_len=None, pack_row_rounding=None):
        """The DataFeeder of a train or test run, the flags resolved as the
        JAX package resolves them (``resolve_pack_flags``)."""
        pack, pack_max_len, bucket_rounding = resolve_pack_flags(
            pack_sequences, pack_max_len, bucket_rounding)
        return DataFeeder(self.topology.data_type(), feeding,
                          bucket_rounding=bucket_rounding,
                          pack_sequences=pack, pack_max_len=pack_max_len,
                          pack_row_rounding=pack_row_rounding)

    def train(self, reader, num_passes: int = 1, event_handler=None,
              feeding=None, test_reader=None, start_pass: int = 0,
              pipeline_depth: Optional[int] = None,
              bucket_rounding: Optional[int] = None,
              pack_sequences: Optional[bool] = None,
              pack_max_len: Optional[int] = None,
              pack_row_rounding: Optional[int] = None,
              generator: Optional[torch.Generator] = None, **unported):
        """Train over ``num_passes`` passes of ``reader`` (a reader of
        batches), firing the v2 events through ``event_handler``. Any
        ``pipeline_depth`` runs the synchronous loop (the JAX package's
        pipelined loop has the same trajectory). ``pack_sequences``,
        ``pack_max_len`` (None: their flags) and ``pack_row_rounding``
        are the DataFeeder's packing knobs (docs/packing.md); the pass-end
        test uses them too. ``generator`` feeds dropout (default: seeded
        with 1 on the trainer's device)."""
        _refuse_unported("SGD.train", unported, _UNPORTED_TRAIN)
        _refuse_unported_flags("SGD.train")
        if event_handler is None:
            event_handler = _default_event_handler
        pack = dict(pack_sequences=pack_sequences, pack_max_len=pack_max_len,
                    pack_row_rounding=pack_row_rounding)
        feeder = self._feeder(feeding, bucket_rounding, **pack)
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(1)
        params = self._device_params()
        if self._opt_state is None:
            self._opt_state = self.optimizer.init(params)
        opt_state = self._opt_state
        for pass_id in range(start_pass, num_passes):
            event_handler(v2_event.BeginPass(pass_id))
            for ev in self.evaluators.values():
                ev.reset()
            for batch_id, data_batch in enumerate(reader()):
                event_handler(v2_event.BeginIteration(pass_id, batch_id))
                feeds = self._feeds(feeder, data_batch)
                params, opt_state, cost, metrics = self._train_step(
                    params, opt_state, feeds, generator)
                cost = float(cost)       # the step's end: a device sync
                self._batch_counter += 1
                result = {}
                for name, ev in self.evaluators.items():
                    ev.accumulate(metrics[name])
                    result[name] = ev.value()
                event_handler(v2_event.EndIteration(pass_id, batch_id, cost,
                                                    result))
            self.parameters.update_from(params)
            self._opt_state = opt_state
            result = {name: ev.value() for name, ev in self.evaluators.items()}
            if test_reader is not None:
                event_handler(self.test(test_reader, feeding,
                                        bucket_rounding=bucket_rounding,
                                        **pack))
            event_handler(v2_event.EndPass(pass_id, result))
        return self.parameters

    def test(self, reader, feeding=None,
             pack_sequences: Optional[bool] = None,
             pack_max_len: Optional[int] = None,
             pack_row_rounding: Optional[int] = None,
             bucket_rounding: Optional[int] = None) -> "v2_event.TestResult":
        """Mean cost and evaluator values over ``reader``'s batches at the
        current parameters, fed as ``train`` feeds them; the train loop's
        evaluator state is kept."""
        feeder = self._feeder(feeding, bucket_rounding, pack_sequences,
                              pack_max_len, pack_row_rounding)
        params = self._device_params()
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

    def save_parameter_to_tar(self, f):
        self.parameters.to_tar(f)


def _default_event_handler(ev):
    if isinstance(ev, v2_event.EndPass):
        logger.info("Pass %d done. %s", ev.pass_id,
                    " ".join(f"{k}={v:.5f}" for k, v in ev.metrics.items()))
