"""Per-slot continuous decode (counterpart of ``paddle_tpu/step_decode.py``,
the Python twin of the serving daemon's slot scheduler,
native/serving_daemon.cc).

A fixed array of S slots runs the step export (io/merged_model.py
``export_decode_step_ex`` in this process, or a bundle's artifacts
through ``driver_from_bundle_meta``) together every tick, live and free slots
alike. In continuous mode a slot whose request finished takes a new
request's encoder state at the next tick, in the middle of the others'
decodes; in drain mode requests enter only an all-idle batch (static
batching, the baseline).

The slot state stays on the device: an admission runs the init export and
writes its request's row into the state, and a tick reads back only the
[S] ``emitted`` and ``done`` vectors (a finished request's ids and scores
row when it ends).
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

import numpy as np
import torch

from paddle_tpu_torch.io.merged_model import DTYPES, load_step_export


class StepDecodeRequest:
    """One decode request and its per-slot lifecycle record."""

    def __init__(self, feeds: Dict[str, np.ndarray],
                 max_new: Optional[int] = None, eos_id: int = 1):
        #: {signature input name: the request's row (no slot dim)}
        self.feeds = feeds
        #: the request's tick bound, carried in the slot's "state:cap"
        self.max_new = max_new
        self.eos_id = eos_id
        self.slot: Optional[int] = None
        self.submit_time = 0.0
        self.admit_time = 0.0
        self.first_token_time: Optional[float] = None
        self.done_time = 0.0
        self.admit_tick = -1           # scheduler tick at admission
        self.mid_batch = False         # admitted while other slots live
        self.tokens: List[int] = []    # streamed best-hypothesis tokens
        self.ids: Optional[np.ndarray] = None      # final [beam, L]
        self.scores: Optional[np.ndarray] = None   # final [beam]
        self.ticks = 0                 # decode ticks of its slot

    @property
    def best_ids(self) -> List[int]:
        """The best beam's ids cut after the first eos (the daemon's
        /v1/decode answer)."""
        row = self.ids[int(np.argmax(self.scores))]
        hits = np.nonzero(row == self.eos_id)[0]
        return list(row[:int(hits[0]) + 1 if hits.size else len(row)])


class StepDecodeDriver:
    """Slot scheduler over a step export's ``init`` and ``step``.

    ``export`` is the result of ``export_decode_step_ex`` or
    ``load_step_export``; ``drain=True``
    gives static batching. Free slots hold an inert state (the tick
    counter at max_length, nothing alive) and keep executing, as the
    daemon's slot array does."""

    def __init__(self, export: dict, drain: bool = False):
        self.sig = export["signature"]
        self.S = int(self.sig["slots"])
        self.beam = int(self.sig["beam"])
        self.max_len = int(self.sig["max_length"])
        self.eos_id = int(self.sig["eos_id"])
        self.device = export["device"]
        self._init = export["init"]
        self._step = export["step"]
        self.state_names = [e["name"] for e in self.sig["state"]]
        self.enc_names = [e["name"] for e in self.sig["enc"]]
        self.in_specs = self.sig["inputs"]
        self.drain = bool(drain)
        self.state = {e["name"]: self._zeros(e) for e in self.sig["state"]}
        self.state["state:t"].fill_(self.max_len)
        self.state["state:cap"].fill_(self.max_len)
        self.enc = {e["name"]: self._zeros(e) for e in self.sig["enc"]}
        self.slot_req: List[Optional[StepDecodeRequest]] = [None] * self.S
        self.queue: List[StepDecodeRequest] = []
        self.finished: List[StepDecodeRequest] = []
        self.tick_count = 0
        self.admissions = {"fresh": 0, "mid_batch": 0}

    def _zeros(self, entry) -> torch.Tensor:
        dims = tuple(self.S if d == "b" else int(d) for d in entry["shape"])
        return torch.zeros(dims, dtype=DTYPES[entry["dtype"]],
                           device=self.device)

    def submit(self, feeds: Dict[str, np.ndarray],
               max_new: Optional[int] = None) -> StepDecodeRequest:
        r = StepDecodeRequest(feeds, max_new=max_new, eos_id=self.eos_id)
        r.submit_time = time.perf_counter()
        self.queue.append(r)
        return r

    # -- the scheduler -------------------------------------------------

    def _admit(self, slot: int, r: StepDecodeRequest, n_live_entry: int):
        """Run init with the request's feeds in row ``slot`` (zeros in the
        others) and write that row of every output into the slot state:
        the daemon's per-admission prefill."""
        flat = []
        for spec in self.in_specs:
            a = self._zeros(spec)
            a[slot] = torch.as_tensor(np.asarray(r.feeds[spec["name"]]),
                                      dtype=a.dtype)
            flat.append(a)
        named = dict(zip(self.sig["init_outputs"], self._init.call(*flat)))
        for n in self.state_names:
            self.state[n][slot] = named[n][slot]
        for n in self.enc_names:
            self.enc[n][slot] = named[n][slot]
        if r.max_new is not None:
            # this slot goes inert at min(max_new, max_length); the
            # neighbours keep their caps
            self.state["state:cap"][slot] = min(int(r.max_new), self.max_len)
        self.slot_req[slot] = r
        r.slot = slot
        r.admit_tick = self.tick_count
        r.admit_time = time.perf_counter()
        r.mid_batch = n_live_entry > 0
        self.admissions["mid_batch" if r.mid_batch else "fresh"] += 1

    def _admissions(self):
        n_live = sum(1 for r in self.slot_req if r is not None)
        if self.drain and n_live > 0:
            return
        for s in range(self.S):
            if not self.queue:
                break
            if self.slot_req[s] is None:
                self._admit(s, self.queue.pop(0), n_live)

    def tick(self):
        """One round: admit into free slots, run the step over the whole
        slot array, harvest the tokens and the finished requests."""
        self._admissions()
        flat = [self.state[n] for n in self.state_names] + \
               [self.enc[n] for n in self.enc_names]
        named = dict(zip(self.sig["step_outputs"], self._step.call(*flat)))
        for n in self.state_names:
            self.state[n] = named[n]
        self.tick_count += 1
        # the tick's one read-back: [2, S]
        emitted, done = torch.stack([named["emitted"],
                                     named["done"]]).cpu().numpy()
        now = time.perf_counter()
        live = [s for s in range(self.S) if self.slot_req[s] is not None]
        for s in live:
            r = self.slot_req[s]
            r.ticks += 1
            r.tokens.append(int(emitted[s]))
            if r.first_token_time is None:
                r.first_token_time = now
        ended = [s for s in live if done[s]]
        if ended:
            # the finished rows in one read-back each (an index copies, so
            # a later admission into the slot cannot reach them)
            ids = self.state["state:ids"][ended].cpu().numpy()
            scores = self.state["state:scores"][ended].cpu().numpy()
            now = time.perf_counter()
            for i, s in enumerate(ended):
                r = self.slot_req[s]
                r.ids, r.scores, r.done_time = ids[i], scores[i], now
                self.finished.append(r)
                self.slot_req[s] = None

    def run(self, max_ticks: Optional[int] = None) -> List[StepDecodeRequest]:
        """Tick until every submitted request finished; returns them in
        the order they finished."""
        budget = max_ticks if max_ticks is not None else \
            (len(self.queue) + self.S) * (self.max_len + 2)
        while (self.queue or any(r is not None for r in self.slot_req)) \
                and budget > 0:
            self.tick()
            budget -= 1
        if self.queue or any(r is not None for r in self.slot_req):
            raise RuntimeError("step decode did not converge within the "
                               "tick budget (stuck done signal?)")
        return self.finished


def driver_from_bundle_meta(meta: dict, drain: bool = False,
                            device="cuda") -> StepDecodeDriver:
    """A driver over a bundle's decode step artifacts (``meta`` as
    ``read_bundle_meta`` returns it, or its ``torch_step`` dict), loaded
    onto ``device``; raises ``Error``, quoting
    ``torch_step_skip_reason``, for a bundle without them."""
    return StepDecodeDriver(load_step_export(meta, device=device),
                            drain=drain)
