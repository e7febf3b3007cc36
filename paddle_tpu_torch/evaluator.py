"""Evaluators (counterpart of ``paddle_tpu/evaluator.py``; analog of
paddle/gserver/evaluators/). Each evaluator names the layer outputs it
reads, computes a few statistics on the device each batch, and
accumulates them on the host across batches (the reference's per-batch
"CurrentEval" and per-pass printing, Evaluator.h start/finish protocol).

The port has the ``Evaluator`` base, ``classification_error``, ``chunk``
and ``ctc_error`` (alias ``ctc_edit_distance``).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from paddle_tpu_torch.utils.error import Error


def _name(layer) -> str:
    return layer if isinstance(layer, str) else layer.name


class Evaluator:
    #: set by the trainer before each compute() (``_compute_metrics``):
    #: True only when the feed batch is sequence-packed (docs/packing.md).
    #: Packed-aware evaluators read this, not the presence of seg_ids,
    #: which nested SUB_SEQUENCE outputs carry too.
    packed_feed = False

    def reset(self):
        self._acc = None

    def compute(self, outs) -> Dict[str, torch.Tensor]:
        raise NotImplementedError

    def accumulate(self, stats: Dict):
        stats = {k: np.asarray(torch.as_tensor(v).detach().cpu(), np.float64)
                 for k, v in stats.items()}
        if getattr(self, "_acc", None) is None:
            self._acc = stats
        else:
            self._acc = {k: self._acc[k] + stats[k] for k in stats}

    def value(self) -> float:
        raise NotImplementedError


def _sample_weight(outs, weight_name):
    """Per-sample weight column [B] from a named layer output (the
    reference's optional third evaluator input, Evaluator.cpp:39-78)."""
    w = outs[weight_name].value
    if w.dim() > 1:
        w = w[..., 0]
    return w.to(torch.float32)


class classification_error(Evaluator):
    """ClassificationErrorEvaluator: fraction of rows whose argmax doesn't
    match the label (sequence inputs: per valid step). Optional ``weight``
    input: errors and the sample count are weighted per row
    (Evaluator.cpp:50-56)."""

    def __init__(self, input, label, name=None, weight=None, **kw):
        self.input, self.label = _name(input), _name(label)
        self.weight = _name(weight) if weight is not None else None
        self.reset()

    def compute(self, outs):
        pred = outs[self.input]
        label = outs[self.label]
        ids = torch.argmax(pred.value, dim=-1)
        lab = label.value.long()
        if lab.dim() == ids.dim() + 1:
            lab = lab[..., 0]
        wrong = (ids != lab).to(torch.float32)
        count = pred.mask.to(torch.float32) if pred.mask is not None \
            else torch.ones_like(wrong)
        if self.weight is not None:
            w = _sample_weight(outs, self.weight)
            w = w.reshape(tuple(w.shape) + (1,) * (wrong.dim() - w.dim()))
            count = count * w
        if pred.mask is not None:
            wrong = wrong * pred.mask
        if self.weight is not None:
            wrong = wrong * w
        return {"wrong": wrong.sum(), "total": count.sum()}

    def value(self):
        if not getattr(self, "_acc", None):
            return float("nan")
        return float(self._acc["wrong"] / max(self._acc["total"], 1e-9))


class chunk(Evaluator):
    """ChunkEvaluator (NER F1; paddle/gserver/evaluators/ChunkEvaluator.cpp):
    decodes tag sequences into chunks and accumulates precision/recall/F1
    over (begin, end, type) triples.

    chunk_scheme: IOB | IOE | IOBES | plain, dispatched exactly as the
    reference's init() tag tables (ChunkEvaluator.cpp:83-108): tag =
    id % num_tag_types, type = id // num_tag_types, "other" = type ==
    num_chunk_types. Segment extraction is the reference's
    getSegments/isChunkBegin/isChunkEnd state machine
    (ChunkEvaluator.cpp:185-245); excluded_chunk_types are decoded but
    not counted (ChunkEvaluator.cpp:113-116). Decoding runs host-side on
    the label/pred id arrays; a packed row is decoded a segment at a time,
    so no chunk spans two sequences."""

    _SCHEMES = {
        "IOB":   (2, 0, 1, -1, -1),    # (num_tag_types, B, I, E, S)
        "IOE":   (2, -1, 0, 1, -1),
        "IOBES": (4, 0, 1, 2, 3),
        "plain": (1, -1, -1, -1, -1),
    }

    def __init__(self, input, label, chunk_scheme="IOB", num_chunk_types=1,
                 name=None, excluded_chunk_types=None, **kw):
        self.input, self.label = _name(input), _name(label)
        if chunk_scheme not in self._SCHEMES:
            raise Error(f"Unknown chunk scheme: {chunk_scheme}")
        self.scheme = chunk_scheme
        self.num_types = num_chunk_types
        self.excluded = frozenset(excluded_chunk_types or ())
        self.reset()

    def compute(self, outs):
        pred = outs[self.input]
        lab = outs[self.label]
        v = pred.value
        ids = torch.argmax(v, dim=-1) if v.dim() == 3 and v.shape[-1] > 1 \
            else v.long()
        if ids.dim() == 3:
            ids = ids[..., 0]
        lv = lab.value.long()
        if lv.dim() == 3:
            lv = lv[..., 0]
        mask = pred.mask if pred.mask is not None else torch.ones(ids.shape)
        stats = {"pred": ids, "lab": lv, "mask": mask}
        if self.packed_feed and pred.seg_ids is not None:
            # packed rows: accumulate() splits each row per segment
            stats["seg"] = pred.seg_ids
        return stats

    def _is_chunk_end(self, prev_tag, prev_type, tag, ty):
        # ChunkEvaluator.cpp:224-233
        _, B, I, E, S = self._SCHEMES[self.scheme]
        other = self.num_types
        if prev_type == other:
            return False
        if ty == other or ty != prev_type:
            return True
        if prev_tag == B or prev_tag == I:
            return tag == B or tag == S
        return prev_tag in (E, S)      # E/S always close the chunk

    def _is_chunk_begin(self, prev_tag, prev_type, tag, ty):
        # ChunkEvaluator.cpp:236-245
        _, B, I, E, S = self._SCHEMES[self.scheme]
        other = self.num_types
        if prev_type == other:
            return ty != other
        if ty == other:
            return False
        if ty != prev_type or tag == B or tag == S:
            return True
        if tag == I or tag == E:
            return prev_tag == E or prev_tag == S
        return False

    def _decode(self, tags):
        """getSegments (ChunkEvaluator.cpp:185-220): tag id -> ordered,
        non-overlapping (begin, end, type) segments."""
        num_tag_types = self._SCHEMES[self.scheme][0]
        chunks = []
        in_chunk, start = False, 0
        tag, ty = -1, self.num_types
        for i, t in enumerate(tags):
            prev_tag, prev_type = tag, ty
            t = int(t)
            # ids outside [0, num_tag_types*(num_chunk_types+1)) have no
            # decoded meaning; treat them as "other" rather than inventing
            # a type (the reference assumes ids are in range)
            if t < 0:
                tag, ty = -1, self.num_types
            else:
                tag, ty = t % num_tag_types, min(t // num_tag_types,
                                                 self.num_types)
            if in_chunk and self._is_chunk_end(prev_tag, prev_type, tag, ty):
                chunks.append((start, i - 1, prev_type))
                in_chunk = False
            if self._is_chunk_begin(prev_tag, prev_type, tag, ty):
                start, in_chunk = i, True
        if in_chunk:
            chunks.append((start, len(tags) - 1, ty))
        return set(chunks)

    def accumulate(self, stats):
        pred, lab, mask = (torch.as_tensor(stats[k]).detach().cpu().numpy()
                           for k in ("pred", "lab", "mask"))
        seg = torch.as_tensor(stats["seg"]).cpu().numpy() \
            if "seg" in stats else None
        acc = getattr(self, "_acc", None) or {"tp": 0.0, "np": 0.0, "ng": 0.0}

        def drop(cs):
            return {c for c in cs if c[2] not in self.excluded}

        for b in range(pred.shape[0]):
            if seg is not None:
                # a packed row: each segment decoded on its own
                spans = [np.flatnonzero((seg[b] == s) & (mask[b] > 0))
                         for s in range(int(seg[b].max()) + 1)]
            else:
                spans = [np.arange(int(mask[b].sum()))]
            for idx in spans:
                if idx.size == 0:
                    continue
                pc = drop(self._decode(pred[b, idx]))
                gc = drop(self._decode(lab[b, idx]))
                acc["tp"] += len(pc & gc)
                acc["np"] += len(pc)
                acc["ng"] += len(gc)
        self._acc = acc

    def stats(self):
        a = self._acc or {"tp": 0, "np": 1e-9, "ng": 1e-9}
        prec = a["tp"] / max(a["np"], 1e-9)
        rec = a["tp"] / max(a["ng"], 1e-9)
        f1 = 2 * prec * rec / max(prec + rec, 1e-9)
        return {"precision": prec, "recall": rec, "f1": f1}

    def value(self):
        return self.stats()["f1"]


def _edit_distance(a, b) -> int:
    """Levenshtein distance between two id sequences: the JAX package's
    row-by-row recurrence, a row at a time over the longer sequence in
    numpy. Within a row, the insertion chain dp[j] = min(c[j], dp[j-1] + 1)
    is j + the running minimum of c[k] - k."""
    a, b = np.asarray(a, np.int64), np.asarray(b, np.int64)
    if len(a) > len(b):
        a, b = b, a                     # the distance is symmetric
    idx = np.arange(len(b) + 1)
    dp = idx.copy()
    c = np.empty_like(dp)
    for i, x in enumerate(a, 1):
        c[0] = i
        c[1:] = np.minimum(dp[1:] + 1, dp[:-1] + (b != x))
        dp = np.minimum.accumulate(c - idx) + idx
    return int(dp[-1])


class ctc_error(Evaluator):
    """CTCErrorEvaluator (CTCErrorEvaluator.cpp): edit distance between the
    CTC best-path decode of the network output and the label sequence,
    normalised by label length (CER/WER depending on token unit). The
    decode runs on the device, the distances on the host."""

    def __init__(self, input, label, blank=0, name=None, **kw):
        self.input, self.label = _name(input), _name(label)
        self.blank = blank
        self.reset()

    def compute(self, outs):
        pred = outs[self.input]
        lab = outs[self.label]
        if self.packed_feed and pred.seg_ids is not None:
            # the best-path collapse merges repeats ACROSS a packed
            # boundary: no correct row-level decode exists
            raise Error("ctc_error: packed sequence rows are not "
                        "supported; evaluate CTC models unpacked")
        from paddle_tpu_torch.layers.crf_ctc import ctc_greedy_decode
        ids, idmask = ctc_greedy_decode(pred.value, pred.mask, self.blank)
        lv = lab.value.long()
        if lv.dim() == 3:
            lv = lv[..., 0]
        return {"ids": ids, "idmask": idmask, "lab": lv,
                "labmask": lab.mask if lab.mask is not None else
                torch.ones(lv.shape)}

    def accumulate(self, stats):
        ids, idm, lab, lm = (torch.as_tensor(stats[k]).detach().cpu().numpy()
                             for k in ("ids", "idmask", "lab", "labmask"))
        acc = getattr(self, "_acc", None) or {"dist": 0.0, "len": 0.0,
                                              "seqs": 0.0, "wrong": 0.0}
        for b in range(ids.shape[0]):
            ref = lab[b][lm[b] > 0]
            d = _edit_distance(ids[b][idm[b] > 0], ref)
            acc["dist"] += d
            acc["len"] += len(ref)
            acc["seqs"] += 1
            acc["wrong"] += 1 if d else 0
        self._acc = acc

    def value(self):
        a = self._acc or {"dist": 0, "len": 1e-9}
        return a["dist"] / max(a["len"], 1e-9)


ctc_edit_distance = ctc_error
