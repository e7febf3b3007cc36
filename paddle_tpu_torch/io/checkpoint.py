"""Checkpoint save/load: pass directories and step snapshots
(counterpart of ``paddle_tpu/io/checkpoint.py``; analog of the per-pass
``save_dir/pass-%05d`` dirs of ParameterUtil::saveParameters,
paddle/trainer/ParamUtil.cpp:80, and of the Go pserver's checkpoints with
integrity hashes, go/pserver/service.go:76-153).

The files are the JAX package's, byte for byte where the contents are
equal, so a checkpoint written by either package loads in the other:

- ``params.tar``: ``Parameters.to_tar`` (the shared tar format),
- ``opt_state.pkl``: a pickle of the optimizer state in the canonical
  ``{param: {slot: array}, "__step__": ..., "__avg__": ...,
  "__avg_n__": ...}`` layout, every tensor as a numpy array
  (``host_tree``); a gradient-accumulation run writes JAX's
  ``{"opt", "acc", "k"}`` wrapper,
- ``train_state.pkl``: the mid-pass resume state of a step snapshot,
- ``meta.json``: ``format_version`` and the two pickles' md5s, renamed
  LAST, so it is the commit record.

``save_step``/``find_latest_step`` keep step-granular snapshots under
``save_dir/step-%010d``; ``validate_checkpoint`` raises a
``CheckpointError`` naming the path for a torn, corrupt, uncommitted or
future-format checkpoint, and the newest-first scan falls back past one.
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import pickle
import re
import shutil
import struct
import tarfile
from typing import List, Optional, Tuple

import time

import torch

from paddle_tpu_torch.core.parameters import Parameters
from paddle_tpu_torch.observability import metrics as _obs

_M_CKPT_SECONDS = _obs.histogram(
    "paddle_checkpoint_seconds",
    "Checkpoint operation latency (save = full atomic dir write, "
    "validate = integrity scan, load = validated decode)",
    labels=("op",))
_M_CKPT_OPS = _obs.counter(
    "paddle_checkpoint_ops_total",
    "Checkpoint operations by outcome", labels=("op", "ok"))
_M_CKPT_INVALID = _obs.counter(
    "paddle_checkpoint_invalid_snapshots_total",
    "Torn/corrupt step snapshots skipped by the newest-first recovery "
    "scan (the torn-write fallback firing)")

#: Bump when the on-disk layout changes incompatibly. Readers reject
#: checkpoints written by a NEWER format (forward compatibility is
#: explicit, not accidental); absent means 0 (pre-versioning era).
FORMAT_VERSION = 1


class CheckpointError(RuntimeError):
    """A checkpoint is missing, torn, corrupt, or from an unknown future
    format. Always names the offending path."""


def host_tree(tree):
    """``tree`` (nested dicts, lists and tuples) with every tensor as a
    numpy array of its dtype, on the host, and every dict's keys sorted:
    the form the JAX package's ``np.asarray`` tree map gives
    ``opt_state.pkl``, so equal states pickle to the same bytes. Other
    leaves are kept."""
    if isinstance(tree, dict):
        return {k: host_tree(tree[k]) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(host_tree(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    return tree


def _pass_dir(save_dir: str, pass_id: int) -> str:
    return os.path.join(save_dir, f"pass-{pass_id:05d}")


_STEP_RE = re.compile(r"^step-(\d{10})$")


def _step_dir(save_dir: str, global_step: int) -> str:
    return os.path.join(save_dir, f"step-{global_step:010d}")


def _write_atomic(path: str, writer, fault_point: str = "checkpoint.write"):
    """Write via a same-directory per-process temp file + os.rename.

    Concurrent writers each produce a complete private file; the rename
    is atomic on POSIX, so readers never observe a torn truncate+write
    (last renamer wins per file). ``fault_point`` names the injection
    site fired before the fsync (distributed/faults.py)."""
    from paddle_tpu_torch.distributed import faults

    tmp = f"{path}.tmp.{os.getpid()}"
    try:
        with open(tmp, "wb") as f:
            writer(f)
            f.flush()
            faults.fire(fault_point, path=path, file=f)
            os.fsync(f.fileno())
        os.rename(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def save_checkpoint(path: str, parameters: Parameters, opt_state=None,
                    meta: Optional[dict] = None, train_state=None):
    """Every file lands via atomic rename; meta.json (with the opt-state
    and train-state checksums) is renamed LAST, so a reader that sees the
    new meta also sees complete data files. Two non-identical concurrent
    writers can still interleave renames — then load_checkpoint's checksum
    check rejects the mixed set instead of silently loading torn state.

    ``train_state`` is an optional picklable dict of mid-pass resume state
    (RNG key, evaluator partials, reader position) written alongside the
    optimizer state for step-granular snapshots."""
    t0 = time.perf_counter()
    try:
        os.makedirs(path, exist_ok=True)
        _write_atomic(os.path.join(path, "params.tar"),
                      lambda f: parameters.to_tar(f))
        if opt_state is not None:
            flat = host_tree(opt_state)
            payload = pickle.dumps(flat)
            _write_atomic(os.path.join(path, "opt_state.pkl"),
                          lambda f: f.write(payload))
            digest = hashlib.md5(payload).hexdigest()
        else:
            digest = None
        ts_digest = None
        if train_state is not None:
            ts_payload = pickle.dumps(train_state)
            _write_atomic(os.path.join(path, "train_state.pkl"),
                          lambda f: f.write(ts_payload))
            ts_digest = hashlib.md5(ts_payload).hexdigest()
        info = {"format_version": FORMAT_VERSION, "md5_opt_state": digest,
                "md5_train_state": ts_digest, **(meta or {})}
        blob = json.dumps(info).encode()
        _write_atomic(os.path.join(path, "meta.json"),
                      lambda f: f.write(blob))
    except BaseException:
        _M_CKPT_OPS.labels(op="save", ok="false").inc()
        raise
    _M_CKPT_SECONDS.labels(op="save").observe(time.perf_counter() - t0)
    _M_CKPT_OPS.labels(op="save", ok="true").inc()


def _read_meta(path: str) -> dict:
    meta_path = os.path.join(path, "meta.json")
    if not os.path.exists(meta_path):
        # meta.json is renamed LAST — it is the COMMIT record. Data files
        # without it are an uncommitted (crashed-mid-write) checkpoint:
        # loading them would resume without the train state and silently
        # double-train the prefix.
        raise CheckpointError(
            f"{path}: missing meta.json (uncommitted/torn checkpoint)")
    try:
        with open(meta_path) as f:
            return json.load(f)
    except (json.JSONDecodeError, OSError) as e:
        raise CheckpointError(f"{meta_path}: unreadable meta ({e})") from e


def validate_checkpoint(path: str) -> dict:
    """Up-front integrity validation; returns the parsed meta.

    Checks, in order: directory layout, format_version known, params.tar
    readable with every per-param header decoding to the advertised
    payload size (a truncated tar — e.g. a pre-atomic-era torn copy —
    fails HERE with a clear message), and opt/train-state checksums.
    Raises CheckpointError naming the path on any failure."""
    t0 = time.perf_counter()
    try:
        meta = _validate_impl(path)
    except CheckpointError:
        _M_CKPT_OPS.labels(op="validate", ok="false").inc()
        raise
    _M_CKPT_SECONDS.labels(op="validate").observe(time.perf_counter() - t0)
    _M_CKPT_OPS.labels(op="validate", ok="true").inc()
    return meta


def _validate_impl(path: str) -> dict:
    if not os.path.isdir(path):
        raise CheckpointError(f"{path}: not a checkpoint directory")
    ptar = os.path.join(path, "params.tar")
    if not os.path.exists(ptar):
        raise CheckpointError(f"{path}: missing params.tar")
    meta = _read_meta(path)
    fv = int(meta.get("format_version", 0) or 0)
    if fv > FORMAT_VERSION:
        raise CheckpointError(
            f"{path}: written by checkpoint format {fv}, this build reads "
            f"<= {FORMAT_VERSION} — upgrade before loading")
    try:
        fsize = os.path.getsize(ptar)
        with tarfile.open(ptar, mode="r") as tar:
            for member in tar.getmembers():
                # cheap truncation check: the payload the header promises
                # must physically fit in the file (no full member read —
                # load_checkpoint decodes the data exactly once)
                if member.offset_data + member.size > fsize:
                    raise CheckpointError(
                        f"{ptar}: member {member.name} truncated "
                        f"(promises {member.size} bytes past EOF)")
                if member.name == "model.json" or member.name.endswith(".json"):
                    continue
                if member.size < 16:
                    raise CheckpointError(
                        f"{ptar}: member {member.name} too short for a "
                        "parameter header")
                data = tar.extractfile(member)
                head = data.read(16) if data is not None else b""
                if len(head) < 16:
                    raise CheckpointError(
                        f"{ptar}: member {member.name} header unreadable")
                _version, vsize, count = struct.unpack("<iIQ", head)
                if 16 + vsize * count > member.size:
                    raise CheckpointError(
                        f"{ptar}: member {member.name} header promises "
                        f"{count} values but payload is short")
    except CheckpointError:
        raise
    except (tarfile.TarError, EOFError, struct.error, OSError) as e:
        raise CheckpointError(f"{ptar}: corrupt or truncated tar ({e})") from e
    for fname, key in (("opt_state.pkl", "md5_opt_state"),
                       ("train_state.pkl", "md5_train_state")):
        fpath = os.path.join(path, fname)
        if os.path.exists(fpath) and meta.get(key):
            with open(fpath, "rb") as f:
                payload = f.read()
            if hashlib.md5(payload).hexdigest() != meta[key]:
                raise CheckpointError(
                    f"{fpath}: checksum mismatch (torn or mixed-writer "
                    "checkpoint)")
    return meta


def load_checkpoint(path: str) -> Tuple[Parameters, object, dict]:
    """Validated load. The returned meta carries ``train_state`` (the
    unpickled mid-pass resume dict) when the checkpoint has one."""
    t0 = time.perf_counter()
    try:
        out = _load_impl(path)
    except CheckpointError:
        _M_CKPT_OPS.labels(op="load", ok="false").inc()
        raise
    _M_CKPT_SECONDS.labels(op="load").observe(time.perf_counter() - t0)
    _M_CKPT_OPS.labels(op="load", ok="true").inc()
    return out


def _load_impl(path: str) -> Tuple[Parameters, object, dict]:
    meta = validate_checkpoint(path)
    try:
        params = Parameters.from_file(os.path.join(path, "params.tar"))
    except (tarfile.TarError, EOFError, struct.error, OSError,
            AssertionError, KeyError, ValueError) as e:
        raise CheckpointError(
            f"{os.path.join(path, 'params.tar')}: failed to decode ({e})"
        ) from e
    opt_state = None
    opt_path = os.path.join(path, "opt_state.pkl")
    if os.path.exists(opt_path):
        with open(opt_path, "rb") as f:
            payload = f.read()
        try:
            opt_state = pickle.loads(payload)
        except Exception as e:
            raise CheckpointError(
                f"{opt_path}: failed to unpickle optimizer state ({e})"
            ) from e
    ts_path = os.path.join(path, "train_state.pkl")
    if os.path.exists(ts_path):
        with open(ts_path, "rb") as f:
            ts_payload = f.read()
        try:
            meta = {**meta, "train_state": pickle.loads(ts_payload)}
        except Exception as e:
            raise CheckpointError(
                f"{ts_path}: failed to unpickle train state ({e})") from e
    return params, opt_state, meta


def save_pass(save_dir: str, pass_id: int, parameters: Parameters,
              opt_state=None):
    """ParameterUtil::saveParameters analog (per-pass dir)."""
    save_checkpoint(_pass_dir(save_dir, pass_id), parameters, opt_state,
                    {"pass_id": pass_id})


def load_pass(save_dir: str, pass_id: int):
    return load_checkpoint(_pass_dir(save_dir, pass_id))


# --- step-granular snapshots (mid-pass crash safety) -----------------------

def save_step(save_dir: str, global_step: int, parameters: Parameters,
              opt_state=None, meta: Optional[dict] = None, train_state=None,
              keep: int = 0) -> str:
    """Write ``save_dir/step-%010d``. ``global_step`` is the trainer's
    monotonic batch counter ACROSS passes, so lexical dir order is
    recovery order. ``keep > 0`` prunes all but the newest ``keep`` step
    dirs after a successful write (the previous snapshot is always kept
    until the new one is fully landed — torn-write fallback depends on
    it)."""
    path = _step_dir(save_dir, global_step)
    save_checkpoint(path, parameters, opt_state,
                    {"global_step": global_step, **(meta or {})}, train_state)
    if keep > 0:
        for _step, old in list_step_snapshots(save_dir)[:-keep]:
            shutil.rmtree(old, ignore_errors=True)
    return path


def list_step_snapshots(save_dir: str) -> List[Tuple[int, str]]:
    """[(global_step, path)] ascending; missing dir -> []."""
    out = []
    try:
        names = os.listdir(save_dir)
    except FileNotFoundError:
        return out
    for name in names:
        m = _STEP_RE.match(name)
        if m:
            out.append((int(m.group(1)), os.path.join(save_dir, name)))
    return sorted(out)


def find_latest_step(save_dir: str) -> Optional[Tuple[int, str]]:
    """Newest VALID step snapshot, validating candidates newest-first and
    falling back past torn/corrupt ones (with a warning) — the reader-side
    half of the torn-write story."""
    logger = logging.getLogger("paddle_tpu_torch")

    for step, path in reversed(list_step_snapshots(save_dir)):
        try:
            validate_checkpoint(path)
            return step, path
        except CheckpointError as e:
            _M_CKPT_INVALID.inc()
            logger.warning("skipping invalid step snapshot %s: %s", path, e)
    return None


def clear_step_snapshots(save_dir: str):
    """Remove all step snapshots (training completed normally — pass-level
    checkpoints remain; a rerun starts fresh instead of resuming into a
    finished run)."""
    for _step, path in list_step_snapshots(save_dir):
        shutil.rmtree(path, ignore_errors=True)


# --- generic pickled-state snapshots ---------------------------------------
#
# The step-snapshot machinery above is Parameters-shaped (params.tar +
# opt_state.pkl). Services whose state is an arbitrary picklable dict —
# the async pserver's params + optimizer state + host-table rows + dedup
# sequence map — get the same crash-safety discipline through these:
# one ``state.pkl`` written by the atomic writer, ``meta.json`` (with the
# state md5 and format_version) renamed LAST as the commit record, and a
# newest-first validating scan that falls back past torn snapshots.

def _state_dir(save_dir: str, prefix: str, seq: int) -> str:
    return os.path.join(save_dir, f"{prefix}-{seq:020d}")


def save_state_snapshot(save_dir: str, seq: int, payload: dict,
                        prefix: str = "pserver",
                        meta: Optional[dict] = None, keep: int = 0,
                        fault_point: str = "checkpoint.write") -> str:
    """Write ``save_dir/<prefix>-%020d/{state.pkl, meta.json}``. ``seq``
    must be monotone across a service's lifetime (the pserver uses a
    persisted snapshot ordinal) so lexical dir order is recovery
    order. ``keep > 0`` prunes all but the newest ``keep`` AFTER the new
    snapshot fully lands — the torn-write fallback always has the
    previous valid snapshot to land on."""
    t0 = time.perf_counter()
    path = _state_dir(save_dir, prefix, seq)
    try:
        os.makedirs(path, exist_ok=True)
        blob = pickle.dumps(payload)
        _write_atomic(os.path.join(path, "state.pkl"),
                      lambda f: f.write(blob), fault_point=fault_point)
        info = {"format_version": FORMAT_VERSION, "seq": int(seq),
                "md5_state": hashlib.md5(blob).hexdigest(), **(meta or {})}
        mblob = json.dumps(info).encode()
        _write_atomic(os.path.join(path, "meta.json"),
                      lambda f: f.write(mblob), fault_point=fault_point)
    except BaseException:
        _M_CKPT_OPS.labels(op="save", ok="false").inc()
        raise
    _M_CKPT_SECONDS.labels(op="save").observe(time.perf_counter() - t0)
    _M_CKPT_OPS.labels(op="save", ok="true").inc()
    if keep > 0:
        for _seq, old in list_state_snapshots(save_dir, prefix)[:-keep]:
            shutil.rmtree(old, ignore_errors=True)
    return path


def _read_state_impl(path: str) -> Tuple[dict, bytes]:
    """ONE read of a state snapshot dir with full validation: (meta,
    state blob). Shared by validate and load so the restore path does
    not read a multi-GB state.pkl more than once per step."""
    if not os.path.isdir(path):
        raise CheckpointError(f"{path}: not a snapshot directory")
    meta = _read_meta(path)
    fv = int(meta.get("format_version", 0) or 0)
    if fv > FORMAT_VERSION:
        raise CheckpointError(
            f"{path}: written by snapshot format {fv}, this build "
            f"reads <= {FORMAT_VERSION} — upgrade before loading")
    spath = os.path.join(path, "state.pkl")
    if not os.path.exists(spath):
        raise CheckpointError(f"{path}: missing state.pkl")
    with open(spath, "rb") as f:
        blob = f.read()
    if hashlib.md5(blob).hexdigest() != meta.get("md5_state"):
        raise CheckpointError(
            f"{spath}: checksum mismatch (torn snapshot)")
    return meta, blob


def validate_state_snapshot(path: str) -> dict:
    """Commit-record + checksum validation; returns the parsed meta or
    raises CheckpointError naming the path."""
    t0 = time.perf_counter()
    try:
        meta, _blob = _read_state_impl(path)
    except CheckpointError:
        _M_CKPT_OPS.labels(op="validate", ok="false").inc()
        raise
    _M_CKPT_SECONDS.labels(op="validate").observe(time.perf_counter() - t0)
    _M_CKPT_OPS.labels(op="validate", ok="true").inc()
    return meta


def load_state_snapshot(path: str) -> Tuple[dict, dict]:
    """Validated (payload, meta) load of one state snapshot dir —
    state.pkl is read and checksummed exactly once."""
    t0 = time.perf_counter()
    try:
        meta, blob = _read_state_impl(path)
        try:
            payload = pickle.loads(blob)
        except Exception as e:
            raise CheckpointError(
                f"{path}/state.pkl: failed to unpickle ({e})") from e
    except CheckpointError:
        _M_CKPT_OPS.labels(op="load", ok="false").inc()
        raise
    _M_CKPT_SECONDS.labels(op="load").observe(time.perf_counter() - t0)
    _M_CKPT_OPS.labels(op="load", ok="true").inc()
    return payload, meta


def list_state_snapshots(save_dir: str, prefix: str = "pserver"
                         ) -> List[Tuple[int, str]]:
    """[(seq, path)] ascending; missing dir -> []."""
    pat = re.compile(rf"^{re.escape(prefix)}-(\d{{20}})$")
    out = []
    try:
        names = os.listdir(save_dir)
    except FileNotFoundError:
        return out
    for name in names:
        m = pat.match(name)
        if m:
            out.append((int(m.group(1)), os.path.join(save_dir, name)))
    return sorted(out)


def load_latest_state_snapshot(save_dir: str, prefix: str = "pserver"
                               ) -> Optional[Tuple[int, str, dict]]:
    """Newest valid snapshot's (seq, path, payload), falling back past
    torn ones (warning + invalid-snapshot counter) — the find_latest_step
    contract. Each candidate is read exactly once (validate + decode
    share the read) — the restore path for multi-GB snapshots must not
    pay double I/O."""
    logger = logging.getLogger("paddle_tpu_torch")

    for seq, path in reversed(list_state_snapshots(save_dir, prefix)):
        try:
            payload, _meta = load_state_snapshot(path)
            return seq, path, payload
        except CheckpointError as e:
            _M_CKPT_INVALID.inc()
            logger.warning("skipping invalid state snapshot %s: %s", path, e)
    return None
