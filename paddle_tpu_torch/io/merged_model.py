"""Merged inference bundles, the forward's serialized artifact and the
decode's per-tick step export (counterpart of
``paddle_tpu/io/merged_model.py``; analog of
paddle/trainer/MergeModel.cpp:23-64).

A bundle is one file, in the JAX package's format (little-endian)::

    8 bytes magic  b"PTPUMDL1"
    8 bytes uint64 JSON config length
    JSON   config  (Topology.serialize() + meta)
    tar    parameters (Parameters.to_tar format)

For the same topology, parameters, meta and version, ``write_bundle``
writes the JAX package's bytes, and each package reads the other's
bundles (``InferenceMachine`` serves them). Every bundle carries
``meta.bundle_version`` (from the flock counter that JAX writers share,
``next_bundle_version``), ``meta.param_bytes`` and ``meta.param_crc32``.

``export_forward_ex`` is the counterpart of JAX's
``export_forward_stablehlo_ex``: PyTorch has no StableHLO producer, so
the artifact is a ``torch.export`` program (``torch.export.save``'s
bytes, the parameters its constants, the LSTM's and the GRU's forwards
the custom ops ``paddle_tpu_torch::lstm_fwd`` and ``::gru_fwd``), kept
under ``meta.torch_export``; a beam decode's whole loop is one such
program. JAX's ``stablehlo`` keys are not read here, and JAX reads none
of these.

The decode's transition on its own, for a continuous-batching scheduler
(step_decode.py), with the JAX export's signature: an ``init`` run once
per admission and a ``step`` run once per tick over the whole slot
array. ``export_decode_step_artifacts_ex`` makes them two ``torch.export``
programs (JAX ``export_decode_step_stablehlo_ex``), kept under
``meta.torch_step`` (``step_export_meta``) and loaded by
``load_step_export``; ``export_decode_step_ex`` runs the same two modules
in this process, the parameters moved to the device (and their
transposed tables laid out) once, with no cap.

Not ported: host-resident tables in bundles (ROADMAP queue 1 item 8),
``merge_model`` (item 9), per-platform modules and batch ladders.
"""

from __future__ import annotations

import base64
import io
import json
import shutil
import struct
import tempfile
import threading
import time
import zlib
from typing import Optional, Tuple, Union

import torch

from paddle_tpu_torch import quant
from paddle_tpu_torch.core.arg import Arg
from paddle_tpu_torch.core.parameters import Parameters
from paddle_tpu_torch.core.topology import Topology, topology_from_config
from paddle_tpu_torch.data_type import InputType, SeqType
from paddle_tpu_torch.utils.device import resolve_device
from paddle_tpu_torch.utils.error import Error, enforce

MAGIC = b"PTPUMDL1"

# bundle_version stamping: within a process, the millisecond wall clock
# bumped past the last value handed out; across processes (two writers,
# of either package, in one publish dir) only through
# ``next_bundle_version(publish_dir)``'s flock-serialized counter file
_version_lock = threading.Lock()
_last_version = 0

#: the counter file ``next_bundle_version(publish_dir)`` keeps, shared
#: with the JAX package's writers
VERSION_COUNTER_FILE = "BUNDLE_VERSION"

# the static sequence length a padded, masked sequence feed is exported at
# unless the caller gives one (the JAX package's default)
EXPORT_SEQ_LEN = 16
# the static batch of the forward's export, and its fallback where the
# batch cannot stay symbolic (the JAX package's PJRT_STATIC_BATCH)
EXPORT_STATIC_BATCH = 8
# the slot batch of a step export unless the caller gives one
DECODE_EXPORT_SLOTS = 8
# the largest parameter set an artifact embeds as constants (the JAX
# package's cap: past it the bundle's bloat is not worth it)
EXPORT_MAX_PARAM_BYTES = 32 * 1024 * 1024

# the layer types whose forward reaches a kernel that is not yet a
# dispatcher op (``lstm_fwd`` and ``gru_fwd`` are), by that kernel's
# wrapper: traced on the CPU, an artifact would hold its plain version and
# run that on the card with no launch, so export_forward_ex refuses them
_KERNELS_WITHOUT_OP = {"crf": "crf_logz", "ctc": "ctc_nll_kernel",
                       "warp_ctc": "ctc_nll_kernel"}

# any ctx.extras key of a beam decode that the forward's export returns
_GEN_EXTRA_SUFFIXES = (":ids", ":scores", ":ticks")

#: what a port-written bundle says where JAX's carry StableHLO; the
#: native daemon reads it (its /v1/signature then carries the meta's
#: quantize and param_bytes, and its pjrt backend refuses the bundle)
STABLEHLO_SKIP_REASON = (
    "written by paddle_tpu_torch, which has no StableHLO producer; the "
    "forward's artifact, where there is one, is meta.torch_export")
#: what a port-written generation bundle says where JAX's carry the step
#: modules; the native daemon logs it when it decodes drain-batch
STABLEHLO_STEP_SKIP_REASON = (
    "written by paddle_tpu_torch, which has no StableHLO producer; the "
    "decode step's artifacts, where there are any, are meta.torch_step")

_TAGS = {torch.float32: "f32", torch.int32: "i32", torch.int64: "i64",
         torch.float64: "f64", torch.bool: "pred", torch.uint8: "u8"}
DTYPES = {tag: dt for dt, tag in _TAGS.items()}


def _host_tables_error(names) -> Error:
    return Error(f"host-resident table(s) {sorted(names)} in a bundle: "
                 "host tables are not ported yet (ROADMAP queue 1 item 8, "
                 "host_table.py)")


# --- versions --------------------------------------------------------------

def _next_bundle_version() -> int:
    global _last_version
    with _version_lock:
        v = int(time.time() * 1000)
        _last_version = v if v > _last_version else _last_version + 1
        return _last_version


def _bump_counter(publish_dir: str, next_value) -> int:
    """Under an exclusive flock of ``publish_dir``'s counter file, write
    ``next_value(last)`` where it exceeds the last value, and return it
    (the JAX package's read-modify-write: one fd a call, so that the lock
    pairs with this update)."""
    import fcntl
    import os

    os.makedirs(publish_dir, exist_ok=True)
    path = os.path.join(publish_dir, VERSION_COUNTER_FILE)
    fd = os.open(path, os.O_RDWR | os.O_CREAT, 0o644)
    try:
        fcntl.flock(fd, fcntl.LOCK_EX)
        raw = os.read(fd, 64)
        try:
            last = int(raw.decode().strip() or "0")
        except ValueError:
            last = 0
        v = next_value(last)
        if v > last:
            os.lseek(fd, 0, os.SEEK_SET)
            os.ftruncate(fd, 0)
            os.write(fd, str(v).encode())
            os.fsync(fd)
    finally:
        os.close(fd)                   # releases the flock
    return v


def record_bundle_version(publish_dir: str, version: int) -> None:
    """Raise ``publish_dir``'s counter to at least ``version``, so that
    later ``next_bundle_version`` draws there clear an explicit
    version."""
    global _last_version
    with _version_lock:
        _bump_counter(publish_dir, lambda last: int(version))
        _last_version = max(_last_version, int(version))


def next_bundle_version(publish_dir: Optional[str] = None) -> int:
    """The next monotonic ``bundle_version``: without a dir, the
    in-process clock-and-floor sequence; with ``publish_dir``, a
    fetch-and-bump of ``publish_dir/BUNDLE_VERSION`` under an exclusive
    flock, so that writers in several processes, of either package, never
    hand out the same or a regressing version."""
    global _last_version
    if publish_dir is None:
        return _next_bundle_version()
    with _version_lock:
        v = _bump_counter(publish_dir, lambda last: max(
            int(time.time() * 1000), last + 1, _last_version + 1))
        _last_version = max(_last_version, v)
        return v


def newest_bundle_version(dirpath: str, exclude: Optional[str] = None) -> int:
    """Highest ``meta.bundle_version`` among the ``*.ptpu`` bundles in
    ``dirpath`` (0 when none); ``exclude`` names a path to skip (through
    symlinks). Unreadable or torn files are skipped."""
    import glob
    import os

    newest = 0
    exclude = os.path.realpath(exclude) if exclude else None
    for p in glob.glob(os.path.join(dirpath, "*.ptpu")):
        if exclude and os.path.realpath(p) == exclude:
            continue
        try:
            v = int(read_bundle_meta(p).get("bundle_version", 0))
        except Exception:  # noqa: BLE001 - torn or foreign: not a bundle
            continue
        newest = max(newest, v)
    return newest


# --- bundles ---------------------------------------------------------------

def write_bundle(f, topology: Topology, parameters: Parameters,
                 meta: Optional[dict] = None, version: Optional[int] = None,
                 host_tables: Optional[dict] = None):
    """Write a PTPUMDL1 bundle to the binary file ``f``, stamped with
    ``meta.bundle_version`` (``version``, positive, or the in-process
    sequence), ``meta.param_bytes`` and ``meta.param_crc32``, the zlib
    CRC-32 of the parameter tar, which readers check (``verify_bundle``,
    the native daemon). ``host_tables`` raises: not ported yet."""
    if host_tables:
        raise _host_tables_error(host_tables)
    cfg = topology.serialize()
    meta = dict(meta) if meta else {}
    if version is not None:
        enforce(int(version) > 0,
                f"bundle_version must be a positive integer, got {version}")
    meta.setdefault("bundle_version",
                    version if version is not None
                    else _next_bundle_version())
    meta.setdefault("param_bytes", quant.param_bytes(
        {k: parameters.get(k) for k in parameters.names()}))
    # the crc goes into the JSON header, ahead of the tar: spool the tar
    # (to disk past 64 MiB) and crc it in chunks
    with tempfile.SpooledTemporaryFile(max_size=64 << 20) as tar_buf:
        parameters.to_tar(tar_buf)
        tar_buf.seek(0)
        crc = 0
        while True:
            chunk = tar_buf.read(1 << 20)
            if not chunk:
                break
            crc = zlib.crc32(chunk, crc)
        meta["param_crc32"] = "%08x" % (crc & 0xFFFFFFFF)
        cfg["meta"] = meta
        blob = json.dumps(cfg).encode()
        f.write(MAGIC)
        f.write(struct.pack("<Q", len(blob)))
        f.write(blob)
        tar_buf.seek(0)
        shutil.copyfileobj(tar_buf, f)


def read_bundle(f) -> Tuple[Topology, Parameters, dict]:
    magic = f.read(8)
    enforce(magic == MAGIC, f"not a merged model bundle (magic={magic!r})")
    (n,) = struct.unpack("<Q", f.read(8))
    cfg = json.loads(f.read(n).decode())
    topo = topology_from_config(cfg)
    params = Parameters.from_tar(f)
    return topo, params, cfg.get("meta", {})


def dequantize_bundle_params(params: Parameters, meta: dict) -> Parameters:
    """A quantized bundle's parameters widened back to float32 (int8 codes
    times their ``:scale``, bf16 casts); the parameters themselves for a
    float32 bundle."""
    qmeta = (meta or {}).get("quantize")
    if not qmeta:
        return params
    d = quant.dequantize_params({k: params.get(k) for k in params.names()},
                                qmeta)
    return Parameters.from_dict(d)


def load_merged_model(path: str, dequantize: bool = True
                      ) -> Tuple[Topology, Parameters, dict]:
    """(topology, parameters, meta) of the bundle at ``path``, its
    parameters widened to float32 unless ``dequantize`` is False. A bundle
    with host-resident tables raises: the port cannot serve their rows."""
    with open(path, "rb") as f:
        topo, params, meta = read_bundle(f)
    if meta.get("host_tables"):
        raise _host_tables_error(meta["host_tables"])
    if dequantize:
        params = dequantize_bundle_params(params, meta)
    return topo, params, meta


def _read_header(f, path: str) -> dict:
    magic = f.read(8)
    enforce(magic == MAGIC,
            f"{path}: not a merged model bundle (magic={magic!r})")
    raw = f.read(8)
    enforce(len(raw) == 8, f"{path}: truncated bundle header")
    (n,) = struct.unpack("<Q", raw)
    blob = f.read(n)
    enforce(len(blob) == n, f"{path}: truncated bundle header")
    return json.loads(blob.decode()).get("meta", {})


def read_bundle_meta(path: str) -> dict:
    """The JSON header's ``meta`` alone; the parameter tar is not read."""
    with open(path, "rb") as f:
        return _read_header(f, path)


def verify_bundle(path: str) -> dict:
    """Check a bundle on disk as the serving daemon does on a reload:
    magic, a whole JSON header, and the parameter tar's bytes hashing to
    ``meta.param_crc32``. Returns the meta; raises ``Error`` on any
    mismatch, so that a torn write never validates."""
    with open(path, "rb") as f:
        meta = _read_header(f, path)
        want = meta.get("param_crc32")
        enforce(want is not None,
                f"{path}: bundle carries no param_crc32 to validate")
        crc = 0
        while True:
            chunk = f.read(1 << 20)
            if not chunk:
                break
            crc = zlib.crc32(chunk, crc)
        got = "%08x" % (crc & 0xFFFFFFFF)
        enforce(got == want,
                f"{path}: parameter crc mismatch (torn write?): meta says "
                f"{want}, tar bytes hash to {got}")
        return meta


def bundle_meta(topology: Topology, parameters: Parameters,
                qmeta: Optional[dict] = None, seq_len=None,
                static_batch=None, slots=None) -> dict:
    """The meta a port-written bundle carries (``merge_model``'s, less
    StableHLO): ``quantize`` for quantized ``parameters``, the forward's
    artifact under ``torch_export`` (:func:`export_forward_ex`) or why
    there is none under ``torch_export_skip_reason``, and
    ``stablehlo_skip_reason``. A generation topology also carries the
    decode step's artifacts at ``slots`` slots under ``torch_step``
    (:func:`export_decode_step_artifacts_ex`) or why there are none under
    ``torch_step_skip_reason``, and ``stablehlo_step_skip_reason``."""
    from paddle_tpu_torch.layers.recurrent_group import find_beam_layers

    meta = {"quantize": qmeta} if qmeta else {}
    res, reason = export_forward_ex(topology, parameters, seq_len=seq_len,
                                    static_batch=static_batch, qmeta=qmeta)
    if res is not None:
        meta["torch_export"] = forward_export_meta(res)
    else:
        meta["torch_export_skip_reason"] = reason
    meta["stablehlo_skip_reason"] = STABLEHLO_SKIP_REASON
    if find_beam_layers(topology):
        step, reason = export_decode_step_artifacts_ex(
            topology, parameters, seq_len=seq_len, slots=slots, qmeta=qmeta)
        if step is not None:
            meta["torch_step"] = step_export_meta(step)
        else:
            meta["torch_step_skip_reason"] = reason
        meta["stablehlo_step_skip_reason"] = STABLEHLO_STEP_SKIP_REASON
    return meta


# --- the forward's artifact --------------------------------------------------

def _input_specs(topology: Topology, seq_len):
    """Typed feed signature of an inference topology: one entry per
    argument, in feed order, value before mask. Returns (specs, None) or
    (None, skip_reason). Each spec: {feed, role: value|mask, name, dtype:
    f32|i32, shape: ['b', ...]}; ``seq_len`` an int or {feed: int}."""
    specs = []
    for d in topology.data_layers:
        it = d.attr("input_type")
        T = seq_len.get(d.name, EXPORT_SEQ_LEN) \
            if isinstance(seq_len, dict) else seq_len
        if it is None or not isinstance(it, InputType):
            specs.append({"feed": d.name, "role": "value", "name": d.name,
                          "dtype": "f32", "shape": ["b", int(d.size)]})
            continue
        if it.kind in ("sparse_binary", "sparse_value"):
            return None, (f"data layer {d.name!r}: sparse feed kind "
                          f"{it.kind!r} has no servable export form yet")
        if it.seq_type == SeqType.SUB_SEQUENCE:
            return None, (f"data layer {d.name!r}: nested SUB_SEQUENCE "
                          "feeds are not exportable (ragged sub-seqs)")
        if it.seq_type == SeqType.NO_SEQUENCE:
            # the feeder's shapes: ids [B, 1] int32, dense [B, dim]
            index = it.kind == "index"
            specs.append({"feed": d.name, "role": "value", "name": d.name,
                          "dtype": "i32" if index else "f32",
                          "shape": ["b", 1 if index else int(d.size)]})
            continue
        # a plain sequence: padded value and float32 mask at a static T
        index = it.kind == "index"
        specs.append({"feed": d.name, "role": "value", "name": d.name,
                      "dtype": "i32" if index else "f32",
                      "shape": ["b", int(T)] if index
                      else ["b", int(T), int(d.size)]})
        specs.append({"feed": d.name, "role": "mask",
                      "name": d.name + ":mask", "dtype": "f32",
                      "shape": ["b", int(T)]})
    if not specs:
        return None, "topology has no data layers"
    return specs, None


def _kernel_without_op(topology: Topology) -> Optional[str]:
    """Why ``topology`` has no artifact where a layer of it, or of a
    recurrent group's or a decode's inner graph, reaches a kernel that
    is not a dispatcher op; else None."""
    for l in topology.layers:
        kernel = _KERNELS_WITHOUT_OP.get(l.type)
        if kernel is not None:
            return (f"layer {l.name!r} ({l.type}) reaches the {kernel} "
                    "kernel, which is not a dispatcher op yet (ROADMAP "
                    "queue 1 item 2): an artifact would run its plain "
                    "version on the card")
        for v in l.cfg.values():
            inner = getattr(v, "topology", None)
            reason = _kernel_without_op(inner) \
                if isinstance(inner, Topology) else None
            if reason is not None:
                return reason
    return None


def _feeds(in_specs, flat) -> dict:
    """The topology's feeds from flat tensors in ``in_specs``' order: an
    Arg a data layer, its mask beside its value."""
    vals = dict(zip((s["name"] for s in in_specs), flat))
    return {s["feed"]: Arg(vals[s["name"]], vals.get(s["feed"] + ":mask"))
            for s in in_specs if s["role"] == "value"}


def _example(in_specs, batch: int, device=None) -> list:
    """Inputs of the specs at ``batch``: zero values (valid ids), masks of
    ones."""
    return [(torch.ones if s["role"] == "mask" else torch.zeros)(
        tuple(batch if d == "b" else int(d) for d in s["shape"]),
        dtype=DTYPES[s["dtype"]], device=device) for s in in_specs]


def _constants(topology: Topology, parameters: Parameters,
               qmeta: Optional[dict]):
    """(the parameters an artifact embeds, on the CPU, None) or (None,
    skip_reason): missing ones, or past JAX's 32 MiB cap. A quantized
    export also embeds the float32 ':scale' sidecars."""
    pspecs = topology.param_specs()
    wanted = set(pspecs)
    if qmeta:
        wanted |= {n for n in qmeta.get("param_dtypes", ())
                   if n.endswith(quant.SCALE_SUFFIX)}
    pdict = {k: parameters.get(k).detach().cpu().contiguous()
             for k in parameters.names() if k in wanted}
    missing = set(pspecs) - set(pdict)
    if missing:
        return None, f"parameters missing for export: {sorted(missing)}"
    psize = sum(t.numel() * t.element_size() for t in pdict.values())
    if psize > EXPORT_MAX_PARAM_BYTES:
        return None, (f"parameter set too large to embed as module "
                      f"constants ({psize >> 20} MiB > 32 MiB)")
    return pdict, None


class _Forward(torch.nn.Module):
    """The topology's forward over flat inputs, its parameters buffers
    (quantized ones widened inside, on every run)."""

    def __init__(self, topology: Topology, pdict: dict,
                 qmeta: Optional[dict], in_specs: list):
        super().__init__()
        self.topology, self.qmeta, self.in_specs = topology, qmeta, in_specs
        self.names = list(pdict)
        for i, name in enumerate(self.names):
            self.register_buffer(f"p{i}", pdict[name])
        self.out_names: list = []

    def results(self, flat) -> dict:
        """Each output's value (and mask), then the decode's extras."""
        params = quant.dequantize_params(
            {n: getattr(self, f"p{i}") for i, n in enumerate(self.names)},
            self.qmeta)
        outs, ctx = self.topology.forward(params, _feeds(self.in_specs, flat),
                                          return_ctx=True)
        res = {}
        for o in self.topology.outputs:
            res[o.name] = outs[o.name].value
            if outs[o.name].mask is not None:
                res[o.name + ":mask"] = outs[o.name].mask
        for k in sorted(ctx.extras):
            v = ctx.extras[k]
            if k.endswith(":ticks") and isinstance(v, int):
                # the eager early exit counts its ticks on the host; the
                # traced decode returns them as this tensor
                v = torch.tensor(v, dtype=torch.int32)
            if k.endswith(_GEN_EXTRA_SUFFIXES) and k not in res and \
                    isinstance(v, torch.Tensor):
                res[k] = v
        return res

    def forward(self, *flat):
        res = self.results(flat)
        if len(self.out_names) == 1:
            return res[self.out_names[0]]
        return tuple(res[n] for n in self.out_names)


def export_forward_ex(topology: Topology, parameters: Parameters,
                      seq_len=None, static_batch=None,
                      qmeta: Optional[dict] = None):
    """The forward as a serialized ``torch.export`` program (JAX
    ``export_forward_stablehlo_ex``): any number of typed feeds (float32
    dense, int32 ids and id sequences with their masks), the outputs'
    values and masks, then the sorted ``:ids``/``:scores``/``:ticks``
    extras of a decode (its whole loop in the program, the early exit a
    ``while_loop``, ``:ticks`` an int32 tensor). The parameters
    (quantized ones as they are, with their scales: ``qmeta``) are its
    constants, and an LSTM's and a GRU's forwards are the custom ops
    ``paddle_tpu_torch::lstm_fwd`` and ``::gru_fwd``, which launch their
    kernels where the program runs on the card (a GRU layer takes the
    op wherever the card's eager code takes the kernel).

    The batch is symbolic where ``torch.export`` takes it so, else static
    at ``static_batch`` (``signature.symbolic_batch`` False, the error in
    ``symbolic_batch_error``). Traced on the CPU; load it with
    :func:`load_forward_export`. Returns ``({"artifact": bytes,
    "signature": ..., "static_batch": n}, None)`` or ``(None,
    skip_reason)``: past JAX's 32 MiB of parameters, say, or for a layer
    that reaches a kernel that is not an op (CRF, CTC)."""
    seq_len = EXPORT_SEQ_LEN if seq_len is None else seq_len
    static_batch = int(EXPORT_STATIC_BATCH if static_batch is None
                       else static_batch)
    in_specs, reason = _input_specs(topology, seq_len)
    if in_specs is None:
        return None, reason
    reason = _kernel_without_op(topology)
    if reason is not None:
        return None, reason
    pdict, reason = _constants(topology, parameters, qmeta)
    if pdict is None:
        return None, reason
    module = _Forward(topology, pdict, qmeta, in_specs)
    try:
        with torch.no_grad():
            probe = module.results(_example(in_specs, static_batch))
    except Exception as e:  # noqa: BLE001 - a forward that fails: say why
        return None, f"forward does not run for export: {e}"
    # topology outputs (value, then mask) in declaration order, then the
    # sorted decode extras
    for o in topology.outputs:
        module.out_names.append(o.name)
        if o.name + ":mask" in probe:
            module.out_names.append(o.name + ":mask")
    module.out_names += sorted(k for k in probe if k not in module.out_names)
    sig = {"inputs": [dict(s) for s in in_specs],
           "static_batch": static_batch, "symbolic_batch": True,
           "quantize": qmeta["mode"] if qmeta else "f32"}
    args = tuple(_example(in_specs, static_batch))
    batch = torch.export.Dim("b", min=1)
    try:
        program = torch.export.export(
            module, args,
            dynamic_shapes=(tuple({0: batch} for _ in args),))
    except Exception as e:  # noqa: BLE001 - the batch specialized: go static
        sig["symbolic_batch"] = False
        sig["symbolic_batch_error"] = str(e)[:500]
        try:
            program = torch.export.export(module, args)
        except Exception as e2:  # noqa: BLE001 - recorded as the reason
            return None, f"torch.export failed: {e2}"

    def entry(name):
        t = probe[name]
        shape = list(t.shape)
        if sig["symbolic_batch"] and shape[:1] == [static_batch]:
            shape[0] = "b"
        enforce(t.dtype in _TAGS, f"unsupported export dtype {t.dtype}")
        return {"name": name, "dtype": _TAGS[t.dtype], "shape": shape}

    sig["outputs"] = [entry(n) for n in module.out_names]
    buf = io.BytesIO()
    torch.export.save(program, buf)
    return {"artifact": buf.getvalue(), "signature": sig,
            "static_batch": static_batch}, None


def forward_export_meta(res: dict) -> dict:
    """The JSON-able form of an :func:`export_forward_ex` result, kept
    under a bundle's ``meta["torch_export"]``."""
    return {"artifact_b64": base64.b64encode(res["artifact"]).decode(),
            "signature": res["signature"],
            "static_batch": res["static_batch"]}


class ForwardExport:
    """A loaded forward artifact: ``(*flat)`` runs it on ``device`` over
    the signature's inputs (tensors or arrays, in its order) and returns
    its results there, a tensor where there is one, else a tuple."""

    def __init__(self, module, signature: dict, device: torch.device):
        self._module = module
        self.signature = signature
        self.device = device

    def __call__(self, *flat):
        specs = self.signature["inputs"]
        enforce(len(flat) == len(specs),
                f"the artifact takes {len(specs)} inputs "
                f"({[s['name'] for s in specs]}), got {len(flat)}")
        args = [torch.as_tensor(a).to(self.device, DTYPES[s["dtype"]])
                for a, s in zip(flat, specs)]
        with torch.inference_mode():
            return self._module(*args)


def load_forward_export(meta: dict, device: Union[str, torch.device] = "cuda"
                        ) -> ForwardExport:
    """The forward artifact of a bundle's ``meta`` (``torch_export``), its
    constants moved to ``device``; raises, with the recorded reason, for
    a bundle without one."""
    exp = meta.get("torch_export")
    if exp is None:
        raise Error("bundle has no forward artifact: " + meta.get(
            "torch_export_skip_reason", "no torch_export in its meta"))
    device = resolve_device(device)
    program = torch.export.load(io.BytesIO(
        base64.b64decode(exp["artifact_b64"])))
    if device.type != "cpu":
        from torch.export.passes import move_to_device_pass

        program = move_to_device_pass(program, device)
    return ForwardExport(program.module(), exp["signature"], device)


class StepModule:
    """Stands where the JAX export has a serialized module: ``call(*flat)``
    runs ``fn`` on the flat tensors, without autograd, and returns a
    tuple of tensors on the device."""

    def __init__(self, fn):
        self._fn = fn

    def call(self, *flat):
        with torch.no_grad():
            return self._fn(*flat)


class _DecodeStep(torch.nn.Module):
    """The decode step's ``init`` (the topology feeds in ``in_specs``'
    order to ``out_names``) or ``step`` (the ``in_names`` state and
    encoder entries to ``out_names``) over flat tensors, through
    ``BeamStepExport``; its parameters buffers, quantized ones widened
    inside every run (JAX ``_tick_params``). The in-process export runs
    it eagerly; ``torch.export`` makes each an artifact."""

    def __init__(self, ex, which: str, pdict: dict, qmeta: Optional[dict],
                 in_specs: list, in_names: list, out_names: list):
        super().__init__()
        self.ex, self.which, self.qmeta = ex, which, qmeta
        self.in_specs, self.in_names, self.out_names = \
            in_specs, in_names, out_names
        self.names = list(pdict)
        for i, name in enumerate(self.names):
            self.register_buffer(f"p{i}", pdict[name])

    def params(self) -> dict:
        return quant.dequantize_params(
            {n: getattr(self, f"p{i}") for i, n in enumerate(self.names)},
            self.qmeta)

    def named(self, flat) -> dict:
        if self.which == "init":
            return self.ex.init_fn(self.params(), _feeds(self.in_specs, flat))
        return self.ex.step_fn(self.params(), dict(zip(self.in_names, flat)))

    def forward(self, *flat):
        named = self.named(flat)
        return tuple(named[n] for n in self.out_names)


def _step_setup(topology: Topology, parameters: Parameters, seq_len,
                slots):
    """What both step exports start from: (BeamStepExport, in_specs,
    None) or (None, None, skip_reason), in JAX's order of checks."""
    from paddle_tpu_torch.layers.recurrent_group import (
        BeamStepExport, beam_step_unsupported)

    reason = beam_step_unsupported(topology)
    if reason is not None:
        return None, None, reason
    in_specs, reason = _input_specs(topology, seq_len)
    if in_specs is None:
        return None, None, reason
    missing = sorted(set(topology.param_specs()) - set(parameters.names()))
    if missing:
        return None, None, f"parameters missing for export: {missing}"
    return BeamStepExport(topology), in_specs, None


def _step_modules(ex, pdict, qmeta, in_specs, slots, device=None):
    """The init and step modules over ``pdict``, and init's outputs on
    ``slots`` example rows (which name the encoder entries); an encoder
    that fails raises."""
    init = _DecodeStep(ex, "init", pdict, qmeta, in_specs, [], [])
    with torch.no_grad():
        probe = init.named(_example(in_specs, slots, device))
    enc_names = []
    for i in range(ex.n_static):
        enc_names.append(f"enc:{i}")
        if f"enc:{i}:mask" in probe:
            enc_names.append(f"enc:{i}:mask")
    init.out_names = ex.state_names() + enc_names
    step = _DecodeStep(ex, "step", pdict, qmeta, in_specs, init.out_names,
                       ex.state_names() + ["emitted", "done"])
    return init, step, probe


def _step_signature(ex, in_specs, init, step, probe, probe_step, slots,
                    qmeta, errors):
    """The step export's signature, JAX's keys in JAX's order: the slot
    batch "b" in an entry's leading dimension where it stayed symbolic
    (no ``errors``, which record each program's static fallback)."""
    sig = {"slots": slots, "beam": int(ex.beam),
           "max_length": int(ex.max_len), "eos_id": int(ex.eos_id),
           "bos_id": int(ex.bos_id), "symbolic_batch": not errors,
           "quantize": qmeta["mode"] if qmeta else "f32",
           "inputs": [dict(s) for s in in_specs]}
    if errors:
        sig["symbolic_batch_errors"] = errors

    def entry(name, t):
        shape = list(t.shape)
        if not errors and shape[:1] == [slots]:
            shape[0] = "b"
        return {"name": name, "dtype": _TAGS[t.dtype], "shape": shape}

    n_state = len(ex.state_names())
    sig["state"] = [entry(n, probe[n]) for n in init.out_names[:n_state]]
    sig["enc"] = [entry(n, probe[n]) for n in init.out_names[n_state:]]
    sig["extra_outputs"] = [entry(n, probe_step[n])
                            for n in ("emitted", "done")]
    sig["init_outputs"] = init.out_names
    sig["step_inputs"] = init.out_names
    sig["step_outputs"] = step.out_names
    return sig


def _probe_step(step, probe):
    """The step's named outputs on init's example outputs."""
    with torch.no_grad():
        return dict(zip(step.out_names,
                        step(*(probe[n] for n in step.in_names))))


def export_decode_step_ex(topology: Topology, parameters: Parameters,
                          slots=None, seq_len=None,
                          device: Union[str, torch.device] = "cuda"):
    """The per-tick decode step of a generation topology, for a scheduler
    that admits requests into free slots mid-decode (the JAX
    ``export_decode_step_stablehlo_ex``'s signature), run in this
    process:

      init  (topology feeds at the slot batch) -> (slot state at tick 0,
            per-slot encoder state): once per admission;
      step  (slot state, encoder state) -> (slot state', emitted, done):
            once per tick over the whole slot array.

    Returns ``(result, None)`` or ``(None, skip_reason)``. ``result``
    holds ``signature`` (:func:`export_decode_step_artifacts_ex`'s, the
    slot batch ``"b"``), ``slots``, ``device`` and the ``init`` and
    ``step`` StepModules, which run the modules that function
    serializes. The parameters go to ``device`` once, their transposed
    tables laid out once; the export runs init and step once to learn the
    state's shapes. The JAX export's 32 MiB limit on parameters embedded
    as module constants does not apply: nothing is embedded."""
    from paddle_tpu_torch.layers.misc import transposed_tables

    seq_len = EXPORT_SEQ_LEN if seq_len is None else seq_len
    slots = DECODE_EXPORT_SLOTS if slots is None else int(slots)
    device = resolve_device(device)
    ex, in_specs, reason = _step_setup(topology, parameters, seq_len, slots)
    if ex is None:
        return None, reason
    params = transposed_tables(
        ex.inner.topology,
        {k: parameters.get(k).to(device) for k in topology.param_specs()})
    try:
        init, step, probe = _step_modules(ex, params, None, in_specs, slots,
                                          device)
    except Exception as e:  # noqa: BLE001 - an encoder that fails: say why
        return None, f"decode init does not run for step export: {e}"
    try:
        probe_step = _probe_step(step, probe)
    except Exception as e:  # noqa: BLE001 - a tick that fails: say why
        return None, f"decode step does not run for step export: {e}"
    sig = _step_signature(ex, in_specs, init, step, probe, probe_step,
                          slots, None, {})
    return {"init": StepModule(init), "step": StepModule(step),
            "signature": sig, "slots": slots, "device": device}, None


def export_decode_step_artifacts_ex(topology: Topology,
                                    parameters: Parameters, seq_len=None,
                                    slots=None,
                                    qmeta: Optional[dict] = None):
    """The per-tick decode step of :func:`export_decode_step_ex` as two
    serialized ``torch.export`` programs, ``init`` and ``step`` (JAX
    ``export_decode_step_stablehlo_ex``), the parameters their constants
    (quantized ones as they are, with their scales: ``qmeta``, widened
    inside every run), the encoder's GRUs the op
    ``paddle_tpu_torch::gru_fwd``. Traced on the CPU; a selective_fc that
    reads its table transposed lays W.T out inside each run, so no second
    copy of the table rides in the artifact.

    The slot batch is symbolic on the leading dimension of every input
    where ``torch.export`` takes it so, else static at ``slots``
    (``signature.symbolic_batch`` False, the error in
    ``symbolic_batch_errors[label]``). Returns ``({"init": {"artifact":
    bytes}, "step": {"artifact": bytes}, "signature": ..., "slots": n},
    None)`` or ``(None, skip_reason)``, JAX's reasons: a decode
    ``beam_step_unsupported`` refuses, missing parameters, past the
    32 MiB cap. The signature has JAX's keys in JAX's order, less its
    per-platform ``module_errors``."""
    seq_len = EXPORT_SEQ_LEN if seq_len is None else seq_len
    slots = DECODE_EXPORT_SLOTS if slots is None else int(slots)
    ex, in_specs, reason = _step_setup(topology, parameters, seq_len, slots)
    if ex is None:
        return None, reason
    pdict, reason = _constants(topology, parameters, qmeta)
    if pdict is None:
        return None, reason
    try:
        init, step, probe = _step_modules(ex, pdict, qmeta, in_specs, slots)
    except Exception as e:  # noqa: BLE001 - recorded as the reason
        return None, f"decode init does not trace for step export: {e}"
    try:
        probe_step = _probe_step(step, probe)
    except Exception as e:  # noqa: BLE001 - recorded as the reason
        return None, f"decode step does not trace for step export: {e}"

    batch = torch.export.Dim("b", min=1)
    errors = {}

    def export(module, args, label):
        # only the leading dimension is the slot batch: a later one equal
        # to ``slots`` (the beam, a length) stays static
        dims = tuple({0: batch} if a.dim() and a.shape[0] == slots else None
                     for a in args)
        try:
            program = torch.export.export(module, args,
                                          dynamic_shapes=(dims,))
        except Exception as e:  # noqa: BLE001 - the batch specialized
            errors[label] = str(e)[:500]
            try:
                program = torch.export.export(module, args)
            except Exception as e2:  # noqa: BLE001 - recorded as the reason
                raise RuntimeError(f"{label} torch.export failed: {e2}") \
                    from e2
        buf = io.BytesIO()
        torch.export.save(program, buf)
        return {"artifact": buf.getvalue()}

    try:
        init_res = export(init, tuple(_example(in_specs, slots)), "init")
        step_res = export(step, tuple(probe[n] for n in step.in_names),
                          "step")
    except RuntimeError as e:
        return None, str(e)
    return {"init": init_res, "step": step_res,
            "signature": _step_signature(ex, in_specs, init, step, probe,
                                         probe_step, slots, qmeta, errors),
            "slots": slots}, None


def step_export_meta(res: dict) -> dict:
    """The JSON-able form of an :func:`export_decode_step_artifacts_ex`
    result, kept under a bundle's ``meta["torch_step"]`` (JAX
    ``stablehlo_step_meta``)."""
    return {"signature": res["signature"], "slots": res["slots"],
            "init_artifact_b64": base64.b64encode(
                res["init"]["artifact"]).decode(),
            "step_artifact_b64": base64.b64encode(
                res["step"]["artifact"]).decode()}


def _step_meta(meta: dict) -> dict:
    """The ``torch_step`` dict of a bundle's meta, or that dict itself;
    raises, with the recorded reason, for a bundle without one."""
    if "init_artifact_b64" in meta:
        return meta
    if "torch_step" in meta:
        return meta["torch_step"]
    raise Error("bundle has no decode step artifacts: " + meta.get(
        "torch_step_skip_reason", "no torch_step in its meta"))


def load_step_export(meta: dict, device: Union[str, torch.device] = "cuda"
                     ) -> dict:
    """The decode step's artifacts of a bundle's meta (its ``torch_step``,
    or that dict itself), their constants moved to ``device``: the dict
    ``StepDecodeDriver`` takes (``init`` and ``step``, each with
    ``call(*flat)``, ``signature``, ``slots`` and ``device``); raises,
    with the recorded reason, for a bundle without them."""
    step_meta = _step_meta(meta)
    device = resolve_device(device)

    def load(key):
        program = torch.export.load(io.BytesIO(
            base64.b64decode(step_meta[key])))
        if device.type != "cpu":
            from torch.export.passes import move_to_device_pass

            program = move_to_device_pass(program, device)
        return StepModule(program.module())

    return {"init": load("init_artifact_b64"),
            "step": load("step_artifact_b64"),
            "signature": step_meta["signature"],
            "slots": int(step_meta["slots"]), "device": device}
