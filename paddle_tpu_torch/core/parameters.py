"""Parameter store with the tar checkpoint format (counterpart of
``paddle_tpu/core/parameters.py``; analog of
python/paddle/v2/parameters.py to_tar/from_tar and
paddle/parameter/Parameter.cpp save/load).

Parameters are a flat dict name -> CPU tensor; an ``Inference`` or a
trainer copies them to its device (the trainer writes them back at each
pass end). A tar written by either package loads in the other:
one ``<name>`` binary per parameter (int32 version, uint32 value size,
uint64 count, raw little-endian values), a ``<name>.json`` shape entry,
and ``model.json`` when the parameters carry a topology.
"""

from __future__ import annotations

import io
import json
import struct
import tarfile
from typing import Dict, Iterator, Mapping, Optional

import numpy as np
import torch

from paddle_tpu_torch.utils.error import enforce

PARAM_HEADER_VERSION = 0

# the value-size header field doubles as the dtype tag: 4 = f32,
# 2 = bf16 raw bits, 1 = int8; anything else is refused on read
_DTYPE_BY_VSIZE = {4: torch.float32, 2: torch.bfloat16, 1: torch.int8}


class Parameters:
    def __init__(self, topology=None):
        self._params: Dict[str, torch.Tensor] = {}
        self._topology = topology
        # bumped by every replacement of a value (set, update_from), so an
        # Inference knows when its device copy is stale
        self.version = 0

    @classmethod
    def from_topology(cls, topology,
                      generator: Optional[torch.Generator] = None
                      ) -> "Parameters":
        """Fresh parameters of ``topology`` (``Topology.init_params``)."""
        p = cls(topology)
        p._params = topology.init_params(generator)
        return p

    @classmethod
    def from_numpy(cls, d: Mapping[str, np.ndarray],
                   topology=None) -> "Parameters":
        """Parameters from name -> array, e.g. a ``paddle_tpu``
        ``Parameters.as_dict()`` converted with ``np.asarray``."""
        p = cls(topology)
        for k, v in d.items():
            p._params[k] = torch.from_numpy(np.array(v, copy=True))
        return p

    @classmethod
    def from_dict(cls, d: Mapping[str, object]) -> "Parameters":
        """Parameters from name -> tensor (or array): tensors kept as they
        are, arrays copied (as JAX's ``jnp.asarray`` makes a buffer of its
        own), so a later write into the caller's array leaves them be."""
        p = cls()
        p._params = {k: v if isinstance(v, torch.Tensor)
                     else torch.from_numpy(np.array(v, copy=True))
                     for k, v in d.items()}
        return p

    # --- dict-ish access (v2 Parameters API) ------------------------------
    def names(self):
        return sorted(self._params)

    def keys(self):
        return self.names()

    def __contains__(self, name: str) -> bool:
        return name in self._params

    def __iter__(self) -> Iterator[str]:
        return iter(self.names())

    def __len__(self):
        return len(self._params)

    def get(self, name: str) -> torch.Tensor:
        return self._params[name]

    def __getitem__(self, name: str) -> torch.Tensor:
        return self.get(name)

    def set(self, name: str, value):
        # a buffer of its own, as jnp.asarray gives the JAX package: later
        # writes into the caller's array do not reach the parameter
        value = torch.as_tensor(value).clone()
        if name in self._params:
            enforce(value.shape == self._params[name].shape,
                    f"shape mismatch for {name}: {tuple(value.shape)} vs "
                    f"{tuple(self._params[name].shape)}")
        self._params[name] = value
        self.version += 1

    def __setitem__(self, name: str, value):
        self.set(name, value)

    def get_shape(self, name: str):
        return tuple(self._params[name].shape)

    def as_dict(self) -> Dict[str, torch.Tensor]:
        return dict(self._params)

    def update_from(self, tree: Mapping[str, torch.Tensor]):
        """Replace the whole store by ``tree`` (name -> tensor), as the
        trainer does after training; tensors are kept on the CPU."""
        self._params = {k: v.detach().cpu() for k, v in tree.items()}
        self.version += 1

    # --- tar checkpoint format --------------------------------------------
    @staticmethod
    def _encode_param(t: torch.Tensor) -> bytes:
        """f32 unless the tensor is already bf16 or int8, which round-trip
        as they are."""
        t = t.detach().cpu()
        if t.dtype not in (torch.bfloat16, torch.int8):
            t = t.to(torch.float32)
        t = t.contiguous()
        header = struct.pack("<iIQ", PARAM_HEADER_VERSION, t.element_size(),
                             t.numel())
        raw = t.reshape(-1).view(torch.uint8) if t.numel() else \
            torch.empty(0, dtype=torch.uint8)
        return header + raw.numpy().tobytes()

    @staticmethod
    def _decode_param(buf: bytes) -> torch.Tensor:
        version, vsize, count = struct.unpack("<iIQ", buf[:16])
        dt = _DTYPE_BY_VSIZE.get(vsize)
        if dt is None:
            raise ValueError(
                f"unsupported value size {vsize} "
                "(4=f32, 2=bf16, 1=int8 are the known encodings)")
        payload = bytearray(buf[16:16 + vsize * count])
        if not payload:
            return torch.empty(0, dtype=dt)
        return torch.frombuffer(payload, dtype=dt)

    def to_tar(self, f):
        """Write tar: one '<name>' binary per param + '<name>.json' shape
        metadata + 'model.json' topology config when available."""
        with tarfile.open(fileobj=f, mode="w") as tar:
            for name in self.names():
                t = self._params[name]
                payload = self._encode_param(t)
                info = tarfile.TarInfo(name=name)
                info.size = len(payload)
                tar.addfile(info, io.BytesIO(payload))
                side = {"shape": list(t.shape)}
                if t.dtype == torch.int8:
                    side["dtype"] = "int8"
                elif t.dtype == torch.bfloat16:
                    side["dtype"] = "bf16"
                meta = json.dumps(side).encode()
                minfo = tarfile.TarInfo(name=name + ".json")
                minfo.size = len(meta)
                tar.addfile(minfo, io.BytesIO(meta))
            if self._topology is not None:
                cfg = json.dumps(self._topology.serialize()).encode()
                cinfo = tarfile.TarInfo(name="model.json")
                cinfo.size = len(cfg)
                tar.addfile(cinfo, io.BytesIO(cfg))

    @classmethod
    def from_tar(cls, f) -> "Parameters":
        p = cls()
        shapes = {}
        raw = {}
        with tarfile.open(fileobj=f, mode="r") as tar:
            for member in tar.getmembers():
                if member.name.startswith("__hostrows__/"):
                    # serving row sidecars ride in the same tar but are
                    # not parameters
                    continue
                if member.name == "model.json":
                    continue
                data = tar.extractfile(member).read()
                if member.name.endswith(".json"):
                    shapes[member.name[:-5]] = json.loads(data)["shape"]
                else:
                    raw[member.name] = cls._decode_param(data)
        for name, flat in raw.items():
            p._params[name] = flat.reshape(shapes.get(name, [flat.numel()]))
        return p

    def to_file(self, path: str):
        with open(path, "wb") as f:
            self.to_tar(f)

    @classmethod
    def from_file(cls, path: str) -> "Parameters":
        with open(path, "rb") as f:
            return cls.from_tar(f)


def create(*layers, generator: Optional[torch.Generator] = None
           ) -> Parameters:
    """paddle.parameters.create(cost) analog: fresh parameters for the
    topology of the output layer(s), or of a prebuilt Topology."""
    from paddle_tpu_torch.core.topology import Topology

    if len(layers) == 1 and isinstance(layers[0], Topology):
        topology = layers[0]
    else:
        topology = Topology(list(layers))
    return Parameters.from_topology(topology, generator)
