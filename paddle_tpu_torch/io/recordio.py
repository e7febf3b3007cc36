"""RecordIO-style chunked record files (counterpart of
``paddle_tpu/io/recordio.py``: the same bytes, so a file written by
either package reads in the other).

Analog of the RecordIO format the Go master shards datasets into
(go/master/service.go task chunks; recordio vendored lib). Format here:
magic u32 | per record: u32 length + crc32 u32 + payload. Chunk-level
indexing enables the master service to hand out (path, offset, count)
tasks for fault-tolerant data dispatch.
"""

from __future__ import annotations

import struct
import zlib
from typing import Iterator, List, Tuple

MAGIC = 0x7061646C  # 'padl'


class RecordIOWriter:
    def __init__(self, path: str):
        self.f = open(path, "wb")
        self.f.write(struct.pack("<I", MAGIC))
        self.offsets: List[int] = []

    def write(self, payload: bytes):
        if isinstance(payload, str):
            payload = payload.encode()
        self.offsets.append(self.f.tell())
        self.f.write(struct.pack("<II", len(payload), zlib.crc32(payload)))
        self.f.write(payload)

    def close(self):
        self.f.close()

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()


class RecordIOReader:
    def __init__(self, path: str):
        self.path = path
        self.f = open(path, "rb")
        magic, = struct.unpack("<I", self.f.read(4))
        if magic != MAGIC:
            raise IOError(f"{path}: bad recordio magic {magic:#x}")

    def __iter__(self) -> Iterator[bytes]:
        while True:
            hdr = self.f.read(8)
            if len(hdr) < 8:
                return
            length, crc = struct.unpack("<II", hdr)
            payload = self.f.read(length)
            if zlib.crc32(payload) != crc:
                raise IOError(f"{self.path}: crc mismatch")
            yield payload

    def read_range(self, offset: int, count: int) -> List[bytes]:
        """Read `count` records starting at byte `offset` — the master's
        task unit (go/master/service.go Chunk)."""
        self.f.seek(offset)
        out = []
        for _ in range(count):
            hdr = self.f.read(8)
            if len(hdr) < 8:
                break
            length, crc = struct.unpack("<II", hdr)
            payload = self.f.read(length)
            if zlib.crc32(payload) != crc:
                raise IOError(f"{self.path}: crc mismatch")
            out.append(payload)
        return out

    def index(self) -> List[Tuple[int, int]]:
        """[(offset, 1)] per record, for task sharding."""
        self.f.seek(4)
        idx = []
        while True:
            pos = self.f.tell()
            hdr = self.f.read(8)
            if len(hdr) < 8:
                return idx
            length, _ = struct.unpack("<II", hdr)
            self.f.seek(length, 1)
            idx.append((pos, 1))

    def close(self):
        self.f.close()

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()
