"""TFRecord file reader/writer (framework-independent).

A pure-Python record framer.  The checksum runs through the C helper of
the repository's ``native/`` directory when that library has been built
(``native/build.sh``) and loads; otherwise through a table-driven Python
loop, which is slow but needs nothing.  This module never builds the
helper itself.

Record framing::

    uint64 length | uint32 masked_crc32c(length) | data | uint32 masked_crc32c(data)
"""

from __future__ import annotations

import ctypes
import glob as globlib
import os
import struct
from typing import Iterator, List, Optional

import numpy as np

_NATIVE_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "native")
_NATIVE = None


def _load_native():
    global _NATIVE
    if _NATIVE is not None:
        return _NATIVE
    so = os.path.abspath(os.path.join(_NATIVE_DIR, "libbyolo_native.so"))
    if not os.path.exists(so):
        _NATIVE = False
        return False
    try:
        lib = ctypes.CDLL(so)
        lib.byolo_masked_crc32c.restype = ctypes.c_uint32
        lib.byolo_masked_crc32c.argtypes = [ctypes.c_char_p, ctypes.c_size_t]
        lib.byolo_crc32c.restype = ctypes.c_uint32
        lib.byolo_crc32c.argtypes = [ctypes.c_char_p, ctypes.c_size_t]
        _NATIVE = lib
    except OSError:
        _NATIVE = False
    return _NATIVE


# ---- pure-python fallback -------------------------------------------------

_CRC_TABLE: Optional[np.ndarray] = None


def _crc_table() -> np.ndarray:
    global _CRC_TABLE
    if _CRC_TABLE is None:
        poly = np.uint32(0x82F63B78)
        table = np.arange(256, dtype=np.uint32)
        for _ in range(8):
            table = np.where(table & 1, (table >> 1) ^ poly, table >> 1)
        _CRC_TABLE = table
    return _CRC_TABLE


def _crc32c_py(data: bytes) -> int:
    table = _crc_table()
    crc = 0xFFFFFFFF
    # chunked python loop over a numpy view; slow but dependency-free
    for b in np.frombuffer(data, dtype=np.uint8).tolist():
        crc = int(table[(crc ^ b) & 0xFF]) ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def crc32c(data: bytes) -> int:
    lib = _load_native()
    if lib:
        return lib.byolo_crc32c(data, len(data))
    return _crc32c_py(data)


def masked_crc32c(data: bytes) -> int:
    lib = _load_native()
    if lib:
        return lib.byolo_masked_crc32c(data, len(data))
    crc = _crc32c_py(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


# ---- record framing --------------------------------------------------------


class TFRecordWriter:
    def __init__(self, path: str):
        self._f = open(path, "wb")

    def write(self, record: bytes):
        header = struct.pack("<Q", len(record))
        self._f.write(header)
        self._f.write(struct.pack("<I", masked_crc32c(header)))
        self._f.write(record)
        self._f.write(struct.pack("<I", masked_crc32c(record)))

    def close(self):
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def read_records(path: str, verify: bool = False) -> Iterator[bytes]:
    """Yield raw record payloads from one tfrecord file."""
    with open(path, "rb") as f:
        while True:
            header = f.read(8)
            if len(header) < 8:
                return
            (length,) = struct.unpack("<Q", header)
            hcrc = f.read(4)
            data = f.read(length)
            dcrc = f.read(4)
            if len(data) < length or len(dcrc) < 4:
                raise IOError(f"truncated tfrecord: {path}")
            if verify:
                if struct.unpack("<I", hcrc)[0] != masked_crc32c(header):
                    raise IOError(f"bad header crc in {path}")
                if struct.unpack("<I", dcrc)[0] != masked_crc32c(data):
                    raise IOError(f"bad data crc in {path}")
            yield data


def list_shards(file_pattern: str) -> List[str]:
    files = sorted(globlib.glob(file_pattern))
    if not files:
        raise FileNotFoundError(f"no tfrecord shards match {file_pattern!r}")
    return files


def read_shards(
    file_pattern: str,
    shuffle_rng: Optional[np.random.Generator] = None,
    cycle_length: int = 2,
    shard_index: int = 0,
    shard_count: int = 1,
) -> Iterator[bytes]:
    """Interleaved shard reader.

    Parity with the reference input graph: shards listed by pattern,
    optionally shuffled, then round-robin
    interleaved ``cycle_length`` files at a time with block length 1.

    ``shard_count > 1`` stripes the (sorted) file list across hosts BEFORE
    shuffling, so multi-host training reads disjoint per-host subsets
    deterministically.
    """
    files = list_shards(file_pattern)
    if shard_count > 1:
        files = files[shard_index::shard_count]
        assert files, (
            f"host {shard_index}/{shard_count}: no shard files in "
            f"{file_pattern} — need >= {shard_count} shards"
        )
    if shuffle_rng is not None:
        shuffle_rng.shuffle(files)
    pending = list(files)
    active: List[Iterator[bytes]] = []
    while pending or active:
        while len(active) < cycle_length and pending:
            active.append(read_records(pending.pop(0)))
        i = 0
        while i < len(active):
            try:
                yield next(active[i])
                i += 1
            except StopIteration:
                del active[i]
