"""Minimal tf.train.Example protobuf codec (no TensorFlow dependency).

The reference reads/writes TF Object Detection API tfrecords
(lib_yolo/dataset_utils.py:16-27, create_tf_records_citypersons.py:42-60).
Only three message types are involved, so a tiny hand-rolled wire-format
codec replaces the protobuf runtime::

    Example  { Features features = 1 }
    Features { map<string, Feature> feature = 1 }
    Feature  { oneof { BytesList=1, FloatList=2, Int64List=3 } }
    BytesList { repeated bytes value = 1 }
    FloatList { repeated float value = 1 }   # packed
    Int64List { repeated int64 value = 1 }   # packed

Decode accepts both packed and unpacked repeated scalars; encode writes the
packed form (what TF's writer produces).  Output of ``decode_example`` is
``{name: list[bytes] | np.ndarray(float32) | np.ndarray(int64)}``.
"""

from __future__ import annotations

import struct
from typing import Dict, List, Union

import numpy as np

FeatureValue = Union[List[bytes], np.ndarray]


# --------------------------------------------------------------------------
# wire-format primitives
# --------------------------------------------------------------------------


def _read_varint(buf: bytes, pos: int):
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7
        if shift > 63:
            raise ValueError("varint too long")


def _write_varint(out: bytearray, value: int):
    while True:
        b = value & 0x7F
        value >>= 7
        if value:
            out.append(b | 0x80)
        else:
            out.append(b)
            return


def _iter_fields(buf: bytes):
    pos = 0
    n = len(buf)
    while pos < n:
        tag, pos = _read_varint(buf, pos)
        field, wire = tag >> 3, tag & 7
        if wire == 0:  # varint
            val, pos = _read_varint(buf, pos)
        elif wire == 1:  # 64-bit
            val = buf[pos : pos + 8]
            pos += 8
        elif wire == 2:  # length-delimited
            ln, pos = _read_varint(buf, pos)
            val = buf[pos : pos + ln]
            pos += ln
        elif wire == 5:  # 32-bit
            val = buf[pos : pos + 4]
            pos += 4
        else:
            raise ValueError(f"unsupported wire type {wire}")
        yield field, wire, val


# --------------------------------------------------------------------------
# decode
# --------------------------------------------------------------------------


def _decode_feature(buf: bytes) -> FeatureValue:
    for field, wire, val in _iter_fields(buf):
        if field == 1:  # BytesList
            return [v for f, w, v in _iter_fields(val) if f == 1]
        if field == 2:  # FloatList
            floats: List[float] = []
            for f, w, v in _iter_fields(val):
                if f != 1:
                    continue
                if w == 2:  # packed
                    floats.extend(np.frombuffer(v, dtype="<f4").tolist())
                elif w == 5:
                    floats.append(struct.unpack("<f", v)[0])
            return np.asarray(floats, np.float32)
        if field == 3:  # Int64List
            ints: List[int] = []
            for f, w, v in _iter_fields(val):
                if f != 1:
                    continue
                if w == 2:  # packed varints
                    pos = 0
                    while pos < len(v):
                        x, pos = _read_varint(v, pos)
                        ints.append(x - (1 << 64) if x >= (1 << 63) else x)
                elif w == 0:
                    ints.append(v - (1 << 64) if v >= (1 << 63) else v)
            return np.asarray(ints, np.int64)
    return []


def decode_example(buf: bytes) -> Dict[str, FeatureValue]:
    out: Dict[str, FeatureValue] = {}
    for field, _, features_buf in _iter_fields(buf):
        if field != 1:
            continue
        for f, _, entry in _iter_fields(features_buf):
            if f != 1:
                continue
            key = b""
            feat: FeatureValue = []
            for ef, _, ev in _iter_fields(entry):
                if ef == 1:
                    key = ev
                elif ef == 2:
                    feat = _decode_feature(ev)
            out[key.decode("utf-8")] = feat
    return out


# --------------------------------------------------------------------------
# encode
# --------------------------------------------------------------------------


def _len_delimited(out: bytearray, field: int, payload: bytes):
    _write_varint(out, (field << 3) | 2)
    _write_varint(out, len(payload))
    out.extend(payload)


def _encode_feature(value) -> bytes:
    inner = bytearray()
    if isinstance(value, (list, tuple)) and (not value or isinstance(value[0], (bytes, str))):
        blist = bytearray()
        for v in value:
            _len_delimited(blist, 1, v.encode("utf-8") if isinstance(v, str) else v)
        _len_delimited(inner, 1, bytes(blist))
    elif isinstance(value, bytes):
        blist = bytearray()
        _len_delimited(blist, 1, value)
        _len_delimited(inner, 1, bytes(blist))
    else:
        arr = np.asarray(value)
        if np.issubdtype(arr.dtype, np.floating):
            flist = bytearray()
            _len_delimited(flist, 1, arr.astype("<f4").tobytes())
            _len_delimited(inner, 2, bytes(flist))
        elif np.issubdtype(arr.dtype, np.integer):
            ilist = bytearray()
            packed = bytearray()
            for v in arr.reshape(-1).tolist():
                _write_varint(packed, v & ((1 << 64) - 1) if v < 0 else v)
            _len_delimited(ilist, 1, bytes(packed))
            _len_delimited(inner, 3, bytes(ilist))
        else:
            raise TypeError(f"unsupported feature dtype {arr.dtype}")
    return bytes(inner)


def encode_example(features: Dict[str, FeatureValue]) -> bytes:
    fbuf = bytearray()
    for key, value in features.items():
        entry = bytearray()
        _len_delimited(entry, 1, key.encode("utf-8"))
        _len_delimited(entry, 2, _encode_feature(value))
        _len_delimited(fbuf, 1, bytes(entry))
    out = bytearray()
    _len_delimited(out, 1, bytes(fbuf))
    return bytes(out)
