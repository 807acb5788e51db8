"""Protobuf wire-format writer and reader for the ONNX schema subset
(counterpart of ``mxnet_tpu/contrib/_onnx_proto.py``).

ONNX is protobuf, and the wire format is three primitives: varints,
fixed-width scalars and length-delimited blobs. This module writes and
reads the ModelProto/GraphProto/NodeProto/TensorProto/AttributeProto/
ValueInfoProto subset that export and import need, with the public field
numbers of onnx.proto3, so no ``onnx`` package is needed. The reader
accepts packed and unpacked repeated scalars (as proto3 parsers must); the
writer emits unpacked, which every conformant parser accepts.
"""
from __future__ import annotations

import struct
from typing import Dict, List, Tuple

# --- wire primitives -------------------------------------------------------


def _varint(n: int) -> bytes:
    if n < 0:
        n += 1 << 64  # proto negative ints are 10-byte varints
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _tag(field: int, wire: int) -> bytes:
    return _varint((field << 3) | wire)


def field_varint(field: int, value: int) -> bytes:
    return _tag(field, 0) + _varint(int(value))


def field_bytes(field: int, data: bytes) -> bytes:
    return _tag(field, 2) + _varint(len(data)) + data


def field_string(field: int, s: str) -> bytes:
    return field_bytes(field, s.encode("utf-8"))


def field_message(field: int, msg: bytes) -> bytes:
    return field_bytes(field, msg)


def field_float(field: int, value: float) -> bytes:
    return _tag(field, 5) + struct.pack("<f", float(value))


# --- reader ----------------------------------------------------------------


def parse_message(data: bytes) -> Dict[int, List]:
    """Parse one message into {field_number: [raw values]}.

    Varint fields → int; 32/64-bit → raw 4/8 bytes; length-delimited →
    bytes (caller interprets as submessage, string, or packed scalars).
    """
    out: Dict[int, List] = {}
    i = 0
    n = len(data)
    while i < n:
        key, i = _read_varint(data, i)
        field, wire = key >> 3, key & 7
        if wire == 0:
            val, i = _read_varint(data, i)
        elif wire == 1:
            val, i = data[i:i + 8], i + 8
        elif wire == 2:
            ln, i = _read_varint(data, i)
            val, i = data[i:i + ln], i + ln
        elif wire == 5:
            val, i = data[i:i + 4], i + 4
        else:
            raise ValueError(f"unsupported wire type {wire}")
        out.setdefault(field, []).append(val)
    return out


def _read_varint(data: bytes, i: int) -> Tuple[int, int]:
    shift = 0
    val = 0
    while True:
        b = data[i]
        i += 1
        val |= (b & 0x7F) << shift
        if not b & 0x80:
            return val, i
        shift += 7


def ints_of(vals: List) -> List[int]:
    """Repeated int field: list of varints and/or packed blobs."""
    out: List[int] = []
    for v in vals:
        if isinstance(v, int):
            out.append(_signed64(v))
        else:  # packed
            i = 0
            while i < len(v):
                x, i = _read_varint(v, i)
                out.append(_signed64(x))
    return out


def _signed64(v: int) -> int:
    return v - (1 << 64) if v >= 1 << 63 else v


def float_of(raw) -> float:
    return struct.unpack("<f", raw)[0] if isinstance(raw, bytes) else raw


def string_of(raw: bytes) -> str:
    return raw.decode("utf-8")
