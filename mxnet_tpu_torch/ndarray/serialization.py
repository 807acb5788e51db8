"""Reference-compatible binary NDArray serialization (counterpart of
``mxnet_tpu/ndarray/serialization.py``; the same bytes in both directions).

The upstream ``MXNDArraySave``/``MXNDArrayLoad`` list container:

    file   := u64 list_magic(0x112) | u64 reserved(0)
              | u64 n_arrays | array*  | u64 n_names | dmlc_str*
              | [u64 crc_magic | u32 crc32]          (optional footer)
    array  := u32 nd_magic | i32 stype | u32 ndim | i64*ndim shape
              | i32 dev_type | i32 dev_id | i32 type_flag | raw data
    dmlc_str := u64 len | bytes

Dense arrays only (stype 0). ndim == 0 encodes a "none" array (no
context, dtype or data follow), so a 0-d array is saved as shape (1,)
with a warning, as the reference does. ``save_nd`` commits through
temp file + fsync + rename (``checkpoint/atomic.py``) and appends a CRC32
footer over the whole container; ``load_nd`` verifies the footer when
present and rejects any other trailing bytes, so truncation and bit
flips raise ``ValueError``. Files written by upstream MXNet (no footer)
load.

numpy has no bfloat16: a bf16 array (type flag 12, the reference's
``ml_dtypes.bfloat16`` slot) is handled as a CPU ``torch.bfloat16``
tensor here, and every other dtype as a numpy array.
"""
from __future__ import annotations

import struct
import warnings
from typing import Dict, List, Union

import numpy as np
import torch

from ..checkpoint.atomic import atomic_write_bytes, crc32_bytes

__all__ = ["save_nd", "load_nd", "is_binary_nd", "host_array", "raw_bytes"]

_LIST_MAGIC = 0x112
_CRC_MAGIC = 0x314352435F544B43  # "CKT_CRC1" little-endian
_CRC_FOOTER_LEN = 12  # u64 magic + u32 crc32
# reference ndarray.cc: V1 = int64 TShape, V2 = +storage type, V3 = np-shape
_ND_V1 = 0xF993FAC8
_ND_V2 = 0xF993FAC9
_ND_V3 = 0xF993FACA

# reference mshadow type flags (mshadow/base.h); 12 is bfloat16
_TYPE_FLAG_TO_DTYPE = {
    0: np.dtype(np.float32),
    1: np.dtype(np.float64),
    2: np.dtype(np.float16),
    3: np.dtype(np.uint8),
    4: np.dtype(np.int32),
    5: np.dtype(np.int8),
    6: np.dtype(np.int64),
    7: np.dtype(np.bool_),
    8: np.dtype(np.int16),
    9: np.dtype(np.uint16),
    10: np.dtype(np.uint32),
    11: np.dtype(np.uint64),
}
_DTYPE_TO_TYPE_FLAG = {v: k for k, v in _TYPE_FLAG_TO_DTYPE.items()}
_BF16_FLAG = 12

_CPU_DEV_TYPE = 1  # Context::kCPU: loads are device-agnostic anyway

HostArray = Union[np.ndarray, torch.Tensor]


def host_array(v) -> HostArray:
    """An NDArray, tensor or array-like as a host array: numpy, or a CPU
    ``torch.bfloat16`` tensor for bf16 (whose bits numpy cannot hold)."""
    t = getattr(v, "_data", v)
    if isinstance(t, torch.Tensor):
        t = t.detach()
        if t.dtype == torch.bfloat16:
            return t.cpu().contiguous()
        return t.cpu().numpy()
    return np.asarray(t)


def raw_bytes(a: HostArray) -> bytes:
    """The array's elements in C order, as the file stores them."""
    if isinstance(a, torch.Tensor):
        return a.contiguous().view(torch.int16).numpy().tobytes()
    return np.ascontiguousarray(a).tobytes()


def _write_array(out: List[bytes], arr: HostArray) -> None:
    if isinstance(arr, torch.Tensor) and arr.dtype != torch.bfloat16:
        arr = arr.detach().cpu().numpy()
    if arr.ndim == 0:
        # ndim 0 means "none" and carries no ctx/dtype/data (1.x NDArrays
        # are never 0-d; legacy scalars are shape (1,))
        warnings.warn("0-d NDArray saved as shape (1,) for reference "
                      "format compatibility")
        arr = arr.reshape(1)
    out.append(struct.pack("<Ii", _ND_V2, 0))  # magic, stype=default(dense)
    out.append(struct.pack("<I", arr.ndim))
    out.append(struct.pack(f"<{arr.ndim}q", *arr.shape))
    out.append(struct.pack("<ii", _CPU_DEV_TYPE, 0))
    if isinstance(arr, torch.Tensor):
        flag = _BF16_FLAG
    else:
        flag = _DTYPE_TO_TYPE_FLAG.get(arr.dtype)
        if flag is None:
            raise TypeError(f"dtype {arr.dtype} has no reference type flag")
    out.append(struct.pack("<i", flag))
    out.append(raw_bytes(arr))


class _Reader:
    def __init__(self, buf: bytes):
        self.buf = buf
        self.pos = 0

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.buf):
            raise ValueError("truncated NDArray file")
        b = self.buf[self.pos:self.pos + n]
        self.pos += n
        return b

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))


def _read_array(r: _Reader) -> HostArray:
    (magic,) = r.unpack("<I")
    if magic not in (_ND_V1, _ND_V2, _ND_V3):
        raise ValueError(f"bad NDArray record magic {magic:#x}")
    if magic in (_ND_V2, _ND_V3):
        (stype,) = r.unpack("<i")
        if stype != 0:
            raise ValueError(f"sparse storage type {stype} not supported "
                             "on load")
    (ndim,) = r.unpack("<I")
    if ndim == 0:
        return np.zeros((), np.float32)  # reference "none" placeholder
    if ndim > 32:
        raise ValueError(f"implausible ndim {ndim}")
    shape = r.unpack(f"<{ndim}q")
    r.unpack("<ii")  # dev_type, dev_id: ignored, the caller places arrays
    (flag,) = r.unpack("<i")
    count = int(np.prod(shape))
    if flag == _BF16_FLAG:
        bits = np.frombuffer(r.take(count * 2), np.int16).reshape(shape)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16)
    dtype = _TYPE_FLAG_TO_DTYPE.get(flag)
    if dtype is None:
        raise ValueError(f"unknown type flag {flag}")
    data = r.take(count * dtype.itemsize)
    return np.frombuffer(data, dtype=dtype).reshape(shape).copy()


def save_nd(fname: str, arrays: List[HostArray], names: List[str],
            crc: bool = True, durable: bool = True) -> None:
    """Write the list container; ``names`` may be empty (a list save).
    Committed through temp file + fsync + rename, with a CRC32 footer over
    the whole container (``crc=False`` gives the plain upstream layout)."""
    out: List[bytes] = [struct.pack("<QQ", _LIST_MAGIC, 0),
                        struct.pack("<Q", len(arrays))]
    for a in arrays:
        _write_array(out, a)
    out.append(struct.pack("<Q", len(names)))
    for n in names:
        b = n.encode("utf-8")
        out.append(struct.pack("<Q", len(b)))
        out.append(b)
    body = b"".join(out)
    if crc:
        body += struct.pack("<QI", _CRC_MAGIC, crc32_bytes(body))
    atomic_write_bytes(fname, body, durable=durable)


def is_binary_nd(head: bytes) -> bool:
    return len(head) >= 8 and struct.unpack("<Q", head[:8])[0] == _LIST_MAGIC


def load_nd(fname: str) -> Union[List[HostArray], Dict[str, HostArray]]:
    with open(fname, "rb") as f:
        buf = f.read()
    r = _Reader(buf)
    magic, _reserved = r.unpack("<QQ")
    if magic != _LIST_MAGIC:
        raise ValueError(f"not an NDArray file (magic {magic:#x})")
    (n,) = r.unpack("<Q")
    if n > 1_000_000:
        raise ValueError(f"implausible array count {n}")
    arrays = [_read_array(r) for _ in range(n)]
    (n_names,) = r.unpack("<Q")
    if n_names not in (0, n):
        raise ValueError(f"{n} arrays but {n_names} names")
    names = [r.take(r.unpack("<Q")[0]).decode("utf-8")
             for _ in range(n_names)]
    _verify_footer(buf, r.pos)
    if n_names == 0:
        return arrays
    return dict(zip(names, arrays))


def _verify_footer(buf: bytes, end: int) -> None:
    """No trailing bytes: an upstream file, accepted. A footer must
    match; anything else is truncation or corruption."""
    remaining = len(buf) - end
    if remaining == 0:
        return
    if remaining != _CRC_FOOTER_LEN:
        raise ValueError(
            f"{remaining} unexpected trailing bytes (truncated file or "
            "damaged CRC footer)")
    magic, crc = struct.unpack_from("<QI", buf, end)
    if magic != _CRC_MAGIC:
        raise ValueError(f"bad CRC footer magic {magic:#x}")
    actual = crc32_bytes(buf[:end])
    if actual != crc:
        raise ValueError(
            f"CRC mismatch: footer {crc:#010x} != computed {actual:#010x} "
            "(file is corrupt)")
