"""The length-prefixed binary framing of the parameter-server wire
(counterpart of the framing half of ``mxnet_tpu/kvstore/ps_server.py``).

The serve plane (``serve/server.py``, ``serve/client.py``) rides the same
frames as the parameter server, on its own opcode range (``wire.py``).
Frames are byte-identical with the reference's (little-endian)::

    frame  := u32 len | u8 opcode | u16 key_len | key bytes | payload
    array  := u8 ndim | u32 * ndim shape | u8 dtype_code | raw bytes
    arrays := u8 count | array * count

``dtype_code`` is the mshadow type flag (``base.DTYPE_TO_CODE``). numpy
has no bfloat16, so a bf16 array is a CPU ``torch.bfloat16`` tensor on
both sides: it packs as its raw bits under code 12 and unpacks to one,
never through float32. The parameter server itself (``PSServer``) and the
2-bit compressed arrays (code 16) belong to the distributed slice of the
port (queue item A14).
"""
from __future__ import annotations

import socket
import struct

import numpy as np
import torch

from ..base import CODE_TO_DTYPE, DTYPE_TO_CODE, MXNetError
from ..ndarray.serialization import host_array, raw_bytes

__all__ = ["_pack_array", "_unpack_array", "_pack_arrays", "_unpack_arrays",
           "_send_msg", "_recv_exact", "_recv_msg"]

_BF16 = DTYPE_TO_CODE["bfloat16"]


def _pack_array(arr) -> bytes:
    arr = host_array(arr)  # numpy, or a CPU bfloat16 tensor
    code = _BF16 if isinstance(arr, torch.Tensor) \
        else DTYPE_TO_CODE[arr.dtype.name]
    shape = tuple(arr.shape)
    return (struct.pack("<B", len(shape)) + struct.pack(f"<{len(shape)}I",
                                                        *shape)
            + struct.pack("<B", code) + raw_bytes(arr))


def _array_nbytes(buf: memoryview) -> int:
    """Byte length of one packed array at the head of ``buf``."""
    ndim = struct.unpack_from("<B", buf, 0)[0]
    shape = struct.unpack_from(f"<{ndim}I", buf, 1)
    code = struct.unpack_from("<B", buf, 1 + 4 * ndim)[0]
    size = 1
    for s in shape:
        size *= s
    return 2 + 4 * ndim + size * _itemsize(code)


def _itemsize(code: int) -> int:
    if code == _BF16:
        return 2
    if code not in CODE_TO_DTYPE:
        raise MXNetError(f"wire dtype code {code} is not supported here "
                         "(2-bit compressed arrays, code 16, come with the "
                         "parameter server of queue item A14)")
    return np.dtype(CODE_TO_DTYPE[code]).itemsize


def _unpack_array(buf: memoryview):
    ndim = struct.unpack_from("<B", buf, 0)[0]
    shape = struct.unpack_from(f"<{ndim}I", buf, 1)
    code = struct.unpack_from("<B", buf, 1 + 4 * ndim)[0]
    _itemsize(code)
    off = 2 + 4 * ndim
    if code == _BF16:
        bits = np.frombuffer(buf, dtype=np.int16, offset=off)
        return torch.from_numpy(bits.reshape(shape).copy()).view(
            torch.bfloat16)
    data = np.frombuffer(buf, dtype=np.dtype(CODE_TO_DTYPE[code]),
                         offset=off)
    return data.reshape(shape).copy()


def _pack_arrays(arrays) -> bytes:
    """N arrays on one payload: u8 count, then each array."""
    if len(arrays) > 255:
        raise ValueError(f"too many arrays for one frame ({len(arrays)})")
    # as the reference: numpy inputs made contiguous, so 0-d packs as (1,)
    return struct.pack("<B", len(arrays)) + b"".join(
        _pack_array(a if isinstance(a, torch.Tensor)
                    else np.ascontiguousarray(a)) for a in arrays)


def _unpack_arrays(buf: memoryview):
    """The arrays of a :func:`_pack_arrays` payload, and the bytes read."""
    (count,) = struct.unpack_from("<B", buf, 0)
    out, off = [], 1
    for _ in range(count):
        n = _array_nbytes(buf[off:])
        out.append(_unpack_array(buf[off:off + n]))
        off += n
    return out, off


def _send_msg(sock: socket.socket, opcode: int, key: str = "", payload=b""):
    """Frame and send one message. ``payload`` is ``bytes``/``memoryview``
    or a list of buffer parts, sent scatter-gather without being joined."""
    kb = key.encode()
    parts = list(payload) if isinstance(payload, (list, tuple)) \
        else [payload]
    plen = sum(len(p) for p in parts)
    head = struct.pack("<IBH", 3 + len(kb) + plen, opcode, len(kb)) + kb
    _send_parts(sock, [head] + parts)


def _send_parts(sock, parts) -> None:
    """``sendall`` of a list of buffers through ``sendmsg``, resuming after
    a partial send."""
    views = [memoryview(p) for p in parts if len(p)]
    if not hasattr(sock, "sendmsg"):
        sock.sendall(b"".join(views))
        return
    while views:
        sent = sock.sendmsg(views)
        while sent:
            if sent >= len(views[0]):
                sent -= len(views[0])
                views.pop(0)
            else:
                views[0] = views[0][sent:]
                sent = 0


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    chunks = []
    while n:
        c = sock.recv(min(n, 1 << 20))
        if not c:
            raise ConnectionError("peer closed")
        chunks.append(c)
        n -= len(c)
    return chunks[0] if len(chunks) == 1 else b"".join(chunks)


def _recv_msg(sock: socket.socket):
    """One frame: ``(opcode, key, payload memoryview)``."""
    (ln,) = struct.unpack("<I", _recv_exact(sock, 4))
    body = memoryview(_recv_exact(sock, ln))
    opcode, klen = struct.unpack_from("<BH", body, 0)
    key = bytes(body[3:3 + klen]).decode()
    payload = body[3 + klen:]
    return opcode, key, payload
