"""RecordIO, the reference's packed binary record format (counterpart of
``mxnet_tpu/io/recordio.py``). Format kept bit-compatible so .rec files
interchange:

  [kMagic:u32][lrec:u32][data (padded to 4 bytes)] per record, where
  lrec's upper 3 bits encode continuation (unused here: cflag=0) and the
  lower 29 bits the payload length.

``IRHeader``/pack/unpack (flag, label, id, id2) match the reference's
image-record header. JPEG encode/decode goes through PIL, imported where
it is used, as the reference does; files written by either package are
byte-identical and read by the other.
"""
from __future__ import annotations

import io as _io
import os
import struct
from collections import namedtuple

import numpy as np

__all__ = ["MXRecordIO", "MXIndexedRecordIO", "IRHeader", "pack", "unpack",
           "pack_img", "unpack_img"]

_KMAGIC = 0xCED7230A

IRHeader = namedtuple("HEADER", ["flag", "label", "id", "id2"])
_IR_FORMAT = "IfQQ"
_IR_SIZE = struct.calcsize(_IR_FORMAT)


class MXRecordIO:
    """Sequential record file reader/writer (reference MXRecordIO)."""

    def __init__(self, uri, flag):
        self.uri = uri
        self.flag = flag
        self.record = None
        self.open()

    def open(self):
        if self.flag == "w":
            self.record = open(self.uri, "wb")
            self.writable = True
        elif self.flag == "r":
            self.record = open(self.uri, "rb")
            self.writable = False
        else:
            raise ValueError(f"invalid flag {self.flag!r}")

    def close(self):
        if self.record:
            self.record.close()
            self.record = None

    def __del__(self):
        self.close()

    def __getstate__(self):
        d = dict(self.__dict__)
        d["record"] = None
        return d

    def __setstate__(self, d):
        self.__dict__.update(d)
        self.open()

    def reset(self):
        self.close()
        self.open()

    def write(self, buf: bytes):
        assert self.writable
        self.record.write(struct.pack("<II", _KMAGIC, len(buf)))
        self.record.write(buf)
        pad = (4 - len(buf) % 4) % 4
        if pad:
            self.record.write(b"\x00" * pad)

    def read(self):
        assert not self.writable
        hdr = self.record.read(8)
        if len(hdr) < 8:
            return None
        magic, lrec = struct.unpack("<II", hdr)
        if magic != _KMAGIC:
            raise IOError(f"invalid RecordIO magic {magic:#x} in {self.uri}")
        length = lrec & ((1 << 29) - 1)
        buf = self.record.read(length)
        pad = (4 - length % 4) % 4
        if pad:
            self.record.read(pad)
        return buf

    def tell(self):
        return self.record.tell()


class MXIndexedRecordIO(MXRecordIO):
    """Random-access record file via a .idx sidecar (reference analog)."""

    def __init__(self, idx_path, uri, flag, key_type=int):
        self.idx_path = idx_path
        self.idx = {}
        self.keys = []
        self.key_type = key_type
        self.fidx = None
        super().__init__(uri, flag)

    def open(self):
        super().open()
        self.idx = {}
        self.keys = []
        if self.flag == "r" and os.path.exists(self.idx_path):
            with open(self.idx_path) as f:
                for line in f:
                    parts = line.strip().split("\t")
                    if len(parts) >= 2:
                        k = self.key_type(parts[0])
                        self.idx[k] = int(parts[1])
                        self.keys.append(k)
        elif self.flag == "w":
            self.fidx = open(self.idx_path, "w")

    def close(self):
        if self.fidx:
            self.fidx.close()
            self.fidx = None
        super().close()

    def seek(self, idx):
        assert not self.writable
        self.record.seek(self.idx[idx])

    def read_idx(self, idx):
        self.seek(idx)
        return self.read()

    def write_idx(self, idx, buf):
        key = self.key_type(idx)
        pos = self.tell()
        self.write(buf)
        self.fidx.write(f"{key}\t{pos}\n")
        self.idx[key] = pos
        self.keys.append(key)


def pack(header: IRHeader, s: bytes) -> bytes:
    """Pack a header + payload into one record blob (reference mx.recordio.pack)."""
    flag = header.flag
    label = header.label
    if isinstance(label, (list, tuple, np.ndarray)) and np.ndim(label) > 0:
        arr = np.asarray(label, np.float32)
        flag = arr.size
        hdr = struct.pack(_IR_FORMAT, flag, 0.0, header.id, header.id2)
        return hdr + arr.tobytes() + s
    hdr = struct.pack(_IR_FORMAT, 0, float(label), header.id, header.id2)
    return hdr + s


def unpack(s: bytes):
    """Unpack a record blob into (IRHeader, payload)."""
    flag, label, id_, id2 = struct.unpack(_IR_FORMAT, s[:_IR_SIZE])
    payload = s[_IR_SIZE:]
    if flag > 0:
        arr = np.frombuffer(payload[:flag * 4], np.float32)
        return IRHeader(flag, arr, id_, id2), payload[flag * 4:]
    return IRHeader(flag, label, id_, id2), payload


def pack_img(header: IRHeader, img: np.ndarray, quality=95, img_fmt=".jpg") -> bytes:
    from PIL import Image

    buf = _io.BytesIO()
    arr = np.asarray(img, np.uint8)
    pil = Image.fromarray(arr.squeeze(-1) if arr.ndim == 3 and arr.shape[-1] == 1
                          else arr)
    fmt = "JPEG" if img_fmt.lower() in (".jpg", ".jpeg") else "PNG"
    pil.save(buf, format=fmt, quality=quality)
    return pack(header, buf.getvalue())


def unpack_img(s: bytes, iscolor=1):
    from PIL import Image

    header, payload = unpack(s)
    img = Image.open(_io.BytesIO(payload))
    img = img.convert("RGB" if iscolor else "L")
    arr = np.asarray(img, np.uint8)
    if arr.ndim == 2:
        arr = arr[:, :, None]
    return header, arr
