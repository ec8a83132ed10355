"""MessagePack, the subset that flax's checkpoints use, with flax's arrays.

The JAX package writes checkpoints with ``flax.serialization.to_bytes``:
a state dict (nested maps with string keys) packed as MessagePack, each
array leaf an extension value.  This module reads and writes that format
with the standard library, numpy and torch alone (no ``msgpack``, no flax):

  * nil, bool, int, float, str, bin, array (list / tuple) and map;
  * ext 1, an ndarray: the MessagePack encoding of (shape, dtype name, raw
    C-order bytes); ext 3, a numpy scalar in the same form; ext 2, a
    complex number as (real, imag).

``bfloat16`` leaves, which numpy cannot hold, decode to bf16 torch tensors
(through an int16 view of their bytes) and encode from them; every other
array decodes to a read-only numpy array over the input bytes, and torch
tensors encode by their numpy view.  Encoding picks the smallest form of
each value, as ``msgpack.packb(use_bin_type=True)`` does, so flax's own
bytes re-encode identically.  flax splits arrays above 2**30 bytes into
chunks; that form is refused with an error both ways (bert-large's largest
leaf is 125 MB).
"""

from __future__ import annotations

import struct
from typing import Any, BinaryIO, Callable

import numpy as np
import torch

EXT_NDARRAY = 1
EXT_COMPLEX = 2
EXT_NPSCALAR = 3
MAX_CHUNK_SIZE = 2**30  # flax chunks array leaves above this many bytes
_CHUNKED = "__msgpack_chunked_array__"


def _header(small_tag: int, small_max: int, n: int, tags) -> bytes:
    """The head of a str / bin / array / map of ``n`` items: the fix form
    when ``small_tag`` is given and ``n < small_max``, else the first of
    the 8/16/32-bit forms in ``tags`` (None where a form does not exist)
    that holds ``n``."""
    if small_tag is not None and n < small_max:
        return bytes([small_tag | n])
    for tag, fmt, limit in zip(tags, (">B", ">H", ">I"), (2**8, 2**16, 2**32)):
        if tag is not None and n < limit:
            return bytes([tag]) + struct.pack(fmt, n)
    raise ValueError(f"msgpack: {n} items or bytes are too many")


def _str_header(n):
    return _header(0xA0, 32, n, (0xD9, 0xDA, 0xDB))


def _bin_header(n):
    return _header(None, 0, n, (0xC4, 0xC5, 0xC6))


def _array_header(n):
    return _header(0x90, 16, n, (None, 0xDC, 0xDD))


def _map_header(n):
    return _header(0x80, 16, n, (None, 0xDE, 0xDF))


def _ext_header(code: int, n: int) -> bytes:
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if n in fixed:
        return bytes([fixed[n], code])
    for tag, fmt, limit in ((0xC7, ">B", 2**8), (0xC8, ">H", 2**16),
                            (0xC9, ">I", 2**32)):
        if n < limit:
            return bytes([tag]) + struct.pack(fmt, n) + bytes([code])
    raise ValueError(f"msgpack: an extension of {n} bytes is too long")


def _int(v: int) -> bytes:
    if 0 <= v < 128:
        return bytes([v])
    if -32 <= v < 0:
        return struct.pack(">b", v)
    if v >= 0:
        for tag, fmt, limit in ((0xCC, ">B", 2**8), (0xCD, ">H", 2**16),
                                (0xCE, ">I", 2**32), (0xCF, ">Q", 2**64)):
            if v < limit:
                return bytes([tag]) + struct.pack(fmt, v)
    else:
        for tag, fmt, limit in ((0xD0, ">b", 2**7), (0xD1, ">h", 2**15),
                                (0xD2, ">i", 2**31), (0xD3, ">q", 2**63)):
            if v >= -limit:
                return bytes([tag]) + struct.pack(fmt, v)
    raise ValueError(f"msgpack: integer {v} out of range")


def _array_payload(x) -> tuple:
    """(shape, dtype name, C-order bytes as a flat uint8 array) of an array
    leaf, as flax stores it."""
    name = None
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().contiguous()
        if x.dtype == torch.bfloat16:
            name, x = "bfloat16", x.view(torch.int16)
        x = x.numpy()
    x = np.asarray(x, order="C")  # keeps 0-d arrays 0-d
    if x.dtype.hasobject or x.dtype.fields is not None:
        raise ValueError(f"msgpack: dtype {x.dtype} is not serialisable")
    return x.shape, name or x.dtype.name, x.reshape(-1).view(np.uint8)


def _array_ext(code: int, x, write: Callable[[Any], Any]) -> None:
    shape, name, buf = _array_payload(x)
    nbytes = buf.size
    if nbytes > MAX_CHUNK_SIZE:
        raise ValueError(
            f"msgpack: an array of {nbytes} bytes needs flax's chunked form "
            f"(over {MAX_CHUNK_SIZE} bytes), which this codec does not write")
    head = bytearray(_array_header(3))
    head += _array_header(len(shape))
    for d in shape:
        head += _int(int(d))
    head += _str_header(len(name)) + name.encode()
    head += _bin_header(nbytes)
    write(_ext_header(code, len(head) + nbytes))
    write(bytes(head))
    write(buf.data)


def pack(obj, write: Callable[[Any], Any]) -> None:
    """Encode ``obj`` piece by piece through ``write`` (e.g. a file's
    ``write``): big array buffers are handed over without a copy."""
    if obj is None:
        write(b"\xc0")
    elif obj is True or obj is False:
        write(b"\xc3" if obj else b"\xc2")
    elif isinstance(obj, int):
        write(_int(obj))
    elif isinstance(obj, float):
        write(b"\xcb" + struct.pack(">d", obj))
    elif isinstance(obj, str):
        data = obj.encode()
        write(_str_header(len(data)) + data)
    elif isinstance(obj, (bytes, bytearray)):
        write(_bin_header(len(obj)) + bytes(obj))
    elif isinstance(obj, (np.ndarray, torch.Tensor)):
        _array_ext(EXT_NDARRAY, obj, write)
    elif isinstance(obj, np.generic):
        _array_ext(EXT_NPSCALAR, np.asarray(obj), write)
    elif isinstance(obj, complex):
        body = packb((obj.real, obj.imag))
        write(_ext_header(EXT_COMPLEX, len(body)) + body)
    elif isinstance(obj, (list, tuple)):
        write(_array_header(len(obj)))
        for item in obj:
            pack(item, write)
    elif isinstance(obj, dict):
        write(_map_header(len(obj)))
        for key, value in obj.items():
            pack(key, write)
            pack(value, write)
    else:
        raise TypeError(f"msgpack: cannot encode {type(obj).__name__}")


def packb(obj) -> bytes:
    out = bytearray()
    pack(obj, out.extend)
    return bytes(out)


def dump(obj, f: BinaryIO) -> None:
    pack(obj, f.write)


class _Reader:
    def __init__(self, data):
        self.buf = memoryview(data).cast("B")
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise ValueError("msgpack: truncated input")
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out

    def uint(self, size: int) -> int:
        return int.from_bytes(self.take(size), "big")

    def value(self):
        tag = self.take(1)[0]
        if tag < 0x80:
            return tag
        if tag >= 0xE0:
            return tag - 0x100
        if 0x80 <= tag <= 0x8F:
            return self.map(tag & 0x0F)
        if 0x90 <= tag <= 0x9F:
            return self.array(tag & 0x0F)
        if 0xA0 <= tag <= 0xBF:
            return self.str(tag & 0x1F)
        if tag == 0xC0:
            return None
        if tag in (0xC2, 0xC3):
            return tag == 0xC3
        if tag in (0xC4, 0xC5, 0xC6):
            return bytes(self.bin(tag))
        if tag in (0xC7, 0xC8, 0xC9):
            n = self.uint(1 << (tag - 0xC7))
            return self.ext(n)
        if tag == 0xCA:
            return struct.unpack(">f", self.take(4))[0]
        if tag == 0xCB:
            return struct.unpack(">d", self.take(8))[0]
        if 0xCC <= tag <= 0xCF:
            return self.uint(1 << (tag - 0xCC))
        if 0xD0 <= tag <= 0xD3:
            size = 1 << (tag - 0xD0)
            return int.from_bytes(self.take(size), "big", signed=True)
        if 0xD4 <= tag <= 0xD8:
            return self.ext(1 << (tag - 0xD4))
        if tag in (0xD9, 0xDA, 0xDB):
            return self.str(self.uint(1 << (tag - 0xD9)))
        if tag in (0xDC, 0xDD):
            return self.array(self.uint(2 << (tag - 0xDC)))
        if tag in (0xDE, 0xDF):
            return self.map(self.uint(2 << (tag - 0xDE)))
        raise ValueError(f"msgpack: unknown type byte 0x{tag:02x}")

    def bin(self, tag: int) -> memoryview:
        if tag not in (0xC4, 0xC5, 0xC6):
            raise ValueError(f"msgpack: type byte 0x{tag:02x} is not bin")
        return self.take(self.uint(1 << (tag - 0xC4)))

    def str(self, n: int) -> str:
        return str(self.take(n), "utf-8")

    def array(self, n: int) -> list:
        return [self.value() for _ in range(n)]

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.value()
            out[key] = self.value()
        if _CHUNKED in out:
            raise ValueError(
                "msgpack: a chunked array (flax splits leaves over "
                f"{MAX_CHUNK_SIZE} bytes) is not read by this codec")
        return out

    def ext(self, n: int):
        code = self.take(1)[0]
        body = _Reader(self.take(n))
        if code == EXT_COMPLEX:
            real, imag = body.value()
            return complex(real, imag)
        if code not in (EXT_NDARRAY, EXT_NPSCALAR):
            raise ValueError(f"msgpack: unknown extension type {code}")
        if body.take(1)[0] != 0x93:
            raise ValueError("msgpack: an array extension is not a "
                             "(shape, dtype, bytes) triple")
        shape, name = tuple(body.value()), body.value()
        buf = body.bin(body.take(1)[0])  # a view: no copy of the data
        if name == "bfloat16":
            bits = np.frombuffer(buf, np.int16).reshape(shape)
            arr = torch.from_numpy(bits.copy()).view(torch.bfloat16)
            return arr if code == EXT_NDARRAY else arr.reshape(())
        arr = np.frombuffer(buf, np.dtype(name)).reshape(shape)
        return arr if code == EXT_NDARRAY else arr[()]


def unpackb(data) -> Any:
    """Decode one MessagePack value from ``data`` (bytes-like).  Arrays are
    views of ``data``, which must outlive them."""
    reader = _Reader(data)
    out = reader.value()
    if reader.pos != len(reader.buf):
        raise ValueError(f"msgpack: {len(reader.buf) - reader.pos} bytes "
                         "after the value")
    return out
