"""Zstandard frames decoded by the port's own host decoder.

``csrc/zstd_decode.cpp`` (RFC 8878, with the XXH64 content checksum) is
built by ``_build`` at first use and called through ``ctypes``, which
releases the GIL: a batch of frames is split across a small thread pool,
one C call a thread.  A frame decodes straight into its destination where
the caller gives one (a zarr chunk's part of its leaf), else into a buffer
of the size its header states or that grows up to ``max_size``.  Every
error code raises :class:`ZstdError`; nothing falls back to another
decoder.
"""

from __future__ import annotations

import ctypes
import os
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional, Sequence

import numpy as np

from .. import _build

_P = ctypes.c_void_p
_SIZE = ctypes.c_size_t
_SIGNATURES = {
    "msa_zstd_decompress": (_P, _SIZE, _P, _SIZE, ctypes.POINTER(_SIZE)),
    "msa_zstd_decompress_batch": (ctypes.c_int, _P, _P, _P, _P, _P, _P),
    "msa_zstd_content_size": (_P, _SIZE, ctypes.POINTER(ctypes.c_uint64)),
    "msa_crc32c": (_P, _SIZE),
}
_RESTYPES = {"msa_crc32c": ctypes.c_uint32}

ERRORS = {
    -1: "the input ends inside a frame",
    -2: "not a zstd frame (bad magic number)",
    -3: "a reserved bit or block type is set",
    -4: "the frame needs a dictionary",
    -5: "the output does not fit its buffer",
    -6: "a corrupt entropy table or stream",
    -7: "a match reaches before the output's start",
    -8: "the content checksum does not match",
    -9: "the frame's stated content size is not met",
    -10: "a table is repeated before any was set",
    -11: "a block decodes to more than 128 KiB",
}
DST_TOO_SMALL = -5
THREADS = min(8, os.cpu_count() or 1)

_pool: Optional[ThreadPoolExecutor] = None


class ZstdError(ValueError):
    """A frame the decoder refuses: corrupt, truncated or of another size."""


def _lib() -> ctypes.CDLL:
    return _build.load("zstd_decode", _SIGNATURES, _RESTYPES)


def _bytes(data) -> np.ndarray:
    return np.frombuffer(data, dtype=np.uint8)


def crc32c(data) -> int:
    """The CRC-32C (Castagnoli) of a bytes-like object."""
    buf = _bytes(data)
    return int(_lib().msa_crc32c(buf.ctypes.data, buf.size))


def content_size(frame) -> Optional[int]:
    """The content size a frame's header states, else None."""
    buf = _bytes(frame)
    size = ctypes.c_uint64()
    code = _lib().msa_zstd_content_size(buf.ctypes.data, buf.size,
                                        ctypes.byref(size))
    if code < 0:
        raise ZstdError(f"zstd: {ERRORS.get(code, code)}")
    return int(size.value) if code == 0 else None


def _decode_batch(jobs) -> List[int]:
    """One C call for ``jobs``, a list of (src, dst) uint8 arrays; the code
    of each job, its written size checked against its destination."""
    n = len(jobs)
    srcs = (_P * n)(*[s.ctypes.data for s, _ in jobs])
    sizes = (_SIZE * n)(*[s.size for s, _ in jobs])
    dsts = (_P * n)(*[d.ctypes.data for _, d in jobs])
    caps = (_SIZE * n)(*[d.size for _, d in jobs])
    written = (_SIZE * n)()
    codes = (ctypes.c_int * n)()
    _lib().msa_zstd_decompress_batch(n, srcs, sizes, dsts, caps, written,
                                     codes)
    return [(code, int(w)) for code, w in zip(codes, written)]


def _pool_map(fn, groups):
    global _pool
    if len(groups) == 1:
        return [fn(groups[0])]
    if _pool is None:
        _pool = ThreadPoolExecutor(THREADS, thread_name_prefix="zstd")
    return list(_pool.map(fn, groups))


def _split(jobs, threads: int):
    """``jobs`` in at most ``threads`` groups of about equal input bytes."""
    if threads <= 1 or len(jobs) <= 1:
        return [jobs]
    total = sum(s.size for s, _ in jobs)
    share = total / threads
    groups, group, acc = [], [], 0
    for job in jobs:
        group.append(job)
        acc += job[0].size
        if acc >= share * (len(groups) + 1) and len(groups) < threads - 1:
            groups.append(group)
            group = []
    if group:
        groups.append(group)
    return groups


def decompress(frames: Sequence, outs: Optional[Sequence[np.ndarray]] = None,
               max_size: int = 1 << 30,
               threads: Optional[int] = None) -> List[np.ndarray]:
    """Decode each input (one or more zstd frames back to back) to a uint8
    array.

    ``outs``, when given, are the destinations, one an input: C-contiguous
    uint8 arrays (views into a larger array are fine), each filled exactly
    by ``threads`` (default ``THREADS``) in parallel.  Without them an
    input decodes into a buffer of the size its header states, else of a
    guess, doubled while too small up to ``max_size`` bytes.  Raises
    :class:`ZstdError` on any error code and on a decoded size other than
    the one expected.
    """
    frames = [_bytes(f) for f in frames]
    if outs is None:
        return [_decompress_unknown(f, max_size) for f in frames]
    outs = list(outs)
    if len(outs) != len(frames):
        raise ValueError("decompress: one destination a frame")
    for out in outs:
        if out.dtype != np.uint8 or not out.flags.c_contiguous \
                or not out.flags.writeable:
            raise ValueError("decompress: a destination must be a writable "
                             "C-contiguous uint8 array")
    groups = _split(list(zip(frames, outs)), threads or THREADS)
    results = [r for group in _pool_map(_decode_batch, groups) for r in group]
    for i, (out, (code, written)) in enumerate(zip(outs, results)):
        if code != 0:
            raise ZstdError(f"zstd: frame {i}: {ERRORS.get(code, code)}")
        if written != out.size:
            raise ZstdError(f"zstd: frame {i} decodes to {written} bytes, "
                            f"not {out.size}")
    return outs


def _decompress_unknown(frame: np.ndarray, max_size: int) -> np.ndarray:
    """Decode into a buffer of the size the first frame's header states
    (frames may follow it), else of a guess, doubled while too small."""
    try:
        stated = content_size(frame)
    except ZstdError:  # a skippable frame first; the decode reports errors
        stated = None
    cap = min(max_size, max(1, stated) if stated is not None
              else max(1 << 16, 4 * frame.size))
    while True:
        out = np.empty(cap, np.uint8)
        written = _SIZE()
        code = _lib().msa_zstd_decompress(frame.ctypes.data, frame.size,
                                          out.ctypes.data, cap,
                                          ctypes.byref(written))
        if code == DST_TOO_SMALL and cap < max_size:
            cap = min(max_size, 2 * cap)
            continue
        if code != 0:
            raise ZstdError(f"zstd: {ERRORS.get(code, code)}"
                            + (f" (limit {max_size} bytes)"
                               if code == DST_TOO_SMALL else ""))
        return out[:written.value]
