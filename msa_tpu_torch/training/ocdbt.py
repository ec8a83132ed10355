"""A read-only reader of tensorstore's OCDBT key-value stores.

The JAX package's sharded checkpoints (``orbax.checkpoint`` with
``use_ocdbt``) keep every zarr file in one OCDBT store: a B+tree whose
nodes and values live in data files beside a manifest.  This module reads
such a store with the standard library, numpy and the port's zstd decoder.

The format, as this reader takes it:

  * ``manifest.ocdbt`` and every B-tree node start with a 4-byte
    big-endian magic (``0x0cdb3a2a`` for a manifest, ``0x0cdb20de`` for a
    node), the file's length as a little-endian u64, a varint format
    version (0) and a varint compression method (0 none, 1 zstd); then
    the (compressed) body, then the CRC-32C of everything before it,
    little-endian.  Every such file is checked against its CRC.
  * The manifest body: the config (a 16-byte uuid, manifest kind,
    ``max_inline_value_bytes``, ``max_decoded_node_bytes``, the version
    tree's arity log2, the compression method and, for zstd, a 4-byte
    level), a data-file table, then the newest versions of the tree, each
    with its root node reference (file, offset, length), height and
    statistics; the newest is the store.
  * A data-file table lists paths, each stored as the length of the prefix
    it shares with the previous path and its own suffix, with the length
    of its base path (the directory it is relative to).  A table's paths
    are relative to the base path of the file that holds the table (a
    nested store's ``ocdbt.process_N/``), so references are followed by
    path alone.
  * A node: its height, a data-file table and its entries.  Keys are
    prefix-compressed; an interior entry adds the length of the key prefix
    common to its whole subtree (its child's keys omit that prefix) and
    the child's reference and statistics; a leaf entry has a value stored
    inline or a reference (file, offset; the length is the value's) into
    a data file.  Columns are stored one after another: all prefix
    lengths, then all suffix lengths, and so on.

Indirect values are read with ``os.pread``, so a store of many gigabytes is
never held in memory whole.  Anything else -- another manifest kind, a
compression method other than none or zstd, a newer format version --
raises ``NotImplementedError`` naming it; a file that is corrupt raises
:class:`OcdbtError`.
"""

from __future__ import annotations

import os
import struct
from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional, Tuple, Union

from . import zstd

MANIFEST_MAGIC = 0x0CDB3A2A
NODE_MAGIC = 0x0CDB20DE
FORMAT_VERSION = 0
MANIFEST_FILE = "manifest.ocdbt"
COMPRESSIONS = {0: "none", 1: "zstd"}


class OcdbtError(ValueError):
    """A store file that is corrupt or truncated."""


@dataclass(frozen=True)
class Ref:
    """Bytes [offset, offset + length) of a data file: ``path`` in the
    store, under ``base``, the directory its own references are relative
    to."""
    path: str
    offset: int
    length: int
    base: str = ""


Value = Union[bytes, Ref]


class _Reader:
    """Bounds-checked reads of a node or manifest body."""

    def __init__(self, data: bytes, what: str):
        self.data, self.pos, self.what = data, 0, what

    def _fail(self):
        raise OcdbtError(f"{self.what}: truncated or corrupt")

    def varint(self) -> int:
        data, pos, value, shift = self.data, self.pos, 0, 0
        while True:
            if pos >= len(data) or shift > 63:
                self._fail()
            byte = data[pos]
            pos += 1
            value |= (byte & 0x7F) << shift
            shift += 7
            if byte < 0x80:
                self.pos = pos
                return value

    def varints(self, n: int) -> List[int]:
        return [self.varint() for _ in range(n)]

    def byte(self) -> int:
        return self.take(1)[0]

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            self._fail()
        self.pos += n
        return self.data[self.pos - n:self.pos]

    def end(self):
        if self.pos != len(self.data):
            raise OcdbtError(f"{self.what}: {len(self.data) - self.pos} "
                             "bytes after its end")


def _unwrap(data: bytes, magic: int, what: str, max_size: int) -> bytes:
    """The body of a manifest or node file: header, CRC-32C and
    compression checked."""
    if len(data) < 16:
        raise OcdbtError(f"{what}: {len(data)} bytes, too short")
    (got,) = struct.unpack(">I", data[:4])
    if got != magic:
        raise OcdbtError(f"{what}: magic {got:#010x}, expected {magic:#010x}")
    (length,) = struct.unpack("<Q", data[4:12])
    if length != len(data):
        raise OcdbtError(f"{what}: states {length} bytes, holds {len(data)}")
    (crc,) = struct.unpack("<I", data[-4:])
    if zstd.crc32c(memoryview(data)[:-4]) != crc:
        raise OcdbtError(f"{what}: CRC-32C mismatch")
    head = _Reader(data[:-4], what)
    head.pos = 12
    version = head.varint()
    if version > FORMAT_VERSION:
        raise NotImplementedError(
            f"{what}: OCDBT format version {version} (this reader knows "
            f"{FORMAT_VERSION})")
    method = head.varint()
    body = memoryview(data)[head.pos:-4]
    if method == 0:
        return bytes(body)
    if method == 1:
        try:
            return zstd.decompress([body], max_size=max_size)[0].tobytes()
        except zstd.ZstdError as e:
            raise OcdbtError(f"{what}: {e}") from None
    raise NotImplementedError(f"{what}: OCDBT compression method {method}")


def _read_table(r: _Reader, base: str) -> List[Tuple[str, str]]:
    """A data-file table: (path, base path) of each file, both relative to
    the store's root; ``base`` is the base path of the file that holds
    the table."""
    n = r.varint()
    prefix = [0] + r.varints(max(n - 1, 0))
    suffix = r.varints(n)
    base_lengths = r.varints(n)
    files, path = [], b""
    for i in range(n):
        if prefix[i] > len(path):
            r._fail()
        path = path[:prefix[i]] + r.take(suffix[i])
        if base_lengths[i] > len(path):
            r._fail()
        name = path.decode()
        if name.startswith("/") or ".." in name.split("/"):
            raise OcdbtError(f"{r.what}: data file {name!r} leaves the store")
        files.append((base + name, base + name[:base_lengths[i]]))
    return files


def _ref(r: _Reader, table, f: int, offset: int, length: int) -> Ref:
    if f >= len(table):
        r._fail()
    return Ref(table[f][0], offset, length, table[f][1])


def _read_refs(r: _Reader, table, n: int) -> List[Ref]:
    """n (file, offset, length) references, then their statistics."""
    files, offsets, lengths = r.varints(n), r.varints(n), r.varints(n)
    r.varints(3 * n)  # num_keys, num_tree_bytes, num_indirect_value_bytes
    return [_ref(r, table, f, o, l)
            for f, o, l in zip(files, offsets, lengths)]


def _upper(prefix: bytes) -> Optional[bytes]:
    """The least key above every key that starts with ``prefix`` (None when
    there is none)."""
    stripped = prefix.rstrip(b"\xff")
    if not stripped:
        return None
    return stripped[:-1] + bytes([stripped[-1] + 1])


def _read_keys(r: _Reader, n: int, interior: bool):
    prefix = [0] + r.varints(max(n - 1, 0))
    suffix = r.varints(n)
    common = r.varints(n) if interior else None
    keys, key = [], b""
    for i in range(n):
        if prefix[i] > len(key):
            r._fail()
        key = key[:prefix[i]] + r.take(suffix[i])
        keys.append(key)
    return keys, common


class KvStore:
    """The newest version of the OCDBT store at directory ``root``.

    ``keys(prefix)`` lists its keys, ``read(key)`` / ``read_many(keys)``
    return values as bytes, ``locate(key)`` says where a value is (its
    bytes when inline, else a :class:`Ref`).  ``stats`` counts what the
    walk met: the tree's height, interior and leaf nodes, inline and
    indirect values.
    """

    def __init__(self, root: str):
        self.root = root
        with open(os.path.join(root, MANIFEST_FILE), "rb") as f:
            data = f.read()
        # the manifest's own limit is not known yet: bound it generously
        body = _unwrap(data, MANIFEST_MAGIC, MANIFEST_FILE, 1 << 26)
        r = _Reader(body, MANIFEST_FILE)
        r.take(16)  # the store's uuid
        kind = r.varint()
        if kind != 0:
            raise NotImplementedError(
                f"{root}: OCDBT manifest kind {kind} (numbered manifests); "
                "this reader reads single-file manifests")
        self.max_inline_value_bytes = r.varint()
        self.max_decoded_node_bytes = r.varint()
        r.byte()  # the version tree's arity, log2
        method = r.varint()
        if method not in COMPRESSIONS:
            raise NotImplementedError(
                f"{root}: OCDBT compression method {method}")
        if method == 1:
            r.take(4)  # the zstd level, which decoding does not need
        table = _read_table(r, "")
        n = r.varint()
        if n == 0:
            self._root = None
            self.height = 0
        else:
            r.varints(n)  # generation numbers
            heights = [r.byte() for _ in range(n)]
            refs = _read_refs(r, table, n)
            r.take(8 * n)  # commit times
            # older versions' nodes follow; the newest version is the store
            self._root, self.height = refs[-1], heights[-1]
        self.stats = {"height": self.height, "interior_nodes": 0,
                      "leaf_nodes": 0, "inline_values": 0,
                      "indirect_values": 0}
        self._index: Dict[str, Dict[bytes, Value]] = {}

    # -- files ---------------------------------------------------------------

    def _path(self, rel: str) -> str:
        return os.path.join(self.root, rel)

    def _pread(self, ref: Ref) -> bytes:
        fd = os.open(self._path(ref.path), os.O_RDONLY)
        try:
            data = os.pread(fd, ref.length, ref.offset)
        finally:
            os.close(fd)
        if len(data) != ref.length:
            raise OcdbtError(f"{ref.path}: {ref.length} bytes at "
                             f"{ref.offset} run past its end")
        return data

    # -- the tree ------------------------------------------------------------

    def _walk(self, ref: Ref, height: int, key_prefix: bytes,
              lo: bytes, hi: Optional[bytes], want: bytes,
              out: Dict[bytes, Value]):
        """Add the values under ``want`` of the subtree at ``ref``, which
        holds the keys in [lo, hi) and omits ``key_prefix`` from them."""
        what = f"{ref.path}@{ref.offset}"
        body = _unwrap(self._pread(ref), NODE_MAGIC, what,
                       self.max_decoded_node_bytes)
        r = _Reader(body, what)
        if r.byte() != height:
            raise OcdbtError(f"{what}: height differs from its reference")
        table = _read_table(r, ref.base)
        n = r.varint()
        if n == 0:
            raise OcdbtError(f"{what}: an empty node")
        if height == 0:
            self.stats["leaf_nodes"] += 1
            keys, _ = _read_keys(r, n, interior=False)
            lengths, kinds = r.varints(n), r.varints(n)
            if any(k > 1 for k in kinds):
                r._fail()
            indirect = [i for i in range(n) if kinds[i] == 1]
            files = r.varints(len(indirect))
            offsets = r.varints(len(indirect))
            values: Dict[int, Value] = {
                i: _ref(r, table, f, o, lengths[i])
                for i, f, o in zip(indirect, files, offsets)}
            for i in range(n):
                if kinds[i] == 0:
                    values[i] = r.take(lengths[i])
            r.end()
            for i in range(n):
                key = key_prefix + keys[i]
                if key.startswith(want):
                    out[key] = values[i]
                    self.stats["inline_values" if kinds[i] == 0
                               else "indirect_values"] += 1
            return
        self.stats["interior_nodes"] += 1
        keys, common = _read_keys(r, n, interior=True)
        children = _read_refs(r, table, n)
        r.end()
        full = [key_prefix + k for k in keys]
        upper = _upper(want)
        for i in range(n):
            if common[i] > len(keys[i]):
                raise OcdbtError(f"{what}: a subtree prefix longer than "
                                 "its key")
            # entry i holds the keys in [start, end)
            start = lo if i == 0 else full[i]
            end = full[i + 1] if i + 1 < n else hi
            if (end is not None and end <= want) or \
                    (upper is not None and start >= upper):
                continue
            self._walk(children[i], height - 1,
                       key_prefix + keys[i][:common[i]], start, end, want,
                       out)

    def _entries(self, prefix: str) -> Dict[bytes, Value]:
        """Every key under ``prefix`` and its value (cached per prefix)."""
        if prefix not in self._index:
            out: Dict[bytes, Value] = {}
            if self._root is not None:
                self._walk(self._root, self.height, b"", b"", None,
                           prefix.encode(), out)
            self._index[prefix] = out
        return self._index[prefix]

    def keys(self, prefix: str = "") -> List[str]:
        """The sorted keys that start with ``prefix``."""
        return sorted(k.decode() for k in self._entries(prefix))

    def locate(self, key: str, prefix: str = "") -> Value:
        """Where the value of ``key`` is: its bytes when stored inline,
        else a :class:`Ref`.  ``prefix`` names the walk to look it up in
        (a prefix of ``key``).  Raises ``KeyError`` for a missing key."""
        return self._entries(prefix)[key.encode()]

    def read_refs(self, refs: Iterable[Ref]) -> List[bytes]:
        """The bytes of each reference, adjacent ranges of a file read in
        one ``pread``."""
        refs = list(refs)
        out: List[Optional[bytes]] = [None] * len(refs)
        order = sorted(range(len(refs)),
                       key=lambda i: (refs[i].path, refs[i].offset))
        i = 0
        while i < len(order):
            first = refs[order[i]]
            j, end = i + 1, first.offset + first.length
            while j < len(order) and refs[order[j]].path == first.path \
                    and refs[order[j]].offset == end:
                end += refs[order[j]].length
                j += 1
            data = memoryview(self._pread(Ref(first.path, first.offset,
                                              end - first.offset)))
            for k in order[i:j]:
                ref = refs[k]
                start = ref.offset - first.offset
                out[k] = data[start:start + ref.length]
            i = j
        return out

    def read_many(self, keys: Iterable[str], prefix: str = "") -> List[bytes]:
        values = [self.locate(k, prefix) for k in keys]
        refs = [v for v in values if isinstance(v, Ref)]
        read = iter(self.read_refs(refs))
        return [bytes(next(read)) if isinstance(v, Ref) else v
                for v in values]

    def read(self, key: str) -> bytes:
        return self.read_many([key])[0]
