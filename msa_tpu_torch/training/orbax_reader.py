"""The JAX package's sharded orbax checkpoints, read without orbax.

``msa_tpu/training/checkpoint.py::save_checkpoint_sharded`` (every
multi-process run's checkpoint) writes an ``orbax/`` directory with
``orbax.checkpoint.StandardCheckpointer``:

  * ``_METADATA`` (JSON): ``tree_metadata`` maps each leaf of the train
    state to its key path (``key_metadata``: a dict key, or a sequence
    index as a string) and its value type; ``use_ocdbt`` and
    ``use_zarr3`` say how the arrays are stored;
  * an OCDBT store (``ocdbt.py``) holding one zarr v2 array per leaf under
    the leaf's path joined by ``.``: ``<name>/.zarray`` (JSON) and one
    zstd-compressed chunk per shard, ``<name>/<i>.<j>`` (``<name>/0`` for a
    scalar), in C order.

:func:`read_state` returns the state as ``training/msgpack_codec.py``
decodes ``state.msgpack``: nested dicts with string keys (a tuple member
under its index, so ``from_jax_opt_state`` finds ``count, mu, nu`` and
``mini_step, acc_grads`` by name), numpy leaves, bf16 leaves as bf16 torch
tensors, and ``{}`` where orbax stored no data (an empty optax state).
Chunks decode on the zstd module's thread pool, straight into the leaf's
array where a chunk is a contiguous run of it.  Only ``use_ocdbt: true``
with zarr v2, zstd compression and the dtypes below are read; anything
else raises ``NotImplementedError`` naming it.
"""

from __future__ import annotations

import json
import math
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from . import zstd
from .ocdbt import KvStore, Ref

METADATA_FILE = "_METADATA"
KEY_TYPE_SEQUENCE = 1
KEY_TYPE_DICT = 2
# the zarr v2 dtypes of a train state, and their numpy forms; bfloat16 is
# read as its 16-bit pattern and viewed as torch.bfloat16
DTYPES = {"<f4": "<f4", "<i4": "<i4", "bfloat16": "<u2"}
# compressed bytes read and decoded at a time: bounds the reader's memory
# beside the state it returns
BATCH_BYTES = 256 << 20


def _key_path(entry: Dict[str, Any]) -> Tuple[str, ...]:
    path = []
    for part in entry["key_metadata"]:
        if part.get("key_type") not in (KEY_TYPE_SEQUENCE, KEY_TYPE_DICT):
            raise NotImplementedError(
                f"orbax key type {part.get('key_type')} in {entry}")
        path.append(str(part["key"]))
    return tuple(path)


def read_metadata(directory: str) -> Dict[Tuple[str, ...], Dict[str, Any]]:
    """Each leaf's key path -> its value metadata, from ``_METADATA``;
    raises NotImplementedError for a layout this reader does not read."""
    with open(os.path.join(directory, METADATA_FILE)) as f:
        meta = json.load(f)
    if meta.get("use_zarr3"):
        raise NotImplementedError(
            f"{directory}: use_zarr3 is true; this reader reads zarr v2 "
            "arrays only")
    if not meta.get("use_ocdbt"):
        raise NotImplementedError(
            f"{directory}: use_ocdbt is false (one tensorstore directory a "
            "leaf); this reader reads OCDBT stores only")
    return {_key_path(entry): entry.get("value_metadata", {})
            for entry in meta["tree_metadata"].values()}


class _Array:
    """One zarr v2 array of the store: its ``.zarray`` checked and its
    chunks listed as (key, the slices of the array it covers)."""

    def __init__(self, name: str, zarray: bytes):
        spec = json.loads(zarray)
        self.name = name
        if spec.get("zarr_format") != 2:
            raise NotImplementedError(
                f"{name}: zarr_format {spec.get('zarr_format')}")
        dtype = spec["dtype"]
        if not isinstance(dtype, str) or dtype not in DTYPES:
            raise NotImplementedError(f"{name}: zarr dtype {dtype!r}")
        self.bf16 = dtype == "bfloat16"
        self.dtype = np.dtype(DTYPES[dtype])
        compressor = spec.get("compressor") or {}
        if compressor.get("id") != "zstd":
            raise NotImplementedError(
                f"{name}: zarr compressor {compressor.get('id')!r}")
        if spec.get("filters"):
            raise NotImplementedError(f"{name}: zarr filters "
                                      f"{spec['filters']!r}")
        if spec.get("order", "C") != "C":
            raise NotImplementedError(f"{name}: zarr order {spec['order']!r}")
        self.fill_value = spec.get("fill_value")
        self.shape = tuple(spec["shape"])
        self.chunk_shape = tuple(spec["chunks"])
        if len(self.chunk_shape) != len(self.shape):
            raise ValueError(f"{name}: chunks {self.chunk_shape} for shape "
                             f"{self.shape}")
        self.sep = spec.get("dimension_separator", ".")

    def chunks(self):
        """(key, slices into the array, whether the chunk runs past the
        array's end) of every chunk."""
        if not self.shape:
            return [(f"{self.name}/0", (), False)]
        grid = [math.ceil(s / c) if c else 0
                for s, c in zip(self.shape, self.chunk_shape)]
        out = []
        for index in np.ndindex(*grid):
            slices = tuple(slice(i * c, min((i + 1) * c, s)) for i, c, s in
                           zip(index, self.chunk_shape, self.shape))
            partial = any(sl.stop - sl.start != c
                          for sl, c in zip(slices, self.chunk_shape))
            out.append((f"{self.name}/" + self.sep.join(map(str, index)),
                        slices, partial))
        return out


def _set(tree: Dict[str, Any], path: Sequence[str], value) -> None:
    for part in path[:-1]:
        tree = tree.setdefault(part, {})
    tree[path[-1]] = value


def read_state(directory: str,
               only: Optional[Sequence[str]] = None) -> Dict[str, Any]:
    """The train state in the ``orbax/`` directory ``directory``, in
    ``msgpack_codec``'s form; ``only`` keeps the top-level keys named
    (``("params",)`` reads no optimizer state)."""
    leaves = read_metadata(directory)
    if only is not None:
        leaves = {p: m for p, m in leaves.items() if p[0] in only}
    store = KvStore(directory)
    index: Dict[str, str] = {}  # key -> the walk (prefix) that found it
    for prefix in sorted({p[0] + ("." if len(p) > 1 else "/")
                          for p in leaves}):  # one walk a top-level key
        for key in store.keys(prefix):
            index[key] = prefix
    tree: Dict[str, Any] = {}
    # (source: bytes or Ref, the leaf's part the chunk fills, the chunk's
    # part that lies in the array, the array); a chunk that is a whole
    # contiguous run of its leaf decodes in place, any other through a
    # buffer of its own
    jobs = []
    for path, meta in sorted(leaves.items()):
        if meta.get("value_type") == "None":
            _set(tree, path, {})
            continue
        name = ".".join(path)
        array = _Array(name, _read(store, index, f"{name}/.zarray"))
        out = np.empty(array.shape, array.dtype)
        for key, slices, partial in array.chunks():
            if key not in index:
                raise KeyError(
                    f"{directory}: chunk {key} is missing and the array's "
                    f"fill_value is {array.fill_value!r}")
            view = out[slices] if slices else out
            inner = None if not partial and view.flags.c_contiguous else \
                tuple(slice(0, sl.stop - sl.start) for sl in slices)
            jobs.append((store.locate(key, index[key]), view, inner, array))
        leaf = out
        if array.bf16:
            leaf = torch.from_numpy(out.view(np.int16)).view(torch.bfloat16)
        _set(tree, path, leaf)
    _run(store, jobs)
    return tree


def _read(store: KvStore, index: Dict[str, str], key: str) -> bytes:
    if key not in index:
        raise KeyError(f"{store.root}: no {key} in the store")
    value = store.locate(key, index[key])
    return value if not isinstance(value, Ref) else \
        bytes(store.read_refs([value])[0])


def _batches(jobs):
    """``jobs`` cut into runs of about ``BATCH_BYTES`` compressed bytes."""
    start = 0
    while start < len(jobs):
        end, size = start, 0
        while end < len(jobs) and (end == start or size < BATCH_BYTES):
            value = jobs[end][0]
            size += value.length if isinstance(value, Ref) else len(value)
            end += 1
        yield jobs[start:end]
        start = end


def _read_sources(store: KvStore, batch):
    refs = [j[0] for j in batch if isinstance(j[0], Ref)]
    read = iter(store.read_refs(refs))
    return [next(read) if isinstance(j[0], Ref) else j[0] for j in batch]


def _run(store: KvStore, jobs) -> None:
    """Read and decode the chunks of ``jobs`` a batch at a time, the next
    batch read while this one decodes."""
    batches = list(_batches(jobs))
    with ThreadPoolExecutor(1, thread_name_prefix="orbax-read") as reader:
        pending = reader.submit(_read_sources, store, batches[0]) \
            if batches else None
        for n, batch in enumerate(batches):
            sources = pending.result()
            if n + 1 < len(batches):
                pending = reader.submit(_read_sources, store, batches[n + 1])
            dests = [view.reshape(-1).view(np.uint8) if inner is None else
                     np.empty(math.prod(array.chunk_shape) *
                              array.dtype.itemsize, np.uint8)
                     for _, view, inner, array in batch]
            zstd.decompress(sources, outs=dests)
            for (_, view, inner, array), dest in zip(batch, dests):
                if inner is not None:
                    view[...] = dest.view(array.dtype).reshape(
                        array.chunk_shape)[inner]
