"""Which leaves of the parameter tree the model group splits, and how.

Counterpart of ``msa_tpu/parallel/sharding.py`` (``_spec_for``), on the
port's paths (``models/weights.py::named_leaves``: dense ``weight`` is
[out, in]).  Megatron's tensor-parallel layout:

  * q/k/v and FFN ``wi`` column-split: every leaf on the output dim
    (``weight`` / ``qweight`` rows, ``bias``, ``qscale``), so each rank
    holds ``num_heads / mp`` heads and ``intermediate_size / mp`` columns;
  * ``o`` and ``wo`` row-split: ``weight`` / ``qweight`` on the input dim;
    their ``bias`` and ``qscale`` replicated (added or applied once, after
    the sum over the group);
  * the word embedding vocab-split (rows), and ``cls/decoder_bias`` with
    it: the tied MLM decoder computes a vocab shard a rank;
  * everything else replicated, the int8 static ``ascale`` included.

JAX lays these specs over devices and GSPMD places the collectives; the
port's model code places them itself (``models/bert.py``,
``models/mmbert.py``, ``ops/losses.py``).  :func:`shard_params` cuts a
rank's shard out of the full tree, :func:`gather_params` puts shards back
together, :func:`gather_across` does that over the model group.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Sequence

import torch

from .mesh import MODEL_AXIS, Mesh

COLUMN_SPLIT = ("q", "k", "v", "wi")
ROW_SPLIT = ("o", "wo")


def split_dim(path: str) -> Optional[int]:
    """The dim of the leaf at ``path`` that the model group splits, or None
    (replicated)."""
    parts = path.split("/")
    if path.endswith("embeddings/word") or path.endswith("decoder_bias"):
        return 0
    if len(parts) == 5 and parts[:2] == ["bert", "layers"]:
        name, leaf = parts[3], parts[4]
        if leaf == "ascale":
            return None
        if name in COLUMN_SPLIT:
            return 0
        if name in ROW_SPLIT and leaf in ("weight", "qweight"):
            return 1
    return None


def sequence_partial(path: str) -> bool:
    """True for the replicated leaves that, under sequence parallelism, see
    only the rank's rows of the sequence, so their gradients are partial
    sums over the model group: the encoder's LayerNorms and the biases of
    the row-split ``o`` and ``wo``."""
    parts = path.split("/")
    return (len(parts) == 5 and parts[:2] == ["bert", "layers"] and
            (parts[3] in ("attn_ln", "mlp_ln")
             or (parts[3] in ROW_SPLIT and parts[4] == "bias")))


def check_divisible(bert_cfg, mp: int) -> None:
    """Raise unless the model group divides the heads, the FFN width and
    the padded vocabulary."""
    for what, n in (("num_attention_heads", bert_cfg.num_attention_heads),
                    ("intermediate_size", bert_cfg.intermediate_size),
                    ("padded vocab size", bert_cfg.padded_vocab_size)):
        if n % mp:
            raise ValueError(f"{what} {n} is not divisible by "
                             f"model_parallel={mp}")


def _map(tree, fn, prefix: str = ""):
    """``tree`` (dicts and lists) with ``fn(path, leaf)`` at every leaf."""
    if isinstance(tree, dict):
        return {k: _map(v, fn, f"{prefix}{k}/") for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map(v, fn, f"{prefix}{i}/") for i, v in enumerate(tree)]
    return fn(prefix[:-1], tree)


def _shard_leaf(path: str, leaf: torch.Tensor, size: int, index: int
               ) -> torch.Tensor:
    """Rank ``index``'s piece of one leaf (its own storage), for a model
    group of ``size``."""
    dim = split_dim(path)
    if dim is None or size == 1:
        return leaf
    if leaf.shape[dim] % size:
        raise ValueError(f"{path}: dim {dim} of {tuple(leaf.shape)} is not "
                         f"divisible by model_parallel={size}")
    return leaf.detach().chunk(size, dim)[index].clone(
        memory_format=torch.contiguous_format)


def shard_params(full, mesh: Mesh, rank: int):
    """The shard of ``full`` (a parameter tree in the port's layout, or a
    tree of the same paths: Adam moments) that ``rank`` of ``mesh`` holds."""
    size = mesh.shape[MODEL_AXIS]
    index = mesh.coords(rank)[1]
    return _map(full, lambda path, t: _shard_leaf(path, t, size, index))


def shard_opt_state(state, mesh: Mesh, rank: int):
    """An ``AdamWState`` with its moment trees (and accumulator) cut as
    :func:`shard_params` cuts the parameters."""
    acc = None if state.acc is None else shard_params(state.acc, mesh, rank)
    return dataclasses.replace(state, mu=shard_params(state.mu, mesh, rank),
                               nu=shard_params(state.nu, mesh, rank), acc=acc)


def gather_params(shards: Sequence[Any]):
    """The full tree from every rank's shard (in model-rank order): split
    leaves concatenated on their dim, replicated ones taken from the
    first."""
    def leaf(path, _):
        dim = split_dim(path)
        got = [_get(s, path) for s in shards]
        return got[0] if dim is None else torch.cat(got, dim)
    return _map(shards[0], leaf)


def _get(tree, path: str):
    for key in path.split("/"):
        tree = tree[int(key)] if isinstance(tree, list) else tree[key]
    return tree


def gather_across(local, mp) -> Any:
    """The full tree on every rank of the model group ``mp``
    (``parallel.distributed.ModelParallel``) from each rank's shard: one
    all-gather a split leaf."""
    return _map(local, lambda path, t: t.detach() if split_dim(path) is None
                else mp.all_gather(t, split_dim(path)))


def gather_opt_state(state, mp):
    """:func:`gather_across` of an ``AdamWState``'s trees."""
    acc = None if state.acc is None else gather_across(state.acc, mp)
    return dataclasses.replace(state, mu=gather_across(state.mu, mp),
                               nu=gather_across(state.nu, mp), acc=acc)

