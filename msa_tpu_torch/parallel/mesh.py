"""A (data, model) grid of process ranks.

Counterpart of ``msa_tpu/parallel/mesh.py``.  JAX lays a ``Mesh`` over
devices and lets GSPMD place the collectives; the port runs one process per
rank (``parallel/distributed.py``), so its mesh is a grid of ranks: the
``data`` axis splits the batch (the gradients are summed over it), the
``model`` axis splits the weights (tensor and sequence parallelism,
``parallel/sharding.py``).  Each rank reads its (d, m) place from
:meth:`Mesh.coords`, and its two process groups -- the ranks of its data
column and of its model row -- from :meth:`Mesh.groups`.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np

DATA_AXIS = "data"
MODEL_AXIS = "model"


def world_size() -> int:
    """Ranks in the default process group; 1 without one."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


# process groups by their ranks: every rank creates the same groups in the
# same order, so a mesh built twice reuses them
_GROUPS: Dict[Tuple[int, ...], object] = {}


def _group(ranks: Sequence[int]):
    """The process group of ``ranks`` (None: the whole default group).
    ``torch.distributed.new_group`` is collective: every rank of the default
    group must call this, in the same order, for every group."""
    import torch.distributed as dist

    key = tuple(int(r) for r in ranks)
    if key == tuple(range(dist.get_world_size())):
        return None
    if key not in _GROUPS:
        _GROUPS[key] = dist.new_group(list(key))
    return _GROUPS[key]


class Mesh:
    """``ranks``: an int array [data, model] of global ranks."""

    def __init__(self, ranks):
        self.ranks = np.asarray(ranks, dtype=np.int64).reshape(
            np.shape(ranks)[0], -1)

    @property
    def shape(self) -> Dict[str, int]:
        return {DATA_AXIS: self.ranks.shape[0], MODEL_AXIS: self.ranks.shape[1]}

    @property
    def size(self) -> int:
        return int(self.ranks.size)

    def coords(self, rank: int) -> Tuple[int, int]:
        """(d, m): the data row and model column of ``rank``."""
        hit = np.argwhere(self.ranks == rank)
        if not len(hit):
            raise ValueError(f"rank {rank} is not in the mesh "
                             f"{self.ranks.tolist()}")
        return int(hit[0][0]), int(hit[0][1])

    def groups(self) -> Dict[str, object]:
        """This rank's process groups, for each axis longer than 1:
        {DATA_AXIS: the ranks of its model column (the data group),
        MODEL_AXIS: the ranks of its data row (the model group)}; None
        stands for the default group.  Every group of such an axis is
        created on every rank, columns first, then rows, in index order: a
        rank that created them in another order would hang.  The mesh must
        hold every rank of the process group."""
        import torch.distributed as dist

        if self.size != world_size():
            raise ValueError(f"{self}: a mesh of every rank of the "
                             f"{world_size()} is needed")
        d, m = self.coords(dist.get_rank())
        out = {}
        if self.ranks.shape[0] > 1:
            cols = [_group(self.ranks[:, j]) for j in range(self.ranks.shape[1])]
            out[DATA_AXIS] = cols[m]
        if self.ranks.shape[1] > 1:
            rows = [_group(self.ranks[i]) for i in range(self.ranks.shape[0])]
            out[MODEL_AXIS] = rows[d]
        return out

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, ranks={self.ranks.tolist()})"


def make_mesh(data_parallel: int = -1, model_parallel: int = 1,
              ranks: Optional[Sequence[int]] = None) -> Mesh:
    """Build a (data, model) mesh over ``ranks`` (default: every rank of the
    process group, or the one process).  ``data_parallel=-1`` -> all
    remaining."""
    ranks = list(ranks) if ranks is not None else list(range(world_size()))
    n = len(ranks)
    if model_parallel <= 0:
        model_parallel = 1
    if data_parallel == -1:
        if n % model_parallel:
            raise ValueError(f"{n} ranks not divisible by "
                             f"model_parallel={model_parallel}")
        data_parallel = n // model_parallel
    want = data_parallel * model_parallel
    if want > n:
        raise ValueError(f"requested {want} ranks, have {n}")
    return Mesh(np.asarray(ranks[:want]).reshape(data_parallel, model_parallel))


def make_hybrid_mesh(dcn_data_parallel: int, ici_data_parallel: int = -1,
                     model_parallel: int = 1,
                     ranks: Optional[Sequence[int]] = None,
                     slice_ids: Optional[Sequence[int]] = None) -> Mesh:
    """Multi-host mesh: data parallelism across hosts (slices), data x model
    within one.  Every ``model`` group and every within-slice block of the
    ``data`` axis holds ranks of ONE slice; only the outermost blocks of the
    gradient sum cross hosts.  The outer axis folds into ``data``, so the
    axis names are :func:`make_mesh`'s.

    By default the slices are contiguous blocks of the world's ranks (the
    ranks of one host are numbered together, as ``torchrun`` numbers them);
    pass ``ranks`` and ``slice_ids`` to give the topology by hand.
    """
    if (ranks is None) != (slice_ids is None):
        raise ValueError("pass both ranks and slice_ids, or neither")
    if ranks is None:
        ranks = list(range(world_size()))
        if len(ranks) % dcn_data_parallel:
            raise ValueError(f"uneven slices: {len(ranks)} ranks over "
                             f"{dcn_data_parallel}")
        per_slice = len(ranks) // dcn_data_parallel
        slice_ids = [r // per_slice for r in ranks]
    return Mesh(_hybrid_grid_from_slices(ranks, slice_ids, dcn_data_parallel,
                                         ici_data_parallel, model_parallel))


def _hybrid_grid_from_slices(ranks, slice_ids, dcn_data_parallel,
                             ici_data_parallel, model_parallel):
    """(data, model) grid with slice-locality: slice s owns the contiguous
    data-axis rows [s * ici_dp, (s+1) * ici_dp)."""
    ranks = list(ranks)
    slice_ids = list(slice_ids)
    if len(ranks) != len(slice_ids):
        raise ValueError(f"{len(ranks)} ranks but {len(slice_ids)} slice_ids")
    groups: dict = {}
    for r, s in zip(ranks, slice_ids):
        groups.setdefault(s, []).append(r)
    if len(groups) != dcn_data_parallel:
        raise ValueError(f"{len(groups)} slices found, "
                         f"dcn_data_parallel={dcn_data_parallel}")
    sizes = {len(g) for g in groups.values()}
    if len(sizes) != 1:
        raise ValueError(f"uneven slices: {sorted(sizes)}")
    per_slice = sizes.pop()
    if ici_data_parallel == -1:
        ici_data_parallel = per_slice // model_parallel
    if ici_data_parallel * model_parallel != per_slice:
        raise ValueError(
            f"slice of {per_slice} ranks != ici_data_parallel"
            f"({ici_data_parallel}) x model_parallel({model_parallel})")
    return np.concatenate([np.asarray(groups[s]).reshape(
        ici_data_parallel, model_parallel) for s in sorted(groups)], axis=0)
