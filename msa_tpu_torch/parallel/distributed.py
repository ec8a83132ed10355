"""Data parallelism across processes: launch, batch sharding, collectives.

Counterpart of ``msa_tpu/parallel/distributed.py``.  One process per rank,
joined by ``torch.distributed``:

* :func:`initialize` starts the process group (``tcp://`` at a coordinator,
  or torchrun's ``env://``), once, and puts the rank on its card;
* every rank holds the same seeded global batch and keeps its rows
  (:func:`shard_host_batch`), as JAX's ``global_batch_array`` does: no data
  is exchanged;
* :class:`DataParallel` is a rank's view of its data group: the sums and
  row gathers the losses need to equal the global batch's (``ops/
  losses.py``), and the one flat all-reduce of the gradients;
* :class:`ModelParallel` is its view of its model group (tensor and
  sequence parallelism, Megatron's layout): the conjugate pairs of
  collectives as autograd functions -- identity / all-reduce, all-reduce /
  identity, all-gather / reduce-scatter, reduce-scatter / all-gather --
  an all-reduce MAX, and the gather of split leaves for checkpoints.

The backend follows the device layout, never a failure: ``gloo`` for CPU
tensors and for ranks that share a card (NCCL refuses two ranks on one
device), else ``nccl``.  Both run the native all-gather and reduce-scatter
on CPU and CUDA tensors (gloo's CUDA form stages through the host), so no
collective is rewritten as an all-reduce.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from .mesh import DATA_AXIS, MODEL_AXIS, Mesh


def _env_int(name: str) -> Optional[int]:
    return int(os.environ[name]) if name in os.environ else None


def process_env_defaults() -> Dict[str, Optional[object]]:
    """Manual-launch settings from the environment (``MSA_COORDINATOR``,
    ``MSA_NUM_PROCESSES``, ``MSA_PROCESS_ID``) for CLIs that don't pass
    explicit flags."""
    return {"coordinator_address": os.environ.get("MSA_COORDINATOR"),
            "num_processes": _env_int("MSA_NUM_PROCESSES"),
            "process_id": _env_int("MSA_PROCESS_ID")}


def local_rank(process_id: Optional[int] = None) -> int:
    """The rank's index on its host: torchrun's ``LOCAL_RANK``, else the
    process id (a manual launch puts its processes on one host)."""
    env = _env_int("LOCAL_RANK")
    if env is not None:
        return env
    if process_id is not None:
        return process_id
    return dist.get_rank() if dist.is_initialized() else 0


def local_world_size(num_processes: Optional[int] = None) -> int:
    """Ranks on this host: torchrun's ``LOCAL_WORLD_SIZE``, else
    ``num_processes`` (one host), else the world."""
    env = _env_int("LOCAL_WORLD_SIZE")
    if env is not None:
        return env
    if num_processes is not None:
        return num_processes
    return dist.get_world_size() if dist.is_initialized() else 1


def rank_device(device="cuda", process_id: Optional[int] = None
                ) -> torch.device:
    """The rank's device: the CPU when asked for, else
    ``cuda:{local_rank % device_count}``.  Raises without a card."""
    device = torch.device(device)
    if device.type == "cpu":
        return device
    if not torch.cuda.is_available():
        raise RuntimeError(f"device {device} asked for, but CUDA is not "
                           "available; pass the CPU to run on it")
    return torch.device("cuda",
                        local_rank(process_id) % torch.cuda.device_count())


def choose_backend(device, local_ranks: int) -> str:
    """``gloo`` for CPU tensors and for ranks that share a card (NCCL
    refuses two ranks on one device), else ``nccl``."""
    if torch.device(device).type == "cpu":
        return "gloo"
    return "gloo" if local_ranks > torch.cuda.device_count() else "nccl"


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None, device="cuda") -> str:
    """Start the default process group, once; returns its backend.

    With a ``coordinator_address`` (host:port, where rank 0 listens) the
    group meets at ``tcp://`` and needs ``num_processes`` and
    ``process_id``; without one it reads torchrun's variables (``env://``:
    ``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``).  On CUDA
    the rank's card becomes the current device (:func:`rank_device`).
    """
    if dist.is_initialized():
        return dist.get_backend()
    if coordinator_address is not None:
        if num_processes is None or process_id is None:
            raise ValueError(
                f"coordinator {coordinator_address}: the number of processes"
                " and this process's id are needed (--num_processes / "
                "--process_id or MSA_NUM_PROCESSES / MSA_PROCESS_ID)")
        init = dict(init_method=f"tcp://{coordinator_address}",
                    world_size=num_processes, rank=process_id)
    else:
        init = dict(init_method="env://")
        num_processes = _env_int("WORLD_SIZE")
        process_id = _env_int("RANK")
    dev = rank_device(device, process_id)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    backend = choose_backend(dev, local_world_size(num_processes))
    print(f"msa_tpu_torch.parallel: rank {process_id} of {num_processes} on "
          f"{dev}, backend {backend}", flush=True)
    dist.init_process_group(backend, **init)
    return backend


def is_multiprocess() -> bool:
    return dist.is_initialized() and dist.get_world_size() > 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def barrier() -> None:
    """Wait for every rank (a no-op in one process)."""
    if is_multiprocess():
        dist.barrier()


def broadcast_object(obj, src: int = 0):
    """``obj`` as rank ``src`` holds it, on every rank."""
    if not is_multiprocess():
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=src)
    return box[0]


def pad_batch(batch: Dict[str, np.ndarray], multiple: int
              ) -> Dict[str, np.ndarray]:
    """Zero-pad every array's rows to a multiple of ``multiple``: the padded
    rows carry weight 0, so every loss ignores them (JAX's
    ``Trainer._shard_batch``)."""
    pad = (-len(next(iter(batch.values())))) % multiple
    if not pad:
        return batch
    return {k: np.concatenate([np.asarray(v), np.zeros(
        (pad,) + np.shape(v)[1:], np.asarray(v).dtype)]) for k, v in batch.items()}


def local_rows(x, size: int, index: int):
    """Rows ``[index * n, (index + 1) * n)`` of ``x``, n = len(x) / size."""
    n = len(x) // size
    return x[index * n:(index + 1) * n]


def shard_host_batch(batch: Dict[str, np.ndarray], size: int, index: int
                     ) -> Dict[str, np.ndarray]:
    """A data rank's rows of the global host batch (padded first to a
    multiple of the group's ``size``)."""
    return {k: local_rows(v, size, index)
            for k, v in pad_batch(batch, size).items()}


class CommTimer:
    """Time spent in collectives: host seconds around CPU collectives; on
    the card CUDA event pairs on the current stream, read only in
    :attr:`seconds`, so no step waits for the card."""

    def __init__(self):
        self._host, self._events = 0.0, []

    @contextlib.contextmanager
    def __call__(self, device: torch.device):
        if device.type != "cuda":
            t0 = time.perf_counter()
            yield
            self._host += time.perf_counter() - t0
            return
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        yield
        end.record()
        self._events.append((start, end))

    @property
    def seconds(self) -> float:
        for start, end in self._events:
            end.synchronize()
            self._host += start.elapsed_time(end) / 1e3
        self._events.clear()
        return self._host


class _GatherRows(torch.autograd.Function):
    """All-gather of rows; the backward sums the gathered gradient over
    the group and keeps the own rows."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return group._gather(x)

    @staticmethod
    def backward(ctx, grad):
        g = ctx.group
        return local_rows(g.sum(grad.contiguous()), g.size, g.index), None


class DataParallel:
    """A rank's place in its data group: ``size`` ranks, this one at
    ``index``, joined by the process group ``group`` (None: the default
    group).  Every collective is one ``all_reduce`` (SUM), which gloo
    runs on CPU and CUDA tensors and NCCL on CUDA ones; a gather adds
    each rank's rows into a zeroed buffer of the group's rows."""

    def __init__(self, size: int, index: int, group=None):
        self.size, self.index, self.group = size, index, group

    @classmethod
    def from_mesh(cls, mesh: Mesh) -> Optional["DataParallel"]:
        """The data group of this process's rank (the ranks of its model
        column), or None for a data axis of 1.  The mesh must hold every
        rank of the process group."""
        if mesh.shape[DATA_AXIS] == 1:
            return None
        group = mesh.groups()[DATA_AXIS]
        return cls(mesh.shape[DATA_AXIS], mesh.coords(dist.get_rank())[0],
                   group)

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of ``x`` over the group (no autograd)."""
        out = x.detach().clone()
        dist.all_reduce(out, group=self.group)
        return out

    def _gather(self, x: torch.Tensor) -> torch.Tensor:
        n = x.shape[0]
        buf = x.new_zeros((self.size * n,) + tuple(x.shape[1:]))
        buf[self.index * n:(self.index + 1) * n] = x.detach()
        dist.all_reduce(buf, group=self.group)
        return buf

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's rows of ``x``, in rank order; differentiable."""
        if torch.is_grad_enabled() and x.requires_grad:
            return _GatherRows.apply(x, self)
        return self._gather(x)

    def sum_flat(self, tensors: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """``tensors`` (one dtype, one device: the f32 gradients) summed
        over the group through one flat buffer: one all_reduce, not one a
        tensor."""
        return _sum_flat(tensors, self.group)


def _sum_flat(tensors, group) -> List[torch.Tensor]:
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=group)
    return [part.view_as(t) for part, t in
            zip(flat.split([t.numel() for t in tensors]), tensors)]


# ---------------------------------------------------------------------------
# Tensor and sequence parallelism
# ---------------------------------------------------------------------------


def pad_rows(x: torch.Tensor, multiple: int, dim: int = 1) -> torch.Tensor:
    """``x`` zero-padded along ``dim`` to a multiple of ``multiple``."""
    pad = (-x.shape[dim]) % multiple
    if not pad:
        return x
    shape = list(x.shape)
    shape[dim] = pad
    return torch.cat([x, x.new_zeros(shape)], dim)


class _Copy(torch.autograd.Function):
    """Identity forward, all-reduce backward: the input of a column-split
    product, whose every rank's gradient is a partial sum."""

    @staticmethod
    def forward(ctx, x, mp):
        ctx.mp = mp
        return x

    @staticmethod
    def backward(ctx, grad):
        return ctx.mp.all_reduce(grad), None


class _Reduce(torch.autograd.Function):
    """All-reduce forward, identity backward: the output of a row-split
    product."""

    @staticmethod
    def forward(ctx, x, mp):
        return mp.all_reduce(x)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _Gather(torch.autograd.Function):
    """All-gather along ``dim`` forward; reduce-scatter backward (the
    gathered tensor feeds column-split products)."""

    @staticmethod
    def forward(ctx, x, mp, dim):
        ctx.mp, ctx.dim = mp, dim
        return mp.all_gather(x, dim)

    @staticmethod
    def backward(ctx, grad):
        return ctx.mp.reduce_scatter(grad, ctx.dim), None, None


class _ReduceScatter(torch.autograd.Function):
    """Reduce-scatter along ``dim`` forward, all-gather backward."""

    @staticmethod
    def forward(ctx, x, mp, dim):
        ctx.mp, ctx.dim = mp, dim
        return mp.reduce_scatter(x, dim)

    @staticmethod
    def backward(ctx, grad):
        return ctx.mp.all_gather(grad, ctx.dim), None, None


class _Split(torch.autograd.Function):
    """The own chunk along ``dim`` of a replicated tensor forward;
    all-gather backward."""

    @staticmethod
    def forward(ctx, x, mp, dim):
        ctx.mp, ctx.dim = mp, dim
        return mp.chunk(x, dim)

    @staticmethod
    def backward(ctx, grad):
        return ctx.mp.all_gather(grad, ctx.dim), None, None


class _GatherReplicated(torch.autograd.Function):
    """All-gather along ``dim`` into a tensor that is used replicated
    (every rank's gradient of it is the same): the backward keeps the own
    chunk."""

    @staticmethod
    def forward(ctx, x, mp, dim):
        ctx.mp, ctx.dim = mp, dim
        return mp.all_gather(x, dim)

    @staticmethod
    def backward(ctx, grad):
        return ctx.mp.chunk(grad, ctx.dim).contiguous(), None, None


class ModelParallel:
    """A rank's place in its model group: ``size`` ranks that split the
    weights (``parallel/sharding.py``), this one at ``index``, joined by
    ``group`` (None: the default group).  ``sequence_parallel``: between
    the LayerNorm boundaries of the encoder the residual stream is split
    over the sequence (``models/bert.py``).

    The raw collectives (:meth:`all_reduce`, :meth:`all_gather`,
    :meth:`reduce_scatter`, :meth:`max`) take no gradient; the conjugate
    pairs (:meth:`copy`, :meth:`reduce`, :meth:`gather`,
    :meth:`scatter`, :meth:`split`, :meth:`gather_replicated`) carry one
    where autograd records.  Every collective is timed (:attr:`timer`)."""

    def __init__(self, size: int, index: int, group=None,
                 sequence_parallel: bool = False):
        self.size, self.index, self.group = size, index, group
        self.sequence_parallel = bool(sequence_parallel)
        self.timer = CommTimer()

    @classmethod
    def from_mesh(cls, mesh: Mesh, sequence_parallel: bool = False
                  ) -> Optional["ModelParallel"]:
        """The model group of this process's rank (the ranks of its data
        row), or None for a model axis of 1 (sequence parallelism is then
        the identity, as in JAX)."""
        if mesh.shape[MODEL_AXIS] == 1:
            return None
        group = mesh.groups()[MODEL_AXIS]
        return cls(mesh.shape[MODEL_AXIS], mesh.coords(dist.get_rank())[1],
                   group, sequence_parallel)

    # raw collectives ---------------------------------------------------

    def all_reduce(self, x: torch.Tensor, op=dist.ReduceOp.SUM
                   ) -> torch.Tensor:
        out = x.detach().contiguous().clone()
        with self.timer(out.device):
            dist.all_reduce(out, op=op, group=self.group)
        return out

    def max(self, x: torch.Tensor) -> torch.Tensor:
        """The elementwise maximum of ``x`` over the group."""
        return self.all_reduce(x, dist.ReduceOp.MAX)

    def all_gather(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """Every rank's ``x`` concatenated along ``dim`` in rank order."""
        x = x.detach().contiguous()
        buf = x.new_empty((self.size * x.shape[0],) + tuple(x.shape[1:]))
        with self.timer(x.device):
            dist.all_gather_into_tensor(buf, x, group=self.group)
        if dim == 0:
            return buf
        return torch.cat(buf.chunk(self.size), dim)

    def reduce_scatter(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """The own chunk along ``dim`` (its length a multiple of the group)
        of the sum of ``x`` over the group."""
        parts = torch.cat(x.detach().chunk(self.size, dim)) if dim else \
            x.detach().contiguous()
        out = parts.new_empty((parts.shape[0] // self.size,) +
                              tuple(parts.shape[1:]))
        with self.timer(x.device):
            dist.reduce_scatter_tensor(out, parts, group=self.group)
        return out

    def chunk(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """The own chunk of ``x`` along ``dim`` (no collective)."""
        return x.chunk(self.size, dim)[self.index]

    # conjugate pairs ------------------------------------------------------

    @staticmethod
    def _recorded(x: torch.Tensor) -> bool:
        return torch.is_grad_enabled() and x.requires_grad

    def copy(self, x: torch.Tensor) -> torch.Tensor:
        """Identity; the backward sums the gradient over the group."""
        return _Copy.apply(x, self) if self._recorded(x) else x

    def reduce(self, x: torch.Tensor) -> torch.Tensor:
        """The sum over the group; the backward is the identity."""
        return _Reduce.apply(x, self) if self._recorded(x) \
            else self.all_reduce(x)

    def gather(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """All-gather along ``dim``; the backward reduce-scatters."""
        return _Gather.apply(x, self, dim) if self._recorded(x) \
            else self.all_gather(x, dim)

    def scatter(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """Reduce-scatter along ``dim``; the backward all-gathers."""
        return _ReduceScatter.apply(x, self, dim) if self._recorded(x) \
            else self.reduce_scatter(x, dim)

    def split(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """The own chunk of a replicated ``x``; the backward all-gathers."""
        return _Split.apply(x, self, dim) if self._recorded(x) \
            else self.chunk(x, dim)

    def gather_replicated(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """All-gather along ``dim`` into a tensor every rank then uses
        alike; the backward keeps the own chunk of the gradient."""
        return _GatherReplicated.apply(x, self, dim) if self._recorded(x) \
            else self.all_gather(x, dim)

    def sum_flat(self, tensors: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """``tensors`` (one dtype, one device) summed over the group in
        one flat all-reduce."""
        with self.timer(tensors[0].device):
            return _sum_flat(tensors, self.group)
