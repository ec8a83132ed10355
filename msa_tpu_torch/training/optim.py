"""AdamW with optax semantics, the warmup/decay schedule and the decay mask.

Counterpart of ``msa_tpu/training/optim.py::make_optimizer`` (the optax
chain ``clip_by_global_norm`` -> AdamW, inside ``optax.MultiSteps`` when
accumulating), written with ``torch._foreach_*`` ops over the parameter
tree:

  * the moments update in f32 and are stored in ``adam_mu_dtype`` /
    ``adam_nu_dtype``, as ``scale_by_adam_casted`` does;
  * eps = 1e-6, added outside the square root;
  * the learning rate comes from the pre-increment count, the bias
    correction from count + 1;
  * decoupled weight decay, masked off biases and LayerNorm parameters;
  * ``max_grad_norm`` > 0 clips by the global norm first;
  * ``gradient_accumulation_steps`` k > 1 keeps a running mean of the
    gradients and updates on every k-th call, as ``optax.MultiSteps``.

The update is applied to the parameters in place (they are the trainer's
own f32 master tensors), which saves a second copy of them.  The count
lives on the host, so the schedule costs no device round trip.

``TrainConfig.fused_optimizer`` selects :class:`FusedAdamW` instead
(:func:`make_fused_optimizer`, JAX's ``FusedAdamW``): one fused kernel
launch per leaf, no accumulation.

Under tensor parallelism (``mp``, set by the trainer) each rank updates
its shard; only the global gradient norm of the clip needs the model
group (:func:`global_norm`).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional

import torch

from ..configs import TrainConfig
from ..models.weights import map_tree, named_leaves
from ..ops.fused_adamw import fused_adamw_leaf
from ..parallel.sharding import split_dim

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def no_decay(path: str) -> bool:
    """True for the leaves weight decay skips: biases and LayerNorm
    parameters (the JAX ``decay_mask`` rule, on the port's paths)."""
    p = path.lower()
    return (p.endswith("bias") or "/ln/" in f"/{p}" or p.endswith("scale")
            or any(n in p for n in ("attn_ln", "mlp_ln", "transform_ln")))


def global_norm(grads: List[torch.Tensor], paths: List[str],
                mp=None) -> torch.Tensor:
    """The 2-norm of every gradient together (0-d f32).  Under tensor
    parallelism (``mp``, the grads of the rank's shard) the squares of
    the split leaves are summed over the model group and the replicated
    leaves, alike on every rank, are counted once."""
    norms = torch.stack(torch._foreach_norm(grads))
    if mp is None:
        return torch.linalg.vector_norm(norms)
    split = torch.tensor([split_dim(p) is not None for p in paths],
                         device=norms.device)
    sq = norms.float().square()
    return (mp.all_reduce(sq[split].sum()) + sq[~split].sum()).sqrt()


def decay_mask(params) -> Dict[str, bool]:
    """{path: True where weight decay applies} over the parameter tree."""
    return {path: not no_decay(path) for path, _ in named_leaves(params)}


def linear_warmup_decay(base_lr: float, total_steps: int,
                        warmup_proportion: float) -> Callable[[int], float]:
    """Linear warmup from 0 to ``base_lr``, then linear decay to 0."""
    warmup = max(int(total_steps * warmup_proportion), 1)
    decay = max(total_steps - warmup, 1)

    def schedule(count: int) -> float:
        if count < warmup:
            return base_lr * count / warmup
        return base_lr * (1.0 - min(count - warmup, decay) / decay)

    return schedule


@dataclass
class AdamWState:
    """count: updates applied; mu / nu: trees like the parameters, in their
    storage dtypes; mini_step / acc: the accumulation state (acc is None
    without accumulation)."""

    count: int
    mu: Any
    nu: Any
    mini_step: int = 0
    acc: Optional[Any] = None


class AdamW:
    def __init__(self, schedule: Callable[[int], float], b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-6,
                 weight_decay: float = 0.01, max_grad_norm: float = 0.0,
                 mu_dtype: str = "float32", nu_dtype: str = "float32",
                 accumulation_steps: int = 1):
        self.schedule = schedule
        self.b1, self.b2, self.eps = b1, b2, eps
        self.weight_decay = weight_decay
        self.max_grad_norm = max_grad_norm
        self.mu_dtype = _DTYPES[mu_dtype]
        self.nu_dtype = _DTYPES[nu_dtype]
        self.accumulation_steps = accumulation_steps
        self.mp = None  # the model group under tensor parallelism

    def init(self, params) -> AdamWState:
        def zeros(dtype):
            return map_tree(params, lambda p: torch.zeros_like(p, dtype=dtype))
        acc = (zeros(torch.float32) if self.accumulation_steps > 1 else None)
        return AdamWState(count=0, mu=zeros(self.mu_dtype),
                          nu=zeros(self.nu_dtype), acc=acc)

    @torch.no_grad()
    def step(self, params, grads: Dict[str, torch.Tensor],
             state: AdamWState) -> None:
        """Apply one update in place.  ``grads``: {path: f32 gradient} for
        every leaf of ``params``."""
        paths = [p for p, _ in named_leaves(params)]
        leaves = dict(named_leaves(params))
        g = [grads[p].float() for p in paths]
        k = self.accumulation_steps
        if k > 1:
            acc = dict(named_leaves(state.acc))
            acc_l = [acc[p] for p in paths]
            # running mean, as MultiSteps' use_grad_mean
            diff = torch._foreach_sub(g, acc_l)
            torch._foreach_div_(diff, float(state.mini_step + 1))
            torch._foreach_add_(acc_l, diff)
            if state.mini_step < k - 1:
                state.mini_step += 1
                return
            g = [a.clone() for a in acc_l]
            for a in acc_l:
                a.zero_()
            state.mini_step = 0

        if self.max_grad_norm and self.max_grad_norm > 0:
            norm = global_norm(g, paths, self.mp)
            factor = torch.where(norm < self.max_grad_norm,
                                 torch.ones_like(norm),
                                 self.max_grad_norm / norm)
            torch._foreach_mul_(g, factor)

        b1, b2 = self.b1, self.b2
        t = state.count + 1
        c1, c2 = 1.0 - b1 ** t, 1.0 - b2 ** t
        lr = self.schedule(state.count)
        mu_store = dict(named_leaves(state.mu))
        nu_store = dict(named_leaves(state.nu))
        mu = [mu_store[p].float() for p in paths]
        nu = [nu_store[p].float() for p in paths]
        torch._foreach_mul_(mu, b1)
        torch._foreach_add_(mu, g, alpha=1.0 - b1)
        torch._foreach_mul_(nu, b2)
        torch._foreach_addcmul_(nu, g, g, value=1.0 - b2)
        update = torch._foreach_div(mu, c1)
        denom = torch._foreach_div(nu, c2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        torch._foreach_div_(update, denom)
        p_list: List[torch.Tensor] = [leaves[p] for p in paths]
        decayed = [i for i, p in enumerate(paths) if not no_decay(p)]
        if self.weight_decay and decayed:
            torch._foreach_add_([update[i] for i in decayed],
                                [p_list[i] for i in decayed],
                                alpha=self.weight_decay)
        torch._foreach_add_(p_list, update, alpha=-lr)
        for path, m32, n32 in zip(paths, mu, nu):
            if mu_store[path] is not m32:
                mu_store[path].copy_(m32)
            if nu_store[path] is not n32:
                nu_store[path].copy_(n32)
        state.count = t


class FusedAdamW(AdamW):
    """AdamW as one fused kernel launch per leaf (``ops/fused_adamw.py``),
    the counterpart of ``msa_tpu/training/optim.py::FusedAdamW``: optax's
    semantics (the schedule, bias correction, eps outside the root, the
    decay mask) with JAX's own clip rule, scale = min(1, max_grad_norm /
    (global norm + 1e-12)), computed on the device and handed to every
    launch.  The moments update in f32 inside the kernel and are stored
    in ``mu_dtype`` / ``nu_dtype``: no f32 copy of a moment or an update
    is ever materialised.  No gradient accumulation.

    The same in-place ``step(params, grads, state)`` and
    :class:`AdamWState` (``acc`` None) as :class:`AdamW`.  JAX computes
    lr, c1 and c2 in f32 on the device; here they are computed on the host
    in double and rounded once to f32 where they enter the kernel, so they
    can differ from JAX's by one f32 ulp."""

    @torch.no_grad()
    def step(self, params, grads: Dict[str, torch.Tensor],
             state: AdamWState) -> None:
        """Apply one update in place, one kernel launch per leaf."""
        named = list(named_leaves(params))
        g = [grads[path].float() for path, _ in named]
        scale = None
        if self.max_grad_norm and self.max_grad_norm > 0:
            norm = global_norm(g, [path for path, _ in named], self.mp)
            scale = torch.clamp(torch.div(torch.full_like(
                norm, self.max_grad_norm), norm + 1e-12), max=1.0)
        t = state.count + 1
        lr = self.schedule(state.count)
        c1, c2 = 1.0 - self.b1 ** t, 1.0 - self.b2 ** t
        mu = dict(named_leaves(state.mu))
        nu = dict(named_leaves(state.nu))
        for (path, p), gp in zip(named, g):
            fused_adamw_leaf(p, gp, mu[path], nu[path], lr,
                             0.0 if no_decay(path) else self.weight_decay,
                             c1, c2, b1=self.b1, b2=self.b2, eps=self.eps,
                             clip_scale=scale)
        state.count = t


def make_optimizer(cfg: TrainConfig, total_steps: int) -> AdamW:
    """The JAX ``make_optimizer``'s AdamW, from the same config fields
    (``fused_optimizer`` is the trainer's choice: :func:`make_fused_optimizer`)."""
    return AdamW(
        linear_warmup_decay(cfg.learning_rate, total_steps,
                            cfg.warmup_proportion),
        weight_decay=cfg.weight_decay, max_grad_norm=cfg.max_grad_norm,
        mu_dtype=cfg.adam_mu_dtype, nu_dtype=cfg.adam_nu_dtype,
        accumulation_steps=cfg.gradient_accumulation_steps)


def make_fused_optimizer(cfg: TrainConfig, total_steps: int) -> FusedAdamW:
    """The JAX ``make_fused_optimizer``: :class:`FusedAdamW` from the same
    config fields; gradient accumulation raises, as in JAX."""
    if cfg.gradient_accumulation_steps > 1:
        raise ValueError("fused_optimizer does not support gradient "
                         "accumulation; use the optax path")
    return FusedAdamW(
        linear_warmup_decay(cfg.learning_rate, total_steps,
                            cfg.warmup_proportion),
        weight_decay=cfg.weight_decay, max_grad_norm=cfg.max_grad_norm,
        mu_dtype=cfg.adam_mu_dtype, nu_dtype=cfg.adam_nu_dtype)
