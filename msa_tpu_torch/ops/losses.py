"""Loss primitives (all reductions weighted), in plain PyTorch.

Counterpart of ``msa_tpu/ops/losses.py``: cross entropy with ignore index
-100, MSE and the CPC InfoNCE term.  Every reduction takes an optional
per-example weight so a zero-padded final batch contributes nothing.

Under data parallelism (``dp``, a ``parallel.distributed.DataParallel``)
each rank holds some rows of the global batch and returns its share of the
global loss: its own sum over the group's count (a mean of the ranks'
means would be wrong wherever their counts differ), and InfoNCE scores its
queries against every rank's keys.  The shares add up to the loss of the
global batch, as JAX's traced-global shapes give it.

Under tensor parallelism (``mp``, a ``parallel.distributed.ModelParallel``)
the tied MLM decoder's logits are split over the vocabulary, and
:func:`cross_entropy` is vocabulary-parallel: the row max, the sum of
exponentials and the target logit are reduced over the model group
(GSPMD's reduction of JAX's logsumexp over the vocab-sharded logits); the
gradient is the shard's softmax minus the shard's one-hot.  The means stay
over the data group only.
"""

from __future__ import annotations

from typing import Optional

import torch

IGNORE_INDEX = -100


def _safe_mean(total: torch.Tensor, denom: torch.Tensor, dp=None
               ) -> torch.Tensor:
    if dp is not None:
        denom = dp.sum(denom)
    return total / torch.clamp(denom, min=1e-9)


class _VocabParallelCE(torch.autograd.Function):
    """lse - target logit of each row of vocabulary-split f32 ``logits``
    [N, C / mp]; ``target`` [N] global ids (any id where the row is
    ignored).  The backward is (softmax - one-hot) of the shard."""

    @staticmethod
    def forward(ctx, logits, target, mp):
        width = logits.shape[-1]
        row_max = mp.max(logits.detach().amax(-1))
        shifted = logits - row_max[:, None]
        exp = shifted.exp()
        total = mp.all_reduce(exp.sum(-1))
        local = target - mp.index * width
        inside = (local >= 0) & (local < width)
        local = torch.where(inside, local, 0)
        picked = torch.gather(shifted, -1, local[:, None])[:, 0]
        picked = mp.all_reduce(torch.where(inside, picked, 0.0))
        ctx.save_for_backward(exp.div_(total[:, None]), local, inside)
        return total.log() - picked

    @staticmethod
    def backward(ctx, grad):
        softmax, local, inside = ctx.saved_tensors
        onehot = torch.zeros_like(softmax).scatter_(
            -1, local[:, None], inside[:, None].to(softmax.dtype))
        return (softmax - onehot) * grad[:, None], None, None


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  weights: Optional[torch.Tensor] = None,
                  ignore_index: int = IGNORE_INDEX, dp=None,
                  mp=None) -> torch.Tensor:
    """Mean CE over positions where ``labels != ignore_index``.

    ``logits``: [..., C] (any leading shape), ``labels``: [...] int.  An
    all-ignored batch yields 0 instead of NaN.  ``mp``: the logits are the
    rank's vocabulary columns [..., C / mp] of a model group's.
    """
    logits = logits.float()
    valid = (labels != ignore_index).float()
    if mp is None:
        safe = labels.long().clamp(0, logits.shape[-1] - 1)
        lse = torch.logsumexp(logits, dim=-1)
        picked = torch.gather(logits, -1, safe[..., None])[..., 0]
        per_pos = (lse - picked) * valid
    else:
        safe = labels.long().clamp(0, logits.shape[-1] * mp.size - 1)
        per_pos = _VocabParallelCE.apply(
            logits.reshape(-1, logits.shape[-1]), safe.reshape(-1),
            mp).reshape(labels.shape) * valid
    if weights is not None:
        w = weights.float().reshape(
            weights.shape + (1,) * (per_pos.dim() - weights.dim()))
        per_pos = per_pos * w
        valid = valid * w
    return _safe_mean(per_pos.sum(), valid.sum(), dp)


def mse(preds: torch.Tensor, targets: torch.Tensor,
        weights: Optional[torch.Tensor] = None, dp=None) -> torch.Tensor:
    """Weighted mean squared error over flat views."""
    sq = (preds.float().reshape(-1) - targets.float().reshape(-1)) ** 2
    if weights is None:
        if dp is None:
            return sq.mean()
        weights = torch.ones_like(sq)
    w = weights.float().reshape(-1)
    return _safe_mean((sq * w).sum(), w.sum(), dp)


def infonce(x: torch.Tensor, x_pred: torch.Tensor,
            weights: Optional[torch.Tensor] = None,
            eps: float = 1e-12, dp=None) -> torch.Tensor:
    """CPC InfoNCE term: rows L2-normalised, then
    ``-mean(pos - logsumexp_j(x @ x_pred^T))``; zero-weight (padding) rows
    are excluded from the mean and from the negative set.  Under ``dp`` the
    negatives are every rank's rows (gathered, with their weights)."""
    x = x.float()
    x_pred = x_pred.float()
    x = x / torch.clamp(torch.linalg.vector_norm(x, dim=1, keepdim=True),
                        min=eps)
    x_pred = x_pred / torch.clamp(
        torch.linalg.vector_norm(x_pred, dim=1, keepdim=True), min=eps)
    pos = (x * x_pred).sum(-1)
    keys = x_pred if dp is None else dp.gather(x_pred)
    scores = x @ keys.T  # [B, B] (under dp [local B, global B])
    if weights is not None:
        w = weights.float().reshape(-1)
        w_keys = w if dp is None else dp.gather(w)
        scores = torch.where(w_keys[None, :] > 0, scores, -torch.inf)
        per = (pos - torch.logsumexp(scores, dim=-1)) * w
        return -_safe_mean(per.sum(), w.sum(), dp)
    per = pos - torch.logsumexp(scores, dim=-1)
    if dp is None:
        return -per.mean()
    return -_safe_mean(per.sum(), torch.full_like(per.sum(), per.numel()), dp)
