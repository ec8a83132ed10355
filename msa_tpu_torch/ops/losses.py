"""Loss primitives (all reductions weighted), in plain PyTorch.

Counterpart of ``msa_tpu/ops/losses.py``: cross entropy with ignore index
-100, MSE and the CPC InfoNCE term.  Every reduction takes an optional
per-example weight so a zero-padded final batch contributes nothing.
"""

from __future__ import annotations

from typing import Optional

import torch

IGNORE_INDEX = -100


def _safe_mean(total: torch.Tensor, denom: torch.Tensor) -> torch.Tensor:
    return total / torch.clamp(denom, min=1e-9)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  weights: Optional[torch.Tensor] = None,
                  ignore_index: int = IGNORE_INDEX) -> torch.Tensor:
    """Mean CE over positions where ``labels != ignore_index``.

    ``logits``: [..., C] (any leading shape), ``labels``: [...] int.  An
    all-ignored batch yields 0 instead of NaN.
    """
    logits = logits.float()
    valid = (labels != ignore_index).float()
    safe = labels.long().clamp(0, logits.shape[-1] - 1)
    lse = torch.logsumexp(logits, dim=-1)
    picked = torch.gather(logits, -1, safe[..., None])[..., 0]
    per_pos = (lse - picked) * valid
    if weights is not None:
        w = weights.float().reshape(
            weights.shape + (1,) * (per_pos.dim() - weights.dim()))
        per_pos = per_pos * w
        valid = valid * w
    return _safe_mean(per_pos.sum(), valid.sum())


def mse(preds: torch.Tensor, targets: torch.Tensor,
        weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Weighted mean squared error over flat views."""
    sq = (preds.float().reshape(-1) - targets.float().reshape(-1)) ** 2
    if weights is None:
        return sq.mean()
    w = weights.float().reshape(-1)
    return _safe_mean((sq * w).sum(), w.sum())


def infonce(x: torch.Tensor, x_pred: torch.Tensor,
            weights: Optional[torch.Tensor] = None,
            eps: float = 1e-12) -> torch.Tensor:
    """CPC InfoNCE term: rows L2-normalised, then
    ``-mean(pos - logsumexp_j(x @ x_pred^T))``; zero-weight (padding) rows
    are excluded from the mean and from the negative set."""
    x = x.float()
    x_pred = x_pred.float()
    x = x / torch.clamp(torch.linalg.vector_norm(x, dim=1, keepdim=True),
                        min=eps)
    x_pred = x_pred / torch.clamp(
        torch.linalg.vector_norm(x_pred, dim=1, keepdim=True), min=eps)
    pos = (x * x_pred).sum(-1)
    scores = x @ x_pred.T  # [B, B]
    if weights is not None:
        w = weights.float().reshape(-1)
        scores = torch.where(w[None, :] > 0, scores, -torch.inf)
        per = (pos - torch.logsumexp(scores, dim=-1)) * w
        return -_safe_mean(per.sum(), w.sum())
    return -(pos - torch.logsumexp(scores, dim=-1)).mean()
