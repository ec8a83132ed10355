"""Multi-head attention: dispatch between the CUDA kernels and plain PyTorch.

Counterpart of ``msa_tpu/ops/attention.py::multi_head_attention``, keyed on
the tensor's device instead of ``on_tpu``:

  * CUDA, S < 1024: the short-attention kernels (``ops/short_attention.py``),
    forward and backward, with attention dropout inside the kernels at the
    rate snapped to t/256 (as JAX snaps it for its kernel);
  * CUDA, S >= 1024: ``NotImplementedError`` -- the blockwise flash2
    kernels are not ported yet (ROADMAP, frame-level slice);
  * CPU: the plain path; dropout there is a bernoulli mask at the unsnapped
    rate, like ``_xla_attention`` (what JAX does off the TPU);
  * ``use_flash="never"``: the plain path on every device, as in JAX.

Dropout is active when ``deterministic`` is False, ``dropout_rate`` > 0 and
a ``seed`` is given; the seed keys the kernels' Philox mask, or seeds the
generator of the plain path's bernoulli draw.
"""

from __future__ import annotations

from typing import Optional

import torch

from .dropout import quantize_dropout_rate, seeded_generator
from .short_attention import MAX_SEQ as SHORT_MAX_SEQ
from .short_attention import short_attention, short_attention_plain

USE_FLASH = ("auto", "always", "never")


def _plain_with_dropout(q, k, v, key_bias, num_heads, rate, seed):
    b, s, _ = q.shape
    keep = torch.empty((b, num_heads, s, s), device=q.device).bernoulli_(
        1.0 - rate, generator=seeded_generator(seed, q.device)).bool()
    return short_attention_plain(q, k, v, key_bias, num_heads, rate, keep)


def multi_head_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         bias: torch.Tensor, *, num_heads: int,
                         dropout_rate: float = 0.0, seed: Optional[int] = None,
                         deterministic: bool = True,
                         use_flash: str = "auto") -> torch.Tensor:
    """q/k/v [B, S, H], bias [B, 1, 1, S] additive key mask -> [B, S, H]."""
    if use_flash not in USE_FLASH:
        raise ValueError(f"use_flash must be one of {USE_FLASH}, "
                         f"got {use_flash!r}")
    key_bias = bias[:, 0, 0, :]
    dropout = (not deterministic) and dropout_rate > 0.0 and seed is not None
    if use_flash == "never" or not q.is_cuda:
        if dropout:
            return _plain_with_dropout(q, k, v, key_bias, num_heads,
                                       dropout_rate, seed)
        return short_attention_plain(q, k, v, key_bias, num_heads)
    if q.shape[1] > SHORT_MAX_SEQ:
        raise NotImplementedError(
            f"attention at S={q.shape[1]} > {SHORT_MAX_SEQ} needs the flash2 "
            "kernel, which is not ported yet (ROADMAP: frame-level slice); "
            "use_flash='never' runs the plain path")
    if dropout:
        return short_attention(q, k, v, key_bias, num_heads,
                               quantize_dropout_rate(dropout_rate), seed)
    return short_attention(q, k, v, key_bias, num_heads)
