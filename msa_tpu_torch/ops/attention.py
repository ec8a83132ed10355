"""Multi-head attention: dispatch between the CUDA kernel and plain PyTorch.

Counterpart of ``msa_tpu/ops/attention.py::multi_head_attention`` for the
deterministic path, keyed on the tensor's device instead of ``on_tpu``:

  * CUDA, S < 1024: the short-attention kernel (``ops/short_attention.py``);
  * CUDA, S >= 1024: ``NotImplementedError`` -- the blockwise flash2 kernel
    is not ported yet (ROADMAP, frame-level slice);
  * CPU: the plain path;
  * ``use_flash="never"``: the plain path on every device, as in JAX.
"""

from __future__ import annotations

import torch

from .short_attention import MAX_SEQ as SHORT_MAX_SEQ
from .short_attention import short_attention, short_attention_plain

USE_FLASH = ("auto", "always", "never")


def multi_head_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         bias: torch.Tensor, *, num_heads: int,
                         use_flash: str = "auto") -> torch.Tensor:
    """q/k/v [B, S, H], bias [B, 1, 1, S] additive key mask -> [B, S, H]."""
    if use_flash not in USE_FLASH:
        raise ValueError(f"use_flash must be one of {USE_FLASH}, "
                         f"got {use_flash!r}")
    key_bias = bias[:, 0, 0, :]
    if use_flash == "never":
        return short_attention_plain(q, k, v, key_bias, num_heads)
    if q.is_cuda and q.shape[1] > SHORT_MAX_SEQ:
        raise NotImplementedError(
            f"attention at S={q.shape[1]} > {SHORT_MAX_SEQ} needs the flash2 "
            "kernel, which is not ported yet (ROADMAP: frame-level slice); "
            "use_flash='never' runs the plain path")
    return short_attention(q, k, v, key_bias, num_heads)
