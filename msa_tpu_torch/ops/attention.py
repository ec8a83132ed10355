"""Multi-head attention: dispatch between the CUDA kernels and plain PyTorch.

Counterpart of ``msa_tpu/ops/attention.py::multi_head_attention``, keyed on
the tensor's device instead of ``on_tpu`` (:func:`attention_route`):

  * CUDA, ``use_flash="auto"``: the short-attention kernels
    (``ops/short_attention.py``) for S < 1024, the blockwise flash2 kernels
    (``ops/flash2.py``) from S = 1024, JAX's ``_FLASH_MIN_SEQ``.  JAX hands
    512 < S < 1024 to XLA's plain attention here (its short kernel stops at
    512); the port's short kernels take that range, since a kernel beats
    the plain path on the card;
  * CUDA, ``use_flash="always"``: short for S <= 512, flash2 above, JAX's
    own ``always`` split;
  * ``use_flash="never"``, or CPU tensors: the plain path.  Dropout there
    is a bernoulli mask at the unsnapped rate, like ``_xla_attention``
    (what JAX does off the TPU).

Both kernel families take attention dropout inside the kernels, at the rate
snapped to t/256 (as JAX snaps it for its kernels), with one mask rule.
Dropout is active when ``deterministic`` is False, ``dropout_rate`` > 0 and
a ``seed`` is given; the seed keys the kernels' Philox mask, or seeds the
generator of the plain path's bernoulli draw.

Two remat rungs pick other kernels on the ``short`` route only, as JAX
dispatches its v2s / v2p entries only where its short kernel runs:
``stash_probs=True`` (``+probs``) takes ``short_attention_probs``, and
:func:`packed_attention` (``save_pack``) ``short_attention_packed``.  On
the flash2 and plain routes both behave as their base.
"""

from __future__ import annotations

from typing import Optional

import torch

from .dropout import quantize_dropout_rate, seeded_generator
from .flash2 import flash_attention2
from .short_attention import (short_attention, short_attention_packed,
                              short_attention_plain, short_attention_probs)

USE_FLASH = ("auto", "always", "never")
FLASH_MIN_SEQ = 1024        # "auto": flash2 from here (JAX's _FLASH_MIN_SEQ)
ALWAYS_SHORT_MAX_SEQ = 512  # "always": short up to here (JAX's _SHORT_MAX_SEQ)


def attention_route(use_flash: str, seq: int, on_cuda: bool) -> str:
    """Which attention runs: "short", "flash2" or "plain"."""
    if use_flash not in USE_FLASH:
        raise ValueError(f"use_flash must be one of {USE_FLASH}, "
                         f"got {use_flash!r}")
    if use_flash == "never" or not on_cuda:
        return "plain"
    if use_flash == "always":
        return "short" if seq <= ALWAYS_SHORT_MAX_SEQ else "flash2"
    return "short" if seq < FLASH_MIN_SEQ else "flash2"


def _plain_with_dropout(q, k, v, key_bias, num_heads, rate, seed):
    b, s, _ = q.shape
    keep = torch.empty((b, num_heads, s, s), device=q.device).bernoulli_(
        1.0 - rate, generator=seeded_generator(seed, q.device)).bool()
    return short_attention_plain(q, k, v, key_bias, num_heads, rate, keep)


def multi_head_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         bias: torch.Tensor, *, num_heads: int,
                         dropout_rate: float = 0.0, seed: Optional[int] = None,
                         deterministic: bool = True,
                         use_flash: str = "auto", stash_probs: bool = False,
                         recompute=None) -> torch.Tensor:
    """q/k/v [B, S, H], bias [B, 1, 1, S] additive key mask -> [B, S, H].

    ``stash_probs``: the ``+probs`` kernels on the short route.
    ``recompute``: on a kernel route, a callable giving (q, k, v) back in
    the backward instead of saving them (``ops/short_attention.py``); the
    plain route ignores it."""
    route = attention_route(use_flash, q.shape[1], q.is_cuda)
    key_bias = bias[:, 0, 0, :]
    dropout = (not deterministic) and dropout_rate > 0.0 and seed is not None
    if route == "plain":
        if dropout:
            return _plain_with_dropout(q, k, v, key_bias, num_heads,
                                       dropout_rate, seed)
        return short_attention_plain(q, k, v, key_bias, num_heads)
    if route == "flash2":
        kernel = flash_attention2
    else:
        kernel = short_attention_probs if stash_probs else short_attention
    rate = quantize_dropout_rate(dropout_rate) if dropout else 0.0
    return kernel(q, k, v, key_bias, num_heads, rate,
                  seed if dropout else None, recompute=recompute)


def packed_attention(qkv: torch.Tensor, bias: torch.Tensor, *,
                     num_heads: int, dropout_rate: float = 0.0,
                     seed: Optional[int] = None,
                     deterministic: bool = True) -> torch.Tensor:
    """The short route's packed attention (``save_pack``): qkv [B, S, 3H]
    (q|k|v thirds), bias [B, 1, 1, S] -> [B, S, H] by
    ``short_attention_packed``, whose gradient of ``qkv`` is one
    [B, S, 3H] tensor.  The caller has checked that the route is short."""
    dropout = (not deterministic) and dropout_rate > 0.0 and seed is not None
    return short_attention_packed(
        qkv, bias[:, 0, 0, :], num_heads,
        quantize_dropout_rate(dropout_rate) if dropout else 0.0,
        seed if dropout else None)
