"""Dropout rules of the port: the t/256 rate snap, the attention keep mask
and hidden dropout.

Counterpart of ``quantize_dropout_rate`` / ``_byte_threshold``
(``msa_tpu/ops/short_attention.py``) and of ``_dropout``
(``msa_tpu/models/bert.py``).

* **Attention dropout on the kernel path** uses the rate snapped to t/256.
  The keep decision of element (b, head, i, j) of the [B, heads, S, S]
  probabilities is a function of that index and the seed alone
  (:func:`keep_mask_plain`, the CUDA kernels' rule in plain PyTorch):
  Philox4x32-10 keyed by the 64-bit seed, counter ``(j // 16, (b * heads +
  head) * S + i, 0, 0)``; byte ``j % 16`` of its four 32-bit outputs
  (little-endian within each word) decides key j, keep iff byte >= t.
  Kept probabilities are scaled by 256 / (256 - t) = 1 / (1 - rate).  The
  TPU's PRNG cannot be reproduced, so the masks differ from JAX's; the
  distribution (keep share 1 - t/256, four decisions per 32-bit draw) is
  the same.
* **Hidden dropout** (:func:`dropout`) runs in plain PyTorch from the
  caller's ``torch.Generator``: at S >= 256 the uint8-threshold path (keep
  iff a random byte >= t, rescale 256 / (256 - t)), below it a bernoulli
  draw with the unsnapped rate, as JAX gates it.
"""

from __future__ import annotations

from typing import Optional

import torch

DROP_QUANT = 256
# hidden dropout takes the uint8-threshold path from this sequence length
# (msa_tpu/models/bert.py::_BITS_DROPOUT_MIN_SEQ)
BITS_DROPOUT_MIN_SEQ = 256
SEED_BITS = 62
SHARD_SEED_STRIDE = 1000003

_PHILOX_M = (0xD2511F53, 0xCD9E8D57)
_PHILOX_W = (0x9E3779B9, 0xBB67AE85)
_U32 = 0xFFFFFFFF


def quantize_dropout_rate(rate: float) -> float:
    """Snap ``rate`` to the nearest t/256 (1 <= t <= 255), 0 for rate <= 0."""
    if rate <= 0.0:
        return 0.0
    t = min(max(int(round(rate * DROP_QUANT)), 1), DROP_QUANT - 1)
    return t / DROP_QUANT


def byte_threshold(rate: float) -> int:
    """The byte threshold t of a rate snapped to t/256; 0 for rate 0."""
    if rate == 0.0:
        return 0
    t = int(round(rate * DROP_QUANT))
    if not (0 < t < DROP_QUANT and rate == t / DROP_QUANT):
        raise ValueError(f"dropout rate {rate} is not a multiple of 1/256 "
                         "(quantize_dropout_rate snaps it)")
    return t


def draw_seed(generator: torch.Generator) -> int:
    """A seed in [0, 2**62) from ``generator`` (a CPU generator: no device
    synchronisation)."""
    return int(torch.randint(0, 2 ** SEED_BITS, (1,), generator=generator,
                             dtype=torch.int64))


def shard_seed(seed: int, shard: int) -> int:
    """``seed`` for a rank's ``shard`` of the mesh: JAX's rule for its
    head-parallel attention, seed + shard * 1000003
    (``msa_tpu/ops/attention.py::_head_parallel``), kept in [0, 2**62).
    Shard 0 keeps the seed.  The attention sites take shard m + mp * d
    (model index m, data index d), as JAX's; the hidden sites d alone, so
    every rank of a model group draws the replicated stream's mask."""
    return (seed + shard * SHARD_SEED_STRIDE) % 2 ** SEED_BITS


def seeded_generator(seed: int, device) -> torch.Generator:
    """A generator on ``device`` seeded with ``seed``."""
    return torch.Generator(device=device).manual_seed(int(seed))


def _mulhilo(m: int, c: torch.Tensor):
    """(hi, lo) 32-bit halves of m * c for u32 values held in int64, without
    overflowing int64: c is split into 16-bit halves."""
    a = m * (c & 0xFFFF)            # < 2**48
    b = m * (c >> 16)               # < 2**48
    t = a + ((b & 0xFFFF) << 16)    # < 2**49
    return (b >> 16) + (t >> 32), t & _U32


def philox4x32_10(c0, c1, c2, c3, key0: int, key1: int):
    """Philox4x32-10 on counters (c0, c1, c2, c3) (int64 tensors holding u32
    values) with key (key0, key1).  Returns the four u32 outputs."""
    k0, k1 = key0 & _U32, key1 & _U32
    for r in range(10):
        if r > 0:
            k0 = (k0 + _PHILOX_W[0]) & _U32
            k1 = (k1 + _PHILOX_W[1]) & _U32
        hi0, lo0 = _mulhilo(_PHILOX_M[0], c0)
        hi1, lo1 = _mulhilo(_PHILOX_M[1], c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def keep_mask_plain(seed: int, rate: float, batch: int, num_heads: int,
                    seq: int, device="cpu") -> torch.Tensor:
    """The attention kernels' keep mask, [B, heads, S, S] bool, in plain
    PyTorch (the plain version of the CUDA mask-export entry)."""
    t = byte_threshold(rate)
    groups = -(-seq // 16)
    rows = torch.arange(batch * num_heads * seq, dtype=torch.int64,
                        device=device)
    grp = torch.arange(groups, dtype=torch.int64, device=device)
    c0 = grp[None, :].expand(rows.numel(), groups)
    c1 = rows[:, None].expand(rows.numel(), groups)
    zero = torch.zeros_like(c0)
    words = torch.stack(philox4x32_10(c0, c1, zero, zero, seed, seed >> 32),
                        dim=-1)
    shifts = torch.arange(0, 32, 8, dtype=torch.int64, device=device)
    byte = (words[..., None] >> shifts) & 0xFF   # [rows, groups, 4, 4]
    keep = byte.reshape(rows.numel(), groups * 16)[:, :seq] >= t
    return keep.reshape(batch, num_heads, seq, seq)


def dropout_mask(shape, rate: float, generator: torch.Generator,
                 device) -> torch.Tensor:
    """The keep mask (bool) of hidden dropout on a tensor of ``shape``,
    drawn from ``generator`` (on ``device``) as :func:`dropout` draws it:
    random bytes against the t/256 threshold for [..., S, H] with S >= 256,
    else a bernoulli draw at the unsnapped rate."""
    if len(shape) >= 3 and shape[-2] >= BITS_DROPOUT_MIN_SEQ:
        t = byte_threshold(quantize_dropout_rate(rate))
        return torch.randint(0, DROP_QUANT, shape, generator=generator,
                             device=device, dtype=torch.uint8) >= t
    return torch.empty(shape, device=device).bernoulli_(
        1.0 - rate, generator=generator).bool()


def apply_dropout_mask(x: torch.Tensor, keep: torch.Tensor, rate: float,
                       seq: Optional[int] = None) -> torch.Tensor:
    """``x`` with :func:`dropout_mask`'s ``keep`` applied: kept values
    rescaled by 256 / (256 - t) on the byte rule, 1 / (1 - rate) else.
    The rule follows ``seq``, the sequence length the mask was drawn for
    (default: ``x``'s own; a sequence-parallel shard passes the full one)."""
    seq = x.shape[-2] if seq is None else seq
    if x.dim() >= 3 and seq >= BITS_DROPOUT_MIN_SEQ:
        t = byte_threshold(quantize_dropout_rate(rate))
        return torch.where(keep, x * (DROP_QUANT / (DROP_QUANT - t)),
                           0.0).to(x.dtype)
    return torch.where(keep, x / (1.0 - rate), 0.0).to(x.dtype)


def dropout(x: torch.Tensor, rate: float,
            generator: torch.Generator) -> torch.Tensor:
    """Hidden dropout (``_dropout`` of the JAX package), drawing only from
    ``generator`` (on ``x``'s device).  Identity at rate 0."""
    if rate == 0.0:
        return x
    return apply_dropout_mask(
        x, dropout_mask(x.shape, rate, generator, x.device), rate)
