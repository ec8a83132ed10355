"""Dropout rules of the port: the t/256 rate snap, the attention keep mask
and hidden dropout.

Counterpart of ``quantize_dropout_rate`` / ``_byte_threshold``
(``msa_tpu/ops/short_attention.py``) and of ``_dropout``
(``msa_tpu/models/bert.py``).

* **Attention dropout in the kernels** takes any rate in [0, 1).  The keep
  decision of element (b, head, i, j) of the [B, heads, S, S]
  probabilities is a function of that index, the seed and the rate alone
  (:func:`keep_mask_plain`, the CUDA kernels' rule in plain PyTorch), with
  Philox4x32-10 keyed by the 64-bit seed and row ``(b * heads + head) * S
  + i``:

  - the byte rule, for a rate on the t/256 grid (the model paths snap to
    it): counter ``(j // 16, row, 0, 0)``; byte ``j % 16`` of the four
    32-bit outputs (little-endian within each word) decides key j, keep
    iff byte >= t; kept probabilities scaled by 256 / (256 - t);
  - the word rule, for any other rate (JAX's ``_keep_mask`` fallback):
    counter ``(j // 4, row, 1, 0)`` (the third word 1, so that its stream
    never meets the byte rule's); word ``j % 4`` decides key j, keep iff
    word >= ``min(floor(rate * 2**32), 2**32 - 1)``; kept probabilities
    scaled by 1 / (1 - rate) in f32.

  The TPU's PRNG cannot be reproduced, so the masks differ from JAX's; the
  distributions (keep share 1 - t/256 with four decisions per 32-bit draw,
  or 1 - rate to 2**-32 with one) are the same.
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


def check_rate(rate: float, what: str = "dropout") -> float:
    """``rate`` as a float, raising unless it lies in [0, 1) (the attention
    kernels take any such rate)."""
    rate = float(rate)
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"{what}: dropout rate {rate} outside [0, 1)")
    return rate


def on_grid(rate: float) -> bool:
    """Whether ``rate`` (in [0, 1)) is 0 or a multiple of 1/256, the rates
    the byte rule draws; any other rate draws by the word rule."""
    t = rate * DROP_QUANT
    return t == int(t)


def word_threshold(rate: float) -> int:
    """The word rule's 32-bit threshold of ``rate``: keep iff a Philox word
    >= min(floor(rate * 2**32), 2**32 - 1) (JAX's ``_keep_mask``)."""
    return min(int(rate * 2 ** 32), _U32)


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
    PyTorch (the plain version of the CUDA mask-export entry): the byte
    rule for a rate on the t/256 grid, else the word rule."""
    rate = check_rate(rate, "keep_mask_plain")
    rows = torch.arange(batch * num_heads * seq, dtype=torch.int64,
                        device=device)
    per_draw = 16 if on_grid(rate) else 4  # keys one Philox draw decides
    groups = -(-seq // per_draw)
    grp = torch.arange(groups, dtype=torch.int64, device=device)
    c0 = grp[None, :].expand(rows.numel(), groups)
    c1 = rows[:, None].expand(rows.numel(), groups)
    zero = torch.zeros_like(c0)
    stream = zero if per_draw == 16 else torch.ones_like(c0)
    words = torch.stack(philox4x32_10(c0, c1, stream, zero, seed, seed >> 32),
                        dim=-1)                  # [rows, groups, 4]
    if per_draw == 16:
        shifts = torch.arange(0, 32, 8, dtype=torch.int64, device=device)
        draws = (words[..., None] >> shifts) & 0xFF   # [rows, groups, 4, 4]
        threshold = byte_threshold(rate)
    else:
        draws = words
        threshold = word_threshold(rate)
    keep = draws.reshape(rows.numel(), groups * per_draw)[:, :seq] >= threshold
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
