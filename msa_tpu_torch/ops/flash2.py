"""Blockwise attention for long sequences: hand-written CUDA kernels.

Counterpart of ``msa_tpu/ops/flash2.py::flash_attention2``, the attention
of the frame-level path (S >= 1024): the forward (TPU kernel
``_fwd_kernel``) with in-kernel attention-probs dropout, and its backward,
either the fused single sweep (``_bwd_fused_kernel``) or the split pair
(``_dq_kernel`` then ``_dkv_kernel``), chosen by JAX's own rule
(:func:`use_fused_backward`).  Same contract as the JAX entry: q, k, v and
the returned ctx are [B, S, H] in natural layout (heads are sliced inside
the kernels), ``key_bias`` is an additive [B, S] f32 mask, the softmax runs
in f32, no gradient flows to the bias or the seed, and the dropout rate is
any rate in [0, 1) (the model paths snap it to t/256).  The kernels (``csrc/flash2.cu``) take float32 and
bfloat16, any S >= 1 and any integer head dim from 1 to 256 (the libraries
of head dim 16, 32, 64, 128 and 256; any other runs zero-padded on the
next one up, ``short_attention.HeadPad``); the source's header says what
bounds them on the H100 and how they are laid out.  bf16 runs on the tensor
cores: the forward and the split pair on ``wgmma`` at every head dim, the
fused backward on ``mma.sync`` up to 128 and on ``wgmma`` at 256; f32 on
the CUDA cores (at 256 the short-attention kernels,
``short_attention.wide_f32``).

Dropout uses the rule of ``ops/dropout.py`` (Philox of the seed and the
element's index), the short-attention kernels' rule: at the same seed both
kernel families draw the same mask.

Entry points, each launching its kernels for CUDA tensors (or raising):

* :func:`flash_attention2` -- the forward; under autograd on CUDA it is a
  ``torch.autograd.Function`` whose backward is
  :func:`flash_attention2_backward`.  CPU tensors run
  :func:`flash_attention2_plain` at rate 0;
* :func:`flash_attention2_backward` -- dq, dk, dv by the fused route
  (:func:`flash2_bwd_fused`, a delta pre-pass and one sweep) or the split pair
  (:func:`flash2_bwd_split`, two launches), both by JAX's rule with its
  roundings, whose plain version is :func:`flash_attention2_backward_plain`.

``flash_attention2.launches``, ``flash2_bwd_fused.launches`` and
``flash2_bwd_split.launches`` count kernel launches.  f32 above head dim 128
launches none of this module's kernels: its calls count on
``short_attention.launches`` and ``short_attention_v3_backward.launches``,
whose kernels run.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from .. import _build
from ..configs import _round_up
from .dropout import check_rate
from .short_attention import (
    _DTYPES,
    HeadPad,
    _aligned,
    _check,
    _forward_kernel as _short_forward_kernel,
    _seed_words,
    _stream,
    launch_forward,
    save_inputs,
    saved_inputs,
    short_attention_plain,
    wide_f32,
    wide_f32_backward,
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_U = ctypes.c_uint
_F = ctypes.c_float
_D = ctypes.c_double
_SIGNATURES = {
    "msa_flash2_fwd": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F,
                       _U, _U, _D, _P),
    "msa_flash2_bwd_fused": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I,
                             _I, _I, _I, _I, _F, _U, _U, _D, _P),
    "msa_flash2_bwd_split": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I,
                             _I, _I, _I, _I, _F, _U, _U, _D, _P),
}

# JAX's fused-backward budget and the block arithmetic it is computed from
# (msa_tpu/ops/flash2.py:73-111, 584-596), copied so that both packages
# take the same backward route at every shape.
_BQ, _BK = 256, 1024
_LANE_GROUP = 128
FUSED_BWD_BUDGET = 14 * 1024 * 1024


def _pick_block(s: int, pref: int) -> int:
    """Largest block <= pref that adds no padding beyond the 128 round-up."""
    s128 = _round_up(s, 128)
    b = min(pref, s128)
    while b > 128 and s128 % b:
        b //= 2
    return b if s128 % b == 0 else 128


def _blocks_for(s: int, bq_pref: int = _BQ, bk_pref: int = _BK):
    """JAX's (bq, bk) for sequence length s: bk capped at 512 from S=2048."""
    if s >= 2048:
        bk_pref = min(bk_pref, 512)
    return _pick_block(s, bq_pref), _pick_block(s, bk_pref)


def use_fused_backward(s: int, hidden: int, num_heads: int,
                       dtype: torch.dtype) -> bool:
    """Whether the backward at sequence length ``s`` takes the fused kernel,
    by the JAX package's rule: its fused program's estimated footprint
    (bands, accumulators and live f32 tiles at its TPU block sizes) under
    14 MiB.  That threshold is a TPU VMEM budget and means nothing on the
    H100, whose kernels run either route at any S; it is kept so that both
    packages take the same route (bf16 at d=64: fused at S=1024 and 2048,
    split at 4096; f32 split from S=1024)."""
    d = hidden // num_heads
    hpg = min(num_heads, max(1, _LANE_GROUP // d))
    while num_heads % hpg:
        hpg -= 1
    gw = hpg * d
    itemsize = torch.empty((), dtype=dtype).element_size()
    bq, bk = _blocks_for(s)
    sq, sk = _round_up(s, bq), _round_up(s, bk)
    fused_bytes = ((4 * sq + 4 * sk) * gw * itemsize + sq * gw * 4
                   + 2 * hpg * bk * gw * 4 + 4 * bq * hpg * bk * 4)
    return fused_bytes < FUSED_BWD_BUDGET


def flash_attention2_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           key_bias: torch.Tensor, num_heads: int,
                           rate: float = 0.0,
                           keep: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The plain PyTorch version of :func:`flash_attention2` (same
    contract), differentiable by ordinary autograd.  Blockwise attention
    computes the same function as whole-sequence attention, so this is
    ``short_attention_plain``'s math: scores and softmax in f32, ``keep``
    (a [B, heads, S, S] bool mask) zeroes and rescales by 1 / (1 - rate),
    the probabilities are cast to the input dtype for the PV product."""
    return short_attention_plain(q, k, v, key_bias, num_heads, rate, keep)


def flash_attention2_backward_plain(q, k, v, key_bias, out, lse, dout,
                                    num_heads: int, rate: float = 0.0,
                                    keep: Optional[torch.Tensor] = None):
    """dq, dk, dv of :func:`flash_attention2_plain` by JAX's flash2 backward
    rule (``_dq_kernel``, ``_dkv_kernel``, ``_bwd_fused_kernel``), in f32:
    p = exp2(s2 - lse) from the forward's row ``lse`` in log2 units (s2 the
    scores times log2 e), delta = rowsum(dO * o) from ``out`` (the output
    the backward reads: the kernels' f32 out32) and the unscaled dO.  With
    ``keep`` (a [B, heads, S, S] bool mask) dO * (1 / (1 - rate)) is rounded
    to q's dtype before dP = dO V^T and dV = pd^T dO, the factor too (JAX
    multiplies dO by a weakly typed Python float, which takes dO's dtype:
    1.109375 in bf16 at rate 26/256), and pd is the kept p unscaled; dS = p
    * (dpm - delta).  pd and dS are rounded to q's dtype before their
    products, as those kernels round them (nothing changes in f32)."""
    b, s, h = q.shape
    d = h // num_heads
    split = lambda x: x.reshape(b, s, num_heads, d).float()  # noqa: E731
    logits = torch.einsum("bqnd,bknd->bnqk", split(q), split(k)) / math.sqrt(d)
    logits = logits + key_bias.float()[:, None, None, :]
    p = torch.exp2(logits / math.log(2.0) - lse[..., None])
    do = split(dout)
    delta = (do * split(out)).sum(-1).transpose(1, 2)[..., None]
    if keep is not None:
        fold = torch.tensor(1.0 / (1.0 - rate), dtype=q.dtype).item()
        do = split((dout.float() * fold).to(q.dtype))
    dp = torch.einsum("bqnd,bknd->bnqk", do, split(v))
    pd, dpm = p, dp
    if keep is not None:
        pd, dpm = torch.where(keep, p, 0.0), torch.where(keep, dp, 0.0)
    ds = (p * (dpm - delta)).to(q.dtype).float()
    pd = pd.to(q.dtype).float()
    scale = 1.0 / math.sqrt(d)
    dq = torch.einsum("bnqk,bknd->bqnd", ds, split(k)) * scale
    dk = torch.einsum("bnqk,bqnd->bknd", ds, split(q)) * scale
    dv = torch.einsum("bnqk,bqnd->bknd", pd, do)
    return tuple(x.reshape(b, s, h).to(q.dtype) for x in (dq, dk, dv))


def _forward_kernel(q, k, v, key_bias, num_heads, seed, rate, train):
    """The flash2 forward kernel (``short_attention.launch_forward``: the
    two forwards share one C signature, flash2's with the f32 output its
    backward reads); returns (ctx, lse, ctx32).  f32 at a head dim above
    128 runs the short-attention CUDA-core forward (``wide_f32``, counted
    there), whose ctx is the f32 output."""
    if wide_f32(q.dtype, q.shape[2] // num_heads):
        ctx, lse = _short_forward_kernel(q, k, v, key_bias, num_heads, seed,
                                         rate, train)
        return ctx, lse, ctx if train else None
    result = launch_forward("flash2", _SIGNATURES, "msa_flash2_fwd",
                            "flash_attention2", q, k, v, key_bias, num_heads,
                            seed, rate, train, out32=True)
    flash_attention2.launches += 1
    return result


def _backward_args(q, k, v, key_bias, out32, lse, dout, num_heads, what):
    """The backward's inputs checked, each head padded to the library's
    head dim (``pad``, a :class:`HeadPad`, is the last item)."""
    _check(q, k, v, key_bias, num_heads, what, max_seq=None)
    b, s, h = q.shape
    if out32.shape != q.shape or out32.dtype != torch.float32 or \
            dout.shape != q.shape or lse.shape != (b, num_heads, s):
        raise ValueError(f"{what}: out32/dout/lse {tuple(out32.shape)} "
                         f"{out32.dtype}, {tuple(dout.shape)}, "
                         f"{tuple(lse.shape)} do not fit q {tuple(q.shape)}")
    pad = HeadPad(h, num_heads)
    q, k, v, out32, dout = _aligned(
        *map(pad.pad, (q, k, v, out32, dout.to(q.dtype))), what=what)
    return (q, k, v, key_bias.to(torch.float32).contiguous(), out32, dout,
            lse.contiguous(), pad)


def delta_scratch(lse: torch.Tensor) -> torch.Tensor:
    """delta = rowsum(dO o), [B, heads, S] f32 like ``lse``, left unset: the
    scratch that the split pair's dq launch (or the fused route's pre-pass)
    writes and its second launch reads."""
    return torch.empty_like(lse)


def fused_scratch(q: torch.Tensor, lse: torch.Tensor):
    """The fused route's scratch, left unset: :func:`delta_scratch`, which
    its pre-pass writes, and the f32 dq buffer [B, S, H], which the
    pre-pass zeroes and the sweep's atomics sum into."""
    return (delta_scratch(lse),
            torch.empty(q.shape, dtype=torch.float32, device=q.device))


def flash2_bwd_fused(q, k, v, key_bias, out32, lse, dout, num_heads: int,
                     seed: int = 0, rate: float = 0.0
                     ) -> Tuple[torch.Tensor, ...]:
    """dq, dk, dv of :func:`flash_attention2` by the fused route (CUDA
    only, two launches: a pre-pass writing delta = rowsum(dO o) and zeroing
    an f32 dq buffer, then the sweep): ``out32`` (the output in f32) and
    ``lse`` are the training forward's outputs for the same inputs, seed
    and rate.  dq is summed by f32 atomics into that buffer, then cast.
    f32 above head dim 128: the short-attention CUDA-core pair
    (:func:`_wide_backward`)."""
    if wide_f32(q.dtype, q.shape[2] // num_heads):
        return _wide_backward(q, k, v, key_bias, out32, lse, dout, num_heads,
                              seed, rate, "flash2_bwd_fused")
    q, k, v, key_bias, out32, dout, lse, pad = _backward_args(
        q, k, v, key_bias, out32, lse, dout, num_heads, "flash2_bwd_fused")
    b, s, h = q.shape
    delta, dq32 = fused_scratch(q, lse)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    code = pad.library("flash2", _SIGNATURES).msa_flash2_bwd_fused(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), key_bias.data_ptr(),
        out32.data_ptr(), dout.data_ptr(), lse.data_ptr(), delta.data_ptr(),
        dq32.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, s, h, num_heads,
        _DTYPES[q.dtype], pad.scale, *_seed_words(seed),
        check_rate(rate), _stream(q))
    _build.check(code, "flash2_bwd_fused")
    flash2_bwd_fused.launches += 2
    return tuple(map(pad.cut, (dq32.to(q.dtype), dk, dv)))


def flash2_bwd_split(q, k, v, key_bias, out32, lse, dout, num_heads: int,
                     seed: int = 0, rate: float = 0.0
                     ) -> Tuple[torch.Tensor, ...]:
    """dq, dk, dv of :func:`flash_attention2` by the split pair (CUDA only,
    two launches: dq, which writes delta = rowsum(dO o), then dk/dv; bf16
    on the warpgroup kernels at every head dim, f32 above head dim 128 the
    short-attention CUDA-core pair, :func:`_wide_backward`)."""
    if wide_f32(q.dtype, q.shape[2] // num_heads):
        return _wide_backward(q, k, v, key_bias, out32, lse, dout, num_heads,
                              seed, rate, "flash2_bwd_split")
    q, k, v, key_bias, out32, dout, lse, pad = _backward_args(
        q, k, v, key_bias, out32, lse, dout, num_heads, "flash2_bwd_split")
    b, s, h = q.shape
    delta = delta_scratch(lse)
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    code = pad.library("flash2", _SIGNATURES).msa_flash2_bwd_split(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), key_bias.data_ptr(),
        out32.data_ptr(), dout.data_ptr(), lse.data_ptr(), delta.data_ptr(),
        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, s, h, num_heads,
        _DTYPES[q.dtype], pad.scale, *_seed_words(seed),
        check_rate(rate), _stream(q))
    _build.check(code, "flash2_bwd_split")
    flash2_bwd_split.launches += 2
    return tuple(map(pad.cut, (dq, dk, dv)))


def _wide_backward(q, k, v, key_bias, out32, lse, dout, num_heads, seed,
                   rate, what):
    """Either route's gradients for ``wide_f32`` inputs, one code for both:
    the short-attention v3 pair (counted there), whose f32 rule is flash2's
    (delta from the f32 output; the lse recomputed, so ``lse`` is only
    checked)."""
    _backward_args(q, k, v, key_bias, out32, lse, dout, num_heads, what)
    return wide_f32_backward(q, k, v, key_bias, out32, dout, num_heads, seed,
                             rate, what)


def flash_attention2_backward(q, k, v, key_bias, out32, lse, dout,
                              num_heads: int, seed: int = 0, rate: float = 0.0,
                              fused: Optional[bool] = None
                              ) -> Tuple[torch.Tensor, ...]:
    """dq, dk, dv of :func:`flash_attention2` (CUDA only).  ``fused``: None
    takes the JAX package's route (:func:`use_fused_backward`); True or
    False forces one kernel (the counterpart of JAX's ``_FUSED_BWD`` A/B
    switch)."""
    if fused is None:
        fused = use_fused_backward(q.shape[1], q.shape[2], num_heads, q.dtype)
    run = flash2_bwd_fused if fused else flash2_bwd_split
    return run(q, k, v, key_bias, out32, lse, dout, num_heads, seed, rate)


class _FlashAttention2(torch.autograd.Function):
    """Forward kernel + backward kernel(s).  Saves q, k, v, the bias, the
    output (in f32) and the row lse, as ``_flash2_fwd`` saves its residuals;
    no gradient for the bias or seed."""

    @staticmethod
    def forward(ctx, q, k, v, key_bias, num_heads, seed, rate, recompute):
        out, lse, out32 = _forward_kernel(q, k, v, key_bias, num_heads, seed,
                                          check_rate(rate), train=True)
        save_inputs(ctx, recompute, q, k, v, key_bias, out32, lse)
        ctx.args = (num_heads, seed, rate)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, key_bias, out32, lse = saved_inputs(ctx)
        num_heads, seed, rate = ctx.args
        dq, dk, dv = flash_attention2_backward(q, k, v, key_bias, out32, lse,
                                               dout, num_heads, seed, rate)
        return dq, dk, dv, None, None, None, None, None


def flash_attention2(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     key_bias: torch.Tensor, num_heads: int,
                     rate: float = 0.0, seed: Optional[int] = None,
                     recompute=None) -> torch.Tensor:
    """q/k/v: [B, S, H]; key_bias: [B, S] additive mask.  Returns ctx [B, S, H].

    ``rate``: attention-probs dropout, any rate in [0, 1) (the model paths
    snap it with ``ops.dropout.quantize_dropout_rate``), with ``seed`` (an int in
    [0, 2**62)).  CUDA tensors launch the kernels (or raise): the forward
    alone when no gradient is needed, else the autograd pair.  CPU tensors
    take the plain version, at rate 0 only: dropout off the card is
    ``multi_head_attention``'s bernoulli mask.  ``recompute``: a callable
    giving (q, k, v) back in the backward instead of saving them
    (``ops/short_attention.py``).
    """
    if rate > 0.0 and seed is None:
        raise ValueError("flash_attention2: dropout needs a seed")
    rate = check_rate(rate)
    if q.device.type == "cpu":
        if rate:
            raise ValueError(
                "flash_attention2: in-kernel dropout needs CUDA tensors; on "
                "the CPU give flash_attention2_plain a keep mask")
        return flash_attention2_plain(q, k, v, key_bias, num_heads)
    _check(q, k, v, key_bias, num_heads, "flash_attention2", max_seq=None)
    seed = 0 if seed is None else int(seed)
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        return _FlashAttention2.apply(q, k, v, key_bias, num_heads, seed, rate,
                                      recompute)
    return _forward_kernel(q, k, v, key_bias, num_heads, seed, rate,
                           train=False)[0]


flash_attention2.launches = 0
flash2_bwd_fused.launches = 0
flash2_bwd_split.launches = 0
