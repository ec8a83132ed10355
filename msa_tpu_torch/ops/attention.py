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
  * on the long route (``"flash2"`` above), the module switch
    :data:`USE_FLASH2` (JAX's ``_USE_FLASH2``, read at call time) picks the
    kernel: True (the default, as in JAX) flash2 in the natural layout,
    False the head-split flash attention of this module
    (:func:`flash_attention`, JAX's ``_flash_attention``) between the head
    transposes JAX puts around it;
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

The head-split flash attention (kernel row 13, ``csrc/flash_attention.cu``;
TPU kernels ``_flash_kernel``, ``_flash_dq_kernel``, ``_flash_dkv_kernel``
of ``msa_tpu/ops/attention.py``) lives here, where JAX keeps it:

* :func:`flash_attention` -- q, k, v [B, heads, S, d] (d = 32 or 64) and a
  [B, S] f32 key bias; under autograd on CUDA a ``torch.autograd.Function``
  whose backward is :func:`flash_attention_backward` (two launches, dq then
  dk/dv).  It
  saves q, k, v, the bias, the output in its dtype and the row lse
  (natural-log units; flash2's is in log2 units, and the two are never
  mixed).  CPU tensors run :func:`flash_attention_plain` at rate 0, with
  :func:`flash_attention_backward_plain` under autograd.
``flash_attention.launches`` and ``flash_attention_backward.launches``
count kernel launches.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from .. import _build
from .dropout import byte_threshold, quantize_dropout_rate, seeded_generator
from .flash2 import delta_scratch, flash_attention2
from .short_attention import (_DTYPES, _aligned, _seed_words, _stream,
                              check_head_dim, save_inputs, saved_inputs,
                              short_attention,
                              short_attention_packed, short_attention_plain,
                              short_attention_probs)

USE_FLASH = ("auto", "always", "never")
FLASH_MIN_SEQ = 1024        # "auto": flash2 from here (JAX's _FLASH_MIN_SEQ)
ALWAYS_SHORT_MAX_SEQ = 512  # "always": short up to here (JAX's _SHORT_MAX_SEQ)
# JAX's _USE_FLASH2: the long route takes flash2 (True) or the head-split
# flash_attention (False).  Read at each call; tests and chip_smoke.py flip
# it as JAX's A/B flips its own.
USE_FLASH2 = True

_P = ctypes.c_void_p
_I = ctypes.c_int
_U = ctypes.c_uint
_F = ctypes.c_float
_SIGNATURES = {
    "msa_flash_attention_fwd": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                _F, _U, _U, _I, _P),
    "msa_flash_attention_bwd": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                                _I, _I, _I, _I, _I, _F, _U, _U, _I, _P),
}


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
    rate = quantize_dropout_rate(dropout_rate) if dropout else 0.0
    seed = seed if dropout else None
    if route == "flash2" and not USE_FLASH2:
        return _head_split_flash(q, k, v, key_bias, num_heads, rate, seed,
                                 recompute)
    if route == "flash2":
        kernel = flash_attention2
    else:
        kernel = short_attention_probs if stash_probs else short_attention
    return kernel(q, k, v, key_bias, num_heads, rate, seed,
                  recompute=recompute)


def _head_split_flash(q, k, v, key_bias, num_heads, rate, seed, recompute):
    """JAX's long route with ``_USE_FLASH2`` False: [B, S, H] split into
    [B, heads, S, d], :func:`flash_attention`, heads merged back.  A
    ``recompute`` callable gives [B, S, H] q, k, v; they are split again in
    the backward."""
    b, s, h = q.shape

    def split(x):
        return x.reshape(b, s, num_heads, h // num_heads).transpose(1, 2) \
            .contiguous()

    rec = None if recompute is None else (
        lambda: tuple(split(x) for x in recompute()))
    out = flash_attention(split(q), split(k), split(v), key_bias, rate, seed,
                          recompute=rec)
    return out.transpose(1, 2).reshape(b, s, h)


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


# ---------------------------------------------------------------------------
# The head-split flash attention (kernel row 13)
# ---------------------------------------------------------------------------


def _scores_heads(q, k, key_bias):
    """f32 scores [B, heads, S, S] of head-split q, k and a [B, S] bias."""
    scores = torch.einsum("bnqd,bnkd->bnqk", q.float(), k.float())
    return scores / math.sqrt(q.shape[-1]) + key_bias.float()[:, None, None, :]


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          key_bias: torch.Tensor, rate: float = 0.0,
                          keep: Optional[torch.Tensor] = None,
                          with_lse: bool = False):
    """The plain PyTorch version of :func:`flash_attention` (same contract),
    differentiable by ordinary autograd: scores and softmax in f32, ``keep``
    (a [B, heads, S, S] bool mask) zeroes and rescales by 1 / (1 - rate),
    the probabilities are cast to the input dtype for the PV product.
    ``with_lse``: also the row logsumexp [B, heads, S] f32 in natural-log
    units (JAX's ``_flash_forward_dispatch(..., with_lse=True)``)."""
    scores = _scores_heads(q, k, key_bias)
    probs = torch.softmax(scores, dim=-1)
    if keep is not None:
        probs = torch.where(keep, probs / (1.0 - rate), 0.0)
    out = torch.einsum("bnqk,bnkd->bnqd", probs.to(q.dtype), v)
    if with_lse:
        return out, torch.logsumexp(scores, dim=-1)
    return out


def flash_attention_backward_plain(q, k, v, key_bias, out, lse, dout,
                                   rate: float = 0.0,
                                   keep: Optional[torch.Tensor] = None):
    """dq, dk, dv of :func:`flash_attention_plain` by JAX's
    ``_flash_dq_kernel`` / ``_flash_dkv_kernel`` rule, in f32: p = exp(s -
    lse) from the saved natural-log ``lse``, dP = dO.V^T, with ``keep`` dpm
    the kept dP over ``1 - rate`` and pd the kept p unscaled, delta =
    rowsum(dO * o) from ``out`` (the forward's output in its own dtype,
    widened), dS = p * (dpm - delta).  pd and dS are rounded to q's dtype
    before their products, as those kernels round them (``.astype``) for
    the matrix unit and the CUDA kernels for the tensor cores (nothing
    changes in f32); dV = pd^T dO is then divided by ``1 - rate`` in f32
    (``_flash_dkv_kernel``, ``attention.py:242-244``)."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    p = torch.exp(_scores_heads(q, k, key_bias) - lse[..., None])
    do = dout.float()
    dp = torch.einsum("bnqd,bnkd->bnqk", do, v.float())
    pd, dpm = p, dp
    if keep is not None:
        pd = torch.where(keep, p, 0.0)
        dpm = torch.where(keep, dp, 0.0) / (1.0 - rate)
    delta = (do * out.float()).sum(-1, keepdim=True)
    ds = (p * (dpm - delta)).to(q.dtype).float()
    pd = pd.to(q.dtype).float()
    dq = torch.einsum("bnqk,bnkd->bnqd", ds, k.float()) * scale
    dk = torch.einsum("bnqk,bnqd->bnkd", ds, q.float()) * scale
    dv = torch.einsum("bnqk,bnqd->bnkd", pd, do)
    if keep is not None:
        dv = dv / (1.0 - rate)
    return tuple(x.to(q.dtype) for x in (dq, dk, dv))


def _check_heads(q, k, v, key_bias, what):
    """Raise unless head-split q, k, v and key_bias (None: not checked) fit
    the kernels."""
    if q.device.type != "cuda":
        raise ValueError(f"{what}: no kernel for device {q.device}")
    if q.dim() != 4:
        raise ValueError(f"{what}: q {tuple(q.shape)} is not [B, heads, S, d]")
    b, n, s, d = q.shape
    if q.dtype not in _DTYPES:
        raise TypeError(f"{what}: dtype {q.dtype} not supported "
                        "(float32 or bfloat16)")
    check_head_dim(d, what)
    for name, x in (("k", k), ("v", v)):
        if x.shape != q.shape or x.dtype != q.dtype or x.device != q.device:
            raise ValueError(f"{what}: {name} {tuple(x.shape)} {x.dtype} "
                             f"{x.device} does not match q")
    if key_bias is not None and (key_bias.shape != (b, s)
                                 or key_bias.device != q.device):
        raise ValueError(f"{what}: key_bias {tuple(key_bias.shape)} on "
                         f"{key_bias.device}, want ({b}, {s}) on {q.device}")


def _forward_kernel(q, k, v, key_bias, seed, threshold, train):
    """The head-split forward kernel; returns (out, lse), lse [B, heads, S]
    f32 in natural-log units when ``train``, else None."""
    b, n, s, d = q.shape
    q, k, v = _aligned(q, k, v, what="flash_attention")
    key_bias = key_bias.to(torch.float32).contiguous()
    out = torch.empty_like(q)
    lse = (torch.empty((b, n, s), dtype=torch.float32, device=q.device)
           if train else None)
    lib = _build.load("flash_attention", _SIGNATURES)
    code = lib.msa_flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), key_bias.data_ptr(),
        out.data_ptr(), None if lse is None else lse.data_ptr(), b, n, s, d,
        _DTYPES[q.dtype], 1.0 / math.sqrt(d), *_seed_words(seed), threshold,
        _stream(q))
    _build.check(code, "flash_attention")
    flash_attention.launches += 1
    return out, lse


def flash_attention_backward(q, k, v, key_bias, out, lse, dout, seed: int = 0,
                             rate: float = 0.0) -> Tuple[torch.Tensor, ...]:
    """dq, dk, dv of :func:`flash_attention` (CUDA only): ``out`` (in q's
    dtype) and ``lse`` (natural-log units) are the training forward's
    outputs for the same inputs, seed and rate.  Two launches: dq, which
    writes delta = rowsum(dO * o) to scratch, then dk/dv."""
    _check_heads(q, k, v, key_bias, "flash_attention_backward")
    b, n, s, d = q.shape
    if out.shape != q.shape or out.dtype != q.dtype or \
            dout.shape != q.shape or lse.shape != (b, n, s):
        raise ValueError(f"flash_attention_backward: out/dout/lse "
                         f"{tuple(out.shape)} {out.dtype}, {tuple(dout.shape)}, "
                         f"{tuple(lse.shape)} do not fit q {tuple(q.shape)}")
    q, k, v, out, dout = _aligned(q, k, v, out, dout.to(q.dtype),
                                  what="flash_attention_backward")
    key_bias = key_bias.to(torch.float32).contiguous()
    lse = lse.contiguous()
    delta = delta_scratch(lse)
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    lib = _build.load("flash_attention", _SIGNATURES)
    code = lib.msa_flash_attention_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), key_bias.data_ptr(),
        out.data_ptr(), dout.data_ptr(), lse.data_ptr(), delta.data_ptr(),
        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, n, s, d,
        _DTYPES[q.dtype], 1.0 / math.sqrt(d), *_seed_words(seed),
        byte_threshold(rate), _stream(q))
    _build.check(code, "flash_attention_backward")
    flash_attention_backward.launches += 2
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    """Forward kernel + the dq / dk-dv pair.  Saves q, k, v, the bias, the
    output and the row lse, as ``_flash_fwd`` saves its residuals; no
    gradient for the bias or seed.  On CPU tensors (rate 0) the plain
    forward and the plain backward."""

    @staticmethod
    def forward(ctx, q, k, v, key_bias, seed, rate, recompute):
        if q.is_cuda:
            out, lse = _forward_kernel(q, k, v, key_bias, seed,
                                       byte_threshold(rate), train=True)
        else:
            out, lse = flash_attention_plain(q, k, v, key_bias, with_lse=True)
        save_inputs(ctx, recompute, q, k, v, key_bias, out, lse)
        ctx.args = (seed, rate)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, key_bias, out, lse = saved_inputs(ctx)
        seed, rate = ctx.args
        if q.is_cuda:
            grads = flash_attention_backward(q, k, v, key_bias, out, lse, dout,
                                             seed, rate)
        else:
            grads = flash_attention_backward_plain(q, k, v, key_bias, out, lse,
                                                   dout)
        return (*grads, None, None, None, None)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    key_bias: torch.Tensor, rate: float = 0.0,
                    seed: Optional[int] = None, recompute=None) -> torch.Tensor:
    """The counterpart of JAX's ``_flash_attention``: q/k/v [B, heads, S, d]
    (d = 32 or 64 on CUDA), key_bias [B, S] additive mask; returns [B,
    heads, S, d].  Any S >= 1.

    ``rate``: attention-probs dropout, a multiple of 1/256
    (``ops.dropout.quantize_dropout_rate``), with ``seed`` (an int in [0,
    2**62)); the mask is the one flash2 and the short kernels draw at that
    seed.  CUDA tensors launch the kernels (or raise): the forward alone
    when no gradient is needed, else the autograd pair.  CPU tensors take
    the plain versions, at rate 0 only.  ``recompute``: a callable giving
    (q, k, v) back in the backward instead of saving them
    (``ops/short_attention.py``)."""
    if rate > 0.0 and seed is None:
        raise ValueError("flash_attention: dropout needs a seed")
    threshold = byte_threshold(rate)
    if q.device.type == "cpu":
        if threshold:
            raise ValueError(
                "flash_attention: in-kernel dropout needs CUDA tensors; on "
                "the CPU give flash_attention_plain a keep mask")
    else:
        _check_heads(q, k, v, key_bias, "flash_attention")
    seed = 0 if seed is None else int(seed)
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        return _FlashAttention.apply(q, k, v, key_bias, seed, rate, recompute)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, key_bias)
    return _forward_kernel(q, k, v, key_bias, seed, threshold, train=False)[0]


flash_attention.launches = 0
flash_attention_backward.launches = 0
