"""Whole-sequence attention for short sequences: hand-written CUDA kernels.

Counterpart of ``msa_tpu/ops/short_attention.py::short_attention_v2``: the
forward (TPU kernel ``_fwd_kernel_v2``) with in-kernel attention-probs
dropout, and its backward (``_bwd_kernel_v2``), which recomputes the
softmax and the dropout mask and writes dq, dk and dv.  Same contract as
the JAX entry: q, k, v and the returned ctx are [B, S, H] in natural layout
(heads are sliced inside the kernels), ``key_bias`` is an additive [B, S]
f32 mask, the softmax runs in f32, no gradient flows to the bias or the
seed.  The kernels (``csrc/short_attention.cu``) take float32 and bfloat16,
S < 1024 and head dim 64 (bert-base and bert-large); the source's header
says what bounds them on the H100 and how they are laid out.  JAX hands
512 < S < 1024 to XLA under ``use_flash="auto"``; here these kernels take
it (``ops/attention.py`` routes), and S >= 1024 goes to the blockwise
flash2 kernels (``ops/flash2.py``).

Dropout takes a rate snapped to t/256 and a 64-bit seed; the keep mask is
the function of (seed, element index) that ``ops/dropout.py`` defines, so
the forward, the backward and :func:`dropout_keep_mask` agree.

Entry points, each launching its kernel for CUDA tensors (or raising):

* :func:`short_attention` -- the forward; under autograd on CUDA it is a
  ``torch.autograd.Function`` whose backward is
  :func:`short_attention_backward` (two launches: dq, then dk/dv).  CPU
  tensors run :func:`short_attention_plain` at rate 0;
* :func:`dropout_keep_mask` -- the [B, heads, S, S] keep mask for a seed
  (plain version: ``ops.dropout.keep_mask_plain``).

``short_attention.launches``, ``short_attention_backward.launches`` and
``dropout_keep_mask.launches`` count kernel launches.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from .. import _build
from .dropout import byte_threshold

MAX_SEQ = 1023
HEAD_DIM = 64
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_P = ctypes.c_void_p
_I = ctypes.c_int
_U = ctypes.c_uint
_F = ctypes.c_float
_SIGNATURES = {
    "msa_short_attention_fwd": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                                _I, _F, _U, _U, _I, _P),
    "msa_short_attention_bwd": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                                _I, _I, _I, _I, _I, _F, _U, _U, _I, _P),
    "msa_dropout_keep_mask": (_P, _I, _I, _I, _U, _U, _I, _P),
}


def short_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          key_bias: torch.Tensor, num_heads: int,
                          rate: float = 0.0,
                          keep: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The plain PyTorch version of :func:`short_attention` (same contract),
    differentiable by ordinary autograd.

    Mirrors ``_xla_attention``: scores and softmax in f32; with ``keep`` (a
    [B, heads, S, S] bool mask) the kept probabilities are divided by
    ``1 - rate`` and the rest zeroed; the probabilities are cast to the
    input dtype for the PV product.
    """
    b, s, h = q.shape
    d = h // num_heads
    split = lambda x: x.reshape(b, s, num_heads, d)  # noqa: E731
    scores = torch.einsum("bqnd,bknd->bnqk", split(q).float(),
                          split(k).float())
    scores = scores / math.sqrt(d) + key_bias.float()[:, None, None, :]
    probs = torch.softmax(scores, dim=-1)
    if keep is not None:
        probs = torch.where(keep, probs / (1.0 - rate), 0.0)
    ctx = torch.einsum("bnqk,bknd->bqnd", probs.to(q.dtype), split(v))
    return ctx.reshape(b, s, h)


def _check(q, k, v, key_bias, num_heads, what, max_seq=MAX_SEQ):
    """Raise unless q, k, v and key_bias fit the attention kernels (the
    flash2 wrappers share it with ``max_seq=None``)."""
    if q.device.type != "cuda":
        raise ValueError(f"{what}: no kernel for device {q.device}")
    b, s, h = q.shape
    if q.dtype not in _DTYPES:
        raise TypeError(f"{what}: dtype {q.dtype} not supported "
                        "(float32 or bfloat16)")
    if h % num_heads or h // num_heads != HEAD_DIM:
        raise ValueError(f"{what}: head dim {h / num_heads:g} not supported "
                         f"(the kernels take {HEAD_DIM})")
    if max_seq is not None and s > max_seq:
        raise ValueError(f"{what}: S={s} > {max_seq}")
    for name, x in (("k", k), ("v", v)):
        if x.shape != q.shape or x.dtype != q.dtype or x.device != q.device:
            raise ValueError(f"{what}: {name} {tuple(x.shape)} {x.dtype} "
                             f"{x.device} does not match q")
    if key_bias.shape != (b, s) or key_bias.device != q.device:
        raise ValueError(f"{what}: key_bias {tuple(key_bias.shape)} on "
                         f"{key_bias.device}, want ({b}, {s}) on {q.device}")


def _aligned(*xs, what="short_attention"):
    out = [x.contiguous() for x in xs]
    for x in out:
        if x.data_ptr() % 16:
            raise ValueError(f"{what}: tensors must be 16-byte aligned")
    return out


def _seed_words(seed: int):
    return seed & 0xFFFFFFFF, (seed >> 32) & 0xFFFFFFFF


def _stream(x):
    return torch.cuda.current_stream(x.device).cuda_stream


def launch_forward(entry, what, q, k, v, key_bias, num_heads, seed,
                   threshold, train):
    """Launch an attention forward kernel through its C ``entry`` (the
    short and the flash2 forwards share one signature); returns (ctx, lse,
    ctx32).  ``train``: also the row lse [B, heads, S] (log2 units) and the
    output in f32 (``ctx`` itself for f32 inputs), which the backward
    reads; else both are None."""
    b, s, h = q.shape
    q, k, v = _aligned(q, k, v, what=what)
    key_bias = key_bias.to(torch.float32).contiguous()
    out = torch.empty_like(q)
    lse = out32 = None
    if train:
        lse = torch.empty((b, num_heads, s), dtype=torch.float32,
                          device=q.device)
        out32 = out if q.dtype == torch.float32 else torch.empty(
            q.shape, dtype=torch.float32, device=q.device)
    code = entry(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), key_bias.data_ptr(),
        out.data_ptr(), None if lse is None else lse.data_ptr(),
        None if out32 is None or out32 is out else out32.data_ptr(), b, s, h,
        num_heads, _DTYPES[q.dtype], 1.0 / math.sqrt(HEAD_DIM),
        *_seed_words(seed), threshold, _stream(q))
    _build.check(code, what)
    return out, lse, out32


def _forward_kernel(q, k, v, key_bias, num_heads, seed, threshold, train):
    """The short forward kernel (:func:`launch_forward`)."""
    lib = _build.load("short_attention", _SIGNATURES)
    result = launch_forward(lib.msa_short_attention_fwd, "short_attention",
                            q, k, v, key_bias, num_heads, seed, threshold,
                            train)
    short_attention.launches += 1
    return result


def short_attention_backward(q, k, v, key_bias, out32, lse, dout,
                             num_heads: int, seed: int = 0,
                             rate: float = 0.0) -> Tuple[torch.Tensor, ...]:
    """dq, dk, dv of :func:`short_attention` (CUDA only): ``out32`` (the
    output in f32) and ``lse`` are the training forward's outputs for the
    same inputs, seed and rate.  Two launches, dq then dk/dv; no [S, S]
    tensor is stored."""
    _check(q, k, v, key_bias, num_heads, "short_attention_backward")
    b, s, h = q.shape
    threshold = byte_threshold(rate)
    if out32.shape != q.shape or out32.dtype != torch.float32 or \
            dout.shape != q.shape or lse.shape != (b, num_heads, s):
        raise ValueError("short_attention_backward: out32/dout/lse "
                         f"{tuple(out32.shape)} {out32.dtype}, "
                         f"{tuple(dout.shape)}, {tuple(lse.shape)} do not fit "
                         f"q {tuple(q.shape)}")
    q, k, v, out32, dout = _aligned(q, k, v, out32, dout.to(q.dtype))
    key_bias = key_bias.to(torch.float32).contiguous()
    lse = lse.contiguous()
    delta = torch.empty_like(lse)
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    lib = _build.load("short_attention", _SIGNATURES)
    code = lib.msa_short_attention_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), key_bias.data_ptr(),
        out32.data_ptr(), dout.data_ptr(), lse.data_ptr(), delta.data_ptr(),
        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, s, h, num_heads,
        _DTYPES[q.dtype], 1.0 / math.sqrt(HEAD_DIM), *_seed_words(seed),
        threshold, _stream(q))
    _build.check(code, "short_attention_backward")
    short_attention_backward.launches += 2
    return dq, dk, dv


class _ShortAttention(torch.autograd.Function):
    """Forward kernel + backward kernel pair.  Saves q, k, v, the bias, the
    output (in f32) and the row lse -- the seed and rate ride as Python
    numbers -- as ``_v2_fwd`` saves its residuals; no gradient for the bias
    or seed."""

    @staticmethod
    def forward(ctx, q, k, v, key_bias, num_heads, seed, rate):
        out, lse, out32 = _forward_kernel(q, k, v, key_bias, num_heads, seed,
                                          byte_threshold(rate), train=True)
        ctx.save_for_backward(q, k, v, key_bias, out32, lse)
        ctx.args = (num_heads, seed, rate)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, key_bias, out32, lse = ctx.saved_tensors
        num_heads, seed, rate = ctx.args
        dq, dk, dv = short_attention_backward(q, k, v, key_bias, out32, lse,
                                              dout, num_heads, seed, rate)
        return dq, dk, dv, None, None, None, None


def short_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    key_bias: torch.Tensor, num_heads: int,
                    rate: float = 0.0, seed: Optional[int] = None
                    ) -> torch.Tensor:
    """q/k/v: [B, S, H]; key_bias: [B, S] additive mask.  Returns ctx [B, S, H].

    ``rate``: attention-probs dropout, a multiple of 1/256
    (``ops.dropout.quantize_dropout_rate``), with ``seed`` (an int in
    [0, 2**62)).  CUDA tensors launch the kernels (or raise): the forward
    alone when no gradient is needed, else the autograd pair.  CPU tensors
    take the plain version, at rate 0 only: dropout off the card is
    ``multi_head_attention``'s bernoulli mask, and the kernels' mask is
    ``short_attention_plain`` given ``ops.dropout.keep_mask_plain``.
    """
    if rate > 0.0 and seed is None:
        raise ValueError("short_attention: dropout needs a seed")
    threshold = byte_threshold(rate)
    if q.device.type == "cpu":
        if threshold:
            raise ValueError(
                "short_attention: in-kernel dropout needs CUDA tensors; on the "
                "CPU give short_attention_plain a keep mask")
        return short_attention_plain(q, k, v, key_bias, num_heads)
    _check(q, k, v, key_bias, num_heads, "short_attention")
    seed = 0 if seed is None else int(seed)
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        return _ShortAttention.apply(q, k, v, key_bias, num_heads, seed, rate)
    return _forward_kernel(q, k, v, key_bias, num_heads, seed, threshold,
                           train=False)[0]


def dropout_keep_mask(seed: int, rate: float, batch: int, num_heads: int,
                      seq: int, device) -> torch.Tensor:
    """The kernels' attention keep mask, [B, heads, S, S] bool, for ``seed``
    and a rate snapped to t/256, exported by a CUDA kernel on a CUDA
    device.  Its plain version is :func:`ops.dropout.keep_mask_plain`."""
    device = torch.device(device)
    threshold = byte_threshold(rate)
    if threshold == 0:
        raise ValueError("dropout_keep_mask: rate must be > 0")
    if device.type != "cuda":
        raise ValueError(f"dropout_keep_mask: no kernel for device {device}; "
                         "keep_mask_plain is the plain version")
    out = torch.empty((batch, num_heads, seq, seq), dtype=torch.uint8,
                      device=device)
    lib = _build.load("short_attention", _SIGNATURES)
    code = lib.msa_dropout_keep_mask(
        out.data_ptr(), batch, num_heads, seq, *_seed_words(int(seed)),
        threshold, torch.cuda.current_stream(device).cuda_stream)
    _build.check(code, "dropout_keep_mask")
    dropout_keep_mask.launches += 1
    return out.bool()


short_attention.launches = 0
short_attention_backward.launches = 0
dropout_keep_mask.launches = 0
