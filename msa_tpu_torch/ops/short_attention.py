"""Whole-sequence attention for short sequences: a hand-written CUDA kernel.

Counterpart of ``msa_tpu/ops/short_attention.py::short_attention_v2``
(TPU kernel ``_fwd_kernel_v2``), forward only and without dropout -- the
serving path runs it deterministic.  Same contract as the JAX entry: q, k, v
and the returned ctx are [B, S, H] in natural layout (heads are sliced
inside the kernel), ``key_bias`` is an additive [B, S] f32 mask, the softmax
runs in f32.  The kernel (``csrc/short_attention.cu``) takes float32 and
bfloat16, S < 1024 and head dim 64 (bert-base and bert-large); its header
says what bounds it on the H100 and how it is laid out.  JAX hands
512 < S < 1024 to XLA; here the kernel covers it, as it streams keys in
tiles and splits queries into tiles.  S >= 1024 is the blockwise flash2
kernel's range, not ported yet.

:func:`short_attention` launches the kernel for CUDA tensors and runs
:func:`short_attention_plain` for CPU tensors; nothing else.
"""

from __future__ import annotations

import ctypes
import math

import torch

from .. import _build

MAX_SEQ = 1023
HEAD_DIM = 64
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "msa_short_attention_fwd": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                ctypes.c_float, _P),
}


def short_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          key_bias: torch.Tensor,
                          num_heads: int) -> torch.Tensor:
    """The plain PyTorch version of :func:`short_attention` (same contract).

    Mirrors ``_xla_attention`` (deterministic): scores and softmax in f32,
    the probabilities cast to the input dtype for the PV product.
    """
    b, s, h = q.shape
    d = h // num_heads
    split = lambda x: x.reshape(b, s, num_heads, d)  # noqa: E731
    scores = torch.einsum("bqnd,bknd->bnqk", split(q).float(),
                          split(k).float())
    scores = scores / math.sqrt(d) + key_bias.float()[:, None, None, :]
    probs = torch.softmax(scores, dim=-1)
    ctx = torch.einsum("bnqk,bknd->bqnd", probs.to(q.dtype), split(v))
    return ctx.reshape(b, s, h)


def short_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    key_bias: torch.Tensor, num_heads: int) -> torch.Tensor:
    """q/k/v: [B, S, H]; key_bias: [B, S] additive mask.  Returns ctx [B, S, H].

    CUDA tensors launch the kernel (or raise); CPU tensors take the plain
    version.  ``short_attention.launches`` counts kernel launches.
    """
    if q.device.type == "cpu":
        return short_attention_plain(q, k, v, key_bias, num_heads)
    if q.device.type != "cuda":
        raise ValueError(f"short_attention: no kernel for device {q.device}")
    b, s, h = q.shape
    if q.dtype not in _DTYPES:
        raise TypeError(f"short_attention: dtype {q.dtype} not supported "
                        "(float32 or bfloat16)")
    if h % num_heads or h // num_heads != HEAD_DIM:
        raise ValueError(f"short_attention: head dim {h / num_heads:g} "
                         f"not supported (the kernel takes {HEAD_DIM})")
    if s > MAX_SEQ:
        raise ValueError(f"short_attention: S={s} > {MAX_SEQ}")
    for name, x in (("k", k), ("v", v)):
        if x.shape != q.shape or x.dtype != q.dtype or x.device != q.device:
            raise ValueError(f"short_attention: {name} {tuple(x.shape)} "
                             f"{x.dtype} {x.device} does not match q")
    if key_bias.shape != (b, s) or key_bias.device != q.device:
        raise ValueError(f"short_attention: key_bias {tuple(key_bias.shape)} "
                         f"on {key_bias.device}, want ({b}, {s}) on {q.device}")
    q, k, v = (x.contiguous() for x in (q, k, v))
    key_bias = key_bias.to(torch.float32).contiguous()
    for x in (q, k, v):
        if x.data_ptr() % 16:
            raise ValueError("short_attention: q/k/v must be 16-byte aligned")
    out = torch.empty_like(q)
    lib = _build.load("short_attention", _SIGNATURES)
    code = lib.msa_short_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), key_bias.data_ptr(),
        out.data_ptr(), b, s, h, num_heads, _DTYPES[q.dtype],
        1.0 / math.sqrt(HEAD_DIM), torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(code, "short_attention")
    short_attention.launches += 1
    return out


short_attention.launches = 0
