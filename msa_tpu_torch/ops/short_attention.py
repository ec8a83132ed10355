"""Whole-sequence attention for short sequences: hand-written CUDA kernels.

Counterpart of ``msa_tpu/ops/short_attention.py::short_attention_v2``: the
forward (TPU kernel ``_fwd_kernel_v2``) with in-kernel attention-probs
dropout, and its backward (``_bwd_kernel_v2``), which recomputes the
softmax and the dropout mask and writes dq, dk and dv.  Same contract as
the JAX entry: q, k, v and the returned ctx are [B, S, H] in natural layout
(heads are sliced inside the kernels), ``key_bias`` is an additive [B, S]
f32 mask, the softmax runs in f32, no gradient flows to the bias or the
seed.  The kernels (``csrc/short_attention.cu``) take float32 and bfloat16,
S < 1024 and any integer head dim from 1 to 256: each source is built
once a head dim of ``HEAD_DIMS`` (16, 32, 64, 128, 256), and a head dim
between runs on the smallest of them above it, its heads zero-padded to
that width on the way in and cut back on the way out (:class:`HeadPad`;
the scores keep the scale of the true head dim); the source's header says
what bounds them on the H100 and how they are laid out.  bf16 runs on the
tensor cores at every head dim; above 128 (the library of 256), where the
whole-row templates do not fit, every forward is the two-sweep ring and
every backward the tiled dq and dk/dv pair, at every S
(:func:`backward_route`).  JAX hands
512 < S < 1024 to XLA under ``use_flash="auto"``; here these kernels take
it (``ops/attention.py`` routes), and S >= 1024 goes to the blockwise
flash2 kernels (``ops/flash2.py``).

Dropout takes any rate in [0, 1) and a 64-bit seed; the keep mask is the
function of (seed, rate, element index) that ``ops/dropout.py`` defines
(the byte rule on the t/256 grid the model paths snap to, the word rule off
it), so the forward, the backward and :func:`dropout_keep_mask` agree.

Entry points, each launching its kernel for CUDA tensors (or raising):

* :func:`short_attention` -- the forward; under autograd on CUDA it is a
  ``torch.autograd.Function`` whose backward is
  :func:`short_attention_backward` (JAX's ``_bwd_kernel_v2`` rule), or,
  with the module switch ``USE_V3_BWD`` on (JAX's ``_USE_V3_BWD``,
  ``_bwd_kernel_v3``), :func:`short_attention_v3_backward`, which reads the
  ctx.  bf16 runs them on the tensor cores: one launch at S <= 128 (head
  dims up to 128), which
  recomputes the softmax, so the pair keeps q, k, v and the bias (v3 also
  the ctx); above, the tiled dq and dk/dv pair (``csrc/short_bwd_tiled.cuh``).
  f32 runs the dq and dk/dv pair on the CUDA cores.  v2's pairs read the
  row lse that its training forward writes and keeps
  (:func:`backward_route`).  CPU tensors run
  :func:`short_attention_plain` at rate 0 (under ``USE_V3_BWD`` with
  :func:`short_attention_v3_backward_plain` as its backward);
* :func:`short_attention_probs` -- the ``+probs`` remat rung (JAX
  ``short_attention_v2s``): under autograd the forward kernel also writes
  the signed probabilities (:func:`probs_width` says their layout) and the
  backward (:func:`short_attention_probs_backward`) reads them instead of
  recomputing scores, softmax and dropout.  Without gradient it is the
  plain forward kernel;
* :func:`short_attention_packed` -- the ``save_pack`` rung (JAX
  ``short_attention_v2p``): q, k, v as the thirds of one [B, S, 3H] tensor,
  read in place; the backward (:func:`short_attention_packed_backward`,
  JAX's ``_bwd_kernel_v2p``: the v3 rule on the ctx) writes one [B, S, 3H]
  gradient;
* :func:`dropout_keep_mask` -- the [B, heads, S, S] keep mask for a seed
  (plain version: ``ops.dropout.keep_mask_plain``);
* :func:`short_attention_v1` -- JAX's ``short_attention``, the v1 pair
  (``_fwd_kernel`` / ``_bwd_kernel``, ``csrc/short_attention_v1.cu`` up to
  128 keys, above them the v2 kernels' forms): the same function as
  :func:`short_attention`, but the pair keeps only its inputs.  The
  forward writes ctx alone and the backward
  (:func:`short_attention_v1_backward`) recomputes the softmax and takes
  delta = rowsum(p * dpm).  No model path calls it, as in JAX.

Each kernel entry has a plain version beside it (``*_plain``), which CPU
tensors run; the training forward's outputs (ctx and the row lse) have
theirs in :func:`short_attention_train_forward_plain`.  Every backward rule
rounds dS and the dropped p to the input dtype before their products, as
JAX's kernels do.  ``short_attention``,
``short_attention_probs`` and ``flash_attention2`` take ``recompute``: a
callable returning (q, k, v), called in the backward in place of saving q,
k and v (the ``save_ctx`` rung recomputes the projections, never the
attention forward).

``<entry>.launches`` counts each entry's kernel launches.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from .. import _build
from .dropout import check_rate

MAX_SEQ = 1023
HEAD_DIMS = _build.HEAD_DIMS  # every attention kernel is instantiated for these
MAX_HEAD_DIM = HEAD_DIMS[-1]
# The widest head dim of the whole-row templates (csrc/short_fwd_tc.cuh,
# short_bwd_tc.cuh) and of flash's f32 kernels: a library above it (256)
# runs bf16 short attention on the two-sweep forward and the tiled backward
# pair at every S, and f32 flash on this module's CUDA-core kernels
# (:func:`wide_f32`); bf16 flash there runs its forward, fused backward
# and split pair on wgmma.
WHOLE_ROW_MAX_HEAD_DIM = 128
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_P = ctypes.c_void_p
_I = ctypes.c_int
_U = ctypes.c_uint
_F = ctypes.c_float
_D = ctypes.c_double
_SIGNATURES = {
    "msa_short_attention_fwd": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                _F, _U, _U, _D, _P),
    "msa_short_attention_bwd": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I,
                                _I, _I, _I, _I, _F, _U, _U, _D, _P),
    "msa_short_attention_v3_bwd": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                                   _I, _I, _I, _I, _I, _F, _U, _U, _D, _P),
    "msa_short_attention_packed_fwd": (_P, _P, _P, _P, _I, _I, _I, _I, _I,
                                       _F, _U, _U, _D, _P),
    "msa_short_attention_packed_bwd": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                                       _I, _I, _F, _U, _U, _D, _P),
    "msa_short_attention_probs_fwd": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                                      _I, _F, _U, _U, _D, _P),
    "msa_short_attention_probs_bwd": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _I,
                                      _I, _I, _I, _I, _F, _D, _P),
    "msa_dropout_keep_mask": (_P, _I, _I, _I, _U, _U, _D, _P),
}
_V1_SIGNATURES = {
    "msa_short_attention_v1_fwd": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F,
                                   _U, _U, _D, _P),
    "msa_short_attention_v1_bwd": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                                   _I, _I, _F, _U, _U, _D, _P),
}
# csrc/short_attention_v1.cu holds a head's K and V in shared memory up to
# V1_WHOLE_ROW_SEQ keys and head dims up to V1_MAX_HEAD_DIM; above either,
# to MAX_SEQ and MAX_HEAD_DIM, v1 runs the v2 kernels' forms
V1_WHOLE_ROW_SEQ = 128
V1_MAX_HEAD_DIM = _build.source_head_dims("short_attention_v1")[-1]
# The bf16 v2, v2p, v3 and v2s backwards run on the tensor cores at every S
# the kernels take: in one launch up to WHOLE_ROW_BWD_MAX_SEQ at head dims
# up to WHOLE_ROW_MAX_HEAD_DIM (csrc/short_bwd_tc.cuh: a warp holds its
# whole score row in registers), otherwise as the tiled dq and dk/dv pair
# up to TC_BWD_MAX_SEQ (csrc/short_bwd_tiled.cuh).  f32 takes the CUDA-core
# pair.
WHOLE_ROW_BWD_MAX_SEQ = 128
TC_BWD_MAX_SEQ = MAX_SEQ
WHOLE_ROW, TILED, CUDA_CORES = "whole row", "tiled", "CUDA cores"
PROBS_GROUP = 16  # keys per Philox draw: the probs rows are padded to it
# JAX's module switch _USE_V3_BWD: the training forward keeps the ctx
# itself, and the backward is short_attention_v3_backward (delta = dO . o
# from the ctx in its own dtype, the lse recomputed).  Read when the
# forward runs; tests and chip_smoke.py flip it as JAX's test flips its
# own.
USE_V3_BWD = False


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
    probs = _scores_plain(q, k, key_bias, num_heads)
    if keep is not None:
        probs = torch.where(keep, probs / (1.0 - rate), 0.0)
    ctx = torch.einsum("bnqk,bknd->bqnd", probs.to(q.dtype),
                       v.reshape(b, s, num_heads, h // num_heads))
    return ctx.reshape(b, s, h)


def short_attention_train_forward_plain(
        q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
        key_bias: torch.Tensor, num_heads: int, rate: float = 0.0,
        keep: Optional[torch.Tensor] = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version of the training forward (:func:`launch_forward`
    with ``train``): (ctx, lse).

    Scores and softmax in f32; ``lse`` [B, heads, S] f32 is each row's log2
    of the sum of exp2 of its scores in the log2 domain (logsumexp / ln 2);
    ``ctx`` is the dropped probabilities (``keep`` a [B, heads, S, S] bool
    mask, kept p over ``1 - rate``) rounded to q's dtype times v, summed in
    f32 and rounded once to q's dtype, as JAX's ``_fwd_kernel_v2`` forms
    it.  The oracle of the kernels' training form; no model path calls it.
    """
    b, s, h = q.shape
    logits = _logits_plain(q, k, key_bias, num_heads)
    lse = torch.logsumexp(logits, dim=-1) / math.log(2.0)
    p = torch.softmax(logits, dim=-1)
    if keep is not None:
        p = torch.where(keep, p / (1.0 - rate), 0.0)
    ctx = torch.einsum("bnqk,bknd->bqnd", p.to(q.dtype).float(),
                       v.float().reshape(b, s, num_heads, h // num_heads))
    return ctx.reshape(b, s, h).to(q.dtype), lse


def _logits_plain(q, k, key_bias, num_heads):
    """f32 scores [B, heads, S, S] in natural units, the key bias added."""
    b, s, h = q.shape
    d = h // num_heads
    split = lambda x: x.reshape(b, s, num_heads, d)  # noqa: E731
    scores = torch.einsum("bqnd,bknd->bnqk", split(q).float(),
                          split(k).float())
    return scores / math.sqrt(d) + key_bias.float()[:, None, None, :]


def _scores_plain(q, k, key_bias, num_heads):
    """f32 softmax probabilities [B, heads, S, S] (``_xla_attention``)."""
    return torch.softmax(_logits_plain(q, k, key_bias, num_heads), dim=-1)


def _check(q, k, v, key_bias, num_heads, what, max_seq=MAX_SEQ):
    """Raise unless q, k, v and key_bias (None: not checked) fit the
    attention kernels (the flash2 wrappers share it with ``max_seq=None``)."""
    if q.device.type != "cuda":
        raise ValueError(f"{what}: no kernel for device {q.device}")
    b, s, h = q.shape
    if q.dtype not in _DTYPES:
        raise TypeError(f"{what}: dtype {q.dtype} not supported "
                        "(float32 or bfloat16)")
    check_head_dim(h / num_heads, what)
    if max_seq is not None and s > max_seq:
        raise ValueError(f"{what}: S={s} > {max_seq}")
    for name, x in (("k", k), ("v", v)):
        if x.shape != q.shape or x.dtype != q.dtype or x.device != q.device:
            raise ValueError(f"{what}: {name} {tuple(x.shape)} {x.dtype} "
                             f"{x.device} does not match q")
    if key_bias is not None and (key_bias.shape != (b, s)
                                 or key_bias.device != q.device):
        raise ValueError(f"{what}: key_bias {tuple(key_bias.shape)} on "
                         f"{key_bias.device}, want ({b}, {s}) on {q.device}")


def check_head_dim(d, what):
    """Raise unless ``d`` is a head dim the attention kernels take: an
    integer from 1 to ``MAX_HEAD_DIM``."""
    if not (float(d).is_integer() and 1 <= d <= MAX_HEAD_DIM):
        raise ValueError(f"{what}: head dim {d:g} not supported (the kernels "
                         f"take an integer head dim from 1 to {MAX_HEAD_DIM})")


def kernel_head_dim(d: int) -> int:
    """The instantiated head dim that head dim ``d`` runs on: the smallest
    of ``HEAD_DIMS`` at or above it."""
    return next(k for k in HEAD_DIMS if k >= d)


def softmax_scale(hidden: int, num_heads: int) -> float:
    """1 / sqrt(d), the scores' scale at head dim d = hidden / num_heads."""
    return 1.0 / math.sqrt(hidden // num_heads)


class HeadPad:
    """A head dim d on the kernels of ``kernel_head_dim(d)`` = kd: each
    head's d columns of a [B, S, heads * d] tensor widened to kd by zeros
    (:meth:`pad`), and cut back (:meth:`cut`).  The zero columns add
    exactly 0 to every score, every dP and delta, and the kernels write
    zeros there; the row lse, the stashed probs and the dropout mask index
    rows and keys, never columns, so they are untouched.  ``hidden`` is the
    width the kernels see, ``scale`` the softmax scale of the true d.  At d
    = kd both are the identity."""

    def __init__(self, hidden: int, num_heads: int):
        self.heads = num_heads
        self.d = hidden // num_heads
        self.kd = kernel_head_dim(self.d)
        self.hidden = num_heads * self.kd
        self.scale = softmax_scale(hidden, num_heads)

    def library(self, source, signatures):
        """``source``'s library at head dim kd."""
        return _build.load(_build.head_dim_library(source, self.kd),
                           signatures)

    def pad(self, x):
        if x is None or self.d == self.kd:
            return x
        b, s, _ = x.shape
        return F.pad(x.reshape(b, s, self.heads, self.d),
                     (0, self.kd - self.d)).reshape(b, s, self.hidden)

    def cut(self, x):
        if x is None or self.d == self.kd:
            return x
        b, s, _ = x.shape
        return x.reshape(b, s, self.heads, self.kd)[..., :self.d].reshape(
            b, s, self.heads * self.d)

    def pad_packed(self, qkv):
        """The thirds of a packed [B, S, 3 * heads * d] qkv, each padded."""
        if self.d == self.kd:
            return qkv
        return torch.cat([self.pad(t) for t in _thirds(qkv)], dim=-1)

    def cut_packed(self, dqkv):
        if self.d == self.kd:
            return dqkv
        return torch.cat([self.cut(t) for t in _thirds(dqkv)], dim=-1)


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


def _ptr(x):
    return None if x is None else x.data_ptr()


def launch_forward(source, signatures, entry, what, q, k, v, key_bias,
                   num_heads, seed, rate, train, out32=False):
    """Launch an attention forward kernel through the C ``entry`` of
    ``source``'s library at q's head dim (:class:`HeadPad`; the short and
    the flash2 forwards share one signature, flash2's with an f32 output
    after the lse); returns (ctx, lse, ctx32).  ``train``: also
    the row lse [B, heads, S] (log2 units), which the backward reads, else
    None.  ``out32`` (flash2): the entry takes an f32 output, which in
    training it also writes (``ctx`` itself for f32 inputs) for its
    backward; else ctx32 is None.  The short forward runs bf16 on the
    tensor cores (whole rows in registers up to 128 keys at head dims up to
    128, two sweeps otherwise) and f32 on the CUDA cores; its training
    form's plain version is :func:`short_attention_train_forward_plain`."""
    b, s, h = q.shape
    rate = check_rate(rate, what)
    pad = HeadPad(h, num_heads)
    q, k, v = _aligned(*map(pad.pad, (q, k, v)), what=what)
    key_bias = key_bias.to(torch.float32).contiguous()
    out = torch.empty_like(q)
    lse = ctx32 = None
    if train:
        lse = torch.empty((b, num_heads, s), dtype=torch.float32,
                          device=q.device)
        if out32:
            ctx32 = out if q.dtype == torch.float32 else torch.empty(
                q.shape, dtype=torch.float32, device=q.device)
    f32 = (None if ctx32 is out else _ptr(ctx32),) if out32 else ()
    code = getattr(pad.library(source, signatures), entry)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), key_bias.data_ptr(),
        out.data_ptr(), _ptr(lse), *f32, b, s, pad.hidden,
        num_heads, _DTYPES[q.dtype], pad.scale,
        *_seed_words(seed), rate, _stream(q))
    _build.check(code, what)
    ctx = pad.cut(out)
    return ctx, lse, ctx if ctx32 is out else pad.cut(ctx32)


def _forward_kernel(q, k, v, key_bias, num_heads, seed, rate, train):
    """The short forward kernel (:func:`launch_forward`): (ctx, lse), the
    lse None unless ``train``."""
    out, lse, _ = launch_forward("short_attention", _SIGNATURES,
                                 "msa_short_attention_fwd", "short_attention",
                                 q, k, v, key_bias, num_heads, seed, rate,
                                 train)
    short_attention.launches += 1
    return out, lse


def backward_route(seq: int, dtype: torch.dtype, head_dim: int) -> str:
    """The route of the v2, v2p, v3 and v2s backwards at (S, dtype) and head
    dim d, the rule of
    ``csrc/short_attention.cu::tc_backward`` and ``bwd_dispatch``:

    * ``WHOLE_ROW``: bf16 at S <= 128 and d <= 128, one tensor-core launch
      (``csrc/short_bwd_tc.cuh``) that recomputes each row's softmax (v2s:
      reads its probs), so the v2 forward keeps no lse for it;
    * ``TILED``: bf16 at 129 <= S <= 1023, and at every S above d = 128
      (the library of 256), the tensor-core dq and dk/dv pair
      (``csrc/short_bwd_tiled.cuh``), v2's reading the training forward's
      lse;
    * ``CUDA_CORES``: f32, the dq and dk/dv pair on the CUDA cores (v2's
      reading the lse too)."""
    if dtype != torch.bfloat16:
        return CUDA_CORES
    if (seq <= WHOLE_ROW_BWD_MAX_SEQ
            and kernel_head_dim(head_dim) <= WHOLE_ROW_MAX_HEAD_DIM):
        return WHOLE_ROW
    return TILED


def tensor_core_backward(seq: int, dtype: torch.dtype, head_dim: int) -> bool:
    """Whether the backwards at (S, dtype, d) run on the tensor cores: bf16
    at any S and head dim the kernels take (:func:`backward_route`)."""
    return backward_route(seq, dtype, head_dim) != CUDA_CORES


def backward_launches(seq: int, dtype: torch.dtype, head_dim: int) -> int:
    """Kernel launches of one :func:`short_attention_backward`,
    :func:`short_attention_packed_backward`,
    :func:`short_attention_v3_backward` or
    :func:`short_attention_probs_backward` call: 1 on the whole-row route,
    2 on either pair (:func:`backward_route`)."""
    return 1 if backward_route(seq, dtype, head_dim) == WHOLE_ROW else 2


class RouteCount:
    """The launches one backward entry made on the tiled route
    (``<entry>.tiled.launches``), beside its total (``<entry>.launches``)."""

    def __init__(self):
        self.launches = 0


def _count_backward(entry, seq, dtype, head_dim):
    """Add one call's launches to ``entry``'s count, and to its tiled
    route's count where it ran there."""
    n = backward_launches(seq, dtype, head_dim)
    entry.launches += n
    if backward_route(seq, dtype, head_dim) == TILED:
        entry.tiled.launches += n


def short_attention_backward(q, k, v, key_bias, lse, dout, num_heads: int,
                             seed: int = 0,
                             rate: float = 0.0) -> Tuple[torch.Tensor, ...]:
    """dq, dk, dv of :func:`short_attention` (CUDA only) by JAX's
    ``_bwd_kernel_v2`` rule, for the forward's seed and rate: p recomputed,
    delta = rowsum(p * dpm), dS and the dropped p rounded to q's dtype
    before their products (plain version:
    :func:`short_attention_v1_backward_plain`).  No [S, S] tensor is
    stored.  bf16 at S <= 128 and d <= 128: one tensor-core launch, which
    recomputes each row's max and sum from q and k (``lse`` is not read and
    may be None).  Otherwise two launches, dq then dk/dv (bf16 on the tensor
    cores, f32 on the CUDA cores), which read ``lse``, the training
    forward's row lse for the same inputs (:func:`backward_route`)."""
    _check(q, k, v, key_bias, num_heads, "short_attention_backward")
    grads = _backward_kernel(q, k, v, key_bias, lse, dout, num_heads, seed,
                             rate)
    _count_backward(short_attention_backward, q.shape[1], q.dtype,
                    q.shape[2] // num_heads)
    return grads


def _backward_kernel(q, k, v, key_bias, lse, dout, num_heads, seed, rate):
    """The launches of :func:`short_attention_backward`, uncounted."""
    b, s, h = q.shape
    one = backward_route(s, q.dtype, h // num_heads) == WHOLE_ROW
    if dout.shape != q.shape or not one and (
            lse is None or lse.shape != (b, num_heads, s)):
        raise ValueError("short_attention_backward: dout/lse "
                         f"{tuple(dout.shape)}, "
                         f"{None if lse is None else tuple(lse.shape)} do not "
                         f"fit q {tuple(q.shape)} {q.dtype}")
    pad = HeadPad(h, num_heads)
    q, k, v, dout = _aligned(*map(pad.pad, (q, k, v, dout.to(q.dtype))))
    key_bias = key_bias.to(torch.float32).contiguous()
    lse = None if one else lse.contiguous()
    delta = None if one else torch.empty_like(lse)
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    code = pad.library("short_attention", _SIGNATURES).msa_short_attention_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), key_bias.data_ptr(),
        dout.data_ptr(), _ptr(lse), _ptr(delta), dq.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), b, s, pad.hidden, num_heads, _DTYPES[q.dtype],
        pad.scale, *_seed_words(seed), check_rate(rate), _stream(q))
    _build.check(code, "short_attention_backward")
    return tuple(map(pad.cut, (dq, dk, dv)))


def short_attention_v3_backward_plain(q, k, v, key_bias, out, dout,
                                      num_heads: int, rate: float = 0.0,
                                      keep: Optional[torch.Tensor] = None):
    """dq, dk, dv of :func:`short_attention_plain` by JAX's
    ``_bwd_kernel_v3`` rule, in f32: p the softmax recomputed from q and k,
    then :func:`_grads_from_probs_plain` with delta_i = dO_i . o_i per head
    from ``out`` (the forward's ctx in its own dtype, widened), dS and the
    dropped p rounded to q's dtype before their products as that kernel
    rounds them (nothing changes in f32); ``keep`` a [B, heads, S, S] bool
    mask."""
    b, s, h = q.shape
    split = lambda x: x.reshape(b, s, num_heads, h // num_heads).float()  # noqa: E731
    delta = (split(dout) * split(out)).sum(-1).transpose(1, 2)[..., None]
    p = _scores_plain(q, k, key_bias, num_heads)
    return _grads_from_probs_plain(q, k, v, p, dout, num_heads, rate, keep,
                                   q.dtype, delta)


def short_attention_v3_backward(q, k, v, key_bias, out, dout, num_heads: int,
                                seed: int = 0,
                                rate: float = 0.0) -> Tuple[torch.Tensor, ...]:
    """dq, dk, dv of :func:`short_attention` by the v3 kernels (CUDA only):
    ``out`` is the forward's ctx in q's dtype for the same inputs, seed and
    rate.  bf16 at S <= 128 and d <= 128: one tensor-core launch;
    otherwise two, dq (which recomputes each row's lse and writes it and
    delta = dO . o to scratch) then dk/dv, bf16 on the tensor cores and
    f32 on the CUDA cores (:func:`backward_route`)."""
    _check(q, k, v, key_bias, num_heads, "short_attention_v3_backward")
    b, s, h = q.shape
    if out.shape != q.shape or out.dtype != q.dtype or dout.shape != q.shape:
        raise ValueError("short_attention_v3_backward: out/dout "
                         f"{tuple(out.shape)} {out.dtype}, {tuple(dout.shape)} "
                         f"do not fit q {tuple(q.shape)} {q.dtype}")
    grads = _v3_backward_kernel(q, k, v, key_bias, out, dout, num_heads, seed,
                                rate, "short_attention_v3_backward")
    _count_backward(short_attention_v3_backward, s, q.dtype, h // num_heads)
    return grads


def _v3_backward_kernel(q, k, v, key_bias, out, dout, num_heads, seed, rate,
                        what):
    """The launches of :func:`short_attention_v3_backward`, uncounted and at
    any S (the CUDA-core pair takes any)."""
    b, s, h = q.shape
    pad = HeadPad(h, num_heads)
    q, k, v, out, dout = _aligned(*map(pad.pad, (q, k, v, out,
                                                 dout.to(q.dtype))))
    key_bias = key_bias.to(torch.float32).contiguous()
    lse, delta = (torch.empty((b, num_heads, s), dtype=torch.float32,
                              device=q.device) for _ in range(2))
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    lib = pad.library("short_attention", _SIGNATURES)
    code = lib.msa_short_attention_v3_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), key_bias.data_ptr(),
        out.data_ptr(), dout.data_ptr(), lse.data_ptr(), delta.data_ptr(),
        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, s, pad.hidden,
        num_heads, _DTYPES[q.dtype], pad.scale, *_seed_words(seed),
        check_rate(rate), _stream(q))
    _build.check(code, what)
    return tuple(map(pad.cut, (dq, dk, dv)))


def wide_f32(dtype: torch.dtype, head_dim: int) -> bool:
    """Whether the flash entries (``ops/flash2.py``, ``ops/attention.py``)
    run on this module's CUDA-core kernels: f32 at a head dim above 128,
    where the flash kernels' staged f32 tiles do not fit in shared
    memory.  Those kernels take any S, and their f32 rules are the flash
    rules (in f32 no rounding differs)."""
    return (dtype == torch.float32
            and kernel_head_dim(head_dim) > WHOLE_ROW_MAX_HEAD_DIM)


def wide_f32_backward(q, k, v, key_bias, out, dout, num_heads, seed, rate,
                      what):
    """dq, dk, dv for :func:`wide_f32` inputs by the v3 pair on the CUDA
    cores (delta = dO . o from ``out``, the f32 output; the lse
    recomputed), counted on :func:`short_attention_v3_backward`, whose
    kernels they are."""
    grads = _v3_backward_kernel(q, k, v, key_bias, out, dout, num_heads, seed,
                                rate, what)
    _count_backward(short_attention_v3_backward, q.shape[1], q.dtype,
                    q.shape[2] // num_heads)
    return grads


def save_inputs(ctx, recompute, q, k, v, *rest):
    """Save (q, k, v, *rest) for the backward, or only ``rest`` with the
    ``recompute`` callable that gives q, k, v back (``save_ctx``)."""
    ctx.recompute = recompute
    ctx.save_for_backward(*rest) if recompute is not None else \
        ctx.save_for_backward(q, k, v, *rest)


def saved_inputs(ctx):
    """(q, k, v, *rest) as :func:`save_inputs` saved them."""
    if ctx.recompute is None:
        return ctx.saved_tensors
    with torch.no_grad():
        return (*ctx.recompute(), *ctx.saved_tensors)


class _ShortAttention(torch.autograd.Function):
    """Forward kernel + backward kernel pair.  Saves q, k, v and the bias --
    the seed and rate ride as Python numbers -- and, where a pair runs the
    backward (the tiled or the CUDA-core route of :func:`backward_route`),
    the row lse of the training forward; bf16 at S <= 128 and d <= 128
    runs the serving forward and keeps what JAX's ``_v2_fwd`` keeps and the
    ``_bwd_kernel_v2`` it pairs with reads.  No gradient for the bias or seed.  Under
    ``USE_V3_BWD`` (read here, in the forward) it saves the ctx instead of
    the lse, and the backward is the v3 pair; on CPU tensors (rate 0) the
    plain forward and the v3 plain backward."""

    @staticmethod
    def forward(ctx, q, k, v, key_bias, num_heads, seed, rate, recompute):
        ctx.v3 = USE_V3_BWD
        ctx.args = (num_heads, seed, rate)
        if not q.is_cuda:
            out = short_attention_plain(q, k, v, key_bias, num_heads)
            save_inputs(ctx, recompute, q, k, v, key_bias, out)
            return out
        train = not ctx.v3 and backward_route(
            q.shape[1], q.dtype, q.shape[2] // num_heads) != WHOLE_ROW
        out, lse = _forward_kernel(q, k, v, key_bias, num_heads, seed,
                                   check_rate(rate), train)
        save_inputs(ctx, recompute, q, k, v, key_bias, out if ctx.v3 else lse)
        return out

    @staticmethod
    def backward(ctx, dout):
        num_heads, seed, rate = ctx.args
        q, k, v, key_bias, saved = saved_inputs(ctx)
        if not ctx.v3:  # saved: the lse, or None
            grads = short_attention_backward(q, k, v, key_bias, saved, dout,
                                             num_heads, seed, rate)
        elif q.is_cuda:  # saved: the ctx
            grads = short_attention_v3_backward(
                q, k, v, key_bias, saved, dout, num_heads, seed, rate)
        else:
            grads = short_attention_v3_backward_plain(
                q, k, v, key_bias, saved, dout, num_heads)
        return (*grads, None, None, None, None, None)


def short_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    key_bias: torch.Tensor, num_heads: int,
                    rate: float = 0.0, seed: Optional[int] = None,
                    recompute=None) -> torch.Tensor:
    """q/k/v: [B, S, H]; key_bias: [B, S] additive mask.  Returns ctx [B, S, H].

    ``rate``: attention-probs dropout, any rate in [0, 1) (the model paths
    snap it to t/256 with ``ops.dropout.quantize_dropout_rate``), with
    ``seed`` (an int in [0, 2**62)).  CUDA tensors launch the kernels (or
    raise): the forward alone when no gradient is needed, else the autograd
    pair.  CPU tensors take the plain version, at rate 0 only: dropout off the card is
    ``multi_head_attention``'s bernoulli mask, and the kernels' mask is
    ``short_attention_plain`` given ``ops.dropout.keep_mask_plain``.
    ``recompute``: see the module docstring.
    """
    if rate > 0.0 and seed is None:
        raise ValueError("short_attention: dropout needs a seed")
    rate = check_rate(rate)
    needs_grad = torch.is_grad_enabled() and any(
        x.requires_grad for x in (q, k, v))
    if q.device.type == "cpu":
        if rate:
            raise ValueError(
                "short_attention: in-kernel dropout needs CUDA tensors; on the "
                "CPU give short_attention_plain a keep mask")
        if USE_V3_BWD and needs_grad:  # the v3 backward's plain version
            return _ShortAttention.apply(q, k, v, key_bias, num_heads, 0, rate,
                                         recompute)
        return short_attention_plain(q, k, v, key_bias, num_heads)
    _check(q, k, v, key_bias, num_heads, "short_attention")
    seed = 0 if seed is None else int(seed)
    if needs_grad:
        return _ShortAttention.apply(q, k, v, key_bias, num_heads, seed, rate,
                                     recompute)
    return _forward_kernel(q, k, v, key_bias, num_heads, seed, rate,
                           train=False)[0]


def dropout_keep_mask(seed: int, rate: float, batch: int, num_heads: int,
                      seq: int, device) -> torch.Tensor:
    """The kernels' attention keep mask, [B, heads, S, S] bool, for ``seed``
    and a rate in (0, 1), exported by a CUDA kernel on a CUDA device.  Its
    plain version is :func:`ops.dropout.keep_mask_plain`."""
    device = torch.device(device)
    rate = check_rate(rate)
    if rate == 0:
        raise ValueError("dropout_keep_mask: rate must be > 0")
    if device.type != "cuda":
        raise ValueError(f"dropout_keep_mask: no kernel for device {device}; "
                         "keep_mask_plain is the plain version")
    out = torch.empty((batch, num_heads, seq, seq), dtype=torch.uint8,
                      device=device)
    # every head dim's library holds the export; any one serves
    lib = _build.load(_build.head_dim_library("short_attention", 64),
                      _SIGNATURES)
    code = lib.msa_dropout_keep_mask(
        out.data_ptr(), batch, num_heads, seq, *_seed_words(int(seed)),
        rate, torch.cuda.current_stream(device).cuda_stream)
    _build.check(code, "dropout_keep_mask")
    dropout_keep_mask.launches += 1
    return out.bool()


# ---------------------------------------------------------------------------
# '+probs' (JAX short_attention_v2s): stash the signed probabilities
# ---------------------------------------------------------------------------


def probs_width(seq: int) -> int:
    """Columns of a stashed-probs row: S rounded up to 16.  The probs are
    [B, heads, S, probs_width(S)] in the compute dtype, entry (b, h, i, j)
    keep ? p : -p (p the softmax probability before dropout), zero past S.
    JAX's layout is [B, S, heads * round_up(S, 128)] (head h's row i at
    columns h * round_up(S, 128) + j)."""
    return -(-seq // PROBS_GROUP) * PROBS_GROUP


def short_attention_probs_plain(q, k, v, key_bias, num_heads: int,
                                rate: float = 0.0,
                                keep: Optional[torch.Tensor] = None):
    """The plain version of the ``+probs`` forward: (ctx [B, S, H], signed
    probs [B, heads, S, probs_width(S)] in q's dtype).  ``keep`` (a [B,
    heads, S, S] bool mask) applies dropout: ctx reads the kept
    probabilities divided by ``1 - rate``, as :func:`short_attention_plain`."""
    b, s, h = q.shape
    p = _scores_plain(q, k, key_bias, num_heads)
    pd = p if keep is None else torch.where(keep, p / (1.0 - rate), 0.0)
    ctx = torch.einsum("bnqk,bknd->bqnd", pd.to(q.dtype),
                       v.reshape(b, s, num_heads, h // num_heads))
    signed = p if keep is None else torch.where(keep, p, -p)
    probs = signed.new_zeros((b, num_heads, s, probs_width(s)))
    probs[..., :s] = signed
    return ctx.reshape(b, s, h), probs.to(q.dtype)


def short_attention_probs_backward_plain(q, k, v, probs, dout, num_heads: int,
                                         rate: float = 0.0):
    """dq, dk, dv from the signed probs (JAX ``_bwd_kernel_v2s``), in f32:
    p = |ps|, keep = ps > 0, then :func:`_grads_from_probs_plain` with dS
    and the dropped p rounded to q's dtype before their products, as that
    kernel rounds them (nothing changes in f32)."""
    s = q.shape[1]
    ps = probs[..., :s].float()
    return _grads_from_probs_plain(q, k, v, ps.abs(), dout, num_heads, rate,
                                   ps > 0.0 if rate > 0.0 else None, q.dtype)


def _grads_from_probs_plain(q, k, v, p, dout, num_heads, rate, keep,
                            operand_dtype=None, delta=None):
    """dq, dk, dv in f32 from the softmax probabilities ``p`` [B, heads, S,
    S] (JAX ``_bwd_kernel``, ``_bwd_kernel_v2s`` and ``_bwd_kernel_v3``): pd
    and dpm the kept p and dP = dO.V^T over ``1 - rate`` (``keep`` None: all
    kept), delta = sum_j p * dpm per row unless given ([B, heads, S, 1]),
    dS = p * (dpm - delta); with ``operand_dtype`` pd and dS rounded to it
    before their products."""
    b, s, h = q.shape
    d = h // num_heads
    split = lambda x: x.reshape(b, s, num_heads, d).float()  # noqa: E731
    dp = torch.einsum("bqnd,bknd->bnqk", split(dout), split(v))
    if keep is not None:
        pd = torch.where(keep, p, 0.0) / (1.0 - rate)
        dpm = torch.where(keep, dp, 0.0) / (1.0 - rate)
    else:
        pd, dpm = p, dp
    if delta is None:
        delta = (p * dpm).sum(-1, keepdim=True)
    ds = p * (dpm - delta)
    if operand_dtype is not None:
        ds, pd = (x.to(operand_dtype).float() for x in (ds, pd))
    scale = 1.0 / math.sqrt(d)
    dq = torch.einsum("bnqk,bknd->bqnd", ds, split(k)) * scale
    dk = torch.einsum("bnqk,bqnd->bknd", ds, split(q)) * scale
    dv = torch.einsum("bnqk,bqnd->bknd", pd, split(dout))
    return tuple(x.reshape(b, s, h).to(q.dtype) for x in (dq, dk, dv))


def short_attention_probs_backward(q, k, v, probs, dout, num_heads: int,
                                   rate: float = 0.0):
    """dq, dk, dv of :func:`short_attention_probs` from the forward's signed
    probs (CUDA only), by JAX's ``_bwd_kernel_v2s`` rule (plain version:
    :func:`short_attention_probs_backward_plain`).  No score, softmax or
    Philox draw is recomputed.  bf16 at S <= 128 and d <= 128: one
    tensor-core launch that reads p and the keep bit from the probs;
    otherwise two, dq (which writes delta = sum p * dpm to scratch) then
    dk/dv, bf16 on the tensor cores and f32 on the CUDA cores
    (:func:`backward_route`)."""
    _check(q, k, v, None, num_heads, "short_attention_probs_backward")
    b, s, h = q.shape
    if probs.shape != (b, num_heads, s, probs_width(s)) or \
            probs.dtype != q.dtype or dout.shape != q.shape:
        raise ValueError("short_attention_probs_backward: probs "
                         f"{tuple(probs.shape)} {probs.dtype} / dout "
                         f"{tuple(dout.shape)} do not fit q {tuple(q.shape)}")
    pad = HeadPad(h, num_heads)
    q, k, v, dout = map(pad.pad, (q, k, v, dout.to(q.dtype)))
    q, k, v, probs, dout = _aligned(q, k, v, probs, dout)
    delta = None if backward_route(s, q.dtype, h // num_heads) == WHOLE_ROW \
        else torch.empty(
        (b, num_heads, s), dtype=torch.float32, device=q.device)
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    lib = pad.library("short_attention", _SIGNATURES)
    code = lib.msa_short_attention_probs_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), probs.data_ptr(),
        dout.data_ptr(), _ptr(delta), dq.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), b, s, pad.hidden, num_heads, _DTYPES[q.dtype],
        pad.scale, check_rate(rate), _stream(q))
    _build.check(code, "short_attention_probs_backward")
    _count_backward(short_attention_probs_backward, s, q.dtype, h // num_heads)
    return tuple(map(pad.cut, (dq, dk, dv)))


def _probs_forward_kernel(q, k, v, key_bias, num_heads, seed, rate):
    b, s, h = q.shape
    pad = HeadPad(h, num_heads)
    q, k, v = _aligned(*map(pad.pad, (q, k, v)), what="short_attention_probs")
    key_bias = key_bias.to(torch.float32).contiguous()
    out = torch.empty_like(q)
    probs = torch.empty((b, num_heads, s, probs_width(s)), dtype=q.dtype,
                        device=q.device)
    lib = pad.library("short_attention", _SIGNATURES)
    code = lib.msa_short_attention_probs_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), key_bias.data_ptr(),
        out.data_ptr(), probs.data_ptr(), b, s, pad.hidden, num_heads,
        _DTYPES[q.dtype], pad.scale, *_seed_words(seed),
        check_rate(rate), _stream(q))
    _build.check(code, "short_attention_probs")
    short_attention_probs.launches += 1
    return pad.cut(out), probs


class _ShortAttentionProbs(torch.autograd.Function):
    """The v2s pair: the forward kernel writes ctx and the signed probs, the
    backward kernels read q, k, v, the probs and dout.  On CPU tensors the
    plain versions of both (rate 0)."""

    @staticmethod
    def forward(ctx, q, k, v, key_bias, num_heads, seed, rate, recompute):
        if q.is_cuda:
            out, probs = _probs_forward_kernel(q, k, v, key_bias, num_heads,
                                               seed, rate)
        else:
            out, probs = short_attention_probs_plain(q, k, v, key_bias,
                                                     num_heads)
        save_inputs(ctx, recompute, q, k, v, probs)
        ctx.args = (num_heads, rate)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, probs = saved_inputs(ctx)
        num_heads, rate = ctx.args
        entry = (short_attention_probs_backward if q.is_cuda
                 else short_attention_probs_backward_plain)
        return (*entry(q, k, v, probs, dout, num_heads, rate),
                None, None, None, None, None)


def short_attention_probs(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          key_bias: torch.Tensor, num_heads: int,
                          rate: float = 0.0, seed: Optional[int] = None,
                          recompute=None) -> torch.Tensor:
    """:func:`short_attention` with the ``+probs`` backward (JAX
    ``short_attention_v2s``): the same forward math and dropout mask; when a
    gradient is needed the forward also stashes the signed probabilities
    and the backward reads them.  Without gradient it runs the plain
    forward kernel (``short_attention``) and writes no probs.  CPU tensors
    run the plain versions, at rate 0 only."""
    needs_grad = torch.is_grad_enabled() and any(
        x.requires_grad for x in (q, k, v))
    if not needs_grad:
        return short_attention(q, k, v, key_bias, num_heads, rate, seed)
    if rate > 0.0 and seed is None:
        raise ValueError("short_attention_probs: dropout needs a seed")
    if q.device.type == "cpu":
        if check_rate(rate):
            raise ValueError("short_attention_probs: in-kernel dropout needs "
                             "CUDA tensors; on the CPU give "
                             "short_attention_probs_plain a keep mask")
    else:
        _check(q, k, v, key_bias, num_heads, "short_attention_probs")
    return _ShortAttentionProbs.apply(q, k, v, key_bias, num_heads,
                                      0 if seed is None else int(seed), rate,
                                      recompute)


# ---------------------------------------------------------------------------
# 'save_pack' (JAX short_attention_v2p): packed [B, S, 3H] q|k|v
# ---------------------------------------------------------------------------


def _thirds(qkv):
    h = qkv.shape[-1] // 3
    return qkv[..., :h], qkv[..., h:2 * h], qkv[..., 2 * h:]


def short_attention_packed_plain(qkv, key_bias, num_heads: int,
                                 rate: float = 0.0,
                                 keep: Optional[torch.Tensor] = None):
    """The plain version of :func:`short_attention_packed`:
    :func:`short_attention_plain` on the thirds of ``qkv``."""
    return short_attention_plain(*_thirds(qkv), key_bias, num_heads, rate,
                                 keep)


def short_attention_packed_backward_plain(qkv, key_bias, dout,
                                          num_heads: int, rate: float = 0.0,
                                          keep: Optional[torch.Tensor] = None,
                                          out: Optional[torch.Tensor] = None):
    """The packed gradient [B, S, 3H] of :func:`short_attention_packed_plain`
    by JAX's ``_bwd_kernel_v2p`` rule, the v3 one: q, k and v the thirds of
    ``qkv`` in its dtype, ``out`` the forward's ctx in that dtype (None:
    :func:`short_attention_plain`'s), then
    :func:`short_attention_v3_backward_plain` (delta = dO . o per head row,
    dS and the dropped p rounded to qkv's dtype), dq, dk and dv written into
    the thirds of one buffer."""
    q, k, v = _thirds(qkv)
    if out is None:
        out = short_attention_plain(q, k, v, key_bias, num_heads, rate, keep)
    grads = short_attention_v3_backward_plain(q, k, v, key_bias, out, dout,
                                              num_heads, rate, keep)
    return torch.cat(grads, dim=-1)


def _check_packed(qkv, key_bias, num_heads, what):
    b, s, h3 = qkv.shape
    if h3 % 3:
        raise ValueError(f"{what}: last dim {h3} is not 3H")
    q, k, v = _thirds(qkv)
    _check(q, k, v, key_bias, num_heads, what)


def _packed_forward_kernel(qkv, key_bias, num_heads, seed, rate, train):
    """The packed forward; (ctx, lse) as :func:`_forward_kernel`: the same
    kernels reading the thirds of ``qkv`` at row stride 3H."""
    b, s, h3 = qkv.shape
    pad = HeadPad(h3 // 3, num_heads)
    (qkv,) = _aligned(pad.pad_packed(qkv), what="short_attention_packed")
    key_bias = key_bias.to(torch.float32).contiguous()
    out = torch.empty((b, s, pad.hidden), dtype=qkv.dtype, device=qkv.device)
    lse = torch.empty((b, num_heads, s), dtype=torch.float32,
                      device=qkv.device) if train else None
    lib = pad.library("short_attention", _SIGNATURES)
    code = lib.msa_short_attention_packed_fwd(
        qkv.data_ptr(), key_bias.data_ptr(), out.data_ptr(), _ptr(lse), b, s,
        pad.hidden, num_heads, _DTYPES[qkv.dtype], pad.scale,
        *_seed_words(seed), rate, _stream(qkv))
    _build.check(code, "short_attention_packed")
    short_attention_packed.launches += 1
    return pad.cut(out), lse


def short_attention_packed_backward(qkv, key_bias, out, dout, num_heads: int,
                                    seed: int = 0,
                                    rate: float = 0.0) -> torch.Tensor:
    """dqkv [B, S, 3H] of :func:`short_attention_packed` (CUDA only) by
    JAX's ``_bwd_kernel_v2p`` rule (v3's, :func:`short_attention_v3_backward`):
    ``out`` is the forward's ctx in qkv's dtype for the same inputs, seed
    and rate, delta = dO . o, the lse recomputed, dS and the dropped p
    rounded; q, k and v are read as the thirds of ``qkv`` in place and dq,
    dk, dv written into the thirds of one buffer.  bf16 at S <= 128 and d
    <= 128: one tensor-core launch at row stride 3H; otherwise a pair,
    bf16 on the tensor cores and f32 on the CUDA cores
    (:func:`backward_route`)."""
    _check_packed(qkv, key_bias, num_heads, "short_attention_packed_backward")
    b, s, h3 = qkv.shape
    if out.shape != (b, s, h3 // 3) or out.dtype != qkv.dtype or \
            dout.shape != out.shape:
        raise ValueError("short_attention_packed_backward: out/dout "
                         f"{tuple(out.shape)} {out.dtype}, {tuple(dout.shape)} "
                         f"do not fit qkv {tuple(qkv.shape)} {qkv.dtype}")
    pad = HeadPad(h3 // 3, num_heads)
    qkv, out, dout = _aligned(pad.pad_packed(qkv), pad.pad(out),
                              pad.pad(dout.to(qkv.dtype)))
    key_bias = key_bias.to(torch.float32).contiguous()
    lse, delta = (torch.empty((b, num_heads, s), dtype=torch.float32,
                              device=qkv.device) for _ in range(2))
    dqkv = torch.empty_like(qkv)
    lib = pad.library("short_attention", _SIGNATURES)
    code = lib.msa_short_attention_packed_bwd(
        qkv.data_ptr(), key_bias.data_ptr(), out.data_ptr(), dout.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dqkv.data_ptr(), b, s, pad.hidden,
        num_heads, _DTYPES[qkv.dtype], pad.scale,
        *_seed_words(seed), check_rate(rate), _stream(qkv))
    _build.check(code, "short_attention_packed_backward")
    _count_backward(short_attention_packed_backward, s, qkv.dtype,
                    h3 // 3 // num_heads)
    return pad.cut_packed(dqkv)


class _ShortAttentionPacked(torch.autograd.Function):
    """The v2p pair.  The forward runs the serving form and saves qkv, the
    bias and the ctx, as JAX's ``_v2p_fwd`` saves its residuals; the
    gradient of qkv is one [B, S, 3H] tensor.  On CPU tensors the plain
    versions of both (rate 0)."""

    @staticmethod
    def forward(ctx, qkv, key_bias, num_heads, seed, rate):
        if qkv.is_cuda:
            out = _packed_forward_kernel(qkv, key_bias, num_heads, seed,
                                         check_rate(rate), False)[0]
        else:
            out = short_attention_packed_plain(qkv, key_bias, num_heads)
        ctx.save_for_backward(qkv, key_bias, out)
        ctx.args = (num_heads, seed, rate)
        return out

    @staticmethod
    def backward(ctx, dout):
        num_heads, seed, rate = ctx.args
        qkv, key_bias, out = ctx.saved_tensors
        if qkv.is_cuda:
            dqkv = short_attention_packed_backward(
                qkv, key_bias, out, dout, num_heads, seed, rate)
        else:
            dqkv = short_attention_packed_backward_plain(
                qkv, key_bias, dout, num_heads, out=out)
        return dqkv, None, None, None, None


def short_attention_packed(qkv: torch.Tensor, key_bias: torch.Tensor,
                           num_heads: int, rate: float = 0.0,
                           seed: Optional[int] = None) -> torch.Tensor:
    """Attention on one packed qkv [B, S, 3H] (q|k|v thirds) -> ctx [B, S, H]
    (JAX ``short_attention_v2p``): the kernels of :func:`short_attention`
    read the thirds in place (row stride 3H), with the same dropout mask at
    a seed, and the backward returns one packed dqkv.  CPU tensors run the
    plain versions, at rate 0 only."""
    if rate > 0.0 and seed is None:
        raise ValueError("short_attention_packed: dropout needs a seed")
    rate = check_rate(rate)
    seed = 0 if seed is None else int(seed)
    if qkv.device.type == "cpu":
        if rate:
            raise ValueError("short_attention_packed: in-kernel dropout needs "
                             "CUDA tensors; on the CPU give "
                             "short_attention_packed_plain a keep mask")
    else:
        _check_packed(qkv, key_bias, num_heads, "short_attention_packed")
    if torch.is_grad_enabled() and qkv.requires_grad:
        return _ShortAttentionPacked.apply(qkv, key_bias, num_heads, seed,
                                           rate)
    if qkv.device.type == "cpu":
        return short_attention_packed_plain(qkv, key_bias, num_heads)
    return _packed_forward_kernel(qkv, key_bias, num_heads, seed, rate,
                                  train=False)[0]


# ---------------------------------------------------------------------------
# v1 (JAX short_attention): the pair that keeps only its inputs
# ---------------------------------------------------------------------------


def short_attention_v1_backward_plain(q, k, v, key_bias, dout, num_heads: int,
                                      rate: float = 0.0,
                                      keep: Optional[torch.Tensor] = None):
    """dq, dk, dv of :func:`short_attention_plain` by JAX's ``_bwd_kernel``
    (v1), in f32, from the inputs alone: p the softmax recomputed from q, k
    and the bias, then :func:`_grads_from_probs_plain` (delta = sum_j p *
    dpm, not dO . o), dS and the dropped p rounded to q's dtype before their
    products as that kernel rounds them (``.astype``; nothing changes in
    f32); ``keep`` a [B, heads, S, S] bool mask."""
    p = _scores_plain(q, k, key_bias, num_heads)
    return _grads_from_probs_plain(q, k, v, p, dout, num_heads, rate, keep,
                                   q.dtype)


def v1_on_v2(seq: int, head_dim: int) -> bool:
    """Whether v1 runs on the v2 kernels' forms at (S, d): above
    ``V1_WHOLE_ROW_SEQ`` keys or a head dim above ``V1_MAX_HEAD_DIM``."""
    return seq > V1_WHOLE_ROW_SEQ or kernel_head_dim(head_dim) > V1_MAX_HEAD_DIM


def _v1_forward_kernel(q, k, v, key_bias, num_heads, seed, rate):
    b, s, h = q.shape
    if v1_on_v2(s, h // num_heads):  # the same function on the v2 forward's forms
        out = launch_forward("short_attention", _SIGNATURES,
                             "msa_short_attention_fwd", "short_attention_v1",
                             q, k, v, key_bias, num_heads, seed, rate,
                             train=False)[0]
        short_attention_v1.launches += 1
        return out
    pad = HeadPad(h, num_heads)
    q, k, v = _aligned(*map(pad.pad, (q, k, v)), what="short_attention_v1")
    key_bias = key_bias.to(torch.float32).contiguous()
    out = torch.empty_like(q)
    lib = pad.library("short_attention_v1", _V1_SIGNATURES)
    code = lib.msa_short_attention_v1_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), key_bias.data_ptr(),
        out.data_ptr(), b, s, pad.hidden, num_heads, _DTYPES[q.dtype],
        pad.scale, *_seed_words(seed), rate, _stream(q))
    _build.check(code, "short_attention_v1")
    short_attention_v1.launches += 1
    return pad.cut(out)


def v1_backward_launches(seq: int, dtype: torch.dtype, head_dim: int) -> int:
    """Kernel launches of one :func:`short_attention_v1_backward` call: 1 up
    to ``V1_WHOLE_ROW_SEQ`` keys and head dim ``V1_MAX_HEAD_DIM``; above,
    the v2 training forward for the row lse, then the v2 backward
    (:func:`backward_launches`)."""
    if not v1_on_v2(seq, head_dim):
        return 1
    return 1 + backward_launches(seq, dtype, head_dim)


def short_attention_v1_backward(q, k, v, key_bias, dout, num_heads: int,
                                seed: int = 0,
                                rate: float = 0.0) -> Tuple[torch.Tensor, ...]:
    """dq, dk, dv of :func:`short_attention_v1` (CUDA only) from q, k, v,
    the bias and dout alone, for the forward's seed and rate.  Up to 128
    keys (and head dim 128) one launch that recomputes each row's max, sum
    and probabilities; above, v1 keeps no lse, so the v2 training forward recomputes it (its
    ctx dropped) and the v2 backward, whose rule (delta = rowsum(p * dpm))
    is v1's, reads it (:func:`v1_backward_launches`)."""
    _check(q, k, v, key_bias, num_heads, "short_attention_v1_backward")
    b, s, h = q.shape
    if dout.shape != q.shape:
        raise ValueError(f"short_attention_v1_backward: dout "
                         f"{tuple(dout.shape)} does not fit q {tuple(q.shape)}")
    if v1_on_v2(s, h // num_heads):
        rate = check_rate(rate)
        lse = launch_forward("short_attention", _SIGNATURES,
                             "msa_short_attention_fwd",
                             "short_attention_v1_backward", q, k, v, key_bias,
                             num_heads, seed, rate, train=True)[1]
        grads = _backward_kernel(q, k, v, key_bias, lse, dout, num_heads,
                                 seed, rate)
        short_attention_v1_backward.launches += v1_backward_launches(
            s, q.dtype, h // num_heads)
        return grads
    pad = HeadPad(h, num_heads)
    q, k, v, dout = _aligned(*map(pad.pad, (q, k, v, dout.to(q.dtype))),
                             what="short_attention_v1_backward")
    key_bias = key_bias.to(torch.float32).contiguous()
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    lib = pad.library("short_attention_v1", _V1_SIGNATURES)
    code = lib.msa_short_attention_v1_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), key_bias.data_ptr(),
        dout.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, s,
        pad.hidden, num_heads, _DTYPES[q.dtype], pad.scale,
        *_seed_words(seed), check_rate(rate), _stream(q))
    _build.check(code, "short_attention_v1_backward")
    short_attention_v1_backward.launches += 1
    return tuple(map(pad.cut, (dq, dk, dv)))


class _ShortAttentionV1(torch.autograd.Function):
    """The v1 pair: saves q, k, v and the bias -- its inputs, as ``_short_fwd``
    saves (q, k, v, key_bias, seed) -- and nothing the forward computed; the
    seed and rate ride as Python numbers.  On CPU tensors (rate 0) the plain
    forward and the v1 plain backward."""

    @staticmethod
    def forward(ctx, q, k, v, key_bias, num_heads, seed, rate):
        if q.is_cuda:
            out = _v1_forward_kernel(q, k, v, key_bias, num_heads, seed,
                                     check_rate(rate))
        else:
            out = short_attention_plain(q, k, v, key_bias, num_heads)
        ctx.save_for_backward(q, k, v, key_bias)
        ctx.args = (num_heads, seed, rate)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, key_bias = ctx.saved_tensors
        num_heads, seed, rate = ctx.args
        if q.is_cuda:
            grads = short_attention_v1_backward(q, k, v, key_bias, dout,
                                                num_heads, seed, rate)
        else:
            grads = short_attention_v1_backward_plain(q, k, v, key_bias, dout,
                                                      num_heads)
        return (*grads, None, None, None, None)


def short_attention_v1(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       key_bias: torch.Tensor, num_heads: int,
                       rate: float = 0.0,
                       seed: Optional[int] = None) -> torch.Tensor:
    """The counterpart of JAX's ``short_attention``
    (``msa_tpu/ops/short_attention.py:667``, the v1 pair; this module's
    :func:`short_attention` is JAX's ``short_attention_v2``).  q/k/v: [B, S,
    H] with S <= 1023 on CUDA (above 128 keys on the v2 kernels' forms);
    key_bias: [B, S] additive mask.  Returns ctx
    [B, S, H], the same function as :func:`short_attention` with the same
    dropout mask at a seed.  Under autograd it keeps only its inputs, and
    its backward recomputes everything from them.  CUDA tensors launch the
    kernels (or raise); CPU tensors run :func:`short_attention_plain` and,
    under autograd, :func:`short_attention_v1_backward_plain`, at rate 0
    only."""
    if rate > 0.0 and seed is None:
        raise ValueError("short_attention_v1: dropout needs a seed")
    rate = check_rate(rate)
    if q.device.type == "cpu":
        if rate:
            raise ValueError("short_attention_v1: in-kernel dropout needs CUDA "
                             "tensors; on the CPU give short_attention_plain a "
                             "keep mask")
    else:
        _check(q, k, v, key_bias, num_heads, "short_attention_v1")
    seed = 0 if seed is None else int(seed)
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        return _ShortAttentionV1.apply(q, k, v, key_bias, num_heads, seed, rate)
    if q.device.type == "cpu":
        return short_attention_plain(q, k, v, key_bias, num_heads)
    return _v1_forward_kernel(q, k, v, key_bias, num_heads, seed, rate)


short_attention.launches = 0
short_attention_backward.launches = 0
short_attention_v3_backward.launches = 0
dropout_keep_mask.launches = 0
short_attention_probs.launches = 0
short_attention_probs_backward.launches = 0
short_attention_packed.launches = 0
short_attention_packed_backward.launches = 0
for _entry in (short_attention_backward, short_attention_v3_backward,
               short_attention_probs_backward,
               short_attention_packed_backward):
    _entry.tiled = RouteCount()
del _entry
short_attention_v1.launches = 0
short_attention_v1_backward.launches = 0
