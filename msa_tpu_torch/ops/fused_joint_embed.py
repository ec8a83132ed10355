"""Fused joint embedding: a hand-written CUDA kernel.

Counterpart of ``msa_tpu/ops/fused_joint_embed.py::fused_joint_embed``
(TPU kernel ``_kernel``).  For each batch row it writes ``LN(text_emb)`` to
rows [0, L) and ``LN(relu(feats @ W + b))`` to rows [L, L+Lp); the
projection and the LayerNorm run in f32 and the output is stored in
``text_emb``'s dtype.  The kernel (``csrc/fused_joint_embed.cu``) takes
any H up to 2048 (the tiny preset's 64, bert-base's 768, bert-large's 1024)
and D <= 1024 (the datasets' D is one of 35, 47, 74, 81, 371); its header
says what bounds it on the H100.

:func:`fused_joint_embed` launches the kernel for CUDA tensors and runs
:func:`fused_joint_embed_plain` for CPU tensors.  Under autograd on CUDA it
is a ``torch.autograd.Function``: the forward is the kernel, the backward
recomputes through the plain version under autograd -- as JAX's ``_bwd`` is
the VJP of ``_ref_forward``, an XLA recompute and no Pallas kernel.  The
kernel has no row limit (text rows by teams of lanes, frame rows in tiles
of 8-64 rows of the flattened [B * Lp] index), so JAX's VMEM-derived
``_MAX_FUSED_ROWS`` has no counterpart here.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from .. import _build

_MAX_HIDDEN = 2048
_MAX_FEAT = 1024
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "msa_fused_joint_embed": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                              ctypes.c_float, _I, _P),
}


def fused_joint_embed_plain(text_emb, feats, w, b, scale, bias,
                            eps: float) -> torch.Tensor:
    """The plain PyTorch version: ``_ref_forward``, except that the
    projection stays in f32 as the TPU kernel computes it (``_ref_forward``
    rounds it to the compute dtype first; the two agree in f32)."""
    proj = torch.relu(feats.float() @ w.float() + b.float())
    x = torch.cat([text_emb.float(), proj], dim=1)
    y = F.layer_norm(x, x.shape[-1:], scale.float(), bias.float(), eps)
    return y.to(text_emb.dtype)


class _FusedJointEmbed(torch.autograd.Function):
    """Kernel forward; backward by recomputing the plain version."""

    @staticmethod
    def forward(ctx, text_emb, feats, w, b, scale, bias, eps):
        ctx.save_for_backward(text_emb, feats, w, b, scale, bias)
        ctx.eps = eps
        return _kernel(text_emb, feats, w, b, scale, bias, eps)

    @staticmethod
    def backward(ctx, grad):
        inputs = [x.detach().requires_grad_(need) for x, need in
                  zip(ctx.saved_tensors, ctx.needs_input_grad)]
        with torch.enable_grad():
            out = fused_joint_embed_plain(*inputs, ctx.eps)
        wanted = [x for x in inputs if x.requires_grad]
        grads = iter(torch.autograd.grad(out, wanted, grad))
        return (*(next(grads) if x.requires_grad else None for x in inputs),
                None)


def fused_joint_embed(text_emb: torch.Tensor, feats: torch.Tensor,
                      w: torch.Tensor, b: torch.Tensor, scale: torch.Tensor,
                      bias: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """[B, L, H] text embeddings + [B, Lp, D] frames -> [B, L+Lp, H].

    ``w`` is [D, H] (the JAX layout); ``b``, ``scale``, ``bias`` are [H].
    ``fused_joint_embed.launches`` counts kernel launches.
    """
    args = (text_emb, feats, w, b, scale, bias)
    if text_emb.device.type == "cpu":
        return fused_joint_embed_plain(*args, eps)
    if torch.is_grad_enabled() and any(x.requires_grad for x in args):
        return _FusedJointEmbed.apply(*args, eps)
    return _kernel(*args, eps)


def _kernel(text_emb, feats, w, b, scale, bias, eps):
    bsz, l, h = text_emb.shape
    lp, d = feats.shape[1], feats.shape[2]
    if text_emb.device.type != "cuda":
        raise ValueError(
            f"fused_joint_embed: no kernel for device {text_emb.device}")
    if text_emb.dtype not in _DTYPES or feats.dtype != text_emb.dtype:
        raise TypeError(
            f"fused_joint_embed: text {text_emb.dtype} / feats {feats.dtype}; "
            "both must be float32 or both bfloat16")
    if h > _MAX_HIDDEN or d > _MAX_FEAT:
        raise ValueError(f"fused_joint_embed: H={h}, D={d} not supported "
                         f"(H <= {_MAX_HIDDEN}, D <= {_MAX_FEAT})")
    if feats.shape[0] != bsz or w.shape != (d, h) or any(
            p.shape != (h,) for p in (b, scale, bias)):
        raise ValueError(
            f"fused_joint_embed: shapes text {tuple(text_emb.shape)}, feats "
            f"{tuple(feats.shape)}, w {tuple(w.shape)} do not fit")
    if any(x.device != text_emb.device for x in (feats, w, b, scale, bias)):
        raise ValueError("fused_joint_embed: every input must lie on "
                         f"{text_emb.device}")
    params = [p.to(torch.float32).contiguous() for p in (w, b, scale, bias)]
    text_emb, feats = text_emb.contiguous(), feats.contiguous()
    out = torch.empty((bsz, l + lp, h), dtype=text_emb.dtype,
                      device=text_emb.device)
    lib = _build.load("fused_joint_embed", _SIGNATURES)
    code = lib.msa_fused_joint_embed(
        text_emb.data_ptr(), feats.data_ptr(),
        *(p.data_ptr() for p in params), out.data_ptr(),
        bsz, l, lp, d, h, float(eps), _DTYPES[text_emb.dtype],
        torch.cuda.current_stream(text_emb.device).cuda_stream)
    _build.check(code, "fused_joint_embed")
    fused_joint_embed.launches += 1
    return out


fused_joint_embed.launches = 0
