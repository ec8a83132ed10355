"""One tensor's AdamW update in one pass: a hand-written CUDA kernel.

Counterpart of ``msa_tpu/ops/fused_adamw.py::fused_adamw_leaf`` (TPU
kernel ``_kernel``), with its arithmetic (``_adamw_math``), decoupled
weight decay and eps outside the square root:

    mu' = b1 mu + (1-b1) g        nu' = b2 nu + (1-b2) g^2
    p'  = p - lr [ (mu'/c1) / (sqrt(nu'/c2) + eps) + wd p ]

with c1 = 1 - b1^t, c2 = 1 - b2^t, everything in f32 and the moments
stored back in their own dtypes (f32 or bf16, rounded to nearest even).
``p`` and ``g`` are f32 (the trainer's masters and gradients).  An
optional ``clip_scale`` (a 0-d f32 tensor on p's device, the global-norm
clip's factor) multiplies g first, as JAX scales the gradients before its
kernel; the kernel reads it on the device, so clipping needs no host sync.

:func:`fused_adamw_leaf` updates p, mu and nu in place: the kernel
(``csrc/fused_adamw.cu``) for CUDA tensors, :func:`fused_adamw_leaf_plain`
copied back for CPU tensors.  ``fused_adamw_leaf.launches`` counts the
kernel launches.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from .. import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_P = ctypes.c_void_p
_F = ctypes.c_float
_SIGNATURES = {
    "msa_fused_adamw": (_P, _P, _P, _P, ctypes.c_longlong, ctypes.c_int,
                        ctypes.c_int, _F, _F, _F, _F, _F, _F, _F, _F, _F, _P,
                        _P),
}


def fused_adamw_leaf_plain(p: torch.Tensor, g: torch.Tensor, mu: torch.Tensor,
                           nu: torch.Tensor, lr: float, wd: float, c1: float,
                           c2: float, *, b1: float = 0.9, b2: float = 0.999,
                           eps: float = 1e-6,
                           clip_scale: Optional[torch.Tensor] = None):
    """The plain PyTorch version: returns (p', mu', nu') as new tensors in
    the input dtypes.  lr, wd, c1 and c2 enter as f32 tensors on p's device
    (one rounding each); a Python divisor would be turned into a multiply
    by its reciprocal on CUDA, one more rounding than the kernel's true
    division."""
    f32 = lambda x: torch.as_tensor(x, dtype=torch.float32,  # noqa: E731
                                    device=p.device)
    g = g.float()
    if clip_scale is not None:
        g = g * clip_scale
    mu_new = b1 * mu.float() + (1.0 - b1) * g
    nu_new = b2 * nu.float() + (1.0 - b2) * g * g
    upd = (mu_new / f32(c1)) / (torch.sqrt(nu_new / f32(c2)) + eps) \
        + f32(wd) * p.float()
    p_new = p.float() - f32(lr) * upd
    return p_new.to(p.dtype), mu_new.to(mu.dtype), nu_new.to(nu.dtype)


def _check(p, g, mu, nu, clip_scale):
    if p.device.type != "cuda":
        raise ValueError(f"fused_adamw_leaf: no kernel for device {p.device}")
    if p.dtype != torch.float32 or g.dtype != torch.float32:
        raise TypeError(f"fused_adamw_leaf: p {p.dtype} / g {g.dtype}; both "
                        "must be float32")
    for name, x in (("mu", mu), ("nu", nu)):
        if x.dtype not in _DTYPES:
            raise TypeError(f"fused_adamw_leaf: {name} {x.dtype} not supported "
                            "(float32 or bfloat16)")
    for name, x in (("g", g), ("mu", mu), ("nu", nu)):
        if x.shape != p.shape or x.device != p.device:
            raise ValueError(f"fused_adamw_leaf: {name} {tuple(x.shape)} on "
                             f"{x.device} does not match p {tuple(p.shape)} "
                             f"on {p.device}")
    for name, x in (("p", p), ("mu", mu), ("nu", nu)):
        if not x.is_contiguous():
            raise ValueError(f"fused_adamw_leaf: {name} is updated in place "
                             "and must be contiguous")
    if clip_scale is not None and (clip_scale.numel() != 1 or
                                   clip_scale.dtype != torch.float32 or
                                   clip_scale.device != p.device):
        raise ValueError("fused_adamw_leaf: clip_scale must be one f32 value "
                         f"on {p.device}")


@torch.no_grad()
def fused_adamw_leaf(p: torch.Tensor, g: torch.Tensor, mu: torch.Tensor,
                     nu: torch.Tensor, lr: float, wd: float, c1: float,
                     c2: float, *, b1: float = 0.9, b2: float = 0.999,
                     eps: float = 1e-6,
                     clip_scale: Optional[torch.Tensor] = None):
    """Update ``p``, ``mu`` and ``nu`` in place with one AdamW step from
    gradient ``g``; returns (p, mu, nu).  lr, wd, c1, c2: host floats,
    rounded once to f32.  CUDA tensors launch the kernel (or raise); CPU
    tensors run :func:`fused_adamw_leaf_plain`."""
    hyper = dict(b1=b1, b2=b2, eps=eps, clip_scale=clip_scale)
    if p.device.type == "cpu":
        for dst, src in zip((p, mu, nu), fused_adamw_leaf_plain(
                p, g, mu, nu, lr, wd, c1, c2, **hyper)):
            dst.copy_(src)
        return p, mu, nu
    _check(p, g, mu, nu, clip_scale)
    g = g.contiguous()
    lib = _build.load("fused_adamw", _SIGNATURES)
    code = lib.msa_fused_adamw(
        p.data_ptr(), g.data_ptr(), mu.data_ptr(), nu.data_ptr(), p.numel(),
        _DTYPES[mu.dtype], _DTYPES[nu.dtype], b1, 1.0 - b1, b2, 1.0 - b2, eps,
        lr, wd, c1, c2, None if clip_scale is None else clip_scale.data_ptr(),
        torch.cuda.current_stream(p.device).cuda_stream)
    _build.check(code, "fused_adamw_leaf")
    fused_adamw_leaf.launches += 1
    return p, mu, nu


fused_adamw_leaf.launches = 0
