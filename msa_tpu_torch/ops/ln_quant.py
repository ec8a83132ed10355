"""Fused residual add + LayerNorm + int8 quantize: a hand-written CUDA
kernel for the int8 serving path.

Counterpart of ``msa_tpu/ops/ln_quant.py::ln_quant`` (TPU kernels
``_kernel_static`` and ``_kernel_dynamic``).  One pass over the rows emits
both consumers' views of a post-LN activation:

    x, res --> h  = LayerNorm(x + res)      (x's dtype: the residual stream)
           --> xi = int8 quantize of h      (the next int8 GEMM's input)

The sum and the LayerNorm run in f32; ``xi`` quantizes the ROUNDED ``h``,
so it equals ``quantize_act(h)`` of the composition.  With a static scale
``ascale`` (a 0-d f32 tensor, read on the device: no host sync) the kernel
writes (h, xi); without one it also computes the per-row scale
max|h| / 127 + 1e-12 and returns it [..., 1].

:func:`ln_quant` runs :func:`ln_quant_plain` for CPU tensors and launches
the kernel (``csrc/ln_quant.cu``) for CUDA ones, at any H: the lane-team
forms where :func:`supported_hidden` holds (H a multiple of 64 up to 512,
of 128 up to 1024 or of 256 up to 2048), the generic form (a warp or a
CTA a row, tail-masked columns) for every other H;
``ln_quant_static.launches`` and ``ln_quant_dynamic.launches`` count the
launches.  Forward only: the serving path is never differentiated.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from .. import _build
from .quant import quantize_act

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    "msa_ln_quant_static": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _F, _I, _P),
    "msa_ln_quant_dynamic": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _F, _I, _P),
}


def supported_hidden(h_dim: int) -> bool:
    """Whether rows of ``h_dim`` columns take the kernel's lane-team form: a
    team of 32, 16 or 8 lanes (the most that divide the row's 8-column
    chunks) holds a row, at most 8 chunks a lane
    (``csrc/ln_quant.cu::team_lanes``).  Every other width takes the
    generic form: a warp a row below 1024 columns, a CTA a row from
    there."""
    if h_dim <= 0 or h_dim % 64:
        return False
    chunks = h_dim // 8
    lanes = next(n for n in (32, 16, 8) if chunks % n == 0)
    return chunks // lanes <= 8


def ln_quant_plain(x: torch.Tensor, res: torch.Tensor, scale: torch.Tensor,
                   bias: torch.Tensor, eps: float,
                   ascale: Optional[torch.Tensor] = None):
    """The plain PyTorch version: ``layer_norm(x + res)`` (the sum in f32,
    as the kernels take it) cast to x's dtype, then ``quantize_act``.
    Returns (h, xi, row), ``row`` None in static mode."""
    y = F.layer_norm(x.float() + res.float(), x.shape[-1:], scale.float(),
                     bias.float(), eps)
    h = y.to(x.dtype)
    xi, row = quantize_act(h, ascale)
    return h, xi, (row if ascale is None else None)


def ln_quant(x: torch.Tensor, res: torch.Tensor, ln_params, eps: float,
             ascale: Optional[torch.Tensor] = None):
    """``h = layer_norm(x + res)`` and its int8 view, fused.

    ``x``/``res`` [..., H]; ``ln_params`` {"scale", "bias"} ([H]);
    ``ascale`` a static f32 scale or None for per-row scales.  Returns
    ``(h, xi, row)``: ``row`` [..., 1] f32 in dynamic mode, None in static
    mode (the caller holds ascale).
    """
    args = (x, res, ln_params["scale"], ln_params["bias"], eps)
    if x.device.type == "cpu":
        return ln_quant_plain(*args, ascale)
    if ascale is None:
        return ln_quant_dynamic(*args)
    return ln_quant_static(*args, ascale) + (None,)


def _prepare(x, res, scale, bias, what):
    h_dim = x.shape[-1]
    if x.device.type != "cuda":
        raise ValueError(f"{what}: no kernel for device {x.device}")
    if x.dtype not in _DTYPES or res.dtype != x.dtype:
        raise TypeError(f"{what}: x {x.dtype} / res {res.dtype}; both must "
                        "be float32 or both bfloat16")
    if h_dim < 1:
        raise ValueError(f"{what}: H={h_dim}; rows need a column")
    if res.shape != x.shape or scale.shape != (h_dim,) or \
            bias.shape != (h_dim,):
        raise ValueError(f"{what}: shapes x {tuple(x.shape)}, res "
                         f"{tuple(res.shape)}, ln {tuple(scale.shape)} do not fit")
    tensors = [t.contiguous() for t in (x, res)] + [
        t.to(torch.float32).contiguous() for t in (scale, bias)]
    if any(t.device != x.device or t.data_ptr() % 16 for t in tensors):
        raise ValueError(f"{what}: every input must lie on {x.device}, "
                         "16-byte aligned")
    return tensors


def _launch(entry, tensors, extra_in, outs, eps):
    x = tensors[0]
    n, h_dim = x.numel() // x.shape[-1], x.shape[-1]
    lib = _build.load("ln_quant", _SIGNATURES)
    code = getattr(lib, entry)(
        *(t.data_ptr() for t in tensors + extra_in + outs), n, h_dim,
        float(eps), _DTYPES[x.dtype],
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(code, entry)


def ln_quant_static(x, res, scale, bias, eps: float, ascale: torch.Tensor):
    """The static-scale kernel (TPU ``_kernel_static``): (h, xi)."""
    tensors = _prepare(x, res, scale, bias, "ln_quant_static")
    ascale = torch.as_tensor(ascale, dtype=torch.float32, device=x.device)
    if ascale.numel() != 1:
        raise ValueError(f"ln_quant_static: ascale has {ascale.numel()} "
                         "elements, want one")
    h = torch.empty_like(tensors[0])
    xi = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    _launch("msa_ln_quant_static", tensors, [ascale], [h, xi], eps)
    ln_quant_static.launches += 1
    return h, xi


def ln_quant_dynamic(x, res, scale, bias, eps: float):
    """The per-row-scale kernel (TPU ``_kernel_dynamic``): (h, xi, row)."""
    tensors = _prepare(x, res, scale, bias, "ln_quant_dynamic")
    h = torch.empty_like(tensors[0])
    xi = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    row = torch.empty(x.shape[:-1] + (1,), dtype=torch.float32,
                      device=x.device)
    _launch("msa_ln_quant_dynamic", tensors, [], [h, xi, row], eps)
    ln_quant_dynamic.launches += 1
    return h, xi, row


ln_quant_static.launches = 0
ln_quant_dynamic.launches = 0
