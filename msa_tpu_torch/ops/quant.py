"""int8 weight + activation quantization for the serving path.

Counterpart of ``msa_tpu/ops/quant.py``, in the port's [out, in] weight
layout.  The scheme is the JAX package's:

  * weights: symmetric per-output-channel int8 (absmax / 127), quantized
    once at load time;
  * activations: symmetric int8, per row (dynamic) or at one calibrated
    scale per (layer, projection) (static, ``act_scales_from_stats``);
  * the product accumulates in int32 and is dequantized as
    ``acc * (row * qscale) + bias`` in f32, then cast to the compute dtype.

Only the encoder's six projections (q/k/v/o/wi/wo) are quantized.  The
int8 product is ``torch._int_mm`` (int8 x int8 -> int32): JAX computes it
with ``lax.dot_general`` outside any Pallas kernel.  ``qweight`` is stored
[out, in] contiguous and handed over as its transpose, the column-major
second operand that cuBLAS's int8 GEMM takes, so no call copies it.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

# encoder projections on the int8 path (the [*, H] x [H, *] heavies)
QUANT_LAYER_KEYS = ("q", "k", "v", "o", "wi", "wo")

# Which calibrated activation statistic feeds each projection's static
# scale: q/k/v read the layer's input stream, o the attention context, wi
# the post-attention-LN stream, wo the gelu output.  Keys match the
# per-layer stats of ``bert_encoder(collect_act_stats=True)``.
PROJ_STAT = {"q": "attn_in", "k": "attn_in", "v": "attn_in",
             "o": "ctx", "wi": "mlp_in", "wo": "ffn_act"}

# cuBLAS's int8 GEMM (``torch._int_mm`` on CUDA) takes more than 16 rows
_INT_MM_MIN_ROWS = 17


def quantize_weight(weight: torch.Tensor, eps: float = 1e-12):
    """[..., out, in] weight -> (int8 [..., out, in] contiguous, f32
    per-output-channel scale [..., out]).

    The absmax runs over the input axis; the division is a true one and
    ``torch.round`` rounds half to even, as ``jnp.round`` does, so the
    result is bit-equal to JAX's on the transposed [in, out] kernel.
    """
    w = weight.float()
    scale = w.abs().amax(dim=-1) / 127.0 + eps
    q = torch.clamp(torch.round(w / scale[..., None]), -127, 127)
    return q.to(torch.int8).contiguous(), scale


def quantize_act(x: torch.Tensor, ascale: Optional[torch.Tensor] = None,
                 row_max=None):
    """[..., K] activations -> (int8 [..., K], f32 scale).

    ``ascale`` None: per-row scales [..., 1] = max|x| / 127 + 1e-12.
    ``ascale`` a scalar: that static scale (returned as an f32 tensor);
    values beyond it saturate at +-127.  ``row_max``: under tensor
    parallelism, where ``x`` holds some of the K columns, a callable that
    takes the row absmax to its maximum over the model group, so the scale
    is the whole row's (JAX's reduce over the last axis, which GSPMD makes
    a cross-shard max).

    The division runs in f32 on x widened inside the kernel (a bf16 tensor
    over an f32 one of at least one dimension promotes to f32), which saves
    a pass over the activations and equals ``x.float() / scale``.
    """
    if ascale is None:
        row = torch.linalg.vector_norm(x, float("inf"), dim=-1, keepdim=True,
                                       dtype=torch.float32)
        if row_max is not None:
            row = row_max(row)
        row = row / 127.0 + 1e-12
        q = torch.div(x, row)
    else:
        row = torch.as_tensor(ascale, dtype=torch.float32, device=x.device)
        q = torch.div(x, row.reshape(1))
    q.round_().clamp_(-127, 127)
    return q.to(torch.int8), row


def int8_mm(xi: torch.Tensor, qweight: torch.Tensor) -> torch.Tensor:
    """[M, K] int8 x [N, K] int8 (``qweight``'s layout) -> [M, N] int32.

    On CUDA a product of at most 16 rows is padded to 17 with zero rows:
    cuBLAS's int8 GEMM refuses fewer."""
    m = xi.shape[0]
    if xi.is_cuda and m < _INT_MM_MIN_ROWS:
        xi = torch.cat([xi, xi.new_zeros(_INT_MM_MIN_ROWS - m, xi.shape[1])])
    return torch._int_mm(xi, qweight.t())[:m]


def int8_product(xi: torch.Tensor, qweight: torch.Tensor) -> torch.Tensor:
    """:func:`int8_mm` over the leading dims of ``xi`` [..., K] -> [..., N]
    int32."""
    acc = int8_mm(xi.reshape(-1, xi.shape[-1]), qweight)
    return acc.reshape(*xi.shape[:-1], acc.shape[-1])


def dequantize(acc: torch.Tensor, row, qscale: torch.Tensor,
               bias: torch.Tensor, out_dtype: torch.dtype) -> torch.Tensor:
    """The int32 product ``acc`` [..., N] of activations quantized at
    ``row`` (a scalar or [..., 1] f32) back to ``out_dtype``."""
    row = torch.as_tensor(row, dtype=torch.float32, device=acc.device)
    # acc.float() * (row * qscale) + bias in f32, then the cast, in JAX's
    # order; the int32 -> f32 widening happens inside the multiply and the
    # cast inside the add, which saves two passes and changes no bit
    out = torch.mul(acc, row * qscale.float())
    return torch.add(out, bias.float(),
                     out=torch.empty(out.shape, dtype=out_dtype,
                                     device=out.device))


def int8_matmul_pre(xi: torch.Tensor, row, qweight: torch.Tensor,
                    qscale: torch.Tensor, bias: torch.Tensor,
                    out_dtype: torch.dtype) -> torch.Tensor:
    """The int8 dense for an activation already quantized (``xi`` [..., K]
    int8, e.g. from ``ops/ln_quant.py``) at ``row``: a scalar or [..., 1]
    f32 scale.  Returns [..., N] in ``out_dtype``."""
    return dequantize(int8_product(xi, qweight), row, qscale, bias,
                      out_dtype)


def int8_dense(x: torch.Tensor, qweight: torch.Tensor, qscale: torch.Tensor,
               bias: torch.Tensor,
               ascale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``x`` [..., K] (bf16/f32) through an int8 projection ([N, K]
    ``qweight``, [N] ``qscale``, [N] ``bias``), quantized per row
    (``ascale`` None) or at the static ``ascale``.  Returns x.dtype."""
    xi, row = quantize_act(x, ascale)
    return int8_matmul_pre(xi, row, qweight, qscale, bias, x.dtype)


def act_scales_from_stats(act_stats: Dict[str, torch.Tensor],
                          margin: float = 1.0) -> Dict[str, torch.Tensor]:
    """Per-layer absmax stats ({"attn_in"|"ctx"|"mlp_in"|"ffn_act": [L]})
    -> {projection: [L] f32 static scale}; ``margin`` > 1 leaves headroom
    beyond the calibrated absmax."""
    return {proj: torch.as_tensor(act_stats[stat]).float() * margin / 127.0
            + 1e-12 for proj, stat in PROJ_STAT.items()}


def quantize_bert_params(params, act_stats=None, margin: float = 1.0,
                         fuse_qkv: bool = False):
    """The parameter tree with the encoder projections in int8.

    Each quantized dense becomes {"qweight", "qscale", "bias"} (the bias
    as it was), plus "ascale" (this layer's 0-d static scale) when
    ``act_stats`` is given; everything else is untouched.
    ``models/bert.py::dense`` dispatches on "qweight".

    ``fuse_qkv``: each layer's q, k and v entries become one "qkv" entry,
    as JAX's: qweight [3H, H] (q|k|v on the output axis), qscale and bias
    [3H], and q's static scale as the shared "ascale" (q, k and v read
    the same calibrated input).  ``models/bert.py::bert_layer_int8`` runs
    it as one int8 product feeding the packed attention.
    """
    ascales = (None if act_stats is None
               else act_scales_from_stats(act_stats, margin))
    layers = []
    for i, lp in enumerate(params["bert"]["layers"]):
        lp = dict(lp)
        for key in QUANT_LAYER_KEYS:
            qweight, qscale = quantize_weight(lp[key]["weight"])
            entry = {"qweight": qweight, "qscale": qscale,
                     "bias": lp[key]["bias"]}
            if ascales is not None:
                entry["ascale"] = ascales[key][i].to(qscale.device)
            lp[key] = entry
        if fuse_qkv:
            q, k, v = lp.pop("q"), lp.pop("k"), lp.pop("v")
            fused = {name: torch.cat([q[name], k[name], v[name]], dim=0)
                     for name in ("qweight", "qscale", "bias")}
            if "ascale" in q:
                fused["ascale"] = q["ascale"]
            lp["qkv"] = fused
        layers.append(lp)
    return {**params, "bert": {**params["bert"], "layers": layers}}
