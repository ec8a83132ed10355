"""BERT encoder core as plain functions over a parameter tree of tensors.

Counterpart of ``msa_tpu/models/bert.py`` for the deterministic forward
(serving): no dropout, no remat, no int8.  LayerNorm and softmax run in
f32, matmuls in the compute dtype.  Layers are a list of per-layer dicts
(the JAX tree stacks them on a leading axis and scans; PyTorch runs a
loop).  Dense layers hold ``weight`` [out, in] and ``bias`` [out], as
``torch.nn.functional.linear`` takes them (``models/weights.py`` transposes
the JAX [in, out] kernels).
"""

from __future__ import annotations

from typing import Any, Dict

import torch
import torch.nn.functional as F

from ..configs import BertConfig

from ..ops.attention import multi_head_attention

Params = Dict[str, Any]


def layer_norm(x: torch.Tensor, p: Params, eps: float) -> torch.Tensor:
    """f32 LayerNorm; output cast back to the input dtype."""
    y = F.layer_norm(x.float(), x.shape[-1:], p["scale"].float(),
                     p["bias"].float(), eps)
    return y.to(x.dtype)


def dense(x: torch.Tensor, p: Params) -> torch.Tensor:
    return F.linear(x, p["weight"].to(x.dtype), p["bias"].to(x.dtype))


def gelu(x: torch.Tensor, exact: bool = False) -> torch.Tensor:
    """BERT's gelu: the tanh approximation in bf16 unless ``exact``
    (``BertConfig.exact_gelu``), exact erf otherwise (as the JAX package)."""
    tanh = x.dtype == torch.bfloat16 and not exact
    return F.gelu(x, approximate="tanh" if tanh else "none")


def bert_embeddings(params: Params, input_ids: torch.Tensor, cfg: BertConfig,
                    *, compute_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Word + position + type-0 embeddings -> LN.  [B, S, H].

    Every token has segment 0: no caller of the JAX ``bert_embeddings``
    passes token types, and the joint passes zero them by definition.
    """
    p = params["embeddings"]
    word = F.embedding(input_ids, p["word"]).to(compute_dtype)
    pos = p["position"][:input_ids.shape[-1]].to(compute_dtype)
    x = word + pos[None, :, :] + p["type"][0].to(compute_dtype)
    return layer_norm(x, p["ln"], cfg.layer_norm_eps)


def bert_layer(lp: Params, h: torch.Tensor, attn_bias: torch.Tensor,
               cfg: BertConfig, *, use_flash: str = "auto") -> torch.Tensor:
    """One post-LN transformer layer (the split q/k/v branch of the JAX
    ``bert_encoder`` layer body)."""
    ctx = multi_head_attention(
        dense(h, lp["q"]), dense(h, lp["k"]), dense(h, lp["v"]), attn_bias,
        num_heads=cfg.num_attention_heads, use_flash=use_flash)
    h = layer_norm(h + dense(ctx, lp["o"]), lp["attn_ln"], cfg.layer_norm_eps)
    up = gelu(dense(h, lp["wi"]), cfg.exact_gelu)
    return layer_norm(h + dense(up, lp["wo"]), lp["mlp_ln"], cfg.layer_norm_eps)


def bert_encoder(params: Params, hidden: torch.Tensor, attn_bias: torch.Tensor,
                 cfg: BertConfig, *, use_flash: str = "auto") -> torch.Tensor:
    """``hidden`` [B, S, H]; ``attn_bias`` additive [B, 1, 1, S]."""
    for lp in params["layers"]:
        hidden = bert_layer(lp, hidden, attn_bias, cfg, use_flash=use_flash)
    return hidden


def bert_pooler(params: Params, hidden: torch.Tensor) -> torch.Tensor:
    """tanh(dense(first token)), the tanh in f32."""
    first = dense(hidden[:, 0], params["pooler"])
    return torch.tanh(first.float()).to(hidden.dtype)


def extended_attention_mask(mask: torch.Tensor) -> torch.Tensor:
    """[B, S] 1/0 mask -> additive f32 [B, 1, 1, S] bias (0 keep, -10000
    drop, the reference's fill)."""
    return ((1.0 - mask.to(torch.float32)) * -10000.0)[:, None, None, :]
