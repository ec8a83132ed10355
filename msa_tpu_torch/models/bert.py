"""BERT encoder core as plain functions over a parameter tree of tensors.

Counterpart of ``msa_tpu/models/bert.py``: post-LN layers with LayerNorm
and softmax in f32 and matmuls in the compute dtype, dropout at the
embedding, attention-output and FFN-output sites (``ops/dropout.py``) and
inside the attention kernels, and optional per-layer rematerialisation.
Layers are a list of per-layer dicts (the JAX tree stacks them on a
leading axis and scans; PyTorch runs a loop).  Dense layers hold ``weight``
[out, in] and ``bias`` [out], as ``torch.nn.functional.linear`` takes them
(``models/weights.py`` transposes the JAX [in, out] kernels), or, on the
int8 serving path, ``qweight`` / ``qscale`` / ``bias`` [/ ``ascale``]
(``ops/quant.py``).

Randomness: a training forward takes a host ``torch.Generator`` and draws
one integer seed per dropout site from it, in a fixed order; each site
seeds its own draw (or the attention kernel's Philox mask) from that
integer.  A layer therefore receives its seeds as arguments, and the
recompute of a checkpointed layer reproduces its dropout exactly.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..configs import BertConfig
from ..ops.attention import multi_head_attention
from ..ops.dropout import draw_seed, dropout, seeded_generator
from ..ops.ln_quant import ln_quant
from ..ops.quant import int8_dense, int8_matmul_pre, quantize_act

STATS = ("attn_in", "ctx", "mlp_in", "ffn_act")

Params = Dict[str, Any]


def layer_norm(x: torch.Tensor, p: Params, eps: float) -> torch.Tensor:
    """f32 LayerNorm; output cast back to the input dtype."""
    y = F.layer_norm(x.float(), x.shape[-1:], p["scale"].float(),
                     p["bias"].float(), eps)
    return y.to(x.dtype)


def dense(x: torch.Tensor, p: Params) -> torch.Tensor:
    if "qweight" in p:  # int8 serving path (ops/quant.py)
        return int8_dense(x, p["qweight"], p["qscale"], p["bias"],
                          p.get("ascale"))
    return F.linear(x, p["weight"].to(x.dtype), p["bias"].to(x.dtype))


def gelu(x: torch.Tensor, exact: bool = False) -> torch.Tensor:
    """BERT's gelu: the tanh approximation in bf16 unless ``exact``
    (``BertConfig.exact_gelu``), exact erf otherwise (as the JAX package)."""
    tanh = x.dtype == torch.bfloat16 and not exact
    return F.gelu(x, approximate="tanh" if tanh else "none")


def site_dropout(x: torch.Tensor, rate: float,
                 seed: Optional[int]) -> torch.Tensor:
    """Hidden dropout at one site, drawing from a generator seeded with
    ``seed`` on ``x``'s device; identity when ``seed`` is None."""
    if seed is None or rate == 0.0:
        return x
    return dropout(x, rate, seeded_generator(seed, x.device))


def bert_embeddings(params: Params, input_ids: torch.Tensor, cfg: BertConfig,
                    *, compute_dtype: torch.dtype = torch.float32,
                    seed: Optional[int] = None) -> torch.Tensor:
    """Word + position + type-0 embeddings -> LN -> dropout.  [B, S, H].

    Every token has segment 0: no caller of the JAX ``bert_embeddings``
    passes token types, and the joint passes zero them by definition.
    ``seed`` None is the deterministic forward.
    """
    p = params["embeddings"]
    word = F.embedding(input_ids, p["word"]).to(compute_dtype)
    pos = p["position"][:input_ids.shape[-1]].to(compute_dtype)
    x = word + pos[None, :, :] + p["type"][0].to(compute_dtype)
    x = layer_norm(x, p["ln"], cfg.layer_norm_eps)
    return site_dropout(x, cfg.hidden_dropout_prob, seed)


def _absmax(x: torch.Tensor) -> torch.Tensor:
    return x.abs().amax().float()  # exact in any float dtype


def bert_layer(lp: Params, h: torch.Tensor, attn_bias: torch.Tensor,
               cfg: BertConfig, *, use_flash: str = "auto",
               seeds: Optional[Tuple[int, int, int]] = None,
               stats: Optional[Dict[str, list]] = None) -> torch.Tensor:
    """One post-LN transformer layer (the split q/k/v branch of the JAX
    ``bert_encoder`` layer body).  ``seeds``: (attention probs, attention
    output, FFN output) dropout seeds; None is the deterministic layer.
    ``stats``: lists that gain this layer's absmax of each int8 site's
    input (``STATS``), for static-scale calibration."""
    attn_seed, post_seed, mlp_seed = seeds if seeds is not None else (None,) * 3
    if stats is not None:
        stats["attn_in"].append(_absmax(h))
    ctx = multi_head_attention(
        dense(h, lp["q"]), dense(h, lp["k"]), dense(h, lp["v"]), attn_bias,
        num_heads=cfg.num_attention_heads,
        dropout_rate=cfg.attention_probs_dropout_prob, seed=attn_seed,
        deterministic=seeds is None, use_flash=use_flash)
    if stats is not None:
        stats["ctx"].append(_absmax(ctx))
    attn_out = site_dropout(dense(ctx, lp["o"]), cfg.hidden_dropout_prob,
                            post_seed)
    h = layer_norm(h + attn_out, lp["attn_ln"], cfg.layer_norm_eps)
    if stats is not None:
        stats["mlp_in"].append(_absmax(h))
    up = gelu(dense(h, lp["wi"]), cfg.exact_gelu)
    if stats is not None:
        stats["ffn_act"].append(_absmax(up))
    down = site_dropout(dense(up, lp["wo"]), cfg.hidden_dropout_prob, mlp_seed)
    return layer_norm(h + down, lp["mlp_ln"], cfg.layer_norm_eps)


def bert_layer_int8(lp: Params, h: torch.Tensor, attn_bias: torch.Tensor,
                    cfg: BertConfig, *, use_flash: str = "auto",
                    xi_attn: Optional[torch.Tensor] = None,
                    next_ascale: Optional[torch.Tensor] = None):
    """The deterministic int8 serving layer with the fused LayerNorm +
    quantize sites (``ops/ln_quant.py``).  Returns (h, int8 view of h or
    None).

    * mlp_in: the post-attention LayerNorm emits the stream and wi's int8
      view in one pass (at wi's static scale, or per row).
    * attn_in (``xi_attn`` given): q, k and v read this layer's int8 input,
      quantized at q's static scale, and are all dequantized against q's
      scale; the closing LayerNorm then emits the next layer's view at
      ``next_ascale``.  Without ``next_ascale`` it is a plain LayerNorm.
    * otherwise (per-row scales) q, k and v share one quantize of h: three
      would give the same int8 view, as XLA's CSE makes of JAX's three
      ``int8_dense`` calls.
    """
    eps = cfg.layer_norm_eps
    if xi_attn is None:
        xi_attn, row = quantize_act(h)
    else:
        row = lp["q"]["ascale"]
    q, k, v = (int8_matmul_pre(xi_attn, row, lp[n]["qweight"], lp[n]["qscale"],
                               lp[n]["bias"], h.dtype) for n in ("q", "k", "v"))
    ctx = multi_head_attention(q, k, v, attn_bias,
                               num_heads=cfg.num_attention_heads,
                               use_flash=use_flash)
    wi = lp["wi"]
    h, xi, row = ln_quant(h, dense(ctx, lp["o"]), lp["attn_ln"], eps,
                          wi.get("ascale"))
    up = int8_matmul_pre(xi, row if row is not None else wi["ascale"],
                         wi["qweight"], wi["qscale"], wi["bias"], h.dtype)
    down = dense(gelu(up, cfg.exact_gelu), lp["wo"])
    if next_ascale is None:
        return layer_norm(h + down, lp["mlp_ln"], eps), None
    h, xi_next, _ = ln_quant(h, down, lp["mlp_ln"], eps, next_ascale)
    return h, xi_next


def bert_encoder(params: Params, hidden: torch.Tensor, attn_bias: torch.Tensor,
                 cfg: BertConfig, *, use_flash: str = "auto",
                 generator: Optional[torch.Generator] = None,
                 remat: bool = False, collect_act_stats: bool = False):
    """``hidden`` [B, S, H]; ``attn_bias`` additive [B, 1, 1, S].

    ``generator``: a host generator for a training forward (three seeds per
    layer are drawn from it, in layer order); None is deterministic.
    ``remat=True`` checkpoints each layer (the JAX ``full`` policy): one
    non-reentrant ``torch.utils.checkpoint`` per layer, which keeps only the
    layer's input and recomputes the rest in the backward.

    ``collect_act_stats=True`` (int8 static-scale calibration) returns
    ``(hidden, stats)``: {"attn_in", "ctx", "mlp_in", "ffn_act"} -> [L] f32
    absmax of the inputs of each quantized projection class.

    int8 parameters on the deterministic path, without remat or stats,
    take :func:`bert_layer_int8`; with static scales, each layer's closing
    LayerNorm also emits the next layer's int8 view (layer 0's is one
    standalone quantize; the last layer's, at layer 0's scale, is
    discarded, as JAX's scan computes it).
    """
    layers = params["layers"]
    if generator is None and not remat and not collect_act_stats and \
            "qweight" in layers[0]["wi"]:
        n = len(layers)
        chain = "ascale" in layers[0]["q"]  # static scales, every projection
        xi = quantize_act(hidden, layers[0]["q"]["ascale"])[0] if chain else None
        for i, lp in enumerate(layers):
            hidden, xi = bert_layer_int8(
                lp, hidden, attn_bias, cfg, use_flash=use_flash, xi_attn=xi,
                next_ascale=layers[(i + 1) % n]["q"]["ascale"] if chain else None)
        return hidden
    stats = {k: [] for k in STATS} if collect_act_stats else None
    for lp in layers:
        seeds = (None if generator is None
                 else tuple(draw_seed(generator) for _ in range(3)))
        if remat:
            hidden = checkpoint(bert_layer, lp, hidden, attn_bias, cfg,
                                use_flash=use_flash, seeds=seeds, stats=stats,
                                use_reentrant=False)
        else:
            hidden = bert_layer(lp, hidden, attn_bias, cfg,
                                use_flash=use_flash, seeds=seeds, stats=stats)
    if collect_act_stats:
        return hidden, {k: torch.stack(v) for k, v in stats.items()}
    return hidden


def bert_pooler(params: Params, hidden: torch.Tensor) -> torch.Tensor:
    """tanh(dense(first token)), the tanh in f32."""
    first = dense(hidden[:, 0], params["pooler"])
    return torch.tanh(first.float()).to(hidden.dtype)


def extended_attention_mask(mask: torch.Tensor) -> torch.Tensor:
    """[B, S] 1/0 mask -> additive f32 [B, 1, 1, S] bias (0 keep, -10000
    drop, the reference's fill)."""
    return ((1.0 - mask.to(torch.float32)) * -10000.0)[:, None, None, :]
