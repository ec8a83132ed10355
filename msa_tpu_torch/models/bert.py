"""BERT encoder core as plain functions over a parameter tree of tensors.

Counterpart of ``msa_tpu/models/bert.py``: post-LN layers with LayerNorm
and softmax in f32 and matmuls in the compute dtype, dropout at the
embedding, attention-output and FFN-output sites (``ops/dropout.py``) and
inside the attention kernels, and the named rematerialisation policies
(:func:`remat_layer`).
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

Rematerialisation (``remat_policy``, JAX's ``jax.checkpoint`` policies of
``bert_encoder``): each policy saves what JAX's saves and recomputes the
rest.  The layer is split into regions; a region that the policy
recomputes runs under its own non-reentrant ``torch.utils.checkpoint``,
whose inputs -- the values the policy saves -- stay alive until the
backward, and what a policy saves stays outside the regions.  JAX's names
map to the port's values as follows:

* ``attn_io``: q, k, v (the attention Function keeps them);
* ``attn_ctx`` / ``attn_lse``: the attention output and the kernel's own
  residuals (the f32 output and the row lse of the short and flash2
  kernels), kept by its autograd Function, so a policy that saves them
  never re-runs the attention forward;
* ``narrow``: the attention projection's output and the post-attention
  LayerNorm's output; ``ffn_wide``: the FFN's up-projection and its gelu;
* ``drop_mask`` (``+drop``): the two hidden-dropout bool masks, drawn
  before the layer and handed to the regions, so a recompute draws
  nothing; without it a recompute redraws them from the site's seed;
* ``attn_probs`` (``+probs``): the signed probabilities of the short
  kernel (``short_attention_probs``), whose backward then reads them;
* ``attn_pack`` (``save_pack``): the packed [*, 3H] q|k|v of
  ``short_attention_packed``.

``+probs`` and ``save_pack`` change kernels only on the short-attention
route (``ops/attention.py::attention_route``); elsewhere -- the flash2
route, the plain route of the CPU or ``use_flash="never"`` -- they act as
their base (``save_pack`` as ``save_attn``), as JAX's do where its short
kernel does not run.  Selective activation checkpointing
(``create_selective_checkpoint_contexts``) sees only dispatcher ops and
could not cache the attention kernels, which are ctypes calls inside
autograd Functions; hence the regions.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..configs import BertConfig
from ..ops.attention import (attention_route, multi_head_attention,
                             packed_attention)
from ..ops.dropout import (apply_dropout_mask, draw_seed, dropout,
                           dropout_mask, seeded_generator, shard_seed)
from ..ops.ln_quant import ln_quant
from ..ops.quant import int8_dense, int8_matmul_pre, quantize_act

STATS = ("attn_in", "ctx", "mlp_in", "ffn_act")
# JAX's remat policy bases (msa_tpu/models/bert.py); "none" is the port's
# no-checkpointing rung.  "+drop" / "+probs" compose only with the bases in
# SUFFIX_BASES, as in JAX.
REMAT_BASES = ("full", "dots", "save_small", "save_wide", "save_attn",
               "save_ctx", "save_pack")
SUFFIX_BASES = ("full", "save_small", "save_attn", "save_ctx", "save_pack",
                "save_wide")

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


def site_dropout(x: torch.Tensor, rate: float, site) -> torch.Tensor:
    """Hidden dropout at one site.  ``site``: None (identity), an int seed
    (the mask is drawn from a generator seeded with it on ``x``'s device)
    or a bool keep mask from :func:`site_mask` (applied, nothing drawn)."""
    if site is None or rate == 0.0:
        return x
    if isinstance(site, torch.Tensor):
        return apply_dropout_mask(x, site, rate)
    return dropout(x, rate, seeded_generator(site, x.device))


def site_mask(shape, rate: float, seed: Optional[int], device):
    """The keep mask :func:`site_dropout` would draw from ``seed`` for a
    tensor of ``shape`` (None when there is no dropout)."""
    if seed is None or rate == 0.0:
        return None
    return dropout_mask(shape, rate, seeded_generator(seed, device), device)


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


def _qkv(lp: Params, h: torch.Tensor):
    if "qkv" in lp:  # the fused int8 projection (ops/quant.py fuse_qkv)
        return dense(h, lp["qkv"]).chunk(3, dim=-1)
    return dense(h, lp["q"]), dense(h, lp["k"]), dense(h, lp["v"])


def _attend(q, k, v, attn_bias, cfg: BertConfig, use_flash: str,
            seed: Optional[int], **kernel):
    return multi_head_attention(
        q, k, v, attn_bias, num_heads=cfg.num_attention_heads,
        dropout_rate=cfg.attention_probs_dropout_prob, seed=seed,
        deterministic=seed is None, use_flash=use_flash, **kernel)


def _attn_ln(lp: Params, h, attn_out, cfg: BertConfig, drop):
    """The post-attention LayerNorm over the residual and the dropped
    attention projection."""
    return layer_norm(h + site_dropout(attn_out, cfg.hidden_dropout_prob,
                                       drop),
                      lp["attn_ln"], cfg.layer_norm_eps)


def _ffn_ln(lp: Params, h1, down, cfg: BertConfig, drop):
    """The closing LayerNorm over the residual and the dropped FFN output."""
    return layer_norm(h1 + site_dropout(down, cfg.hidden_dropout_prob, drop),
                      lp["mlp_ln"], cfg.layer_norm_eps)


def _ffn(lp: Params, h1, cfg: BertConfig, drop):
    up = gelu(dense(h1, lp["wi"]), cfg.exact_gelu)
    return _ffn_ln(lp, h1, dense(up, lp["wo"]), cfg, drop)


def _post_attention(lp: Params, h, ctx, cfg: BertConfig, drop1, drop2):
    """The layer from the attention output on."""
    return _ffn(lp, _attn_ln(lp, h, dense(ctx, lp["o"]), cfg, drop1), cfg,
                drop2)


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
    if stats is None:
        return _post_attention(
            lp, h, _attend(*_qkv(lp, h), attn_bias, cfg, use_flash, attn_seed),
            cfg, post_seed, mlp_seed)
    stats["attn_in"].append(_absmax(h))
    ctx = _attend(*_qkv(lp, h), attn_bias, cfg, use_flash, attn_seed)
    stats["ctx"].append(_absmax(ctx))
    h = _attn_ln(lp, h, dense(ctx, lp["o"]), cfg, post_seed)
    stats["mlp_in"].append(_absmax(h))
    up = gelu(dense(h, lp["wi"]), cfg.exact_gelu)
    stats["ffn_act"].append(_absmax(up))
    return _ffn_ln(lp, h, dense(up, lp["wo"]), cfg, mlp_seed)


def parse_remat_policy(policy: str) -> Tuple[str, bool, bool]:
    """(base, +drop, +probs) of a policy name, the suffixes in any order,
    as JAX parses them; raises for an unknown base or a suffix on a base
    that cannot honour it ("dots", "auto")."""
    base, save_drop, save_probs = policy, False, False
    while True:
        if base.endswith("+drop"):
            save_drop, base = True, base[:-len("+drop")]
        elif base.endswith("+probs"):
            save_probs, base = True, base[:-len("+probs")]
        else:
            break
    if (save_drop or save_probs) and base not in SUFFIX_BASES:
        raise ValueError(
            f"remat_policy suffix (+drop/+probs) does not compose with base "
            f"{base!r}; use one of the save_* named policies or 'full'")
    if base not in REMAT_BASES + ("none",):
        raise ValueError(f"unknown remat_policy {policy!r}")
    return base, save_drop, save_probs


def _region(fn, *args):
    """A region the policy recomputes: its inputs are saved, nothing else.
    Every random draw in a region is seeded from its arguments (or reads a
    saved mask), so the global RNG states need not be stashed and
    restored around the recompute."""
    return checkpoint(fn, *args, use_reentrant=False, preserve_rng_state=False)


def remat_layer(lp: Params, h: torch.Tensor, attn_bias: torch.Tensor,
                cfg: BertConfig, policy: str, *, use_flash: str = "auto",
                seeds: Optional[Tuple[int, int, int]] = None) -> torch.Tensor:
    """:func:`bert_layer` under the remat ``policy`` (a JAX policy name;
    see the module docstring): the same values, with what the policy does
    not save recomputed in the backward."""
    base, save_drop, save_probs = parse_remat_policy(policy)
    attn_seed, drop1, drop2 = seeds if seeds is not None else (None,) * 3
    if save_drop:  # 'drop_mask': draw both masks now, save them
        rate = cfg.hidden_dropout_prob
        drop1 = site_mask(h.shape, rate, drop1, h.device)
        drop2 = site_mask(h.shape, rate, drop2, h.device)
    route = attention_route(use_flash, h.shape[1], h.is_cuda)
    stash = save_probs and route == "short"

    def attend(q, k, v, **kernel):
        return _attend(q, k, v, attn_bias, cfg, use_flash, attn_seed,
                       stash_probs=stash, **kernel)

    if base == "full":
        return _region(lambda x, d1, d2: _post_attention(
            lp, x, attend(*_qkv(lp, x)), cfg, d1, d2), h, drop1, drop2)
    if base == "dots":  # every matmul output; the attention is re-run
        q, k, v = _qkv(lp, h)
        attn_out = _region(lambda *qkv: dense(attend(*qkv), lp["o"]), q, k, v)
        up = _region(lambda x, a: dense(_attn_ln(lp, x, a, cfg, drop1),
                                        lp["wi"]), h, attn_out)
        down = _region(lambda u: dense(gelu(u, cfg.exact_gelu), lp["wo"]), up)
        return _region(lambda x, a, dn: _ffn_ln(
            lp, _attn_ln(lp, x, a, cfg, drop1), dn, cfg, drop2),
            h, attn_out, down)

    if base == "save_pack" and route == "short":
        qkv = torch.cat(_qkv(lp, h), dim=-1)  # 'attn_pack'
        ctx = packed_attention(
            qkv, attn_bias, num_heads=cfg.num_attention_heads,
            dropout_rate=cfg.attention_probs_dropout_prob, seed=attn_seed,
            deterministic=attn_seed is None)
    elif base == "save_ctx" and route == "plain":
        # no kernel residuals to keep: the plain attention is recomputed
        ctx = _region(lambda x: attend(*_qkv(lp, x)), h)
    elif base == "save_ctx":  # q, k, v recomputed, the kernel never re-run
        ctx = attend(*_qkv(lp, h), recompute=lambda: _qkv(lp, h))
    else:
        ctx = attend(*_qkv(lp, h))
    if base in ("save_attn", "save_ctx", "save_pack"):
        return _region(lambda x, c, d1, d2: _post_attention(
            lp, x, c, cfg, d1, d2), h, ctx, drop1, drop2)
    h1 = _region(lambda x, a, d1: _attn_ln(lp, x, a, cfg, d1), h,
                 dense(ctx, lp["o"]), drop1)
    if base == "save_small":
        return _region(lambda x, d2: _ffn(lp, x, cfg, d2), h1, drop2)
    up = gelu(dense(h1, lp["wi"]), cfg.exact_gelu)  # save_wide
    return _region(lambda x, u, d2: _ffn_ln(lp, x, dense(u, lp["wo"]), cfg,
                                            d2), h1, up, drop2)


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
    * a fused "qkv" entry (``fuse_qkv``): one quantize of h (at its static
      scale, or per row) and one [*, 3H] int8 product.  On the short route
      the packed attention kernel reads its thirds in place (JAX's
      ``int8_qkv_direct``); elsewhere the thirds are sliced out.
    """
    eps = cfg.layer_norm_eps
    if "qkv" in lp:
        fused = lp["qkv"]
        xi_attn, row = quantize_act(h, fused.get("ascale"))
        qkv = int8_matmul_pre(xi_attn, row, fused["qweight"], fused["qscale"],
                              fused["bias"], h.dtype)
        if attention_route(use_flash, h.shape[1], h.is_cuda) == "short":
            ctx = packed_attention(qkv, attn_bias,
                                   num_heads=cfg.num_attention_heads)
        else:
            ctx = multi_head_attention(*qkv.chunk(3, dim=-1), attn_bias,
                                       num_heads=cfg.num_attention_heads,
                                       use_flash=use_flash)
    else:
        if xi_attn is None:
            xi_attn, row = quantize_act(h)
        else:
            row = lp["q"]["ascale"]
        q, k, v = (int8_matmul_pre(xi_attn, row, lp[n]["qweight"],
                                   lp[n]["qscale"], lp[n]["bias"], h.dtype)
                   for n in ("q", "k", "v"))
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
                 remat_policy: str = "none", collect_act_stats: bool = False,
                 shard: int = 0):
    """``hidden`` [B, S, H]; ``attn_bias`` additive [B, 1, 1, S].

    ``generator``: a host generator for a training forward (three seeds per
    layer are drawn from it, in layer order, each moved for the data-
    parallel ``shard`` by ``ops.dropout.shard_seed``); None is
    deterministic.
    ``remat_policy``: "none" (nothing checkpointed) or a JAX policy name,
    applied to every layer by :func:`remat_layer`.

    ``collect_act_stats=True`` (int8 static-scale calibration) returns
    ``(hidden, stats)``: {"attn_in", "ctx", "mlp_in", "ffn_act"} -> [L] f32
    absmax of the inputs of each quantized projection class.

    int8 parameters on the deterministic path, without remat or stats,
    take :func:`bert_layer_int8`; with static scales and split q, k, v,
    each layer's closing LayerNorm also emits the next layer's int8 view
    (layer 0's is one standalone quantize; the last layer's, at layer 0's
    scale, is discarded, as JAX's scan computes it).  With a fused "qkv"
    entry each layer quantizes its own input, as JAX's fused path does.
    """
    layers = params["layers"]
    remat = remat_policy != "none"
    if remat:
        parse_remat_policy(remat_policy)
    if generator is None and not remat and not collect_act_stats and \
            "qweight" in layers[0]["wi"]:
        n = len(layers)
        # static scales on every projection, split q/k/v
        chain = "ascale" in layers[0].get("q", {})
        xi = quantize_act(hidden, layers[0]["q"]["ascale"])[0] if chain else None
        for i, lp in enumerate(layers):
            hidden, xi = bert_layer_int8(
                lp, hidden, attn_bias, cfg, use_flash=use_flash, xi_attn=xi,
                next_ascale=layers[(i + 1) % n]["q"]["ascale"] if chain else None)
        return hidden
    stats = {k: [] for k in STATS} if collect_act_stats else None
    for lp in layers:
        seeds = (None if generator is None
                 else tuple(shard_seed(draw_seed(generator), shard)
                            for _ in range(3)))
        if remat:
            hidden = remat_layer(lp, hidden, attn_bias, cfg, remat_policy,
                                 use_flash=use_flash, seeds=seeds)
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
