"""MMBert: the tri-modal model and its joint loss over a tensor tree.

Counterpart of ``msa_tpu/models/mmbert.py`` with ``mlm_scores=False`` (the
MLM CE is always computed at the gathered masked positions): a text pass
over [B, L] and one stacked joint pass over [2B, L+Lp] (text+visual and
text+speech views), then the align, NSP and gated-fusion heads, and
``mmbert_loss`` = alpha * MLM + AP + label - beta * NCE.  The parameter
layout is ``init_mmbert_params``'s (``models/weights.py`` builds or converts
it).

A training forward (``deterministic=False``) takes a host
``torch.Generator`` and draws every dropout seed from it, in this order:
the three embedding sites (text, text+visual, text+speech), the two joint
embeddings, the text encoder's layers, the joint encoder's layers (under
``fuse_text_pass`` the one encoder call's layers).  ``shard`` (a rank's
place on the data axis) moves every seed by ``shard * 1000003``, JAX's
rule for its head-parallel attention, so the ranks of a dp group draw
distinct masks for their local rows; the attention seeds also move by the
model index (``bert_encoder``).

Under tensor parallelism (``mp``, a ``parallel.distributed.ModelParallel``
of the rank's model group; ``params`` its shard) the encoder and the word
embedding split as ``parallel/sharding.py`` lays them out, and the tied MLM
decoder computes the rank's vocabulary columns: ``mlm_logits`` returns a
shard, and the cross entropy reduces over the group (``ops/losses.py``).
Everything else is replicated.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

from ..configs import MMBertConfig
from ..ops import losses as L
from ..ops.dropout import draw_seed, shard_seed
from ..ops.fused_joint_embed import fused_joint_embed
from .bert import (
    Params,
    bert_embeddings,
    bert_encoder,
    bert_pooler,
    dense,
    extended_attention_mask,
    gelu,
    layer_norm,
    site_dropout,
)


def joint_embed(params: Params, text_embeddings: torch.Tensor,
                pair_features: torch.Tensor, proj_name: str,
                cfg: MMBertConfig, *, seed: Optional[int] = None
                ) -> torch.Tensor:
    """LN(concat_seq(text_embeddings, relu(W.pair_features + b))) -> dropout,
    [B, L+Lp, H].

    The LayerNorm covers both halves (the text half is normalised twice, as
    in the reference).  The fused kernel runs on CUDA, its plain version on
    the CPU (``ops/fused_joint_embed.py``); dropout (``joint_dropout_prob``)
    stays a separate op, as in JAX.
    """
    jp = params["joint"]
    x = fused_joint_embed(
        text_embeddings, pair_features.to(text_embeddings.dtype),
        jp[proj_name]["kernel"], jp[proj_name]["bias"], jp["ln"]["scale"],
        jp["ln"]["bias"], cfg.bert.layer_norm_eps)
    return site_dropout(x, cfg.joint_dropout_prob, seed)


def mlm_logits(params: Params, sequence_output: torch.Tensor,
               cfg: MMBertConfig, mp=None) -> torch.Tensor:
    """Tied-decoder MLM head: transform (dense + gelu + LN), then logits
    against the (padded) word embedding table.  Returns float32 [.., Vp]
    (under ``mp`` the rank's [.., Vp / mp] columns: its word rows and
    ``decoder_bias`` shard).

    The decoder product runs in the compute dtype and its output is widened
    to f32; JAX asks XLA for an f32 result of the same bf16 product, so in
    bf16 the logits here carry one more bf16 rounding.
    """
    cp = params["cls"]
    x = dense(sequence_output, cp["transform_dense"])
    x = gelu(x, cfg.bert.exact_gelu)
    x = layer_norm(x, cp["transform_ln"], cfg.bert.layer_norm_eps)
    if mp is not None:  # the input of a vocabulary-split product
        x = mp.copy(x)
    word = params["bert"]["embeddings"]["word"].to(x.dtype)
    return F.linear(x, word).float() + cp["decoder_bias"].float()


def pair_frame_mask(features: torch.Tensor) -> torch.Tensor:
    """A frame is real iff any coordinate is nonzero.  [B, Lp] int32."""
    return (features.abs() > 0).any(dim=-1).to(torch.int32)


def fusion_head(params: Params, pooled_t, pooled_v, pooled_s,
                cfg: MMBertConfig):
    """Gated fusion -> (logits f32, temp)."""
    fp = params["fusion"]

    def gate(pooled, head):
        a = dense(torch.cat([pooled, pooled], dim=1), fp["attn"])
        return dense(torch.relu(a), fp[head])

    fused = torch.cat([pooled_t * gate(pooled_t, "vt"),
                       pooled_v * gate(pooled_v, "vv"),
                       pooled_s * gate(pooled_s, "vs")], dim=1)
    temp = dense(fused, fp["classifier1"])
    logits = dense(temp, fp["classifier2"]).float()
    return logits, temp


def cpc_nce(params: Params, pooled_t, pooled_v, pooled_s, temp,
            weights=None, dp=None) -> torch.Tensor:
    """Sum of the three InfoNCE terms."""
    pp = params["cpc"]
    return (L.infonce(pooled_t, dense(temp, pp["zt"]), weights, dp=dp)
            + L.infonce(pooled_v, dense(temp, pp["zv"]), weights, dp=dp)
            + L.infonce(pooled_s, dense(temp, pp["za"]), weights, dp=dp))


def mmbert_forward(params: Params, text_ids: torch.Tensor,
                   text_mask: torch.Tensor, tv_ids: torch.Tensor,
                   ts_ids: torch.Tensor, visual: torch.Tensor,
                   speech: torch.Tensor, cfg: MMBertConfig, *,
                   compute_dtype: torch.dtype = torch.float32,
                   use_flash: str = "auto", deterministic: bool = True,
                   generator: Optional[torch.Generator] = None,
                   remat_policy: str = "none",
                   collect_act_stats: bool = False,
                   fuse_text_pass: bool = False,
                   shard: int = 0, mp=None) -> Dict[str, torch.Tensor]:
    """Three-view forward.  Returns every head output the serving path and
    the loss read, without MLM logits (the loss gathers them).

    ``deterministic=False`` with a host ``generator`` applies every dropout;
    ``remat_policy`` ("none" or a JAX policy name) applies to every layer
    of both encoder calls (``bert_encoder``).
    ``collect_act_stats=True`` (int8 static-scale calibration) adds
    "act_stats": the per-layer absmax of each quantized projection's input,
    the elementwise max over the text and joint passes (``ops/quant.py``).

    ``fuse_text_pass=True`` zero-pads the text view to L+Lp and stacks all
    three views into one [3B, L+Lp] encoder call instead of [B, L] and
    [2B, L+Lp], as JAX's flag does: the padded keys carry the mask's fill,
    so the text rows' outputs are the unfused ones up to summation order.

    ``mp``: the model group under tensor parallelism (see above).
    """
    bert = params["bert"]
    bcfg = cfg.bert
    b = text_ids.shape[0]
    gen = None if deterministic else generator
    seed = lambda: (None if gen is None  # noqa: E731
                    else shard_seed(draw_seed(gen), shard))
    emb_t = bert_embeddings(bert, text_ids, bcfg, compute_dtype=compute_dtype,
                            seed=seed(), mp=mp)
    emb_tv = bert_embeddings(bert, tv_ids, bcfg, compute_dtype=compute_dtype,
                             seed=seed(), mp=mp)
    emb_ts = bert_embeddings(bert, ts_ids, bcfg, compute_dtype=compute_dtype,
                             seed=seed(), mp=mp)
    joint_v = joint_embed(params, emb_tv, visual, "Wv", cfg, seed=seed())
    joint_s = joint_embed(params, emb_ts, speech, "Ws", cfg, seed=seed())
    mask_v = torch.cat([text_mask.to(torch.int32), pair_frame_mask(visual)], 1)
    mask_s = torch.cat([text_mask.to(torch.int32), pair_frame_mask(speech)], 1)

    encode = lambda x, mask: bert_encoder(  # noqa: E731
        bert, x, extended_attention_mask(mask), bcfg, use_flash=use_flash,
        generator=gen, remat_policy=remat_policy,
        collect_act_stats=collect_act_stats, shard=shard, mp=mp)
    if fuse_text_pass:
        # one encoder call over [3B, L+Lp]
        l, lp = text_ids.shape[1], visual.shape[1]
        seq_all = encode(torch.cat([F.pad(emb_t, (0, 0, 0, lp)), joint_v,
                                    joint_s], 0),
                         torch.cat([F.pad(text_mask.to(torch.int32), (0, lp)),
                                    mask_v, mask_s], 0))
        if collect_act_stats:
            seq_all, act_stats = seq_all
        pooled_all = bert_pooler(bert, seq_all)
        seq_t, seq_j = seq_all[:b, :l], seq_all[b:]
        pooled_t, pooled_v, pooled_s = pooled_all.split(b)
    else:
        # pass 1: text only [B, L]; pass 2: both joint views [2B, L+Lp]
        seq_t = encode(emb_t, text_mask)
        if collect_act_stats:
            seq_t, act_stats = seq_t
        pooled_t = bert_pooler(bert, seq_t)
        seq_j = encode(torch.cat([joint_v, joint_s], 0),
                       torch.cat([mask_v, mask_s], 0))
        if collect_act_stats:
            seq_j, stats_j = seq_j
            act_stats = {k: torch.maximum(v, stats_j[k])
                         for k, v in act_stats.items()}
        pooled_v, pooled_s = bert_pooler(bert, seq_j).split(b)

    align = dense(seq_j[:, 0], params["cls"]["align"]).float()
    nsp_t = dense(pooled_t, params["cls"]["seq_relationship"]).float()
    logits, temp = fusion_head(params, pooled_t, pooled_v, pooled_s, cfg)
    out = {
        "seq_text": seq_t,
        "seq_joint": seq_j,
        "align_visual": align[:b],
        "align_speech": align[b:],
        "nsp_text": nsp_t,
        "pooled_text": pooled_t,
        "pooled_visual": pooled_v,
        "pooled_speech": pooled_s,
        "temp": temp,
        "logits": logits,
    }
    if collect_act_stats:
        out["act_stats"] = act_stats
    return out


def mlm_cap(batch: int, text_len: int) -> int:
    """Masked positions gathered per view: ~2x the expected count (0.15 of
    the positions) plus headroom, as ``mmbert_loss`` sizes it in JAX."""
    return max(int(0.35 * batch * text_len) + 16, 32)


def gathered_mlm_ce(params: Params, seq: torch.Tensor, labels: torch.Tensor,
                    weights: Optional[torch.Tensor], cfg: MMBertConfig,
                    cap: int, dp=None, mp=None) -> torch.Tensor:
    """MLM CE at the masked positions only: up to ``cap`` of them (a static
    count) are gathered and the [cap, H] x [H, V] decoder runs there.  The
    loss equals the dense one whenever the masked count <= cap; positions
    beyond the cap are dropped (``mmbert_loss`` counts them).  ``topk``
    gathers in another order than JAX's ``top_k``; the loss is a sum over
    the gathered set and does not depend on it.
    """
    b, s, h = seq.shape
    flat_seq = seq.reshape(b * s, h)
    flat_lab = labels.reshape(b * s)
    is_masked = (flat_lab != L.IGNORE_INDEX).float()
    idx = torch.topk(is_masked, min(cap, b * s)).indices
    picked = is_masked[idx] > 0
    sel_lab = torch.where(picked, flat_lab[idx], L.IGNORE_INDEX)
    sel_w = None
    if weights is not None:
        sel_w = weights[:, None].expand(b, s).reshape(b * s)[idx]
    return L.cross_entropy(mlm_logits(params, flat_seq[idx], cfg, mp),
                           sel_lab, sel_w, dp=dp, mp=mp)


def mmbert_loss(params: Params, outputs: Dict[str, torch.Tensor],
                mlm_labels_text: torch.Tensor, mlm_labels_tv: torch.Tensor,
                mlm_labels_ts: torch.Tensor, ap_visual: torch.Tensor,
                ap_speech: torch.Tensor, sentiment: torch.Tensor,
                cfg: MMBertConfig, weights: Optional[torch.Tensor] = None,
                compute_mlm: bool = True, dp=None,
                mp=None) -> Dict[str, torch.Tensor]:
    """The joint loss.  ``compute_mlm=False`` skips the MLM CE (the
    deterministic eval path, whose labels are all -100).

    Under ``dp`` (``parallel.distributed.DataParallel``) the outputs are a
    rank's rows of the global batch and every loss is the rank's share of
    the global one (``ops/losses.py``): the shares sum to the global loss.
    The MLM gather cap is sized from the global batch, as JAX's, and
    ``mlm_overflow`` is the rank's own, summed with the other metrics.
    Under ``mp`` the MLM cross entropy runs over vocabulary shards; every
    loss is the same on each rank of the model group."""
    b, l = mlm_labels_text.shape
    # the pair half carries no language, so no MLM supervision there
    lp = outputs["seq_joint"].shape[1] - l
    ignore = torch.full((b, lp), L.IGNORE_INDEX, dtype=mlm_labels_text.dtype,
                        device=mlm_labels_text.device)
    labels_v = torch.cat([mlm_labels_tv, ignore], dim=1)
    labels_s = torch.cat([mlm_labels_ts, ignore], dim=1)

    device = outputs["logits"].device
    mlm_overflow = torch.zeros((), dtype=torch.int32, device=device)
    if not compute_mlm:
        text_mlm = visual_mlm = speech_mlm = torch.zeros((), device=device)
    else:
        seq_j = outputs["seq_joint"]
        cap = mlm_cap(b * (1 if dp is None else dp.size), l)
        text_mlm = gathered_mlm_ce(params, outputs["seq_text"],
                                   mlm_labels_text, weights, cfg, cap, dp, mp)
        visual_mlm = gathered_mlm_ce(params, seq_j[:b], labels_v, weights,
                                     cfg, cap, dp, mp)
        speech_mlm = gathered_mlm_ce(params, seq_j[b:], labels_s, weights,
                                     cfg, cap, dp, mp)
        # no silent caps: count the positions the gather dropped
        for lab in (mlm_labels_text, labels_v, labels_s):
            n_masked = (lab != L.IGNORE_INDEX).sum().to(torch.int32)
            mlm_overflow = mlm_overflow + torch.clamp(n_masked - cap, min=0)
    mlm = (text_mlm + visual_mlm + speech_mlm) / 3.0

    ap = (L.cross_entropy(outputs["align_visual"], ap_visual, weights, dp=dp)
          + L.cross_entropy(outputs["align_speech"], ap_speech, weights,
                            dp=dp)) / 2.0

    logits = outputs["logits"]
    if cfg.regression:
        preds = torch.tanh(logits) if cfg.num_labels == 1 else logits
        label_loss = L.mse(preds.reshape(-1), sentiment, weights, dp=dp)
        pred_out = preds
    else:
        label_loss = L.cross_entropy(logits, sentiment, weights, dp=dp)
        pred_out = torch.argmax(torch.sigmoid(logits), dim=1)

    nce = cpc_nce(params, outputs["pooled_text"], outputs["pooled_visual"],
                  outputs["pooled_speech"], outputs["temp"], weights, dp)
    joint = cfg.alpha * mlm + ap + label_loss - cfg.beta * nce
    return {
        "loss": joint,
        "mlm_loss": mlm,
        "text_mlm_loss": text_mlm,
        "visual_mlm_loss": visual_mlm,
        "speech_mlm_loss": speech_mlm,
        "ap_loss": ap,
        "label_loss": label_loss,
        "nce": nce,
        "mlm_overflow": mlm_overflow,
        "predictions": pred_out,
    }
