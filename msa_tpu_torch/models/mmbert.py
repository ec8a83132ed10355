"""MMBert forward for serving: the tri-modal model over a tensor tree.

Counterpart of ``msa_tpu/models/mmbert.py``'s deterministic forward with
``mlm_scores=False``: a text pass over [B, L] and one stacked joint pass
over [2B, L+Lp] (text+visual and text+speech views), then the align, NSP
and gated-fusion heads.  The parameter layout is ``init_mmbert_params``'s
(``models/weights.py`` builds or converts it).
"""

from __future__ import annotations

from typing import Dict

import torch

from ..configs import MMBertConfig

from ..ops.fused_joint_embed import fused_joint_embed
from .bert import (
    Params,
    bert_embeddings,
    bert_encoder,
    bert_pooler,
    dense,
    extended_attention_mask,
)


def joint_embed(params: Params, text_embeddings: torch.Tensor,
                pair_features: torch.Tensor, proj_name: str,
                cfg: MMBertConfig) -> torch.Tensor:
    """LN(concat_seq(text_embeddings, relu(W.pair_features + b))) -> [B, L+Lp, H].

    The LayerNorm covers both halves (the text half is normalised twice, as
    in the reference).  The fused kernel runs on CUDA, its plain version on
    the CPU (``ops/fused_joint_embed.py``).
    """
    jp = params["joint"]
    return fused_joint_embed(
        text_embeddings, pair_features.to(text_embeddings.dtype),
        jp[proj_name]["kernel"], jp[proj_name]["bias"], jp["ln"]["scale"],
        jp["ln"]["bias"], cfg.bert.layer_norm_eps)


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


def mmbert_forward(params: Params, text_ids: torch.Tensor,
                   text_mask: torch.Tensor, tv_ids: torch.Tensor,
                   ts_ids: torch.Tensor, visual: torch.Tensor,
                   speech: torch.Tensor, cfg: MMBertConfig, *,
                   compute_dtype: torch.dtype = torch.float32,
                   use_flash: str = "auto") -> Dict[str, torch.Tensor]:
    """Three-view forward.  Returns every head output the serving path and
    the loss read, without the MLM logits."""
    bert = params["bert"]
    bcfg = cfg.bert
    b = text_ids.shape[0]
    emb_t = bert_embeddings(bert, text_ids, bcfg, compute_dtype=compute_dtype)
    emb_tv = bert_embeddings(bert, tv_ids, bcfg, compute_dtype=compute_dtype)
    emb_ts = bert_embeddings(bert, ts_ids, bcfg, compute_dtype=compute_dtype)
    joint_v = joint_embed(params, emb_tv, visual, "Wv", cfg)
    joint_s = joint_embed(params, emb_ts, speech, "Ws", cfg)
    mask_v = torch.cat([text_mask.to(torch.int32), pair_frame_mask(visual)], 1)
    mask_s = torch.cat([text_mask.to(torch.int32), pair_frame_mask(speech)], 1)

    # pass 1: text only [B, L]; pass 2: both joint views stacked [2B, L+Lp]
    seq_t = bert_encoder(bert, emb_t, extended_attention_mask(text_mask), bcfg,
                         use_flash=use_flash)
    pooled_t = bert_pooler(bert, seq_t)
    seq_j = bert_encoder(bert, torch.cat([joint_v, joint_s], 0),
                         extended_attention_mask(torch.cat([mask_v, mask_s], 0)),
                         bcfg, use_flash=use_flash)
    pooled_j = bert_pooler(bert, seq_j)
    pooled_v, pooled_s = pooled_j[:b], pooled_j[b:]

    align = dense(seq_j[:, 0], params["cls"]["align"]).float()
    nsp_t = dense(pooled_t, params["cls"]["seq_relationship"]).float()
    logits, temp = fusion_head(params, pooled_t, pooled_v, pooled_s, cfg)
    return {
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
