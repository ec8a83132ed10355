"""Analytic FLOPs model for throughput/MFU reporting on the H100.

The same matmul count as ``msa_tpu/utils/flops.py`` (the port's own copy),
with the peak of the card the port runs on: the NVIDIA H100 SXM's dense
bf16 tensor-core rate, 989 TFLOP/s (NVIDIA's data sheet, at the 700 W
power limit).  MFU is stated against that peak whatever the card's
configured power limit; report the limit beside it.
"""

from __future__ import annotations

from ..configs import MMBertConfig

H100_BF16_PEAK_FLOPS = 989e12


def encoder_flops(batch: int, seq: int, hidden: int, inter: int, layers: int) -> float:
    """Forward matmul FLOPs for one encoder pass."""
    tokens = batch * seq
    per_token = 2 * (4 * hidden * hidden + 2 * hidden * inter)
    attn = 2 * 2 * batch * seq * seq * hidden  # scores + context
    return layers * (tokens * per_token + attn)


def mmbert_step_flops(cfg: MMBertConfig, batch: int, seq: int,
                      backward: bool = True, gathered_mlm: bool = True,
                      pair_seq: int | None = None) -> float:
    """Matmul FLOPs of one MMBert train step (3 passes + MLM heads).

    ``pair_seq``: frame-level pair length Lp (None = word-aligned, Lp = L);
    the joint passes run over seq + pair_seq tokens.
    """
    b = cfg.bert
    lp = pair_seq if pair_seq is not None else seq
    fwd = encoder_flops(batch, seq, b.hidden_size, b.intermediate_size,
                        b.num_hidden_layers)
    fwd += encoder_flops(2 * batch, seq + lp, b.hidden_size, b.intermediate_size,
                         b.num_hidden_layers)
    if gathered_mlm:
        # masked-position gather: 3 views x cap positions (see mmbert_loss)
        positions = 3 * (int(0.35 * batch * seq) + 16)
    else:
        positions = batch * seq + 2 * batch * 2 * seq
    fwd += 2 * positions * b.hidden_size * b.padded_vocab_size
    fwd += 2 * positions * b.hidden_size * b.hidden_size  # transform dense
    return fwd * (3.0 if backward else 1.0)
