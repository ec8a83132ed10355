#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (msa_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --flash-times ROOT

Run from the root of a checkout.  ``--flash-times ROOT`` only times the
flash kernels and the joint embed (:func:`time_flash_backwards`) of the
checkout at ROOT (this one's or another's, whose kernels build into
ROOT/build/), so two trees are timed by the same code in one run.  With no
argument, in order, and stopping at the first failure (no phase catches
its own), the script:

  1. requires CUDA and prints the card's name and power limit;
  2. builds the CUDA kernels from msa_tpu_torch/csrc with nvcc (sm_90a),
     one nvcc per source, all started together, prints each source's nvcc
     wall time and what ptxas reports (registers, static shared memory,
     spills) for the bf16 tensor-core kernels of the short attention (the
     v1, v2, v2p and v2s forwards, the v1, v2, v2p, v3 and v2s backwards,
     each at head dim 32 and 64), for the joint embed's tiles and
     flash2's bf16 fused backward and its pre-pass, none of which may
     spill, and for the warpgroup (wgmma) kernels of rows 10, 12 and 13
     (the bf16 forward, the split backward's dq and dk/dv launches, in
     flash2.cu and flash_attention.cu), none of which may spill or have its
     wgmma products serialised;
  3. holds each kernel against its plain PyTorch version on the card, in
     bf16 and f32, and times both (and, where one exists, the PyTorch
     library call that computes the same function):
     * the attention forward at the serving shapes (and a few more), its
       serving and training forms (ctx, the row lse) and the packed forward
       (v2p) at rate 0 and with dropout, each call's form (bf16: tensor
       cores, whole row up to 128 keys, two sweeps above); bf16 also at S =
       12, 128, 130, 200 and 1000;
     * the attention backward (bf16 at S <= 128 on the tensor cores, else
       the CUDA-core pair) through autograd of the entry, against its plain
       rule with JAX's roundings and against autograd through the plain
       version in f32, at rate 0 and at rate 0.1 snapped to t/256, the plain
       versions taking the kernel's exported keep mask;
     * the dropout mask: the export kernel against its plain Philox, the
       keep share, the forward with dropout against the plain version given
       that mask, and seed determinism;
     * the fused joint embedding, also at its tile edges (B=3, Lp=37 at H =
       768, 1000 and 1001, D = 47, 74 and 371);
     * the fused residual + LayerNorm + int8 quantize, static and dynamic,
       at the int8 serving path's row counts;
     * the flash2 forward (frame-level joint shape [32, 1024] in bf16, f32,
       a ragged S=1030, S=4096), and its fused and split backward, each
       forced, against JAX's rule with its roundings
       (``flash_attention2_backward_plain``), against autograd through the
       plain version in f32 and against each other, with and without
       dropout (also at S = 1000 and 2048, both fused by JAX's rule), and
       its dropout against the short kernel's at S=768 under one seed;
     * the '+probs' (v2s) and 'save_pack' (v2p) pairs at the text and
       joint shapes: the v2s forward's ctx and signed probs (their signs
       the exported keep mask) and its backward from its own probs against
       the plain versions (the backward's rounded rule, and autograd in
       f32), v2s's ctx against v2's; the packed forward bit-equal to v2's
       and the packed backward to v3's on the thirds, both against the
       plain versions (the backward's rounded rule, and autograd in f32),
       also at [8, 130] (the CUDA-core backward); the bf16 v2s forward
       (tensor cores) also at S = 12, 128 and, in its two-sweep form, 200
       and 1000, and its backward from those probs at S = 12, 128 (tensor
       cores) and 200 (the CUDA-core pair);
     * the fused AdamW on bert-large's leaf shapes, every pair of
       moment dtypes, with and without a clip scale, an odd length and an
       unaligned leaf, timed beside ``torch.optim.AdamW(fused=True)``; the
       v3 backward pair (``USE_V3_BWD``) against its plain version and the
       v2 backward at the text and joint shapes, its recomputed lse against the
       forward's;
     * the head-split flash attention (``ops.attention.flash_attention``,
       [B, heads, S, 64]) at the frame-level joint shape [32, 16, 1024],
       an odd S=1000 and S=4096, bf16 and f32: the forward and its
       natural-log lse, the backward pair against its plain rule and
       against autograd, with and without dropout, and against flash2 in
       natural layout at the same seed; timed beside SDPA on [B, heads, S,
       d];
     * the v1 short attention (``short_attention_v1``) at the text and
       joint shapes: forward, backward, the same against v2 at one seed,
       and the bytes it keeps for the backward (its inputs) against v2's;
       its bf16 forward (tensor cores) also at S = 8 and 128;
  3a. holds the warpgroup kernels of rows 10, 12 and 13 in bf16 at S =
     1, 70, 127, 129, 1000, 1024, 2048 and 4096, rate 0 and 26/256, head
     dim 64 and 32, both layouts (``phase_wgmma_flash``): the serving and
     training forwards against the plain rule, the split backwards against
     their rounded rules and f32 autograd, their gradients bit-equal
     across two calls;
  3b. probes flash2's fused-backward dq at [32, 1024] bf16 on four more
     inputs: its distance to f32 autograd and to the rounded rule; times
     the flash kernels (flash2's forward, its fused and split backwards,
     the head-split pair) at [32, 1024, 1024] bf16, rate 0 and the
     training dropout, the forwards and backwards at head dim 32, flash2's
     split backward at [2, 4096, 1024], the joint embed at H = 1024 and
     64, and both flash2 backward routes' device time by kernel
     (``torch.profiler``);
  3c. runs every kernel phase of 3 (but the dropout export and AdamW)
     again at head dim 32 (H = 64, 2 heads), ln_quant and the joint embed
     at H = 64;
  3d. JAX's ``tiny`` preset (head dim 32) through ``cli.train --model
     tiny``, the bf16, int8 and int8_static ``Predictor`` and the
     frame-level path (serving, 1 + 2 train steps on flash2 at d = 32);
  4. serves a ragged synthetic MOSI split through the bf16 ``Predictor``
     with a full-width bert-large MMBert (random weights from a seed),
     checks the predictions and the kernel launches per batch, then checks
     an f32 card run against the CPU plain run on a few samples;
  5. pushes JSONL requests (one of them invalid) through ``serve_stream``;
  5b. serves the same split with the same weights in the ``int8`` and
     ``int8_static`` modes (static scales calibrated on a slice of it),
     checks the kernel launches per batch and the int8 GEMM against the
     CPU's (bit-equal), reports samples/s beside bf16's and the gap to the
     bf16 predictions, and checks f32 int8 card runs against the CPU
     (depth cut to INT8_F32_LAYERS); then both modes with
     ``fuse_qkv=True``: 48 packed attention forwards a batch and no v2,
     samples/s in turns with the split projections, the predictions'
     agreement;
  5c. serves a frame-level split (B=16, L=40, Lp=984: joint pass [32,
     1024]) with the same weights through the bf16 ``Predictor``, checks
     the launches per batch (flash2 for the joint pass, the short kernel
     for the text pass) and an f32 card run against the CPU at cut depth;
  5d. writes the weights as a checkpoint with the port's
     ``save_checkpoint`` and runs ``python -m msa_tpu_torch.cli.serve
     --quantize int8_static`` on it as a subprocess, checking its answers
     against the in-process ``Predictor.from_checkpoint``;
  6. trains bert-large in bf16 at B=96, L=40 (MOSI widths, the default
     dropouts, MLM on) through ``Trainer`` over a synthetic split, checks
     finite losses, moved parameters and the kernel launches per step,
     reports ms/step, samples/s, MFU and peak memory, and runs the
     deterministic eval step on the trained weights;
  6b. trains bert-large in bf16 in frame-level mode (B=16, L=40, Lp=984)
     for 2+4 steps with the fused flash2 backward, and one step at Lp=4056
     (S=4096, depth cut to 2 layers), where the split backward runs,
     checking the launches per step, losses and moved parameters;
  6c. trains bert-large bf16 at B=96 under each remat rung (none, full,
     full+drop, dots, save_small, save_wide, save_attn, save_attn+drop,
     save_ctx, save_ctx+drop, save_pack, save_attn+drop+probs) from the
     same weights and seed: losses against the no-remat run's, ms/step,
     peak memory and launches per step ('full' and 'dots' run each
     attention forward twice, every save_* rung once; '+probs' runs only
     the v2s pair, 'save_pack' only the packed pair); then frame level
     (B=16, Lp=984) under none, save_attn+drop and save_ctx, flash2's
     forward not re-run; then B=96 with ``fused_optimizer=True``
     against the foreach AdamW under none and full (one fused AdamW launch
     per leaf and step), and with ``USE_V3_BWD`` against v2 under none and
     save_attn (ms/step, peak, bytes kept, losses);
  6d. 'auto': no checkpointing at B=96, JAX's ladder (save_attn+drop) at
     the smallest batch whose activation estimate passes half the card's
     memory, and one step there;
  6d'. the frame-level path with ``ops.attention.USE_FLASH2 = False`` (the
     joint pass on the head-split kernels): serving against the flash2
     Predictor on the same weights (24 head-split forwards a batch), 1+3
     train steps against flash2 from the same weights and seeds (24
     forwards and 24 + 24 backward launches a step), one step under
     save_ctx, and the f32 frame-level train steps card against CPU;
  6e. the training entry point: ``python -m msa_tpu_torch.cli.train``'s
     flow at bert-large B=96 for two epochs with checkpoints, ``--resume``
     from the first epoch's checkpoint (its second epoch ends on the
     uninterrupted run's parameters bit for bit), then ``cli.sample`` and
     ``cli.score`` on the result;
  7. runs two f32 train steps of a small model on the card (TF32 off) and
     on the CPU from the same weights and MLM masks, and compares the
     losses, the first step's gradients and the updated parameters; then
     the same in frame-level mode at S=1024 (flash2 in f32).

The line before the last is a JSON summary of the kernels; the last line is
``{"ok": true, "device": {...}}``.  Without CUDA, or without the package
beside it, the script exits non-zero before printing any result.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import dataclasses
import io
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time

# Tolerances of the kernel-vs-plain comparisons on the card.
#  * f32: both sides are f32 throughout and differ in summation order.
#  * bf16 forward: both round to bf16 at the end; the plain attention also
#    rounds the probabilities to bf16 before the PV product (as the JAX
#    reference does), as do the bf16 forwards (v1, v2, v2p and v2s, all on
#    the tensor cores).  About one bf16 ulp.
#  * gradients: every backward kernel rounds dS and the dropped p to bf16
#    before their products, as JAX's do, so each is held against its plain
#    rule with those roundings (evaluated in f32 on the same values) at
#    the tolerance: the rest differs by the rounding of the bf16 outputs
#    (2^-9 relative) and summation order, 1e-2 relative is ~5 ulps.  And
#    against autograd through the plain version in f32 (bf16 inputs
#    widened exactly) within twice the tolerance plus the gap the roundings
#    make in the rule (check_within): at a row with few live keys many
#    large p's sum into a small dv, and their bf16 rounding alone passes
#    1e-2 there.
#  * rows whose keys are all masked: every score carries the -10000 fill,
#    whose f32 ulp (2^-10) quantises the scores differently in the kernels'
#    base-2 domain and the plain natural one.
#  * flash2's fused backward sums dq over key blocks by f32 atomics, in an
#    order that changes from run to run: S/128 partial sums in bf16 (S/64
#    in f32) in f32, ~1e-7 relative, far inside the gradient tolerances;
#    fused and split agree within them too.
ATTN_TOL = {"float32": (1e-4, 1e-4), "bfloat16": (2e-2, 2e-2)}  # (atol, rtol)
GRAD_TOL = {"float32": (2e-4, 2e-4), "bfloat16": (1e-2, 1e-2)}
MASKED_ROW_ATOL = 1e-2
MASKED_ROW_GRAD_ATOL = 5e-2
EMBED_TOL = {"float32": (1e-4, 1e-4), "bfloat16": (1e-2, 1e-2)}
# f32 Predictor on the card (TF32 off) against the CPU plain run: 24 layers
# of f32 in another summation order.
F32_PRED_ATOL = 1e-4
# f32 train steps, card against CPU: losses in relative terms; parameters
# after an Adam step, whose update g / (|g| + 1e-6) turns the summation-order
# noise of a gradient near 1e-6 into a visible share of lr: a tenth of one
# step's lr (5e-4).
F32_LOSS_RTOL = 1e-4
F32_PARAM_ATOL = 5e-5
# the first step's gradients, card against CPU, per leaf in the 2-norm:
# |g_card - g_cpu| <= RTOL |g_cpu| + FLOOR |whole gradient|.  Summation-
# order noise in f32 sits near 1e-6 relative; a leaf off by a constant
# factor is off by |factor - 1| relative.  The floor covers leaves whose
# gradient is zero in exact arithmetic and f32 noise on the card and the
# CPU (the attention key biases: softmax ignores a shift shared by a row).
F32_GRAD_RTOL = 1e-4
F32_GRAD_FLOOR = 1e-6
# ln_quant kernels against their plain version (the CPU test's bounds): h
# in f32 within 1e-6; in bf16 within one bf16 ulp (at most 2^-7 of the
# value), since a 1-ulp difference of the f32 LayerNorm (summation order)
# can flip h's rounding; xi differs in under 0.5 % of the elements and by
# at most one level (flipped ties); the dynamic row scale within 1e-5
# relative in f32 and one bf16 ulp of the row's largest |h| in bf16.
LN_QUANT_H_TOL = {"float32": (1e-6, 1e-6), "bfloat16": (1e-6, 2.0**-7)}
LN_QUANT_ROW_RTOL = {"float32": 1e-5, "bfloat16": 2.0**-7}
LN_QUANT_XI_SHARE = 0.005
# f32 int8 Predictor on the card against the CPU: both quantize the same
# f32 weights bit-equally and the int8 products are exact (checked apart,
# bit-equal), but f32 summation order upstream of each activation quantize
# flips the ties within ~1e-6 of a rounding boundary by one level.  Over
# six full-width layers those flips move the predictions by ~1.5e-3; a
# layout or scale fault moves them by the order of the quantization's own
# effect (~3e-2 against bf16) or of their spread (~0.3).
INT8_F32_PRED_ATOL = 5e-3
INT8_F32_LAYERS = 6   # depth of the f32 int8 card-vs-CPU check (CPU time)
CLI_REQUESTS = 21     # valid JSONL lines of the service CLI phase
CLI_BATCH = 8
ATTN_DROPOUT = 0.1  # snapped to 26/256 on the kernel path
KEEP_SHARE_SIGMAS = 4.0

# frame-level mode (benchmarks/bench_frame_level.py's shape): B=16, L=40,
# Lp=984 native-rate frames, so the joint pass is [32, 1024]
FRAME_BATCH = 16
FRAME_PAIR_LEN = 984
FRAME_SERVE = 3 * FRAME_BATCH - 5   # three batches, the last one ragged
FRAME_WARMUP = 2
FRAME_STEPS = 4
FRAME_F32_LAYERS = 2  # depth of the f32 frame-level card-vs-CPU check
# the long-S step: S = 4096, where JAX's rule takes the split backward
LONG_PAIR_LEN = 4056
LONG_BATCH = 8
LONG_LAYERS = 2

REMAT_RUNGS = ("none", "full", "full+drop", "dots", "save_small", "save_wide",
               "save_attn", "save_attn+drop", "save_ctx", "save_ctx+drop",
               "save_pack", "save_attn+drop+probs")
REMAT_WARMUP, REMAT_STEPS = 1, 6
FRAME_RUNGS = ("none", "save_attn+drop", "save_ctx")
# rungs' bf16 losses against the no-remat run's: the first step's equal
# (v2s within PROBS_LOSS_RTOL: its ctx rounds in another place), the next
# ones within REMAT_LOSS_RTOL (the backward's summation order moves the
# updates by bf16 roundings)
PROBS_LOSS_RTOL = 2e-3
REMAT_LOSS_RTOL = 2e-2
CLI_SYNTHETIC = 2 * 96  # cli.train: two steps an epoch at B=96
# the tiny preset's served predictions must spread at least this much, or
# the int8 and f32 comparisons would compare constants
TINY_PRED_SPREAD = 1e-2

# fused AdamW kernel against its plain version: p within 1e-6 relative,
# each moment within one ulp of its dtype (both sides compute the same
# separately rounded f32 expression, so bit-equality is expected; the
# phase prints whether it held).  Its bound counts 16 f32 operations an
# element (5 products and 3 sums for the moments, 2 quotients, a root, the
# eps sum, the decay product, the sum, the lr product and the difference).
ADAMW_P_RTOL = 1e-6
ULP = {"float32": 2.0 ** -23, "bfloat16": 2.0 ** -7}
ADAMW_OPS = 16
# fused_optimizer and USE_V3_BWD train runs: 1 warm-up + 3 timed steps
# each, from the same weights and seed as the run they are compared with.
# The first step's loss is bit-equal (the same forward before any update);
# the later ones within PR6_LOSS_RTOL: the two optimizers round the update
# differently in f32 (the foreach path divides by a host scalar as a
# multiply by its reciprocal and widens/narrows the bf16 moments in
# separate passes; v3 takes delta from the bf16 ctx instead of the f32
# output), and bf16 training carries such roundings into the loss as the
# remat rungs' backward orders do (REMAT_LOSS_RTOL).
PR6_WARMUP, PR6_STEPS = 1, 3
PR6_LOSS_RTOL = 2e-2
# the head-split flash attention's row lse (natural-log units) against the
# plain logsumexp: the same f32 scores summed in another order, and the
# kernel's base-2 statistics converted by ln 2 (an ulp or two of |lse| ~ 8
# on live rows); rows with every key masked sit near -10000, where an f32
# ulp is 2^-10, under MASKED_ROW_ATOL.
FLASH_LSE_ATOL, FLASH_LSE_RTOL = 1e-4, 1e-5
# the v3 backward's recomputed row lse (log2 units) against the forward's:
# in f32 the CUDA-core pair sums the CUDA-core forward's products in its
# order (bit-equal).  In bf16 the forward runs on the tensor cores: up to
# 128 keys the tensor-core v3 kernel forms its lse as the whole-row forward
# does; above, the CUDA-core pair sums q pre-scaled, 16 keys an update,
# where the forward took mma.sync scores (q . k, then times scale * log2e)
# in 64-key tiles, so the lse moves by an ulp or two of the scores: ~1e-6
# on live rows (|lse| < ~10), and on rows with every key masked (lse near
# -14427, an f32 ulp of 2^-10) by about one ulp of |lse|, ~1e-7 relative.
V3_TC_LSE_TOL = (1e-5, 1e-6)  # (atol, rtol)
# the short forward's training-form lse (log2 units) against the plain
# logsumexp of the f32 scores over ln 2: the kernel's scores come from the
# tensor cores (bf16) or the CUDA cores (f32) in another summation order
# and its statistics in base 2, ~1e-6 on live rows (|lse| < ~15); on rows
# with every key masked the scores and lse sit near -14427, where an f32
# ulp is 2^-10 and the two sides quantise each score apart: about an ulp
# of |lse|, inside the relative bound.
TRAIN_LSE_TOL = (1e-4, 1e-6)  # (atol, rtol)
# frame_flash against the default flash2 path from the same weights: the
# head-split kernels are flash2's with another addressing
# (csrc/flash_kernels.cuh), so the serving predictions are expected
# bit-equal; the bound only has to catch a layout fault, which moves
# predictions by their spread (~0.3).  Training: the warm-up step's loss
# bit-equal (same forward, same masks), later ones within the remat rungs'
# REMAT_LOSS_RTOL (the backward reads bf16 o for delta here, flash2 its f32
# output, and bf16 training carries such roundings into the loss).
FRAME_FLASH_PRED_ATOL = 1e-2
# fuse_qkv serving against the split projections, bf16: int8 (per-row
# scales) computes the same int8 products, scales and epilogue per element
# and the packed kernel is bit-equal to v2 on the thirds, so the
# predictions are equal.  int8_static's split path takes each layer's
# q/k/v input from the fused LayerNorm + quantize kernel, the fused path
# (JAX's too) from the plain LayerNorm and a standalone quantize: h
# differs by a bf16 ulp here and there (LN_QUANT_H_TOL), which flips
# quantization ties by a whole level (a static scale is max|h| / 127),
# i.e. draws another realisation of the quantization noise.  Each
# realisation sits within the quantization's own effect of the bf16
# predictions, so the two within twice the split path's measured gap to
# bf16; a layout or scale fault moves them by their spread.  The fused
# path's arithmetic is held apart by the f32 card-vs-CPU check.

BATCH = 96          # bench.py's batch
TEXT_LEN = 40       # MOSI max_seq_length
N_SERVE = 5 * BATCH - 23  # five batches, the last one ragged
TRAIN_WARMUP = 2
TRAIN_STEPS = 8
HIDDEN, HEADS = 1024, 16

# cycles of the spin kernel that holds the stream while cuda_ms queues its
# timed calls: ~25 ms at the H100's clock, longer than the host takes to
# queue 20 calls of any function timed here
HOLD_CYCLES = 50_000_000

# H100 SXM (NVIDIA's data sheet): HBM rate and dense bf16 / f32 peaks, for
# each kernel's bound (the larger of bytes / rate and FLOPs / peak).
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}


def cuda_ms(fn, iters: int = 20) -> float:
    """Device ms per call of ``fn``.  A spin kernel holds the stream while
    the host queues every timed call, so the host's launch overhead (tens
    of microseconds per wrapper call) does not pace a short kernel."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(HOLD_CYCLES)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(nbytes: float, flops: float, dtype: str):
    """(least time in ms, what bounds it) for moving ``nbytes`` through HBM
    and doing ``flops`` at the card's peak for ``dtype``."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def check_close(name, got, ref, atol, rtol, mask=None) -> float:
    import torch

    got, ref = got.float(), ref.float()
    if mask is not None:
        got, ref = got[mask], ref[mask]
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: non-finite kernel output")
    err = (got - ref).abs()
    bad = err > atol + rtol * ref.abs()
    if bad.any():
        raise AssertionError(
            f"{name}: {int(bad.sum())} elements outside atol={atol} "
            f"rtol={rtol}; max abs err {float(err.max()):.3e}")
    return float(err.max())


def check_within(name, got, want, atol, rtol, gap, mask) -> float:
    """|got - want| within twice (atol + rtol |want|) plus ``gap`` (what a
    rounding the kernel shares with its plain rule moves in that rule) on
    ``mask``; returns the largest difference."""
    diff = (got.float() - want.float()).abs()[mask]
    allowed = (2 * (atol + rtol * want.float().abs()) + gap)[mask]
    if (diff > allowed).any():
        raise AssertionError(f"{name}: {int((diff > allowed).sum())} elements "
                             "beyond twice the bound plus the rounding gap; "
                             f"max abs diff {float(diff.max()):.3e}")
    return float(diff.max())


def attention_inputs(gen, b, s, dtype):
    import torch

    q, k, v = (torch.randn(b, s, HIDDEN, device="cuda", generator=gen)
               .to(dtype) for _ in range(3))
    lengths = torch.randint(1, s + 1, (b,), device="cuda", generator=gen)
    lengths[0] = 0  # a fully masked row, as the Predictor's padding
    mask = (torch.arange(s, device="cuda")[None] < lengths[:, None])
    bias = (1.0 - mask.float()) * -10000.0
    return q, k, v, bias, lengths > 0


@contextlib.contextmanager
def head_widths(hidden, heads):
    """The phases' attention width and head count (the module's HIDDEN and
    HEADS, which every kernel phase reads) set to ``hidden`` and ``heads``
    for the block, restored after it."""
    global HIDDEN, HEADS
    saved = HIDDEN, HEADS
    HIDDEN, HEADS = hidden, heads
    try:
        yield
    finally:
        HIDDEN, HEADS = saved


def sdpa_args(q, k, v, bias):
    """[B, S, H] -> SDPA's [B, heads, S, d] views and an additive mask."""
    b, s, _ = q.shape
    split = lambda x: x.view(b, s, HEADS, -1).transpose(1, 2)  # noqa: E731
    return split(q), split(k), split(v), bias[:, None, None, :].to(q.dtype)


def fwd_form(s, dtype):
    """The form the short forward takes for (S, dtype): csrc/short_attention.cu
    ::fwd_dispatch."""
    import torch

    if dtype != torch.bfloat16:
        return "CUDA cores"
    return "tensor cores, whole row" if s <= 128 else "tensor cores, two-sweep"


def check_train_forward(tag, q, k, v, bias, live, seed, rate, keep,
                        few_keys=False):
    """The short forward's serving and training forms (v2), and the packed
    forward (v2p) on the thirds of one [B, S, 3H] buffer, at one seed: the
    training form's ctx (ATTN_TOL on live rows) and lse (TRAIN_LSE_TOL)
    against ``short_attention_train_forward_plain`` (given the exported
    keep mask); fully masked rows of ctx against it at MASKED_ROW_ATOL or,
    with ``few_keys``, by :func:`check_masked_rows`; the serving ctx equal
    to the training ctx, v2p equal to v2 in both outputs, bit for bit.
    Returns (max abs err of ctx, of lse on rows with a live key, the masked
    rows' (difference, rule gap) or None)."""
    import torch

    from msa_tpu_torch.ops import short_attention as sa
    from msa_tpu_torch.ops.dropout import byte_threshold

    dname = str(q.dtype).split(".")[1]
    atol, rtol = ATTN_TOL[dname]
    t = byte_threshold(rate)
    serve = sa._forward_kernel(q, k, v, bias, HEADS, seed, t, False)[0]
    ctx, lse = sa._forward_kernel(q, k, v, bias, HEADS, seed, t, True)
    qkv = torch.cat([q, k, v], dim=-1)
    packed = sa._packed_forward_kernel(qkv, bias, HEADS, seed, t, True)
    packed_serve = sa._packed_forward_kernel(qkv, bias, HEADS, seed, t, False)[0]
    rctx, rlse = sa.short_attention_train_forward_plain(
        q, k, v, bias, HEADS, rate, keep)
    torch.cuda.synchronize()
    if not torch.equal(serve, ctx):
        raise AssertionError(f"{tag}: serving and training ctx differ")
    if not (all(torch.equal(a, c) for a, c in zip(packed, (ctx, lse)))
            and torch.equal(packed_serve, serve)):
        raise AssertionError(f"{tag}: v2p not bit-equal to v2 on the thirds")
    err = check_close(f"{tag} ctx", ctx, rctx, atol, rtol, mask=live)
    check_close(f"{tag} lse", lse, rlse, *TRAIN_LSE_TOL)
    lse_err = float((lse - rlse)[live].abs().max())  # fully masked rows apart
    masked = None
    if few_keys:
        masked = check_masked_rows(tag, ctx, q, k, v, bias, live, rate, keep)
    else:
        check_close(f"{tag} ctx masked row", ctx, rctx, MASKED_ROW_ATOL, 0.0,
                    mask=~live)
    return err, lse_err, masked


def phase_attention(gen):
    """The short forward (v2) at the serving shapes and a few more, bf16
    and f32: the serving form against the plain version (and SDPA's time),
    the training form (ctx, lse) and the packed forward
    (:func:`check_train_forward`) at rate 0 and with dropout, each call's
    form and the training form's time beside the serving form's (v2p's
    both forms too).  Then bf16
    at B = 4 and S = 12, 128 (whole rows), 130, 200, 1000 (two sweeps), rate
    0 and 26/256, from a generator of its own."""
    import torch
    import torch.nn.functional as F

    from msa_tpu_torch.ops.dropout import quantize_dropout_rate
    from msa_tpu_torch.ops.short_attention import (
        _forward_kernel, _packed_forward_kernel, dropout_keep_mask,
        short_attention, short_attention_plain)

    rate_on = quantize_dropout_rate(ATTN_DROPOUT)
    cases = [("text", BATCH, TEXT_LEN), ("joint", 2 * BATCH, 2 * TEXT_LEN),
             ("s77", 16, 77), ("s130", 8, 130), ("s512", 4, 512),
             ("s768", 4, 768)]  # 512 < S < 1024: XLA's range in JAX
    worst, times = 0.0, {}
    for label, b, s in cases:
        for dtype in (torch.bfloat16, torch.float32):
            dname = str(dtype).split(".")[1]
            q, k, v, bias, live = attention_inputs(gen, b, s, dtype)
            out = short_attention(q, k, v, bias, HEADS)
            ref = short_attention_plain(q, k, v, bias, HEADS)
            torch.cuda.synchronize()
            atol, rtol = ATTN_TOL[dname]
            err = check_close(f"short_attention {label} {dname}", out, ref,
                              atol, rtol, mask=live)
            err_masked = check_close(
                f"short_attention {label} {dname} masked row", out, ref,
                MASKED_ROW_ATOL, 0.0, mask=~live)
            worst = max(worst, err)
            train_err = lse_err = 0.0
            for rate in (0.0, rate_on):
                seed = 2024 + s
                keep = (dropout_keep_mask(seed, rate, b, HEADS, s, "cuda")
                        if rate else None)
                e, le, _ = check_train_forward(
                    f"short_attention training form {label} {dname} rate "
                    f"{rate:g}", q, k, v, bias, live, seed, rate, keep)
                train_err, lse_err = max(train_err, e), max(lse_err, le)
            worst = max(worst, train_err)
            ms = cuda_ms(lambda: short_attention(q, k, v, bias, HEADS))
            train_ms = cuda_ms(lambda: _forward_kernel(q, k, v, bias, HEADS, 0,
                                                       0, True))
            qkv = torch.cat([q, k, v], dim=-1)
            packed_ms = [cuda_ms(lambda: _packed_forward_kernel(
                qkv, bias, HEADS, 0, 0, train)) for train in (False, True)]
            plain_ms = cuda_ms(lambda: short_attention_plain(q, k, v, bias, HEADS))
            sq, sk, sv, sm = sdpa_args(q, k, v, bias)
            lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
                sq, sk, sv, attn_mask=sm))
            itemsize = q.element_size()
            nbytes = 4 * b * s * HIDDEN * itemsize + b * s * 4
            flops = 4 * b * s * s * HIDDEN
            bound = bound_ms(nbytes, flops, dname)
            # the training form also writes the row lse
            train_bound = bound_ms(nbytes + b * HEADS * s * 4, flops, dname)
            times[(label, dname)] = (ms, plain_ms, lib_ms, bound)
            print(f"short_attention [{b},{s},{HIDDEN}] {dname} "
                  f"({fwd_form(s, dtype)}): max_abs_err {err:.3e} (atol "
                  f"{atol}, rtol {rtol}), masked row {err_masked:.3e} (atol "
                  f"{MASKED_ROW_ATOL}); training form (rate 0 and "
                  f"{rate_on:g}) ctx {train_err:.3e}, lse "
                  f"{lse_err:.3e} on live rows (all rows within atol "
                  f"{TRAIN_LSE_TOL[0]}, rtol {TRAIN_LSE_TOL[1]}), v2p "
                  f"bit-equal; kernel {ms:.4f} ms "
                  f"(training form {train_ms:.4f} ms, bound "
                  f"{train_bound[0]:.4f} ms; v2p {packed_ms[0]:.4f} / "
                  f"{packed_ms[1]:.4f} ms), plain {plain_ms:.4f} ms, sdpa "
                  f"{lib_ms:.4f} ms, bound {bound[0]:.4f} ms ({bound[1]}, "
                  f"{bound[0] / ms:.1%} of it reached)", flush=True)
    # a generator of their own: the later phases draw the inputs they drew
    # before these shapes were added
    edge_gen = torch.Generator(device="cuda").manual_seed(11)
    for s in (12, 128, 130, 200, 1000):
        for rate in (0.0, rate_on):
            q, k, v, bias, live = attention_inputs(edge_gen, 4, s,
                                                   torch.bfloat16)
            seed = 2024 + s
            keep = (dropout_keep_mask(seed, rate, 4, HEADS, s, "cuda")
                    if rate else None)
            tag = f"short_attention [4,{s},{HIDDEN}] bfloat16 rate {rate:g}"
            err, lse_err, (diff, gap) = check_train_forward(
                tag, q, k, v, bias, live, seed, rate, keep, few_keys=True)
            worst = max(worst, err)
            print(f"{tag} ({fwd_form(s, torch.bfloat16)}): ctx "
                  f"max_abs_err {err:.3e}, lse {lse_err:.3e} on live rows; "
                  f"serving ctx = training ctx, v2p bit-equal; masked rows "
                  f"{diff:.3e} from f32 (the rounding rule {gap:.3e})",
                  flush=True)
    return worst, times


def check_rounded_backward(tag, grads, rule, rule32, auto, live, atol, rtol):
    """A backward kernel's dq, dk, dv against its plain rule with the
    kernel's roundings (``rule``: dS and the dropped p rounded to the
    dtype) at (atol, rtol) on live rows and MASKED_ROW_GRAD_ATOL on fully
    masked rows, and against autograd through the plain forward in f32
    (``auto``) on live rows within twice the tolerance plus the gap those
    roundings make in the rule (|rule - rule32|, ``rule32`` the rule in f32
    throughout; :func:`check_within`).  Returns (max abs err against the
    rule, largest difference to autograd)."""
    err = auto_err = 0.0
    for name, g, r, r32, a in zip(("dq", "dk", "dv"), grads, rule, rule32,
                                  auto):
        err = max(err, check_close(f"{tag} {name}", g, r, atol, rtol,
                                   mask=live))
        check_close(f"{tag} {name} masked row", g, r, MASKED_ROW_GRAD_ATOL,
                    0.0, mask=~live)
        gap = (r.float() - r32.float()).abs()
        auto_err = max(auto_err, check_within(
            f"{tag} {name} against autograd", g, a, atol, rtol, gap, live))
    return err, auto_err


def phase_attention_backward(gen):
    """The v2 backward (row 3; bf16 at S <= 128 one tensor-core launch of
    short_bwd_tc.cuh, else the CUDA-core pair), run through autograd of
    ``short_attention`` (so through the forward form and the tensors its
    route keeps), at rate 0 and with dropout, held by
    :func:`check_rounded_backward` against JAX's ``_bwd_kernel_v2`` rule
    (``short_attention_v1_backward_plain``, dS and the dropped p rounded,
    given the exported keep mask) and against autograd through the plain
    version in f32.  Times the backward alone beside the plain backward,
    SDPA's and the bound."""
    import torch
    import torch.nn.functional as F

    from msa_tpu_torch.ops import short_attention as sa
    from msa_tpu_torch.ops.dropout import byte_threshold, quantize_dropout_rate

    rate_on = quantize_dropout_rate(ATTN_DROPOUT)
    cases = [("text", BATCH, TEXT_LEN), ("joint", 2 * BATCH, 2 * TEXT_LEN),
             ("s130", 8, 130), ("s512", 4, 512), ("s768", 4, 768)]
    worst, times = 0.0, {}
    for label, b, s in cases:
        for dtype in (torch.bfloat16, torch.float32):
            dname = str(dtype).split(".")[1]
            tc = sa.tensor_core_backward(s, dtype)
            cores = "tensor cores" if tc else "CUDA cores"
            for rate in (0.0, rate_on):
                q, k, v, bias, live = attention_inputs(gen, b, s, dtype)
                dout = torch.randn(b, s, HIDDEN, device="cuda",
                                   generator=gen).to(dtype)
                seed = 1234 + s
                keep = (sa.dropout_keep_mask(seed, rate, b, HEADS, s, "cuda")
                        if rate else None)
                qq, kk, vv = (x.detach().requires_grad_() for x in (q, k, v))
                grads = torch.autograd.grad(
                    sa.short_attention(qq, kk, vv, bias, HEADS, rate, seed),
                    (qq, kk, vv), dout)
                wide = [x.detach().float().requires_grad_() for x in (q, k, v)]
                auto = torch.autograd.grad(sa.short_attention_plain(
                    *wide, bias, HEADS, rate, keep), wide, dout.float())
                rule = sa.short_attention_v1_backward_plain(
                    q, k, v, bias, dout, HEADS, rate, keep)
                rule32 = sa.short_attention_v1_backward_plain(
                    *wide, bias, dout.float(), HEADS, rate, keep)
                torch.cuda.synchronize()
                atol, rtol = GRAD_TOL[dname]
                case_err, auto_err = check_rounded_backward(
                    f"short_attention_backward {label} {dname} rate {rate:g}",
                    grads, rule, rule32, auto, live, atol, rtol)
                worst = max(worst, case_err)

                # times: the backward alone against the plain backward alone
                # (autograd through the plain version, graph kept)
                lse = sa._forward_kernel(q, k, v, bias, HEADS, seed,
                                         byte_threshold(rate), not tc)[1]
                ms = cuda_ms(lambda: sa.short_attention_backward(
                    q, k, v, bias, lse, dout, HEADS, seed, rate))
                qq, kk, vv = (x.detach().requires_grad_() for x in (q, k, v))
                out = sa.short_attention_plain(qq, kk, vv, bias, HEADS, rate,
                                               keep)
                plain_ms = cuda_ms(lambda: torch.autograd.grad(
                    out, (qq, kk, vv), dout, retain_graph=True))
                lib_ms = lib_txt = None
                if rate == 0.0:
                    # the library yardstick: SDPA's backward alone, and its
                    # forward + backward, with the additive mask, dropout 0
                    sq, sk, sv, sm = sdpa_args(qq, kk, vv, bias)
                    lib_out = F.scaled_dot_product_attention(sq, sk, sv,
                                                             attn_mask=sm)
                    lib_do = dout.view(b, s, HEADS, -1).transpose(1, 2)
                    lib_ms = cuda_ms(lambda: torch.autograd.grad(
                        lib_out, (qq, kk, vv), lib_do, retain_graph=True))
                    fb_ms = cuda_ms(lambda: torch.autograd.grad(
                        F.scaled_dot_product_attention(sq, sk, sv,
                                                       attn_mask=sm),
                        (qq, kk, vv), lib_do))
                    lib_txt = f"sdpa bwd {lib_ms:.4f} ms, fwd+bwd {fb_ms:.4f} ms"
                # the function's bytes: reads q, k, v, dO and the [B, S] f32
                # bias once, writes dq, dk, dv once.  The row lse that the
                # CUDA-core pair reads from the forward (and delta, which its
                # dq launch hands to dk/dv) are that design's own choice, so
                # the lse is printed apart, not counted.  The products: the
                # scores (recomputed: P is not an input), dP = dO.V^T, dV =
                # P^T.dO, dQ = dS.K, dK = dS^T.Q
                nbytes = 7 * q.element_size() * b * s * HIDDEN + b * s * 4
                extra = b * HEADS * s * 4
                bound = bound_ms(nbytes, 10 * b * s * s * HIDDEN, dname)
                times[(label, dname, rate)] = (ms, plain_ms, lib_ms, bound)
                print(f"short_attention_backward [{b},{s},{HIDDEN}] {dname} "
                      f"({cores}) rate {rate:g}: max_abs_err {case_err:.3e} "
                      f"against the rounded rule (atol {atol}, rtol {rtol}), "
                      f"{auto_err:.3e} against f32 autograd (twice that plus "
                      f"the rounding gap); kernel {ms:.4f} ms, plain "
                      f"{plain_ms:.4f} ms, {lib_txt or 'no sdpa (dropout)'}, "
                      f"bound {bound[0]:.4f} ms ({bound[1]}, "
                      f"{bound[0] / ms:.1%} of it reached"
                      + ("" if tc else f"; the lse read adds "
                         f"{extra / HBM_BYTES_PER_S * 1e3:.4f} ms") + ")",
                      flush=True)
    return worst, times


def phase_dropout(gen):
    """The keep mask on the card: the export kernel against its plain
    Philox, its keep share, the forward with dropout against the plain
    version given the mask, and determinism in the seed."""
    import math

    import torch

    from msa_tpu_torch.ops.dropout import (
        byte_threshold, keep_mask_plain, quantize_dropout_rate)
    from msa_tpu_torch.ops.short_attention import (
        dropout_keep_mask, short_attention, short_attention_plain)

    b, s = 2 * BATCH, 2 * TEXT_LEN  # the joint shape
    rate = quantize_dropout_rate(ATTN_DROPOUT)
    seed = 987654321987
    keep = dropout_keep_mask(seed, rate, b, HEADS, s, "cuda")
    plain = keep_mask_plain(seed, rate, b, HEADS, s, device="cuda")
    torch.cuda.synchronize()
    mismatches = int((keep != plain).sum())
    if mismatches:
        raise AssertionError(f"dropout mask: {mismatches} decisions differ "
                             "from the plain Philox")
    want = 1.0 - byte_threshold(rate) / 256
    share = float(keep.float().mean())
    sigma = math.sqrt(want * (1 - want) / keep.numel())
    if abs(share - want) > KEEP_SHARE_SIGMAS * sigma:
        raise AssertionError(f"keep share {share:.6f}, want {want:.6f} "
                             f"+- {KEEP_SHARE_SIGMAS} x {sigma:.2e}")
    again = dropout_keep_mask(seed, rate, b, HEADS, s, "cuda")
    other = dropout_keep_mask(seed + 1, rate, b, HEADS, s, "cuda")
    if not torch.equal(keep, again) or torch.equal(keep, other):
        raise AssertionError("dropout mask: not a function of the seed")
    mask_ms = cuda_ms(lambda: dropout_keep_mask(seed, rate, b, HEADS, s, "cuda"))
    plain_ms = cuda_ms(lambda: keep_mask_plain(seed, rate, b, HEADS, s,
                                               device="cuda"))
    bound = bound_ms(keep.numel(), 0, "bfloat16")  # writes one byte each
    print(f"dropout_keep_mask [{b},{HEADS},{s},{s}] rate {rate}: bit-equal to "
          f"the plain Philox; keep share {share:.6f} (want {want:.6f} +- "
          f"{KEEP_SHARE_SIGMAS:g} sigma = {KEEP_SHARE_SIGMAS * sigma:.2e}); "
          f"seed-deterministic; kernel {mask_ms:.4f} ms, plain {plain_ms:.4f}"
          f" ms, bound {bound[0]:.4f} ms", flush=True)

    worst = 0.0
    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype).split(".")[1]
        q, k, v, bias, live = attention_inputs(gen, b, s, dtype)
        out = short_attention(q, k, v, bias, HEADS, rate, seed)
        ref = short_attention_plain(q, k, v, bias, HEADS, rate, keep)
        same = short_attention(q, k, v, bias, HEADS, rate, seed)
        diff = short_attention(q, k, v, bias, HEADS, rate, seed + 1)
        torch.cuda.synchronize()
        atol, rtol = ATTN_TOL[dname]
        err = check_close(f"short_attention dropout {dname}", out, ref, atol,
                          rtol, mask=live)
        check_close(f"short_attention dropout {dname} masked row", out, ref,
                    MASKED_ROW_ATOL, 0.0, mask=~live)
        if not torch.equal(out, same) or torch.equal(out, diff):
            raise AssertionError("attention dropout: not a function of the seed")
        worst = max(worst, err)
        print(f"short_attention [{b},{s},{HIDDEN}] {dname} rate {rate}: "
              f"max_abs_err {err:.3e} against the plain version given the "
              "exported mask; same seed bit-equal, next seed differs",
              flush=True)
    return {"mismatches": mismatches, "ms": mask_ms, "plain_ms": plain_ms,
            "bound": bound, "err": worst}


def joint_embed_args(gen, batch, lp, d, h, dtype):
    """Random inputs of the joint embed: text [batch, TEXT_LEN, h], frames
    [batch, lp, d] (batch row 1 padded from frame 30), W, b, LN scale and
    bias; the last element is eps."""
    import torch

    text = torch.randn(batch, TEXT_LEN, h, device="cuda",
                       generator=gen).to(dtype)
    feats = torch.randn(batch, lp, d, device="cuda", generator=gen).to(dtype)
    feats[1, 30:] = 0.0  # padded frames
    w = torch.randn(d, h, device="cuda", generator=gen) * 0.05
    b, scale, bias = (torch.randn(h, device="cuda", generator=gen) * s + m
                      for s, m in ((0.02, 0.0), (0.1, 1.0), (0.1, 0.0)))
    return text, feats, w, b, scale, bias, 1e-12


def phase_joint_embed(gen):
    import torch
    import torch.nn.functional as F

    from msa_tpu_torch.ops.fused_joint_embed import (
        fused_joint_embed, fused_joint_embed_plain)

    eps = 1e-12
    worst, times = 0.0, {}
    # the kernel's tile edges, checked, not timed: B * Lp = 111 frame rows
    # (not a multiple of any tile's R), bert-base's H = 768, a ragged H =
    # 1000 and H = 1001 (no 16-byte vectors), D = 371 (six rounds of
    # staged features), from a generator of their own
    egen = torch.Generator(device="cuda").manual_seed(13)
    for d, h in ((47, 768), (371, 768), (74, 1000), (371, 1000), (47, 1001)):
        for dtype in (torch.bfloat16, torch.float32):
            dname = str(dtype).split(".")[1]
            args = joint_embed_args(egen, 3, 37, d, h, dtype)
            out = fused_joint_embed(*args)
            ref = fused_joint_embed_plain(*args)
            torch.cuda.synchronize()
            atol, rtol = EMBED_TOL[dname]
            worst = max(worst, check_close(
                f"fused_joint_embed [3,{TEXT_LEN}+37,{h}] D={d} {dname}", out,
                ref, atol, rtol))
    print(f"fused_joint_embed tile edges (B=3, Lp=37; H = 768, 1000, 1001; "
          f"D = 47, 74, 371; bf16 and f32): max_abs_err {worst:.3e}",
          flush=True)
    # MOSI (47, 74) and UR-FUNNY (371) widths at Lp = L, one Lp != L, and
    # the frame-level rows (B=16 x Lp=984) at the MOSI widths
    for d, lp, batch in ((47, TEXT_LEN, BATCH), (74, TEXT_LEN, BATCH),
                         (371, TEXT_LEN, BATCH), (74, 56, BATCH),
                         (47, FRAME_PAIR_LEN, FRAME_BATCH),
                         (74, FRAME_PAIR_LEN, FRAME_BATCH)):
        for dtype in (torch.bfloat16, torch.float32):
            dname = str(dtype).split(".")[1]
            text, feats, w, b, scale, bias, _ = joint_embed_args(
                gen, batch, lp, d, HIDDEN, dtype)
            args = (text, feats, w, b, scale, bias, eps)
            out = fused_joint_embed(*args)
            ref = fused_joint_embed_plain(*args)
            torch.cuda.synchronize()
            atol, rtol = EMBED_TOL[dname]
            err = check_close(f"fused_joint_embed D={d} {dname}", out, ref,
                              atol, rtol)
            worst = max(worst, err)
            # the autograd wrapper (kernel forward, plain recompute for the
            # backward) against plain autograd, every input's gradient
            leaves = [x.detach().requires_grad_() for x in args[:6]]
            dout = torch.randn(out.shape, device="cuda", generator=gen).to(dtype)
            got = torch.autograd.grad(fused_joint_embed(*leaves, eps), leaves,
                                      dout)
            want = torch.autograd.grad(fused_joint_embed_plain(*leaves, eps),
                                       leaves, dout)
            grad_err = max(check_close(
                f"fused_joint_embed D={d} {dname} grad {name}", g, r, atol, rtol)
                for name, g, r in zip(("text", "feats", "w", "b", "scale",
                                       "bias"), got, want))
            ms = cuda_ms(lambda: fused_joint_embed(*args))
            plain_ms = cuda_ms(lambda: fused_joint_embed_plain(*args))
            wt = w.t().contiguous().to(dtype)
            lib_ms = cuda_ms(lambda: F.layer_norm(torch.cat(
                [text, torch.relu(F.linear(feats, wt, b.to(dtype)))], 1),
                (HIDDEN,), scale.to(dtype), bias.to(dtype), eps))
            itemsize = text.element_size()
            nbytes = ((text.numel() + feats.numel() + out.numel()) * itemsize
                      + (w.numel() + 3 * HIDDEN) * 4)
            bound = bound_ms(nbytes, 2 * batch * lp * d * HIDDEN, dname)
            times[(d, lp, dname)] = (ms, plain_ms, lib_ms, bound)
            print(f"fused_joint_embed [{batch},{TEXT_LEN}+{lp},{HIDDEN}] "
                  f"D={d} {dname}: max_abs_err {err:.3e} (atol {atol}, rtol "
                  f"{rtol}), autograd wrapper's gradients {grad_err:.3e}; "
                  f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
                  f"linear+layer_norm {lib_ms:.4f} ms, bound {bound[0]:.4f} "
                  f"ms ({bound[1]})", flush=True)
    return worst, times


def phase_ln_quant(gen, cases=None):
    """The fused residual + LayerNorm + int8 quantize kernels against the
    plain composition, at the int8 serving path's row counts (``cases``:
    (label, rows) pairs in their place)."""
    import torch

    from msa_tpu_torch.ops.ln_quant import (
        ln_quant_dynamic, ln_quant_plain, ln_quant_static)

    eps = 1e-12
    worst, times = {"static": 0.0, "dynamic": 0.0}, {}
    for label, rows in cases or (("text", BATCH * TEXT_LEN),
                                 ("joint", 2 * BATCH * 2 * TEXT_LEN)):
        for dtype in (torch.bfloat16, torch.float32):
            dname = str(dtype).split(".")[1]
            x, res = (torch.randn(rows, HIDDEN, device="cuda", generator=gen)
                      .to(dtype) for _ in range(2))
            scale = 1.0 + 0.1 * torch.randn(HIDDEN, device="cuda", generator=gen)
            bias = 0.1 * torch.randn(HIDDEN, device="cuda", generator=gen)
            # a calibrated-like scale: |h| reaches ~5, so the largest values
            # saturate at +-127
            ascale = torch.tensor(4.0 / 127, device="cuda")
            for mode in ("static", "dynamic"):
                args = (x, res, scale, bias, eps)
                if mode == "static":
                    h, xi = ln_quant_static(*args, ascale)
                    row = None
                    rh, rxi, _ = ln_quant_plain(*args, ascale)
                else:
                    h, xi, row = ln_quant_dynamic(*args)
                    rh, rxi, rrow = ln_quant_plain(*args)
                torch.cuda.synchronize()
                tag = f"ln_quant_{mode} [{rows},{HIDDEN}] {dname}"
                atol, rtol = LN_QUANT_H_TOL[dname]
                err = check_close(tag + " h", h, rh, atol, rtol)
                diff = (xi.int() - rxi.int()).abs()
                share = float((diff > 0).float().mean())
                if share >= LN_QUANT_XI_SHARE or int(diff.max()) > 1:
                    raise AssertionError(
                        f"{tag} xi: {share:.2e} of the elements differ (want "
                        f"< {LN_QUANT_XI_SHARE}), max {int(diff.max())} levels")
                if row is not None:
                    check_close(tag + " row", row, rrow, 0.0,
                                LN_QUANT_ROW_RTOL[dname])
                worst[mode] = max(worst[mode], err)
                if mode == "static":
                    ms = cuda_ms(lambda: ln_quant_static(*args, ascale))
                    plain_ms = cuda_ms(lambda: ln_quant_plain(*args, ascale))
                else:
                    ms = cuda_ms(lambda: ln_quant_dynamic(*args))
                    plain_ms = cuda_ms(lambda: ln_quant_plain(*args))
                # reads x, res and the f32 LN parameters, writes h and xi
                # (and the f32 row scales); ~10 f32 operations per element
                nbytes = (rows * HIDDEN * (3 * x.element_size() + 1)
                          + 2 * HIDDEN * 4 + (4 * rows if row is not None else 4))
                bound = bound_ms(nbytes, 10 * rows * HIDDEN, "float32")
                times[(mode, label, dname)] = (ms, plain_ms, None, bound)
                print(f"{tag}: h max_abs_err {err:.3e} (atol {atol}, rtol "
                      f"{rtol}), xi differs in {share:.2e} of the elements "
                      f"(< {LN_QUANT_XI_SHARE}, max 1 level); kernel {ms:.4f} "
                      f"ms, plain {plain_ms:.4f} ms, no single library call, "
                      f"bound {bound[0]:.4f} ms ({bound[1]})", flush=True)
    return worst, times


def phase_flash2(gen):
    """The flash2 forward against its plain version: the frame-level joint
    shape, f32, a ragged S with padded keys, and S = 4096."""
    import torch
    import torch.nn.functional as F

    from msa_tpu_torch.ops.flash2 import flash_attention2, flash_attention2_plain

    cases = [("frame", 2 * FRAME_BATCH, TEXT_LEN + FRAME_PAIR_LEN, torch.bfloat16),
             ("frame", 2, TEXT_LEN + FRAME_PAIR_LEN, torch.float32),
             ("s1030", 4, 1030, torch.bfloat16), ("s1030", 4, 1030, torch.float32),
             ("s4096", 2, 4096, torch.bfloat16)]
    worst, times = 0.0, {}
    for label, b, s, dtype in cases:
        dname = str(dtype).split(".")[1]
        q, k, v, bias, live = attention_inputs(gen, b, s, dtype)
        out = flash_attention2(q, k, v, bias, HEADS)
        ref = flash_attention2_plain(q, k, v, bias, HEADS)
        torch.cuda.synchronize()
        atol, rtol = ATTN_TOL[dname]
        err = check_close(f"flash_attention2 {label} {dname}", out, ref, atol,
                          rtol, mask=live)
        err_masked = check_close(f"flash_attention2 {label} {dname} masked row",
                                 out, ref, MASKED_ROW_ATOL, 0.0, mask=~live)
        worst = max(worst, err)
        ms = cuda_ms(lambda: flash_attention2(q, k, v, bias, HEADS))
        plain_ms = cuda_ms(lambda: flash_attention2_plain(q, k, v, bias, HEADS),
                           iters=5)
        sq, sk, sv, sm = sdpa_args(q, k, v, bias)
        lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
            sq, sk, sv, attn_mask=sm))
        nbytes = 4 * b * s * HIDDEN * q.element_size() + b * s * 4
        bound = bound_ms(nbytes, 4 * b * s * s * HIDDEN, dname)
        times[(label, dname)] = (ms, plain_ms, lib_ms, bound)
        print(f"flash_attention2 [{b},{s},{HIDDEN}] {dname}: max_abs_err "
              f"{err:.3e} (atol {atol}, rtol {rtol}), masked row "
              f"{err_masked:.3e} (atol {MASKED_ROW_ATOL}); kernel {ms:.4f} ms"
              f" ({4 * b * s * s * HIDDEN / ms / 1e9:.1f} TFLOP/s), plain "
              f"{plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms, bound {bound[0]:.4f}"
              f" ms ({bound[1]})", flush=True)
    return worst, times


def check_flash2_backward(tag, q, k, v, bias, live, dout, seed, rate, keep):
    """flash2's fused and split backwards, each forced, from the training
    forward's f32 output and lse: each held by :func:`check_rounded_backward`
    against JAX's rule with its roundings (``flash_attention2_backward_plain``
    given out32, the lse and the keep mask: dS and pd rounded, under dropout
    dO * (1 / (1 - rate)) rounded before dP and dV) at GRAD_TOL, and
    against autograd through the plain version in f32 within twice it plus
    the gap those roundings make in the rule; fused and split against each
    other at GRAD_TOL; the forward against the plain version at ATTN_TOL.
    Returns (errors against the rule by route, against autograd by route,
    fused vs split, out32, lse)."""
    import torch

    from msa_tpu_torch.ops.dropout import byte_threshold
    from msa_tpu_torch.ops.flash2 import (
        _forward_kernel, flash_attention2_backward,
        flash_attention2_backward_plain, flash_attention2_plain)

    dname = str(q.dtype).split(".")[1]
    out, lse, ctx32 = _forward_kernel(q, k, v, bias, HEADS, seed,
                                      byte_threshold(rate), train=True)
    o32 = out if ctx32 is None else ctx32
    got = {fused: flash_attention2_backward(
        q, k, v, bias, o32, lse, dout, HEADS, seed, rate, fused=fused)
        for fused in (True, False)}
    wide = [x.detach().float().requires_grad_() for x in (q, k, v)]
    ref_out = flash_attention2_plain(*wide, bias, HEADS, rate, keep)
    auto = torch.autograd.grad(ref_out, wide, dout.float())
    rule = flash_attention2_backward_plain(q, k, v, bias, o32, lse, dout,
                                           HEADS, rate, keep)
    rule32 = flash_attention2_backward_plain(
        *(x.detach() for x in wide), bias, o32, lse, dout.float(), HEADS, rate,
        keep)
    torch.cuda.synchronize()
    atol, rtol = ATTN_TOL[dname]
    check_close(f"{tag} forward", out, ref_out.detach(), atol, rtol, mask=live)
    gatol, grtol = GRAD_TOL[dname]
    errs, autos = {}, {}
    for fused in (True, False):
        route = "fused" if fused else "split"
        errs[fused], autos[fused] = check_rounded_backward(
            f"flash2_bwd_{route} {tag}", got[fused], rule, rule32, auto, live,
            gatol, grtol)
    between = max(check_close(f"flash2 fused vs split {tag} {name}", gf, gs,
                              gatol, grtol, mask=live)
                  for name, gf, gs in zip(("dq", "dk", "dv"), got[True],
                                          got[False]))
    return errs, autos, between, o32, lse


def phase_flash2_backward(gen):
    """The fused and the split flash2 backward, each forced, by
    :func:`check_flash2_backward` (against JAX's rounded rule at GRAD_TOL,
    against f32 autograd within twice it plus the rule's gap, against each
    other); with dropout at B=2 (the plain versions given keep_mask_plain);
    and the flash2 forward's dropout against the short kernel's at S=768."""
    import torch
    import torch.nn.functional as F

    from msa_tpu_torch.ops.dropout import keep_mask_plain, quantize_dropout_rate
    from msa_tpu_torch.ops.flash2 import (
        flash_attention2, flash_attention2_backward, flash_attention2_plain)
    from msa_tpu_torch.ops.short_attention import short_attention

    rate_on = quantize_dropout_rate(ATTN_DROPOUT)
    s_frame = TEXT_LEN + FRAME_PAIR_LEN
    # (label, B, S, dtype, rate, the route timed at rate 0 (None: neither),
    # generator); the fused kernel's edges (S = 1000: a ragged last key
    # block and query tile; 2048: 16 key blocks, both fused by JAX's rule)
    # from a generator of their own, so the later phases draw their old
    # inputs
    egen = torch.Generator(device="cuda").manual_seed(14)
    cases = [("frame", 2 * FRAME_BATCH, s_frame, torch.bfloat16, 0.0, True, gen),
             ("s4096", 2, 4096, torch.bfloat16, 0.0, False, gen),
             ("frame", 2, s_frame, torch.float32, 0.0, False, gen),
             ("frame", 2, s_frame, torch.bfloat16, rate_on, True, gen),
             ("frame", 2, s_frame, torch.float32, rate_on, False, gen)]
    cases += [(f"s{s}", 2, s, torch.bfloat16, rate, None, egen)
              for s in (1000, 2048) for rate in (0.0, rate_on)]
    worst = {True: 0.0, False: 0.0}
    times = {}
    for label, b, s, dtype, rate, timed, cgen in cases:
        dname = str(dtype).split(".")[1]
        q, k, v, bias, live = attention_inputs(cgen, b, s, dtype)
        dout = torch.randn(b, s, HIDDEN, device="cuda",
                           generator=cgen).to(dtype)
        seed = 4321 + s
        keep = (keep_mask_plain(seed, rate, b, HEADS, s, device="cuda")
                if rate else None)
        tag = f"{label} [{b},{s},{HIDDEN}] {dname} rate {rate:g}"
        errs, autos, between, o32, lse = check_flash2_backward(
            tag, q, k, v, bias, live, dout, seed, rate, keep)
        for fused in (True, False):
            worst[fused] = max(worst[fused], errs[fused])
        gatol, grtol = GRAD_TOL[dname]
        timing = ""
        if rate == 0.0 and timed is not None:
            ms, other_ms = (cuda_ms(lambda: flash_attention2_backward(
                q, k, v, bias, o32, lse, dout, HEADS, seed, rate,
                fused=route), iters=10) for route in (timed, not timed))
            qq, kk, vv = (x.detach().requires_grad_() for x in (q, k, v))
            o = flash_attention2_plain(qq, kk, vv, bias, HEADS)
            plain_ms = cuda_ms(lambda: torch.autograd.grad(
                o, (qq, kk, vv), dout, retain_graph=True), iters=5)
            sq, sk, sv, sm = sdpa_args(qq, kk, vv, bias)
            lib_out = F.scaled_dot_product_attention(sq, sk, sv, attn_mask=sm)
            lib_do = dout.view(b, s, HEADS, -1).transpose(1, 2)
            lib_ms = cuda_ms(lambda: torch.autograd.grad(
                lib_out, (qq, kk, vv), lib_do, retain_graph=True), iters=10)
            # bytes and products as for the short backward (see there)
            nbytes = 7 * q.element_size() * b * s * HIDDEN + b * s * 4
            bound = bound_ms(nbytes, 10 * b * s * s * HIDDEN, dname)
            times[(label, dname, timed)] = (ms, plain_ms, lib_ms, bound)
            timing = (f"; {'fused' if timed else 'split'} kernel {ms:.4f} ms "
                      f"({10 * b * s * s * HIDDEN / ms / 1e9:.1f} TFLOP/s; the "
                      f"{'split' if timed else 'fused'} route {other_ms:.4f} "
                      f"ms), plain "
                      f"{plain_ms:.4f} ms, sdpa bwd {lib_ms:.4f} ms, bound "
                      f"{bound[0]:.4f} ms ({bound[1]})")
        print(f"flash2 backward [{b},{s},{HIDDEN}] {dname} rate {rate:g}: "
              f"max_abs_err fused {errs[True]:.3e}, split {errs[False]:.3e} "
              f"against the rounded rule (atol {gatol}, rtol {grtol}); "
              f"against f32 autograd fused {autos[True]:.3e}, split "
              f"{autos[False]:.3e} (twice that plus the rule's rounding gap); "
              f"fused vs split {between:.3e}{timing}", flush=True)

    # the same seed draws the same mask in both kernel families (S=768 is
    # the short kernel's range; flash2 takes any S)
    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype).split(".")[1]
        q, k, v, bias, live = attention_inputs(gen, 4, 768, dtype)
        a = flash_attention2(q, k, v, bias, HEADS, rate_on, 99)
        b_ = short_attention(q, k, v, bias, HEADS, rate_on, 99)
        c = flash_attention2(q, k, v, bias, HEADS, rate_on, 100)
        torch.cuda.synchronize()
        atol, rtol = ATTN_TOL[dname]
        err = check_close(f"flash2 vs short dropout S=768 {dname}", a, b_,
                          atol, rtol, mask=live)
        if torch.allclose(a.float(), c.float(), atol=atol, rtol=rtol):
            raise AssertionError("flash2 dropout: not a function of the seed")
        print(f"flash2 vs short_attention with dropout {rate_on} at [4,768,"
              f"{HIDDEN}] {dname}, same seed: max_abs_err {err:.3e}; the next"
              " seed differs", flush=True)
    return worst, times


def probe_flash2_dq():
    """flash2's fused-backward dq at the frame-level joint shape [32, 1024]
    bf16, rate 0, on inputs from four generators of their own: how far it
    lies from f32 autograd (elements beyond GRAD_TOL, the check it was held
    to before it was held to the rounded rule) and from the rounded rule.
    The new checks of :func:`check_flash2_backward` hold; the old one is
    reported, not enforced."""
    import torch

    from msa_tpu_torch.ops.flash2 import (
        flash_attention2_backward, flash_attention2_backward_plain,
        flash_attention2_plain, _forward_kernel)

    atol, rtol = GRAD_TOL["bfloat16"]
    b, s = 2 * FRAME_BATCH, TEXT_LEN + FRAME_PAIR_LEN
    for seed in (101, 102, 103, 104):
        pgen = torch.Generator(device="cuda").manual_seed(seed)
        q, k, v, bias, live = attention_inputs(pgen, b, s, torch.bfloat16)
        dout = torch.randn(b, s, HIDDEN, device="cuda",
                           generator=pgen).to(torch.bfloat16)
        out, lse, o32 = _forward_kernel(q, k, v, bias, HEADS, 0, 0, train=True)
        dq = flash_attention2_backward(q, k, v, bias, o32, lse, dout, HEADS,
                                       fused=True)[0].float()
        wide = [x.detach().float().requires_grad_() for x in (q, k, v)]
        auto = torch.autograd.grad(flash_attention2_plain(
            *wide, bias, HEADS), wide[0], dout.float())[0]
        rule = flash_attention2_backward_plain(q, k, v, bias, o32, lse, dout,
                                               HEADS)[0].float()
        rule32 = flash_attention2_backward_plain(
            *(x.detach() for x in wide), bias, o32, lse, dout.float(),
            HEADS)[0]
        torch.cuda.synchronize()
        line = []
        for name, ref in (("f32 autograd", auto), ("the rounded rule", rule)):
            err = (dq - ref).abs()[live]
            beyond = int((err > atol + rtol * ref.abs()[live]).sum())
            line.append(f"{name}: max {float(err.max()):.3e}, {beyond} "
                        "elements beyond GRAD_TOL")
        gap = float((rule - rule32).abs()[live].max())
        print(f"flash2 fused dq probe [{b},{s},{HIDDEN}] bfloat16 generator "
              f"{seed}: against {'; against '.join(line)}; the rule's "
              f"rounding gap to f32 {gap:.3e}", flush=True)
        check_flash2_backward(f"probe generator {seed}", q, k, v, bias, live,
                              dout, 0, 0.0, None)


# The warpgroup kernels' tile edges: their 128-row query blocks (127, 129),
# ragged tails (70, 1000), a single key, and the long shapes.
WG_SEQS = (1, 70, 127, 129, 1000, 1024, 2048, 4096)


def phase_wgmma_flash():
    """The warpgroup (wgmma) kernels of rows 10, 12 and 13 in bf16 at every
    S of WG_SEQS, rate 0 and 26/256, head dim 64 (H = 1024, 16 heads) and
    32 (H = 64, 2 heads), both layouts, B = 2 (a fully masked row and a
    ragged one), from a generator of their own: the serving form bit-equal
    to the training form; the training ctx against the plain rule
    (``short_attention_train_forward_plain``: p rounded to bf16 before P V)
    at ATTN_TOL, its lse at TRAIN_LSE_TOL (log2 units for flash2, natural
    for the head-split form; rows with every key masked at
    MASKED_ROW_ATOL; up to 128 keys the ctx of those rows by
    :func:`check_masked_rows`), flash2's out32 rounding to its ctx bit for
    bit, the head-split ctx bit-equal to flash2's (one kernel, another
    addressing);
    the split backward of each layout by :func:`check_rounded_backward`
    (its rounded rule at GRAD_TOL, f32 autograd within twice it plus the
    rule's rounding gap), its dq, dk and dv bit-equal across two calls (no
    atomics).  Returns the worst errors."""
    import torch

    from msa_tpu_torch.ops import attention as A
    from msa_tpu_torch.ops import flash2 as F2
    from msa_tpu_torch.ops.dropout import (
        byte_threshold, keep_mask_plain, quantize_dropout_rate)
    from msa_tpu_torch.ops.short_attention import (
        short_attention_train_forward_plain)

    gen = torch.Generator(device="cuda").manual_seed(15)
    rate_on = quantize_dropout_rate(ATTN_DROPOUT)
    atol, rtol = ATTN_TOL["bfloat16"]
    gatol, grtol = GRAD_TOL["bfloat16"]
    worst = {"fwd": 0.0, "lse": 0.0, "flash2_bwd": 0.0, "row13_bwd": 0.0}
    t0 = time.perf_counter()
    for hidden, heads in ((1024, 16), (64, 2)):
        with head_widths(hidden, heads):
            d = HIDDEN // HEADS
            for s in WG_SEQS:
                for rate in (0.0, rate_on):
                    b = 2
                    q, k, v, bias, live = attention_inputs(gen, b, s,
                                                           torch.bfloat16)
                    dout = torch.randn(q.shape, device="cuda",
                                       generator=gen).to(torch.bfloat16)
                    seed, t = 1400 + s, byte_threshold(rate)
                    keep = (keep_mask_plain(seed, rate, b, HEADS, s,
                                            device="cuda") if rate else None)
                    tag = f"wgmma d={d} [{b},{s},{HIDDEN}] rate {rate:g}"
                    serve = F2._forward_kernel(q, k, v, bias, HEADS, seed, t,
                                               False)[0]
                    out, lse, out32 = F2._forward_kernel(q, k, v, bias, HEADS,
                                                         seed, t, True)
                    qh, kh, vh, doh = (split_heads(x) for x in (q, k, v, dout))
                    serve_h = A._forward_kernel(qh, kh, vh, bias, seed, t,
                                                False)[0]
                    out_h, lse_h = A._forward_kernel(qh, kh, vh, bias, seed, t,
                                                     True)
                    rctx, rlse = short_attention_train_forward_plain(
                        q, k, v, bias, HEADS, rate, keep)
                    torch.cuda.synchronize()
                    for what, a, c in (("flash2 serving vs training", serve, out),
                                       ("head-split serving vs training",
                                        serve_h, out_h),
                                       ("flash2 out32 rounded vs ctx",
                                        out32.to(out.dtype), out),
                                       ("head-split vs flash2 ctx",
                                        merge_heads(out_h), out)):
                        if not torch.equal(a, c):
                            raise AssertionError(f"{tag}: {what} differ")
                    err = check_close(f"{tag} ctx", out, rctx, atol, rtol,
                                      mask=live)
                    if s <= 128:
                        # a few keys: the kernel applies 1 / (1 - rate) in
                        # f32 after P V, the rule rounds p / (1 - rate)
                        # (1.109375 in bf16 at one key), as for the short
                        # forwards at a few keys
                        check_masked_rows(tag, out, q, k, v, bias, live, rate,
                                          keep)
                    else:
                        check_close(f"{tag} ctx masked row", out, rctx,
                                    MASKED_ROW_ATOL, 0.0, mask=~live)
                    lse_err = 0.0
                    for what, got, want in (("flash2 lse", lse, rlse),
                                            ("head-split lse", lse_h,
                                             rlse * math.log(2.0))):
                        lse_err = max(lse_err, check_close(
                            f"{tag} {what}", got, want, *TRAIN_LSE_TOL,
                            mask=live))
                        check_close(f"{tag} {what} masked row", got, want,
                                    MASKED_ROW_ATOL, 0.0, mask=~live)
                    # the split backwards, twice each
                    runs = [F2.flash2_bwd_split(q, k, v, bias, out32, lse, dout,
                                                HEADS, seed, rate)
                            for _ in range(2)]
                    runs_h = [A.flash_attention_backward(
                        qh, kh, vh, bias, out_h, lse_h, doh, seed, rate)
                        for _ in range(2)]
                    wide = [x.float().requires_grad_() for x in (q, k, v)]
                    auto = torch.autograd.grad(F2.flash_attention2_plain(
                        *wide, bias, HEADS, rate, keep), wide, dout.float())
                    rule = F2.flash_attention2_backward_plain(
                        q, k, v, bias, out32, lse, dout, HEADS, rate, keep)
                    rule32 = F2.flash_attention2_backward_plain(
                        *(x.detach() for x in wide), bias, out32, lse,
                        dout.float(), HEADS, rate, keep)
                    rule_h = A.flash_attention_backward_plain(
                        qh, kh, vh, bias, out_h, lse_h, doh, rate, keep)
                    rule_h32 = A.flash_attention_backward_plain(
                        *(split_heads(x.detach()) for x in wide), bias, out_h,
                        lse_h, doh.float(), rate, keep)
                    torch.cuda.synchronize()
                    for what, pair in (("flash2 split", runs),
                                       ("head-split pair", runs_h)):
                        if not all(torch.equal(x, y) for x, y in zip(*pair)):
                            raise AssertionError(f"{tag}: {what} gradients "
                                                 "differ between two calls")
                    e2, a2 = check_rounded_backward(
                        f"{tag} flash2 split", runs[0], rule, rule32, auto,
                        live, gatol, grtol)
                    e13, a13 = check_rounded_backward(
                        f"{tag} head-split pair",
                        [merge_heads(x) for x in runs_h[0]],
                        [merge_heads(x) for x in rule_h],
                        [merge_heads(x) for x in rule_h32], auto, live, gatol,
                        grtol)
                    worst["fwd"] = max(worst["fwd"], err)
                    worst["lse"] = max(worst["lse"], lse_err)
                    worst["flash2_bwd"] = max(worst["flash2_bwd"], e2)
                    worst["row13_bwd"] = max(worst["row13_bwd"], e13)
                    print(f"{tag}: ctx {err:.3e} (atol {atol}, rtol {rtol}), "
                          f"lse {lse_err:.3e} (atol {TRAIN_LSE_TOL[0]}, rtol "
                          f"{TRAIN_LSE_TOL[1]}); split backward against the "
                          f"rounded rule flash2 {e2:.3e}, head-split {e13:.3e}"
                          f" (atol {gatol}, rtol {grtol}), against f32 "
                          f"autograd {a2:.3e} / {a13:.3e}; serving = training"
                          f", head-split = flash2, gradients equal across two"
                          f" calls", flush=True)
                    del auto, rule, rule32, rule_h, rule_h32, wide
    print(f"wgmma kernels: every check passed in {time.perf_counter() - t0:.1f}"
          " s", flush=True)
    return worst


def time_flash_backwards():
    """Device ms of the flash kernels at the frame-level joint shape [2 x
    FRAME_BATCH, 1024, 1024] bf16 (16 heads), at rate 0 and at the training
    dropout: flash2's training forward (row 10), its fused and split
    backward routes (rows 11, 12) and the head-split forward and backward
    pair (row 13), each backward from its own training forward's output and
    lse at that rate; at head dim 32 ([32, 1024, 64], rate 0) flash2's
    training forward, fused and split backwards and row 13's forward and
    pair; flash2's split backward at [2, 4096, 1024] (the long-S step's
    route); and the joint embed (row 2) at [96, 40+40, 1024] and [96,
    40+40, 64], D = 47.  It calls only entry points that
    every tree of the port has had since row 13 was ported, so
    ``--flash-times ROOT`` times another checkout's kernels by this code.
    Prints and returns {label: ms}."""
    import torch

    from msa_tpu_torch.ops import attention as A
    from msa_tpu_torch.ops import flash2 as F2
    from msa_tpu_torch.ops.dropout import byte_threshold, quantize_dropout_rate
    from msa_tpu_torch.ops.fused_joint_embed import fused_joint_embed

    b, s, h, heads = 2 * FRAME_BATCH, TEXT_LEN + FRAME_PAIR_LEN, 1024, 16
    gen = torch.Generator(device="cuda").manual_seed(0)
    q, k, v, dout = (torch.randn(b, s, h, device="cuda", generator=gen)
                     .to(torch.bfloat16) for _ in range(4))
    bias = torch.zeros(b, s, device="cuda")
    qh, kh, vh, doh = (x.view(b, s, heads, -1).transpose(1, 2).contiguous()
                       for x in (q, k, v, dout))
    times = {}
    for rate in (0.0, quantize_dropout_rate(ATTN_DROPOUT)):
        t = byte_threshold(rate)
        _, lse, out32 = F2._forward_kernel(q, k, v, bias, heads, 7, t, True)
        times[f"flash2 fwd rate {rate:g}"] = cuda_ms(
            lambda: F2._forward_kernel(q, k, v, bias, heads, 7, t, True),
            iters=10)
        for fused in (True, False):
            times[f"flash2 {'fused' if fused else 'split'} rate {rate:g}"] = \
                cuda_ms(lambda: F2.flash_attention2_backward(
                    q, k, v, bias, out32, lse, dout, heads, 7, rate,
                    fused=fused), iters=10)
        out, lse_h = A._forward_kernel(qh, kh, vh, bias, 7, t, True)
        times[f"row 13 fwd rate {rate:g}"] = cuda_ms(
            lambda: A._forward_kernel(qh, kh, vh, bias, 7, t, True), iters=10)
        times[f"row 13 rate {rate:g}"] = cuda_ms(
            lambda: A.flash_attention_backward(qh, kh, vh, bias, out, lse_h,
                                               doh, 7, rate), iters=10)
    q32, k32, v32, do32 = (x[..., :64].contiguous() for x in (q, k, v, dout))
    _, lse, out32 = F2._forward_kernel(q32, k32, v32, bias, 2, 7, 0, True)
    for fused in (True, False):
        times[f"flash2 {'fused' if fused else 'split'} d32 rate 0"] = \
            cuda_ms(lambda: F2.flash_attention2_backward(
                q32, k32, v32, bias, out32, lse, do32, 2, 7, 0.0,
                fused=fused), iters=10)
    # the forwards and row 13's pair at head dim 32 ([32, 1024, 64], 2 heads)
    times["flash2 fwd d32 rate 0"] = cuda_ms(
        lambda: F2._forward_kernel(q32, k32, v32, bias, 2, 7, 0, True))
    q32h, k32h, v32h, do32h = (x.view(b, s, 2, 32).transpose(1, 2).contiguous()
                               for x in (q32, k32, v32, do32))
    out, lse_h = A._forward_kernel(q32h, k32h, v32h, bias, 7, 0, True)
    times["row 13 fwd d32 rate 0"] = cuda_ms(
        lambda: A._forward_kernel(q32h, k32h, v32h, bias, 7, 0, True))
    times["row 13 d32 rate 0"] = cuda_ms(
        lambda: A.flash_attention_backward(q32h, k32h, v32h, bias, out, lse_h,
                                           do32h, 7, 0.0), iters=10)
    # row 12 where the long-S step takes it: [2, 4096, 1024], rate 0
    gl = torch.Generator(device="cuda").manual_seed(1)
    ql, kl, vl, dol = (torch.randn(2, 4096, h, device="cuda", generator=gl)
                       .to(torch.bfloat16) for _ in range(4))
    bl = torch.zeros(2, 4096, device="cuda")
    _, lse_l, out32_l = F2._forward_kernel(ql, kl, vl, bl, heads, 7, 0, True)
    times["flash2 split s4096 rate 0"] = cuda_ms(
        lambda: F2.flash_attention2_backward(ql, kl, vl, bl, out32_l, lse_l, dol,
                                             heads, 7, 0.0, fused=False),
        iters=10)
    del ql, kl, vl, dol, out32_l
    for hid in (1024, 64):
        args = joint_embed_args(gen, BATCH, TEXT_LEN, 47, hid, torch.bfloat16)
        times[f"joint embed H={hid}"] = cuda_ms(
            lambda: fused_joint_embed(*args))
    print(f"flash kernels [{b},{s},{h}] and the joint embed, bfloat16, ms: "
          f"{json.dumps(times)}", flush=True)
    _, lse, out32 = F2._forward_kernel(q, k, v, bias, heads, 7, 0, True)
    for fused in (True, False):
        parts = device_ms_by_kernel(lambda: F2.flash_attention2_backward(
            q, k, v, bias, out32, lse, dout, heads, 7, 0.0, fused=fused))
        print(f"flash2 {'fused' if fused else 'split'} route [{b},{s},{h}] "
              f"bfloat16 rate 0, device ms a call by kernel: "
              f"{json.dumps(parts)}", flush=True)
    return times


def device_ms_by_kernel(fn, calls: int = 5):
    """Device ms a call of ``fn`` for each kernel it launches (by name, cut
    before its template arguments), from ``torch.profiler`` over ``calls``
    calls after a warm-up."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    parts = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            name = e.name.replace("void ", "").replace("(anonymous namespace)::", "")
            name = re.split(r"[<(]", name, 1)[0]
            name = name.split("::")[-1]
            parts[name] = parts.get(name, 0.0) + e.time_range.elapsed_us() / 1e3
    return {name: round(ms / calls, 4) for name, ms in parts.items()}


def phase_head_dim_32():
    """Every attention kernel at head dim 32 and ln_quant and the joint
    embed at H = 64 (the tiny preset's widths: H = 64, 2 heads): the kernel
    phases above, run again under :func:`head_widths` from a generator of
    their own, with their checks and tolerances (each phase's shapes: the
    short forwards and backwards at the text and joint shapes, bf16 and f32,
    and at the edge lengths each phase runs -- v2s's forward at 12-1000 and
    its backward at 12, 128 and 200; flash2 and the head-split flash attention
    at [B, 1024, 2 x 32], S = 1000 / 1030 and 4096; ln_quant also at an odd
    row count).  Returns each phase's (worst error, times)."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(32)
    out = {}
    t0 = time.perf_counter()
    with head_widths(64, 2):
        print(f"head dim 32: H={HIDDEN}, {HEADS} heads", flush=True)
        out["attention"] = phase_attention(gen)
        out["attention_backward"] = phase_attention_backward(gen)
        out["joint_embed"] = phase_joint_embed(gen)
        out["ln_quant"] = phase_ln_quant(gen, (
            ("text", BATCH * TEXT_LEN), ("joint", 2 * BATCH * 2 * TEXT_LEN),
            ("odd", 1001)))
        out["flash2"] = phase_flash2(gen)
        out["flash2_backward"] = phase_flash2_backward(gen)
        out["probs_packed"] = phase_probs_packed(gen)
        out["v3"] = phase_v3_kernels(gen)
        out["flash_attention"] = phase_flash_attention(gen)
        out["v1"] = phase_short_v1(gen)
    print(f"head dim 32: every kernel check passed in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return out


def phase_tiny_preset():
    """JAX's ``tiny`` preset (H = 64, 2 heads: head dim 32) on the card
    through the hand-written kernels: ``cli.train --model tiny`` (its
    flow, one epoch on a synthetic MOSI split; launches per step and eval
    pass as at bert-large), the trained weights served by the bf16, int8
    and int8_static ``Predictor`` (launches per batch, finite predictions,
    an f32 card run against the CPU's), then the frame-level path (L = 40,
    Lp = 984: the joint pass [2B, 1024] on flash2 at head dim 32; the
    preset's 128 positions embed the text alone): serving and 1 + 2 train
    steps."""
    import numpy as np
    import torch

    from msa_tpu_torch.cli import train
    from msa_tpu_torch.data import synthetic_split
    from msa_tpu_torch.inference import Predictor
    from msa_tpu_torch.models.weights import init_params, to_device

    n_train, batch, layers = 256, 32, 2
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)  # the CLI logs under ./logs
        try:
            argv = ["--model", "tiny", "--dataset", "mosi", "--synthetic",
                    str(n_train), "--n_epochs", "1", "--train_batch_size",
                    str(batch), "--val_batch_size", str(batch),
                    "--test_batch_size", str(batch), "--checkpoint_root",
                    os.path.join(tmp, "model_save"), "--numpy_root",
                    os.path.join(tmp, "numpy_save"), "--device", "cuda"]
            reset_counts()
            t0 = time.perf_counter()
            trainer, state, result = train.run(
                train.build_parser().parse_args(argv))
            fit_s = time.perf_counter() - t0
            launches = kernel_counts()
        finally:
            os.chdir(cwd)
    exp = trainer.config
    cfg = exp.model
    if cfg.bert.head_dim != 32 or trainer.remat_policy != "none":
        raise AssertionError(f"tiny: head dim {cfg.bert.head_dim}, remat "
                             f"{trainer.remat_policy}")
    steps = state.step
    want = rung_launches("none", layers, steps)
    evals = 2 * -(-(n_train // 8) // batch)  # val and test, one epoch
    want["short_attention"] += 2 * layers * evals
    want["fused_joint_embed"] += 2 * evals
    if launches != want:
        raise AssertionError(f"tiny cli.train launches {launches}, want {want}")
    losses = [float(h["train"]["loss"]) for h in result.history]
    if not all(np.isfinite(losses)):
        raise AssertionError(f"tiny cli.train: epoch losses {losses}")
    del state, trainer
    # serving: random weights from a seed at initializer range 0.1 (at the
    # preset's 0.02 the tiny model's predictions spread ~2.5e-7, and one
    # epoch of the CLI's defaults saturates its head: either would compare
    # nothing)
    params = init_params(dataclasses.replace(cfg, bert=dataclasses.replace(
        cfg.bert, initializer_range=0.1)), torch.Generator(
            device="cuda").manual_seed(0))

    n_serve = 3 * batch - 5
    split = synthetic_split(n_serve, TEXT_LEN, cfg.visual_dim, cfg.speech_dim,
                            vocab_size=cfg.bert.vocab_size, seed=7)
    calib = dataclasses.replace(split, **{
        f: getattr(split, f)[:batch] for f in (
            "input_ids", "attention_mask", "visual", "speech", "target")})
    n_batches = -(-n_serve // batch)
    outs, per_batch = {}, {}
    for mode in (None, "int8", "int8_static"):
        pred = Predictor(exp, params, batch, "cuda", quantize=mode,
                         calibration=calib if mode == "int8_static" else None)
        pred.predict_split(split)  # warm
        reset_counts()
        out = pred.predict_split(split)
        got = kernel_counts()
        if got != serving_launches(layers, n_batches, mode):
            raise AssertionError(f"tiny serving {mode}: launches {got}")
        if out.shape != (n_serve,) or not np.isfinite(out).all() or \
                np.abs(out).max() > 1.0:
            raise AssertionError(f"tiny serving {mode}: predictions "
                                 f"{out.shape}, max |p| {np.abs(out).max()}")
        outs[mode or "bf16"] = out
        per_batch[mode or "bf16"] = {k: v // n_batches for k, v in got.items()
                                     if v}
    if not np.ptp(outs["bf16"]) > TINY_PRED_SPREAD:
        raise AssertionError(f"tiny serving: predictions spread "
                             f"{float(np.ptp(outs['bf16'])):.3e}, too little "
                             "to compare")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    exp32 = dataclasses.replace(
        exp, train=dataclasses.replace(exp.train, compute_dtype="float32"))
    rows = [0, n_serve - 1]
    sub = [np.asarray(x)[rows] for x in (split.input_ids, split.attention_mask,
                                          split.visual, split.speech)]
    gpu32 = Predictor(exp32, params, len(rows), "cuda").predict_arrays(*sub)
    cpu32 = Predictor(exp32, to_device(params, "cpu"), len(rows),
                      "cpu").predict_arrays(*sub)
    err32 = float(np.abs(gpu32 - cpu32).max())
    if not err32 <= F32_PRED_ATOL:
        raise AssertionError(f"tiny f32 card vs CPU predictions differ by "
                             f"{err32:.3e} > {F32_PRED_ATOL}")
    print(f"tiny preset (H={cfg.bert.hidden_size}, "
          f"{cfg.bert.num_attention_heads} heads, head dim "
          f"{cfg.bert.head_dim}, {layers} layers): cli.train {steps} "
          f"steps at B={batch} in {fit_s:.1f} s (epoch losses {losses}), "
          f"launches {dict((k, v) for k, v in launches.items() if v)}; served "
          f"{n_serve} samples in bf16 / int8 / int8_static, launches per batch "
          f"{per_batch}; int8 / int8_static against bf16 max |diff| "
          f"{float(np.abs(outs['int8'] - outs['bf16']).max()):.3e} / "
          f"{float(np.abs(outs['int8_static'] - outs['bf16']).max()):.3e} "
          f"(bf16 predictions spread {float(np.ptp(outs['bf16'])):.3e}); f32 "
          f"card vs CPU {err32:.3e} (atol {F32_PRED_ATOL})", flush=True)

    # frame level: the joint pass [2B, 1024] runs flash2 at head dim 32
    fexp = frame_experiment(FRAME_PAIR_LEN, model="tiny")
    fsplit = synthetic_split(FRAME_SERVE, TEXT_LEN, cfg.visual_dim,
                             cfg.speech_dim, vocab_size=cfg.bert.vocab_size,
                             seed=8, pair_seq_length=FRAME_PAIR_LEN)
    fpred = Predictor(fexp, params, FRAME_BATCH, "cuda")
    fpred.predict_split(fsplit)  # warm
    reset_counts()
    fout = fpred.predict_split(fsplit)
    got = kernel_counts()
    nb = -(-FRAME_SERVE // FRAME_BATCH)
    fwant = expect_counts(short_attention=layers * nb,
                          flash_attention2=layers * nb,
                          fused_joint_embed=2 * nb)
    if got != fwant or fout.shape != (FRAME_SERVE,) or \
            not np.isfinite(fout).all():
        raise AssertionError(f"tiny frame-level serving: launches {got}, want "
                             f"{fwant}; predictions {fout.shape}")
    print(f"tiny frame-level serving B={FRAME_BATCH} L={TEXT_LEN} "
          f"Lp={FRAME_PAIR_LEN}: {FRAME_SERVE} samples, launches per batch "
          f"{dict((k, v // nb) for k, v in got.items() if v)}", flush=True)
    phase_frame_training(FRAME_PAIR_LEN, FRAME_BATCH, None, 1, 2,
                         "tiny frame-level", model="tiny")


def kernel_counters():
    from msa_tpu_torch.ops.attention import (
        flash_attention, flash_attention_backward)
    from msa_tpu_torch.ops.flash2 import (
        flash2_bwd_fused, flash2_bwd_split, flash_attention2)
    from msa_tpu_torch.ops.fused_adamw import fused_adamw_leaf
    from msa_tpu_torch.ops.fused_joint_embed import fused_joint_embed
    from msa_tpu_torch.ops.ln_quant import ln_quant_dynamic, ln_quant_static
    from msa_tpu_torch.ops.short_attention import (
        dropout_keep_mask, short_attention, short_attention_backward,
        short_attention_packed, short_attention_packed_backward,
        short_attention_probs, short_attention_probs_backward,
        short_attention_v1, short_attention_v1_backward,
        short_attention_v3_backward)

    return {"short_attention": short_attention,
            "short_attention_backward": short_attention_backward,
            "short_attention_v3_backward": short_attention_v3_backward,
            "fused_adamw_leaf": fused_adamw_leaf,
            "short_attention_probs": short_attention_probs,
            "short_attention_probs_backward": short_attention_probs_backward,
            "short_attention_packed": short_attention_packed,
            "short_attention_packed_backward": short_attention_packed_backward,
            "dropout_keep_mask": dropout_keep_mask,
            "fused_joint_embed": fused_joint_embed,
            "ln_quant_static": ln_quant_static,
            "ln_quant_dynamic": ln_quant_dynamic,
            "flash_attention2": flash_attention2,
            "flash2_bwd_fused": flash2_bwd_fused,
            "flash2_bwd_split": flash2_bwd_split,
            "flash_attention": flash_attention,
            "flash_attention_backward": flash_attention_backward,
            "short_attention_v1": short_attention_v1,
            "short_attention_v1_backward": short_attention_v1_backward}


def kernel_counts():
    return {name: fn.launches for name, fn in kernel_counters().items()}


def expect_counts(**nonzero):
    """Every counter 0 except those given."""
    want = dict.fromkeys(kernel_counters(), 0)
    want.update(nonzero)
    return want


def reset_counts():
    for fn in kernel_counters().values():
        fn.launches = 0


def phase_serving(exp, params):
    import numpy as np
    import torch

    from msa_tpu_torch.data import synthetic_split
    from msa_tpu_torch.inference import Predictor
    from msa_tpu_torch.models.weights import to_device

    cfg = exp.model
    split = synthetic_split(N_SERVE, TEXT_LEN, cfg.visual_dim, cfg.speech_dim,
                            vocab_size=cfg.bert.vocab_size, seed=0)
    pred = Predictor(exp, params, BATCH, "cuda")
    n_batches = -(-N_SERVE // BATCH)

    warm = pred.predict_split(split)  # first use: cuBLAS handles, kernels
    reset_counts()
    t0 = time.perf_counter()
    out = pred.predict_split(split)  # ends in a device-to-host copy
    seconds = time.perf_counter() - t0
    launches = kernel_counts()
    t1 = time.perf_counter()
    pred.predict_split(split)
    seconds_again = time.perf_counter() - t1

    layers = cfg.bert.num_hidden_layers
    want = serving_launches(layers, n_batches)
    if launches != want:
        raise AssertionError(f"serving kernel launches {launches}, want "
                             f"{want} ({n_batches} batches)")
    if out.shape != (N_SERVE,) or not np.isfinite(out).all():
        raise AssertionError(f"predictions: shape {out.shape}, finite "
                             f"{bool(np.isfinite(out).all())}")
    if np.abs(out).max() > 1.0:
        raise AssertionError(f"predictions outside [-1, 1]: {np.abs(out).max()}")
    if not np.array_equal(out, warm):
        print(f"note: repeated bf16 runs differ by "
              f"{float(np.abs(out - warm).max()):.3e}")
    print(f"serving bf16 bert-large B={BATCH} L={TEXT_LEN}: {N_SERVE} samples "
          f"in {n_batches} batches, {N_SERVE / seconds:.2f} samples/s "
          f"({seconds * 1e3:.1f} ms; again {N_SERVE / seconds_again:.2f} "
          f"samples/s); launches {launches}", flush=True)

    # f32 on the card (no TF32 anywhere) against the CPU plain run
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    exp32 = dataclasses.replace(
        exp, train=dataclasses.replace(exp.train, compute_dtype="float32"))
    rows = [0, 7, N_SERVE // 2, N_SERVE - 1]
    sub = [np.asarray(x)[rows] for x in (split.input_ids, split.attention_mask,
                                          split.visual, split.speech)]
    gpu32 = Predictor(exp32, params, len(rows), "cuda").predict_arrays(*sub)
    cpu32 = Predictor(exp32, to_device(params, "cpu"), len(rows),
                      "cpu").predict_arrays(*sub)
    err32 = float(np.abs(gpu32 - cpu32).max())
    if not err32 <= F32_PRED_ATOL:
        raise AssertionError(f"f32 card vs CPU predictions differ by {err32:.3e}"
                             f" > {F32_PRED_ATOL}")
    print(f"f32 card vs CPU plain on {len(rows)} samples: max |diff| "
          f"{err32:.3e} (atol {F32_PRED_ATOL}); bf16 vs f32 on the card "
          f"{float(np.abs(out[rows] - gpu32).max()):.3e}", flush=True)
    return pred, split, launches


def serving_launches(layers, n_batches, quantize=None, fuse_qkv=False):
    """Kernel launches of ``n_batches`` serving batches: per encoder call
    one attention forward per layer (the packed one under ``fuse_qkv``)
    and, int8_static, two ln_quant per layer (mlp_in and the closing
    LayerNorm; under ``fuse_qkv`` mlp_in only, as in JAX), int8 one
    (mlp_in)."""
    per_call = {None: (0, 0), "int8": (0, 1),
                "int8_static": (1 if fuse_qkv else 2, 0)}
    static, dynamic = per_call[quantize]
    attention = 2 * layers * n_batches
    return expect_counts(short_attention=0 if fuse_qkv else attention,
                         short_attention_packed=attention if fuse_qkv else 0,
                         fused_joint_embed=2 * n_batches,
                         ln_quant_static=2 * static * layers * n_batches,
                         ln_quant_dynamic=2 * dynamic * layers * n_batches)


def int8_f32_gaps(exp, params, split, calib, fuse_qkv=False):
    """f32 int8 and int8_static Predictors on the card (no TF32) against the
    CPU's plain run on two samples, depth cut to INT8_F32_LAYERS: the
    largest |difference| per mode, each within INT8_F32_PRED_ATOL."""
    import numpy as np
    import torch

    from msa_tpu_torch.inference import Predictor
    from msa_tpu_torch.models.weights import to_device

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    bert = dataclasses.replace(exp.model.bert, num_hidden_layers=INT8_F32_LAYERS)
    exp32 = dataclasses.replace(
        exp, model=dataclasses.replace(exp.model, bert=bert),
        train=dataclasses.replace(exp.train, compute_dtype="float32"))
    cut = dict(params, bert=dict(params["bert"],
                                 layers=params["bert"]["layers"][:INT8_F32_LAYERS]))
    rows = [0, N_SERVE - 1]
    sub = [np.asarray(x)[rows] for x in (split.input_ids, split.attention_mask,
                                          split.visual, split.speech)]
    calib32 = dataclasses.replace(calib, **{
        f: np.asarray(getattr(split, f))[rows] for f in (
            "input_ids", "attention_mask", "visual", "speech", "target")})
    errs = {}
    for mode in ("int8", "int8_static"):
        kw = {"quantize": mode, "fuse_qkv": fuse_qkv,
              "calibration": calib32 if mode == "int8_static" else None}
        gpu = Predictor(exp32, cut, len(rows), "cuda", **kw).predict_arrays(*sub)
        cpu = Predictor(exp32, to_device(cut, "cpu"), len(rows), "cpu",
                        **kw).predict_arrays(*sub)
        errs[mode] = float(np.abs(gpu - cpu).max())
        if not errs[mode] <= INT8_F32_PRED_ATOL:
            raise AssertionError(f"f32 {mode} (fuse_qkv {fuse_qkv}) card vs "
                                 f"CPU predictions differ by {errs[mode]:.3e} "
                                 f"> {INT8_F32_PRED_ATOL}")
    return errs


def phase_int8_serving(exp, params, pred16, split):
    """The int8 and int8_static Predictors on the bf16 phase's weights."""
    import numpy as np
    import torch

    from msa_tpu_torch.inference import Predictor
    from msa_tpu_torch.ops.quant import int8_mm

    layers = exp.model.bert.num_hidden_layers
    n_batches = -(-N_SERVE // BATCH)
    calib = dataclasses.replace(split, **{
        f: getattr(split, f)[:2 * BATCH] for f in (
            "input_ids", "attention_mask", "visual", "speech", "target")})
    preds = {"bf16": pred16,
             "int8": Predictor(exp, params, BATCH, "cuda", quantize="int8"),
             "int8_static": Predictor(exp, params, BATCH, "cuda",
                                      quantize="int8_static",
                                      calibration=calib)}
    outs, launches = {}, {}
    for mode, pred in preds.items():
        pred.predict_split(split)  # warm: cuBLAS int8 handles
        reset_counts()
        outs[mode] = pred.predict_split(split)
        launches[mode] = kernel_counts()
        want = serving_launches(layers, n_batches,
                                None if mode == "bf16" else mode)
        if launches[mode] != want:
            raise AssertionError(f"{mode} serving kernel launches "
                                 f"{launches[mode]}, want {want}")
        out = outs[mode]
        if out.shape != (N_SERVE,) or not np.isfinite(out).all() or \
                np.abs(out).max() > 1.0:
            raise AssertionError(f"{mode} predictions: shape {out.shape}, "
                                 f"max |p| {np.abs(out).max()}")
    # the int8 GEMM (cuBLAS through torch._int_mm) against the CPU's on the
    # path's weights: integer products, so bit-equal; 5 rows take the
    # zero-row padding that cuBLAS needs below 17
    gen = torch.Generator(device="cuda").manual_seed(5)
    layer = preds["int8"].params["bert"]["layers"][0]
    for name in ("q", "wi", "wo"):
        w = layer[name]["qweight"]
        for rows in (5, 8 * TEXT_LEN):
            xi = torch.randint(-127, 128, (rows, w.shape[1]), device="cuda",
                               dtype=torch.int8, generator=gen)
            if not torch.equal(int8_mm(xi, w).cpu(), int8_mm(xi.cpu(), w.cpu())):
                raise AssertionError(f"int8 GEMM {name} [{rows},{w.shape[1]}]"
                                     f"x[{w.shape[1]},{w.shape[0]}]: card and "
                                     "CPU products differ")
    print("int8 GEMM (torch._int_mm) on the card bit-equal to the CPU's for "
          "q, wi and wo at 5 and 320 rows", flush=True)

    rates = {mode: [] for mode in preds}
    for mode in ("bf16", "int8", "int8_static", "int8_static", "int8", "bf16"):
        t0 = time.perf_counter()
        preds[mode].predict_split(split)  # ends in a device-to-host copy
        rates[mode].append(N_SERVE / (time.perf_counter() - t0))
    for mode in ("int8", "int8_static"):
        gap = float(np.abs(outs[mode] - outs["bf16"]).max())
        corr = float(np.corrcoef(outs[mode], outs["bf16"])[0, 1])
        print(f"serving {mode} bert-large B={BATCH} L={TEXT_LEN}: samples/s "
              f"{[round(r, 2) for r in rates[mode]]} (bf16 "
              f"{[round(r, 2) for r in rates['bf16']]}, same process, order "
              f"bf16 int8 int8_static int8_static int8 bf16); launches per "
              f"batch {({k: v // n_batches for k, v in launches[mode].items()})};"
              f" against bf16: max |diff| {gap:.3e}, correlation {corr:.6f} "
              f"(random weights: predictions spread {float(np.ptp(outs['bf16'])):.3e})",
              flush=True)

    errs = int8_f32_gaps(exp, params, split, calib)
    print(f"f32 int8 / int8_static card vs CPU plain ({INT8_F32_LAYERS} "
          f"layers at full width, 2 samples): max |diff| "
          f"{errs['int8']:.3e} / {errs['int8_static']:.3e} (atol "
          f"{INT8_F32_PRED_ATOL})", flush=True)
    return launches, rates, preds, outs, calib


def cli_requests(cfg, n, seed):
    import numpy as np

    rng = np.random.default_rng(seed)
    words = ["love", "hate", "this", "movie", "the", "plot", "was", "great"]
    reqs = []
    for i in range(n):
        k = int(rng.integers(1, 12))
        req = {"id": f"r{i}", "words": [words[j] for j in
                                        rng.integers(0, len(words), k)]}
        if i % 3 != 2:
            req["visual"] = rng.standard_normal((k, cfg.visual_dim)).round(3).tolist()
        if i % 3 != 1:
            req["speech"] = rng.standard_normal((k, cfg.speech_dim)).round(3).tolist()
        reqs.append(json.dumps(req))
    return reqs


def phase_service_cli(exp, params):
    """The service CLI in a subprocess on a checkpoint the port wrote,
    against the in-process Predictor.from_checkpoint on the same lines."""
    import numpy as np

    from msa_tpu_torch.cli.serve import read_calibration, serve_stream
    from msa_tpu_torch.data import FastTokenizer, make_test_vocab
    from msa_tpu_torch.inference import Predictor
    from msa_tpu_torch.training.checkpoint import save_checkpoint
    from msa_tpu_torch.training.optim import make_optimizer
    from msa_tpu_torch.training.train_state import TrainState

    cfg = exp.model
    # bf16 Adam moments keep the file at ~2.7 GB
    exp = dataclasses.replace(exp, train=dataclasses.replace(
        exp.train, adam_mu_dtype="bfloat16", adam_nu_dtype="bfloat16"))
    reqs = cli_requests(cfg, CLI_REQUESTS, seed=11)
    reqs.insert(5, "NOT JSON")
    repo = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        state = TrainState(params=params,
                           opt_state=make_optimizer(exp.train, 1).init(params))
        run = os.path.join(tmp, "run")
        save_checkpoint(os.path.join(run, "epoch_000"), state, exp, epoch=0)
        del state
        size = os.path.getsize(os.path.join(run, "epoch_000", "state.msgpack"))
        save_s = time.perf_counter() - t0
        vocab = make_test_vocab(extra_words=["love", "hate", "this", "movie",
                                             "plot", "great"])
        paths = {k: os.path.join(tmp, k) for k in (
            "vocab.txt", "requests.jsonl", "calibration.jsonl", "cli.jsonl",
            "in_process.jsonl")}
        with open(paths["vocab.txt"], "w") as f:
            f.writelines(tok + "\n" for tok in sorted(vocab, key=vocab.get))
        with open(paths["requests.jsonl"], "w") as f:
            f.write("\n".join(reqs) + "\n")
        with open(paths["calibration.jsonl"], "w") as f:
            f.write("\n".join(cli_requests(cfg, 2 * CLI_BATCH, seed=12)) + "\n")
        cmd = [sys.executable, "-m", "msa_tpu_torch.cli.serve", "--checkpoint",
               run, "--vocab", paths["vocab.txt"], "--batch_size",
               str(CLI_BATCH), "--quantize", "int8_static", "--calibration",
               paths["calibration.jsonl"], "--input", paths["requests.jsonl"],
               "--output", paths["cli.jsonl"]]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, cwd=repo, capture_output=True, text=True,
                              timeout=600, env=dict(os.environ, PYTHONPATH=repo))
        cli_s = time.perf_counter() - t0
        if proc.returncode != 0:
            raise AssertionError(f"service CLI exit {proc.returncode}:\n"
                                 f"{proc.stderr[-4000:]}")
        with open(paths["cli.jsonl"]) as f:
            lines = [json.loads(x) for x in f.read().splitlines()]

        tokenizer = FastTokenizer(paths["vocab.txt"])
        pred = Predictor.from_checkpoint(
            run, batch_size=CLI_BATCH, device="cuda", quantize="int8_static",
            calibration=read_calibration(paths["calibration.jsonl"], tokenizer,
                                         exp))
        with open(paths["requests.jsonl"]) as fin, \
                open(paths["in_process.jsonl"], "w") as fout:
            counts = serve_stream(pred, tokenizer, fin, fout,
                                  batch_size=CLI_BATCH, max_wait=0.05,
                                  drain_flush=True)
        with open(paths["in_process.jsonl"]) as f:
            ref = [json.loads(x) for x in f.read().splitlines()]
    answers = {x["id"]: x["prediction"] for x in lines if "prediction" in x}
    errors = [x for x in lines if "error" in x]
    want = {x["id"]: x["prediction"] for x in ref if "prediction" in x}
    if len(answers) != CLI_REQUESTS or len(errors) != 1 or \
            errors[0]["id"] is not None or set(answers) != set(want) or \
            counts != {"answered": CLI_REQUESTS, "errors": 1}:
        raise AssertionError(f"service CLI: {len(answers)} answers, errors "
                             f"{errors}, in-process counts {counts}")
    diff = max(abs(answers[k] - want[k]) for k in want)
    # the same code on the same card and lines, batched alike: equal
    if diff != 0.0 or not all(np.isfinite(list(answers.values()))):
        raise AssertionError(f"service CLI answers differ from the in-process "
                             f"Predictor by {diff:.3e}")
    print(f"service CLI (python -m msa_tpu_torch.cli.serve --quantize "
          f"int8_static, batch {CLI_BATCH}) on a port-written bert-large "
          f"checkpoint ({size / 1e9:.2f} GB, written in {save_s:.1f} s): exit 0"
          f" in {cli_s:.1f} s, {len(answers)} answered, 1 error line, answers "
          f"equal to the in-process Predictor.from_checkpoint", flush=True)


def phase_service(pred, frames=None):
    """JSONL lines through ``serve_stream``; ``frames``: a frame-level
    model's native-rate rows per request (any count; past Lp they are cut),
    else one row per word."""
    import numpy as np

    from msa_tpu_torch.cli.serve import serve_stream
    from msa_tpu_torch.data import FastTokenizer, make_test_vocab

    cfg = pred.config.model
    vis = lambda n: [[0.1] * cfg.visual_dim] * (frames or n)  # noqa: E731
    spc = lambda n: [[0.2] * cfg.speech_dim] * (frames or n)  # noqa: E731
    reqs = [
        json.dumps({"id": "a", "words": ["love", "this", "movie"],
                    "visual": vis(3), "speech": spc(3)}),
        json.dumps({"id": "b", "words": ["hate", "this"], "speech": spc(2)}),
        json.dumps({"id": "c", "words": ["the", "plot", "was", "great"]}),
        "NOT JSON",
        json.dumps({"id": "d", "words": ["bad"], "visual": vis(1)}),
        json.dumps({"id": "e", "words": ["really", "not", "good", "film"],
                    "visual": vis(4), "speech": spc(4)}),
    ]
    with tempfile.TemporaryDirectory() as tmp:
        vocab = make_test_vocab(extra_words=["love", "hate", "this"])
        path = os.path.join(tmp, "vocab.txt")
        with open(path, "w") as f:
            f.writelines(tok + "\n" for tok in sorted(vocab, key=vocab.get))
        tokenizer = FastTokenizer(path)
        fout = io.StringIO()
        t0 = time.perf_counter()
        counts = serve_stream(pred, tokenizer, io.StringIO("\n".join(reqs) + "\n"),
                              fout, batch_size=pred.batch_size, max_wait=0.05,
                              drain_flush=True)
        seconds = time.perf_counter() - t0
    lines = [json.loads(x) for x in fout.getvalue().splitlines()]
    answers = {x["id"]: x["prediction"] for x in lines if "prediction" in x}
    errors = [x for x in lines if "error" in x]
    if counts != {"answered": 5, "errors": 1} or set(answers) != set("abcde") \
            or len(errors) != 1 or errors[0]["id"] is not None:
        raise AssertionError(f"service: counts {counts}, lines {lines}")
    if not all(np.isfinite(p) and abs(p) <= 1.0 for p in answers.values()):
        raise AssertionError(f"service predictions {answers}")
    mode = "" if frames is None else f" (frame level, {frames} frames a request)"
    print(f"serve_stream{mode}: answered {counts['answered']}, errors "
          f"{counts['errors']}, {seconds * 1e3:.1f} ms for the stream (one "
          "flush at EOF)", flush=True)


def phase_training():
    """bert-large bf16 train steps at bench.py's shape, with dropout."""
    import torch

    from msa_tpu_torch.data import MultimodalDataset, synthetic_split
    from msa_tpu_torch.training.trainer import Trainer

    exp = train_experiment(BATCH)
    cfg = exp.model
    trainer = Trainer(exp, "cuda")
    state = trainer.init_state(0, total_steps=10_000)
    split = synthetic_split(4 * BATCH, TEXT_LEN, cfg.visual_dim,
                            cfg.speech_dim, vocab_size=cfg.bert.vocab_size,
                            seed=0)
    batches = list(MultimodalDataset(split, seed=0).epoch_batches(
        0, BATCH, drop_last=True))
    watch = {"bert/layers/0/q/weight": state.params["bert"]["layers"][0]["q"]["weight"],
             "joint/Wv/kernel": state.params["joint"]["Wv"]["kernel"],
             "fusion/classifier2/weight": state.params["fusion"]["classifier2"]["weight"]}
    before = {k: v.detach().clone() for k, v in watch.items()}
    for i in range(TRAIN_WARMUP):
        state, metrics = trainer.train_step(state, batches[i % len(batches)], 1)
        float(metrics["loss"])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    step_metrics = []
    t0 = time.perf_counter()
    for i in range(TRAIN_STEPS):
        state, metrics = trainer.train_step(state, batches[i % len(batches)], 1)
        step_metrics.append(metrics)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = kernel_counts()
    peak = torch.cuda.max_memory_allocated()

    layers = cfg.bert.num_hidden_layers
    want = rung_launches("none", layers, TRAIN_STEPS)
    if trainer.remat_policy != "none" or launches != want:
        raise AssertionError(f"training: remat {trainer.remat_policy}, launches "
                             f"{launches}, want {want} ({TRAIN_STEPS} steps)")
    host = [{k: float(v) for k, v in m.items()} for m in step_metrics]
    if not all(all(map(lambda x: x == x and abs(x) < float("inf"), m.values()))
               for m in host):
        raise AssertionError(f"training: non-finite metrics {host}")
    if any(m["mlm_overflow"] for m in host) or not all(m["mlm_loss"] > 0
                                                       for m in host):
        raise AssertionError(f"training: MLM loss or gather cap {host}")
    moved = {k: float((watch[k].detach() - before[k]).abs().max())
             for k in watch}
    if not all(x > 0 for x in moved.values()):
        raise AssertionError(f"training: parameters did not move {moved}")
    # the deterministic eval step on the trained weights (a ragged batch)
    batch = dict(batches[0], weight=batches[0]["weight"].copy())
    batch["weight"][-7:] = 0.0
    losses = trainer.eval_step(state.params, batch, 0)
    preds = losses["predictions"].float()
    if preds.shape != (BATCH, 1) or not torch.isfinite(preds).all() or \
            not torch.isfinite(losses["loss"]) or float(losses["mlm_loss"]):
        raise AssertionError(f"eval step: predictions {tuple(preds.shape)}, "
                             f"loss {float(losses['loss'])}, mlm "
                             f"{float(losses['mlm_loss'])}")
    ms_step = seconds * 1e3 / TRAIN_STEPS
    sps = BATCH * TRAIN_STEPS / seconds
    per_step = {k: v // TRAIN_STEPS for k, v in launches.items()}
    print(f"training bf16 bert-large B={BATCH} L={TEXT_LEN} (dropout "
          f"{cfg.bert.hidden_dropout_prob}/{cfg.bert.attention_probs_dropout_prob}"
          f"/{cfg.joint_dropout_prob}, MLM on, remat off: activations "
          f"~{trainer.activation_bytes() / 1e9:.1f} GB estimated): "
          f"{TRAIN_STEPS} steps after {TRAIN_WARMUP} warm-up, "
          f"{ms_step:.2f} ms/step, {sps:.2f} samples/s, MFU "
          f"{trainer.mfu(sps):.4f} (of 989 TFLOP/s bf16), peak memory "
          f"{peak / 2**30:.2f} GiB; launches per step {per_step}; losses "
          f"{[round(m['loss'], 4) for m in host]}; max |update| {moved}; "
          f"eval step loss {float(losses['loss']):.4f}", flush=True)
    return launches, {"ms_step": ms_step, "samples_per_s": sps,
                      "mfu": trainer.mfu(sps), "peak_bytes": peak}


def frame_experiment(pair_len, layers=None, model="bert-large-uncased",
                     **train):
    """MMBert (bert-large, or the preset ``model``) on MOSI widths in
    frame-level mode (``pair_len`` native-rate frames per modality), depth
    cut to ``layers`` if given."""
    from msa_tpu_torch.configs import build_experiment

    exp = build_experiment("mosi", model, num_labels=1, **train)
    data = dataclasses.replace(exp.data, pair_seq_length=pair_len)
    bert = exp.model.bert
    if layers is not None:
        bert = dataclasses.replace(bert, num_hidden_layers=layers)
    return dataclasses.replace(exp, data=data, model=dataclasses.replace(
        exp.model, bert=bert))


def cut_depth(params, layers):
    return dict(params, bert=dict(params["bert"],
                                  layers=params["bert"]["layers"][:layers]))


def phase_frame_serving(params):
    """The bf16 Predictor in frame-level mode (B=16, L=40, Lp=984: the joint
    pass is [32, 1024], the flash2 forward's range) on the bf16 phase's
    weights, then an f32 card run against the CPU at cut depth."""
    import numpy as np
    import torch

    from msa_tpu_torch.data import synthetic_split
    from msa_tpu_torch.inference import Predictor
    from msa_tpu_torch.models.weights import to_device

    exp = frame_experiment(FRAME_PAIR_LEN)
    cfg = exp.model
    split = synthetic_split(FRAME_SERVE, TEXT_LEN, cfg.visual_dim,
                            cfg.speech_dim, vocab_size=cfg.bert.vocab_size,
                            seed=1, pair_seq_length=FRAME_PAIR_LEN)
    pred = Predictor(exp, params, FRAME_BATCH, "cuda")
    n_batches = -(-FRAME_SERVE // FRAME_BATCH)
    pred.predict_split(split)  # warm
    reset_counts()
    t0 = time.perf_counter()
    out = pred.predict_split(split)  # ends in a device-to-host copy
    seconds = time.perf_counter() - t0
    launches = kernel_counts()
    t1 = time.perf_counter()
    pred.predict_split(split)
    seconds_again = time.perf_counter() - t1
    layers = cfg.bert.num_hidden_layers
    want = expect_counts(short_attention=layers * n_batches,
                         flash_attention2=layers * n_batches,
                         fused_joint_embed=2 * n_batches)
    if launches != want:
        raise AssertionError(f"frame-level serving launches {launches}, want "
                             f"{want} ({n_batches} batches)")
    if out.shape != (FRAME_SERVE,) or not np.isfinite(out).all() or \
            np.abs(out).max() > 1.0:
        raise AssertionError(f"frame-level predictions: shape {out.shape}, "
                             f"max |p| {np.abs(out).max()}")
    per_batch = {k: v // n_batches for k, v in launches.items() if v}
    print(f"frame-level serving bf16 bert-large B={FRAME_BATCH} L={TEXT_LEN} "
          f"Lp={FRAME_PAIR_LEN} (joint pass [{2 * FRAME_BATCH},"
          f"{TEXT_LEN + FRAME_PAIR_LEN}]): {FRAME_SERVE} samples in "
          f"{n_batches} batches, {FRAME_SERVE / seconds:.2f} samples/s "
          f"({seconds * 1e3 / n_batches:.1f} ms per batch; again "
          f"{FRAME_SERVE / seconds_again:.2f} samples/s); launches per batch "
          f"{per_batch}", flush=True)
    phase_service(pred, frames=FRAME_PAIR_LEN + 200)

    # f32 on the card (no TF32) against the CPU plain run, depth cut
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    exp32 = frame_experiment(FRAME_PAIR_LEN, FRAME_F32_LAYERS,
                             compute_dtype="float32")
    cut = cut_depth(params, FRAME_F32_LAYERS)
    rows = [0, FRAME_SERVE - 1]
    sub = [np.asarray(x)[rows] for x in (split.input_ids, split.attention_mask,
                                          split.visual, split.speech)]
    gpu32 = Predictor(exp32, cut, len(rows), "cuda").predict_arrays(*sub)
    cpu32 = Predictor(exp32, to_device(cut, "cpu"), len(rows),
                      "cpu").predict_arrays(*sub)
    err32 = float(np.abs(gpu32 - cpu32).max())
    if not err32 <= F32_PRED_ATOL:
        raise AssertionError(f"frame-level f32 card vs CPU predictions differ "
                             f"by {err32:.3e} > {F32_PRED_ATOL}")
    print(f"frame-level f32 card vs CPU plain ({FRAME_F32_LAYERS} layers at "
          f"full width, {len(rows)} samples): max |diff| {err32:.3e} (atol "
          f"{F32_PRED_ATOL})", flush=True)
    return launches, FRAME_SERVE / seconds


def phase_frame_training(pair_len, batch, layers, warmup, steps, label,
                         model="bert-large-uncased"):
    """bf16 train steps in frame-level mode (MOSI widths, the default
    dropouts, MLM on, bf16 Adam moments): finite losses, moved parameters
    and the kernel launches per step, with the joint pass's backward on the
    route JAX's rule gives its length."""
    import torch

    from msa_tpu_torch.data import MultimodalDataset, synthetic_split
    from msa_tpu_torch.ops.flash2 import use_fused_backward
    from msa_tpu_torch.training.trainer import Trainer

    exp = frame_experiment(pair_len, layers, model, train_batch_size=batch,
                           compute_dtype="bfloat16", warmup_proportion=0.01,
                           adam_mu_dtype="bfloat16", adam_nu_dtype="bfloat16",
                           data_parallel=1)
    cfg = exp.model
    trainer = Trainer(exp, "cuda")
    state = trainer.init_state(0, total_steps=10_000)
    split = synthetic_split(2 * batch, TEXT_LEN, cfg.visual_dim,
                            cfg.speech_dim, vocab_size=cfg.bert.vocab_size,
                            seed=2, pair_seq_length=pair_len)
    batches = list(MultimodalDataset(split, seed=0).epoch_batches(
        0, batch, drop_last=True))
    watch = {"bert/layers/0/q/weight": state.params["bert"]["layers"][0]["q"]["weight"],
             "joint/Wv/kernel": state.params["joint"]["Wv"]["kernel"]}
    before = {k: v.detach().clone() for k, v in watch.items()}
    for i in range(warmup):
        state, metrics = trainer.train_step(state, batches[i % len(batches)], 1)
        float(metrics["loss"])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    step_metrics = []
    t0 = time.perf_counter()
    for i in range(steps):
        state, metrics = trainer.train_step(state, batches[i % len(batches)], 1)
        step_metrics.append(metrics)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = kernel_counts()
    peak = torch.cuda.max_memory_allocated()

    n = cfg.bert.num_hidden_layers
    seq = TEXT_LEN + pair_len
    fused = use_fused_backward(seq, cfg.bert.hidden_size,
                               cfg.bert.num_attention_heads, torch.bfloat16)
    want = rung_launches("none", n, steps, frame=True, fused=fused)
    if trainer.remat_policy != "none" or launches != want:
        raise AssertionError(f"{label} training: remat {trainer.remat_policy}, "
                             f"launches {launches}, want {want}")
    host = [{k: float(v) for k, v in m.items()} for m in step_metrics]
    if not all(all(x == x and abs(x) < float("inf") for x in m.values())
               for m in host):
        raise AssertionError(f"{label} training: non-finite metrics {host}")
    if any(m["mlm_overflow"] for m in host) or not all(m["mlm_loss"] > 0
                                                       for m in host):
        raise AssertionError(f"{label} training: MLM loss or gather cap {host}")
    moved = {k: float((watch[k].detach() - before[k]).abs().max())
             for k in watch}
    if not all(x > 0 for x in moved.values()):
        raise AssertionError(f"{label} training: parameters did not move {moved}")
    ms_step = seconds * 1e3 / steps
    sps = batch * steps / seconds
    per_step = {k: v // steps for k, v in launches.items() if v}
    print(f"{label} training bf16 {model} ({n} layers) B={batch} "
          f"L={TEXT_LEN} Lp={pair_len} (joint pass [{2 * batch},{seq}], "
          f"{'fused' if fused else 'split'} flash2 backward; remat off: "
          f"activations ~{trainer.activation_bytes() / 1e9:.1f} GB estimated):"
          f" {steps} steps after {warmup} warm-up, {ms_step:.2f} ms/step, "
          f"{sps:.2f} samples/s, MFU {trainer.mfu(sps):.4f} (of 989 TFLOP/s "
          f"bf16), peak memory {peak / 2**30:.2f} GiB; launches per step "
          f"{per_step}; losses {[round(m['loss'], 4) for m in host]}; max "
          f"|update| {moved}", flush=True)
    return launches, {"ms_step": ms_step, "samples_per_s": sps,
                      "mfu": trainer.mfu(sps), "peak_bytes": peak}


def phase_f32_train(pair_len=None, batch_size=8):
    """Two f32 train steps of a small model, card against CPU, same weights
    and injected MLM masks, dropout 0, TF32 off.  ``pair_len``: frame-level
    mode with that many frames (at L + Lp = 1024 the joint pass runs the
    flash2 kernels in f32)."""
    import numpy as np
    import torch

    from msa_tpu_torch.configs import (
        BertConfig, DataConfig, ExperimentConfig, MMBertConfig, TrainConfig)
    from msa_tpu_torch.data import MultimodalDataset, synthetic_split
    from msa_tpu_torch.models.weights import init_params, named_leaves
    from msa_tpu_torch.training.trainer import Trainer

    mode = "" if pair_len is None else f", frame level L={TEXT_LEN} Lp={pair_len}"
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    bert = BertConfig(hidden_size=256, num_hidden_layers=4,
                      num_attention_heads=4, intermediate_size=1024,
                      hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
    exp = ExperimentConfig(
        model_name="small",
        model=MMBertConfig(bert=bert, joint_dropout_prob=0.0),
        data=DataConfig(max_seq_length=TEXT_LEN, pair_seq_length=pair_len),
        train=TrainConfig(compute_dtype="float32",
                          train_batch_size=batch_size,
                          data_parallel=1, warmup_proportion=0.0))
    params = init_params(exp.model, torch.Generator().manual_seed(3))
    split = synthetic_split(2 * batch_size, TEXT_LEN, exp.model.visual_dim,
                            exp.model.speech_dim, seed=4,
                            pair_seq_length=pair_len)
    batches = list(MultimodalDataset(split, seed=5).epoch_batches(
        0, batch_size))
    rng = np.random.default_rng(6)
    for batch in batches:
        ids = batch["text_ids"]
        special = np.isin(ids, (0, 100, 101, 102, 103))
        masked = (rng.random((ids.shape[0], 3, ids.shape[1])) < 0.15) & \
            ~special[:, None]
        batch["mlm_masked"] = masked
        batch["mlm_replaced"] = (rng.random(masked.shape) < 0.8) & masked
    runs = {}
    for device in ("cuda", "cpu"):
        trainer = Trainer(exp, device)
        state = trainer.init_state(0, total_steps=4, params=params)
        # the first step's per-leaf gradients, as the optimizer receives them
        first_grads = {}
        update = trainer.tx.step

        def step(p, grads, opt_state, update=update, first_grads=first_grads):
            if not first_grads:
                first_grads.update({k: g.detach().cpu().clone()
                                    for k, g in grads.items()})
            return update(p, grads, opt_state)

        trainer.tx.step = step
        losses = []
        for batch in batches:
            state, metrics = trainer.train_step(state, batch, 7)
            losses.append(float(metrics["loss"]))
        runs[device] = (losses, dict(named_leaves(state.params)), first_grads)
    (gl, gp, gg), (cl, cp, cg) = runs["cuda"], runs["cpu"]
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(gl, cl))
    param_err = max(float((gp[k].detach().cpu() - cp[k].detach()).abs().max())
                    for k in cp)
    moved = max(float((cp[k].detach() - v).abs().max())
                for k, v in named_leaves(params))
    # per leaf in the 2-norm (F32_GRAD_*); leaves the loss does not reach
    # (the NSP head) are zero on both sides
    if set(gg) != set(cg):
        raise AssertionError("f32 train: the two runs' gradient leaves differ")
    total = float(torch.linalg.vector_norm(
        torch.stack([g.norm() for g in cg.values()])))
    floor = F32_GRAD_FLOOR * total
    grad_ratio, worst_leaf, rel_err = 0.0, None, 0.0
    for k in cg:
        ref_norm = float(cg[k].norm())
        diff = float((gg[k] - cg[k]).norm())
        ratio = diff / (F32_GRAD_RTOL * ref_norm + floor)
        if ratio >= grad_ratio:
            grad_ratio, worst_leaf = ratio, k
        if ref_norm > 1e3 * floor:  # leaves clear of the noise floor
            rel_err = max(rel_err, diff / ref_norm)
    zero = [k for k in cg if not float(cg[k].norm())]
    if not (loss_err <= F32_LOSS_RTOL and param_err <= F32_PARAM_ATOL
            and moved > 5 * F32_PARAM_ATOL and grad_ratio <= 1.0
            and len(zero) < len(cg) // 2):
        raise AssertionError(
            f"f32 train{mode} card vs CPU: loss rel err {loss_err:.3e} (rtol "
            f"{F32_LOSS_RTOL}), param err {param_err:.3e} (atol "
            f"{F32_PARAM_ATOL}), params moved {moved:.3e}, first-step "
            f"gradients: {worst_leaf} at {grad_ratio:.3e} of its tolerance "
            f"(rtol {F32_GRAD_RTOL}, floor {floor:.3e}), zero-gradient "
            f"leaves {zero}")
    print(f"f32 train steps (4 layers, H=256, B={batch_size}{mode}) card vs CPU "
          f"plain: losses "
          f"{[round(x, 6) for x in gl]} vs {[round(x, 6) for x in cl]}, max "
          f"rel err {loss_err:.3e} (rtol {F32_LOSS_RTOL}); first-step "
          f"gradients of {len(cg)} leaves: worst relative 2-norm error "
          f"{rel_err:.3e} over leaves above 1e3 x the floor, worst leaf "
          f"{worst_leaf} at {grad_ratio:.3e} of its tolerance (rtol "
          f"{F32_GRAD_RTOL}, floor {F32_GRAD_FLOOR} x |g| = {floor:.3e}); "
          f"params max |diff| {param_err:.3e} (atol {F32_PARAM_ATOL}) after "
          f"moving up to {moved:.3e}", flush=True)
    return loss_err, param_err


def rounded_rule_ctx(q, k, v, bias, rate, keep):
    """ctx by the rule of JAX's v1 and v2s forwards and of the port's
    tensor-core forwards, evaluated in f32: the f32 softmax, the dropped
    probabilities rounded to q's dtype before P V (``p.astype(v.dtype)``,
    ``pd.astype(vg.dtype)``; the plain versions' ``.to(q.dtype)``), the
    product and the result left in f32."""
    import torch

    from msa_tpu_torch.ops import short_attention as sa

    b, s, h = q.shape
    p = sa._scores_plain(q, k, bias, HEADS)
    if keep is not None:
        p = torch.where(keep, p / (1.0 - rate), 0.0)
    ctx = torch.einsum("bnqk,bknd->bqnd", p.to(q.dtype).float(),
                       v.float().view(b, s, HEADS, -1))
    return ctx.reshape(b, s, h)


def check_masked_rows(tag, out, q, k, v, bias, live, rate, keep):
    """Fully masked rows of a bf16 forward that rounds p to bf16 before P V
    (v1, v2s) at a few keys, against the plain version in f32 within twice
    MASKED_ROW_ATOL plus the gap that rounding makes in the plain rule
    (:func:`check_within`).  Under the -10000 fill the kernel and the rule
    quantise p differently (MASKED_ROW_ATOL's reason), so each rounds some
    p to the neighbouring bf16 value; with a few keys the p are large and
    one such step moves ctx by up to 2^-8 |v|.  Returns (largest
    difference, the rule's largest gap to f32) there."""
    f32 = rounded_rule_ctx(q.float(), k.float(), v.float(), bias, rate, keep)
    gap = (rounded_rule_ctx(q, k, v, bias, rate, keep) - f32).abs()
    diff = check_within(f"{tag} masked row", out, f32, MASKED_ROW_ATOL, 0.0,
                        gap, ~live)
    return diff, float(gap[~live].max())


def check_probs_forward(tag, q, k, v, bias, live, seed, rate, keep,
                        few_keys=False):
    """The v2s forward kernel's ctx and signed probs against the plain
    version on the same values in f32 (ctx on live rows at ATTN_TOL, on
    fully masked rows at MASKED_ROW_ATOL, or with ``few_keys`` by
    :func:`check_masked_rows`) and, with dropout, the probs' signs against
    the keep mask; returns (ctx, probs, the plain ctx, max abs err, the
    masked rows' (difference, rule gap) or None)."""
    import torch

    from msa_tpu_torch.ops import short_attention as sa

    dname = str(q.dtype).split(".")[1]
    atol, rtol = ATTN_TOL[dname]
    s = q.shape[1]
    ctx, probs = sa._probs_forward_kernel(q, k, v, bias, HEADS, seed, rate)
    ref_ctx, ref_probs = sa.short_attention_probs_plain(
        q.float(), k.float(), v.float(), bias, HEADS, rate, keep)
    torch.cuda.synchronize()
    err = check_close(f"short_attention_probs {tag} ctx", ctx, ref_ctx, atol,
                      rtol, mask=live)
    masked = None
    if few_keys:
        masked = check_masked_rows(f"short_attention_probs {tag} ctx", ctx, q,
                                   k, v, bias, live, rate, keep)
    else:
        check_close(f"short_attention_probs {tag} ctx masked row", ctx,
                    ref_ctx, MASKED_ROW_ATOL, 0.0, mask=~live)
    err = max(err, check_close(f"short_attention_probs {tag} probs",
                               probs[live], ref_probs[live], atol, rtol))
    if rate:
        ps = probs[..., :s].float()
        wrong = int((((ps > 0) != keep) & (ps != 0)).sum())
        if wrong:
            raise AssertionError(f"short_attention_probs {tag}: {wrong} signs "
                                 "differ from the exported keep mask")
    return ctx, probs, ref_ctx, err, masked


def check_probs_backward(tag, q, k, v, bias, live, probs, dout, rate, keep):
    """Row 5's backward (dS and pd rounded as JAX's ``_bwd_kernel_v2s``)
    from the v2s forward kernel's own signed probs, by
    :func:`check_rounded_backward`: against the plain backward on the same
    probs at GRAD_TOL, and against autograd through the plain forward in
    f32 within twice it plus the rule's rounding gap (``rule32``: the plain
    backward on the f32 softmax's probs, dS and pd unrounded).  Returns
    (max abs err against the rule, against autograd)."""
    import torch

    from msa_tpu_torch.ops import short_attention as sa

    wide = [x.float() for x in (q, k, v, dout)]
    grads = sa.short_attention_probs_backward(q, k, v, probs, dout, HEADS,
                                              rate)
    rule = sa.short_attention_probs_backward_plain(q, k, v, probs, dout,
                                                   HEADS, rate)
    rule32 = sa.short_attention_probs_backward_plain(
        *wide[:3], sa.short_attention_probs_plain(
            *wide[:3], bias, HEADS, rate, keep)[1], wide[3], HEADS, rate)
    qq, kk, vv = (x.detach().requires_grad_() for x in wide[:3])
    auto = torch.autograd.grad(sa.short_attention_plain(
        qq, kk, vv, bias, HEADS, rate, keep), (qq, kk, vv), wide[3])
    torch.cuda.synchronize()
    return check_rounded_backward(
        f"short_attention_probs_backward {tag}", grads, rule, rule32, auto,
        live, *GRAD_TOL[str(q.dtype).split(".")[1]])


def check_packed(tag, q, k, v, bias, live, dout, seed, rate, keep):
    """The packed pair (v2p) on the thirds of one [B, S, 3H] qkv: its
    forward bit-equal to v2's in both forms, its backward (row 6; JAX's
    ``_bwd_kernel_v2p`` rule, v3's: delta from the ctx, dS and pd rounded)
    bit-equal to the v3 backward on the thirds (the same kernels at row
    stride 3H) and held by :func:`check_rounded_backward` against the
    repaired plain packed rule given the kernel's ctx and against autograd
    through the plain packed forward in f32; the ctx against the plain
    version at ATTN_TOL on live rows.  Returns (qkv, ctx, forward error,
    backward error against the rule, against autograd)."""
    import torch

    from msa_tpu_torch.ops import short_attention as sa
    from msa_tpu_torch.ops.dropout import byte_threshold

    dname = str(q.dtype).split(".")[1]
    t = byte_threshold(rate)
    qkv = torch.cat([q, k, v], dim=-1)
    packed = sa._packed_forward_kernel(qkv, bias, HEADS, seed, t, True)
    serve = sa._packed_forward_kernel(qkv, bias, HEADS, seed, t, False)[0]
    plain2 = sa._forward_kernel(q, k, v, bias, HEADS, seed, t, True)
    out = packed[0]
    dqkv = sa.short_attention_packed_backward(qkv, bias, out, dout, HEADS,
                                              seed, rate)
    v3 = sa.short_attention_v3_backward(q, k, v, bias, out, dout, HEADS, seed,
                                        rate)
    rule = sa.short_attention_packed_backward_plain(qkv, bias, dout, HEADS,
                                                    rate, keep, out=out)
    wide = qkv.detach().float().requires_grad_()
    plain32 = sa.short_attention_packed_plain(wide, bias, HEADS, rate, keep)
    (auto,) = torch.autograd.grad(plain32, wide, dout.float())
    rule32 = sa.short_attention_packed_backward_plain(
        wide.detach(), bias, dout.float(), HEADS, rate, keep)
    torch.cuda.synchronize()
    if not all(torch.equal(a, c) for a, c in zip(packed, plain2)) or \
            not torch.equal(serve, out) or \
            not torch.equal(dqkv, torch.cat(v3, dim=-1)):
        raise AssertionError(f"short_attention_packed {tag}: not bit-equal to "
                             "v2's forward and v3's backward on the thirds")
    atol, rtol = ATTN_TOL[dname]
    ferr = check_close(f"short_attention_packed {tag}", out, plain32, atol,
                       rtol, mask=live)
    berr, auto_err = check_rounded_backward(
        f"short_attention_packed_backward {tag}", sa._thirds(dqkv),
        sa._thirds(rule), sa._thirds(rule32), sa._thirds(auto), live,
        *GRAD_TOL[dname])
    return qkv, out, ferr, berr, auto_err


def phase_probs_packed(gen):
    """The '+probs' (v2s) and 'save_pack' (v2p) pairs against their plain
    versions, at the text and joint shapes, bf16 and f32, rate 0 and with
    dropout: the v2s forward's ctx and signed probs (whose signs are the
    exported keep mask's bits; its ctx also against v2's at the same seed),
    its backward (row 5's, dS and pd rounded as JAX's ``_bwd_kernel_v2s``)
    from its own probs by :func:`check_rounded_backward` against the plain
    backward on the same inputs and against autograd through the plain
    forward in f32; the packed pair by :func:`check_packed`; whether v2's
    ctx equals v1's bit for bit (printed: in bf16 both are short_fwd_tc.cuh's
    template).  Then the packed pair at [8, 130] (the CUDA-core backward
    route) and the bf16 v2s forward (tensor cores) at the shapes that reach
    its other forms: S = 12 (one ragged 16-key tile), 128 (the widest
    whole-row form) and 200, 1000 (the two-sweep form, with query tiles and
    a ragged last key tile), each from a generator of its own; at S = 12,
    128 and 200 also row 5's backward from those probs, rate 0 and with
    dropout (one ragged tile and the widest tensor-core form; at 200 the
    bf16 CUDA-core pair).  Times the kernels at rate 0 beside the plain
    versions, SDPA and the bound."""
    import torch
    import torch.nn.functional as F

    from msa_tpu_torch.ops import short_attention as sa
    from msa_tpu_torch.ops.dropout import quantize_dropout_rate

    rate_on = quantize_dropout_rate(ATTN_DROPOUT)
    worst = dict.fromkeys(("probs", "probs_bwd", "packed", "packed_bwd"), 0.0)
    times = {}
    for label, b, s in (("text", BATCH, TEXT_LEN), ("joint", 2 * BATCH, 2 * TEXT_LEN)):
        for dtype in (torch.bfloat16, torch.float32):
            dname = str(dtype).split(".")[1]
            atol, rtol = ATTN_TOL[dname]
            gatol = GRAD_TOL[dname][0]
            for rate in (0.0, rate_on):
                q, k, v, bias, live = attention_inputs(gen, b, s, dtype)
                dout = torch.randn(b, s, HIDDEN, device="cuda",
                                   generator=gen).to(dtype)
                seed = 4321 + s
                keep = (sa.dropout_keep_mask(seed, rate, b, HEADS, s, "cuda")
                        if rate else None)
                tag = f"{label} {dname} rate {rate:g}"

                # v2s forward: ctx, signed probs, agreement with v2
                ctx, probs, ref_ctx, err, _ = check_probs_forward(
                    tag, q, k, v, bias, live, seed, rate, keep)
                v2_ctx = sa.short_attention(q, k, v, bias, HEADS, rate, seed)
                v1_ctx = sa.short_attention_v1(q, k, v, bias, HEADS, rate, seed)
                torch.cuda.synchronize()
                v2_err = check_close(f"short_attention_probs {tag} vs v2", ctx,
                                     v2_ctx, atol, rtol, mask=live)
                v1_same = torch.equal(v1_ctx, v2_ctx)
                worst["probs"] = max(worst["probs"], err)

                # v2s backward from the kernel's own probs
                berr, bauto = check_probs_backward(tag, q, k, v, bias, live,
                                                   probs, dout, rate, keep)
                worst["probs_bwd"] = max(worst["probs_bwd"], berr)

                # v2p: v2's forward and v3's backward on the thirds
                qkv, pctx, perr, pberr, pauto = check_packed(
                    tag, q, k, v, bias, live, dout, seed, rate, keep)
                worst["packed"] = max(worst["packed"], perr)
                worst["packed_bwd"] = max(worst["packed_bwd"], pberr)
                print(f"v2s / v2p [{b},{s},{HIDDEN}] {tag}: probs forward "
                      f"max_abs_err {err:.3e} (ctx vs v2 {v2_err:.3e}), "
                      f"backward {berr:.3e} against the rounded rule, "
                      f"{bauto:.3e} against f32 autograd; packed forward "
                      f"bit-equal to v2's and backward to v3's on the thirds, "
                      f"against the plain versions {perr:.3e} / {pberr:.3e} "
                      f"(atol {atol} / {gatol}), backward {pauto:.3e} against "
                      f"f32 autograd; v2's ctx "
                      f"{'equals' if v1_same else 'differs from'} v1's bit "
                      "for bit", flush=True)
                if rate:
                    if dname == "bfloat16":  # the form the '+probs' rung runs
                        ms = cuda_ms(lambda: sa._probs_forward_kernel(
                            q, k, v, bias, HEADS, seed, rate))
                        print(f"  probs [{b},{s},{HIDDEN}] {dname} rate "
                              f"{rate:g}: kernel (tensor cores) {ms:.4f} ms",
                              flush=True)
                    continue

                # times at rate 0: kernel, plain, SDPA, bound
                it = q.element_size()
                sq, sk, sv, sm = sdpa_args(q, k, v, bias)
                lib_fwd = cuda_ms(lambda: F.scaled_dot_product_attention(
                    sq, sk, sv, attn_mask=sm))
                qq, kk, vv = (x.detach().requires_grad_() for x in (q, k, v))
                lq, lk, lv, lm = sdpa_args(qq, kk, vv, bias)
                lib_out = F.scaled_dot_product_attention(lq, lk, lv,
                                                         attn_mask=lm)
                lib_do = dout.view(b, s, HEADS, -1).transpose(1, 2)
                lib_bwd = cuda_ms(lambda: torch.autograd.grad(
                    lib_out, (qq, kk, vv), lib_do, retain_graph=True))
                qkv_g = qkv.detach().requires_grad_()
                pout = sa.short_attention_packed_plain(qkv_g, bias, HEADS)
                probs_bytes = b * HEADS * s * s * it  # the S x S it must write
                fwd_flops, io = 4 * b * s * s * HIDDEN, b * s * HIDDEN * it
                times[("probs", label, dname)] = (
                    cuda_ms(lambda: sa._probs_forward_kernel(
                        q, k, v, bias, HEADS, seed, 0.0)),
                    cuda_ms(lambda: sa.short_attention_probs_plain(
                        q, k, v, bias, HEADS)), lib_fwd,
                    bound_ms(4 * io + b * s * 4 + probs_bytes, fwd_flops, dname))
                times[("probs_bwd", label, dname)] = (
                    cuda_ms(lambda: sa.short_attention_probs_backward(
                        q, k, v, probs, dout, HEADS, 0.0)),
                    cuda_ms(lambda: sa.short_attention_probs_backward_plain(
                        q, k, v, probs, dout, HEADS, 0.0)), lib_bwd,
                    bound_ms(7 * io + probs_bytes, 2 * fwd_flops, dname))
                times[("packed", label, dname)] = (
                    cuda_ms(lambda: sa._packed_forward_kernel(
                        qkv, bias, HEADS, seed, 0, False)),
                    cuda_ms(lambda: sa.short_attention_packed_plain(
                        qkv, bias, HEADS)), lib_fwd,
                    bound_ms(4 * io + b * s * 4, fwd_flops, dname))
                # the packed backward reads qkv, o, dO and the bias and
                # writes dqkv: v3's bytes and products
                times[("packed_bwd", label, dname)] = (
                    cuda_ms(lambda: sa.short_attention_packed_backward(
                        qkv, bias, pctx, dout, HEADS, seed, 0.0)),
                    cuda_ms(lambda: torch.autograd.grad(
                        pout, qkv_g, dout, retain_graph=True)), lib_bwd,
                    bound_ms(8 * io + b * s * 4, 2.5 * fwd_flops, dname))
                tc = {"probs": dname == "bfloat16", "packed": dname == "bfloat16",
                      "probs_bwd": sa.tensor_core_backward(s, dtype),
                      "packed_bwd": sa.tensor_core_backward(s, dtype)}
                for name in ("probs", "probs_bwd", "packed", "packed_bwd"):
                    ms, plain_ms, lib_ms, bound = times[(name, label, dname)]
                    cores = "tensor cores" if tc[name] else "CUDA cores"
                    print(f"  {name} [{b},{s},{HIDDEN}] {dname}: kernel "
                          f"({cores}) {ms:.4f} ms, plain {plain_ms:.4f} ms, "
                          f"sdpa {lib_ms:.4f} ms, bound {bound[0]:.4f} ms "
                          f"({bound[1]})", flush=True)
    # generators of their own: the later phases draw the inputs they drew
    # before these shapes were added
    long_gen = torch.Generator(device="cuda").manual_seed(12)
    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype).split(".")[1]
        for rate in (0.0, rate_on):
            q, k, v, bias, live = attention_inputs(long_gen, 8, 130, dtype)
            dout = torch.randn(8, 130, HIDDEN, device="cuda",
                               generator=long_gen).to(dtype)
            seed = 4321 + 130
            keep = (sa.dropout_keep_mask(seed, rate, 8, HEADS, 130, "cuda")
                    if rate else None)
            tag = f"[8,130,{HIDDEN}] {dname} rate {rate:g}"
            _, _, perr, pberr, pauto = check_packed(
                tag, q, k, v, bias, live, dout, seed, rate, keep)
            worst["packed"] = max(worst["packed"], perr)
            worst["packed_bwd"] = max(worst["packed_bwd"], pberr)
            print(f"v2p {tag} (backward on the CUDA cores): forward bit-equal "
                  f"to v2's and backward to v3's on the thirds, against the "
                  f"plain versions {perr:.3e} / {pberr:.3e}, backward "
                  f"{pauto:.3e} against f32 autograd", flush=True)
    edge_gen = torch.Generator(device="cuda").manual_seed(5)
    dout_gen = torch.Generator(device="cuda").manual_seed(6)
    for s in (12, 128, 200, 1000):
        for rate in (0.0, rate_on):
            q, k, v, bias, live = attention_inputs(edge_gen, 4, s,
                                                   torch.bfloat16)
            seed = 4321 + s
            keep = (sa.dropout_keep_mask(seed, rate, 4, HEADS, s, "cuda")
                    if rate else None)
            tag = f"[4,{s},{HIDDEN}] bfloat16 rate {rate:g}"
            _, probs, _, err, (diff, gap) = check_probs_forward(
                tag, q, k, v, bias, live, seed, rate, keep, few_keys=True)
            worst["probs"] = max(worst["probs"], err)
            line = (f"v2s forward (tensor cores) {tag}: max_abs_err {err:.3e}; "
                    f"masked rows {diff:.3e} from f32 (the rounding rule "
                    f"{gap:.3e})")
            if s <= 200:  # the backward's one-tile, widest and CUDA-core forms
                dout = torch.randn(4, s, HIDDEN, device="cuda",
                                   generator=dout_gen).to(torch.bfloat16)
                berr, bauto = check_probs_backward(tag, q, k, v, bias, live,
                                                   probs, dout, rate, keep)
                worst["probs_bwd"] = max(worst["probs_bwd"], berr)
                cores = ("tensor cores" if sa.tensor_core_backward(
                    s, torch.bfloat16) else "CUDA cores")
                line += (f"; backward ({cores}) {berr:.3e} against the rounded "
                         f"rule, {bauto:.3e} against f32 autograd")
            print(line, flush=True)
    return worst, times


def rung_launches(policy, layers, steps, frame=False, fused=True):
    """Kernel launches of ``steps`` bf16 train steps under the remat
    ``policy`` ("none": no checkpointing): one attention per layer and
    encoder call, run again in the backward by 'full' and 'dots' (their
    regions recompute it); '+probs' runs the v2s pair and 'save_pack' the
    packed pair on the short route (all of it word-aligned; the text pass
    in frame-level mode, whose joint pass runs flash2, never re-run under a
    save_* policy).  The v2, v2p and v2s backwards take one launch at S <=
    128 in bf16."""
    import torch

    from msa_tpu_torch.ops.short_attention import backward_launches

    again = 2 if policy.split("+")[0] in ("full", "dots") else 1
    seqs = (TEXT_LEN,) if frame else (TEXT_LEN, 2 * TEXT_LEN)
    short_calls = layers * len(seqs)
    bwd = layers * sum(backward_launches(s, torch.bfloat16) for s in seqs)
    counts = {"fused_joint_embed": 2}
    if "+probs" in policy:
        counts.update(short_attention_probs=again * short_calls,
                      short_attention_probs_backward=bwd)
    elif policy == "save_pack":
        counts.update(short_attention_packed=short_calls,
                      short_attention_packed_backward=bwd)
    else:
        counts.update(short_attention=again * short_calls,
                      short_attention_backward=bwd)
    if frame:  # either flash2 backward route is two launches a layer
        counts.update(flash_attention2=again * layers,
                      flash2_bwd_fused=2 * layers if fused else 0,
                      flash2_bwd_split=0 if fused else 2 * layers)
    return expect_counts(**{k: v * steps for k, v in counts.items()})


def train_run(exp, params, batches, warmup, steps, label):
    """``warmup`` + ``steps`` train steps of ``exp`` from ``params`` (the
    same batches and seed for every caller): the losses, ms/step over the
    timed steps, peak memory, the bytes autograd keeps for the backward (by
    storage, in the warm-up steps; the bf16 weight copies included), the
    kernel launches of the timed steps and the trainer's remat policy."""
    import torch

    from msa_tpu_torch.training.trainer import Trainer

    trainer = Trainer(exp, "cuda")
    state = trainer.init_state(0, total_steps=10_000, params=params)
    losses, saved = [], {}

    def pack(t):  # what autograd keeps, by storage
        saved[t.untyped_storage().data_ptr()] = t.untyped_storage().nbytes()
        return t

    for i in range(warmup):
        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            state, m = trainer.train_step(state, batches[i % len(batches)], 1)
        losses.append(float(m["loss"]))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    metrics = []
    t0 = time.perf_counter()
    for i in range(warmup, warmup + steps):
        state, m = trainer.train_step(state, batches[i % len(batches)], 1)
        metrics.append(m)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = kernel_counts()
    peak = torch.cuda.max_memory_allocated()
    losses += [float(m["loss"]) for m in metrics]
    if not all(x == x and abs(x) < float("inf") for x in losses):
        raise AssertionError(f"{label}: losses {losses}")
    policy = trainer.remat_policy
    del state, trainer
    torch.cuda.empty_cache()
    return {"losses": losses, "ms_step": seconds * 1e3 / steps,
            "peak_bytes": peak, "saved_bytes": sum(saved.values()),
            "launches": launches, "remat_policy": policy,
            "per_step": {k: v // steps for k, v in launches.items() if v}}


def with_rung(exp, rung, **train):
    """``exp`` under the remat ``rung`` ("none": no checkpointing)."""
    return dataclasses.replace(exp, train=dataclasses.replace(
        exp.train, remat=rung != "none",
        remat_policy="auto" if rung == "none" else rung, **train))


def run_rungs(exp, params, batches, rungs, warmup, steps, label, frame=False):
    """Each remat rung from the same weights, batches and seed: its losses,
    ms/step, peak memory, the bytes autograd keeps for the backward and the
    launches (:func:`train_run`), against the first rung ("none")."""
    import torch

    from msa_tpu_torch.ops.flash2 import use_fused_backward

    layers = exp.model.bert.num_hidden_layers
    seq = TEXT_LEN + (exp.data.pair_seq_length or TEXT_LEN)
    fused = use_fused_backward(seq, HIDDEN, HEADS, torch.bfloat16)
    out = {}
    for rung in rungs:
        r = out[rung] = train_run(with_rung(exp, rung), params, batches,
                                  warmup, steps, f"{label} {rung}")
        if r["remat_policy"] != rung:
            raise AssertionError(f"{label} {rung}: resolved to "
                                 f"{r['remat_policy']}")
        want = rung_launches(rung, layers, steps, frame, fused)
        if r["launches"] != want:
            raise AssertionError(f"{label} {rung}: launches {r['launches']}, "
                                 f"want {want}")
    ref = out[rungs[0]]["losses"]
    for rung, r in out.items():
        # the forward of every rung does the same arithmetic (a region's
        # forward runs the same kernels), except v2s, whose ctx is the PV
        # product of normalised probabilities rounded to bf16 (the tensor-
        # core forward) where v2 normalises after it; later steps add the
        # backward's summation order (dots sums the post-attention
        # LayerNorm's gradient from two regions)
        first = abs(r["losses"][0] - ref[0]) / abs(ref[0])
        drift = max(abs(a - b) / abs(b) for a, b in zip(r["losses"], ref))
        r["first_rel"], r["max_rel"] = first, drift
        if ("+probs" not in rung and first != 0.0) or \
                first > PROBS_LOSS_RTOL or drift > REMAT_LOSS_RTOL:
            raise AssertionError(f"{label} {rung}: losses {r['losses']} "
                                 f"against {ref}")
        print(f"{label} remat {rung}: {r['ms_step']:.2f} ms/step, peak "
              f"{r['peak_bytes'] / 2**30:.2f} GiB, saved for the backward "
              f"{r['saved_bytes'] / 2**30:.2f} GiB, launches per step "
              f"{r['per_step']}; losses {[round(x, 5) for x in r['losses']]} "
              f"(first step rel diff {first:.2e}, max {drift:.2e} against "
              f"{rungs[0]})", flush=True)
    return out


def phase_remat_rungs():
    """bert-large bf16 at B=96, L=40 (bench.py's training shape) under each
    remat rung, from the same weights and seed."""
    exp, params, batches = train_inputs(1)
    return run_rungs(exp, params, batches, REMAT_RUNGS, REMAT_WARMUP,
                     REMAT_STEPS, f"B={BATCH}")


def phase_frame_rungs():
    """Frame level (B=16, L=40, Lp=984) under the save_* rungs: flash2's
    forward is not re-run (its residuals, ctx and lse, stay saved)."""
    import torch

    from msa_tpu_torch.data import MultimodalDataset, synthetic_split
    from msa_tpu_torch.models.weights import init_params

    exp = frame_experiment(FRAME_PAIR_LEN, None, train_batch_size=FRAME_BATCH,
                           compute_dtype="bfloat16", warmup_proportion=0.01,
                           adam_mu_dtype="bfloat16", adam_nu_dtype="bfloat16",
                           data_parallel=1)
    cfg = exp.model
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(2))
    split = synthetic_split(2 * FRAME_BATCH, TEXT_LEN, cfg.visual_dim,
                            cfg.speech_dim, vocab_size=cfg.bert.vocab_size,
                            seed=2, pair_seq_length=FRAME_PAIR_LEN)
    batches = list(MultimodalDataset(split, seed=0).epoch_batches(
        0, FRAME_BATCH, drop_last=True))
    return run_rungs(exp, params, batches, FRAME_RUNGS, 1, 2,
                     f"frame-level B={FRAME_BATCH} Lp={FRAME_PAIR_LEN}",
                     frame=True)


def phase_auto():
    """'auto' on this card: no checkpointing at B=96; at the smallest batch
    (a multiple of 32) whose activation estimate passes half the card's
    memory, JAX's ladder, whose first rung fits an 80 GB card; one step
    there."""
    import torch

    from msa_tpu_torch.data import MultimodalDataset, synthetic_split
    from msa_tpu_torch.training.trainer import Trainer

    memory = torch.cuda.get_device_properties(0).total_memory
    small = Trainer(train_experiment(BATCH), "cuda")
    if small.remat_policy != "none":
        raise AssertionError(f"auto at B={BATCH}: {small.remat_policy}")
    batch = BATCH
    while Trainer(train_experiment(batch), "cuda").activation_bytes() <= \
            0.5 * memory:
        batch += 32
    trainer = Trainer(train_experiment(batch), "cuda")
    if trainer.remat_policy != "save_attn+drop":
        raise AssertionError(f"auto at B={batch}: {trainer.remat_policy}")
    cfg = trainer.config.model
    state = trainer.init_state(0, total_steps=10_000)
    split = synthetic_split(batch, TEXT_LEN, cfg.visual_dim, cfg.speech_dim,
                            vocab_size=cfg.bert.vocab_size, seed=5)
    (b,) = list(MultimodalDataset(split, seed=0).epoch_batches(0, batch))
    state, m = trainer.train_step(state, b, 1)  # warm-up
    float(m["loss"])
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    state, m = trainer.train_step(state, b, 1)
    loss = float(m["loss"])
    seconds = time.perf_counter() - t0
    launches = kernel_counts()
    want = rung_launches("save_attn+drop", cfg.bert.num_hidden_layers, 1)
    if launches != want or not loss == loss:
        raise AssertionError(f"auto B={batch}: launches {launches}, loss {loss}")
    peak = torch.cuda.max_memory_allocated()
    print(f"auto: B={BATCH} -> none ({small.activation_bytes() / 1e9:.1f} GB "
          f"estimated); B={batch} ({trainer.activation_bytes() / 1e9:.1f} GB "
          f"> half of {memory / 1e9:.1f} GB) -> {trainer.remat_policy}: one "
          f"step {seconds * 1e3:.1f} ms, peak {peak / 2**30:.2f} GiB, loss "
          f"{loss:.4f}", flush=True)
    del state, trainer
    torch.cuda.empty_cache()
    return launches


def phase_entry_point():
    """python -m msa_tpu_torch.cli.train at bert-large on the card (through
    its ``run``, the CLI's flow): two epochs with checkpoints, then
    --resume from the first epoch's checkpoint, whose second epoch must end
    on the uninterrupted run's parameters bit for bit; then cli.sample on
    the checkpoint and cli.score on the saved predictions."""
    import numpy as np
    import torch

    from msa_tpu_torch.cli import sample, score, train
    from msa_tpu_torch.models.weights import named_leaves
    from msa_tpu_torch.training.checkpoint import (
        epoch_dir, list_epoch_checkpoints)

    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)  # the CLI logs under ./logs
        try:
            argv = ["--model", "bert-large-uncased", "--dataset", "mosi",
                    "--synthetic", str(CLI_SYNTHETIC), "--n_epochs", "2",
                    "--train_batch_size", str(BATCH), "--val_batch_size",
                    str(BATCH), "--test_batch_size", str(BATCH),
                    "--checkpoint_root", os.path.join(tmp, "model_save"),
                    "--numpy_root", os.path.join(tmp, "numpy_save"),
                    "--device", "cuda"]
            reset_counts()
            t0 = time.perf_counter()
            trainer, state, result = train.run(
                train.build_parser().parse_args(argv))
            fit_s = time.perf_counter() - t0
            launches = kernel_counts()
            steps = state.step
            run = os.path.join(tmp, "model_save",
                               sorted(os.listdir(os.path.join(tmp, "model_save")))[-1])
            epochs = list_epoch_checkpoints(run)
            if trainer.remat_policy != "none" or 0 not in epochs or \
                    len(result.history) != 2:
                raise AssertionError(f"cli.train: remat {trainer.remat_policy}"
                                     f", checkpoints {epochs}, history "
                                     f"{len(result.history)}")
            want = rung_launches("none", 24, steps)
            # the eval passes: one forward per layer and encoder call
            evals = 2 * -(-(CLI_SYNTHETIC // 8) // BATCH) * 2
            want["short_attention"] += 2 * 24 * evals
            want["fused_joint_embed"] += 2 * evals
            if launches != want:
                raise AssertionError(f"cli.train launches {launches}, want {want}")
            t0 = time.perf_counter()
            _, resumed, rresult = train.run(train.build_parser().parse_args(
                argv + ["--resume", epoch_dir(run, 0)]))
            resume_s = time.perf_counter() - t0
            got = dict(named_leaves(resumed.params))
            differ = [k for k, v in named_leaves(state.params)
                      if not torch.equal(v, got[k])]
            if differ or resumed.step != steps:
                raise AssertionError(f"resume: {len(differ)} leaves differ "
                                     f"({differ[:3]}), step {resumed.step}")
            del state, resumed, trainer
            torch.cuda.empty_cache()
            t0 = time.perf_counter()
            preds, labels = sample.main(["--checkpoint", run, "--synthetic",
                                         str(BATCH), "--batch_size",
                                         str(BATCH), "--device", "cuda"])
            sample_s = time.perf_counter() - t0
            np_root = os.path.join(tmp, "numpy_save")
            report = score.main(["--path", sorted(os.listdir(np_root))[-1],
                                 "--numpy_root", np_root])
            if preds.shape[0] != BATCH or not np.isfinite(preds).all() or \
                    not np.isfinite(report["mae"]):
                raise AssertionError(f"cli.sample / cli.score: {preds.shape}, "
                                     f"mae {report['mae']}")
        finally:
            os.chdir(cwd)
    print(f"cli.train bert-large B={BATCH}, {CLI_SYNTHETIC} synthetic samples,"
          f" 2 epochs ({steps} steps): {fit_s:.1f} s, checkpoints at epochs "
          f"{[e + 1 for e in epochs]}, best epoch {result.best_epoch + 1}; "
          f"--resume from epoch 1: {resume_s:.1f} s, epoch-2 parameters "
          f"bit-equal to the uninterrupted run's; cli.sample {sample_s:.1f} s "
          f"(ACC/MAE/F1 printed above), cli.score MAE {report['mae']:.4f}",
          flush=True)
    return launches


def phase_fused_adamw(gen):
    """The fused AdamW kernel against its plain version on bert-large's
    leaf shapes (the word embedding, an FFN weight, a bias, the regression
    head's [1] bias, an odd length and a leaf 4 bytes off 16-byte
    alignment: the scalar path), each pair of moment dtypes, with and
    without a clip scale; then its time on the word-embedding leaf and an
    FFN weight against its bound, the plain version and
    ``torch.optim.AdamW(fused=True)`` on the same leaf (with f32 moments:
    its bytes are the f32 kernel's)."""
    import torch

    from msa_tpu_torch.ops.fused_adamw import (
        fused_adamw_leaf, fused_adamw_leaf_plain)

    dts = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    hyper = (3e-4, 0.01, 1.0 - 0.9 ** 7, 1.0 - 0.999 ** 7)  # lr, wd, c1, c2
    shapes = {"word": (30592, HIDDEN), "wi": (4 * HIDDEN, HIDDEN),
              "bias": (HIDDEN,), "head": (1,), "odd": (1001,),
              "unaligned": (4097,)}
    worst, exact = 0.0, True
    for label, shape in shapes.items():
        for mu_name, mu_dt in dts.items():
            for nu_name, nu_dt in dts.items():
                def draw(scale, shift=0):
                    x = torch.randn(shape[0] + shift, *shape[1:], device="cuda",
                                    generator=gen) * scale
                    return x[shift:] if shift else x
                shift = 1 if label == "unaligned" else 0  # 4 bytes off
                p, g = draw(1.0, shift), draw(1e-2, shift)
                mu = draw(1e-3, shift).to(mu_dt)
                nu = (draw(1e-3, shift) ** 2).to(nu_dt)
                for clip in (None, torch.tensor(0.25, device="cuda")):
                    want = fused_adamw_leaf_plain(p, g, mu, nu, *hyper,
                                                  clip_scale=clip)
                    got = [p.clone(), mu.clone(), nu.clone()]
                    if shift:  # keep the clones off 16-byte alignment
                        got = [torch.empty(x.numel() + 1, dtype=x.dtype,
                                           device="cuda")[1:].copy_(x)
                               for x in got]
                    fused_adamw_leaf(got[0], g, got[1], got[2], *hyper,
                                     clip_scale=clip)
                    torch.cuda.synchronize()
                    tag = (f"fused_adamw {label} {list(shape)} mu {mu_name} "
                           f"nu {nu_name} clip {clip is not None}")
                    worst = max(worst, check_close(tag + " p", got[0], want[0],
                                                   0.0, ADAMW_P_RTOL))
                    check_close(tag + " mu", got[1], want[1], 1e-30,
                                ULP[mu_name])
                    check_close(tag + " nu", got[2], want[2], 1e-30,
                                ULP[nu_name])
                    exact &= all(torch.equal(a, b) for a, b in zip(got, want))
    print(f"fused_adamw against its plain version on {len(shapes)} leaf "
          f"shapes x 4 moment dtypes x clip on/off: p max_abs_err {worst:.3e} "
          f"(rtol {ADAMW_P_RTOL}), moments within one ulp; bit-equal "
          f"everywhere: {exact}", flush=True)

    times = {}
    for label in ("word", "wi"):
        n = shapes[label][0] * shapes[label][1]
        p = torch.randn(shapes[label], device="cuda", generator=gen)
        g = torch.randn(shapes[label], device="cuda", generator=gen) * 1e-2
        m16, n16 = (torch.zeros_like(p, dtype=torch.bfloat16) for _ in range(2))
        m32, n32 = (torch.zeros_like(p) for _ in range(2))
        ms = cuda_ms(lambda: fused_adamw_leaf(p, g, m16, n16, *hyper))
        ms32 = cuda_ms(lambda: fused_adamw_leaf(p, g, m32, n32, *hyper))
        plain_ms = cuda_ms(lambda: fused_adamw_leaf_plain(p, g, m16, n16,
                                                          *hyper))
        lib_p = torch.nn.Parameter(p.clone())
        lib_p.grad = g.clone()
        lib = torch.optim.AdamW([lib_p], lr=hyper[0], betas=(0.9, 0.999),
                                eps=1e-6, weight_decay=hyper[1], fused=True)
        lib_ms = cuda_ms(lib.step)
        bound = bound_ms(20 * n, ADAMW_OPS * n, "float32")
        bound32 = bound_ms(28 * n, ADAMW_OPS * n, "float32")
        times[label] = (ms, plain_ms, lib_ms, bound)
        print(f"fused_adamw {label} {list(shapes[label])}: kernel {ms:.4f} ms "
              f"with bf16 moments (bound {bound[0]:.4f} ms, 20 B/element, "
              f"{bound[1]}), {ms32:.4f} ms with f32 moments (bound "
              f"{bound32[0]:.4f} ms, 28 B/element); plain {plain_ms:.4f} ms; "
              f"torch.optim.AdamW(fused=True), f32 moments, {lib_ms:.4f} ms",
              flush=True)
        del lib, lib_p
    return worst, times


def check_v3_backward(tag, q, k, v, bias, live, dout, seed, rate,
                      few_keys=False):
    """One v3 backward case: the kernel (tensor cores for bf16 at S <= 128,
    else the CUDA-core pair) against its plain rule with the kernel's
    roundings (dS and the dropped p to the dtype, delta from the ctx in its
    dtype) at GRAD_TOL on live rows; fully masked rows against that rule at
    MASKED_ROW_GRAD_ATOL or, with ``few_keys``, against the rule in f32
    within twice it plus the roundings' gap (:func:`check_within`); against
    the v2 backward on the same inputs within twice GRAD_TOL plus that gap; the
    row lse it writes to scratch against the forward's (bit-equal in f32,
    where both are the CUDA cores' sums; in bf16, where the forward runs on
    the tensor cores, within V3_TC_LSE_TOL); two launches bit-equal.
    Returns (max abs err, against v2, lse difference, out, lse) for the
    timings."""
    import math

    import torch

    from msa_tpu_torch import _build
    from msa_tpu_torch.ops import short_attention as sa
    from msa_tpu_torch.ops.dropout import byte_threshold

    b, s, _ = q.shape
    dname = str(q.dtype).split(".")[1]
    atol, rtol = GRAD_TOL[dname]
    t = byte_threshold(rate)
    keep = (sa.dropout_keep_mask(seed, rate, b, HEADS, s, "cuda")
            if rate else None)
    out, lse = sa._forward_kernel(q, k, v, bias, HEADS, seed, t, True)
    v3 = sa.short_attention_v3_backward(q, k, v, bias, out, dout, HEADS, seed,
                                        rate)
    ref = sa.short_attention_v3_backward_plain(q, k, v, bias, out, dout, HEADS,
                                               rate, keep)
    # the rule in f32 throughout: no rounding of dS and p, o the plain f32
    # output (the kernel's ctx rounds p to bf16 before P V)
    wide = [x.float() for x in (q, k, v)]
    ref32 = sa.short_attention_v3_backward_plain(
        *wide, bias, sa.short_attention_plain(*wide, bias, HEADS, rate, keep),
        dout.float(), HEADS, rate, keep)
    v2 = sa.short_attention_backward(q, k, v, bias, lse, dout, HEADS, seed,
                                     rate)
    # the C entry once more, keeping its scratch: the recomputed lse
    scratch = [torch.empty_like(lse) for _ in range(2)]
    grads = [torch.empty_like(q) for _ in range(3)]
    _build.check(_build.load("short_attention", sa._SIGNATURES)
                 .msa_short_attention_v3_bwd(
                     *(x.data_ptr() for x in (q, k, v, bias, out, dout,
                                              *scratch, *grads)),
                     b, s, HIDDEN, HEADS, sa._DTYPES[q.dtype],
                     sa.softmax_scale(HIDDEN, HEADS), *sa._seed_words(seed), t,
                     sa._stream(q)), "v3 scratch check")
    torch.cuda.synchronize()
    if q.dtype == torch.bfloat16:
        lse_err = check_close(f"{tag} lse", scratch[0], lse, *V3_TC_LSE_TOL)
    else:
        if not torch.equal(scratch[0], lse):
            raise AssertionError(f"{tag}: the recomputed row lse is not "
                                 "the forward's bit for bit")
        lse_err = 0.0
    if not all(torch.equal(a, c) for a, c in zip(grads, v3)):
        raise AssertionError(f"{tag}: two launches differ")
    err = v2_err = 0.0
    for name, g3, r, g2, r32 in zip(("dq", "dk", "dv"), v3, ref, v2, ref32):
        err = max(err, check_close(f"{tag} {name}", g3, r, atol, rtol,
                                   mask=live))
        gap = (r.float() - r32.float()).abs()  # the roundings' share
        if few_keys:
            check_within(f"{tag} {name} masked row", g3, r32,
                         MASKED_ROW_GRAD_ATOL, 0.0, gap, ~live)
        else:
            check_close(f"{tag} {name} masked row", g3, r,
                        MASKED_ROW_GRAD_ATOL, 0.0, mask=~live)
        # both round dS and pd; they differ in how delta is taken
        v2_err = max(v2_err, check_within(f"{tag} {name} vs v2", g3, g2,
                                          atol, rtol, gap, live))
    return err, v2_err, lse_err, out, lse


def phase_v3_kernels(gen):
    """The v3 backward against its plain version (delta from the ctx in
    its own dtype, dS and the dropped p rounded to it), at the text and
    joint shapes, bf16 (tensor cores, one launch) and f32 (the CUDA-core
    pair), rate 0 and with dropout (the plain version given the exported
    keep mask), and against the v2 backward on the same inputs; the row lse it
    recomputes against the forward's (:func:`check_v3_backward`); times at
    rate 0 beside v2's and SDPA's backward.  Then bf16 at B = 4 and S = 8,
    12, 128 (one, a ragged and eight 16-key tiles) and 200 (the CUDA-core
    pair), from a generator of its own."""
    import torch
    import torch.nn.functional as F

    from msa_tpu_torch.ops import short_attention as sa
    from msa_tpu_torch.ops.dropout import quantize_dropout_rate

    rate_on = quantize_dropout_rate(ATTN_DROPOUT)
    worst, times = 0.0, {}
    for label, b, s in (("text", BATCH, TEXT_LEN),
                        ("joint", 2 * BATCH, 2 * TEXT_LEN)):
        for dtype in (torch.bfloat16, torch.float32):
            dname = str(dtype).split(".")[1]
            atol, rtol = GRAD_TOL[dname]
            cores = ("tensor cores" if sa.tensor_core_backward(s, dtype)
                     else "CUDA cores")
            for rate in (0.0, rate_on):
                q, k, v, bias, live = attention_inputs(gen, b, s, dtype)
                dout = torch.randn(b, s, HIDDEN, device="cuda",
                                   generator=gen).to(dtype)
                seed = 999 + s
                tag = f"short_attention_v3_backward {label} {dname} rate {rate:g}"
                err, v2_err, lse_err, out, lse = check_v3_backward(
                    tag, q, k, v, bias, live, dout, seed, rate)
                worst = max(worst, err)
                line = (f"short_attention_v3_backward [{b},{s},{HIDDEN}] {dname} "
                        f"({cores}) rate {rate:g}: max_abs_err {err:.3e} (atol "
                        f"{atol}, rtol {rtol}), against v2 {v2_err:.3e} (twice "
                        f"those and the roundings' gap), lse {lse_err:.3e} "
                        "from the forward's")
                if rate == 0.0:
                    ms = cuda_ms(lambda: sa.short_attention_v3_backward(
                        q, k, v, bias, out, dout, HEADS, seed, 0.0))
                    v2_ms = cuda_ms(lambda: sa.short_attention_backward(
                        q, k, v, bias, lse, dout, HEADS, seed, 0.0))
                    plain_ms = cuda_ms(lambda: sa.short_attention_v3_backward_plain(
                        q, k, v, bias, out, dout, HEADS))
                    qq, kk, vv = (x.detach().requires_grad_() for x in (q, k, v))
                    sq, sk, sv, sm = sdpa_args(qq, kk, vv, bias)
                    lib_out = F.scaled_dot_product_attention(sq, sk, sv,
                                                             attn_mask=sm)
                    lib_do = dout.view(b, s, HEADS, -1).transpose(1, 2)
                    lib_ms = cuda_ms(lambda: torch.autograd.grad(
                        lib_out, (qq, kk, vv), lib_do, retain_graph=True))
                    # reads q, k, v, o (the ctx: an input of this function)
                    # and dO, the [B, S] f32 bias; writes dq, dk, dv.  The
                    # products: scores, dP, dV, dQ, dK (the CUDA-core
                    # pair's second score pass is the design's own)
                    nbytes = 8 * q.element_size() * b * s * HIDDEN + b * s * 4
                    bound = bound_ms(nbytes, 10 * b * s * s * HIDDEN, dname)
                    times[(label, dname)] = (ms, plain_ms, lib_ms, bound)
                    line += (f"; kernel {ms:.4f} ms (v2 {v2_ms:.4f} ms), "
                             f"plain {plain_ms:.4f} ms, sdpa bwd {lib_ms:.4f} "
                             f"ms, bound {bound[0]:.4f} ms ({bound[1]}, "
                             f"{bound[0] / ms:.1%} of it reached)")
                print(line, flush=True)
    edge_gen = torch.Generator(device="cuda").manual_seed(10)  # see phase_probs_packed
    for s in (8, 12, 128, 200):
        cores = ("tensor cores" if sa.tensor_core_backward(s, torch.bfloat16)
                 else "CUDA cores")
        for rate in (0.0, rate_on):
            q, k, v, bias, live = attention_inputs(edge_gen, 4, s,
                                                   torch.bfloat16)
            dout = torch.randn(4, s, HIDDEN, device="cuda",
                               generator=edge_gen).to(torch.bfloat16)
            tag = f"short_attention_v3_backward [4,{s},{HIDDEN}] bfloat16 rate {rate:g}"
            err, v2_err, lse_err, *_ = check_v3_backward(
                tag, q, k, v, bias, live, dout, 999 + s, rate, few_keys=True)
            worst = max(worst, err)
            print(f"{tag} ({cores}): max_abs_err {err:.3e}, against v2 "
                  f"{v2_err:.3e}, lse {lse_err:.3e} from the forward's; "
                  "masked rows within twice MASKED_ROW_GRAD_ATOL and the "
                  "roundings' gap of the f32 rule", flush=True)
    return worst, times


def split_heads(x):
    """[B, S, H] -> the head-split [B, heads, S, d] layout (a copy)."""
    b, s, h = x.shape
    return x.view(b, s, HEADS, h // HEADS).transpose(1, 2).contiguous()


def merge_heads(x):
    b, n, s, d = x.shape
    return x.transpose(1, 2).reshape(b, s, n * d)


def phase_flash_attention(gen):
    """The head-split flash attention (row 13) against its plain version:
    the forward and its natural-log lse at the frame-level joint shape
    [32, 16, 1024, 64] (bf16), long S (4096) and an odd S (1000, padded
    keys), bf16 and f32; the backward pair, run through autograd, against
    its plain version on the same inputs (JAX's rule: p from the lse, delta
    = rowsum(dO o) with o the forward's output in its dtype), and against
    autograd through the plain forward in f32 within twice the tolerance
    plus the gap that o's rounding makes in the plain rule (as v3's); with
    and without dropout (the plain versions given keep_mask_plain: forward
    and backward draw that mask), and against flash2 in natural layout at
    the same seed (same mask) within the same allowance; a second seed gives
    another mask.  Times beside the bound, the plain version and SDPA on [B,
    heads, S, d] with the additive mask."""
    import torch
    import torch.nn.functional as F

    from msa_tpu_torch.ops import attention as A
    from msa_tpu_torch.ops.dropout import (
        byte_threshold, keep_mask_plain, quantize_dropout_rate)
    from msa_tpu_torch.ops.flash2 import flash_attention2

    rate_on = quantize_dropout_rate(ATTN_DROPOUT)
    s_frame = TEXT_LEN + FRAME_PAIR_LEN
    # (label, B, S, dtype, rate, timed)
    cases = [("frame", 2 * FRAME_BATCH, s_frame, torch.bfloat16, 0.0, True),
             ("frame", 2, s_frame, torch.float32, 0.0, False),
             ("s1000", 4, 1000, torch.bfloat16, 0.0, False),
             ("s1000", 4, 1000, torch.float32, 0.0, False),
             ("s4096", 2, 4096, torch.bfloat16, 0.0, False),
             ("frame", 2, s_frame, torch.bfloat16, rate_on, False),
             ("frame", 2, s_frame, torch.float32, rate_on, False)]
    worst = {"fwd": 0.0, "bwd": 0.0}
    times = {}
    for label, b, s, dtype, rate, timed in cases:
        dname = str(dtype).split(".")[1]
        x, y, z, bias, live = attention_inputs(gen, b, s, dtype)
        q, k, v = (split_heads(t) for t in (x, y, z))
        dout = torch.randn(q.shape, device="cuda", generator=gen).to(dtype)
        seed = 2718 + s
        keep = (keep_mask_plain(seed, rate, b, HEADS, s, device="cuda")
                if rate else None)
        out, lse = A._forward_kernel(q, k, v, bias, seed, byte_threshold(rate),
                                     train=True)
        # the backward pair through autograd, from its own training forward
        xq, xk, xv = (t.detach().requires_grad_() for t in (q, k, v))
        out_ag = A.flash_attention(xq, xk, xv, bias, rate, seed)
        grads = torch.autograd.grad(out_ag, (xq, xk, xv), dout)
        qq, kk, vv = (t.detach().float().requires_grad_() for t in (q, k, v))
        ref, ref_lse = A.flash_attention_plain(qq, kk, vv, bias, rate, keep,
                                               with_lse=True)
        auto = torch.autograd.grad(ref, (qq, kk, vv), dout.float())
        # the plain rule in f32 math, pd and dS rounded to the dtype before
        # their products as the kernels (and JAX's) round them
        refs = A.flash_attention_backward_plain(q, k, v, bias, out, lse, dout,
                                                rate, keep)
        # what o's rounding to the dtype moves in the plain rule (0 in f32)
        o_gap = [(a.float() - c.float()).abs() for a, c in zip(
            refs, A.flash_attention_backward_plain(
                q, k, v, bias, ref.detach(), lse, dout, rate, keep))]
        torch.cuda.synchronize()
        if not torch.equal(out_ag, out):
            raise AssertionError(f"flash_attention {label}: the autograd "
                                 "forward differs from the kernel's")
        tag = (f"flash_attention {label} [{b},{HEADS},{s},{HIDDEN // HEADS}] "
               f"{dname} rate {rate:g}")
        atol, rtol = ATTN_TOL[dname]
        err = check_close(tag, out, ref, atol, rtol, mask=live)
        check_close(tag + " masked row", out, ref, MASKED_ROW_ATOL, 0.0,
                    mask=~live)
        lse_err = check_close(tag + " lse", lse, ref_lse, FLASH_LSE_ATOL,
                              FLASH_LSE_RTOL, mask=live)
        check_close(tag + " lse masked row", lse, ref_lse, MASKED_ROW_ATOL, 0.0,
                    mask=~live)
        gatol, grtol = GRAD_TOL[dname]
        gerr = auto_err = 0.0
        for name, g, r, a, gap in zip(("dq", "dk", "dv"), grads, refs, auto,
                                      o_gap):
            gerr = max(gerr, check_close(f"{tag} {name}", g, r, gatol, grtol,
                                         mask=live))
            check_close(f"{tag} {name} masked row", g, r, MASKED_ROW_GRAD_ATOL,
                        0.0, mask=~live)
            auto_err = max(auto_err, check_within(
                f"{tag} {name} against autograd", g, a, gatol, grtol, gap, live))
        worst["fwd"] = max(worst["fwd"], err)
        worst["bwd"] = max(worst["bwd"], gerr)
        line = (f"{tag}: max_abs_err {err:.3e} (atol {atol}, rtol {rtol}), lse "
                f"{lse_err:.3e} (atol {FLASH_LSE_ATOL}, rtol {FLASH_LSE_RTOL}), "
                f"gradients {gerr:.3e} against the plain rule (atol {gatol}, "
                f"rtol {grtol}), {auto_err:.3e} against autograd through the "
                f"plain forward (o's rounding gap up to "
                f"{max(float(x[live].max()) for x in o_gap):.3e})")
        if rate:
            # flash2 in natural layout at the same seed draws the same mask:
            # the same output, and gradients within the tolerance (flash2's
            # delta reads its f32 output, this pair's its output in dtype)
            xx, yy, zz = (t.detach().requires_grad_() for t in (x, y, z))
            o2 = flash_attention2(xx, yy, zz, bias, HEADS, rate, seed)
            g2 = torch.autograd.grad(o2, (xx, yy, zz), merge_heads(dout))
            o3 = A.flash_attention(q, k, v, bias, rate, seed + 1)
            torch.cuda.synchronize()
            f2_err = check_close(tag + " against flash2", merge_heads(out), o2,
                                 atol, rtol, mask=live)
            for name, g, r, gap in zip(("dq", "dk", "dv"), grads, g2, o_gap):
                f2_err = max(f2_err, check_within(
                    f"{tag} {name} against flash2", g, split_heads(r), gatol,
                    grtol, gap, live))
            if torch.allclose(out.float(), o3.float(), atol=atol, rtol=rtol):
                raise AssertionError(f"{tag}: the mask is not a function of "
                                     "the seed")
            line += (f"; against flash2 at the same seed {f2_err:.3e}, the "
                     "next seed differs")
        if timed:
            sq, sk, sv = (t.detach().requires_grad_() for t in (q, k, v))
            sm = bias[:, None, None, :].to(dtype)
            ms = cuda_ms(lambda: A.flash_attention(q, k, v, bias))
            plain_ms = cuda_ms(lambda: A.flash_attention_plain(q, k, v, bias),
                               iters=5)
            lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, attn_mask=sm))
            split_ms = cuda_ms(lambda: [split_heads(t) for t in (x, y, z)])
            merge_ms = cuda_ms(lambda: merge_heads(out))
            bwd_ms = cuda_ms(lambda: A.flash_attention_backward(
                q, k, v, bias, out, lse, dout, seed, 0.0), iters=10)
            pq, pk, pv = (t.detach().requires_grad_() for t in (q, k, v))
            po = A.flash_attention_plain(pq, pk, pv, bias)
            bwd_plain_ms = cuda_ms(lambda: torch.autograd.grad(
                po, (pq, pk, pv), dout, retain_graph=True), iters=5)
            lo = F.scaled_dot_product_attention(sq, sk, sv, attn_mask=sm)
            bwd_lib_ms = cuda_ms(lambda: torch.autograd.grad(
                lo, (sq, sk, sv), dout, retain_graph=True), iters=10)
            flops = 4 * b * s * s * HIDDEN
            nbytes = 4 * b * s * HIDDEN * q.element_size() + b * s * 4
            bound = bound_ms(nbytes, flops, dname)
            # the backward reads q, k, v, o and dO, the bias and the row lse
            # (o and lse are inputs of JAX's _flash_dq_kernel / _dkv_kernel),
            # writes dq, dk, dv; products: scores, dP, dV, dQ, dK
            bwd_bytes = (8 * q.element_size() * b * s * HIDDEN + b * s * 4
                         + b * HEADS * s * 4)
            bwd_bound = bound_ms(bwd_bytes, 10 * b * s * s * HIDDEN, dname)
            times["fwd"] = (ms, plain_ms, lib_ms, bound)
            times["bwd"] = (bwd_ms, bwd_plain_ms, bwd_lib_ms, bwd_bound)
            line += (f"; forward {ms:.4f} ms ({flops / ms / 1e9:.1f} TFLOP/s), "
                     f"plain {plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms, bound "
                     f"{bound[0]:.4f} ms ({bound[1]}); the route's head split "
                     f"of q, k, v {split_ms:.4f} ms and merge {merge_ms:.4f} "
                     f"ms; backward pair {bwd_ms:.4f} ms "
                     f"({2.5 * flops / bwd_ms / 1e9:.1f} TFLOP/s), plain "
                     f"{bwd_plain_ms:.4f} ms, sdpa bwd {bwd_lib_ms:.4f} ms, "
                     f"bound {bwd_bound[0]:.4f} ms ({bwd_bound[1]})")
        print(line, flush=True)
    return worst, times


def saved_bytes(fn):
    """Bytes (by storage) that autograd keeps for the backward of ``fn()``."""
    import torch

    saved = {}

    def pack(t):
        saved[t.untyped_storage().data_ptr()] = t.untyped_storage().nbytes()
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        out = fn()
    return out, sum(saved.values())


def phase_short_v1(gen):
    """The v1 short attention (row 7) against its plain version at the text
    and joint shapes ([96, 40, 1024], [192, 80, 1024], 16 heads), bf16 and
    f32: the forward; the backward, run through autograd, against its plain
    version (JAX's _bwd_kernel rule: dS and the dropped p rounded to the
    dtype before their products), and against autograd through the plain
    forward in f32 and the v2 kernels (which round neither) within twice
    the tolerance plus the gap those roundings make in the plain rule, at
    rate 0 and with dropout (the plain versions given keep_mask_plain; v2
    at the same seed draws the same mask; in bf16 v2's gradients are v1's
    bit for bit, one instantiation of short_bwd_tc.cuh); the bytes autograd
    keeps for the backward against v2's (v1 keeps its inputs only, as v2
    does where its backward is the tensor-core launch; elsewhere v2 also
    keeps the row lse).  Times beside the
    bound, the plain version and SDPA (bf16 on the tensor cores, f32 on the
    CUDA cores).  Then the bf16 forward at S = 8 (one ragged 16-key tile)
    and 128 (eight tiles, the widest) against the plain version and v2,
    and the bf16 backward at S = 8, 12 and 128 (:func:`check_v1_backward`),
    each from a generator of its own."""
    import torch
    import torch.nn.functional as F

    from msa_tpu_torch.ops import short_attention as sa
    from msa_tpu_torch.ops.dropout import keep_mask_plain, quantize_dropout_rate

    rate_on = quantize_dropout_rate(ATTN_DROPOUT)
    worst = {"fwd": 0.0, "bwd": 0.0}
    times = {}
    for label, b, s in (("text", BATCH, TEXT_LEN),
                        ("joint", 2 * BATCH, 2 * TEXT_LEN)):
        for dtype in (torch.bfloat16, torch.float32):
            dname = str(dtype).split(".")[1]
            atol, rtol = ATTN_TOL[dname]
            gatol, grtol = GRAD_TOL[dname]
            for rate in (0.0, rate_on):
                q, k, v, bias, live = attention_inputs(gen, b, s, dtype)
                dout = torch.randn(b, s, HIDDEN, device="cuda",
                                   generator=gen).to(dtype)
                seed = 31 + s
                keep = (keep_mask_plain(seed, rate, b, HEADS, s, device="cuda")
                        if rate else None)
                runs = {}
                for name, entry in (("v1", sa.short_attention_v1),
                                    ("v2", sa.short_attention)):
                    qq, kk, vv = (x.detach().requires_grad_() for x in (q, k, v))
                    out, kept = saved_bytes(lambda: entry(
                        qq, kk, vv, bias, HEADS, rate, seed if rate else None))
                    runs[name] = (out, kept, *torch.autograd.grad(
                        out, (qq, kk, vv), dout))
                qq, kk, vv = (x.detach().float().requires_grad_()
                              for x in (q, k, v))
                ref = sa.short_attention_plain(qq, kk, vv, bias, HEADS, rate, keep)
                auto = torch.autograd.grad(ref, (qq, kk, vv), dout.float())
                refs = sa.short_attention_v1_backward_plain(
                    q, k, v, bias, dout, HEADS, rate, keep)
                torch.cuda.synchronize()
                tag = f"short_attention_v1 {label} [{b},{s},{HIDDEN}] {dname} rate {rate:g}"
                out, kept, *grads = runs["v1"]
                err = check_close(tag, out, ref, atol, rtol, mask=live)
                check_close(tag + " masked row", out, ref, MASKED_ROW_ATOL, 0.0,
                            mask=~live)
                gerr = auto_err = 0.0
                v2_out, v2_kept, *v2_grads = runs["v2"]
                v2_err = check_close(tag + " against v2", out, v2_out, atol,
                                     rtol, mask=live)
                for name, g, r, a, g2 in zip(("dq", "dk", "dv"), grads, refs,
                                             auto, v2_grads):
                    gerr = max(gerr, check_close(f"{tag} {name}", g, r, gatol,
                                                 grtol, mask=live))
                    check_close(f"{tag} {name} masked row", g, r,
                                MASKED_ROW_GRAD_ATOL, 0.0, mask=~live)
                    gap = (r.float() - a).abs()  # the operands' rounding
                    auto_err = max(auto_err, check_within(
                        f"{tag} {name} against autograd", g, a, gatol, grtol,
                        gap, live))
                    v2_err = max(v2_err, check_within(
                        f"{tag} {name} against v2", g, g2, gatol, grtol, gap,
                        live))
                inputs = 3 * q.numel() * q.element_size() + bias.numel() * 4
                v2_inputs = inputs + (0 if sa.tensor_core_backward(s, dtype)
                                      else b * HEADS * s * 4)
                if kept != inputs or v2_kept != v2_inputs:
                    raise AssertionError(f"{tag}: keeps {kept} bytes for the "
                                         f"backward (its inputs: {inputs}; v2 "
                                         f"{v2_kept}, want {v2_inputs})")
                if dtype == torch.bfloat16 and not all(
                        torch.equal(g, g2) for g, g2 in zip(grads, v2_grads)):
                    raise AssertionError(f"{tag}: v2's bf16 gradients are not "
                                         "v1's bit for bit")
                worst["fwd"] = max(worst["fwd"], err)
                worst["bwd"] = max(worst["bwd"], gerr)
                line = (f"{tag}: max_abs_err {err:.3e} (atol {atol}, rtol "
                        f"{rtol}), gradients {gerr:.3e} against the plain rule "
                        f"(atol {gatol}, rtol {grtol}), {auto_err:.3e} against "
                        f"autograd (twice that plus the rounding gap); against "
                        f"v2 at the same seed {v2_err:.3e}"
                        f"{' (bit-equal gradients)' if dtype == torch.bfloat16 else ''}; "
                        f"kept for the backward {kept / 2**20:.2f} MiB (its "
                        f"inputs) against v2's {v2_kept / 2**20:.2f} MiB")
                if rate == 0.0:
                    ms = cuda_ms(lambda: sa.short_attention_v1(
                        q, k, v, bias, HEADS))
                    v2_ms = cuda_ms(lambda: sa.short_attention(
                        q, k, v, bias, HEADS))
                    plain_ms = cuda_ms(lambda: sa.short_attention_plain(
                        q, k, v, bias, HEADS))
                    sq, sk, sv, sm = sdpa_args(q, k, v, bias)
                    lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
                        sq, sk, sv, attn_mask=sm))
                    bwd_ms = cuda_ms(lambda: sa.short_attention_v1_backward(
                        q, k, v, bias, dout, HEADS))
                    pq, pk, pv = (x.detach().requires_grad_() for x in (q, k, v))
                    po = sa.short_attention_plain(pq, pk, pv, bias, HEADS)
                    bwd_plain_ms = cuda_ms(lambda: torch.autograd.grad(
                        po, (pq, pk, pv), dout, retain_graph=True))
                    sq, sk, sv, sm = sdpa_args(pq, pk, pv, bias)
                    lo = F.scaled_dot_product_attention(sq, sk, sv, attn_mask=sm)
                    lib_do = dout.view(b, s, HEADS, -1).transpose(1, 2)
                    bwd_lib_ms = cuda_ms(lambda: torch.autograd.grad(
                        lo, (pq, pk, pv), lib_do, retain_graph=True))
                    itemsize = q.element_size()
                    bound = bound_ms(4 * b * s * HIDDEN * itemsize + b * s * 4,
                                     4 * b * s * s * HIDDEN, dname)
                    # reads q, k, v, dO and the bias, writes dq, dk, dv (v1
                    # takes nothing else); products: scores, dP, dV, dQ, dK
                    bwd_bound = bound_ms(7 * b * s * HIDDEN * itemsize + b * s * 4,
                                         10 * b * s * s * HIDDEN, dname)
                    times[("fwd", label, dname)] = (ms, plain_ms, lib_ms, bound)
                    times[("bwd", label, dname)] = (bwd_ms, bwd_plain_ms,
                                                    bwd_lib_ms, bwd_bound)
                    cores = ("tensor cores" if dname == "bfloat16"
                             else "CUDA cores")
                    line += (f"; forward ({cores}) {ms:.4f} ms (v2 {v2_ms:.4f} "
                             f"ms), plain {plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms, bound "
                             f"{bound[0]:.4f} ms ({bound[1]}); backward "
                             f"({cores}) {bwd_ms:.4f} ms, plain "
                             f"{bwd_plain_ms:.4f} ms, sdpa bwd {bwd_lib_ms:.4f} "
                             f"ms, bound {bwd_bound[0]:.4f} ms ({bwd_bound[1]}, "
                             f"{bwd_bound[0] / bwd_ms:.1%} of it reached)")
                print(line, flush=True)
    atol, rtol = ATTN_TOL["bfloat16"]
    edge_gen = torch.Generator(device="cuda").manual_seed(6)  # see phase_probs_packed
    for s in (8, 128):
        for rate in (0.0, rate_on):
            q, k, v, bias, live = attention_inputs(edge_gen, 4, s,
                                                   torch.bfloat16)
            seed = 31 + s
            keep = (keep_mask_plain(seed, rate, 4, HEADS, s, device="cuda")
                    if rate else None)
            out = sa.short_attention_v1(q, k, v, bias, HEADS, rate,
                                        seed if rate else None)
            v2_out = sa.short_attention(q, k, v, bias, HEADS, rate,
                                        seed if rate else None)
            ref = sa.short_attention_plain(q.float(), k.float(), v.float(),
                                           bias, HEADS, rate, keep)
            torch.cuda.synchronize()
            tag = f"short_attention_v1 [4,{s},{HIDDEN}] bfloat16 rate {rate:g}"
            err = check_close(tag, out, ref, atol, rtol, mask=live)
            diff, gap = check_masked_rows(tag, out, q, k, v, bias, live, rate,
                                          keep)
            v2_err = check_close(tag + " against v2", out, v2_out, atol, rtol,
                                 mask=live)
            worst["fwd"] = max(worst["fwd"], err)
            print(f"{tag} (tensor cores): max_abs_err {err:.3e}, against v2 "
                  f"{v2_err:.3e}; masked rows {diff:.3e} from f32 (the "
                  f"rounding rule {gap:.3e})", flush=True)
    bwd_gen = torch.Generator(device="cuda").manual_seed(9)
    for s in (8, 12, 128):
        for rate in (0.0, rate_on):
            q, k, v, bias, live = attention_inputs(bwd_gen, 4, s,
                                                   torch.bfloat16)
            dout = torch.randn(4, s, HIDDEN, device="cuda",
                               generator=bwd_gen).to(torch.bfloat16)
            worst["bwd"] = max(worst["bwd"], check_v1_backward(
                q, k, v, bias, live, dout, 31 + s, rate))
    return worst, times


def check_v1_backward(q, k, v, bias, live, dout, seed, rate):
    """The bf16 v1 backward kernel (tensor cores) at a few keys: against
    its plain rule (dS and the dropped p rounded to bf16) at GRAD_TOL on
    live rows; against autograd through the plain forward in f32 (fully
    masked rows at MASKED_ROW_GRAD_ATOL) within twice the tolerance plus
    the gap the roundings make in the plain rule (:func:`check_within`);
    v2's backward at the same seed (the same instantiation of
    short_bwd_tc.cuh) bit for bit.  Returns the max abs err."""
    import torch

    from msa_tpu_torch.ops import short_attention as sa
    from msa_tpu_torch.ops.dropout import keep_mask_plain

    b, s, _ = q.shape
    atol, rtol = GRAD_TOL["bfloat16"]
    keep = (keep_mask_plain(seed, rate, b, HEADS, s, device="cuda")
            if rate else None)
    grads = sa.short_attention_v1_backward(q, k, v, bias, dout, HEADS, seed,
                                           rate)
    qq, kk, vv = (x.detach().requires_grad_() for x in (q, k, v))
    v2_out = sa.short_attention(qq, kk, vv, bias, HEADS, rate,
                                seed if rate else None)
    v2 = torch.autograd.grad(v2_out, (qq, kk, vv), dout)
    qq, kk, vv = (x.detach().float().requires_grad_() for x in (q, k, v))
    ref = sa.short_attention_plain(qq, kk, vv, bias, HEADS, rate, keep)
    auto = torch.autograd.grad(ref, (qq, kk, vv), dout.float())
    refs = sa.short_attention_v1_backward_plain(q, k, v, bias, dout, HEADS,
                                                rate, keep)
    torch.cuda.synchronize()
    tag = f"short_attention_v1_backward [{b},{s},{HIDDEN}] bfloat16 rate {rate:g}"
    if not all(torch.equal(g, g2) for g, g2 in zip(grads, v2)):
        raise AssertionError(f"{tag}: v2's gradients are not v1's bit for bit")
    err = auto_err = masked = 0.0
    for name, g, r, a in zip(("dq", "dk", "dv"), grads, refs, auto):
        err = max(err, check_close(f"{tag} {name}", g, r, atol, rtol,
                                   mask=live))
        gap = (r.float() - a).abs()  # the operands' rounding
        masked = max(masked, check_within(f"{tag} {name} masked row", g, a,
                                          MASKED_ROW_GRAD_ATOL, 0.0, gap,
                                          ~live))
        auto_err = max(auto_err, check_within(f"{tag} {name} against autograd",
                                              g, a, atol, rtol, gap, live))
    print(f"{tag} (tensor cores): max_abs_err {err:.3e} against the plain "
          f"rule, {auto_err:.3e} against autograd (twice the tolerance plus "
          f"the rounding gap); v2's gradients bit-equal; masked rows "
          f"{masked:.3e} from f32", flush=True)
    return err


def head_split_counts(want, layers, steps):
    """Launches ``want`` (the joint pass on flash2) with the joint pass on
    the head-split kernels instead: its forwards as flash_attention and a
    backward pair (dq, dk/dv) per layer and step."""
    want = dict(want, flash_attention=want["flash_attention2"],
                flash_attention_backward=2 * layers * steps)
    want["flash_attention2"] = want["flash2_bwd_fused"] = 0
    want["flash2_bwd_split"] = 0
    return want


def phase_frame_flash():
    """The frame-level path (B=16, L=40, Lp=984: joint pass [32, 1024]) at
    full width with ``ops.attention.USE_FLASH2 = False``, the joint pass on
    the head-split kernels between head transposes: serving against the
    default flash2 Predictor on the same weights (24 head-split forwards a
    batch); 1 warm-up + 3 train steps with the default dropouts against
    flash2 from the same weights, batches and seeds (24 forwards and 24 + 24
    backward launches a step); one step under save_ctx (``recompute=``); and
    the f32 frame-level train steps, card against CPU.  The switch is
    restored whatever happens."""
    import numpy as np
    import torch

    from msa_tpu_torch.data import MultimodalDataset, synthetic_split
    from msa_tpu_torch.inference import Predictor
    from msa_tpu_torch.models.weights import init_params
    from msa_tpu_torch.ops import attention as A

    exp = frame_experiment(FRAME_PAIR_LEN, None, train_batch_size=FRAME_BATCH,
                           compute_dtype="bfloat16", warmup_proportion=0.01,
                           adam_mu_dtype="bfloat16", adam_nu_dtype="bfloat16",
                           data_parallel=1)
    cfg = exp.model
    layers = cfg.bert.num_hidden_layers
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(4))
    serve = synthetic_split(FRAME_SERVE, TEXT_LEN, cfg.visual_dim,
                            cfg.speech_dim, vocab_size=cfg.bert.vocab_size,
                            seed=6, pair_seq_length=FRAME_PAIR_LEN)
    train = synthetic_split(2 * FRAME_BATCH, TEXT_LEN, cfg.visual_dim,
                            cfg.speech_dim, vocab_size=cfg.bert.vocab_size,
                            seed=7, pair_seq_length=FRAME_PAIR_LEN)
    batches = list(MultimodalDataset(train, seed=0).epoch_batches(
        0, FRAME_BATCH, drop_last=True))
    n_batches = -(-FRAME_SERVE // FRAME_BATCH)
    out = {}
    try:
        preds, rates = {}, {}
        for flash2 in (True, False):
            A.USE_FLASH2 = flash2
            pred = Predictor(exp, params, FRAME_BATCH, "cuda")
            pred.predict_split(serve)  # warm
            reset_counts()
            t0 = time.perf_counter()
            preds[flash2] = pred.predict_split(serve)
            rates[flash2] = FRAME_SERVE / (time.perf_counter() - t0)
            launches = kernel_counts()
            del pred
            if flash2:
                continue
            want = expect_counts(short_attention=layers * n_batches,
                                 flash_attention=layers * n_batches,
                                 fused_joint_embed=2 * n_batches)
            if launches != want:
                raise AssertionError(f"frame_flash serving launches "
                                     f"{launches}, want {want}")
            out["serving"] = launches
        gap = float(np.abs(preds[False] - preds[True]).max())
        if not np.isfinite(preds[False]).all() or gap > FRAME_FLASH_PRED_ATOL:
            raise AssertionError(f"frame_flash serving: max |diff| to flash2's "
                                 f"predictions {gap:.3e} > {FRAME_FLASH_PRED_ATOL}")
        print(f"frame_flash serving bf16 bert-large B={FRAME_BATCH} "
              f"Lp={FRAME_PAIR_LEN}, USE_FLASH2=False: {rates[False]:.2f} "
              f"samples/s against flash2's {rates[True]:.2f}; launches per batch "
              f"{({k: v // n_batches for k, v in out['serving'].items() if v})}; "
              f"max |diff| to flash2's predictions {gap:.3e} (atol "
              f"{FRAME_FLASH_PRED_ATOL}; bit-equal: {gap == 0.0})", flush=True)

        runs = {}
        for flash2, rung, warmup, steps in ((True, "none", 1, 3),
                                            (False, "none", 1, 3),
                                            (False, "save_ctx", 1, 1)):
            A.USE_FLASH2 = flash2
            label = f"frame_flash {rung} USE_FLASH2={flash2}"
            r = runs[(flash2, rung)] = train_run(
                with_rung(exp, rung), params, batches, warmup, steps, label)
            want = rung_launches(rung, layers, steps, frame=True)
            if not flash2:
                want = head_split_counts(want, layers, steps)
            if r["remat_policy"] != rung or r["launches"] != want:
                raise AssertionError(f"{label}: remat {r['remat_policy']}, "
                                     f"launches {r['launches']}, want {want}")
        base = runs[(True, "none")]
        for key in ((False, "none"), (False, "save_ctx")):
            r = runs[key]
            # the same forward kernels and masks: the warm-up step's loss is
            # bit-equal; later steps carry the backward's roundings (bf16 o
            # in delta here, the f32 output in flash2's)
            drift = max(abs(a - b) / abs(b)
                        for a, b in zip(r["losses"], base["losses"]))
            if r["losses"][0] != base["losses"][0] or \
                    drift > REMAT_LOSS_RTOL:
                raise AssertionError(f"frame_flash {key}: losses "
                                     f"{r['losses']} against flash2's "
                                     f"{base['losses']}")
            r["max_rel"] = drift
        hs = runs[(False, "none")]
        for key, r in runs.items():
            print(f"frame_flash training bf16 bert-large B={FRAME_BATCH} "
                  f"Lp={FRAME_PAIR_LEN} remat {key[1]} USE_FLASH2={key[0]}: "
                  f"{r['ms_step']:.2f} ms/step, "
                  f"{FRAME_BATCH * 1e3 / r['ms_step']:.2f} samples/s, peak "
                  f"{r['peak_bytes'] / 2**30:.2f} GiB, kept for the backward "
                  f"{r['saved_bytes'] / 2**30:.2f} GiB; launches per step "
                  f"{r['per_step']}; losses {[round(x, 5) for x in r['losses']]}"
                  + ("" if key[0] else f" (max rel {r['max_rel']:.2e} against "
                     f"flash2, bound {REMAT_LOSS_RTOL})"), flush=True)
        out["training"] = hs["launches"]
        out["save_ctx"] = runs[(False, "save_ctx")]["launches"]
        out["runs"] = runs
        out["serving_rates"] = rates

        A.USE_FLASH2 = False
        reset_counts()
        phase_f32_train(pair_len=FRAME_PAIR_LEN, batch_size=4)
        f32 = kernel_counts()
        if not f32["flash_attention"] or not f32["flash_attention_backward"] \
                or f32["flash_attention2"]:
            raise AssertionError(f"frame_flash f32 train: launches {f32}")
    finally:
        A.USE_FLASH2 = True
    return out


def train_inputs(seed):
    """bench.py's training configuration at B=96, bert-large weights from
    ``seed`` and two batches of a synthetic split (the rung phases')."""
    import torch

    from msa_tpu_torch.data import MultimodalDataset, synthetic_split
    from msa_tpu_torch.models.weights import init_params

    exp = train_experiment(BATCH)
    params = init_params(exp.model,
                         torch.Generator(device="cuda").manual_seed(seed))
    cfg = exp.model
    split = synthetic_split(4 * BATCH, TEXT_LEN, cfg.visual_dim, cfg.speech_dim,
                            vocab_size=cfg.bert.vocab_size, seed=0)
    batches = list(MultimodalDataset(split, seed=0).epoch_batches(
        0, BATCH, drop_last=True))
    return exp, params, batches


def compare_runs(label, base, other, name):
    """``other``'s losses against ``base``'s: the first step bit-equal, the
    rest within PR6_LOSS_RTOL; returns the largest relative gap."""
    first, rest = base["losses"][0], other["losses"][0]
    drift = max(abs(a - b) / abs(b)
                for a, b in zip(other["losses"], base["losses"]))
    if first != rest or drift > PR6_LOSS_RTOL:
        raise AssertionError(f"{label} {name}: losses {other['losses']} "
                             f"against {base['losses']}")
    return drift


def phase_fused_train(exp, params, batches):
    """bert-large bf16 B=96 with fused_optimizer=True against the foreach
    AdamW, from the same weights and seed, with no checkpointing and under
    'full' (where the optimizer's f32 temporaries set the peak): ms/step,
    one fused AdamW launch per leaf and step, peak memory and losses."""
    from msa_tpu_torch.models.weights import named_leaves

    layers = exp.model.bert.num_hidden_layers
    leaves = sum(1 for _ in named_leaves(params))
    out = {}
    for rung in ("none", "full"):
        for fused in (False, True):
            label = f"B={BATCH} {rung} fused_optimizer={fused}"
            r = out[(rung, fused)] = train_run(
                with_rung(exp, rung, fused_optimizer=fused), params, batches,
                PR6_WARMUP, PR6_STEPS, label)
            want = rung_launches(rung, layers, PR6_STEPS)
            want["fused_adamw_leaf"] = leaves * PR6_STEPS if fused else 0
            if r["launches"] != want:
                raise AssertionError(f"{label}: launches {r['launches']}, "
                                     f"want {want}")
        base, fused = out[(rung, False)], out[(rung, True)]
        drift = compare_runs(f"B={BATCH} {rung}", base, fused,
                             "fused_optimizer")
        print(f"fused_optimizer B={BATCH} remat {rung}: {fused['ms_step']:.2f} "
              f"ms/step against {base['ms_step']:.2f} (foreach AdamW), peak "
              f"{fused['peak_bytes'] / 2**30:.2f} GiB against "
              f"{base['peak_bytes'] / 2**30:.2f}; fused_adamw launches per "
              f"step {fused['per_step']['fused_adamw_leaf']} ({leaves} leaves); "
              f"losses {[round(x, 5) for x in fused['losses']]} against "
              f"{[round(x, 5) for x in base['losses']]} (max rel {drift:.2e}, "
              f"bound {PR6_LOSS_RTOL})", flush=True)
    return out


def phase_v3_train(exp, params, batches):
    """bert-large bf16 B=96 with the short-attention backward switched to
    v3 (``ops.short_attention.USE_V3_BWD``) against v2, from the same
    weights and seed, with no checkpointing and under save_attn: ms/step,
    peak memory, the bytes kept for the backward, launches and losses.
    The switch is restored whatever happens."""
    from msa_tpu_torch.ops import short_attention as sa

    layers = exp.model.bert.num_hidden_layers
    out = {}
    try:
        for rung in ("none", "save_attn"):
            for v3 in (False, True):
                sa.USE_V3_BWD = v3
                label = f"B={BATCH} {rung} v3={v3}"
                r = out[(rung, v3)] = train_run(
                    with_rung(exp, rung), params, batches, PR6_WARMUP,
                    PR6_STEPS, label)
                want = rung_launches(rung, layers, PR6_STEPS)
                if v3:  # the v3 backward in place of v2's, as many launches
                    want["short_attention_v3_backward"] = \
                        want["short_attention_backward"]
                    want["short_attention_backward"] = 0
                if r["launches"] != want:
                    raise AssertionError(f"{label}: launches {r['launches']}, "
                                         f"want {want}")
    finally:
        sa.USE_V3_BWD = False
    for rung in ("none", "save_attn"):
        base, v3 = out[(rung, False)], out[(rung, True)]
        drift = compare_runs(f"B={BATCH} {rung}", base, v3, "v3 backward")
        print(f"v3 backward B={BATCH} remat {rung}: {v3['ms_step']:.2f} ms/step "
              f"against {base['ms_step']:.2f} (v2), peak "
              f"{v3['peak_bytes'] / 2**30:.2f} GiB against "
              f"{base['peak_bytes'] / 2**30:.2f}, kept for the backward "
              f"{v3['saved_bytes'] / 2**30:.2f} GiB against "
              f"{base['saved_bytes'] / 2**30:.2f} "
              f"({(v3['saved_bytes'] - base['saved_bytes']) / 1e9:+.2f} GB); "
              f"launches per step {v3['per_step']}; losses "
              f"{[round(x, 5) for x in v3['losses']]} (max rel {drift:.2e} "
              f"against v2, bound {PR6_LOSS_RTOL})", flush=True)
    return out


def phase_fuse_qkv(exp, params, split, preds, outs, calib):
    """int8 and int8_static serving at B=96 with fuse_qkv=True (one [*, 3H]
    int8 projection per layer feeding the packed attention kernel) against
    the split projections' Predictors of the int8 phase (``outs``: their
    predictions and bf16's): launches per batch, samples/s in turns, the
    predictions' agreement, and f32 card runs against the CPU."""
    import numpy as np

    from msa_tpu_torch.inference import Predictor

    layers = exp.model.bert.num_hidden_layers
    n_batches = -(-N_SERVE // BATCH)
    launches, rates = {}, {}
    for mode in ("int8", "int8_static"):
        fused = Predictor(exp, params, BATCH, "cuda", quantize=mode,
                          calibration=calib if mode == "int8_static" else None,
                          fuse_qkv=True)
        fused.predict_split(split)  # warm
        reset_counts()
        out = fused.predict_split(split)
        launches[mode] = kernel_counts()
        want = serving_launches(layers, n_batches, mode, fuse_qkv=True)
        if launches[mode] != want:
            raise AssertionError(f"{mode} fuse_qkv serving launches "
                                 f"{launches[mode]}, want {want}")
        gap = float(np.abs(out - outs[mode]).max())
        bound = (0.0 if mode == "int8" else
                 2 * float(np.abs(outs[mode] - outs["bf16"]).max()))
        if out.shape != (N_SERVE,) or not np.isfinite(out).all() or gap > bound:
            raise AssertionError(f"{mode} fuse_qkv predictions: shape "
                                 f"{out.shape}, max |diff| to the split "
                                 f"projections {gap:.3e} > {bound}")
        rates[mode] = {"split": [], "fused": []}
        for kind in ("split", "fused", "fused", "split"):
            pred = preds[mode] if kind == "split" else fused
            t0 = time.perf_counter()
            pred.predict_split(split)  # ends in a device-to-host copy
            rates[mode][kind].append(N_SERVE / (time.perf_counter() - t0))
        print(f"serving {mode} fuse_qkv bert-large B={BATCH} L={TEXT_LEN}: "
              f"samples/s {[round(r, 2) for r in rates[mode]['fused']]} "
              f"against split {[round(r, 2) for r in rates[mode]['split']]} "
              f"(same process, order split fused fused split); launches per "
              f"batch {({k: v // n_batches for k, v in launches[mode].items() if v})}; "
              f"max |diff| to the split projections {gap:.3e} (bound "
              f"{bound:.3e}), correlation "
              f"{float(np.corrcoef(out, outs[mode])[0, 1]):.6f}", flush=True)
        del fused
    errs = int8_f32_gaps(exp, params, split, calib, fuse_qkv=True)
    print(f"f32 int8 / int8_static fuse_qkv card vs CPU plain "
          f"({INT8_F32_LAYERS} layers at full width, 2 samples): max |diff| "
          f"{errs['int8']:.3e} / {errs['int8_static']:.3e} (atol "
          f"{INT8_F32_PRED_ATOL})", flush=True)
    return launches, rates


def train_experiment(batch):
    """bench.py's training configuration at ``batch``: MOSI widths, L=40,
    bf16, the default dropouts (hidden 0.1, attention 0.1, joint 0.5), MLM
    on, bf16 Adam moments."""
    from msa_tpu_torch.configs import build_experiment

    return build_experiment("mosi", "bert-large-uncased", num_labels=1,
                            train_batch_size=batch, compute_dtype="bfloat16",
                            warmup_proportion=0.01, adam_mu_dtype="bfloat16",
                            adam_nu_dtype="bfloat16", data_parallel=1)


# The sources of the bf16 tensor-core kernels (the v1, v2 and v2p forwards
# of short_fwd_tc.cuh and the two-sweep v2 form, the v2s forwards, the v1,
# v2, v2p, v3 and v2s backwards of short_bwd_tc.cuh, each at head dim 32
# and 64) and the dynamic shared memory their
# launchers ask for, by kernel: the padded rows of Q, K, V and the bias; the
# two-sweep forms at 128 rows: the Q tile (v2s also its stage), the K and V
# rings and their bias; the backward: Q, K, V and dO rows, the pd and dS
# tiles and the bias.
TC_SOURCES = ("short_attention", "short_attention_v1")
# whole-row forwards and backwards up to this many 16-key tiles must not
# spill (the backward holds two score rows a warp, the forward one)
TC_NO_SPILL_TILES = 5
TC_KERNEL = re.compile(
    r"(short_fwd_tc_kernel|short_bwd_tc_kernel|short_attention_fwd_tc_long_kernel|"
    r"short_attention_probs_fwd_tc(?:_long)?_kernel)I((?:L[ib]\d+E)+)E")


def tc_dynamic_smem(kernel):
    args = [int(a) for a in re.findall(r"L[ib](\d+)E", TC_KERNEL.search(
        kernel).group(2))]
    row = 2 * (args[0] + 8)  # bytes of a staged head row at head dim args[0]
    if "tc_long" in kernel:
        q_rows = 2 * 128 if "probs" in kernel else 128
        return (q_rows + 4 * 64) * row + 2 * 64 * 4
    rows = 16 * args[1]
    if "short_bwd_tc" in kernel:
        return 4 * rows * row + 2 * rows * (rows + 8) * 2 + rows * 4
    return 3 * rows * row + rows * 4


def report_tc_resources(usage):
    """Print ptxas's registers, static shared memory and spills for each
    instantiation of the tensor-core kernels, as kernel<head dim, 16-key
    tiles, dropout, training form> (kernel<head dim, dropout[, training
    form]> for the two-sweep forms; v2s's kernel<head dim, 16-key tiles,
    dropout>; the backward kernel<head dim, 16-key tiles, dropout, rule:
    0 recompute, 1 from o, 2 from the probs>), and fail if a whole-row
    forward or backward of at most TC_NO_SPILL_TILES tiles spills or has a
    stack frame."""
    tc = [u for u in usage if TC_KERNEL.search(u["kernel"])]
    for name in ("short_fwd_tc_kernel", "short_bwd_tc_kernel",
                 "short_attention_fwd_tc_long_kernel"):
        if not any(name in u["kernel"] for u in tc):
            raise AssertionError(f"ptxas reported no {name}")
    for u in tc:
        m = TC_KERNEL.search(u["kernel"])
        args = re.findall(r"L[ib](\d+)E", m.group(2))
        name = f"{m.group(1)}<{', '.join(args)}>"
        print(f"ptxas {u['source']} {name}: {u['registers']} registers, "
              f"{u['static_smem']} B static + {tc_dynamic_smem(u['kernel'])} B "
              f"dynamic smem, stack {u['stack']} B, spill stores "
              f"{u['spill_stores']} B, loads {u['spill_loads']} B", flush=True)
        if (m.group(1) in ("short_fwd_tc_kernel", "short_bwd_tc_kernel")
                and int(args[1]) <= TC_NO_SPILL_TILES
                and (u["stack"] or u["spill_stores"] or u["spill_loads"])):
            raise AssertionError(f"ptxas: {name} in {u['source']} spills or "
                                 "keeps a stack frame")


# The redesigned kernels of rows 2 and 11 (the joint embed's
# tiles, flash2's bf16 fused sweep and its delta pre-pass): none may spill
# or keep a stack frame.  Their threads a CTA, the fused sweep's dynamic
# shared memory by head dim (csrc/flash_kernels.cuh::fused_tc_smem_bytes)
# and the H100's registers and shared memory per SM, for the CTAs an SM
# holds.
REDESIGNED = re.compile(r"(fused_joint_embed_kernel|flash2_bwd_fused_kernel|"
                        r"flash2_bwd_prep_kernel)I")
REDESIGNED_THREADS = {"fused_joint_embed_kernel": 256,
                      "flash2_bwd_fused_kernel": 128, "flash2_bwd_prep_kernel": 256}
FUSED_TC_SMEM = {64: 93184, 32: 60416}
SM_REGISTERS, SM_SMEM, SM_SMEM_PER_CTA = 65536, 233472, 1024


def template_args(kernel, match):
    """The template arguments of a mangled kernel name after ``match`` (a
    match ending at its 'I'): bf16 / f32 types and integer or bool values."""
    tail, args = kernel[match.end():], []
    while tail and tail[0] != "E":
        if tail.startswith("13__nv_bfloat16"):
            args.append("bf16")
            tail = tail[15:]
        elif tail[0] == "f":
            args.append("f32")
            tail = tail[1:]
        else:
            m = re.match(r"L[ib](\d+)E", tail)
            args.append(m.group(1))
            tail = tail[m.end():]
    return args


def report_redesigned(usage):
    """Print ptxas's registers and spills for each instantiation of the
    redesigned kernels, with the CTAs an SM holds by registers (and, for
    the fused sweep, by shared memory); fail on a spill or a stack frame."""
    found = [u for u in usage if REDESIGNED.search(u["kernel"])]
    for name in ("fused_joint_embed_kernel", "flash2_bwd_fused_kernel",
                 "flash2_bwd_prep_kernel"):
        if not any(name in u["kernel"] for u in found):
            raise AssertionError(f"ptxas reported no {name}")
    for u in found:
        m = REDESIGNED.search(u["kernel"])
        name, args = m.group(1), template_args(u["kernel"], m)
        threads = REDESIGNED_THREADS[name]
        by_regs = SM_REGISTERS // (max(u["registers"], 1) * threads)
        extra = ""
        if name == "flash2_bwd_fused_kernel":
            smem = FUSED_TC_SMEM[int(args[0])]
            extra = (f", {smem} B dynamic smem: "
                     f"{SM_SMEM // (smem + SM_SMEM_PER_CTA)} CTAs an SM by it")
        print(f"ptxas {u['source']} {name}<{', '.join(args)}>: "
              f"{u['registers']} registers "
              f"({by_regs} CTAs of {threads} threads an SM by them), "
              f"{u['static_smem']} B static smem{extra}, stack {u['stack']} "
              f"B, spill stores {u['spill_stores']} B, loads "
              f"{u['spill_loads']} B", flush=True)
        if u["stack"] or u["spill_stores"] or u["spill_loads"]:
            raise AssertionError(f"ptxas: {name} in {u['source']} spills or "
                                 "keeps a stack frame")


# The warpgroup (wgmma) kernels of rows 10, 12 and 13 (flash_kernels.cuh:
# flash_fwd_wg_kernel, flash_bwd_dq_wg_kernel, flash_bwd_dkv_wg_kernel, each
# <head dim, head split, dropout[, training form]>): none may spill, keep a
# stack frame or have its wgmma products serialised by ptxas.
WGMMA = re.compile(r"(flash_fwd_wg_kernel|flash_bwd_dq_wg_kernel|"
                   r"flash_bwd_dkv_wg_kernel)I")


def wgmma_launch(name, args):
    """(threads, dynamic shared memory) of a warpgroup kernel's launch, as
    its launcher sets them (the tile choices above flash_kernels.cuh's
    kernels and wg_*_smem_bytes: the alignment slack, the swizzled tiles of
    kD bf16 rows, the bias / lse / delta rows)."""
    row = 2 * int(args[0])
    if name == "flash_fwd_wg_kernel":  # 128 query rows, two 64-key stages
        return 256, 1024 + (128 + 4 * 64) * row + 2 * 64 * 4
    if name == "flash_bwd_dq_wg_kernel":  # 128 query rows, 64 under dropout
        rows = 64 if args[2] == "1" else 128
        return 2 * rows, 1024 + (2 * rows + 4 * 64) * row + 2 * 64 * 4 + rows * 4
    return 128, 1024 + (2 * 64 + 4 * 64) * row + 4 * 64 * 4  # 64 keys


def report_wgmma(usage):
    """Print ptxas's registers, shared memory, spills and wgmma notices for
    each instantiation of the warpgroup kernels, with the CTAs an SM holds
    by registers and by shared memory; fail on a spill, a stack frame or a
    serialisation notice."""
    found = [u for u in usage if WGMMA.search(u["kernel"])]
    for name in ("flash_fwd_wg_kernel", "flash_bwd_dq_wg_kernel",
                 "flash_bwd_dkv_wg_kernel"):
        for source in ("flash2.cu", "flash_attention.cu"):
            if not any(name in u["kernel"] and u["source"] == source
                       for u in found):
                raise AssertionError(f"ptxas reported no {name} in {source}")
    for u in found:
        m = WGMMA.search(u["kernel"])
        name, args = m.group(1), template_args(u["kernel"], m)
        threads, smem = wgmma_launch(name, args)
        by_regs = SM_REGISTERS // (max(u["registers"], 1) * threads)
        by_smem = SM_SMEM // (smem + u["static_smem"] + SM_SMEM_PER_CTA)
        print(f"ptxas {u['source']} {name}<{', '.join(args)}>: "
              f"{u['registers']} registers ({by_regs} CTAs of {threads} "
              f"threads an SM by them), {u['static_smem']} B static + {smem} "
              f"B dynamic smem ({by_smem} CTAs an SM by it), stack "
              f"{u['stack']} B, spill stores {u['spill_stores']} B, loads "
              f"{u['spill_loads']} B, wgmma serialised: "
              f"{'; '.join(u['serialized']) or 'no'}", flush=True)
        if u["stack"] or u["spill_stores"] or u["spill_loads"]:
            raise AssertionError(f"ptxas: {name} in {u['source']} spills or "
                                 "keeps a stack frame")
        if u["serialized"]:
            raise AssertionError(f"ptxas serialised the wgmma products of "
                                 f"{name} in {u['source']}")


def kernel_entry(name, source, replaces, launches, err, timing, by_path):
    ms, plain_ms, lib_ms, (bound, bound_by) = timing
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches, "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
            "bound_by": bound_by, "library_ms": lib_ms,
            "launches_by_path": by_path}


def main() -> int:
    import torch

    if len(sys.argv) not in (1, 3) or sys.argv[1:2] not in ([], ["--flash-times"]):
        print("usage: chip_smoke.py [--flash-times ROOT]", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    if len(sys.argv) == 3:  # the flash backwards of the tree at ROOT only
        sys.path.insert(0, os.path.abspath(sys.argv[2]))
        time_flash_backwards()
        return 0
    from msa_tpu_torch import _build
    from msa_tpu_torch.configs import build_experiment
    from msa_tpu_torch.models.weights import init_params

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(f"card: {smi}", flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}", flush=True)

    t0 = time.perf_counter()
    nvcc_s = {}
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        usage = pool.submit(_build.resource_usage, TC_SOURCES + (
            "flash2", "flash_attention", "fused_joint_embed"))
        for lib in _build.build_all(seconds=nvcc_s).values():
            print(f"built {os.path.relpath(lib)}", flush=True)
        print(f"kernel build: {time.perf_counter() - t0:.1f} s; nvcc wall s "
              f"per source (all started together, beside the ptxas report's "
              f"{len(TC_SOURCES)}): "
              f"{ {k: round(v, 1) for k, v in nvcc_s.items()} }", flush=True)
        report_tc_resources(usage.result())
        report_redesigned(usage.result())
        report_wgmma(usage.result())

    gen = torch.Generator(device="cuda").manual_seed(0)
    attn_err, attn_times = phase_attention(gen)
    bwd_err, bwd_times = phase_attention_backward(gen)
    drop = phase_dropout(gen)
    embed_err, embed_times = phase_joint_embed(gen)
    lnq_err, lnq_times = phase_ln_quant(gen)

    f2_err, f2_times = phase_flash2(gen)
    f2_bwd_err, f2_bwd_times = phase_flash2_backward(gen)
    pp_err, pp_times = phase_probs_packed(gen)
    adamw_err, adamw_times = phase_fused_adamw(gen)
    v3_err, v3_times = phase_v3_kernels(gen)
    fa_err, fa_times = phase_flash_attention(gen)
    v1_err, v1_times = phase_short_v1(gen)
    phase_wgmma_flash()
    probe_flash2_dq()
    time_flash_backwards()
    phase_head_dim_32()
    phase_tiny_preset()

    exp = build_experiment("mosi", "bert-large-uncased", num_labels=1)
    params = init_params(exp.model, torch.Generator(device="cuda").manual_seed(0))
    pred, split, serve_launches = phase_serving(exp, params)
    phase_service(pred)
    int8_launches, _, int8_preds, int8_outs, calib = phase_int8_serving(
        exp, params, pred, split)
    del pred
    fuse_launches, _ = phase_fuse_qkv(exp, params, split, int8_preds,
                                      int8_outs, calib)
    del int8_preds
    frame_serve_launches, _ = phase_frame_serving(params)
    phase_service_cli(exp, params)
    del params
    torch.cuda.empty_cache()
    train_launches, _ = phase_training()
    torch.cuda.empty_cache()
    frame_train_launches, _ = phase_frame_training(
        FRAME_PAIR_LEN, FRAME_BATCH, None, FRAME_WARMUP, FRAME_STEPS,
        "frame-level")
    torch.cuda.empty_cache()
    long_launches, _ = phase_frame_training(
        LONG_PAIR_LEN, LONG_BATCH, LONG_LAYERS, 1, 1, "long-S")
    torch.cuda.empty_cache()
    rungs = phase_remat_rungs()
    pr6_inputs = train_inputs(3)
    fused_runs = phase_fused_train(*pr6_inputs)
    v3_runs = phase_v3_train(*pr6_inputs)
    del pr6_inputs
    torch.cuda.empty_cache()
    frame_rungs = phase_frame_rungs()
    torch.cuda.empty_cache()
    frame_flash = phase_frame_flash()
    torch.cuda.empty_cache()
    auto_launches = phase_auto()
    cli_launches = phase_entry_point()
    phase_f32_train()
    phase_f32_train(pair_len=FRAME_PAIR_LEN, batch_size=4)

    def paths(name):
        return {"serving": serve_launches[name], "training": train_launches[name],
                "serving_int8": int8_launches["int8"][name],
                "serving_int8_static": int8_launches["int8_static"][name],
                "frame_serving": frame_serve_launches[name],
                "frame_training": frame_train_launches[name],
                "long_training": long_launches[name],
                "remat_rungs": sum(r["launches"][name] for r in rungs.values()),
                "frame_remat_rungs": sum(r["launches"][name]
                                         for r in frame_rungs.values()),
                "auto_big_batch": auto_launches[name],
                "cli_train": cli_launches[name],
                "serving_int8_fuse_qkv": fuse_launches["int8"][name],
                "serving_int8_static_fuse_qkv":
                    fuse_launches["int8_static"][name],
                "fused_optimizer_train": sum(r["launches"][name]
                                             for r in fused_runs.values()),
                "v3_train": sum(r["launches"][name] for r in v3_runs.values()),
                "frame_flash_serving": frame_flash["serving"][name],
                "frame_flash_training": frame_flash["training"][name],
                "frame_flash_save_ctx": frame_flash["save_ctx"][name]}

    def rung(policy, name):  # launches per step under that rung
        return rungs[policy]["per_step"].get(name, 0)

    joint = ("joint", "bfloat16")
    kernels = [
        kernel_entry("short_attention", "msa_tpu_torch/csrc/short_fwd_tc.cuh",
                     "msa_tpu/ops/short_attention.py:303",
                     train_launches["short_attention"], attn_err,
                     attn_times[joint], paths("short_attention")),
        kernel_entry("short_attention_backward",
                     "msa_tpu_torch/csrc/short_bwd_tc.cuh",
                     "msa_tpu/ops/short_attention.py:336",
                     train_launches["short_attention_backward"], bwd_err,
                     bwd_times[joint + (0.0,)],
                     paths("short_attention_backward")),
        kernel_entry("dropout_keep_mask", "msa_tpu_torch/csrc/short_attention.cu",
                     "msa_tpu/ops/short_attention.py:97",
                     train_launches["dropout_keep_mask"],
                     float(drop["mismatches"]),
                     (drop["ms"], drop["plain_ms"], None, drop["bound"]),
                     paths("dropout_keep_mask")),
        kernel_entry("fused_joint_embed", "msa_tpu_torch/csrc/fused_joint_embed.cu",
                     "msa_tpu/ops/fused_joint_embed.py:24",
                     train_launches["fused_joint_embed"], embed_err,
                     embed_times[(47, TEXT_LEN, "bfloat16")],
                     paths("fused_joint_embed")),
        kernel_entry("ln_quant_static", "msa_tpu_torch/csrc/ln_quant.cu",
                     "msa_tpu/ops/ln_quant.py:36",
                     int8_launches["int8_static"]["ln_quant_static"],
                     lnq_err["static"],
                     lnq_times[("static",) + joint], paths("ln_quant_static")),
        kernel_entry("ln_quant_dynamic", "msa_tpu_torch/csrc/ln_quant.cu",
                     "msa_tpu/ops/ln_quant.py:51",
                     int8_launches["int8"]["ln_quant_dynamic"],
                     lnq_err["dynamic"],
                     lnq_times[("dynamic",) + joint], paths("ln_quant_dynamic")),
        kernel_entry("flash2_fwd", "msa_tpu_torch/csrc/flash2.cu",
                     "msa_tpu/ops/flash2.py:121",
                     frame_train_launches["flash_attention2"], f2_err,
                     f2_times[("frame", "bfloat16")], paths("flash_attention2")),
        kernel_entry("flash2_bwd_fused", "msa_tpu_torch/csrc/flash2.cu",
                     "msa_tpu/ops/flash2.py:355",
                     frame_train_launches["flash2_bwd_fused"], f2_bwd_err[True],
                     f2_bwd_times[("frame", "bfloat16", True)],
                     paths("flash2_bwd_fused")),
        kernel_entry("flash2_bwd_split", "msa_tpu_torch/csrc/flash2.cu",
                     "msa_tpu/ops/flash2.py:224",
                     long_launches["flash2_bwd_split"], f2_bwd_err[False],
                     f2_bwd_times[("s4096", "bfloat16", False)],
                     paths("flash2_bwd_split")),
        kernel_entry("short_attention_probs",
                     "msa_tpu_torch/csrc/short_attention.cu",
                     "msa_tpu/ops/short_attention.py:858",
                     rung("save_attn+drop+probs", "short_attention_probs"),
                     pp_err["probs"], pp_times[("probs",) + joint],
                     paths("short_attention_probs")),
        kernel_entry("short_attention_probs_backward",
                     "msa_tpu_torch/csrc/short_bwd_tc.cuh",
                     "msa_tpu/ops/short_attention.py:895",
                     rung("save_attn+drop+probs",
                          "short_attention_probs_backward"),
                     pp_err["probs_bwd"], pp_times[("probs_bwd",) + joint],
                     paths("short_attention_probs_backward")),
        kernel_entry("short_attention_packed",
                     "msa_tpu_torch/csrc/short_fwd_tc.cuh",
                     "msa_tpu/ops/short_attention.py:471",
                     rung("save_pack", "short_attention_packed"),
                     pp_err["packed"], pp_times[("packed",) + joint],
                     paths("short_attention_packed")),
        kernel_entry("short_attention_packed_backward",
                     "msa_tpu_torch/csrc/short_bwd_tc.cuh",
                     "msa_tpu/ops/short_attention.py:505",
                     rung("save_pack", "short_attention_packed_backward"),
                     pp_err["packed_bwd"], pp_times[("packed_bwd",) + joint],
                     paths("short_attention_packed_backward")),
        kernel_entry("fused_adamw", "msa_tpu_torch/csrc/fused_adamw.cu",
                     "msa_tpu/ops/fused_adamw.py:41",
                     fused_runs[("none", True)]["launches"]["fused_adamw_leaf"],
                     adamw_err, adamw_times["word"], paths("fused_adamw_leaf")),
        kernel_entry("short_attention_v3_backward",
                     "msa_tpu_torch/csrc/short_bwd_tc.cuh",
                     "msa_tpu/ops/short_attention.py:392",
                     v3_runs[("none", True)]["launches"][
                         "short_attention_v3_backward"],
                     v3_err, v3_times[joint],
                     paths("short_attention_v3_backward")),
        kernel_entry("flash_attention_fwd",
                     "msa_tpu_torch/csrc/flash_attention.cu",
                     "msa_tpu/ops/attention.py:117",
                     frame_flash["training"]["flash_attention"], fa_err["fwd"],
                     fa_times["fwd"], paths("flash_attention")),
        kernel_entry("flash_attention_bwd",
                     "msa_tpu_torch/csrc/flash_attention.cu",
                     "msa_tpu/ops/attention.py:171",
                     frame_flash["training"]["flash_attention_backward"],
                     fa_err["bwd"], fa_times["bwd"],
                     paths("flash_attention_backward")),
        kernel_entry("short_attention_v1_fwd",
                     "msa_tpu_torch/csrc/short_fwd_tc.cuh",
                     "msa_tpu/ops/short_attention.py:139",
                     train_launches["short_attention_v1"], v1_err["fwd"],
                     v1_times[("fwd",) + joint], paths("short_attention_v1")),
        kernel_entry("short_attention_v1_bwd",
                     "msa_tpu_torch/csrc/short_bwd_tc.cuh",
                     "msa_tpu/ops/short_attention.py:177",
                     train_launches["short_attention_v1_backward"],
                     v1_err["bwd"], v1_times[("bwd",) + joint],
                     paths("short_attention_v1_backward")),
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
