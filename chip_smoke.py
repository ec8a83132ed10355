#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (msa_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --flash-times ROOT
    python3 chip_smoke.py --short-times ROOT
    python3 chip_smoke.py --cli-worker OUT {rate0,preset} -- CLI_TRAIN_FLAGS...
    python3 chip_smoke.py --predict-worker OUT RANK PORT

Run from the root of a checkout.  ``--flash-times ROOT`` only times the
flash kernels and the joint embed, flash at head dims 128, 256 and 192 and
the frame-level step at 4 heads of 256, on flash2 and under ``USE_FLASH2 =
False`` (:func:`time_flash_path`) of the
checkout at ROOT (this one's or another's, whose kernels build into
ROOT/build/), so two trees are timed by the same code in one run;
``--short-times ROOT`` likewise times the bf16 short backwards above 128
keys and the Lp = 500 frame-level train step (:func:`time_short_path`).
The two worker
modes are the ranks phase 6g starts (:func:`cli_worker`,
:func:`predict_worker`).  With no
argument, in order, and stopping at the first failure (no phase catches
its own), the script:

  1. requires CUDA and prints the card's name and power limit;
  2. builds the CUDA kernels from msa_tpu_torch/csrc with nvcc (sm_90a),
     one nvcc per library (each attention source once a head dim of 16,
     32, 64 and 128), all started together, prints each library's nvcc
     wall time and what ptxas reported in the build (registers, static
     shared memory, spills) for the bf16 tensor-core kernels of the short
     attention (the v1, v2, v2p and v2s forwards, the v1, v2, v2p, v3 and
     v2s backwards and the tiled backward pair above 128 keys, at every
     head dim; none may spill at 32 or 64), for the joint embed's tiles
     and flash2's bf16 fused backward and its pre-pass, none of which may
     spill, and for the warpgroup (wgmma) kernels of rows 10, 12 and 13
     (the bf16 forward, the split backward's dq and dk/dv launches, in
     flash2.cu and flash_attention.cu) and of row 11 at head dim 256
     (flash2's fused backward), none of which may have its wgmma products
     serialised or spill at 32, 64 or 256;
  3. holds each kernel against its plain PyTorch version on the card, in
     bf16 and f32, and times both (and, where one exists, the PyTorch
     library call that computes the same function):
     * the attention forward at the serving shapes (and a few more), its
       serving and training forms (ctx, the row lse) and the packed forward
       (v2p) at rate 0 and with dropout, each call's form (bf16: tensor
       cores, whole row up to 128 keys, two sweeps above); bf16 also at S =
       12, 128, 130, 200 and 1000;
     * the attention backward (bf16 on the tensor cores: one launch at S
       <= 128, the tiled pair above; f32 the CUDA-core pair) through
       autograd of the entry, against its plain
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
       also at [8, 130] (the tiled backward); the bf16 v2s forward
       (tensor cores) also at S = 12, 128 and, in its two-sweep form, 200
       and 1000, and its backward from those probs at S = 12, 128 (one
       launch) and 200 (the tiled pair);
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
     * the bf16 v2, v3, v2s and v2p backwards above 128 keys (the tiled
       pair of csrc/short_bwd_tiled.cuh) at S = 129, 200, 1023 and the
       frame-level joint shape [32, 540], each with a fully masked row, at
       rate 0 and 26/256, against their rounded rules
       (``phase_tiled_backward``), every launch on the tiled route; then
       timed at [8, 130], [4, 512], [4, 768] and [32, 540] beside their
       plain rules, SDPA's backward and the bound
       (:func:`time_short_backwards`);
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
  3c'. every kernel phase of 3c again at head dims 26 (H = 312, 12
     heads: the instantiation at 32, heads zero-padded) and 128 (H = 1024,
     8 heads), v2's and flash2's forwards and backwards also at 8 and 16,
     ln_quant's generic form at H = 32, 100, 312 and 4096 and the joint
     embed at H = 2560, D = 1100 (``phase_head_dims``); v1 above 128 keys
     (S = 200, 540, 1000) runs in each v1 phase;
  3d. JAX's ``tiny`` preset (head dim 32) through ``cli.train --model
     tiny``, the bf16, int8 and int8_static ``Predictor`` and the
     frame-level path (serving, 1 + 2 train steps on flash2 at d = 32);
     then TinyBERT-4L-312D's widths (head dim 26; ``phase_tinybert``):
     1 + 3 bf16 train steps at B = 96, L = 40, the bf16, int8 and
     int8_static ``Predictor``, one frame-level serving batch and train
     step at Lp = 984; and ``cli.train --model bert-base-uncased`` for two
     steps, its weights through the bf16 and int8 ``Predictor``
     (``phase_bert_base_preset``);
  3e. the JAX package's sharded orbax checkpoint of a two-process run
     (``tests/data/orbax_two_process``) through the port's reader
     (``phase_orbax``): the zstd decoder built with the host compiler,
     every leaf's SHA-256 against JAX's restore, the decode rate (on the
     fixture's chunks and on a large leaf's chunk, ``tests/data/zstd_chunk``),
     then one
     train step resumed as ``cli.train --resume`` does and a
     ``Predictor.from_checkpoint`` pass on the card, both bit-equal to the
     same from the port's msgpack re-save (head dim 32: the short attention
     forward and backward and the joint embed launch in each);
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
     checking the launches per step, losses and moved parameters; then at
     Lp = 500 (joint pass [32, 540] on the short kernels; ``phase_frame_short``):
     1 + 3 steps with the default dropouts (ms/step, samples/s, peak,
     launches a step by route: 24 tiled v2 pairs), one step each with the
     v2s, v2p and v3 backwards ('+probs', 'save_pack', ``USE_V3_BWD``;
     their tiled pairs) against its losses, and 4 layers at attention
     dropout 0 against the plain attention's losses;
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
  6f. ``fuse_text_pass`` at bert-large B=96 (one [3B, 80] encoder call):
     1 + 5 bf16 train steps a run at dropout 0, in turns unfused, fused,
     fused, unfused from the same weights (losses within GRAD_TOL, two
     leaves' updates within UPDATE_RTOL of the unfused updates, ms/step,
     launches per step), and bf16 serving fused against unfused
     (ATTN_TOL, samples/s);
  6g. data parallelism in two processes on the one card over gloo, each
     rank launched with ``cli.train --dp 2 --coordinator ... --process_id
     r`` (this script's ``--cli-worker`` mode calls the CLI's ``run`` and
     reports the process's kernel launches, final-parameter digest and
     all-reduce time): bert-large global B=96 at dropout 0 against a
     one-process epoch (losses, and two leaves' updates), the tiny preset with ``--resume`` bit-equal to the
     uninterrupted run, and the dp=2 ``Predictor`` (``--predict-worker``)
     against dp=1;
  6h. tensor and sequence parallelism in two processes on the one card
     over gloo, each rank ``cli.train --mp 2 --coordinator ...`` (this
     script's ``--tp-worker`` runs the CLI's ``run`` without and with
     sequence parallelism, then the other parts on the same model group):
     bert-large global B=96 at dropout 0, 1 + 2 steps, against a
     one-process epoch (losses, two leaves' updates, launches by route at
     8 local heads, peak memory, the model group's collective ms a step);
     one step at the preset's dropout (bit-equal replicated leaves on both
     ranks); frame level at Lp=984 (flash2 at 8 local heads) against one
     process; the bf16 and int8 Predictors against mp=1; and the tiny
     preset at dp=2 x mp=2 in four processes with ``--resume`` bit-equal;
  7. runs two f32 train steps of a small model on the card (TF32 off) and
     on the CPU from the same weights and MLM masks, and compares the
     losses, the first step's gradients and the updated parameters; then
     the same in frame-level mode at S=1024 (flash2 in f32).

The line before the last is a JSON summary of the kernels; the last line is
``{"ok": true, "device": {...}}``.  Without CUDA, or without the package
beside it, the script exits non-zero before printing any result.
"""

from __future__ import annotations

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
# A bf16 backward rule rounds each dropped p to bf16 before dV = pd^T dO, as
# the kernels do, but the two form p in f32 by formulas that agree only to
# their last bits (a softmax against exp2(s - lse) on the forward's lse,
# the scores summed in another order).  A p within that gap of a midpoint
# between two bf16 values may round up in one and down in the other, and
# dv then moves by one bf16 step of pd times |dO|: 2^-7 * 2 = 1.6e-2 for a
# dropped pd just above 1 and |dO| = 2, past GRAD_TOL.  :func:`tie_slack`
# allows that step at every p within TIE_RTOL of a midpoint, and no more;
# :func:`check_v2_backward` measures the gap between the rule's p and
# exp2(s - lse) on the kernel's lse and fails if it passes TIE_RTOL.
TIE_RTOL = 2.0 ** -18
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
# fuse_text_pass: 1 + 5 train steps a run, in turns unfused, fused, fused,
# unfused (ten timed steps a form)
FUSE_WARMUP, FUSE_STEPS = 1, 5
# data parallelism: two steps of the global B=96 through cli.train --dp 2,
# held against one process; each spawn's time limit (s)
DP_SYNTHETIC = 2 * 96
DP_TIMEOUT = 300
# tensor parallelism (phase 6h): an epoch of 1 + 2 steps at the global B=96
# through cli.train --mp 2, SP off and on, in one spawn of two ranks with
# its own time limit (s); the served split is two batches, the last ragged
TP_SYNTHETIC = 3 * 96
TP_TIMEOUT = 540
TP_SERVE = 2 * 96 - 23
# The leaves whose updates (final minus initial weights) fuse_text_pass and
# dp are held to against the reference run's: the first layer's q, which
# every loss term reaches through the whole encoder, and the text view's
# InfoNCE head, which only the contrastive term reaches (so a wrong
# cross-rank gather shows there first).  The 2-norm of the difference of
# the updates must stay within UPDATE_RTOL of the reference update's 2-norm
# (bf16: the fused call and half batches take other GEMM roundings, and
# Adam's first steps, near lr * sign(g), turn the sign of a gradient near 0
# into a whole step; on the H100 the correct runs read 1.6e-2 and 4.7e-2
# fused, 1.8e-2 and 3.3e-3 under dp, where a gather whose backward skips
# the cross-rank sum reads about 2); a zero update fails.
UPDATE_LEAVES = ("bert/layers/0/q/weight", "cpc/zt/weight")
UPDATE_RTOL = 0.25
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
# does; above, the tiled pair takes the same mma.sync scores but sums the
# row's exponentials over 32-key halves of the forward's 64-key tiles, in
# another order, so the lse moves by an ulp or two: ~1e-6 on live rows
# (|lse| < ~10), and on rows with every key masked (lse near -14427, an
# f32 ulp of 2^-10) by about one ulp of |lse|, ~1e-7 relative.
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


def check_close(name, got, ref, atol, rtol, mask=None, slack=None) -> float:
    """|got - ref| within atol + rtol |ref| on ``mask``, plus ``slack``
    (:func:`tie_slack`) where given; the elements that needed the slack
    are printed.  Returns the largest difference."""
    import torch

    got, ref = got.float(), ref.float()
    if mask is not None:
        got, ref = got[mask], ref[mask]
        slack = None if slack is None else slack[mask]
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: non-finite kernel output")
    err = (got - ref).abs()
    allowed = atol + rtol * ref.abs()
    bad = err > allowed + (0.0 if slack is None else slack)
    if bad.any():
        raise AssertionError(
            f"{name}: {int(bad.sum())} elements outside atol={atol} "
            f"rtol={rtol}{'' if slack is None else ' plus the tie slack'}; "
            f"max abs err {float(err.max()):.3e}")
    tied = err > allowed
    if tied.any():
        err, allowed, ref, slack = (x.flatten() for x in (err, allowed, ref,
                                                          slack))
        i = int(torch.argmax(torch.where(tied.flatten(), err - allowed,
                                         -1.0)))
        print(f"{name}: {int(tied.sum())} of {err.numel()} elements past "
              f"atol={atol} rtol={rtol}, each within its bf16 tie slack "
              f"(the largest excess {float(err[i] - allowed[i]):.3e}, its "
              f"slack {float(slack[i]):.3e}: |diff| {float(err[i]):.3e}, "
              f"ref {float(ref[i]):.3e})", flush=True)
    return float(err.max())


def tie_slack(pd, do):
    """dv's slack for a bf16 rule that rounds ``pd`` ([B, heads, S, S] f32,
    the dropped p as the rule forms it) before pd^T ``do`` ([B, S, H], the
    rule's other operand): the bf16 step between the roundings of
    pd (1 - TIE_RTOL) and pd (1 + TIE_RTOL), zero but where pd lies that
    near a bf16 midpoint, times |do|, summed over the query rows as dv
    sums.  Returns (slack [B, S, H] f32, the number of such pd)."""
    import torch

    step = ((pd * (1.0 + TIE_RTOL)).to(torch.bfloat16).float()
            - (pd * (1.0 - TIE_RTOL)).to(torch.bfloat16).float())
    b, n, s, _ = pd.shape
    slack = torch.einsum("bnqk,bqnd->bknd", step,
                         do.float().abs().reshape(b, s, n, -1))
    return slack.reshape(b, s, -1), int((step != 0).sum())


def check_update(name, got, ref, start, rtol=None):
    """A leaf's update (``got - start``) against the reference run's
    (``ref - start``): neither zero, and the 2-norm of their difference
    within ``rtol`` (default UPDATE_RTOL) of the reference update's.  A leaf
    compared as weights cannot tell a step from no step where the update is
    far below the weights' tolerance; its update can.  Returns (the
    relative 2-norm difference, the reference update's largest element,
    the largest difference over it)."""
    d_got, d_ref = got.float() - start.float(), ref.float() - start.float()
    n_got, n_ref = float(d_got.norm()), float(d_ref.norm())
    if not n_got > 0 or not n_ref > 0:
        raise AssertionError(f"{name}: no update (2-norm {n_got:.3e}, "
                             f"reference {n_ref:.3e})")
    rel = float((d_got - d_ref).norm()) / n_ref
    top = float(d_ref.abs().max())
    if not rel <= (UPDATE_RTOL if rtol is None else rtol):
        raise AssertionError(f"{name}: update differs from the reference "
                             f"update by {rel:.3e} of its 2-norm {n_ref:.3e}")
    return rel, top, float((d_got - d_ref).abs().max()) / top


def check_within(name, got, want, atol, rtol, gap, mask) -> float:
    """|got - want| within twice (atol + rtol |want|) plus ``gap`` (what a
    rounding the kernel shares with its plain rule moves in that rule, and
    any tie slack) on ``mask``; returns the largest difference."""
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


# The attention-dropout rate the kernel phases draw at beside 0: None for
# ATTN_DROPOUT snapped to t/256 (the model paths' rate); phase_dropout_rates
# sets rates off the grid (the word rule) through dropout_rate.
PHASE_RATE = None


def phase_rate():
    """The kernel phases' dropout rate (see PHASE_RATE)."""
    from msa_tpu_torch.ops.dropout import quantize_dropout_rate

    return (quantize_dropout_rate(ATTN_DROPOUT) if PHASE_RATE is None
            else PHASE_RATE)


@contextlib.contextmanager
def dropout_rate(rate):
    """The kernel phases' dropout rate set to ``rate`` for the block."""
    global PHASE_RATE
    saved = PHASE_RATE
    PHASE_RATE = rate
    try:
        yield
    finally:
        PHASE_RATE = saved


def sdpa_args(q, k, v, bias):
    """[B, S, H] -> SDPA's [B, heads, S, d] views and an additive mask."""
    b, s, _ = q.shape
    split = lambda x: x.view(b, s, HEADS, -1).transpose(1, 2)  # noqa: E731
    return split(q), split(k), split(v), bias[:, None, None, :].to(q.dtype)


def fwd_form(s, dtype):
    """The form the short forward takes for (S, dtype) at the phases' head
    dim: csrc/short_attention.cu::fwd_dispatch (the whole-row template up
    to 128 keys at head dims up to 128, else the two-sweep ring)."""
    import torch

    from msa_tpu_torch.ops import short_attention as sa

    if dtype != torch.bfloat16:
        return "CUDA cores"
    if s <= 128 and (sa.kernel_head_dim(HIDDEN // HEADS)
                     <= sa.WHOLE_ROW_MAX_HEAD_DIM):
        return "tensor cores, whole row"
    return "tensor cores, two-sweep"


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

    dname = str(q.dtype).split(".")[1]
    atol, rtol = ATTN_TOL[dname]
    t = rate
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

    from msa_tpu_torch.ops.short_attention import (
        _forward_kernel, _packed_forward_kernel, dropout_keep_mask,
        short_attention, short_attention_plain)

    rate_on = phase_rate()
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


def check_rounded_backward(tag, grads, rule, rule32, auto, live, atol, rtol,
                           dv_slack=None):
    """A backward kernel's dq, dk, dv against its plain rule with the
    kernel's roundings (``rule``: dS and the dropped p rounded to the
    dtype) at (atol, rtol) on live rows and MASKED_ROW_GRAD_ATOL on fully
    masked rows, and against autograd through the plain forward in f32
    (``auto``) on live rows within twice the tolerance plus the gap those
    roundings make in the rule (|rule - rule32|, ``rule32`` the rule in f32
    throughout; :func:`check_within`).  ``dv_slack`` (:func:`tie_slack`)
    is added to dv's bounds on live rows.  Returns (max abs err against the
    rule, largest difference to autograd)."""
    err = auto_err = 0.0
    for name, g, r, r32, a in zip(("dq", "dk", "dv"), grads, rule, rule32,
                                  auto):
        slack = dv_slack if name == "dv" else None
        err = max(err, check_close(f"{tag} {name}", g, r, atol, rtol,
                                   mask=live, slack=slack))
        check_close(f"{tag} {name} masked row", g, r, MASKED_ROW_GRAD_ATOL,
                    0.0, mask=~live)
        gap = (r.float() - r32.float()).abs()
        if slack is not None:
            gap = gap + slack
        auto_err = max(auto_err, check_within(
            f"{tag} {name} against autograd", g, a, atol, rtol, gap, live))
    return err, auto_err


def phase_attention_backward(gen):
    """The v2 backward (row 3; bf16 at S <= 128 one tensor-core launch of
    short_bwd_tc.cuh, above it the tiled pair of short_bwd_tiled.cuh; f32
    the CUDA-core pair), run through autograd of
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

    rate_on = phase_rate()
    cases = [("text", BATCH, TEXT_LEN), ("joint", 2 * BATCH, 2 * TEXT_LEN),
             ("s130", 8, 130), ("s512", 4, 512), ("s768", 4, 768)]
    worst, times = 0.0, {}
    for label, b, s in cases:
        for dtype in (torch.bfloat16, torch.float32):
            dname = str(dtype).split(".")[1]
            route = sa.backward_route(s, dtype, HIDDEN // HEADS)
            one = route == sa.WHOLE_ROW  # else a pair that reads the lse
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
                                         rate, not one)[1]
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
                # pairs read from the forward (and delta, which their dq
                # launch hands to dk/dv) are that design's own choice, so
                # the lse is printed apart, not counted.  The products: the
                # scores (recomputed: P is not an input), dP = dO.V^T, dV =
                # P^T.dO, dQ = dS.K, dK = dS^T.Q
                nbytes = 7 * q.element_size() * b * s * HIDDEN + b * s * 4
                extra = b * HEADS * s * 4
                bound = bound_ms(nbytes, 10 * b * s * s * HIDDEN, dname)
                times[(label, dname, rate)] = (ms, plain_ms, lib_ms, bound)
                print(f"short_attention_backward [{b},{s},{HIDDEN}] {dname} "
                      f"({route}) rate {rate:g}: max_abs_err {case_err:.3e} "
                      f"against the rounded rule (atol {atol}, rtol {rtol}), "
                      f"{auto_err:.3e} against f32 autograd (twice that plus "
                      f"the rounding gap); kernel {ms:.4f} ms, plain "
                      f"{plain_ms:.4f} ms, {lib_txt or 'no sdpa (dropout)'}, "
                      f"bound {bound[0]:.4f} ms ({bound[1]}, "
                      f"{bound[0] / ms:.1%} of it reached"
                      + ("" if one else f"; the lse read adds "
                         f"{extra / HBM_BYTES_PER_S * 1e3:.4f} ms") + ")",
                      flush=True)
    return worst, times


def phase_dropout(gen):
    """The keep mask on the card: the export kernel against its plain
    Philox, its keep share, the forward with dropout against the plain
    version given the mask, and determinism in the seed."""
    import math

    import torch

    from msa_tpu_torch.ops.dropout import keep_mask_plain
    from msa_tpu_torch.ops.short_attention import (
        dropout_keep_mask, short_attention, short_attention_plain)

    b, s = 2 * BATCH, 2 * TEXT_LEN  # the joint shape
    rate = phase_rate()
    seed = 987654321987
    keep = dropout_keep_mask(seed, rate, b, HEADS, s, "cuda")
    plain = keep_mask_plain(seed, rate, b, HEADS, s, device="cuda")
    torch.cuda.synchronize()
    mismatches = int((keep != plain).sum())
    if mismatches:
        raise AssertionError(f"dropout mask: {mismatches} decisions differ "
                             "from the plain Philox")
    want = 1.0 - rate  # exactly, on either rule: t / 256 on the grid
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
    dO * (1 / (1 - rate)) rounded before dP and dV; in bf16 dv within
    :func:`tie_slack` of it) at GRAD_TOL, and against autograd through the
    plain version in f32 within twice it plus the gap those roundings make
    in the rule (the rule in f32 on the plain forward's output and lse, so
    the forward's rounding of p that out32 carries counts too); fused and split against each other at GRAD_TOL; the
    forward against the plain version at ATTN_TOL.  f32 above head dim 128
    (``wide_f32``) runs one code, the short-attention v3 pair, for both
    routes: that is checked once, and not against itself.  Returns (errors
    against the rule by route, against autograd by route, fused vs split or
    None, out32, lse)."""
    import torch

    from msa_tpu_torch.ops.flash2 import (
        _forward_kernel, flash_attention2_backward,
        flash_attention2_backward_plain, flash_attention2_plain)
    from msa_tpu_torch.ops.short_attention import _logits_plain, wide_f32

    dname = str(q.dtype).split(".")[1]
    out, lse, ctx32 = _forward_kernel(q, k, v, bias, HEADS, seed, rate,
                                      train=True)
    o32 = out if ctx32 is None else ctx32
    routes = (True,) if wide_f32(q.dtype, HIDDEN // HEADS) else (True, False)
    got = {fused: flash_attention2_backward(
        q, k, v, bias, o32, lse, dout, HEADS, seed, rate, fused=fused)
        for fused in routes}
    wide = [x.detach().float().requires_grad_() for x in (q, k, v)]
    ref_out = flash_attention2_plain(*wide, bias, HEADS, rate, keep)
    auto = torch.autograd.grad(ref_out, wide, dout.float())
    rule = flash_attention2_backward_plain(q, k, v, bias, o32, lse, dout,
                                           HEADS, rate, keep)
    # the rule in f32 throughout on the plain forward's output and lse: the
    # gap to it holds the kernel forward's bf16 rounding of p before P V
    # too, which o32 carries into delta
    plain_lse = torch.logsumexp(_logits_plain(q, k, bias, HEADS),
                                dim=-1) / math.log(2.0)
    rule32 = flash_attention2_backward_plain(
        *(x.detach() for x in wide), bias, ref_out.detach(), plain_lse,
        dout.float(), HEADS, rate, keep)
    del plain_lse
    slack = None
    if q.dtype == torch.bfloat16:  # the rule's pd: the kept p, unscaled
        pd = torch.exp2(_logits_plain(q, k, bias, HEADS) / math.log(2.0)
                        - lse[..., None])
        do = dout
        if keep is not None:
            pd = torch.where(keep, pd, 0.0)
            fold = torch.tensor(1.0 / (1.0 - rate), dtype=q.dtype).item()
            do = (dout.float() * fold).to(q.dtype)
        slack, _ = tie_slack(pd, do)
        del pd
    torch.cuda.synchronize()
    atol, rtol = ATTN_TOL[dname]
    check_close(f"{tag} forward", out, ref_out.detach(), atol, rtol, mask=live)
    gatol, grtol = GRAD_TOL[dname]
    errs, autos = {}, {}
    for fused in routes:
        route = "fused" if fused else "split"
        errs[fused], autos[fused] = check_rounded_backward(
            f"flash2_bwd_{route} {tag}", got[fused], rule, rule32, auto, live,
            gatol, grtol, dv_slack=slack)
    between = None
    if len(routes) == 2:
        between = max(check_close(f"flash2 fused vs split {tag} {name}", gf,
                                  gs, gatol, grtol, mask=live)
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

    from msa_tpu_torch.ops.dropout import keep_mask_plain
    from msa_tpu_torch.ops.flash2 import (
        flash_attention2, flash_attention2_backward, flash_attention2_plain)
    from msa_tpu_torch.ops.short_attention import short_attention

    rate_on = phase_rate()
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
    from msa_tpu_torch.ops.dropout import keep_mask_plain
    from msa_tpu_torch.ops.short_attention import (
        short_attention_train_forward_plain)

    gen = torch.Generator(device="cuda").manual_seed(15)
    rate_on = phase_rate()
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
                    seed, t = 1400 + s, rate
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
    pair; at head dim 16 ([32, 1024, 128], rate 0) flash2's fused and split
    backwards; SDPA's backward at head dims 64, 32 and 16 at those shapes;
    flash2's split backward at [2, 4096, 1024] (the long-S step's
    route) at 16 heads of 64, and at [2, 4096, H] at the wide head dims
    (``WIDE_HEAD_DIM_CASES``) beside SDPA's backward; and the joint embed
    (row 2) at [96, 40+40, 1024] and [96, 40+40, 64], D = 47.  It calls only entry points that
    every tree of the port has had since row 13 was ported, so
    ``--flash-times ROOT`` times another checkout's kernels by this code.
    Prints and returns {label: ms}."""
    import torch

    from msa_tpu_torch.ops import attention as A
    from msa_tpu_torch.ops import flash2 as F2
    from msa_tpu_torch.ops.dropout import quantize_dropout_rate
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
        t = rate
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
    # both flash2 backwards at head dim 16 ([32, 1024, 128], 8 heads), and
    # SDPA's backward at head dims 64, 32 and 16 beside them
    q16, k16, v16, do16 = (x[..., :128].contiguous() for x in (q, k, v, dout))
    _, lse, out32 = F2._forward_kernel(q16, k16, v16, bias, 8, 7, 0, True)
    for fused in (True, False):
        times[f"flash2 {'fused' if fused else 'split'} d16 rate 0"] = \
            cuda_ms(lambda: F2.flash_attention2_backward(
                q16, k16, v16, bias, out32, lse, do16, 8, 7, 0.0,
                fused=fused), iters=10)
    mask = bias[:, None, None, :].to(torch.bfloat16)
    for d, xs in ((64, (q, k, v, dout)), (32, (q32, k32, v32, do32)),
                  (16, (q16, k16, v16, do16))):
        qq, kk, vv = (x.detach().requires_grad_() for x in xs[:3])
        split = lambda x: x.view(b, s, -1, d).transpose(1, 2)  # noqa: E731
        lib_out = torch.nn.functional.scaled_dot_product_attention(
            split(qq), split(kk), split(vv), attn_mask=mask)
        times[f"sdpa bwd d{d}"] = cuda_ms(lambda: torch.autograd.grad(
            lib_out, (qq, kk, vv), split(xs[3]), retain_graph=True), iters=10)
        del qq, kk, vv, lib_out
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
    # and at the wide head dims (4 heads of 256 at H = 1024, where JAX's rule
    # takes the split route too; 6 of 192 padded), beside SDPA's backward
    for d, hid, nh in WIDE_HEAD_DIM_CASES:
        ql, kl, vl, dol = (torch.randn(2, 4096, hid, device="cuda", generator=gl)
                           .to(torch.bfloat16) for _ in range(4))
        _, lse_l, out32_l = F2._forward_kernel(ql, kl, vl, bl, nh, 7, 0, True)
        times[f"flash2 split s4096 d{d} rate 0"] = cuda_ms(
            lambda: F2.flash_attention2_backward(ql, kl, vl, bl, out32_l, lse_l,
                                                 dol, nh, 7, 0.0, fused=False),
            iters=10)
        qq, kk, vv = (x.detach().requires_grad_() for x in (ql, kl, vl))
        split = lambda x: x.view(2, 4096, nh, d).transpose(1, 2)  # noqa: E731
        lib_out = torch.nn.functional.scaled_dot_product_attention(
            split(qq), split(kk), split(vv),
            attn_mask=bl[:, None, None, :].to(torch.bfloat16))
        times[f"sdpa bwd s4096 d{d}"] = cuda_ms(lambda: torch.autograd.grad(
            lib_out, (qq, kk, vv), split(dol), retain_graph=True), iters=10)
        del ql, kl, vl, dol, out32_l, qq, kk, vv, lib_out
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


def time_flash_at_head_dims():
    """Device ms of bf16 flash at ``FLASH_TIMED_HEAD_DIMS`` (d = 128 at H =
    1024, 8 heads; d = 256 at H = 1024, 4 heads; d = 192 at H = 1152, 6
    heads, padded onto 256) at the frame-level joint shape [2 x
    FRAME_BATCH, 1024, H], rate 0 and the training dropout: flash2's
    serving and training forwards, its fused and split backwards (from its
    own training forward's f32 output and lse), the head-split serving
    forward and backward pair (from its training forward's output and
    lse); SDPA's forward and backward at rate 0.  Entry points every
    tree of the port has had since head dim 256 came in, so
    ``--flash-times ROOT`` times another checkout's kernels by this code.
    Prints and returns {label: ms}."""
    import torch
    import torch.nn.functional as F

    from msa_tpu_torch.ops import attention as A
    from msa_tpu_torch.ops import flash2 as F2
    from msa_tpu_torch.ops.dropout import quantize_dropout_rate

    b, s = 2 * FRAME_BATCH, TEXT_LEN + FRAME_PAIR_LEN
    times = {}
    for d, hidden, heads in FLASH_TIMED_HEAD_DIMS:
        gen = torch.Generator(device="cuda").manual_seed(d)
        q, k, v, dout = (torch.randn(b, s, hidden, device="cuda", generator=gen)
                         .to(torch.bfloat16) for _ in range(4))
        bias = torch.zeros(b, s, device="cuda")
        qh, kh, vh, doh = (x.view(b, s, heads, d).transpose(1, 2).contiguous()
                           for x in (q, k, v, dout))
        for rate in (0.0, quantize_dropout_rate(ATTN_DROPOUT)):
            _, lse, out32 = F2._forward_kernel(q, k, v, bias, heads, 7, rate,
                                               True)
            times[f"d{d} flash2 fwd rate {rate:g}"] = cuda_ms(
                lambda: F2._forward_kernel(q, k, v, bias, heads, 7, rate,
                                           False), iters=10)
            times[f"d{d} flash2 fwd train rate {rate:g}"] = cuda_ms(
                lambda: F2._forward_kernel(q, k, v, bias, heads, 7, rate,
                                           True), iters=10)
            for fused in (True, False):
                times[f"d{d} flash2 {'fused' if fused else 'split'} rate "
                      f"{rate:g}"] = cuda_ms(
                    lambda: F2.flash_attention2_backward(
                        q, k, v, bias, out32, lse, dout, heads, 7, rate,
                        fused=fused), iters=10)
            times[f"d{d} row 13 fwd rate {rate:g}"] = cuda_ms(
                lambda: A._forward_kernel(qh, kh, vh, bias, 7, rate, False),
                iters=10)
            out_h, lse_h = A._forward_kernel(qh, kh, vh, bias, 7, rate, True)
            times[f"d{d} row 13 bwd rate {rate:g}"] = cuda_ms(
                lambda: A.flash_attention_backward(qh, kh, vh, bias, out_h,
                                                   lse_h, doh, 7, rate),
                iters=10)
            del out_h, lse_h
        qq, kk, vv = (x.detach().requires_grad_() for x in (qh, kh, vh))
        mask = bias[:, None, None, :].to(torch.bfloat16)
        lib_out = F.scaled_dot_product_attention(qq, kk, vv, attn_mask=mask)
        times[f"d{d} sdpa fwd"] = cuda_ms(
            lambda: F.scaled_dot_product_attention(qq, kk, vv, attn_mask=mask),
            iters=10)
        times[f"d{d} sdpa bwd"] = cuda_ms(lambda: torch.autograd.grad(
            lib_out, (qq, kk, vv), doh, retain_graph=True), iters=10)
        del q, k, v, dout, qh, kh, vh, doh, qq, kk, vv, lib_out, lse, out32
    print(f"flash at head dims [{b},{s},H] bfloat16, ms: "
          f"{json.dumps(times)}", flush=True)
    return times


WIDE_FRAME_STEPS = 3


def frame_step_ms(model=None, flash2=True):
    """ms/step of WIDE_FRAME_STEPS bf16 frame-level train steps (B =
    FRAME_BATCH, Lp = FRAME_PAIR_LEN: the joint pass [32, 1024] on flash2,
    fused backward; with ``flash2`` False under ``USE_FLASH2 = False``, on
    the head-split flash attention and its split pair) of ``model``:
    bert-large's widths at 4 heads of 256 (``WIDE_HEADS``, 24 layers; the
    default), as
    phase_wide_heads trains it, or bert-large itself (16 heads of 64, as
    phase_frame_training trains it), after a warm-up step (host clock
    around synchronised steps), and the losses: entry points every tree of
    the port has had since head dim 256 came in, for ``--flash-times
    ROOT``."""
    import torch

    from msa_tpu_torch.data import MultimodalDataset, synthetic_split
    from msa_tpu_torch.ops import attention as A
    from msa_tpu_torch.training.trainer import Trainer

    model = model or WIDE_HEADS
    exp = frame_experiment(FRAME_PAIR_LEN, None, model,
                           train_batch_size=FRAME_BATCH,
                           compute_dtype="bfloat16", warmup_proportion=0.01,
                           adam_mu_dtype="bfloat16", adam_nu_dtype="bfloat16",
                           data_parallel=1)
    cfg = exp.model
    trainer = Trainer(exp, "cuda")
    state = trainer.init_state(0, total_steps=10_000)
    split = synthetic_split(2 * FRAME_BATCH, TEXT_LEN, cfg.visual_dim,
                            cfg.speech_dim, vocab_size=cfg.bert.vocab_size,
                            seed=2, pair_seq_length=FRAME_PAIR_LEN)
    batches = list(MultimodalDataset(split, seed=0).epoch_batches(
        0, FRAME_BATCH, drop_last=True))
    saved, A.USE_FLASH2 = A.USE_FLASH2, flash2
    try:
        state, m = trainer.train_step(state, batches[0], 1)
        losses = [float(m["loss"])]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        metrics = []
        for i in range(WIDE_FRAME_STEPS):
            state, m = trainer.train_step(
                state, batches[(i + 1) % len(batches)], 1)
            metrics.append(m)
        torch.cuda.synchronize()
    finally:
        A.USE_FLASH2 = saved
    ms = (time.perf_counter() - t0) * 1e3 / WIDE_FRAME_STEPS
    losses += [float(m["loss"]) for m in metrics]
    switch = "" if flash2 else " (USE_FLASH2 = False)"
    label = "wide heads" if model == WIDE_HEADS else model.split("-uncased")[0]
    print(f"{label} frame step{switch}: {model} frame-level training "
          f"bf16 B={FRAME_BATCH} L={TEXT_LEN} Lp={FRAME_PAIR_LEN}: {ms:.2f} "
          f"ms/step over {WIDE_FRAME_STEPS} steps after 1; losses "
          f"{[round(x, 5) for x in losses]}", flush=True)
    return ms, losses


def time_flash_path():
    """``--flash-times ROOT``: the flash kernels and the joint embed
    (:func:`time_flash_backwards`), bf16 flash at head dims 128, 256 and
    192 (:func:`time_flash_at_head_dims`), the frame-level step at 4
    heads of 256, on flash2 and under ``USE_FLASH2 = False``, and
    bert-large's (16 heads of 64, 24 fused sweeps a step) on flash2
    (:func:`frame_step_ms`) of the tree on sys.path, whose kernels build
    into its own build/."""
    times = time_flash_backwards()
    times.update(time_flash_at_head_dims())
    times["wide heads frame step"] = frame_step_ms()[0]
    times["wide heads frame step (USE_FLASH2 = False)"] = \
        frame_step_ms(flash2=False)[0]
    times["bert-large frame step"] = frame_step_ms("bert-large-uncased")[0]
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
        out["tiled_backward"] = phase_tiled_backward()
        out["flash_attention"] = phase_flash_attention(gen)
        out["v1"] = phase_short_v1(gen)
    print(f"head dim 32: every kernel check passed in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return out


# The head dims the port runs beside the presets' 32 and 64: (d,
# H, heads, every kernel phase or only v2's and flash2's forward and
# backward).  d = 26 is TinyBERT-4L-312D's (H = 312, 12 heads: the
# instantiation at 32, zero-padded), 128 the widest instantiation, 8 and
# 16 the narrowest (d = 8 on the one at 16).
HEAD_DIM_CASES = ((26, 312, 12, True), (128, 1024, 8, True),
                  (8, 64, 8, False), (16, 128, 8, False))
LN_QUANT_WIDTHS = (32, 312, 4096, 100)  # the generic form's widths
WIDE_EMBED = (2560, 1100)  # (H, D) of the joint embed past 2048 and 1024


def phase_head_dims():
    """Every attention kernel at head dims 26 and 128, and v2's and
    flash2's forwards and backwards at 8 and 16 (``HEAD_DIM_CASES``): the
    kernel phases above under :func:`head_widths`, from a generator of
    their own each, with their checks and tolerances (a head dim off the
    instantiations runs its heads zero-padded, the pad and the cut inside
    every timed call); then ln_quant's generic form at ``LN_QUANT_WIDTHS``
    and the joint embed at ``WIDE_EMBED``.  Returns {d: {phase: (worst
    error, times)}} and the wide-width checks' {"ln_quant": ..., "joint_embed":
    ...}."""
    import torch

    from msa_tpu_torch.ops import short_attention as sa

    out = {}
    t0 = time.perf_counter()
    for d, hidden, heads, full in HEAD_DIM_CASES:
        gen = torch.Generator(device="cuda").manual_seed(100 + d)
        with head_widths(hidden, heads):
            print(f"head dim {d}: H={HIDDEN}, {HEADS} heads", flush=True)
            res = {"attention": phase_attention(gen),
                   "attention_backward": phase_attention_backward(gen),
                   "flash2": phase_flash2(gen),
                   "flash2_backward": phase_flash2_backward(gen)}
            if full:
                res["probs_packed"] = phase_probs_packed(gen)
                res["v3"] = phase_v3_kernels(gen)
                res["tiled_backward"] = phase_tiled_backward()
                res["flash_attention"] = phase_flash_attention(gen)
                res["v1"] = phase_short_v1(gen)
            if d not in sa.HEAD_DIMS:
                time_head_pad(gen, 2 * BATCH, 2 * TEXT_LEN)
                time_head_pad(gen, 2 * FRAME_BATCH, FRAME_PAIR_LEN + TEXT_LEN)
        out[d] = res
    gen = torch.Generator(device="cuda").manual_seed(99)
    wide = {"ln_quant": {}}
    for h in LN_QUANT_WIDTHS:
        with head_widths(h, 1):
            wide["ln_quant"][h] = phase_ln_quant(gen, (
                ("text", BATCH * TEXT_LEN), ("odd", 1001)))
    wide["joint_embed"] = check_wide_joint_embed(gen)
    print(f"head dims {[c[0] for c in HEAD_DIM_CASES]}, ln_quant at "
          f"{LN_QUANT_WIDTHS}, the joint embed at H, D = {WIDE_EMBED}: every "
          f"check passed in {time.perf_counter() - t0:.1f} s", flush=True)
    return out, wide


def time_head_pad(gen, b, s):
    """The pad and the cut a head dim off the instantiations costs at [b, s,
    HIDDEN] bf16 (``ops.short_attention.HeadPad``): the three pads of q, k
    and v a forward call makes, and one cut of its output, timed alone."""
    import torch

    from msa_tpu_torch.ops.short_attention import HeadPad

    pad = HeadPad(HIDDEN, HEADS)
    q = torch.randn(b, s, HIDDEN, device="cuda", generator=gen).to(torch.bfloat16)
    wide = pad.pad(q)
    pad_ms = cuda_ms(lambda: [pad.pad(q) for _ in range(3)])
    cut_ms = cuda_ms(lambda: pad.cut(wide))
    print(f"head dim {pad.d} on the instantiation at {pad.kd}: three pads "
          f"[{b},{s},{HIDDEN}] -> [{b},{s},{pad.hidden}] {pad_ms:.4f} ms, the "
          f"cut back {cut_ms:.4f} ms (inside every timed call at this head "
          f"dim)", flush=True)
    return pad_ms, cut_ms


def check_wide_joint_embed(gen, h=WIDE_EMBED[0], d=WIDE_EMBED[1]):
    """The joint embed at H, D (``WIDE_EMBED``: rows held in three sweeps,
    features in 18 staged rounds, tiles of 4 rows over 3 column rounds;
    ``HUGE_EMBED``: frame tiles that hold no row, the projection recomputed
    in three sweeps) at B = 3, Lp = 37 and B = 16, L = Lp = 40, bf16 and
    f32, against the plain version; the bf16 B = 16 call timed.  Returns
    (worst error, (ms, plain ms, library ms, bound))."""
    import torch
    import torch.nn.functional as F

    from msa_tpu_torch.ops.fused_joint_embed import (
        fused_joint_embed, fused_joint_embed_plain)

    worst, timing = 0.0, None
    for batch, lp in ((3, 37), (16, TEXT_LEN)):
        for dtype in (torch.bfloat16, torch.float32):
            dname = str(dtype).split(".")[1]
            args = joint_embed_args(gen, batch, lp, d, h, dtype)
            out = fused_joint_embed(*args)
            ref = fused_joint_embed_plain(*args)
            torch.cuda.synchronize()
            tag = f"fused_joint_embed [{batch},{TEXT_LEN}+{lp},{h}] D={d} {dname}"
            err = check_close(tag, out, ref, *EMBED_TOL[dname])
            worst = max(worst, err)
            line = f"{tag}: max_abs_err {err:.3e}"
            if batch == 16 and dtype == torch.bfloat16:
                text, feats, w, b, scale, bias, eps = args
                ms = cuda_ms(lambda: fused_joint_embed(*args))
                plain_ms = cuda_ms(lambda: fused_joint_embed_plain(*args))
                wt = w.t().contiguous().to(dtype)
                lib_ms = cuda_ms(lambda: F.layer_norm(torch.cat(
                    [text, torch.relu(F.linear(feats, wt, b.to(dtype)))], 1),
                    (h,), scale.to(dtype), bias.to(dtype), eps))
                nbytes = ((text.numel() + feats.numel() + out.numel()) * 2
                          + (w.numel() + 3 * h) * 4)
                bound = bound_ms(nbytes, 2 * batch * lp * d * h, dname)
                timing = (ms, plain_ms, lib_ms, bound)
                line += (f"; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
                         f"linear+layer_norm {lib_ms:.4f} ms, bound "
                         f"{bound[0]:.4f} ms ({bound[1]})")
            print(line, flush=True)
    return worst, timing


# The widest head dim and the pad onto it (PR 20): (d, H, heads).  d = 256
# runs bf16 short attention on the tensor cores (the ring forwards and the
# tiled backward pair at every S), flash's forward, flash2's fused backward
# and the split pair of rows 12 and 13 on wgmma, f32 on the CUDA cores;
# d = 192 pads each head to 256.
WIDE_HEAD_DIM_CASES = ((256, 1024, 4), (192, 1152, 6))
# The head dims time_flash_at_head_dims takes beside bert-large's 64: the
# widest below 256 (8 heads of 128), then WIDE_HEAD_DIM_CASES.
FLASH_TIMED_HEAD_DIMS = ((128, 1024, 8),) + WIDE_HEAD_DIM_CASES
HUGE_EMBED = (16384, 47)  # (H, D) of the joint embed's form that holds no row


# The short kernels' checks at the wide head dims: a length below 128 and
# one above, in both dtypes; in bf16 also the lengths the ring forwards and
# the tiled pair take there that they take at no other head dim
# (WIDE_TC_SHAPES: S = 1, one ragged 16-row warp tile, the text pass [B,
# L], the edges of a 64-row tile and of the whole-row templates' 128 keys,
# the last short S), and at d = 256 the word rule at WIDE_WORD_RATE; the
# flash entries at a ragged S past 1024, and at d = 256 in bf16 also at the
# edges of their 64-key and 64- / 128-query tiles (WIDE_FLASH_EDGE_SHAPES:
# S = 1, a ragged 16-row warp tile, 63-65, 127, 129, the last short S),
# at the long-S path's length (WIDE_FLASH_LONG_SHAPE, where JAX's rule
# takes flash2's split route at 4 heads of 256) and at the word rule.
# Then, at the head dim
# phase_wide_heads runs (256), the shapes that path gives the kernels it
# launches, in bf16: v2 at the joint pass [2B, 2L], flash2 at the
# frame-level joint pass [2B, L + Lp].
WIDE_SHORT_SHAPES = ((8, 80), (4, 200))
WIDE_TC_SHAPES = ((4, 1), (4, 17), (BATCH, TEXT_LEN), (4, 64), (4, 65),
                  (4, 128), (4, 129), (2, 1023))
WIDE_WORD_RATE = 0.1
WIDE_FLASH_SHAPE = (2, 1030)
WIDE_FLASH_EDGE_SHAPES = ((2, 1), (2, 17), (2, 63), (2, 64), (2, 65), (2, 127),
                          (2, 129), (2, 1023))
WIDE_FLASH_EDGE_SEED = 257
WIDE_FLASH_LONG_SHAPE = (2, 4096)
WIDE_FLASH_LONG_SEED = 258
WIDE_PATH_HEAD_DIM = 256


def phase_head_dim_256():
    """Every attention kernel at head dims 256 and 192
    (``WIDE_HEAD_DIM_CASES``, under :func:`head_widths`, from a generator of
    their own each): :func:`check_wide_kernels` (every entry, forward and
    backward, bf16 and f32, rate 0 and 26/256, by the kernel phases'
    checks and tolerances) and :func:`time_wide_kernels` (the serving and
    frame shapes' times beside the bound, the plain version and SDPA);
    then the joint embed at ``HUGE_EMBED``.  Returns {d: {kernel: (ms,
    plain ms, library ms, bound)}} and the joint embed's (worst error,
    timing)."""
    import torch

    from msa_tpu_torch.ops import short_attention as sa

    out = {}
    t0 = time.perf_counter()
    for d, hidden, heads in WIDE_HEAD_DIM_CASES:
        gen = torch.Generator(device="cuda").manual_seed(200 + d)
        with head_widths(hidden, heads):
            print(f"head dim {d}: H={HIDDEN}, {HEADS} heads (the library of "
                  f"{sa.kernel_head_dim(d)})", flush=True)
            check_wide_kernels(gen)
            out[d] = time_wide_kernels(gen)
            if d not in sa.HEAD_DIMS:
                time_head_pad(gen, 2 * BATCH, 2 * TEXT_LEN)
    gen = torch.Generator(device="cuda").manual_seed(98)
    huge = check_wide_joint_embed(gen, *HUGE_EMBED)
    print(f"head dims {[c[0] for c in WIDE_HEAD_DIM_CASES]} and the joint "
          f"embed at H, D = {HUGE_EMBED}: every check passed in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return out, huge


def check_wide_kernels(gen):
    """Every attention entry at the phases' widths, bf16 and f32, rate 0 and
    26/256 (the plain versions given the exported mask; bf16 at d = 256
    also ``WIDE_WORD_RATE``, the word rule), by the checks the kernel
    phases use: at ``WIDE_SHORT_SHAPES`` (bf16: and ``WIDE_TC_SHAPES``) the
    v2 forward's serving
    and training forms and v2p's (:func:`check_train_forward`), the v2
    backward through autograd (:func:`check_v2_backward`), v3
    (:func:`check_v3_backward`), v2s's pair (:func:`check_probs_forward`,
    :func:`check_probs_backward`), v2p's backward (:func:`check_packed`),
    v1 (bf16: :func:`check_v1_backward`, its forward against the plain
    version and v2's bit for bit); at ``WIDE_FLASH_SHAPE`` (bf16 at d = 256:
    and ``WIDE_FLASH_EDGE_SHAPES``, the word rule too, and
    ``WIDE_FLASH_LONG_SHAPE`` at rate 0 and 26/256) flash2's forward and
    both backwards and the head-split pair (:func:`check_wide_flash`); at
    ``WIDE_PATH_HEAD_DIM`` the path's own shapes
    (:func:`check_wide_path_shapes`)."""
    import torch

    from msa_tpu_torch.ops import short_attention as sa

    rate_on = phase_rate()
    wide_path = HIDDEN // HEADS == WIDE_PATH_HEAD_DIM
    egen = torch.Generator(device="cuda").manual_seed(WIDE_FLASH_EDGE_SEED)
    lgen = torch.Generator(device="cuda").manual_seed(WIDE_FLASH_LONG_SEED)
    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype).split(".")[1]
        bf = dtype == torch.bfloat16
        word = (WIDE_WORD_RATE,) if bf and wide_path else ()
        for rate in (0.0, rate_on) + word:
            for b, s in WIDE_SHORT_SHAPES + (WIDE_TC_SHAPES if bf else ()):
                q, k, v, bias, live = attention_inputs(gen, b, s, dtype)
                dout = torch.randn(b, s, HIDDEN, device="cuda",
                                   generator=gen).to(dtype)
                seed = 4200 + s
                keep = (sa.dropout_keep_mask(seed, rate, b, HEADS, s, "cuda")
                        if rate else None)
                tag = f"[{b},{s},{HIDDEN}] {dname} rate {rate:g}"
                # the edge lengths' masked rows as the kernel phases' edges
                few = (b, s) in WIDE_TC_SHAPES
                errs = [check_train_forward(f"short_attention {tag}", q, k, v,
                                            bias, live, seed, rate, keep,
                                            few_keys=few)[0]]
                errs += check_v2_backward(f"short_attention_backward {tag}",
                                          q, k, v, bias, live, dout, seed,
                                          rate, keep)
                errs += check_v3_backward(
                    f"short_attention_v3_backward {tag}", q, k, v, bias, live,
                    dout, seed, rate, few_keys=few)[:2]
                _, probs, _, perr, _ = check_probs_forward(
                    tag, q, k, v, bias, live, seed, rate, keep, few_keys=few)
                errs += [perr, *check_probs_backward(tag, q, k, v, bias, live,
                                                     probs, dout, rate, keep)]
                errs += check_packed(tag, q, k, v, bias, live, dout, seed,
                                     rate, keep)[2:]
                if dtype == torch.bfloat16:
                    out = sa.short_attention_v1(q, k, v, bias, HEADS, rate,
                                                seed if rate else None)
                    v2_out = sa.short_attention(q, k, v, bias, HEADS, rate,
                                                seed if rate else None)
                    ref = sa.short_attention_plain(q.float(), k.float(),
                                                   v.float(), bias, HEADS,
                                                   rate, keep)
                    torch.cuda.synchronize()
                    if not torch.equal(out, v2_out):
                        raise AssertionError(f"short_attention_v1 {tag}: not "
                                             "v2's forward bit for bit")
                    errs += [check_close(f"short_attention_v1 {tag}", out, ref,
                                         *ATTN_TOL[dname], mask=live),
                             check_v1_backward(q, k, v, bias, live, dout, seed,
                                               rate)]
                print(f"head dim {HIDDEN // HEADS} short kernels {tag} "
                      f"({fwd_form(s, dtype)}; backward "
                      f"{sa.backward_route(s, dtype, HIDDEN // HEADS)}): "
                      f"worst error {max(errs):.3e} (v2, v2p, v3, v2s, v1 "
                      f"forward and backward against their plain versions)",
                      flush=True)
                del q, k, v, dout, keep
            if rate not in word:
                check_wide_flash(gen, *WIDE_FLASH_SHAPE, dtype, rate)
            if bf and wide_path:  # from a generator of their own
                shapes = (WIDE_FLASH_SHAPE,) if rate in word else ()
                for b, s in shapes + WIDE_FLASH_EDGE_SHAPES:
                    check_wide_flash(egen, b, s, dtype, rate)
                if rate not in word:
                    check_wide_flash(lgen, *WIDE_FLASH_LONG_SHAPE, dtype, rate)
    if wide_path:
        check_wide_path_shapes(gen)


def check_wide_flash(gen, b, s, dtype, rate):
    """flash2's forward and both backwards (:func:`check_flash2_backward`)
    and the head-split pair (:func:`check_head_split`) at [b, s, HIDDEN],
    rate ``rate`` (the plain versions given the exported mask), one line
    printed."""
    import torch

    from msa_tpu_torch.ops import short_attention as sa

    dname = str(dtype).split(".")[1]
    q, k, v, bias, live = attention_inputs(gen, b, s, dtype)
    dout = torch.randn(b, s, HIDDEN, device="cuda", generator=gen).to(dtype)
    seed = 4300 + s
    keep = (sa.dropout_keep_mask(seed, rate, b, HEADS, s, "cuda")
            if rate else None)
    tag = f"[{b},{s},{HIDDEN}] {dname} rate {rate:g}"
    errs, autos, between, _, _ = check_flash2_backward(
        tag, q, k, v, bias, live, dout, seed, rate, keep)
    herr = check_head_split(f"flash_attention {tag}", q, k, v, bias, live,
                            dout, seed, rate, keep)
    if between is None:  # wide_f32: the short kernels, one code
        line = (f"flash2 forward and backward (both routes the "
                f"short-attention CUDA-core forward and v3 pair) "
                f"{errs[True]:.3e} against the rounded rule, "
                f"{autos[True]:.3e} against f32 autograd; head-split (the "
                f"same kernels, one head a row)")
    else:
        line = (f"flash2 fused / split {errs[True]:.3e} / {errs[False]:.3e} "
                f"against the rounded rule, {autos[True]:.3e} / "
                f"{autos[False]:.3e} against f32 autograd, fused vs split "
                f"{between:.3e}; head-split")
    print(f"head dim {HIDDEN // HEADS} flash {tag}: {line} forward and "
          f"backward {herr:.3e}", flush=True)


def check_wide_path_shapes(gen):
    """The kernels phase_wide_heads launches, at the shapes it gives them,
    bf16, rate 0 and the training dropout: the v2 forward (both forms, v2p)
    and backward at [2B, 2L] by :func:`check_train_forward` and
    :func:`check_v2_backward`; flash2's forward and both backwards at [2B,
    L + Lp] by :func:`check_flash2_backward`.  The tolerances are the kernel
    phases'; dv's bf16 rounding ties get :func:`tie_slack`, printed where
    used."""
    import torch

    from msa_tpu_torch.ops import short_attention as sa

    bf = torch.bfloat16
    for rate in (0.0, phase_rate()):
        for b, s in ((2 * BATCH, 2 * TEXT_LEN),
                     (2 * FRAME_BATCH, TEXT_LEN + FRAME_PAIR_LEN)):
            q, k, v, bias, live = attention_inputs(gen, b, s, bf)
            dout = torch.randn(b, s, HIDDEN, device="cuda",
                               generator=gen).to(bf)
            seed = 4400 + s
            keep = (sa.dropout_keep_mask(seed, rate, b, HEADS, s, "cuda")
                    if rate else None)
            tag = f"[{b},{s},{HIDDEN}] bfloat16 rate {rate:g}"
            if s <= sa.MAX_SEQ:
                ferr = check_train_forward(f"short_attention {tag}", q, k, v,
                                           bias, live, seed, rate, keep)[0]
                berr, aerr = check_v2_backward(
                    f"short_attention_backward {tag}", q, k, v, bias, live,
                    dout, seed, rate, keep)
                print(f"head dim {HIDDEN // HEADS} path shape {tag}: v2 "
                      f"forward {ferr:.3e}, backward {berr:.3e} against the "
                      f"rounded rule, {aerr:.3e} against f32 autograd",
                      flush=True)
            else:
                errs, autos, between, _, _ = check_flash2_backward(
                    tag, q, k, v, bias, live, dout, seed, rate, keep)
                print(f"head dim {HIDDEN // HEADS} path shape {tag}: flash2 "
                      f"fused / split {errs[True]:.3e} / {errs[False]:.3e} "
                      f"against the rounded rule, {autos[True]:.3e} / "
                      f"{autos[False]:.3e} against f32 autograd, fused vs "
                      f"split {between:.3e}", flush=True)
            del q, k, v, dout, keep


def check_head_split(tag, x, y, z, bias, live, dout, seed, rate, keep):
    """The head-split flash pair on [B, S, H] inputs split into heads, as
    phase_flash_attention holds it: the forward and its natural-log lse
    against the plain version at ATTN_TOL / FLASH_LSE_*, the backward
    through autograd against the plain rule (``flash_attention_backward_
    plain`` on the kernel's output and lse) at GRAD_TOL and against f32
    autograd within twice it plus the rule's rounding gap.  Returns the
    worst error against the plain versions."""
    import torch

    from msa_tpu_torch.ops import attention as A

    dname = str(x.dtype).split(".")[1]
    q, k, v, do = (split_heads(t) for t in (x, y, z, dout))
    out, lse = A._forward_kernel(q, k, v, bias, seed, rate, train=True)
    xq, xk, xv = (t.detach().requires_grad_() for t in (q, k, v))
    grads = torch.autograd.grad(A.flash_attention(xq, xk, xv, bias, rate, seed),
                                (xq, xk, xv), do)
    qq, kk, vv = (t.detach().float().requires_grad_() for t in (q, k, v))
    ref, ref_lse = A.flash_attention_plain(qq, kk, vv, bias, rate, keep,
                                           with_lse=True)
    auto = torch.autograd.grad(ref, (qq, kk, vv), do.float())
    refs = A.flash_attention_backward_plain(q, k, v, bias, out, lse, do, rate,
                                            keep)
    gaps = [(a.float() - c.float()).abs() for a, c in zip(
        refs, A.flash_attention_backward_plain(
            q.float(), k.float(), v.float(), bias, ref.detach(), lse,
            do.float(), rate, keep))]
    torch.cuda.synchronize()
    err = check_close(tag, out, ref, *ATTN_TOL[dname], mask=live)
    check_close(tag + " lse", lse, ref_lse, FLASH_LSE_ATOL, FLASH_LSE_RTOL,
                mask=live)
    gatol, grtol = GRAD_TOL[dname]
    for name, g, r, a, gap in zip(("dq", "dk", "dv"), grads, refs, auto, gaps):
        err = max(err, check_close(f"{tag} {name}", g, r, gatol, grtol,
                                   mask=live))
        check_within(f"{tag} {name} against autograd", g, a, gatol, grtol, gap,
                     live)
    return err


def time_wide_kernels(gen):
    """bf16 times of every attention entry at the phases' widths: the short
    kernels at the joint shape [192, 80], flash2 at [32, 1024] (its split
    backward there too), the head-split pair at [32, heads, 1024, d]; each
    beside the bound (bytes read and written once, the products of the
    function), the plain version and SDPA (forward, or backward alone).
    Returns {kernel: (ms, plain ms, library ms, bound)} by the kernels
    line's names."""
    import torch
    import torch.nn.functional as F

    from msa_tpu_torch.ops import attention as A
    from msa_tpu_torch.ops import flash2 as F2
    from msa_tpu_torch.ops import short_attention as sa

    bf, seed, times = torch.bfloat16, 17, {}
    for kind, b, s in (("short", 2 * BATCH, 2 * TEXT_LEN),
                       ("flash", 2 * FRAME_BATCH, TEXT_LEN + FRAME_PAIR_LEN)):
        q, k, v, bias, _ = attention_inputs(gen, b, s, bf)
        dout = torch.randn(q.shape, device="cuda", generator=gen).to(bf)
        io = b * s * HIDDEN * 2
        fwd_flops = 4 * b * s * s * HIDDEN
        fwd_bound = bound_ms(4 * io + b * s * 4, fwd_flops, "bfloat16")
        bwd_bound = bound_ms(7 * io + b * s * 4, 2.5 * fwd_flops, "bfloat16")
        v3_bound = bound_ms(8 * io + b * s * 4, 2.5 * fwd_flops, "bfloat16")
        qq, kk, vv = (x.detach().requires_grad_() for x in (q, k, v))
        plain_out = sa.short_attention_plain(qq, kk, vv, bias, HEADS)
        plain_fwd = cuda_ms(lambda: sa.short_attention_plain(q, k, v, bias,
                                                             HEADS), iters=5)
        plain_bwd = cuda_ms(lambda: torch.autograd.grad(
            plain_out, (qq, kk, vv), dout, retain_graph=True), iters=5)
        sq, sk, sv, sm = sdpa_args(qq, kk, vv, bias)
        lib_out = F.scaled_dot_product_attention(sq, sk, sv, attn_mask=sm)
        lib_do = dout.view(b, s, HEADS, -1).transpose(1, 2)
        lib_fwd = cuda_ms(lambda: F.scaled_dot_product_attention(
            sq, sk, sv, attn_mask=sm))
        lib_bwd = cuda_ms(lambda: torch.autograd.grad(
            lib_out, (qq, kk, vv), lib_do, retain_graph=True))
        if kind == "short":
            out, lse = sa._forward_kernel(q, k, v, bias, HEADS, seed, 0.0, True)
            _, probs = sa._probs_forward_kernel(q, k, v, bias, HEADS, seed, 0.0)
            qkv = torch.cat([q, k, v], dim=-1)
            probs_bytes = probs.numel() * 2
            calls = {
                "short_attention": (lambda: sa._forward_kernel(
                    q, k, v, bias, HEADS, seed, 0.0, False), plain_fwd, lib_fwd,
                    fwd_bound),
                "short_attention_backward": (lambda: sa.short_attention_backward(
                    q, k, v, bias, lse, dout, HEADS), plain_bwd, lib_bwd,
                    bwd_bound),
                "short_attention_v3_backward": (
                    lambda: sa.short_attention_v3_backward(
                        q, k, v, bias, out, dout, HEADS), plain_bwd, lib_bwd,
                    v3_bound),
                "short_attention_probs": (lambda: sa._probs_forward_kernel(
                    q, k, v, bias, HEADS, seed, 0.0), plain_fwd, lib_fwd,
                    bound_ms(4 * io + b * s * 4 + probs_bytes, fwd_flops,
                             "bfloat16")),
                "short_attention_probs_backward": (
                    lambda: sa.short_attention_probs_backward(
                        q, k, v, probs, dout, HEADS), plain_bwd, lib_bwd,
                    bound_ms(7 * io + probs_bytes, 2 * fwd_flops, "bfloat16")),
                "short_attention_packed": (lambda: sa._packed_forward_kernel(
                    qkv, bias, HEADS, seed, 0.0, False), plain_fwd, lib_fwd,
                    fwd_bound),
                "short_attention_packed_backward": (
                    lambda: sa.short_attention_packed_backward(
                        qkv, bias, out, dout, HEADS), plain_bwd, lib_bwd,
                    v3_bound),
                "short_attention_v1_fwd": (lambda: sa._v1_forward_kernel(
                    q, k, v, bias, HEADS, seed, 0.0), plain_fwd, lib_fwd,
                    fwd_bound),
                "short_attention_v1_bwd": (
                    lambda: sa.short_attention_v1_backward(
                        q, k, v, bias, dout, HEADS), plain_bwd, lib_bwd,
                    bwd_bound)}
        else:
            _, lse, o32 = F2._forward_kernel(q, k, v, bias, HEADS, seed, 0.0,
                                             True)
            hq, hk, hv, hdo = (split_heads(x) for x in (q, k, v, dout))
            hout, hlse = A._forward_kernel(hq, hk, hv, bias, seed, 0.0, True)
            calls = {
                "flash2_fwd": (lambda: F2._forward_kernel(
                    q, k, v, bias, HEADS, seed, 0.0, False), plain_fwd,
                    lib_fwd, fwd_bound),
                "flash2_bwd_fused": (lambda: F2.flash_attention2_backward(
                    q, k, v, bias, o32, lse, dout, HEADS, fused=True),
                    plain_bwd, lib_bwd, bwd_bound),
                "flash2_bwd_split": (lambda: F2.flash_attention2_backward(
                    q, k, v, bias, o32, lse, dout, HEADS, fused=False),
                    plain_bwd, lib_bwd, bwd_bound),
                "flash_attention_fwd": (lambda: A._forward_kernel(
                    hq, hk, hv, bias, seed, 0.0, False), plain_fwd, lib_fwd,
                    fwd_bound),
                "flash_attention_bwd": (lambda: A.flash_attention_backward(
                    hq, hk, hv, bias, hout, hlse, hdo), plain_bwd, lib_bwd,
                    bwd_bound)}
        for name, (fn, plain_ms, lib_ms, bound) in calls.items():
            ms = cuda_ms(fn, iters=5 if kind == "flash" else 20)
            times[name] = (ms, plain_ms, lib_ms, bound)
            print(f"head dim {HIDDEN // HEADS} {name} [{b},{s},{HIDDEN}] bf16: "
                  f"kernel {ms:.4f} ms, bound {bound[0]:.4f} ms ({bound[1]}, "
                  f"{bound[0] / ms:.1%} of it reached), plain {plain_ms:.4f} "
                  f"ms, sdpa {lib_ms:.4f} ms", flush=True)
    return times


# Rates off the t/256 grid (PR 20): the word rule of csrc/dropout.cuh.
OFF_GRID_RATES = (0.1, 0.3)
# keep_mask_plain's digests of the byte rule's masks before the word rule
# existed (tests/test_torch_dropout_rates.py holds the plain rule to them):
# (rate, (B, heads, S), SHA-256 of the [B, heads, S, S] bool mask)
GRID_MASK_SEED = (123 << 32) + 456
GRID_MASK_DIGESTS = (
    (26 / 256, (2, 3, 40),
     "7bcd8010427732aa99506824c8ca5a4e007e56baa3f4fd62a3d2ae4f11d69771"),
    (26 / 256, (1, 2, 130),
     "3af584e0f5484370ef47d9f6bbd975203dabfa10f7e0228c362d86bfa6d866c4"),
    (1 / 256, (2, 3, 40),
     "40afc2a52a0bfca3ce3857a5d4b8bb2fc834b09b38cb08c9666ac3a61746faef"),
    (255 / 256, (1, 2, 130),
     "a1fedb2687ca5d714ae094702b9f20d08af2eca1b001d84e0259af34ae341cbd"),
    (0.5, (2, 3, 40),
     "f3ebf82e94be42cc21a7cdb3d80f3e9c8416bed97b4030425db184e90cfc2a20"))


def phase_dropout_rates():
    """Attention dropout at rates off the t/256 grid, 0.1 and 0.3 (the word
    rule: one Philox word a key).  At each rate: phase_dropout at the
    bert-large joint shape (the exported mask bit-equal to keep_mask_plain
    over 192 x 16 x 80 x 80 = 19.7M decisions, its keep share within
    KEEP_SHARE_SIGMAS of 1 - rate, the mask a function of the seed, the
    forward against the plain version given it); then every drawing
    kernel's phase at the tiny preset's widths (H = 64, 2 heads: the same
    templates, cheaper) with its checks, forward and backward against the
    plain versions given the exported mask.  Then the byte rule's masks,
    exported by the kernel, against GRID_MASK_DIGESTS (bit-equal to the
    earlier tree's), and :func:`time_rates`.  Returns the timings."""
    import hashlib

    import torch

    from msa_tpu_torch.ops.dropout import on_grid
    from msa_tpu_torch.ops.short_attention import dropout_keep_mask

    t0 = time.perf_counter()
    for rate in OFF_GRID_RATES:
        if on_grid(rate):
            raise AssertionError(f"rate {rate} is on the t/256 grid")
        with dropout_rate(rate):
            phase_dropout(torch.Generator(device="cuda").manual_seed(300))
            gen = torch.Generator(device="cuda").manual_seed(301)
            with head_widths(64, 2):
                print(f"dropout rate {rate} (the word rule): every drawing "
                      f"kernel at H={HIDDEN}, {HEADS} heads", flush=True)
                phase_attention(gen)
                phase_attention_backward(gen)
                phase_flash2_backward(gen)
                phase_probs_packed(gen)
                phase_v3_kernels(gen)
                phase_tiled_backward()
                phase_flash_attention(gen)
                phase_short_v1(gen)
    for rate, shape, digest in GRID_MASK_DIGESTS:
        keep = dropout_keep_mask(GRID_MASK_SEED, rate, *shape, "cuda")
        got = hashlib.sha256(keep.cpu().numpy().tobytes()).hexdigest()
        if got != digest:
            raise AssertionError(f"dropout mask at rate {rate} {shape}: "
                                 f"{got}, the earlier tree's {digest}")
    print(f"dropout: the byte rule's exported masks at rates "
          f"{sorted({r for r, _, _ in GRID_MASK_DIGESTS})} bit-equal to the "
          f"earlier tree's ({len(GRID_MASK_DIGESTS)} digests); rates "
          f"{OFF_GRID_RATES}: every check passed in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return time_rates()


def time_rates():
    """Each drawing kernel at rate 0.1 (the word rule) against the same
    kernel at 26/256 (the byte rule), bf16 at bert-large widths (d = 64):
    the short kernels at the joint shape [192, 80] (the tiled pair at
    [32, 540]), flash2 and the head-split pair at [32, 1024], the mask
    export at [192, 16, 80, 80].  Returns {kernel: {rate: ms}}."""
    import torch

    from msa_tpu_torch.ops import attention as A
    from msa_tpu_torch.ops import flash2 as F2
    from msa_tpu_torch.ops import short_attention as sa

    gen = torch.Generator(device="cuda").manual_seed(302)
    seed = 77
    bf = torch.bfloat16
    b, s = 2 * BATCH, 2 * TEXT_LEN
    q, k, v, bias, _ = attention_inputs(gen, b, s, bf)
    dout = torch.randn(q.shape, device="cuda", generator=gen).to(bf)
    qkv = torch.cat([q, k, v], dim=-1)
    tb, ts = TILED_TIMING_SHAPES[-1]
    tq, tk, tv, tbias, _ = attention_inputs(gen, tb, ts, bf)
    tdout = torch.randn(tq.shape, device="cuda", generator=gen).to(bf)
    fb, fs = 2 * FRAME_BATCH, TEXT_LEN + FRAME_PAIR_LEN
    fq, fk, fv, fbias, _ = attention_inputs(gen, fb, fs, bf)
    fdout = torch.randn(fq.shape, device="cuda", generator=gen).to(bf)
    hq, hk, hv, hdout = (split_heads(x) for x in (fq, fk, fv, fdout))
    times = {}
    for rate in (26 / 256, 0.1):
        out, lse = sa._forward_kernel(q, k, v, bias, HEADS, seed, rate, True)
        _, probs = sa._probs_forward_kernel(q, k, v, bias, HEADS, seed, rate)
        _, tlse = sa._forward_kernel(tq, tk, tv, tbias, HEADS, seed, rate,
                                     True)
        _, flse, fo32 = F2._forward_kernel(fq, fk, fv, fbias, HEADS, seed,
                                           rate, True)
        hout, hlse = A._forward_kernel(hq, hk, hv, fbias, seed, rate, True)
        calls = {
            "dropout_keep_mask": lambda: sa.dropout_keep_mask(
                seed, rate, b, HEADS, s, "cuda"),
            "short_attention (training form)": lambda: sa._forward_kernel(
                q, k, v, bias, HEADS, seed, rate, True),
            "short_attention_backward": lambda: sa.short_attention_backward(
                q, k, v, bias, None, dout, HEADS, seed, rate),
            "short_attention_v3_backward":
                lambda: sa.short_attention_v3_backward(
                    q, k, v, bias, out, dout, HEADS, seed, rate),
            "short_attention_probs": lambda: sa._probs_forward_kernel(
                q, k, v, bias, HEADS, seed, rate),
            "short_attention_probs_backward":
                lambda: sa.short_attention_probs_backward(
                    q, k, v, probs, dout, HEADS, rate),
            "short_attention_packed": lambda: sa._packed_forward_kernel(
                qkv, bias, HEADS, seed, rate, False),
            "short_attention_packed_backward":
                lambda: sa.short_attention_packed_backward(
                    qkv, bias, out, dout, HEADS, seed, rate),
            "short_attention_v1": lambda: sa._v1_forward_kernel(
                q, k, v, bias, HEADS, seed, rate),
            "short_attention_v1_backward":
                lambda: sa.short_attention_v1_backward(
                    q, k, v, bias, dout, HEADS, seed, rate),
            f"short_attention_backward tiled [{tb},{ts}]":
                lambda: sa.short_attention_backward(
                    tq, tk, tv, tbias, tlse, tdout, HEADS, seed, rate),
            "flash2_fwd (training form)": lambda: F2._forward_kernel(
                fq, fk, fv, fbias, HEADS, seed, rate, True),
            "flash2_bwd_fused": lambda: F2.flash_attention2_backward(
                fq, fk, fv, fbias, fo32, flse, fdout, HEADS, seed, rate,
                fused=True),
            "flash2_bwd_split": lambda: F2.flash_attention2_backward(
                fq, fk, fv, fbias, fo32, flse, fdout, HEADS, seed, rate,
                fused=False),
            "flash_attention_fwd (training form)": lambda: A._forward_kernel(
                hq, hk, hv, fbias, seed, rate, True),
            "flash_attention_bwd": lambda: A.flash_attention_backward(
                hq, hk, hv, fbias, hout, hlse, hdout, seed, rate)}
        for name, fn in calls.items():
            times.setdefault(name, {})[rate] = cuda_ms(fn, iters=10)
    for name, by_rate in times.items():
        grid, word = by_rate[26 / 256], by_rate[0.1]
        print(f"rate timing {name}: rate 0.1 (word rule) {word:.4f} ms, "
              f"26/256 (byte rule) {grid:.4f} ms ({word / grid:.2f}x)",
              flush=True)
    return times


# bert-large's widths with 4 heads of 256 (PR 20): no public checkpoint has
# them; the config exists to drive the d = 256 kernels through Trainer and
# Predictor at full width (random weights from a seed).
WIDE_HEADS = "bert-large-4x256"
WIDE_HEADS_WIDTHS = dict(vocab_size=30522, hidden_size=1024,
                         num_hidden_layers=24, num_attention_heads=4,
                         intermediate_size=4096, max_position_embeddings=512)


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


TINYBERT_WARMUP, TINYBERT_STEPS = 1, 3
TINYBERT_SERVE = 2 * BATCH - 5  # two batches, the second ragged


def phase_tinybert():
    """TinyBERT-4L-312D's widths (head dim 26: the kernels instantiated at
    32, every head zero-padded from 26; ln_quant's generic form at H = 312)
    through :func:`phase_widths`."""
    return phase_widths(TINYBERT, "TinyBERT-4L-312D widths",
                        (26, 312, 30592, 1200, 0.1, 0.1))


def phase_wide_heads():
    """bert-large's widths with 4 heads of 256 (``WIDE_HEADS``: every
    attention kernel at head dim 256, bf16 short attention on the ring
    forwards and the tiled pair, flash2's forward and fused backward on
    wgmma) through :func:`phase_widths`."""
    return phase_widths(WIDE_HEADS, "bert-large widths at 4 heads of 256",
                        (256, 1024, 30592, 4096, 0.1, 0.1))


def phase_widths(model, label, want_widths):
    """The MMBert of ``model``'s widths (a ``BertConfig`` in
    ``build_experiment``'s MMBert; ``want_widths``: its head dim, H, padded
    vocab, FFN and dropouts) through the normal entry points at B = 96,
    L = 40, MOSI widths, random weights from a seed: 1 + 3 bf16
    ``Trainer.train_step`` steps at dropout 0.1 (finite losses, moved
    parameters, the launches a step by route), ``Predictor.predict_split``
    in bf16, int8 and int8_static (the launches a batch, samples/s), then
    frame level at Lp = 984 (flash2 at the model's head dim): one serving
    batch and one train step after a warm-up one.  Returns the launches of
    each path and the train and serving rates."""
    import numpy as np
    import torch

    from msa_tpu_torch.data import MultimodalDataset, synthetic_split
    from msa_tpu_torch.inference import Predictor
    from msa_tpu_torch.ops.short_attention import kernel_head_dim
    from msa_tpu_torch.training.trainer import Trainer

    exp = model_experiment(model, train_batch_size=BATCH,
                           compute_dtype="bfloat16", warmup_proportion=0.01,
                           adam_mu_dtype="bfloat16", adam_nu_dtype="bfloat16",
                           data_parallel=1)
    cfg = exp.model
    bert = cfg.bert
    d, layers = bert.head_dim, bert.num_hidden_layers
    if (d, bert.hidden_size, bert.padded_vocab_size, bert.intermediate_size,
            bert.hidden_dropout_prob, bert.attention_probs_dropout_prob) != \
            want_widths:
        raise AssertionError(f"{label}: {bert}")
    kd = kernel_head_dim(d)
    out, rates = {}, {}
    trainer = Trainer(exp, "cuda")
    state = trainer.init_state(0, total_steps=10_000)
    split = synthetic_split(2 * BATCH, TEXT_LEN, cfg.visual_dim, cfg.speech_dim,
                            vocab_size=bert.vocab_size, seed=4)
    batches = list(MultimodalDataset(split, seed=0).epoch_batches(
        0, BATCH, drop_last=True))
    watch = state.params["bert"]["layers"][0]["q"]["weight"]
    before = watch.detach().clone()
    for i in range(TINYBERT_WARMUP):
        state, metrics = trainer.train_step(state, batches[i % len(batches)], 1)
        float(metrics["loss"])
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    step_metrics = []
    for i in range(TINYBERT_STEPS):
        state, metrics = trainer.train_step(state, batches[i % len(batches)], 1)
        step_metrics.append(metrics)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    out["training"] = kernel_counts()
    want = rung_launches("none", layers, TINYBERT_STEPS, head_dim=d)
    if trainer.remat_policy != "none" or out["training"] != want:
        raise AssertionError(f"{label} training: remat {trainer.remat_policy}, "
                             f"launches {out['training']}, want {want}")
    losses = [float(m["loss"]) for m in step_metrics]
    moved = float((watch.detach() - before).abs().max())
    if not all(np.isfinite(losses)) or not moved > 0:
        raise AssertionError(f"{label} training: losses {losses}, max "
                             f"|update| {moved}")
    ms_step = seconds * 1e3 / TINYBERT_STEPS
    rates["training"] = (ms_step, BATCH * TINYBERT_STEPS / seconds)
    print(f"{label} (H={bert.hidden_size}, {bert.num_attention_heads}"
          f" heads of {d} on the instantiation at {kd}, {layers} layers, FFN "
          f"{bert.intermediate_size}, vocab {bert.padded_vocab_size}) training "
          f"bf16 B={BATCH} L={TEXT_LEN} dropout 0.1: {TINYBERT_STEPS} steps "
          f"after {TINYBERT_WARMUP} warm-up, {ms_step:.2f} ms/step, "
          f"{BATCH * TINYBERT_STEPS / seconds:.2f} samples/s; launches per "
          f"step (every one at head dim {d} on kD = {kd}) "
          f"{ {k: v // TINYBERT_STEPS for k, v in out['training'].items() if v} }; "
          f"losses {[round(x, 4) for x in losses]}", flush=True)
    params = state.params
    del state, trainer

    split = synthetic_split(TINYBERT_SERVE, TEXT_LEN, cfg.visual_dim,
                            cfg.speech_dim, vocab_size=bert.vocab_size, seed=5)
    calib = dataclasses.replace(split, **{
        f: getattr(split, f)[:BATCH] for f in (
            "input_ids", "attention_mask", "visual", "speech", "target")})
    n_batches = -(-TINYBERT_SERVE // BATCH)
    preds = {}
    for mode in (None, "int8", "int8_static"):
        pred = Predictor(exp, params, BATCH, "cuda", quantize=mode,
                         calibration=calib if mode == "int8_static" else None)
        pred.predict_split(split)  # warm
        reset_counts()
        t0 = time.perf_counter()
        got = pred.predict_split(split)
        seconds = time.perf_counter() - t0
        name = mode or "bf16"
        out[f"serving_{name}"] = kernel_counts()
        if out[f"serving_{name}"] != serving_launches(layers, n_batches, mode):
            raise AssertionError(f"{label} serving {name}: launches "
                                 f"{out[f'serving_{name}']}")
        if got.shape != (TINYBERT_SERVE,) or not np.isfinite(got).all():
            raise AssertionError(f"{label} serving {name}: {got.shape}")
        preds[name] = got
        rates[f"serving_{name}"] = TINYBERT_SERVE / seconds
        print(f"{label} serving {name} B={BATCH}: {TINYBERT_SERVE} "
              f"samples, {TINYBERT_SERVE / seconds:.2f} samples/s; launches "
              f"per batch {dict((k, v // n_batches) for k, v in out[f'serving_{name}'].items() if v)}"
              f"{' (ln_quant generic form)' if mode else ''}",
              flush=True)
    gap = max(float(np.abs(preds[m] - preds["bf16"]).max())
              for m in ("int8", "int8_static"))
    spread = float(np.ptp(preds["bf16"]))
    print(f"{label}: int8 / int8_static against bf16 max |diff| "
          f"{gap:.3e} (bf16 predictions spread {spread:.3e})", flush=True)
    if not gap < spread:
        raise AssertionError(f"{label}: int8 predictions off bf16 by {gap:.3e}, "
                             f"their spread {spread:.3e}")

    # frame level: the joint pass [2B, 1024] on flash2 at the head dim
    fexp = frame_experiment(FRAME_PAIR_LEN, model=model)
    fsplit = synthetic_split(FRAME_BATCH, TEXT_LEN, cfg.visual_dim,
                             cfg.speech_dim, vocab_size=bert.vocab_size, seed=8,
                             pair_seq_length=FRAME_PAIR_LEN)
    fpred = Predictor(fexp, params, FRAME_BATCH, "cuda")
    reset_counts()
    t0 = time.perf_counter()
    fout = fpred.predict_split(fsplit)
    seconds = time.perf_counter() - t0
    out["frame_serving"] = kernel_counts()
    fwant = expect_counts(short_attention=layers, flash_attention2=layers,
                          fused_joint_embed=2)
    if out["frame_serving"] != fwant or fout.shape != (FRAME_BATCH,) or \
            not np.isfinite(fout).all():
        raise AssertionError(f"{label} frame-level serving: launches "
                             f"{out['frame_serving']}, predictions {fout.shape}")
    print(f"{label} frame-level serving B={FRAME_BATCH} "
          f"Lp={FRAME_PAIR_LEN}: one batch in {seconds * 1e3:.1f} ms (the "
          f"first, unwarmed), launches {dict((k, v) for k, v in out['frame_serving'].items() if v)}",
          flush=True)
    del params, fpred
    # one measured step after one warm-up (the learning rate's warm-up
    # starts at 0, so a first step alone moves nothing)
    out["frame_training"], rates["frame_training"] = phase_frame_training(
        FRAME_PAIR_LEN, FRAME_BATCH, None, 1, 1, f"{label} frame-level",
        model=model)
    return out, rates


def phase_bert_base_preset():
    """JAX's ``bert-base-uncased`` preset (H = 768, 12 heads of 64, 12
    layers) end to end: ``cli.train --model bert-base-uncased`` for two
    steps on a synthetic MOSI split (launches a step as at bert-large), then
    the trained weights through the bf16 and int8 ``Predictor`` (launches a
    batch, finite predictions)."""
    import numpy as np

    from msa_tpu_torch.cli import train
    from msa_tpu_torch.data import synthetic_split
    from msa_tpu_torch.inference import Predictor

    batch = 32
    n_train = 2 * batch
    cwd = os.getcwd()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)  # the CLI logs under ./logs
        try:
            argv = ["--model", "bert-base-uncased", "--dataset", "mosi",
                    "--synthetic", str(n_train), "--n_epochs", "1",
                    "--train_batch_size", str(batch), "--val_batch_size",
                    str(batch), "--test_batch_size", str(batch),
                    "--checkpoint_root", os.path.join(tmp, "model_save"),
                    "--numpy_root", os.path.join(tmp, "numpy_save"),
                    "--device", "cuda"]
            reset_counts()
            trainer, state, result = train.run(
                train.build_parser().parse_args(argv))
            launches = kernel_counts()
        finally:
            os.chdir(cwd)
    fit_s = time.perf_counter() - t0
    exp = trainer.config
    bert = exp.model.bert
    layers = bert.num_hidden_layers
    if (bert.hidden_size, bert.head_dim, layers) != (768, 64, 12) or \
            state.step != 2:
        raise AssertionError(f"bert-base: H {bert.hidden_size}, head dim "
                             f"{bert.head_dim}, {layers} layers, {state.step} "
                             "steps")
    want = rung_launches("none", layers, state.step)
    evals = 2 * -(-(n_train // 8) // batch)
    want["short_attention"] += 2 * layers * evals
    want["fused_joint_embed"] += 2 * evals
    if launches != want:
        raise AssertionError(f"bert-base cli.train launches {launches}, want "
                             f"{want}")
    losses = [float(h["train"]["loss"]) for h in result.history]
    if not all(np.isfinite(losses)):
        raise AssertionError(f"bert-base cli.train: epoch losses {losses}")
    params = state.params
    del state, trainer
    n_serve = 2 * batch - 3
    split = synthetic_split(n_serve, TEXT_LEN, exp.model.visual_dim,
                            exp.model.speech_dim, vocab_size=bert.vocab_size,
                            seed=9)
    per_batch = {}
    for mode in (None, "int8"):
        pred = Predictor(exp, params, batch, "cuda", quantize=mode)
        reset_counts()
        got = pred.predict_split(split)
        counts = kernel_counts()
        if counts != serving_launches(layers, 2, mode):
            raise AssertionError(f"bert-base serving {mode}: launches {counts}")
        if got.shape != (n_serve,) or not np.isfinite(got).all():
            raise AssertionError(f"bert-base serving {mode}: {got.shape}")
        per_batch[mode or "bf16"] = {k: v // 2 for k, v in counts.items() if v}
    print(f"bert-base-uncased preset: cli.train 2 steps at B={batch} and its "
          f"eval passes in {fit_s:.1f} s (epoch losses {losses}), launches "
          f"{dict((k, v) for k, v in launches.items() if v)}; served {n_serve} "
          f"samples in bf16 / int8, launches per batch {per_batch}", flush=True)
    return launches


ORBAX_FIXTURE = os.path.join("tests", "data", "orbax_two_process")
ORBAX_RATE_BYTES = 256 << 20  # decoded bytes a decode-rate run covers
ORBAX_CHUNK = os.path.join("tests", "data", "zstd_chunk")


def resume_orbax_step(directory, exp, device, batch):
    """The calls ``cli.train --resume`` makes (``cli/train.py``), then one
    train step: (loss, the updated parameters, the kernels' launches in
    the step)."""
    from msa_tpu_torch.training.checkpoint import load_checkpoint
    from msa_tpu_torch.training.trainer import Trainer

    trainer = Trainer(exp, device, mask_token_id=4, special_ids=(0, 2, 3, 4))
    loaded, _ = load_checkpoint(directory, trainer.device)
    state = trainer.init_state(exp.train.seed, 10, params=loaded.params)
    state.opt_state = trainer.local_opt_state(loaded.opt_state)
    state.step = loaded.step
    reset_counts()
    state, metrics = trainer.train_step(state, batch, base_seed=1)
    loss = float(metrics["loss"])
    return loss, state.params, kernel_counts()


def phase_orbax(device="cuda"):
    """The JAX package's sharded orbax checkpoint of a two-process run
    (``tests/data/orbax_two_process``, written by
    ``scripts/make_orbax_fixture.py``: dp = 2 x mp = 2, H = 64 with head
    dim 32, bf16 moments) through the port's own reader: the zstd decoder
    built with the host compiler, every leaf's SHA-256 held to
    ``digests.json`` (JAX's restore of it) and the decode rate with one
    thread and with the pool, on the fixture's small chunks and on the
    committed chunk of a large leaf (``tests/data/zstd_chunk``, written by
    ``scripts/make_zstd_chunk.py``: one frame of eight compressed blocks,
    held to its SHA-256); then resumed on the card for one train step
    through the calls ``cli.train --resume`` makes, and served through
    ``Predictor.from_checkpoint``, the loss, the updated parameters and the
    predictions bit-equal to the same from the port's msgpack re-save of
    the state it read.  Returns the launches of the resumed step and of
    the serving pass."""
    import hashlib

    import numpy as np
    import torch

    from msa_tpu_torch import _build
    from msa_tpu_torch.data import MultimodalDataset, synthetic_split
    from msa_tpu_torch.inference import Predictor
    from msa_tpu_torch.models.weights import named_leaves
    from msa_tpu_torch.training import orbax_reader, zstd
    from msa_tpu_torch.training.checkpoint import (
        load_checkpoint, load_config, save_checkpoint)
    from msa_tpu_torch.training.ocdbt import KvStore, Ref

    build_s = {}
    t0 = time.perf_counter()
    _build.build_all(["zstd_decode"], seconds=build_s)
    build_wall = time.perf_counter() - t0
    directory = os.path.join(ORBAX_FIXTURE, "epoch_000")
    orbax = os.path.join(directory, "orbax")
    with open(os.path.join(ORBAX_FIXTURE, "digests.json")) as f:
        want = json.load(f)
    t0 = time.perf_counter()
    tree = orbax_reader.read_state(orbax)
    read_s = time.perf_counter() - t0

    def digests(node, path=()):
        if isinstance(node, dict):
            return {k: v for key, child in node.items()
                    for k, v in digests(child, path + (key,)).items()}
        data = (node.view(torch.int16).numpy() if isinstance(
            node, torch.Tensor) else np.ascontiguousarray(node)).tobytes()
        return {"/".join(path): hashlib.sha256(data).hexdigest()}

    got = digests(tree)
    if got != want["leaves"]:
        bad = sorted(k for k in set(got) | set(want["leaves"])
                     if got.get(k) != want["leaves"].get(k))
        raise AssertionError(f"orbax: {len(bad)} leaves differ from JAX's "
                             f"restore: {bad[:5]}")

    # the decode rate: every chunk frame of the store, and the committed
    # chunk of a large leaf (one frame of eight 128 KiB blocks), each
    # repeated to ORBAX_RATE_BYTES decoded, into a destination of its own
    store = KvStore(orbax)
    frames, sizes = [], []
    for key in store.keys():
        if key.endswith("/.zarray"):
            spec = json.loads(store.read(key))
            chunk = spec["chunks"]
            nbytes = int(np.prod(chunk, dtype=np.int64)) * (
                2 if spec["dtype"] == "bfloat16" else
                np.dtype(spec["dtype"]).itemsize)
            for ck in store.keys(key[:-len(".zarray")]):
                if not ck.endswith("/.zarray"):
                    value = store.locate(ck)
                    frames.append(bytes(store.read_refs([value])[0])
                                  if isinstance(value, Ref) else value)
                    sizes.append(nbytes)
    with open(os.path.join(ORBAX_CHUNK, "chunk.json")) as f:
        large = json.load(f)
    with open(os.path.join(ORBAX_CHUNK, "chunk.zst"), "rb") as f:
        large_frame = f.read()
    inputs = {}
    for label, base, base_sizes in (
            ("chunks", frames, sizes),
            ("large", [large_frame], [large["decoded_bytes"]])):
        copies = max(1, ORBAX_RATE_BYTES // sum(base_sizes))
        inputs[label] = (base * copies, [np.empty(n, np.uint8) for n in
                                         base_sizes * copies], copies)
    rates = {}
    for label, (srcs, outs, _) in inputs.items():
        for threads in (1, zstd.THREADS):
            zstd.decompress(srcs[:8], outs=outs[:8], threads=threads)
            t0 = time.perf_counter()
            zstd.decompress(srcs, outs=outs, threads=threads)
            rates[label, threads] = sum(o.size for o in outs) / (
                time.perf_counter() - t0) / 1e6
    large_outs = inputs["large"][1]
    for out in (large_outs[0], large_outs[-1]):
        if hashlib.sha256(out.tobytes()).hexdigest() != large["sha256"]:
            raise AssertionError("orbax: the large chunk decodes wrong")
    del inputs, large_outs

    # resume and serve, from the orbax directory and from a msgpack re-save
    config = load_config(directory)
    exp = dataclasses.replace(config, train=dataclasses.replace(
        config.train, data_parallel=1, model_parallel=1))
    split = synthetic_split(16, exp.data.max_seq_length,
                            exp.model.visual_dim, exp.model.speech_dim,
                            vocab_size=exp.model.bert.vocab_size, seed=4)
    batch = next(MultimodalDataset(split, seed=0).epoch_batches(0, 8))
    with tempfile.TemporaryDirectory() as tmp:
        state, meta = load_checkpoint(directory, "cpu")
        resaved = os.path.join(tmp, "epoch_000")
        save_checkpoint(resaved, state, config, epoch=int(meta["epoch"]))
        runs = {form: resume_orbax_step(path, exp, device, batch)
                for form, path in (("orbax", directory),
                                   ("msgpack", resaved))}
        preds, serving = {}, {}
        for form, path in (("orbax", directory), ("msgpack", resaved)):
            pred = Predictor.from_checkpoint(path, batch_size=8,
                                             device=device)
            reset_counts()
            preds[form] = pred.predict_split(split)
            serving[form] = kernel_counts()
    (loss, params, launches), (ref_loss, ref_params, _) = \
        runs["orbax"], runs["msgpack"]
    ref = dict(named_leaves(ref_params))
    differ = [k for k, v in named_leaves(params)
              if not torch.equal(v, ref[k])]
    if loss != ref_loss or differ or not np.isfinite(loss):
        raise AssertionError(f"orbax resume: loss {loss} against {ref_loss}, "
                             f"{len(differ)} leaves differ ({differ[:3]})")
    if not np.array_equal(preds["orbax"], preds["msgpack"]) or \
            not np.isfinite(preds["orbax"]).all():
        raise AssertionError(f"orbax serving: {preds['orbax'][:4]} against "
                             f"{preds['msgpack'][:4]}")
    print(f"orbax: {len(got)} leaves of the two-process checkpoint equal "
          f"JAX's restore (SHA-256), read in {read_s:.3f} s; decoder build "
          f"{build_wall:.1f} s; resumed step loss {loss!r} and "
          f"{len(ref)} updated leaves bit-equal to the msgpack re-save's, "
          f"{len(split)} predictions bit-equal", flush=True)
    n = zstd.THREADS
    print(f"orbax zstd decode rate (MB/s of decoded output, one thread / "
          f"{n} threads, {os.cpu_count()} CPUs, {ORBAX_RATE_BYTES >> 20} MiB "
          f"decoded each): the fixture's {len(frames)} chunk frames "
          f"({sum(sizes)} B) repeated {rates['chunks', 1]:.1f} / "
          f"{rates['chunks', n]:.1f}; a large leaf's chunk (one frame of "
          f"{large['decoded_bytes']} B, {len(large_frame)} B compressed) "
          f"repeated {rates['large', 1]:.1f} / {rates['large', n]:.1f}",
          flush=True)
    return {"training": launches, "serving": serving["orbax"]}


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
            "short_attention_v1_backward": short_attention_v1_backward,
            # the backwards' launches on the tiled route (bf16 above 128 keys)
            **{f"{name}_tiled": fn.tiled for name, fn in (
                ("short_attention_backward", short_attention_backward),
                ("short_attention_v3_backward", short_attention_v3_backward),
                ("short_attention_probs_backward",
                 short_attention_probs_backward),
                ("short_attention_packed_backward",
                 short_attention_packed_backward))}}


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
    """MMBert (bert-large, the preset ``model``, or ``TINYBERT``'s or
    ``WIDE_HEADS``' widths) on MOSI widths in frame-level mode (``pair_len`` native-rate frames per
    modality), depth cut to ``layers`` if given."""
    exp = model_experiment(model, **train)
    data = dataclasses.replace(exp.data, pair_seq_length=pair_len)
    bert = exp.model.bert
    if layers is not None:
        bert = dataclasses.replace(bert, num_hidden_layers=layers)
    return dataclasses.replace(exp, data=data, model=dataclasses.replace(
        exp.model, bert=bert))


# TinyBERT General 4L-312D's widths (huawei-noah/TinyBERT_General_4L_312D's
# config: hidden 312, 12 heads -- head dim 26 --, 4 layers, FFN 1200, vocab
# 30522, padded to 30592, 512 positions), run with random weights from a
# seed: nothing is downloaded.
TINYBERT = "tinybert-4l-312d"
TINYBERT_WIDTHS = dict(vocab_size=30522, hidden_size=312, num_hidden_layers=4,
                       num_attention_heads=12, intermediate_size=1200,
                       max_position_embeddings=512)


def model_experiment(model, **train):
    """``build_experiment``'s MMBert on MOSI widths with the BERT preset
    ``model``, or with ``TINYBERT``'s or ``WIDE_HEADS``' widths as its
    BertConfig (on the training defaults of bert-base and bert-large)."""
    from msa_tpu_torch.configs import BertConfig, build_experiment

    widths = {TINYBERT: ("bert-base-uncased", TINYBERT_WIDTHS),
              WIDE_HEADS: ("bert-large-uncased", WIDE_HEADS_WIDTHS)}
    if model not in widths:
        return build_experiment("mosi", model, num_labels=1, **train)
    preset, bert = widths[model]
    exp = build_experiment("mosi", preset, num_labels=1, **train)
    return dataclasses.replace(exp, model_name=model, model=dataclasses.replace(
        exp.model, bert=BertConfig(**bert)))


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
                         model="bert-large-uncased"):  # or TINYBERT, WIDE_HEADS
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
    want = rung_launches("none", n, steps, frame=True, fused=fused,
                         head_dim=cfg.bert.head_dim)
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

    dname = str(q.dtype).split(".")[1]
    t = rate
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
    template).  Then the packed pair at [8, 130] (bf16: the tiled backward
    route) and the bf16 v2s forward (tensor cores) at the shapes that reach
    its other forms: S = 12 (one ragged 16-key tile), 128 (the widest
    whole-row form) and 200, 1000 (the two-sweep form, with query tiles and
    a ragged last key tile), each from a generator of its own; at S = 12,
    128 and 200 also row 5's backward from those probs, rate 0 and with
    dropout (one ragged tile and the widest one-launch form; at 200 the
    tiled pair).  Times the kernels at rate 0 beside the plain
    versions, SDPA and the bound."""
    import torch
    import torch.nn.functional as F

    from msa_tpu_torch.ops import short_attention as sa

    rate_on = phase_rate()
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
                fwd_cores = ("tensor cores" if dname == "bfloat16"
                             else "CUDA cores")
                cores_of = {"probs": fwd_cores, "packed": fwd_cores,
                            "probs_bwd": sa.backward_route(s, dtype, HIDDEN // HEADS),
                            "packed_bwd": sa.backward_route(s, dtype, HIDDEN // HEADS)}
                for name in ("probs", "probs_bwd", "packed", "packed_bwd"):
                    ms, plain_ms, lib_ms, bound = times[(name, label, dname)]
                    cores = cores_of[name]
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
            print(f"v2p {tag} (backward: {sa.backward_route(130, dtype, HIDDEN // HEADS)}): "
                  f"forward bit-equal "
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
            if s <= 200:  # the backward's one-tile, widest and tiled forms
                dout = torch.randn(4, s, HIDDEN, device="cuda",
                                   generator=dout_gen).to(torch.bfloat16)
                berr, bauto = check_probs_backward(tag, q, k, v, bias, live,
                                                   probs, dout, rate, keep)
                worst["probs_bwd"] = max(worst["probs_bwd"], berr)
                cores = sa.backward_route(s, torch.bfloat16, HIDDEN // HEADS)
                line += (f"; backward ({cores}) {berr:.3e} against the rounded "
                         f"rule, {bauto:.3e} against f32 autograd")
            print(line, flush=True)
    return worst, times


def rung_launches(policy, layers, steps, frame=False, fused=True,
                  head_dim=64):
    """Kernel launches of ``steps`` bf16 train steps under the remat
    ``policy`` ("none": no checkpointing): one attention per layer and
    encoder call, run again in the backward by 'full' and 'dots' (their
    regions recompute it); '+probs' runs the v2s pair and 'save_pack' the
    packed pair on the short route (all of it word-aligned; the text pass
    in frame-level mode, whose joint pass runs flash2, never re-run under a
    save_* policy).  The v2, v2p and v2s backwards take one launch at S <=
    128 in bf16 at head dims up to 128, else the tiled pair, counted on
    ``<entry>_tiled`` too (``head_dim``: the model's, bert-large's 64
    unless given)."""
    import torch

    from msa_tpu_torch.ops.short_attention import (
        TILED, backward_launches, backward_route)

    again = 2 if policy.split("+")[0] in ("full", "dots") else 1
    seqs = (TEXT_LEN,) if frame else (TEXT_LEN, 2 * TEXT_LEN)
    short_calls = layers * len(seqs)
    bwd = layers * sum(backward_launches(s, torch.bfloat16, head_dim)
                       for s in seqs)
    tiled = layers * sum(backward_launches(s, torch.bfloat16, head_dim)
                         for s in seqs
                         if backward_route(s, torch.bfloat16, head_dim) == TILED)
    counts = {"fused_joint_embed": 2}
    if "+probs" in policy:
        counts.update(short_attention_probs=again * short_calls,
                      short_attention_probs_backward=bwd,
                      short_attention_probs_backward_tiled=tiled)
    elif policy == "save_pack":
        counts.update(short_attention_packed=short_calls,
                      short_attention_packed_backward=bwd,
                      short_attention_packed_backward_tiled=tiled)
    else:
        counts.update(short_attention=again * short_calls,
                      short_attention_backward=bwd,
                      short_attention_backward_tiled=tiled)
    if frame:  # either flash2 backward route is two launches a layer
        counts.update(flash_attention2=again * layers,
                      flash2_bwd_fused=2 * layers if fused else 0,
                      flash2_bwd_split=0 if fused else 2 * layers)
    return expect_counts(**{k: v * steps for k, v in counts.items()})


def train_run(exp, params, batches, warmup, steps, label, keep=None):
    """``warmup`` + ``steps`` train steps of ``exp`` from ``params`` (the
    same batches and seed for every caller): the losses, ms/step over the
    timed steps, peak memory, the bytes autograd keeps for the backward (by
    storage, in the warm-up steps; the bf16 weight copies included), the
    kernel launches of the timed steps and the trainer's remat policy; and
    the parameter leaves named in ``keep`` after the last step (on the
    CPU, by name)."""
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
    kept = None
    if keep is not None:
        from msa_tpu_torch.models.weights import named_leaves
        leaves = dict(named_leaves(state.params))
        kept = {k: leaves[k].detach().cpu() for k in keep}
    del state, trainer
    torch.cuda.empty_cache()
    return {"losses": losses, "ms_step": seconds * 1e3 / steps, "kept": kept,
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
    """One v3 backward case: the kernel (bf16 on the tensor cores: one
    launch at S <= 128, else the tiled pair; f32 the CUDA-core pair) against
    its plain rule with the kernel's
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

    b, s, _ = q.shape
    dname = str(q.dtype).split(".")[1]
    atol, rtol = GRAD_TOL[dname]
    t = rate
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
    # the C entry once more (on the head dim's library, its heads padded as
    # the wrapper pads them), keeping its scratch: the recomputed lse
    pad = sa.HeadPad(HIDDEN, HEADS)
    padded = [pad.pad(x).contiguous() for x in (q, k, v)]
    scratch = [torch.empty_like(lse) for _ in range(2)]
    grads = [torch.empty_like(padded[0]) for _ in range(3)]
    _build.check(pad.library("short_attention", sa._SIGNATURES)
                 .msa_short_attention_v3_bwd(
                     *(x.data_ptr() for x in (
                         *padded, bias, pad.pad(out).contiguous(),
                         pad.pad(dout).contiguous(), *scratch, *grads)),
                     b, s, pad.hidden, HEADS, sa._DTYPES[q.dtype], pad.scale,
                     *sa._seed_words(seed), t, sa._stream(q)),
                 "v3 scratch check")
    grads = [pad.cut(g) for g in grads]
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

    rate_on = phase_rate()
    worst, times = 0.0, {}
    for label, b, s in (("text", BATCH, TEXT_LEN),
                        ("joint", 2 * BATCH, 2 * TEXT_LEN)):
        for dtype in (torch.bfloat16, torch.float32):
            dname = str(dtype).split(".")[1]
            atol, rtol = GRAD_TOL[dname]
            cores = sa.backward_route(s, dtype, HIDDEN // HEADS)
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
        cores = sa.backward_route(s, torch.bfloat16, HIDDEN // HEADS)
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


# the frame-level path on the short kernels: Lp = 500 frames beside L = 40
# tokens (the visual frame length of the unaligned CMU-MOSI / MOSEI data),
# joint pass [2B, 540], which `auto` sends to the short kernels (S < 1024)
FRAME_SHORT_LEN = 500
FRAME_SHORT_WARMUP, FRAME_SHORT_STEPS = 1, 3
FRAME_SHORT_REF_LAYERS = 4  # the plain-attention reference's depth
# the bf16 short backwards above 128 keys: the shapes timed (parent and
# tree alike, --short-times) and the edges held against the rounded rules
TILED_TIMING_SHAPES = ((8, 130), (4, 512), (4, 768),
                       (2 * FRAME_BATCH, TEXT_LEN + FRAME_SHORT_LEN))
TILED_EDGE_SHAPES = ((4, 129), (4, 200), (2, 1023),
                     (2 * FRAME_BATCH, TEXT_LEN + FRAME_SHORT_LEN))
TILED_ENTRIES = ("short_attention_backward", "short_attention_v3_backward",
                 "short_attention_probs_backward",
                 "short_attention_packed_backward")


def tiled_backward_bound(b, s, dtype, rule):
    """(ms, what bounds it) of one short backward at [b, s, HIDDEN] by
    ``rule`` (v2, v3, v2s, v2p): it reads q, k, v and dO once (v3, v2p also
    o; v2s the [B, heads, S, S] probs instead of the bias) and writes dq,
    dk, dv; the products are the scores (recomputed: p is not an input;
    none for v2s), dP, dV, dQ and dK."""
    import torch

    it = torch.tensor([], dtype=dtype).element_size()
    io = b * s * HIDDEN * it
    flops = 2 * b * s * s * HIDDEN
    dname = str(dtype).split(".")[1]
    if rule == "v2s":
        return bound_ms(7 * io + b * HEADS * s * s * it, 4 * flops, dname)
    return bound_ms((8 if rule in ("v3", "v2p") else 7) * io + b * s * 4,
                    5 * flops, dname)


def time_short_backwards(with_plain=False):
    """Device ms of the bf16 short backwards v2, v3, v2s and v2p (rows 3-6)
    at TILED_TIMING_SHAPES, rate 0 and the training dropout, each from its
    own forward's outputs (v2: the training forward's lse), with SDPA's
    backward at rate 0 and the bound; ``with_plain``: also each plain rule
    at rate 0.  It calls only entry points every tree of the port has had
    since row 6's backward moved to the tensor cores, so ``--short-times
    ROOT`` times another checkout's kernels by this code.  Prints and
    returns {label: ms}."""
    import torch
    import torch.nn.functional as F

    from msa_tpu_torch.ops import short_attention as sa
    from msa_tpu_torch.ops.dropout import quantize_dropout_rate

    gen = torch.Generator(device="cuda").manual_seed(17)
    times = {}
    for b, s in TILED_TIMING_SHAPES:
        q, k, v, dout = (torch.randn(b, s, HIDDEN, device="cuda",
                                     generator=gen).to(torch.bfloat16)
                         for _ in range(4))
        bias = torch.zeros(b, s, device="cuda")
        qkv = torch.cat([q, k, v], dim=-1)
        shape = f"[{b},{s}]"
        for rate in (0.0, quantize_dropout_rate(ATTN_DROPOUT)):
            t = rate
            out, lse = sa._forward_kernel(q, k, v, bias, HEADS, 7, t, True)
            pout = sa._packed_forward_kernel(qkv, bias, HEADS, 7, t, False)[0]
            _, probs = sa._probs_forward_kernel(q, k, v, bias, HEADS, 7, rate)
            runs = {
                "v2": lambda: sa.short_attention_backward(
                    q, k, v, bias, lse, dout, HEADS, 7, rate),
                "v3": lambda: sa.short_attention_v3_backward(
                    q, k, v, bias, out, dout, HEADS, 7, rate),
                "v2s": lambda: sa.short_attention_probs_backward(
                    q, k, v, probs, dout, HEADS, rate),
                "v2p": lambda: sa.short_attention_packed_backward(
                    qkv, bias, pout, dout, HEADS, 7, rate)}
            for rule, fn in runs.items():
                times[f"{rule} {shape} rate {rate:g}"] = cuda_ms(fn, iters=10)
        qq, kk, vv = (x.detach().requires_grad_() for x in (q, k, v))
        sq, sk, sv, sm = sdpa_args(qq, kk, vv, bias)
        lib_out = F.scaled_dot_product_attention(sq, sk, sv, attn_mask=sm)
        lib_do = dout.view(b, s, HEADS, -1).transpose(1, 2)
        times[f"sdpa bwd {shape}"] = cuda_ms(lambda: torch.autograd.grad(
            lib_out, (qq, kk, vv), lib_do, retain_graph=True), iters=10)
        if with_plain:
            out, _ = sa._forward_kernel(q, k, v, bias, HEADS, 7, 0, True)
            _, probs = sa._probs_forward_kernel(q, k, v, bias, HEADS, 7, 0.0)
            plains = {
                "v2": lambda: sa.short_attention_v1_backward_plain(
                    q, k, v, bias, dout, HEADS),
                "v3": lambda: sa.short_attention_v3_backward_plain(
                    q, k, v, bias, out, dout, HEADS),
                "v2s": lambda: sa.short_attention_probs_backward_plain(
                    q, k, v, probs, dout, HEADS),
                "v2p": lambda: sa.short_attention_packed_backward_plain(
                    qkv, bias, dout, HEADS, out=out)}
            for rule, fn in plains.items():
                times[f"{rule} plain {shape}"] = cuda_ms(fn, iters=3)
        del q, k, v, dout, qkv, qq, kk, vv, lib_out, probs
        torch.cuda.empty_cache()
    print(f"bf16 short backwards (v2, v3, v2s, v2p) at "
          f"{[list(x) for x in TILED_TIMING_SHAPES]} x {HIDDEN} ({HEADS} "
          f"heads), ms: {json.dumps(times)}", flush=True)
    return times


def frame_short_experiment(layers=None, attention_dropout=None, **train):
    """bert-large (or ``layers`` of it) in frame-level mode at Lp =
    FRAME_SHORT_LEN, B = FRAME_BATCH, bf16, bf16 Adam moments, the default
    route and dropouts (``attention_dropout``: another attention-probs
    rate; ``train``: more build_experiment arguments, e.g.
    ``use_flash_attention``)."""
    exp = frame_experiment(FRAME_SHORT_LEN, layers, train_batch_size=FRAME_BATCH,
                           compute_dtype="bfloat16", warmup_proportion=0.01,
                           adam_mu_dtype="bfloat16", adam_nu_dtype="bfloat16",
                           data_parallel=1, **train)
    if attention_dropout is None:
        return exp
    return dataclasses.replace(exp, model=dataclasses.replace(
        exp.model, bert=dataclasses.replace(
            exp.model.bert, attention_probs_dropout_prob=attention_dropout)))


def frame_short_inputs(exp, seed=5):
    """Weights from ``seed`` and two batches of a synthetic frame-level
    split for ``exp``."""
    import torch

    from msa_tpu_torch.data import MultimodalDataset, synthetic_split
    from msa_tpu_torch.models.weights import init_params

    cfg = exp.model
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(seed))
    split = synthetic_split(2 * FRAME_BATCH, TEXT_LEN, cfg.visual_dim,
                            cfg.speech_dim, vocab_size=cfg.bert.vocab_size,
                            seed=8, pair_seq_length=FRAME_SHORT_LEN)
    batches = list(MultimodalDataset(split, seed=0).epoch_batches(
        0, FRAME_BATCH, drop_last=True))
    return params, batches


def frame_short_step_ms():
    """ms/step of FRAME_SHORT_WARMUP + FRAME_SHORT_STEPS bf16 train steps of
    bert-large at Lp = FRAME_SHORT_LEN (host clock around synchronised
    steps) and the losses: entry points every tree of the port has, for
    ``--short-times ROOT``."""
    import torch

    from msa_tpu_torch.training.trainer import Trainer

    exp = frame_short_experiment()
    params, batches = frame_short_inputs(exp)
    trainer = Trainer(exp, "cuda")
    state = trainer.init_state(0, total_steps=10_000, params=params)
    losses = []
    for i in range(FRAME_SHORT_WARMUP):
        state, m = trainer.train_step(state, batches[i % len(batches)], 1)
        losses.append(float(m["loss"]))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    metrics = []
    for i in range(FRAME_SHORT_WARMUP, FRAME_SHORT_WARMUP + FRAME_SHORT_STEPS):
        state, m = trainer.train_step(state, batches[i % len(batches)], 1)
        metrics.append(m)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / FRAME_SHORT_STEPS
    losses += [float(m["loss"]) for m in metrics]
    print(f"frame-level training bf16 bert-large B={FRAME_BATCH} L={TEXT_LEN} "
          f"Lp={FRAME_SHORT_LEN} (joint pass [{2 * FRAME_BATCH},"
          f"{TEXT_LEN + FRAME_SHORT_LEN}]): {ms:.2f} ms/step over "
          f"{FRAME_SHORT_STEPS} steps after {FRAME_SHORT_WARMUP}; losses "
          f"{[round(x, 5) for x in losses]}", flush=True)
    return ms, losses


def time_wide_short():
    """Device ms of the bf16 short entries at head dim 256 (``WIDE_HEADS``'
    H = 1024 in 4 heads) at the joint pass [2B, 2L] and the Lp = 500 joint
    pass [32, 540], rate 0 and the training dropout: the v2 forward's
    serving and training forms, v2p, v2s and v1 forwards, the v2, v3, v2s,
    v2p and v1 backwards (each from its own forward's outputs), and SDPA's
    forward and backward at rate 0.  Entry points every tree of the port
    has had since head dim 256 came in, so ``--short-times ROOT`` times
    another checkout's kernels by this code.  Prints and returns {label:
    ms}."""
    times = {}
    with head_widths(WIDE_HEADS_WIDTHS["hidden_size"],
                     WIDE_HEADS_WIDTHS["num_attention_heads"]):
        for b, s in ((2 * BATCH, 2 * TEXT_LEN),
                     (2 * FRAME_BATCH, TEXT_LEN + FRAME_SHORT_LEN)):
            times.update(time_wide_short_at(b, s))
    print(f"bf16 short entries at head dim 256 (H = 1024, 4 heads), ms: "
          f"{json.dumps(times)}", flush=True)
    return times


def time_wide_short_at(b, s):
    """:func:`time_wide_short` at [b, s]."""
    import torch
    import torch.nn.functional as F

    from msa_tpu_torch.ops import short_attention as sa
    from msa_tpu_torch.ops.dropout import quantize_dropout_rate

    times = {}
    gen = torch.Generator(device="cuda").manual_seed(23)
    q, k, v, dout = (torch.randn(b, s, HIDDEN, device="cuda",
                                 generator=gen).to(torch.bfloat16)
                     for _ in range(4))
    bias = torch.zeros(b, s, device="cuda")
    qkv = torch.cat([q, k, v], dim=-1)
    for rate in (0.0, quantize_dropout_rate(ATTN_DROPOUT)):
        out, lse = sa._forward_kernel(q, k, v, bias, HEADS, 7, rate, True)
        pout = sa._packed_forward_kernel(qkv, bias, HEADS, 7, rate,
                                         False)[0]
        _, probs = sa._probs_forward_kernel(q, k, v, bias, HEADS, 7, rate)
        runs = {
            "v2 fwd": lambda: sa._forward_kernel(q, k, v, bias, HEADS, 7,
                                                 rate, False),
            "v2 fwd train": lambda: sa._forward_kernel(
                q, k, v, bias, HEADS, 7, rate, True),
            "v2p fwd": lambda: sa._packed_forward_kernel(
                qkv, bias, HEADS, 7, rate, False),
            "v2s fwd": lambda: sa._probs_forward_kernel(
                q, k, v, bias, HEADS, 7, rate),
            "v1 fwd": lambda: sa._v1_forward_kernel(q, k, v, bias, HEADS,
                                                    7, rate),
            "v2 bwd": lambda: sa.short_attention_backward(
                q, k, v, bias, lse, dout, HEADS, 7, rate),
            "v3 bwd": lambda: sa.short_attention_v3_backward(
                q, k, v, bias, out, dout, HEADS, 7, rate),
            "v2s bwd": lambda: sa.short_attention_probs_backward(
                q, k, v, probs, dout, HEADS, rate),
            "v2p bwd": lambda: sa.short_attention_packed_backward(
                qkv, bias, pout, dout, HEADS, 7, rate),
            "v1 bwd": lambda: sa.short_attention_v1_backward(
                q, k, v, bias, dout, HEADS, 7, rate)}
        for name, fn in runs.items():
            times[f"d256 {name} [{b},{s}] rate {rate:g}"] = cuda_ms(
                fn, iters=10)
    qq, kk, vv = (x.detach().requires_grad_() for x in (q, k, v))
    sq, sk, sv, sm = sdpa_args(qq, kk, vv, bias)
    lib_out = F.scaled_dot_product_attention(sq, sk, sv, attn_mask=sm)
    lib_do = dout.view(b, s, HEADS, -1).transpose(1, 2)
    times[f"d256 sdpa fwd [{b},{s}]"] = cuda_ms(
        lambda: F.scaled_dot_product_attention(sq, sk, sv, attn_mask=sm),
        iters=10)
    times[f"d256 sdpa bwd [{b},{s}]"] = cuda_ms(lambda: torch.autograd.grad(
        lib_out, (qq, kk, vv), lib_do, retain_graph=True), iters=10)
    return times


def wide_heads_step_ms():
    """ms/step of TINYBERT_STEPS bf16 train steps (after TINYBERT_WARMUP) of
    bert-large's widths at 4 heads of 256 (``WIDE_HEADS``) at B = 96, L =
    40, dropout 0.1, as :func:`phase_widths` trains it (host clock around
    synchronised steps), and the losses: entry points every tree of the
    port has had since head dim 256 came in, for ``--short-times ROOT``."""
    import torch

    from msa_tpu_torch.data import MultimodalDataset, synthetic_split
    from msa_tpu_torch.training.trainer import Trainer

    exp = model_experiment(WIDE_HEADS, train_batch_size=BATCH,
                           compute_dtype="bfloat16", warmup_proportion=0.01,
                           adam_mu_dtype="bfloat16", adam_nu_dtype="bfloat16",
                           data_parallel=1)
    cfg = exp.model
    trainer = Trainer(exp, "cuda")
    state = trainer.init_state(0, total_steps=10_000)
    split = synthetic_split(2 * BATCH, TEXT_LEN, cfg.visual_dim, cfg.speech_dim,
                            vocab_size=cfg.bert.vocab_size, seed=4)
    batches = list(MultimodalDataset(split, seed=0).epoch_batches(
        0, BATCH, drop_last=True))
    losses = []
    for i in range(TINYBERT_WARMUP):
        state, m = trainer.train_step(state, batches[i % len(batches)], 1)
        losses.append(float(m["loss"]))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    metrics = []
    for i in range(TINYBERT_STEPS):
        state, m = trainer.train_step(state, batches[i % len(batches)], 1)
        metrics.append(m)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / TINYBERT_STEPS
    losses += [float(m["loss"]) for m in metrics]
    print(f"{WIDE_HEADS} training bf16 B={BATCH} L={TEXT_LEN}: {ms:.2f} "
          f"ms/step over {TINYBERT_STEPS} steps after {TINYBERT_WARMUP}; "
          f"losses {[round(x, 5) for x in losses]}", flush=True)
    return ms, losses


def time_short_path():
    """``--short-times ROOT``: the short backwards (:func:`time_short_backwards`),
    the Lp = 500 frame step (:func:`frame_short_step_ms`), the entries at
    head dim 256 (:func:`time_wide_short`) and the 4-heads-of-256 step
    (:func:`wide_heads_step_ms`) of the tree on sys.path, whose kernels
    build into its own build/."""
    from msa_tpu_torch import _build

    t0 = time.perf_counter()
    seconds = {}
    _build.build_all(seconds=seconds)
    print(f"kernel build {time.perf_counter() - t0:.1f} s (nvcc s "
          f"{ {k: round(v, 1) for k, v in seconds.items()} })", flush=True)
    times = time_short_backwards()
    times["frame step Lp=500"] = frame_short_step_ms()[0]
    times.update(time_wide_short())
    times["wide heads step"] = wide_heads_step_ms()[0]
    return times


def check_v2_backward(tag, q, k, v, bias, live, dout, seed, rate, keep):
    """The v2 backward through autograd of ``short_attention`` (its forward
    form and the tensors its route keeps), held by
    :func:`check_rounded_backward` against JAX's ``_bwd_kernel_v2`` rule
    (given the exported keep mask; in bf16 dv within :func:`tie_slack` of
    it, after the gap between the rule's p and exp2(s - lse) on the
    training forward's lse is found within TIE_RTOL) and against autograd
    through the plain version in f32.  Returns (max abs err, against
    autograd)."""
    import torch

    from msa_tpu_torch.ops import short_attention as sa

    qq, kk, vv = (x.detach().requires_grad_() for x in (q, k, v))
    grads = torch.autograd.grad(
        sa.short_attention(qq, kk, vv, bias, HEADS, rate, seed), (qq, kk, vv),
        dout)
    wide = [x.detach().float().requires_grad_() for x in (q, k, v)]
    auto = torch.autograd.grad(sa.short_attention_plain(
        *wide, bias, HEADS, rate, keep), wide, dout.float())
    rule = sa.short_attention_v1_backward_plain(q, k, v, bias, dout, HEADS,
                                                rate, keep)
    rule32 = sa.short_attention_v1_backward_plain(
        *wide, bias, dout.float(), HEADS, rate, keep)
    slack = None
    if q.dtype == torch.bfloat16:
        lse = sa._forward_kernel(q, k, v, bias, HEADS, seed, rate, True)[1]
        logits = sa._logits_plain(q, k, bias, HEADS)
        p = torch.softmax(logits, dim=-1)
        gap = p_formula_gap(p, logits, lse, live)
        pd = p if keep is None else torch.where(keep, p, 0.0) / (1.0 - rate)
        slack, ties = tie_slack(pd, dout)
        print(f"{tag}: the rule's p and exp2(s - lse) on the kernel's lse "
              f"{gap:.3e} apart (TIE_RTOL {TIE_RTOL:.3e}); {ties} dropped p "
              f"within it of a bf16 midpoint", flush=True)
    torch.cuda.synchronize()
    return check_rounded_backward(tag, grads, rule, rule32, auto, live,
                                  *GRAD_TOL[str(q.dtype).split(".")[1]],
                                  dv_slack=slack)


def p_formula_gap(p, logits, lse, live):
    """The largest relative gap between the rule's softmax ``p`` and
    exp2(logits / ln 2 - lse), ``lse`` the kernel's row lse (log2 units), on
    live rows where p >= 2^-10 (smaller p move dv by less than 2^-18 a
    tie); fails if it passes TIE_RTOL."""
    import torch

    formula = torch.exp2(logits / math.log(2.0) - lse[..., None])
    big = (p >= 2.0 ** -10) & live[:, None, None, None]
    gap = float(((p - formula).abs() / p)[big].max()) if big.any() else 0.0
    if not gap <= TIE_RTOL:
        raise AssertionError(f"the rule's p and exp2(s - lse) differ by "
                             f"{gap:.3e} relative, past TIE_RTOL {TIE_RTOL}")
    return gap


def phase_tiled_backward():
    """The bf16 short backwards above 128 keys (the tiled tensor-core pair
    of csrc/short_bwd_tiled.cuh) at TILED_EDGE_SHAPES -- S = 129 (one key
    past the whole-row kernel), 200 (a ragged last tile), 1023 (the last S
    of the short route) and the frame-level joint shape [32, 540] -- each
    with a fully masked batch row, at rate 0 and the training dropout, from
    a generator of its own: v2 through autograd (:func:`check_v2_backward`),
    v3 (:func:`check_v3_backward`: also its lse against the forward's and
    against v2), v2s from its own forward's probs
    (:func:`check_probs_forward`, :func:`check_probs_backward`) and v2p
    (:func:`check_packed`: bit-equal to v3 on the thirds), each against its
    rounded rule at GRAD_TOL.  Every backward launch of the phase must be on
    the tiled route.  Returns {rule: worst error}."""
    import torch

    from msa_tpu_torch.ops import short_attention as sa

    rate_on = phase_rate()
    gen = torch.Generator(device="cuda").manual_seed(16)
    worst = dict.fromkeys(("v2", "v3", "v2s", "v2p"), 0.0)
    reset_counts()
    t0 = time.perf_counter()
    for b, s in TILED_EDGE_SHAPES:
        for rate in (0.0, rate_on):
            q, k, v, bias, live = attention_inputs(gen, b, s, torch.bfloat16)
            dout = torch.randn(b, s, HIDDEN, device="cuda",
                               generator=gen).to(torch.bfloat16)
            seed = 2718 + s
            keep = (sa.dropout_keep_mask(seed, rate, b, HEADS, s, "cuda")
                    if rate else None)
            tag = f"[{b},{s},{HIDDEN}] bfloat16 rate {rate:g}"
            e2, a2 = check_v2_backward(f"short_attention_backward {tag}", q, k,
                                       v, bias, live, dout, seed, rate, keep)
            e3, v2_err, lse_err, *_ = check_v3_backward(
                f"short_attention_v3_backward {tag}", q, k, v, bias, live,
                dout, seed, rate)
            _, probs, _, ferr, _ = check_probs_forward(tag, q, k, v, bias, live,
                                                       seed, rate, keep)
            es, as_ = check_probs_backward(tag, q, k, v, bias, live, probs,
                                           dout, rate, keep)
            _, _, _, ep, ap = check_packed(tag, q, k, v, bias, live, dout,
                                           seed, rate, keep)
            for rule, e in (("v2", e2), ("v3", e3), ("v2s", es), ("v2p", ep)):
                worst[rule] = max(worst[rule], e)
            print(f"tiled backwards {tag}: against the rounded rules v2 "
                  f"{e2:.3e}, v3 {e3:.3e}, v2s {es:.3e}, v2p {ep:.3e} (GRAD_TOL "
                  f"{GRAD_TOL['bfloat16']}); against f32 autograd v2 {a2:.3e}, "
                  f"v2s {as_:.3e}, v2p {ap:.3e} (twice GRAD_TOL plus the "
                  f"roundings' gap); v3 against v2 {v2_err:.3e}, its lse "
                  f"{lse_err:.3e} from the forward's; v2p bit-equal to v3 on "
                  f"the thirds; masked rows within {MASKED_ROW_GRAD_ATOL}",
                  flush=True)
    counts = {name: (fn.launches, fn.tiled.launches)
              for name, fn in kernel_counters().items()
              if name in TILED_ENTRIES}
    if not all(n and n == tiled for n, tiled in counts.values()):
        raise AssertionError(f"tiled backwards: launches (all, tiled) {counts}")
    print(f"tiled backwards: every launch on the tiled route {counts}; "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return worst


def tiled_counts(counts, steps):
    """Launches a step of each bf16 backward entry by route: the tiled
    pair's (two a call) and the whole-row kernel's (one a call)."""
    out = {}
    for name in TILED_ENTRIES:
        n, tiled = counts[name] // steps, counts[name + "_tiled"] // steps
        if n:
            out[name] = (f"{tiled} tiled ({tiled // 2} calls of the pair) + "
                         f"{n - tiled} whole-row")
    return out


def phase_frame_short():
    """bert-large at full width and depth in frame-level mode with Lp =
    FRAME_SHORT_LEN (B = FRAME_BATCH, L = TEXT_LEN: joint pass [32, 540] on
    the short kernels), bf16, the default route and dropouts:
    FRAME_SHORT_WARMUP + FRAME_SHORT_STEPS train steps (ms/step,
    samples/s, peak, launches a step by route: 24 tiled v2 pairs from the
    joint pass, 24 whole-row launches from the text pass); then one timed
    step each of the other backwards on the same path, from the same
    weights, batches and seeds -- '+probs' (v2s), 'save_pack' (v2p) and
    ``USE_V3_BWD`` (v3) -- with their launches and losses against the
    default run's (REMAT_LOSS_RTOL); then FRAME_SHORT_REF_LAYERS layers at
    attention dropout 0, the kernel route against the plain attention
    (``use_flash_attention="never"``), 1 + 2 steps each, the losses within
    REMAT_LOSS_RTOL.  Returns {run: train_run's result}."""
    import torch

    from msa_tpu_torch.ops import short_attention as sa

    layers = 24
    exp = frame_short_experiment()
    params, batches = frame_short_inputs(exp)
    seq = TEXT_LEN + FRAME_SHORT_LEN
    runs = {}
    steps = FRAME_SHORT_STEPS
    r = runs["v2"] = train_run(exp, params, batches, FRAME_SHORT_WARMUP,
                               steps, "frame_short v2")
    # per layer: the text pass's whole-row launch, the joint pass's pair
    want = expect_counts(short_attention=2 * layers * steps,
                         short_attention_backward=3 * layers * steps,
                         short_attention_backward_tiled=2 * layers * steps,
                         fused_joint_embed=2 * steps)
    if r["remat_policy"] != "none" or r["launches"] != want:
        raise AssertionError(f"frame_short: remat {r['remat_policy']}, "
                             f"launches {r['launches']}, want {want}")
    print(f"frame-level training bf16 bert-large ({layers} layers) "
          f"B={FRAME_BATCH} L={TEXT_LEN} Lp={FRAME_SHORT_LEN} (joint pass "
          f"[{2 * FRAME_BATCH},{seq}] on the short kernels, attention dropout "
          f"on): {r['ms_step']:.2f} ms/step over {steps} steps after "
          f"{FRAME_SHORT_WARMUP}, {FRAME_BATCH * 1e3 / r['ms_step']:.2f} "
          f"samples/s, peak {r['peak_bytes'] / 2**30:.2f} GiB; launches per "
          f"step {r['per_step']}; backward launches a step by entry "
          f"{tiled_counts(r['launches'], steps)}; losses "
          f"{[round(x, 5) for x in r['losses']]}", flush=True)

    variants = (("v2s", "save_attn+drop+probs", False, "short_attention_probs",
                 "short_attention_probs_backward"),
                ("v2p", "save_pack", False, "short_attention_packed",
                 "short_attention_packed_backward"),
                ("v3", "none", True, "short_attention",
                 "short_attention_v3_backward"))
    try:
        for rule, rung, v3, fwd, bwd in variants:
            sa.USE_V3_BWD = v3
            r = runs[rule] = train_run(with_rung(exp, rung), params, batches,
                                       FRAME_SHORT_WARMUP, 1,
                                       f"frame_short {rule}")
            sa.USE_V3_BWD = False
            want = expect_counts(**{fwd: 2 * layers, bwd: 3 * layers,
                                    bwd + "_tiled": 2 * layers,
                                    "fused_joint_embed": 2})
            drift = max(abs(a - b) / abs(b) for a, b in zip(
                r["losses"], runs["v2"]["losses"]))
            if r["remat_policy"] != rung or r["launches"] != want or \
                    drift > REMAT_LOSS_RTOL:
                raise AssertionError(
                    f"frame_short {rule}: remat {r['remat_policy']}, launches "
                    f"{r['launches']}, want {want}; losses {r['losses']} "
                    f"against v2's {runs['v2']['losses']}")
            print(f"frame-level training Lp={FRAME_SHORT_LEN} with the {rule} "
                  f"backward (remat {rung}{', USE_V3_BWD' if v3 else ''}): "
                  f"{r['ms_step']:.2f} ms/step (1 step), peak "
                  f"{r['peak_bytes'] / 2**30:.2f} GiB; backward launches a "
                  f"step {tiled_counts(r['launches'], 1)}; losses "
                  f"{[round(x, 5) for x in r['losses']]} (max rel {drift:.2e} "
                  f"against v2's, bound {REMAT_LOSS_RTOL})", flush=True)
    finally:
        sa.USE_V3_BWD = False

    # the plain-attention reference, depth cut, attention dropout 0 on both
    ref = {}
    for route in ("auto", "never"):
        cut = frame_short_experiment(FRAME_SHORT_REF_LAYERS,
                                     attention_dropout=0.0,
                                     use_flash_attention=route)
        ref[route] = runs[f"ref_{route}"] = train_run(
            cut, cut_depth(params, FRAME_SHORT_REF_LAYERS), batches, 1, 2,
            f"frame_short reference {route}")
    got, base = ref["auto"], ref["never"]
    tiled = got["launches"]["short_attention_backward_tiled"]
    drift = max(abs(a - b) / abs(b) for a, b in zip(got["losses"],
                                                   base["losses"]))
    attention = [n for n in base["launches"] if n.startswith("short_")]
    if tiled != 2 * FRAME_SHORT_REF_LAYERS * 2 or drift > REMAT_LOSS_RTOL or \
            any(base["launches"][n] for n in attention):
        raise AssertionError(f"frame_short reference: losses {got['losses']} "
                             f"against the plain attention's {base['losses']}, "
                             f"tiled launches {tiled}, plain run's "
                             f"{base['launches']}")
    print(f"frame-level training Lp={FRAME_SHORT_LEN}, {FRAME_SHORT_REF_LAYERS} "
          f"layers, attention dropout 0: kernels {got['ms_step']:.2f} ms/step, "
          f"losses {[round(x, 5) for x in got['losses']]} against the plain "
          f"attention's {base['ms_step']:.2f} ms/step, "
          f"{[round(x, 5) for x in base['losses']]} (max rel {drift:.2e}, "
          f"bound {REMAT_LOSS_RTOL})", flush=True)
    return runs


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
    plus the gap the rule's roundings make in it (o's, and dS's and the
    dropped p's: |rule - the rule in f32 on the f32 output|, as
    :func:`check_rounded_backward` holds the short backwards); with
    and without dropout (the plain versions given keep_mask_plain: forward
    and backward draw that mask), and against flash2 in natural layout at
    the same seed (same mask) within the same allowance; a second seed gives
    another mask.  Times beside the bound, the plain version and SDPA on [B,
    heads, S, d] with the additive mask."""
    import torch
    import torch.nn.functional as F

    from msa_tpu_torch.ops import attention as A
    from msa_tpu_torch.ops.dropout import keep_mask_plain
    from msa_tpu_torch.ops.flash2 import flash_attention2

    rate_on = phase_rate()
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
        out, lse = A._forward_kernel(q, k, v, bias, seed, rate,
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
        # what the rule's roundings (o to the dtype, dS and the dropped p
        # before their products) move in it: the rule in f32 throughout on
        # the plain f32 output (0 in f32)
        o_gap = [(a.float() - c.float()).abs() for a, c in zip(
            refs, A.flash_attention_backward_plain(
                q.float(), k.float(), v.float(), bias, ref.detach(), lse,
                dout.float(), rate, keep))]
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
                f"plain forward (the rule's rounding gap up to "
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
    each from a generator of its own; then v1 above 128 keys
    (:func:`check_v1_long`)."""
    import torch
    import torch.nn.functional as F

    from msa_tpu_torch.ops import short_attention as sa
    from msa_tpu_torch.ops.dropout import keep_mask_plain

    rate_on = phase_rate()
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
                v2_inputs = inputs + (
                    0 if sa.backward_route(s, dtype, HIDDEN // HEADS) == sa.WHOLE_ROW
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
    for key, err in check_v1_long().items():
        worst[key] = max(worst[key], err)
    return worst, times


V1_LONG_SEQS = (200, 540, 1000)


def check_v1_long():
    """v1 above 128 keys (the v2 kernels' forms: the two-sweep forward, the
    training forward's lse and the v2 pair for the backward) at S = 200,
    540 and 1000 (B = 2), bf16 at rate 0 and 26/256: the forward against
    the plain version and v2, the backward by :func:`check_v1_backward`
    (its plain rule, autograd, v2's gradients bit for bit) with its
    launches counted (:func:`short_attention_v1.v1_backward_launches`);
    then f32 at S = 540 (the CUDA-core forms) against autograd through the
    plain version in f32 at GRAD_TOL.  From a generator of its own.
    Returns the worst forward and backward errors."""
    import torch

    from msa_tpu_torch.ops import short_attention as sa
    from msa_tpu_torch.ops.dropout import keep_mask_plain

    rate_on = phase_rate()
    gen = torch.Generator(device="cuda").manual_seed(19)
    worst = {"fwd": 0.0, "bwd": 0.0}
    atol, rtol = ATTN_TOL["bfloat16"]
    for s in V1_LONG_SEQS:
        for rate in (0.0, rate_on):
            q, k, v, bias, live = attention_inputs(gen, 2, s, torch.bfloat16)
            dout = torch.randn(2, s, HIDDEN, device="cuda",
                               generator=gen).to(torch.bfloat16)
            seed = 31 + s
            keep = (keep_mask_plain(seed, rate, 2, HEADS, s, device="cuda")
                    if rate else None)
            out = sa.short_attention_v1(q, k, v, bias, HEADS, rate,
                                        seed if rate else None)
            v2_out = sa.short_attention(q, k, v, bias, HEADS, rate,
                                        seed if rate else None)
            ref = sa.short_attention_plain(q.float(), k.float(), v.float(),
                                           bias, HEADS, rate, keep)
            torch.cuda.synchronize()
            tag = f"short_attention_v1 [2,{s},{HIDDEN}] bfloat16 rate {rate:g}"
            err = check_close(tag, out, ref, atol, rtol, mask=live)
            if not torch.equal(out, v2_out):
                raise AssertionError(f"{tag}: v1's forward is not v2's")
            diff, gap = check_masked_rows(tag, out, q, k, v, bias, live, rate,
                                          keep)
            before = sa.short_attention_v1_backward.launches
            berr = check_v1_backward(q, k, v, bias, live, dout, seed, rate)
            got = sa.short_attention_v1_backward.launches - before
            if got != sa.v1_backward_launches(s, torch.bfloat16,
                                                 HIDDEN // HEADS):
                raise AssertionError(f"{tag}: {got} backward launches")
            worst["fwd"] = max(worst["fwd"], err)
            worst["bwd"] = max(worst["bwd"], berr)
            print(f"{tag} (the two-sweep forward, v2's equal): max_abs_err "
                  f"{err:.3e}; masked rows {diff:.3e} from f32 (the rule "
                  f"{gap:.3e}); backward {got} launches", flush=True)
    q, k, v, bias, live = attention_inputs(gen, 2, 540, torch.float32)
    dout = torch.randn(2, 540, HIDDEN, device="cuda", generator=gen)
    qq, kk, vv = (x.detach().requires_grad_() for x in (q, k, v))
    out = sa.short_attention_v1(qq, kk, vv, bias, HEADS)
    grads = torch.autograd.grad(out, (qq, kk, vv), dout)
    qq, kk, vv = (x.detach().requires_grad_() for x in (q, k, v))
    ref = sa.short_attention_plain(qq, kk, vv, bias, HEADS)
    auto = torch.autograd.grad(ref, (qq, kk, vv), dout)
    torch.cuda.synchronize()
    tag = f"short_attention_v1 [2,540,{HIDDEN}] float32"
    atol, rtol = ATTN_TOL["float32"]
    gatol, grtol = GRAD_TOL["float32"]
    err = check_close(tag, out, ref, atol, rtol, mask=live)
    gerr = max(check_close(f"{tag} {name}", g, a, gatol, grtol, mask=live)
               for name, g, a in zip(("dq", "dk", "dv"), grads, auto))
    worst["fwd"], worst["bwd"] = max(worst["fwd"], err), max(worst["bwd"], gerr)
    print(f"{tag} (CUDA cores): max_abs_err {err:.3e}, gradients {gerr:.3e} "
          f"against autograd (atol {gatol}, rtol {grtol})", flush=True)
    return worst


def check_v1_backward(q, k, v, bias, live, dout, seed, rate):
    """The bf16 v1 backward kernel (tensor cores; above 128 keys and at
    head dim 256 the v2 forward's lse and the tiled pair) at a few keys:
    against
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
    cores = "tensor cores"
    print(f"{tag} ({cores}): max_abs_err {err:.3e} against the plain "
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
# The head dims whose kernels may not spill (the presets' widths); a spill
# at another instantiation (16, 128) is printed and written down in PERF.md
NO_SPILL_HEAD_DIMS = (32, 64)
TC_KERNEL = re.compile(
    r"(short_fwd_tc_kernel|short_bwd_tc_kernel|short_attention_fwd_tc_long_kernel|"
    r"short_attention_probs_fwd_tc(?:_long)?_kernel|short_bwd_dq_kernel|"
    r"short_bwd_dkv_kernel)I((?:L[ib]\d+E)+)E")
# the tiled backward pair (csrc/short_bwd_tiled.cuh): none may spill
TILED_KERNELS = ("short_bwd_dq_kernel", "short_bwd_dkv_kernel")
# bf16 at head dim 256 on the tensor cores: the tiled pair and the two-sweep
# ring forwards, which take every S there, and flash's warpgroup forward,
# flash2's warpgroup fused backward and the warpgroup split pair of rows 12
# and 13 (its dk/dv launch by role); none may spill either
# (report_tc_resources holds the short kernels, report_wgmma flash's)
WIDE_FLASH_KERNELS = ("flash_fwd_wg_kernel", "flash_fwd_wg_overlap_kernel",
                      "flash2_bwd_fused_wg_kernel", "flash_bwd_dq_wg_kernel",
                      "flash_bwd_dkv_wg_kernel", "flash_bwd_dkv_role_wg_kernel")
WIDE_TC_KERNELS = TILED_KERNELS + ("short_attention_fwd_tc_long_kernel",
                                   "short_attention_probs_fwd_tc_long_kernel"
                                   ) + WIDE_FLASH_KERNELS


def tc_dynamic_smem(kernel):
    args = [int(a) for a in re.findall(r"L[ib](\d+)E", TC_KERNEL.search(
        kernel).group(2))]
    row = 2 * (args[0] + 8)  # bytes of a staged head row at head dim args[0]
    name = TC_KERNEL.search(kernel).group(1)
    if name in TILED_KERNELS:  # <head dim, dropout, rule>: 64-row tiles
        # swizzled wgmma tiles of 2 kD bytes a row after a 1024-byte
        # alignment; v2s: a ring of probs tiles (72 values a row) for one
        probs = args[2] == 2
        # f32 rows of 64 in the ring: the bias (dq), lse and delta (dk/dv)
        stats = ((0 if probs else 2) if name == "short_bwd_dq_kernel"
                 else (2 if probs else 4))
        return (1024 + (5 if probs else 6) * 64 * 2 * args[0]
                + probs * 2 * 64 * 72 * 2 + stats * 64 * 4)
    if "tc_long" in kernel:  # v2s: also a probs stage of 64 keys a row
        stage = 128 * 2 * (64 + 8) if "probs" in kernel else 0
        return (128 + 4 * 64) * row + stage + 2 * 64 * 4
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
    0 recompute, 1 from o, 2 from the probs>; the tiled pair above 128 keys
    kernel<head dim, dropout, rule>), and fail if, at a head dim of
    NO_SPILL_HEAD_DIMS, a whole-row forward or backward of at most
    TC_NO_SPILL_TILES tiles, or any kernel of the tiled pair, or at head
    dim 256 any of WIDE_TC_KERNELS, spills or has a stack frame, or if
    ptxas serialised a tiled kernel's wgmma products (at any head dim)."""
    tc = [u for u in usage if TC_KERNEL.search(u["kernel"])]
    for name in ("short_fwd_tc_kernel", "short_bwd_tc_kernel",
                 "short_attention_fwd_tc_long_kernel") + TILED_KERNELS:
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
        checked = int(args[0]) in NO_SPILL_HEAD_DIMS and (
            m.group(1) in TILED_KERNELS or (
                m.group(1) in ("short_fwd_tc_kernel", "short_bwd_tc_kernel")
                and int(args[1]) <= TC_NO_SPILL_TILES)) or (
            int(args[0]) == 256 and m.group(1) in WIDE_TC_KERNELS)
        if m.group(1) in TILED_KERNELS and u["serialized"]:
            raise AssertionError(f"ptxas serialised the wgmma products of "
                                 f"{name}: {u['serialized']}")
        if checked and (u["stack"] or u["spill_stores"] or u["spill_loads"]):
            raise AssertionError(f"ptxas: {name} in {u['source']} spills or "
                                 "keeps a stack frame")


# The redesigned kernels of rows 2 and 11 (the joint embed's tiles,
# flash2's bf16 fused sweep up to head dim 32 and its delta pre-pass; the
# sweep from 64 on is a warpgroup kernel, report_wgmma's): none may spill
# or keep a stack frame.  Their threads a CTA, the fused sweep's dynamic
# shared memory by head dim (csrc/flash_kernels.cuh::fused_tc_smem_bytes)
# and the H100's registers and shared memory per SM, for the CTAs an SM
# holds.
REDESIGNED = re.compile(r"(fused_joint_embed_kernel|flash2_bwd_fused_kernel|"
                        r"flash2_bwd_prep_kernel)I")
REDESIGNED_THREADS = {"fused_joint_embed_kernel": 256,
                      "flash2_bwd_fused_kernel": 128, "flash2_bwd_prep_kernel": 256}
FUSED_TC_SMEM = {32: 60416, 16: 44032}
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
    for name in REDESIGNED_THREADS:
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


# The warpgroup (wgmma) kernels of rows 10-13 (flash_kernels.cuh:
# flash_fwd_wg_kernel, flash_fwd_wg_overlap_kernel (the forward at 256
# under dropout),
# flash_bwd_dq_wg_kernel, flash_bwd_dkv_wg_kernel (up to 128),
# flash_bwd_dkv_role_wg_kernel (the dk/dv launch at 256), each <head dim,
# head split, dropout[, training form]>, and flash2_bwd_fused_wg_kernel
# <head dim, dropout> (flash2's fused backward, bf16, at every head dim of
# FUSED_HEAD_DIMS; below them flash2_bwd_fused_kernel, report_redesigned's)):
# none may have its wgmma products serialised by ptxas, and none may spill
# or keep a stack frame at a head dim of NO_SPILL_HEAD_DIMS
# (WIDE_FLASH_KERNELS at 256 too).
WGMMA = re.compile(r"(flash_fwd_wg_kernel|flash_fwd_wg_overlap_kernel|"
                   r"flash_bwd_dq_wg_kernel|flash_bwd_dkv_wg_kernel|"
                   r"flash_bwd_dkv_role_wg_kernel|flash2_bwd_fused_wg_kernel)I")
FUSED_HEAD_DIMS = (64, 128, 256)
# The fused warpgroup sweep's choices at 64 and 128 (flash_kernels.cuh::
# kNarrowFusedKeyGroups, kNarrowFusedStages, kFusedTmaDq): warpgroups a
# CTA, each on 64 keys; ring stages; dQ staged as a [64 x d] f32 tile for
# the bulk tensor reductions.  At 256 one CTA of two warpgroups on 64 keys,
# dQ by atomics.
FUSED_KEY_GROUPS, FUSED_STAGES, FUSED_TMA_DQ = 2, 2, True


def wgmma_launch(name, args):
    """(threads, dynamic shared memory) of a warpgroup kernel's launch, as
    its launcher sets them (the tile choices above flash_kernels.cuh's
    kernels and wg_*_smem_bytes: the alignment slack, the swizzled tiles of
    kD bf16 rows, the bias / lse / delta rows)."""
    row = 2 * int(args[0])
    if name in ("flash_fwd_wg_kernel", "flash_fwd_wg_overlap_kernel"):
        # 128 query rows, two 64-key stages
        return 256, 1024 + (128 + 4 * 64) * row + 2 * 64 * 4
    if name == "flash2_bwd_fused_wg_kernel":
        # K and V, the 64-query ring stages of q and dO, the dS^T tile, the
        # staged dQ tile, the stages' lse and delta
        d = int(args[0])
        groups, stages, tma = ((1, 2, False) if d == 256 else (
            FUSED_KEY_GROUPS, FUSED_STAGES, FUSED_TMA_DQ))
        return 256 if d == 256 else 128 * groups, (
            1024 + (2 * 64 * groups + 2 * stages * 64) * row + 64 * groups * 128
            + tma * 64 * d * 4 + 2 * stages * 64 * 4)
    if name == "flash_bwd_dq_wg_kernel":
        if args[0] == "256":  # 64 query rows, one stage of 32 keys
            return 128, 1024 + (2 * 64 + 2 * 32) * row + 32 * 4 + 64 * 4
        rows = 64 if args[2] == "1" else 128  # 128 query rows, 64 under dropout
        return 2 * rows, 1024 + (2 * rows + 4 * 64) * row + 2 * 64 * 4 + rows * 4
    if name == "flash_bwd_dkv_role_wg_kernel":
        # 64 keys, two warpgroups by role, the f32 p tile between them
        return 256, 1024 + (2 * 64 + 4 * 64) * row + 64 * 64 * 4 + 4 * 64 * 4
    return 128, 1024 + (2 * 64 + 4 * 64) * row + 4 * 64 * 4  # 64 keys


def report_wgmma(usage):
    """Print ptxas's registers, shared memory, spills and wgmma notices for
    each instantiation of the warpgroup kernels, with the CTAs an SM holds
    by registers and by shared memory; fail if flash2.cu lacks the fused
    sweep at a head dim of FUSED_HEAD_DIMS, on a serialisation notice, and
    on a spill or a stack frame at a head dim of NO_SPILL_HEAD_DIMS or, for
    WIDE_FLASH_KERNELS, at 256."""
    found = [u for u in usage if WGMMA.search(u["kernel"])]
    fused_at = {int(template_args(u["kernel"], WGMMA.search(u["kernel"]))[0])
                for u in found if u["source"] == "flash2.cu"
                and "flash2_bwd_fused_wg_kernelI" in u["kernel"]}
    if fused_at != set(FUSED_HEAD_DIMS):
        raise AssertionError(f"ptxas reported flash2_bwd_fused_wg_kernel at "
                             f"head dims {sorted(fused_at)}, not "
                             f"{list(FUSED_HEAD_DIMS)}")
    both = ("flash2.cu", "flash_attention.cu")
    for name, sources in (
            ("flash_fwd_wg_kernel", both), ("flash_fwd_wg_overlap_kernel", both),
            ("flash_bwd_dq_wg_kernel", both), ("flash_bwd_dkv_wg_kernel", both),
            ("flash_bwd_dkv_role_wg_kernel", both),
            ("flash2_bwd_fused_wg_kernel", ("flash2.cu",))):
        for source in sources:
            if not any(name + "I" in u["kernel"] and u["source"] == source
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
        checked = int(args[0]) in NO_SPILL_HEAD_DIMS or (
            int(args[0]) == 256 and name in WIDE_FLASH_KERNELS)
        if checked and (u["stack"] or u["spill_stores"] or u["spill_loads"]):
            raise AssertionError(f"ptxas: {name}<{', '.join(args)}> in "
                                 f"{u['source']} spills or keeps a stack frame")
        if u["serialized"]:
            raise AssertionError(f"ptxas serialised the wgmma products of "
                                 f"{name} in {u['source']}")


def report_wide(usage):
    """Print ptxas's registers, stack and spills for every kernel of the
    libraries of head dim 256 (short attention: f32 on the CUDA cores, bf16
    on the ring forwards and the tiled pair, which report_tc_resources
    holds to no spill; flash: the forward, the fused backward and the split
    pair on wgmma, which report_wgmma holds to no spill, f32 on the CUDA
    cores): the other kernels' spills are written down, not failed on."""
    wide = [u for u in usage if u["library"].endswith("_d256")]
    if not wide:
        raise AssertionError("ptxas reported no kernel at head dim 256")
    for u in wide:
        name = re.sub(r"^_ZN\d+_GLOBAL__N__[0-9a-f]+_\d+_\w+?_cu_[0-9a-f]{8}"
                      r"\d+(?=[a-z])", "", u["kernel"])
        print(f"ptxas d=256 {u['library']} {name[:90]}: {u['registers']} "
              f"registers, {u['static_smem']} B static smem, stack "
              f"{u['stack']} B, spill stores {u['spill_stores']} B, loads "
              f"{u['spill_loads']} B", flush=True)
    spilled = [u for u in wide if u["spill_stores"] or u["spill_loads"]]
    print(f"ptxas d=256: {len(spilled)} of {len(wide)} kernels spill, at most "
          f"{max((u['spill_stores'] for u in wide), default=0)} B stored",
          flush=True)


def no_dropout(exp):
    """``exp`` with every dropout rate 0 (hidden, attention, joint)."""
    m = exp.model
    return dataclasses.replace(exp, model=dataclasses.replace(
        m, joint_dropout_prob=0.0, bert=dataclasses.replace(
            m.bert, hidden_dropout_prob=0.0,
            attention_probs_dropout_prob=0.0)))


def with_fuse(exp, fuse):
    return dataclasses.replace(exp, train=dataclasses.replace(
        exp.train, fuse_text_pass=fuse))


def fused_launches(layers, steps=1, train=True):
    """Kernel launches of ``steps`` bf16 steps (or serving batches) under
    ``fuse_text_pass``: one short-attention call a layer over [3B, 2L] (and
    its backward), the two joint embeds."""
    import torch

    from msa_tpu_torch.ops.short_attention import backward_launches

    bwd = layers * backward_launches(2 * TEXT_LEN, torch.bfloat16,
                                     HIDDEN // HEADS) * train
    return expect_counts(fused_joint_embed=2 * steps,
                         short_attention=layers * steps,
                         short_attention_backward=bwd * steps)


def phase_fuse_text_pass():
    """``fuse_text_pass`` at bert-large B=96, L=40: one [3B, 80] encoder
    call in place of [B, 40] + [2B, 80].  1 + 5 bf16 train steps at dropout
    0 from the same weights, batches and seed, unfused, fused, fused,
    unfused (each run's losses within GRAD_TOL of the first unfused run's,
    the updates of UPDATE_LEAVES within UPDATE_RTOL of its updates; ms/step
    of each run, peak, launches per step), then the ragged serving split in
    bf16 in the same turns (predictions within ATTN_TOL; samples/s,
    launches per batch)."""
    import numpy as np
    import torch

    from msa_tpu_torch.data import synthetic_split
    from msa_tpu_torch.inference import Predictor

    t_phase = time.perf_counter()
    exp, params, batches = train_inputs(5)
    exp = no_dropout(exp)
    layers = exp.model.bert.num_hidden_layers
    turns = (False, True, True, False)
    runs = [train_run(with_fuse(exp, fuse), params, batches, FUSE_WARMUP,
                      FUSE_STEPS, f"fuse_text_pass={fuse}", keep=UPDATE_LEAVES)
            for fuse in turns]
    want = {False: rung_launches("none", layers, FUSE_STEPS),
            True: fused_launches(layers, FUSE_STEPS)}
    base = runs[0]
    atol, rtol = GRAD_TOL["bfloat16"]
    start = {k: params_leaf(params, k) for k in UPDATE_LEAVES}
    gaps, updates = [], {k: [] for k in UPDATE_LEAVES}
    for fuse, r in zip(turns, runs):
        if r["launches"] != want[fuse] or r["remat_policy"] != "none":
            raise AssertionError(f"fuse_text_pass={fuse}: launches "
                                 f"{r['launches']}, want {want[fuse]}, remat "
                                 f"{r['remat_policy']}")
        gaps += [abs(a - b) for a, b in zip(r["losses"], base["losses"])]
        if not all(abs(a - b) <= atol + rtol * abs(b)
                   for a, b in zip(r["losses"], base["losses"])):
            raise AssertionError(f"fuse_text_pass={fuse} losses {r['losses']}"
                                 f" against {base['losses']}")
        for k in UPDATE_LEAVES:
            updates[k].append(check_update(
                f"fuse_text_pass={fuse} {k}", r["kept"][k], base["kept"][k],
                start[k]))
    ms = {fuse: [r["ms_step"] for f, r in zip(turns, runs) if f == fuse]
          for fuse in (False, True)}
    fused = runs[1]
    print(f"fuse_text_pass training bf16 bert-large B={BATCH} L={TEXT_LEN} "
          f"(dropout 0, remat off; {FUSE_STEPS} steps after {FUSE_WARMUP}, "
          f"in turns unfused, fused, fused, unfused): fused "
          f"{[round(x, 2) for x in ms[True]]} ms/step against unfused "
          f"{[round(x, 2) for x in ms[False]]}; peak "
          f"{fused['peak_bytes'] / 2**30:.2f} against "
          f"{base['peak_bytes'] / 2**30:.2f} GiB; launches per step fused "
          f"{fused['per_step']}, unfused {base['per_step']}; losses fused "
          f"{[round(x, 5) for x in fused['losses']]}, unfused "
          f"{[round(x, 5) for x in base['losses']]} (max |diff| "
          f"{max(gaps):.2e}); "
          f"{update_text(updates, "the first unfused run's")}", flush=True)
    del batches

    cfg = exp.model
    split = synthetic_split(N_SERVE, TEXT_LEN, cfg.visual_dim, cfg.speech_dim,
                            vocab_size=cfg.bert.vocab_size, seed=0)
    n_batches = -(-N_SERVE // BATCH)
    preds = {fuse: Predictor(with_fuse(exp, fuse), params, BATCH, "cuda")
             for fuse in (False, True)}
    outs, rates, launches = {}, {False: [], True: []}, {}
    for fuse in (False, True):
        preds[fuse].predict_split(split)  # warm
    for fuse in turns:
        reset_counts()
        t0 = time.perf_counter()
        outs[fuse] = preds[fuse].predict_split(split)
        rates[fuse].append(N_SERVE / (time.perf_counter() - t0))
        launches[fuse] = kernel_counts()
        want = (fused_launches(layers, n_batches, train=False) if fuse
                else serving_launches(layers, n_batches))
        if launches[fuse] != want:
            raise AssertionError(f"fuse_text_pass={fuse} serving launches "
                                 f"{launches[fuse]}, want {want}")
    del preds
    atol, rtol = ATTN_TOL["bfloat16"]
    pred_err = check_close("fuse_text_pass predictions",
                           torch.from_numpy(outs[True]),
                           torch.from_numpy(outs[False]), atol, rtol)
    print(f"fuse_text_pass serving bf16 bert-large B={BATCH}: {N_SERVE} "
          f"samples in turns unfused, fused, fused, unfused: fused "
          f"{[round(x, 2) for x in rates[True]]} samples/s against unfused "
          f"{[round(x, 2) for x in rates[False]]}; launches per batch fused "
          f"{({k: v // n_batches for k, v in launches[True].items() if v})}"
          f"; predictions max |diff| {pred_err:.3e} (bf16 predictions spread "
          f"{float(np.ptp(outs[False])):.3e}); phase "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)
    del params
    torch.cuda.empty_cache()
    return {"training": fused["launches"], "serving": launches[True],
            "ms_step": ms, "samples_per_s": rates}


def update_text(updates, against):
    """What :func:`check_update` returned for each leaf and run."""
    return "; ".join(
        f"{k} update against {against}: relative 2-norm diff "
        f"{[f'{u[0]:.3e}' for u in us]} (limit "
        f"{UPDATE_RTOL}), largest element diff over largest update "
        f"{[f'{u[2]:.3e}' for u in us]}, largest update {us[0][1]:.3e}"
        for k, us in updates.items())


def params_leaf(params, name):
    from msa_tpu_torch.models.weights import named_leaves

    return dict(named_leaves(params))[name].detach().float().cpu()


def free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn_ranks(label, argv_of, cwd, timeout=DP_TIMEOUT, n=2):
    """``n`` processes of this script (``argv_of(rank, port)``), joined at a
    free local port; fails with their output if any fails.  Returns
    (outputs, wall seconds)."""
    port = free_port()
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, "-u", os.path.abspath(__file__), *argv_of(r, port)],
        cwd=cwd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(n)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, out) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise AssertionError(f"{label}: rank {r} exited {p.returncode}:\n"
                                 f"{out[-6000:]}")
    return outs, time.perf_counter() - t0


def dp_cli_argv(model, n, batch, epochs, root, extra=()):
    return ["--model", model, "--dataset", "mosi", "--synthetic", str(n),
            "--n_epochs", str(epochs), "--train_batch_size", str(batch),
            "--val_batch_size", str(batch), "--test_batch_size", str(batch),
            "--checkpoint_root", os.path.join(root, "model_save"),
            "--numpy_root", os.path.join(root, "numpy_save"),
            "--device", "cuda", *extra]


def dp_launch(rank, port, dp=2, mp=1):
    return ["--dp", str(dp), "--mp", str(mp),
            "--coordinator", f"127.0.0.1:{port}",
            "--num_processes", str(dp * mp), "--process_id", str(rank)]


def params_digest(trainer, state):
    """sha256 of the whole parameter tree by sorted leaf name (the model
    group's shards gathered; a loaded tree orders its keys otherwise than
    a fresh one, so an unsorted digest differs where every leaf is
    equal)."""
    import hashlib

    from msa_tpu_torch.models.weights import named_leaves
    from msa_tpu_torch.parallel import sharding

    params = state.params if trainer.mp is None else \
        sharding.gather_across(state.params, trainer.mp)
    digest = hashlib.sha256()
    for k, v in sorted(named_leaves(params)):
        digest.update(k.encode())
        digest.update(v.detach().cpu().numpy().tobytes())
    return digest.hexdigest()


def cli_worker(out, dropout, argv):
    """A rank of ``python -m msa_tpu_torch.cli.train`` (its ``run``, with
    these flags; ``dropout`` "rate0" sets every dropout rate of the
    experiment the flags describe to 0, "preset" keeps the preset's):
    writes what it ran to ``out``.json (kernel launches of
    the process, steps, a digest of the final parameters, the fit history,
    the gradient all-reduce time, peak memory) and ``out``.npz (the final
    UPDATE_LEAVES)."""
    import numpy as np
    import torch

    from msa_tpu_torch.cli import train
    from msa_tpu_torch.models.weights import named_leaves

    if dropout == "rate0":
        flags_config = train.build_config
        train.build_config = lambda args: no_dropout(flags_config(args))
    reset_counts()
    trainer, state, result = train.run(train.build_parser().parse_args(argv))
    torch.cuda.synchronize()
    digest = params_digest(trainer, state)
    leaves = dict(named_leaves(state.params))
    np.savez(out + ".npz", *(leaves[k].detach().cpu().numpy()
                             for k in UPDATE_LEAVES))
    with open(out + ".json", "w") as f:
        json.dump({"launches": kernel_counts(), "step": state.step,
                   "digest": digest, "history": result.history,
                   "best_epoch": result.best_epoch,
                   "comm_ms": trainer.comm_seconds * 1e3,
                   "dp": None if trainer.dp is None else
                   [trainer.dp.size, trainer.dp.index],
                   "mp": None if trainer.mp is None else
                   [trainer.mp.size, trainer.mp.index],
                   "remat": trainer.remat_policy,
                   "backend": torch.distributed.get_backend(),
                   "peak_gib": torch.cuda.max_memory_allocated() / 2**30}, f)
    return 0


def predict_worker(out, rank, port):
    """A rank of a dp=2 bf16 bert-large ``Predictor`` (weights from seed 0)
    serving the ragged split: its predictions (``out``.npy) and kernel
    launches (``out``.json)."""
    import numpy as np
    import torch

    from msa_tpu_torch.configs import build_experiment
    from msa_tpu_torch.data import synthetic_split
    from msa_tpu_torch.inference import Predictor
    from msa_tpu_torch.models.weights import init_params
    from msa_tpu_torch.parallel import distributed

    distributed.initialize(f"127.0.0.1:{port}", 2, rank, device="cuda")
    exp = build_experiment("mosi", "bert-large-uncased", num_labels=1,
                           data_parallel=2)
    cfg = exp.model
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
    split = synthetic_split(N_SERVE, TEXT_LEN, cfg.visual_dim, cfg.speech_dim,
                            vocab_size=cfg.bert.vocab_size, seed=0)
    pred = Predictor(exp, params, BATCH, "cuda")
    pred.predict_split(split)  # warm
    reset_counts()
    t0 = time.perf_counter()
    preds = pred.predict_split(split)
    seconds = time.perf_counter() - t0
    np.save(out + ".npy", preds)
    with open(out + ".json", "w") as f:
        json.dump({"launches": kernel_counts(), "seconds": seconds,
                   "backend": torch.distributed.get_backend()}, f)
    return 0


def read_rank(path, arrays=".npy"):
    """A worker's report and its arrays (``.npz``: UPDATE_LEAVES by name)."""
    import numpy as np

    with open(path + ".json") as f:
        info = json.load(f)
    if arrays == ".npy":
        return info, np.load(path + ".npy")
    with np.load(path + ".npz") as z:
        return info, dict(zip(UPDATE_LEAVES, (z[f"arr_{i}"] for i in
                                              range(len(UPDATE_LEAVES)))))


def phase_data_parallel():
    """Data parallelism across two processes on the one card, over gloo
    (NCCL refuses two ranks on one device), every rank launched as ``python
    -m msa_tpu_torch.cli.train --dp 2 --coordinator 127.0.0.1:<port>
    --num_processes 2 --process_id r`` (through this script's worker mode,
    which calls the CLI's ``run`` and reports what the process ran):

    * bert-large, global B=96 (48 a rank), dropout 0, remat off, one epoch
      of two steps: both ranks log the same epoch losses and end on the
      same parameters; the losses within bf16 GRAD_TOL, and the updates of
      UPDATE_LEAVES within UPDATE_RTOL, of a one-process epoch on the same
      global batches; the gradient all-reduce's ms a step;
    * the tiny preset, two epochs, and ``--resume`` from the first epoch's
      checkpoint (rank 0 wrote it): the resumed run ends on the
      uninterrupted run's parameters bit for bit, on both ranks;
    * the bf16 ``Predictor`` at dp=2 on the ragged B=96 split: the same
      array on both ranks, within ATTN_TOL of dp=1.

    Two ranks share one H100 here and gloo stages every collective through
    the host, so this shows correctness, not scaling."""
    import numpy as np
    import torch

    from msa_tpu_torch.cli import train
    from msa_tpu_torch.configs import build_experiment
    from msa_tpu_torch.data import synthetic_split
    from msa_tpu_torch.inference import Predictor
    from msa_tpu_torch.models.weights import init_params
    from msa_tpu_torch.training.checkpoint import epoch_dir
    from msa_tpu_torch.training.trainer import Trainer

    t_phase = time.perf_counter()
    atol, rtol = GRAD_TOL["bfloat16"]
    with tempfile.TemporaryDirectory() as tmp:
        # bert-large: the one-process epoch first, in this process
        big = dp_cli_argv("bert-large-uncased", DP_SYNTHETIC, BATCH, 1,
                          os.path.join(tmp, "big"))
        args = train.build_parser().parse_args(big)
        train_ds = train.load_splits(args)[0]
        trainer = Trainer(no_dropout(train.build_config(args)), "cuda")
        state = trainer.init_state(args.seed, train_ds.num_batches(BATCH))
        start = {k: params_leaf(state.params, k) for k in UPDATE_LEAVES}
        state, em = trainer.train_epoch(state, train_ds, 0, args.seed)
        ref = em.averaged()
        ref_leaves = {k: params_leaf(state.params, k) for k in UPDATE_LEAVES}
        del trainer, state
        torch.cuda.empty_cache()
        outs, big_s = spawn_ranks(
            "dp bert-large", lambda r, port: [
                "--cli-worker", os.path.join(tmp, f"big{r}"), "rate0", "--",
                *big, *dp_launch(r, port)], tmp)
        ranks = [read_rank(os.path.join(tmp, f"big{r}"), ".npz")
                 for r in range(2)]
        lines = [[ln[ln.index("[Train Epoch"):].split(" (")[0]
                  for ln in out.splitlines()
                  if "[Train Epoch" in ln and "Joint" in ln] for out in outs]
        steps = DP_SYNTHETIC // BATCH
        want = rung_launches("none", 24, steps)
        want["short_attention"] += 2 * 24 * 2  # one val and one test batch
        want["fused_joint_embed"] += 2 * 2
        for r, (info, _) in enumerate(ranks):
            if info["launches"] != want or info["step"] != steps or \
                    info["dp"] != [2, r] or info["backend"] != "gloo" or \
                    info["remat"] != "none":
                raise AssertionError(f"dp bert-large rank {r}: {info}, want "
                                     f"launches {want}")
        if lines[0] != lines[1] or not lines[0] or \
                ranks[0][0]["digest"] != ranks[1][0]["digest"]:
            raise AssertionError(f"dp bert-large: ranks differ: {lines}, "
                                 f"{[i['digest'] for i, _ in ranks]}")
        got = ranks[0][0]["history"][0]["train"]
        gaps = {k: abs(got[k] - ref[k]) for k in
                ("loss", "mlm_loss", "ap_loss", "label_loss", "nce")}
        if not all(g <= atol + rtol * abs(ref[k]) for k, g in gaps.items()):
            raise AssertionError(f"dp bert-large losses {got} against one "
                                 f"process {ref}")
        updates = {k: [check_update(f"dp {k}", torch.from_numpy(
            ranks[0][1][k]), ref_leaves[k], start[k])] for k in UPDATE_LEAVES}
        comm = ranks[0][0]["comm_ms"] / steps
        print(f"dp=2 bert-large bf16 B={BATCH} ({BATCH // 2} a rank, two "
              f"processes on one card, gloo), {steps} steps through "
              f"cli.train: both ranks log {lines[0]} and end on equal "
              f"parameters; epoch losses against one process max |diff| "
              f"{max(gaps.values()):.2e} ({got['loss']:.5f} against "
              f"{ref['loss']:.5f}); rank 0's "
              f"{update_text(updates, "one process's")}; "
              f"gradient all-reduce {comm:.1f} ms a step (one flat f32 "
              f"buffer of every gradient, staged through the host by gloo: "
              f"two ranks share one H100, so this is correctness, not "
              f"scaling); peak per rank "
              f"{[round(i['peak_gib'], 2) for i, _ in ranks]} GiB; "
              f"{big_s:.1f} s for both ranks", flush=True)

        # tiny: two epochs, then --resume from the first epoch's checkpoint
        root = os.path.join(tmp, "tiny")
        tiny = dp_cli_argv("tiny", 256, 32, 2, root)
        _, tiny_s = spawn_ranks("dp tiny", lambda r, port: [
            "--cli-worker", os.path.join(tmp, f"tiny{r}"), "preset", "--",
            *tiny, *dp_launch(r, port)], tmp)
        run = os.path.join(root, "model_save",
                           sorted(os.listdir(os.path.join(root, "model_save")))[0])
        if not os.path.isdir(epoch_dir(run, 0)):
            raise AssertionError(f"dp tiny: no checkpoint of epoch 1 in {run}")
        _, resume_s = spawn_ranks("dp tiny --resume", lambda r, port: [
            "--cli-worker", os.path.join(tmp, f"resume{r}"), "preset", "--",
            *tiny, *dp_launch(r, port), "--resume", epoch_dir(run, 0)], tmp)
        infos = [read_rank(os.path.join(tmp, f"{k}{r}"), ".npz")[0]
                 for k in ("tiny", "resume") for r in range(2)]
        if len({i["digest"] for i in infos}) != 1 or \
                {i["step"] for i in infos} != {16}:
            raise AssertionError(f"dp tiny --resume: digests "
                                 f"{[i['digest'][:12] for i in infos]}, steps "
                                 f"{[i['step'] for i in infos]}")
        tiny_want = rung_launches("none", 2, 16)
        tiny_want["short_attention"] += 2 * 2 * 4  # val + test, two epochs
        tiny_want["fused_joint_embed"] += 2 * 4
        if infos[0]["launches"] != tiny_want:
            raise AssertionError(f"dp tiny launches {infos[0]['launches']}, "
                                 f"want {tiny_want}")
        print(f"dp=2 tiny preset B=32 through cli.train: 2 epochs "
              f"({tiny_s:.1f} s), --resume from epoch 1 ({resume_s:.1f} s) "
              f"ends on the uninterrupted run's parameters bit for bit on "
              f"both ranks (step 16)", flush=True)

        # serving
        exp = build_experiment("mosi", "bert-large-uncased", num_labels=1)
        params = init_params(exp.model, torch.Generator(
            device="cuda").manual_seed(0))
        split = synthetic_split(N_SERVE, TEXT_LEN, exp.model.visual_dim,
                                exp.model.speech_dim,
                                vocab_size=exp.model.bert.vocab_size, seed=0)
        one = Predictor(exp, params, BATCH, "cuda").predict_split(split)
        del params
        torch.cuda.empty_cache()
        _, serve_s = spawn_ranks("dp serving", lambda r, port: [
            "--predict-worker", os.path.join(tmp, f"serve{r}"), str(r),
            str(port)], tmp)
        served = [read_rank(os.path.join(tmp, f"serve{r}")) for r in range(2)]
        n_batches = -(-N_SERVE // BATCH)
        for r, (info, preds) in enumerate(served):
            if info["launches"] != serving_launches(24, n_batches) or \
                    preds.shape != (N_SERVE,):
                raise AssertionError(f"dp serving rank {r}: {info}, "
                                     f"{preds.shape}")
        if not np.array_equal(served[0][1], served[1][1]):
            raise AssertionError("dp serving: the ranks' arrays differ")
        atol, rtol = ATTN_TOL["bfloat16"]
        err = check_close("dp=2 predictions", torch.from_numpy(served[0][1]),
                          torch.from_numpy(one), atol, rtol)
        print(f"dp=2 serving bf16 bert-large B={BATCH} ({BATCH // 2} rows a "
              f"rank): {N_SERVE} samples, the same array on both ranks, "
              f"max |diff| {err:.3e} against dp=1; "
              f"{N_SERVE / served[0][0]['seconds']:.2f} samples/s a rank "
              f"pair ({serve_s:.1f} s for both ranks with start-up); phase "
              f"{time.perf_counter() - t_phase:.1f} s", flush=True)
    return {"training": ranks[0][0]["launches"],
            "tiny_training": infos[0]["launches"],
            "serving": served[0][0]["launches"], "comm_ms_step": comm}


def with_sp(exp, sp):
    return dataclasses.replace(exp, train=dataclasses.replace(
        exp.train, sequence_parallel=sp))


def tp_inputs():
    """What phase 6h's reference and its ranks share: the frame-level
    experiment and batch (B=16, Lp=984, dropout 0) and the served split."""
    from msa_tpu_torch.data import MultimodalDataset, synthetic_split

    fexp = no_dropout(frame_experiment(
        FRAME_PAIR_LEN, train_batch_size=FRAME_BATCH,
        compute_dtype="bfloat16", data_parallel=1))
    cfg = fexp.model
    fbatch = next(iter(MultimodalDataset(synthetic_split(
        FRAME_BATCH, TEXT_LEN, cfg.visual_dim, cfg.speech_dim,
        vocab_size=cfg.bert.vocab_size, seed=2,
        pair_seq_length=FRAME_PAIR_LEN), seed=0).epoch_batches(0, FRAME_BATCH)))
    split = synthetic_split(TP_SERVE, TEXT_LEN, cfg.visual_dim, cfg.speech_dim,
                            vocab_size=cfg.bert.vocab_size, seed=0)
    return fexp, fbatch, split


def tp_worker(out, argv):
    """A rank of ``cli.train --mp 2`` (bert-large, B=96, dropout 0) run
    twice in this process, without and with sequence parallelism (set in
    the experiment: JAX's CLI has no flag for it), then on the same model
    group: one train step at the preset's dropout (a digest of the
    replicated leaves), one frame-level step at Lp=984, and the bf16 and
    int8 Predictors on TP_SERVE rows.  Writes ``out``.json (per part: the
    process's kernel launches, losses, the model group's collective ms
    inside the train epochs, peak memory) and ``out``.npz (the UPDATE_LEAVES
    of both cli runs, gathered; the predictions)."""
    import hashlib

    import numpy as np
    import torch

    from msa_tpu_torch.cli import train
    from msa_tpu_torch.configs import build_experiment
    from msa_tpu_torch.inference import Predictor
    from msa_tpu_torch.models.weights import init_params, named_leaves
    from msa_tpu_torch.parallel import sharding
    from msa_tpu_torch.training import trainer as trainer_mod

    epoch_comm = [0.0]
    train_epoch = trainer_mod.Trainer.train_epoch

    def timed_epoch(self, *a, **k):  # the model group's time in training
        before = self.model_comm_seconds
        result = train_epoch(self, *a, **k)
        epoch_comm[0] += self.model_comm_seconds - before
        return result

    trainer_mod.Trainer.train_epoch = timed_epoch
    flags_config = train.build_config
    report, arrays = {}, {}

    def part(name, fn):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        epoch_comm[0] = 0.0
        t0 = time.perf_counter()
        info = fn()
        torch.cuda.synchronize()
        info.update(launches=kernel_counts(), seconds=time.perf_counter() - t0,
                    peak_gib=torch.cuda.max_memory_allocated() / 2**30)
        report[name] = info

    def cli(sp):
        train.build_config = lambda args: with_sp(no_dropout(
            flags_config(args)), sp)
        trainer, state, result = train.run(train.build_parser().parse_args(
            argv))
        leaves = dict(named_leaves(state.params))
        for k in UPDATE_LEAVES:
            dim = sharding.split_dim(k)
            leaf = leaves[k].detach()
            arrays[f"sp{int(sp)} {k}"] = (leaf if dim is None else
                                          trainer.mp.all_gather(leaf, dim)
                                          ).float().cpu().numpy()
        return {"step": state.step, "history": result.history,
                "mp": [trainer.mp.size, trainer.mp.index,
                       trainer.mp.sequence_parallel],
                "remat": trainer.remat_policy,
                "backend": torch.distributed.get_backend(),
                "comm_ms_step": epoch_comm[0] * 1e3 / state.step}

    for sp in (False, True):
        part(f"sp{int(sp)}", lambda: cli(sp))
    train.build_config = flags_config
    args = train.build_parser().parse_args(argv)
    exp = with_sp(train.build_config(args), True)

    def dropout_step():
        """One step at the preset's dropout, sequence parallel: the model
        ranks must end on bit-equal replicated leaves."""
        trainer = trainer_mod.Trainer(exp, "cuda")
        state = trainer.init_state(args.seed, 100)
        batch = next(iter(train.load_splits(args)[0].epoch_batches(
            0, BATCH, shuffle=True)))
        state, m = trainer.train_step(state, batch, args.seed)
        digest = hashlib.sha256()
        for k, v in sorted(named_leaves(state.params)):
            if sharding.split_dim(k) is None:
                digest.update(k.encode())
                digest.update(v.detach().cpu().numpy().tobytes())
        return {"loss": float(m["loss"]), "digest": digest.hexdigest()}

    part("dropout", dropout_step)
    fexp, fbatch, split = tp_inputs()

    def frame_step():
        trainer = trainer_mod.Trainer(with_sp(dataclasses.replace(
            fexp, train=dataclasses.replace(fexp.train, model_parallel=2)),
            True), "cuda")
        state = trainer.init_state(0, 100)
        state, m = trainer.train_step(state, fbatch, 1)
        return {k: float(v) for k, v in m.items()}

    part("frame", frame_step)
    sexp = build_experiment("mosi", "bert-large-uncased", num_labels=1,
                            data_parallel=1, model_parallel=2)
    for mode in ("bf16", "int8"):
        def serve(mode=mode):
            params = init_params(sexp.model, torch.Generator(
                device="cuda").manual_seed(0))
            pred = Predictor(sexp, params, BATCH, "cuda",
                             quantize=None if mode == "bf16" else mode)
            del params
            arrays[f"serve {mode}"] = pred.predict_split(split)
            return {}
        part(f"serve_{mode}", serve)
    np.savez(out + ".npz", **arrays)
    with open(out + ".json", "w") as f:
        json.dump(report, f)
    return 0


def phase_one_local_head():
    """Every attention kernel entry a tensor-parallel path takes, at one
    local head of d = 32 (the tiny preset at mp = 2: H / mp = 32): the
    kernel phases of the short forward and backward (whole-row, tiled,
    v3), flash2 and the head-split flash attention under
    :func:`head_widths`, with their checks and tolerances, from a
    generator of their own (v2s, v2p and v1 run on no such path; ln_quant
    and the joint embed see the whole, replicated width)."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(33)
    t0 = time.perf_counter()
    with head_widths(32, 1):
        print(f"one local head: H={HIDDEN}, {HEADS} head", flush=True)
        phase_attention(gen)
        phase_attention_backward(gen)
        phase_v3_kernels(gen)
        phase_tiled_backward()
        phase_flash2(gen)
        phase_flash2_backward(gen)
        phase_flash_attention(gen)
    print(f"one local head: every kernel check passed in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)


def phase_tensor_parallel():
    """Tensor and sequence parallelism in two processes on the one card,
    over gloo (NCCL refuses two ranks on one device), every rank launched
    as ``python -m msa_tpu_torch.cli.train --mp 2 --coordinator
    127.0.0.1:<port> --num_processes 2 --process_id r`` (through this
    script's ``--tp-worker``, which calls the CLI's ``run`` twice and then
    runs the other parts on the same model group):

    * bert-large, global B=96 on both ranks, 8 of the 16 heads and half
      the FFN and vocabulary a rank, dropout 0, one epoch of 1 + 2 steps,
      without and with sequence parallelism: the epoch losses within bf16
      GRAD_TOL, and the UPDATE_LEAVES' updates within UPDATE_RTOL, of a
      one-process epoch on the same batches; the launches (the short v2
      pair only: JAX's head-parallel attention takes neither v2s nor v2p);
      peak memory and the model group's collective ms a step;
    * one step at the preset's dropout under sequence parallelism: both
      ranks end on bit-equal replicated leaves (no rank forked the
      residual stream with a mask of its own);
    * frame level, B=16, Lp=984 (flash2 at 8 local heads), one step at
      dropout 0 with sequence parallelism, against one process;
    * the bf16 and int8 Predictors against mp=1;
    * the tiny preset (2 heads: 1 a rank, d = 32) at dp=2 x mp=2 in four
      processes: two epochs and ``--resume`` from the first epoch's
      checkpoint end on bit-equal whole parameters on every rank, after
      every attention kernel entry of these paths was checked at one local
      head of d = 32 (:func:`phase_one_local_head`).

    gloo stages every collective through the host and two ranks share one
    H100, so the collective times describe that setup, not scaling."""
    import numpy as np
    import torch

    from msa_tpu_torch.cli import train
    from msa_tpu_torch.configs import build_experiment
    from msa_tpu_torch.inference import Predictor
    from msa_tpu_torch.models.weights import init_params
    from msa_tpu_torch.ops.flash2 import use_fused_backward
    from msa_tpu_torch.training.checkpoint import epoch_dir
    from msa_tpu_torch.training.trainer import Trainer

    t_phase = time.perf_counter()
    phase_one_local_head()
    atol, rtol = GRAD_TOL["bfloat16"]
    with tempfile.TemporaryDirectory() as tmp:
        # the one-process references first, in this process
        big = dp_cli_argv("bert-large-uncased", TP_SYNTHETIC, BATCH, 1,
                          os.path.join(tmp, "big"))
        args = train.build_parser().parse_args(big)
        train_ds = train.load_splits(args)[0]
        trainer = Trainer(no_dropout(train.build_config(args)), "cuda")
        state = trainer.init_state(args.seed, train_ds.num_batches(BATCH))
        start = {k: params_leaf(state.params, k) for k in UPDATE_LEAVES}
        state, em = trainer.train_epoch(state, train_ds, 0, args.seed)
        ref = em.averaged()
        ref_leaves = {k: params_leaf(state.params, k) for k in UPDATE_LEAVES}
        del trainer, state
        fexp, fbatch, split = tp_inputs()
        trainer = Trainer(fexp, "cuda")
        state = trainer.init_state(0, 100)
        frame_ref = {k: float(v) for k, v in
                     trainer.train_step(state, fbatch, 1)[1].items()}
        del trainer, state
        exp = build_experiment("mosi", "bert-large-uncased", num_labels=1)
        params = init_params(exp.model, torch.Generator(
            device="cuda").manual_seed(0))
        serve_ref = {mode: Predictor(
            exp, params, BATCH, "cuda",
            quantize=None if mode == "bf16" else mode).predict_split(split)
            for mode in ("bf16", "int8")}
        del params
        torch.cuda.empty_cache()
        ref_s = time.perf_counter() - t_phase

        outs, big_s = spawn_ranks("tp bert-large", lambda r, port: [
            "--tp-worker", os.path.join(tmp, f"tp{r}"), "--", *big,
            *dp_launch(r, port, 1, 2)], tmp, timeout=TP_TIMEOUT)
        ranks = []
        for r in range(2):
            with open(os.path.join(tmp, f"tp{r}.json")) as f:
                info = json.load(f)
            with np.load(os.path.join(tmp, f"tp{r}.npz")) as z:
                ranks.append((info, {k: z[k] for k in z.files}))
        steps = TP_SYNTHETIC // BATCH
        want = rung_launches("none", 24, steps)
        want["short_attention"] += 2 * 24 * 2  # one val and one test batch
        want["fused_joint_embed"] += 2 * 2
        lines = []
        for sp in (0, 1):
            for r, (info, _) in enumerate(ranks):
                run = info[f"sp{sp}"]
                if run["launches"] != want or run["step"] != steps or \
                        run["mp"] != [2, r, bool(sp)] or \
                        run["backend"] != "gloo" or run["remat"] != "none":
                    raise AssertionError(f"tp bert-large sp={sp} rank {r}: "
                                         f"{run}, want launches {want}")
            runs = [info[f"sp{sp}"] for info, _ in ranks]
            if any(runs[0]["history"][0]["train"][k] !=
                   runs[1]["history"][0]["train"][k] for k in
                   ("loss", "mlm_loss", "ap_loss", "label_loss", "nce")):
                raise AssertionError(f"tp sp={sp}: the ranks' losses differ: "
                                     f"{[r_['history'] for r_ in runs]}")
            got = runs[0]["history"][0]["train"]
            gaps = {k: abs(got[k] - ref[k]) for k in
                    ("loss", "mlm_loss", "ap_loss", "label_loss", "nce")}
            if not all(g <= atol + rtol * abs(ref[k]) for k, g in gaps.items()):
                raise AssertionError(f"tp sp={sp} losses {got} against one "
                                     f"process {ref}")
            updates = {k: [check_update(f"tp sp={sp} {k}", torch.from_numpy(
                ranks[0][1][f"sp{sp} {k}"]), ref_leaves[k], start[k])]
                for k in UPDATE_LEAVES}
            lines.append(
                f"{'with' if sp else 'without'} sequence parallelism: epoch "
                f"losses against one process max |diff| "
                f"{max(gaps.values()):.2e} ({got['loss']:.5f} against "
                f"{ref['loss']:.5f}); rank 0's "
                f"{update_text(updates, 'one process' + chr(39) + 's')}; the "
                f"model group's collectives "
                f"{[round(r_['comm_ms_step'], 1) for r_ in runs]} ms a step "
                f"a rank; peak {[round(r_['peak_gib'], 2) for r_ in runs]} "
                f"GiB; {runs[0]['seconds']:.1f} s for the run")
        per_step = {k: v for k, v in rung_launches("none", 24, 1).items()
                    if v}
        print(f"tp: mp=2 bert-large bf16 B={BATCH} (the same rows on both "
              f"ranks, 8 heads, H/mp = 512 a rank; two processes on one "
              f"card, gloo), {steps} steps through cli.train; launches a "
              f"step a rank {per_step} (the short v2 pair only); "
              + "; ".join(lines) + f"; {big_s:.1f} s for both ranks' "
              f"parts", flush=True)

        drops = [info["dropout"] for info, _ in ranks]
        if drops[0]["digest"] != drops[1]["digest"] or \
                not math.isfinite(drops[0]["loss"]):
            raise AssertionError(f"tp dropout step: {drops}")
        frames = [info["frame"] for info, _ in ranks]
        fgap = {k: abs(frames[0][k] - frame_ref[k]) for k in
                ("loss", "mlm_loss", "ap_loss", "label_loss", "nce")}
        fused = use_fused_backward(TEXT_LEN + FRAME_PAIR_LEN, 512, 8,
                                   torch.bfloat16)
        fwant = rung_launches("none", 24, 1, frame=True, fused=fused)
        if any(frames[0][k] != frames[1][k] for k in fgap) or not all(
                g <= atol + rtol * abs(frame_ref[k]) for k, g in fgap.items()) \
                or frames[0]["mlm_overflow"] or \
                any(f["launches"] != fwant for f in frames):
            raise AssertionError(f"tp frame step {frames} against one "
                                 f"process {frame_ref}, want launches "
                                 f"{fwant}")
        atol_s, rtol_s = ATTN_TOL["bfloat16"]
        n_batches = -(-TP_SERVE // BATCH)
        serve_err = {}
        for mode in ("bf16", "int8"):
            got = [arr[f"serve {mode}"] for _, arr in ranks]
            want_s = serving_launches(24, n_batches,
                                      None if mode == "bf16" else mode)
            if not np.array_equal(got[0], got[1]) or \
                    ranks[0][0][f"serve_{mode}"]["launches"] != want_s:
                raise AssertionError(f"tp serving {mode}: ranks differ or "
                                     f"launches {ranks[0][0][f'serve_{mode}']}"
                                     f", want {want_s}")
            serve_err[mode] = check_close(
                f"tp serving {mode}", torch.from_numpy(got[0]),
                torch.from_numpy(serve_ref[mode]), atol_s, rtol_s)
        print(f"tp: one step at the preset's dropout with sequence "
              f"parallelism: bit-equal replicated leaves on both ranks "
              f"(loss {drops[0]['loss']:.5f}); frame level B={FRAME_BATCH} "
              f"Lp={FRAME_PAIR_LEN} at mp=2 with sequence parallelism "
              f"(flash2 at 8 local heads, {'fused' if fused else 'split'} "
              f"backward), one step: losses against one process max |diff| "
              f"{max(fgap.values()):.2e} ({frames[0]['loss']:.5f} against "
              f"{frame_ref['loss']:.5f}), peak "
              f"{[round(i['frame']['peak_gib'], 2) for i, _ in ranks]} GiB, "
              f"{ranks[0][0]['frame']['seconds']:.1f} s; serving "
              f"{TP_SERVE} rows at mp=2 against mp=1: bf16 max |diff| "
              f"{serve_err['bf16']:.3e}, int8 {serve_err['int8']:.3e}, the "
              f"same arrays on both ranks ({ranks[0][0]['serve_bf16']['seconds']:.1f}"
              f" / {ranks[0][0]['serve_int8']['seconds']:.1f} s with the "
              f"weights' set-up); references in this process {ref_s:.1f} s",
              flush=True)

        # tiny: dp=2 x mp=2, two epochs, then --resume from epoch 1
        root = os.path.join(tmp, "tiny")
        tiny = dp_cli_argv("tiny", 256, 32, 2, root)
        _, tiny_s = spawn_ranks("tp tiny", lambda r, port: [
            "--cli-worker", os.path.join(tmp, f"tiny{r}"), "preset", "--",
            *tiny, *dp_launch(r, port, 2, 2)], tmp, n=4)
        run = os.path.join(root, "model_save",
                           sorted(os.listdir(os.path.join(root, "model_save")))[0])
        if not os.path.isdir(epoch_dir(run, 0)):
            raise AssertionError(f"tp tiny: no checkpoint of epoch 1 in {run}")
        _, resume_s = spawn_ranks("tp tiny --resume", lambda r, port: [
            "--cli-worker", os.path.join(tmp, f"resume{r}"), "preset", "--",
            *tiny, *dp_launch(r, port, 2, 2), "--resume", epoch_dir(run, 0)],
            tmp, n=4)
        infos = [read_rank(os.path.join(tmp, f"{k}{r}"), ".npz")[0]
                 for k in ("tiny", "resume") for r in range(4)]
        if len({i["digest"] for i in infos}) != 1 or \
                {i["step"] for i in infos} != {16} or \
                [i["mp"] for i in infos[:4]] != [[2, r % 2] for r in range(4)]:
            raise AssertionError(f"tp tiny --resume: digests "
                                 f"{[i['digest'][:12] for i in infos]}, steps "
                                 f"{[i['step'] for i in infos]}, mp "
                                 f"{[i['mp'] for i in infos]}")
        tiny_want = rung_launches("none", 2, 16)
        tiny_want["short_attention"] += 2 * 2 * 4  # val + test, two epochs
        tiny_want["fused_joint_embed"] += 2 * 4
        if infos[0]["launches"] != tiny_want:
            raise AssertionError(f"tp tiny launches {infos[0]['launches']}, "
                                 f"want {tiny_want}")
        print(f"tp: dp=2 x mp=2 tiny preset B=32 (1 head of d=32 a rank) "
              f"through cli.train in four processes: 2 epochs "
              f"({tiny_s:.1f} s), --resume from epoch 1 ({resume_s:.1f} s) "
              f"ends on the uninterrupted run's whole parameters bit for bit "
              f"on all four ranks (step 16); phase "
              f"{time.perf_counter() - t_phase:.1f} s", flush=True)
    info0 = ranks[0][0]
    return {"training": info0["sp0"]["launches"],
            "sp_training": info0["sp1"]["launches"],
            "frame": info0["frame"]["launches"],
            "serving": info0["serve_bf16"]["launches"],
            "int8_serving": info0["serve_int8"]["launches"],
            "tiny_training": infos[0]["launches"],
            "comm_ms_step": [info0["sp0"]["comm_ms_step"],
                             info0["sp1"]["comm_ms_step"]]}


def timed(fn, *args, **kwargs):
    """``fn(*args, **kwargs)``, its wall seconds printed on a line of their
    own (where the script's time goes)."""
    t0 = time.perf_counter()
    out = fn(*args, **kwargs)
    print(f"[{fn.__name__}: {time.perf_counter() - t0:.1f} s]", flush=True)
    return out


# The head dims each attention kernel ran at in this script's checks: every
# one at the presets' 32 and 64 and at 26 and 128 (phase_head_dims), v2's
# and flash2's forwards and backwards also at 8 and 16; the widths ln_quant
# and the joint embed ran at.
ALL_HEAD_DIMS = [8, 16, 26, 32, 64, 128, 192, 256]
FULL_HEAD_DIMS = [26, 32, 64, 128, 192, 256]
LN_QUANT_RAN_AT = sorted({HIDDEN, 64, *LN_QUANT_WIDTHS})
EMBED_RAN_AT = sorted({HIDDEN, 64, 768, 1000, 1001, WIDE_EMBED[0],
                       HUGE_EMBED[0]})
# Each drawing kernel's timing in time_rates, by its kernels-line name
RATE_TIMED = {
    "short_attention": "short_attention (training form)",
    "short_attention_backward": "short_attention_backward",
    "dropout_keep_mask": "dropout_keep_mask",
    "flash2_fwd": "flash2_fwd (training form)",
    "flash2_bwd_fused": "flash2_bwd_fused", "flash2_bwd_split": "flash2_bwd_split",
    "short_attention_probs": "short_attention_probs",
    "short_attention_probs_backward": "short_attention_probs_backward",
    "short_attention_packed": "short_attention_packed",
    "short_attention_packed_backward": "short_attention_packed_backward",
    "short_attention_v3_backward": "short_attention_v3_backward",
    "flash_attention_fwd": "flash_attention_fwd (training form)",
    "flash_attention_bwd": "flash_attention_bwd",
    "short_attention_v1_fwd": "short_attention_v1",
    "short_attention_v1_bwd": "short_attention_v1_backward",
    "short_attention_backward_tiled": "short_attention_backward tiled [{},{}]"
                                      .format(*TILED_TIMING_SHAPES[-1])}


def kernel_entry(name, source, replaces, launches, err, timing, by_path,
                 head_dims=None, widths=None):
    ms, plain_ms, lib_ms, (bound, bound_by) = timing
    entry = {"name": name, "route": "cuda", "source": source,
             "replaces": replaces, "launches": launches, "max_abs_err": err,
             "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
             "bound_by": bound_by, "library_ms": lib_ms,
             "launches_by_path": by_path}
    if head_dims:
        entry["head_dims"] = head_dims
    if widths:
        entry["widths"] = widths
    return entry


def main() -> int:
    import torch

    worker = sys.argv[1:2] in (["--cli-worker"], ["--predict-worker"],
                               ["--tp-worker"])
    if not worker and (len(sys.argv) not in (1, 3) or sys.argv[1:2] not in (
            [], ["--flash-times"], ["--short-times"])):
        print("usage: chip_smoke.py [--flash-times ROOT | --short-times ROOT]",
              file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    if sys.argv[1:2] == ["--cli-worker"]:  # --cli-worker OUT DROPOUT -- ARGV
        return cli_worker(sys.argv[2], sys.argv[3], sys.argv[5:])
    if sys.argv[1:2] == ["--predict-worker"]:  # --predict-worker OUT RANK PORT
        return predict_worker(sys.argv[2], int(sys.argv[3]), int(sys.argv[4]))
    if sys.argv[1:2] == ["--tp-worker"]:  # --tp-worker OUT -- ARGV
        return tp_worker(sys.argv[2], sys.argv[4:])
    if len(sys.argv) == 3:  # timings of the tree at ROOT only
        sys.path.insert(0, os.path.abspath(sys.argv[2]))
        if sys.argv[1] == "--flash-times":
            time_flash_path()
        else:
            time_short_path()
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
    for lib in _build.build_all(seconds=nvcc_s).values():
        print(f"built {os.path.relpath(lib)}", flush=True)
    print(f"kernel build: {time.perf_counter() - t0:.1f} s; nvcc wall s "
          f"per library (an attention source once a head dim, all started "
          f"together on {os.cpu_count()} CPUs): "
          f"{ {k: round(v, 1) for k, v in nvcc_s.items()} }", flush=True)
    # ptxas's report, kept beside each library by the build
    usage = _build.resource_usage(TC_SOURCES + (
        "flash2", "flash_attention", "fused_joint_embed"))
    report_tc_resources(usage)
    report_redesigned(usage)
    report_wgmma(usage)
    report_wide(usage)

    gen = torch.Generator(device="cuda").manual_seed(0)
    attn_err, attn_times = timed(phase_attention, gen)
    bwd_err, bwd_times = timed(phase_attention_backward, gen)
    drop = timed(phase_dropout, gen)
    embed_err, embed_times = timed(phase_joint_embed, gen)
    lnq_err, lnq_times = timed(phase_ln_quant, gen)

    f2_err, f2_times = timed(phase_flash2, gen)
    f2_bwd_err, f2_bwd_times = timed(phase_flash2_backward, gen)
    pp_err, pp_times = timed(phase_probs_packed, gen)
    adamw_err, adamw_times = timed(phase_fused_adamw, gen)
    v3_err, v3_times = timed(phase_v3_kernels, gen)
    tiled_err = timed(phase_tiled_backward)
    tiled_times = timed(time_short_backwards, with_plain=True)
    fa_err, fa_times = timed(phase_flash_attention, gen)
    v1_err, v1_times = timed(phase_short_v1, gen)
    timed(phase_wgmma_flash)
    timed(probe_flash2_dq)
    timed(time_flash_backwards)
    timed(phase_head_dim_32)
    head_dims, wide = timed(phase_head_dims)
    wide_dims, huge_embed = timed(phase_head_dim_256)
    rate_times = timed(phase_dropout_rates)
    timed(phase_tiny_preset)
    tinybert, _ = timed(phase_tinybert)
    wide_heads, _ = timed(phase_wide_heads)
    base_launches = timed(phase_bert_base_preset)
    orbax = timed(phase_orbax)
    for path, names in (("training", ("short_attention",
                                      "short_attention_backward",
                                      "fused_joint_embed")),
                        ("serving", ("short_attention",
                                     "fused_joint_embed"))):
        missing = [n for n in names if not orbax[path][n]]
        if missing:
            raise AssertionError(f"orbax {path}: no launch of {missing}")

    exp = build_experiment("mosi", "bert-large-uncased", num_labels=1)
    params = init_params(exp.model, torch.Generator(device="cuda").manual_seed(0))
    pred, split, serve_launches = timed(phase_serving, exp, params)
    timed(phase_service, pred)
    int8_launches, _, int8_preds, int8_outs, calib = timed(
        phase_int8_serving, exp, params, pred, split)
    del pred
    fuse_launches, _ = timed(phase_fuse_qkv, exp, params, split,
                             int8_preds, int8_outs, calib)
    del int8_preds
    frame_serve_launches, _ = timed(phase_frame_serving, params)
    timed(phase_service_cli, exp, params)
    del params
    torch.cuda.empty_cache()
    train_launches, _ = timed(phase_training)
    torch.cuda.empty_cache()
    frame_train_launches, _ = timed(
        phase_frame_training,
        FRAME_PAIR_LEN, FRAME_BATCH, None, FRAME_WARMUP, FRAME_STEPS,
        "frame-level")
    torch.cuda.empty_cache()
    long_launches, _ = timed(
        phase_frame_training,
        LONG_PAIR_LEN, LONG_BATCH, LONG_LAYERS, 1, 1, "long-S")
    torch.cuda.empty_cache()
    frame_short = timed(phase_frame_short)
    torch.cuda.empty_cache()
    rungs = timed(phase_remat_rungs)
    pr6_inputs = train_inputs(3)
    fused_runs = timed(phase_fused_train, *pr6_inputs)
    v3_runs = timed(phase_v3_train, *pr6_inputs)
    del pr6_inputs
    torch.cuda.empty_cache()
    frame_rungs = timed(phase_frame_rungs)
    torch.cuda.empty_cache()
    frame_flash = timed(phase_frame_flash)
    torch.cuda.empty_cache()
    auto_launches = timed(phase_auto)
    cli_launches = timed(phase_entry_point)
    torch.cuda.empty_cache()
    fuse = timed(phase_fuse_text_pass)
    dp = timed(phase_data_parallel)
    tp = timed(phase_tensor_parallel)
    timed(phase_f32_train)
    timed(phase_f32_train, pair_len=FRAME_PAIR_LEN, batch_size=4)

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
                "frame_flash_save_ctx": frame_flash["save_ctx"][name],
                "fuse_text_pass_training": fuse["training"][name],
                "fuse_text_pass_serving": fuse["serving"][name],
                "dp_training_rank0": dp["training"][name],
                "dp_tiny_training_rank0": dp["tiny_training"][name],
                "dp_serving_rank0": dp["serving"][name],
                "tp_training_rank0": tp["training"][name],
                "tp_sp_training_rank0": tp["sp_training"][name],
                "tp_frame_training_rank0": tp["frame"][name],
                "tp_serving_rank0": tp["serving"][name],
                "tp_int8_serving_rank0": tp["int8_serving"][name],
                "tp_tiny_training_rank0": tp["tiny_training"][name],
                "orbax_resume_training": orbax["training"][name],
                "orbax_serving": orbax["serving"][name],
                **{f"tinybert_{p}": tinybert[p][name] for p in tinybert},
                **{f"wide_heads_{p}": wide_heads[p][name] for p in wide_heads},
                "bert_base_cli_train": base_launches[name],
                **{f"frame_short_{rule}": r["launches"][name]
                   for rule, r in frame_short.items()}}

    def rung(policy, name):  # launches per step under that rung
        return rungs[policy]["per_step"].get(name, 0)

    joint = ("joint", "bfloat16")
    frame_shape = "[{},{}]".format(*TILED_TIMING_SHAPES[-1])

    def tiled_entry(name, rule, replaces):
        """The tiled pair of ``name`` (rule ``rule``) at the frame-level
        joint shape, rate 0; its launches from the Lp = 500 run of it."""
        b, s = TILED_TIMING_SHAPES[-1]
        timing = (tiled_times[f"{rule} {frame_shape} rate 0"],
                  tiled_times[f"{rule} plain {frame_shape}"],
                  tiled_times[f"sdpa bwd {frame_shape}"],
                  tiled_backward_bound(b, s, torch.bfloat16, rule))
        return kernel_entry(
            f"{name}_tiled", "msa_tpu_torch/csrc/short_bwd_tiled.cuh",
            f"msa_tpu/ops/short_attention.py:{replaces}",
            frame_short[rule]["launches"][f"{name}_tiled"], tiled_err[rule],
            timing, paths(f"{name}_tiled"), head_dims=FULL_HEAD_DIMS)

    kernels = [
        kernel_entry("short_attention", "msa_tpu_torch/csrc/short_fwd_tc.cuh",
                     "msa_tpu/ops/short_attention.py:303",
                     train_launches["short_attention"], attn_err,
                     attn_times[joint], paths("short_attention"),
                     head_dims=ALL_HEAD_DIMS),
        kernel_entry("short_attention_backward",
                     "msa_tpu_torch/csrc/short_bwd_tc.cuh",
                     "msa_tpu/ops/short_attention.py:336",
                     train_launches["short_attention_backward"], bwd_err,
                     bwd_times[joint + (0.0,)],
                     paths("short_attention_backward"),
                     head_dims=ALL_HEAD_DIMS),
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
                     paths("fused_joint_embed"),
                     widths=EMBED_RAN_AT),
        kernel_entry("ln_quant_static", "msa_tpu_torch/csrc/ln_quant.cu",
                     "msa_tpu/ops/ln_quant.py:36",
                     int8_launches["int8_static"]["ln_quant_static"],
                     lnq_err["static"],
                     lnq_times[("static",) + joint], paths("ln_quant_static"),
                     widths=LN_QUANT_RAN_AT),
        kernel_entry("ln_quant_dynamic", "msa_tpu_torch/csrc/ln_quant.cu",
                     "msa_tpu/ops/ln_quant.py:51",
                     int8_launches["int8"]["ln_quant_dynamic"],
                     lnq_err["dynamic"],
                     lnq_times[("dynamic",) + joint], paths("ln_quant_dynamic"),
                     widths=LN_QUANT_RAN_AT),
        kernel_entry("flash2_fwd", "msa_tpu_torch/csrc/flash2.cu",
                     "msa_tpu/ops/flash2.py:121",
                     frame_train_launches["flash_attention2"], f2_err,
                     f2_times[("frame", "bfloat16")], paths("flash_attention2"),
                     head_dims=ALL_HEAD_DIMS),
        kernel_entry("flash2_bwd_fused", "msa_tpu_torch/csrc/flash2.cu",
                     "msa_tpu/ops/flash2.py:355",
                     frame_train_launches["flash2_bwd_fused"], f2_bwd_err[True],
                     f2_bwd_times[("frame", "bfloat16", True)],
                     paths("flash2_bwd_fused"),
                     head_dims=ALL_HEAD_DIMS),
        kernel_entry("flash2_bwd_split", "msa_tpu_torch/csrc/flash2.cu",
                     "msa_tpu/ops/flash2.py:224",
                     long_launches["flash2_bwd_split"], f2_bwd_err[False],
                     f2_bwd_times[("s4096", "bfloat16", False)],
                     paths("flash2_bwd_split"),
                     head_dims=ALL_HEAD_DIMS),
        kernel_entry("short_attention_probs",
                     "msa_tpu_torch/csrc/short_attention.cu",
                     "msa_tpu/ops/short_attention.py:858",
                     rung("save_attn+drop+probs", "short_attention_probs"),
                     pp_err["probs"], pp_times[("probs",) + joint],
                     paths("short_attention_probs"),
                     head_dims=FULL_HEAD_DIMS),
        kernel_entry("short_attention_probs_backward",
                     "msa_tpu_torch/csrc/short_bwd_tc.cuh",
                     "msa_tpu/ops/short_attention.py:895",
                     rung("save_attn+drop+probs",
                          "short_attention_probs_backward"),
                     pp_err["probs_bwd"], pp_times[("probs_bwd",) + joint],
                     paths("short_attention_probs_backward"),
                     head_dims=FULL_HEAD_DIMS),
        kernel_entry("short_attention_packed",
                     "msa_tpu_torch/csrc/short_fwd_tc.cuh",
                     "msa_tpu/ops/short_attention.py:471",
                     rung("save_pack", "short_attention_packed"),
                     pp_err["packed"], pp_times[("packed",) + joint],
                     paths("short_attention_packed"),
                     head_dims=FULL_HEAD_DIMS),
        kernel_entry("short_attention_packed_backward",
                     "msa_tpu_torch/csrc/short_bwd_tc.cuh",
                     "msa_tpu/ops/short_attention.py:505",
                     rung("save_pack", "short_attention_packed_backward"),
                     pp_err["packed_bwd"], pp_times[("packed_bwd",) + joint],
                     paths("short_attention_packed_backward"),
                     head_dims=FULL_HEAD_DIMS),
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
                     paths("short_attention_v3_backward"),
                     head_dims=FULL_HEAD_DIMS),
        kernel_entry("flash_attention_fwd",
                     "msa_tpu_torch/csrc/flash_attention.cu",
                     "msa_tpu/ops/attention.py:117",
                     frame_flash["training"]["flash_attention"], fa_err["fwd"],
                     fa_times["fwd"], paths("flash_attention"),
                     head_dims=FULL_HEAD_DIMS),
        kernel_entry("flash_attention_bwd",
                     "msa_tpu_torch/csrc/flash_attention.cu",
                     "msa_tpu/ops/attention.py:171",
                     frame_flash["training"]["flash_attention_backward"],
                     fa_err["bwd"], fa_times["bwd"],
                     paths("flash_attention_backward"),
                     head_dims=FULL_HEAD_DIMS),
        kernel_entry("short_attention_v1_fwd",
                     "msa_tpu_torch/csrc/short_fwd_tc.cuh",
                     "msa_tpu/ops/short_attention.py:139",
                     train_launches["short_attention_v1"], v1_err["fwd"],
                     v1_times[("fwd",) + joint], paths("short_attention_v1"),
                     head_dims=FULL_HEAD_DIMS),
        kernel_entry("short_attention_v1_bwd",
                     "msa_tpu_torch/csrc/short_bwd_tc.cuh",
                     "msa_tpu/ops/short_attention.py:177",
                     train_launches["short_attention_v1_backward"],
                     v1_err["bwd"], v1_times[("bwd",) + joint],
                     paths("short_attention_v1_backward"),
                     head_dims=FULL_HEAD_DIMS),
        tiled_entry("short_attention_backward", "v2", 336),
        tiled_entry("short_attention_v3_backward", "v3", 392),
        tiled_entry("short_attention_probs_backward", "v2s", 895),
        tiled_entry("short_attention_packed_backward", "v2p", 505),
    ]
    # each kernel's times at the other head dims and widths it ran at (a head
    # dim off the instantiations: its pad and cut inside each timed call)
    def timing(t):
        ms, plain_ms, lib_ms, (bound, _) = t
        return {"ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                "bound_ms": bound}

    at_dims = {
        "short_attention": ("attention", joint),
        "short_attention_backward": ("attention_backward", joint + (0.0,)),
        "flash2_fwd": ("flash2", ("frame", "bfloat16")),
        "flash2_bwd_fused": ("flash2_backward", ("frame", "bfloat16", True)),
        "flash2_bwd_split": ("flash2_backward", ("s4096", "bfloat16", False)),
        "short_attention_probs": ("probs_packed", ("probs",) + joint),
        "short_attention_probs_backward": ("probs_packed",
                                           ("probs_bwd",) + joint),
        "short_attention_packed": ("probs_packed", ("packed",) + joint),
        "short_attention_packed_backward": ("probs_packed",
                                            ("packed_bwd",) + joint),
        "short_attention_v3_backward": ("v3", joint),
        "flash_attention_fwd": ("flash_attention", "fwd"),
        "flash_attention_bwd": ("flash_attention", "bwd"),
        "short_attention_v1_fwd": ("v1", ("fwd",) + joint),
        "short_attention_v1_bwd": ("v1", ("bwd",) + joint)}
    for entry in kernels:
        if entry["name"] in at_dims:
            phase, key = at_dims[entry["name"]]
            entry["by_head_dim"] = {
                str(d): timing(res[phase][1][key])
                for d, res in head_dims.items() if phase in res}
            entry["by_head_dim"].update({
                str(d): timing(res[entry["name"]])
                for d, res in wide_dims.items()})
        if entry["name"] not in ("fused_joint_embed", "ln_quant_static",
                                 "ln_quant_dynamic", "fused_adamw"):
            # every attention kernel draws by either rule of dropout.cuh
            entry["dropout_rules"] = ["byte (t/256)", "word (any rate)"]
        if entry["name"] in RATE_TIMED:
            entry["ms_by_rate"] = {
                f"{rate:g}": ms
                for rate, ms in rate_times[RATE_TIMED[entry["name"]]].items()}
        if entry["name"].startswith("ln_quant_"):
            mode = entry["name"].split("_")[-1]
            entry["by_width"] = {
                str(h): timing(r[1][(mode, "text", "bfloat16")])
                for h, r in wide["ln_quant"].items()}
        if entry["name"] == "fused_joint_embed":
            entry["by_width"] = {str(WIDE_EMBED[0]): timing(
                wide["joint_embed"][1]), str(HUGE_EMBED[0]): timing(
                huge_embed[1])}
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
