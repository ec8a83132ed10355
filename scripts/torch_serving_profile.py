#!/usr/bin/env python3
"""Where the port's serving time goes on one NVIDIA GPU, and what the
short-attention kernel is worth end to end.

    python3 scripts/torch_serving_profile.py [--quantize int8|int8_static]
                                             [--out FILE.json]
    python3 scripts/torch_serving_profile.py --pair-seq-length 984 --batch 16

Serves a ragged synthetic MOSI split through ``msa_tpu_torch``'s
``Predictor`` (bf16, or an int8 mode with static scales calibrated on the
split's first two batches) with a full-width bert-large MMBert (random
weights from a seed; B=96, L=40, as chip_smoke.py drives it; with
``--pair-seq-length Lp`` in frame-level mode, Lp frames per modality, so
the joint pass runs at S = 40 + Lp and, from 1024, on the flash2 kernel),
then:

  1. A/B, alternating in one process: samples/s with the attention
     kernels (``use_flash_attention="auto"``) against the plain attention
     on the card (``"never"``), order K P P K K P P K;
  2. host enqueue against enqueue plus device time, per batch;
  3. ``torch.profiler`` over a few batches: device kernel time per batch
     by kernel name, in order, the kernels' sum and their union against
     the wall time of the profiled region;
  4. with ``--quantize``: each piece of the int8 projections (quantize
     pass, int8 GEMM, dequant epilogue, ln_quant) timed alone at the
     path's shapes with CUDA events and summed per batch, beside the bf16
     GEMMs they replace.

Prints one line per result and, last, a JSON object with every number;
``--out`` writes the same object to a file.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import re
import statistics
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BATCH = 96
TEXT_LEN = 40
# kernel-name families for the breakdown, checked in order
FAMILIES = (
    ("short_attention", r"short_attention_fwd_kernel"),
    ("flash2", r"flash2_fwd_kernel"),
    ("fused_joint_embed", r"fused_joint_embed_kernel"),
    ("ln_quant", r"ln_quant_kernel"),
    ("int8_gemm", r"s8|i8|int8|imma"),
    ("gemm", r"nvjet|gemm|cutlass|xmma|cublas"),
    ("layer_norm", r"layer_norm|LayerNorm"),
    ("gelu", r"gelu|GeluCUDA|tanh"),
)


def family(name: str) -> str:
    for fam, pattern in FAMILIES:
        if re.search(pattern, name):
            return fam
    return "other"


# cycles of the spin kernel that holds the stream while cuda_ms queues its
# timed calls: ~25 ms at the H100's clock, longer than the host takes to
# queue 20 calls of any function timed here
HOLD_CYCLES = 50_000_000


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


def int8_pieces(quantize: str, layers: int, hidden: int, ffn: int,
                batch: int, pair_len=None) -> dict:
    """ms per batch of each piece of the int8 projections, each timed alone
    at the path's row counts and multiplied by its count per batch (per
    encoder call and layer: q, k, v, o at [H, H], wi [H, 4H], wo [4H, H];
    quantize passes on the q/k/v input (one for the three), o's and wo's,
    per row in ``int8``; on o's and wo's at a static scale in
    ``int8_static``), beside the bf16 GEMMs."""
    import torch
    import torch.nn.functional as F

    from msa_tpu_torch.ops.ln_quant import ln_quant
    from msa_tpu_torch.ops.quant import int8_matmul_pre, int8_mm, quantize_act

    static = quantize == "int8_static"
    gen = torch.Generator(device="cuda").manual_seed(1)
    ascale = torch.tensor(4.0 / 127, device="cuda")
    # (K, N, projections of that shape per layer)
    projections = ((hidden, hidden, 4), (hidden, ffn, 1), (ffn, hidden, 1))
    quantized_inputs = {hidden: 1 if static else 2, ffn: 1}
    out = {"quantize": 0.0, "int8_gemm": 0.0, "dequant_epilogue": 0.0,
           "ln_quant": 0.0, "bf16_gemm": 0.0}
    joint = TEXT_LEN + (pair_len or TEXT_LEN)
    for rows in (batch * TEXT_LEN, 2 * batch * joint):
        for k, count in quantized_inputs.items():
            x = torch.randn(rows, k, device="cuda", generator=gen).bfloat16()
            sc = ascale if static else None
            out["quantize"] += count * layers * cuda_ms(
                lambda: quantize_act(x, sc))
        for k, n, count in projections:
            x = torch.randn(rows, k, device="cuda", generator=gen).bfloat16()
            xi, row = quantize_act(x, ascale if static else None)
            w = torch.randint(-127, 128, (n, k), dtype=torch.int8,
                              device="cuda", generator=gen)
            qs, b = torch.rand(n, device="cuda"), torch.zeros(n, device="cuda")
            gemm = cuda_ms(lambda: int8_mm(xi, w))
            both = cuda_ms(lambda: int8_matmul_pre(xi, row, w, qs, b,
                                                   torch.bfloat16))
            wb = torch.randn(n, k, device="cuda", generator=gen).bfloat16()
            out["int8_gemm"] += count * layers * gemm
            out["dequant_epilogue"] += count * layers * (both - gemm)
            out["bf16_gemm"] += count * layers * cuda_ms(
                lambda: F.linear(x, wb, b.bfloat16()))
        x, res = (torch.randn(rows, hidden, device="cuda", generator=gen)
                  .bfloat16() for _ in range(2))
        ln = {"scale": torch.ones(hidden, device="cuda"),
              "bias": torch.zeros(hidden, device="cuda")}
        sites = 2 if static else 1
        out["ln_quant"] += sites * layers * cuda_ms(
            lambda: ln_quant(x, res, ln, 1e-12, ascale if static else None))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=BATCH)
    ap.add_argument("--pair-seq-length", type=int, default=None,
                    help="frame-level mode: Lp frames per modality")
    ap.add_argument("--samples", type=int, default=None,
                    help="default: five batches, the last one ragged")
    ap.add_argument("--reps", type=int, default=4,
                    help="timed runs per arm of the A/B")
    ap.add_argument("--profile-batches", type=int, default=3)
    ap.add_argument("--quantize", choices=["int8", "int8_static"], default=None)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    batch_size = args.batch
    if args.samples is None:
        args.samples = 5 * batch_size - 23

    sys.path.insert(0, REPO)
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from msa_tpu_torch.configs import build_experiment
    from msa_tpu_torch.data import synthetic_split
    from msa_tpu_torch.inference import Predictor
    from msa_tpu_torch.models.weights import init_params

    if not torch.cuda.is_available():
        print("torch_serving_profile: CUDA is not available", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(f"card: {card}", flush=True)
    result = {"card": card, "torch": torch.__version__,
              "cuda": torch.version.cuda, "batch": batch_size,
              "text_len": TEXT_LEN, "pair_seq_length": args.pair_seq_length,
              "samples": args.samples,
              "quantize": args.quantize}

    exp = build_experiment("mosi", "bert-large-uncased", num_labels=1)
    exp = dataclasses.replace(exp, data=dataclasses.replace(
        exp.data, pair_seq_length=args.pair_seq_length))
    cfg = exp.model
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
    split = synthetic_split(args.samples, TEXT_LEN, cfg.visual_dim,
                            cfg.speech_dim, vocab_size=cfg.bert.vocab_size,
                            seed=0, pair_seq_length=args.pair_seq_length)

    calibration = dataclasses.replace(split, **{
        f: getattr(split, f)[:2 * batch_size] for f in (
            "input_ids", "attention_mask", "visual", "speech", "target")})

    def predictor(use_flash):
        e = dataclasses.replace(exp, train=dataclasses.replace(
            exp.train, use_flash_attention=use_flash))
        return Predictor(e, params, batch_size, "cuda", quantize=args.quantize,
                         calibration=calibration
                         if args.quantize == "int8_static" else None)

    arms = {"kernel": predictor("auto"), "plain": predictor("never")}
    for pred in arms.values():
        pred.predict_split(split)  # first use: kernels, cuBLAS handles

    # 1. A/B
    rates = {name: [] for name in arms}
    for name in ("kernel", "plain", "plain", "kernel") * (args.reps // 2):
        t0 = time.perf_counter()
        arms[name].predict_split(split)  # ends in a device-to-host copy
        rates[name].append(args.samples / (time.perf_counter() - t0))
    result["ab_samples_per_s"] = rates
    for name, r in rates.items():
        print(f"A/B {name}: samples/s {r}", flush=True)

    # 2. host enqueue against enqueue + device, one full batch
    pred = arms["kernel"]
    batch = [pred._upload(np.asarray(x)[:batch_size]) for x in (
        split.input_ids, split.attention_mask, split.visual, split.speech)]
    torch.cuda.synchronize()
    enqueue, total = [], []
    for _ in range(7):
        t0 = time.perf_counter()
        pred._forward(*batch)
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        enqueue.append((t1 - t0) * 1e3)
        total.append((time.perf_counter() - t0) * 1e3)
    result["enqueue_ms_median"] = statistics.median(enqueue)
    result["enqueue_plus_device_ms_median"] = statistics.median(total)
    print(f"one batch: host enqueue {result['enqueue_ms_median']:.2f} ms "
          f"(median of 7), enqueue + device "
          f"{result['enqueue_plus_device_ms_median']:.2f} ms", flush=True)

    # 3. profiler breakdown
    n = args.profile_batches * batch_size
    sub = [np.asarray(x)[:n] for x in (split.input_ids, split.attention_mask,
                                       split.visual, split.speech)]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        pred.predict_arrays(*sub)
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.events() if e.device_type.name == "CUDA"]
    if not kernels:
        raise RuntimeError("the profiler recorded no device time")
    per_name, per_family = {}, {}
    spans = []
    for e in kernels:
        us = e.time_range.elapsed_us()
        per_name[e.name] = per_name.get(e.name, 0.0) + us
        fam = family(e.name)
        per_family[fam] = per_family.get(fam, 0.0) + us
        spans.append((e.time_range.start, e.time_range.end))
    spans.sort()
    union, cur_start, cur_end = 0.0, *spans[0]
    for start, end in spans[1:]:
        if start > cur_end:
            union += cur_end - cur_start
            cur_start, cur_end = start, end
        else:
            cur_end = max(cur_end, end)
    union += cur_end - cur_start
    nb = args.profile_batches
    kernel_ms = sum(per_name.values()) / 1e3
    result["profile"] = {
        "batches": nb, "wall_ms_per_batch": wall_ms / nb,
        "kernel_ms_per_batch": kernel_ms / nb,
        "kernel_union_ms_per_batch": union / 1e3 / nb,
        "busy_share": union / 1e3 / wall_ms,
        "family_ms_per_batch": {k: v / 1e3 / nb for k, v in sorted(
            per_family.items(), key=lambda kv: -kv[1])},
        "top_kernels_ms_per_batch": {k: v / 1e3 / nb for k, v in sorted(
            per_name.items(), key=lambda kv: -kv[1])[:15]},
    }
    p = result["profile"]
    print(f"profiler over {nb} batches: wall {p['wall_ms_per_batch']:.2f} "
          f"ms/batch, kernels {p['kernel_ms_per_batch']:.2f} ms/batch "
          f"(union {p['kernel_union_ms_per_batch']:.2f}), busy share "
          f"{p['busy_share']:.3f} (profiler on)", flush=True)
    for fam, ms in p["family_ms_per_batch"].items():
        print(f"  {fam}: {ms:.3f} ms/batch ({100 * ms / p['kernel_ms_per_batch']:.1f} %)")
    for name, ms in p["top_kernels_ms_per_batch"].items():
        print(f"    {ms:8.3f} ms/batch  {name[:110]}")

    # 4. the int8 projections piece by piece
    if args.quantize:
        bc = cfg.bert
        pieces = int8_pieces(args.quantize, bc.num_hidden_layers,
                             bc.hidden_size, bc.intermediate_size, batch_size,
                             args.pair_seq_length)
        result["int8_pieces_ms_per_batch"] = pieces
        print(f"{args.quantize} projections, each piece timed alone, ms per "
              "batch (both encoder calls): " + ", ".join(
                  f"{k} {v:.3f}" for k, v in pieces.items()), flush=True)

    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
