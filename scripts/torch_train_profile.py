#!/usr/bin/env python3
"""Where the port's training step time goes on one NVIDIA GPU, and what the
short-attention kernels are worth end to end.

    python3 scripts/torch_train_profile.py [--out FILE.json]
    python3 scripts/torch_train_profile.py --pair-seq-length 984 --batch 16

Trains a full-width bert-large MMBert (random weights from a seed) through
``msa_tpu_torch``'s ``Trainer`` at bench.py's shape, as chip_smoke.py does:
MOSI widths, B=96, L=40, bf16 compute with bf16 Adam moments, the default
dropouts, MLM on.  ``--pair-seq-length Lp`` trains in frame-level mode (Lp
frames per modality: the joint pass runs at S = 40 + Lp, from 1024 on the
flash2 kernels).  Then:

  1. A/B, alternating in one process: ms/step with the attention kernels
     (``use_flash_attention="auto"``: forward and backward kernels,
     dropout inside them) against the plain attention on the card
     (``"never"``: the plain version under autograd, dropout a bernoulli
     mask), order K P P K ...  In frame-level mode the plain attention's
     saved probabilities do not fit on the card (~6 GB per layer at
     [32, 1024]), so the A/B is between the flash2 backward routes: the
     JAX package's (``fused``, at S = 1024 and 2048) against the split
     pair forced (``split``);
  2. host enqueue of one step against enqueue plus device time;
  3. ``torch.profiler`` over a few steps: device kernel time per step by
     kernel family and by name, the kernels' union against the wall time.

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
    ("attention_fwd", r"short_attention_fwd_kernel"),
    ("attention_bwd", r"short_attention_bwd_d(q|kv)_kernel"),
    ("flash2_fwd", r"flash2_fwd_kernel"),
    ("flash2_bwd", r"flash2_bwd_d(q|kv)_kernel"),
    ("fused_joint_embed", r"fused_joint_embed_kernel"),
    ("gemm", r"nvjet|gemm|cutlass|xmma|cublas|sm90_"),
    ("optimizer", r"multi_tensor_apply|foreach|Foreach"),
    ("layer_norm", r"layer_norm|LayerNorm"),
    ("gelu", r"gelu|GeluCUDA|tanh"),
    ("random", r"bernoulli|distribution|philox|uniform|randint|random"),
    ("softmax_ce", r"softmax|logsumexp|LogSoftMax|nll|cross_entropy"),
)


def family(name: str) -> str:
    for fam, pattern in FAMILIES:
        if re.search(pattern, name):
            return fam
    return "other"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=4,
                    help="timed runs per arm of the A/B")
    ap.add_argument("--steps", type=int, default=5,
                    help="train steps per timed run")
    ap.add_argument("--profile-steps", type=int, default=2)
    ap.add_argument("--batch", type=int, default=BATCH)
    ap.add_argument("--pair-seq-length", type=int, default=None,
                    help="frame-level mode: Lp frames per modality")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    sys.path.insert(0, REPO)
    import torch
    from torch.profiler import ProfilerActivity, profile

    from msa_tpu_torch.configs import build_experiment
    from msa_tpu_torch.ops import flash2
    from msa_tpu_torch.data import MultimodalDataset, synthetic_split
    from msa_tpu_torch.models.weights import init_params
    from msa_tpu_torch.training.trainer import Trainer

    if not torch.cuda.is_available():
        print("torch_train_profile: CUDA is not available", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(f"card: {card}", flush=True)
    result = {"card": card, "torch": torch.__version__,
              "cuda": torch.version.cuda, "batch": args.batch,
              "text_len": TEXT_LEN, "pair_seq_length": args.pair_seq_length}

    exp = build_experiment("mosi", "bert-large-uncased", num_labels=1,
                           train_batch_size=args.batch,
                           compute_dtype="bfloat16",
                           warmup_proportion=0.01, adam_mu_dtype="bfloat16",
                           adam_nu_dtype="bfloat16", data_parallel=1)
    exp = dataclasses.replace(exp, data=dataclasses.replace(
        exp.data, pair_seq_length=args.pair_seq_length))
    cfg = exp.model
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
    split = synthetic_split(4 * args.batch, TEXT_LEN, cfg.visual_dim,
                            cfg.speech_dim, vocab_size=cfg.bert.vocab_size,
                            seed=0, pair_seq_length=args.pair_seq_length)
    batches = list(MultimodalDataset(split, seed=0).epoch_batches(
        0, args.batch, drop_last=True))

    def arm(use_flash):
        e = dataclasses.replace(exp, train=dataclasses.replace(
            exp.train, use_flash_attention=use_flash))
        trainer = Trainer(e, "cuda")
        return trainer, trainer.init_state(0, 10_000, params=params)

    if args.pair_seq_length is None:
        main_arm, other = "kernel", "plain"
        arms = {"kernel": arm("auto"), "plain": arm("never")}
    else:  # both on the kernels; "split" forces the split flash2 backward
        main_arm, other = "fused", "split"
        arms = {"fused": arm("auto"), "split": arm("auto")}
    jax_route = flash2.use_fused_backward
    step_no = [0]

    def run(name, steps):
        trainer, state = arms[name]
        flash2.use_fused_backward = ((lambda *a: False) if name == "split"
                                     else jax_route)
        try:
            for _ in range(steps):
                state, metrics = trainer.train_step(
                    state, batches[step_no[0] % len(batches)], 1)
                step_no[0] += 1
        finally:
            flash2.use_fused_backward = jax_route
        arms[name] = (trainer, state)
        return metrics

    for name in arms:  # first use: kernels, cuBLAS handles, allocator
        float(run(name, 2)["loss"])

    # 1. A/B
    ms = {name: [] for name in arms}
    for name in (main_arm, other, other, main_arm) * (args.reps // 2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run(name, args.steps)
        torch.cuda.synchronize()
        ms[name].append((time.perf_counter() - t0) * 1e3 / args.steps)
    result["ab_ms_per_step"] = ms
    for name, r in ms.items():
        print(f"A/B {name}: ms/step {r}", flush=True)
    del arms[other]
    torch.cuda.empty_cache()

    # 2. host enqueue against enqueue + device, one step
    enqueue, total = [], []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run(main_arm, 1)
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        enqueue.append((t1 - t0) * 1e3)
        total.append((time.perf_counter() - t0) * 1e3)
    result["enqueue_ms_median"] = statistics.median(enqueue)
    result["enqueue_plus_device_ms_median"] = statistics.median(total)
    print(f"one step: host enqueue {result['enqueue_ms_median']:.2f} ms "
          f"(median of 5), enqueue + device "
          f"{result['enqueue_plus_device_ms_median']:.2f} ms", flush=True)

    # 3. profiler breakdown
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run(main_arm, args.profile_steps)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.events() if e.device_type.name == "CUDA"]
    if not kernels:
        raise RuntimeError("the profiler recorded no device time")
    per_name, per_family, spans = {}, {}, []
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
    n = args.profile_steps
    kernel_ms = sum(per_name.values()) / 1e3
    result["profile"] = {
        "steps": n, "wall_ms_per_step": wall_ms / n,
        "kernel_ms_per_step": kernel_ms / n,
        "kernel_union_ms_per_step": union / 1e3 / n,
        "busy_share": union / 1e3 / wall_ms,
        "launches_per_step": len(kernels) / n,
        "family_ms_per_step": {k: v / 1e3 / n for k, v in sorted(
            per_family.items(), key=lambda kv: -kv[1])},
        "top_kernels_ms_per_step": {k: v / 1e3 / n for k, v in sorted(
            per_name.items(), key=lambda kv: -kv[1])[:20]},
    }
    p = result["profile"]
    print(f"profiler over {n} steps: wall {p['wall_ms_per_step']:.2f} "
          f"ms/step, kernels {p['kernel_ms_per_step']:.2f} ms/step (union "
          f"{p['kernel_union_ms_per_step']:.2f}), busy share "
          f"{p['busy_share']:.3f} (profiler on), "
          f"{p['launches_per_step']:.0f} kernels per step", flush=True)
    for fam, t in p["family_ms_per_step"].items():
        print(f"  {fam}: {t:.3f} ms/step ({100 * t / p['kernel_ms_per_step']:.1f} %)")
    for name, t in p["top_kernels_ms_per_step"].items():
        print(f"    {t:8.3f} ms/step  {name[:110]}")

    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
