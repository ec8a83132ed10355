#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (msa_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout.  In order, and stopping at the first
failure (no phase catches its own):

  1. requires CUDA and prints the card's name and power limit;
  2. builds the CUDA kernels from msa_tpu_torch/csrc with nvcc (sm_90a);
  3. holds each kernel against its plain PyTorch version on the card at
     the serving shapes (and a few more), in bf16 and f32, and times both;
  4. serves a ragged synthetic MOSI split through the bf16 ``Predictor``
     with a full-width bert-large MMBert (random weights from a seed),
     checks the predictions and that every batch launched each kernel the
     expected number of times, then checks an f32 card run against the CPU
     plain run on a few samples;
  5. pushes JSONL requests (one of them invalid) through ``serve_stream``.

The line before the last is a JSON summary of the kernels; the last line is
``{"ok": true, "device": {...}}``.  Without CUDA, or without the package
beside it, the script exits non-zero before printing any result.
"""

from __future__ import annotations

import dataclasses
import io
import json
import os
import subprocess
import sys
import tempfile
import time

# Tolerances of the kernel-vs-plain comparisons on the card.
#  * f32: both sides are f32 throughout and differ in summation order.
#  * bf16: both round to bf16 at the end; the plain attention also rounds
#    the probabilities to bf16 before the PV product (as the JAX reference
#    does), the kernel keeps them in f32.  Allow about one bf16 ulp.
#  * attention rows whose keys are all masked: every score carries the
#    -10000 fill, whose f32 ulp (2^-10) quantises the scores differently in
#    the kernel's base-2 domain and the plain natural one.
ATTN_TOL = {"float32": (1e-4, 1e-4), "bfloat16": (2e-2, 2e-2)}  # (atol, rtol)
MASKED_ROW_ATOL = 1e-2
EMBED_TOL = {"float32": (1e-4, 1e-4), "bfloat16": (1e-2, 1e-2)}
# f32 Predictor on the card (TF32 off) against the CPU plain run: 24 layers
# of f32 in another summation order.
F32_PRED_ATOL = 1e-4

BATCH = 96          # bench.py's serving batch
TEXT_LEN = 40       # MOSI max_seq_length
N_SERVE = 5 * BATCH - 23  # five batches, the last one ragged


def cuda_ms(fn, iters: int = 20) -> float:
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


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


def phase_attention(gen):
    import torch

    from msa_tpu_torch.ops.short_attention import (
        short_attention, short_attention_plain)

    cases = [("text", BATCH, TEXT_LEN), ("joint", 2 * BATCH, 2 * TEXT_LEN),
             ("s77", 16, 77), ("s130", 8, 130), ("s512", 4, 512),
             ("s768", 4, 768)]  # 512 < S < 1024: XLA's range in JAX
    hidden, heads = 1024, 16
    worst, times = 0.0, {}
    for label, b, s in cases:
        for dtype in (torch.bfloat16, torch.float32):
            dname = str(dtype).split(".")[1]
            q, k, v = (torch.randn(b, s, hidden, device="cuda", generator=gen)
                       .to(dtype) for _ in range(3))
            lengths = torch.randint(1, s + 1, (b,), device="cuda",
                                    generator=gen)
            lengths[0] = 0  # a fully masked row, as the Predictor's padding
            mask = (torch.arange(s, device="cuda")[None] < lengths[:, None])
            bias = (1.0 - mask.float()) * -10000.0
            out = short_attention(q, k, v, bias, heads)
            ref = short_attention_plain(q, k, v, bias, heads)
            torch.cuda.synchronize()
            atol, rtol = ATTN_TOL[dname]
            live = lengths > 0
            err = check_close(f"short_attention {label} {dname}", out, ref,
                              atol, rtol, mask=live)
            err_masked = check_close(
                f"short_attention {label} {dname} masked row", out, ref,
                MASKED_ROW_ATOL, 0.0, mask=~live)
            worst = max(worst, err)
            ms = cuda_ms(lambda: short_attention(q, k, v, bias, heads))
            plain_ms = cuda_ms(lambda: short_attention_plain(q, k, v, bias, heads))
            times[(label, dname)] = (ms, plain_ms)
            print(f"short_attention [{b},{s},{hidden}] {dname}: max_abs_err "
                  f"{err:.3e} (atol {atol}, rtol {rtol}), masked row "
                  f"{err_masked:.3e} (atol {MASKED_ROW_ATOL}); kernel "
                  f"{ms:.4f} ms, plain {plain_ms:.4f} ms", flush=True)
    return worst, times


def phase_joint_embed(gen):
    import torch

    from msa_tpu_torch.ops.fused_joint_embed import (
        fused_joint_embed, fused_joint_embed_plain)

    hidden, eps = 1024, 1e-12
    worst, times = 0.0, {}
    # MOSI (47, 74) and UR-FUNNY (371) widths at Lp = L, and one Lp != L
    for d, lp in ((47, TEXT_LEN), (74, TEXT_LEN), (371, TEXT_LEN), (74, 56)):
        for dtype in (torch.bfloat16, torch.float32):
            dname = str(dtype).split(".")[1]
            text = torch.randn(BATCH, TEXT_LEN, hidden, device="cuda",
                               generator=gen).to(dtype)
            feats = torch.randn(BATCH, lp, d, device="cuda",
                                generator=gen).to(dtype)
            feats[1, 30:] = 0.0  # padded frames
            w = torch.randn(d, hidden, device="cuda", generator=gen) * 0.05
            b, scale, bias = (torch.randn(hidden, device="cuda", generator=gen)
                              * s + m for s, m in ((0.02, 0.0), (0.1, 1.0),
                                                   (0.1, 0.0)))
            args = (text, feats, w, b, scale, bias, eps)
            out = fused_joint_embed(*args)
            ref = fused_joint_embed_plain(*args)
            torch.cuda.synchronize()
            atol, rtol = EMBED_TOL[dname]
            err = check_close(f"fused_joint_embed D={d} {dname}", out, ref,
                              atol, rtol)
            worst = max(worst, err)
            ms = cuda_ms(lambda: fused_joint_embed(*args))
            plain_ms = cuda_ms(lambda: fused_joint_embed_plain(*args))
            times[(d, lp, dname)] = (ms, plain_ms)
            print(f"fused_joint_embed [{BATCH},{TEXT_LEN}+{lp},{hidden}] "
                  f"D={d} {dname}: max_abs_err {err:.3e} (atol {atol}, rtol "
                  f"{rtol}); kernel {ms:.4f} ms, plain {plain_ms:.4f} ms",
                  flush=True)
    return worst, times


def phase_serving(exp, params):
    import numpy as np
    import torch

    from msa_tpu_torch.data import synthetic_split
    from msa_tpu_torch.inference import Predictor
    from msa_tpu_torch.ops.fused_joint_embed import fused_joint_embed
    from msa_tpu_torch.ops.short_attention import short_attention

    cfg = exp.model
    split = synthetic_split(N_SERVE, TEXT_LEN, cfg.visual_dim, cfg.speech_dim,
                            vocab_size=cfg.bert.vocab_size, seed=0)
    pred = Predictor(exp, params, BATCH, "cuda")
    n_batches = -(-N_SERVE // BATCH)

    warm = pred.predict_split(split)  # first use: cuBLAS handles, kernels
    short_attention.launches = 0
    fused_joint_embed.launches = 0
    t0 = time.perf_counter()
    out = pred.predict_split(split)  # ends in a device-to-host copy
    seconds = time.perf_counter() - t0
    launches = {"short_attention": short_attention.launches,
                "fused_joint_embed": fused_joint_embed.launches}
    t1 = time.perf_counter()
    pred.predict_split(split)
    seconds_again = time.perf_counter() - t1

    layers = cfg.bert.num_hidden_layers
    want = {"short_attention": 2 * layers * n_batches,
            "fused_joint_embed": 2 * n_batches}
    if launches != want:
        raise AssertionError(f"kernel launches {launches}, want {want} "
                             f"({n_batches} batches)")
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
    from msa_tpu_torch.models.weights import to_device
    cpu32 = Predictor(exp32, to_device(params, "cpu"), len(rows),
                      "cpu").predict_arrays(*sub)
    err32 = float(np.abs(gpu32 - cpu32).max())
    if not err32 <= F32_PRED_ATOL:
        raise AssertionError(f"f32 card vs CPU predictions differ by {err32:.3e}"
                             f" > {F32_PRED_ATOL}")
    print(f"f32 card vs CPU plain on {len(rows)} samples: max |diff| "
          f"{err32:.3e} (atol {F32_PRED_ATOL}); bf16 vs f32 on the card "
          f"{float(np.abs(out[rows] - gpu32).max()):.3e}", flush=True)
    return pred, launches


def phase_service(pred):
    import numpy as np

    from msa_tpu_torch.cli.serve import serve_stream
    from msa_tpu_torch.data import FastTokenizer, make_test_vocab

    cfg = pred.config.model
    vis = lambda n: [[0.1] * cfg.visual_dim] * n  # noqa: E731
    spc = lambda n: [[0.2] * cfg.speech_dim] * n  # noqa: E731
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
    print(f"serve_stream: answered {counts['answered']}, errors "
          f"{counts['errors']}, {seconds * 1e3:.1f} ms for the stream (one "
          "flush at EOF)", flush=True)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
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
    for name in _build.KERNELS:
        lib = _build.build(name)
        print(f"built {os.path.relpath(lib)}", flush=True)
    print(f"kernel build: {time.perf_counter() - t0:.1f} s", flush=True)

    gen = torch.Generator(device="cuda").manual_seed(0)
    attn_err, attn_times = phase_attention(gen)
    embed_err, embed_times = phase_joint_embed(gen)

    exp = build_experiment("mosi", "bert-large-uncased", num_labels=1)
    params = init_params(exp.model, torch.Generator(device="cuda").manual_seed(0))
    pred, launches = phase_serving(exp, params)
    phase_service(pred)

    kernels = [
        {"name": "short_attention", "route": "cuda",
         "source": "msa_tpu_torch/csrc/short_attention.cu",
         "replaces": "msa_tpu/ops/short_attention.py:303",
         "launches": launches["short_attention"], "max_abs_err": attn_err,
         "ms": attn_times[("joint", "bfloat16")][0],
         "plain_ms": attn_times[("joint", "bfloat16")][1]},
        {"name": "fused_joint_embed", "route": "cuda",
         "source": "msa_tpu_torch/csrc/fused_joint_embed.cu",
         "replaces": "msa_tpu/ops/fused_joint_embed.py:24",
         "launches": launches["fused_joint_embed"], "max_abs_err": embed_err,
         "ms": embed_times[(47, TEXT_LEN, "bfloat16")][0],
         "plain_ms": embed_times[(47, TEXT_LEN, "bfloat16")][1]},
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
