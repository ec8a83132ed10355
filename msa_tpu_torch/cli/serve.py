"""Streaming inference service: JSONL requests in, predictions out.

Counterpart of ``msa_tpu/cli/serve.py`` around the port's
:class:`msa_tpu_torch.inference.Predictor`:

    python -m msa_tpu_torch.cli.serve --checkpoint model_save/<run> \
        --vocab vocab.txt [--quantize int8|int8_static --calibration reqs.jsonl] \
        [--device cpu] < requests.jsonl > predictions.jsonl

The request schema, featurisation (:func:`featurize_request`) and line
reader (:func:`_iter_lines`) are the port's own copies of that module's
host code: one JSON object per line,

    {"id": "any", "words": ["i", "love", "it"],
     "visual": [[...frame...], ...], "speech": [[...frame...], ...]}

with ``visual``/``speech`` optional.  Lines are micro-batched up to
``batch_size`` and flushed on a full batch, on EOF, once the oldest pending
request is ``max_wait`` seconds old, or (``drain_flush``) as soon as the
input is drained.  Each answer echoes ``id`` and adds ``prediction``; an
invalid line yields ``{"id": ..., "error": ...}`` and the service goes on.
The service runs on the card unless ``--device cpu`` asks for the CPU.
"""

from __future__ import annotations

import argparse
import json
import os
import select
import sys
import time
from typing import Dict

import numpy as np

from ..data.featurize import FeaturizedSplit, featurize


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--checkpoint", required=True,
                   help="run dir (latest epoch) or direct epoch dir")
    p.add_argument("--model_num", type=int, default=None,
                   help="select a specific retained epoch checkpoint")
    p.add_argument("--vocab", required=True, help="BERT wordpiece vocab.txt")
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--quantize", choices=["int8", "int8_static"], default=None,
                   help="int8-quantize the encoder projections; "
                        "'int8_static' uses static activation scales "
                        "calibrated on --calibration")
    p.add_argument("--calibration", default=None,
                   help="JSONL requests file (same schema as serving input) "
                        "used to calibrate int8_static activation scales")
    p.add_argument("--max_wait", type=float, default=0.05,
                   help="flush a partial batch once its OLDEST request is "
                        "this many seconds old (0 flushes only on a full "
                        "batch or EOF)")
    p.add_argument("--drain_flush", action=argparse.BooleanOptionalAction,
                   default=True,
                   help="flush a partial batch as soon as the input fd is "
                        "drained instead of waiting out --max_wait")
    p.add_argument("--input", default=None, help="JSONL file (default: stdin)")
    p.add_argument("--output", default=None,
                   help="JSONL file (default: stdout)")
    p.add_argument("--device", default="cuda",
                   help="torch device to serve on (default: cuda)")
    return p


def featurize_request(req, tokenizer, L, Lp, vdim, sdim):
    """One request -> a one-row :class:`FeaturizedSplit`.

    ``visual``/``speech`` are optional (zero-filled when absent).  With a
    word-aligned model (``Lp`` None) each must have exactly one row per
    word: the featurizer replicates rows per sub-token by word index, so
    extra rows would silently misalign (fewer already raise).
    """
    words = [str(w) for w in req["words"]]
    visual = np.asarray(req.get("visual", []), np.float32).reshape(-1, vdim) \
        if req.get("visual") else np.zeros((len(words), vdim), np.float32)
    speech = np.asarray(req.get("speech", []), np.float32).reshape(-1, sdim) \
        if req.get("speech") else np.zeros((len(words), sdim), np.float32)
    if Lp is None:
        for name, arr in (("visual", visual), ("speech", speech)):
            if len(arr) != len(words):
                raise ValueError(
                    f"word-aligned model: {name} must have one row per word "
                    f"(got {len(arr)} rows for {len(words)} words); resample "
                    f"frames to word level or serve a frame-level "
                    f"(pair_seq_length) checkpoint")
    sample = ((words, visual, speech), [np.array([0.0])], req.get("id"))
    return featurize([sample], tokenizer, L, vdim, sdim, "mosi", "sentiment",
                     1, pair_seq_length=Lp)


# Sentinel yielded by _iter_lines when the input fd is drained right after
# complete lines arrived: the caller may flush its partial batch at once
# instead of waiting out the max_wait deadline (light-load latency).
_DRAINED = object()


def _iter_lines(fin, max_wait, timeout_fn=None, drain_flush=False):
    """Yield decoded lines from ``fin``; yield ``None`` when the flush
    timer fires (the caller's cue to flush a partial batch).

    The select timeout comes from ``timeout_fn()`` each iteration (the
    caller points it at the OLDEST pending request's deadline; a plain idle
    timer would be reset by every arrival); ``max_wait`` alone is the
    fallback when no timeout_fn is given.  ``drain_flush=True`` also yields
    :data:`_DRAINED` whenever the fd has no more data ready right after
    complete lines were consumed.  The server is synchronous (a flush
    blocks the read loop), so no batch is in flight whenever the generator
    runs.

    Timed mode reads the raw fd via select + os.read so a complete line is
    never stranded inside Python's buffered reader while select blocks on
    the fd.  Seekable files (and max_wait=0) use plain iteration: they are
    always ready, so the timer is meaningless there.
    """
    timed = max_wait and max_wait > 0
    if timed:
        try:
            timed = not fin.seekable()
        except (AttributeError, OSError, ValueError):
            pass
        try:
            fd = fin.fileno()
        except (AttributeError, OSError, ValueError):
            timed = False
    if not timed:
        yield from fin
        return
    buf = b""
    check_drain = False
    while True:
        if check_drain:
            # zero-timeout probe right after lines were consumed; only a
            # NEGATIVE probe yields (the next iteration always reaches the
            # blocking select below, so this is no busy loop)
            check_drain = False
            ready, _, _ = select.select([fd], [], [], 0.0)
            if not ready:
                yield _DRAINED
                continue
        else:
            wait = timeout_fn() if timeout_fn is not None else max_wait
            ready, _, _ = select.select([fd], [], [], max(wait, 0.0))
            if not ready:
                yield None
                continue
        chunk = os.read(fd, 1 << 16)
        if not chunk:
            if buf:
                yield buf.decode("utf-8", "replace")
            return
        buf += chunk
        got_line = False
        while b"\n" in buf:
            line, buf = buf.split(b"\n", 1)
            yield line.decode("utf-8", "replace")
            got_line = True
        check_drain = drain_flush and got_line


def serve_stream(predictor, tokenizer, fin, fout, *, batch_size: int,
                 max_wait: float, drain_flush: bool) -> Dict[str, int]:
    """Answer the JSONL requests of ``fin`` on ``fout`` until EOF.

    Returns ``{"answered": n, "errors": m}``.
    """
    cfg = predictor.config
    L, Lp = cfg.data.max_seq_length, cfg.data.pair_seq_length
    vdim, sdim = cfg.model.visual_dim, cfg.model.speech_dim
    pending: list = []  # (id, FeaturizedSplit)
    # monotonic timestamp of the OLDEST un-flushed request: max_wait bounds
    # its age (deadline flush), not the gap between arrivals
    pending_since = [None]
    counts = {"answered": 0, "errors": 0}

    def flush():
        if pending:
            preds = predictor.predict_arrays(
                np.concatenate([s.input_ids for _, s in pending]),
                np.concatenate([s.attention_mask for _, s in pending]),
                np.concatenate([s.visual for _, s in pending]),
                np.concatenate([s.speech for _, s in pending]))
            for (rid, _), pred in zip(pending, preds):
                fout.write(json.dumps({"id": rid, "prediction": float(pred)})
                           + "\n")
            fout.flush()
            counts["answered"] += len(pending)
            pending.clear()
        pending_since[0] = None

    def timeout_fn():
        if pending_since[0] is None:
            return max_wait
        return pending_since[0] + max_wait - time.monotonic()

    for line in _iter_lines(fin, max_wait, timeout_fn, drain_flush=drain_flush):
        if line is None or line is _DRAINED:
            # deadline hit, or the input is drained (and no batch is in
            # flight: flush is synchronous): answer the partial batch now
            flush()
            continue
        line = line.strip()
        if not line:
            continue
        try:
            req = json.loads(line)
            split = featurize_request(req, tokenizer, L, Lp, vdim, sdim)
        except Exception as e:  # a bad line must not kill the service
            rid = None
            try:
                rid = json.loads(line).get("id")
            except Exception:
                pass
            fout.write(json.dumps({"id": rid, "error": str(e)}) + "\n")
            fout.flush()
            counts["errors"] += 1
            continue
        if pending_since[0] is None:
            pending_since[0] = time.monotonic()
        pending.append((req.get("id"), split))
        if len(pending) >= batch_size or (
                max_wait and max_wait > 0
                and time.monotonic() - pending_since[0] >= max_wait):
            flush()
    flush()
    return counts


def read_calibration(path: str, tokenizer, config) -> FeaturizedSplit:
    """The requests of a JSONL file as one FeaturizedSplit."""
    L, Lp = config.data.max_seq_length, config.data.pair_seq_length
    vdim, sdim = config.model.visual_dim, config.model.speech_dim
    splits = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                splits.append(featurize_request(json.loads(line), tokenizer,
                                                L, Lp, vdim, sdim))
    if not splits:
        raise SystemExit(f"empty calibration file {path}")
    return FeaturizedSplit(
        **{name: np.concatenate([getattr(s, name) for s in splits])
           for name in ("input_ids", "attention_mask", "visual", "speech",
                        "target")},
        segments=[], words=[])


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    from ..data.fast_wordpiece import FastTokenizer
    from ..inference import Predictor
    from ..training.checkpoint import load_config, resolve_checkpoint

    if args.quantize == "int8_static" and not args.calibration:
        raise SystemExit("--quantize int8_static needs --calibration "
                         "<requests.jsonl>")
    tokenizer = FastTokenizer(args.vocab)
    calibration = None
    if args.quantize == "int8_static":
        config = load_config(resolve_checkpoint(args.checkpoint,
                                                args.model_num))
        if config is None:
            raise SystemExit(f"no config.json in {args.checkpoint}")
        calibration = read_calibration(args.calibration, tokenizer, config)
    predictor = Predictor.from_checkpoint(
        args.checkpoint, batch_size=args.batch_size, device=args.device,
        model_num=args.model_num, quantize=args.quantize,
        calibration=calibration)
    fin = open(args.input) if args.input else sys.stdin
    fout = open(args.output, "w") if args.output else sys.stdout
    try:
        serve_stream(predictor, tokenizer, fin, fout,
                     batch_size=args.batch_size, max_wait=args.max_wait,
                     drain_flush=args.drain_flush)
    finally:
        if args.input:
            fin.close()
        if args.output:
            fout.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
