"""Streaming inference service: JSONL requests in, predictions out.

Counterpart of the service loop of ``msa_tpu/cli/serve.py`` around the
port's :class:`msa_tpu_torch.inference.Predictor`.  The request schema,
featurisation and line reader are the JAX package's own host code,
imported: one JSON object per line,

    {"id": "any", "words": ["i", "love", "it"],
     "visual": [[...frame...], ...], "speech": [[...frame...], ...]}

with ``visual``/``speech`` optional.  Lines are micro-batched up to
``batch_size`` and flushed on a full batch, on EOF, once the oldest pending
request is ``max_wait`` seconds old, or (``drain_flush``) as soon as the
input is drained.  Each answer echoes ``id`` and adds ``prediction``; an
invalid line yields ``{"id": ..., "error": ...}`` and the service goes on.

The command-line entry (``--checkpoint``) waits for the checkpoint port.
"""

from __future__ import annotations

import json
import time
from typing import Dict

import numpy as np

from msa_tpu.cli.serve import _DRAINED, _iter_lines, featurize_request


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
