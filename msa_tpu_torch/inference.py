"""Batched inference / serving API on PyTorch.

Counterpart of ``msa_tpu/inference.py::Predictor``: put the parameters on
the device once, then serve fixed-shape batches (a ragged final batch is
zero-padded to the batch size and the padding is dropped from the output).
On CUDA the forward runs the hand-written kernels (``msa_tpu_torch.ops``);
on the CPU their plain versions.
"""

from __future__ import annotations

import numpy as np
import torch

from .configs import ExperimentConfig
from .data import FeaturizedSplit

from .models.mmbert import mmbert_forward
from .models.weights import cast_for_compute, to_device

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


class Predictor:
    """Sentiment predictions from aligned tri-modal inputs."""

    def __init__(self, config: ExperimentConfig, params, batch_size: int,
                 device, *, quantize: str | None = None):
        """``params``: the port's tree (``models/weights.py``), on any
        device; it is copied to ``device`` and its dense weights cast to the
        compute dtype once."""
        tc = config.train
        if quantize is not None:
            raise NotImplementedError(
                f"quantize={quantize!r}: int8 serving is not ported yet "
                "(ROADMAP: int8 serving)")
        if tc.data_parallel not in (-1, 1) or tc.model_parallel != 1:
            raise NotImplementedError(
                f"data_parallel={tc.data_parallel}, model_parallel="
                f"{tc.model_parallel}: the port serves on one device "
                "(ROADMAP: parallelism); -1 means that one device")
        if tc.compute_dtype not in _DTYPES:
            raise ValueError(f"unknown compute_dtype {tc.compute_dtype!r}")
        self.config = config
        self.batch_size = int(batch_size)
        self.device = torch.device(device)
        self.dtype = _DTYPES[tc.compute_dtype]
        self.params = cast_for_compute(to_device(params, self.device),
                                       self.dtype)

    def _upload(self, x: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(np.ascontiguousarray(x))
        if t.is_floating_point():
            # bf16 on the wire: the forward casts the features to the
            # compute dtype on arrival anyway, so casting on the host is
            # identical and halves the bytes moved
            t = t.to(self.dtype)
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t.to(self.device)

    @torch.inference_mode()
    def _forward(self, ids, mask, visual, speech) -> torch.Tensor:
        cfg = self.config.model
        ids = ids.long()
        out = mmbert_forward(self.params, ids, mask, ids, ids, visual, speech,
                             cfg, compute_dtype=self.dtype,
                             use_flash=self.config.train.use_flash_attention)
        logits = out["logits"]
        if cfg.regression:  # num_labels 1 or 7: one regression output
            preds = torch.tanh(logits) if cfg.num_labels == 1 else logits
            return preds.reshape(-1)
        return torch.argmax(torch.sigmoid(logits), dim=1)

    def predict_arrays(self, input_ids: np.ndarray, attention_mask: np.ndarray,
                       visual: np.ndarray, speech: np.ndarray) -> np.ndarray:
        """[N, L] ids/mask + [N, Lp, D*] features -> [N] predictions.

        Every batch is enqueued before the first result is fetched, so the
        host prepares batch i+1 while the device runs batch i.
        """
        n = input_ids.shape[0]
        bs = self.batch_size
        pending = []  # (device predictions, real rows)
        for start in range(0, n, bs):
            end = min(start + bs, n)
            pad = bs - (end - start)

            def prep(x):
                x = np.asarray(x[start:end])
                if pad:
                    x = np.concatenate(
                        [x, np.zeros((pad,) + x.shape[1:], x.dtype)])
                return self._upload(x)

            preds = self._forward(prep(input_ids), prep(attention_mask),
                                  prep(visual), prep(speech))
            pending.append((preds, end - start))
        if not pending:
            return np.zeros((0,))
        return np.concatenate([p.cpu().numpy()[:k] for p, k in pending])

    def predict_split(self, split: FeaturizedSplit) -> np.ndarray:
        return self.predict_arrays(split.input_ids, split.attention_mask,
                                   split.visual, split.speech)
