"""Batched inference / serving API on PyTorch.

Counterpart of ``msa_tpu/inference.py``: put the parameters on the device
once, then serve fixed-shape batches (a ragged final batch is zero-padded
to the batch size and the padding is dropped from the output).  On CUDA the
forward runs the hand-written kernels (``msa_tpu_torch.ops``); on the CPU
their plain versions.  ``quantize`` selects the int8 serving modes
(``ops/quant.py``), with static activation scales from
:func:`calibrate_act_stats` for ``int8_static``.  Under data parallelism
each rank serves its rows of every batch and the predictions are gathered,
so every rank returns the whole array.  Under tensor parallelism the ranks
of a model group serve the same rows with their shards of the weights
(``parallel/sharding.py``): the int8 modes quantize the full weights, then
cut them.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from .configs import ExperimentConfig
from .data import FeaturizedSplit

from .models.mmbert import mmbert_forward
from .models.weights import cast_for_compute, to_device
from .ops.quant import quantize_bert_params
from .parallel import sharding
from .parallel.distributed import DataParallel, ModelParallel, local_rows
from .parallel.mesh import DATA_AXIS, make_mesh, world_size

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
QUANTIZE_MODES = ("int8", "int8_static")


def _upload(x: np.ndarray, device: torch.device,
            dtype: torch.dtype) -> torch.Tensor:
    t = torch.from_numpy(np.ascontiguousarray(x))
    if t.is_floating_point():
        # bf16 on the wire: the forward casts the features to the compute
        # dtype on arrival anyway, so casting on the host is identical and
        # halves the bytes moved
        t = t.to(dtype)
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def _serving_forward(params, config: ExperimentConfig, dtype: torch.dtype,
                     ids, mask, visual, speech, collect_act_stats=False,
                     mp=None):
    ids = ids.long()
    return mmbert_forward(params, ids, mask, ids, ids, visual, speech,
                          config.model, compute_dtype=dtype,
                          use_flash=config.train.use_flash_attention,
                          collect_act_stats=collect_act_stats,
                          fuse_text_pass=config.train.fuse_text_pass, mp=mp)


def _fetch(tensors):
    """Device tensors -> numpy arrays: the one device-to-host fetch of
    :meth:`Predictor.predict_arrays`'s window."""
    return [t.cpu().numpy() for t in tensors]


@torch.inference_mode()
def calibrate_act_stats(config: ExperimentConfig, params, split: FeaturizedSplit,
                        batch_size: int = 8, max_batches: int = 4, mp=None):
    """Absmax activation statistics for int8 static-scale quantization.

    Runs the deterministic serving forward with ``collect_act_stats=True``
    over up to ``max_batches`` batches of ``split`` on the device that holds
    ``params`` (the port's tree, in the compute dtype) and returns the
    elementwise max: {"attn_in"|"ctx"|"mlp_in"|"ffn_act": [L] f32 tensor},
    what :func:`~msa_tpu_torch.ops.quant.quantize_bert_params` takes.
    Under tensor parallelism (``mp``; ``params`` the rank's shard) each
    statistic is the maximum over the model group, the same on each rank.
    """
    n = len(split)
    if n == 0:
        raise ValueError("empty calibration split")
    dtype = _DTYPES[config.train.compute_dtype]
    device = params["bert"]["embeddings"]["word"].device
    agg = None
    for start in range(0, min(n, batch_size * max_batches), batch_size):
        end = min(start + batch_size, n)

        def prep(x):
            x = np.asarray(x[start:end])
            if len(x) < batch_size:
                # fill by REPEATING real rows, not zeros: an all-zero row
                # has an all-zero attention mask, and its degenerate
                # activations would loosen the static scales; max() over
                # repeats changes nothing
                reps = -(-batch_size // len(x))
                x = np.concatenate([x] * reps)[:batch_size]
            return _upload(x, device, dtype)

        stats = _serving_forward(
            params, config, dtype, prep(split.input_ids),
            prep(split.attention_mask), prep(split.visual), prep(split.speech),
            collect_act_stats=True, mp=mp)["act_stats"]
        agg = stats if agg is None else {
            k: torch.maximum(v, stats[k]) for k, v in agg.items()}
    return agg


class Predictor:
    """Sentiment predictions from aligned tri-modal inputs."""

    def __init__(self, config: ExperimentConfig, params, batch_size: int = 8,
                 device="cuda", *, quantize: str | None = None,
                 calibration: FeaturizedSplit | None = None,
                 fuse_qkv: bool = False, inflight_batches: int = 64):
        """``params``: the port's tree (``models/weights.py``), on any
        device; it is copied to ``device`` and its dense weights cast to the
        compute dtype once.  ``device`` is the card unless the caller asks
        for the CPU.

        ``quantize="int8"`` quantizes the encoder's six projections once
        (per-channel int8 weights, per-row activation scales);
        ``"int8_static"`` also calibrates static activation scales on
        ``calibration`` (a FeaturizedSplit), which it requires.
        ``fuse_qkv`` (int8 modes; ignored without ``quantize``, as in JAX)
        fuses each layer's q, k and v into one [*, 3H] int8 projection that
        feeds the packed attention kernel (``ops/quant.py``).

        ``inflight_batches`` bounds how many enqueued but unfetched batches
        :meth:`predict_arrays` keeps on the device (a memory bound on big
        splits) while the fetches still overlap the device's work.

        The mesh is ``make_mesh(data_parallel, model_parallel)`` over the
        process group: a data axis above 1 splits every batch's rows over
        it, so ``batch_size`` must be a multiple of it; a model axis above 1
        splits the weights (``sequence_parallel`` as the config says), and
        ``fuse_qkv`` then raises, as JAX's does.
        """
        tc = config.train
        if quantize not in (None,) + QUANTIZE_MODES:
            raise ValueError(f"unknown quantize mode: {quantize!r}")
        if quantize == "int8_static" and calibration is None:
            raise ValueError(
                "quantize='int8_static' needs calibration= a FeaturizedSplit "
                "to derive static activation scales")
        if tc.compute_dtype not in _DTYPES:
            raise ValueError(f"unknown compute_dtype {tc.compute_dtype!r}")
        if fuse_qkv and tc.model_parallel > 1:
            # contiguous model-axis chunks of the [*, 3H] output would mix
            # q with k (JAX's guard, msa_tpu/inference.py)
            raise ValueError("fuse_qkv requires a mesh without a model axis "
                             "(ops/quant.py docstring)")
        self.mesh = make_mesh(tc.data_parallel, tc.model_parallel)
        if int(batch_size) % self.mesh.shape[DATA_AXIS]:
            raise ValueError(
                f"batch_size {batch_size} must be a multiple of the "
                f"data-axis size {self.mesh.shape[DATA_AXIS]}")
        self.dp = DataParallel.from_mesh(self.mesh)
        self.mp = ModelParallel.from_mesh(self.mesh, tc.sequence_parallel)
        if self.mp is not None:
            sharding.check_divisible(config.model.bert, self.mp.size)
        self.inflight_batches = max(1, int(inflight_batches))
        self.config = config
        self.batch_size = int(batch_size)
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "Predictor: device 'cuda' asked for, but CUDA is not "
                "available; pass device='cpu' to serve on the CPU")
        self.dtype = _DTYPES[tc.compute_dtype]
        self.quantize = quantize
        params = to_device(params, self.device)
        if quantize is not None:
            stats = None
            if quantize == "int8_static":
                stats = calibrate_act_stats(
                    config, self._local(cast_for_compute(params, self.dtype)),
                    calibration, batch_size=self.batch_size, mp=self.mp)
            # from the full f32 weights, as JAX quantizes them (a row-split
            # weight's channel scale spans every rank's rows); calibration
            # ran on the unfused tree
            params = quantize_bert_params(params, act_stats=stats,
                                          fuse_qkv=fuse_qkv)
        self.params = cast_for_compute(self._local(params), self.dtype)

    def _local(self, params):
        """The rank's shard of a full tree under tensor parallelism."""
        if self.mp is None:
            return params
        return sharding.shard_params(params, self.mesh, dist.get_rank())

    @classmethod
    def from_checkpoint(cls, directory: str, batch_size: int = 8,
                        device="cuda", model_num: int | None = None,
                        quantize: str | None = None,
                        calibration: FeaturizedSplit | None = None
                        ) -> "Predictor":
        """A Predictor over the parameters of a checkpoint (a run directory,
        whose newest or ``model_num``-th epoch is taken, or an epoch
        directory), with the experiment config saved beside them.  It
        serves at the launch's layout, not the saved one: every rank of the
        process group (or the one process) on the data axis, the weights
        unsplit, so a model trained at dp x mp across hosts serves on one
        rank."""
        from .training.checkpoint import (
            load_config, load_params, resolve_checkpoint)

        directory = resolve_checkpoint(directory, model_num)
        config = load_config(directory)
        if config is None:
            raise FileNotFoundError(f"no config.json in {directory}")
        config = dataclasses.replace(config, train=dataclasses.replace(
            config.train, data_parallel=world_size(), model_parallel=1))
        return cls(config, load_params(directory, "cpu"), batch_size, device,
                   quantize=quantize, calibration=calibration)

    def _upload(self, x: np.ndarray) -> torch.Tensor:
        return _upload(x, self.device, self.dtype)

    @torch.inference_mode()
    def _forward(self, ids, mask, visual, speech) -> torch.Tensor:
        cfg = self.config.model
        out = _serving_forward(self.params, self.config, self.dtype, ids,
                               mask, visual, speech, mp=self.mp)
        logits = out["logits"]
        if cfg.regression:  # num_labels 1 or 7: one regression output
            preds = torch.tanh(logits) if cfg.num_labels == 1 else logits
            return preds.reshape(-1)
        return torch.argmax(torch.sigmoid(logits), dim=1)

    def predict_arrays(self, input_ids: np.ndarray, attention_mask: np.ndarray,
                       visual: np.ndarray, speech: np.ndarray) -> np.ndarray:
        """[N, L] ids/mask + [N, Lp, D*] features -> [N] predictions.

        Batches are enqueued ahead of the fetches, so the host prepares
        batch i+1 while the device runs batch i.  At most
        ``inflight_batches`` are outstanding: when the window fills, the
        oldest half is fetched (a full drain would leave the device idle
        once a window).
        """
        n = input_ids.shape[0]
        bs = self.batch_size
        out: list = []
        pending = []  # (device predictions, real rows)

        def drain(count=None):
            take = pending if count is None else pending[:count]
            if not take:
                return
            host = _fetch([p for p, _ in take])
            out.extend(p[:k] for p, (_, k) in zip(host, take))
            del pending[:len(take)]

        for start in range(0, n, bs):
            end = min(start + bs, n)
            pad = bs - (end - start)

            def prep(x):
                x = np.asarray(x[start:end])
                if pad:
                    x = np.concatenate(
                        [x, np.zeros((pad,) + x.shape[1:], x.dtype)])
                if self.dp is not None:  # this rank's rows of the batch
                    x = local_rows(x, self.dp.size, self.dp.index)
                return self._upload(x)

            preds = self._forward(prep(input_ids), prep(attention_mask),
                                  prep(visual), prep(speech))
            if self.dp is not None:
                preds = self.dp.gather(preds)
            pending.append((preds, end - start))
            if len(pending) >= self.inflight_batches:
                drain(max(1, self.inflight_batches // 2))
        drain()
        return np.concatenate(out) if out else np.zeros((0,))

    def predict_split(self, split: FeaturizedSplit) -> np.ndarray:
        return self.predict_arrays(split.input_ids, split.attention_mask,
                                   split.visual, split.speech)
