"""Training / eval runtime on one device or a data-parallel group.

Counterpart of ``msa_tpu/training/trainer.py``'s ``Trainer`` (its
``_build_train_step``, ``_build_eval_step``, ``train_epoch`` and
``eval_epoch``): one train step draws the three views' MLM masks (or takes
injected ones), runs the three-pass forward with dropout, the joint loss,
the backward and the AdamW update.  PyTorch runs eagerly, so there is no
step to build: :meth:`Trainer.train_step` is the step.

On a CUDA device the step runs the hand-written kernels (attention forward
and backward with in-kernel dropout -- the short kernels, or flash2 for a
frame-level joint pass at S >= 1024 -- and the joint embedding); on the CPU
their plain versions.  The device is the card unless the caller passes
``"cpu"``.  :meth:`Trainer.fit` is the epoch loop with model selection,
patience, one checkpoint per improvement and resume (``fit`` of the JAX
package); ``cli/train.py`` drives it.

Under ``data_parallel > 1`` each process is one rank of the default
process group (``parallel/distributed.py``): every rank holds the same
global batch (zero-padded to a multiple of the data axis with weight-0
rows, as JAX's ``_shard_batch``), draws the global MLM masks from the same
seed, keeps its rows, and computes its share of the global loss
(``ops/losses.py``); the gradients are summed in one flat all-reduce, so
every rank applies the same update to its copy of the state.  The dropout
seeds move by the rank (``ops.dropout.shard_seed``).

Under ``model_parallel > 1`` the ranks of a data row form a model group
(``parallel/mesh.py``): each holds its shard of the parameters and of the
Adam moments (``parallel/sharding.py``), the same rows of the batch, and
runs the forward and backward with Megatron's collectives
(``models/bert.py``); the gradients are summed over the data group only.
Under ``sequence_parallel`` the encoder's LayerNorms and ``o`` / ``wo``
biases see the rank's rows of the sequence, so their gradients are summed
over the model group too.  A checkpoint is the full state: the shards are
gathered, rank 0 writes, and loading cuts the rank's shard again.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..configs import ExperimentConfig
from ..data.dataset import MultimodalDataset, prefetch
from ..metrics.scores import test_ce_score, test_mse_score
from ..models.bert import parse_remat_policy
from ..models.mmbert import mmbert_forward, mmbert_loss
from ..models.weights import (cast_for_compute, init_params, map_tree,
                              named_leaves)
from ..ops import masking
from ..ops.attention import FLASH_MIN_SEQ
from ..ops.dropout import SEED_BITS, draw_seed, seeded_generator
from ..parallel import sharding
from ..parallel.distributed import (CommTimer, DataParallel, ModelParallel,
                                    barrier, local_rows, pad_batch,
                                    process_index)
from ..parallel.mesh import make_mesh
from ..utils.flops import H100_BF16_PEAK_FLOPS, mmbert_step_flops
from .optim import global_norm, make_fused_optimizer, make_optimizer
from .train_state import TrainState

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
_METRICS = ("loss", "mlm_loss", "ap_loss", "label_loss", "nce", "mlm_overflow")

# The 'auto' remat policy, first rung: checkpoint nothing while the eager
# step's saved activations fit comfortably on the card.  The estimate counts
# what autograd keeps per token and encoder layer in the compute dtype's
# bytes, in units of H: the layer input (1, read by the q/k/v products), q,
# k, v (3, kept by the attention kernel), ctx (1, and 2 more for the f32
# copy the attention backward reads), the f32 input of both LayerNorms
# (2 x 2), the LayerNorm output feeding the FFN (1), the FFN's
# up-projection and its gelu (2 x 4), and two bool dropout masks (~1): ~21
# elements of H, rounded up to 22.  bert-large at B=96 in bf16: 19,200
# tokens x 22 x 2 B x 1024 x 24 layers = ~20.8 GB, i.e. roughly 0.9 GB per
# layer; in frame-level mode at B=16, L=40, Lp=984, 33,408 tokens: ~36.1
# GB (36.0 GiB peak measured on an 80 GB H100, no checkpointing; the
# flash2 kernels keep no [S, S] tensor).  "Fit comfortably" is half the
# card's memory: the rest holds the f32 weights, their gradients, the Adam
# moments and the optimizer's f32 temporaries (~20 B per parameter, 6.7 GB
# at bert-large), the MLM head's logits and the allocator's slack.
_ACT_ELEMENTS_PER_TOKEN_LAYER = 22
_ACT_MEMORY_FRACTION = 0.5
# Below that rung, JAX's ladder (msa_tpu/training/trainer.py
# _resolve_remat_policy): the first policy whose stash fits the budget,
# JAX's fractions of the card's memory -- 6/16, or 10/16 in frame-level
# mode on the flash2 route (both calibrated on the TPU; no port run has
# recalibrated them).  JAX counts its stash in units of one [tokens, H]
# bf16 tensor per layer: 6 (save_attn+drop), 5, 3, 2 (save_ctx).  The
# port's stash per token, layer and element of H, in bytes, with `it` the
# compute dtype's size: the layer input (it), q, k, v (3 it), ctx (it),
# under '+drop' the two bool masks (2 B), and on the tokens of a flash2
# joint pass the f32 output its backward reads (4 B in bf16; in f32 it is
# ctx itself).  The short route keeps no f32 output.  In bf16 units: JAX's
# 6, 5, 3 and 2 on the short route, 8, 7, 5 and 4 on flash2's; the row lse
# (heads / H of a unit) is left out.
_REMAT_STASH_FRACTION = 6.0 / 16.0
_REMAT_STASH_FRACTION_FRAME = 10.0 / 16.0
_REMAT_LADDER = (  # (policy, its q/k/v/ctx/input tensors, masks?)
    ("save_attn+drop", 5, True), ("save_attn", 5, False),
    ("save_ctx+drop", 2, True), ("save_ctx", 2, False))


def _card_memory(device: torch.device) -> Optional[float]:
    """The card's memory in bytes; None off the card (the CPU: 'auto'
    checkpoints nothing there)."""
    if device.type != "cuda":
        return None
    return float(torch.cuda.get_device_properties(device).total_memory)


def fold_in(base_seed: int, step: int) -> int:
    """A seed for ``step`` derived from ``base_seed`` (the role of
    ``jax.random.fold_in``), in [0, 2**62)."""
    words = np.random.SeedSequence([int(base_seed), int(step)]).generate_state(
        2, np.uint32)
    return (int(words[0]) << 32 | int(words[1])) % (2 ** SEED_BITS)


@dataclass
class EpochMetrics:
    loss: float = 0.0
    mlm_loss: float = 0.0
    ap_loss: float = 0.0
    label_loss: float = 0.0
    nce: float = 0.0
    mlm_overflow: int = 0  # total gather-cap overflow; anything >0 is a bug
    grad_norm: float = 0.0
    grad_norm_steps: int = 0
    steps: int = 0
    samples: int = 0
    seconds: float = 0.0

    def update(self, m: Dict[str, Any], batch_size: int):
        self.loss += float(m["loss"])
        self.mlm_loss += float(m["mlm_loss"])
        self.ap_loss += float(m["ap_loss"])
        self.label_loss += float(m["label_loss"])
        self.nce += float(m["nce"])
        if "mlm_overflow" in m:
            self.mlm_overflow += int(m["mlm_overflow"])
        if "grad_norm" in m:
            self.grad_norm += float(m["grad_norm"])
            self.grad_norm_steps += 1
        self.steps += 1
        self.samples += batch_size

    def averaged(self) -> Dict[str, float]:
        s = max(self.steps, 1)
        out = {"loss": self.loss / s, "mlm_loss": self.mlm_loss / s,
               "ap_loss": self.ap_loss / s, "label_loss": self.label_loss / s,
               "nce": self.nce / s, "mlm_overflow": self.mlm_overflow}
        if self.grad_norm_steps:
            out["grad_norm"] = self.grad_norm / self.grad_norm_steps
        if self.seconds > 0:
            out["samples_per_sec"] = self.samples / self.seconds
        return out


@dataclass
class FitResult:
    """The selection state of :meth:`Trainer.fit` (JAX ``FitResult``)."""
    best_epoch: int = -1
    best_acc: float = 0.0
    best_mae: float = float("inf")
    best_f1: float = 0.0
    best_preds: Optional[np.ndarray] = None
    best_labels: Optional[np.ndarray] = None
    history: List[Dict[str, Any]] = field(default_factory=list)

    def to_meta(self) -> Dict[str, Any]:
        """JSON-serializable selection state (preds/labels go to .npy)."""
        return {
            "best_epoch": int(self.best_epoch),
            "best_acc": float(self.best_acc),
            "best_mae": float(self.best_mae),
            "best_f1": float(self.best_f1),
            "history": self.history,
        }

    @classmethod
    def from_meta(cls, meta: Dict[str, Any],
                  directory: Optional[str] = None) -> "FitResult":
        r = cls(best_epoch=int(meta.get("best_epoch", -1)),
                best_acc=float(meta.get("best_acc", 0.0)),
                best_mae=float(meta.get("best_mae", float("inf"))),
                best_f1=float(meta.get("best_f1", 0.0)),
                history=list(meta.get("history", [])))
        if directory is not None:
            for attr, name in (("best_preds", "predict.npy"),
                               ("best_labels", "target.npy")):
                path = os.path.join(directory, name)
                if os.path.exists(path):
                    setattr(r, attr, np.load(path))
        return r


class Trainer:
    """Owns the device, the optimizer and the train / eval steps."""

    def __init__(self, config: ExperimentConfig, device="cuda",
                 mask_token_id: int = masking.DEFAULT_MASK_ID,
                 special_ids: Tuple[int, ...] = masking.DEFAULT_SPECIAL_IDS):
        """The mesh is ``make_mesh(data_parallel, model_parallel)`` over the
        process group (one rank without one): an axis above 1 needs the
        process group started (``parallel.distributed.initialize``)."""
        tc = config.train
        if tc.compute_dtype not in _DTYPES:
            raise ValueError(f"unknown compute_dtype {tc.compute_dtype!r}")
        self.mesh = make_mesh(tc.data_parallel, tc.model_parallel)
        self.dp = DataParallel.from_mesh(self.mesh)
        self.mp = ModelParallel.from_mesh(self.mesh, tc.sequence_parallel)
        if self.mp is not None:
            sharding.check_divisible(config.model.bert, self.mp.size)
        # the rank's data index: the hidden dropout seeds' shard (the
        # attention seeds' is m + mp * d, bert_encoder)
        self.shard = 0 if self.dp is None else self.dp.index
        # gradient all-reduces over the data group
        self._comm = CommTimer()
        self.config = config
        self.device = torch.device(device)
        self.compute_dtype = _DTYPES[tc.compute_dtype]
        self.mask_token_id = mask_token_id
        self.special_ids = tuple(special_ids)
        self.tx = None  # set in init_state
        # Parity hook: a callable (epoch, batch_index, batch) -> dict with
        # "mlm_masked"/"mlm_replaced" [B, 3, L] bools; when set, the step
        # applies these MLM masks (ops/masking.py::apply_mlm_masks) instead
        # of drawing them, so the JAX trainer and this one can consume
        # identical masks.  train_step reads them from the batch.
        self.mlm_mask_injector = None
        # "none" or a JAX policy name, resolved once (models/bert.py)
        self.remat_policy = self._resolve_remat_policy()

    # ------------------------------------------------------------------
    # State
    # ------------------------------------------------------------------

    def init_state(self, seed: int, total_steps: int,
                   params=None) -> TrainState:
        """Random parameters from ``seed`` (``models/weights.py``), or a copy
        of ``params`` (e.g. ``from_jax_params``), as f32 masters on the
        device, and a fresh optimizer state (``FusedAdamW`` under
        ``fused_optimizer``, as JAX picks it).  Replace ``opt_state`` (e.g.
        with ``from_jax_opt_state``) to resume one."""
        if params is None:
            params = init_params(self.config.model, torch.Generator(
                device=self.device).manual_seed(int(seed)))
        params = map_tree(self.local_tree(params), lambda p: p.detach().to(
            self.device, torch.float32, copy=True).requires_grad_())
        tc = self.config.train
        self.tx = (make_fused_optimizer if tc.fused_optimizer
                   else make_optimizer)(tc, total_steps)
        self.tx.mp = self.mp
        return TrainState(params=params, opt_state=self.tx.init(params))

    def local_tree(self, tree):
        """The rank's shard of a full tree (parameters or moments) under
        tensor parallelism; the tree itself otherwise."""
        if self.mp is None:
            return tree
        return sharding.shard_params(tree, self.mesh, dist.get_rank())

    def local_opt_state(self, opt_state):
        """The rank's shard of a full optimizer state (a checkpoint's, or
        ``from_jax_opt_state``'s)."""
        if self.mp is None:
            return opt_state
        return sharding.shard_opt_state(opt_state, self.mesh, dist.get_rank())

    def full_state(self, state: TrainState) -> TrainState:
        """The whole state from every rank's shard (collective over the
        model group); the state itself without one."""
        if self.mp is None:
            return state
        return TrainState(
            params=sharding.gather_across(state.params, self.mp),
            opt_state=sharding.gather_opt_state(state.opt_state, self.mp),
            step=state.step)

    # ------------------------------------------------------------------
    # Steps
    # ------------------------------------------------------------------

    def _frame_level_flash(self) -> bool:
        """Frame-level mode with the joint pass on the flash2 route."""
        data = self.config.data
        return (data.pair_seq_length is not None
                and data.max_seq_length + data.pair_seq_length >= FLASH_MIN_SEQ
                and self.config.train.use_flash_attention != "never")

    def _resolve_remat_policy(self) -> str:
        """The remat policy of the step: "none" when ``remat`` is off, a
        named policy as given (validated), and for ``auto``: "none" while
        :meth:`activation_bytes` fits half the card (always on the CPU),
        else the first rung of JAX's ladder whose stash fits its budget
        (see above), else "full"."""
        tc = self.config.train
        if not tc.remat:
            return "none"
        if tc.remat_policy != "auto":
            if parse_remat_policy(tc.remat_policy)[0] == "none":
                raise ValueError(f"unknown remat_policy {tc.remat_policy!r}")
            return tc.remat_policy
        memory = _card_memory(self.device)
        if memory is None or \
                self.activation_bytes() <= _ACT_MEMORY_FRACTION * memory:
            return "none"
        budget = memory * (_REMAT_STASH_FRACTION_FRAME
                           if self._frame_level_flash()
                           else _REMAT_STASH_FRACTION)
        it = torch.empty((), dtype=self.compute_dtype).element_size()
        text, joint = self._tokens()
        out32 = (4 * joint / (text + joint) if self._frame_level_flash()
                 and self.compute_dtype != torch.float32 else 0)
        per_element = self.activation_bytes() / (
            _ACT_ELEMENTS_PER_TOKEN_LAYER * it)  # tokens x H x layers
        for policy, tensors, masks in _REMAT_LADDER:
            if per_element * (tensors * it + out32 + 2 * masks) < budget:
                return policy
        return "full"

    def _tokens(self) -> Tuple[int, int]:
        """(text pass, joint passes) tokens of one step of this rank (its
        rows of the batch under dp; under ``fuse_text_pass`` the one
        [3B, L+Lp] call counts as joint)."""
        tc = self.config.train
        b = -(-tc.train_batch_size // (1 if self.dp is None else self.dp.size))
        if self.mp is not None:  # JAX divides by every device of the mesh
            b = -(-b // self.mp.size)
        l = self.config.data.max_seq_length
        lp = self.config.data.pair_seq_length or l
        if tc.fuse_text_pass:
            return 0, 3 * b * (l + lp)
        return b * l, 2 * b * (l + lp)

    def activation_bytes(self) -> float:
        """The eager step's saved activations, estimated (see above)."""
        bert = self.config.model.bert
        tokens = sum(self._tokens())
        itemsize = torch.empty((), dtype=self.compute_dtype).element_size()
        return (tokens * _ACT_ELEMENTS_PER_TOKEN_LAYER * itemsize
                * bert.hidden_size * bert.num_hidden_layers)

    def upload(self, batch: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        """A numpy batch (``MultimodalDataset.epoch_batches``) on the device."""
        regression = self.config.model.regression
        kinds = {"text_ids": torch.long, "text_mask": torch.int32,
                 "visual": torch.float32, "speech": torch.float32,
                 "visual_ap": torch.long, "speech_ap": torch.long,
                 "target": torch.float32 if regression else torch.long,
                 "weight": torch.float32, "mlm_masked": torch.bool,
                 "mlm_replaced": torch.bool}
        out = {}
        for key, value in batch.items():
            t = torch.as_tensor(np.asarray(value)).to(kinds[key])
            if self.device.type == "cuda":
                t = t.pin_memory()
            out[key] = t.to(self.device, non_blocking=True)
        return out

    def _global_batch(self, batch: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        """The host batch on the device, padded to a multiple of the data
        axis under dp."""
        return self.upload(batch if self.dp is None
                           else pad_batch(batch, self.dp.size))

    def _local(self, b: Dict[str, torch.Tensor], views):
        """The rank's rows of the global batch and MLM views."""
        if self.dp is None:
            return b, views
        rows = lambda x: local_rows(x, self.dp.size, self.dp.index)  # noqa: E731
        return ({k: rows(v) for k, v in b.items()},
                [(rows(ids), rows(lab)) for ids, lab in views])

    def _sum_metrics(self, metrics: Dict[str, torch.Tensor]
                     ) -> Dict[str, torch.Tensor]:
        """The ranks' shares of each scalar metric summed (one all-reduce);
        predictions gathered."""
        if self.dp is None:
            return metrics
        keys = [k for k in metrics if k != "predictions"]
        total = self.dp.sum(torch.stack([metrics[k].float() for k in keys]))
        out = {k: t.to(metrics[k].dtype) for k, t in zip(keys, total.unbind())}
        if "predictions" in metrics:
            out["predictions"] = self.dp.gather(metrics["predictions"])
        return out

    def _sum_grads(self, paths, grads):
        """The gradients summed over the data group in one flat buffer;
        under sequence parallelism the partial ones of the replicated
        leaves the sequence shards feed first over the model group."""
        grads = list(grads)
        if self.mp is not None and self.mp.sequence_parallel:
            idx = [i for i, p in enumerate(paths)
                   if sharding.sequence_partial(p)]
            for i, g in zip(idx, self.mp.sum_flat([grads[i] for i in idx])):
                grads[i] = g
        if self.dp is None:
            return grads
        with self._comm(self.device):
            return self.dp.sum_flat(grads)

    @property
    def comm_seconds(self) -> float:
        """The gradient all-reduces' time so far (on the card: between
        events on the step's stream, read here, after the steps)."""
        return self._comm.seconds

    @property
    def model_comm_seconds(self) -> float:
        """The model group's collectives' time so far (0 without one)."""
        return 0.0 if self.mp is None else self.mp.timer.seconds

    def _mlm_views(self, b, generator):
        ids = b["text_ids"]
        data = self.config.data
        if data.mlm and "mlm_masked" in b:
            m, r = b["mlm_masked"], b["mlm_replaced"]
            return [masking.apply_mlm_masks(ids, m[:, i], r[:, i],
                                            self.mask_token_id)
                    for i in range(3)]
        if data.mlm:
            dev = seeded_generator(draw_seed(generator), self.device)
            return [masking.mask_tokens(dev, ids, data.mlm_probability,
                                        self.mask_token_id, self.special_ids)
                    for _ in range(3)]
        labels = torch.where(b["text_mask"] > 0, ids, masking.IGNORE_INDEX)
        return [(ids, labels)] * 3

    def train_step(self, state: TrainState, batch: Dict[str, Any],
                   base_seed: int) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        """One step: forward with dropout, loss, backward, AdamW update (in
        place).  The step's randomness comes from ``base_seed`` with the
        step number folded in.  Returns (state, metrics); the metrics are
        0-d device tensors (no host synchronisation)."""
        if self.tx is None:
            raise RuntimeError("train_step before init_state")
        cfg = self.config.model
        tc = self.config.train
        b = self._global_batch(batch)
        generator = torch.Generator().manual_seed(fold_in(base_seed, state.step))
        b, views = self._local(b, self._mlm_views(b, generator))
        (t_ids, t_lab), (tv_ids, tv_lab), (ts_ids, ts_lab) = views
        paths, leaves = zip(*named_leaves(state.params))
        with torch.enable_grad():
            params = cast_for_compute(state.params, self.compute_dtype)
            out = mmbert_forward(
                params, t_ids, b["text_mask"], tv_ids, ts_ids, b["visual"],
                b["speech"], cfg, compute_dtype=self.compute_dtype,
                use_flash=tc.use_flash_attention, deterministic=False,
                generator=generator, remat_policy=self.remat_policy,
                fuse_text_pass=tc.fuse_text_pass, shard=self.shard,
                mp=self.mp)
            losses = mmbert_loss(params, out, t_lab, tv_lab, ts_lab,
                                 b["visual_ap"], b["speech_ap"], b["target"],
                                 cfg, weights=b["weight"], dp=self.dp,
                                 mp=self.mp)
            # parameters the loss does not reach (the NSP head) get zero
            # gradients, as jax.grad gives them
            grads = torch.autograd.grad(losses["loss"], leaves,
                                        allow_unused=True,
                                        materialize_grads=True)
        grads = self._sum_grads(paths, grads)
        metrics = self._sum_metrics({k: losses[k].detach() for k in _METRICS})
        if tc.log_grad_norm:
            metrics["grad_norm"] = global_norm(list(grads), list(paths),
                                               self.mp)
        self.tx.step(state.params, dict(zip(paths, grads)), state.opt_state)
        state.step += 1
        return state, metrics

    @torch.no_grad()
    def eval_step(self, params, batch: Dict[str, Any],
                  seed: int) -> Dict[str, torch.Tensor]:
        """Deterministic forward + loss; no MLM masking unless
        ``eval_masking`` (then the masks come from ``seed``)."""
        cfg = self.config.model
        tc = self.config.train
        b = self._global_batch(batch)
        ids = b["text_ids"]
        if tc.eval_masking:
            views = self._mlm_views({"text_ids": ids, "text_mask": b["text_mask"]},
                                    torch.Generator().manual_seed(int(seed)))
        else:
            ignore = torch.full_like(ids, masking.IGNORE_INDEX)
            views = [(ids, ignore)] * 3
        b, views = self._local(b, views)
        (t_ids, t_lab), (tv_ids, tv_lab), (ts_ids, ts_lab) = views
        params = cast_for_compute(params, self.compute_dtype)
        out = mmbert_forward(params, t_ids, b["text_mask"], tv_ids, ts_ids,
                             b["visual"], b["speech"], cfg,
                             compute_dtype=self.compute_dtype,
                             use_flash=tc.use_flash_attention,
                             fuse_text_pass=tc.fuse_text_pass, mp=self.mp)
        # under dp: the global losses and every rank's predictions
        return self._sum_metrics(mmbert_loss(
            params, out, t_lab, tv_lab, ts_lab, b["visual_ap"],
            b["speech_ap"], b["target"], cfg, weights=b["weight"],
            compute_mlm=tc.eval_masking, dp=self.dp, mp=self.mp))

    # ------------------------------------------------------------------
    # Epochs
    # ------------------------------------------------------------------

    def train_epoch(self, state: TrainState, dataset: MultimodalDataset,
                    epoch: int, base_seed: int
                    ) -> Tuple[TrainState, EpochMetrics]:
        tc = self.config.train
        em = EpochMetrics()
        t0 = time.perf_counter()
        batches = prefetch(dataset.epoch_batches(
            epoch, tc.train_batch_size, shuffle=True, force_aligned=False))
        device_metrics: List[Dict[str, torch.Tensor]] = []
        profiling = tc.profile_dir is not None and epoch == 0
        prof = None
        for i, batch in enumerate(batches):
            if self.mlm_mask_injector is not None:
                batch = dict(batch)
                batch.update(self.mlm_mask_injector(epoch, i, batch))
            if profiling and i == tc.profile_start:
                prof = self._profiler()
                prof.start()
            elif prof is not None:
                prof.step()
            state, metrics = self.train_step(state, batch, base_seed)
            # metric scalars stay on the device: one transfer at epoch end
            device_metrics.append(metrics)
            if prof is not None and i + 1 == tc.profile_stop:
                prof.stop()
                prof, profiling = None, False
        if prof is not None:  # the epoch ended inside the window
            prof.stop()
        for m in device_metrics:
            em.update({k: v.item() for k, v in m.items()}, tc.train_batch_size)
        em.seconds = time.perf_counter() - t0
        return state, em

    def _profiler(self):
        """A ``torch.profiler`` trace of the train steps [profile_start,
        profile_stop) of epoch 0 (one ``ProfilerStep#`` span a step),
        written into ``profile_dir`` (one ``*.pt.trace.json`` a rank,
        TensorBoard's layout) when it stops."""
        from torch.profiler import (ProfilerActivity, profile, schedule,
                                    tensorboard_trace_handler)

        tc = self.config.train
        activities = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        return profile(
            activities=activities,
            schedule=schedule(wait=0, warmup=0, repeat=1,
                              active=max(tc.profile_stop - tc.profile_start, 1)),
            on_trace_ready=tensorboard_trace_handler(
                tc.profile_dir, worker_name=f"rank{process_index()}"))

    def eval_epoch(self, state: TrainState, dataset: MultimodalDataset,
                   epoch: int, base_seed: int, batch_size: int
                   ) -> Tuple[EpochMetrics, np.ndarray, np.ndarray]:
        tc = self.config.train
        em = EpochMetrics()
        device_losses, masks, labels = [], [], []
        t0 = time.perf_counter()
        for bi, batch in enumerate(dataset.epoch_batches(
                epoch, batch_size, shuffle=False,
                force_aligned=not tc.eval_random_pairs)):
            w = batch["weight"] > 0
            # epoch and batch index fold into the seed, so eval_masking draws
            # fresh masks per batch
            seed = fold_in(fold_in(base_seed, epoch), bi)
            device_losses.append(self.eval_step(state.params, batch, seed))
            masks.append(w)
            labels.append(batch["target"][w])
        preds: List[np.ndarray] = []
        for losses, w in zip(device_losses, masks):
            host = {k: v.cpu().numpy() for k, v in losses.items()}
            em.update(host, int(w.sum()))
            p = host["predictions"]
            preds.append(p.reshape(p.shape[0], -1)[: len(w)][w])
        em.seconds = time.perf_counter() - t0
        return em, np.concatenate(preds), np.concatenate(labels)

    # ------------------------------------------------------------------
    # Fit
    # ------------------------------------------------------------------

    def fit(self, state: TrainState, train_ds: MultimodalDataset,
            val_ds: MultimodalDataset, test_ds: MultimodalDataset,
            logger=None, checkpoint_dir: Optional[str] = None,
            base_seed: Optional[int] = None, start_epoch: int = 0,
            resume_result: Optional[FitResult] = None
            ) -> Tuple[TrainState, FitResult]:
        """Train ``n_epochs`` (from ``start_epoch``), selecting on the val
        split (or the test split, ``select_on="test"``), with patience and
        one checkpoint per improvement (``epoch_NNN`` under
        ``checkpoint_dir``, with ``predict.npy`` / ``target.npy`` and the
        selection state in meta.json's ``fit``).  ``resume_result``
        restores that state, so a resumed run continues the same fit.
        ``base_seed`` (default: the config's seed) keys every step's
        randomness with the step number folded in, so a run resumed from a
        checkpoint takes the uninterrupted run's steps."""
        from .checkpoint import epoch_dir, save_checkpoint

        tc = self.config.train
        log = logger.info if logger else (
            lambda *a: print(a[0] % tuple(a[1:]) if a[1:] else a[0]))
        base_seed = tc.seed if base_seed is None else base_seed
        scorer = test_mse_score if self.config.model.regression else test_ce_score

        result = resume_result if resume_result is not None else FitResult()
        # epochs already run without improvement (0 when resuming from the
        # best checkpoint, which is where resume normally starts)
        patience = max(0, start_epoch - result.best_epoch - 1) \
            if result.history else 0
        for epoch in range(start_epoch, tc.n_epochs):
            patience += 1
            state, tm = self.train_epoch(state, train_ds, epoch, base_seed)
            t = tm.averaged()
            log("[Train Epoch %d] Joint %.4f AP %.4f MLM %.4f Label %.4f NCE "
                "%.4f (%.1f samples/s)", epoch + 1, t["loss"], t["ap_loss"],
                t["mlm_loss"], t["label_loss"], t["nce"],
                t.get("samples_per_sec", 0.0))
            if "grad_norm" in t:
                log("[Train Epoch %d] grad_norm %.4f", epoch + 1, t["grad_norm"])
            if t["mlm_overflow"]:
                log("WARNING: MLM gather cap overflowed by %d positions this "
                    "epoch -- raise the cap (losses underweighted MLM)",
                    int(t["mlm_overflow"]))

            vm, vpreds, vlabels = self.eval_epoch(state, val_ds, epoch,
                                                  base_seed, tc.val_batch_size)
            if len(vpreds) > 1 and float(np.std(np.asarray(
                    vpreds, np.float64))) < 1e-6:
                log("WARNING: validation predictions are constant (%.4f) -- "
                    "saturated head? try lower --beta / --learning_rate",
                    float(np.asarray(vpreds).reshape(-1)[0]))
            val_acc, val_mae, val_f1 = scorer(vpreds, vlabels)
            v = vm.averaged()
            log("[Val Epoch %d] Loss %.4f ACC %.4f MAE %.4f F1 %.4f",
                epoch + 1, v["loss"], val_acc, val_mae, val_f1)

            _, tpreds, tlabels = self.eval_epoch(state, test_ds, epoch,
                                                 base_seed, tc.test_batch_size)
            test_acc, test_mae, test_f1 = scorer(tpreds, tlabels)
            log("[Epoch %d] Test_ACC %.4f Test_MAE %.4f Test_F1 %.4f",
                epoch + 1, test_acc, test_mae, test_f1)

            select_acc = val_acc if tc.select_on == "val" else test_acc
            result.history.append({
                "epoch": epoch + 1, "train": t, "val_acc": val_acc,
                "val_mae": val_mae, "test_acc": test_acc, "test_mae": test_mae,
                "test_f1": test_f1,
            })

            if select_acc > result.best_acc:
                result.best_epoch = epoch
                result.best_acc = select_acc
                result.best_mae = test_mae
                result.best_f1 = test_f1
                result.best_preds = tpreds
                result.best_labels = tlabels
                patience = 0
                if checkpoint_dir:
                    # one retained checkpoint per improvement, carrying the
                    # selection state for an exact resume; the whole state
                    # (the model group's shards gathered) is replicated, so
                    # rank 0 writes it and every rank waits until it is whole
                    d = epoch_dir(checkpoint_dir, epoch)
                    whole = self.full_state(state)
                    if process_index() == 0:
                        save_checkpoint(d, whole, self.config, epoch,
                                        extra={"fit": result.to_meta()})
                        np.save(os.path.join(d, "predict.npy"), tpreds)
                        np.save(os.path.join(d, "target.npy"), tlabels)
                    barrier()

            if patience >= tc.patience:
                log("Early stopping at epoch %d", epoch + 1)
                break

        log("[Best Epoch %d] ACC %.4f MAE %.4f F1 %.4f",
            result.best_epoch + 1, result.best_acc, result.best_mae,
            result.best_f1)
        return state, result

    # ------------------------------------------------------------------
    # Perf accounting
    # ------------------------------------------------------------------

    def step_flops(self) -> float:
        return mmbert_step_flops(self.config.model,
                                 self.config.train.train_batch_size,
                                 self.config.data.max_seq_length,
                                 pair_seq=self.config.data.pair_seq_length)

    def mfu(self, samples_per_sec: float) -> float:
        """Model FLOP utilisation against the H100's dense bf16 peak."""
        steps_per_sec = samples_per_sec / self.config.train.train_batch_size
        return self.step_flops() * steps_per_sec / H100_BF16_PEAK_FLOPS
