"""Training CLI: the JAX package's flag surface (``msa_tpu/cli/train.py``,
itself the reference's train.py:24-41) around the port's ``Trainer.fit``.

    python -m msa_tpu_torch.cli.train --dataset mosi --num_labels 7 \
        --alpha 0.4 --beta 0.7 --vocab vocab.txt --data_pkl cmu_mosi.pkl

Without ``--data_pkl`` a synthetic dataset of ``--synthetic N`` examples is
generated.  It trains on the card unless ``--device cpu`` asks for the CPU.
``--resume <run dir or epoch dir>`` continues a fit from its checkpoint
(written by this CLI or by the JAX package's): the weights, the optimizer
state and the step, and the selection state in meta.json, so the resumed
epochs take the uninterrupted run's steps.  The remat policy comes from
the config (``TrainConfig.remat_policy``, "auto" by default).

Data parallelism across processes: every process runs this CLI with the
same flags plus its own id, e.g. two ranks on one host

    python -m msa_tpu_torch.cli.train --dp 2 --coordinator 127.0.0.1:29500 \
        --num_processes 2 --process_id {0,1} ...

(``MSA_COORDINATOR`` / ``MSA_NUM_PROCESSES`` / ``MSA_PROCESS_ID`` fill the
flags left out), or ``torchrun --nproc_per_node 2 -m msa_tpu_torch.cli.train
--distributed --dp 2 ...`` (``env://``).  Each rank trains on
``cuda:{local rank % cards}`` (or the CPU with ``--device cpu``), over gloo
where ranks share a card or tensors are on the CPU, else NCCL
(``parallel/distributed.py``).  Rank 0 writes the checkpoints and the saved
predictions.

Tensor and sequence parallelism: ``--mp M`` splits the weights over M ranks
(the data axis takes the rest: ``--dp -1``), e.g. on the CPU

    python -m msa_tpu_torch.cli.train --device cpu --dp 2 --mp 2 \
        --coordinator 127.0.0.1:29500 --num_processes 4 --process_id {0..3} ...

The config's ``sequence_parallel`` splits the residual stream over the
sequence as well.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import pickle
import sys
from typing import Optional, Tuple

import numpy as np

from ..configs import MODALITY_DIMS, build_experiment
from ..data.dataset import MultimodalDataset
from ..data.featurize import featurize, synthetic_split
from ..data.wordpiece import Tokenizer
from ..training.trainer import FitResult, Trainer
from ..utils.logging import get_logger, make_date_dir


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    # reference flag surface (train.py:24-41)
    p.add_argument("--dataset", type=str, choices=["mosi", "mosei", "ur_funny"],
                   default="mosei")
    p.add_argument("--emotion", type=str, default="sentiment")
    p.add_argument("--num_labels", type=int, default=1)
    p.add_argument("--model", type=str,
                   choices=["bert-base-uncased", "bert-large-uncased", "tiny"],
                   default="bert-large-uncased")
    p.add_argument("--learning_rate", type=float, default=5e-4)
    p.add_argument("--warmup_proportion", type=float, default=0.1)
    p.add_argument("--n_epochs", type=int, default=200)
    p.add_argument("--train_batch_size", type=int, default=32)
    p.add_argument("--val_batch_size", type=int, default=4)
    p.add_argument("--test_batch_size", type=int, default=8)
    p.add_argument("--gradient_accumulation_step", type=int, default=1)
    p.add_argument("--mlm", action=argparse.BooleanOptionalAction, default=True)
    p.add_argument("--mlm_probability", type=float, default=0.15)
    p.add_argument("--max_seq_length", type=int, default=40)
    p.add_argument("--pair_seq_length", type=int, default=None,
                   help="frame-level mode: keep visual/speech at native "
                        "frame rate with this fixed length Lp (joint pass "
                        "runs over max_seq_length + Lp tokens); default: "
                        "word-aligned, Lp == max_seq_length")
    p.add_argument("--alpha", type=float, default=1.0)
    p.add_argument("--beta", type=float, default=1.0)
    p.add_argument("--data_pkl", type=str, default=None,
                   help="pickle from preprocessing (cmu_<dataset>.pkl)")
    p.add_argument("--vocab", type=str, default=None,
                   help="BERT wordpiece vocab.txt (required with --data_pkl)")
    p.add_argument("--pretrained", type=str, default=None,
                   help="a local torch state_dict file (.pt/.bin) of an HF "
                        "BertForPreTraining; see scripts/fetch_bert_weights.py "
                        "for making one on a networked machine")
    p.add_argument("--synthetic", type=int, default=0,
                   help="train on N synthetic examples instead of real data")
    p.add_argument("--checkpoint_root", type=str, default="./model_save")
    p.add_argument("--numpy_root", type=str, default="./numpy_save")
    p.add_argument("--resume", type=str, default=None)
    p.add_argument("--dp", type=int, default=-1,
                   help="data-parallel size (-1: every rank of the launch)")
    p.add_argument("--mp", type=int, default=1,
                   help="model-parallel (tensor-parallel) size")
    p.add_argument("--compute_dtype", type=str, default="bfloat16",
                   choices=["bfloat16", "float32"])
    p.add_argument("--use_flash_attention", type=str, default="auto",
                   choices=["auto", "always", "never"])
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device to train on (default: cuda)")
    # multi-process launch: every process runs this CLI with the same flags
    # plus its own --process_id; the process group starts before any
    # device use
    p.add_argument("--distributed", action="store_true",
                   help="start the process group from torchrun's "
                        "environment (env://)")
    p.add_argument("--coordinator", type=str, default=None,
                   help="host:port where rank 0 listens (manual launch)")
    p.add_argument("--num_processes", type=int, default=None)
    p.add_argument("--process_id", type=int, default=None)
    return p


def launch(args):
    """Start the process group when the launch flags (or their MSA_*
    variables) ask for one; returns the device this rank trains on."""
    return launch_from(args.device, args.distributed, args.coordinator,
                       args.num_processes, args.process_id)


def launch_from(device, distributed: bool = False,
                coordinator: Optional[str] = None,
                num_processes: Optional[int] = None,
                process_id: Optional[int] = None):
    """:func:`launch` from its values; what is None is read from the
    ``MSA_*`` variables."""
    from ..parallel.distributed import (initialize, process_env_defaults,
                                        rank_device)

    env = process_env_defaults()
    coordinator = coordinator or env["coordinator_address"]
    if not (distributed or coordinator or num_processes):
        return device
    process_id = process_id if process_id is not None else env["process_id"]
    initialize(coordinator_address=coordinator,
               num_processes=(num_processes if num_processes is not None
                              else env["num_processes"]),
               process_id=process_id, device=device)
    return rank_device(device, process_id)


def load_splits(args) -> Tuple[MultimodalDataset, MultimodalDataset,
                               MultimodalDataset, Optional[Tokenizer]]:
    vdim, sdim = MODALITY_DIMS[args.dataset]
    if args.data_pkl:
        if not args.vocab:
            sys.exit("--vocab is required with --data_pkl")
        from ..data.fast_wordpiece import FastTokenizer
        tokenizer = FastTokenizer(args.vocab)  # native path, python fallback
        with open(args.data_pkl, "rb") as f:
            data = pickle.load(f)
        splits = []
        for name in ("train", "val", "test"):
            fs = featurize(data[name], tokenizer, args.max_seq_length, vdim,
                           sdim, args.dataset, args.emotion, args.num_labels,
                           pair_seq_length=args.pair_seq_length)
            splits.append(MultimodalDataset(fs, seed=args.seed))
        return splits[0], splits[1], splits[2], tokenizer
    n = args.synthetic or 256
    mk = lambda n_, s: MultimodalDataset(  # noqa: E731
        synthetic_split(n_, args.max_seq_length, vdim, sdim,
                        num_labels=args.num_labels, seed=s,
                        pair_seq_length=args.pair_seq_length), seed=s)
    return mk(n, 0), mk(max(n // 8, 8), 1), mk(max(n // 8, 8), 2), None


def build_config(args):
    """The experiment the flags describe."""
    exp = build_experiment(
        dataset=args.dataset, model_name=args.model,
        num_labels=args.num_labels, emotion=args.emotion,
        alpha=args.alpha, beta=args.beta,
        learning_rate=args.learning_rate,
        warmup_proportion=args.warmup_proportion,
        n_epochs=args.n_epochs,
        train_batch_size=args.train_batch_size,
        val_batch_size=args.val_batch_size,
        test_batch_size=args.test_batch_size,
        gradient_accumulation_steps=args.gradient_accumulation_step,
        data_parallel=args.dp, model_parallel=args.mp,
        compute_dtype=args.compute_dtype,
        use_flash_attention=args.use_flash_attention,
        seed=args.seed,
    )
    exp = dataclasses.replace(
        exp, data=dataclasses.replace(
            exp.data, dataset=args.dataset, mlm=args.mlm,
            mlm_probability=args.mlm_probability,
            max_seq_length=args.max_seq_length,
            pair_seq_length=args.pair_seq_length,
            num_labels=args.num_labels))
    return exp


def run(args):
    """The CLI's flow; returns (trainer, final state, FitResult)."""
    from ..parallel import distributed

    device = launch(args)
    logger, _ = get_logger("./logs")
    logger.info("Alpha: %s Beta: %s", args.alpha, args.beta)
    if distributed.is_multiprocess():
        import torch.distributed as dist
        logger.info("Distributed: rank %d of %d on %s, backend %s",
                    dist.get_rank(), dist.get_world_size(), device,
                    dist.get_backend())

    train_ds, val_ds, test_ds, tokenizer = load_splits(args)
    logger.info("Split sizes: train %d val %d test %d",
                len(train_ds), len(val_ds), len(test_ds))

    exp = build_config(args)

    mask_kwargs = {}
    if tokenizer is not None:
        mask_kwargs = dict(mask_token_id=tokenizer.mask_token_id,
                           special_ids=tuple(tokenizer.special_token_ids()))
    trainer = Trainer(exp, device, **mask_kwargs)
    logger.info("Device: %s, mesh %s, remat policy %s", trainer.device,
                trainer.mesh.shape, trainer.remat_policy)

    steps_per_epoch = train_ds.num_batches(args.train_batch_size)
    total_steps = steps_per_epoch * args.n_epochs

    params = None
    if args.pretrained:
        import torch

        from ..models.weights import (init_params, load_pretrained_bert,
                                      resolve_pretrained)
        logger.info("Loading pretrained weights: %s", args.pretrained)
        params = load_pretrained_bert(
            resolve_pretrained(args.pretrained), exp.model,
            init_params(exp.model, torch.Generator(
                device=trainer.device).manual_seed(args.seed)))

    start_epoch = loaded_step = 0
    resume_result = None
    if args.resume:
        from ..training.checkpoint import load_checkpoint, resolve_checkpoint
        ckpt = resolve_checkpoint(args.resume)  # run dir or direct epoch dir
        loaded, meta = load_checkpoint(ckpt, trainer.device)
        state = trainer.init_state(args.seed, total_steps,
                                   params=loaded.params)
        state.opt_state = trainer.local_opt_state(loaded.opt_state)
        state.step = loaded.step
        loaded_step = loaded.step
        start_epoch = int(meta.get("epoch", -1)) + 1
        if "fit" in meta:  # restore best_*/patience/history, not just weights
            resume_result = FitResult.from_meta(meta["fit"], ckpt)
        logger.info("Resumed from %s at step %s (epoch %d)", ckpt,
                    meta.get("step"), start_epoch)
    else:
        state = trainer.init_state(args.seed, total_steps, params=params)

    main_rank = distributed.process_index() == 0
    # rank 0 writes; every rank names the same directory
    ckpt_dir = distributed.broadcast_object(
        make_date_dir(args.checkpoint_root) if main_rank else None)
    logger.info("Model save path: %s", ckpt_dir)
    state, result = trainer.fit(state, train_ds, val_ds, test_ds, logger,
                                checkpoint_dir=ckpt_dir,
                                start_epoch=start_epoch,
                                resume_result=resume_result)
    steps_run = max(state.step - loaded_step, 1)
    if trainer.dp is not None:
        logger.info("Gradient all-reduce: %.2f ms a step (%d ranks)",
                    trainer.comm_seconds * 1e3 / steps_run, trainer.dp.size)
    if trainer.mp is not None:
        logger.info("Model-group collectives: %.2f ms a step, eval included "
                    "(%d ranks)", trainer.model_comm_seconds * 1e3 / steps_run,
                    trainer.mp.size)
    if trainer.device.type == "cuda":
        import torch
        logger.info("Peak device memory: %.2f GiB",
                    torch.cuda.max_memory_allocated(trainer.device) / 2**30)

    if result.best_preds is not None and main_rank:
        np_dir = make_date_dir(args.numpy_root)
        np.save(os.path.join(np_dir, "predict.npy"), result.best_preds)
        np.save(os.path.join(np_dir, "target.npy"), result.best_labels)
        logger.info("Saved predictions to %s", np_dir)
    return trainer, state, result


def main(argv=None) -> FitResult:
    return run(build_parser().parse_args(argv))[2]


if __name__ == "__main__":
    main()
