"""Checkpoint inference CLI (``msa_tpu/cli/sample.py`` in the port): load a
checkpoint (written by either package), run the test split through the
deterministic eval step, print the scores and, for regression, the full
MISA report.

    python -m msa_tpu_torch.cli.sample --checkpoint model_save/20260816-00 \
        --data_pkl cmu_mosi.pkl --vocab vocab.txt [--device cpu]

It takes JAX's ``--dp`` (the data-parallel size the eval step runs at, -1:
every rank of the launch) and ``--mp`` (the model-parallel size).  Above
one rank every process runs this CLI, started by torchrun (``env://``) or
with the ``MSA_COORDINATOR`` / ``MSA_NUM_PROCESSES`` / ``MSA_PROCESS_ID``
variables of ``cli.train``'s manual launch.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import pickle
import sys

from ..data.dataset import MultimodalDataset
from ..data.featurize import featurize, synthetic_split
from ..data.wordpiece import Tokenizer
from ..metrics.scores import misa_report, test_ce_score, test_mse_score
from ..training.checkpoint import load_checkpoint, load_config, resolve_checkpoint
from ..training.trainer import Trainer
from .train import launch_from


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--checkpoint", type=str, required=True,
                   help="run dir (holding epoch_NNN checkpoints) or a direct "
                        "checkpoint dir")
    p.add_argument("--model_num", type=int, default=None,
                   help="epoch number of the retained checkpoint to load "
                        "(ref sampling.py --model_num); default: newest/best")
    p.add_argument("--data_pkl", type=str, default=None)
    p.add_argument("--vocab", type=str, default=None)
    p.add_argument("--synthetic", type=int, default=0)
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--dp", type=int, default=-1,
                   help="data-parallel size (-1: every rank of the launch)")
    p.add_argument("--mp", type=int, default=1,
                   help="model-parallel (tensor-parallel) size")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device to run on (default: cuda)")
    args = p.parse_args(argv)
    device = launch_from(args.device, distributed="WORLD_SIZE" in os.environ)

    try:
        ckpt = resolve_checkpoint(args.checkpoint, args.model_num)
    except FileNotFoundError as e:
        sys.exit(str(e))
    exp = load_config(ckpt)
    if exp is None:
        sys.exit(f"no config.json found in {ckpt}")
    exp = dataclasses.replace(exp, train=dataclasses.replace(
        exp.train, data_parallel=args.dp, model_parallel=args.mp))

    vdim, sdim = exp.model.visual_dim, exp.model.speech_dim
    lp = exp.data.pair_seq_length
    mask_kwargs = {}
    if args.data_pkl:
        if not args.vocab:
            sys.exit("--vocab is required with --data_pkl")
        tokenizer = Tokenizer.from_file(args.vocab)
        mask_kwargs = dict(mask_token_id=tokenizer.mask_token_id,
                           special_ids=tuple(tokenizer.special_token_ids()))
        with open(args.data_pkl, "rb") as f:
            data = pickle.load(f)
        fs = featurize(data["test"], tokenizer, exp.data.max_seq_length, vdim,
                       sdim, exp.data.dataset, exp.data.emotion,
                       exp.data.num_labels, pair_seq_length=lp)
    else:
        n = args.synthetic or 64
        fs = synthetic_split(n, exp.data.max_seq_length, vdim, sdim,
                             vocab_size=exp.model.bert.vocab_size,
                             num_labels=exp.data.num_labels, seed=2,
                             pair_seq_length=lp)
    test_ds = MultimodalDataset(fs, seed=0)

    trainer = Trainer(exp, device, **mask_kwargs)
    state, meta = load_checkpoint(ckpt, trainer.device)
    state.params = trainer.local_tree(state.params)
    print(f"Loaded checkpoint at step {meta.get('step')} epoch {meta.get('epoch')}")

    _, preds, labels = trainer.eval_epoch(state, test_ds, 0, 0, args.batch_size)
    scorer = test_mse_score if exp.model.regression else test_ce_score
    acc, mae, f1 = scorer(preds, labels)
    print(f"ACC {acc:.4f} MAE {mae:.4f} F1 {f1:.4f}")
    if exp.model.regression:
        misa_report(labels, preds, verbose=True)
    return preds, labels


if __name__ == "__main__":
    main()
