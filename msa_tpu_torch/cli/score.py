"""Offline scoring CLI (ref score.py:121-134), the port's copy of
``msa_tpu/cli/score.py``: the MISA report of saved predictions.

    python -m msa_tpu_torch.cli.score --path 20260816-00
    python -m msa_tpu_torch.cli.score --predict p.npy --target t.npy
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from ..metrics.scores import misa_report


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--path", type=str, default=None,
                   help="run dir under numpy_save/ containing predict/target.npy")
    p.add_argument("--predict", type=str, default=None)
    p.add_argument("--target", type=str, default=None)
    p.add_argument("--numpy_root", type=str, default="numpy_save")
    p.add_argument("--swap_binary", action="store_true",
                   help="reproduce the reference's swapped binary report")
    args = p.parse_args(argv)

    if args.path:
        preds = np.load(os.path.join(args.numpy_root, args.path, "predict.npy"))
        labels = np.load(os.path.join(args.numpy_root, args.path, "target.npy"))
    elif args.predict and args.target:
        preds = np.load(args.predict)
        labels = np.load(args.target)
    else:
        p.error("give --path or both --predict/--target")

    print(np.unique(np.round(preds.reshape(-1))))
    print(np.unique(np.round(labels.reshape(-1))))
    report = misa_report(labels, preds, swap_binary=args.swap_binary,
                         verbose=True)
    return report


if __name__ == "__main__":
    main()
