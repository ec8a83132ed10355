"""Preprocessing CLI (the JAX package's ``cli/preprocess.py``; ref
pre_processing.py / parse_funny.py entry points).

    python -m msa_tpu_torch.cli.preprocess --dataset cmu_mosi --data_path ./sdk_data
    python -m msa_tpu_torch.cli.preprocess --dataset ur_funny --data_path ./sdk_features
"""

from __future__ import annotations

import argparse


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--dataset", type=str, required=True,
                   choices=["cmu_mosi", "cmu_mosei", "ur_funny"])
    p.add_argument("--data_path", type=str, default="./sdk_data")
    p.add_argument("--out", type=str, default=None)
    p.add_argument("--eps", type=float, default=1e-6,
                   help="z-norm epsilon (reference used 0 for CMU: pass 0.0 "
                        "to reproduce, at your own div-by-zero risk)")
    args = p.parse_args(argv)

    if args.dataset == "ur_funny":
        from ..data.preprocessing.ur_funny import run
        run(args.data_path, args.out or "cmu_ur_funny.pkl", args.eps)
    else:
        from ..data.preprocessing.cmu import run
        run(args.dataset, args.data_path, args.out, eps=args.eps)


if __name__ == "__main__":
    main()
