"""Alpha/beta grid sweep driver (the JAX package's ``cli/sweep.py``, itself
the reference's run_main.sh:3-8).

Every cell runs the port's ``cli.train`` in this process and records its
best metrics as one JSON line.  Flags other than the three below go to
``cli.train`` unchanged (a data-parallel launch too; rank 0 writes).

    python -m msa_tpu_torch.cli.sweep --dataset mosi --num_labels 7 \\
        --data_pkl cmu_mosi.pkl --vocab vocab.txt \\
        --alphas 0.1:1.0:10 --betas 0.1:1.0:10
"""

from __future__ import annotations

import argparse
import json

import numpy as np


def parse_grid(spec: str):
    """'0.1:1.0:10' -> 10 evenly spaced values; '0.3,0.5' -> exact list."""
    if ":" in spec:
        lo, hi, n = spec.split(":")
        return [round(float(x), 6)
                for x in np.linspace(float(lo), float(hi), int(n))]
    return [float(x) for x in spec.split(",")]


def main(argv=None):
    from ..parallel.distributed import process_index
    from .train import main as train_main

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0],
                                add_help=False)
    p.add_argument("--alphas", type=str, default="0.1:1.0:10")
    p.add_argument("--betas", type=str, default="0.1:1.0:10")
    p.add_argument("--out", type=str, default="sweep_results.jsonl")
    sweep_args, rest = p.parse_known_args(argv)

    results = []
    for a in parse_grid(sweep_args.alphas):
        for b in parse_grid(sweep_args.betas):
            result = train_main(rest + ["--alpha", str(a), "--beta", str(b)])
            row = {"alpha": a, "beta": b,
                   "best_epoch": result.best_epoch + 1,
                   "best_acc": result.best_acc,
                   "best_mae": result.best_mae,
                   "best_f1": result.best_f1}
            results.append(row)
            if process_index() == 0:
                with open(sweep_args.out, "a") as f:
                    f.write(json.dumps(row) + "\n")
                print(json.dumps(row))
    best = max(results, key=lambda r: r["best_acc"])
    if process_index() == 0:
        print("BEST CELL:", json.dumps(best))
    return results


if __name__ == "__main__":
    main()
