"""Write ``tests/data/zstd_chunk/``: one zarr chunk of a large leaf, the
frame the port's zstd decoder is timed on and held to.

A bert-large leaf's chunk is one zstd frame of many 128 KiB blocks; the
orbax fixture's chunks are a few kB each, one block.  This script writes a
[512, 1024] bfloat16 array of N(0, 0.02) weights (1 MiB, as the bf16
moments and weights of a train state look) with tensorstore's zarr driver
and zstd at level 1 (orbax's compressor), and keeps the one chunk file it
writes: a frame of eight compressed blocks.  ``chunk.json`` holds its
decoded size and the SHA-256 of the decoded bytes.

This script uses tensorstore and ml_dtypes; the port does not.  Run it
from the repository root:

    python scripts/make_zstd_chunk.py [--out tests/data/zstd_chunk]
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import shutil
import tempfile

import ml_dtypes
import numpy as np
import tensorstore as ts

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEFAULT_OUT = os.path.join(REPO, "tests", "data", "zstd_chunk")
SHAPE = (512, 1024)
LEVEL = 1
SEED = 0


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=DEFAULT_OUT)
    out = ap.parse_args().out
    data = (np.random.default_rng(SEED).standard_normal(SHAPE) * 0.02
            ).astype(ml_dtypes.bfloat16)
    with tempfile.TemporaryDirectory() as tmp:
        store = ts.open({"driver": "zarr", "kvstore": f"file://{tmp}",
                         "metadata": {"compressor": {"id": "zstd",
                                                     "level": LEVEL},
                                      "dtype": "bfloat16",
                                      "chunks": list(SHAPE)}},
                        create=True, shape=SHAPE, dtype=ts.bfloat16).result()
        store.write(data).result()
        os.makedirs(out, exist_ok=True)
        shutil.copyfile(os.path.join(tmp, "0.0"),
                        os.path.join(out, "chunk.zst"))
    with open(os.path.join(out, "chunk.json"), "w") as f:
        json.dump({"shape": list(SHAPE), "dtype": "bfloat16",
                   "level": LEVEL, "seed": SEED,
                   "decoded_bytes": data.nbytes,
                   "sha256": hashlib.sha256(data.tobytes()).hexdigest()},
                  f, indent=1)
        f.write("\n")


if __name__ == "__main__":
    main()
