"""UR_FUNNY preprocessing (offline, host-side): the port's own copy of
``msa_tpu/data/preprocessing/ur_funny.py``.

Port of ref parse_funny.py:16-87: loads the four UR_FUNNY SDK pickles
(openface / covarep / language / humor labels), keeps punchline features,
per-instance z-norm with eps=1e-6, emits the same
``((words, visual, acoustic), label, key)`` triple format and the
``cmu_ur_funny.pkl`` output.
"""

from __future__ import annotations

import os
import pickle
from typing import List, Tuple

import numpy as np

from .cmu import save_pickle, znorm


def _load(path: str):
    with open(path, "rb") as f:
        return pickle.load(f)


def parse_ur_funny(data_path: str, eps: float = 1e-6) -> Tuple[List, List, List]:
    folds = _load(os.path.join(data_path, "data_folds.pkl"))
    openface = _load(os.path.join(data_path, "openface_features_sdk.pkl"))
    covarep = _load(os.path.join(data_path, "covarep_features_sdk.pkl"))
    language = _load(os.path.join(data_path, "language_sdk.pkl"))
    humor = _load(os.path.join(data_path, "humor_label_sdk.pkl"))

    train, dev, test = [], [], []
    num_drop = 0
    for key in humor.keys():
        label = np.array(humor[key], dtype=int)
        words = np.array(language[key]["punchline_features"])
        acoustic = np.array(covarep[key]["punchline_features"])
        visual = np.array(openface[key]["punchline_features"])
        if not (words.shape[0] == acoustic.shape[0] == visual.shape[0]):
            num_drop += 1
            continue
        label = np.array([np.nan_to_num(label)])[:, np.newaxis]
        visual = znorm(np.nan_to_num(visual), eps)
        acoustic = znorm(np.nan_to_num(acoustic), eps)

        entry = ((words, visual, acoustic), label, key)
        if key in folds["train"]:
            train.append(entry)
        elif key in folds["dev"]:
            dev.append(entry)
        elif key in folds["test"]:
            test.append(entry)
    print(f"# of Train {len(train)}\n# of dev {len(dev)}\n# of test {len(test)}")
    print(f"Total number of {num_drop} datapoints have been dropped.")
    return train, dev, test


def run(data_path: str = "./sdk_features", out_path: str = "cmu_ur_funny.pkl",
        eps: float = 1e-6):
    train, dev, test = parse_ur_funny(data_path, eps)
    save_pickle(train, dev, test, out_path)
