"""CMU-MOSI / CMU-MOSEI preprocessing (offline, host-side): the port's own
copy of ``msa_tpu/data/preprocessing/cmu.py`` (numpy and pickle only).

Port of the reference pipeline (pre_processing.py:19-172): download via
CMU-MultimodalSDK, word-level alignment with averaged collapse, pause-token
removal, per-instance z-normalization, standard-fold split, pickle output in
the ``{"train": [((words, visual, speech), label, segment), ...], ...}``
format every downstream stage consumes.

Pure Python/numpy is the right tool here (run-once, IO-bound); the mmsdk
dependency is import-gated so the rest of the framework never needs it.

Deviation (SURVEY.md section 7 (i)): the z-norm epsilon defaults to 1e-6
instead of the reference's 0 (pre_processing.py:64), which divided by zero
for constant features; pass ``eps=0.0`` to reproduce the reference exactly.
"""

from __future__ import annotations

import os
import pickle
import re
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

DEFAULT_FIELDS = {
    "cmu_mosi": {
        "text": "CMU_MOSI_ModifiedTimestampedWords",
        "visual": "CMU_MOSI_Visual_Facet_41",
        "speech": "CMU_MOSI_COVAREP",
        "label": "CMU_MOSI_Opinion_Labels",
    },
    "cmu_mosei": {
        "text": "CMU_MOSEI_TimestampedWords",
        "visual": "CMU_MOSEI_VisualFacet42",
        "speech": "CMU_MOSEI_COVAREP",
        "label": "CMU_MOSEI_Labels",
    },
}


def _require_mmsdk():
    try:
        from mmsdk import mmdatasdk as md  # type: ignore
        return md
    except ImportError as e:  # pragma: no cover - environment dependent
        raise ImportError(
            "CMU preprocessing needs CMU-MultimodalSDK (mmsdk). Install it "
            "and re-run; the rest of msa_tpu_torch does not depend on it."
        ) from e


def avg_collapse(intervals: np.ndarray, features: np.ndarray) -> np.ndarray:
    """Word-span collapse function (ref pre_processing.py:13-17)."""
    try:
        return np.average(features, axis=0)
    except Exception:
        return features


def download_dataset(dataset_name: str, data_path: str):
    """Fetch highlevel/raw/label csds + return standard folds
    (ref pre_processing.py:19-55)."""
    md = _require_mmsdk()
    os.makedirs(data_path, exist_ok=True)
    DATASET = md.cmu_mosi if dataset_name == "cmu_mosi" else md.cmu_mosei
    for recipe in (DATASET.highlevel, DATASET.raw, DATASET.labels):
        try:
            md.mmdataset(recipe, data_path)
        except RuntimeError:
            pass  # already downloaded
    folds = DATASET.standard_folds
    return (folds.standard_train_fold, folds.standard_valid_fold,
            folds.standard_test_fold)


def znorm(x: np.ndarray, eps: float = 1e-6) -> np.ndarray:
    """Per-instance z-normalization (ref pre_processing.py:117-119)."""
    out = (x - x.mean(0, keepdims=True)) / (eps + np.std(x, axis=0, keepdims=True))
    return np.nan_to_num(out)


def prepare_segments(
    dataset,
    fields: Dict[str, str],
    train_split: Sequence[str],
    val_split: Sequence[str],
    test_split: Sequence[str],
    eps: float = 1e-6,
) -> Tuple[List, List, List]:
    """Segment loop: fold routing, pause stripping, z-norm
    (ref pre_processing.py:57-132)."""
    pattern = re.compile(r"(.*)\[.*\]")
    train, val, test = [], [], []
    num_drop = 0
    for segment in dataset[fields["label"]].keys():
        m = re.search(pattern, segment)
        if m is None:
            num_drop += 1
            continue
        vid = m.group(1)
        try:
            label = dataset[fields["label"]][segment]["features"]
            _words = dataset[fields["text"]][segment]["features"]
            _visual = dataset[fields["visual"]][segment]["features"]
            _speech = dataset[fields["speech"]][segment]["features"]
        except KeyError:
            num_drop += 1
            continue
        if not (_words.shape[0] == _visual.shape[0] == _speech.shape[0]):
            num_drop += 1
            continue
        label = np.nan_to_num(label)
        _visual = np.nan_to_num(_visual)
        _speech = np.nan_to_num(_speech)

        words, visual, speech = [], [], []
        for i, word in enumerate(_words):
            if word[0] != b"sp":  # strip speech pauses
                words.append(word[0].decode("utf-8"))
                visual.append(_visual[i, :])
                speech.append(_speech[i, :])
        if not words:
            num_drop += 1
            continue
        words = np.asarray(words)
        visual = znorm(np.asarray(visual), eps)
        speech = znorm(np.asarray(speech), eps)

        entry = ((words, visual, speech), label, segment)
        if vid in train_split:
            train.append(entry)
        elif vid in val_split:
            val.append(entry)
        elif vid in test_split:
            test.append(entry)
    print(f"Total number of {num_drop} datapoints have been dropped.")
    return train, val, test


def save_pickle(train, val, test, out_path: str):
    with open(out_path, "wb") as f:
        pickle.dump({"train": train, "val": val, "test": test}, f)
    print("Save Complete!")


def run(dataset_name: str, data_path: str, out_path: Optional[str] = None,
        fields: Optional[Dict[str, str]] = None, eps: float = 1e-6):
    """End-to-end: download, align by words (avg collapse), align by labels,
    split, pickle (ref pre_processing.py:141-172)."""
    md = _require_mmsdk()
    fields = fields or DEFAULT_FIELDS[dataset_name]
    tr, va, te = download_dataset(dataset_name, data_path)
    recipe = {fields[k]: os.path.join(data_path, fields[k]) + ".csd"
              for k in ("text", "visual", "speech")}
    dataset = md.mmdataset(recipe)
    dataset.align(fields["text"], collapse_functions=[avg_collapse])
    label_recipe = {fields["label"]: os.path.join(data_path, fields["label"] + ".csd")}
    dataset.add_computational_sequences(label_recipe, destination=None)
    dataset.align(fields["label"])
    train, val, test = prepare_segments(dataset, fields, tr, va, te, eps)
    save_pickle(train, val, test, out_path or f"{dataset_name}.pkl")
