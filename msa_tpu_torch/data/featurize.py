"""Featurization: raw (words, visual, speech) triples -> fixed-shape arrays.

TPU-native re-design of the reference featurizer (ref train.py:101-196,
duplicated in sampling.py:46-173).  Key behaviours preserved:

  * per-word WordPiece tokenization with an inversion list so visual/speech
    frames are replicated per sub-token (ref train.py:159-176);
  * truncation to ``max_seq_length - 2`` (ref train.py:179-182);
  * ``[CLS] tokens [SEP]`` framing; the visual/speech streams get a zero SEP
    row and are zero-padded to exactly ``max_seq_length`` rows with NO row for
    [CLS] -- frames therefore sit one position earlier than their text token,
    exactly as in ref train.py:113-127;
  * pad token id 0, mask 1 on real tokens.

Unlike the reference (python lists per example, re-padded per batch by a
torch collate), the whole split is materialized once into dense numpy arrays
so every training batch is a zero-copy slice with a static shape -- XLA never
recompiles.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence

import numpy as np

from ..configs import EMOTIONS


@dataclass
class FeaturizedSplit:
    """One dataset split as fixed-shape arrays."""

    input_ids: np.ndarray      # [N, L] int32
    attention_mask: np.ndarray  # [N, L] int32 (1 = real token)
    visual: np.ndarray          # [N, L, Dv] float32
    speech: np.ndarray          # [N, L, Ds] float32
    target: np.ndarray          # [N] float32 (regression) or int32 (classification)
    segments: List
    words: List

    def __len__(self) -> int:
        return int(self.input_ids.shape[0])

    @property
    def max_seq_length(self) -> int:
        return int(self.input_ids.shape[1])


def select_target(raw_label, dataset: str, task: str, num_labels: int):
    """Label transform (ref MMBertDataset.py:63-98 ``sentiment_selection``).

    ``raw_label`` is ``items[i][1][0]``: a length-1 array for MOSI, a 7-dim
    emotion vector for MOSEI, ``[int]`` for UR_FUNNY.
    """
    mode = str(num_labels)
    raw = np.asarray(raw_label).reshape(-1)
    if dataset == "mosei":
        if task == "sentiment":
            if mode == "2":
                return 1 if raw[0] >= 0 else 0
            if mode == "7":
                return float(raw[0])
            if mode == "1":
                return float(raw[0]) / 3.0
        else:
            if mode == "2":
                return 1 if raw[EMOTIONS.index(task)] != 0 else 0
            if mode == "6":
                return int(np.argmax(raw[1:]))
    elif dataset == "mosi":
        if mode == "2":
            return 1 if raw[0] >= 0 else 0
        if mode == "7":
            return float(raw[0])
        if mode == "1":
            return float(raw[0]) / 3.0
    elif dataset == "ur_funny":
        if mode == "2":
            return 1 if raw[0] == 1 else 0
    raise ValueError(f"unsupported (dataset={dataset}, task={task}, num_labels={num_labels})")


def featurize(
    samples: Sequence,
    tokenizer,
    max_seq_length: int,
    visual_dim: int,
    speech_dim: int,
    dataset: str = "mosi",
    task: str = "sentiment",
    num_labels: int = 1,
    pair_seq_length: int | None = None,
) -> FeaturizedSplit:
    """Convert raw pickle samples into a :class:`FeaturizedSplit`.

    ``samples`` entries are ``((words, visual, speech), label, segment)``
    as produced by preprocessing (ref pre_processing.py:121-126).

    ``pair_seq_length=None`` (default) reproduces the reference layout:
    frames are word-aligned and replicated per sub-token (inversion list,
    ref train.py:159-176), so the pair streams share the text length L.
    Setting it enables FRAME-LEVEL mode (beyond the reference, which can
    only consume mmsdk-collapsed word-aligned features): the raw frame
    streams are kept at their native rate, zero-padded/truncated to exactly
    ``pair_seq_length`` rows, and the joint pass runs over L + Lp tokens --
    the long-stream extension the blockwise flash kernel exists for
    (SURVEY.md section 5.7).
    """
    n = len(samples)
    L = max_seq_length
    Lp = pair_seq_length if pair_seq_length is not None else L
    ids = np.zeros((n, L), dtype=np.int32)
    mask = np.zeros((n, L), dtype=np.int32)
    vis = np.zeros((n, Lp, visual_dim), dtype=np.float32)
    spc = np.zeros((n, Lp, speech_dim), dtype=np.float32)
    targets = np.zeros((n,), dtype=np.float64)
    segments: List = []
    words_out: List = []

    cls_id = tokenizer.cls_token_id
    sep_id = tokenizer.sep_token_id

    for idx, sample in enumerate(samples):
        (words, visual, speech), label, segment = sample[0], sample[1], sample[2]
        visual = np.asarray(visual, dtype=np.float32)
        speech = np.asarray(speech, dtype=np.float32)

        if hasattr(tokenizer, "encode_words"):
            # native/batched fast path (.fast_wordpiece)
            token_ids_all, inv = tokenizer.encode_words(list(words))
            inv = inv.astype(np.int64)
        else:
            tokens: List[str] = []
            inversions: List[int] = []
            for i, word in enumerate(list(words)):
                pieces = tokenizer.tokenize(str(word))
                tokens.extend(pieces)
                inversions.extend([i] * len(pieces))
            assert len(tokens) == len(inversions)
            token_ids_all = np.asarray(
                tokenizer.convert_tokens_to_ids(tokens), np.int32)
            inv = np.asarray(inversions, dtype=np.int64)

        if pair_seq_length is None:
            new_visual = visual[inv] if len(inv) else np.zeros((0, visual_dim), np.float32)
            new_speech = speech[inv] if len(inv) else np.zeros((0, speech_dim), np.float32)
        else:
            # frame-level: native rate, no inversion replication
            new_visual = visual.reshape(-1, visual_dim)[:Lp]
            new_speech = speech.reshape(-1, speech_dim)[:Lp]

        if len(token_ids_all) > L - 2:
            token_ids_all = token_ids_all[: L - 2]
            if pair_seq_length is None:
                new_visual = new_visual[: L - 2]
                new_speech = new_speech[: L - 2]

        t = len(token_ids_all)
        token_ids = token_ids_all
        ids[idx, 0] = cls_id
        ids[idx, 1 : t + 1] = token_ids
        ids[idx, t + 1] = sep_id
        mask[idx, : t + 2] = 1
        # Word-aligned mode: frames occupy rows [0, t); row t is the zero SEP
        # frame; the rest is zero padding (ref train.py:115-127 layout).
        # Frame-level mode: rows [0, n_frames) up to Lp.
        vis[idx, : len(new_visual)] = new_visual
        spc[idx, : len(new_speech)] = new_speech

        targets[idx] = select_target(label[0], dataset, task, num_labels)
        segments.append(segment)
        words_out.append(words)

    classification = not (str(num_labels) in ("1", "7"))
    target = targets.astype(np.int32) if classification else targets.astype(np.float32)
    return FeaturizedSplit(
        input_ids=ids,
        attention_mask=mask,
        visual=vis,
        speech=spc,
        target=target,
        segments=segments,
        words=words_out,
    )


def synthetic_split(
    n: int,
    max_seq_length: int,
    visual_dim: int,
    speech_dim: int,
    vocab_size: int = 30522,
    num_labels: int = 1,
    seed: int = 0,
    pair_seq_length: int | None = None,
) -> FeaturizedSplit:
    """Random split with the real data layout; used by benchmarks and tests.

    ``pair_seq_length`` mirrors :func:`featurize`'s frame-level mode: the
    visual/speech streams get their own (typically longer) length Lp.
    """
    rng = np.random.default_rng(seed)
    L = max_seq_length
    Lp = pair_seq_length if pair_seq_length is not None else L
    lengths = rng.integers(5, L - 2, size=n, endpoint=True)
    frame_counts = (lengths if pair_seq_length is None
                    else rng.integers(Lp // 2, Lp, size=n, endpoint=True))
    ids = np.zeros((n, L), dtype=np.int32)
    mask = np.zeros((n, L), dtype=np.int32)
    vis = np.zeros((n, Lp, visual_dim), dtype=np.float32)
    spc = np.zeros((n, Lp, speech_dim), dtype=np.float32)
    low = min(999, max(vocab_size // 4, 5))
    for i, (t, f) in enumerate(zip(lengths, frame_counts)):
        t, f = int(t), int(f)
        ids[i, 0] = 101 if vocab_size > 103 else 2
        ids[i, 1 : t + 1] = rng.integers(low, vocab_size, size=t)
        ids[i, t + 1] = 102 if vocab_size > 103 else 3
        mask[i, : t + 2] = 1
        vis[i, :f] = rng.standard_normal((f, visual_dim), dtype=np.float32)
        spc[i, :f] = rng.standard_normal((f, speech_dim), dtype=np.float32)
    if str(num_labels) in ("1", "7"):
        target = rng.uniform(-3, 3, size=n).astype(np.float32)
        if num_labels == 1:
            target = (target / 3.0).astype(np.float32)
    else:
        target = rng.integers(0, num_labels, size=n).astype(np.int32)
    return FeaturizedSplit(
        input_ids=ids, attention_mask=mask, visual=vis, speech=spc,
        target=target, segments=list(range(n)), words=[[] for _ in range(n)],
    )
