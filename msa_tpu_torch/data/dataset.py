"""Three-view multimodal dataset with seeded alignment-pair sampling.

Re-design of the reference ``MMBertDataset`` (ref MMBertDataset.py:101-202).
Per example i the reference emits three views:

  (a) text-only;
  (b) text (+) visual  -- 50% the aligned clip (ap label 1), 50% a random
      other index's clip (ap label 0); the LAST index is always self-paired
      (ref MMBertDataset.py:138-156).  NOTE the class docstring in the
      reference states the inverse label semantics; the code's labels
      (1 = aligned) are what training uses, and what we keep.
  (c) text (+) speech, likewise.

Text for every view is always example i's text; only the pair features swap.
Instead of python RNG per __getitem__, an epoch's pairings are drawn in one
vectorized pass with a seeded numpy Generator -- reproducible and resumable.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .featurize import FeaturizedSplit


@dataclass
class EpochPairing:
    """Pair indices and alignment labels for one epoch over one split."""

    visual_index: np.ndarray  # [N] int64: which example's visual features view (b) uses
    visual_ap: np.ndarray     # [N] int32: 1 = aligned, 0 = random pair
    speech_index: np.ndarray  # [N] int64
    speech_ap: np.ndarray     # [N] int32


def sample_pairing(n: int, rng: np.random.Generator, aligned_prob: float = 0.5,
                   force_aligned: bool = False) -> EpochPairing:
    """Draw one epoch of pair assignments.

    ``force_aligned=True`` gives deterministic aligned pairs (ap label 1) for
    evaluation (SURVEY.md section 7 deviation: the reference also randomizes
    pairs at eval, corrupting half the joint views' sentiment signal).
    """
    def draw():
        if force_aligned:
            return np.arange(n, dtype=np.int64), np.ones(n, dtype=np.int32)
        aligned = rng.uniform(size=n) < aligned_prob
        aligned[n - 1] = True  # edge case: last index always self-paired
        # Random partner != i for the unaligned ones.
        partner = rng.integers(0, n - 1, size=n)
        partner = partner + (partner >= np.arange(n))  # skip self
        index = np.where(aligned, np.arange(n), partner).astype(np.int64)
        return index, aligned.astype(np.int32)

    vi, va = draw()
    si, sa = draw()
    return EpochPairing(visual_index=vi, visual_ap=va, speech_index=si, speech_ap=sa)


class MultimodalDataset:
    """A featurized split plus seeded pairing state.

    ``epoch_batches`` yields fixed-shape numpy batch dicts; the final partial
    batch is zero-padded to the full batch size with a ``weight`` vector so
    the jitted train step never sees a new shape.
    """

    def __init__(self, split: FeaturizedSplit, aligned_prob: float = 0.5,
                 seed: int = 0):
        self.split = split
        self.aligned_prob = aligned_prob
        self.seed = seed

    def __len__(self) -> int:
        return len(self.split)

    def epoch_batches(self, epoch: int, batch_size: int, shuffle: bool = True,
                      force_aligned: bool = False, drop_last: bool = False):
        split = self.split
        n = len(split)
        rng = np.random.default_rng(np.random.SeedSequence([self.seed, epoch]))
        pairing = sample_pairing(n, rng, self.aligned_prob, force_aligned)
        order = rng.permutation(n) if shuffle else np.arange(n)

        num_batches = n // batch_size if drop_last else -(-n // batch_size)
        for b in range(num_batches):
            idx = order[b * batch_size : (b + 1) * batch_size]
            k = len(idx)
            pad = batch_size - k
            if pad:
                idx = np.concatenate([idx, np.zeros(pad, dtype=idx.dtype)])
            vi = pairing.visual_index[idx]
            si = pairing.speech_index[idx]
            weight = np.ones(batch_size, dtype=np.float32)
            if pad:
                weight[k:] = 0.0
            yield {
                "text_ids": split.input_ids[idx],
                "text_mask": split.attention_mask[idx],
                "visual": split.visual[vi],
                "visual_ap": pairing.visual_ap[idx],
                "speech": split.speech[si],
                "speech_ap": pairing.speech_ap[idx],
                "target": split.target[idx],
                "weight": weight,
            }

    def num_batches(self, batch_size: int, drop_last: bool = False) -> int:
        n = len(self.split)
        return n // batch_size if drop_last else -(-n // batch_size)


def prefetch(iterator, depth: int = 2):
    """Run the batch assembly in a background thread, ``depth`` ahead.

    The device step and the next batch's numpy slicing then overlap (the
    reference's DataLoader(num_workers=0) assembled batches inline on the
    hot path, trainer.py:28-31).
    """
    import queue
    import threading

    q: "queue.Queue" = queue.Queue(maxsize=depth)
    sentinel = object()
    err: list = []

    def worker():
        try:
            for item in iterator:
                q.put(item)
        except BaseException as e:  # propagate into the consumer
            err.append(e)
        finally:
            q.put(sentinel)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    while True:
        item = q.get()
        if item is sentinel:
            if err:
                raise err[0]
            return
        yield item
