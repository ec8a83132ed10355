"""ctypes binding for the native C++ WordPiece encoder.

``FastTokenizer`` is a drop-in for :class:`.wordpiece.Tokenizer` in the
featurizer: ``encode_words(words) -> (ids, inversions)`` runs the whole word
list through one C call (ASCII fast path); samples containing non-ASCII
words fall back to the pure-Python tokenizer, so output parity is by
construction.  The library is ``csrc/wordpiece.cpp``, built by ``_build``'s
host route on first use (into ``build/msa_tpu_torch/wordpiece-<hash>.so``);
where it cannot be built everything stays pure Python.
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Sequence, Tuple

import numpy as np

from .. import _build
from .wordpiece import Tokenizer

_I32P = ctypes.POINTER(ctypes.c_int32)
_SIGNATURES = {
    "wp_create": (ctypes.c_char_p,),
    "wp_free": (ctypes.c_void_p,),
    "wp_encode_words": (ctypes.c_void_p, ctypes.c_char_p, _I32P, _I32P,
                        ctypes.c_int32),
}
_RESTYPES = {"wp_create": ctypes.c_void_p, "wp_free": None,
             "wp_encode_words": ctypes.c_int32}


def _load_library() -> Optional[ctypes.CDLL]:
    try:
        return _build.load("wordpiece", _SIGNATURES, _RESTYPES)
    except (RuntimeError, OSError):  # no host compiler, or a failed build
        return None


class FastTokenizer:
    """Native-accelerated tokenizer with exact Python-tokenizer parity."""

    def __init__(self, vocab_path: str, do_lower_case: bool = True):
        self.python = Tokenizer.from_file(vocab_path, do_lower_case)
        self._lib = _load_library() if do_lower_case else None
        self._handle = None
        if self._lib is not None:
            handle = self._lib.wp_create(vocab_path.encode())
            if handle:
                self._handle = ctypes.c_void_p(handle)
            else:
                self._lib = None

    # --- Tokenizer protocol passthroughs -------------------------------
    def __getattr__(self, name):
        return getattr(self.python, name)

    @property
    def native_available(self) -> bool:
        return self._handle is not None

    def _encode_words_python(self, words: Sequence[str]) -> Tuple[np.ndarray, np.ndarray]:
        ids: List[int] = []
        inv: List[int] = []
        for i, w in enumerate(words):
            toks = self.python.tokenize(str(w))
            ids.extend(self.python.convert_tokens_to_ids(toks))
            inv.extend([i] * len(toks))
        return np.asarray(ids, np.int32), np.asarray(inv, np.int32)

    def encode_words(self, words: Sequence[str]) -> Tuple[np.ndarray, np.ndarray]:
        """All words of one sample -> (token_ids, word_inversions)."""
        if self._handle is None or not words:
            return self._encode_words_python(words)
        strs = [str(w) for w in words]
        # '\n' is the native protocol's word separator, and the C side does
        # not treat '\r' as a word split the way the Python tokenizer does:
        # either embedded in a word would shift every later inversion index
        # (mis-aligning the visual/speech frame gather).  Fall back.
        if any("\n" in w or "\r" in w for w in strs):
            return self._encode_words_python(words)
        try:
            text = "\n".join(strs).encode("ascii")
        except UnicodeEncodeError:
            return self._encode_words_python(words)
        max_out = max(len(text) * 2 + 16, 64)
        ids = np.empty(max_out, np.int32)
        inv = np.empty(max_out, np.int32)
        n = self._lib.wp_encode_words(
            self._handle, text,
            ids.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            inv.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            max_out)
        if n < 0:
            return self._encode_words_python(words)
        return ids[:n].copy(), inv[:n].copy()

    def __del__(self):
        lib, handle = getattr(self, "_lib", None), getattr(self, "_handle", None)
        if lib is not None and handle:
            lib.wp_free(handle)
