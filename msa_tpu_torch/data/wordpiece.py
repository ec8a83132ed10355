"""Host-side WordPiece tokenizer (vocab-file driven, no torch/transformers).

TPU-native replacement for the reference's delegated HF ``BertTokenizer``
(ref train.py:198-210).  Implements the BERT "uncased" pipeline: unicode
cleanup, lowercasing + accent stripping, CJK spacing, punctuation splitting,
then greedy longest-match WordPiece.  Behaviour is golden-tested against
``transformers.BertTokenizer`` in tests/test_wordpiece.py.
"""

from __future__ import annotations

import unicodedata
from typing import Dict, Iterable, List, Optional

PAD_TOKEN = "[PAD]"
UNK_TOKEN = "[UNK]"
CLS_TOKEN = "[CLS]"
SEP_TOKEN = "[SEP]"
MASK_TOKEN = "[MASK]"

SPECIAL_TOKENS = (PAD_TOKEN, UNK_TOKEN, CLS_TOKEN, SEP_TOKEN, MASK_TOKEN)


def load_vocab(path: str) -> Dict[str, int]:
    vocab: Dict[str, int] = {}
    with open(path, encoding="utf-8") as f:
        for i, line in enumerate(f):
            token = line.rstrip("\n")
            if token:
                vocab[token] = i
    return vocab


def _is_whitespace(ch: str) -> bool:
    if ch in (" ", "\t", "\n", "\r"):
        return True
    return unicodedata.category(ch) == "Zs"


def _is_control(ch: str) -> bool:
    if ch in ("\t", "\n", "\r"):
        return False
    return unicodedata.category(ch).startswith("C")


def _is_punctuation(ch: str) -> bool:
    cp = ord(ch)
    # ASCII blocks treated as punctuation by BERT even when unicode disagrees.
    if (33 <= cp <= 47) or (58 <= cp <= 64) or (91 <= cp <= 96) or (123 <= cp <= 126):
        return True
    return unicodedata.category(ch).startswith("P")


def _is_cjk(cp: int) -> bool:
    return (
        (0x4E00 <= cp <= 0x9FFF)
        or (0x3400 <= cp <= 0x4DBF)
        or (0x20000 <= cp <= 0x2A6DF)
        or (0x2A700 <= cp <= 0x2B73F)
        or (0x2B740 <= cp <= 0x2B81F)
        or (0x2B820 <= cp <= 0x2CEAF)
        or (0xF900 <= cp <= 0xFAFF)
        or (0x2F800 <= cp <= 0x2FA1F)
    )


class BasicTokenizer:
    """BERT basic tokenizer: cleanup, lowercase, accents, punctuation split."""

    def __init__(self, do_lower_case: bool = True):
        self.do_lower_case = do_lower_case

    def tokenize(self, text: str) -> List[str]:
        text = self._clean(text)
        text = self._pad_cjk(text)
        tokens: List[str] = []
        for tok in text.split():
            if self.do_lower_case:
                tok = tok.lower()
                tok = self._strip_accents(tok)
            tokens.extend(self._split_punct(tok))
        return tokens

    @staticmethod
    def _clean(text: str) -> str:
        out = []
        for ch in text:
            cp = ord(ch)
            if cp == 0 or cp == 0xFFFD or _is_control(ch):
                continue
            out.append(" " if _is_whitespace(ch) else ch)
        return "".join(out)

    @staticmethod
    def _pad_cjk(text: str) -> str:
        out = []
        for ch in text:
            if _is_cjk(ord(ch)):
                out.append(f" {ch} ")
            else:
                out.append(ch)
        return "".join(out)

    @staticmethod
    def _strip_accents(text: str) -> str:
        text = unicodedata.normalize("NFD", text)
        return "".join(ch for ch in text if unicodedata.category(ch) != "Mn")

    @staticmethod
    def _split_punct(token: str) -> List[str]:
        if not token:
            return []
        parts: List[List[str]] = []
        start_new = True
        for ch in token:
            if _is_punctuation(ch):
                parts.append([ch])
                start_new = True
            else:
                if start_new:
                    parts.append([])
                    start_new = False
                parts[-1].append(ch)
        return ["".join(p) for p in parts]


class WordPieceTokenizer:
    """Greedy longest-match-first subword tokenizer."""

    def __init__(self, vocab: Dict[str, int], unk_token: str = UNK_TOKEN,
                 max_input_chars_per_word: int = 100):
        self.vocab = vocab
        self.unk_token = unk_token
        self.max_input_chars_per_word = max_input_chars_per_word

    def tokenize(self, word: str) -> List[str]:
        if len(word) > self.max_input_chars_per_word:
            return [self.unk_token]
        tokens: List[str] = []
        start = 0
        n = len(word)
        while start < n:
            end = n
            cur = None
            while start < end:
                sub = word[start:end]
                if start > 0:
                    sub = "##" + sub
                if sub in self.vocab:
                    cur = sub
                    break
                end -= 1
            if cur is None:
                return [self.unk_token]
            tokens.append(cur)
            start = end
        return tokens


class Tokenizer:
    """Full BERT-uncased tokenizer over a vocab file.

    API mirrors the subset of HF ``BertTokenizer`` the reference uses:
    ``tokenize``, ``convert_tokens_to_ids``, special-token attributes
    (ref train.py:111-120, model_utils.py:18-32).
    """

    def __init__(self, vocab: Dict[str, int], do_lower_case: bool = True):
        self.vocab = vocab
        self.inv_vocab = {v: k for k, v in vocab.items()}
        self.basic = BasicTokenizer(do_lower_case)
        self.wordpiece = WordPieceTokenizer(vocab)
        for name, tok in (
            ("pad", PAD_TOKEN), ("unk", UNK_TOKEN), ("cls", CLS_TOKEN),
            ("sep", SEP_TOKEN), ("mask", MASK_TOKEN),
        ):
            if tok not in vocab:
                raise ValueError(f"vocab is missing required special token {tok}")
            setattr(self, f"{name}_token", tok)
            setattr(self, f"{name}_token_id", vocab[tok])

    @classmethod
    def from_file(cls, path: str, do_lower_case: bool = True) -> "Tokenizer":
        return cls(load_vocab(path), do_lower_case)

    @property
    def vocab_size(self) -> int:
        return len(self.vocab)

    def tokenize(self, text: str) -> List[str]:
        out: List[str] = []
        for word in self.basic.tokenize(text):
            out.extend(self.wordpiece.tokenize(word))
        return out

    def convert_tokens_to_ids(self, tokens: Iterable[str]) -> List[int]:
        unk = self.vocab[self.unk_token]
        return [self.vocab.get(t, unk) for t in tokens]

    def convert_ids_to_tokens(self, ids: Iterable[int]) -> List[str]:
        return [self.inv_vocab.get(int(i), self.unk_token) for i in ids]

    def encode(self, text: str) -> List[int]:
        return self.convert_tokens_to_ids(self.tokenize(text))

    def special_token_ids(self) -> List[int]:
        return [getattr(self, f"{n}_token_id") for n in ("pad", "unk", "cls", "sep", "mask")]


def make_test_vocab(extra_words: Optional[List[str]] = None) -> Dict[str, int]:
    """Tiny deterministic vocab for tests and synthetic benchmarks."""
    tokens = list(SPECIAL_TOKENS)
    tokens += [chr(c) for c in range(ord("a"), ord("z") + 1)]
    tokens += ["##" + chr(c) for c in range(ord("a"), ord("z") + 1)]
    tokens += ["the", "and", "movie", "was", "great", "bad", "##ly", "##ing",
               "act", "plot", "really", "not", "good", "film", ".", ",", "!", "?"]
    if extra_words:
        tokens += [w for w in extra_words if w not in tokens]
    return {t: i for i, t in enumerate(dict.fromkeys(tokens))}
