"""BERT WordPiece tokenizer, dependency-free: the port's copy of
``lrce_tpu/data/tokenizer.py``, the same ids for the same text.

Behavior-compatible with `BertTokenizerFast.from_pretrained('bert-base-uncased')`
as used by the reference datasets (reference lrce/dataset/e2e_dataset.py:32,
165-174,222-295): basic tokenization (lowercase, accent strip, punctuation
split, CJK isolation) + greedy longest-match WordPiece, `[CLS] A [SEP]` /
`[CLS] A [SEP] B [SEP]` pair encoding, `padding='max_length'` semantics
(and like the reference call sites, NO truncation by default).

Loads a standard `vocab.txt`. A C++ fast path (lrce_tpu_torch/native)
implements the same algorithm for throughput (``use_native``); this module
is the reference implementation and fallback.
"""

from __future__ import annotations

import os
import unicodedata
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from lrce_tpu_torch import native

PAD, UNK, CLS, SEP, MASK = "[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"


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
    if (33 <= cp <= 47) or (58 <= cp <= 64) or (91 <= cp <= 96) or (123 <= cp <= 126):
        return True
    return unicodedata.category(ch).startswith("P")


def _is_cjk(cp: int) -> bool:
    return ((0x4E00 <= cp <= 0x9FFF) or (0x3400 <= cp <= 0x4DBF)
            or (0x20000 <= cp <= 0x2A6DF) or (0x2A700 <= cp <= 0x2B73F)
            or (0x2B740 <= cp <= 0x2B81F) or (0x2B820 <= cp <= 0x2CEAF)
            or (0xF900 <= cp <= 0xFAFF) or (0x2F800 <= cp <= 0x2FA1F))


class BertWordPieceTokenizer:
    """do_lower_case BERT tokenizer over a vocab.txt."""

    def __init__(self, vocab_path: str, do_lower_case: bool = True,
                 max_word_chars: int = 100, use_native: bool = True):
        self.vocab: Dict[str, int] = {}
        with open(vocab_path, "r", encoding="utf-8") as f:
            for i, line in enumerate(f):
                self.vocab[line.rstrip("\n")] = i
        self.inv_vocab = {v: k for k, v in self.vocab.items()}
        self.do_lower_case = do_lower_case
        self.max_word_chars = max_word_chars
        self.pad_id = self.vocab[PAD]
        self.unk_id = self.vocab[UNK]
        self.cls_id = self.vocab[CLS]
        self.sep_id = self.vocab[SEP]

        # C++ fast path (ASCII inputs); parity-tested vs this implementation.
        # None when use_native is off or the native library did not build.
        self._native = None
        if use_native and do_lower_case and native.native_available():
            self._native = native.NativeWordPiece(vocab_path)

    # -- basic tokenization --------------------------------------------------

    def _clean(self, text: str) -> str:
        out = []
        for ch in text:
            cp = ord(ch)
            if cp == 0 or cp == 0xFFFD or _is_control(ch):
                continue
            out.append(" " if _is_whitespace(ch) else ch)
        return "".join(out)

    def _split_cjk(self, text: str) -> str:
        out = []
        for ch in text:
            if _is_cjk(ord(ch)):
                out.append(f" {ch} ")
            else:
                out.append(ch)
        return "".join(out)

    @staticmethod
    def _strip_accents(text: str) -> str:
        return "".join(ch for ch in unicodedata.normalize("NFD", text)
                       if unicodedata.category(ch) != "Mn")

    @staticmethod
    def _split_punct(token: str) -> List[str]:
        out: List[List[str]] = []
        new_word = True
        for ch in token:
            if _is_punctuation(ch):
                out.append([ch])
                new_word = True
            else:
                if new_word:
                    out.append([])
                new_word = False
                out[-1].append(ch)
        return ["".join(w) for w in out]

    def basic_tokenize(self, text: str) -> List[str]:
        text = self._split_cjk(self._clean(text))
        tokens = text.strip().split() if text.strip() else []
        out: List[str] = []
        for tok in tokens:
            if self.do_lower_case:
                tok = self._strip_accents(tok.lower())
            out.extend(self._split_punct(tok))
        return [t for t in out if t]

    # -- wordpiece -----------------------------------------------------------

    def wordpiece(self, word: str) -> List[str]:
        if len(word) > self.max_word_chars:
            return [UNK]
        pieces: List[str] = []
        start = 0
        while start < len(word):
            end = len(word)
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
                return [UNK]
            pieces.append(cur)
            start = end
        return pieces

    def tokenize(self, text: str) -> List[str]:
        out: List[str] = []
        for word in self.basic_tokenize(text):
            out.extend(self.wordpiece(word))
        return out

    def convert_tokens_to_ids(self, tokens: Sequence[str]) -> List[int]:
        return [self.vocab.get(t, self.unk_id) for t in tokens]

    # -- encoding ------------------------------------------------------------

    def encode(self, text: str, text_pair: Optional[str] = None,
               max_length: Optional[int] = None,
               padding: str = "max_length",
               truncation: bool = False) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """-> (input_ids, attention_mask, token_type_ids) int64 arrays.

        Mirrors the reference tokenizer call: add_special_tokens=True,
        padding='max_length', NO truncation (e2e_dataset.py:165-174).
        """
        if self._native is not None and padding == "max_length":
            got = self._native.encode(text, text_pair, max_length, truncation)
            if got is not None:
                return got

        a = self.convert_tokens_to_ids(self.tokenize(text))
        ids = [self.cls_id] + a + [self.sep_id]
        types = [0] * len(ids)
        if text_pair is not None:
            b = self.convert_tokens_to_ids(self.tokenize(str(text_pair)))
            ids += b + [self.sep_id]
            types += [1] * (len(b) + 1)

        if truncation and max_length is not None and len(ids) > max_length:
            ids = ids[:max_length - 1] + [self.sep_id]
            types = types[:max_length]

        mask = [1] * len(ids)
        if padding == "max_length" and max_length is not None:
            pad_n = max_length - len(ids)
            if pad_n > 0:
                ids += [self.pad_id] * pad_n
                mask += [0] * pad_n
                types += [0] * pad_n
        return (np.asarray(ids, np.int64), np.asarray(mask, np.int64),
                np.asarray(types, np.int64))

    def decode(self, ids: Sequence[int]) -> str:
        toks = [self.inv_vocab.get(int(i), UNK) for i in ids]
        return " ".join(toks)


# the path in LRCE_TPU_BERT_VOCAB first (the JAX package's name, so one
# environment serves both), then the pretrained directory under the working
# directory; unlike lrce_tpu, not the user's HuggingFace cache
_VOCAB_SEARCH_PATHS = [
    "./pretrained_models/bert-base-uncased-vocab.txt",
    "./pretrained_models/vocab.txt",
]


def find_bert_vocab() -> Optional[str]:
    # env var read at call time (not import time) so late configuration wins
    for p in [os.environ.get("LRCE_TPU_BERT_VOCAB", "")] + _VOCAB_SEARCH_PATHS:
        if p and os.path.exists(p):
            return p
    return None


def load_default_tokenizer() -> BertWordPieceTokenizer:
    """bert-base-uncased tokenizer; requires vocab.txt to be present locally
    (the reference instead downloads it from the HuggingFace hub,
    e2e_dataset.py:32)."""
    path = find_bert_vocab()
    if path is None:
        raise FileNotFoundError(
            "bert-base-uncased vocab.txt not found. Set LRCE_TPU_BERT_VOCAB "
            "or place it at ./pretrained_models/bert-base-uncased-vocab.txt")
    return BertWordPieceTokenizer(path)
