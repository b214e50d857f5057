"""Word-level tokenizer.

A copy of ``twotowers_tpu/tokenizers/word.py``: PAD=0, UNK=1, optional
lowercasing, regex ``\\b\\w+\\b`` word extraction when punctuation stripping
is on (whitespace split otherwise), and a vocabulary sorted by falling
count with ties broken alphabetically, so every host builds the same one.
Batches of 64 ASCII texts or more, with punctuation stripping on, go through
the native core when a C++ compiler exists.
"""

from __future__ import annotations

import re
from collections import Counter
from typing import Any, Dict, List, Sequence

import numpy as np

from .base import TOKENIZER_REGISTRY, BaseTokenizer

_WORD_PATTERN = re.compile(r"\b\w+\b")


@TOKENIZER_REGISTRY.register("word")
class WordTokenizer(BaseTokenizer):
    PAD = 0
    UNK = 1

    def __init__(
        self,
        lowercase: bool = True,
        strip_punctuation: bool = True,
        max_len: int = 32,
        max_vocab_size: int | None = None,
        **_unused: Any,
    ):
        self.lowercase = lowercase
        self.strip_punctuation = strip_punctuation
        self.max_len = max_len
        self.max_vocab_size = max_vocab_size
        self.word_to_index: Dict[str, int] = {}
        self.index_to_word: Dict[int, str] = {}

    # ---- text processing -----------------------------------------------------

    def _tokenize(self, text: str) -> List[str]:
        if self.lowercase:
            text = text.lower()
        if self.strip_punctuation:
            return _WORD_PATTERN.findall(text)
        return text.split()

    # ---- vocab ---------------------------------------------------------------

    def fit(self, texts: Sequence[str]) -> "WordTokenizer":
        counts: Counter = Counter()
        for text in texts:
            counts.update(self._tokenize(text))
        # Deterministic: sort by (-count, word) so ties are stable across hosts.
        sorted_words = sorted(counts.items(), key=lambda kv: (-kv[1], kv[0]))
        if self.max_vocab_size is not None:
            sorted_words = sorted_words[: max(0, self.max_vocab_size - 2)]
        self.word_to_index = {"<PAD>": self.PAD, "<UNK>": self.UNK}
        for index, (word, _count) in enumerate(sorted_words, start=2):
            self.word_to_index[word] = index
        self.index_to_word = {idx: word for word, idx in self.word_to_index.items()}
        return self

    @property
    def is_fitted(self) -> bool:
        return len(self.word_to_index) > 2

    @property
    def vocab_size(self) -> int:
        return max(len(self.word_to_index), 2)

    # ---- encode / decode -----------------------------------------------------

    def encode(self, text: str) -> List[int]:
        get = self.word_to_index.get
        return [get(word, self.UNK) for word in self._tokenize(text)]

    def encode_batch(self, texts: Sequence[str], max_len: int) -> np.ndarray:
        # native route: ASCII corpora with punctuation stripping (the C
        # core's byte-level \w+ and ASCII lowercasing match exactly there)
        if (
            len(texts) >= 64
            and self.strip_punctuation
            and self.is_fitted
            and all(t.isascii() for t in texts)
        ):
            from ..native.tokenize import WordVocabTable, available, word_encode_batch

            if available():
                if getattr(self, "_native_table_size", None) != len(self.word_to_index):
                    self._native_table = WordVocabTable(self.word_to_index)
                    self._native_table_size = len(self.word_to_index)
                native = word_encode_batch(
                    texts, self._native_table, max_len,
                    unk_id=self.UNK, lowercase=self.lowercase,
                )
                if native is not None:
                    return native
        return super().encode_batch(texts, max_len)

    def decode(self, ids: Sequence[int]) -> str:
        return " ".join(
            self.index_to_word.get(int(i), "<UNK>") for i in ids if int(i) != self.PAD
        )

    # ---- serialisation -------------------------------------------------------

    def state_dict(self) -> Dict[str, Any]:
        return {
            "type": "word",
            "lowercase": self.lowercase,
            "strip_punctuation": self.strip_punctuation,
            "max_len": self.max_len,
            "max_vocab_size": self.max_vocab_size,
            "word_to_index": self.word_to_index,
        }

    @classmethod
    def from_state_dict(cls, state: Dict[str, Any]) -> "WordTokenizer":
        tok = cls(
            lowercase=state.get("lowercase", True),
            strip_punctuation=state.get("strip_punctuation", True),
            max_len=state.get("max_len", 32),
            max_vocab_size=state.get("max_vocab_size"),
        )
        tok.word_to_index = dict(state["word_to_index"])
        tok.index_to_word = {idx: word for word, idx in tok.word_to_index.items()}
        return tok
