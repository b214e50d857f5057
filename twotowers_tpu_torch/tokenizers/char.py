"""Character-level tokenizer.

A copy of ``twotowers_tpu/tokenizers/char.py``: PAD=0, vocabulary is the
sorted set of unique characters mapped to ids starting at 1, unknown
characters encode to 0, ``vocab_size`` counts the padding id. Encoding is
vectorised through a numpy lookup table, and batches of 64 texts or more go
through the native core when a C++ compiler exists.
"""

from __future__ import annotations

from typing import Any, Dict, List, Sequence

import numpy as np

from .base import TOKENIZER_REGISTRY, BaseTokenizer


@TOKENIZER_REGISTRY.register("char")
class CharTokenizer(BaseTokenizer):
    PAD = 0

    def __init__(self, max_len: int = 64, **_unused: Any):
        # max_len is carried as the default batch length; extra config keys
        # (e.g. from YAML) are accepted and ignored for forward compatibility.
        self.max_len = max_len
        self.string_to_index: Dict[str, int] = {}
        self.index_to_string: Dict[int, str] = {}
        self._lut: np.ndarray | None = None  # codepoint -> id fast path

    # ---- vocab ---------------------------------------------------------------

    def fit(self, texts: Sequence[str]) -> "CharTokenizer":
        chars = sorted({char for text in texts for char in text})
        self.string_to_index = {char: idx + 1 for idx, char in enumerate(chars)}
        self.index_to_string = {idx: char for char, idx in self.string_to_index.items()}
        self._build_lut()
        return self

    def _build_lut(self) -> None:
        if not self.string_to_index:
            self._lut = None
            return
        max_cp = max(ord(c) for c in self.string_to_index)
        lut = np.zeros(max_cp + 1, dtype=np.int32)
        for char, idx in self.string_to_index.items():
            lut[ord(char)] = idx
        self._lut = lut

    @property
    def is_fitted(self) -> bool:
        return bool(self.string_to_index)

    @property
    def vocab_size(self) -> int:
        # +1 for the padding id, matching the reference
        return len(self.string_to_index) + 1

    # ---- encode / decode -----------------------------------------------------

    def encode(self, text: str) -> List[int]:
        if self._lut is not None:
            cps = np.frombuffer(text.encode("utf-32-le"), dtype=np.uint32)
            ids = np.where(cps < len(self._lut), self._lut[np.minimum(cps, len(self._lut) - 1)], 0)
            return ids.astype(np.int32).tolist()
        return [self.string_to_index.get(char, 0) for char in text]

    def encode_batch(self, texts: Sequence[str], max_len: int) -> np.ndarray:
        lut = self._lut
        if lut is None:
            return super().encode_batch(texts, max_len)
        if len(texts) >= 64:  # amortise the buffer packing
            from ..native.tokenize import char_encode_batch

            native = char_encode_batch(texts, lut, max_len)
            if native is not None:
                return native
        out = np.zeros((len(texts), max_len), dtype=np.int32)
        n = len(lut)
        for i, text in enumerate(texts):
            cps = np.frombuffer(text[:max_len].encode("utf-32-le"), dtype=np.uint32)
            ids = np.where(cps < n, lut[np.minimum(cps, n - 1)], 0)
            out[i, : len(ids)] = ids
        return out

    def decode(self, ids: Sequence[int]) -> str:
        return "".join(self.index_to_string.get(int(i), "?") for i in ids)

    # ---- serialisation -------------------------------------------------------

    def state_dict(self) -> Dict[str, Any]:
        return {
            "type": "char",
            "max_len": self.max_len,
            "string_to_index": self.string_to_index,
        }

    @classmethod
    def from_state_dict(cls, state: Dict[str, Any]) -> "CharTokenizer":
        tok = cls(max_len=state.get("max_len", 64))
        tok.string_to_index = dict(state["string_to_index"])
        tok.index_to_string = {idx: char for char, idx in tok.string_to_index.items()}
        tok._build_lut()
        return tok
