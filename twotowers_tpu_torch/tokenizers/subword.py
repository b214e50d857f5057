"""Subword tokenizers: BPE and WordPiece.

A copy of ``twotowers_tpu/tokenizers/subword.py``:

* **bpe** -- byte-pair encoding over word-internal character pairs with an
  end-of-word marker. Training keeps incremental pair counts, so fitting is
  O(merges x affected words). Count ties go to the lexicographically
  smallest pair, so every host derives the same merge table and the ids
  equal the JAX package's.
* **wordpiece** -- greedy longest-match-first encoding over word-start
  pieces and ``##``-prefixed continuation pieces; the vocabulary comes from
  the same BPE merge procedure.

Both share the word tokenizer's pre-tokenization (lowercase + ``\\b\\w+\\b``)
and its contract: PAD=0, UNK=1, dense int32 batch output, JSON state.
"""

from __future__ import annotations

import re
from collections import Counter, defaultdict
from typing import Any, Dict, List, Optional, Sequence, Tuple

from .base import TOKENIZER_REGISTRY, BaseTokenizer

_WORD_PATTERN = re.compile(r"\b\w+\b")
END_OF_WORD = "</w>"
CONTINUATION = "##"


def _pretokenize(text: str, lowercase: bool) -> List[str]:
    if lowercase:
        text = text.lower()
    return _WORD_PATTERN.findall(text)


def learn_bpe_merges(
    word_counts: Counter, num_merges: int
) -> List[Tuple[str, str]]:
    """Learn an ordered BPE merge table from word frequencies.

    Incremental algorithm: pair counts and a pair -> {word ids} index are
    updated only for words touched by each merge. Ties on count break
    lexicographically for cross-host determinism.
    """
    words: List[List[str]] = []
    freqs: List[int] = []
    for word, count in sorted(word_counts.items()):
        words.append(list(word) + [END_OF_WORD])
        freqs.append(count)

    pair_counts: Counter = Counter()
    pair_words: Dict[Tuple[str, str], set] = defaultdict(set)
    for w_idx, symbols in enumerate(words):
        for pair in zip(symbols, symbols[1:]):
            pair_counts[pair] += freqs[w_idx]
            pair_words[pair].add(w_idx)

    merges: List[Tuple[str, str]] = []
    for _ in range(num_merges):
        if not pair_counts:
            break
        # most frequent pair; ties -> lexicographically smallest
        best = min(pair_counts.items(), key=lambda kv: (-kv[1], kv[0]))[0]
        if pair_counts[best] < 2:
            break  # nothing left worth merging
        merges.append(best)
        merged_symbol = best[0] + best[1]

        for w_idx in list(pair_words[best]):
            symbols = words[w_idx]
            freq = freqs[w_idx]
            # remove this word's old pair contributions
            for pair in zip(symbols, symbols[1:]):
                pair_counts[pair] -= freq
                if pair_counts[pair] <= 0:
                    del pair_counts[pair]
                pair_words[pair].discard(w_idx)
            # apply the merge within the word
            out: List[str] = []
            i = 0
            while i < len(symbols):
                if (
                    i + 1 < len(symbols)
                    and symbols[i] == best[0]
                    and symbols[i + 1] == best[1]
                ):
                    out.append(merged_symbol)
                    i += 2
                else:
                    out.append(symbols[i])
                    i += 1
            words[w_idx] = out
            # add the new pair contributions back
            for pair in zip(out, out[1:]):
                pair_counts[pair] += freq
                pair_words[pair].add(w_idx)
    return merges


def _apply_merges(
    word: str, merge_ranks: Dict[Tuple[str, str], int]
) -> List[str]:
    """Encode one word with a learned merge table (highest-priority first)."""
    symbols = list(word) + [END_OF_WORD]
    while len(symbols) > 1:
        ranked = [
            (merge_ranks[pair], i)
            for i, pair in enumerate(zip(symbols, symbols[1:]))
            if pair in merge_ranks
        ]
        if not ranked:
            break
        _, best_i = min(ranked)
        first, second = symbols[best_i], symbols[best_i + 1]
        out: List[str] = []
        i = 0
        while i < len(symbols):
            if (
                i + 1 < len(symbols)
                and symbols[i] == first
                and symbols[i + 1] == second
            ):
                out.append(first + second)
                i += 2
            else:
                out.append(symbols[i])
                i += 1
        symbols = out
    return symbols


@TOKENIZER_REGISTRY.register("bpe")
class BPETokenizer(BaseTokenizer):
    """Byte-pair-encoding tokenizer (word-internal merges, ``</w>`` marker)."""

    PAD = 0
    UNK = 1

    def __init__(
        self,
        num_merges: int = 2000,
        lowercase: bool = True,
        max_len: int = 48,
        max_vocab_size: Optional[int] = None,
        **_unused: Any,
    ):
        self.num_merges = num_merges
        self.lowercase = lowercase
        self.max_len = max_len
        self.max_vocab_size = max_vocab_size
        self.merges: List[Tuple[str, str]] = []
        self.token_to_id: Dict[str, int] = {}
        self.id_to_token: Dict[int, str] = {}
        self._merge_ranks: Dict[Tuple[str, str], int] = {}
        self._word_cache: Dict[str, List[int]] = {}

    def fit(self, texts: Sequence[str]) -> "BPETokenizer":
        word_counts: Counter = Counter()
        for text in texts:
            word_counts.update(_pretokenize(text, self.lowercase))
        num_merges = self.num_merges
        if self.max_vocab_size is not None:
            num_merges = min(num_merges, max(0, self.max_vocab_size - 2))
        self.merges = learn_bpe_merges(word_counts, num_merges)

        # vocabulary: every symbol reachable after the merges, deterministic
        self._merge_ranks = {p: i for i, p in enumerate(self.merges)}
        symbols = set()
        for word in word_counts:
            symbols.update(_apply_merges(word, self._merge_ranks))
        # base alphabet stays encodable even if merged away everywhere
        for word in word_counts:
            symbols.update(word)
        symbols.add(END_OF_WORD)
        self.token_to_id = {"<PAD>": self.PAD, "<UNK>": self.UNK}
        for index, token in enumerate(sorted(symbols), start=2):
            self.token_to_id[token] = index
        if self.max_vocab_size is not None:
            self.token_to_id = dict(
                list(self.token_to_id.items())[: self.max_vocab_size]
            )
        self.id_to_token = {i: t for t, i in self.token_to_id.items()}
        self._merge_ranks = {p: i for i, p in enumerate(self.merges)}
        self._word_cache = {}
        return self

    @property
    def is_fitted(self) -> bool:
        return len(self.token_to_id) > 2

    @property
    def vocab_size(self) -> int:
        return max(len(self.token_to_id), 2)

    def _encode_word(self, word: str) -> List[int]:
        cached = self._word_cache.get(word)
        if cached is None:
            get = self.token_to_id.get
            cached = [
                get(s, self.UNK) for s in _apply_merges(word, self._merge_ranks)
            ]
            if len(self._word_cache) < 100_000:
                self._word_cache[word] = cached
        return cached

    def encode(self, text: str) -> List[int]:
        ids: List[int] = []
        for word in _pretokenize(text, self.lowercase):
            ids.extend(self._encode_word(word))
        return ids

    def decode(self, ids: Sequence[int]) -> str:
        pieces = [
            self.id_to_token.get(int(i), "<UNK>")
            for i in ids
            if int(i) != self.PAD
        ]
        return "".join(pieces).replace(END_OF_WORD, " ").strip()

    def state_dict(self) -> Dict[str, Any]:
        return {
            "type": "bpe",
            "num_merges": self.num_merges,
            "lowercase": self.lowercase,
            "max_len": self.max_len,
            "max_vocab_size": self.max_vocab_size,
            "merges": [list(p) for p in self.merges],
            "token_to_id": self.token_to_id,
        }

    @classmethod
    def from_state_dict(cls, state: Dict[str, Any]) -> "BPETokenizer":
        tok = cls(
            num_merges=state.get("num_merges", 2000),
            lowercase=state.get("lowercase", True),
            max_len=state.get("max_len", 48),
            max_vocab_size=state.get("max_vocab_size"),
        )
        tok.merges = [tuple(p) for p in state["merges"]]
        tok.token_to_id = dict(state["token_to_id"])
        tok.id_to_token = {i: t for t, i in tok.token_to_id.items()}
        tok._merge_ranks = {p: i for i, p in enumerate(tok.merges)}
        return tok


@TOKENIZER_REGISTRY.register("wordpiece")
class WordPieceTokenizer(BaseTokenizer):
    """WordPiece tokenizer: greedy longest-match-first subword encoding."""

    PAD = 0
    UNK = 1

    def __init__(
        self,
        num_merges: int = 2000,
        lowercase: bool = True,
        max_len: int = 48,
        max_vocab_size: Optional[int] = None,
        max_word_chars: int = 64,
        **_unused: Any,
    ):
        self.num_merges = num_merges
        self.lowercase = lowercase
        self.max_len = max_len
        self.max_vocab_size = max_vocab_size
        self.max_word_chars = max_word_chars
        self.token_to_id: Dict[str, int] = {}
        self.id_to_token: Dict[int, str] = {}
        self._word_cache: Dict[str, List[int]] = {}

    def fit(self, texts: Sequence[str]) -> "WordPieceTokenizer":
        word_counts: Counter = Counter()
        for text in texts:
            word_counts.update(_pretokenize(text, self.lowercase))
        num_merges = self.num_merges
        if self.max_vocab_size is not None:
            num_merges = min(num_merges, max(0, self.max_vocab_size - 2))
        merges = learn_bpe_merges(word_counts, num_merges)
        ranks = {p: i for i, p in enumerate(merges)}

        # wordpiece vocab: word-start pieces plain, continuations ##-prefixed
        pieces = set()
        for word in word_counts:
            symbols = _apply_merges(word, ranks)
            for pos, symbol in enumerate(symbols):
                text_piece = symbol.replace(END_OF_WORD, "")
                if not text_piece:
                    continue
                pieces.add(
                    text_piece if pos == 0 else CONTINUATION + text_piece
                )
            # base alphabet for greedy fallback coverage
            for pos, ch in enumerate(word):
                pieces.add(ch if pos == 0 else CONTINUATION + ch)
        self.token_to_id = {"<PAD>": self.PAD, "<UNK>": self.UNK}
        for index, token in enumerate(sorted(pieces), start=2):
            self.token_to_id[token] = index
        if self.max_vocab_size is not None:
            self.token_to_id = dict(
                list(self.token_to_id.items())[: self.max_vocab_size]
            )
        self.id_to_token = {i: t for t, i in self.token_to_id.items()}
        self._word_cache = {}
        return self

    @property
    def is_fitted(self) -> bool:
        return len(self.token_to_id) > 2

    @property
    def vocab_size(self) -> int:
        return max(len(self.token_to_id), 2)

    def _encode_word(self, word: str) -> List[int]:
        cached = self._word_cache.get(word)
        if cached is not None:
            return cached
        if len(word) > self.max_word_chars:
            return [self.UNK]
        ids: List[int] = []
        start = 0
        while start < len(word):
            end = len(word)
            piece_id = None
            while end > start:
                piece = word[start:end]
                if start > 0:
                    piece = CONTINUATION + piece
                found = self.token_to_id.get(piece)
                if found is not None:
                    piece_id = found
                    break
                end -= 1
            if piece_id is None:
                ids = [self.UNK]  # BERT behaviour: unmatchable word -> [UNK]
                break
            ids.append(piece_id)
            start = end
        if len(self._word_cache) < 100_000:
            self._word_cache[word] = ids
        return ids

    def encode(self, text: str) -> List[int]:
        ids: List[int] = []
        for word in _pretokenize(text, self.lowercase):
            ids.extend(self._encode_word(word))
        return ids

    def decode(self, ids: Sequence[int]) -> str:
        out: List[str] = []
        for i in ids:
            token = self.id_to_token.get(int(i))
            if token is None or int(i) == self.PAD:
                continue
            if token.startswith(CONTINUATION):
                if out:
                    out[-1] += token[len(CONTINUATION):]
                else:
                    out.append(token[len(CONTINUATION):])
            else:
                out.append(token)
        return " ".join(out)

    def state_dict(self) -> Dict[str, Any]:
        return {
            "type": "wordpiece",
            "num_merges": self.num_merges,
            "lowercase": self.lowercase,
            "max_len": self.max_len,
            "max_vocab_size": self.max_vocab_size,
            "max_word_chars": self.max_word_chars,
            "token_to_id": self.token_to_id,
        }

    @classmethod
    def from_state_dict(cls, state: Dict[str, Any]) -> "WordPieceTokenizer":
        tok = cls(
            num_merges=state.get("num_merges", 2000),
            lowercase=state.get("lowercase", True),
            max_len=state.get("max_len", 48),
            max_vocab_size=state.get("max_vocab_size"),
            max_word_chars=state.get("max_word_chars", 64),
        )
        tok.token_to_id = dict(state["token_to_id"])
        tok.id_to_token = {i: t for t, i in tok.token_to_id.items()}
        return tok
