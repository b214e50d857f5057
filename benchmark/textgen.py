"""Inputs made from the seed: texts for the serving cells, Zipf id rows for
the training cell.

``random_texts`` is ``chip_smoke.py:synthetic_texts`` (lowercase letters
and spaces, lengths uniform in a range) made in bulk on the device: one
buffer of characters with a newline after each text, drawn by a
``torch.Generator`` in one call and split into Python strings once; the
space takes 6 of 32 equally likely symbols, about its share of English
text. ``zipf_ids`` is ``chip_smoke.py:zipf_ids`` (bench.py's word-vocab
inputs). Every draw comes from the seed and a stream number (documents,
queries, pairs, ...), so one seed gives the same inputs on a given device
and the streams of one seed are independent.
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np

SYMBOLS = np.frombuffer(b"abcdefghijklmnopqrstuvwxyz      ", np.uint8)  # 32
NEWLINE = ord("\n")

# the streams drawn from one seed
DOCS, QUERIES, PAIRS, FIRST_PAIRS, SAMPLE = range(5)


def rng_for(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng([int(seed), stream])


def torch_seed(seed: int, stream: int) -> int:
    return int(np.random.SeedSequence([int(seed), stream]).generate_state(1, np.uint64)[0]
               % (2 ** 63))


@dataclasses.dataclass
class Texts:
    """Texts back to back in ``data`` (uint8), text i at
    ``data[starts[i]:starts[i] + lengths[i]]``, each followed by a
    newline."""

    data: np.ndarray
    starts: np.ndarray
    lengths: np.ndarray

    def __len__(self) -> int:
        return len(self.starts)

    def strings(self) -> List[str]:
        """The texts as Python strings, in order."""
        return self.data.tobytes().decode("ascii").split("\n")[:-1]

    def head(self, n: int) -> "Texts":
        """The first ``n`` texts (a view)."""
        end = int(self.starts[n - 1] + self.lengths[n - 1] + 1) if n else 0
        return Texts(self.data[:end], self.starts[:n], self.lengths[:n])


def random_texts(n: int, lo: int, hi: int, seed: int, stream: int, device="cpu") -> Texts:
    """``n`` texts of ``lo``..``hi`` characters, each drawn from 32
    equally likely symbols (26 lowercase letters, 6 spaces) on ``device``.
    Two texts of 12 or more characters coincide with odds under 1e-14 a
    pair."""
    import torch

    lengths = rng_for(seed, stream).integers(lo, hi + 1, size=n, dtype=np.int64)
    ends = np.cumsum(lengths + 1)  # one past each text's newline
    gen = torch.Generator(device=device).manual_seed(torch_seed(seed, stream))
    codes = torch.randint(0, len(SYMBOLS), (int(ends[-1]) if n else 0,), generator=gen,
                          device=device, dtype=torch.uint8)
    letters = len(SYMBOLS) - 6  # codes 0-25 are letters, 26-31 the space
    data = torch.where(codes < letters, codes + ord("a"), ord(" ")).to(torch.uint8).cpu().numpy()
    data[ends - 1] = NEWLINE
    return Texts(data, ends - lengths - 1, lengths)


def zipf_ids(rng: np.random.Generator, vocab: int, n: int, exponent: float = 1.07) -> np.ndarray:
    """Ids drawn Zipf(``exponent``) over ranks 1..vocab-1; 0 is the pad."""
    ranks = np.arange(1, vocab)
    weights = 1.0 / np.power(ranks, exponent)
    return rng.choice(ranks, size=n, p=weights / weights.sum()).astype(np.int32)


def zipf_rows(rng: np.random.Generator, n: int, lo: int, hi: int, seq: int, vocab: int,
              exponent: float) -> np.ndarray:
    """(n, seq) int32 rows of ``lo``..``hi`` Zipf ids, padded with 0."""
    lengths = rng.integers(lo, hi + 1, size=n)
    rows = np.zeros((n, seq), np.int32)
    rows[np.arange(seq)[None, :] < lengths[:, None]] = zipf_ids(
        rng, vocab, int(lengths.sum()), exponent)
    return rows
