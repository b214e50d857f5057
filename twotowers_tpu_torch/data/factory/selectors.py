"""Positive selectors, negative samplers, and leakage filters.

A copy of ``twotowers_tpu/data/factory/selectors.py``. Every sampler takes
its own seeded ``random.Random``, so a seed gives the same triplets on
every host and in both packages.

MS MARCO v1.1 row shape: ``{query, answers, passages: {is_selected,
passage_text}}``.
"""

from __future__ import annotations

import random
from typing import Callable, Dict, Iterator, List, Optional, Sequence, Set

import pandas as pd

Context = Dict[str, object]
Sampler = Callable[[Context], Optional[str]]


# ---------------------------------------------------------------- filters

def answer_in_text(text: str, answers: Sequence[str]) -> bool:
    """Case-insensitive substring check: does the text leak any answer?"""
    lowered = text.lower()
    return any(str(answer).lower() in lowered for answer in answers)


def ngram_set(text: str, n: int = 3) -> Set[str]:
    words = text.lower().split()
    return {" ".join(words[i:i + n]) for i in range(len(words) - n + 1)}


def high_ngram_overlap(text_a: str, text_b: str, n: int = 3,
                       threshold: float = 0.8) -> bool:
    """3-gram Jaccard similarity >= threshold (near-duplicate detector)."""
    grams_a, grams_b = ngram_set(text_a, n), ngram_set(text_b, n)
    if not grams_a or not grams_b:
        return False
    jaccard = len(grams_a & grams_b) / len(grams_a | grams_b)
    return jaccard >= threshold


# ----------------------------------------------------------- positive side

def classic_positives(df: pd.DataFrame) -> Iterator[Context]:
    """Yield one context per ``is_selected == 1`` passage (multi-positive).

    The context keeps the row's answers and full passage set so intra-query
    samplers can draw same-query negatives without re-scanning the frame.
    """
    for _, row in df.iterrows():
        passages = row["passages"]
        selected = list(passages["is_selected"])
        texts = list(passages["passage_text"])
        # answers may be a list (in-memory) or a numpy array (parquet round-
        # trip); an array is not truth-testable, so check None explicitly
        raw_answers = row.get("answers")
        answers = [] if raw_answers is None else list(raw_answers)
        for is_sel, text in zip(selected, texts):
            if int(is_sel) == 1:
                yield {
                    "query": row["query"],
                    "positive": text,
                    "answers": answers,
                    "passages": {"is_selected": selected,
                                 "passage_text": texts},
                }


# ----------------------------------------------------------- negative side

def build_inter_query_pool(df: pd.DataFrame) -> List[str]:
    """Flat list of every passage text across all queries."""
    pool: List[str] = []
    for _, row in df.iterrows():
        pool.extend(list(row["passages"]["passage_text"]))
    return pool


def random_inter_query(pool: Sequence[str], seed: Optional[int] = None) -> Sampler:
    """Uniform draw from the global passage pool (cross-query negatives)."""
    rng = random.Random(seed)

    def sampler(_context: Context) -> Optional[str]:
        if not pool:
            return None
        return rng.choice(list(pool) if not isinstance(pool, list) else pool)

    return sampler


def intra_query_zero_filtered(seed: Optional[int] = None) -> Sampler:
    """Same-query ``is_selected == 0`` negatives, leakage-filtered.

    Candidates that contain any gold answer (``answer_in_text``) or are
    near-duplicates of the positive (``high_ngram_overlap``) are excluded;
    returns ``None`` when no candidate survives so ``build_triplets`` can drop the
    positive.
    """
    rng = random.Random(seed)

    def sampler(context: Context) -> Optional[str]:
        passages = context.get("passages") or {}
        selected = list(passages.get("is_selected", []))
        texts = list(passages.get("passage_text", []))
        answers = list(context.get("answers") or [])
        positive = str(context.get("positive", ""))
        candidates = [
            text for is_sel, text in zip(selected, texts)
            if int(is_sel) == 0
            and not answer_in_text(text, answers)
            and not high_ngram_overlap(text, positive)
        ]
        if not candidates:
            return None
        return rng.choice(candidates)

    return sampler
