"""What the two serving drivers share: the corpus, the queries, the model,
and the check of answers against the plain reference.

The configuration file (``configs/<config>.json``) gives the model as the
program's config dict (``model``), the corpus (``corpus``: documents,
their lengths in characters, how many of the first documents fit the
tokenizer) and ``encode_batch_size``. The traffic file gives the queries'
lengths, the pool of distinct queries the window draws from in order, and
how many answered queries the check compares.
"""

from __future__ import annotations

import dataclasses
import gc
from typing import Any, Dict, List, Sequence, Tuple

import numpy as np

from . import textgen, weights
from .reference import mean_search, precision


@dataclasses.dataclass
class Serving:
    docs: textgen.Texts
    doc_strings: List[str]
    fit: textgen.Texts
    queries: textgen.Texts
    query_strings: List[str]
    tokenizer: Any
    spec: Any
    tree: Dict[str, Any]  # weights on the device, JAX layout

    def query(self, i: int) -> str:
        return self.query_strings[i % len(self.query_strings)]


def setup(run) -> Serving:
    from twotowers_tpu_torch.models.towers import spec_from_config
    from twotowers_tpu_torch.tokenizers.char import CharTokenizer

    cfg, traffic = run.cell.config, run.cell.traffic
    model, corpus = cfg["model"], cfg["corpus"]
    docs = textgen.random_texts(corpus["n_docs"], *corpus["doc_chars"], run.seed, textgen.DOCS,
                                run.device)
    queries = textgen.random_texts(traffic["query_pool"], *traffic["query_chars"], run.seed,
                                   textgen.QUERIES, run.device)
    run.mark("texts")
    fit = docs.head(min(corpus["fit_docs"], len(docs)))
    tokenizer = CharTokenizer(max_len=model["tokeniser"]["max_len"]).fit(fit.strings())
    spec = spec_from_config(model, tokenizer.vocab_size)
    tree = weights.make(weights.mean_leaves(tokenizer.vocab_size, spec.embedding.embedding_dim,
                                            spec.tower.hidden_dim, spec.tied_weights),
                        run.seed, run.device)
    out = Serving(docs, docs.strings(), fit, queries, queries.strings(), tokenizer, spec, tree)
    run.mark("strings, tokenizer fit, weights")
    return out


def max_len(run) -> int:
    return int(run.cell.config["model"]["tokeniser"]["max_len"])


def kept(run) -> np.ndarray:
    """Which of the pool's queries have their answers kept for the check:
    each with the traffic's ``check_keep`` odds, drawn from the seed. Only
    these answers outlive their request, so the window's host work is the
    program's and not the keeping of every answer."""
    rng = textgen.rng_for(run.seed, textgen.SAMPLE)
    return rng.random(int(run.cell.traffic["query_pool"])) < float(run.cell.traffic["check_keep"])


def sample(run, n_kept: int) -> np.ndarray:
    """Positions, among the ``n_kept`` kept answers of the window, that
    the check compares (``check_queries`` of them): drawn from the seed,
    sorted."""
    n = min(int(run.cell.traffic["check_queries"]), n_kept)
    rng = textgen.rng_for(run.seed + 1, textgen.SAMPLE)
    return np.sort(rng.choice(n_kept, size=n, replace=False))


def free_device_memory() -> None:
    import torch

    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def judge(run, s: Serving, query_idx: Sequence[int], got_ids: np.ndarray,
          got_scores: np.ndarray, renormalize: bool) -> Dict[str, float]:
    """``rank_gap`` and ``score_gap`` of the answers (``got_ids``,
    ``got_scores``: (S, k)) to the pool's queries ``query_idx``, against
    the reference in f32. ``renormalize``: the store's normalisation of
    the document and query vectors (clamp 1e-8) comes first."""
    import torch

    precision.exact_matmuls()
    tower_d = "query_tower" if s.spec.tied_weights else "document_tower"
    lut = mean_search.fit_vocab(s.fit.data).to(run.device)
    docs = mean_search.encode_texts(
        mean_search.DeviceTexts(s.docs, run.device),
        torch.arange(len(s.docs), device=run.device), lut, s.tree, tower_d, max_len(run),
        precision.caster("f32"))
    idx = torch.from_numpy(np.asarray(query_idx, np.int64) % len(s.queries)).to(run.device)
    queries = mean_search.encode_texts(mean_search.DeviceTexts(s.queries, run.device), idx,
                                       lut, s.tree, "query_tower", max_len(run),
                                       precision.caster("f32"))
    if renormalize:
        docs = mean_search.l2_normalize(docs, mean_search.STORE_EPS)
        queries = mean_search.l2_normalize(queries, mean_search.STORE_EPS)
    return mean_search.judge(queries, docs, torch.from_numpy(got_ids).to(run.device),
                             torch.from_numpy(got_scores).to(run.device))


def answers_to_arrays(answers: Sequence[List[Tuple[int, float]]], k: int
                      ) -> Tuple[np.ndarray, np.ndarray, int]:
    """(S, k) ids and scores of answers given as lists of (doc index or -1,
    score); the count of malformed answers (not k results, an index that
    is no document, or one index twice). Their missing places read doc 0
    at score 0."""
    ids = np.zeros((len(answers), k), np.int64)
    scores = np.zeros((len(answers), k), np.float32)
    bad = 0
    for row, answer in enumerate(answers):
        found = [i for i, _ in answer]
        if len(answer) != k or min(found, default=-1) < 0 or len(set(found)) != len(found):
            bad += 1
        for col, (i, score) in enumerate(answer[:k]):
            ids[row, col] = max(i, 0)
            scores[row, col] = score
    return ids, scores, bad
