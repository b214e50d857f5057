"""Seed-deterministic synthetic query/document pair generator.

A copy of ``twotowers_tpu/data/factory/synthetic.py``: templated topic
texts, positives seeded with the query's keyword, cross-topic negatives,
and the 70% variant / 30% new expansion. One ``random.Random(seed)``
threads through every draw in the same order, so a seed gives the JAX
package's rows; file writing is a separate step.
"""

from __future__ import annotations

import random
from pathlib import Path
from typing import List, Optional, Tuple

import pandas as pd

from ..triplets import pairs_to_triplets
from ...utils.logging import get_logger
from .readers import RAW_DATA_DIR

logger = get_logger("data.factory.synthetic")

TOPICS = {
    "machine learning": ["gradient descent", "overfitting", "regularisation",
                         "feature engineering", "cross validation"],
    "deep learning": ["backpropagation", "convolutional networks",
                      "attention mechanisms", "batch normalisation",
                      "transformers"],
    "information retrieval": ["dense retrieval", "inverted indexes",
                              "query expansion", "learning to rank",
                              "two tower models"],
    "hardware acceleration": ["tensor processing units", "systolic arrays",
                              "memory bandwidth", "matrix multiplication",
                              "mixed precision"],
    "natural language processing": ["tokenization", "word embeddings",
                                    "language models", "named entity recognition",
                                    "text classification"],
}

QUERY_TEMPLATES = [
    "what is {kw}",
    "how does {kw} work",
    "explain {kw} in simple terms",
    "why is {kw} important in {topic}",
    "best practices for {kw}",
    "introduction to {kw}",
    "{kw} tutorial for beginners",
    "common problems with {kw}",
]

SENTENCE_TEMPLATES = [
    "{kw} is a core technique in {topic} used by many practitioners.",
    "Researchers in {topic} rely on {kw} to improve model quality.",
    "A common approach to {topic} problems involves {kw} at scale.",
    "Understanding {kw} requires familiarity with the basics of {topic}.",
    "Modern systems combine {kw} with other methods from {topic}.",
    "In practice, {kw} can dramatically change results in {topic} work.",
    "The theory behind {kw} was developed alongside advances in {topic}.",
    "Engineers tune {kw} carefully when building {topic} pipelines.",
]

FILLER_WORDS = [
    "system", "method", "approach", "result", "analysis", "process",
    "performance", "design", "structure", "behaviour", "component",
    "strategy", "experiment", "baseline", "pipeline", "metric",
]


def random_sentence(rng: random.Random, topic: str, keyword: str) -> str:
    template = rng.choice(SENTENCE_TEMPLATES)
    return template.format(kw=keyword, topic=topic)


def generate_paragraph(rng: random.Random, topic: str, keyword: str,
                       n_sentences: int = 3) -> str:
    sentences = [random_sentence(rng, topic, keyword)]
    for _ in range(n_sentences - 1):
        other_kw = rng.choice(TOPICS[topic])
        sentences.append(random_sentence(rng, topic, other_kw))
        # sprinkle filler so documents are not pure template repeats
        filler = " ".join(rng.choice(FILLER_WORDS)
                          for _ in range(rng.randint(2, 5)))
        sentences[-1] += f" This relates to the {filler}."
    return " ".join(sentences)


def generate_query(rng: random.Random, topic: str, keyword: str) -> str:
    return rng.choice(QUERY_TEMPLATES).format(kw=keyword, topic=topic)


def generate_document(rng: random.Random, topic: Optional[str] = None,
                      keyword: Optional[str] = None) -> str:
    topic = topic or rng.choice(sorted(TOPICS))
    keyword = keyword or rng.choice(TOPICS[topic])
    return generate_paragraph(rng, topic, keyword,
                              n_sentences=rng.randint(2, 4))


def create_positive_pair(rng: random.Random) -> Tuple[str, str]:
    """Query + a document seeded with the same topic keyword."""
    topic = rng.choice(sorted(TOPICS))
    keyword = rng.choice(TOPICS[topic])
    return generate_query(rng, topic, keyword), generate_document(rng, topic, keyword)


def create_negative_pair(rng: random.Random, query: str,
                         avoid_topic: Optional[str] = None) -> Tuple[str, str]:
    """The same query with a document drawn from a *different* topic."""
    topics = [t for t in sorted(TOPICS) if t != avoid_topic] or sorted(TOPICS)
    topic = rng.choice(topics)
    return query, generate_document(rng, topic)


def generate_synthetic_pairs(num_pairs: int,
                             negatives_per_query: int = 1,
                             seed: Optional[int] = None) -> pd.DataFrame:
    """``num_pairs`` positives + ``num_pairs * negatives_per_query`` negatives."""
    rng = random.Random(seed)
    rows: List[dict] = []
    for _ in range(num_pairs):
        topic = rng.choice(sorted(TOPICS))
        keyword = rng.choice(TOPICS[topic])
        query = generate_query(rng, topic, keyword)
        rows.append({"query": query,
                     "document": generate_document(rng, topic, keyword),
                     "label": 1})
        for _ in range(negatives_per_query):
            _, neg_doc = create_negative_pair(rng, query, avoid_topic=topic)
            rows.append({"query": query, "document": neg_doc, "label": 0})
    return pd.DataFrame(rows, columns=["query", "document", "label"])


def expand_synthetic_dataset(df: pd.DataFrame, additional_pairs: int,
                             seed: Optional[int] = None) -> pd.DataFrame:
    """Grow a pairs frame: ~70% re-templated variants of existing positives,
    ~30% brand-new pairs, each followed by a cross-topic negative."""
    rng = random.Random(seed)
    positives = df[df["label"] == 1]
    rows: List[dict] = []
    for _ in range(additional_pairs):
        if len(positives) and rng.random() < 0.7:
            base = positives.iloc[rng.randrange(len(positives))]
            # variant: same document, newly templated query about a shared word
            words = [w for w in str(base["document"]).split() if len(w) > 6]
            keyword = rng.choice(words) if words else "retrieval"
            topic = rng.choice(sorted(TOPICS))
            rows.append({"query": generate_query(rng, topic, keyword),
                         "document": base["document"], "label": 1})
        else:
            query, doc = create_positive_pair(rng)
            rows.append({"query": query, "document": doc, "label": 1})
        # keep the pos/neg mix roughly balanced in the expansion too
        _, neg_doc = create_negative_pair(rng, rows[-1]["query"])
        rows.append({"query": rows[-1]["query"], "document": neg_doc,
                     "label": 0})
    return pd.concat([df, pd.DataFrame(rows)], ignore_index=True)


def write_pairs_tsv(df: pd.DataFrame, path=None) -> Path:
    """Write pairs as headered TSV (tabs/newlines in text sanitised)."""
    path = Path(path) if path else RAW_DATA_DIR / "pairs.tsv"
    path.parent.mkdir(parents=True, exist_ok=True)
    clean = df.copy()
    for col in ("query", "document"):
        clean[col] = clean[col].astype(str).str.replace(r"[\t\n]", " ", regex=True)
    clean.to_csv(path, sep="\t", index=False)
    logger.info("Wrote %d pairs -> %s", len(clean), path)
    return path


def write_triplets_parquet(df: pd.DataFrame, path) -> Path:
    """Convert pairs -> cartesian triplets and write training parquet."""
    q, p, n = pairs_to_triplets(
        df["query"].astype(str).tolist(),
        df["document"].astype(str).tolist(),
        df["label"].tolist(),
    )
    out = pd.DataFrame({"q_text": q, "d_pos_text": p, "d_neg_text": n})
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    out.to_parquet(path)
    logger.info("Wrote %d triplets -> %s", len(out), path)
    return path
