"""The port's data layer against the JAX package's.

``TripletDataset`` reads TSV with the ``csv`` module where the JAX package
uses pandas; both must give the same texts, the same fitted vocabulary and
the same id arrays. Batching is a copy: the same batches, weights and
shuffles, compared exactly.
"""

import sys

import numpy as np
import pytest
import torch

from twotowers_tpu.data import batching as jax_batching
from twotowers_tpu.data.triplets import TripletDataset as JaxTripletDataset
from twotowers_tpu.data.triplets import pairs_to_triplets as jax_pairs_to_triplets
from twotowers_tpu.tokenizers import WordTokenizer as JaxWordTokenizer
from twotowers_tpu_torch.data import (
    TripletDataset, iterate_batches, num_batches, pairs_to_triplets, place_on_device,
    prefetch_to_device)
from twotowers_tpu_torch.tokenizers import WordTokenizer

_WORDS = ["alpha", "beta", "gamma", "delta", "eps", "zeta", "eta", "theta"]


def _text(rng):
    return " ".join(rng.choice(_WORDS, size=rng.integers(1, 9)))


def _write(path, header, rows):
    with open(path, "w") as f:
        if header:
            f.write("\t".join(header) + "\n")
        for row in rows:
            f.write("\t".join(str(v) for v in row) + "\n")
    return str(path)


@pytest.fixture
def tables(tmp_path, np_rng):
    triplets = [(_text(np_rng), _text(np_rng), _text(np_rng)) for _ in range(30)]
    queries = [_text(np_rng) for _ in range(6)]
    pairs = [(q, _text(np_rng), int(np_rng.integers(0, 2))) for q in queries for _ in range(4)]
    return {
        "q_text": _write(tmp_path / "a.tsv", ("q_text", "d_pos_text", "d_neg_text"), triplets),
        "query": _write(tmp_path / "b.tsv", ("query", "positive_doc", "negative_doc"),
                        triplets),
        "pairs": _write(tmp_path / "c.tsv", ("query", "document", "label"), pairs),
        "headerless": _write(tmp_path / "d.txt", None, pairs),
        "blank-lines": _write(tmp_path / "e.tsv", ("query", "positive_doc", "negative_doc"),
                              triplets[:3] + [("",) * 0] + triplets[3:5]),
    }


@pytest.mark.parametrize("kind", ["q_text", "query", "pairs", "headerless", "blank-lines"])
def test_tsv_dataset_matches_jax(tables, kind):
    got = TripletDataset(tables[kind], WordTokenizer(), max_length=6)
    want = JaxTripletDataset(tables[kind], JaxWordTokenizer(), max_length=6)
    assert len(got) == len(want) > 0
    assert (got.query_texts, got.positive_texts, got.negative_texts) == \
        (want.query_texts, want.positive_texts, want.negative_texts)
    assert got.tokenizer.word_to_index == want.tokenizer.word_to_index
    for a, b in zip(got.arrays(), want.arrays()):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == np.int32 and a.shape == (len(got), 6)


def test_parquet_matches_jax(tmp_path, tables):
    pd = pytest.importorskip("pandas")
    pytest.importorskip("pyarrow")
    path = str(tmp_path / "t.parquet")
    pd.read_csv(tables["query"], sep="\t").to_parquet(path)
    got = TripletDataset(path, WordTokenizer(), max_length=5)
    want = JaxTripletDataset(path, JaxWordTokenizer(), max_length=5)
    for a, b in zip(got.arrays(), want.arrays()):
        np.testing.assert_array_equal(a, b)


def test_parquet_without_pandas_says_why(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "pandas", None)  # import pandas now fails
    with pytest.raises(ImportError, match="needs pandas"):
        TripletDataset(str(tmp_path / "t.parquet"), WordTokenizer())


def test_unknown_schema_and_format_raise(tmp_path):
    with pytest.raises(ValueError, match="Unsupported file format"):
        TripletDataset(str(tmp_path / "t.csv"), WordTokenizer())
    path = _write(tmp_path / "x.tsv", ("a", "b", "c", "d"), [(1, 2, 3, 4)])
    with pytest.raises(ValueError, match="fields"):  # headerless pairs want 3 fields
        TripletDataset(path, WordTokenizer())


def test_pairs_to_triplets_matches_jax(np_rng):
    queries = [f"q{i}" for i in np_rng.integers(0, 4, size=20)]
    docs = [f"d{i}" for i in range(20)]
    labels = np_rng.integers(0, 2, size=20).tolist()
    assert pairs_to_triplets(queries, docs, labels) == jax_pairs_to_triplets(queries, docs, labels)


@pytest.mark.parametrize("shuffle,drop,multi_neg", [
    (False, False, False), (True, False, False), (True, True, False), (True, False, True)])
def test_batches_match_jax(np_rng, shuffle, drop, multi_neg):
    q = np_rng.integers(0, 50, size=(23, 7)).astype(np.int32)
    p = np_rng.integers(0, 50, size=(23, 7)).astype(np.int32)
    n = np_rng.integers(0, 50, size=(23, 3, 7) if multi_neg else (23, 7)).astype(np.int32)
    kwargs = dict(shuffle=shuffle, seed=4, drop_remainder=drop)
    got = list(iterate_batches((q, p, n), 8, **kwargs))
    want = list(jax_batching.iterate_batches((q, p, n), 8, **kwargs))
    assert len(got) == len(want) == num_batches(23, 8, drop_remainder=drop)
    for a, b in zip(got, want):
        for field in ("queries", "positives", "negatives", "weights"):
            np.testing.assert_array_equal(getattr(a, field), getattr(b, field))
        assert a.num_real == b.num_real
    if not drop:
        assert got[-1].num_real == 7 and not got[-1].queries[7:].any()
        assert got[-1].weights.tolist() == [1.0] * 7 + [0.0]


def test_prefetch_keeps_order_and_places_tensors(np_rng):
    q = np_rng.integers(0, 50, size=(20, 5)).astype(np.int32)
    batches = list(iterate_batches((q, q, None), 6))
    placed = list(prefetch_to_device(iter(batches), device="cpu"))
    assert len(placed) == len(batches)
    for host, dev in zip(batches, placed):
        assert isinstance(dev.queries, torch.Tensor) and dev.queries.dtype == torch.int32
        assert dev.negatives is None and dev.num_real == host.num_real
        np.testing.assert_array_equal(dev.queries.numpy(), host.queries)
        np.testing.assert_array_equal(dev.weights.numpy(), host.weights)
    one = place_on_device(batches[0], "cpu")
    assert one.weights.dtype == torch.float32
