"""The port's mean-vector search, GloVe search and retrieval CLI against the
JAX package.

* ``MeanVectorSearch`` with an explicit vectors dict: encodings within
  atol 1e-6 (the same numpy arithmetic), the same ranked documents and
  scores within 1e-5 (f32 dot products summed in another order).
* Its index files load in either package.
* ``GloVeSearch`` offline: gensim is absent, so every word gets a seeded
  pseudo-vector, 50 wide. The JAX package seeds those from the salted
  ``hash()``, so its vectors cannot be compared; the same vectors dict goes
  to JAX's ``MeanVectorSearch`` instead.
* The CLI (``build-index``, ``search``, ``--device cpu``) on a checkpoint of
  ``configs/word2vec_skipgram.yml`` at its full widths (a frozen 300-wide
  table, the tied 256-wide ``mean`` tower), random weights from a JAX seed:
  the ranked documents of JAX's ``TwoTowerSearch`` on the same weights,
  scores within 1e-5.
"""

import json
import re
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from twotowers_tpu.index.glove import GloVeSearch as JaxGloVeSearch
from twotowers_tpu.index.glove import MeanVectorSearch as JaxMeanVectorSearch
from twotowers_tpu.index.two_tower import TwoTowerSearch as JaxSearch
from twotowers_tpu.models import init_two_tower
from twotowers_tpu.models.towers import spec_from_config as jax_spec_from_config
from twotowers_tpu.tokenizers import build_tokenizer as jax_build_tokenizer
from twotowers_tpu_torch.index import BaseSearch, GloVeSearch, MeanVectorSearch, TwoTowerSearch
from twotowers_tpu_torch.index import cli
from twotowers_tpu_torch.train.checkpoint import save_params
from twotowers_tpu_torch.utils import load_config

ROOT = Path(__file__).resolve().parents[1]
ATOL = 1e-5
WORDS = [f"word{i}" for i in range(60)]


def _texts(n, seed=0, vocab=WORDS):
    rng = np.random.default_rng(seed)
    return [" ".join(rng.choice(vocab, size=rng.integers(3, 9))) for _ in range(n)]


DOCS = list(dict.fromkeys(_texts(150)))
QUERIES = [DOCS[4], DOCS[77], "word3 word5 unknownword", "nothing known here", "Word7, WORD8!"]


@pytest.fixture(scope="module")
def vectors():
    rng = np.random.default_rng(1)
    return {w: rng.normal(size=12).astype(np.float32) for w in WORDS}


def _same_results(got, want):
    assert [d for d, _ in got] == [d for d, _ in want]
    np.testing.assert_allclose([s for _, s in got], [s for _, s in want], atol=ATOL)


def test_mean_vector_search_matches_jax(vectors):
    search = MeanVectorSearch(vectors, device="cpu")
    jax_search = JaxMeanVectorSearch(vectors)
    assert isinstance(search, BaseSearch) and search.dim == jax_search.dim == 12
    np.testing.assert_allclose(search.encode(DOCS + QUERIES), jax_search.encode(DOCS + QUERIES),
                               rtol=0, atol=1e-6)
    search.index_documents(DOCS)
    jax_search.index_documents(DOCS)
    assert search.num_documents == jax_search.num_documents == len(DOCS)
    assert search._doc_matrix.shape == (len(DOCS), 12)  # no padding rows
    for query in QUERIES:
        for k in (1, 5, len(DOCS) + 10):
            _same_results(search.search(query, top_k=k), jax_search.search(query, top_k=k))
    assert search.search(DOCS[4], top_k=1)[0][0] == DOCS[4]


def test_mean_vector_search_defaults(vectors):
    assert MeanVectorSearch({}, device="cpu").dim == JaxMeanVectorSearch({}).dim == 50
    assert MeanVectorSearch(vectors, dim=7, device="cpu").dim == 7
    empty = MeanVectorSearch(vectors, device="cpu")
    with pytest.raises(RuntimeError, match="No index built"):
        empty.search("word1")
    with pytest.raises(RuntimeError, match="No index to save"):
        empty.save_index("nowhere")
    empty.index_documents([])
    assert empty.search("word1") == []


@pytest.mark.parametrize("saver", ["jax", "port"])
def test_index_files_load_in_the_other_package(vectors, tmp_path, saver):
    search, jax_search = MeanVectorSearch(vectors, device="cpu"), JaxMeanVectorSearch(vectors)
    first, second = (jax_search, search) if saver == "jax" else (search, jax_search)
    first.index_documents(DOCS)
    first.save_index(str(tmp_path))
    assert json.loads((tmp_path / "documents.json").read_text())["dim"] == 12
    second.load_index(str(tmp_path))
    assert second.num_documents == len(DOCS) and second.dim == 12
    for query in QUERIES:
        _same_results(second.search(query, top_k=4), first.search(query, top_k=4))


def test_glove_search_offline(monkeypatch):
    monkeypatch.setitem(sys.modules, "gensim", None)  # no vectors, whatever is installed
    search = GloVeSearch("glove-twitter-25", device="cpu")
    assert search.dim == 50 and GloVeSearch(dim=30, device="cpu").dim == 30  # dim or 50
    assert "anything" in search.vectors and search.vectors["tpu"].shape == (50,)
    np.testing.assert_array_equal(search.vectors["tpu"],
                                  GloVeSearch(device="cpu").vectors["tpu"])
    search.index_documents(DOCS)
    search.encode(QUERIES)  # draws the queries' words too, before the copy
    jax_search = JaxMeanVectorSearch(dict(search.vectors), dim=50)
    jax_search.index_documents(DOCS)
    for query in QUERIES:
        got = search.search(query, top_k=5)
        _same_results(got, jax_search.search(query, top_k=5))
    for doc in DOCS[:10]:
        top = search.search(doc, top_k=2)
        assert top[0][0] == doc or top[0][1] == pytest.approx(top[1][1])
    jax_offline = JaxGloVeSearch("glove-twitter-25")
    assert jax_offline.dim == search.dim


def test_entry_points_run_on_the_card_unless_asked(vectors, monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setitem(sys.modules, "gensim", None)
    for make in (lambda: MeanVectorSearch(vectors), lambda: GloVeSearch()):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()
    ckpt, docs, _ = _checkpoint(tmp_path)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main(["build-index", "--checkpoint", ckpt, "--documents", docs,
                  "--index", str(tmp_path / "idx")])


# ---- the CLI ---------------------------------------------------------------------

def _checkpoint(tmp_path):
    """A save_params checkpoint of configs/word2vec_skipgram.yml's model (word
    vocab from DOCS, random weights from a JAX seed), and DOCS as a txt."""
    config = load_config(str(ROOT / "configs" / "word2vec_skipgram.yml"))
    tok_cfg = {k: v for k, v in config["tokeniser"].items() if k != "type"}
    jax_tok = jax_build_tokenizer("word", **tok_cfg).fit(DOCS)
    jax_spec = jax_spec_from_config(config, jax_tok.vocab_size)
    params = init_two_tower(jax.random.PRNGKey(2), jax_spec)
    path = save_params(str(tmp_path / "ckpt"), jax.tree_util.tree_map(np.asarray, params),
                       jax_tok.state_dict(), config)
    docs = tmp_path / "docs.txt"
    docs.write_text("\n".join(DOCS) + "\n\n")
    return path, str(docs), (params, jax_spec, jax_tok)


@pytest.fixture
def recorded(monkeypatch):
    """Every TwoTowerSearch.search the CLI makes, with its exact results."""
    calls = []
    search = TwoTowerSearch.search

    def recording(self, query, top_k=5):
        out = search(self, query, top_k)
        calls.append((query, top_k, out, self))
        return out

    monkeypatch.setattr(TwoTowerSearch, "search", recording)
    return calls


def test_cli_builds_and_searches_as_jax(tmp_path, capsys, recorded):
    ckpt, docs, (params, jax_spec, jax_tok) = _checkpoint(tmp_path)
    index = str(tmp_path / "index")
    assert cli.main(["build-index", "--checkpoint", ckpt, "--documents", docs,
                     "--index", index, "--device", "cpu"]) == 0
    assert f"Indexed {len(DOCS)} documents" in capsys.readouterr().out
    assert len(json.loads((Path(index) / "documents.json").read_text())["documents"]) == len(DOCS)

    jax_search = JaxSearch(params, jax_spec, jax_tok, max_length=32)
    jax_search.index_documents(DOCS)
    for query in QUERIES:
        assert cli.main(["search", "--checkpoint", ckpt, "--index", index, "--query", query,
                         "--top_k", "5", "--device", "cpu"]) == 0
        printed = capsys.readouterr().out.splitlines()
        got_query, top_k, got, search = recorded[-1]
        assert (got_query, top_k) == (query, 5) and search.device.type == "cpu"
        assert search.spec.embedding.embedding_dim == 300 and search.max_length == 32
        want = jax_search.search(query, top_k=5)
        _same_results(got, want)
        assert printed[0].startswith(f'Query: "{query}"') and f"{len(DOCS)} docs)" in printed[0]
        ranks = [re.match(r"^ ?(\d+)\. \[(-?[0-9.]+)\] (.*)$", line) for line in printed[1:]]
        assert [m.group(3) for m in ranks] == [d for d, _ in want]
        assert [int(m.group(1)) for m in ranks] == [1, 2, 3, 4, 5]
    assert recorded[0][2][0][0] == DOCS[4]  # an indexed text comes first for itself


def test_cli_max_length_and_parquet_documents(tmp_path, capsys, recorded):
    import pandas as pd

    ckpt, _, _ = _checkpoint(tmp_path)
    parquet = tmp_path / "docs.parquet"
    pd.DataFrame({"id": range(len(DOCS)), "passage_text": DOCS}).to_parquet(parquet)
    index = str(tmp_path / "index")
    assert cli.main(["build-index", "--checkpoint", ckpt, "--documents", str(parquet),
                     "--index", index, "--max_length", "8", "--device", "cpu"]) == 0
    assert cli.main(["search", "--checkpoint", ckpt, "--index", index, "--query", DOCS[9],
                     "--max_length", "8", "--device", "cpu"]) == 0
    _, _, results, search = recorded[-1]
    assert search.max_length == 8 and len(results) == 5
    pd.DataFrame({"other": ["x"]}).to_parquet(tmp_path / "bad.parquet")
    with pytest.raises(ValueError, match="No text column"):
        cli._load_documents(str(tmp_path / "bad.parquet"))


def test_cli_parquet_without_pandas_says_so(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "pandas", None)
    with pytest.raises(ImportError, match="needs pandas"):
        cli._load_documents(str(tmp_path / "docs.parquet"))
