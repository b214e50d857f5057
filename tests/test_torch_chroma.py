"""The rest of serving: ``serve/chroma.py``, the search page and the app's
model and backend selection, against the JAX package.

``chromadb`` is not installed here: a stub client takes its place, as in
``tests/test_serve_reports.py``. The port's ``ChromaCollection`` gives the
JAX adapter's results on the same stub, and ``collection_from_env`` picks
the same backend with ``CHROMA_HOST`` set, unset and unreachable. One
deviation, on purpose: an add without metadata sends none, where the JAX
adapter sends an empty dict a record, which Chroma servers that require
non-empty metadata reject (``twotowers_tpu/serve/chroma.py:71``); the
stub here rejects them as such a server does. The page is the JAX
package's byte for byte; ``MODEL_REPO_URL`` loads a model through a stubbed
Hub.
"""

import logging
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

import twotowers_tpu.serve.chroma as jax_chroma
import twotowers_tpu_torch.serve.app as app
import twotowers_tpu_torch.serve.chroma as chroma
from test_torch_loop import _config, _word_tsv
from twotowers_tpu.serve.store import VectorCollection as JaxVectorCollection
from twotowers_tpu_torch.hub import save_model_for_hub
from twotowers_tpu_torch.serve.store import VectorCollection
from twotowers_tpu_torch.train import train_model

ROOT = Path(__file__).resolve().parents[1]


def _unit(v):
    v = np.asarray(v, np.float32)
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


class _StubCollection:
    """An in-memory Chroma collection that, like current servers, rejects
    an empty metadata dict and stores None where none is sent."""

    def __init__(self):
        self.store, self.upserts = {}, []

    def upsert(self, ids, embeddings, documents, metadatas=None):
        self.upserts.append(metadatas)
        if metadatas is not None and any(not m for m in metadatas):
            raise ValueError("Expected metadata to be a non-empty dict")
        for i, (key, e, d) in enumerate(zip(ids, embeddings, documents)):
            self.store[key] = (np.asarray(e, np.float32), d,
                               None if metadatas is None else metadatas[i])

    def count(self):
        return len(self.store)

    def query(self, query_embeddings, n_results, include):
        q = _unit(query_embeddings)
        keys = list(self.store)
        sims = q @ _unit(np.stack([self.store[k][0] for k in keys])).T
        out = {"ids": [], "documents": [], "distances": [], "metadatas": []}
        for row in sims:
            order = np.argsort(-row, kind="stable")[:n_results]
            out["ids"].append([keys[j] for j in order])
            out["documents"].append([self.store[keys[j]][1] for j in order])
            out["distances"].append([float(1 - row[j]) for j in order])
            out["metadatas"].append([self.store[keys[j]][2] for j in order])
        return out


class _StubClient:
    def __init__(self):
        self.collections = {}

    def get_or_create_collection(self, name, metadata=None):
        assert metadata == {"hnsw:space": "cosine"}
        return self.collections.setdefault(name, _StubCollection())


def _pair(dim=None):
    """The port's and JAX's adapters, each on a stub client of its own."""
    return (chroma.ChromaCollection("docs", client=_StubClient(), dim=dim),
            jax_chroma.ChromaCollection("docs", client=_StubClient(), dim=dim))


def test_add_and_query_match_jax(np_rng):
    port, jax = _pair()
    vectors = _unit(np_rng.normal(size=(12, 8)))
    metadatas = [{"k": i} for i in range(12)]
    for col in (port, jax):
        assert col.add([f"d{i}" for i in range(12)], vectors, [f"doc {i}" for i in range(12)],
                       metadatas) == 12
        assert col.count() == 12 and col.dim == 8
    queries = _unit(np_rng.normal(size=(3, 8)))
    got, want = port.query(queries, n_results=4), jax.query(queries, n_results=4)
    assert got == want and got["metadatas"][0][0] in metadatas
    # upsert: the same id again overwrites, as the in-process store does
    for col in (port, jax):
        col.add(["d0"], vectors[:1], ["new"], [{"k": "new"}])
    assert port.query(vectors[:1], 1) == jax.query(vectors[:1], 1)
    assert port.query(vectors[:1], 1)["documents"] == [["new"]] and port.count() == 12
    # the service's device encode is a tensor: read back to host floats
    assert port.query(torch.from_numpy(queries), 4) == jax.query(queries, 4)


def test_empty_query_and_dim_mismatch_match_jax():
    for col in _pair():
        assert col.query(np.ones((1, 4), np.float32)) == {
            "ids": [[]], "documents": [[]], "distances": [[]], "metadatas": [[]]}
        col.add(["a"], np.ones((1, 4), np.float32), ["d"], [{"k": 1}])
        with pytest.raises(ValueError, match="dim mismatch"):
            col.add(["b"], np.ones((1, 8), np.float32), ["d2"])
        with pytest.raises(ValueError, match="must align"):
            col.add(["b", "c"], np.ones((1, 4), np.float32), ["d2"])
        with pytest.raises(NotImplementedError, match="reconnect"):
            type(col).load("some/path")


def test_add_without_metadata_sends_none_where_jax_sends_empty_dicts(np_rng):
    """The deviation: the JAX adapter's empty dicts are refused by a server
    that wants non-empty metadata; the port sends none, and such records
    read back with ``{}``, the in-process store's empty metadata."""
    port, jax = _pair()
    vectors = _unit(np_rng.normal(size=(2, 4)))
    with pytest.raises(ValueError, match="non-empty dict"):
        jax.add(["a", "b"], vectors, ["da", "db"])
    assert port.add(["a", "b"], vectors, ["da", "db"]) == 2
    assert port._collection.upserts == [None]
    assert port.query(vectors[1], 2)["metadatas"] == [[{}, {}]]
    store = VectorCollection("docs", device="cpu")
    store.add(["a", "b"], vectors, ["da", "db"])
    assert store.query(vectors[1], 2)["metadatas"] == [[{}, {}]]


def _chromadb(client=None, error=None):
    module = types.ModuleType("chromadb")

    def HttpClient(host, port):  # noqa: N802 (chromadb's name)
        if error:
            raise error
        client.address = (host, port)
        return client

    module.HttpClient = HttpClient
    return module


@pytest.mark.parametrize("case", ["unset", "set", "unreachable", "no chromadb"])
def test_collection_from_env_picks_the_backend_jax_picks(monkeypatch, case):
    client = _StubClient()
    if case == "unset":
        monkeypatch.delenv("CHROMA_HOST", raising=False)
    else:
        monkeypatch.setenv("CHROMA_HOST", "chroma.local")
        monkeypatch.setenv("CHROMA_PORT", "8123")
    module = {"set": _chromadb(client),
              "unreachable": _chromadb(error=ConnectionError("refused")),
              "no chromadb": None}.get(case, _chromadb(client))
    monkeypatch.setitem(sys.modules, "chromadb", module)
    got = chroma.collection_from_env("docs", device="cpu")
    want = jax_chroma.collection_from_env("docs")
    expected = {"set": (chroma.ChromaCollection, jax_chroma.ChromaCollection)}.get(
        case, (VectorCollection, JaxVectorCollection))
    assert (type(got), type(want)) == expected and got.name == want.name == "docs"
    if case == "set":
        assert client.address == ("chroma.local", 8123) and "docs" in client.collections
    else:
        assert got.device == torch.device("cpu")


def test_the_page_is_the_jax_page_byte_for_byte():
    jax_page = ROOT / "twotowers_tpu" / "serve" / "static" / "index.html"
    assert app.INDEX_PAGE.read_bytes() == jax_page.read_bytes()
    assert app.index_page() == jax_page.read_text() and "<html" in app.index_page().lower()
    assert "serve/static/*.html" in (ROOT / "pyproject.toml").read_text().split(
        "twotowers_tpu_torch = [")[1].split("]")[0]


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    tmp_path = tmp_path_factory.mktemp("served")
    data, rows = _word_tsv(tmp_path / "train.tsv", np.random.default_rng(3), n=40)
    train_model(_config(tmp_path, data, epochs=1, encoder={
        "arch": "mean", "hidden_dim": 32, "tied_weights": True}), seed=0, device="cpu")
    return tmp_path / "ckpt" / "best_model", [row[1] for row in rows]


def _stub_hub(monkeypatch, root, error=None):
    calls = []
    module = types.ModuleType("huggingface_hub")

    def snapshot_download(repo_id, **kwargs):
        calls.append(repo_id)
        if error:
            raise error
        return str(root)

    module.snapshot_download = snapshot_download
    monkeypatch.setitem(sys.modules, "huggingface_hub", module)
    return calls


def test_load_runtime_falls_back_to_the_hub(monkeypatch, checkpoint, tmp_path):
    best, positives = checkpoint
    snapshot = tmp_path / "snapshot"
    save_model_for_hub(str(best), str(snapshot))
    calls = _stub_hub(monkeypatch, snapshot)
    monkeypatch.delenv("MODEL_CHECKPOINT", raising=False)
    monkeypatch.setenv("MODEL_REPO_URL", "someone/two-tower")
    runtime = app._load_runtime("cpu")
    assert calls == ["someone/two-tower"] and runtime.device == torch.device("cpu")
    direct = app.ModelRuntime(str(best), device="cpu")
    np.testing.assert_array_equal(runtime.encode(positives[:5]), direct.encode(positives[:5]))

    monkeypatch.setenv("MODEL_CHECKPOINT", str(best))  # a local checkpoint comes first
    assert app._load_runtime("cpu") is not None and calls == ["someone/two-tower"]


def test_load_runtime_soft_fails_without_a_model(monkeypatch, tmp_path):
    records = []
    handler = logging.Handler(logging.ERROR)
    handler.emit = lambda record: records.append(record.getMessage())
    logger = logging.getLogger("twotowers_tpu_torch.serve.app")
    logger.addHandler(handler)
    try:
        monkeypatch.delenv("MODEL_CHECKPOINT", raising=False)
        monkeypatch.delenv("MODEL_REPO_URL", raising=False)
        assert app._load_runtime("cpu") is None
        _stub_hub(monkeypatch, tmp_path, error=ConnectionError("offline"))
        monkeypatch.setenv("MODEL_REPO_URL", "someone/two-tower")
        assert app._load_runtime("cpu") is None
    finally:
        logger.removeHandler(handler)
    assert records == ["Hub model load failed: offline"]


@pytest.mark.parametrize("backend", ["in-process", "chroma"])
def test_build_service_serves_as_the_app_builds_it(monkeypatch, checkpoint, backend):
    best, positives = checkpoint
    monkeypatch.setenv("MODEL_CHECKPOINT", str(best))
    monkeypatch.delenv("MODEL_REPO_URL", raising=False)
    if backend == "chroma":
        monkeypatch.setenv("CHROMA_HOST", "chroma.local")
        monkeypatch.setitem(sys.modules, "chromadb", _chromadb(_StubClient()))
    else:
        monkeypatch.delenv("CHROMA_HOST", raising=False)
    service = app.build_service("cpu")
    expected = chroma.ChromaCollection if backend == "chroma" else VectorCollection
    assert isinstance(service.collection, expected) and service.model is not None
    docs = list(dict.fromkeys(positives))
    service.add(docs, ids=[f"p{i}" for i in range(len(docs))])
    assert service.health() == {"status": "ok", "model_loaded": True, "documents": len(docs)}
    for i in (0, len(docs) // 2, len(docs) - 1):
        results = service.search(docs[i], top_k=3)["results"]
        first = [r["document"] for r in results
                 if r["distance"] <= results[0]["distance"] + 1e-6]
        assert docs[i] in first and all(r["metadata"] == {} for r in results)
    assert app.build_service("cpu", load_model=False).model is None
