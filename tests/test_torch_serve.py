"""The serving slice as a whole: the JAX package against the port.

Both packages get the same parameters (carried over with ``convert``) and
the same tokenizer state, and serve the same texts. Scores and vectors agree
within atol 1e-5 (f32 towers and f32 dot products summed in another order);
documents, ids, statuses and response shapes are equal. The port runs on
the CPU here (``device="cpu"``), where ``score_topk`` is its plain version.
"""

import jax
import numpy as np
import pytest
import torch

from twotowers_tpu.index.two_tower import TwoTowerSearch as JaxSearch
from twotowers_tpu.models import init_two_tower
from twotowers_tpu.models.towers import spec_from_config as jax_spec_from_config
from twotowers_tpu.serve.app import ModelRuntime as JaxRuntime
from twotowers_tpu.serve.service import RetrievalService as JaxService
from twotowers_tpu.serve.service import ServiceError as JaxServiceError
from twotowers_tpu.serve.store import VectorCollection as JaxCollection
from twotowers_tpu.tokenizers import build_tokenizer as jax_build_tokenizer
from twotowers_tpu.train.checkpoint import load_metadata as jax_load_metadata
from twotowers_tpu.train.checkpoint import save_checkpoint
from twotowers_tpu.train.optim import build_optimizer
from twotowers_tpu_torch.convert import params_from_jax
from twotowers_tpu_torch.index.two_tower import TwoTowerSearch
from twotowers_tpu_torch.models import spec_from_config
from twotowers_tpu_torch.serve import service as service_module
from twotowers_tpu_torch.serve import store as store_module
from twotowers_tpu_torch.serve.app import ModelRuntime, _load_runtime, create_app
from twotowers_tpu_torch.serve.service import RetrievalService, ServiceError
from twotowers_tpu_torch.serve.store import MAX_RETRIES, VectorCollection
from twotowers_tpu_torch.tokenizers import tokenizer_from_state
from twotowers_tpu_torch.train.checkpoint import load_metadata, load_trained_model, save_params

CONFIG = {
    "tokeniser": {"type": "char", "max_len": 32},
    "embedding": {"type": "lookup", "embedding_dim": 16},
    "encoder": {"arch": "mean", "hidden_dim": 24, "tied_weights": False},
    "optimizer": {"type": "adamw", "lr": 1e-3},
}
MAX_LEN = 32
ATOL = 1e-5


def _texts(n, seed=0):
    rng = np.random.default_rng(seed)
    alphabet = np.array(list("abcdefghijklmnopqrstuvwxyz  "))
    return ["".join(rng.choice(alphabet, size=rng.integers(8, 30))) for _ in range(n)]


TEXTS = _texts(40)
QUERIES = [TEXTS[3], TEXTS[17], "zzz qqq", "a"]


@pytest.fixture(scope="module")
def both():
    """(jax_params, jax_spec, jax_tokenizer, port_model, port_spec, port_tokenizer)."""
    jax_tok = jax_build_tokenizer("char").fit(TEXTS)
    jax_spec = jax_spec_from_config(CONFIG, jax_tok.vocab_size)
    params = init_two_tower(jax.random.PRNGKey(0), jax_spec)
    tok = tokenizer_from_state(jax_tok.state_dict())
    spec = spec_from_config(CONFIG, tok.vocab_size)
    model = params_from_jax(jax.tree_util.tree_map(np.asarray, params), spec)
    return params, jax_spec, jax_tok, model, spec, tok


def _searches(both):
    params, jax_spec, jax_tok, model, spec, tok = both
    return (JaxSearch(params, jax_spec, jax_tok, max_length=MAX_LEN, encode_batch_size=16),
            TwoTowerSearch(model, spec, tok, max_length=MAX_LEN, encode_batch_size=16,
                           device="cpu"))


def _assert_same_results(got, want):
    assert [[d for d, _ in row] for row in got] == [[d for d, _ in row] for row in want]
    np.testing.assert_allclose([[s for _, s in row] for row in got],
                               [[s for _, s in row] for row in want], atol=ATOL)


def test_search_batch_matches_jax(both):
    jax_search, search = _searches(both)
    jax_search.index_documents(TEXTS)
    search.index_documents(TEXTS)
    assert search._doc_matrix.shape == (128, 24)  # padded to ROW_ALIGN rows
    got, want = search.search_batch(QUERIES, top_k=5), jax_search.search_batch(QUERIES, top_k=5)
    _assert_same_results(got, want)
    _assert_same_results([search.search(QUERIES[2], top_k=100)],
                         [jax_search.search(QUERIES[2], top_k=100)])


@pytest.mark.parametrize("saver", ["jax", "port"])
def test_index_files_load_in_the_other_package(both, tmp_path, saver):
    jax_search, search = _searches(both)
    first, second = (jax_search, search) if saver == "jax" else (search, jax_search)
    first.index_documents(TEXTS)
    first.save_index(str(tmp_path))
    second.load_index(str(tmp_path))
    assert second.num_documents == len(TEXTS)
    _assert_same_results(second.search_batch(QUERIES, top_k=3),
                         first.search_batch(QUERIES, top_k=3))


@pytest.fixture(scope="module")
def services(both, tmp_path_factory):
    """A JAX service on an orbax checkpoint and a port service on a
    save_params checkpoint of the same weights."""
    params, _, jax_tok, _, _, _ = both
    optimizer = build_optimizer(CONFIG)
    jax_path = save_checkpoint(
        {"params": params, "opt_state": optimizer.init(params)},
        str(tmp_path_factory.mktemp("jax_ckpt")), tokenizer_state=jax_tok.state_dict(),
        config=CONFIG, epoch=1, loss=0.5, save_best=False)
    port_path = save_params(str(tmp_path_factory.mktemp("port_ckpt")),
                            jax.tree_util.tree_map(np.asarray, params),
                            jax_tok.state_dict(), CONFIG)
    return (JaxService(model=JaxRuntime(jax_path), collection=JaxCollection("documents")),
            RetrievalService(model=ModelRuntime(port_path, device="cpu"), device="cpu"),
            jax_path, port_path)


def test_service_routes_match_jax(services):
    jax_service, service, _, _ = services
    assert service.health() == jax_service.health()
    np.testing.assert_allclose(service.embed(QUERIES)["embeddings"],
                               jax_service.embed(QUERIES)["embeddings"], atol=ATOL)
    ids = [f"d{i}" for i in range(len(TEXTS))]
    assert service.add(TEXTS, ids=ids) == jax_service.add(TEXTS, ids=ids)
    assert service.health() == jax_service.health()
    for query in QUERIES:
        got, want = service.search(query, top_k=4), jax_service.search(query, top_k=4)
        assert got["query"] == want["query"]
        strip = lambda r: [(x["id"], x["document"], x["metadata"]) for x in r["results"]]  # noqa: E731
        assert strip(got) == strip(want)
        np.testing.assert_allclose([x["distance"] for x in got["results"]],
                                   [x["distance"] for x in want["results"]], atol=ATOL)


@pytest.mark.parametrize("call,status", [
    (lambda s: s.embed([]), 422),
    (lambda s: s.add(["a", "b"], ids=["only_one"]), 422),
    (lambda s: s.add([]), 422),
])
def test_service_errors_match_jax(services, call, status):
    jax_service, service, _, _ = services
    for svc, error in ((service, ServiceError), (jax_service, JaxServiceError)):
        with pytest.raises(error) as exc:
            call(svc)
        assert exc.value.status == status


def test_negative_top_k_raises_as_jax_does(both, services):
    """A negative k is refused by score_topk in both packages, through
    search_batch (which clamps k only from above) and through the service's
    search, whose error is not a ServiceError and so propagates; k = 0
    gives empty results in both."""
    jax_search, search = _searches(both)
    jax_search.index_documents(TEXTS)
    search.index_documents(TEXTS)
    for s in (search, jax_search):
        with pytest.raises(ValueError, match="nonnegative"):
            s.search_batch(QUERIES, top_k=-1)
    assert search.search_batch(QUERIES[:2], top_k=0) == jax_search.search_batch(QUERIES[:2],
                                                                               top_k=0)
    jax_service, service, _, _ = services
    ids = [f"d{i}" for i in range(len(TEXTS))]
    for svc in (service, jax_service):
        svc.add(TEXTS, ids=ids)
        with pytest.raises(ValueError, match="nonnegative"):
            svc.search(QUERIES[0], top_k=-1)
    assert service.search(QUERIES[0], top_k=0) == jax_service.search(QUERIES[0], top_k=0)


def test_degraded_mode_matches_jax():
    jax_svc, svc = JaxService(model=None), RetrievalService(model=None, device="cpu")
    assert svc.health() == jax_svc.health()
    for call in (lambda s: s.embed(["x"]), lambda s: s.add(["x"]), lambda s: s.search("x")):
        for s, error in ((svc, ServiceError), (jax_svc, JaxServiceError)):
            with pytest.raises(error) as exc:
                call(s)
            assert exc.value.status == 503


def test_checkpoint_layout_matches_jax(services):
    _, _, jax_path, port_path = services
    assert set(load_metadata(port_path)) == set(jax_load_metadata(jax_path))
    model, spec, tok, config = load_trained_model(port_path, device="cpu")
    assert config == CONFIG and not model.training and spec.output_dim == 24
    assert tok.state_dict() == jax_load_metadata(jax_path)["tokenizer"]


def test_entry_points_default_to_the_card(both, services, monkeypatch):
    _, _, _, model, spec, tok = both
    port_path = services[3]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for build in (lambda: ModelRuntime(port_path),
                  lambda: TwoTowerSearch(model, spec, tok),
                  lambda: VectorCollection("documents"),
                  lambda: RetrievalService(),
                  lambda: load_trained_model(port_path)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            build()


def test_load_runtime_reads_model_checkpoint(services, monkeypatch):
    monkeypatch.setenv("MODEL_CHECKPOINT", services[3])
    assert isinstance(_load_runtime("cpu"), ModelRuntime)
    monkeypatch.delenv("MODEL_CHECKPOINT")
    assert _load_runtime("cpu") is None
    with pytest.raises(RuntimeError, match="fastapi"):
        create_app("cpu")


def test_query_under_sustained_writes_pairs_texts_with_their_scores(monkeypatch):
    """Deviation from the JAX store: once its retries run out it returns
    texts of the newest state beside scores of an older one. Here the last
    attempt is scored under the lock, so each text carries its own score."""
    e0, e1 = np.eye(2, dtype=np.float32)
    coll = VectorCollection("c", device="cpu")
    coll.add(["a", "b"], np.stack([e0, e1]), ["a0", "b"])
    real = store_module.score_topk
    writes = []

    def score_then_write(docs, queries, k, n):
        out = real(docs, queries, k, n)
        if coll._lock.acquire(blocking=False):  # an optimistic attempt: a writer slips in
            coll._lock.release()
            writes.append(1)
            coll.add(["a"], [-e0 if len(writes) % 2 else e0], [f"a{len(writes)}"])
        return out

    monkeypatch.setattr(store_module, "score_topk", score_then_write)
    result = coll.query(e0[None], n_results=2)
    assert len(writes) == MAX_RETRIES
    stored = {rid: coll._embeddings[coll._id_to_pos[rid]] for rid in ("a", "b")}
    for rid, doc, dist in zip(result["ids"][0], result["documents"][0],
                              result["distances"][0]):
        assert doc == coll._documents[coll._id_to_pos[rid]]
        assert dist == pytest.approx(1.0 - float(stored[rid] @ e0), abs=1e-6)
    assert result["documents"][0] == ["b", f"a{MAX_RETRIES}"]


def _records(coll):
    return {rid: (coll._documents[pos], coll._metadatas[pos], coll._embeddings[pos].tolist())
            for rid, pos in coll._id_to_pos.items()}


@pytest.mark.parametrize("first", [[], ["x"]])
def test_repeated_id_within_one_add_keeps_its_last_record(first):
    """Deviation from the JAX store, which splits the record (first add:
    the first embedding beside the last text) or raises IndexError after a
    partial write (a later add). Here the last occurrence wins, on an empty
    store and on a non-empty one."""
    coll = VectorCollection("c", device="cpu")
    e = np.eye(4, dtype=np.float32)
    if first:
        coll.add(first, e[3:], ["X"])
    coll.add(["a", "b", "a"], e[:3], ["A1", "B", "A2"], [{"n": 1}, {"n": 2}, {"n": 3}])
    assert coll.count() == len(first) + 2 == len(coll._embeddings)
    assert _records(coll)["a"] == ("A2", {"n": 3}, e[2].tolist())
    assert _records(coll)["b"] == ("B", {"n": 2}, e[1].tolist())
    result = coll.query(e[2][None], n_results=1)
    assert (result["ids"], result["documents"]) == ([["a"]], [["A2"]])
    assert result["distances"][0][0] == pytest.approx(0.0, abs=1e-6)


def test_short_metadatas_leave_the_store_as_it_was():
    coll = VectorCollection("c", device="cpu")
    e = np.eye(3, dtype=np.float32)
    coll.add(["x"], e[:1], ["X"], [{"k": 0}])
    before = (_records(coll), coll._version)
    with pytest.raises(ValueError, match="metadatas"):
        coll.add(["x", "y"], e[1:], ["X2", "Y"], [{"k": 1}])
    assert (_records(coll), coll._version) == before
    with pytest.raises(ValueError, match="align"):
        coll.add(["y", "z"], e[1:2], ["Y", "Z"])
    assert (_records(coll), coll._version) == before


def test_id_less_adds_in_one_millisecond_keep_both(services, monkeypatch):
    """Deviation from the JAX service, whose doc_{ms}_{i} ids collide for
    two id-less adds in one millisecond: the second overwrites the first.
    Here the ids carry a per-process call number too."""
    service = services[1]
    fresh = RetrievalService(model=service.model, device="cpu")
    monkeypatch.setattr(service_module.time, "time", lambda: 1_700_000_000.0)
    fresh.add(TEXTS[:3])
    fresh.add(TEXTS[3:5])
    assert fresh.collection.count() == 5
    assert len(set(fresh.collection._ids)) == 5
    assert all(rid.startswith("doc_1700000000000_") for rid in fresh.collection._ids)
