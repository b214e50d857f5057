"""The port's sharded index against the JAX package's, on the CPU.

The JAX package's ``ShardedDocIndex`` / ``ShardedTwoTowerSearch`` run in
this process on its 8 virtual CPU devices; the port's run in one group of 4
spawned gloo ranks (``torch_spawn.spawn_ranks``), over meshes of 1, 2 and
4 shards (the 1- and 2-shard meshes leave the other ranks out), and each
rank writes its results to an ``.npz``. The cases mirror
``tests/test_sharded_index.py``, with the 1,000-doc corpus cut to 1,001
rows so that no shard count divides it, and a tie case. The model's
weights are the port's initial draw, carried to JAX with
``convert.params_to_jax``.

Tolerances: indices exactly; scores rtol 1e-5 (f32 dot products summed in
another order); ``to_host`` and the saved index exactly.

Top level imports no JAX: the ranks import this module.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import pytest
import torch

from torch_spawn import spawn_ranks
from twotowers_tpu_torch.index import ShardedDocIndex, ShardedTwoTowerSearch, TwoTowerSearch
from twotowers_tpu_torch.models import EmbeddingSpec, TowerSpec, TwoTower, TwoTowerSpec
from twotowers_tpu_torch.parallel import make_mesh
from twotowers_tpu_torch.tokenizers import CharTokenizer

SHARDS = (1, 2, 4)
SCORES = {"rtol": 1e-5, "atol": 1e-6}


def _vectors(seed, *shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _docs_and_queries():
    docs, queries = _vectors(0, 1001, 32), _vectors(1, 7, 32)
    ties = np.round(_vectors(2, 300, 8))  # integer-valued: many equal scores
    tie_queries = np.ones((3, 8), np.float32)
    return docs, queries, ties, tie_queries


def _model():
    texts = [f"document number {i} about topic {i % 7}" for i in range(40)]
    tok = CharTokenizer().fit(texts)
    spec = TwoTowerSpec(
        embedding=EmbeddingSpec(kind="lookup", vocab_size=tok.vocab_size, embedding_dim=16),
        tower=TowerSpec(arch="mean", embedding_dim=16, hidden_dim=32),
        tied_weights=True)
    return TwoTower(spec, torch.Generator().manual_seed(4)), spec, tok, texts


QUERIES = ("document number 3", "topic 5", "completely new text")


def _index_checks(workdir: Path, rank: int):
    docs, queries, ties, tie_queries = _docs_and_queries()
    out = {}
    for shards in SHARDS:  # a 1- or 2-shard mesh leaves ranks out: they build none
        mesh = make_mesh(1, shards, device_type="cpu")
        if rank >= shards:
            continue
        index = ShardedDocIndex(mesh)
        for name, call in (("to_host_unbuilt", lambda: index.to_host()),
                           ("search_unbuilt", lambda: index.search_vectors(queries, 3))):
            try:
                call()
            except RuntimeError as exc:
                out[f"{name}{shards}"] = str(exc)
        index.build(docs)
        out[f"scores{shards}"], out[f"idx{shards}"] = index.search_vectors(queries, 9)
        out[f"host{shards}"] = index.to_host()
        index.build(ties)
        out[f"tie_scores{shards}"], out[f"tie_idx{shards}"] = index.search_vectors(tie_queries,
                                                                                   20)
    mesh = make_mesh(1, 2, device_type="cpu")
    if rank < 2:
        index = ShardedDocIndex(mesh)
        index.build(_vectors(3, 5, 8))
        out["clamped_scores"], out["clamped_idx"] = index.search_vectors(_vectors(4, 1, 8), 50)
    mesh = make_mesh(1, 4, device_type="cpu")
    index = ShardedDocIndex(mesh)
    index.build(_vectors(5, 300, 16))  # 75 rows a shard; k=80 reaches past a shard
    out["pad_scores"], out["pad_idx"] = index.search_vectors(_vectors(6, 4, 16), 80)

    # to_host over a (2, 2) mesh: data replicas of each shard
    mesh = make_mesh(2, 2, device_type="cpu")
    index = ShardedDocIndex(mesh)
    index.build(_vectors(7, 301, 16))
    out["host_2x2"] = index.to_host()

    model, spec, tok, texts = _model()
    mesh4 = make_mesh(1, 4, device_type="cpu")
    sharded = ShardedTwoTowerSearch(model, spec, tok, mesh4, max_length=32,
                                    encode_batch_size=8)
    sharded.index_documents(texts)
    for i, query in enumerate(QUERIES):
        results = sharded.search(query, top_k=5)
        out[f"docs{i}"] = [d for d, _ in results]
        out[f"doc_scores{i}"] = [s for _, s in results]

    # save / load over the whole group: rank 0 writes, every rank reads
    sharded = ShardedTwoTowerSearch(model, spec, tok, make_mesh(2, 2, device_type="cpu"),
                                    max_length=32, encode_batch_size=8)
    sharded.index_documents(texts)
    before = sharded.search("document number 7", top_k=3)
    sharded.save_index(str(workdir / "idx"))
    fresh = ShardedTwoTowerSearch(model, spec, tok, make_mesh(2, 2, device_type="cpu"),
                                  max_length=32, encode_batch_size=8)
    fresh.load_index(str(workdir / "idx"))
    out["roundtrip_equal"] = fresh.search("document number 7", top_k=3) == before
    out["roundtrip_docs"] = fresh.num_documents
    return out


def _rank_main(rank, world, workdir):
    out = _index_checks(workdir, rank)
    np.savez(workdir / f"index.r{rank}.npz", **{k: np.asarray(v) for k, v in out.items()})


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    workdir = tmp_path_factory.mktemp("sharded_index")
    spawn_ranks(_rank_main, 4, workdir)

    def load(rank=0):
        with np.load(workdir / f"index.r{rank}.npz") as data:
            return {k: data[k] for k in data.files}

    load.workdir = workdir
    return load


def _jax_index(shards, docs):
    from twotowers_tpu.index import ShardedDocIndex as JaxIndex
    from twotowers_tpu.parallel import make_mesh as jax_mesh

    index = JaxIndex(jax_mesh(data=1, model=shards))
    index.build(docs)
    return index


class TestShardedDocIndex:
    @pytest.mark.parametrize("num_shards", SHARDS)
    def test_matches_jax_and_dense_argsort(self, ranks, num_shards):
        docs, queries, _, _ = _docs_and_queries()
        want_s, want_i = _jax_index(num_shards, docs).search_vectors(queries, k=9)
        dense = queries @ docs.T
        for rank in range(num_shards):
            got = ranks(rank)
            np.testing.assert_array_equal(got[f"idx{num_shards}"], want_i)
            np.testing.assert_allclose(got[f"scores{num_shards}"], want_s, **SCORES)
            for qi in range(len(queries)):
                want = np.argsort(-dense[qi], kind="stable")[:9]
                np.testing.assert_array_equal(got[f"idx{num_shards}"][qi], want)

    @pytest.mark.parametrize("num_shards", SHARDS)
    def test_ties_go_to_the_lower_index(self, ranks, num_shards):
        _, _, ties, tie_queries = _docs_and_queries()
        want = np.argsort(-(tie_queries @ ties.T), axis=1, kind="stable")[:, :20]
        _, jax_idx = _jax_index(num_shards, ties).search_vectors(tie_queries, k=20)
        np.testing.assert_array_equal(jax_idx, want)
        for rank in range(num_shards):
            np.testing.assert_array_equal(ranks(rank)[f"tie_idx{num_shards}"], want)

    def test_k_clamped_to_corpus(self, ranks):
        want_s, want_i = _jax_index(2, _vectors(3, 5, 8)).search_vectors(_vectors(4, 1, 8), k=50)
        for rank in range(2):
            got = ranks(rank)
            assert got["clamped_idx"].shape == (1, 5)
            np.testing.assert_array_equal(got["clamped_idx"], want_i)
            np.testing.assert_allclose(got["clamped_scores"], want_s, **SCORES)

    def test_padding_rows_never_returned(self, ranks):
        """300 rows over 4 shards with k=80, more than a shard's 75 rows."""
        want_s, want_i = _jax_index(4, _vectors(5, 300, 16)).search_vectors(
            _vectors(6, 4, 16), k=80)
        for rank in range(4):
            got = ranks(rank)
            assert got["pad_idx"].max() < 300
            np.testing.assert_array_equal(got["pad_idx"], want_i)
            np.testing.assert_allclose(got["pad_scores"], want_s, **SCORES)

    @pytest.mark.parametrize("num_shards", SHARDS)
    def test_to_host_roundtrip(self, ranks, num_shards):
        docs = _docs_and_queries()[0]
        for rank in range(num_shards):
            np.testing.assert_array_equal(ranks(rank)[f"host{num_shards}"], docs)

    def test_to_host_over_data_replicas(self, ranks):
        want = _vectors(7, 301, 16)
        np.testing.assert_array_equal(_jax_index(4, want).to_host(), want)
        for rank in range(4):
            np.testing.assert_array_equal(ranks(rank)["host_2x2"], want)

    @pytest.mark.parametrize("call", ["to_host", "search"])
    def test_before_build_raises(self, ranks, call):
        for shards in SHARDS:
            assert "not built" in str(ranks(0)[f"{call}_unbuilt{shards}"])


class TestShardedTwoTowerSearch:
    def test_matches_unsharded_engine(self, ranks):
        """4 shards against the port's single-device engine and the JAX
        package's sharded one, from the same weights."""
        from twotowers_tpu.index import ShardedTwoTowerSearch as JaxSearch
        from twotowers_tpu.models import spec_from_config as jax_spec_from_config
        from twotowers_tpu.parallel import make_mesh as jax_mesh
        import jax
        import jax.numpy as jnp
        from twotowers_tpu_torch.convert import params_to_jax

        model, spec, tok, texts = _model()
        single = TwoTowerSearch(model, spec, tok, max_length=32, encode_batch_size=8,
                                device="cpu")
        single.index_documents(texts)
        jax_spec = jax_spec_from_config(
            {"embedding": {"type": "lookup", "embedding_dim": 16},
             "encoder": {"arch": "mean", "hidden_dim": 32, "tied_weights": True}},
            tok.vocab_size)
        jax_search = JaxSearch(jax.tree_util.tree_map(jnp.asarray, params_to_jax(model)),
                               jax_spec, tok, jax_mesh(data=1, model=4), max_length=32,
                               encode_batch_size=8)
        jax_search.index_documents(texts)
        for i, query in enumerate(QUERIES):
            want = single.search(query, top_k=5)
            jax_want = jax_search.search(query, top_k=5)
            assert [d for d, _ in jax_want] == [d for d, _ in want]
            for rank in range(4):
                got = ranks(rank)
                assert list(got[f"docs{i}"]) == [d for d, _ in want]
                np.testing.assert_allclose(got[f"doc_scores{i}"], [s for _, s in want],
                                           **SCORES)
                np.testing.assert_allclose(got[f"doc_scores{i}"], [s for _, s in jax_want],
                                           **SCORES)

    def test_save_load_roundtrip(self, ranks):
        for rank in range(4):
            got = ranks(rank)
            assert bool(got["roundtrip_equal"]) and int(got["roundtrip_docs"]) == 40
        with np.load(ranks.workdir / "idx" / "embeddings.npz") as data:
            assert data["embeddings"].shape == (40, 32)
