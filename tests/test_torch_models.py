"""The port's ops, embedding, towers and weight converter against JAX.

Inputs come from a numpy seed and go to both packages; JAX's parameters are
carried into the port with ``convert.params_from_jax``. Tolerances:

* f32 ops and encodings: rtol 1e-5, atol 1e-6 (the same f32 arithmetic,
  summed in another order by another BLAS);
* the lookup and the converter: bit for bit;
* ``precision: bf16``: atol 5e-3 on unit vectors, about one bf16 step
  (2**-8 = 3.9e-3 relative) of a pooled component: the lookup and pooling
  run in bf16, and the two frameworks may round their bf16 sums at other
  places. On this seeded input the gap is 6e-8.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from twotowers_tpu.models import (
    EmbeddingSpec as JaxEmbeddingSpec, TowerSpec as JaxTowerSpec,
    TwoTowerSpec as JaxTwoTowerSpec, embed_ids, init_two_tower)
from twotowers_tpu.models.towers import encode as jax_encode
from twotowers_tpu.models.embeddings import (
    spec_from_config as jax_embedding_spec_from_config)
from twotowers_tpu.models.towers import spec_from_config as jax_spec_from_config
from twotowers_tpu.ops import core as jax_core
from twotowers_tpu_torch.convert import params_from_jax, params_to_jax
from twotowers_tpu_torch.models import (
    Embedding, EmbeddingSpec, TowerSpec, TwoTower, TwoTowerSpec, spec_from_config)
from twotowers_tpu_torch.models.embeddings import (
    spec_from_config as embedding_spec_from_config)
from twotowers_tpu_torch.ops import core

DEFAULT_CONFIG = {  # configs/default_config.yml, the sections the model reads
    "precision": "float32",
    "tokeniser": {"type": "char", "max_len": 64},
    "embedding": {"type": "lookup", "embedding_dim": 64},
    "encoder": {"arch": "mean", "hidden_dim": 128, "tied_weights": False},
    "max_sequence_length": 64,
}


def _ids(rng, vocab, batch=6, seq=16):
    ids = rng.integers(0, vocab, size=(batch, seq)).astype(np.int32)
    ids[:, seq // 2:] = 0  # trailing padding
    ids[1] = 0             # an all-pad row pools to zero
    return ids


def _to_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _specs(arch, emb, hidden, tied, vocab=40, bf16=False):
    jax_spec = JaxTwoTowerSpec(
        embedding=JaxEmbeddingSpec(kind="lookup", vocab_size=vocab, embedding_dim=emb),
        tower=JaxTowerSpec(arch=arch, embedding_dim=emb, hidden_dim=hidden),
        tied_weights=tied, compute_dtype=jnp.bfloat16 if bf16 else jnp.float32)
    spec = TwoTowerSpec(
        embedding=EmbeddingSpec(kind="lookup", vocab_size=vocab, embedding_dim=emb),
        tower=TowerSpec(arch=arch, embedding_dim=emb, hidden_dim=hidden),
        tied_weights=tied, compute_dtype=torch.bfloat16 if bf16 else torch.float32)
    return jax_spec, spec


class TestOps:
    def test_pool_and_normalize_match_jax(self, np_rng):
        emb = np_rng.normal(size=(5, 12, 16)).astype(np.float32)
        ids = _ids(np_rng, 30, batch=5, seq=12)
        got = core.masked_mean_pool(torch.from_numpy(emb), torch.from_numpy(ids))
        want = np.asarray(jax_core.masked_mean_pool(jnp.asarray(emb), jnp.asarray(ids)))
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
        assert np.all(got.numpy()[1] == 0)  # the all-pad row

        x = np_rng.normal(size=(4, 16)).astype(np.float32)
        x[2] = 0.0  # exactly zero row: the eps clamps decide its value
        for fn, jax_fn, args in [
            (core.l2_normalize, jax_core.l2_normalize, (x,)),
            (core.cosine_similarity, jax_core.cosine_similarity, (x, x[::-1].copy())),
        ]:
            got = fn(*map(torch.from_numpy, args)).numpy()
            want = np.asarray(jax_fn(*map(jnp.asarray, args)))
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
            assert np.all(np.isfinite(got))


class TestEmbedding:
    # 40 takes JAX's one-hot matmul branch, 600 its gather branch
    @pytest.mark.parametrize("vocab", [40, 600])
    @pytest.mark.parametrize("bf16", [False, True])
    def test_lookup_is_bit_exact(self, np_rng, vocab, bf16):
        table = np_rng.normal(size=(vocab, 16)).astype(np.float32)
        table[0] = 0.0
        ids = _ids(np_rng, vocab)
        spec = JaxEmbeddingSpec(kind="lookup", vocab_size=vocab, embedding_dim=16)
        want = embed_ids({"table": jnp.asarray(table)}, spec, jnp.asarray(ids),
                         dtype=jnp.bfloat16 if bf16 else jnp.float32)
        module = Embedding(EmbeddingSpec(kind="lookup", vocab_size=vocab, embedding_dim=16))
        with torch.no_grad():
            module.table.copy_(torch.from_numpy(table))
            got = module(torch.from_numpy(ids), torch.bfloat16 if bf16 else torch.float32)
        np.testing.assert_array_equal(got.float().numpy(),
                                      np.asarray(want.astype(jnp.float32)))
        assert np.all(got.float().numpy()[ids == 0] == 0)  # the padding row

    @pytest.mark.parametrize("vocab", [40, 600])
    @pytest.mark.parametrize("bf16", [False, True])
    def test_positional_lookup_is_bit_exact(self, np_rng, vocab, bf16):
        """Table rows plus ``pos[:L]`` on the real tokens only; pad rows stay
        exactly zero."""
        table = np_rng.normal(size=(vocab, 16)).astype(np.float32)
        table[0] = 0.0
        pos = (0.02 * np_rng.normal(size=(20, 16))).astype(np.float32)
        ids = _ids(np_rng, vocab)
        jax_spec = JaxEmbeddingSpec(kind="positional", vocab_size=vocab, embedding_dim=16,
                                    max_len=20)
        want = embed_ids({"table": jnp.asarray(table), "pos": jnp.asarray(pos)}, jax_spec,
                         jnp.asarray(ids), dtype=jnp.bfloat16 if bf16 else jnp.float32)
        spec = EmbeddingSpec(kind="positional", vocab_size=vocab, embedding_dim=16, max_len=20)
        module = Embedding(spec)
        assert module.pos.shape == (20, 16) and module.pos.requires_grad
        with torch.no_grad():
            module.table.copy_(torch.from_numpy(table))
            module.pos.copy_(torch.from_numpy(pos))
            got = module(torch.from_numpy(ids), torch.bfloat16 if bf16 else torch.float32)
        np.testing.assert_array_equal(got.float().numpy(),
                                      np.asarray(want.astype(jnp.float32)))
        assert np.all(got.float().numpy()[ids == 0] == 0)

    def test_positional_defaults_follow_the_config(self):
        got = embedding_spec_from_config({"type": "positional", "embedding_dim": 8}, 30)
        want = jax_embedding_spec_from_config({"type": "positional", "embedding_dim": 8}, 30)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert got.trainable and got.max_len == 128
        frozen = Embedding(embedding_spec_from_config(
            {"type": "positional", "embedding_dim": 8, "trainable": False}, 30))
        assert not frozen.table.requires_grad and not frozen.pos.requires_grad


class TestTowers:
    @pytest.mark.parametrize("arch,emb,hidden", [
        ("mean", 16, 32), ("avg_pool", 16, 16), ("avg_pool", 16, 24)])
    @pytest.mark.parametrize("tied", [True, False])
    def test_encode_matches_jax(self, np_rng, arch, emb, hidden, tied):
        jax_spec, spec = _specs(arch, emb, hidden, tied)
        params = init_two_tower(jax.random.PRNGKey(1), jax_spec)
        model = params_from_jax(_to_np(params), spec).eval()
        ids = _ids(np_rng, 40)
        for tower in ("query", "document"):
            want = np.asarray(jax_encode(params, jax_spec, jnp.asarray(ids), tower))
            with torch.no_grad():
                got = model.encode(torch.from_numpy(ids), tower).numpy()
            assert got.shape == (6, spec.output_dim) and got.dtype == np.float32
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
        q, d, n = model(*(torch.from_numpy(ids),) * 3)
        assert torch.equal(d, n) and (torch.equal(q, d) or not tied)

    def test_bf16_precision_matches_jax(self, np_rng):
        jax_spec, spec = _specs("mean", 16, 32, False, bf16=True)
        params = init_two_tower(jax.random.PRNGKey(2), jax_spec)
        model = params_from_jax(_to_np(params), spec).eval()
        ids = _ids(np_rng, 40)
        want = np.asarray(jax_encode(params, jax_spec, jnp.asarray(ids), "document"))
        with torch.no_grad():
            got = model.encode(torch.from_numpy(ids), "document").numpy()
        assert got.dtype == np.float32
        np.testing.assert_allclose(got, want, atol=5e-3)

    @pytest.mark.parametrize("arch,hidden", [("mean", 32), ("avg_pool", 16), ("avg_pool", 24)])
    @pytest.mark.parametrize("tied", [True, False])
    def test_converter_round_trip_is_bit_exact(self, arch, hidden, tied):
        jax_spec, spec = _specs(arch, 16, hidden, tied)
        tree = _to_np(init_two_tower(jax.random.PRNGKey(3), jax_spec))
        back = params_to_jax(params_from_jax(tree, spec))
        flat = jax.tree_util.tree_leaves_with_path(tree)
        back_flat = jax.tree_util.tree_leaves_with_path(back)
        assert [p for p, _ in flat] == [p for p, _ in back_flat]
        for (_, a), (_, b) in zip(flat, back_flat):
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)

    def test_spec_from_config_matches_jax(self):
        want = jax_spec_from_config(DEFAULT_CONFIG, vocab_size=57)
        got = spec_from_config(DEFAULT_CONFIG, vocab_size=57)
        assert dataclasses.asdict(got.embedding) == dataclasses.asdict(want.embedding)
        assert dataclasses.asdict(got.tower) == dataclasses.asdict(want.tower)
        assert got.tied_weights == want.tied_weights and got.output_dim == want.output_dim == 128
        assert got.compute_dtype == torch.float32
        assert spec_from_config({"precision": "bf16"}, 5).compute_dtype == torch.bfloat16

    def test_init_draws_from_the_generator(self):
        _, spec = _specs("mean", 16, 32, False)
        state = torch.random.get_rng_state()
        a = TwoTower(spec, torch.Generator().manual_seed(7))
        b = TwoTower(spec, torch.Generator().manual_seed(7))
        assert torch.equal(torch.random.get_rng_state(), state)  # global RNG untouched
        for (name, pa), (_, pb) in zip(a.named_parameters(), b.named_parameters()):
            assert torch.equal(pa, pb), name
        assert torch.all(a.embedding.table[0] == 0)
        assert abs(a.embedding.table[1:].std().item() - 1.0) < 0.1  # N(0, 1)
        for linear, fan_in in [(a.query_tower.fc1, 16), (a.query_tower.fc2, 32)]:
            bound = 1.0 / np.sqrt(fan_in)
            for p in (linear.weight, linear.bias):
                assert p.abs().max().item() <= bound

    @pytest.mark.parametrize("arch", ["cnn", "rnn", "transformer"])
    def test_sequence_tower_spec_from_config_matches_jax(self, arch):
        """The sequence towers build from a config, with JAX's spec and its
        parameter count."""
        config = {"embedding": {"type": "positional", "embedding_dim": 16, "max_len": 24},
                  "encoder": {"arch": arch, "hidden_dim": 32, "num_layers": 2, "num_heads": 4,
                              "max_len": 24, "kernel_size": 4, "dropout": 0.0,
                              "tied_weights": True},
                  "precision": "bf16"}
        want = jax_spec_from_config(config, vocab_size=57)
        got = spec_from_config(config, vocab_size=57)
        assert dataclasses.asdict(got.embedding) == dataclasses.asdict(want.embedding)
        assert dataclasses.asdict(got.tower) == dataclasses.asdict(want.tower)
        assert got.output_dim == want.output_dim == 32 and got.compute_dtype == torch.bfloat16
        model = TwoTower(got)
        n_jax = sum(int(np.size(x)) for x in jax.tree_util.tree_leaves(
            init_two_tower(jax.random.PRNGKey(0), want)))
        assert sum(p.numel() for p in model.parameters()) == n_jax
