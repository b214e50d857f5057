"""The word-scale lookup's plain versions against the JAX package.

The scatter-add plain version (``scatter_add_rows_reference``, what a CPU
tensor takes) and the gradient of the port's lookup ``GatherScatterGrad``
are held against ``scatter_add_rows(..., interpret=True)`` and the gradient
of ``_take_scatter_grad``, on the cases of the JAX package's kernel tests
(``test_torch_embed_kernels.py`` holds the CUDA kernel against the same
plain version on the card). Tolerances: rtol/atol 1e-5 (f32 sums in another
order), 1e-4 for the duplicate-heavy cases, as the JAX tests state them;
integer-valued g is bit-equal. The forward gather moves bits: bit-equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_embed_kernels import SCATTER_CASES, scatter_case
from twotowers_tpu.kernels.pallas_scatter_add import _take_scatter_grad, scatter_add_rows
from twotowers_tpu_torch.kernels.scatter_add import scatter_add_rows_reference
from twotowers_tpu_torch.models.embeddings import Embedding, EmbeddingSpec, GatherScatterGrad

# the interpret-mode kernel runs fast at a small tile; the tile changes no sum
TILE_N = 512


def _jax_scatter(g, ids, vocab):
    return np.asarray(scatter_add_rows(jnp.asarray(g), jnp.asarray(ids), vocab,
                                       tile_n=TILE_N, interpret=True))


@pytest.mark.parametrize("name", SCATTER_CASES)
def test_plain_scatter_add_matches_pallas_interpret(name):
    g, ids, vocab, rtol = scatter_case(name)
    got = scatter_add_rows_reference(torch.from_numpy(g), torch.from_numpy(ids), vocab)
    want = _jax_scatter(g, ids, vocab)
    assert got.dtype == torch.float32 and got.shape == want.shape
    if name == "integer":
        np.testing.assert_array_equal(got.numpy(), want)
    else:
        np.testing.assert_allclose(got.numpy(), want, rtol=rtol, atol=rtol)


def test_plain_scatter_add_widens_bf16_cotangents():
    g, ids, vocab, _ = scatter_case("v640-d64")
    g_bf16 = jnp.asarray(g).astype(jnp.bfloat16)
    want = np.asarray(scatter_add_rows(g_bf16, jnp.asarray(ids), vocab, tile_n=TILE_N,
                                       interpret=True))
    got = scatter_add_rows_reference(torch.from_numpy(g).bfloat16(), torch.from_numpy(ids),
                                     vocab)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def _jax_lookup_grad(table, ids, weight, table_dtype, dtype, monkeypatch):
    from twotowers_tpu.kernels import pallas_scatter_add as mod

    monkeypatch.setattr(mod, "scatter_add_rows",
                        lambda g, i, v: scatter_add_rows(g, i, v, tile_n=TILE_N, interpret=True))

    def loss(tab):
        out = _take_scatter_grad(tab, jnp.asarray(ids), dtype)
        return jnp.sum(out.astype(jnp.float32) * jnp.asarray(weight))

    value, grad = jax.value_and_grad(loss)(jnp.asarray(table).astype(table_dtype))
    return float(value), np.asarray(grad.astype(jnp.float32)), grad.dtype


@pytest.mark.parametrize("bf16_table", [False, True])
@pytest.mark.parametrize("bf16_compute", [False, True])
def test_lookup_gradient_matches_take_scatter_grad(np_rng, monkeypatch, bf16_table, bf16_compute):
    """GatherScatterGrad's CPU path against ``_take_scatter_grad``'s VJP:
    the gather, then the f32 scatter-add of the incoming rows cast to the
    table's dtype (a bf16 table receives a bf16 gradient)."""
    table = np_rng.normal(size=(640, 16)).astype(np.float32)
    ids = np.minimum(np_rng.geometric(0.3, size=(8, 12)) - 1, 639).astype(np.int32)
    weight = np_rng.normal(size=(8, 12, 16)).astype(np.float32)
    jdt, tdt = ((jnp.bfloat16, torch.bfloat16) if bf16_compute else (jnp.float32, torch.float32))
    jtab, ttab = ((jnp.bfloat16, torch.bfloat16) if bf16_table else (jnp.float32, torch.float32))
    value, want, want_dtype = _jax_lookup_grad(table, ids, weight, jtab, jdt, monkeypatch)

    tab = torch.from_numpy(table).to(ttab).requires_grad_()
    out = GatherScatterGrad.apply(tab, torch.from_numpy(ids), tdt)
    got_value = (out.float() * torch.from_numpy(weight)).sum()
    got_value.backward()
    assert out.dtype == tdt and tab.grad.dtype == ttab
    assert str(want_dtype) == str(ttab).removeprefix("torch.")
    # a bf16 gradient is one rounding of the same f32 sums: one bf16 step
    tol = 8e-3 if bf16_table else 1e-4
    np.testing.assert_allclose(float(got_value.detach()), value, rtol=1e-5)
    np.testing.assert_allclose(tab.grad.float().numpy(), want, rtol=tol, atol=tol)


@pytest.mark.parametrize("bf16", [False, True])
def test_word_scale_embedding_uses_the_lookup_function(np_rng, bf16):
    """Above 512 ids the module's gather is bit-equal to jnp.take and its
    backward is the scatter-add; at 512 and below it stays F.embedding."""
    for vocab, fn in ((640, "GatherScatterGradBackward"), (512, "EmbeddingBackward")):
        module = Embedding(EmbeddingSpec(kind="lookup", vocab_size=vocab, embedding_dim=16))
        table = np_rng.normal(size=(vocab, 16)).astype(np.float32)
        with torch.no_grad():
            module.table.copy_(torch.from_numpy(table))
        ids = np_rng.integers(0, vocab, size=(4, 9)).astype(np.int32)
        dtype = torch.bfloat16 if bf16 else torch.float32
        out = module(torch.from_numpy(ids), dtype)
        walk, names = [out.grad_fn], set()
        while walk:
            node = walk.pop()
            if node is not None:
                names.add(type(node).__name__)
                walk.extend(n for n, _ in node.next_functions)
        assert any(name.startswith(fn) for name in names), names
        want = jnp.take(jnp.asarray(table).astype(jnp.bfloat16 if bf16 else jnp.float32),
                        jnp.asarray(ids), axis=0).astype(jnp.float32)
        np.testing.assert_array_equal(out.detach().float().numpy(), np.asarray(want))


def test_frozen_table_gets_no_gradient(np_rng):
    module = Embedding(EmbeddingSpec(kind="lookup", vocab_size=640, embedding_dim=8,
                                     trainable=False))
    assert not module.table.requires_grad
    out = module(torch.from_numpy(np_rng.integers(0, 640, size=(2, 5)).astype(np.int32)))
    assert not out.requires_grad
