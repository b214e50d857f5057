"""The port's score + top-k against the JAX package's two implementations.

On the CPU the port's ``score_topk`` is its plain version; it is held
against ``score_topk_xla`` and against the Pallas kernel in interpret mode
(``tile_n=128``; that path declines N < 2 * tile_n, so its cases use
N >= 256), on the cases of the JAX package's own kernel tests. Scores agree
within rtol 1e-5 (one f32 product summed in another order) and indices
exactly. ``test_torch_topk_kernel.py`` holds the CUDA kernel against the
plain version on the same cases.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_topk_kernel import CASES, case
from twotowers_tpu.kernels.pallas_topk import score_topk_pallas
from twotowers_tpu.ops.topk_score import score_topk_xla
from twotowers_tpu_torch.ops import topk_score
from twotowers_tpu_torch.ops.topk_score import score_topk, score_topk_reference


def _jax_paths(docs, queries, k, n_docs):
    d, q = jnp.asarray(docs), jnp.asarray(queries)
    out = {"xla": score_topk_xla(d, q, k, n_docs)}
    if docs.shape[0] >= 256:
        out["pallas"] = score_topk_pallas(d, q, k, n_docs, tile_n=128, interpret=True)
    return out


@pytest.mark.parametrize("name", CASES)
def test_cpu_path_matches_jax(name):
    docs, queries, k, n_docs = case(name)
    got_s, got_i = score_topk(torch.from_numpy(docs), torch.from_numpy(queries), k, n_docs)
    assert got_s.dtype == torch.float32 and got_i.dtype == torch.int32
    assert got_s.shape == got_i.shape == (queries.shape[0], k)
    for path, (want_s, want_i) in _jax_paths(docs, queries, k, n_docs).items():
        np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), rtol=1e-5,
                                   err_msg=path)
        np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i), err_msg=path)
    if name == "n_docs":
        assert got_i.max() < 300
    if name in ("ties", "zero-query"):  # equal scores go to the lower index
        np.testing.assert_array_equal(got_i.numpy(), np.tile(np.arange(k), (len(queries), 1)))


def test_bf16_docs_cast_queries_like_pallas(np_rng):
    docs = np_rng.normal(size=(512, 32)).astype(np.float32)
    queries = np_rng.normal(size=(3, 32)).astype(np.float32)
    got_s, got_i = score_topk_reference(torch.from_numpy(docs).bfloat16(),
                                        torch.from_numpy(queries), 8)
    want_s, want_i = score_topk_pallas(jnp.asarray(docs, jnp.bfloat16), jnp.asarray(queries),
                                       8, tile_n=128, interpret=True)
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), rtol=1e-5)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))


@pytest.mark.parametrize("n,dim,k,route", [
    (1000, 128, 10, "kernel"), (1000, 128, 256, "kernel"), (300, 64, 300, "torch"),
    (1000, 128, 257, "torch"), (1000, 1025, 10, "torch"), (100, 16, 101, "torch"),
    (1, 8, 1, "kernel")])
def test_route_rule_on_the_card(monkeypatch, n, dim, k, route):
    """Off the CPU the route is chosen by shape before any launch: the
    kernel for 1 <= k <= min(256, N) and D <= 1024, else the torch route,
    counted apart. Tensors on the meta device stand in for the card's."""
    taken = []
    monkeypatch.setattr(topk_score, "score_topk_cuda", lambda *a: taken.append("kernel"))
    monkeypatch.setattr(topk_score, "score_topk_reference", lambda *a: taken.append("torch"))
    before = topk_score.TORCH_ROUTE_CALLS
    score_topk(torch.empty(n, dim, device="meta"), torch.empty(2, dim, device="meta"), k)
    assert taken == [route]
    assert topk_score.TORCH_ROUTE_CALLS == before + (route == "torch")


def test_torch_route_matches_jax_for_large_k(np_rng):
    """k = 300 > 256, the shape the kernel refuses: the torch route gives
    score_topk_xla's results."""
    docs = np_rng.normal(size=(700, 16)).astype(np.float32)
    queries = np_rng.normal(size=(3, 16)).astype(np.float32)
    got_s, got_i = topk_score.score_topk_torch(torch.from_numpy(docs), torch.from_numpy(queries),
                                               300, 650)
    want_s, want_i = score_topk_xla(jnp.asarray(docs), jnp.asarray(queries), 300, 650)
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), rtol=1e-5)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
