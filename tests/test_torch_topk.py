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
