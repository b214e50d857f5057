"""The score + top-k CUDA kernel's wrapper, held against its plain version.

This file imports no JAX, so it also runs on a machine with a card and
without JAX. There the repo's conftest (which imports JAX) is left out:

    python -m pytest --noconftest tests/test_torch_topk_kernel.py -q

The tests marked ``cuda`` skip where there is no card. Scores agree within
rtol 1e-5, atol 1e-6 (f32 sums in another order than cuBLAS's), indices
exactly: the seeded cases have no near-ties. ``test_torch_topk.py`` holds
the plain version against the JAX package on the same cases.
"""

import numpy as np
import pytest
import torch

from twotowers_tpu_torch.kernels import topk
from twotowers_tpu_torch.ops.topk_score import score_topk, score_topk_reference


def case(name, seed=0):
    """(docs, queries, k, n_docs) for a named case, from a numpy seed."""
    rng = np.random.default_rng(seed)
    normal = lambda *shape: rng.normal(size=shape).astype(np.float32)  # noqa: E731
    if name.startswith("random"):
        n, q, dim, k = {"random-512": (512, 4, 32, 5), "random-1024": (1024, 16, 64, 10),
                        "random-ragged": (700, 3, 16, 7), "random-small": (100, 2, 8, 5)}[name]
        return normal(n, dim), normal(q, dim), k, None
    if name == "n_docs":
        docs = normal(512, 16)
        docs[300:] = 50.0  # rows past n_docs carry huge scores
        return docs, normal(2, 16), 5, 300
    if name == "ties":
        docs = np.zeros((512, 8), np.float32)
        docs[:, 0] = 1.0  # every doc scores identically
        queries = np.zeros((2, 8), np.float32)
        queries[:, 0] = 1.0
        return docs, queries, 4, 512
    if name == "zero-query":  # a text of out-of-vocabulary characters
        return normal(300, 16), np.zeros((1, 16), np.float32), 6, None
    if name == "k1":
        return normal(400, 16), normal(3, 16), 1, None
    if name == "k-eq-n":
        return normal(256, 16), normal(2, 16), 256, None
    raise KeyError(name)


CASES = ["random-512", "random-1024", "random-ragged", "random-small", "n_docs", "ties",
         "zero-query", "k1", "k-eq-n"]


@pytest.mark.parametrize("shape,k,dtype,match", [
    ((64, 8), 257, torch.float32, "k <= min"),
    ((64, 8), 65, torch.float32, "k <= min"),
    ((64, 8), 0, torch.float32, "k <= min"),
    ((64, 1025), 5, torch.float32, "D <= 1024"),
    ((64, 8), 5, torch.float16, "float32 or bfloat16"),
])
def test_kernel_limits_raise(shape, k, dtype, match):
    docs = torch.zeros(shape, dtype=dtype)
    with pytest.raises(ValueError, match=match):
        topk.score_topk_cuda(docs, torch.zeros(2, shape[1]), k)


def test_kernel_refuses_cpu_tensors():
    """The wrapper never hands a call to the plain version."""
    before = topk.LAUNCHES
    with pytest.raises(ValueError, match="CUDA device"):
        topk.score_topk_cuda(torch.zeros(64, 8), torch.zeros(2, 8), 5)
    assert topk.LAUNCHES == before


@pytest.mark.parametrize("q,n", [(1, 1_000_000), (32, 1_000_000), (256, 1_000_000),
                                 (256, 999_983), (3, 1000), (5000, 200), (1, 1)])
def test_plan_fills_the_card_and_covers_the_docs(q, n):
    rows, n_splits, split_len = topk.plan(q, n, sm_count=132)
    q_blocks = -(-q // (4 * rows))
    assert rows == (1 if q <= 4 else 8)
    assert split_len % topk.TILE_N == 0
    assert (n_splits - 1) * split_len < n <= n_splits * split_len
    assert 1 <= n_splits <= topk.MAX_SPLITS
    # enough blocks for every SM, unless the docs run out of tiles first
    assert q_blocks * n_splits >= min(132, q_blocks * -(-n // topk.TILE_N))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_matches_plain_version(cuda, name, dtype):
    docs, queries, k, n_docs = case(name)
    docs = torch.from_numpy(docs).to(cuda, dtype)
    queries = torch.from_numpy(queries).to(cuda)
    before = topk.LAUNCHES
    got_s, got_i = score_topk(docs, queries, k, n_docs)
    torch.cuda.synchronize()
    assert topk.LAUNCHES == before + 1
    want_s, want_i = score_topk_reference(docs, queries, k, n_docs)
    torch.testing.assert_close(got_s, want_s, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(got_i, want_i, rtol=0, atol=0)
