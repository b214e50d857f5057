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


PLAN_CASES = [(1, 1_000_000), (32, 1_000_000), (256, 1_000_000), (256, 999_983), (3, 1000),
              (5000, 200), (1, 1)]
PLAN_CASES += [(q, n) for q in (5, 31, 33, 64, 255, 257, 5000)
               for n in (1_000_000, 999_983, 200) if (q, n) not in PLAN_CASES]


@pytest.mark.parametrize("q,n", PLAN_CASES)
def test_plan_fills_the_card_and_covers_the_docs(q, n):
    rows, n_splits, split_len = topk.plan(q, n, sm_count=132, blocks_per_sm=2)
    tile = topk.STREAM_ROWS if q <= 4 else topk.BATCH_TILE_N
    q_blocks = -(-q // (4 * rows))
    assert rows == (1 if q <= 4 else 8)
    assert split_len % tile == 0
    assert (n_splits - 1) * split_len < n <= n_splits * split_len
    assert 1 <= n_splits <= topk.MAX_SPLITS
    # enough blocks for every SM, unless the docs run out of tiles first
    assert q_blocks * n_splits >= min(132, q_blocks * -(-n // tile))


@pytest.mark.parametrize("q,blocks_per_sm,splits", [(256, 1, 17), (256, 2, 33), (256, 3, 50),
                                                     (256, 4, 66), (33, 3, 196), (5, 3, 391)])
def test_plan_gives_a_batch_one_wave_of_splits(q, blocks_per_sm, splits):
    """About as many splits as put ``blocks_per_sm`` blocks of 32 queries on
    each of 132 SMs at once: one wave, short of a query block at most."""
    rows, n_splits, split_len = topk.plan(q, 1_000_000, 132, blocks_per_sm)
    q_blocks = -(-q // 32)
    assert (rows, n_splits) == (8, splits)
    assert q_blocks * n_splits < 132 * blocks_per_sm + q_blocks
    assert split_len == -(-(-(-1_000_000 // 256)) // splits) * 256


@pytest.mark.parametrize("q", [1, 2, 3, 4])
def test_plan_of_up_to_four_queries_ignores_the_batch_occupancy(q):
    """Q <= 4 takes the streaming pass (rows_per_thread 1, all the queries in
    one block), never the batch pass's tiles of 256: its plan follows only
    the blocks per SM it is given, the same for every Q up to 4."""
    for blocks in (1, 2, 5):
        want = topk.plan(1, 1_000_000, 132, blocks)
        assert topk.plan(q, 1_000_000, 132, blocks) == want
        assert want[0] == 1 and want[2] % topk.STREAM_ROWS == 0


STREAM_PLAN_CASES = [(q, n, blocks) for q in (1, 2, 3, 4)
                     for n in (1, 127, 1_000_000, 999_983) for blocks in (1, 2, 4)]


@pytest.mark.parametrize("q,n,blocks", STREAM_PLAN_CASES)
def test_plan_of_a_single_search_makes_one_wave_of_splits(q, n, blocks):
    """The splits cover the docs, stay within pass 2's ``MAX_SPLITS`` and
    make about one wave: no more blocks than fit on 132 SMs at once, and at
    1M docs within 3% of them, so pass 2 merges a few hundred lists."""
    rows, n_splits, split_len = topk.plan(q, n, 132, blocks)
    tiles = -(-n // topk.STREAM_ROWS)
    wave = min(132 * blocks, tiles)
    assert rows == 1 and split_len % topk.STREAM_ROWS == 0
    assert (n_splits - 1) * split_len < n <= n_splits * split_len
    assert 1 <= n_splits <= topk.MAX_SPLITS
    assert n_splits <= wave and 2 * n_splits > wave
    if n >= 1_000_000:
        assert n_splits >= 0.97 * wave


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


EDGE_CASES = [(q, dim, dtype, k, off) for q in (5, 33, 257) for dim in (1, 100, 129, 1024)
              for dtype in (torch.float32, torch.bfloat16) for k in (1, 64, 256)
              for off in (-1, 1)]


@pytest.mark.cuda
@pytest.mark.parametrize("q,dim,dtype,k,off", EDGE_CASES)
def test_batch_kernel_crosses_tile_edges(cuda, q, dim, dtype, k, off):
    """The Q >= 5 pass at N = 256 m +- 1 (a ragged last tile), D across the
    16-deep chunks (D=100 in bf16 and D=1, 129 take the scalar staging),
    k up to 256. Integer-valued inputs sum exactly in any order, so scores
    and indices equal the plain version's to the bit, ties included."""
    gen = torch.Generator(device=cuda).manual_seed(q * 7919 + dim * 31 + k)
    n = 256 * (150 if dim == 1024 else 600) + off
    docs = torch.randint(-2, 3, (n, dim), device=cuda, generator=gen).to(dtype)
    queries = torch.randint(-2, 3, (q, dim), device=cuda, generator=gen).float()
    before = topk.LAUNCHES
    got_s, got_i = score_topk(docs, queries, k)
    torch.cuda.synchronize()
    assert topk.LAUNCHES == before + 1
    want_s, want_i = score_topk_reference(docs, queries, k)
    assert torch.equal(got_s, want_s)
    assert torch.equal(got_i, want_i)


@pytest.mark.cuda
@pytest.mark.parametrize("q", [5, 257])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_batch_kernel_masks_rows_past_n_docs(cuda, q, dtype):
    gen = torch.Generator(device=cuda).manual_seed(q)
    docs = torch.randint(-2, 3, (256 * 40 + 1, 64), device=cuda, generator=gen).to(dtype)
    docs[5000:] = 50  # rows past n_docs would win if not masked
    queries = torch.ones(q, 64, device=cuda)
    got = score_topk(docs, queries, 64, 5000)
    want = score_topk_reference(docs, queries, 64, 5000)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert int(got[1].max()) < 5000


def _split_len(cuda, q, n, dtype, dim, k):
    """The split length of the Q <= 4 pass for this call on the card."""
    per_sm = topk.stream_occupancy(cuda, dtype, q, dim, k)["blocks_per_sm"]
    sm_count = torch.cuda.get_device_properties(cuda).multi_processor_count
    return topk.plan(q, n, sm_count, per_sm)[2]


def _bit_equal(docs, queries, k, n_docs=None):
    before = topk.LAUNCHES
    got_s, got_i = score_topk(docs, queries, k, n_docs)
    torch.cuda.synchronize()
    assert topk.LAUNCHES == before + 1
    want_s, want_i = score_topk_reference(docs, queries, k, n_docs)
    assert torch.equal(got_s, want_s)
    assert torch.equal(got_i, want_i)
    return got_s, got_i


STREAM_EDGE_CASES = [(q, dim, dtype, k, off) for q in (1, 4) for dim in (1, 100, 128, 1024)
                     for dtype in (torch.float32, torch.bfloat16) for k in (1, 64, 256)
                     for off in (-1, 1)]


@pytest.mark.cuda
@pytest.mark.parametrize("q,dim,dtype,k,off", STREAM_EDGE_CASES)
def test_stream_kernel_crosses_split_edges(cuda, q, dim, dtype, k, off):
    """The Q <= 4 pass at N = split_len m +- 1 (a last split one row long or
    one row short), D=1 and 100 on the scalar fill in bf16 (D=1 in f32
    too), D=1024 in several 128-column passes, k up to 256. Integer-valued
    inputs sum exactly in any order, so scores and indices equal the plain
    version's to the bit, ties included."""
    gen = torch.Generator(device=cuda).manual_seed(q * 7919 + dim * 31 + k)
    base = topk.STREAM_ROWS * (150 if dim == 1024 else 600)
    split_len = _split_len(cuda, q, base, dtype, dim, k)
    n = split_len * -(-base // split_len) + off
    docs = torch.randint(-2, 3, (n, dim), device=cuda, generator=gen).to(dtype)
    queries = torch.randint(-2, 3, (q, dim), device=cuda, generator=gen).float()
    _bit_equal(docs, queries, k)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 5, 63, 64, 65, 127, 129])
@pytest.mark.parametrize("q", [1, 4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_stream_kernel_takes_fewer_docs_than_one_iteration(cuda, n, q, dtype):
    """N below one block iteration's rows (64 f32, 128 bf16), and just past."""
    gen = torch.Generator(device=cuda).manual_seed(n)
    docs = torch.randint(-2, 3, (n, 128), device=cuda, generator=gen).to(dtype)
    queries = torch.randint(-2, 3, (q, 128), device=cuda, generator=gen).float()
    _bit_equal(docs, queries, min(5, n))


@pytest.mark.cuda
@pytest.mark.parametrize("q", [1, 3])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_stream_kernel_masks_rows_past_n_docs(cuda, q, dtype):
    gen = torch.Generator(device=cuda).manual_seed(q)
    docs = torch.randint(-2, 3, (256 * 40 + 1, 64), device=cuda, generator=gen).to(dtype)
    docs[5000:] = 50  # rows past n_docs would win if not masked
    got = _bit_equal(docs, torch.ones(q, 64, device=cuda), 64, 5000)
    assert int(got[1].max()) < 5000


@pytest.mark.cuda
@pytest.mark.parametrize("offset", ["row", "element"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_stream_kernel_reads_docs_off_alignment(cuda, offset, dtype):
    """A docs view one row (D=100: 400 or 200 bytes) or one element past the
    start of its storage. bf16 at D=100 and any view one element off take
    the scalar fill; f32 one row off stays 16-byte aligned."""
    gen = torch.Generator(device=cuda).manual_seed(7)
    n, dim = 50_001, 100
    skip = dim if offset == "row" else 1
    storage = torch.randint(-2, 3, ((n + 1) * dim,), device=cuda, generator=gen).to(dtype)
    docs = storage[skip:skip + n * dim].view(n, dim)
    queries = torch.randint(-2, 3, (2, dim), device=cuda, generator=gen).float()
    _bit_equal(docs, queries, 10)


@pytest.mark.cuda
@pytest.mark.parametrize("q,k", [(1, 256), (4, 256), (2, 10)])
def test_stream_kernel_breaks_ties_to_the_lower_index(cuda, q, k):
    """Every score ties (or every query is zero): the first k docs, in order."""
    docs = torch.zeros(8192, 16, device=cuda)
    docs[:, 0] = 1.0
    queries = torch.zeros(q, 16, device=cuda)
    if k == 256:
        queries[:, 0] = 1.0
    _, got_i = _bit_equal(docs, queries, k)
    assert torch.equal(got_i.cpu(), torch.arange(k, dtype=torch.int32).repeat(q, 1))
