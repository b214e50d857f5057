"""The embedding kernels' wrappers (scatter-add and gather), held against
their plain versions.

This file imports no JAX, so it also runs on a machine with a card and
without JAX. There the repo's conftest (which imports JAX) is left out:

    python -m pytest --noconftest tests/test_torch_embed_kernels.py -q

The tests marked ``cuda`` skip where there is no card. Tolerances: the
scatter-add sums f32 in another order than the plain ``index_add_``, which
on the card adds by atomics in an order that changes from run to run (up
to 20,000 rows into one here), so each element is held within
``1e-5 * sum(|g|) + 1e-6`` of its row, a bound that scales as the rounding
of either order does; integer-valued g sums exactly in any order, so it is
bit-equal, and the kernel gives the same bits on every run. The gather
moves bits, so it is bit-equal. ``test_torch_scatter_add.py`` holds the
plain versions against the JAX package on the same cases, with the JAX
tests' tolerances.
"""

import numpy as np
import pytest
import torch

from twotowers_tpu_torch.kernels import gather, scatter_add
from twotowers_tpu_torch.kernels.gather import gather_rows, gather_rows_reference
from twotowers_tpu_torch.kernels.scatter_add import (
    CHUNK, plan, scatter_add_rows, scatter_add_rows_reference, scatter_add_sorted, sort_ids)
from twotowers_tpu_torch.models.embeddings import GatherScatterGrad


def scatter_case(name, seed=0):
    """(g float32, ids int32, vocab, rtol) for a named case, from a numpy
    seed: the cases of the JAX package's scatter-add tests, and three more."""
    rng = np.random.default_rng(seed)
    shapes = {  # vocab, dim, n
        "v640-d64": (640, 64, 4096),       # one run per id, many ids
        "ragged-n": (640, 64, 5000),       # n not a multiple of any tile
        "d32-v130": (130, 32, 4096),       # dim below one warp's 64 columns
        "d128": (1024, 128, 4096),         # two column blocks
        "v612": (30522 % 997, 64, 4096),   # vocab not 8-aligned
        "v30522": (30522, 64, 4096),       # BERT-sized, unaligned vocab
        "d130": (640, 130, 4096),          # a ragged third column block
        "geometric": (640, 64, 4096),      # duplicate-heavy, Zipf-like
        "all-equal": (640, 64, 20000),     # one run across many chunks
        "integer": (640, 64, 4096),        # integer-valued g: exact sums
    }
    vocab, dim, n = shapes[name]
    if name == "geometric":
        ids = np.minimum(rng.geometric(0.3, size=n) - 1, vocab - 1)
    elif name == "all-equal":
        ids = np.full(n, 7)
    else:
        ids = rng.integers(0, vocab, size=n)
    if name == "integer":
        g = rng.integers(-3, 4, size=(n, dim)).astype(np.float32)
    else:
        g = rng.normal(size=(n, dim)).astype(np.float32)
    rtol = 1e-4 if name in ("geometric", "all-equal") else 1e-5
    return g, ids.astype(np.int32), vocab, rtol


SCATTER_CASES = ["v640-d64", "ragged-n", "d32-v130", "d128", "v612", "v30522", "d130",
                 "geometric", "all-equal", "integer"]


def kernel_path_case(name, seed=0):
    """(g float32, ids int32, vocab, storage offset of g) for the cases that
    reach the redesigned kernel's paths: runs whose lengths straddle a
    chunk, N below one chunk, N = 1, ids outside [0, V) inside runs that
    cross chunks, and a g 2 or 4 bytes off 16-byte alignment (the scalar
    loads). The rows' order is shuffled, so the sort's perm is not the
    identity."""
    rng = np.random.default_rng(seed)
    vocab, dim, offset = 97, 64, 0
    run = {"run chunk-1": CHUNK - 1, "run chunk": CHUNK, "run chunk+1": CHUNK + 1,
           "run 3chunk+5": 3 * CHUNK + 5}
    if name in run:  # a 7-row run first, so the runs start off the chunk grid too
        ids = np.concatenate([np.full(7, 3)] + [np.full(run[name], i) for i in range(5, 17)])
    elif name == "n < chunk":
        ids = rng.integers(0, 8, size=CHUNK // 2 + 3)
    elif name == "n = 1":
        ids = np.array([5])
    elif name == "out of range in crossing runs":
        ids = np.concatenate([np.full(3 * CHUNK, -4), np.full(2 * CHUNK + 9, vocab),
                              np.full(CHUNK + 1, vocab + 7), rng.integers(0, vocab, 900),
                              np.full(CHUNK * 2, 11)])
    elif name == "misaligned g":
        ids, offset = rng.integers(0, vocab, size=3000), 1
        ids[:700] = 4
    ids = rng.permutation(ids).astype(np.int32)
    g = rng.normal(size=(len(ids), dim)).astype(np.float32)
    return g, ids, vocab, offset


KERNEL_PATH_CASES = ["run chunk-1", "run chunk", "run chunk+1", "run 3chunk+5", "n < chunk",
                     "n = 1", "out of range in crossing runs", "misaligned g"]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


# ---- the wrappers' checks, on the CPU -----------------------------------------

@pytest.mark.parametrize("g_shape,ids_dtype,g_dtype,match", [
    ((8, 4), torch.int64, torch.float32, "ids must be int32"),
    ((8, 4), torch.int32, torch.float16, "float32 or bfloat16"),
    ((8,), torch.int32, torch.float32, r"g must be \(N, D\)"),
])
def test_scatter_add_rejects_what_the_kernel_does_not_take(g_shape, ids_dtype, g_dtype, match):
    with pytest.raises(ValueError, match=match):
        scatter_add.check_args(torch.zeros(g_shape, dtype=g_dtype),
                               torch.zeros(8, dtype=ids_dtype), 16, torch.float32)


def test_kernel_wrappers_refuse_cpu_tensors():
    """The kernel entry never hands a call to the plain version."""
    before = (scatter_add.LAUNCHES, gather.LAUNCHES)
    ids = torch.zeros(8, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA device"):
        scatter_add_sorted(torch.zeros(8, 4), *sort_ids(ids), 16)
    with pytest.raises(ValueError, match="CUDA device"):
        gather.check_args(torch.zeros(16, 4), ids, torch.float32)
    assert (scatter_add.LAUNCHES, gather.LAUNCHES) == before


def test_cpu_tensors_take_the_plain_versions():
    g = torch.ones(6, 3)
    ids = torch.tensor([0, 2, 2, 5, 5, 5], dtype=torch.int32)
    before = (scatter_add.LAUNCHES, gather.LAUNCHES)
    out = scatter_add_rows(g, ids, 7, torch.bfloat16)
    assert out.dtype == torch.bfloat16
    assert out[:, 0].tolist() == [1, 0, 2, 0, 0, 3, 0]
    table = torch.arange(21, dtype=torch.float32).reshape(7, 3)
    assert torch.equal(gather_rows(table, ids), table[ids.long()])
    assert (scatter_add.LAUNCHES, gather.LAUNCHES) == before


@pytest.mark.parametrize("dim,dtype,ptr,vector,team_lanes", [
    (64, torch.bfloat16, 0, True, 8),     # the train path: a 128-byte row, 4 teams a warp
    (64, torch.float32, 0, True, 16),     # #4/#5's f32 g: 256 bytes, 2 teams a warp
    (64, torch.bfloat16, 2, False, 8),    # g 2 bytes off alignment: scalar loads
    (32, torch.float32, 16, True, 8),
    (130, torch.bfloat16, 0, False, 32),  # 260 bytes: not a multiple of 16
    (130, torch.float32, 0, False, 32),   # 33 slabs: two column blocks of 32 lanes
    (1024, torch.bfloat16, 0, True, 32),
    (1, torch.float32, 0, False, 1),      # 32 one-lane teams a warp
])
def test_scatter_add_plan(dim, dtype, ptr, vector, team_lanes):
    """The launch plan, on the CPU: which loads a shape and pointer take,
    the team shape, and the scratch the wrapper allocates."""
    n, sm_count = 1_048_576, 132
    p = plan(n, dim, dtype, ptr, sm_count)
    assert (p.vector, p.team_lanes) == (vector, team_lanes)
    assert p.chunk == CHUNK and p.n_chunks == -(-n // CHUNK)
    assert p.smem_bytes == p.warps * (2 * 32 // team_lanes * CHUNK + 2) * 4 <= 48 * 1024
    # a fixed pass-2 grid of 2,048 threads an SM, not one block a chunk
    assert p.span_blocks == 2048 // (32 * p.span_warps) * sm_count


def test_scatter_add_plan_edges():
    assert plan(1, 64, torch.bfloat16, 0, 132).span_blocks == 0  # one chunk: no pass 2
    assert plan(CHUNK + 1, 64, torch.bfloat16, 0, 132).span_blocks == 1
    main = plan(1_048_576, 64, torch.bfloat16, 0, 132)
    assert (main.n_chunks, main.warps, main.span_warps) == (8192, 8, 16)
    assert plan(100, 1, torch.float32, 0, 132).warps == 1  # 32 one-lane teams: 32 KB a warp


def test_kernel_path_cases_reach_their_paths():
    """The cases exist as named: misaligned g, runs that straddle a chunk,
    and out-of-range ids in runs longer than a chunk."""
    g, ids, vocab, offset = kernel_path_case("misaligned g")
    assert offset == 1 and not plan(len(ids), 64, torch.bfloat16, 2 * offset, 132).vector
    _, ids, _, _ = kernel_path_case("run chunk+1")
    assert np.bincount(ids)[5:17].tolist() == [CHUNK + 1] * 12
    _, ids, vocab, _ = kernel_path_case("out of range in crossing runs")
    assert (ids < 0).sum() > CHUNK and (ids >= vocab).sum() > 2 * CHUNK
    assert len(kernel_path_case("n = 1")[1]) == 1
    assert len(kernel_path_case("n < chunk")[1]) < CHUNK


def test_sort_ids_is_stable():
    ids = torch.tensor([3, 1, 3, 1, 0], dtype=torch.int32)
    sorted_ids, perm = sort_ids(ids)
    assert sorted_ids.tolist() == [0, 1, 1, 3, 3] and perm.tolist() == [4, 1, 3, 0, 2]
    assert perm.dtype == torch.int64


# ---- the kernels on the card --------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("name", SCATTER_CASES)
@pytest.mark.parametrize("g_dtype", [torch.float32, torch.bfloat16])
def test_scatter_add_kernel_matches_plain_version(cuda, name, g_dtype):
    g, ids, vocab, _ = scatter_case(name)
    g = torch.from_numpy(g).to(cuda, g_dtype)
    ids = torch.from_numpy(ids).to(cuda)
    before = scatter_add.LAUNCHES
    got = scatter_add_rows(g, ids, vocab)
    torch.cuda.synchronize()
    assert scatter_add.LAUNCHES == before + 1
    want = scatter_add_rows_reference(g, ids, vocab)
    if name == "integer":
        assert torch.equal(got, want)
    else:
        bound = 1e-5 * scatter_add_rows_reference(g.abs(), ids, vocab) + 1e-6
        assert bool(((got - want).abs() <= bound).all()), float((got - want).abs().max())
    assert torch.equal(scatter_add_rows(g, ids, vocab), got)  # the same bits every run


@pytest.mark.cuda
@pytest.mark.parametrize("name", KERNEL_PATH_CASES)
@pytest.mark.parametrize("g_dtype", [torch.float32, torch.bfloat16])
def test_scatter_add_kernel_paths_match_plain_version(cuda, name, g_dtype):
    g, ids, vocab, offset = kernel_path_case(name)
    flat = torch.from_numpy(g).to(cuda, g_dtype).reshape(-1)
    storage = torch.empty(flat.numel() + offset, dtype=g_dtype, device=cuda)
    storage[offset:] = flat
    g = storage[offset:].view(len(ids), -1)  # a contiguous view at this storage offset
    assert (g.data_ptr() % 16 == 0) == (offset == 0)
    ids = torch.from_numpy(ids).to(cuda)
    got = scatter_add_rows(g, ids, vocab)
    torch.cuda.synchronize()
    want = scatter_add_rows_reference(g, ids, vocab)
    bound = 1e-5 * scatter_add_rows_reference(g.abs(), ids, vocab) + 1e-6
    assert bool(((got - want).abs() <= bound).all()), float((got - want).abs().max())
    assert torch.equal(scatter_add_rows(g, ids, vocab), got)  # the same bits every run
    ints = torch.round(g.float() * 2).to(g_dtype)  # integer-valued: exact in any order
    assert torch.equal(scatter_add_rows(ints, ids, vocab),
                       scatter_add_rows_reference(ints, ids, vocab))


@pytest.mark.cuda
def test_scatter_add_kernel_writes_the_table_dtype(cuda):
    """A bf16 table receives its f32 sums rounded once to bf16."""
    g, ids, vocab, _ = scatter_case("v640-d64")
    g = torch.from_numpy(g).to(cuda, torch.bfloat16)
    ids = torch.from_numpy(ids).to(cuda)
    got = scatter_add_rows(g, ids, vocab, torch.bfloat16)
    want = scatter_add_rows_reference(g, ids, vocab, torch.bfloat16)
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got.float(), want.float(), rtol=8e-3, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("dim", [64, 130, 32])
@pytest.mark.parametrize("table_dtype,out_dtype", [
    (torch.float32, torch.float32), (torch.float32, torch.bfloat16),
    (torch.bfloat16, torch.float32), (torch.bfloat16, torch.bfloat16)])
def test_gather_kernel_is_bit_equal(cuda, dim, table_dtype, out_dtype):
    rng = np.random.default_rng(1)
    table = torch.from_numpy(rng.normal(size=(700, dim)).astype(np.float32)).to(cuda, table_dtype)
    ids = torch.from_numpy(rng.integers(0, 700, size=5003).astype(np.int32)).to(cuda)
    before = gather.LAUNCHES
    got = gather_rows(table, ids, out_dtype)
    torch.cuda.synchronize()
    assert gather.LAUNCHES == before + 1
    assert got.dtype == out_dtype
    assert torch.equal(got, gather_rows_reference(table, ids, out_dtype))


def test_gather_plain_version_reads_ids_outside_the_table_as_zero_rows():
    rng = np.random.default_rng(3)
    table = rng.normal(size=(70, 8)).astype(np.float32)
    ids = rng.integers(-140, 140, size=503).astype(np.int32)
    ids[:4] = [-1, 70, 2**31 - 1, -2**31]
    want = np.where(((ids >= 0) & (ids < 70))[:, None], table[np.clip(ids, 0, 69)], 0.0)
    got = gather_rows(torch.from_numpy(table), torch.from_numpy(ids), torch.float32)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.cuda
@pytest.mark.parametrize("table_dtype,out_dtype", [
    (torch.float32, torch.bfloat16), (torch.float32, torch.float32)])
def test_gather_kernel_reads_ids_outside_the_table_as_zero_rows(cuda, table_dtype, out_dtype):
    """A shard of the row-sharded lookup gets the ids other shards own as
    ids outside [0, V): negative ones, ones at V and past it."""
    rng = np.random.default_rng(3)
    table = torch.from_numpy(rng.normal(size=(700, 64)).astype(np.float32)).to(cuda, table_dtype)
    ids = rng.integers(-1400, 1400, size=5003).astype(np.int32)
    ids[:4] = [-1, 700, 2**31 - 1, -2**31]
    ids = torch.from_numpy(ids).to(cuda)
    got = gather_rows(table, ids, out_dtype)
    torch.cuda.synchronize()
    outside = (ids < 0) | (ids >= 700)
    assert int(outside.sum()) > 2500
    assert torch.equal(got, gather_rows_reference(table, ids, out_dtype))
    assert not bool(got[outside].any())
    assert torch.equal(got[~outside], table[ids[~outside].long()].to(out_dtype))


@pytest.mark.cuda
def test_lookup_function_on_the_card_matches_the_cpu(cuda):
    """GatherScatterGrad's value and table gradient on the card against its
    CPU path (the plain versions) on the same inputs."""
    rng = np.random.default_rng(2)
    table = rng.normal(size=(640, 16)).astype(np.float32)
    ids = rng.integers(0, 640, size=(8, 12)).astype(np.int32)
    weight = rng.normal(size=(8, 12, 16)).astype(np.float32)
    grads = []
    for device in ("cpu", cuda):
        tab = torch.from_numpy(table).to(device).requires_grad_()
        out = GatherScatterGrad.apply(tab, torch.from_numpy(ids).to(device), torch.float32)
        (out * torch.from_numpy(weight).to(device)).sum().backward()
        grads.append((out.detach().cpu(), tab.grad.cpu()))
    assert torch.equal(grads[0][0], grads[1][0])
    torch.testing.assert_close(grads[1][1], grads[0][1], rtol=1e-5, atol=1e-5)
