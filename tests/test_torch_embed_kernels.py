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
from twotowers_tpu_torch.models import embeddings
from twotowers_tpu_torch.kernels.scatter_add import (
    CHUNK, plan, scatter_add_rows, scatter_add_rows_reference, scatter_add_sorted, sort_ids)
from twotowers_tpu_torch.models.embeddings import Embedding, EmbeddingSpec, GatherScatterGrad


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


F32, BF16 = torch.float32, torch.bfloat16
PAIRS = [(F32, F32), (F32, BF16), (BF16, F32), (BF16, BF16)]
# dim -> (elems, lanes) of an aligned f32 -> f32 plan, then of a pair with a
# bf16 side: a lane's store is 16 bytes where D is a multiple of its columns
GATHER_PLANS = {1: ((1, 1), (1, 1)), 3: ((1, 4), (1, 4)), 12: ((4, 4), (4, 4)),
                50: ((2, 32), (2, 32)), 64: ((4, 16), (8, 8)), 130: ((2, 32), (2, 32)),
                300: ((4, 32), (4, 32)), 1024: ((4, 32), (8, 32))}
# dim -> lanes with the table one element off 16-byte alignment: one column a lane
GATHER_LANES_OFF = {1: 1, 3: 4, 12: 16, 50: 32, 64: 32, 130: 32, 300: 32, 1024: 32}


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("table_dtype,out_dtype", PAIRS)
@pytest.mark.parametrize("dim", sorted(GATHER_PLANS))
def test_gather_plan(dim, table_dtype, out_dtype, aligned):
    """The gather's launch plan, on the CPU: columns a lane, lanes a row,
    the load and store widths, rows in flight and the grid of a word-step
    lookup (1,048,576 ids on 132 SMs)."""
    n, sm_count = 1_048_576, 132
    table_ptr = 0 if aligned else table_dtype.itemsize  # one element off 16 bytes
    p = gather.plan(n, dim, table_dtype, out_dtype, table_ptr, 256, sm_count)
    if aligned:
        elems, lanes = GATHER_PLANS[dim][table_dtype != out_dtype or table_dtype == BF16]
    else:
        elems, lanes = 1, GATHER_LANES_OFF[dim]
    assert (p.elems, p.lanes) == (elems, lanes)
    assert (p.load_bytes, p.store_bytes) == (elems * table_dtype.itemsize,
                                             elems * out_dtype.itemsize)
    rows = min(4, lanes)  # no more rows than lanes: a tile's ids are one warp's load
    assert p.rows == rows and p.tile_rows == 32 // lanes * rows <= 32
    assert p.blocks == sm_count * gather.BLOCKS_PER_SM  # a full card of blocks, striding


def test_gather_plan_widths_at_the_lookup_shapes():
    """f32 -> bf16 at D=64: two 16-byte loads into one 16-byte store; f32 ->
    f32 at D=300: 16 bytes each way, 75 slabs over 32 lanes; bf16 -> f32: one
    16-byte load, 32 bytes stored; an output 8 bytes off halves the slab."""
    word = gather.plan(1_048_576, 64, F32, BF16, 0, 0, 132)
    assert (word.elems, word.load_bytes, word.store_bytes, word.lanes) == (8, 32, 16, 8)
    pretrained = gather.plan(4096, 300, F32, F32, 0, 0, 132)
    assert (pretrained.elems, pretrained.load_bytes, pretrained.lanes) == (4, 16, 32)
    widen = gather.plan(4096, 64, BF16, F32, 0, 0, 132)
    assert (widen.load_bytes, widen.store_bytes) == (16, 32)
    out_off = gather.plan(4096, 64, F32, BF16, 0, 8, 132)
    assert (out_off.elems, out_off.store_bytes) == (4, 8)
    # the C entry's code: elems, log2 lanes and rows, then the dtypes' bits
    assert word.code == 8 | 3 << 4 | 4 << 8
    assert pretrained.code | gather.dtype_bits(F32, F32) == 4 | 5 << 4 | 1 << 8
    assert gather.dtype_bits(BF16, F32) == 1 << 16 and gather.dtype_bits(F32, BF16) == 1 << 17


@pytest.mark.parametrize("n,dim,pair,rows,blocks", [
    (4096, 300, (F32, F32), 1, 512),     # the pretrained batch: 4,096 tiles of a row
    (2048, 64, (F32, BF16), 1, 64),      # one serving encode: 512 tiles of 4 rows
    (524_288, 64, (F32, BF16), 4, 528),  # a model rank's shard of the word step
    (1, 64, (BF16, BF16), 1, 1),         # one row: one block
    (67_568, 64, (F32, BF16), 2, 528),   # 4,223 tiles of 16 rows: one short of the card
    (67_584, 64, (F32, BF16), 4, 528),   # 4,224 tiles of 16 rows fill the card's warps
    (16_896, 1, (F32, F32), 1, 66),      # one-lane teams: 528 tiles of 32 rows
    (9_000, 8, (F32, F32), 1, 71),       # two-lane teams: 563 tiles of 16 rows
])
def test_gather_plan_rows_in_flight_and_grid(n, dim, pair, rows, blocks):
    """The most rows in flight (4, 2, 1, at most the team's lanes) whose
    tiles fill every warp the card holds, else 1; a warp a tile, blocks of 8
    warps up to a full card."""
    p = gather.plan(n, dim, *pair, 0, 0, 132)
    assert (p.rows, p.blocks) == (rows, blocks)
    assert p.rows in gather.ROWS


@pytest.mark.parametrize("table_shape,ids,table_dtype,out_dtype,match", [
    ((16, 4), torch.zeros(8, dtype=torch.int64), F32, F32, "ids must be int32"),
    ((16, 4), torch.zeros(8, dtype=torch.int32), torch.float16, F32, "float32 or bfloat16"),
    ((16, 4), torch.zeros(8, dtype=torch.int32), F32, torch.float16, "float32 or bfloat16"),
    ((16,), torch.zeros(8, dtype=torch.int32), F32, F32, r"table must be \(V, D\)"),
    ((16, 4), torch.zeros((2, 4), dtype=torch.int32), F32, F32, r"table must be \(V, D\)"),
    ((16, 4), torch.zeros(0, dtype=torch.int32), F32, F32, "1 <= N < 2\\*\\*31"),
    ((16, 0), torch.zeros(8, dtype=torch.int32), F32, F32, "non-empty"),
    ((16, 4), torch.zeros(8, dtype=torch.int32), F32, F32, "one CUDA device"),
])
def test_gather_rejects_what_the_kernel_does_not_take(table_shape, ids, table_dtype, out_dtype,
                                                      match):
    """The wrapper's checks keep their refusals and messages."""
    with pytest.raises(ValueError, match=match):
        gather.check_args(torch.zeros(table_shape, dtype=table_dtype), ids, out_dtype)


def _counting_apply(monkeypatch):
    calls = []
    apply = GatherScatterGrad.apply

    def counted(*args):
        calls.append(1)
        return apply(*args)

    monkeypatch.setattr(GatherScatterGrad, "apply", counted)
    return calls


@pytest.mark.parametrize("mode,node", [("grad", True), ("no_grad", False),
                                       ("inference_mode", False), ("frozen table", False)])
def test_lookup_without_a_gradient_calls_the_gather_directly(monkeypatch, mode, node):
    """Under no_grad or inference_mode, or for a table that wants no
    gradient, the lookup calls ``embeddings.gather_rows`` directly, with the
    gradient path's bits and no ``GatherScatterGrad`` node; with a gradient
    it goes through the autograd Function."""
    rng = np.random.default_rng(5)
    spec = EmbeddingSpec(kind="lookup", vocab_size=700, embedding_dim=12,
                         trainable=mode != "frozen table")
    module = Embedding(spec)
    with torch.no_grad():
        module.table.copy_(torch.from_numpy(rng.normal(size=(700, 12)).astype(np.float32)))
    ids = torch.from_numpy(rng.integers(0, 700, size=(3, 7)).astype(np.int64))
    want = GatherScatterGrad.apply(module.table.detach(), ids, torch.bfloat16)
    calls = _counting_apply(monkeypatch)
    gathers = []
    direct = embeddings.gather_rows
    monkeypatch.setattr(embeddings, "gather_rows",
                        lambda *args: gathers.append(1) or direct(*args))
    if mode == "no_grad":
        with torch.no_grad():
            out = module(ids, torch.bfloat16)
    elif mode == "inference_mode":
        with torch.inference_mode():
            out = module(ids, torch.bfloat16)
    else:
        out = module(ids, torch.bfloat16)
    assert (len(calls), len(gathers)) == (int(node), 1)
    assert (out.grad_fn is not None) == node and out.requires_grad == node
    assert out.shape == (3, 7, 12) and out.dtype == torch.bfloat16
    assert torch.equal(out.detach(), want)


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
@pytest.mark.parametrize("n", [1, 31, 5003])
@pytest.mark.parametrize("dim", [1, 3, 12, 32, 50, 64, 130, 300, 1024])
@pytest.mark.parametrize("table_dtype,out_dtype", PAIRS)
def test_gather_kernel_is_bit_equal(cuda, dim, table_dtype, out_dtype, n):
    rng = np.random.default_rng(1)
    table = torch.from_numpy(rng.normal(size=(700, dim)).astype(np.float32)).to(cuda, table_dtype)
    ids = torch.from_numpy(rng.integers(0, 700, size=n).astype(np.int32)).to(cuda)
    before = gather.LAUNCHES
    got = gather_rows(table, ids, out_dtype)
    torch.cuda.synchronize()
    assert gather.LAUNCHES == before + 1
    assert got.dtype == out_dtype
    assert torch.equal(got, gather_rows_reference(table, ids, out_dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("dim", [64, 300])
@pytest.mark.parametrize("out_dtype", [F32, BF16])
def test_gather_kernel_takes_a_table_off_alignment(cuda, dim, out_dtype):
    """A table view 4 bytes off 16-byte alignment: one column a lane."""
    rng = np.random.default_rng(4)
    storage = torch.from_numpy(rng.normal(size=700 * dim + 1).astype(np.float32)).to(cuda)
    table = storage[1:].view(700, dim)
    assert table.data_ptr() % 16 == 4
    assert gather.plan(5003, dim, F32, out_dtype, table.data_ptr(), 0, 132).elems == 1
    ids = torch.from_numpy(rng.integers(-5, 705, size=5003).astype(np.int32)).to(cuda)
    before = gather.LAUNCHES
    got = gather_rows(table, ids, out_dtype)
    torch.cuda.synchronize()
    assert gather.LAUNCHES == before + 1
    assert torch.equal(got, gather_rows_reference(table, ids, out_dtype))


@pytest.mark.cuda
def test_gather_kernel_writes_an_output_past_2_31_elements(cuda):
    """33,554,439 ids x 64 bf16: 2**31 + 448 output elements (4.3 GB), so
    the output's addresses need more than 31 bits."""
    n, dim = 2**25 + 7, 64
    gen = torch.Generator(device=cuda).manual_seed(6)
    table = torch.randn(32_768, dim, device=cuda, generator=gen)
    ids = torch.randint(-3, 32_771, (n,), device=cuda, generator=gen, dtype=torch.int32)
    before = gather.LAUNCHES
    got = gather_rows(table, ids, BF16)
    torch.cuda.synchronize()
    assert gather.LAUNCHES == before + 1 and got.numel() >= 2**31
    assert torch.equal(got, gather_rows_reference(table, ids, BF16))


@pytest.mark.cuda
@pytest.mark.parametrize("table_dtype,out_dtype", PAIRS)
def test_gather_kernels_hold_the_planned_blocks(cuda, table_dtype, out_dtype):
    """Every build of the kernel fits the BLOCKS_PER_SM blocks an SM that
    the plan's grid counts on."""
    for elems in (8, 4, 2, 1):
        if elems * min(table_dtype.itemsize, out_dtype.itemsize) > 16:
            continue
        for rows in gather.ROWS:
            p = gather.Plan(elems=elems, lanes=8, rows=rows, blocks=1, load_bytes=0,
                            store_bytes=0)
            assert gather.occupancy(table_dtype, out_dtype, p) >= gather.BLOCKS_PER_SM


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
