"""The score + top-k CUDA kernel's wrapper, held against its plain version.

This file imports no JAX, so it also runs on a machine with a card and
without JAX. There the repo's conftest (which imports JAX) is left out:

    python -m pytest --noconftest tests/test_torch_topk_kernel.py -q

The tests marked ``cuda`` skip where there is no card. Scores agree within
rtol 1e-5, atol 1e-6 (f32 sums in another order than cuBLAS's), indices
exactly: the seeded cases have no near-ties; the float cases of the bf16
tensor-core pass at 1M-scale shapes are held by ``topk.agree``, which
allows near-ties. Integer-valued inputs sum exactly in any order and are
held bit for bit. ``test_torch_topk.py`` holds
the plain version against the JAX package on the same cases. Pass 2 alone
is held bit for bit against its plain merge on candidate lists from
``chip_smoke.crafted_lists``, which imports no JAX either.
"""

import math
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from chip_smoke import crafted_lists, sample_pairs_in_main
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
    if name in ("ties", "batch-ties"):
        q, k = (2, 4) if name == "ties" else (9, 200)  # Q >= 5: the batch pass at large k
        docs = np.zeros((512, 8), np.float32)
        docs[:, 0] = 1.0  # every doc scores identically
        queries = np.zeros((q, 8), np.float32)
        queries[:, 0] = 1.0
        return docs, queries, k, 512
    if name == "batch-large-k":  # Q >= 5 at k=256: the warps' selection
        return normal(1024, 32), normal(33, 32), 256, None
    if name == "zero-query":  # a text of out-of-vocabulary characters
        return normal(300, 16), np.zeros((1, 16), np.float32), 6, None
    if name == "k1":
        return normal(400, 16), normal(3, 16), 1, None
    if name == "k-eq-n":
        return normal(256, 16), normal(2, 16), 256, None
    raise KeyError(name)


CASES = ["random-512", "random-1024", "random-ragged", "random-small", "n_docs", "ties",
         "zero-query", "k1", "k-eq-n", "batch-large-k", "batch-ties"]


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


@pytest.mark.parametrize("k,nbytes", [(1, 37_888), (10, 40_192), (14, 41_216), (15, 50_304),
                                      (32, 54_656), (100, 72_832), (256, 113_792)])
def test_tiles_smem_counts_the_lists_of_the_selection_k_takes(k, nbytes):
    """The Q >= 5 pass's shared bytes (score_topk.cu's tiles_smem): the
    two staging buffers (37,376), then up to k = WIDE_K the narrow
    selection's 32 lists of k values and indices and two counts a query,
    above it the wide selection's 32 lists of values and indices and 32
    buffers of TILE_QUEUE, each with a padding word after every 32 pairs,
    then a bar (value, index) and a buffer count a query: 37,376 + 8 x 32
    x (256 + 8 + 32 + 1) + 12 x 32 at k=256."""
    assert topk.tiles_smem(k) == nbytes
    assert (k > topk.WIDE_K) == (k >= 15)


# the shared memory an H100 SM gives its blocks (228 KB), less 1 KB a block
SM_SHARED, BLOCK_RESERVED = 233_472, 1024


@pytest.mark.parametrize("k", [1, 10, 14, 15, 16, 32, 64, 100, 200, 255, 256])
def test_tiles_smem_keeps_two_blocks_an_sm_at_every_k(k):
    """Shared memory alone leaves room for 2 blocks an SM at every k the
    kernel takes, and for 3 wherever the narrow selection serves (k=10's
    occupancy, which the card's run asserts with the registers)."""
    per_block = topk.tiles_smem(k) + BLOCK_RESERVED
    assert 2 * per_block <= SM_SHARED
    if k <= topk.WIDE_K:
        assert 3 * per_block <= SM_SHARED


@pytest.mark.parametrize("q,dim,k,nbytes", [
    (1, 128, 10, 1_184), (4, 128, 10, 4_736), (1, 100, 11, 5_504), (1, 128, 33, 6_976),
    (1, 128, 256, 21_632), (4, 128, 256, 86_528), (2, 1024, 100, 29_952), (3, 1, 1, 1_824)])
def test_stream_smem_counts_the_lists_of_the_selection_k_takes(q, dim, k, nbytes):
    """The Q <= 4 pass's shared bytes (score_topk.cu's stream_smem): the
    queries in f32, padded to whole 128 columns, then up to k =
    STREAM_WIDE_K each warp's list of k values and indices and a fill
    count a query, above it each warp's skewed list of k and skewed queue
    of STREAM_QUEUE a query: 512 + 8 x 8 x (264 + 66) at Q=1, k=256."""
    assert topk.stream_smem(q, dim, k) == nbytes
    assert (k > topk.STREAM_WIDE_K) == (k >= 11)


# the shared memory a block may take on an H100 (227 KB)
BLOCK_SHARED_MAX = 232_448


@pytest.mark.parametrize("q", [1, 2, 3, 4])
@pytest.mark.parametrize("k", [1, 10, 11, 32, 100, 256])
def test_stream_smem_fits_a_block_at_every_width(q, k):
    """Every Q <= 4 block fits the card's 227 KB a block at D up to 1024;
    Q=4, k=256 at D=128 fits one block and Q=1, k=10 three on an SM (the
    main path's search, 3-4 blocks an SM by registers)."""
    assert topk.stream_smem(q, topk.MAX_DIM, k) <= BLOCK_SHARED_MAX
    assert topk.stream_smem(4, 128, 256) <= BLOCK_SHARED_MAX
    assert 3 * (topk.stream_smem(1, 128, 10) + BLOCK_RESERVED) <= SM_SHARED


CONSTANTS = ["STREAM_WIDE_K", "WIDE_K", "STREAM_QUEUE", "STREAM_WARPS", "MAX_K",
             "MAX_SPLITS", "MMA_DEPTH", "TILE_QUEUE", "STREAM_MMA_STAGES", "STREAM_MMA_DEPTH",
             "RING_WARPS", "RING_STAGES", "RING_DEPTH", "RING_SMALL_Q", "RING_LIST",
             "RING_LANE_DOCS", "RING_LONG_SPLIT", "RING_LONG_LANE_DOCS", "PASS_TILES_RING"]


@pytest.mark.parametrize("name", CONSTANTS)
def test_python_constants_mirror_the_cuda_source(name):
    """The wrapper's copies of score_topk.cu's constants (each a
    ``constexpr int`` there) are the source's, so that the plan and the
    shared-memory mirrors follow the kernel."""
    source = (Path(topk.__file__).resolve().parents[1] / "csrc" / "score_topk.cu").read_text()
    found = re.findall(rf"^constexpr int {name} = (\d+);", source, flags=re.M)
    assert found == [str(getattr(topk, name))]


def test_mma_stages_fit_the_staging_bytes():
    """The bf16 Q >= 5 kernel keeps tiles_smem's bytes: its two cp.async
    stages (256 doc rows and 32 query rows of MMA_DEPTH bf16 each, 36,864
    bytes) fit in the f32 kernel's staging bytes; the narrow selection's
    queues (32 queries x 128 docs, values and indices) fit in both stages,
    the wide warps' skewed queues of 256 pairs in one."""
    stage = (topk.BATCH_TILE_N + 32) * topk.MMA_DEPTH * 2
    assert 2 * stage == 36_864 <= topk.STAGING_BYTES
    assert 2 * 4 * 32 * topk.BATCH_TILE_N // 2 <= 2 * stage
    assert 4 * 2 * 4 * topk.list_stride(topk.BATCH_TILE_N) <= stage


def _mma_doc(m, r):  # score_topk.cu:mma_doc, the doc that row r of M-tile m multiplies
    return 128 * (m >> 3) + 16 * (r & 7) + 8 * (m & 1) + 4 * (r >> 3) + ((m >> 1) & 3)


def _doc_slot(d):  # score_topk.cu:doc_slot, bits 0 and 4 swapped
    return (d & ~0x11) | ((d >> 4) & 1) | ((d & 1) << 4)


def test_mma_quad_transpose_leaves_the_cuda_core_layout():
    """score_topk.cu's quad_transpose, step by step on (query, doc) labels
    of one warp's C fragments (m16n8k16: lane (g, t) holds rows g and g + 8
    of every M-tile for queries 2t and 2t + 1; row r of M-tile m is doc
    mma_doc(m, r)), leaves acc[i][jj] = query i of doc 4 lane + jj % 4 +
    128 (jj / 4): the layout of the CUDA-core product, which both
    selections read."""
    c = {lane: [[(2 * (lane & 3) + (x & 1), _mma_doc(m, (lane >> 2) + 8 * (x >> 1)))
                 for x in range(4)] for m in range(16)] for lane in range(32)}
    w = {lane: [[None] * 16 for _ in range(4)] for lane in range(32)}
    for p in range(2):
        for m in range(16):
            for lane in range(32):
                odd = lane & 1
                got = c[lane ^ 1][m][p] if not odd else c[lane ^ 1][m][2 + p]
                w[lane][p][m] = got if odd else c[lane][m][p]
                w[lane][2 + p][m] = c[lane][m][2 + p] if odd else got
    acc = {lane: [[None] * 8 for _ in range(8)] for lane in range(32)}
    for q in range(4):
        for j in range(8):
            for lane in range(32):
                high = lane & 2
                got = w[lane ^ 2][q][2 * j] if not high else w[lane ^ 2][q][2 * j + 1]
                acc[lane][q][j] = got if high else w[lane][q][2 * j]
                acc[lane][4 + q][j] = w[lane][q][2 * j + 1] if high else got
    for lane in range(32):
        for i in range(8):
            for jj in range(8):
                assert acc[lane][i][jj] == (i, 128 * (jj >> 2) + 4 * lane + (jj & 3))


def test_mma_stage_layout_is_free_of_bank_conflicts():
    """The bf16 stages: a doc lives in slot doc_slot(d), unit u of slot s at
    byte 64 s + 16 (u ^ (s / 32) % 4). Each ldmatrix phase (8 lanes: one
    16-byte unit of 8 rows of an M-tile) and each quarter-warp of cp.async
    copies (slots e / 4, units e % 4 of e = tid + 128 i) falls on the 8
    bank groups once; and a lane's A-fragment address is its M-tile 0's
    plus a constant a tile, as mma_chunk computes it."""
    def at(s, u):
        return 64 * s + 16 * (u ^ ((s >> 5) & 3))

    assert sorted(_doc_slot(d) for d in range(256)) == list(range(256))
    assert sorted(_mma_doc(m, r) for m in range(16) for r in range(16)) == list(range(256))
    for m in range(16):
        for ks in range(2):
            for lanes in (range(8 * j, 8 * j + 8) for j in range(4)):
                banks = {at(_doc_slot(_mma_doc(m, lane & 15)), 2 * ks + (lane >> 4)) // 16 % 8
                         for lane in lanes}
                assert len(banks) == 8
            for lane in range(32):
                r, u = lane & 15, 2 * ks + (lane >> 4)
                assert (at(_doc_slot(_mma_doc(m, r)), u) - at(_doc_slot(_mma_doc(0, r)), u)
                        == 64 * _doc_slot(_mma_doc(m, 0)))
    for e0 in range(0, 1024, 8):
        assert len({at(e // 4, e % 4) // 16 % 8 for e in range(e0, e0 + 8)}) == 8


def test_pass_codes_mirror_the_cuda_source():
    """score_topk_bar_launch's pass1 codes: the wrapper's are the source's."""
    source = (Path(topk.__file__).resolve().parents[1] / "csrc" / "score_topk.cu").read_text()
    assert ("constexpr int PASS_STREAM = 1, PASS_STREAM_MMA = 2, PASS_TILES = 8;" in source)
    assert (topk.PASS_STREAM, topk.PASS_STREAM_MMA, topk.PASS_TILES) == (1, 2, 8)


@pytest.mark.parametrize("q,dim,k,nbytes", [
    (2, 128, 10, 141_504), (4, 128, 10, 151_936), (4, 128, 256, 216_704),
    (3, 1024, 256, 200_672), (4, 1024, 256, 223_872), (2, 72, 100, 153_408),
    (3, 8, 11, 146_528)])
def test_stream_mma_smem_counts_rings_queries_and_lists(q, dim, k, nbytes):
    """The bf16 Q = 2-4 pass's shared bytes (score_topk.cu's
    stream_mma_smem): 8 warps x 4 stages x 4,096 bytes of ring (131,072),
    the queries' bf16 rows of D rounded up to 64, plus 16 elements, then the
    wide selection's skewed lists and queues at every k: 131,072 + 2 x 4 x
    144 + 8 x 32 x (264 + 66) at Q=4, k=256, D=128."""
    assert topk.STREAM_MMA_STAGE_BYTES == 32 * 64 * 2
    assert topk.stream_mma_smem(q, dim, k) == nbytes
    assert nbytes <= BLOCK_SHARED_MAX


@pytest.mark.parametrize("q", [2, 3, 4])
@pytest.mark.parametrize("k", [1, 10, 11, 100, 256])
def test_stream_mma_block_fits_and_keeps_bytes_in_flight(q, k):
    """Every bf16 Q = 2-4 block fits the 227 KB a block may take at D up
    to 1024, one block an SM (two would not fit), and its rings keep 8
    warps x 3 stages x 4 KB = 96 KB in flight an SM, over the ~18 KB the
    card needs (0.7 us x 3.35 TB/s / 132 SMs)."""
    assert topk.stream_mma_smem(q, topk.MAX_DIM, k) <= BLOCK_SHARED_MAX
    assert 2 * (topk.stream_mma_smem(q, 8, k) + BLOCK_RESERVED) > SM_SHARED
    in_flight = topk.STREAM_WARPS * (topk.STREAM_MMA_STAGES - 1) * topk.STREAM_MMA_STAGE_BYTES
    assert in_flight == 98_304 >= 0.7e-6 * 3.35e12 / 132


ALIGNED = 4096  # a data_ptr on a 16-byte boundary


@pytest.mark.parametrize("dtype,q,dim,ptr,takes", [
    (torch.bfloat16, 2, 128, ALIGNED, True), (torch.bfloat16, 3, 128, ALIGNED, True),
    (torch.bfloat16, 4, 128, ALIGNED, True), (torch.bfloat16, 4, 1024, ALIGNED, True),
    (torch.bfloat16, 2, 8, ALIGNED, True), (torch.bfloat16, 3, 72, ALIGNED, True),
    (torch.bfloat16, 1, 128, ALIGNED, False), (torch.bfloat16, 5, 128, ALIGNED, False),
    (torch.float32, 4, 128, ALIGNED, False), (torch.float32, 2, 128, ALIGNED, False),
    (torch.bfloat16, 4, 100, ALIGNED, False), (torch.bfloat16, 2, 1, ALIGNED, False),
    (torch.bfloat16, 4, 128, ALIGNED + 2, False), (torch.bfloat16, 3, 128, ALIGNED + 8, False)])
def test_route_rule_sends_aligned_bf16_at_two_to_four_queries_to_the_tensor_cores(
        dtype, q, dim, ptr, takes):
    """kernels/topk.py's route rule for the Q <= 4 pass: bf16 docs at Q =
    2-4 whose D is a multiple of 8 and whose pointer is 16-byte aligned go
    to score_topk_stream_mma; f32, Q = 1, Q >= 5 (the batch pass) and docs
    off alignment stay on score_topk_stream (or score_topk_tiles)."""
    assert topk.stream_mma_takes(dtype, q, dim, ptr) is takes


def test_route_rule_reads_the_views_pointer():
    """A view one element into bf16 storage is off 16-byte alignment and
    leaves the tensor-core pass, though its D is a multiple of 8."""
    storage = torch.zeros(65 * 128, dtype=torch.bfloat16)
    docs, off = storage[:64 * 128].view(64, 128), storage[1:1 + 64 * 128].view(64, 128)
    assert docs.data_ptr() % 16 == 0 and off.data_ptr() % 16 == 2
    assert topk.stream_mma_takes(docs.dtype, 3, 128, docs.data_ptr())
    assert not topk.stream_mma_takes(off.dtype, 3, 128, off.data_ptr())


@pytest.mark.parametrize("q", [2, 3, 4])
@pytest.mark.parametrize("n", [1_000_000, 999_983])
def test_plan_of_the_tensor_core_stream_makes_one_wave(q, n):
    """One block an SM (stream_mma_occupancy) gives about 132 splits of a
    whole number of STREAM_ROWS docs at 1M docs: one wave, within 3%."""
    rows, n_splits, split_len = topk.plan(q, n, 132, 1)
    assert rows == 1 and split_len % topk.STREAM_ROWS == 0
    assert (n_splits - 1) * split_len < n <= n_splits * split_len
    assert 0.97 * 132 <= n_splits <= 132


def _step_doc(m, r):  # score_topk.cu:step_doc, the step doc that row r of M-tile m multiplies
    return 4 * (r & 7) + 2 * m + (r >> 3)


def _step_unit(d, u):  # score_topk.cu:step_unit, byte offset of unit u of step doc d
    return d * 128 + ((u ^ ((d >> 2) & 7)) << 4)


def test_stream_mma_stage_layout_is_free_of_bank_conflicts():
    """A stage of score_topk_stream_mma: 32 docs x 8 units of 16 bytes,
    unit u of doc d at byte 128 d + 16 (u ^ (d / 4) % 8). Each ldmatrix
    phase (8 lanes: a 16-byte unit of 8 rows of an M-tile; lanes 0-15 rows
    0-15 at unit 2 ks, lanes 16-31 at 2 ks + 1) and each quarter-warp of a
    stage's copies (copy i of lane e: unit e % 8 of doc e / 8 + 4 i) falls
    on the 8 bank groups once; the copies fill every unit of the stage
    once; and tile 1's A address is tile 0's plus 256 bytes."""
    assert sorted(_step_doc(m, r) for m in range(2) for r in range(16)) == list(range(32))
    copies = [_step_unit((e >> 3) + 4 * i, e & 7) for i in range(8) for e in range(32)]
    assert sorted(copies) == list(range(0, 4096, 16))
    for i in range(8):
        for e0 in range(0, 32, 8):
            banks = {_step_unit((e >> 3) + 4 * i, e & 7) // 16 % 8 for e in range(e0, e0 + 8)}
            assert len(banks) == 8
    for m in range(2):
        for ks in range(4):
            for phase in range(4):
                lanes = range(8 * phase, 8 * phase + 8)
                banks = {_step_unit(_step_doc(m, lane & 15), 2 * ks + (lane >> 4)) // 16 % 8
                         for lane in lanes}
                assert len(banks) == 8
            for lane in range(32):
                r, u = lane & 15, 2 * ks + (lane >> 4)
                assert _step_unit(_step_doc(1, r), u) == _step_unit(_step_doc(0, r), u) + 256


def _stream_mma_lane_products(nq, chunks):
    """score_topk_stream_mma's arithmetic for one warp step, traced on
    labels: which (doc, query, depth) products each lane's score of each
    query sums. Copies (stage_step), B registers (query g % QC at words 8 ks
    + t and 8 ks + 4 + t of chunk c), ldmatrix.x4 of A (lane l: row l % 16
    of the tile at unit 2 ks + l / 16; matrix j from lanes 8 j .. 8 j + 7:
    rows 0-7 / 8-15 at depth 0-7, then at 8-15), mma.m16n8k16 (C rows g
    and g + 8, columns 2t and 2t + 1), then the selects and the lane ^ 1
    exchange that give lane l its doc. Returns {lane: [Counter a query]}."""
    from collections import Counter

    qc = 2 if nq == 2 else 4
    c = {(lane, m): [Counter() for _ in range(4)] for lane in range(32) for m in range(2)}
    for ch in range(chunks):
        stage = {}  # byte offset -> (doc, first depth)
        for lane in range(32):
            for i in range(8):
                d, u = (lane >> 3) + 4 * i, lane & 7
                stage[_step_unit(d, u)] = (d, 64 * ch + 8 * u)
        for ks in range(4):
            # B[kk][n]: lane (g, t)'s b0 holds kk = 2t, 2t + 1 and b1 kk = 8 + 2t, + 1
            b = {}
            for lane in range(32):
                g, t = lane >> 2, lane & 3
                qn = g & (qc - 1)
                for h in range(2):
                    word = 32 * ch + 8 * ks + 4 * h + t  # of query qn's row
                    for half in range(2):
                        kk = 8 * h + 2 * t + half
                        b[kk, g] = (qn if qn < nq else None, 2 * word + half)
            for m in range(2):
                a = {}  # A[row][kk]
                for lane in range(32):
                    r, hi = lane & 15, lane >> 4
                    d, depth0 = stage[_step_unit(_step_doc(m, r), 2 * ks + hi) - 256 * 0]
                    assert d == _step_doc(m, r) and depth0 == 64 * ch + 16 * ks + 8 * hi
                    for e in range(8):
                        a[r, 8 * hi + e] = (d, depth0 + e)
                for lane in range(32):
                    g, t = lane >> 2, lane & 3
                    for j in range(4):
                        row, col = g + 8 * (j >> 1), 2 * t + (j & 1)
                        for kk in range(16):
                            (d, da), (qq, db) = a[row, kk], b[kk, col]
                            assert da == db  # A's depth is B's
                            if qq is not None:
                                c[lane, m][j][d, qq, da] += 1
    out = {}
    for lane in range(32):
        odd, high = lane & 1, (lane >> 1) & 1
        own = c[lane, high]
        if qc == 2:
            v = [own[2] if odd else own[0], own[3] if odd else own[1]]
        else:
            partner = c[lane ^ 1, high]  # what lane ^ 1 sends: its own[0 / 1] if odd, else [2 / 3]
            sent = [partner[0], partner[1]] if not odd else [partner[2], partner[3]]
            keep = [own[2], own[3]] if odd else [own[0], own[1]]
            v = sent + keep if odd else keep + sent
        out[lane] = v[:nq]
    return out


@pytest.mark.parametrize("nq", [2, 3, 4])
@pytest.mark.parametrize("chunks", [1, 2, 3])
def test_stream_mma_fragments_cover_each_product_once(nq, chunks):
    """Traced through the copies, the fragments, the mma and the exchange,
    lane l's score of query q sums exactly the products of doc l and query
    q at every depth of the chunks, each once: every (doc, query, depth)
    product of the step once, and each lane the doc that the selections
    test (doc base + lane, in lane order). Three chunks take the third
    from shared memory, the first two from registers."""
    from collections import Counter

    products = _stream_mma_lane_products(nq, chunks)
    for lane in range(32):
        for q in range(nq):
            want = Counter({(lane, q, depth): 1 for depth in range(64 * chunks)})
            assert products[lane][q] == want


CANDIDATE_CASES = [(1000, 10, 256, None), (1000, 100, 256, 700), (1000, 256, 512, None),
                   (300, 256, 256, 260), (5, 3, 2, None)]


@pytest.mark.parametrize("n,k,split_len,n_docs", CANDIDATE_CASES)
def test_candidates_reference_is_each_splits_top_k(n, k, split_len, n_docs):
    """The plain pass 1: each split's own top-k with global indices, best
    first, (-inf, NO_INDEX) after a short split runs out, rows past n_docs
    scored -1e30; pass 2's plain merge of its lists gives the plain
    version's result bit for bit."""
    rng = np.random.default_rng(n + k)
    docs = torch.from_numpy(rng.integers(-2, 3, (n, 8)).astype(np.float32))
    queries = torch.from_numpy(rng.integers(-2, 3, (6, 8)).astype(np.float32))
    cand_v, cand_i = topk.candidates_reference(docs, queries, k, split_len, n_docs)
    n_splits = -(-n // split_len)
    assert cand_v.shape == cand_i.shape == (6, n_splits, k)
    assert cand_v.dtype == torch.float32 and cand_i.dtype == torch.int32
    for s in range(n_splits):
        real = min(k, split_len, n - s * split_len)
        idx = cand_i[:, s, :real]
        assert bool(((idx >= s * split_len) & (idx < (s + 1) * split_len)).all())
        assert bool((cand_i[:, s, real:] == topk.NO_INDEX).all())
        assert bool(torch.isneginf(cand_v[:, s, real:]).all())
    want = score_topk_reference(docs, queries, k, n_docs)
    got = topk.merge_topk_reference(cand_v, cand_i)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def _pairs_at_or_before(docs, queries, k, split_len, n_docs, bar_v, bar_i):
    """Each query's and split's top-k among the pairs that rank at or
    before its bar pair, by Python's sort: (Q, S) lists of (value, index)."""
    scores = (queries.double() @ docs.double().T).tolist()  # exact: small integers
    n = docs.shape[0]
    n_docs = n if n_docs is None else n_docs
    out = []
    for q, row in enumerate(scores):
        bv, bi = float(bar_v[q]), int(bar_i[q])
        lists = []
        for begin in range(0, n, split_len):
            pairs = [(row[d] if d < n_docs else float(np.float32(-1e30)), d)
                     for d in range(begin, min(begin + split_len, n))]
            pairs = sorted(pairs, key=lambda p: (-p[0], p[1]))
            lists.append([p for p in pairs if p[0] > bv or (p[0] == bv and p[1] <= bi)][:k])
        out.append(lists)
    return out


BAR_CANDIDATE_CASES = [(1000, 10, 256, None, 37), (1000, 100, 256, 700, 5),
                       (1000, 256, 512, None, 0), (300, 256, 256, 260, 299), (5, 3, 2, None, 4),
                       (1000, 20, 128, 999, 999)]


@pytest.mark.parametrize("n,k,split_len,n_docs,bar_doc", BAR_CANDIDATE_CASES)
def test_candidates_reference_with_a_bar_keeps_pairs_at_or_before_it(n, k, split_len, n_docs,
                                                                      bar_doc):
    """The plain barred pass 1: each split's top-k among the pairs that rank
    at or before the query's bar (its score, then its index: the bar pair
    itself is kept), best first, padded with (-inf, NO_INDEX), as Python's
    sort of every pair gives them. The bar is doc ``bar_doc``'s own pair,
    so ties with it go by index."""
    rng = np.random.default_rng(n + k + bar_doc)
    docs = torch.from_numpy(rng.integers(-2, 3, (n, 8)).astype(np.float32))
    queries = torch.from_numpy(rng.integers(-2, 3, (6, 8)).astype(np.float32))
    scores = queries @ docs.T
    if n_docs is not None:
        scores[:, n_docs:] = -1e30
    bar_v = scores[:, bar_doc].contiguous()
    bar_i = torch.full((6,), bar_doc, dtype=torch.int32)
    cand_v, cand_i = topk.candidates_reference(docs, queries, k, split_len, n_docs,
                                               bar=(bar_v, bar_i))
    want = _pairs_at_or_before(docs, queries, k, split_len, n_docs, bar_v, bar_i)
    n_splits = -(-n // split_len)
    assert cand_v.shape == cand_i.shape == (6, n_splits, k)
    for q in range(6):
        for s in range(n_splits):
            pairs = want[q][s]
            assert cand_i[q, s, :len(pairs)].tolist() == [d for _, d in pairs]
            assert cand_v[q, s, :len(pairs)].tolist() == [v for v, _ in pairs]
            assert bool((cand_i[q, s, len(pairs):] == topk.NO_INDEX).all())
            assert bool(torch.isneginf(cand_v[q, s, len(pairs):]).all())


T = topk.BATCH_TILE_N


def sample_docs(n, plan):
    """Docs a sample plan (n_splits, split_len, split_docs) reads."""
    if plan is None:
        return 0
    n_splits, split_len, split_docs = plan
    return sum(min(split_docs, n - s * split_len) for s in range(n_splits))


@pytest.mark.parametrize("q,k,n,n_splits,split_tiles,sample_tiles,want", [
    (32, 256, 1_000_000, 261, 15, 15, (261, 15 * T, T)),
    (256, 100, 1_000_000, 33, 119, 119, (33, 119 * T, 8 * T)),
    (256, 100, 1_000_000, 33, 119, 8, (33, 119 * T, T)),
    (5, topk.WIDE_K + 1, 524_288, 256, 8, 8, (256, 8 * T, T)),
    (5, 256, 524_287, 256, 8, 8, (128, 16 * T, T)),
    (256, 256, 65_536, 32, 8, 8, (32, 8 * T, T)),
    (33, 256, 65_535, 32, 8, 8, None), (32, 256, 65_536, 256, 1, 1, None),
    (32, 256, 1_000_000, 1024, 3, 3, None), (4, 256, 1_000_000, 261, 15, 15, None),
    (32, topk.WIDE_K, 1_000_000, 261, 15, 15, None), (32, 10, 1_000_000, 261, 15, 15, None),
    (5, 15, 270_336, 264, 4, 4, (132, 8 * T, T)),
    (257, 256, 999_983, 30, 131, 131, (30, 131 * T, 9 * T))])
def test_bar_rule_takes_wide_batches_over_many_docs(q, k, n, n_splits, split_tiles,
                                                     sample_tiles, want):
    """The bar applies to the Q >= 5 pass's wide selection (Q >= 5, k >
    WIDE_K) alone, where a split reads BAR_MIN_TILES tiles or more; the
    sample holds about the largest of BAR_DOCS, its half and so on down to
    BAR_MIN_DOCS that the pass's docs hold BAR_MIN_RATIO times: the first
    tiles of every split, or the first tile of every few splits. Elsewhere
    a call is as before. A sample plan (split_docs under split_len) is
    barred by the same rule."""
    got = topk.bar_plan(q, k, n, n_splits, split_tiles * T, sample_tiles * T)
    assert got == want
    if got is not None:  # its splits are the pass's own, each at a tile's start
        assert got[0] <= n_splits and got[1] % (split_tiles * T) == 0 and got[2] % T == 0
        assert got[2] <= sample_tiles * T and (got[0] - 1) * got[1] < n
    assert (topk.BAR_DOCS, topk.BAR_MIN_DOCS, topk.BAR_MIN_RATIO, topk.BAR_MIN_TILES) == (
        65_536, 8_192, 8, 4)
    ratio = topk.BAR_DOCS // topk.BAR_MIN_DOCS  # each halving a whole number of tiles
    assert ratio & (ratio - 1) == 0 and topk.BAR_MIN_DOCS % topk.BATCH_TILE_N == 0
    assert 8_192 <= topk.BAR_MIN_DOCS <= topk.BAR_DOCS <= 65_536
    assert topk.BAR_MIN_DOCS >= topk.MAX_K


@pytest.mark.parametrize("q,first,second", [(32, 66_816, 0), (256, 67_584, 8_448),
                                            (5, 66_816, 0), (257, 69_120, 15_360)])
def test_bar_rule_under_the_plan_at_one_million_docs(q, first, second):
    """Under ``plan`` (132 SMs, 2 blocks an SM at k=256), a call over 1M
    docs samples one tile of each of 261 splits at Q <= 32; at Q=256 eight
    of each of 33, and that sample run, whose splits span 8 tiles, is
    barred in turn by one tile of each; the innermost run takes none."""
    n = 1_000_000
    n_splits, split_len = topk.plan(q, n, 132, 2)[1:]
    outer = topk.bar_plan(q, 256, n, n_splits, split_len, split_len)
    assert sample_docs(n, outer) == first
    inner = topk.bar_plan(q, 256, n, *outer)
    assert sample_docs(n, inner) == second
    assert inner is None or topk.bar_plan(q, 256, n, *inner) is None


@pytest.mark.parametrize("max_docs,min_docs,min_ratio,min_tiles,n,want", [
    (8_192, 8_192, 8, 4, 65_536, 8_192), (8_192, 8_192, 8, 4, 65_535, 0),
    (65_536, 65_536, 4, 1, 262_144, 65_536), (65_536, 65_536, 4, 1, 262_143, 0),
    (65_536, 8_192, 2, 4, 131_071, 32_768), (65_536, 8_192, 8, 1, 65_536, 8_192),
    (128, 128, 1, 1, 1_000, 0)])
def test_bar_rule_follows_its_sample_and_ratio(max_docs, min_docs, min_ratio, min_tiles, n,
                                               want):
    """Other sample sizes, ratios and split lengths (the variants' sweep),
    here at splits of four tiles: none below a whole tile."""
    n_splits = -(-n // (4 * T))
    got = topk.bar_plan(32, 256, n, n_splits, 4 * T, 4 * T, max_docs=max_docs,
                        min_docs=min_docs, min_ratio=min_ratio, min_tiles=min_tiles)
    assert sample_docs(n, got) == want


@pytest.mark.parametrize("shape,dtypes,q,k,match", [
    (((4,), (4,)), (torch.float32, torch.int32), 4, 256, "only Q >= 5"),
    (((5,), (5,)), (torch.float32, torch.int32), 5, 14, "only Q >= 5"),
    (((5,), (6,)), (torch.float32, torch.int32), 5, 256, "\\(Q,\\) float32"),
    (((5,), (5,)), (torch.float64, torch.int32), 5, 256, "\\(Q,\\) float32"),
    (((5, 1), (5, 1)), (torch.float32, torch.int32), 5, 256, "\\(Q,\\) float32")])
def test_bar_arguments_are_checked(shape, dtypes, q, k, match):
    bar = (torch.zeros(shape[0], dtype=dtypes[0]), torch.zeros(shape[1], dtype=dtypes[1]))
    with pytest.raises(ValueError, match=match):
        topk._check_bar(bar, q, k, torch.device("cpu"))


def test_barred_pass_one_refuses_cpu_tensors():
    before = topk.LAUNCHES
    bar = (torch.zeros(5), torch.zeros(5, dtype=torch.int32))
    with pytest.raises(ValueError, match="CUDA device"):
        topk.score_topk_candidates(torch.zeros(64, 8), torch.zeros(5, 8), 20, bar=bar)
    assert topk.LAUNCHES == before


MERGE_PLAN_CASES = [(s, k) for s in (1, 2, 3, 31, 32, 33, 100, 391, 521, 1023, 1024)
                    for k in (1, 10, 64, 256)]


@pytest.mark.parametrize("s,k", MERGE_PLAN_CASES)
def test_merge_plan_fits_its_budget_and_covers_every_list(s, k):
    """Pass 2's tree: one level where all S lists fit one block's shared
    budget; else groups of even sizes that cover the S lists, each at most
    the widest power of two that fits, as few as those allow, and a last
    level over their winners that fits too. The two levels take
    ceil(log2(S)) rounds, as one block over all S lists would."""
    group, levels, smem = topk.merge_plan(s, k)
    groups = -(-s // group)
    sizes = [min(group, s - g * group) for g in range(groups)]
    assert sum(sizes) == s and min(sizes) >= 1
    budget = topk.MERGE_SMEM_BUDGET
    if topk.merge_smem(s, k) <= budget:
        assert (group, levels, smem) == (s, 1, topk.merge_smem(s, k))
    else:
        assert levels == 2 and 1 < groups < s
        assert smem == max(topk.merge_smem(group, k), topk.merge_smem(groups, k)) <= budget
        widest = 2 ** math.floor(math.log2(group))
        widest = widest if widest == group else 2 * widest
        assert topk.merge_smem(widest, k) <= budget < topk.merge_smem(2 * widest, k)
        assert groups == -(-s // widest)  # as few groups as the widest allows
        assert group - min(sizes) < groups
    assert smem <= budget
    rounds = math.ceil(math.log2(group)) + (math.ceil(math.log2(groups)) if levels == 2 else 0)
    assert rounds == math.ceil(math.log2(s))


@pytest.mark.parametrize("lists,k,nbytes", [(1, 1, 64), (1, 10, 192), (32, 256, 101_376),
                                            (33, 256, 105_600), (521, 10, 64_544)])
def test_merge_smem_counts_both_buffers(lists, k, nbytes):
    """Values and indices of the lists plus those of the first round's
    ceil(lists / 2) lists, each plane with a padding word after every 32
    pairs and rounded up to whole 16-byte units (score_topk.cu's
    merge_smem). At 33 lists of 256: 2 x 4 x (8,448 + 264 + 4,352 + 136)."""
    assert topk.merge_smem(lists, k) == nbytes


@pytest.mark.parametrize("s,k", [(0, 10), (1025, 10), (5, 0), (5, 257)])
def test_merge_plan_refuses_what_the_kernel_does_not_take(s, k):
    with pytest.raises(ValueError, match="merge_plan"):
        topk.merge_plan(s, k)


def _lists(q, s, k, kind, device="cpu", seed=0):
    return crafted_lists(q, s, k, kind, torch.Generator(device=device).manual_seed(seed))


def _rank_key(value, index):
    return (-value if value != 0 else 0.0, index)


@pytest.mark.parametrize("kind", ["random", "tied", "integer", "signed-zero"])
@pytest.mark.parametrize("q,s,k", [(1, 1, 5), (2, 7, 10), (3, 33, 4)])
def test_merge_reference_ranks_like_the_kernel(kind, q, s, k):
    """The plain pass 2 against Python's sort of every pair by score
    descending, -0.0 equal to +0.0, then index ascending (the kernel's
    ranks_before), the scores' bits kept: -0.0 comes back as -0.0."""
    cand_v, cand_i = _lists(q, s, k, kind, seed=s * 31 + k)
    lists_v, lists_i = cand_v.view(q * s, k).tolist(), cand_i.view(q * s, k).tolist()
    for v, i in zip(lists_v, lists_i):  # crafted as pass 1 leaves them
        assert sorted(zip(v, i), key=lambda p: _rank_key(*p)) == list(zip(v, i))
    got_v, got_i = topk.merge_topk_reference(cand_v, cand_i)
    assert got_v.shape == got_i.shape == (q, k)
    for row in range(q):
        pairs = sorted(zip(cand_v[row].flatten().tolist(), cand_i[row].flatten().tolist()),
                       key=lambda p: _rank_key(*p))[:k]
        assert got_i[row].tolist() == [i for _, i in pairs]
        want = torch.tensor([v for v, _ in pairs], dtype=torch.float32)
        assert torch.equal(got_v[row].view(torch.int32), want.view(torch.int32))
        assert int(got_i[row].max()) != topk.NO_INDEX  # k real pairs beat the padding
    if kind == "signed-zero":
        assert bool(torch.signbit(cand_v[cand_v == 0]).any())


@pytest.mark.parametrize("shape,dtypes,match", [
    ((2, 3), (torch.float32, torch.int32), "two \\(Q, S, k\\) tensors"),
    ((2, 3, 4), (torch.float64, torch.int32), "float32 and int32"),
    ((2, 1025, 4), (torch.float32, torch.int32), "1 <= S <= 1024"),
    ((2, 3, 257), (torch.float32, torch.int32), "1 <= k <= 256"),
])
def test_merge_kernel_limits_raise(shape, dtypes, match):
    with pytest.raises(ValueError, match=match):
        topk.merge_topk_cuda(torch.zeros(shape, dtype=dtypes[0]),
                             torch.zeros(shape, dtype=dtypes[1]))


def test_merge_kernel_refuses_cpu_tensors():
    """Pass 2 alone, like both passes, never hands a call to the plain
    version; neither does pass 1 alone."""
    before = topk.LAUNCHES
    cand_v, cand_i = _lists(2, 3, 4, "random")
    with pytest.raises(ValueError, match="CUDA device"):
        topk.merge_topk_cuda(cand_v, cand_i)
    with pytest.raises(ValueError, match="CUDA device"):
        topk.score_topk_candidates(torch.zeros(64, 8), torch.zeros(2, 8), 5)
    assert topk.LAUNCHES == before


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _call_launches(cuda, q, k, n, dtype):
    """Launches of a score_topk_cuda call: its own, and one for each
    sample run that bars it (bar_plan; none at Q <= 4 or k <= WIDE_K)."""
    if q <= 4 or k <= topk.WIDE_K:
        return 1
    per_sm = topk.tiles_occupancy(cuda, dtype, k)["blocks_per_sm"]
    sm_count = torch.cuda.get_device_properties(cuda).multi_processor_count
    n_splits, split_len = topk.plan(q, n, sm_count, per_sm)[1:]
    sample, launches = (n_splits, split_len, split_len), 1
    while (sample := topk.bar_plan(q, k, n, *sample)) is not None:
        launches += 1
    return launches


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
    assert topk.LAUNCHES == before + _call_launches(cuda, queries.shape[0], k, docs.shape[0],
                                                    dtype)
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
    assert topk.LAUNCHES == before + _call_launches(cuda, q, k, n, dtype)
    want_s, want_i = score_topk_reference(docs, queries, k)
    assert torch.equal(got_s, want_s)
    assert torch.equal(got_i, want_i)


MMA_FLOAT_CASES = [(q, dim, k, off) for q in (5, 33, 257) for dim in (64, 128, 1024)
                   for k in (10, 15, 256) for off in (-1, 1)]


@pytest.mark.cuda
@pytest.mark.parametrize("q,dim,k,off", MMA_FLOAT_CASES)
def test_batch_kernel_bf16_float_data_agrees(cuda, q, dim, k, off):
    """bf16 docs at Q >= 5 on the tensor cores with float data, N = 256 m
    +- 1, both selections (k on both sides of WIDE_K): the products are
    exact and only the order of the f32 sums differs from the plain
    version's, so scores within rtol 1e-5, atol 1e-6 and indices equal
    but for near-ties (topk.agree)."""
    gen = torch.Generator(device=cuda).manual_seed(q * 7919 + dim * 31 + k + off)
    n = 256 * (150 if dim == 1024 else 600) + off
    docs = torch.randn(n, dim, device=cuda, generator=gen)
    docs = (docs / docs.norm(dim=1, keepdim=True)).to(torch.bfloat16)
    queries = torch.randn(q, dim, device=cuda, generator=gen)
    queries /= queries.norm(dim=1, keepdim=True)
    before = topk.LAUNCHES
    got = score_topk(docs, queries, k)
    torch.cuda.synchronize()
    assert topk.LAUNCHES == before + _call_launches(cuda, q, k, n, torch.bfloat16)
    topk.agree(docs, queries, got, score_topk_reference(docs, queries, k))


@pytest.mark.cuda
def test_batch_kernel_bf16_integer_data_is_bit_equal_at_q257_k256(cuda):
    """bf16 docs, Q=257 (a ragged last query block), k=256 (the wide
    selection), D=128 on the cp.async path: integer-valued inputs sum
    exactly in any order, so the tensor cores' result is the plain
    version's bit for bit."""
    gen = torch.Generator(device=cuda).manual_seed(257)
    docs = torch.randint(-2, 3, (100_003, 128), device=cuda, generator=gen).to(torch.bfloat16)
    queries = torch.randint(-2, 3, (257, 128), device=cuda, generator=gen).float()
    _bit_equal(docs, queries, 256)


@pytest.mark.cuda
@pytest.mark.parametrize("q", [5, 33])
@pytest.mark.parametrize("k", [100, 256])
def test_batch_kernel_breaks_ties_to_the_lower_index(cuda, q, k):
    """Every score ties at Q >= 5 and large k (the warps' selection): the
    first k docs in order, bit for bit the plain version's."""
    docs = torch.zeros(8192, 16, device=cuda)
    docs[:, 0] = 1.0
    queries = torch.zeros(q, 16, device=cuda)
    queries[:, 0] = 1.0
    _, got_i = _bit_equal(docs, queries, k)
    assert torch.equal(got_i.cpu(), torch.arange(k, dtype=torch.int32).repeat(q, 1))


@pytest.mark.cuda
@pytest.mark.parametrize("q,k", [(5, 14), (5, 15), (33, 100), (257, 256)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_batch_pass_one_lists_are_each_splits_top_k(cuda, q, k, dtype):
    """Pass 1 alone (score_topk_candidates) at Q >= 5, on both sides of
    WIDE_K, bit for bit the plain per-split top-k under the call's plan,
    with rows past n_docs masked (integer-valued inputs)."""
    gen = torch.Generator(device=cuda).manual_seed(q * 31 + k)
    docs = torch.randint(-2, 3, (100_003, 64), device=cuda, generator=gen).to(dtype)
    queries = torch.randint(-2, 3, (q, 64), device=cuda, generator=gen).float()
    n_docs = 99_000
    got_v, got_i = topk.score_topk_candidates(docs, queries, k, n_docs)
    per_sm = topk.tiles_occupancy(cuda, dtype, k)["blocks_per_sm"]
    sm_count = torch.cuda.get_device_properties(cuda).multi_processor_count
    split_len = topk.plan(q, docs.shape[0], sm_count, per_sm)[2]
    if topk.ring_takes(dtype, q, k):  # the ring pass plans by its own block
        split_len = topk.call_plan(docs, q, k)[2]
    want_v, want_i = topk.candidates_reference(docs, queries, k, split_len, n_docs)
    assert torch.equal(got_v.view(torch.int32), want_v.view(torch.int32))
    assert torch.equal(got_i, want_i)


@pytest.mark.cuda
@pytest.mark.parametrize("q,k", [(5, 15), (33, 100), (257, 256)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_barred_pass_one_lists_are_each_splits_top_k_at_or_before_the_bar(cuda, q, k, dtype):
    """Pass 1 with a bar (each query's k-th pair of the call's sample run,
    read in place with stride k) bit for bit the plain per-split top-k
    among the pairs at or before it, with rows past n_docs masked
    (integer-valued inputs: many ties with the bar)."""
    gen = torch.Generator(device=cuda).manual_seed(q * 37 + k)
    docs = torch.randint(-2, 3, (300_003, 64), device=cuda, generator=gen).to(dtype)
    queries = torch.randint(-2, 3, (q, 64), device=cuda, generator=gen).float()
    n_docs = 299_000
    bar = topk.kth(topk.score_topk_sample(docs, queries, k, n_docs), k)
    assert bar is not None
    got_v, got_i = topk.score_topk_candidates(docs, queries, k, n_docs, bar=bar)
    per_sm = topk.tiles_occupancy(cuda, dtype, k)["blocks_per_sm"]
    sm_count = torch.cuda.get_device_properties(cuda).multi_processor_count
    split_len = topk.plan(q, docs.shape[0], sm_count, per_sm)[2]
    want_v, want_i = topk.candidates_reference(docs, queries, k, split_len, n_docs, bar=bar)
    assert torch.equal(got_v.view(torch.int32), want_v.view(torch.int32))
    assert torch.equal(got_i, want_i)
    assert bool((got_i == topk.NO_INDEX).any())  # the bar left some list short


@pytest.mark.cuda
@pytest.mark.parametrize("q,k,n_docs", [(5, 15, None), (32, 256, None), (257, 256, None),
                                        (33, 100, 300_000)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_barred_call_is_the_plain_version_bit_for_bit(cuda, q, k, n_docs, dtype):
    """score_topk_cuda where the bar rule applies (N = BAR_MIN_RATIO x
    BAR_DOCS + 3): a sample run (two at Q=257), then pass 1 barred by its
    k-th pairs, each a launch; integer-valued inputs give the plain
    version's result bit for bit."""
    gen = torch.Generator(device=cuda).manual_seed(q * 41 + k)
    n = topk.BAR_MIN_RATIO * topk.BAR_DOCS + 3
    assert _call_launches(cuda, q, k, n, dtype) == (3 if q == 257 else 2)
    docs = torch.randint(-2, 3, (n, 32), device=cuda, generator=gen).to(dtype)
    queries = torch.randint(-2, 3, (q, 32), device=cuda, generator=gen).float()
    _bit_equal(docs, queries, k, n_docs)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_barred_call_breaks_ties_to_the_lower_index(cuda, dtype):
    """Every score ties over N = BAR_MIN_RATIO x BAR_DOCS docs: the bar is
    doc k-1's pair, only docs at or before it survive, and the result is
    the first k docs in order."""
    n = topk.BAR_MIN_RATIO * topk.BAR_DOCS
    docs = torch.zeros(n, 16, device=cuda, dtype=dtype)
    docs[:, 0] = 1.0
    queries = torch.zeros(33, 16, device=cuda)
    queries[:, 0] = 1.0
    assert _call_launches(cuda, 33, 256, n, dtype) == 2
    _, got_i = _bit_equal(docs, queries, 256)
    assert torch.equal(got_i.cpu(), torch.arange(256, dtype=torch.int32).repeat(33, 1))


@pytest.mark.cuda
@pytest.mark.parametrize("q", [32, 257])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_sample_run_sums_each_pair_as_the_main_run(cuda, q, dtype):
    """The bar is exact only if the sample run's sums are the main run's
    bit for bit: float inputs, the sample run's top-k pairs that the main
    run's pass-1 lists hold have the same bits there."""
    gen = torch.Generator(device=cuda).manual_seed(q)
    docs = torch.randn(topk.BAR_MIN_RATIO * topk.BAR_DOCS, 128, device=cuda, generator=gen)
    docs = (docs / docs.norm(dim=1, keepdim=True)).to(dtype)
    queries = torch.randn(q, 128, device=cuda, generator=gen)
    sample_v, sample_i, _ = topk.score_topk_sample(docs, queries, 256)
    cands = topk.score_topk_candidates(docs, queries, 256)
    per_sm = topk.tiles_occupancy(cuda, dtype, 256)["blocks_per_sm"]
    sm_count = torch.cuda.get_device_properties(cuda).multi_processor_count
    split_len = topk.plan(q, docs.shape[0], sm_count, per_sm)[2]
    assert sample_pairs_in_main(sample_v, sample_i, *cands, split_len) > q * 128


@pytest.mark.cuda
@pytest.mark.parametrize("k", [10, 14, 15, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_batch_block_fits_without_spills(cuda, k, dtype):
    """Both instantiations of the Q >= 5 pass: no spills, at least 2 blocks
    an SM, 3 at k=10, and the shared bytes of topk.tiles_smem."""
    block = topk.tiles_occupancy(cuda, dtype, k)
    assert block["local_bytes"] == 0
    assert block["blocks_per_sm"] >= (3 if k == 10 else 2)
    assert block["smem_bytes"] == topk.tiles_smem(k)


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
    """The split length of the Q <= 4 pass for this call on the card, docs
    aligned: bf16 at Q = 2-4 and D a multiple of 8 take the tensor-core
    pass (topk.stream_mma_takes), under its own blocks an SM."""
    if topk.stream_mma_takes(dtype, q, dim, 0):
        per_sm = topk.stream_mma_occupancy(cuda, q, dim, k)["blocks_per_sm"]
    else:
        per_sm = topk.stream_occupancy(cuda, dtype, q, dim, k)["blocks_per_sm"]
    sm_count = torch.cuda.get_device_properties(cuda).multi_processor_count
    return topk.plan(q, n, sm_count, per_sm)[2]


def _bit_equal(docs, queries, k, n_docs=None):
    before = topk.LAUNCHES
    got_s, got_i = score_topk(docs, queries, k, n_docs)
    torch.cuda.synchronize()
    assert topk.LAUNCHES == before + _call_launches(docs.device, queries.shape[0], k,
                                                    docs.shape[0], docs.dtype)
    want_s, want_i = score_topk_reference(docs, queries, k, n_docs)
    assert torch.equal(got_s, want_s)
    assert torch.equal(got_i, want_i)
    return got_s, got_i


STREAM_EDGE_CASES = [(q, dim, dtype, k, off) for q in (1, 4) for dim in (1, 100, 128, 1024)
                     for dtype in (torch.float32, torch.bfloat16)
                     for k in (1, 64, 256, topk.STREAM_WIDE_K, topk.STREAM_WIDE_K + 1)
                     for off in (-1, 1)]


@pytest.mark.cuda
@pytest.mark.parametrize("q,dim,dtype,k,off", STREAM_EDGE_CASES)
def test_stream_kernel_crosses_split_edges(cuda, q, dim, dtype, k, off):
    """The Q <= 4 pass at N = split_len m +- 1 (a last split one row long or
    one row short), D=1 and 100 on the scalar fill in bf16 (D=1 in f32
    too), D=1024 in several 128-column passes, k up to 256. Integer-valued
    inputs sum exactly in any order, so scores and indices equal the plain
    version's to the bit, ties included. k on both sides of STREAM_WIDE_K
    takes both selections."""
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
@pytest.mark.parametrize("q,k", [(1, 256), (4, 256), (2, 10), (1, topk.STREAM_WIDE_K),
                                 (1, topk.STREAM_WIDE_K + 1), (3, topk.STREAM_WIDE_K),
                                 (3, topk.STREAM_WIDE_K + 1), (2, 100)])
def test_stream_kernel_breaks_ties_to_the_lower_index(cuda, q, k):
    """Every score ties (or every query is zero): the first k docs, in
    order, with either selection (k on both sides of STREAM_WIDE_K)."""
    docs = torch.zeros(8192, 16, device=cuda)
    docs[:, 0] = 1.0
    queries = torch.zeros(q, 16, device=cuda)
    if k != 10:
        queries[:, 0] = 1.0
    _, got_i = _bit_equal(docs, queries, k)
    assert torch.equal(got_i.cpu(), torch.arange(k, dtype=torch.int32).repeat(q, 1))


@pytest.mark.cuda
@pytest.mark.parametrize("q,k", [(1, 256), (4, 256), (2, topk.STREAM_WIDE_K),
                                 (3, topk.STREAM_WIDE_K + 1), (1, 100)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_stream_pass_one_lists_are_each_splits_top_k(cuda, q, k, dtype):
    """Pass 1 alone (score_topk_candidates) at Q <= 4, on both sides of
    STREAM_WIDE_K, bit for bit the plain per-split top-k under the call's
    plan, with rows past n_docs masked (integer-valued inputs)."""
    gen = torch.Generator(device=cuda).manual_seed(q * 31 + k)
    docs = torch.randint(-2, 3, (100_003, 64), device=cuda, generator=gen).to(dtype)
    queries = torch.randint(-2, 3, (q, 64), device=cuda, generator=gen).float()
    n_docs = 99_000
    got_v, got_i = topk.score_topk_candidates(docs, queries, k, n_docs)
    split_len = _split_len(cuda, q, docs.shape[0], dtype, 64, k)
    want_v, want_i = topk.candidates_reference(docs, queries, k, split_len, n_docs)
    assert torch.equal(got_v.view(torch.int32), want_v.view(torch.int32))
    assert torch.equal(got_i, want_i)


@pytest.mark.cuda
@pytest.mark.parametrize("q", [1, 2, 3, 4])
@pytest.mark.parametrize("k", [10, topk.STREAM_WIDE_K, topk.STREAM_WIDE_K + 1, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_stream_block_fits_without_spills(cuda, q, k, dtype):
    """Both instantiations of the Q <= 4 pass: no spills, the shared bytes
    of topk.stream_smem, and at Q=1 the blocks an SM that its launch bound
    asks for (3 for the narrow selection, 2 for the wide one); one at
    least elsewhere."""
    block = topk.stream_occupancy(cuda, dtype, q, 128, k)
    assert block["local_bytes"] == 0
    assert block["smem_bytes"] == topk.stream_smem(q, 128, k)
    assert block["blocks_per_sm"] >= (3 if (q, k) == (1, 10) else 2 if q == 1 else 1)


def _on_tensor_cores(docs, queries, k, n_docs=None, mma=True):
    """score_topk on the card, bit for bit the plain version, with pass 1
    on score_topk_stream_mma (mma) or not: its launch count says which."""
    before = topk.STREAM_MMA_LAUNCHES
    got = _bit_equal(docs, queries, k, n_docs)
    assert topk.STREAM_MMA_LAUNCHES - before == int(mma)
    return got


STREAM_MMA_EDGE_CASES = [(q, dim, k, off) for q in (2, 3, 4) for dim in (8, 64, 72, 128, 1024)
                         for k in (1, 10, 11, 64, 256) for off in (-1, 1)]


@pytest.mark.cuda
@pytest.mark.parametrize("q,dim,k,off", STREAM_MMA_EDGE_CASES)
def test_stream_mma_kernel_crosses_split_edges(cuda, q, dim, k, off):
    """bf16 docs at Q = 2-4 on the tensor cores at N = split_len m +- 1 (a
    last split one row long or one row short, a warp's last step ragged),
    D from one unit (8) to 1024 (16 stages a step, the queries' fragments
    from shared memory past 128 columns; D=72 zero-fills a stage's last 7
    units), k from 1 to 256. Integer-valued inputs sum
    exactly in any order: the plain version's result bit for bit."""
    gen = torch.Generator(device=cuda).manual_seed(q * 7919 + dim * 31 + k)
    base = topk.STREAM_ROWS * (150 if dim == 1024 else 600)
    split_len = _split_len(cuda, q, base, torch.bfloat16, dim, k)
    n = split_len * -(-base // split_len) + off
    docs = torch.randint(-2, 3, (n, dim), device=cuda, generator=gen).to(torch.bfloat16)
    queries = torch.randint(-2, 3, (q, dim), device=cuda, generator=gen).float()
    _on_tensor_cores(docs, queries, k)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 5, 31, 32, 33, 255, 256, 257])
@pytest.mark.parametrize("q", [2, 3, 4])
def test_stream_mma_kernel_takes_fewer_docs_than_one_iteration(cuda, n, q):
    """N below a warp step (32 docs) and a block step (256), and just past."""
    gen = torch.Generator(device=cuda).manual_seed(n + q)
    docs = torch.randint(-2, 3, (n, 128), device=cuda, generator=gen).to(torch.bfloat16)
    queries = torch.randint(-2, 3, (q, 128), device=cuda, generator=gen).float()
    _on_tensor_cores(docs, queries, min(5, n))


@pytest.mark.cuda
@pytest.mark.parametrize("q", [2, 3, 4])
@pytest.mark.parametrize("k", [10, 64])
def test_stream_mma_kernel_masks_rows_past_n_docs(cuda, q, k):
    gen = torch.Generator(device=cuda).manual_seed(q + k)
    docs = torch.randint(-2, 3, (256 * 40 + 1, 64), device=cuda, generator=gen).to(torch.bfloat16)
    docs[5000:] = 50  # rows past n_docs would win if not masked
    got = _on_tensor_cores(docs, torch.ones(q, 64, device=cuda), k, 5000)
    assert int(got[1].max()) < 5000


@pytest.mark.cuda
@pytest.mark.parametrize("q", [2, 3, 4])
@pytest.mark.parametrize("k", [10, 11, 256])
def test_stream_mma_kernel_breaks_ties_to_the_lower_index(cuda, q, k):
    """Every score ties (bf16 docs, Q = 2-4, k below, at and above the
    Q <= 4 pass's STREAM_WIDE_K): the first k docs, in order."""
    docs = torch.zeros(8192, 16, device=cuda, dtype=torch.bfloat16)
    docs[:, 0] = 1.0
    queries = torch.zeros(q, 16, device=cuda)
    queries[:, 0] = 1.0
    _, got_i = _on_tensor_cores(docs, queries, k)
    assert torch.equal(got_i.cpu(), torch.arange(k, dtype=torch.int32).repeat(q, 1))


@pytest.mark.cuda
@pytest.mark.parametrize("q,k", [(2, 10), (3, 11), (4, 256), (2, 256), (3, 100), (4, 1)])
def test_stream_mma_pass_one_lists_are_each_splits_top_k(cuda, q, k):
    """Pass 1 alone on the tensor cores, k from 1 to 256, bit for bit the
    plain per-split top-k under the call's plan, with rows past n_docs
    masked (integer-valued inputs)."""
    gen = torch.Generator(device=cuda).manual_seed(q * 37 + k)
    docs = torch.randint(-2, 3, (100_003, 64), device=cuda, generator=gen).to(torch.bfloat16)
    queries = torch.randint(-2, 3, (q, 64), device=cuda, generator=gen).float()
    n_docs = 99_000
    before = topk.STREAM_MMA_LAUNCHES
    got_v, got_i = topk.score_topk_candidates(docs, queries, k, n_docs)
    assert topk.STREAM_MMA_LAUNCHES == before + 1
    pass1, _, split_len = topk.call_plan(docs, q, k)
    assert pass1 == topk.PASS_STREAM_MMA
    assert split_len == _split_len(cuda, q, docs.shape[0], torch.bfloat16, 64, k)
    want_v, want_i = topk.candidates_reference(docs, queries, k, split_len, n_docs)
    assert torch.equal(got_v.view(torch.int32), want_v.view(torch.int32))
    assert torch.equal(got_i, want_i)


STREAM_MMA_FLOAT_CASES = [(q, dim, k, off) for q in (2, 3, 4) for dim in (64, 128, 1024)
                          for k in (10, 100, 256) for off in (-1, 1)]


@pytest.mark.cuda
@pytest.mark.parametrize("q,dim,k,off", STREAM_MMA_FLOAT_CASES)
def test_stream_mma_kernel_float_data_agrees_and_repeats(cuda, q, dim, k, off):
    """Float data on the tensor cores: the products are exact and only the
    order of the f32 sums differs from the plain version's, so scores
    within rtol 1e-5, atol 1e-6 and indices equal but for near-ties
    (topk.agree); two calls give the same bits."""
    gen = torch.Generator(device=cuda).manual_seed(q * 7919 + dim * 31 + k + off)
    n = 256 * (150 if dim == 1024 else 600) + off
    docs = torch.randn(n, dim, device=cuda, generator=gen)
    docs = (docs / docs.norm(dim=1, keepdim=True)).to(torch.bfloat16)
    queries = torch.randn(q, dim, device=cuda, generator=gen)
    queries /= queries.norm(dim=1, keepdim=True)
    before = topk.STREAM_MMA_LAUNCHES
    got = score_topk(docs, queries, k)
    again = score_topk(docs, queries, k)
    torch.cuda.synchronize()
    assert topk.STREAM_MMA_LAUNCHES == before + 2
    topk.agree(docs, queries, got, score_topk_reference(docs, queries, k))
    assert torch.equal(got[0].view(torch.int32), again[0].view(torch.int32))
    assert torch.equal(got[1], again[1])


@pytest.mark.cuda
@pytest.mark.parametrize("offset", ["element", "d100"])
@pytest.mark.parametrize("q", [2, 3, 4])
@pytest.mark.parametrize("k", [10, 256])
def test_off_alignment_bf16_docs_take_the_stream_kernel(cuda, offset, q, k):
    """bf16 docs at Q = 2-4 that the tensor-core pass does not take (a view
    one element past 16-byte alignment, or D=100, off a multiple of 8) go
    to score_topk_stream by the route rule, before any launch, and agree
    with the plain version bit for bit (integer-valued inputs)."""
    gen = torch.Generator(device=cuda).manual_seed(q * 3 + k)
    n, dim = 50_001, 128 if offset == "element" else 100
    storage = torch.randint(-2, 3, ((n + 1) * dim,), device=cuda, generator=gen).bfloat16()
    skip = 1 if offset == "element" else 0
    docs = storage[skip:skip + n * dim].view(n, dim)
    queries = torch.randint(-2, 3, (q, dim), device=cuda, generator=gen).float()
    assert not topk.stream_mma_takes(docs.dtype, q, dim, docs.data_ptr())
    assert topk.call_plan(docs, q, k)[0] == topk.PASS_STREAM
    _on_tensor_cores(docs, queries, k, mma=False)


@pytest.mark.cuda
@pytest.mark.parametrize("q", [2, 3, 4])
@pytest.mark.parametrize("k", [1, 10, 11, 256])
@pytest.mark.parametrize("dim", [128, 1024])
def test_stream_mma_block_fits_without_spills(cuda, q, k, dim):
    """The tensor-core pass at Q = 2-4 and every width: no spills, the shared
    bytes of topk.stream_mma_smem, a block an SM, and its rings' 96 KB in
    flight an SM, over the ~18 KB the card needs."""
    block = topk.stream_mma_occupancy(cuda, q, dim, k)
    assert block["local_bytes"] == 0
    assert block["smem_bytes"] == topk.stream_mma_smem(q, dim, k)
    assert block["blocks_per_sm"] == 1
    in_flight = (block["blocks_per_sm"] * topk.STREAM_WARPS * (topk.STREAM_MMA_STAGES - 1)
                 * topk.STREAM_MMA_STAGE_BYTES)
    assert in_flight >= 18 * 1024


MERGE_CASES = [(q, s, k) for q in (1, 4, 5, 257) for s, k in MERGE_PLAN_CASES]


def _merge_bit_equal(cand_v, cand_i):
    want_v, want_i = topk.merge_topk_reference(cand_v, cand_i)
    before = topk.LAUNCHES
    got_v, got_i = topk.merge_topk_cuda(cand_v.clone(), cand_i.clone())  # level 1 writes in place
    torch.cuda.synchronize()
    assert topk.LAUNCHES == before + 1
    assert torch.equal(got_v.view(torch.int32), want_v.view(torch.int32))
    assert torch.equal(got_i, want_i)
    return got_v, got_i


@pytest.mark.cuda
@pytest.mark.parametrize("q,s,k", MERGE_CASES)
def test_merge_kernel_matches_plain_version(cuda, q, s, k):
    """Pass 2 alone on crafted lists with padding, one level or two, bit
    for bit the plain merge's result."""
    _merge_bit_equal(*_lists(q, s, k, "random", cuda, seed=q * 7919 + s * 31 + k))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["tied", "integer", "signed-zero"])
@pytest.mark.parametrize("q,s,k", [(1, 521, 256), (5, 33, 256), (4, 1024, 10), (257, 100, 64)])
def test_merge_kernel_breaks_ties_by_index(cuda, kind, q, s, k):
    """All values tied, few distinct integers, -0.0 beside +0.0: equal
    scores go to the lower index at every level of the tree, and -0.0
    keeps its sign bit."""
    got_v, _ = _merge_bit_equal(*_lists(q, s, k, kind, cuda, seed=s + k))
    if kind == "signed-zero":
        assert bool(torch.signbit(got_v[got_v == 0]).any())


@pytest.mark.cuda
@pytest.mark.parametrize("q", [1, 4, 5, 257])
@pytest.mark.parametrize("k", [10, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_merge_kernel_of_pass_one_candidates(cuda, q, k, dtype):
    """Pass 1's real lists (score_topk_candidates), merged by pass 2
    alone and by the plain merge, give score_topk_cuda's result and the
    plain version's, bit for bit (integer-valued inputs)."""
    gen = torch.Generator(device=cuda).manual_seed(q * 131 + k)
    docs = torch.randint(-2, 3, (100_003, 128), device=cuda, generator=gen).to(dtype)
    queries = torch.randint(-2, 3, (q, 128), device=cuda, generator=gen).float()
    cand_v, cand_i = topk.score_topk_candidates(docs, queries, k)
    got_v, got_i = _merge_bit_equal(cand_v, cand_i)
    want_v, want_i = score_topk_reference(docs, queries, k)
    assert torch.equal(got_v, want_v) and torch.equal(got_i, want_i)
    assert all(torch.equal(a, b) for a, b in zip(topk.score_topk_cuda(docs, queries, k),
                                                 (got_v, got_i)))


def _variants():
    from twotowers_tpu_torch.kernels import topk_variants
    return topk_variants


@pytest.mark.parametrize("name", sorted(_variants().VARIANTS))
def test_every_variant_rewrites_the_source_once(name):
    """kernels/topk_variants.py builds each variant by rewrites that must
    each find their text once in csrc/score_topk.cu: one that no longer
    fits would fail the chip run that times it."""
    variants = _variants()
    source = (Path(topk.__file__).resolve().parents[1] / "csrc" / "score_topk.cu").read_text()
    rewritten = variants.rewrite(name, source, variants.VARIANTS[name][0])
    assert (rewritten == source) == (not variants.VARIANTS[name][0])


def test_every_timed_shape_has_its_queries():
    """Every shape that kernels/topk_variants.py times draws its queries
    from make_corpus's batches."""
    variants = _variants()
    shapes = (variants.SHAPES + variants.K_SWEEP + variants.WIDE_SHAPES + variants.BAR_SWEEP
              + variants.ORDERED)
    assert {shape[0] for shape in shapes} <= set(variants.QUERY_COUNTS)


# ---- score_topk_tiles_ring: f32 docs at Q >= 5 and k <= WIDE_K ----------------

def test_ring_pass_code_mirrors_the_cuda_source():
    """score_topk_bar_launch's pass1 code of the ring pass is the wrapper's."""
    source = (Path(topk.__file__).resolve().parents[1] / "csrc" / "score_topk.cu").read_text()
    assert re.findall(r"^constexpr int PASS_TILES_RING = (\d+);", source, flags=re.M) == ["4"]
    assert topk.PASS_TILES_RING not in (topk.PASS_STREAM, topk.PASS_STREAM_MMA, topk.PASS_TILES)


def test_f32_narrow_calls_reach_no_pass_but_the_ring():
    """score_topk_bar_launch refuses f32 docs on PASS_TILES at k <= WIDE_K
    (the ring's calls), so score_topk_tiles<float, false> runs nowhere."""
    source = (Path(topk.__file__).resolve().parents[1] / "csrc" / "score_topk.cu").read_text()
    launch = source[source.index("int score_topk_bar_launch("):]
    launch = launch[:launch.index("return (int)cudaErrorInvalidValue;")]
    assert "|| (pass1 == PASS_TILES && !docs_bf16 && k <= WIDE_K)" in launch


@pytest.mark.parametrize("q,n,splits", [
    (257, 1_000_000, 53), (256, 1_000_000, 66), (33, 1_000_000, 261), (5, 250_000, 245)])
def test_ring_plan_is_the_tiles_rule_under_the_ring_block(q, n, splits):
    """The ring's plan is plan()'s one rule (the split count rounded up)
    under the block shape the ring reports, at 2 blocks an SM on 132 SMs:
    Q=257 takes 5 query blocks x 53 splits on 264 places."""
    block_queries, tile_docs = topk.ring_block(q)
    assert topk.plan(q, n, 132, 2, block_queries, tile_docs)[1] == splits


@pytest.mark.parametrize("q,split_len,block_queries,tile_docs,nbytes", [
    (5, 0, 32, 256, 82_992), (32, 1 << 20, 32, 256, 82_992), (33, 0, 64, 128, 58_416),
    (256, 32_767, 64, 128, 58_416), (257, 0, 64, 128, 58_416), (256, 32_768, 64, 192, 74_800),
    (33, 1 << 20, 64, 192, 74_800)])
def test_ring_smem_counts_stages_and_lists(q, split_len, block_queries, tile_docs, nbytes):
    """The ring pass's shared bytes (score_topk.cu's ring_smem_q): 1,024 to
    align the ring (TMA's 64-byte swizzle is read off the address), 4
    stages of the tile's doc rows and the block's query rows, 16 floats each
    ((256 + 32) x 64 bytes up to 32 queries, (128 + 64) x 64 above, (192 +
    64) x 64 above on splits of 32,768 docs or more: 6 docs a lane), 8 warps
    x a list of 16 values and indices for each of a warp's 8 queries (8,192
    bytes), then a full mbarrier and a count of readers a stage (48).
    Each shape leaves room for 2 blocks an SM, 16 warps."""
    assert topk.ring_block(q, split_len) == (block_queries, tile_docs)
    assert topk.ring_smem(q, split_len) == nbytes
    assert nbytes == 1024 + 4 * (4 * (tile_docs + block_queries) * 16 + 2 * 8 * 8 * 16) + 48
    assert 2 * (nbytes + BLOCK_RESERVED) <= SM_SHARED


def _ring_unit(r, u):  # score_topk.cu:ring_unit, float offset of unit u of doc row r
    return r * topk.RING_DEPTH + 4 * (u ^ ((r >> 1) & 3))


def test_ring_stage_layout_is_free_of_bank_conflicts():
    """A stage's doc rows: unit u of row r at float ring_unit(r, u). Each
    quarter-warp of a lane's 16-byte reads (rows lane + 32 jj, one unit)
    and each 8 threads' cp.async copies (row e / 4, unit e % 4 of e = tid
    + 256 i, in tiles of 192, 256 and 512 rows) fall on the 8 bank groups
    once; unit u of a row is its unit 0 XOR 4u and doc jj of a lane is 32
    jj rows past doc 0 at every unit, so its reads are one base (ring_unit
    of the lane's row, unit 0) XOR a constant plus a constant; a stage's
    units are each written once; and the swizzle is TMA's 64-byte one
    (address bits 4-5 XOR bits 7-8, the ring 1,024-byte aligned)."""
    units = topk.RING_DEPTH // 4
    for u in range(units):
        for lanes in (range(8 * j, 8 * j + 8) for j in range(4)):
            for jj in range(8):
                assert len({_ring_unit(lane + 32 * jj, u) // 4 % 8 for lane in lanes}) == 8
        for lane in range(32):
            assert _ring_unit(lane, u) == _ring_unit(lane, 0) ^ 4 * u
            for jj in range(8):
                assert (_ring_unit(lane + 32 * jj, u)
                        == _ring_unit(lane, u) + 32 * jj * topk.RING_DEPTH)
    for tile_docs in (192, 256, 512):
        for e0 in range(0, tile_docs * units, 8):
            assert len({_ring_unit(e // units, e % units) // 4 % 8
                        for e in range(e0, e0 + 8)}) == 8
        assert (sorted(_ring_unit(r, u) for r in range(tile_docs) for u in range(units))
                == list(range(0, tile_docs * topk.RING_DEPTH, 4)))
    for r in range(512):
        for u in range(units):
            plain = 64 * r + 16 * u  # the byte of unit u of row r, unswizzled
            assert 4 * _ring_unit(r, u) == plain ^ (((plain >> 7) & 3) << 4)


@pytest.mark.parametrize("q", [5, 32, 33, 256, 257])
@pytest.mark.parametrize("split_len", [0, 32_767, 32_768, 1 << 20])
def test_ring_block_covers_each_query_and_doc_of_a_tile_once(q, split_len):
    """Warp (qw, dw) = (warp % QW, warp / QW) of the 8 holds queries 8 qw ..
    8 qw + 7 and, lane l, docs 32 ND dw + 32 jj + l of a tile (ND =
    topk.ring_lane_docs: 4, or 6 above 32 queries on splits of 32,768 docs
    or more): every (query, doc) pair of the block's queries and tile
    once."""
    block_queries, tile_docs = topk.ring_block(q, split_len)
    query_warps, lane_docs = block_queries // 8, topk.ring_lane_docs(q, split_len)
    assert lane_docs == (6 if q > 32 and split_len >= 32_768 else 4)
    pairs = [(8 * (w % query_warps) + i, 32 * lane_docs * (w // query_warps) + 32 * jj + lane)
             for w in range(topk.RING_WARPS) for lane in range(32)
             for i in range(8) for jj in range(lane_docs)]
    assert len(set(pairs)) == len(pairs) == block_queries * tile_docs


def _ring_wavefronts(offsets, nbytes):
    """Shared-memory wavefronts of one warp-wide read: the lanes' float
    offsets, nbytes each; a bank (4 bytes) serves one word a wavefront to
    every lane that reads it, so a read takes as many wavefronts as its
    busiest bank has distinct words."""
    words = {}
    for at in offsets:
        for w in range(at, at + nbytes // 4):
            words.setdefault(w % 32, set()).add(w)
    return max(len(ws) for ws in words.values())


@pytest.mark.parametrize("lane_docs,wavefronts", [(4, 24), (6, 32)])
def test_ring_unit_product_reads_wavefronts(lane_docs, wavefronts):
    """A warp's reads of one unit of 4 columns, at the addresses
    ring_product computes: 8 query reads of 16 bytes (ring_unit(i, u), one
    address across the warp: a broadcast, one wavefront each) and ND doc
    reads (lane's base XOR 4u, 32 jj rows on: 32 rows, 4 wavefronts each),
    for 8 x ND x 4 FFMAs a lane: 24 wavefronts for 128 FFMAs at ND = 4, 32
    for 192 at 6. A lane reads 16 (8 + ND) bytes a unit, 1.5 bytes an FFMA
    at ND = 4 and 1.17 at 6."""
    for u in range(topk.RING_DEPTH // 4):
        total = sum(_ring_wavefronts([_ring_unit(i, u)] * 32, 16) for i in range(8))
        total += sum(_ring_wavefronts([(_ring_unit(lane, 0) ^ 4 * u) + 32 * jj * topk.RING_DEPTH
                                       for lane in range(32)], 16) for jj in range(lane_docs))
        assert total == wavefronts
    assert 16 * (8 + lane_docs) / (8 * lane_docs * 4) == {4: 1.5, 6: 14 / 12}[lane_docs]


@pytest.mark.parametrize("dtype,q,k,takes", [
    (torch.float32, 5, 10, True), (torch.float32, 256, 1, True), (torch.float32, 33, 14, True),
    (torch.float32, 5000, 5, True), (torch.float32, 256, 15, False),
    (torch.float32, 32, 256, False), (torch.bfloat16, 256, 10, False),
    (torch.bfloat16, 5, 14, False), (torch.float32, 4, 10, False), (torch.float32, 1, 10, False)])
def test_route_rule_sends_f32_batches_at_narrow_k_to_the_ring(dtype, q, k, takes):
    """f32 docs at Q >= 5 and k <= WIDE_K take score_topk_tiles_ring,
    whatever D and alignment; k > WIDE_K (the wide selection and its bar),
    bf16 docs (the tensor cores) and Q <= 4 keep their passes."""
    assert topk.ring_takes(dtype, q, k) is takes


@pytest.mark.parametrize("q", [5, 32, 33, 64, 256, 257, 5000])
@pytest.mark.parametrize("n", [1_000_000, 999_983, 200])
@pytest.mark.parametrize("blocks", [1, 2, 3])
def test_plan_of_the_ring_makes_one_wave(q, n, blocks):
    """Under the ring's block (its queries and tile, as its occupancy entry
    reports them) the plan covers the docs in whole tiles and makes about
    one wave: short of a query block at most past the blocks that fit on
    132 SMs, and at 1M docs and up to 8 query blocks at least 90% of them
    (splits are whole tiles of up to 512 docs: 245 of 264 at Q=32)."""
    block_queries, tile_docs = topk.ring_block(q)
    rows, n_splits, split_len = topk.plan(q, n, 132, blocks, block_queries, tile_docs)
    q_blocks = -(-q // block_queries)
    assert rows == 8 and split_len % tile_docs == 0
    assert (n_splits - 1) * split_len < n <= n_splits * split_len
    assert 1 <= n_splits <= topk.MAX_SPLITS
    assert q_blocks * n_splits < 132 * blocks + q_blocks
    if n >= 1_000_000 and q_blocks <= 8:
        assert q_blocks * n_splits >= 0.9 * 132 * blocks


def _ranks_before(a, b):  # score_topk.cu:ranks_before on (value, index) pairs
    return a[0] > b[0] or (a[0] == b[0] and a[1] < b[1])


def _ring_insert(lanes, pair, k):
    """score_topk.cu:ring_insert on a warp's 32 lanes of (value, index)."""
    p = sum(1 for e in range(32) if e < k and _ranks_before(lanes[e], pair))
    up = [lanes[0]] + lanes[:31]  # __shfl_up_sync by 1: lane 0 keeps its own
    return [pair if e == p else up[e] if e > p else lanes[e] for e in range(32)]


def _ring_rounds(lanes, survivors, k):
    """score_topk.cu:ring_rounds: k rounds, each every lane's best candidate
    left (its list pair below k, its surviving docs), the warp's best of
    them to lane r, dropped by the lane that held it."""
    pad = (-math.inf, topk.NO_INDEX)
    own = [lane < k for lane in range(32)]
    left = [[pair for pair in survivors if pair[1] % 32 == lane] for lane in range(32)]
    out = [pad] * 32
    for r in range(k):
        best = []
        for lane in range(32):
            b = lanes[lane] if own[lane] else pad
            for pair in left[lane]:
                if _ranks_before(pair, b):
                    b = pair
            best.append(b)
        win = best[0]
        for b in best[1:]:
            if _ranks_before(b, win):
                win = b
        out[r] = win
        for lane in range(32):
            if best[lane] == win:
                if own[lane] and lanes[lane] == win:
                    own[lane] = False
                elif win in left[lane]:
                    left[lane].remove(win)
    return out


def _ring_warp_lists(scores, k, t0s, end, n_docs):
    """score_topk.cu:ring_select over a warp's tiles, lane by lane: scores[t]
    is (8 queries, jj, 32 lanes) of tile t, doc t0s[t] + 32 jj + lane.
    Returns each query's list of k pairs as the kernel writes it."""
    pad = (-math.inf, topk.NO_INDEX)
    lists = [[pad] * topk.RING_LIST for _ in range(8)]
    for t0, tile in zip(t0s, scores):
        for i in range(8):
            bar = lists[i][k - 1]
            tops = [max([-1e30] + [float(tile[i, jj, lane]) for jj in range(tile.shape[1])])
                    for lane in range(32)]
            if not any(top >= bar[0] for top in tops):  # no score reaches the bar's value
                continue
            survivors = []
            for jj in range(tile.shape[1]):
                for lane in range(32):
                    doc = t0 + 32 * jj + lane
                    s = float(tile[i, jj, lane]) if doc < n_docs else -1e30
                    if doc < end and _ranks_before((s, doc), bar):
                        survivors.append((s, doc))
            if not survivors:
                continue
            lanes = [lists[i][e % topk.RING_LIST] for e in range(32)]
            if len(survivors) > 2 * k:  # a flood: k rounds of the warp's best
                lanes = _ring_rounds(lanes, survivors, k)
            else:
                for pair in survivors:  # jj, then lane: doc order
                    lanes = _ring_insert(lanes, pair, k)
            lists[i][:k] = lanes[:k]
    return [lst[:k] for lst in lists]


@pytest.mark.parametrize("lane_docs", [topk.RING_LANE_DOCS, topk.RING_LONG_LANE_DOCS])
@pytest.mark.parametrize("kind", ["random", "integer", "tied", "signed-zero"])
@pytest.mark.parametrize("k", [1, 10, 14])
def test_ring_selection_keeps_each_querys_top_k(lane_docs, kind, k):
    """The ring's selection, run lane by lane on a warp's 3 tiles of 4 or 6
    docs a lane (the last cut short by `end`, rows past n_docs masked; the
    first tile's flood merged by rounds, later survivors by rounds or
    inserts), then a second doc warp's lists inserted as at the split's
    end, leaves each query's top-k of its docs by ranks_before, best first:
    ties to the lower index, -0.0 tied with +0.0."""
    rng = np.random.default_rng(k)
    shape = (3, 8, lane_docs, 32)
    scores = {"random": rng.normal(size=shape), "integer": rng.integers(-2, 3, size=shape),
              "tied": np.ones(shape),
              "signed-zero": np.where(rng.random(shape) < 0.5, -0.0, 0.0)}[kind]
    scores = scores.astype(np.float32)
    warp_docs = 32 * lane_docs  # a tile of two doc warps
    end, n_docs = 4 * warp_docs + warp_docs // 2 + 8, 4 * warp_docs + warp_docs // 4 + 6
    firsts = ([0, 2 * warp_docs, 4 * warp_docs], [warp_docs, 3 * warp_docs, 5 * warp_docs])
    lists = [_ring_warp_lists(scores, k, firsts[0], end, n_docs),
             _ring_warp_lists(scores[:, ::-1], k, firsts[1], end, n_docs)]
    for i in range(8):
        lanes = lists[0][i] + [(-math.inf, topk.NO_INDEX)] * (32 - k)
        for pair in lists[1][i]:
            lanes = _ring_insert(lanes, pair, k)
        pairs = []
        for w, t0s in enumerate(firsts):
            tiles = scores if w == 0 else scores[:, ::-1]
            for t, t0 in enumerate(t0s):
                for jj in range(lane_docs):
                    for lane in range(32):
                        doc = t0 + 32 * jj + lane
                        if doc < end:
                            pairs.append((float(tiles[t, i, jj, lane]) if doc < n_docs
                                          else -1e30, doc))
        want = sorted(pairs, key=lambda p: (-p[0], p[1]))[:k]
        assert lanes[:k] == want


def _ring_bit_equal(docs, queries, k, n_docs=None):
    """score_topk on f32 docs through the ring pass: one launch, pass 1 on
    score_topk_tiles_ring, the plain version's result bit for bit."""
    before, ring_before = topk.LAUNCHES, topk.RING_LAUNCHES
    got = _bit_equal(docs, queries, k, n_docs)
    assert (topk.LAUNCHES - before, topk.RING_LAUNCHES - ring_before) == (1, 1)
    return got


RING_EDGE_CASES = [(q, dim, k, off) for q in (5, 33, 257) for dim in (1, 100, 128, 129, 1024)
                   for k in (1, 10, 14) for off in (-1, 1)]


@pytest.mark.cuda
@pytest.mark.parametrize("q,dim,k,off", RING_EDGE_CASES)
def test_ring_kernel_is_the_plain_version_bit_for_bit(cuda, q, dim, k, off):
    """The ring pass at N = 256 m +- 1 (a ragged last tile of either
    block shape), D across its 16-column stages (D=1, 129: 4-byte copies;
    100: a zero-filled unit), k up to WIDE_K, Q=5 and 33 (one query block,
    4 x 2 and 8 x 1 warps) and 257 (a ragged last block). Integer-valued
    inputs sum exactly in any order: the plain version's result bit for
    bit."""
    gen = torch.Generator(device=cuda).manual_seed(q * 7907 + dim * 37 + k + off)
    n = 256 * (150 if dim == 1024 else 600) + off
    docs = torch.randint(-2, 3, (n, dim), device=cuda, generator=gen).float()
    queries = torch.randint(-2, 3, (q, dim), device=cuda, generator=gen).float()
    _ring_bit_equal(docs, queries, k)


@pytest.mark.cuda
@pytest.mark.parametrize("q", [64, 1024, 2048])
@pytest.mark.parametrize("k", [1, 10, 14])
def test_ring_kernel_over_a_million_docs_is_the_plain_version(cuda, q, k):
    """The ring pass at N = 1,000,003, D=128 (splits of whole tiles and a
    ragged last one), Q=64 (one query block of 8 x 1 warps), 1024 (16 of
    them) and 2048 (32; these two on splits of 32,768 docs or more: 6 docs
    a lane, tiles of 192, a ragged last tile in every split):
    integer-valued inputs, the plain version's result bit for bit."""
    gen = torch.Generator(device=cuda).manual_seed(q * 31 + k)
    docs = torch.randint(-2, 3, (1_000_003, 128), device=cuda, generator=gen).float()
    queries = torch.randint(-2, 3, (q, 128), device=cuda, generator=gen).float()
    _ring_bit_equal(docs, queries, k)


@pytest.mark.cuda
@pytest.mark.parametrize("q", [5, 32, 257])
@pytest.mark.parametrize("k", [1, 14])
def test_ring_kernel_masks_rows_past_n_docs(cuda, q, k):
    """Rows at or past n_docs score -1e30 in the ring pass too, though
    they would win unmasked."""
    gen = torch.Generator(device=cuda).manual_seed(q + k)
    docs = torch.randint(-2, 3, (256 * 40 + 1, 64), device=cuda, generator=gen).float()
    docs[5000:] = 50.0
    queries = torch.randint(-2, 3, (q, 64), device=cuda, generator=gen).float()
    got_s, _ = _ring_bit_equal(docs, queries, k, 5000)
    assert bool((got_s < 1e4).all())


@pytest.mark.cuda
@pytest.mark.parametrize("q", [5, 33, 257])
@pytest.mark.parametrize("k", [1, 10, 14])
def test_ring_kernel_breaks_ties_to_the_lower_index(cuda, q, k):
    """Every score ties (and zeros of either sign tie): the first k docs in
    order, bit for bit the plain version's."""
    docs = torch.zeros(8192, 16, device=cuda)
    docs[:, 0] = 1.0
    queries = torch.zeros(q, 16, device=cuda)
    queries[:, 0] = 1.0
    _, got_i = _ring_bit_equal(docs, queries, k)
    assert torch.equal(got_i.cpu(), torch.arange(k, dtype=torch.int32).repeat(q, 1))
    signed = torch.zeros(8192, 16, device=cuda)
    signed[1::2, 0] = -0.0
    _, got_i = _ring_bit_equal(signed, queries, k)
    assert torch.equal(got_i.cpu(), torch.arange(k, dtype=torch.int32).repeat(q, 1))


@pytest.mark.cuda
@pytest.mark.parametrize("q", [5, 33, 257])
@pytest.mark.parametrize("dim", [64, 100])
def test_ring_kernel_reads_docs_off_16_byte_alignment(cuda, q, dim):
    """Docs and queries viewed one float past a 16-byte boundary take the
    ring's 4-byte copies: still the ring pass, still bit-equal."""
    gen = torch.Generator(device=cuda).manual_seed(q * 3 + dim)
    n = 256 * 200 + 1
    flat = torch.randint(-2, 3, (n * dim + 1,), device=cuda, generator=gen).float()
    docs = flat[1:].view(n, dim)
    qflat = torch.randint(-2, 3, (q * dim + 1,), device=cuda, generator=gen).float()
    queries = qflat[1:].view(q, dim)
    assert docs.data_ptr() % 16 != 0 and queries.data_ptr() % 16 != 0
    _ring_bit_equal(docs, queries, 10)


@pytest.mark.cuda
@pytest.mark.parametrize("q", [5, 32, 33, 257])
@pytest.mark.parametrize("k", [1, 10, 14])
def test_ring_pass_one_lists_are_each_splits_top_k(cuda, q, k):
    """Pass 1 alone on the ring (score_topk_candidates) bit for bit the
    plain per-split top-k under the call's plan, rows past n_docs masked,
    a split shorter than k padded (integer-valued inputs)."""
    gen = torch.Generator(device=cuda).manual_seed(q * 53 + k)
    docs = torch.randint(-2, 3, (100_003, 64), device=cuda, generator=gen).float()
    queries = torch.randint(-2, 3, (q, 64), device=cuda, generator=gen).float()
    ring_before = topk.RING_LAUNCHES
    got_v, got_i = topk.score_topk_candidates(docs, queries, k, 99_000)
    assert topk.RING_LAUNCHES == ring_before + 1
    pass1, _, split_len = topk.call_plan(docs, q, k)
    assert pass1 == topk.PASS_TILES_RING
    want_v, want_i = topk.candidates_reference(docs, queries, k, split_len, 99_000)
    assert torch.equal(got_v.view(torch.int32), want_v.view(torch.int32))
    assert torch.equal(got_i, want_i)


@pytest.mark.cuda
@pytest.mark.parametrize("q", [32, 256, 33, 257])
@pytest.mark.parametrize("off", [-1, 1])
def test_ring_kernel_float_data_agrees(cuda, q, off):
    """Float data at D=128 over N = 256 m +- 1: each sum is an IEEE f32
    fmaf chain in ascending d, another order than cuBLAS's, so scores
    within rtol 1e-5, atol 1e-6 and indices equal but for near-ties
    (topk.agree)."""
    gen = torch.Generator(device=cuda).manual_seed(q + off)
    n = 256 * 2000 + off
    docs = torch.randn(n, 128, device=cuda, generator=gen)
    docs /= docs.norm(dim=1, keepdim=True)
    queries = torch.randn(q, 128, device=cuda, generator=gen)
    queries /= queries.norm(dim=1, keepdim=True)
    ring_before = topk.RING_LAUNCHES
    got = score_topk(docs, queries, 10)
    torch.cuda.synchronize()
    assert topk.RING_LAUNCHES == ring_before + 1
    topk.agree(docs, queries, got, score_topk_reference(docs, queries, 10))


@pytest.mark.cuda
@pytest.mark.parametrize("q", [5, 32, 33, 256])
@pytest.mark.parametrize("k", [1, 10, 14])
@pytest.mark.parametrize("split_len", [0, 1 << 20])
def test_ring_block_fits_without_spills(cuda, q, k, split_len):
    """Each block of the ring pass (up to 32 queries; above, on short and on
    long splits, the last with 6 docs a lane): no spills, at most 128
    registers, the shared bytes and the shape of topk.ring_smem and
    topk.ring_block, and 2 blocks an SM (16 warps)."""
    block = topk.ring_occupancy(cuda, q, k, split_len)
    assert block["local_bytes"] == 0 and block["registers"] <= 128
    assert block["smem_bytes"] == topk.ring_smem(q, split_len)
    assert (block["block_queries"], block["tile_docs"]) == topk.ring_block(q, split_len)
    assert block["blocks_per_sm"] >= 2
