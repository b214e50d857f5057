"""Wrapper of the fused score + top-k CUDA kernel (``csrc/score_topk.cu``).

The Hopper counterpart of ``twotowers_tpu/kernels/pallas_topk.py``. It
computes exactly ``ops.topk_score.score_topk_reference``: queries cast to
the docs' dtype, products summed in float32, rows at or past ``n_docs``
scored -1e30, results best first with equal scores to the lower index.

The kernel takes f32 or bf16 docs, any ``N >= 1`` and ``Q >= 1``,
``1 <= k <= min(256, N)`` and ``D <= 1024``; outside those limits the
wrapper raises ``ValueError`` and hands nothing to the plain version. It
launches on the current stream, allocates outputs and scratch with
``torch.empty``, and raises if the launch returns a CUDA error.

Pass 1 is one of four kernels (``call_plan``): ``score_topk_stream`` at
Q <= 4, ``score_topk_stream_mma`` (the tensor cores) in its place for bf16
docs at Q = 2-4 whose rows allow 16-byte copies (``stream_mma_takes``, the
route rule), ``score_topk_tiles`` at Q >= 5, and ``score_topk_tiles_ring``
in its place for f32 docs at k <= ``WIDE_K`` (``ring_takes``: every batch
search).
Pass 1 leaves each query's ``(n_splits, k)`` sorted lists in scratch;
pass 2 merges them by a fixed tree (``merge_plan``). ``merge_topk_cuda``
runs pass 2 alone and ``merge_topk_reference`` is its plain version, for
the checks; ``score_topk_candidates`` runs pass 1 alone and
``candidates_reference`` is its plain version.

At Q >= 5, k > ``WIDE_K`` and splits of several tiles (``bar_plan``), a
call first runs both passes over a sample of the docs: the first tiles of
every split, or of every few splits, about ``BAR_DOCS`` docs spread over
the corpus whatever its order (``sample_topk``). Each query's k-th pair
there is its bar: k docs rank at or before it, so no doc that ranks after
it is in the top-k, and pass 1 over all N docs keeps only pairs at or
before it. Pass 2 then merges the same top-k, bit for bit, since the
sample's tiles lie at the main run's 256-row offsets, so the sample run
sums each (query, doc) pair as the main run does.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Callable, Dict, Optional, Tuple

import torch

from . import build

MAX_K = 256
MAX_DIM = 1024
MAX_SPLITS = 1024   # score_topk.cu:MAX_SPLITS
STREAM_ROWS = 128   # Q <= 4 splits are a whole number of these rows: one block
                    # iteration of score_topk_stream reads 64 (f32) or 128 (bf16)
BATCH_TILE_N = 256  # score_topk.cu:BN, doc rows per tile of the Q >= 5 pass 1
WIDE_K = 14         # score_topk.cu:WIDE_K: at Q >= 5, k above it selects by warps
STREAM_WIDE_K = 10  # score_topk.cu:STREAM_WIDE_K: at Q <= 4, k above it batches survivors
STREAM_QUEUE = 64   # score_topk.cu:STREAM_QUEUE: survivors a wide Q <= 4 warp queues a query
STREAM_WARPS = 8    # score_topk.cu:STREAM_WARPS, warps of a Q <= 4 block
TILE_QUEUE = 32     # score_topk.cu:TILE_QUEUE: survivors a wide Q >= 5 warp buffers a query
BAR_DOCS = 65_536      # docs of the largest sample whose k-th pairs bar a wide Q >= 5 call
BAR_MIN_DOCS = 8_192   # ... and of the smallest (bar_plan)
BAR_MIN_RATIO = 8      # ... that the docs a pass reads hold at least this many times
BAR_MIN_TILES = 4      # ... where the call's splits span at least this many tiles
STAGING_BYTES = 37_376  # score_topk.cu: 2 * STAGE floats of the Q >= 5 pass 1
MMA_DEPTH = 32      # score_topk.cu:MMA_DEPTH: depth of a bf16 Q >= 5 stage (256 doc
                    # and 32 query rows of 64 bytes, two stages within STAGING_BYTES)
STREAM_MMA_STAGES = 4   # score_topk.cu:STREAM_MMA_STAGES: stages of a warp's cp.async ring
STREAM_MMA_DEPTH = 64   # score_topk.cu:STREAM_MMA_DEPTH: columns of a stage (32 docs, 4 KB)
STREAM_MMA_STAGE_BYTES = 32 * STREAM_MMA_DEPTH * 2
RING_WARPS = 8      # score_topk.cu:RING_WARPS, warps of a score_topk_tiles_ring block
RING_STAGES = 4     # score_topk.cu:RING_STAGES: stages of its ring
RING_DEPTH = 16     # score_topk.cu:RING_DEPTH: columns of a stage
RING_LANE_DOCS = 4  # score_topk.cu:RING_LANE_DOCS: docs a lane multiplies by 8 queries ...
RING_LONG_SPLIT = 32_768  # score_topk.cu:RING_LONG_SPLIT: ... above RING_SMALL_Q on splits of
RING_LONG_LANE_DOCS = 6   # this many docs or more: this many (score_topk.cu)
RING_ALIGN = 1024   # score_topk.cu:RING_ALIGN: the ring's alignment in shared memory
RING_SMALL_Q = 32   # score_topk.cu:RING_SMALL_Q: Q up to this takes 4 warps of queries x 2
                    # of docs (32 queries), above it 8 x 1 (64 queries)
RING_LIST = 16      # score_topk.cu:RING_LIST: places of a query's list in a warp
# score_topk.cu's pass1 codes: the kernel that runs pass 1
PASS_STREAM, PASS_STREAM_MMA, PASS_TILES = 1, 2, 8
PASS_TILES_RING = 4

MERGE_SMEM_BUDGET = 110 * 1024  # shared bytes of a pass-2 block, at most: 2 blocks an SM
NO_INDEX = 2**31 - 1  # the index of a padding pair, beside the value -inf

# launches of the kernel so far (both passes, or one pass alone; a barred
# call counts its sample runs too); a run reads it to show it went through
# the kernel
LAUNCHES = 0
# ... of them, those whose pass 1 ran score_topk_stream_mma
STREAM_MMA_LAUNCHES = 0
# ... and those whose pass 1 ran score_topk_tiles_ring
RING_LAUNCHES = 0

_DTYPES = (torch.float32, torch.bfloat16)


def plan(n_queries: int, n: int, sm_count: int, blocks_per_sm: int,
         block_queries: int = 32, tile_docs: int = BATCH_TILE_N) -> Tuple[int, int, int]:
    """(rows_per_thread, n_splits, split_len) for a call.

    Q <= 4 takes ``score_topk_stream`` or ``score_topk_stream_mma`` (all
    the queries in one block, splits a whole number of ``STREAM_ROWS``
    docs); Q >= 5 takes a block of ``block_queries`` queries that reads
    tiles of ``tile_docs`` docs: ``score_topk_tiles`` (32 and
    ``BATCH_TILE_N``, the defaults) or ``score_topk_tiles_ring`` (the shape
    ``ring_occupancy`` reports). Each aims at ``blocks_per_sm``, the blocks
    of its pass that fit on an SM at once (``stream_occupancy``,
    ``stream_mma_occupancy``, ``tiles_occupancy`` or ``ring_occupancy``):
    about one wave of splits, each as long as it can be, the split count
    rounded up. The doc axis is cut into that many splits, each a whole
    number of tiles.
    """
    if n_queries <= 4:
        rows, tile, q_blocks = 1, STREAM_ROWS, 1
    else:
        rows, tile, q_blocks = 8, tile_docs, -(-n_queries // block_queries)
    want = -(-sm_count * max(1, blocks_per_sm) // q_blocks)
    tiles = -(-n // tile)
    n_splits = max(1, min(want, tiles, MAX_SPLITS))
    split_len = -(-tiles // n_splits) * tile
    return rows, -(-n // split_len), split_len


def tiles_smem(k: int) -> int:
    """Shared bytes of a Q >= 5 pass-1 block at this ``k``, for f32 and
    bf16 docs alike (``score_topk.cu:tiles_smem``): the staging buffers
    (the bf16 kernel's two cp.async stages fit in them), then the lists of
    the instantiation that k takes. Above ``WIDE_K`` the wide selection's
    32 lists of values and indices and 32 buffers of ``TILE_QUEUE``, each
    with a padding word after every 32 pairs, then each query's bar (a
    value and an index) and buffer count; else the narrow one's lists and
    two counts a query."""
    if k > WIDE_K:
        return STAGING_BYTES + 8 * 32 * (list_stride(k) + list_stride(TILE_QUEUE)) + 12 * 32
    return STAGING_BYTES + 8 * 32 * k + 8 * 32


def bar_plan(n_queries: int, k: int, n: int, n_splits: int, split_len: int, split_docs: int,
             max_docs: int = BAR_DOCS, min_docs: int = BAR_MIN_DOCS,
             min_ratio: int = BAR_MIN_RATIO,
             min_tiles: int = BAR_MIN_TILES) -> Optional[Tuple[int, int, int]]:
    """The sample whose k-th pairs bar a Q >= 5 pass 1 that runs
    ``n_splits`` splits, split s over docs [s split_len, s split_len +
    split_docs) cut at N: the sample run's own (n_splits, split_len,
    split_docs), or None for no bar.

    Only the wide selection takes a bar (Q >= 5, k > ``WIDE_K``), and only
    where a split spans at least ``min_tiles`` tiles of ``BATCH_TILE_N``:
    a shorter one admits few pairs it could save, and the sample run's
    latency is not paid back. The sample holds about ``rows`` docs, the
    largest of ``max_docs``, its half and so on down to ``min_docs`` that
    the docs the pass reads hold ``min_ratio`` times (none if below a
    tile): the first
    ceil(tiles / n_splits) tiles of every split, or the first tile of
    every (n_splits // tiles)-th split where there are more splits than
    tiles. So it is spread over the corpus, a fair sample of a corpus in
    topic or time order too, and its tiles lie at the pass's own 256-row
    offsets. A sample run's splits are long enough at Q=256 over 1M docs
    (8 tiles) to be barred in turn."""
    if n_queries <= 4 or k <= WIDE_K or split_docs < min_tiles * BATCH_TILE_N:
        return None
    last = (n_splits - 1) * split_len  # every split but the last reads split_docs
    covered = (n_splits - 1) * split_docs + min(split_docs, n - last)
    rows = max_docs
    while rows > min_docs and min_ratio * rows > covered:
        rows //= 2
    if min_ratio * rows > covered or rows < BATCH_TILE_N:  # a whole tile: k docs or more
        return None
    tiles = rows // BATCH_TILE_N
    step = max(1, n_splits // tiles)
    return -(-n_splits // step), step * split_len, -(-tiles // n_splits) * BATCH_TILE_N


Bar = Tuple[torch.Tensor, torch.Tensor]
Launch = Callable[[int, int, int, Optional[Bar]], Tuple[torch.Tensor, torch.Tensor]]


def sample_topk(launch: Launch, n_queries: int, k: int, n: int, n_splits: int, split_len: int,
                split_docs: int, **rule) -> Optional[Tuple[torch.Tensor, torch.Tensor, tuple]]:
    """The run of both passes over the sample that bars a pass 1 under
    (n_splits, split_len, split_docs) (``bar_plan``, ``rule`` its
    keywords): (out_v, out_i, sample plan), or None where it takes none.
    ``launch(n_splits, split_len, split_docs, bar)`` runs both passes under
    a plan and returns (out_v, out_i); the sample run is barred in turn by
    the same rule. Each query's bar is its k-th pair here (``kth``)."""
    sample = bar_plan(n_queries, k, n, n_splits, split_len, split_docs, **rule)
    if sample is None:
        return None
    inner = sample_topk(launch, n_queries, k, n, *sample, **rule)
    return (*launch(*sample, kth(inner, k)), sample)


def kth(top, k: int) -> Optional[Bar]:
    """Each query's k-th pair of a ``sample_topk`` run, read in place
    (stride k: no copy, no host read), or None for none."""
    return None if top is None else (top[0][:, k - 1], top[1][:, k - 1])


def list_stride(k: int) -> int:
    """Words of a skewed list of ``k`` pairs' values (or indices): a padding
    word after every 32 (``score_topk.cu:list_stride``)."""
    return k + -(-k // 32)


def stream_smem(n_queries: int, dim: int, k: int) -> int:
    """Shared bytes of a Q <= 4 pass-1 block (``score_topk.cu:stream_smem``):
    the queries widened to f32 and zero-padded to whole 128 columns, then
    the lists of the selection that k takes. Above ``STREAM_WIDE_K`` each
    warp's skewed list of k values and indices and its queue of
    ``STREAM_QUEUE`` a query; else each warp's list of k and its fill
    count a query."""
    dpad = -(-dim // 128) * 128
    return 4 * n_queries * dpad + _stream_lists(n_queries, k, k > STREAM_WIDE_K)


def stream_mma_takes(dtype: torch.dtype, n_queries: int, dim: int, docs_ptr: int) -> bool:
    """The Q <= 4 pass's route rule: ``score_topk_stream_mma`` (the tensor
    cores) takes bf16 docs at Q = 2-4 whose rows and pointer allow its
    16-byte copies (D a multiple of 8, the pointer 16-byte aligned); every
    other Q <= 4 call, f32 or Q = 1 or off alignment, stays on
    ``score_topk_stream``. Decided before any launch: a launch that fails
    raises, it never picks the route."""
    return dtype == torch.bfloat16 and 2 <= n_queries <= 4 and dim % 8 == 0 \
        and docs_ptr % 16 == 0


def ring_takes(dtype: torch.dtype, n_queries: int, k: int) -> bool:
    """The Q >= 5 pass's route rule: ``score_topk_tiles_ring`` takes f32
    docs at Q >= 5 and k <= ``WIDE_K`` (every batch search; any D and
    alignment: off 16 bytes its copies are 4 bytes each); bf16 docs and k >
    ``WIDE_K`` stay on ``score_topk_tiles``, Q <= 4 on the stream passes."""
    return dtype == torch.float32 and n_queries > 4 and k <= WIDE_K


def ring_lane_docs(n_queries: int, split_len: int = 0) -> int:
    """Docs a lane of the ``score_topk_tiles_ring`` block multiplies (by 8
    queries) in a call of n_queries over splits of split_len docs
    (``score_topk.cu:ring_kernel``): ``RING_LONG_LANE_DOCS`` above
    ``RING_SMALL_Q`` queries on splits of ``RING_LONG_SPLIT`` docs or more,
    where the product outweighs the selection most, else
    ``RING_LANE_DOCS``. The plan follows the block of split_len 0, so a
    long split's last tile may be ragged."""
    long_split = n_queries > RING_SMALL_Q and split_len >= RING_LONG_SPLIT
    return RING_LONG_LANE_DOCS if long_split else RING_LANE_DOCS


def ring_block(n_queries: int, split_len: int = 0) -> Tuple[int, int]:
    """(block_queries, tile_docs) of that ``score_topk_tiles_ring`` block
    (``score_topk.cu:Ring``): 4 warps of 8 queries x 2 warps of 32
    ``ring_lane_docs`` docs up to ``RING_SMALL_Q`` queries, else 8 x 1."""
    query_warps = 4 if n_queries <= RING_SMALL_Q else RING_WARPS
    return (8 * query_warps,
            32 * ring_lane_docs(n_queries, split_len) * (RING_WARPS // query_warps))


def ring_smem(n_queries: int, split_len: int = 0) -> int:
    """Shared bytes of that ``score_topk_tiles_ring`` block
    (``score_topk.cu:ring_smem_q``): room to align the ring to
    ``RING_ALIGN``, ``RING_STAGES`` stages of the tile's doc rows and the
    block's query rows, ``RING_DEPTH`` floats each, every warp's 8 lists of
    ``RING_LIST`` values and indices, then a full mbarrier (8 bytes) and a
    count of readers (4) a stage."""
    block_queries, tile_docs = ring_block(n_queries, split_len)
    return RING_ALIGN + 4 * (RING_STAGES * (tile_docs + block_queries) * RING_DEPTH
                             + 2 * RING_WARPS * 8 * RING_LIST) + 12 * RING_STAGES


def stream_mma_smem(n_queries: int, dim: int, k: int) -> int:
    """Shared bytes of a ``score_topk_stream_mma`` block
    (``score_topk.cu:stream_mma_smem``): 8 warps' rings of
    ``STREAM_MMA_STAGES`` stages of 4 KB, the queries' bf16 rows (D rounded
    up to whole ``STREAM_MMA_DEPTH``, plus 16 elements), then the wide
    selection's lists and queues, as ``stream_smem`` counts them (the
    kernel selects by the wide selection at every k)."""
    dpad = -(-dim // STREAM_MMA_DEPTH) * STREAM_MMA_DEPTH
    rings = STREAM_WARPS * STREAM_MMA_STAGES * STREAM_MMA_STAGE_BYTES
    return rings + 2 * n_queries * (dpad + 16) + _stream_lists(n_queries, k, True)


def _stream_lists(n_queries: int, k: int, wide: bool) -> int:
    lists = STREAM_WARPS * n_queries
    if wide:
        return 8 * lists * (list_stride(k) + list_stride(STREAM_QUEUE))
    return 8 * lists * k + 4 * lists


def merge_smem(lists: int, k: int) -> int:
    """Shared bytes of a pass-2 block over ``lists`` lists of ``k`` pairs
    (``score_topk.cu:merge_smem``): values and indices of the lists, then
    of the ``ceil(lists / 2)`` lists of its first round, each plane with a
    padding word after every 32 pairs and rounded up to whole 16-byte
    units."""
    plane = lambda n: -(-(n - (-n // 32)) // 4) * 4  # noqa: E731
    return 8 * (plane(lists * k) + plane(-(-lists // 2) * k))


@functools.lru_cache(maxsize=None)
def merge_plan(n_splits: int, k: int) -> Tuple[int, int, int]:
    """(group, levels, smem_bytes) of pass 2 over ``n_splits`` lists of k.

    One level, one block a query over every list, where their shared
    memory fits ``MERGE_SMEM_BUDGET``. Else two: level 1 merges groups of
    ``group`` lists, one block per query and group, and the last level
    merges the groups' winners. The groups are as few as fit when each
    holds at most the widest power of two that fits, so that the two
    levels take ceil(log2(n_splits)) rounds in all, and of even sizes (the
    last may be shorter). ``smem_bytes`` is the larger level's block.
    """
    if not 1 <= n_splits <= MAX_SPLITS or not 1 <= k <= MAX_K:
        raise ValueError(f"merge_plan: needs 1 <= n_splits <= {MAX_SPLITS} and "
                         f"1 <= k <= {MAX_K}, got {n_splits} and {k}")
    if merge_smem(n_splits, k) <= MERGE_SMEM_BUDGET:
        return n_splits, 1, merge_smem(n_splits, k)
    widest = 2
    while merge_smem(2 * widest, k) <= MERGE_SMEM_BUDGET:
        widest *= 2
    groups = -(-n_splits // widest)
    group = -(-n_splits // groups)
    groups = -(-n_splits // group)
    return group, 2, max(merge_smem(group, k), merge_smem(groups, k))


def check_args(doc_matrix: torch.Tensor, queries: torch.Tensor, k: int) -> None:
    """Raise ValueError for a call the kernel does not take."""
    if doc_matrix.dim() != 2 or queries.dim() != 2:
        raise ValueError("score_topk: docs must be (N, D) and queries (Q, D)")
    n, dim = doc_matrix.shape
    if queries.shape[1] != dim:
        raise ValueError(f"score_topk: queries have D={queries.shape[1]}, docs D={dim}")
    if doc_matrix.dtype not in _DTYPES:
        raise ValueError(f"score_topk: docs must be float32 or bfloat16, got {doc_matrix.dtype}")
    if not 1 <= dim <= MAX_DIM:
        raise ValueError(f"score_topk: the kernel takes 1 <= D <= {MAX_DIM}, got D={dim}")
    if not 1 <= n < 2**31:
        raise ValueError(f"score_topk: the kernel takes 1 <= N < 2**31, got N={n}")
    if queries.shape[0] < 1:
        raise ValueError("score_topk: the kernel takes Q >= 1")
    if not 1 <= k <= min(MAX_K, n):
        raise ValueError(f"score_topk: the kernel takes 1 <= k <= min({MAX_K}, N={n}), got k={k}")
    if not doc_matrix.is_contiguous():
        raise ValueError("score_topk: docs must be contiguous")


def _lib() -> ctypes.CDLL:
    lib = build.load("score_topk")
    fn = lib.score_topk_bar_launch
    if fn.argtypes is None:
        ptr, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        fn.argtypes = [ptr, ptr, i32, i64, i32, i32, i32, i64, i32, i64, i32,
                       ptr, ptr, ptr, ptr, i32, ptr, ptr, i64, i64, ptr]
        fn.restype = i32
        occ = lib.score_topk_tiles_occupancy
        occ.argtypes = [i32, i32] + [ctypes.POINTER(i32)] * 4
        occ.restype = i32
        occ = lib.score_topk_stream_occupancy
        occ.argtypes = [i32, i32, i32, i32] + [ctypes.POINTER(i32)] * 4
        occ.restype = i32
        occ = lib.score_topk_stream_mma_occupancy
        occ.argtypes = [i32, i32, i32] + [ctypes.POINTER(i32)] * 4
        occ.restype = i32
        occ = lib.score_topk_tiles_ring_split_occupancy
        occ.argtypes = [i32, ctypes.c_longlong, i32] + [ctypes.POINTER(i32)] * 6
        occ.restype = i32
        merge = lib.score_topk_merge_launch
        merge.argtypes = [ptr, ptr, i32, i32, i32, i32, ptr, ptr, ptr]
        merge.restype = i32
        occ = lib.score_topk_merge_occupancy
        occ.argtypes = [i32, i32, i32] + [ctypes.POINTER(i32)] * 4
        occ.restype = i32
    return lib


_OCCUPANCY_KEYS = ("smem_bytes", "blocks_per_sm", "registers", "local_bytes")
_occupancy: Dict[Tuple[int, bool, int], Dict[str, int]] = {}
_stream_occupancy: Dict[Tuple[int, bool, int, int, int], Dict[str, int]] = {}
_stream_mma_occupancy: Dict[Tuple[int, int, int, int], Dict[str, int]] = {}
_ring_occupancy: Dict[Tuple[int, Tuple[int, int]], Dict[str, int]] = {}


def tiles_occupancy(device: torch.device, dtype: torch.dtype, k: int) -> Dict[str, int]:
    """A Q >= 5 pass-1 block for docs of ``dtype`` at this ``k`` on the
    card (the instantiation that k takes: the wide selection above
    ``WIDE_K``), as the CUDA runtime reports it: ``smem_bytes``,
    ``blocks_per_sm`` (registers and shared memory both count),
    ``registers`` a thread and ``local_bytes`` a thread (spills)."""
    key = (torch.device(device).index or 0, dtype == torch.bfloat16, k)
    if key not in _occupancy:
        out = [ctypes.c_int() for _ in range(4)]
        with torch.cuda.device(device):
            err = _lib().score_topk_tiles_occupancy(int(key[1]), k, *map(ctypes.byref, out))
        if err != 0:
            raise RuntimeError(f"score_topk occupancy query failed with cudaError_t {err}")
        _occupancy[key] = dict(zip(_OCCUPANCY_KEYS, (o.value for o in out)))
    return _occupancy[key]


def stream_occupancy(device: torch.device, dtype: torch.dtype, n_queries: int, dim: int,
                     k: int) -> Dict[str, int]:
    """A Q <= 4 pass-1 block for ``n_queries`` queries at this ``dim`` and
    ``k`` on the card, as the CUDA runtime reports it: ``smem_bytes``,
    ``blocks_per_sm``, ``registers`` a thread and ``local_bytes`` a thread
    (spills)."""
    dpad = -(-dim // 128) * 128  # shared memory depends on D through its padding
    key = (torch.device(device).index or 0, dtype == torch.bfloat16, n_queries, dpad, k)
    if key not in _stream_occupancy:
        out = [ctypes.c_int() for _ in range(4)]
        with torch.cuda.device(device):
            err = _lib().score_topk_stream_occupancy(int(key[1]), n_queries, dpad, k,
                                                     *map(ctypes.byref, out))
        if err != 0:
            raise RuntimeError(f"score_topk occupancy query failed with cudaError_t {err}")
        _stream_occupancy[key] = dict(zip(_OCCUPANCY_KEYS, (o.value for o in out)))
    return _stream_occupancy[key]


def stream_mma_occupancy(device: torch.device, n_queries: int, dim: int,
                         k: int) -> Dict[str, int]:
    """A ``score_topk_stream_mma`` block (bf16 docs, Q = 2-4) at this
    ``dim`` and ``k`` on the card, as the CUDA runtime reports it: the keys
    of ``stream_occupancy``."""
    dpad = -(-dim // STREAM_MMA_DEPTH) * STREAM_MMA_DEPTH
    key = (torch.device(device).index or 0, n_queries, dpad, k)
    if key not in _stream_mma_occupancy:
        out = [ctypes.c_int() for _ in range(4)]
        with torch.cuda.device(device):
            err = _lib().score_topk_stream_mma_occupancy(n_queries, dpad, k,
                                                         *map(ctypes.byref, out))
        if err != 0:
            raise RuntimeError(f"score_topk occupancy query failed with cudaError_t {err}")
        _stream_mma_occupancy[key] = dict(zip(_OCCUPANCY_KEYS, (o.value for o in out)))
    return _stream_mma_occupancy[key]


def ring_occupancy(device: torch.device, n_queries: int, k: int,
                   split_len: int = 0) -> Dict[str, int]:
    """A ``score_topk_tiles_ring`` block for ``n_queries`` over splits of
    ``split_len`` docs (f32 docs, k <= ``WIDE_K``) on the card, as the CUDA
    runtime reports it: the keys of ``stream_occupancy``, then
    ``block_queries`` and ``tile_docs``, the block's shape as compiled
    (``plan()`` follows the block of split_len 0)."""
    if not 1 <= k <= WIDE_K:
        raise ValueError(f"ring_occupancy: the ring pass takes 1 <= k <= {WIDE_K}, got {k}")
    key = (torch.device(device).index or 0, ring_block(n_queries, split_len))
    if key not in _ring_occupancy:
        out = [ctypes.c_int() for _ in range(6)]
        with torch.cuda.device(device):
            err = _lib().score_topk_tiles_ring_split_occupancy(n_queries, split_len, k,
                                                               *map(ctypes.byref, out))
        if err != 0:
            raise RuntimeError(f"score_topk occupancy query failed with cudaError_t {err}")
        keys = _OCCUPANCY_KEYS + ("block_queries", "tile_docs")
        _ring_occupancy[key] = dict(zip(keys, (o.value for o in out)))
    return _ring_occupancy[key]


def call_plan(doc_matrix: torch.Tensor, n_queries: int, k: int) -> Tuple[int, int, int]:
    """(pass1, n_splits, split_len) of a call on the card: the kernel that
    runs pass 1 (``PASS_STREAM``, ``PASS_STREAM_MMA`` where
    ``stream_mma_takes``, ``PASS_TILES_RING`` where ``ring_takes``, or
    ``PASS_TILES``) and ``plan()`` under its blocks per SM."""
    device = doc_matrix.device
    n, dim = doc_matrix.shape
    dtype = doc_matrix.dtype
    sm_count = torch.cuda.get_device_properties(device).multi_processor_count
    if ring_takes(dtype, n_queries, k):
        block = ring_occupancy(device, n_queries, k)
        _, n_splits, split_len = plan(n_queries, n, sm_count, block["blocks_per_sm"],
                                      block["block_queries"], block["tile_docs"])
        return PASS_TILES_RING, n_splits, split_len
    mma = stream_mma_takes(dtype, n_queries, dim, doc_matrix.data_ptr())
    if n_queries > 4:
        block = tiles_occupancy(device, dtype, k)
    elif mma:
        block = stream_mma_occupancy(device, n_queries, dim, k)
    else:
        block = stream_occupancy(device, dtype, n_queries, dim, k)
    rows, n_splits, split_len = plan(n_queries, n, sm_count, block["blocks_per_sm"], 32,
                                     BATCH_TILE_N)
    pass1 = PASS_TILES if rows == 8 else PASS_STREAM_MMA if mma else PASS_STREAM
    return pass1, n_splits, split_len


def merge_occupancy(device: torch.device, final_level: bool, lists: int,
                    k: int) -> Dict[str, int]:
    """A pass-2 block over ``lists`` lists of ``k`` on the card, level 1
    (``score_topk_merge_groups``) or the last level
    (``score_topk_merge_final``), as the CUDA runtime reports it: the keys
    of ``stream_occupancy``."""
    out = [ctypes.c_int() for _ in range(4)]
    with torch.cuda.device(device):
        err = _lib().score_topk_merge_occupancy(int(final_level), lists, k,
                                                *map(ctypes.byref, out))
    if err != 0:
        raise RuntimeError(f"score_topk merge occupancy query failed with cudaError_t {err}")
    return dict(zip(_OCCUPANCY_KEYS, (o.value for o in out)))


def _check_bar(bar: Bar, n_queries: int, k: int, device: torch.device) -> None:
    bar_v, bar_i = bar
    if not (bar_v.shape == bar_i.shape == (n_queries,) and bar_v.dtype == torch.float32
            and bar_i.dtype == torch.int32 and bar_v.stride() == bar_i.stride()):
        raise ValueError("score_topk bar: a (Q,) float32 and a (Q,) int32 tensor of one "
                         f"stride, got {tuple(bar_v.shape)} {bar_v.dtype} and "
                         f"{tuple(bar_i.shape)} {bar_i.dtype}")
    if bar_v.device != device or bar_i.device != device:
        raise ValueError(f"score_topk bar: must be on {device}")
    if n_queries <= 4 or k <= WIDE_K:
        raise ValueError(f"score_topk bar: only Q >= 5 and k > {WIDE_K} take one, "
                         f"got Q={n_queries}, k={k}")


def _call(doc_matrix: torch.Tensor, queries: torch.Tensor, k: int, n_docs: Optional[int],
          merge: bool):
    """Check a call and plan it: (launch, n_splits, split_len), where
    ``launch(n_splits, split_len, split_docs, bar)`` launches pass 1 under
    that plan, then pass 2 if ``merge``, returns (cand_v, cand_i, out_v,
    out_i) and adds one to ``LAUNCHES`` (and to ``STREAM_MMA_LAUNCHES``
    or ``RING_LAUNCHES`` where ``score_topk_stream_mma`` or
    ``score_topk_tiles_ring`` ran pass 1)."""
    check_args(doc_matrix, queries, k)
    device = doc_matrix.device
    if device.type != "cuda" or queries.device != device:
        raise ValueError("score_topk kernel: docs and queries must be on one CUDA device, "
                         f"got {device} and {queries.device}")
    n, dim = doc_matrix.shape
    n_docs = n if n_docs is None else int(n_docs)
    queries = queries.to(doc_matrix.dtype).contiguous()
    n_queries = queries.shape[0]
    pass1, n_splits, split_len = call_plan(doc_matrix, n_queries, k)

    def launch(n_splits: int, split_len: int, split_docs: int, bar: Optional[Bar]):
        global LAUNCHES, STREAM_MMA_LAUNCHES, RING_LAUNCHES
        bar_args = (None, None, 0)
        if bar is not None:
            _check_bar(bar, n_queries, k, device)
            bar_args = (bar[0].data_ptr(), bar[1].data_ptr(), bar[0].stride(0))
        cand_v = torch.empty((n_queries, n_splits, k), dtype=torch.float32, device=device)
        cand_i = torch.empty((n_queries, n_splits, k), dtype=torch.int32, device=device)
        out_v = torch.empty((n_queries, k), dtype=torch.float32, device=device)
        out_i = torch.empty((n_queries, k), dtype=torch.int32, device=device)
        group = merge_plan(n_splits, k)[0] if merge else 0
        with torch.cuda.device(device):
            err = _lib().score_topk_bar_launch(
                doc_matrix.data_ptr(), queries.data_ptr(),
                int(doc_matrix.dtype == torch.bfloat16), n, n_queries, dim, k, n_docs,
                n_splits, split_len, pass1, cand_v.data_ptr(), cand_i.data_ptr(),
                out_v.data_ptr(), out_i.data_ptr(), group, *bar_args, split_docs,
                torch.cuda.current_stream(device).cuda_stream)
        if err != 0:
            raise RuntimeError(f"score_topk kernel launch failed with cudaError_t {err}")
        LAUNCHES += 1
        STREAM_MMA_LAUNCHES += int(pass1 == PASS_STREAM_MMA)
        RING_LAUNCHES += int(pass1 == PASS_TILES_RING)
        return cand_v, cand_i, out_v, out_i

    return launch, n_splits, split_len


def score_topk_sample(
    doc_matrix: torch.Tensor,
    queries: torch.Tensor,
    k: int,
    n_docs: Optional[int] = None,
) -> Optional[Tuple[torch.Tensor, torch.Tensor, tuple]]:
    """The sample run that ``score_topk_cuda`` launches first on these
    arguments (``sample_topk``): (out_v, out_i, its (n_splits, split_len,
    split_docs)), or None where the call takes no bar. For the checks and
    the timings; counted in ``LAUNCHES``."""
    launch, n_splits, split_len = _call(doc_matrix, queries, k, n_docs, merge=True)
    return sample_topk(lambda *a: launch(*a)[2:], queries.shape[0], k, doc_matrix.shape[0],
                       n_splits, split_len, split_len)


def score_topk_cuda(
    doc_matrix: torch.Tensor,
    queries: torch.Tensor,
    k: int,
    n_docs: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k of ``queries @ doc_matrix.T`` on the card: (Q, k) float32
    scores and int32 indices. Barred by a sample run where ``bar_plan``
    says so: one launch, and one more for each sample run."""
    launch, n_splits, split_len = _call(doc_matrix, queries, k, n_docs, merge=True)
    run = lambda *a: launch(*a)[2:]  # noqa: E731
    top = sample_topk(run, queries.shape[0], k, doc_matrix.shape[0], n_splits, split_len,
                      split_len)
    return run(n_splits, split_len, split_len, kth(top, k))


def score_topk_candidates(
    doc_matrix: torch.Tensor,
    queries: torch.Tensor,
    k: int,
    n_docs: Optional[int] = None,
    bar: Optional[Bar] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pass 1 alone on the card: the (Q, n_splits, k) sorted lists, padded
    with (-inf, ``NO_INDEX``), that pass 2 would merge. With ``bar`` (a
    (Q,) float32 value and int32 index a query, Q >= 5 and k > ``WIDE_K``
    only), each split's top-k among the pairs that rank at or before it;
    without one, unbarred. For the checks of pass 1 and pass 2; counted in
    ``LAUNCHES``."""
    launch, n_splits, split_len = _call(doc_matrix, queries, k, n_docs, merge=False)
    return launch(n_splits, split_len, split_len, bar)[:2]


def candidates_reference(
    doc_matrix: torch.Tensor,
    queries: torch.Tensor,
    k: int,
    split_len: int,
    n_docs: Optional[int] = None,
    bar: Optional[Bar] = None,
    split_docs: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch pass 1: for each split, the docs [s split_len, s
    split_len + split_docs) cut at N (``split_docs`` defaults to
    ``split_len``), each query's top-k of it as the plain version ranks
    them (``ops.topk_score.score_topk_reference``), with global indices,
    and (-inf, ``NO_INDEX``) after a split's docs run out. With ``bar`` (a
    (Q,) value and index a query), only the pairs that rank at or before
    the query's bar pair count. (Q, n_splits, k), as
    ``score_topk_candidates`` leaves them under a plan of that
    ``split_len``. Used by the tests and the checks only."""
    from ..ops.topk_score import score_topk_reference

    n = doc_matrix.shape[0]
    n_docs = n if n_docs is None else int(n_docs)
    split_docs = split_len if split_docs is None else split_docs
    n_splits = -(-n // split_len)
    cand_v = torch.full((queries.shape[0], n_splits, k), -math.inf, device=doc_matrix.device)
    cand_i = torch.full_like(cand_v, NO_INDEX, dtype=torch.int32)
    for s in range(n_splits):
        begin = s * split_len
        part = doc_matrix[begin:begin + split_docs]
        real = min(k, part.shape[0])
        v, i = score_topk_reference(part, queries, real, n_docs - begin)
        i = i + begin
        if bar is not None:  # ranks at or before the bar: a prefix of the sorted list
            bv, bi = bar[0][:, None], bar[1][:, None]
            keep = (v > bv) | ((v == bv) & (i <= bi))
            v = v.masked_fill(~keep, -math.inf)
            i = i.masked_fill(~keep, NO_INDEX)
        cand_v[:, s, :real] = v
        cand_i[:, s, :real] = i
    return cand_v, cand_i


def agree(docs: torch.Tensor, queries: torch.Tensor, got, want,
          n_docs: Optional[int] = None, rel: float = 1e-5) -> Tuple[float, int]:
    """Hold a top-k (scores, indices) against another's, say the plain
    version's. Scores within rtol 1e-5, atol 1e-6. Indices equal, except
    where the two candidates' scores, recomputed in f64 from the queries
    cast to the docs' dtype, differ by less than ``rel`` relative: the two
    sum in other orders, and near-ties at the k-th place of 1M docs happen.
    Returns (max_abs_err, near-tie swaps). Used by the tests and the checks
    only."""
    gv, gi = got
    wv, wi = want
    torch.testing.assert_close(gv, wv, rtol=1e-5, atol=1e-6)
    differ = gi != wi
    if differ.any():
        q_idx, pos = differ.nonzero(as_tuple=True)
        q64 = queries.to(docs.dtype).double()[q_idx]

        def rescore(idx):
            idx = idx[q_idx, pos].long()
            s = (q64 * docs[idx].double()).sum(1)
            return s if n_docs is None else torch.where(idx < n_docs, s, -1e30)

        sg, sw = rescore(gi), rescore(wi)
        near = (sg - sw).abs() <= rel * torch.maximum(sg.abs(), sw.abs())
        if not bool(near.all()):
            raise AssertionError(f"{int((~near).sum())} indices differ beyond a near-tie")
    return float((gv - wv).abs().max()), int(differ.sum())


def _check_candidates(cand_v: torch.Tensor, cand_i: torch.Tensor) -> None:
    if cand_v.dim() != 3 or cand_v.shape != cand_i.shape:
        raise ValueError("merge_topk: candidates must be two (Q, S, k) tensors of one shape, "
                         f"got {tuple(cand_v.shape)} and {tuple(cand_i.shape)}")
    if cand_v.dtype != torch.float32 or cand_i.dtype != torch.int32:
        raise ValueError(f"merge_topk: candidates must be float32 and int32, got "
                         f"{cand_v.dtype} and {cand_i.dtype}")
    q, s, k = cand_v.shape
    if q < 1 or not 1 <= s <= MAX_SPLITS or not 1 <= k <= MAX_K:
        raise ValueError(f"merge_topk: the kernel takes Q >= 1, 1 <= S <= {MAX_SPLITS} and "
                         f"1 <= k <= {MAX_K}, got {tuple(cand_v.shape)}")


def merge_topk_cuda(cand_v: torch.Tensor,
                    cand_i: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pass 2 alone on the card: the (Q, k) best of each query's S lists
    of k (value, index) pairs, each list sorted best first (score
    descending, then index ascending) and padded with (-inf, ``NO_INDEX``).

    Where ``merge_plan`` gives two levels, level 1 writes its groups'
    winners over the first list of each group: **the candidates are
    overwritten**, so a check passes a copy. It launches the kernel's
    pass 2 and adds one to ``LAUNCHES``, the count it shares with
    ``score_topk_cuda``.
    """
    global LAUNCHES
    _check_candidates(cand_v, cand_i)
    device = cand_v.device
    if device.type != "cuda" or cand_i.device != device:
        raise ValueError("merge_topk kernel: candidates must be on one CUDA device, "
                         f"got {device} and {cand_i.device}")
    if not (cand_v.is_contiguous() and cand_i.is_contiguous()):
        raise ValueError("merge_topk kernel: candidates must be contiguous")
    q, s, k = cand_v.shape
    out_v = torch.empty((q, k), dtype=torch.float32, device=device)
    out_i = torch.empty((q, k), dtype=torch.int32, device=device)
    with torch.cuda.device(device):
        err = _lib().score_topk_merge_launch(
            cand_v.data_ptr(), cand_i.data_ptr(), q, s, k, merge_plan(s, k)[0],
            out_v.data_ptr(), out_i.data_ptr(), torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"score_topk merge launch failed with cudaError_t {err}")
    LAUNCHES += 1
    return out_v, out_i


def merge_topk_reference(cand_v: torch.Tensor,
                         cand_i: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch pass 2: the first k of each query's S*k candidates
    sorted by score descending, then index ascending, as the kernel's
    ``ranks_before`` orders them (-0.0 ties with +0.0 and goes on to the
    index). A stable sort by index, then a stable sort by score; the
    scores' bits come back as they went in. Used by the tests and the
    checks only."""
    _check_candidates(cand_v, cand_i)
    q, _, k = cand_v.shape
    values, index = cand_v.reshape(q, -1), cand_i.reshape(q, -1)
    by_index = torch.sort(index, dim=1, stable=True).indices
    key = torch.gather(values, 1, by_index)
    key = torch.where(key == 0, torch.zeros_like(key), key)  # -0.0 sorts as +0.0
    order = torch.gather(by_index, 1,
                         torch.sort(key, dim=1, descending=True, stable=True).indices[:, :k])
    return torch.gather(values, 1, order), torch.gather(index, 1, order)
