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

Pass 1 leaves each query's ``(n_splits, k)`` sorted lists in scratch;
pass 2 merges them by a fixed tree (``merge_plan``). ``merge_topk_cuda``
runs pass 2 alone and ``merge_topk_reference`` is its plain version, for
the checks; ``score_topk_candidates`` runs pass 1 alone and
``candidates_reference`` is its plain version.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Dict, Optional, Tuple

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
STAGING_BYTES = 37_376  # score_topk.cu: 2 * STAGE floats of the Q >= 5 pass 1
MMA_DEPTH = 32      # score_topk.cu:MMA_DEPTH: depth of a bf16 Q >= 5 stage (256 doc
                    # and 32 query rows of 64 bytes, two stages within STAGING_BYTES)

MERGE_SMEM_BUDGET = 110 * 1024  # shared bytes of a pass-2 block, at most: 2 blocks an SM
NO_INDEX = 2**31 - 1  # the index of a padding pair, beside the value -inf

# kernel launches so far (both passes, or one of them alone); a run reads it
# to show it went through the kernel
LAUNCHES = 0

_DTYPES = (torch.float32, torch.bfloat16)


def plan(n_queries: int, n: int, sm_count: int,
         blocks_per_sm: int) -> Tuple[int, int, int]:
    """(rows_per_thread, n_splits, split_len) for a call.

    Q <= 4 takes ``score_topk_stream`` (all the queries in one block, splits
    a whole number of ``STREAM_ROWS`` docs); Q >= 5 takes
    ``score_topk_tiles`` (32 queries a block, tiles of ``BATCH_TILE_N``).
    Either aims at ``blocks_per_sm``, the blocks of its pass that fit on an
    SM at once (``stream_occupancy`` or ``tiles_occupancy``): about one
    wave of splits, each as long as it can be. The doc axis is cut into
    that many splits, each a whole number of tiles.
    """
    if n_queries <= 4:
        rows, tile = 1, STREAM_ROWS
    else:
        rows, tile = 8, BATCH_TILE_N
    per_sm = max(1, blocks_per_sm)
    q_blocks = -(-n_queries // (4 * rows))
    want = -(-sm_count * per_sm // q_blocks)
    tiles = -(-n // tile)
    n_splits = max(1, min(want, tiles, MAX_SPLITS))
    split_len = -(-tiles // n_splits) * tile
    return rows, -(-n // split_len), split_len


def tiles_smem(k: int) -> int:
    """Shared bytes of a Q >= 5 pass-1 block at this ``k``, for f32 and
    bf16 docs alike (``score_topk.cu:tiles_smem``): the staging buffers
    (the bf16 kernel's two cp.async stages fit in them), then the lists of
    the instantiation that k takes. Above ``WIDE_K`` the wide selection's
    32 lists of values and indices, each with a padding word after every 32
    pairs; else the narrow one's lists and two counts a query."""
    if k > WIDE_K:
        return STAGING_BYTES + 8 * 32 * list_stride(k)
    return STAGING_BYTES + 8 * 32 * k + 8 * 32


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
    lists = STREAM_WARPS * n_queries
    if k > STREAM_WIDE_K:
        return 4 * n_queries * dpad + 8 * lists * (list_stride(k) + list_stride(STREAM_QUEUE))
    return 4 * n_queries * dpad + 8 * lists * k + 4 * lists


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
    fn = lib.score_topk_launch
    if fn.argtypes is None:
        ptr, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        fn.argtypes = [ptr, ptr, i32, i64, i32, i32, i32, i64, i32, i64, i32,
                       ptr, ptr, ptr, ptr, i32, ptr]
        fn.restype = i32
        occ = lib.score_topk_tiles_occupancy
        occ.argtypes = [i32, i32] + [ctypes.POINTER(i32)] * 4
        occ.restype = i32
        occ = lib.score_topk_stream_occupancy
        occ.argtypes = [i32, i32, i32, i32] + [ctypes.POINTER(i32)] * 4
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


def _launch(doc_matrix: torch.Tensor, queries: torch.Tensor, k: int, n_docs: Optional[int],
            merge: bool):
    """Pass 1, then pass 2 if ``merge``: (cand_v, cand_i, out_v, out_i)."""
    global LAUNCHES
    check_args(doc_matrix, queries, k)
    device = doc_matrix.device
    if device.type != "cuda" or queries.device != device:
        raise ValueError("score_topk kernel: docs and queries must be on one CUDA device, "
                         f"got {device} and {queries.device}")
    n, dim = doc_matrix.shape
    n_docs = n if n_docs is None else int(n_docs)
    queries = queries.to(doc_matrix.dtype).contiguous()
    n_queries = queries.shape[0]
    sm_count = torch.cuda.get_device_properties(device).multi_processor_count
    if n_queries > 4:
        block = tiles_occupancy(device, doc_matrix.dtype, k)
    else:
        block = stream_occupancy(device, doc_matrix.dtype, n_queries, dim, k)
    rows, n_splits, split_len = plan(n_queries, n, sm_count, block["blocks_per_sm"])
    group = merge_plan(n_splits, k)[0] if merge else 0

    cand_v = torch.empty((n_queries, n_splits, k), dtype=torch.float32, device=device)
    cand_i = torch.empty((n_queries, n_splits, k), dtype=torch.int32, device=device)
    out_v = torch.empty((n_queries, k), dtype=torch.float32, device=device)
    out_i = torch.empty((n_queries, k), dtype=torch.int32, device=device)
    lib = _lib()
    with torch.cuda.device(device):
        err = lib.score_topk_launch(
            doc_matrix.data_ptr(), queries.data_ptr(),
            int(doc_matrix.dtype == torch.bfloat16), n, n_queries, dim, k, n_docs,
            n_splits, split_len, rows, cand_v.data_ptr(), cand_i.data_ptr(),
            out_v.data_ptr(), out_i.data_ptr(), group,
            torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"score_topk kernel launch failed with cudaError_t {err}")
    LAUNCHES += 1
    return cand_v, cand_i, out_v, out_i


def score_topk_cuda(
    doc_matrix: torch.Tensor,
    queries: torch.Tensor,
    k: int,
    n_docs: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k of ``queries @ doc_matrix.T`` on the card: (Q, k) float32
    scores and int32 indices."""
    return _launch(doc_matrix, queries, k, n_docs, merge=True)[2:]


def score_topk_candidates(
    doc_matrix: torch.Tensor,
    queries: torch.Tensor,
    k: int,
    n_docs: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pass 1 alone on the card: the (Q, n_splits, k) sorted lists, padded
    with (-inf, ``NO_INDEX``), that pass 2 of ``score_topk_cuda`` would
    merge. For the checks of pass 1 and pass 2; counted in ``LAUNCHES``."""
    return _launch(doc_matrix, queries, k, n_docs, merge=False)[:2]


def candidates_reference(
    doc_matrix: torch.Tensor,
    queries: torch.Tensor,
    k: int,
    split_len: int,
    n_docs: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch pass 1: for each split of ``split_len`` docs (the last
    one shorter), each query's top-k of it as the plain version ranks them
    (``ops.topk_score.score_topk_reference``), with global indices, and
    (-inf, ``NO_INDEX``) after a split's docs run out. (Q, n_splits, k), as
    ``score_topk_candidates`` leaves them under a plan of that
    ``split_len``. Used by the tests and the checks only."""
    from ..ops.topk_score import score_topk_reference

    n = doc_matrix.shape[0]
    n_docs = n if n_docs is None else int(n_docs)
    n_splits = -(-n // split_len)
    cand_v = torch.full((queries.shape[0], n_splits, k), -math.inf, device=doc_matrix.device)
    cand_i = torch.full_like(cand_v, NO_INDEX, dtype=torch.int32)
    for s in range(n_splits):
        begin = s * split_len
        part = doc_matrix[begin:begin + split_len]
        real = min(k, part.shape[0])
        v, i = score_topk_reference(part, queries, real, n_docs - begin)
        cand_v[:, s, :real] = v
        cand_i[:, s, :real] = i + begin
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
