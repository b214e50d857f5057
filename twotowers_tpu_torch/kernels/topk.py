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
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from . import build

MAX_K = 256
MAX_DIM = 1024
MAX_SPLITS = 1024   # score_topk.cu:MAX_SPLITS
STREAM_ROWS = 128   # Q <= 4 splits are a whole number of these rows: one block
                    # iteration of score_topk_stream reads 64 (f32) or 128 (bf16)
BATCH_TILE_N = 256  # score_topk.cu:BN, doc rows per tile of the Q >= 5 pass 1

# kernel launches so far; a run reads it to show it went through the kernel
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
                       ptr, ptr, ptr, ptr, ptr]
        fn.restype = i32
        occ = lib.score_topk_tiles_occupancy
        occ.argtypes = [i32, i32, ctypes.POINTER(i32), ctypes.POINTER(i32)]
        occ.restype = i32
        occ = lib.score_topk_stream_occupancy
        occ.argtypes = [i32, i32, i32, i32] + [ctypes.POINTER(i32)] * 4
        occ.restype = i32
    return lib


_occupancy: Dict[Tuple[int, bool, int], Tuple[int, int]] = {}
_stream_occupancy: Dict[Tuple[int, bool, int, int, int], Dict[str, int]] = {}


def tiles_occupancy(device: torch.device, dtype: torch.dtype, k: int) -> Tuple[int, int]:
    """(shared-memory bytes, blocks per SM) of a Q >= 5 pass-1 block for
    docs of ``dtype`` at this ``k`` on the card, as the CUDA runtime
    reports them (registers and shared memory both count)."""
    key = (torch.device(device).index or 0, dtype == torch.bfloat16, k)
    if key not in _occupancy:
        smem, blocks = ctypes.c_int(), ctypes.c_int()
        with torch.cuda.device(device):
            err = _lib().score_topk_tiles_occupancy(int(key[1]), k, ctypes.byref(smem),
                                                    ctypes.byref(blocks))
        if err != 0:
            raise RuntimeError(f"score_topk occupancy query failed with cudaError_t {err}")
        _occupancy[key] = (smem.value, blocks.value)
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
        _stream_occupancy[key] = dict(zip(("smem_bytes", "blocks_per_sm", "registers",
                                           "local_bytes"), (o.value for o in out)))
    return _stream_occupancy[key]


def score_topk_cuda(
    doc_matrix: torch.Tensor,
    queries: torch.Tensor,
    k: int,
    n_docs: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k of ``queries @ doc_matrix.T`` on the card: (Q, k) float32
    scores and int32 indices."""
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
        per_sm = tiles_occupancy(device, doc_matrix.dtype, k)[1]
    else:
        per_sm = stream_occupancy(device, doc_matrix.dtype, n_queries, dim, k)["blocks_per_sm"]
    rows, n_splits, split_len = plan(n_queries, n, sm_count, per_sm)

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
            out_v.data_ptr(), out_i.data_ptr(),
            torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"score_topk kernel launch failed with cudaError_t {err}")
    LAUNCHES += 1
    return out_v, out_i
