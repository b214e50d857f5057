"""Wrapper of the deterministic row scatter-add CUDA kernel
(``csrc/scatter_add_rows.cu``), its launch plan, and its plain version.

The Hopper counterpart of ``twotowers_tpu/kernels/pallas_scatter_add.py:
scatter_add_rows``: ``zeros((V, D), f32).at[ids].add(g)``, the gradient of
an embedding gather. ``g`` is float32 or bfloat16 and is widened to float32
on load; the sums are float32, cast to ``out_dtype`` (the table's dtype) as
they are written. Ids outside ``[0, V)`` are dropped.

Bytes bound it: at the train path's shape it reads 134 MB of g for one add
per element. The ids are sorted stably once (``sort_ids``, timed apart as
the ids' preparation). Pass 1 gives each chunk of ``CHUNK`` sorted rows to
a team of lanes that reads whole g rows as 16-byte slabs, the chunk's ids
staged first and the next 4 rows loaded before the current 4 are added;
rows or pointers off 16-byte alignment take scalar loads. Pass 2 adds only
the runs that cross a chunk, from a list that pass 1 writes and pass 2
reads on the card, so nothing here waits on the device. Summation order:
each chunk's rows in original index order, then a crossing run's pieces
strided over ``SPAN_WARPS`` warps in piece order and the warps in order.
It depends on the ids and shapes alone: the same bits on every run.

``scatter_add_rows`` takes the plain version, ``scatter_add_rows_reference``,
for a CPU tensor, and launches the kernel or raises for a CUDA one.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from typing import Tuple

import torch

from . import build

CHUNK = 128          # sorted rows per team in pass 1 (scatter_add_rows.cu)
WARPS = 8            # pass-1 warps per block, at most
SPAN_WARPS = 16      # pass-2 warps adding one crossing run
SPAN_THREADS_PER_SM = 2048  # pass 2's fixed grid: a full SM of threads each
SMEM_LIMIT = 48 * 1024  # static launch limit of a block's shared memory

# kernel launches so far; a run reads it to show it went through the kernel
LAUNCHES = 0

_DTYPES = (torch.float32, torch.bfloat16)


def scatter_add_rows_reference(g: torch.Tensor, ids: torch.Tensor, vocab: int,
                               out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Plain PyTorch ``zeros((vocab, D), f32).index_add_(0, ids, g)``, cast
    to ``out_dtype``. Ids outside ``[0, vocab)`` are dropped, as JAX's
    scatter drops them: they add into a spare row past the table, which is
    cut off (no host synchronisation, unlike a boolean mask)."""
    ids = ids.long()
    ids = torch.where((ids >= 0) & (ids < vocab), ids, vocab)
    out = torch.zeros((vocab + 1, g.shape[-1]), dtype=torch.float32, device=g.device)
    return out.index_add_(0, ids, g.float())[:vocab].to(out_dtype)


def check_args(g: torch.Tensor, ids: torch.Tensor, vocab: int, out_dtype: torch.dtype) -> None:
    """Raise ValueError for a call the kernel does not take."""
    if g.dim() != 2 or ids.dim() != 1 or ids.shape[0] != g.shape[0]:
        raise ValueError(f"scatter_add_rows: g must be (N, D) and ids (N,), got "
                         f"{tuple(g.shape)} and {tuple(ids.shape)}")
    if g.dtype not in _DTYPES or out_dtype not in _DTYPES:
        raise ValueError(f"scatter_add_rows: g and the output must be float32 or bfloat16, "
                         f"got {g.dtype} and {out_dtype}")
    if ids.dtype != torch.int32:
        raise ValueError(f"scatter_add_rows: ids must be int32, got {ids.dtype}")
    if not 1 <= g.shape[0] < 2**31 or g.shape[1] < 1 or not 1 <= vocab < 2**31:
        raise ValueError(f"scatter_add_rows: the kernel takes 1 <= N < 2**31, D >= 1 and "
                         f"1 <= V < 2**31, got N={g.shape[0]}, D={g.shape[1]}, V={vocab}")
    if g.device.type != "cuda" or ids.device != g.device:
        raise ValueError("scatter_add_rows kernel: g and ids must be on one CUDA device, "
                         f"got {g.device} and {ids.device}")


def sort_ids(ids: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The ids' preparation: (ids sorted ascending, stably; the int64
    position in ``ids`` of each sorted entry)."""
    return torch.sort(ids, stable=True)


@dataclass(frozen=True)
class Plan:
    """How one call is launched; a function of the shapes, g's dtype and
    alignment, and the card's SM count only. The kernel derives its grids
    from these."""
    chunk: int           # sorted rows per team
    vector: bool         # 16-byte g loads (else the scalar fallback)
    team_lanes: int      # lanes per g row: one 16-byte slab each, up to 32
    warps: int           # pass-1 warps per block
    n_chunks: int
    smem_bytes: int      # pass-1 block: staged sids and rows
    span_warps: int      # pass-2 warps per block: one crossing run at a time
    span_blocks: int     # pass-2 grid; 0 when no run can cross a chunk


def plan(n: int, dim: int, g_dtype: torch.dtype, g_ptr: int, sm_count: int) -> Plan:
    """The launch plan of ``n`` rows of ``dim`` columns of ``g_dtype`` at
    address ``g_ptr`` on a card with ``sm_count`` SMs."""
    vec = 16 // g_dtype.itemsize
    slabs = -(-dim // vec)
    team_lanes = min(32, 1 << (slabs - 1).bit_length())
    per_warp = (2 * 32 // team_lanes * CHUNK + 2) * 4  # the kernel's warp_smem_ints
    warps = min(WARPS, SMEM_LIMIT // per_warp)
    n_chunks = -(-n // CHUNK)
    return Plan(chunk=CHUNK, vector=dim % vec == 0 and g_ptr % 16 == 0, team_lanes=team_lanes,
                warps=warps, n_chunks=n_chunks, smem_bytes=warps * per_warp,
                span_warps=SPAN_WARPS,
                span_blocks=min(n_chunks - 1,
                                SPAN_THREADS_PER_SM // (32 * SPAN_WARPS) * sm_count))


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _lib() -> ctypes.CDLL:
    lib = build.load("scatter_add_rows")
    fn = lib.scatter_add_rows_launch
    if fn.argtypes is None:
        ptr, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        fn.argtypes = [ptr, i32, ptr, ptr, i64, i32, i64, i32, i32, i32, i32,
                       ptr, i32, ptr, ptr, i32, i32, ptr]
        fn.restype = i32
        occ = lib.scatter_add_rows_occupancy
        occ.argtypes = [i32, i32, i32, i32, i32, i32, ctypes.POINTER(i32),
                        ctypes.POINTER(i32)]
        occ.restype = i32
    return lib


def occupancy(device: torch.device, g_dtype: torch.dtype, out_dtype: torch.dtype,
              p: Plan) -> Tuple[int, int]:
    """(pass-1 blocks, pass-2 blocks) that fit on one SM of the card for
    this plan, as the CUDA runtime reports them."""
    pass1, pass2 = ctypes.c_int(), ctypes.c_int()
    with torch.cuda.device(device):
        err = _lib().scatter_add_rows_occupancy(
            int(g_dtype == torch.bfloat16), int(out_dtype == torch.bfloat16), int(p.vector),
            p.warps, p.smem_bytes, p.span_warps, ctypes.byref(pass1), ctypes.byref(pass2))
    if err != 0:
        raise RuntimeError(f"scatter_add_rows occupancy query failed with cudaError_t {err}")
    return pass1.value, pass2.value


def scatter_add_sorted(g: torch.Tensor, sorted_ids: torch.Tensor, perm: torch.Tensor,
                       vocab: int, out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The kernel on ids already prepared by ``sort_ids``. Nothing here
    waits on the card."""
    global LAUNCHES
    check_args(g, sorted_ids, vocab, out_dtype)
    if perm.dtype != torch.int64 or perm.shape != sorted_ids.shape or perm.device != g.device:
        raise ValueError("scatter_add_rows: perm must be int64 (N,) on the device of g")
    g = g.contiguous()
    n, dim = g.shape
    device = g.device
    p = plan(n, dim, g.dtype, g.data_ptr(), _sm_count(device))
    out = torch.zeros((vocab, dim), dtype=out_dtype, device=device)
    part = torch.empty((p.n_chunks, 2, dim), dtype=torch.float32, device=device)
    spans = torch.zeros(1 + p.n_chunks, dtype=torch.int32, device=device)
    lib = _lib()
    with torch.cuda.device(device):
        err = lib.scatter_add_rows_launch(
            g.data_ptr(), int(g.dtype == torch.bfloat16), sorted_ids.contiguous().data_ptr(),
            perm.contiguous().data_ptr(), n, dim, vocab, p.chunk, p.team_lanes, p.warps,
            int(p.vector), out.data_ptr(), int(out_dtype == torch.bfloat16),
            part.data_ptr(), spans.data_ptr(), p.span_blocks, p.span_warps,
            torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"scatter_add_rows kernel launch failed with cudaError_t {err}")
    LAUNCHES += 1
    return out


def scatter_add_rows(g: torch.Tensor, ids: torch.Tensor, vocab: int,
                     out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``zeros((vocab, D), f32).at[ids].add(g)`` cast to ``out_dtype``: the
    plain version for CPU tensors, the CUDA kernel for tensors on the card."""
    if g.device.type == "cpu" and ids.device.type == "cpu":
        return scatter_add_rows_reference(g, ids, vocab, out_dtype)
    return scatter_add_sorted(g, *sort_ids(ids), vocab, out_dtype)
