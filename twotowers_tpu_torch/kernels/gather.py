"""Wrapper of the row-gather CUDA kernel (``csrc/gather_rows.cu``), its
launch plan, and its plain version.

The Hopper counterpart of the TPU gather kernels
(``tools/exp_pallas_embed.py:pallas_gather``,
``tools/exp_pallas_embed2.py:pallas_gather`` / ``pallas_gather_take``) and
the forward of the word-scale embedding lookup: ``table[ids]`` cast to
``out_dtype`` in the same pass. ``gather_rows`` takes the plain version,
``gather_rows_reference``, for a CPU tensor, and launches the kernel or
raises for a CUDA one.

Bytes bound it (the output is most of them). ``plan`` gives each row a
team of lanes, each lane storing 16 bytes of output at a time where the row
and the pointers allow it, and has each lane keep several rows' loads in
flight. A lookup at the pretrained or the serving shape spends far more
time on the host than on the card, so the launch path costs attribute
reads, a dict lookup and one ``ctypes`` call: a call's checks and plan run
once for each key of shapes, dtypes, devices and the table's alignment;
the C entry is bound once and takes the plan packed in one integer; the
stream is the raw handle; the device is entered only when it is not the
current one.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import torch

from . import build

WARPS = 8          # warps a block (gather_rows.cu's THREADS / 32)
BLOCKS_PER_SM = 4  # the kernel's launch bound: the blocks an SM holds at least
ROWS = (1, 2, 4)   # rows a lane keeps in flight: the kernel's builds

# kernel launches so far; a run reads it to show it went through the kernel
LAUNCHES = 0

_DTYPES = (torch.float32, torch.bfloat16)


def gather_rows_reference(table: torch.Tensor, ids: torch.Tensor,
                          out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Plain PyTorch ``table[ids].to(out_dtype)``. Ids outside ``[0, V)``
    read as a zero row, as in the kernel: the row-sharded lookup hands
    each shard the ids that other shards own."""
    ids = ids.long()
    owned = (ids >= 0) & (ids < table.shape[0])
    rows = table[torch.where(owned, ids, 0)].to(out_dtype)
    return torch.where(owned[:, None], rows, 0.0)


def check_args(table: torch.Tensor, ids: torch.Tensor, out_dtype: torch.dtype) -> None:
    """Raise ValueError for a call the kernel does not take."""
    if table.dim() != 2 or ids.dim() != 1:
        raise ValueError(f"gather_rows: table must be (V, D) and ids (N,), got "
                         f"{tuple(table.shape)} and {tuple(ids.shape)}")
    if table.dtype not in _DTYPES or out_dtype not in _DTYPES:
        raise ValueError(f"gather_rows: table and output must be float32 or bfloat16, "
                         f"got {table.dtype} and {out_dtype}")
    if ids.dtype != torch.int32:
        raise ValueError(f"gather_rows: ids must be int32, got {ids.dtype}")
    if not 1 <= ids.shape[0] < 2**31 or table.shape[1] < 1 or table.shape[0] < 1:
        raise ValueError(f"gather_rows: the kernel takes 1 <= N < 2**31 and a non-empty "
                         f"table, got N={ids.shape[0]}, table {tuple(table.shape)}")
    if not table.is_cuda or ids.get_device() != table.get_device():
        raise ValueError("gather_rows kernel: table and ids must be on one CUDA device, "
                         f"got {table.device} and {ids.device}")


@dataclass(frozen=True)
class Plan:
    """How one call is launched; a function of the shapes, the dtypes, the
    pointers' alignment and the card's SM count only."""
    elems: int        # columns a lane moves at a time (a slab)
    lanes: int        # lanes a row: a power of 2, up to 32
    rows: int         # rows a lane keeps in flight (4 / rows column blocks of each)
    blocks: int       # the grid, of WARPS warps a block striding over the tiles
    load_bytes: int   # a slab of the table, loaded in accesses of up to 16 bytes
    store_bytes: int  # a slab of the output, stored in accesses of up to 16 bytes

    @property
    def tile_rows(self) -> int:
        """Rows a warp takes at a time, whose ids it loads in one go."""
        return 32 // self.lanes * self.rows

    @property
    def code(self) -> int:
        """elems, log2 of lanes and rows packed in bits 0-3, 4-7 and 8-11, as
        the C entry reads them (``dtype_bits`` adds the rest)."""
        return self.elems | (self.lanes.bit_length() - 1) << 4 | self.rows << 8


def dtype_bits(table_dtype: torch.dtype, out_dtype: torch.dtype) -> int:
    """Bits 16 and 17 of the C entry's code: a bf16 table, a bf16 output."""
    return (table_dtype == torch.bfloat16) << 16 | (out_dtype == torch.bfloat16) << 17


def grid(n: int, lanes: int, rows: int, sm_count: int) -> int:
    """Blocks for ``n`` rows: one warp a tile, at most as many blocks as the
    card holds at once."""
    tiles = -(-n // (32 // lanes * rows))
    return min(-(-tiles // WARPS), sm_count * BLOCKS_PER_SM)


def plan(n: int, dim: int, table_dtype: torch.dtype, out_dtype: torch.dtype, table_ptr: int,
         out_ptr: int, sm_count: int) -> Plan:
    """The launch plan of ``n`` rows of ``dim`` columns from a table of
    ``table_dtype`` at ``table_ptr`` into an output of ``out_dtype`` at
    ``out_ptr``, on a card with ``sm_count`` SMs.

    A lane moves the columns of one 16-byte access of the narrower dtype (8
    with a bf16 side, 4 for f32 -> f32), halved while the row is not a
    multiple of them or a pointer is off their accesses; a row's team is the
    fewest lanes (a power of 2, up to 32) that cover its slabs, wider rows
    looping over column blocks. Each lane keeps the most rows in flight (4,
    2, then 1, never more than its team's lanes: a tile's ids are one load
    of a warp) whose tiles still fill every warp the card holds; 1 where
    none does, which leaves the most tiles and keeps 4 column blocks of a
    wide row in flight instead."""
    t, o = table_dtype.itemsize, out_dtype.itemsize
    elems = 16 // min(t, o)
    while elems > 1 and (dim % elems or table_ptr % min(elems * t, 16)
                         or out_ptr % min(elems * o, 16)):
        elems //= 2
    lanes = min(32, 1 << (dim // elems - 1).bit_length())
    for rows in ROWS[::-1]:
        rows = min(rows, lanes)
        if -(-n // (32 // lanes * rows)) >= sm_count * BLOCKS_PER_SM * WARPS:
            break
    return Plan(elems=elems, lanes=lanes, rows=rows, blocks=grid(n, lanes, rows, sm_count),
                load_bytes=elems * t, store_bytes=elems * o)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


# the calls the wrapper has checked and planned, by the key ``gather_rows``
# builds: (table shape, ids shape, dtypes of table, ids and output, their
# devices, table pointer mod 16) -> (plan, code, n, dim, vocab). The plan
# takes the output as 16-byte aligned, as the caching allocator gives it (at
# least 512 bytes); the C entry refuses an output off its stores.
_plans: dict = {}


def _plan_for(key: tuple, table: torch.Tensor, ids: torch.Tensor,
              out_dtype: torch.dtype) -> tuple:
    """Check a call of a key not seen before, then plan it."""
    check_args(table, ids, out_dtype)
    if len(_plans) >= 4096:
        _plans.clear()
    (vocab, dim), n = table.shape, ids.shape[0]
    p = plan(n, dim, table.dtype, out_dtype, table.data_ptr(), 0, _sm_count(key[5]))
    _plans[key] = (p, p.code | dtype_bits(table.dtype, out_dtype), n, dim, vocab)
    return _plans[key]


def bind(lib: ctypes.CDLL):
    """The C entry ``gather_rows_launch`` of a build, its arguments typed:
    (table, ids, out, n, dim, vocab, code, blocks, stream), the pointers and
    the stream as 64-bit integers."""
    fn = lib.gather_rows_launch
    i64, i32 = ctypes.c_longlong, ctypes.c_int
    fn.argtypes = [i64, i64, i64, i64, i32, i64, i32, i32, i64]
    fn.restype = i32
    return fn


_entry = None  # the bound C entry, after the first launch


def _launcher():
    global _entry
    if _entry is None:
        _entry = bind(build.load("gather_rows"))
    return _entry


def occupancy(table_dtype: torch.dtype, out_dtype: torch.dtype, p: Plan) -> int:
    """Blocks of the plan's kernel that fit on one SM of the current card,
    as the CUDA runtime reports them."""
    blocks = ctypes.c_int()
    fn = build.load("gather_rows").gather_rows_occupancy
    fn.argtypes = [ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_int)]
    err = fn(table_dtype == torch.bfloat16, out_dtype == torch.bfloat16, p.elems, p.rows,
             ctypes.byref(blocks))
    if err != 0:
        raise RuntimeError(f"gather_rows occupancy query failed with cudaError_t {err}")
    return blocks.value


def gather_rows(table: torch.Tensor, ids: torch.Tensor,
                out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``table[ids].to(out_dtype)``, (N, D): the plain version for CPU
    tensors, the CUDA kernel for tensors on the card."""
    global LAUNCHES
    if table.is_cpu and ids.is_cpu:
        return gather_rows_reference(table, ids, out_dtype)
    if not table.is_contiguous():
        table = table.contiguous()
    if not ids.is_contiguous():
        ids = ids.contiguous()
    index, table_ptr = table.get_device(), table.data_ptr()
    key = (table.shape, ids.shape, table.dtype, ids.dtype, out_dtype, index, ids.get_device(),
           table_ptr % 16)
    p, code, n, dim, vocab = _plans.get(key) or _plan_for(key, table, ids, out_dtype)
    out = torch.empty(n, dim, dtype=out_dtype, device=table.device)
    args = (table_ptr, ids.data_ptr(), out.data_ptr(), n, dim, vocab, code, p.blocks,
            torch._C._cuda_getCurrentRawStream(index))
    fn = _entry or _launcher()
    if torch._C._cuda_getDevice() == index:
        err = fn(*args)
    else:
        with torch.cuda.device(index):
            err = fn(*args)
    if err != 0:
        raise RuntimeError(f"gather_rows kernel launch failed with cudaError_t {err}")
    LAUNCHES += 1
    return out
