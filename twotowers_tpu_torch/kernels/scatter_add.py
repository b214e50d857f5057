"""Wrapper of the deterministic row scatter-add CUDA kernel
(``csrc/scatter_add_rows.cu``), and its plain version.

The Hopper counterpart of ``twotowers_tpu/kernels/pallas_scatter_add.py:
scatter_add_rows``: ``zeros((V, D), f32).at[ids].add(g)``, the gradient of
an embedding gather. ``g`` is float32 or bfloat16 and is widened to float32
on load; the sums are float32, cast to ``out_dtype`` (the table's dtype) as
they are written. The kernel's sums do not depend on the run: the ids are
sorted stably once (``sort_ids``, timed apart as the ids' preparation) and
every row adds its g rows in original index order, long runs in fixed
chunks whose partial sums are added in a fixed order.

``scatter_add_rows`` takes the plain version, ``scatter_add_rows_reference``,
for a CPU tensor, and launches the kernel or raises for a CUDA one.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from . import build

CHUNK = 128  # sorted rows per warp in pass 1 (scatter_add_rows.cu)

# kernel launches so far; a run reads it to show it went through the kernel
LAUNCHES = 0

_DTYPES = (torch.float32, torch.bfloat16)


def scatter_add_rows_reference(g: torch.Tensor, ids: torch.Tensor, vocab: int,
                               out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Plain PyTorch ``zeros((vocab, D), f32).index_add_(0, ids, g)``, cast
    to ``out_dtype``."""
    out = torch.zeros((vocab, g.shape[-1]), dtype=torch.float32, device=g.device)
    return out.index_add_(0, ids.long(), g.float()).to(out_dtype)


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


def _lib() -> ctypes.CDLL:
    lib = build.load("scatter_add_rows")
    fn = lib.scatter_add_rows_launch
    if fn.argtypes is None:
        ptr, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        fn.argtypes = [ptr, i32, ptr, ptr, i64, i32, i64, i32, ptr, i32, ptr, ptr]
        fn.restype = i32
    return lib


def scatter_add_sorted(g: torch.Tensor, sorted_ids: torch.Tensor, perm: torch.Tensor,
                       vocab: int, out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The kernel on ids already prepared by ``sort_ids``."""
    global LAUNCHES
    check_args(g, sorted_ids, vocab, out_dtype)
    if perm.dtype != torch.int64 or perm.shape != sorted_ids.shape or perm.device != g.device:
        raise ValueError("scatter_add_rows: perm must be int64 (N,) on the device of g")
    g = g.contiguous()
    n, dim = g.shape
    device = g.device
    out = torch.zeros((vocab, dim), dtype=out_dtype, device=device)
    part = torch.empty((-(-n // CHUNK), 2, dim), dtype=torch.float32, device=device)
    lib = _lib()
    with torch.cuda.device(device):
        err = lib.scatter_add_rows_launch(
            g.data_ptr(), int(g.dtype == torch.bfloat16), sorted_ids.contiguous().data_ptr(),
            perm.contiguous().data_ptr(), n, dim, vocab, CHUNK, out.data_ptr(),
            int(out_dtype == torch.bfloat16), part.data_ptr(),
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
