"""Wrapper of the row-gather CUDA kernel (``csrc/gather_rows.cu``), and its
plain version.

The Hopper counterpart of the TPU gather kernels
(``tools/exp_pallas_embed.py:pallas_gather``,
``tools/exp_pallas_embed2.py:pallas_gather`` / ``pallas_gather_take``) and
the forward of the word-scale embedding lookup: ``table[ids]`` cast to
``out_dtype`` in the same pass. ``gather_rows`` takes the plain version,
``gather_rows_reference``, for a CPU tensor, and launches the kernel or
raises for a CUDA one.
"""

from __future__ import annotations

import ctypes

import torch

from . import build

# kernel launches so far; a run reads it to show it went through the kernel
LAUNCHES = 0

_DTYPES = (torch.float32, torch.bfloat16)


def gather_rows_reference(table: torch.Tensor, ids: torch.Tensor,
                          out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Plain PyTorch ``table[ids].to(out_dtype)``."""
    return table[ids.long()].to(out_dtype)


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
    if table.device.type != "cuda" or ids.device != table.device:
        raise ValueError("gather_rows kernel: table and ids must be on one CUDA device, "
                         f"got {table.device} and {ids.device}")


def _lib() -> ctypes.CDLL:
    lib = build.load("gather_rows")
    fn = lib.gather_rows_launch
    if fn.argtypes is None:
        ptr, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        fn.argtypes = [ptr, i32, ptr, i64, i32, i64, ptr, i32, i32, ptr]
        fn.restype = i32
    return lib


def gather_rows(table: torch.Tensor, ids: torch.Tensor,
                out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``table[ids].to(out_dtype)``, (N, D): the plain version for CPU
    tensors, the CUDA kernel for tensors on the card."""
    global LAUNCHES
    if table.device.type == "cpu" and ids.device.type == "cpu":
        return gather_rows_reference(table, ids, out_dtype)
    check_args(table, ids, out_dtype)
    table = table.contiguous()
    ids = ids.contiguous()
    n = ids.shape[0]
    vocab, dim = table.shape
    out = torch.empty((n, dim), dtype=out_dtype, device=table.device)
    vec = 16 // table.element_size()  # elements of one 16-byte load
    vectorize = dim % vec == 0 and table.data_ptr() % 16 == 0
    lib = _lib()
    with torch.cuda.device(table.device):
        err = lib.gather_rows_launch(
            table.data_ptr(), int(table.dtype == torch.bfloat16), ids.data_ptr(), n, dim,
            vocab, out.data_ptr(), int(out_dtype == torch.bfloat16), int(vectorize),
            torch.cuda.current_stream(table.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"gather_rows kernel launch failed with cudaError_t {err}")
    LAUNCHES += 1
    return out
