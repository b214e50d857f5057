"""The yardstick: the card's published peaks, and the operations and bytes of
the work a cell asks for, counted from its shapes.

Nothing here reads the program. ``topk_bound``, the peaks and ``tf_flops``
are copies of ``chip_smoke.py``'s ``topk_bound``, ``H100_FLOPS`` /
``H100_BYTES_PER_S`` and ``tf_flops`` (itself ``bench.py``'s ``_tf_flops``),
kept here so that a later change to the program cannot move them.
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense rates: HBM3 bytes/s; f32 on the CUDA
# cores; bf16 on the tensor cores.
H100_BYTES_PER_S = 3.35e12
H100_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
ITEMSIZE = {"float32": 4, "bfloat16": 2, "int32": 4}


def topk_bound_s(n_docs: int, dim: int, q: int, k: int, dtype: str = "float32") -> float:
    """Least seconds for one score + top-k call: the docs and the queries read
    once and the (score, index) pairs written once at the HBM rate, against
    2*Q*N*D operations at the peak rate of the docs' type; the larger."""
    bytes_s = ((n_docs + q) * dim * ITEMSIZE[dtype] + q * k * 8) / H100_BYTES_PER_S
    ops_s = 2.0 * q * n_docs * dim / H100_FLOPS[dtype]
    return max(bytes_s, ops_s)


def mean_tower_flops(emb: int, hid: int) -> float:
    """Matmul FLOPs of the ``mean`` tower for one text: Linear(emb, hid) and
    Linear(hid, hid); the lookup and the pooling are no matmul."""
    return 2.0 * emb * hid + 2.0 * hid * hid


def search_flops(n_docs: int, dim: int, emb: int, hid: int) -> float:
    """FLOPs of one query's search: its tower, then its dot product with
    every document."""
    return mean_tower_flops(emb, hid) + 2.0 * n_docs * dim


def tf_flops(batch: int, seq: int, emb: int, hid: int, layers: int) -> float:
    """Matmul FLOPs of one transformer-tower train step with the in_batch
    loss (2 texts a pair): per text forward the input projection 2*B*L*D*H,
    per layer QKV+O 8*B*L*H^2, attention 4*B*L^2*H and the 4x FFN
    16*B*L*H^2; backward ~2x forward; the loss's similarity matmul 2*B^2*H
    forward, 3x with backward. The lookup is a gather: no matmul FLOPs."""
    fwd = 2 * batch * seq * emb * hid + layers * (
        24 * batch * seq * hid * hid + 4 * batch * seq * seq * hid)
    return 2 * 3.0 * fwd + 3.0 * 2 * batch * batch * hid


def gather_bytes(n_ids: int, vocab: int, dim: int, table_dtype: str, out_dtype: str) -> float:
    """Bytes of one row gather, each counted once: the int32 ids, the table,
    the rows written."""
    return (n_ids * ITEMSIZE["int32"] + vocab * dim * ITEMSIZE[table_dtype]
            + n_ids * dim * ITEMSIZE[out_dtype])


def scatter_add_bytes(n_ids: int, vocab: int, dim: int, g_dtype: str, out_dtype: str) -> float:
    """Bytes of one scatter-add, each counted once: the gradient rows, the
    int32 ids, the table-shaped sum written."""
    return (n_ids * dim * ITEMSIZE[g_dtype] + n_ids * ITEMSIZE["int32"]
            + vocab * dim * ITEMSIZE[out_dtype])


def lookup_bound_s(lookups: int, n_ids: int, vocab: int, dim: int, table_dtype: str,
                   compute_dtype: str) -> float:
    """Least seconds of a train step's lookups at the HBM rate: ``lookups``
    gathers forward and as many scatter-adds backward, of ``n_ids`` ids each
    (the adds and casts, one per element, are far below any compute
    limit)."""
    one = (gather_bytes(n_ids, vocab, dim, table_dtype, compute_dtype)
           + scatter_add_bytes(n_ids, vocab, dim, compute_dtype, table_dtype))
    return lookups * one / H100_BYTES_PER_S
