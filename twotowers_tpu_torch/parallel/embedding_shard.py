"""Row-sharded vocabulary lookup: a local gather per shard, summed over 'model'.

The counterpart of ``twotowers_tpu/parallel/embedding_shard.py``. The
(V, D) table is padded to a multiple of the model axis and split by rows;
model rank ``m`` holds rows ``[m * rows, (m + 1) * rows)``. A lookup runs
the gather kernel on ``ids - m * rows`` over the local rows, where an id
outside ``[0, rows)`` reads as a zero row, then sums the (B, L, D)
activations over the model group. That is the JAX package's clamp, mask
and ``psum``, with no clamp and no mask tensor. The backward of the sum is
the identity (every model rank computes the same loss from it), and the
backward of the local gather is the scatter-add kernel over the local rows,
which drops the ids other shards own. On CPU tensors both kernels take
their plain versions.
"""

from __future__ import annotations

import torch
from torch.distributed.device_mesh import DeviceMesh

from ..models.embeddings import lookup_rows
from .collectives import AllReduceSum
from .mesh import MODEL_AXIS, axis_group, axis_index


def shard_vocab_rows(vocab_size: int, num_shards: int) -> int:
    """Rows per shard after padding the vocab to a multiple of the axis."""
    return -(-vocab_size // num_shards)


def pad_table_for_sharding(table: torch.Tensor, num_shards: int) -> torch.Tensor:
    """Zero-pad the table's row axis so it divides evenly across shards."""
    vocab, dim = table.shape
    padded = shard_vocab_rows(vocab, num_shards) * num_shards
    if padded == vocab:
        return table
    return torch.cat([table, table.new_zeros((padded - vocab, dim))])


def sharded_embed_ids(
    local_table: torch.Tensor,
    ids: torch.Tensor,
    mesh: DeviceMesh,
    dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Look up global ``ids`` (..., L) in the row-sharded table, of which
    this rank holds ``local_table`` (rows, D); returns (..., L, D) in
    ``dtype``, the same on every rank of the model group."""
    offset = axis_index(mesh, MODEL_AXIS) * local_table.shape[0]
    local = lookup_rows(local_table, ids - offset, dtype)
    return AllReduceSum.apply(local, axis_group(mesh, MODEL_AXIS))
