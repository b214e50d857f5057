"""Placement of parameters and batches over the ('data', 'model') mesh.

The counterpart of ``twotowers_tpu/parallel/sharding.py``, with a rank's
own part in place of a ``NamedSharding``:

* embedding table: rows over 'model' when ``shard_vocab`` (each rank keeps
  its row block of the table, zero-padded to a multiple of the axis);
  whole on every rank otherwise;
* tower parameters and the learned positions: whole on every rank;
* optimizer state: built over the rank's parameters, so it follows them;
* batches: rows over 'data' (each data rank takes its block of the global
  batch).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn
from torch.distributed.device_mesh import DeviceMesh

from ..models.towers import TwoTower
from .embedding_shard import pad_table_for_sharding, shard_vocab_rows
from .mesh import DATA_AXIS, MODEL_AXIS, axis_index, axis_size

TABLE = "embedding.table"


def param_specs(model: TwoTower, shard_vocab: bool) -> Dict[str, Tuple]:
    """Each parameter's partition spec, by ``named_parameters`` name:
    ``('model', None)`` (rows over 'model') for the embedding table when
    ``shard_vocab``, ``()`` (whole on every rank) otherwise."""
    return {name: ((MODEL_AXIS, None) if shard_vocab and name == TABLE else ())
            for name, _ in model.named_parameters()}


def table_block(table, mesh: DeviceMesh):
    """This rank's row block of ``table`` (numpy or torch), zero-padded to
    a multiple of the model axis."""
    shards = axis_size(mesh, MODEL_AXIS)
    rows = shard_vocab_rows(table.shape[0], shards)
    start = axis_index(mesh, MODEL_AXIS) * rows
    if isinstance(table, np.ndarray):
        padded = np.zeros((rows * shards, table.shape[1]), table.dtype)
        padded[:table.shape[0]] = table
        return padded[start:start + rows]
    return pad_table_for_sharding(table, shards)[start:start + rows]


@torch.no_grad()
def shard_params(model: TwoTower, mesh: DeviceMesh, shard_vocab: bool) -> TwoTower:
    """Keep this rank's row block of the embedding table (in place) when
    ``shard_vocab`` and the model axis is wider than 1; returns ``model``."""
    if shard_vocab and axis_size(mesh, MODEL_AXIS) > 1:
        table = model.embedding.table
        model.embedding.table = nn.Parameter(table_block(table, mesh).clone(),
                                             requires_grad=table.requires_grad)
    return model


def batch_sharding(mesh: DeviceMesh, ndim: int = 2) -> Callable[[np.ndarray], np.ndarray]:
    """This rank's rows of a batch-major ``ndim``-d array whose leading axis
    divides by the data axis: block ``d`` for data rank ``d``."""
    data, d = axis_size(mesh, DATA_AXIS), axis_index(mesh, DATA_AXIS)

    def rows(array: np.ndarray) -> np.ndarray:
        if array.ndim != ndim or array.shape[0] % data:
            raise ValueError(f"batch_sharding: a {ndim}-d array with rows divisible by "
                             f"{data}, got shape {array.shape}")
        block = array.shape[0] // data
        return array[d * block:(d + 1) * block]

    return rows


def pad_batch_to_multiple(array, multiple: int) -> np.ndarray:
    """Zero-pad the leading axis to a multiple (so 'data' divides B)."""
    n = array.shape[0]
    target = -(-n // multiple) * multiple
    if target == n:
        return array
    pad_width = [(0, target - n)] + [(0, 0)] * (array.ndim - 1)
    return np.pad(np.asarray(array), pad_width)


def local_rows(mesh: DeviceMesh, *arrays: Optional[np.ndarray]):
    """This rank's rows of each global batch array (``None`` stays
    ``None``), after padding to a multiple of the data axis: zero ids
    (PAD) and weight 0."""
    data = axis_size(mesh, DATA_AXIS)
    return tuple(None if a is None else
                 batch_sharding(mesh, a.ndim)(pad_batch_to_multiple(a, data))
                 for a in arrays)

