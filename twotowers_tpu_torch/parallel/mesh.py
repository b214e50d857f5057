"""Process groups and the ('data', 'model') device mesh.

The counterpart of ``twotowers_tpu/parallel/mesh.py``. The JAX package runs
one process over many devices; here each rank is a process, joined by a
``torch.distributed`` process group, and the mesh is a
``torch.distributed.device_mesh.DeviceMesh`` over the ranks with the dims
``('data', 'model')``. Rank ``d * model + m`` sits at mesh coordinate
``(d, m)``, the order in which the JAX package lays out ``jax.devices()``.

The backend follows one rule, chosen before any collective runs and
logged: NCCL when every rank of a host has a card of its own; gloo when
ranks share a card (gloo stages CUDA tensors through host memory) or run
on the CPU. The collectives of this package use only ``all_gather`` and
``all_reduce``, which both backends take for CPU and CUDA tensors.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ..utils.device import resolve_device
from ..utils.logging import get_logger

logger = get_logger("parallel.mesh")

DATA_AXIS = "data"
MODEL_AXIS = "model"

# a stated share of the card's memory for one shard of the embedding table
# with its f32 gradient and two Adam moments (recommend_model_parallelism)
TABLE_STATE_SHARE = 0.25
TABLE_STATE_COPIES = 4  # the f32 table, its f32 gradient, Adam's mu and nu


def choose_backend(device_type: str, local_ranks: int) -> str:
    """The backend rule: ``nccl`` when each of the host's ``local_ranks``
    ranks has a card of its own, ``gloo`` when ranks share a card or run on
    the CPU."""
    if device_type == "cuda" and local_ranks <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    device_type: str = "cuda",
) -> Optional[str]:
    """Join this process to the process group; returns the backend, or
    ``None`` in a single process (nothing to join).

    The group comes from torchrun's environment (``RANK``, ``WORLD_SIZE``,
    ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``)
    or from the explicit arguments: ``coordinator_address`` is
    ``host:port`` (a TCP store on that host) or an ``init_method`` URL such
    as ``file:///path``. On the card the rank's device is
    ``LOCAL_RANK % device_count`` and is set before the group starts.
    """
    if dist.is_initialized():
        return dist.get_backend()
    world = int(num_processes if num_processes is not None
                else os.environ.get("WORLD_SIZE", 1))
    if world <= 1:
        return None
    rank = int(process_id if process_id is not None else os.environ["RANK"])
    local_rank = int(os.environ.get("LOCAL_RANK", rank))
    local_ranks = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    if device_type == "cuda":
        resolve_device("cuda")
        torch.cuda.set_device(local_rank % torch.cuda.device_count())
        torch.cuda.init()
    backend = choose_backend(device_type, local_ranks)
    if coordinator_address is None:
        init_method = "env://"
    elif "://" in coordinator_address:
        init_method = coordinator_address
    else:
        init_method = f"tcp://{coordinator_address}"
    dist.init_process_group(backend, init_method=init_method, rank=rank, world_size=world)
    logger.info("Rank %d of %d joined with backend %s (%d ranks on this host, %s)",
                rank, world, backend, local_ranks, device_type)
    return backend


def make_mesh(data: Optional[int] = None, model: int = 1,
              device_type: str = "cuda") -> DeviceMesh:
    """A ('data', 'model') mesh over the first ``data * model`` ranks.

    Defaults: all ranks on the data axis, model axis 1. Every rank of the
    group calls it; a rank past the mesh gets ``get_coordinate() is None``.
    """
    if not dist.is_initialized():
        raise RuntimeError(
            "make_mesh needs a process group: start one process per rank with "
            "`torchrun --nproc-per-node N ...` (then initialize_distributed()), or call "
            "initialize_distributed(address, num_processes, process_id) in each process")
    n = dist.get_world_size()
    if data is None:
        if n % model:
            raise ValueError(f"{n} devices not divisible by model={model}")
        data = n // model
    if data * model > n:
        raise ValueError(f"mesh {data}x{model} needs more than the {n} devices available "
                         f"(start {data * model} ranks with torchrun --nproc-per-node)")
    ranks = torch.arange(data * model).reshape(data, model)
    return DeviceMesh(device_type, ranks, mesh_dim_names=(DATA_AXIS, MODEL_AXIS))


def mesh_shape(mesh: DeviceMesh) -> Tuple[int, int]:
    return mesh.size(0), mesh.size(1)


def axis_size(mesh: DeviceMesh, axis: str) -> int:
    return mesh.size(mesh.mesh_dim_names.index(axis))


def axis_index(mesh: DeviceMesh, axis: str) -> int:
    """This rank's coordinate along ``axis`` (``jax.lax.axis_index``)."""
    return mesh.get_local_rank(axis)


def axis_group(mesh: DeviceMesh, axis: str):
    """The process group of the ranks that share this rank's other
    coordinate, in the order of ``axis``."""
    return mesh.get_group(axis)


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """The device this rank's tensors of the mesh live on."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def is_writer() -> bool:
    """Whether this process writes files: rank 0, or the only process."""
    return not dist.is_initialized() or dist.get_rank() == 0


def recommend_model_parallelism(vocab_size: int, embedding_dim: int,
                                max_shards: Optional[int] = None, *,
                                device_bytes: Optional[int] = None) -> int:
    """Smallest model-axis size whose shard of the embedding table fits
    the card; the remaining ranks go on the data axis.

    The card's rule: the smallest power of two ``S`` for which one shard's
    f32 table, its f32 gradient and its two Adam moments
    (``4 * ceil(V / S) * D * 4`` bytes) take at most ``TABLE_STATE_SHARE``
    of the card's memory (``device_bytes``, by default the current card's
    total). The JAX package's rule is the TPU kernel's VMEM budget, which
    the card does not have: the scatter-add kernel takes any table.
    ``max_shards`` defaults to the ranks of the group (or the cards, or 1);
    when even ``max_shards`` does not fit, the largest allowed power of two
    is returned (best available).
    """
    if max_shards is None:
        max_shards = (dist.get_world_size() if dist.is_initialized()
                      else max(torch.cuda.device_count(), 1))
    if device_bytes is None:
        device_bytes = torch.cuda.get_device_properties(
            resolve_device("cuda").index or 0).total_memory
    budget = TABLE_STATE_SHARE * device_bytes
    shards = 1
    while TABLE_STATE_COPIES * -(-vocab_size // shards) * embedding_dim * 4 > budget:
        if shards * 2 > max_shards:
            logger.warning("vocab %d x %d does not fit %.0f%% of the card's memory even at "
                           "model=%d", vocab_size, embedding_dim, 100 * TABLE_STATE_SHARE,
                           shards)
            break
        shards *= 2
    return shards
