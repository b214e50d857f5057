"""The parallel layer over ``torch.distributed``: mesh, placement,
collectives and the sharded train step (``twotowers_tpu/parallel``)."""

from .collectives import global_in_batch_loss, sharded_topk_merge
from .embedding_shard import pad_table_for_sharding, sharded_embed_ids
from .mesh import (DATA_AXIS, MODEL_AXIS, initialize_distributed, make_mesh,
                   mesh_shape, recommend_model_parallelism)
from .sharding import batch_sharding, pad_batch_to_multiple, param_specs, shard_params
from .train import (
    create_sharded_train_state,
    make_sharded_embed_fn,
    make_sharded_eval_step,
    make_sharded_train_step,
    shard_batch,
)

__all__ = [
    "DATA_AXIS",
    "MODEL_AXIS",
    "batch_sharding",
    "create_sharded_train_state",
    "global_in_batch_loss",
    "initialize_distributed",
    "make_mesh",
    "make_sharded_embed_fn",
    "make_sharded_eval_step",
    "make_sharded_train_step",
    "mesh_shape",
    "recommend_model_parallelism",
    "pad_batch_to_multiple",
    "pad_table_for_sharding",
    "param_specs",
    "shard_batch",
    "shard_params",
    "sharded_embed_ids",
    "sharded_topk_merge",
]
