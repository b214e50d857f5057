"""The training loop: config -> trained model, with checkpointing and resume.

The counterpart of ``twotowers_tpu/train/loop.py``: pipeline build, the
epoch loop over fixed-shape batches copied to the device two ahead
(``prefetch_to_device``), per-batch metrics, optional validation,
best-loss checkpoints and ``resume``. The step's metric scalars are read
one step late, so the host queues the next step before it waits on the
card. The epoch loss is the mean of batch losses weighted by their real
samples. ``profile: {trace_dir: DIR}`` traces the first epoch that runs
with ``torch.profiler`` (host activity, and the card's where the model is
on it) and writes a Chrome trace (``*.pt.trace.json``) into ``DIR``.

``mesh: {data: N, model: M, shard_vocab}`` trains over a process group of
N * M ranks (``parallel/``): each rank takes its data rank's rows of every
batch, the sharded train step sums the gradients (a pair loss takes the
global batch's negatives, so ``global_negatives`` changes nothing, as in
the JAX package, whose GSPMD step sees the global batch either way), and
``val_data:`` takes the sharded eval step. Rank 0 alone logs metrics and
writes checkpoints; every rank takes part in gathering the table shards and
their moments, so a checkpoint holds the whole, unpadded table as a
single process writes it, and loads with or without a mesh (``resume``
under a mesh reads it on every rank and keeps the rank's rows).

``huggingface: {push_to_hub: true, repo_id, private}`` stages the best
model and uploads it after training (``hub.save_and_upload``, rank 0 only);
a failed upload is logged and training still returns, as in the JAX
package.
"""

from __future__ import annotations

import contextlib
import time
from typing import Any, Callable, Dict, Optional, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

from ..convert import load_params, opt_state_from_jax, opt_state_to_jax, params_to_jax
from ..data.batching import Batch, iterate_batches, num_batches, prefetch_to_device
from ..parallel.mesh import is_writer
from ..utils.logging import Timer, get_logger
from .checkpoint import latest_checkpoint, load_checkpoint, save_checkpoint
from .metrics import MetricLogger
from .pipeline import Pipeline, build_pipeline
from .step import TrainState, create_train_state, make_eval_step, make_train_step

logger = get_logger("train.loop")

DEFAULT_EPOCHS = 3
DEFAULT_BATCH_SIZE = 256


def _negatives_for_arity(batch: Batch, arity: str):
    if arity == "pair":
        return None
    negs = batch.negatives
    if negs is None:
        raise ValueError(f"Loss arity {arity!r} needs negatives in the data")
    if arity == "multi_neg" and negs.ndim == 2:
        negs = negs[:, None, :]  # single negative per row -> N=1 group
    return negs


def _device_of(model) -> torch.device:
    return next(model.parameters()).device


def train_epoch(
    train_step,
    state: TrainState,
    pipeline: Pipeline,
    batch_size: int,
    *,
    epoch: int,
    seed: int,
    metric_logger: Optional[MetricLogger] = None,
    batch_placer: Optional[Callable[[Batch], Batch]] = None,
) -> Tuple[TrainState, Dict[str, float]]:
    """Run one epoch; returns (state, epoch metrics).

    The epoch loss is the weighted-by-real-samples mean of batch losses.
    ``batch_placer`` maps each host batch to the part this rank takes (a
    mesh's data rows) before it is copied to the device.
    ``performance/batch_time`` is host wall-clock from a step's dispatch to
    the next step's dispatch, since the metrics are read one step late.
    """
    arity = pipeline.loss_def.arity
    arrays = pipeline.dataset.arrays()
    timer = Timer(f"epoch{epoch}")
    timer.start()

    total_loss = 0.0
    sample_count = 0
    batch_times = []
    pending = None  # (metrics, num_real, batch_start) read one step late

    def drain(pending, batch_idx):
        nonlocal total_loss, sample_count
        metrics, real, batch_start = pending
        host = {k: float(v) for k, v in metrics.items()}
        batch_time = time.time() - batch_start
        batch_times.append(batch_time)
        total_loss += host["loss"] * real
        sample_count += real
        if metric_logger is not None:
            metric_logger.log({
                "train/batch": batch_idx,
                "train/batch_loss": host["loss"],
                "train/pos_similarity": host["pos_similarity"],
                "train/neg_similarity": host["neg_similarity"],
                "train/similarity_diff": host["similarity_diff"],
                "performance/batch_time": batch_time,
                "performance/samples_per_second": real / max(batch_time, 1e-9),
                "gradients/total_norm": host["grad_norm"],
                "train/grad_norm": host["grad_norm"],
            })
        return host

    batches = iterate_batches(arrays, batch_size, shuffle=True, seed=seed + epoch)
    if batch_placer is not None:
        batches = map(batch_placer, batches)
    batch_iter = prefetch_to_device(batches, device=_device_of(state.model))
    last_host = None
    for batch_idx, batch in enumerate(batch_iter):
        batch_start = time.time()
        state, metrics = train_step(
            state, batch.queries, batch.positives,
            _negatives_for_arity(batch, arity), batch.weights,
        )
        if pending is not None:
            last_host = drain(pending, batch_idx - 1)
        pending = (metrics, batch.num_real, batch_start)
    if pending is not None:
        last_host = drain(pending, num_batches(len(pipeline.dataset), batch_size) - 1)

    epoch_time = timer.stop()
    epoch_loss = total_loss / sample_count if sample_count else float("inf")
    metrics_out = {
        "loss": epoch_loss,
        "time": epoch_time,
        "avg_batch_time": float(np.mean(batch_times)) if batch_times else 0.0,
        "samples_per_second": sample_count / max(epoch_time, 1e-9),
    }
    logger.info(
        "Epoch %d: loss=%.6f, %.1f samples/s (%.2fs)",
        epoch, epoch_loss, metrics_out["samples_per_second"], epoch_time,
    )
    if last_host is not None:
        logger.info(
            "  last batch: pos_sim=%.4f neg_sim=%.4f diff=%.4f",
            last_host["pos_similarity"], last_host["neg_similarity"],
            last_host["similarity_diff"],
        )
    return state, metrics_out


def evaluate(eval_step, model, pipeline: Pipeline, batch_size: int,
             dataset=None, batch_placer: Optional[Callable[[Batch], Batch]] = None
             ) -> Dict[str, float]:
    """Validation pass: weighted-mean loss + similarity stats (no grad).
    ``batch_placer`` as in ``train_epoch``."""
    dataset = dataset or pipeline.dataset
    arity = pipeline.loss_def.arity
    totals = {"loss": 0.0, "pos_similarity": 0.0, "neg_similarity": 0.0,
              "similarity_diff": 0.0}
    count = 0
    batches = iterate_batches(dataset.arrays(), batch_size, shuffle=False)
    if batch_placer is not None:
        batches = map(batch_placer, batches)
    batch_iter = prefetch_to_device(batches, device=_device_of(model))
    for batch in batch_iter:
        metrics = eval_step(model, batch.queries, batch.positives,
                            _negatives_for_arity(batch, arity), batch.weights)
        real = batch.num_real
        for key in totals:
            totals[key] += float(metrics[key]) * real
        count += real
    return {k: (v / count if count else float("inf")) for k, v in totals.items()}


@contextlib.contextmanager
def trace_to(trace_dir: str, device: torch.device):
    """Profile the body with ``torch.profiler`` (CPU activity, plus CUDA on
    the card) and write its Chrome trace into ``trace_dir``."""
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(str(trace_dir))):
        yield
    logger.info("Wrote profiler trace to %s", trace_dir)


def _mesh_setup(mesh_cfg: Dict[str, Any], pipeline: Pipeline, seed: int,
                device: torch.device):
    """The sharded step, state, eval step and batch placer of a ``mesh:``
    config, and a function that gives the whole (params, opt_state) trees
    of the state (a collective)."""
    from ..parallel import (
        create_sharded_train_state, make_mesh, make_sharded_eval_step,
        make_sharded_train_step)
    from ..parallel.sharding import local_rows
    from ..parallel.train import sharded_state_to_jax, shard_state_tree

    mesh = make_mesh(data=mesh_cfg.get("data"), model=int(mesh_cfg.get("model", 1)),
                     device_type=device.type)
    shard_vocab = bool(mesh_cfg.get("shard_vocab", True))
    train_step = make_sharded_train_step(pipeline.loss_def, pipeline.optimizer, mesh,
                                         shard_vocab=shard_vocab)
    state = create_sharded_train_state(pipeline.model, pipeline.optimizer, mesh,
                                       shard_vocab=shard_vocab, seed=seed)
    eval_step = make_sharded_eval_step(pipeline.loss_def, mesh, shard_vocab=shard_vocab)

    def batch_placer(batch: Batch) -> Batch:
        q, p, n, w = local_rows(mesh, batch.queries, batch.positives, batch.negatives,
                                batch.weights)
        return Batch(queries=q, positives=p, negatives=n, weights=w,
                     num_real_hint=batch.num_real)

    def trees(state: TrainState):
        return sharded_state_to_jax(state, mesh, pipeline.spec.embedding.vocab_size,
                                    shard_vocab)

    def localize(tree: Dict[str, Any]) -> None:
        shard_state_tree(tree["params"], tree["opt_state"], mesh, shard_vocab)

    logger.info("Sharded training over mesh %s", dict(zip(mesh.mesh_dim_names, mesh.shape)))
    return train_step, state, eval_step, batch_placer, trees, localize


def train_model(config: Dict[str, Any], *, seed: int = 0,
                device: Union[str, torch.device] = "cuda") -> Tuple[TrainState, Pipeline]:
    """Train a two-tower model from a config dict on ``device`` (the card
    unless the caller asks for the CPU); returns (state, pipeline). Under
    ``mesh:`` every rank of the process group calls it."""
    epochs = int(config.get("epochs", DEFAULT_EPOCHS))
    batch_size = int(config.get("batch_size", DEFAULT_BATCH_SIZE))
    checkpoint_dir = config.get("checkpoint_dir", "checkpoints")
    log_dir = config.get("log_dir", "logs")

    pipeline = build_pipeline(config, seed=seed, device=device)
    mesh_cfg = config.get("mesh") or {}
    batch_placer = None
    if mesh_cfg:
        train_step, state, eval_step, batch_placer, trees, localize = _mesh_setup(
            mesh_cfg, pipeline, seed, _device_of(pipeline.model))
    else:
        train_step = make_train_step(pipeline.loss_def, pipeline.optimizer)
        state = create_train_state(pipeline.model, pipeline.optimizer, seed)
        eval_step = make_eval_step(pipeline.loss_def)

        def trees(state: TrainState):
            return params_to_jax(state.model), opt_state_to_jax(state.model, state.optimizer)

        def localize(tree: Dict[str, Any]) -> None:
            pass
    writer = is_writer()

    # optional validation split: `val_data: path` enables per-epoch val metrics
    val_dataset = None
    if config.get("val_data"):
        from ..data.triplets import TripletDataset

        val_dataset = TripletDataset(config["val_data"], pipeline.tokenizer,
                                     max_length=pipeline.max_length)

    # optional torch.profiler trace of the first epoch's steps
    # (`profile: {trace_dir: ...}`)
    profile_dir = (config.get("profile", {}) or {}).get("trace_dir")

    start_epoch = 1
    if config.get("resume"):
        resume_path = config["resume"]
        if resume_path is True or str(resume_path).lower() == "latest":
            resume_path = latest_checkpoint(checkpoint_dir)
        if resume_path:
            tree, meta = load_checkpoint(str(resume_path))
            localize(tree)
            load_params(state.model, tree["params"])
            if tree["opt_state"] is not None:
                opt_state_from_jax(tree["opt_state"], state.model, state.optimizer)
            state.step += int(meta.get("step", 0))
            start_epoch = int(meta.get("epoch", 0)) + 1
            logger.info("Resumed from %s at epoch %d", resume_path, start_epoch)
        else:
            logger.info("No checkpoint found to resume from; starting fresh")

    best_loss = float("inf")
    best_path = None
    with (MetricLogger(config, log_dir=log_dir) if writer
          else contextlib.nullcontext()) as metric_logger:
        for epoch in range(start_epoch, epochs + 1):
            logger.info("Epoch %d/%d", epoch, epochs)
            profiling = profile_dir and epoch == start_epoch
            with trace_to(profile_dir, _device_of(state.model)) if profiling \
                    else contextlib.nullcontext():
                state, epoch_metrics = train_epoch(
                    train_step, state, pipeline, batch_size,
                    epoch=epoch, seed=seed, metric_logger=metric_logger,
                    batch_placer=batch_placer,
                )
            if val_dataset is not None:
                val_metrics = evaluate(eval_step, state.model, pipeline, batch_size,
                                       dataset=val_dataset, batch_placer=batch_placer)
                if writer:
                    metric_logger.log({
                        "epoch": epoch,
                        **{f"val/{k}": v for k, v in val_metrics.items()},
                    })
                logger.info("  val loss=%.6f pos_sim=%.4f",
                            val_metrics["loss"], val_metrics["pos_similarity"])
            lr = (config.get("optimizer", {}) or {}).get(
                "lr", config.get("learning_rate", 1e-3))
            if writer:
                metric_logger.log({
                    "epoch": epoch,
                    "train/epoch_loss": epoch_metrics["loss"],
                    "train/epoch_time": epoch_metrics["time"],
                    "train/learning_rate": lr,
                    "train/batch_size": batch_size,
                    "performance/epoch_samples_per_second":
                        epoch_metrics["samples_per_second"],
                })
            # every rank reads the same global losses, so all take this
            # branch together (the trees of a mesh are a collective)
            if epoch_metrics["loss"] < best_loss:
                best_loss = epoch_metrics["loss"]
                logger.info("New best model with loss: %.6f", best_loss)
                params, opt_state = trees(state)
                if writer:
                    best_path = save_checkpoint(
                        {"params": params, "opt_state": opt_state},
                        checkpoint_dir,
                        tokenizer_state=pipeline.tokenizer.state_dict(),
                        config=config,
                        epoch=epoch,
                        step=state.step,
                        loss=best_loss,
                    )
                if mesh_cfg:
                    dist.barrier()  # the checkpoint is whole before any rank reads it

    logger.info("Training completed. Best loss: %.6f", best_loss)

    hf_config = config.get("huggingface", {}) or {}
    if hf_config.get("push_to_hub") and best_path:
        from ..hub.huggingface import save_and_upload

        try:
            save_and_upload(
                checkpoint_path=best_path,
                repo_id=hf_config.get("repo_id", "mlx7-two-tower"),
                private=bool(hf_config.get("private", False)),
            )
        except Exception as exc:  # network or auth: logged, as the JAX package does
            logger.error("Failed to push model to the Hub: %s", exc)
    return state, pipeline
