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

Not ported yet, and refused rather than ignored: ``mesh:`` (ROADMAP.md §1
item 11) and ``huggingface.push_to_hub`` (§1 item 12).
"""

from __future__ import annotations

import contextlib
import time
from typing import Any, Dict, Optional, Tuple, Union

import numpy as np
import torch

from ..convert import load_params, opt_state_from_jax, opt_state_to_jax, params_to_jax
from ..data.batching import Batch, iterate_batches, num_batches, prefetch_to_device
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
) -> Tuple[TrainState, Dict[str, float]]:
    """Run one epoch; returns (state, epoch metrics).

    The epoch loss is the weighted-by-real-samples mean of batch losses.
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

    batch_iter = prefetch_to_device(
        iterate_batches(arrays, batch_size, shuffle=True, seed=seed + epoch),
        device=_device_of(state.model))
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
             dataset=None) -> Dict[str, float]:
    """Validation pass: weighted-mean loss + similarity stats (no grad)."""
    dataset = dataset or pipeline.dataset
    arity = pipeline.loss_def.arity
    totals = {"loss": 0.0, "pos_similarity": 0.0, "neg_similarity": 0.0,
              "similarity_diff": 0.0}
    count = 0
    batch_iter = prefetch_to_device(
        iterate_batches(dataset.arrays(), batch_size, shuffle=False),
        device=_device_of(model))
    for batch in batch_iter:
        metrics = eval_step(model, batch.queries, batch.positives,
                            _negatives_for_arity(batch, arity), batch.weights)
        real = batch.num_real
        for key in totals:
            totals[key] += float(metrics[key]) * real
        count += real
    return {k: (v / count if count else float("inf")) for k, v in totals.items()}


def _refuse_unported(config: Dict[str, Any]) -> None:
    if config.get("mesh"):
        raise NotImplementedError(
            "mesh: (sharded training) is not ported yet (ROADMAP.md §1 item 11)")
    if (config.get("huggingface", {}) or {}).get("push_to_hub"):
        raise NotImplementedError(
            "huggingface.push_to_hub is not ported yet (ROADMAP.md §1 item 12)")


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


def train_model(config: Dict[str, Any], *, seed: int = 0,
                device: Union[str, torch.device] = "cuda") -> Tuple[TrainState, Pipeline]:
    """Train a two-tower model from a config dict on ``device`` (the card
    unless the caller asks for the CPU); returns (state, pipeline)."""
    _refuse_unported(config)
    epochs = int(config.get("epochs", DEFAULT_EPOCHS))
    batch_size = int(config.get("batch_size", DEFAULT_BATCH_SIZE))
    checkpoint_dir = config.get("checkpoint_dir", "checkpoints")
    log_dir = config.get("log_dir", "logs")

    pipeline = build_pipeline(config, seed=seed, device=device)
    train_step = make_train_step(pipeline.loss_def, pipeline.optimizer)
    state = create_train_state(pipeline.model, pipeline.optimizer, seed)

    # optional validation split: `val_data: path` enables per-epoch val metrics
    val_dataset = None
    eval_step = None
    if config.get("val_data"):
        from ..data.triplets import TripletDataset

        val_dataset = TripletDataset(config["val_data"], pipeline.tokenizer,
                                     max_length=pipeline.max_length)
        eval_step = make_eval_step(pipeline.loss_def)

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
            load_params(state.model, tree["params"])
            if tree["opt_state"] is not None:
                opt_state_from_jax(tree["opt_state"], state.model, state.optimizer)
            state.step += int(meta.get("step", 0))
            start_epoch = int(meta.get("epoch", 0)) + 1
            logger.info("Resumed from %s at epoch %d", resume_path, start_epoch)
        else:
            logger.info("No checkpoint found to resume from; starting fresh")

    best_loss = float("inf")
    with MetricLogger(config, log_dir=log_dir) as metric_logger:
        for epoch in range(start_epoch, epochs + 1):
            logger.info("Epoch %d/%d", epoch, epochs)
            profiling = profile_dir and epoch == start_epoch
            with trace_to(profile_dir, _device_of(state.model)) if profiling \
                    else contextlib.nullcontext():
                state, epoch_metrics = train_epoch(
                    train_step, state, pipeline, batch_size,
                    epoch=epoch, seed=seed, metric_logger=metric_logger,
                )
            if val_dataset is not None:
                val_metrics = evaluate(eval_step, state.model, pipeline, batch_size,
                                       dataset=val_dataset)
                metric_logger.log({
                    "epoch": epoch,
                    **{f"val/{k}": v for k, v in val_metrics.items()},
                })
                logger.info("  val loss=%.6f pos_sim=%.4f",
                            val_metrics["loss"], val_metrics["pos_similarity"])
            lr = (config.get("optimizer", {}) or {}).get(
                "lr", config.get("learning_rate", 1e-3))
            metric_logger.log({
                "epoch": epoch,
                "train/epoch_loss": epoch_metrics["loss"],
                "train/epoch_time": epoch_metrics["time"],
                "train/learning_rate": lr,
                "train/batch_size": batch_size,
                "performance/epoch_samples_per_second": epoch_metrics["samples_per_second"],
            })
            if epoch_metrics["loss"] < best_loss:
                best_loss = epoch_metrics["loss"]
                logger.info("New best model with loss: %.6f", best_loss)
                save_checkpoint(
                    {"params": params_to_jax(state.model),
                     "opt_state": opt_state_to_jax(state.model, state.optimizer)},
                    checkpoint_dir,
                    tokenizer_state=pipeline.tokenizer.state_dict(),
                    config=config,
                    epoch=epoch,
                    step=state.step,
                    loss=best_loss,
                )

    logger.info("Training completed. Best loss: %.6f", best_loss)
    return state, pipeline
