"""Training stage: optimizer, step, loop, metrics and checkpoints."""

from .checkpoint import (
    latest_checkpoint, load_checkpoint, load_trained_model, save_checkpoint, save_params)
from .loop import evaluate, train_epoch, train_model
from .optim import OptimizerConfig, build_optimizer
from .pipeline import Pipeline, build_pipeline
from .step import TrainState, create_train_state, make_eval_step, make_train_step

__all__ = [
    "OptimizerConfig",
    "Pipeline",
    "TrainState",
    "build_optimizer",
    "build_pipeline",
    "create_train_state",
    "evaluate",
    "latest_checkpoint",
    "load_checkpoint",
    "load_trained_model",
    "make_eval_step",
    "make_train_step",
    "save_checkpoint",
    "save_params",
    "train_epoch",
    "train_model",
]
