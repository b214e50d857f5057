"""Five-stage pipeline assembly: config -> (tokenizer, dataset, model, loss, optimizer).

The counterpart of ``twotowers_tpu/train/pipeline.py``: stage 1 tokenizer,
stage 2 dataset (fits the tokenizer if unfit), stage 3 embedding sized from
the dataset's vocabulary, stage 4 the towers, stage 5 loss and optimizer.
The model's weights are drawn from a ``torch.Generator`` seeded with
``seed`` and placed on ``device``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Union

import torch

from ..data.triplets import TripletDataset
from ..models.losses import LossDef, build_loss
from ..models.towers import TwoTower, TwoTowerSpec, spec_from_config
from ..tokenizers import BaseTokenizer, build_tokenizer
from ..utils.device import resolve_device
from ..utils.logging import get_logger
from .optim import OptimizerConfig, build_optimizer

logger = get_logger("train.pipeline")

DEFAULT_MAX_SEQUENCE_LENGTH = 64


@dataclasses.dataclass
class Pipeline:
    tokenizer: BaseTokenizer
    dataset: TripletDataset
    spec: TwoTowerSpec
    model: TwoTower
    optimizer: OptimizerConfig
    loss_def: LossDef
    max_length: int


def max_length_from_config(config: Dict[str, Any]) -> int:
    tok_cfg = config.get("tokeniser", config.get("tokenizer", {})) or {}
    return int(tok_cfg.get("max_len", config.get("max_sequence_length",
                                                 DEFAULT_MAX_SEQUENCE_LENGTH)))


def build_tokenizer_from_config(config: Dict[str, Any]) -> BaseTokenizer:
    # accept both the British spelling and the American one
    tok_cfg = dict(config.get("tokeniser", config.get("tokenizer", {})) or {})
    kind = tok_cfg.pop("type", "char")
    return build_tokenizer(kind, **tok_cfg)


def build_pipeline(config: Dict[str, Any], *, seed: int = 0,
                   dataset: Optional[TripletDataset] = None,
                   device: Union[str, torch.device] = "cuda") -> Pipeline:
    """Assemble the full training pipeline from a config dict."""
    device = resolve_device(device)
    tokenizer = dataset.tokenizer if dataset is not None else build_tokenizer_from_config(config)
    max_length = max_length_from_config(config)

    if dataset is None:
        dataset = TripletDataset(
            data_path=config["data"],
            tokenizer=tokenizer,
            max_length=max_length,
            encode=bool((config.get("dataset", {}) or {}).get("load_to_memory", True)),
        )

    spec = spec_from_config(config, vocab_size=dataset.vocab_size)
    model = TwoTower(spec, torch.Generator().manual_seed(seed)).to(device)

    loss_cfg = dict(config.get("loss", {"type": "triplet", "margin": 0.2}) or {})
    loss_kind = loss_cfg.pop("type", "triplet")
    loss_def = build_loss(loss_kind, **loss_cfg)

    optimizer = build_optimizer(config)
    logger.info(
        "Pipeline built: vocab=%d, arch=%s, hidden=%d, loss=%s, tied=%s, device=%s",
        dataset.vocab_size, spec.tower.arch, spec.tower.hidden_dim,
        loss_kind, spec.tied_weights, device,
    )
    return Pipeline(tokenizer, dataset, spec, model, optimizer, loss_def, max_length)
