"""The per-layer metrics that read the program's own spans
(``twotowers_tpu_torch/utils/tracing.py``): each gives a finite reading
from spans the program recorded under the profiler, the median of its
span's durations from spans given to it, and nothing from a program that
has no such spans."""

from __future__ import annotations

import math
import sys

import pytest

from benchmark import harness
from benchmark.tests.tiny_cells import tiny_run

READERS = {"tokenize_ms.batch": "encode.tokenize", "results_ms.batch": "search.results",
           "readback_ms.batch": "readback", "batch_ms.train": "train.batch",
           "dispatch_ms.train": "train.step", "drain_ms.train": "train.drain"}
SEARCH = ["tokenize_ms.batch", "results_ms.batch", "readback_ms.batch"]
TRAIN = ["batch_ms.train", "dispatch_ms.train", "drain_ms.train"]


def _reader(name):
    return harness.load_reader(harness.BENCH_DIR / "metrics" / f"{name}.py")


def test_a_traced_search_run_reads_its_span_metrics():
    from twotowers_tpu_torch.utils import tracing

    tracing.clear()
    run = tiny_run("serve-batch256-msmarco", seconds=1.0, trace=True)
    out = harness.result(run, {"platform": "cpu"})
    assert run.correct, run.checks
    for name in SEARCH:
        value = out["metrics"][name]["value"]
        assert math.isfinite(value) and value > 0 and out["metrics"][name]["unit"] == "ms"
    tracing.clear()


def test_the_training_readers_read_a_profiled_epoch():
    """The training cell's traced epoch takes minutes on a CPU, so a tiny
    epoch of the program's ``train_epoch`` is profiled here instead."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from twotowers_tpu_torch.models.losses import build_loss
    from twotowers_tpu_torch.models.towers import TwoTower, spec_from_config
    from twotowers_tpu_torch.train.loop import train_epoch
    from twotowers_tpu_torch.train.optim import build_optimizer
    from twotowers_tpu_torch.train.pipeline import Pipeline
    from twotowers_tpu_torch.train.step import create_train_state, make_train_step
    from twotowers_tpu_torch.utils import tracing

    from benchmark.drivers.train_epoch import Pairs

    config = {"embedding": {"type": "lookup", "embedding_dim": 8},
              "encoder": {"arch": "mean", "hidden_dim": 8}, "optimizer": {"type": "adamw"}}
    spec = spec_from_config(config, 40)
    model = TwoTower(spec, generator=torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    pairs = Pairs(*(rng.integers(1, 40, size=(24, 12)).astype(np.int32) for _ in range(2)))
    loss_def, optimizer = build_loss("in_batch"), build_optimizer(config)
    pipeline = Pipeline(None, pairs, spec, model, optimizer, loss_def, 12)
    tracing.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        train_epoch(make_train_step(loss_def, optimizer), create_train_state(model, optimizer),
                    pipeline, 8, epoch=1, seed=0)
    for name in TRAIN:
        value = _reader(name)(None)
        assert value is not None and math.isfinite(value) and value > 0, name
    tracing.clear()


@pytest.mark.parametrize("name", sorted(READERS))
def test_each_reader_takes_the_median_of_its_span(name, monkeypatch):
    from twotowers_tpu_torch.utils import tracing

    def made(span, ms):
        return tracing.Span(span, 0, int(ms * 1e6), 1, None, 1, 0, {})

    held = [made(READERS[name], 1.0), made(READERS[name], 3.0), made(READERS[name], 2.0),
            made("other", 50.0)]
    monkeypatch.setattr(tracing, "spans", lambda: held)
    assert _reader(name)(None) == pytest.approx(2.0)
    monkeypatch.setattr(tracing, "spans", lambda: [made("other", 50.0)])
    assert _reader(name)(None) is None


@pytest.mark.parametrize("name", sorted(READERS))
def test_a_program_without_spans_gives_no_reading(name, monkeypatch):
    monkeypatch.setitem(sys.modules, "twotowers_tpu_torch.utils.tracing", None)
    assert _reader(name)(None) is None
