"""Each cell's control, and each fault the cell can have, comes out not
correct: the comparison that decides ``correct`` has been seen to fail.

The controls are the reference computed one precision down (TF32 for the
f32 serving cells, fp8 for the bf16 training cell), judged as a run judges
the program; ``calibrate.py`` reads the same on the card at the cells' own
size. The faults are planted under a tiny run on the CPU: an answer
altered where it is produced, half of a batch left out with the mean over
the rest, and a step that leaves the state unchanged."""

from __future__ import annotations

import time

import pytest
import torch

from benchmark import calibrate, harness
from benchmark.tests.tiny_cells import SEED, tiny_cell, tiny_run


def _limits_failed(name: str, numbers) -> list:
    limits = tiny_cell(name).limits
    return [k for k, v in numbers.items() if k in limits and v > limits[k]]


def _bare_run(name):
    return harness.Run(tiny_cell(name), SEED, 0, False, torch.device("cpu"), time.perf_counter())


@pytest.mark.parametrize("name", ["serve-batch256-msmarco", "serve-c8-msmarco"])
def test_serving_control_in_tf32_fails(name):
    assert _limits_failed(name, calibrate.serve_control(_bare_run(name), "tf32"))


@pytest.mark.parametrize("name", ["serve-batch256-msmarco", "serve-c8-msmarco"])
def test_serving_reference_in_its_own_precision_passes(name):
    assert not _limits_failed(name, calibrate.serve_control(_bare_run(name), "f32"))


def test_training_control_in_fp8_fails():
    name = "train-transformer-b4096"
    assert _limits_failed(name, calibrate.train_control(_bare_run(name), "fp8"))


def test_training_half_batch_fault_fails():
    name = "train-transformer-b4096"
    assert _limits_failed(name, calibrate.train_readings(_bare_run(name), "half_batch"))


def test_training_unchanged_state_fault_fails(monkeypatch):
    monkeypatch.setattr(torch.optim.AdamW, "step", lambda self, closure=None: None)
    run = tiny_run("train-transformer-b4096")
    assert not run.correct
    assert run.checks["change_gap"][0] == pytest.approx(1.0)


@pytest.mark.parametrize("name,module", [("serve-batch256-msmarco", "index.two_tower"),
                                         ("serve-c8-msmarco", "serve.store")])
def test_serving_altered_answer_fails(monkeypatch, name, module):
    import importlib

    mod = importlib.import_module(f"twotowers_tpu_torch.{module}")
    score = mod.score_topk

    def altered(docs, queries, k, n_docs):
        values, indices = score(docs, queries, k, n_docs)
        indices = indices.clone()
        indices[:, 0] = (indices[:, 0] + 1) % n_docs
        return values, indices

    monkeypatch.setattr(mod, "score_topk", altered)
    run = tiny_run(name)
    assert not run.correct
    assert run.checks["score_gap"][0] > run.checks["score_gap"][1]


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["serve-batch256-msmarco", "serve-c8-msmarco",
                                  "train-transformer-b4096"])
def test_tiny_cells_on_the_card(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    run = harness.execute(tiny_cell(name), SEED, 0.5, True, torch.device("cuda", 0),
                          time.perf_counter())
    assert run.correct, run.checks
    assert run.tracer.summary is None or run.tracer.summary.busy_s > 0
