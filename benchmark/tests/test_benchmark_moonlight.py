"""The Moonlight cell (``train-moonlight-b512``): its operation counts
against hand counts, its two new readers on a fake run and on a traced run,
and the driver's cell cut to CPU size through the harness, with its control
and its fault."""

from __future__ import annotations

import copy
import time
import types

import pytest
import torch

from benchmark import counts_moonlight, harness
from benchmark.drivers import train_moonlight
from benchmark.reference import transformer_train
from benchmark.tests.tiny_cells import SEED

NAME = "train-moonlight-b512"
SMALL = {"hidden_dim": 64, "num_layers": 3, "first_k_dense": 1, "num_heads": 4,
         "qk_nope_head_dim": 16, "qk_rope_head_dim": 8, "v_head_dim": 16, "kv_lora_rank": 32,
         "intermediate_size": 96, "moe_intermediate_size": 24, "n_routed_experts": 16,
         "experts_held": [0, 4], "n_shared_experts": 2, "num_experts_per_tok": 3}


def tiny_cell() -> harness.Cell:
    """The cell at tiny widths, in f32: at these widths bf16's rounding
    moves the loss by up to ~1e-2 (the limits are set at the cell's own
    widths, where it reads ~1e-4), so the plumbing is checked in f32 and
    the control and the fault stand out against it."""
    cell = harness.load_cell(NAME)
    model = cell.config["model"]
    model["precision"] = "f32"
    model["encoder"].update(SMALL)
    model["embedding"]["embedding_dim"] = 64
    model["batch_size"] = 8
    model["optimizer"]["lr"] = 1e-3
    cell.config["vocab_size"] = 700
    cell.traffic.update(pairs=32, query_tokens=[3, 8], query_len=8, positive_tokens=[6, 14],
                        passage_len=14, reference_chunk=4)
    return cell


def test_counts_match_hand_counts_at_small_shapes():
    enc = dict(SMALL)
    # one latent attention: q 64x96, kv_a 64x40, kv_b 32x128, o 64x64
    assert counts_moonlight.mla_params(enc) == 64 * 96 + 64 * 40 + 32 * 128 + 64 * 64
    # a token against 10 keys: 2 x 10 x 4 heads x (24 + 16)
    assert counts_moonlight.attention_flops(enc, 10) == 2 * 10 * 4 * 40
    dense = 3 * 64 * 96
    moe = 64 * 16 + 3 * 64 * 24 * 2 + 3 * 64 * 24 * 4 * 3 / 16
    per_token = 3 * (2 * 16_896 + 2 * 10 * 4 * 40) + 2 * (dense + 2 * moe)
    assert counts_moonlight.token_flops(enc, 10) == pytest.approx(per_token)
    fwd = 5 * (7 * counts_moonlight.token_flops(enc, 7) + 10 * per_token)
    assert counts_moonlight.step_flops(enc, 5, 7, 10) == pytest.approx(
        3 * fwd + 3 * 2 * 25 * 64)
    assert counts_moonlight.experts_bound_s(1000, 2048, 1408) == pytest.approx(
        18 * 1000 * 2048 * 1408 / 989e12)


def test_the_cell_at_published_widths_counts_1_64e14_flops_a_step():
    cell = harness.load_cell(NAME)
    enc = cell.config["model"]["encoder"]
    flops = counts_moonlight.step_flops(enc, 512, 32, 192)
    assert flops == pytest.approx(1.64e14, rel=5e-3)
    leaves = train_moonlight.leaves(int(cell.config["vocab_size"]), enc)
    n = sum(torch.Size(shape).numel() for _, shape, rule, _ in leaves)
    assert n == pytest.approx(526.5e6, rel=1e-3)


def _reader(name):
    return harness.load_reader(harness.BENCH_DIR / "metrics" / f"{name}.py")


def test_the_readers_on_a_fake_run(monkeypatch):
    from twotowers_tpu_torch.utils import tracing

    cell = harness.load_cell(NAME)
    run = types.SimpleNamespace(cell=cell)
    fake = [tracing.DeviceSpan("moe.experts", 0, 1, {"phase": "forward"}, 3.0),
            tracing.DeviceSpan("moe.experts", 5, 6, {"phase": "backward"}, 5.0),
            tracing.DeviceSpan("moe.route", 10, 11, {}, 1.0),
            tracing.DeviceSpan("moe.dispatch", 12, 13, {}, 0.5),
            tracing.DeviceSpan("moe.combine", 110, 111, {}, 2.0),
            tracing.DeviceSpan("mla", 112, 113, {}, 7.0)]
    steps = [tracing.Span("train.step", 0, 50, 1, None, 1, 0, {}),
             tracing.Span("train.step", 100, 150, 2, None, 2, 0, {}),
             tracing.Span("train.step", 200, 250, 3, None, 3, 0, {})]
    monkeypatch.setattr(tracing, "device_spans", lambda: fake)
    monkeypatch.setattr(tracing, "device_ms", lambda: {"moe.experts": 8.0, "mla": 7.0})
    monkeypatch.setattr(tracing, "spans", lambda: steps)
    monkeypatch.setattr(tracing, "counters", lambda: {"moe.assignments": 1e6})
    roofline = _reader("experts_roofline.moe")(run)
    assert roofline == pytest.approx(100 * 18e6 * 2048 * 1408 / 989e12 / 8e-3)
    # steps of 1.5 and 2.0 ms; the third has no span
    assert _reader("route_ms.moe")(run) == pytest.approx(1.75)


def test_the_readers_give_nothing_without_the_programs_spans(monkeypatch):
    from twotowers_tpu_torch.utils import tracing

    run = types.SimpleNamespace(cell=harness.load_cell(NAME))
    tracing.clear()
    assert _reader("experts_roofline.moe")(run) is None
    assert _reader("route_ms.moe")(run) is None
    monkeypatch.delattr(tracing, "device_ms")
    monkeypatch.delattr(tracing, "device_spans")
    assert _reader("experts_roofline.moe")(run) is None
    assert _reader("route_ms.moe")(run) is None


def _run(cell=None, trace=False, seconds=0.3):
    return harness.execute(cell or tiny_cell(), SEED, seconds, trace, torch.device("cpu"),
                           time.perf_counter())


def test_the_tiny_cell_through_the_harness_is_correct_and_reads_its_metrics():
    from twotowers_tpu_torch.utils import tracing

    tracing.clear()
    cell = tiny_cell()
    cell.traffic["pairs"] = 16  # 2 steps an epoch: the traced second epoch starts in time
    run = _run(cell, trace=True, seconds=3.0)
    assert run.correct, run.checks
    out = harness.result(run, {"platform": "cpu"})
    metrics = out["metrics"]
    for name in ("experts_roofline.moe", "route_ms.moe", "train_mfu", "device_idle.train",
                 "batch_ms.train", "dispatch_ms.train", "drain_ms.train"):
        assert name in metrics and metrics[name]["value"] >= 0, name
    assert run.work["traced_steps"] == 2 and "setup_s" in run.e2e
    untraced = harness.result(_run(), {"platform": "cpu"})
    assert set(untraced["metrics"]) == {"train_pairs_per_s", "setup_s"}
    assert untraced["correct"]
    tracing.clear()


def test_the_fp8_control_and_the_top5_fault_fail():
    cell = tiny_cell()
    run = harness.Run(cell, SEED, 0, False, torch.device("cpu"), time.perf_counter())
    spec, tree, model, state, step, batch, first, _ = train_moonlight.build(run)
    _, readings, batches = train_moonlight.first_steps(run, state, step, model, first, batch)
    want = train_moonlight.reference(run, tree, batches, cell.config)
    gaps = transformer_train.compare(readings, want)
    assert all(gaps[k] <= cell.limits[k] for k in gaps), gaps
    low = train_moonlight.reference(run, tree, batches, cell.config, "fp8")
    control = {"losses": low["losses"],
               "first_grad_norms": transformer_train.leaf_norms(low["first_grad"]),
               "change_norms": transformer_train.leaf_norms(low["change"])}
    fp8 = transformer_train.compare(control, want)
    assert any(fp8[k] > cell.limits[k] for k in fp8), fp8
    fault = copy.deepcopy(cell)
    fault.config["model"]["encoder"]["num_experts_per_tok"] = 2
    run = harness.Run(fault, SEED, 0, False, torch.device("cpu"), time.perf_counter())
    spec, tree, model, state, step, batch, first, _ = train_moonlight.build(run)
    _, readings, batches = train_moonlight.first_steps(run, state, step, model, first, batch)
    top = transformer_train.compare(readings, train_moonlight.reference(
        run, tree, batches, cell.config))
    assert any(top[k] > cell.limits[k] for k in top), top


def test_the_half_batch_fault_fails():
    from benchmark import calibrate_moonlight

    cell = tiny_cell()
    run = harness.Run(cell, SEED, 0, False, torch.device("cpu"), time.perf_counter())
    tree, readings, batches = calibrate_moonlight.program_readings(run)
    want = train_moonlight.reference(run, tree, batches, cell.config)
    assert all(v <= cell.limits[k] for k, v in transformer_train.compare(readings, want).items())
    _, readings, _ = calibrate_moonlight.program_readings(run, "half_batch")
    half = transformer_train.compare(readings, want)
    assert any(half[k] > cell.limits[k] for k in half), half
