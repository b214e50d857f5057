"""The port's MS MARCO entry points (``twotowers_tpu_torch.scripts.
{prepare_ms_marco,train_with_msmarco}``) on their local path, against the
repo's root scripts.

Only ``--input_parquet`` is driven, on the committed MS MARCO-shaped
``tests/fixtures/msmarco_raw.parquet``: the ``datasets`` download stays
behind its deferred import. ``prepare_ms_marco`` writes the root script's
triplets parquet and genealogy; ``run_experiment`` and ``main`` train on
the CPU (``--device cpu``) and evaluate, as ``tests/test_orchestration.py``
holds the root script to.
"""

import json
from pathlib import Path

import pandas as pd
import pytest
import torch
import yaml

import prepare_ms_marco as jax_prepare
import train_with_msmarco as jax_msmarco
from test_torch_factory import data_dirs  # noqa: F401 (a fixture)
from twotowers_tpu_torch.scripts import prepare_ms_marco, train_with_msmarco

FIXTURE = Path(__file__).parent / "fixtures" / "msmarco_raw.parquet"
VOLATILE = ("created", "timestamp", "framework", "file", "preset_path")


def _genealogy(path):
    """The sidecar without what names its time, its package or its paths."""
    record = json.loads(Path(str(path) + ".genealogy.json").read_text())
    for step in record["pipeline"]:
        for key in VOLATILE:
            step.pop(key, None)
    return {k: v for k, v in record.items() if k not in VOLATILE}


@pytest.mark.parametrize("preset", ["presets/classic.yml", "presets/multi_positive.yml"])
def test_prepare_writes_the_root_scripts_triplets(tmp_path, data_dirs, preset):  # noqa: F811
    outputs = []
    for module, name in ((prepare_ms_marco, "port"), (jax_prepare, "jax")):
        out = tmp_path / name / "triplets.parquet"
        assert module.main(["--preset", preset, "--output", str(out), "--seed", "7",
                            "--input_parquet", str(FIXTURE)]) == 0
        outputs.append(out)
    got, want = (pd.read_parquet(p) for p in outputs)
    pd.testing.assert_frame_equal(got, want)
    assert set(got.columns) == {"q_text", "d_pos_text", "d_neg_text"} and len(got) > 0
    assert _genealogy(outputs[0]) == _genealogy(outputs[1])
    assert _genealogy(outputs[0])["pipeline"][0]["rows"] == len(pd.read_parquet(FIXTURE))


def _tiny_config(tmp_path, **over):
    config = {
        "tokeniser": {"type": "char", "max_len": 32},
        "embedding": {"type": "lookup", "embedding_dim": 16},
        "encoder": {"arch": "mean", "hidden_dim": 16, "tied_weights": True},
        "loss": {"type": "triplet", "margin": 0.2},
        "batch_size": 16, "epochs": 1, "use_wandb": False,
        "checkpoint_dir": str(tmp_path / "ckpt"), **over,
    }
    path = tmp_path / "msmarco_tiny.yml"
    path.write_text(yaml.safe_dump(config))
    return str(path)


def test_run_experiment_end_to_end_on_the_cpu(tmp_path, data_dirs):  # noqa: F811
    summary = train_with_msmarco.run_experiment(
        split="train", preset_path="presets/classic.yml", samples=120, epochs=1,
        batch_size=16, config_path=_tiny_config(tmp_path), log_dir=str(tmp_path / "logs"),
        input_parquet=str(FIXTURE), device="cpu")
    assert summary["success"] is True, summary.get("error")
    assert (summary["num_triplets"], summary["preset"], summary["device"]) == (120, "classic",
                                                                               "cpu")
    run_dir = next((tmp_path / "logs").iterdir())
    ir = json.loads((run_dir / "ir_metrics.json").read_text())
    assert ir == summary["ir_metrics"] and 0.0 <= ir["mrr"] <= 1.0
    assert any(k.startswith("precision@") for k in ir)
    assert {"train.log", "summary.json", "resolved_config.yml", "ir_metrics.json"} <= {
        p.name for p in run_dir.iterdir()}
    assert list(run_dir.glob("*_metrics.jsonl"))  # the run directory the reports read
    resolved = yaml.safe_load((run_dir / "resolved_config.yml").read_text())
    assert resolved["wandb"]["tags"] == ["msmarco", "train", "classic"]
    (genealogy,) = (data_dirs["torch"] / "processed").glob("*.genealogy.json")
    record = json.loads(genealogy.read_text())
    assert record["pipeline"][0]["rows"] == len(pd.read_parquet(FIXTURE))
    assert record["preset"]["positive_selector"] == "classic"
    assert (tmp_path / "ckpt" / "best_model" / "params.npz").exists()


def test_a_failed_experiment_is_a_summary_not_a_raise(tmp_path, data_dirs):  # noqa: F811
    summary = train_with_msmarco.run_experiment(
        split="train", preset_path="presets/classic.yml", samples=None, epochs=1,
        batch_size=16, config_path=_tiny_config(tmp_path),
        log_dir=str(tmp_path / "logs"), input_parquet=str(tmp_path / "absent.parquet"),
        device="cpu")
    assert summary["success"] is False and "absent.parquet" in summary["error"]


def test_main_runs_the_matrix_and_writes_the_group(tmp_path, data_dirs, capsys):  # noqa: F811
    log_dir = tmp_path / "logs"
    rc = train_with_msmarco.main([
        "--presets", "presets/classic.yml", "presets/multi_positive.yml",
        "--samples", "60", "--epochs", "1", "--config", _tiny_config(tmp_path),
        "--log_dir", str(log_dir), "--input_parquet", str(FIXTURE), "--device", "cpu"])
    assert rc == 0 and "2/2 experiments succeeded" in capsys.readouterr().out
    group = json.loads(next(log_dir.glob("msmarco_group_*.json")).read_text())
    assert [e["preset"] for e in group["experiments"]] == ["classic", "multi_positive"]
    assert all(e["success"] and e["device"] == "cpu" for e in group["experiments"])


def test_fuzzy_preset_lookup_matches_the_root_script():
    for name in ("classic", "clasic.yml", "presets/classic.yml", "multi_positive"):
        got = Path(train_with_msmarco.find_preset_file(name)).resolve()
        assert got == Path(jax_msmarco.find_preset_file(name)).resolve(), name
    for module in (train_with_msmarco, jax_msmarco):
        with pytest.raises(FileNotFoundError):
            module.find_preset_file("zzz_nothing_like_this")


def test_main_runs_on_the_card_unless_asked(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cuda'"):
        train_with_msmarco.main(["--input_parquet", str(FIXTURE), "--log_dir",
                                 str(tmp_path / "logs")])
    assert not (tmp_path / "logs").exists()  # nothing ran
