"""The port's entry points on the CPU: the experiment runner
(``twotowers_tpu_torch.scripts.train``), ``generate_and_train`` and the
``profile:`` trace of ``train_model``.

The runner is held to the root ``train.py``'s contract (a run directory
with ``train.log``, ``resolved_config.yml`` and ``summary.json``, a group
JSON, exit code 1 when a run fails); its ``--parallel`` workers are
spawned. ``generate_and_train`` trains on the factory's synthetic parquet,
which equals the JAX package's for the seed.
"""

import json
from pathlib import Path

import pandas as pd
import pytest
import torch
import yaml

from twotowers_tpu.data.factory.synthetic import generate_synthetic_pairs as jax_pairs
from twotowers_tpu.data.triplets import pairs_to_triplets as jax_pairs_to_triplets
from twotowers_tpu_torch.scripts import generate_and_train
from twotowers_tpu_torch.scripts import train as runner
from twotowers_tpu_torch.train import train_model
from twotowers_tpu_torch.utils import load_config

ROOT = Path(__file__).resolve().parents[1]


def _tsv(path, n=40):
    with open(path, "w") as f:
        f.write("query\tpositive_doc\tnegative_doc\n")
        for i in range(n):
            f.write(f"query {i} about tpus\tdoc {i} on tpus and such\tunrelated text {i * 7}\n")
    return str(path)


def _config_file(tmp_path, name, data, **over):
    config = {"extends": str(ROOT / "configs" / "test_small.yml"), "data": data,
              "checkpoint_dir": str(tmp_path / f"ckpt_{name}"), "batch_size": 16, **over}
    path = tmp_path / f"{name}.yml"
    path.write_text(yaml.safe_dump(config))
    return str(path)


def test_runner_writes_run_directories_and_the_group(tmp_path, capsys):
    data = _tsv(tmp_path / "train.tsv")
    good = _config_file(tmp_path, "good", data)
    bad = _config_file(tmp_path, "bad", str(tmp_path / "absent.tsv"))
    logs = tmp_path / "logs"
    code = runner.main(["--configs", good, bad, "--log_dir", str(logs), "--device", "cpu",
                        "--epochs", "2"])
    assert code == 1 and "1/2 experiments succeeded" in capsys.readouterr().out
    runs = {p.name.rsplit("_", 2)[0]: p for p in logs.iterdir() if p.is_dir()}
    assert set(runs) == {"good", "bad"}
    for run in runs.values():
        assert {"train.log", "summary.json"} <= {p.name for p in run.iterdir()}
    summary = json.loads((runs["good"] / "summary.json").read_text())
    assert summary["success"] and summary["num_triplets"] == 40 and summary["device"] == "cpu"
    assert summary["hardware"]["torch_version"] == torch.__version__
    assert {"cuda_available", "device_count", "nvidia_smi"} <= set(summary["hardware"])
    resolved = yaml.safe_load((runs["good"] / "resolved_config.yml").read_text())
    assert resolved["epochs"] == 2 and resolved["data"] == data
    assert (tmp_path / "ckpt_good" / "best_model" / "params.npz").exists()
    failed = json.loads((runs["bad"] / "summary.json").read_text())
    assert not failed["success"] and "absent.tsv" in failed["error"]
    assert "Experiment bad failed" in (runs["bad"] / "train.log").read_text()
    group = json.loads(next(logs.glob("experiment_group_*.json")).read_text())
    assert (group["total"], group["succeeded"]) == (2, 1)


def test_runner_config_dir_in_spawned_workers(tmp_path):
    data = _tsv(tmp_path / "train.tsv")
    sweep = tmp_path / "sweep"
    sweep.mkdir()
    for name in ("a", "b"):
        _config_file(sweep, name, data, epochs=1)
    logs = tmp_path / "logs"
    assert runner.main(["--config_dir", str(sweep), "--parallel", "2", "--log_dir", str(logs),
                        "--device", "cpu", "--log_level", "WARNING"]) == 0
    group = json.loads(next(logs.glob("experiment_group_*.json")).read_text())
    assert [s["experiment"] for s in group["experiments"]] == ["a", "b"]
    assert all(s["success"] for s in group["experiments"])


def test_runner_needs_a_config():
    with pytest.raises(SystemExit):
        runner.main([])


def test_entry_points_run_on_the_card_unless_asked(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(tmp_path)
    config = _config_file(tmp_path, "c", _tsv(tmp_path / "t.tsv"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        runner.main(["--config", config, "--log_dir", str(tmp_path / "logs")])
    assert not (tmp_path / "logs").exists() or not any((tmp_path / "logs").iterdir())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        generate_and_train.main(["--num_pairs", "5"])
    assert not (tmp_path / "data").exists()


def test_generate_and_train(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)  # the factory's data/ tree is relative to the cwd
    code = generate_and_train.main([
        "--num_pairs", "30", "--seed", "3", "--epochs", "1", "--batch_size", "16",
        "--config", str(ROOT / "configs" / "char_tower.yml"), "--device", "cpu",
        "--output", str(tmp_path / "data" / "processed" / "synthetic.parquet")])
    assert code == 0
    pairs = jax_pairs(30, 1, seed=3)
    q, p, n = jax_pairs_to_triplets(pairs["query"].tolist(), pairs["document"].tolist(),
                                    pairs["label"].tolist())
    written = pd.read_parquet(tmp_path / "data" / "processed" / "synthetic.parquet")
    assert written.to_dict("list") == {"q_text": q, "d_pos_text": p, "d_neg_text": n}
    assert (tmp_path / "data" / "raw" / "pairs.tsv").exists()
    steps = -(-len(q) // 16)
    assert f"Trained on {len(q)} synthetic triplets ({steps} steps)" in capsys.readouterr().out


@pytest.mark.parametrize("resume", [False, True])
def test_profile_traces_the_first_epoch_that_runs(tmp_path, resume):
    config = load_config(_config_file(tmp_path, "p", _tsv(tmp_path / "t.tsv"), epochs=2))
    config["log_dir"] = str(tmp_path / "logs")
    if resume:
        train_model(config, device="cpu")
        config.update(epochs=3, resume="latest")
    config["profile"] = {"trace_dir": str(tmp_path / "trace")}
    state, _ = train_model(config, device="cpu")
    traces = list((tmp_path / "trace").glob("*.pt.trace.json"))
    assert len(traces) == 1  # one epoch traced: the first that ran
    events = json.loads(traces[0].read_text())["traceEvents"]
    names = {e.get("name", "") for e in events}
    assert any(name.startswith("aten::") for name in names)
    assert state.step == (3 if resume else 2) * 3

