"""The port's reports (``twotowers_tpu_torch.reports``) against the JAX
package's, on the same run directories.

The run directories are written by the port's runner
(``python -m twotowers_tpu_torch.scripts.train --device cpu``: three runs
that differ in lr and batch size, one with a dataset genealogy beside its
data) and by the fixtures of ``tests/test_serve_reports.py``. The single
and comparison reports, the genealogy flowchart and the cross-run blocks
equal JAX's text once the ``_generated <timestamp>_`` line is masked; the
hosted W&B path gives JAX's panel structure against the stubbed
``wandb_workspaces`` of that file.
"""

import json
import re
import shutil
from pathlib import Path

import pytest
import yaml

import twotowers_tpu.reports as jax_reports
import twotowers_tpu.reports.blocks as jax_blocks
import twotowers_tpu.reports.cli as jax_cli
import twotowers_tpu.reports.report_utils as jax_utils
import twotowers_tpu.reports.single_report as jax_single
import twotowers_tpu_torch.reports as reports
import twotowers_tpu_torch.reports.blocks as blocks
import twotowers_tpu_torch.reports.cli as cli
import twotowers_tpu_torch.reports.report_utils as utils
import twotowers_tpu_torch.reports.single_report as single
from test_serve_reports import _make_run, run_dir  # noqa: F401 (a fixture)
from test_serve_reports import stub_wandb_workspaces  # noqa: F401 (a fixture)
from test_serve_reports import _StubPanelGrid, _StubReport
from twotowers_tpu_torch.scripts import train as runner

ROOT = Path(__file__).resolve().parents[1]
STAMP = re.compile(r"^_generated [^_]+_$", re.M)


def _masked(path):
    return STAMP.sub("_generated <timestamp>_", Path(path).read_text())


@pytest.fixture(scope="module")
def runner_runs(tmp_path_factory):
    """Three run directories of the port's runner on the CPU; the data of
    the first has a genealogy JSON beside it, as the factory writes."""
    tmp_path = tmp_path_factory.mktemp("runs")
    data = tmp_path / "data" / "train.tsv"
    data.parent.mkdir()
    with open(data, "w") as f:
        f.write("query\tpositive_doc\tnegative_doc\n")
        for i in range(40):
            f.write(f"query {i} about tpus\tdoc {i} on tpus and such\tunrelated text {i * 7}\n")
    configs = []
    for name, lr, batch in (("lr_low", 1e-3, 8), ("lr_mid", 3e-3, 16), ("lr_high", 1e-2, 16)):
        # no log_dir, so the runner puts the metrics into the run directory
        config = {"data": str(data), "tokeniser": {"type": "char", "max_len": 24},
                  "embedding": {"type": "lookup", "embedding_dim": 16},
                  "encoder": {"arch": "mean", "hidden_dim": 16, "tied_weights": True},
                  "loss": {"type": "triplet", "margin": 0.2},
                  "checkpoint_dir": str(tmp_path / f"ckpt_{name}"), "batch_size": batch,
                  "optimizer": {"type": "adamw", "lr": lr}, "epochs": 2}
        path = tmp_path / f"{name}.yml"
        path.write_text(yaml.safe_dump(config))
        configs.append(str(path))
    logs = tmp_path / "logs"
    assert runner.main(["--configs", *configs, "--log_dir", str(logs), "--device", "cpu"]) == 0
    runs = sorted(p for p in logs.iterdir() if p.is_dir())
    assert len(runs) == 3
    (logs / "train.genealogy.json").write_text(json.dumps({
        "artifact": str(data), "pipeline": [{"step": "load_split", "rows": 40},
                                            {"step": "build_triplets", "rows": 40}]}))
    return runs


def _single_pair(run, tmp_path):
    got = reports.create_run_report(str(run), str(tmp_path / "port.md"))
    want = jax_reports.create_run_report(str(run), str(tmp_path / "jax.md"))
    return _masked(got), _masked(want)


def test_single_reports_of_runner_runs_match_jax(runner_runs, tmp_path):
    for run in runner_runs:
        got, want = _single_pair(run, tmp_path)
        assert got == want
        for section in ("Training dynamics", "train/batch_loss", "Similarity monitors",
                        "Performance", "Configuration", "Dataset genealogy", "Run summary"):
            assert section in got, section


def test_single_reports_of_fixture_runs_match_jax(run_dir, tmp_path):  # noqa: F811
    got, want = _single_pair(run_dir, tmp_path)
    assert got == want and "mrr | 0.5000" in got and "IR evaluation" in got
    empty = tmp_path / "empty_run"
    empty.mkdir()
    got, want = _single_pair(empty, tmp_path)
    assert got == want and "No metrics" in got
    # the default output path is report.md inside the run
    assert reports.create_run_report(str(run_dir)) == str(run_dir / "report.md")


def test_comparison_reports_match_jax(runner_runs, run_dir, tmp_path):  # noqa: F811
    cases = [list(map(str, runner_runs))]
    run_b = run_dir.parent / "run_b"
    shutil.copytree(run_dir, run_b)
    (run_b / "resolved_config.yml").write_text("batch_size: 16\nencoder:\n  hidden_dim: 32\n")
    cases.append([str(run_dir), str(run_b)])
    fixture_runs = tmp_path / "made"
    fixture_runs.mkdir()
    cases.append([str(_make_run(fixture_runs, f"r{i}", lr, 8, loss))
                  for i, (lr, loss) in enumerate(zip([1e-3, 3e-3, 6e-3, 1e-2],
                                                     [0.9, 0.6, 0.3, 0.1]))])
    for i, runs in enumerate(cases):
        got = reports.create_comparison_report(runs, str(tmp_path / f"port{i}.md"))
        want = jax_reports.create_comparison_report(runs, str(tmp_path / f"jax{i}.md"))
        assert _masked(got) == _masked(want)
        assert "Parallel coordinates" in _masked(got) and "Parameter importance" in _masked(got)
    assert "optimizer.lr" in _masked(tmp_path / "port0.md")
    # the default output path is beside the first run
    assert reports.create_comparison_report(cases[1]) == str(run_dir.parent
                                                               / "comparison_report.md")


def test_genealogy_and_experiment_files_match_jax(runner_runs):
    record = {"artifact": "data/x.parquet",
              "pipeline": [{"step": "load_split", "rows": 100},
                           {"step": "build_triplets", "rows": 300}, {"step": "no_rows"}]}
    assert utils.genealogy_flowchart(record) == jax_utils.genealogy_flowchart(record)
    assert utils.genealogy_flowchart({}) == jax_utils.genealogy_flowchart({})
    for run in runner_runs:
        assert utils.find_experiment_files(str(run)) == jax_utils.find_experiment_files(str(run))
        files = utils.find_experiment_files(str(run))
        assert None not in (files["metrics"], files["summary"], files["config"], files["log"])
        assert utils.load_metrics(files["metrics"]) == jax_utils.load_metrics(files["metrics"])
        assert utils.resolve_run_id(str(run)) is None
    for values in ([1.0, 2.0, 3.0], []):
        assert utils.summarise_series(values) == jax_utils.summarise_series(values)


def test_cross_run_blocks_match_jax(tmp_path):
    runs = []
    for i, (lr, batch, loss) in enumerate([(1e-3, 8, 0.9), (3e-3, 8, 0.6), (1e-2, 16, 0.2)]):
        run = _make_run(tmp_path, f"r{i}", lr, batch, loss)
        records = utils.load_metrics(next(run.glob("*_metrics.jsonl")))
        config = yaml.safe_load((run / "resolved_config.yml").read_text())
        flat = {"batch_size": config["batch_size"], "optimizer.lr": config["optimizer"]["lr"],
                "encoder.hidden_dim": 32}
        runs.append({"name": run.name, "config": flat, "records": records})
    for n in (1, 2, 3):
        assert blocks.parallel_coordinates_block(runs[:n]) == \
            jax_blocks.parallel_coordinates_block(runs[:n])
        assert blocks.parameter_importance_block(runs[:n]) == \
            jax_blocks.parameter_importance_block(runs[:n])
    assert "optimizer.lr" in blocks.parameter_importance_block(runs)
    records = runs[0]["records"]
    for name in ("training_dynamics_block", "similarity_block", "performance_block",
                 "gradient_block"):
        assert getattr(blocks, name)(records) == getattr(jax_blocks, name)(records)
    ir = {"mrr": 0.5, "recall@10": 0.75}
    assert blocks.ir_metrics_block(ir) == jax_blocks.ir_metrics_block(ir)
    assert blocks.config_block(runs[0]["config"]) == jax_blocks.config_block(runs[0]["config"])


def _panels(grids):
    return [[(p.x, p.y) for p in grid.panels] for grid in grids]


def test_wandb_panels_and_report_match_jax(run_dir, stub_wandb_workspaces):  # noqa: F811
    records = utils.load_metrics(run_dir / "runa_metrics.jsonl")
    assert _panels(blocks.as_wandb_panels(records)) == _panels(jax_blocks.as_wandb_panels(records))
    by_epoch = [{"epoch": e, "train/epoch_loss": 1.0 / (e + 1)} for e in range(3)]
    assert _panels(blocks.as_wandb_panels(by_epoch)) == [[("epoch", ["train/epoch_loss"])]]
    for bad, match in (([], "needs the run's metric records"),
                       ([{"something/else": 1.0}], "none of the known metric")):
        for module in (blocks, jax_blocks):
            with pytest.raises(ValueError, match=match):
                module.as_wandb_panels(bad)

    (run_dir / "wandb" / "run-20260821_000000-abc123").mkdir(parents=True)
    urls = [module.create_wandb_report(str(run_dir), project="twotowers", entity="someone")
            for module in (single, jax_single)]
    port, jax = _StubReport.saved
    assert urls[0] == urls[1] == "https://wandb.stub/twotowers/Two-tower report: run_a"
    assert (port.project, port.entity, port.title) == (jax.project, jax.entity, jax.title)
    assert [type(b) for b in port.blocks] == [type(b) for b in jax.blocks]
    assert _panels([b for b in port.blocks if isinstance(b, _StubPanelGrid)]) == \
        _panels([b for b in jax.blocks if isinstance(b, _StubPanelGrid)])
    assert "abc123" in port.blocks[-1].text == jax.blocks[-1].text


def test_wandb_report_needs_metrics_and_the_package(tmp_path, monkeypatch):
    import sys

    empty = tmp_path / "empty_run"
    empty.mkdir()
    monkeypatch.setitem(sys.modules, "wandb_workspaces", None)
    monkeypatch.setitem(sys.modules, "wandb_workspaces.reports", None)
    monkeypatch.setitem(sys.modules, "wandb_workspaces.reports.v2", None)
    with pytest.raises(RuntimeError, match="wandb_workspaces not installed"):
        single.create_wandb_report(str(empty), project="p")
    with pytest.raises(RuntimeError, match="wandb_workspaces not installed"):
        blocks.as_wandb_panels([{"train/epoch_loss": 1.0}])


def test_cli_single_and_compare_match_jax(runner_runs, tmp_path, capsys):
    run = str(runner_runs[0])
    outputs = []
    for module, name in ((cli, "port"), (jax_cli, "jax")):
        assert module.main(["single", "--run", run, "--output", str(tmp_path / f"{name}.md")]) == 0
        assert module.main(["compare", "--runs", *map(str, runner_runs), "--output",
                            str(tmp_path / f"{name}_cmp.md")]) == 0
        outputs.append(capsys.readouterr().out.replace(name, "NAME"))
    assert outputs[0] == outputs[1]
    for suffix in (".md", "_cmp.md"):
        assert _masked(tmp_path / f"port{suffix}") == _masked(tmp_path / f"jax{suffix}")
