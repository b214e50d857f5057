"""The harness finds every cell's files by name, a cell added as files is
found without an edit, the inputs repeat by seed, and a run loads neither
JAX nor the JAX package."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from benchmark import harness, textgen, weights
from benchmark.tests.tiny_cells import SEED

ROOT = harness.ROOT
MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in MANIFEST["workloads"]]


@pytest.mark.parametrize("name", CELLS)
def test_every_entry_resolves_to_its_files(name):
    cell = harness.load_cell(name)
    assert (harness.BENCH_DIR / "drivers" / f"{cell.traffic['driver']}.py").is_file()
    assert cell.limits, "a cell without limits could never be correct"
    for path in cell.readers.values():
        assert path.is_file()
        assert callable(harness.load_reader(path))
    assert "setup_s" in {m["name"] for m in cell.end_to_end}
    assert len(cell.end_to_end) >= 2 and cell.per_layer


def test_every_file_named_by_the_manifest_exists_under_paths():
    for c in MANIFEST["configs"]:
        assert (ROOT / c["file"]).is_file()
        assert c["file"].startswith(MANIFEST["paths"][0] + "/")
        assert json.loads((ROOT / c["file"]).read_text())["name"] == c["name"]
    for m in MANIFEST["per_layer"]:
        for w in m.get("workloads", []):
            assert w in CELLS
            moved = {e["name"] for e in MANIFEST["end_to_end"]
                     if "workloads" not in e or w in e["workloads"]}
            assert m["moves"] in moved


def test_a_cell_added_as_files_is_found_without_an_edit(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = tmp_path / "benchmark"
    config = json.loads((bench / "configs" / "char-mean128-msmarco.json").read_text())
    config.update(name="char-mean128-1m")
    config["corpus"]["n_docs"] = 1_000_000
    (bench / "configs" / "char-mean128-1m.json").write_text(json.dumps(config))
    traffic = json.loads((bench / "traffic" / "concurrent8.json").read_text())
    (bench / "traffic" / "concurrent1.json").write_text(json.dumps({**traffic, "clients": 1}))
    (bench / "limits" / "serve-c1-1m.json").write_text(
        (bench / "limits" / "serve-c8-msmarco.json").read_text())
    (bench / "metrics" / "store_rebuilds.py").write_text("def read(run):\n    return None\n")
    manifest = json.loads((tmp_path / "BENCHMARK.json").read_text())
    manifest["configs"].append({"name": "char-mean128-1m", "source": "x", "reduced": [],
                                "file": "benchmark/configs/char-mean128-1m.json", "why": "x"})
    manifest["workloads"].append({"name": "serve-c1-1m", "config": "char-mean128-1m",
                                  "traffic": "concurrent1", "chips": 1, "why": "x"})
    for m in manifest["end_to_end"]:
        if m["name"] == "search_qps":
            m["workloads"].append("serve-c1-1m")
    manifest["per_layer"].append({"name": "store_rebuilds", "unit": "count", "better": "lower",
                                  "source": "program_counter", "layer": "serve routes and store",
                                  "moves": "search_qps", "workloads": ["serve-c1-1m"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(manifest))
    cell = harness.load_cell("serve-c1-1m", root=tmp_path)
    assert cell.config["corpus"]["n_docs"] == 1_000_000
    assert cell.traffic["clients"] == 1
    assert (bench / "drivers" / f"{cell.traffic['driver']}.py").is_file()
    assert cell.readers["store_rebuilds"] == bench / "metrics" / "store_rebuilds.py"
    assert harness.load_reader(cell.readers["store_rebuilds"])(None) is None
    assert {m["name"] for m in cell.end_to_end} == {"search_qps", "setup_s"}


def test_texts_repeat_by_seed_and_differ_across_seeds_and_streams():
    a = textgen.random_texts(500, 12, 64, SEED, textgen.QUERIES)
    b = textgen.random_texts(500, 12, 64, SEED, textgen.QUERIES)
    c = textgen.random_texts(500, 12, 64, SEED + 1, textgen.QUERIES)
    d = textgen.random_texts(500, 12, 64, SEED, textgen.DOCS)
    assert a.strings() == b.strings()
    assert a.strings() != c.strings() and a.strings() != d.strings()
    strings = a.strings()
    assert len(strings) == 500 and all(12 <= len(t) <= 64 for t in strings)
    assert all(strings[i] == a.data[a.starts[i]:a.starts[i] + a.lengths[i]].tobytes().decode()
               for i in range(500))
    assert a.head(7).strings() == strings[:7]


def test_zipf_rows_repeat_by_seed():
    rows = [textgen.zipf_rows(textgen.rng_for(s, textgen.PAIRS), 200, 4, 24, 48, 2048, 1.07)
            for s in (SEED, SEED, SEED + 1)]
    assert np.array_equal(rows[0], rows[1]) and not np.array_equal(rows[0], rows[2])
    lengths = (rows[0] > 0).sum(axis=1)
    assert lengths.min() >= 4 and lengths.max() <= 24 and rows[0].max() < 2048
    assert rows[0][:, 24:].sum() == 0


def test_weights_repeat_by_seed_with_a_zero_pad_row():
    import torch

    leaves = weights.transformer_leaves(64, 16, 16, 2, 8, True)
    a, b = (weights.make(leaves, SEED, torch.device("cpu")) for _ in range(2))
    assert torch.equal(a["query_tower"]["layers"][1]["ffn2_w"], b["query_tower"]["layers"][1]["ffn2_w"])
    assert float(a["embedding"]["table"][0].abs().sum()) == 0.0
    bound = 1.0 / np.sqrt(16)
    assert float(a["query_tower"]["layers"][0]["q_w"].abs().max()) <= bound
    assert float(a["query_tower"]["final_ln_scale"].min()) == 1.0


def _clean_env():
    env = {k: v for k, v in os.environ.items() if not k.startswith("JAX")}
    env["PYTHONPATH"] = str(ROOT)
    return env


def test_a_run_loads_neither_jax_nor_the_jax_package():
    code = (
        "import sys\n"
        "from benchmark.tests.tiny_cells import tiny_run\n"
        "for name in ('serve-batch256-msmarco', 'serve-c8-msmarco', 'train-transformer-b4096'):\n"
        "    assert tiny_run(name, seconds=0.2).correct\n"
        "from benchmark import harness\n"
        "print('LOADED', harness.loaded_jax_modules())\n"
        "print('TOP', sorted({m.split('.')[0] for m in sys.modules} & set(harness.JAX_NAMES)))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=_clean_env(),
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "LOADED []" in out.stdout and "TOP []" in out.stdout


def test_run_fails_without_a_result_where_only_the_benchmark_is(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                          "serve-batch256-msmarco", "--seed", str(SEED), "--seconds", "1",
                          "--trace", "0"], cwd=tmp_path, env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode != 0
    assert '"correct"' not in out.stdout
