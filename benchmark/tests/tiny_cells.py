"""The benchmark's cells cut to sizes a CPU test holds, and a helper that
drives one run of them on the CPU (the harness's look for a card
skipped)."""

from __future__ import annotations

import json
import time

import torch

from benchmark import harness

SEED = 2147483700  # past 2**31, as the driver's seeds are


def tiny_cell(name: str) -> harness.Cell:
    if name == "serve-c8-msmarco":  # its files, with no entry in the manifest
        cell = harness.load_cell("serve-batch256-msmarco")
        bench = harness.BENCH_DIR
        cell.name = name
        cell.traffic = json.loads((bench / "traffic" / "concurrent8.json").read_text())
        cell.limits = json.loads((bench / "limits" / f"{name}.json").read_text())
    else:
        cell = harness.load_cell(name)
    if "corpus" in cell.config:
        cell.config["corpus"].update(n_docs=6000, fit_docs=1000)
        cell.config["encode_batch_size"] = 512
        cell.traffic.update(query_pool=2048, check_queries=64, check_keep=0.5, trace_lead_s=0.1,
                            trace_s=0.3)
        if "batch" in cell.traffic:
            cell.traffic["batch"] = 16
        if "clients" in cell.traffic:
            cell.traffic["clients"] = 3
    else:
        cell.config["model"]["batch_size"] = 128
        cell.traffic.update(pairs=256)
    return cell


def tiny_run(name: str, seed: int = SEED, seconds: float = 0.4, trace: bool = False,
             cell: harness.Cell = None) -> harness.Run:
    return harness.execute(cell or tiny_cell(name), seed, seconds, trace,
                           torch.device("cpu"), time.perf_counter())
