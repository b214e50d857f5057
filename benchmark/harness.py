"""The harness: finds a cell's files by name, runs its driver once, reads
its per-layer metrics and prints the result line.

Everything particular to one configuration, traffic mix, per-layer metric
or cell lives in a file of its own, found by the name that
``BENCHMARK.json`` gives it:

* ``configs/<config>.json``: the configuration as it is run;
* ``traffic/<traffic>.json``: the mix's parameters; its ``driver`` names the
  module ``drivers/<driver>.py`` that drives that kind of traffic;
* ``metrics/<metric>.py``: a reader, ``read(run) -> float | None``, that
  takes one per-layer metric from the run's trace, counters or host spans;
* ``limits/<cell>.json``: the limit of each number that decides
  ``correct``.

A later cell, configuration or metric is added as files and entries; no
file here changes.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Tuple

from .measure import Tracer, finite

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
JAX_NAMES = ("jax", "jaxlib", "flax", "twotowers_tpu")


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: Dict[str, Any]
    traffic: Dict[str, Any]
    limits: Dict[str, float]
    end_to_end: List[Dict[str, Any]]
    per_layer: List[Dict[str, Any]]
    readers: Dict[str, Path]


def _applies(metric: Dict[str, Any], cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``root/BENCHMARK.json`` with its files read."""
    manifest = json.loads((root / "BENCHMARK.json").read_text())
    bench = root / "benchmark"
    cells = {w["name"]: w for w in manifest["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json: {sorted(cells)}")
    work = cells[name]
    config = {c["name"]: c for c in manifest["configs"]}[work["config"]]
    per_layer = [m for m in manifest["per_layer"] if _applies(m, name)]
    return Cell(
        name=name,
        chips=int(work["chips"]),
        config=json.loads((root / config["file"]).read_text()),
        traffic=json.loads((bench / "traffic" / f"{work['traffic']}.json").read_text()),
        limits=json.loads((bench / "limits" / f"{name}.json").read_text()),
        end_to_end=[m for m in manifest["end_to_end"] if _applies(m, name)],
        per_layer=per_layer,
        readers={m["name"]: bench / "metrics" / f"{m['name']}.py" for m in per_layer},
    )


def load_reader(path: Path) -> Callable:
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{path.stem}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


@dataclasses.dataclass
class Run:
    """One run of one cell: what the driver measured and counted."""

    cell: Cell
    seed: int
    seconds: float
    trace: bool
    device: Any  # torch.device
    t0: float  # the host clock at process start
    tracer: Tracer = None
    setup_s: Optional[float] = None
    window_s: Optional[float] = None
    attempted: int = 0
    failed: int = 0
    e2e: Dict[str, float] = dataclasses.field(default_factory=dict)
    work: Dict[str, Any] = dataclasses.field(default_factory=dict)
    spans: Dict[str, List[float]] = dataclasses.field(default_factory=dict)
    calls: Dict[str, List[Tuple]] = dataclasses.field(default_factory=dict)
    checks: Dict[str, Tuple[float, float]] = dataclasses.field(default_factory=dict)
    notes: List[str] = dataclasses.field(default_factory=list)
    phases: List[Tuple[str, float]] = dataclasses.field(default_factory=list)
    memory_peak_bytes: int = 0

    def __post_init__(self):
        if self.tracer is None:
            self.tracer = Tracer(self.trace, float(self.cell.traffic.get("trace_lead_s", 1.0)),
                                 float(self.cell.traffic.get("trace_s", 3.0)))

    def mark(self, phase: str) -> None:
        """End a phase of set-up: its seconds since the last mark (or the
        process start) go into ``phases``."""
        now = time.perf_counter()
        self.phases.append((phase, now - sum(s for _, s in self.phases) - self.t0))

    def note(self, line: str) -> None:
        self.notes.append(line)
        print(line, file=sys.stderr, flush=True)

    def check(self, name: str, value: float) -> None:
        """Record a compared number beside its limit from the cell's file."""
        self.checks[name] = (float(value), float(self.cell.limits[name]))

    @property
    def correct(self) -> bool:
        return bool(self.checks) and all(v <= lim for v, lim in self.checks.values())


def execute(cell: Cell, seed: int, seconds: float, trace: bool, device, t0: float) -> Run:
    """Run the cell's driver once (set-up, window, check)."""
    import torch

    run = Run(cell, seed, seconds, trace, device, t0)
    driver = importlib.import_module(f"benchmark.drivers.{cell.traffic['driver']}")
    torch.zeros(1, device=device)  # the device's context
    run.mark("imports, device context")
    driver.run(run)
    run.note("set-up by phase (s): " + ", ".join(f"{p} {s:.3f}" for p, s in run.phases))
    return run


def loaded_jax_modules() -> List[str]:
    return sorted(name for name in sys.modules if name.split(".", 1)[0] in JAX_NAMES)


def power_limit() -> Optional[str]:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout else None


def result(run: Run, device_info: Dict[str, Any]) -> Dict[str, Any]:
    """The result line's object: the cell's end-to-end metrics (``--trace
    0``) or its per-layer ones (``--trace 1``), the checks last."""
    metrics: Dict[str, Dict[str, Any]] = {}
    if run.trace:
        for m in run.cell.per_layer:
            value = finite(load_reader(run.cell.readers[m["name"]])(run))
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in run.cell.end_to_end:
            value = finite(run.e2e.get(m["name"]))
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    out: Dict[str, Any] = {
        "correct": run.correct, "attempted": run.attempted, "failed": run.failed,
        "metrics": metrics, "device": dict(device_info),
    }
    summary = run.tracer.summary
    if run.trace and summary is not None:
        out["device"]["busy_s"] = summary.busy_s
        out["device"]["window_s"] = summary.window_s
        out["breakdown"] = summary.breakdown()
    out["checks"] = {name: {"value": v, "limit": lim} for name, (v, lim) in run.checks.items()}
    return out
