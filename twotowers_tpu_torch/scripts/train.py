"""Experiment runner: train one or many configs, sequentially or in parallel.

The counterpart of the repo's root ``train.py``: a single config, several
configs or a directory of configs; a run directory per experiment with its
``train.log``, ``resolved_config.yml`` and ``summary.json`` (hardware
info, success, dataset sizes, duration); a group JSON over all
runs; optional process-parallel runs. Training runs on ``--device``, the
card unless the caller asks for the CPU; with no card and no ``--device
cpu`` the runner raises before any run. ``--parallel`` starts its workers
with ``spawn``: a forked child of a process that has touched CUDA cannot
use the card. Under torchrun (``RANK``, ``WORLD_SIZE`` ... in the
environment) each process joins the process group first, for configs with
``mesh:``; rank 0 alone writes the run directory and the group JSON.

Usage:
    python -m twotowers_tpu_torch.scripts.train --config configs/char_tower.yml
    python -m twotowers_tpu_torch.scripts.train --configs a.yml b.yml --parallel 2
    python -m twotowers_tpu_torch.scripts.train --config_dir configs/sweep/ --device cpu
    torchrun --nproc-per-node 4 -m twotowers_tpu_torch.scripts.train --config mesh.yml
"""

from __future__ import annotations

import argparse
import datetime
import json
import multiprocessing
import os
import platform
import subprocess
import time
from pathlib import Path
from typing import Any, Dict, List, Optional

import torch

from ..parallel.mesh import initialize_distributed, is_writer
from ..utils import get_logger, load_config, resolve_device, save_config, setup_logging

logger = get_logger("cli.train")


def get_hardware_info() -> Dict[str, Any]:
    """Host and card info: platform, torch and CUDA versions, the cards
    torch sees and what ``nvidia-smi`` says of their name and power limit."""
    info: Dict[str, Any] = {
        "platform": platform.platform(),
        "python_version": platform.python_version(),
        "processor": platform.processor(),
        "cpu_count": os.cpu_count(),
        "torch_version": torch.__version__,
        "cuda_version": torch.version.cuda,
        "cuda_available": torch.cuda.is_available(),
        "device_count": torch.cuda.device_count(),
        "devices": [torch.cuda.get_device_name(i) for i in range(torch.cuda.device_count())],
    }
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True)
        info["nvidia_smi"] = smi.stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError) as exc:
        info["nvidia_smi"] = f"unavailable ({exc})"
    return info


def run_experiment(config_path: str, log_dir: str = "logs",
                   overrides: Optional[Dict[str, Any]] = None,
                   device: str = "cuda") -> Dict[str, Any]:
    """Run one training experiment on ``device``; returns a summary dict
    (success flag, dataset sizes, timings) and writes the log file and the
    resolved-config snapshot (rank 0 alone, in a process group)."""
    name = Path(config_path).stem
    timestamp = datetime.datetime.now().strftime("%Y%m%d_%H%M%S")
    run_dir = Path(log_dir) / f"{name}_{timestamp}"
    writer = is_writer()
    if writer:
        run_dir.mkdir(parents=True, exist_ok=True)
    setup_logging(log_level=os.environ.get("TWOTOWER_LOG_LEVEL", "INFO") if writer
                  else "WARNING", log_file=str(run_dir / "train.log") if writer else None)
    summary: Dict[str, Any] = {
        "experiment": name,
        "config_path": str(config_path),
        "started": timestamp,
        "device": str(device),
        "hardware": get_hardware_info(),
    }
    start = time.time()
    try:
        config = load_config(config_path)
        if overrides:
            config.update(overrides)
        config.setdefault("log_dir", str(run_dir))
        if writer:
            save_config(config, str(run_dir / "resolved_config.yml"))

        from ..train import train_model

        _, pipeline = train_model(config, device=device)
        summary["success"] = True
        summary["num_triplets"] = len(pipeline.dataset)
        summary["vocab_size"] = pipeline.dataset.vocab_size
    except Exception as exc:  # one failed run must not stop the others
        logger.exception("Experiment %s failed", name)
        summary["success"] = False
        summary["error"] = str(exc)
    summary["duration_s"] = time.time() - start
    if writer:
        with open(run_dir / "summary.json", "w") as f:
            json.dump(summary, f, indent=2, default=str)
    return summary


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(description="Train two-tower models from configs")
    parser.add_argument("--config", help="Path to a single config YAML")
    parser.add_argument("--configs", nargs="+", help="Multiple config YAMLs")
    parser.add_argument("--config_dir", help="Directory of config YAMLs")
    parser.add_argument("--log_dir", default="logs")
    parser.add_argument("--parallel", type=int, default=0,
                        help="Run N experiments in parallel processes (0 = sequential)")
    parser.add_argument("--use_wandb", action="store_true")
    parser.add_argument("--epochs", type=int, default=None)
    parser.add_argument("--batch_size", type=int, default=None)
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    parser.add_argument("--log_level", default="INFO",
                        choices=["DEBUG", "INFO", "WARNING", "ERROR"])
    args = parser.parse_args(argv)

    config_paths: List[str] = []
    if args.config:
        config_paths.append(args.config)
    if args.configs:
        config_paths.extend(args.configs)
    if args.config_dir:
        config_paths.extend(
            sorted(str(p) for p in Path(args.config_dir).glob("*.yml"))
        )
    if not config_paths:
        parser.error("Provide --config, --configs or --config_dir")
    resolve_device(args.device)  # no card and no --device cpu: raise before any run
    initialize_distributed(device_type=torch.device(args.device).type)  # under torchrun

    os.environ["TWOTOWER_LOG_LEVEL"] = args.log_level
    overrides: Dict[str, Any] = {}
    if args.use_wandb:
        overrides["use_wandb"] = True
    if args.epochs is not None:
        overrides["epochs"] = args.epochs
    if args.batch_size is not None:
        overrides["batch_size"] = args.batch_size

    jobs = [(p, args.log_dir, overrides, args.device) for p in config_paths]
    if args.parallel > 1 and len(config_paths) > 1:
        with multiprocessing.get_context("spawn").Pool(args.parallel) as pool:
            summaries = pool.starmap(run_experiment, jobs)
    else:
        summaries = [run_experiment(*job) for job in jobs]

    group_meta = {
        "experiments": summaries,
        "total": len(summaries),
        "succeeded": sum(1 for s in summaries if s.get("success")),
    }
    if is_writer():
        group_dir = Path(args.log_dir)
        group_dir.mkdir(parents=True, exist_ok=True)
        group_path = group_dir / f"experiment_group_{int(time.time())}.json"
        with open(group_path, "w") as f:
            json.dump(group_meta, f, indent=2, default=str)
        print(f"{group_meta['succeeded']}/{group_meta['total']} experiments succeeded "
              f"(details: {group_path})")
    return 0 if group_meta["succeeded"] == group_meta["total"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
