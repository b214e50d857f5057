"""Hierarchical logging and wall-clock timing utilities.

A copy of ``twotowers_tpu/utils/logging.py``: a package-wide logger with
per-module children, optional per-run log files, array-info debugging helpers,
and a split-capable ``Timer`` used for the ``performance/*`` metric family.
"""

from __future__ import annotations

import logging
import time
from typing import Any, Dict, Optional

ROOT_LOGGER_NAME = "twotowers_tpu_torch"

_FORMAT = "%(asctime)s - %(name)s - %(levelname)s - %(message)s"


def get_logger(name: str = "") -> logging.Logger:
    """Get a child logger under the package root logger."""
    if name:
        return logging.getLogger(f"{ROOT_LOGGER_NAME}.{name}")
    return logging.getLogger(ROOT_LOGGER_NAME)


def setup_logging(
    log_level: str = "INFO",
    log_file: Optional[str] = None,
    console: bool = True,
) -> logging.Logger:
    """Configure the package logger with console and/or file handlers."""
    numeric_level = getattr(logging, log_level.upper(), None)
    if not isinstance(numeric_level, int):
        raise ValueError(f"Invalid log level: {log_level}")

    logger = logging.getLogger(ROOT_LOGGER_NAME)
    logger.setLevel(numeric_level)
    logger.handlers = []
    # other libraries may attach a root handler; without this every record
    # prints twice
    logger.propagate = False

    formatter = logging.Formatter(_FORMAT)
    if console:
        handler = logging.StreamHandler()
        handler.setFormatter(formatter)
        logger.addHandler(handler)
    if log_file:
        file_handler = logging.FileHandler(log_file, mode="w")
        file_handler.setFormatter(formatter)
        logger.addHandler(file_handler)

    logger.info(
        "Logging configured with level=%s, file=%s, console=%s",
        log_level, log_file, console,
    )
    return logger


def log_array_info(array: Any, name: str = "array", logger: Optional[logging.Logger] = None) -> None:
    """Log shape/dtype/stats for an array-like, or summary for a list."""
    logger = logger or get_logger()
    if hasattr(array, "shape") and hasattr(array, "dtype"):
        import numpy as np

        host = np.asarray(array)
        logger.info("%s shape: %s, dtype: %s", name, host.shape, host.dtype)
        if host.size and np.issubdtype(host.dtype, np.number):
            logger.info(
                "%s stats: min=%.4f, max=%.4f, mean=%.4f, std=%.4f",
                name, host.min(), host.max(),
                host.astype("float64").mean(), host.astype("float64").std(),
            )
        flat = host.flatten()
        if flat.size < 10:
            logger.info("%s full content: %s", name, flat.tolist())
        else:
            logger.info("%s sample: %s ... %s", name, flat[:5].tolist(), flat[-5:].tolist())
    elif isinstance(array, list):
        logger.info("%s type: list, length: %d", name, len(array))
        if len(array) < 10:
            logger.info("%s full content: %s", name, array)
        else:
            logger.info("%s sample: %s ... %s", name, array[:3], array[-3:])
    else:
        logger.info("%s: %s", name, array)


class Timer:
    """Wall-clock timer with named splits and percentage summaries."""

    def __init__(self, name: str = "Timer"):
        self.name = name
        self.start_time: Optional[float] = None
        self.splits = []  # list of (name, absolute_time, elapsed_since_prev)
        self._logger = get_logger("utils.timer")

    def start(self) -> float:
        self.start_time = time.time()
        self.splits = []
        return self.start_time

    def split(self, split_name: Optional[str] = None) -> float:
        if self.start_time is None:
            self.start()
            return 0.0
        current = time.time()
        last_time = self.start_time if not self.splits else self.splits[-1][1]
        elapsed = current - last_time
        self.splits.append((split_name or f"Split {len(self.splits) + 1}", current, elapsed))
        return elapsed

    def stop(self) -> float:
        if self.start_time is None:
            return 0.0
        return time.time() - self.start_time

    def summary(self) -> Dict[str, Any]:
        if self.start_time is None:
            return {"error": "Timer not started"}
        total_time = time.time() - self.start_time
        result = {
            "total_time": total_time,
            "splits": {s[0]: s[2] for s in self.splits},
            "split_percentages": {
                s[0]: (s[2] / total_time) * 100 if total_time else 0.0 for s in self.splits
            },
        }
        self._logger.info("%s summary: total %.4fs", self.name, total_time)
        for sname, elapsed in result["splits"].items():
            self._logger.info(
                "  %s: %.4fs (%.1f%%)", sname, elapsed, result["split_percentages"][sname]
            )
        return result
