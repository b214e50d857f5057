"""Cross-cutting utilities: logging, registries, device choice."""

from .device import resolve_device
from .logging import Timer, get_logger, log_array_info, setup_logging
from .registry import Registry

__all__ = [
    "Registry",
    "Timer",
    "get_logger",
    "log_array_info",
    "resolve_device",
    "setup_logging",
]
