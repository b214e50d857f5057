"""YAML configuration with ``extends:`` inheritance and environment overrides.

A copy of ``twotowers_tpu/utils/config.py``: path resolution (as given,
then relative to the project root, then by basename under ``configs/``),
``extends:`` inheritance by recursive deep merge, and typed ``TWOTOWER_*``
environment overrides where ``__`` nests keys (``TWOTOWER_WANDB__PROJECT``
-> ``wandb.project``). One change: ``yaml`` is imported inside
``load_config`` and ``save_config``, so the rest of the package imports on
a machine without ``pyyaml``, where a config is passed as a dict.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Any, Dict, Optional

from .logging import get_logger

logger = get_logger("utils.config")

ENV_PREFIX = "TWOTOWER_"


def parse_env_value(value: str) -> Any:
    """Parse an environment-variable string into int/float/bool/str."""
    try:
        return int(value)
    except ValueError:
        pass
    try:
        return float(value)
    except ValueError:
        pass
    lowered = value.lower()
    if lowered in ("true", "yes", "1"):
        return True
    if lowered in ("false", "no", "0"):
        return False
    return value


def deep_merge(base: Dict[str, Any], override: Dict[str, Any]) -> Dict[str, Any]:
    """Recursively merge ``override`` into ``base`` (override wins)."""
    result = dict(base)
    for key, value in override.items():
        if key in result and isinstance(result[key], dict) and isinstance(value, dict):
            result[key] = deep_merge(result[key], value)
        else:
            result[key] = value
    return result


def _project_root() -> Path:
    # twotowers_tpu_torch/utils/config.py -> the repo root, two parents above
    # the package
    return Path(__file__).resolve().parent.parent.parent


def _resolve_config_path(path: str) -> Path:
    """1. the path as given; 2. relative to the project root; 3. by basename
    in common ``configs/`` directories."""
    p = Path(path)
    if p.exists():
        return p
    root = _project_root()
    candidate = root / path
    if candidate.exists():
        return candidate
    for config_dir in (root / "configs", Path("configs"), Path("./configs")):
        candidate = Path(config_dir) / p.name
        if candidate.exists():
            return candidate
    raise FileNotFoundError(
        f"Config file not found: {path}. Tried as-given, project-root-relative, "
        f"and basename lookup under configs/."
    )


def _env_overrides(environ: Optional[Dict[str, str]] = None) -> Dict[str, Any]:
    environ = os.environ if environ is None else environ
    overrides: Dict[str, Any] = {}
    for env_name, env_value in environ.items():
        if not env_name.startswith(ENV_PREFIX):
            continue
        config_key = env_name[len(ENV_PREFIX):].lower()
        if "__" in config_key:
            parts = config_key.split("__")
            current = overrides
            for part in parts[:-1]:
                current = current.setdefault(part, {})
            current[parts[-1]] = parse_env_value(env_value)
        else:
            overrides[config_key] = parse_env_value(env_value)
    return overrides


def load_config(path: str, apply_env: bool = True) -> Dict[str, Any]:
    """Load a YAML config with ``extends`` inheritance and env overrides."""
    import yaml

    resolved = _resolve_config_path(path)
    with open(resolved) as f:
        config = yaml.safe_load(f) or {}

    if "extends" in config:
        base_path = config.pop("extends")
        if not os.path.isabs(base_path):
            sibling = resolved.parent / base_path
            base_path = str(sibling) if sibling.exists() else base_path
        try:
            base_config = load_config(base_path, apply_env=False)
        except FileNotFoundError:
            # `extends: configs/foo.yml` written from inside configs/: fall
            # back to the basename lookup of the resolver
            base_config = load_config(Path(base_path).name, apply_env=False)
        config = deep_merge(base_config, config)

    if apply_env:
        overrides = _env_overrides()
        if overrides:
            config = deep_merge(config, overrides)
            logger.info("Applied environment overrides: %s", list(overrides))

    logger.debug("Configuration loaded from %s", resolved)
    return config


def save_config(config: Dict[str, Any], path: str) -> None:
    """Save a config dict as YAML (insertion order preserved)."""
    import yaml

    Path(path).parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w") as f:
        yaml.dump(config, f, default_flow_style=False, sort_keys=False)
    logger.info("Configuration saved to %s", path)
