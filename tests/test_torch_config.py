"""The port's YAML config loader against the JAX package's.

Every file in ``configs/`` loads to the same dict through both, with
``extends:`` inheritance and with ``TWOTOWER_*`` environment overrides.
``chip_smoke.py`` commits the resolved ``configs/transformer_tower.yml``
as a dict (the card's machine may lack ``pyyaml``); it must stay equal to
what both loaders give.
"""

import subprocess
import sys
from pathlib import Path

import pytest

import chip_smoke
from twotowers_tpu.utils import config as jax_config
from twotowers_tpu_torch.utils import config, deep_merge, load_config, save_config

ROOT = Path(__file__).resolve().parents[1]
CONFIGS = sorted(p.name for p in (ROOT / "configs").glob("*.yml"))

OVERRIDES = {  # TWOTOWER_* variables and the typed values they must give
    "TWOTOWER_BATCH_SIZE": 32,
    "TWOTOWER_LEARNING_RATE": 0.01,
    "TWOTOWER_USE_WANDB": False,
    "TWOTOWER_ENCODER__NUM_LAYERS": 3,
    "TWOTOWER_WANDB__PROJECT": "port",
    "TWOTOWER_OPTIMIZER__TYPE": "sgd",
}


@pytest.fixture
def no_env(monkeypatch):
    import os

    for name in list(os.environ):
        if name.startswith(config.ENV_PREFIX):
            monkeypatch.delenv(name)


def test_configs_are_found():
    assert "transformer_tower.yml" in CONFIGS and len(CONFIGS) >= 7


@pytest.mark.parametrize("name", CONFIGS)
def test_load_config_matches_jax(no_env, name):
    got = load_config(str(ROOT / "configs" / name), apply_env=False)
    assert got == jax_config.load_config(str(ROOT / "configs" / name), apply_env=False)
    assert "extends" not in got
    # the same file found by basename and from the project root
    assert load_config(name, apply_env=False) == got
    assert load_config(f"configs/{name}") == got  # no TWOTOWER_* set


@pytest.mark.parametrize("name", ["transformer_tower.yml", "default_config.yml"])
def test_env_overrides_match_jax(no_env, monkeypatch, name):
    for key, value in OVERRIDES.items():
        monkeypatch.setenv(key, str(value).lower() if isinstance(value, bool) else str(value))
    got = load_config(name)
    assert got == jax_config.load_config(name)
    assert got["batch_size"] == 32 and got["learning_rate"] == 0.01
    assert got["use_wandb"] is False and got["encoder"]["num_layers"] == 3
    assert got["wandb"]["project"] == "port" and got["optimizer"]["type"] == "sgd"
    base = load_config(name, apply_env=False)
    assert got["encoder"]["hidden_dim"] == base["encoder"]["hidden_dim"]  # merged, not replaced


def test_extends_resolves_beside_the_child(no_env, tmp_path):
    (tmp_path / "base.yml").write_text("a: 1\nnested:\n  x: 1\n  y: 2\nlist: [1, 2]\n")
    (tmp_path / "child.yml").write_text("extends: base.yml\nnested:\n  y: 3\nlist: [9]\n")
    got = load_config(str(tmp_path / "child.yml"))
    assert got == jax_config.load_config(str(tmp_path / "child.yml"))
    assert got == {"a": 1, "nested": {"x": 1, "y": 3}, "list": [9]}


def test_missing_config_raises_in_both():
    for loader in (load_config, jax_config.load_config):
        with pytest.raises(FileNotFoundError, match="Config file not found"):
            loader("no_such_config.yml")


@pytest.mark.parametrize("value", ["7", "-2", "0.5", "1e-3", "true", "Yes", "FALSE", "no",
                                   "1", "0", "bf16", ""])
def test_parse_env_value_matches_jax(value):
    got = config.parse_env_value(value)
    want = jax_config.parse_env_value(value)
    assert got == want and type(got) is type(want)


def test_deep_merge_matches_jax():
    base = {"a": {"b": 1, "c": {"d": 2}}, "e": [1], "f": 3}
    over = {"a": {"c": {"d": 5, "g": 6}}, "e": {"x": 1}, "h": None}
    assert deep_merge(base, over) == jax_config.deep_merge(base, over)
    assert base == {"a": {"b": 1, "c": {"d": 2}}, "e": [1], "f": 3}  # untouched


def test_save_config_round_trips_through_both(no_env, tmp_path):
    cfg = load_config("transformer_tower.yml")
    save_config(cfg, str(tmp_path / "out" / "saved.yml"))
    assert jax_config.load_config(str(tmp_path / "out" / "saved.yml")) == cfg
    jax_config.save_config(cfg, str(tmp_path / "jax.yml"))
    assert (tmp_path / "jax.yml").read_text() == (tmp_path / "out" / "saved.yml").read_text()


def test_chip_smoke_commits_the_transformer_config(no_env):
    """The dict the chip smoke trains from is the file as both loaders
    resolve it; the phase then changes only its paths and the depth."""
    want = jax_config.load_config("transformer_tower.yml", apply_env=False)
    assert chip_smoke.TRANSFORMER_CONFIG == load_config("transformer_tower.yml",
                                                        apply_env=False) == want
    phase = chip_smoke.transformer_config(Path("/work"))
    changed = {k for k in set(phase) | set(want) if phase.get(k) != want.get(k)}
    assert changed == {"data", "checkpoint_dir", "log_dir", "epochs"}
    assert phase["epochs"] == 2 and phase["batch_size"] == want["batch_size"] == 256


def test_package_imports_without_yaml():
    """yaml is imported only where a file is read or written: the card's
    machine may lack it."""
    code = ("import sys; sys.modules['yaml'] = None\n"
            "import twotowers_tpu_torch.utils as u, twotowers_tpu_torch.train\n"
            "try:\n    u.load_config('transformer_tower.yml')\n"
            "except ImportError:\n    print('refused')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "refused"


def test_in_batch_loss_drops_the_margin_its_base_config_carries(no_env):
    """configs/transformer_tower.yml extends a triplet config, so its loss
    section is {in_batch, margin 0.2, temperature 0.1}. The JAX package
    binds the margin and its step raises; the port drops it (a deviation,
    ROADMAP.md §3) and computes JAX's in_batch loss at temperature 0.1."""
    import jax.numpy as jnp
    import numpy as np
    import torch

    from twotowers_tpu.models.losses import build_loss as jax_build_loss
    from twotowers_tpu_torch.models import build_loss

    loss_cfg = dict(load_config("transformer_tower.yml", apply_env=False)["loss"])
    kind = loss_cfg.pop("type")
    assert kind == "in_batch" and loss_cfg == {"margin": 0.2, "temperature": 0.1}
    rng = np.random.default_rng(0)
    q, d = (x / np.linalg.norm(x, axis=1, keepdims=True)
            for x in rng.normal(size=(2, 5, 8)).astype(np.float32))
    w = np.array([1, 1, 1, 1, 0], np.float32)
    got, _ = build_loss(kind, **loss_cfg).fn(*map(torch.from_numpy, (q, d, w)))
    want, _ = jax_build_loss(kind, temperature=0.1).fn(*map(jnp.asarray, (q, d, w)))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    with pytest.raises(TypeError, match="margin"):
        jax_build_loss(kind, **loss_cfg).fn(*map(jnp.asarray, (q, d, w)))
    with pytest.raises(TypeError, match="unknown settings"):
        build_loss(kind, temprature=0.1)
