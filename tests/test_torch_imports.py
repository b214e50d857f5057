"""Every module of the port imports with neither JAX nor pandas.

The card's machine has no JAX and no pandas. So each module outside
``data/factory/`` (the one package that uses pandas, and only on the host)
must import in a process where ``import pandas`` and ``import jax`` fail,
and importing ``twotowers_tpu_torch`` or its ``data`` package must not load
the factory. One child process imports them all; each module is one case.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PACKAGE = ROOT / "twotowers_tpu_torch"
MODULES = sorted(
    ".".join(("twotowers_tpu_torch",) + path.relative_to(PACKAGE).with_suffix("").parts)
    .removesuffix(".__init__")
    for path in PACKAGE.rglob("*.py")
    if "factory" not in path.relative_to(PACKAGE).parts)

_CHILD = """
import importlib, json, sys, traceback
for blocked in ("pandas", "jax", "jaxlib", "twotowers_tpu"):
    sys.modules[blocked] = None  # any import of these raises ImportError
errors = {}
for name in json.loads(sys.argv[1]):
    try:
        importlib.import_module(name)
    except BaseException:
        errors[name] = traceback.format_exc(limit=3)
errors["<factory loaded>"] = [m for m in sys.modules if ".factory" in m] or None
print(json.dumps(errors))
"""


@pytest.fixture(scope="module")
def import_errors():
    env = {**os.environ,
           "PYTHONPATH": os.pathsep.join([str(ROOT), os.environ.get("PYTHONPATH", "")])}
    out = subprocess.run([sys.executable, "-c", _CHILD, json.dumps(MODULES)], env=env,
                         cwd=str(ROOT), capture_output=True, text=True, timeout=300, check=True)
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_the_walk_finds_the_packages():
    assert {"twotowers_tpu_torch", "twotowers_tpu_torch.data", "twotowers_tpu_torch.index.cli",
            "twotowers_tpu_torch.scripts.train"} <= set(MODULES)


@pytest.mark.parametrize("module", MODULES)
def test_imports_without_jax_or_pandas(import_errors, module):
    assert import_errors.get(module) is None, import_errors[module]


def test_no_module_outside_the_factory_loads_it(import_errors):
    assert import_errors["<factory loaded>"] is None
