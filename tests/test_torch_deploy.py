"""The port's serving deployment: ``serve_torch.Dockerfile`` and
``docker-compose.torch.yml``.

Building the image needs the network, so these tests read the two files
instead and run, in a child process, what the image runs: the port's
service built as the app builds it, with JAX and the host-only packages
unimportable. Every module of the port that the child loads may import at
module level only torch and what the Dockerfile installs.
"""

import ast
import json
import os
import re
import shlex
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import yaml

import chip_smoke
from twotowers_tpu_torch.kernels import build
from twotowers_tpu_torch.tokenizers import build_tokenizer
from twotowers_tpu_torch.train.checkpoint import save_params

ROOT = Path(__file__).resolve().parents[1]
DOCKERFILE = ROOT / "serve_torch.Dockerfile"
COMPOSE = ROOT / "docker-compose.torch.yml"
PACKAGE = "twotowers_tpu_torch"
BLOCKED = ("jax", "jaxlib", "orbax", "flax", "optax", "twotowers_tpu", "bridge", "pandas",
           "pyarrow", "datasets")
IMPORT_NAMES = {"pyyaml": "yaml"}  # pip's name -> the name a module imports


def instructions():
    """(INSTRUCTION, argument) pairs of the Dockerfile, continuation lines
    joined and comments dropped."""
    text = re.sub(r"\\\n", " ", DOCKERFILE.read_text())
    out = []
    for line in text.splitlines():
        line = line.strip()
        if line and not line.startswith("#"):
            word, _, rest = line.partition(" ")
            out.append((word.upper(), rest.strip()))
    return out


def arguments(name):
    return [rest for word, rest in instructions() if word == name]


def installed():
    """The import names of the packages the Dockerfile's pip installs."""
    names = set()
    for run in arguments("RUN"):
        words = shlex.split(run)
        for i in (i for i, w in enumerate(words) if w == "install" and words[i - 1] == "pip"):
            for word in words[i + 1:]:
                if word in ("&&", ";"):
                    break
                if not word.startswith("-"):
                    names.add(IMPORT_NAMES.get(word, word))
    return names


def test_the_image_copies_the_port_alone():
    copies = [shlex.split(rest) for rest in arguments("COPY")]
    sources = {Path(s).parts[0] for words in copies for s in words[:-1]}
    assert PACKAGE in sources
    assert not sources & {"twotowers_tpu", "bridge", ".", "pyproject.toml"}
    assert arguments("WORKDIR") == ["/app"]
    assert [words[-1] for words in copies] == ["./twotowers_tpu_torch"]  # /app/twotowers_tpu_torch
    assert "PYTHONPATH=/app" in arguments("ENV")
    # the kernels' libraries land beside the package: /app/build/twotowers_tpu_torch
    assert build.BUILD_DIR == build.PACKAGE_DIR.parent / "build" / PACKAGE


def test_the_image_installs_no_jax_and_not_the_distribution():
    runs = arguments("RUN")
    assert not any(re.search(r"pip install\b.*\s\.(\[|\s|$)", run) for run in runs)
    assert not any("jax" in run for run in runs if "pip" in run)
    assert {"numpy", "yaml", "fastapi", "uvicorn"} <= installed()
    assert not installed() & set(BLOCKED)


def test_the_image_starts_the_ports_app():
    assert [json.loads(cmd) for cmd in arguments("CMD")] == [
        ["python", "-m", "twotowers_tpu_torch.serve.app"]]
    assert "PORT=8080" in arguments("ENV") and arguments("EXPOSE") == ["8080"]


def test_the_image_builds_the_kernels_on_a_devel_base():
    steps = instructions()
    builds = [i for i, (word, rest) in enumerate(steps) if word == "RUN" and re.search(
        r"python -c .*from twotowers_tpu_torch\.kernels import build; build\.build\(\)", rest)]
    copied = [i for i, (word, rest) in enumerate(steps) if word == "COPY" and PACKAGE in rest]
    assert builds and copied and copied[0] < builds[0]  # built from the copied sources
    defaults = dict(arg.split("=", 1) for arg in arguments("ARG") if "=" in arg)
    (base,) = arguments("FROM")
    base = re.sub(r"\$\{(\w+)\}", lambda m: defaults[m.group(1)], base)
    assert base.startswith("pytorch/pytorch:") and base.endswith("-devel")


def _environ_names(path: Path) -> set:
    """Names a module reads through ``os.environ.get(NAME)`` or
    ``os.environ[NAME]``, NAME a string or a module-level string constant."""
    tree = ast.parse(path.read_text())
    constants = {t.id: node.value.value for node in tree.body if isinstance(node, ast.Assign)
                 and isinstance(node.value, ast.Constant) and isinstance(node.value.value, str)
                 for t in node.targets if isinstance(t, ast.Name)}

    def is_environ(node):
        return isinstance(node, ast.Attribute) and node.attr == "environ" \
            and isinstance(node.value, ast.Name) and node.value.id == "os"

    names = set()
    for node in ast.walk(tree):
        key = None
        if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute) \
                and node.func.attr == "get" and is_environ(node.func.value) and node.args:
            key = node.args[0]
        elif isinstance(node, ast.Subscript) and is_environ(node.value):
            key = node.slice
        if isinstance(key, ast.Constant):
            names.add(key.value)
        elif isinstance(key, ast.Name) and key.id in constants:
            names.add(constants[key.id])
    return names


def test_the_compose_builds_the_image_and_reserves_a_gpu():
    service = yaml.safe_load(COMPOSE.read_text())["services"]["inference"]
    assert service["build"] == {"context": ".", "dockerfile": "serve_torch.Dockerfile"}
    devices = service["deploy"]["resources"]["reservations"]["devices"]
    assert devices == [{"driver": "nvidia", "count": 1, "capabilities": ["gpu"]}]
    assert service["volumes"] == ["./checkpoints:/models:ro"]
    assert service["environment"] == ["MODEL_CHECKPOINT=/models/best_model"]
    assert service["ports"] == ["8080:8080"]


def test_the_compose_passes_only_names_the_port_reads():
    named = re.findall(r"^\s*#?\s*-\s*([A-Z][A-Z0-9_]*)=", COMPOSE.read_text(), re.MULTILINE)
    assert named == ["MODEL_CHECKPOINT", "MODEL_REPO_URL", "CHROMA_HOST", "CHROMA_PORT"]
    read = set()
    for sub in ("serve", "hub"):
        for path in (ROOT / PACKAGE / sub).glob("*.py"):
            read |= _environ_names(path)
    assert {"MODEL_CHECKPOINT", "MODEL_REPO_URL", "CHROMA_HOST", "CHROMA_PORT", "PORT",
            "HUGGINGFACE_ACCESS_TOKEN"} <= read  # the walk finds what the app reads
    assert set(named) <= read


_CHILD = """
import importlib.abc, json, sys

BLOCKED = set(json.loads(sys.argv[1]))


class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"{name} is not in the image")
        return None


sys.meta_path.insert(0, Block())
from twotowers_tpu_torch.serve import app

service = app.build_service("cpu")
texts = json.loads(sys.argv[2])
service.add(texts)
first = []
for text in texts:
    results = service.search(text, top_k=3)["results"]
    first.append(text in [r["document"] for r in results
                          if r["distance"] <= results[0]["distance"] + 1e-6])
print(json.dumps({
    "first": first, "health": service.health(),
    "loaded": {name: m.__file__ for name, m in sys.modules.items()
               if name.split(".")[0] == "twotowers_tpu_torch" and getattr(m, "__file__", None)},
    "blocked_loaded": sorted(n for n in sys.modules if n.split(".")[0] in BLOCKED)}))
"""


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """The child's report: the port's service built as the image's app
    builds it, from a small port checkpoint (the default config's shape,
    random weights from a seed) named by ``MODEL_CHECKPOINT``."""
    tmp_path = tmp_path_factory.mktemp("deploy")
    texts = chip_smoke.synthetic_texts(3, seed=4)
    tokenizer = build_tokenizer("char", max_len=64).fit(texts)
    ckpt = save_params(str(tmp_path / "best_model"),
                       chip_smoke.default_weights(tokenizer.vocab_size, np.random.default_rng(4)),
                       tokenizer.state_dict(), chip_smoke.DEFAULT_CONFIG)
    env = {key: value for key, value in os.environ.items()
           if key not in ("CHROMA_HOST", "CHROMA_PORT", "MODEL_REPO_URL")}
    env.update(MODEL_CHECKPOINT=ckpt, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", _CHILD, json.dumps(BLOCKED), json.dumps(texts)],
                         env=env, cwd=str(tmp_path), capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_the_service_serves_without_jax(served):
    assert served["first"] == [True, True, True]
    assert served["health"] == {"status": "ok", "model_loaded": True, "documents": 3}
    assert served["blocked_loaded"] == []
    assert {"twotowers_tpu_torch.serve.app", "twotowers_tpu_torch.ops.topk_score",
            "twotowers_tpu_torch.train.checkpoint"} <= set(served["loaded"])
    assert all(Path(f).resolve().is_relative_to(ROOT / PACKAGE)
               for f in served["loaded"].values())


def _module_level_imports(path: Path) -> set:
    """Top-level names of the absolute imports a file makes outside any
    function or class (those under a module-level ``try`` or ``if`` too)."""
    names, todo = set(), list(ast.parse(path.read_text()).body)
    while todo:
        node = todo.pop()
        if isinstance(node, ast.Import):
            names |= {alias.name.split(".")[0] for alias in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
        elif isinstance(node, (ast.Try, ast.If)):
            todo += node.body + node.orelse + getattr(node, "finalbody", [])
            todo += [stmt for handler in getattr(node, "handlers", []) for stmt in handler.body]
    return names


def test_the_loaded_modules_import_only_what_the_image_installs(served):
    allowed = installed() | {"torch", PACKAGE}
    foreign = {}
    for name, path in served["loaded"].items():
        third_party = {n for n in _module_level_imports(Path(path))
                       if n not in sys.stdlib_module_names}
        if third_party - allowed:
            foreign[name] = sorted(third_party - allowed)
    assert foreign == {}
