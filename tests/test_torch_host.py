"""The port's host layer against the JAX package's, and the no-JAX guard.

The char tokenizer, its native core and the registry are copies; these tests
prove the copies give the JAX package's outputs exactly (integer ids, no
tolerance). The guard proves that the port imports neither JAX nor anything
of the JAX package.
"""

import ast
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from twotowers_tpu.tokenizers import CharTokenizer as JaxCharTokenizer
from twotowers_tpu.utils.registry import Registry as JaxRegistry
from twotowers_tpu_torch.native import tokenize as native
from twotowers_tpu_torch.tokenizers import (
    CharTokenizer, build_tokenizer, tokenizer_from_state)
from twotowers_tpu_torch.utils.registry import Registry

PACKAGE = Path(__file__).resolve().parents[1] / "twotowers_tpu_torch"


def _texts(rng, n):
    alphabet = np.array(list("abcdefghij klmnop"))
    return ["".join(rng.choice(alphabet, size=rng.integers(0, 40))) for _ in range(n)]


@pytest.fixture
def fitted(np_rng):
    corpus = _texts(np_rng, 50)
    return JaxCharTokenizer().fit(corpus), CharTokenizer().fit(corpus)


# 5 texts take the numpy path, 100 the native one (char.py: >= 64 texts)
@pytest.mark.parametrize("n_texts", [5, 100])
@pytest.mark.parametrize("max_len", [16, 32])
def test_encode_batch_matches_jax(np_rng, fitted, n_texts, max_len):
    jax_tok, tok = fitted
    # 'qrs' and 'Z' are outside the fitted alphabet: they encode to 0
    texts = _texts(np_rng, n_texts) + ["qrsZ", "", "a" * 50]
    got = tok.encode_batch(texts, max_len)
    np.testing.assert_array_equal(got, jax_tok.encode_batch(texts, max_len))
    assert got.dtype == np.int32 and got.shape == (len(texts), max_len)
    np.testing.assert_array_equal(got[-3, :4], 0)


def test_native_core_matches_python_path(np_rng, fitted):
    _, tok = fitted
    assert native.available()  # a C++ compiler exists here
    assert native.get_lib()._name.startswith(str(native.BUILD_DIR))
    texts = _texts(np_rng, 80) + ["qrsZ"]
    python_rows = np.concatenate([tok.encode_batch(texts[i:i + 1], 24)
                                  for i in range(len(texts))])
    np.testing.assert_array_equal(native.char_encode_batch(texts, tok._lut, 24),
                                  python_rows)


def test_state_dict_round_trip(fitted):
    jax_tok, tok = fitted
    assert tok.state_dict() == jax_tok.state_dict()
    again = tokenizer_from_state(jax_tok.state_dict())
    assert isinstance(again, CharTokenizer)
    assert again.vocab_size == jax_tok.vocab_size
    assert again.decode(again.encode("abc")) == "abc"
    np.testing.assert_array_equal(again(["hello"], 8), jax_tok(["hello"], 8))


def test_build_tokenizer_char_only():
    assert isinstance(build_tokenizer("char"), CharTokenizer)


@pytest.mark.parametrize("kind", ["word", "bpe", "wordpiece"])
def test_unported_tokenizer_names_roadmap_item(kind):
    with pytest.raises(NotImplementedError, match="ROADMAP.md §1 item 2"):
        tokenizer_from_state({"type": kind})


@pytest.mark.parametrize("cls", [Registry, JaxRegistry])
def test_registry_copy_behaves_alike(cls):
    reg = cls("thing")
    reg.add("a", 1)
    with pytest.raises(ValueError, match="Duplicate thing registration"):
        reg.add("a", 2)
    with pytest.raises(ValueError, match=r"Unknown thing: 'b'. Available options: \['a'\]"):
        reg.get("b")
    assert "a" in reg and list(reg.names()) == ["a"]


def test_port_imports_no_jax():
    """Import the port and every submodule in a fresh interpreter; no JAX
    module and no module of the JAX package may be loaded."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import twotowers_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, 'twotowers_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'jaxlib'))\n"
        "             or m == 'twotowers_tpu' or m.startswith('twotowers_tpu.'))\n"
        "print(len([m for m in sys.modules if m.startswith('twotowers_tpu_torch')]))\n"
        "assert not bad, bad\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=PACKAGE.parent, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 20  # every submodule was imported


@pytest.mark.parametrize("path", sorted(PACKAGE.rglob("*.py")), ids=lambda p: p.name)
def test_source_has_no_jax_import(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names = [alias.name for alias in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in ("jax", "jaxlib", "twotowers_tpu"), \
                f"{path.name} imports {name}"
