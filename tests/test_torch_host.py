"""The port's host layer against the JAX package's, and the no-JAX guard.

The char and word tokenizers, their native core and the registry are
copies; these tests prove the copies give the JAX package's outputs exactly
(integer ids, no tolerance). The guard proves that the port imports neither
JAX nor anything of the JAX package.
"""

import ast
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from twotowers_tpu.tokenizers import CharTokenizer as JaxCharTokenizer
from twotowers_tpu.tokenizers import WordTokenizer as JaxWordTokenizer
from twotowers_tpu.utils.registry import Registry as JaxRegistry
from twotowers_tpu_torch.native import tokenize as native
from twotowers_tpu_torch.tokenizers import (
    CharTokenizer, WordTokenizer, build_tokenizer, tokenizer_from_state)
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


def test_build_tokenizer_word():
    word = build_tokenizer("word", max_vocab_size=7, max_len=9, lowercase=False)
    assert isinstance(word, WordTokenizer)
    assert (word.max_vocab_size, word.max_len, word.lowercase) == (7, 9, False)


# ---- the word tokenizer ----------------------------------------------------------

_WORDS = ["apple", "Banana", "cherry", "date", "Elder", "fig", "grape", "kiwi", "lime"]


def _sentences(rng, n, ascii_only=True):
    words = _WORDS + ([] if ascii_only else ["café", "naïve"])
    punct = ["", "", ",", ".", "!", " -", "?"]
    return [" ".join(rng.choice(words) + rng.choice(punct)
                     for _ in range(rng.integers(0, 14))) for _ in range(n)]


@pytest.mark.parametrize("max_vocab_size", [None, 6, 2])
@pytest.mark.parametrize("lowercase,strip", [(True, True), (False, True), (True, False)])
def test_word_vocab_matches_jax(np_rng, max_vocab_size, lowercase, strip):
    """Same ids for the same corpus: counts, ties broken alphabetically, the
    max_vocab_size cut (PAD and UNK count towards it)."""
    corpus = _sentences(np_rng, 40) + ["tie_b tie_a tie_b tie_a"]
    kwargs = dict(lowercase=lowercase, strip_punctuation=strip, max_vocab_size=max_vocab_size)
    got = WordTokenizer(**kwargs).fit(corpus)
    want = JaxWordTokenizer(**kwargs).fit(corpus)
    assert got.word_to_index == want.word_to_index
    assert list(got.word_to_index) == list(want.word_to_index)  # the id order too
    assert got.vocab_size == want.vocab_size and got.is_fitted == want.is_fitted


# 5 texts take the Python path, 100 the native one (word.py: >= 64 ASCII texts)
@pytest.mark.parametrize("n_texts", [5, 100])
@pytest.mark.parametrize("lowercase", [True, False])
def test_word_encode_batch_matches_jax(np_rng, n_texts, lowercase):
    corpus = _sentences(np_rng, 60)
    tok = WordTokenizer(lowercase=lowercase, max_vocab_size=8).fit(corpus)
    jax_tok = JaxWordTokenizer(lowercase=lowercase, max_vocab_size=8).fit(corpus)
    texts = _sentences(np_rng, n_texts) + ["unknownword APPLE", "", "apple " * 40]
    got = tok.encode_batch(texts, 10)
    np.testing.assert_array_equal(got, jax_tok.encode_batch(texts, 10))
    assert got.dtype == np.int32 and got.shape == (len(texts), 10)
    assert got[-3, 0] == WordTokenizer.UNK and not got[-2].any()


def test_word_native_core_matches_python_path(np_rng):
    """The native route (ASCII, punctuation stripped) against the Python
    route, text by text; non-ASCII batches stay on the Python route."""
    tok = WordTokenizer(max_vocab_size=9).fit(_sentences(np_rng, 50))
    texts = _sentences(np_rng, 80) + ["Grape,grape;GRAPE_x 123 a_b"]
    table = native.WordVocabTable(tok.word_to_index)
    python_rows = np.concatenate([tok.encode_batch(texts[i:i + 1], 16)
                                  for i in range(len(texts))])
    np.testing.assert_array_equal(native.word_encode_batch(texts, table, 16), python_rows)
    mixed = _sentences(np_rng, 70, ascii_only=False)
    jax_tok = JaxWordTokenizer(max_vocab_size=9).fit(_sentences(np.random.default_rng(0), 50))
    jax_tok.word_to_index = dict(tok.word_to_index)
    np.testing.assert_array_equal(tok.encode_batch(mixed, 16), jax_tok.encode_batch(mixed, 16))


def test_word_state_dict_round_trip(np_rng):
    corpus = _sentences(np_rng, 30)
    jax_tok = JaxWordTokenizer(max_len=12, max_vocab_size=20, lowercase=False).fit(corpus)
    tok = WordTokenizer(max_len=12, max_vocab_size=20, lowercase=False).fit(corpus)
    assert tok.state_dict() == jax_tok.state_dict()
    again = tokenizer_from_state(jax_tok.state_dict())
    assert isinstance(again, WordTokenizer) and again.vocab_size == jax_tok.vocab_size
    assert again.decode(again.encode("apple zzz")) == jax_tok.decode(jax_tok.encode("apple zzz"))
    np.testing.assert_array_equal(again(["apple fig"], 6), jax_tok(["apple fig"], 6))


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
