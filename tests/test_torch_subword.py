"""The port's BPE and WordPiece tokenizers against the JAX package's.

Both packages fit on the same corpus, drawn from a numpy seed; merge
tables, vocabularies, ids, decoded texts and ``state_dict``s must be equal,
and each package must rebuild the other's tokenizer from its state.
"""

import numpy as np
import pytest

from twotowers_tpu.tokenizers import BPETokenizer as JaxBPE
from twotowers_tpu.tokenizers import WordPieceTokenizer as JaxWordPiece
from twotowers_tpu.tokenizers import build_tokenizer as jax_build_tokenizer
from twotowers_tpu.tokenizers.subword import _apply_merges as jax_apply_merges
from twotowers_tpu.tokenizers.subword import learn_bpe_merges as jax_learn_bpe_merges
from twotowers_tpu_torch.tokenizers import (
    BPETokenizer, WordPieceTokenizer, build_tokenizer, tokenizer_from_state)
from twotowers_tpu_torch.tokenizers.subword import _apply_merges, learn_bpe_merges
from twotowers_tpu_torch.train.pipeline import build_tokenizer_from_config

SYLLABLES = ["th", "e", "an", "ing", "er", "qu", "ick", "br", "ow", "n", "fo", "x",
             "Caf", "é", "zz", "9", "ion", "st"]


def _words(rng, n):
    return ["".join(rng.choice(SYLLABLES, size=rng.integers(1, 5))) for _ in range(n)]


def _corpus(rng, n_texts=60):
    vocab = _words(rng, 80)
    return [" ".join(rng.choice(vocab, size=rng.integers(1, 12))) + rng.choice(["", ".", "!"])
            for _ in range(n_texts)]


def _counts(corpus, lowercase=True):
    from collections import Counter

    from twotowers_tpu_torch.tokenizers.subword import _pretokenize

    counts = Counter()
    for text in corpus:
        counts.update(_pretokenize(text, lowercase))
    return counts


@pytest.mark.parametrize("num_merges", [0, 7, 60, 2000])
def test_learn_bpe_merges_matches_jax(np_rng, num_merges):
    counts = _counts(_corpus(np_rng))
    got = learn_bpe_merges(counts, num_merges)
    assert got == jax_learn_bpe_merges(counts, num_merges)
    assert len(got) <= num_merges
    ranks = {p: i for i, p in enumerate(got)}
    for word in sorted(counts)[:40] + ["unseenword", "x"]:
        assert _apply_merges(word, ranks) == jax_apply_merges(word, ranks)


def test_merge_ties_go_to_the_lexicographically_smallest_pair():
    """Every pair here is seen twice, so the table follows pair order
    ("</w>" sorts before letters)."""
    from collections import Counter

    counts = Counter({"cd": 2, "ab": 2, "ba": 2})
    want = [("a", "</w>"), ("a", "b"), ("ab", "</w>"), ("b", "a</w>"), ("c", "d")]
    assert learn_bpe_merges(counts, 5) == jax_learn_bpe_merges(counts, 5) == want


@pytest.mark.parametrize("lowercase", [True, False])
@pytest.mark.parametrize("num_merges,max_vocab_size", [(40, None), (400, None), (400, 30)])
def test_bpe_matches_jax(np_rng, lowercase, num_merges, max_vocab_size):
    corpus = _corpus(np_rng)
    kw = dict(num_merges=num_merges, lowercase=lowercase, max_len=16,
              max_vocab_size=max_vocab_size)
    tok, jax_tok = BPETokenizer(**kw).fit(corpus), JaxBPE(**kw).fit(corpus)
    assert tok.merges == jax_tok.merges
    assert tok.token_to_id == jax_tok.token_to_id and tok.vocab_size == jax_tok.vocab_size
    assert tok.is_fitted and tok.state_dict() == jax_tok.state_dict()
    held_out = _corpus(np.random.default_rng(1), 20) + ["", "ÜNSEEN wörds 42", "x"]
    for text in held_out:
        assert tok.encode(text) == jax_tok.encode(text)
        assert tok.decode(tok.encode(text)) == jax_tok.decode(jax_tok.encode(text))
    np.testing.assert_array_equal(tok(held_out, 16), jax_tok(held_out, 16))
    assert tok(held_out, 16).dtype == np.int32


@pytest.mark.parametrize("lowercase", [True, False])
@pytest.mark.parametrize("num_merges,max_vocab_size", [(40, None), (400, None), (400, 30)])
def test_wordpiece_matches_jax(np_rng, lowercase, num_merges, max_vocab_size):
    corpus = _corpus(np_rng)
    kw = dict(num_merges=num_merges, lowercase=lowercase, max_len=16,
              max_vocab_size=max_vocab_size, max_word_chars=12)
    tok, jax_tok = WordPieceTokenizer(**kw).fit(corpus), JaxWordPiece(**kw).fit(corpus)
    assert tok.token_to_id == jax_tok.token_to_id and tok.vocab_size == jax_tok.vocab_size
    assert tok.state_dict() == jax_tok.state_dict()
    held_out = _corpus(np.random.default_rng(2), 20) + [
        "", "qqqq unmatchable", "thequickbrownfoxthequick", "Café"]
    for text in held_out:
        assert tok.encode(text) == jax_tok.encode(text)
        assert tok.decode(tok.encode(text)) == jax_tok.decode(jax_tok.encode(text))
    np.testing.assert_array_equal(tok(held_out, 16), jax_tok(held_out, 16))


@pytest.mark.parametrize("kind", ["bpe", "wordpiece"])
def test_tokenizer_from_state_rebuilds_subword_tokenizers(np_rng, kind):
    """A checkpoint's tokenizer state, from either package, rebuilds the
    same tokenizer in the other."""
    corpus = _corpus(np_rng)
    jax_tok = jax_build_tokenizer(kind, num_merges=80, max_len=12).fit(corpus)
    tok = tokenizer_from_state(jax_tok.state_dict())
    assert type(tok) is {"bpe": BPETokenizer, "wordpiece": WordPieceTokenizer}[kind]
    assert tok.state_dict() == jax_tok.state_dict()
    back = type(jax_tok).from_state_dict(build_tokenizer(kind, num_merges=80, max_len=12)
                                         .fit(corpus).state_dict())
    texts = corpus[:10] + ["never seen"]
    np.testing.assert_array_equal(tok(texts, 12), jax_tok(texts, 12))
    np.testing.assert_array_equal(back(texts, 12), jax_tok(texts, 12))


def test_subword_tokenizer_from_config():
    config = {"tokeniser": {"type": "bpe", "max_len": 48, "num_merges": 2000}}
    tok = build_tokenizer_from_config(config)
    assert isinstance(tok, BPETokenizer) and tok.num_merges == 2000 and tok.max_len == 48
    assert not tok.is_fitted and tok.vocab_size == 2
