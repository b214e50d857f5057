"""Host-side tokenizers producing statically shaped id arrays (PAD=0)."""

from .base import PAD_ID, TOKENIZER_REGISTRY, BaseTokenizer, build_tokenizer
from .char import CharTokenizer

# tokenizer types of the JAX package that this package has not ported yet
_NOT_PORTED = {"word", "bpe", "wordpiece"}


def tokenizer_from_state(state: dict) -> BaseTokenizer:
    """Rebuild a registered tokenizer from its ``state_dict()``."""
    kind = state.get("type", "char")
    if kind in _NOT_PORTED:
        raise NotImplementedError(
            f"tokenizer type {kind!r} is not ported yet (ROADMAP.md §1 item 2)"
        )
    return TOKENIZER_REGISTRY.get(kind).from_state_dict(state)


__all__ = [
    "PAD_ID",
    "TOKENIZER_REGISTRY",
    "BaseTokenizer",
    "CharTokenizer",
    "build_tokenizer",
    "tokenizer_from_state",
]
