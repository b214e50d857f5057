"""Host-side tokenizers producing statically shaped id arrays (PAD=0)."""

from .base import PAD_ID, TOKENIZER_REGISTRY, BaseTokenizer, build_tokenizer
from .char import CharTokenizer
from .subword import BPETokenizer, WordPieceTokenizer
from .word import WordTokenizer


def tokenizer_from_state(state: dict) -> BaseTokenizer:
    """Rebuild any registered tokenizer from its ``state_dict()``."""
    kind = state.get("type", "char")
    return TOKENIZER_REGISTRY.get(kind).from_state_dict(state)


__all__ = [
    "PAD_ID",
    "TOKENIZER_REGISTRY",
    "BPETokenizer",
    "BaseTokenizer",
    "CharTokenizer",
    "WordPieceTokenizer",
    "WordTokenizer",
    "build_tokenizer",
    "tokenizer_from_state",
]
