"""Seeds that are the same in every process.

Python's ``hash()`` of a string is salted per process (``PYTHONHASHSEED``),
so a seed taken from it, as the JAX package takes its pretrained fallback
table's and its hashed word vectors', changes from run to run. The port
derives those seeds from ``hashlib`` instead.
"""

from __future__ import annotations

import hashlib
from typing import Any


def stable_seed(*key: Any) -> int:
    """A seed in ``[0, 2**31)`` from ``repr(key)``, the same in every process."""
    digest = hashlib.sha256(repr(key).encode("utf-8")).digest()
    return int.from_bytes(digest[:8], "little") % (2**31)
