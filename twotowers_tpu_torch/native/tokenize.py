"""ctypes bindings for the native batch-tokenization core.

A copy of ``twotowers_tpu/native/tokenize.py`` with one change: the library
is built into the package's build directory (``kernels/build.py:BUILD_DIR``,
listed in ``.gitignore``), not next to its source. It compiles
``tokenizer_core.cpp`` on first use, rebuilds when the source is newer than
the library, and degrades gracefully: without a C++ compiler the caller
keeps its pure-Python path.

Word-vocab hashing: FNV-1a over the lowercased UTF-8 bytes, matched exactly
between this wrapper (which calls the C ``fnv1a64`` to build the table) and
the C encoder; collisions map distinct words to one id, at ~64-bit
improbability.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from pathlib import Path
from typing import Dict, Optional, Sequence

import numpy as np

from ..kernels.build import BUILD_DIR
from ..utils.logging import get_logger

logger = get_logger("native.tokenize")

_SRC = Path(__file__).parent / "tokenizer_core.cpp"
_SO = BUILD_DIR / "libtokenizer_core.so"
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_build_failed = False


def _build() -> bool:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = _SO.with_suffix(f".{os.getpid()}.tmp")
    for compiler in ("c++", "g++", "clang++"):
        try:
            subprocess.run(
                [compiler, "-O3", "-march=native", "-shared", "-fPIC",
                 str(_SRC), "-o", str(tmp)],
                check=True, capture_output=True, timeout=120,
            )
        except FileNotFoundError:
            continue
        except subprocess.CalledProcessError as exc:
            logger.warning("native tokenizer build failed with %s: %s",
                           compiler, exc.stderr.decode()[:500])
            return False
        os.replace(tmp, _SO)  # atomic: no process loads a half-written file
        return True
    logger.warning("no C++ compiler found; native tokenizer unavailable")
    return False


def get_lib() -> Optional[ctypes.CDLL]:
    """Load (building if needed) the native core; None when unavailable."""
    global _lib, _build_failed
    with _lock:
        if _lib is not None:
            return _lib
        if _build_failed:
            return None
        if not _SO.exists() or _SO.stat().st_mtime < _SRC.stat().st_mtime:
            if not _build():
                _build_failed = True
                return None
        try:
            lib = ctypes.CDLL(str(_SO))
        except OSError as exc:
            logger.warning("failed to load native tokenizer: %s", exc)
            _build_failed = True
            return None
        lib.char_encode_batch.argtypes = [
            ctypes.POINTER(ctypes.c_uint32), ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int64, ctypes.POINTER(ctypes.c_int32), ctypes.c_int64,
            ctypes.c_int64, ctypes.POINTER(ctypes.c_int32),
        ]
        lib.char_encode_batch.restype = None
        lib.word_encode_batch.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int64, ctypes.POINTER(ctypes.c_uint64),
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int64, ctypes.c_int32,
            ctypes.c_int64, ctypes.c_int, ctypes.POINTER(ctypes.c_int32),
        ]
        lib.word_encode_batch.restype = None
        lib.fnv1a64.argtypes = [ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64]
        lib.fnv1a64.restype = ctypes.c_uint64
        _lib = lib
        return _lib


def available() -> bool:
    return get_lib() is not None


def _ptr(array: np.ndarray, ctype):
    return array.ctypes.data_as(ctypes.POINTER(ctype))


def char_encode_batch(texts: Sequence[str], lut: np.ndarray, max_len: int) -> Optional[np.ndarray]:
    """Native char encoding; None if the core is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    joined = "".join(texts)
    codepoints = np.frombuffer(joined.encode("utf-32-le"), dtype=np.uint32)
    offsets = np.zeros(len(texts) + 1, dtype=np.int64)
    np.cumsum([len(t) for t in texts], out=offsets[1:])
    out = np.empty((len(texts), max_len), dtype=np.int32)
    lut = np.ascontiguousarray(lut, dtype=np.int32)
    lib.char_encode_batch(
        _ptr(codepoints, ctypes.c_uint32), _ptr(offsets, ctypes.c_int64),
        len(texts), _ptr(lut, ctypes.c_int32), len(lut), max_len,
        _ptr(out, ctypes.c_int32),
    )
    return out


class WordVocabTable:
    """Open-addressing (hash, id) table shared with the C encoder."""

    def __init__(self, word_to_index: Dict[str, int]):
        lib = get_lib()
        if lib is None:
            raise RuntimeError("native core unavailable")
        n = max(len(word_to_index), 1)
        capacity = 1
        while capacity < 2 * n:
            capacity *= 2
        self.capacity = capacity
        self.hashes = np.zeros(capacity, dtype=np.uint64)
        self.ids = np.zeros(capacity, dtype=np.int32)
        mask = capacity - 1
        for word, idx in word_to_index.items():
            if word in ("<PAD>", "<UNK>"):
                continue
            data = np.frombuffer(word.encode("utf-8"), dtype=np.uint8)
            if len(data) > 256:
                data = data[:256]
            h = int(lib.fnv1a64(_ptr(np.ascontiguousarray(data), ctypes.c_uint8),
                                len(data))) or 1
            slot = h & mask
            while self.hashes[slot] != 0 and self.hashes[slot] != h:
                slot = (slot + 1) & mask
            self.hashes[slot] = h
            self.ids[slot] = idx


def word_encode_batch(
    texts: Sequence[str], table: WordVocabTable, max_len: int,
    *, unk_id: int = 1, lowercase: bool = True,
) -> Optional[np.ndarray]:
    """Native word encoding; None if the core is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    encoded = [t.encode("utf-8") for t in texts]
    joined = b"".join(encoded)
    utf8 = np.frombuffer(joined, dtype=np.uint8)
    offsets = np.zeros(len(texts) + 1, dtype=np.int64)
    np.cumsum([len(e) for e in encoded], out=offsets[1:])
    out = np.empty((len(texts), max_len), dtype=np.int32)
    lib.word_encode_batch(
        _ptr(utf8 if len(utf8) else np.zeros(1, np.uint8), ctypes.c_uint8),
        _ptr(offsets, ctypes.c_int64), len(texts),
        _ptr(table.hashes, ctypes.c_uint64), _ptr(table.ids, ctypes.c_int32),
        table.capacity, unk_id, max_len, int(lowercase),
        _ptr(out, ctypes.c_int32),
    )
    return out
