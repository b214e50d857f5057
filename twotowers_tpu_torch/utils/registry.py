"""Small named-registry helper used by every pipeline stage.

A copy of ``twotowers_tpu/utils/registry.py``: one reusable class so each
stage gets uniform error messages and a decorator-based registration API.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Iterable


class Registry:
    """A name -> factory mapping with decorator registration."""

    def __init__(self, kind: str):
        self.kind = kind
        self._entries: Dict[str, Any] = {}

    def register(self, name: str) -> Callable[[Any], Any]:
        def deco(obj: Any) -> Any:
            if name in self._entries:
                raise ValueError(f"Duplicate {self.kind} registration: {name!r}")
            self._entries[name] = obj
            return obj
        return deco

    def add(self, name: str, obj: Any) -> None:
        self.register(name)(obj)

    def get(self, name: str) -> Any:
        if name not in self._entries:
            raise ValueError(
                f"Unknown {self.kind}: {name!r}. Available options: {sorted(self._entries)}"
            )
        return self._entries[name]

    def build(self, name: str, **kwargs: Any) -> Any:
        return self.get(name)(**kwargs)

    def names(self) -> Iterable[str]:
        return sorted(self._entries)

    def __contains__(self, name: str) -> bool:
        return name in self._entries
