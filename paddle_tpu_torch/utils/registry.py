"""String -> factory registry (analog of paddle/utils/ClassRegistrar.h).
Counterpart of ``paddle_tpu/utils/registry.py``."""

from __future__ import annotations

from typing import Dict, Generic, TypeVar

T = TypeVar("T")


class Registry(Generic[T]):
    def __init__(self, kind: str):
        self.kind = kind
        self._entries: Dict[str, T] = {}

    def register(self, name: str, obj: T):
        if name in self._entries:
            raise KeyError(f"duplicate {self.kind} registration: {name!r}")
        self._entries[name] = obj
        return obj

    def get(self, name: str) -> T:
        if name not in self._entries:
            raise KeyError(
                f"unknown {self.kind} {name!r}; known: {sorted(self._entries)}")
        return self._entries[name]

    def __contains__(self, name: str) -> bool:
        return name in self._entries

    def names(self):
        return sorted(self._entries)
