"""Tiny name->factory registry used for configs, models and benchmarks."""

from __future__ import annotations

from typing import Callable, Dict, Generic, Iterator, TypeVar

T = TypeVar("T")


class Registry(Generic[T]):
    def __init__(self, kind: str):
        self.kind = kind
        self._entries: Dict[str, T] = {}

    def register(self, name: str) -> Callable[[T], T]:
        def deco(obj: T) -> T:
            if name in self._entries:
                raise KeyError(f"duplicate {self.kind} registration: {name!r}")
            self._entries[name] = obj
            return obj

        return deco

    def add(self, name: str, obj: T) -> None:
        if name in self._entries:
            raise KeyError(f"duplicate {self.kind} registration: {name!r}")
        self._entries[name] = obj

    def get(self, name: str) -> T:
        try:
            return self._entries[name]
        except KeyError:
            known = ", ".join(sorted(self._entries))
            raise KeyError(f"unknown {self.kind} {name!r}; known: {known}") from None

    def __contains__(self, name: str) -> bool:
        return name in self._entries

    def __iter__(self) -> Iterator[str]:
        return iter(sorted(self._entries))

    def names(self):
        return sorted(self._entries)
