"""Minimal pure-Python SortedDict — fallback for `sortedcontainers`.

The container image does not ship `sortedcontainers`; MiniLSM only needs a
small slice of its API (sorted iteration, bisect on keys, indexable key
view), so this drop-in keeps the engine importable everywhere.  When the
real package is installed it is preferred (see minilsm.py).

Copied from ``src/repro/core/sorteddict.py``; only the import prefix differs.
"""
from __future__ import annotations

from bisect import bisect_left, bisect_right, insort
from typing import Any, Iterator, List, Tuple


class SortedDict:
    """dict + sorted key list; O(n) insert for new keys, fine at repro scale."""

    def __init__(self):
        self._d: dict = {}
        self._keys: List[Any] = []

    # ----------------------------------------------------------- mutation
    def __setitem__(self, key, value):
        if key not in self._d:
            insort(self._keys, key)
        self._d[key] = value

    def __delitem__(self, key):
        del self._d[key]
        i = bisect_left(self._keys, key)
        del self._keys[i]

    def clear(self):
        self._d.clear()
        self._keys.clear()

    # ------------------------------------------------------------- lookup
    def __getitem__(self, key):
        return self._d[key]

    def get(self, key, default=None):
        return self._d.get(key, default)

    def __contains__(self, key) -> bool:
        return key in self._d

    def __len__(self) -> int:
        return len(self._d)

    def __bool__(self) -> bool:
        return bool(self._d)

    def __iter__(self) -> Iterator:
        return iter(self._keys)

    # ------------------------------------------------- sorted-view extras
    def keys(self) -> List[Any]:
        return self._keys

    def items(self) -> List[Tuple[Any, Any]]:
        return [(k, self._d[k]) for k in self._keys]

    def values(self) -> List[Any]:
        return [self._d[k] for k in self._keys]

    def bisect_left(self, key) -> int:
        return bisect_left(self._keys, key)

    def bisect_right(self, key) -> int:
        return bisect_right(self._keys, key)
