"""Read-path caching primitives shared across the storage stack.

  * BloomFilter — per-SSTable membership filter so point gets skip files
    that cannot contain the key (zero read bytes on a negative).
  * BlockCache  — a small shared LRU of (namespace, block) -> bytes used by
    SSTable blocks, SortedStore point records, and ValueLog offset reads.
    One cache per engine: hot blocks of every layer compete for the same
    budget, mirroring how a real block cache sits below the whole engine.

Namespaces make invalidation cheap: every cached file owner draws a token
from `next_namespace()` and bumps it when its bytes change (truncate,
rewrite, delete), abandoning stale entries without scanning the LRU.

Copied from ``src/repro/core/cache.py``; only the import prefix differs.
"""
from __future__ import annotations

import itertools
import zlib
from collections import OrderedDict
from typing import Dict, Optional, Tuple

_NS_COUNTER = itertools.count(1)


def next_namespace() -> int:
    """Process-unique token identifying one immutable version of a file."""
    return next(_NS_COUNTER)


class BloomFilter:
    """Split-hash bloom filter over byte keys (~1% fp at 10 bits/key).
    Bits live in a bytearray so add() is O(k), not O(filter_size)."""

    def __init__(self, n_items: int, bits_per_key: int = 10, n_hashes: int = 7):
        self.m = max(64, n_items * bits_per_key)
        self.k = n_hashes
        self._bits = bytearray((self.m + 7) // 8)

    @classmethod
    def from_keys(cls, keys, bits_per_key: int = 10,
                  n_hashes: int = 7) -> "BloomFilter":
        """Build a filter sized for `keys` (per-sorted-run point-get gate:
        a negative membership test skips the run with zero I/O)."""
        keys = list(keys)
        bf = cls(len(keys), bits_per_key, n_hashes)
        for k in keys:
            bf.add(k)
        return bf

    def _probes(self, key: bytes):
        h1 = zlib.crc32(key)
        h2 = zlib.adler32(key) | 1      # odd => cycles through all slots
        for i in range(self.k):
            yield (h1 + i * h2) % self.m

    def add(self, key: bytes):
        for p in self._probes(key):
            self._bits[p >> 3] |= 1 << (p & 7)

    def __contains__(self, key: bytes) -> bool:
        bits = self._bits
        return all(bits[p >> 3] & (1 << (p & 7)) for p in self._probes(key))


class BlockCache:
    """Byte-budgeted LRU keyed by (namespace, block_id)."""

    def __init__(self, capacity_bytes: int = 2 << 20,
                 max_entry_bytes: Optional[int] = None):
        self.capacity = capacity_bytes
        self.max_entry = max_entry_bytes or max(capacity_bytes // 8, 4096)
        self._lru: "OrderedDict[Tuple[int, int], bytes]" = OrderedDict()
        self._bytes = 0
        self.hits = 0
        self.misses = 0

    def get(self, ns: int, block_id: int) -> Optional[bytes]:
        key = (ns, block_id)
        data = self._lru.get(key)
        if data is None:
            self.misses += 1
            return None
        self._lru.move_to_end(key)
        self.hits += 1
        return data

    def put(self, ns: int, block_id: int, data: bytes):
        if len(data) > self.max_entry:
            return
        key = (ns, block_id)
        old = self._lru.pop(key, None)
        if old is not None:
            self._bytes -= len(old)
        self._lru[key] = data
        self._bytes += len(data)
        while self._bytes > self.capacity and self._lru:
            _, evicted = self._lru.popitem(last=False)
            self._bytes -= len(evicted)

    def invalidate(self, ns: int):
        """Drop every entry of one namespace (file truncated/rewritten)."""
        stale = [k for k in self._lru if k[0] == ns]
        for k in stale:
            self._bytes -= len(self._lru.pop(k))

    @property
    def size_bytes(self) -> int:
        return self._bytes

    def stats(self) -> Dict[str, int]:
        return {"hits": self.hits, "misses": self.misses,
                "bytes": self._bytes, "entries": len(self._lru)}
