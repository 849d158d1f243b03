"""Append-only ValueLog — the single persistence point of KVS-Raft.

Entry layout (little-endian):
    u32 magic | u32 term | u64 index | u8 kind | u16 key_len | u32 val_len
    key bytes | value bytes
The (term, index) consensus metadata is serialized WITH the value (paper
§III-B step 3): one append persists both the Raft log entry and the value.
``append`` returns the byte offset, which is the only thing the state machine
keeps.

Copied from ``src/repro/core/valuelog.py``; only the import prefix differs.
"""
from __future__ import annotations

import os
import struct
from dataclasses import dataclass
from typing import Iterator, List, Optional, Tuple

from repro_torch.core.cache import BlockCache, next_namespace
from repro_torch.core.faultfs import fs_fsync, fs_open, fs_remove
from repro_torch.core.metrics import Metrics

_HDR = struct.Struct("<IIQBHI")
MAGIC = 0x4E5A4841  # "NZHA"

KIND_PUT = 1
KIND_NOOP = 2
KIND_SNAP = 3
KIND_CONFIG = 4   # membership change entry: value = JSON {voters, learners}


@dataclass
class LogEntry:
    term: int
    index: int
    kind: int
    key: bytes
    value: bytes

    def encode(self) -> bytes:
        return _HDR.pack(MAGIC, self.term, self.index, self.kind,
                         len(self.key), len(self.value)) + self.key + self.value

    @staticmethod
    def decode(buf: bytes, off: int = 0) -> Tuple["LogEntry", int]:
        magic, term, index, kind, klen, vlen = _HDR.unpack_from(buf, off)
        assert magic == MAGIC, f"corrupt entry at {off}"
        s = off + _HDR.size
        key = buf[s:s + klen]
        value = buf[s + klen:s + klen + vlen]
        return LogEntry(term, index, kind, key, value), s + klen + vlen


class ValueLog:
    """Append-only file of LogEntry records with offset-addressed reads."""

    def __init__(self, path: str, metrics: Metrics, category: str = "valuelog",
                 sync: bool = False, group_commit: bool = False,
                 cache: Optional[BlockCache] = None):
        self.path = path
        self.metrics = metrics
        self.category = category
        self.sync = sync
        self.group_commit = group_commit
        self.cache = cache
        self._cache_ns = next_namespace()
        self._dirty = False
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._f = fs_open(path, "ab+")
        self._f.seek(0, os.SEEK_END)
        self._size = self._f.tell()

    # ------------------------------------------------------------- writes
    def append(self, entry: LogEntry) -> int:
        data = entry.encode()
        off = self._size
        self._f.write(data)
        self._size += len(data)
        self._dirty = True
        if self.sync and not self.group_commit:
            self.sync_now()
        self.metrics.on_write(self.category, len(data))
        return off

    def append_batch(self, entries: List[LogEntry]) -> List[int]:
        """Group commit: ONE buffered write (and, under sync, one fsync via
        sync_now at the commit-window boundary) for the whole batch.  Byte
        accounting stays per-record so write-amplification ratios are
        unchanged — only the fsync count drops."""
        offs: List[int] = []
        chunks: List[bytes] = []
        off = self._size
        for e in entries:
            data = e.encode()
            offs.append(off)
            chunks.append(data)
            off += len(data)
            self.metrics.on_write(self.category, len(data))
        if chunks:
            self._f.write(b"".join(chunks))
            self._size = off
            self._dirty = True
            if self.sync and not self.group_commit:
                self.sync_now()
        return offs

    def sync_now(self):
        """Commit-window boundary: flush + fsync once if anything is dirty."""
        if not self._dirty:
            return
        self._f.flush()
        if self.sync:
            fs_fsync(self._f)
            self.metrics.on_fsync(self.category)
        self._dirty = False

    def flush(self):
        self._f.flush()

    # -------------------------------------------------------------- reads
    def read_at(self, offset: int) -> LogEntry:
        if self.cache is not None:
            rec = self.cache.get(self._cache_ns, offset)
            if rec is not None:
                self.metrics.on_cache_hit(self.category)
                entry, _ = LogEntry.decode(rec, 0)
                return entry
        self._f.flush()
        # persistent handle: append-mode writes always land at EOF, so the
        # write handle doubles as the read handle (no per-read open())
        self._f.seek(offset)
        hdr = self._f.read(_HDR.size)
        magic, term, index, kind, klen, vlen = _HDR.unpack(hdr)
        assert magic == MAGIC, f"corrupt entry at {offset}"
        body = self._f.read(klen + vlen)
        self._f.seek(0, os.SEEK_END)
        self.metrics.on_read(self.category, _HDR.size + klen + vlen)
        if self.cache is not None:
            self.cache.put(self._cache_ns, offset, hdr + body)
        return LogEntry(term, index, kind, body[:klen], body[klen:])

    def read_value_at(self, offset: int) -> bytes:
        return self.read_at(offset).value

    def scan(self) -> Iterator[Tuple[int, LogEntry]]:
        """Sequential scan of (offset, entry) — recovery / GC path."""
        self._f.flush()
        with open(self.path, "rb") as f:
            buf = f.read()
        self.metrics.on_read(self.category + "_seq", len(buf))
        off = 0
        while off < len(buf):
            entry, nxt = LogEntry.decode(buf, off)
            yield off, entry
            off = nxt

    def scan_headers(self) -> Iterator[Tuple[int, LogEntry]]:
        """Header-only scan: seeks past values (KVS-Raft recovery — the
        state machine replays (key, offset) pairs, so values need never be
        read; this is the mechanism behind the paper's Fig. 11 win).
        Yielded entries carry value=b'' and must be hydrated via read_at()
        before being shipped to a follower."""
        self._f.flush()
        with open(self.path, "rb") as f:
            off = 0
            while True:
                hdr = f.read(_HDR.size)
                if len(hdr) < _HDR.size:
                    break
                magic, term, index, kind, klen, vlen = _HDR.unpack(hdr)
                assert magic == MAGIC, f"corrupt entry at {off}"
                key = f.read(klen)
                f.seek(vlen, os.SEEK_CUR)
                self.metrics.on_read(self.category + "_hdr",
                                     _HDR.size + klen)
                e = LogEntry(term, index, kind, key, b"")
                e.value_len = vlen  # type: ignore[attr-defined]
                yield off, e
                off += _HDR.size + klen + vlen

    def repair_tail(self) -> int:
        """Crash hygiene: drop torn/corrupt trailing bytes.  Must run before
        any recovery scan — scan()/scan_headers() assert on magic.  Safe by
        the durability contract: with sync=True every acked entry was
        fsynced before the ack, so a torn tail is by construction unacked.
        Returns the number of bytes dropped."""
        self._f.flush()
        size = os.path.getsize(self.path)
        end = 0
        with open(self.path, "rb") as f:
            while True:
                hdr = f.read(_HDR.size)
                if len(hdr) < _HDR.size:
                    break
                magic, _, _, _, klen, vlen = _HDR.unpack(hdr)
                if magic != MAGIC:
                    break
                if end + _HDR.size + klen + vlen > size:
                    break
                f.seek(klen + vlen, os.SEEK_CUR)
                end += _HDR.size + klen + vlen
        dropped = size - end
        if dropped:
            self.truncate_to(end)
        else:
            self._size = size
        return dropped

    @property
    def size(self) -> int:
        return self._size

    def truncate_to(self, offset: int):
        """Drop the tail from `offset` (Raft conflict resolution)."""
        self._f.flush()
        self._f.truncate(offset)
        self._f.seek(0, os.SEEK_END)
        self._size = offset
        self._dirty = True
        if self.cache is not None:   # cached records past `offset` are stale
            self.cache.invalidate(self._cache_ns)
            self._cache_ns = next_namespace()

    def close(self):
        try:
            self._f.close()
        except Exception:
            pass

    def delete(self):
        self.close()
        if self.cache is not None:
            self.cache.invalidate(self._cache_ns)
        fs_remove(self.path)
