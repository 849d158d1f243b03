"""MiniLSM — a real (if miniature) LSM-tree engine standing in for RocksDB.

Implements the pieces whose I/O the paper reasons about:
  * WAL (optional — PASV removes it) with group commit: one buffered write
    + one fsync per commit window instead of one fsync per record,
  * sorted in-memory memtable with a size threshold,
  * SSTable flush (L0), leveled compaction L0 -> L1 (fanout-triggered),
  * point gets (memtable, then SSTs newest-first) and merged range scans.

SSTables use a block-sparse layout: records are grouped into ~4KB blocks;
only the first key, offset, and length of each block stay in memory, plus a
bloom filter over all keys.  Point gets consult the bloom filter first (a
negative costs zero read bytes), then read exactly one block — served from
the engine-wide BlockCache when hot.  File handles persist across reads.

All file traffic goes through Metrics with per-category tags so write
amplification from WAL/flush/compaction is separately visible.

Copied from ``src/repro/core/minilsm.py``; only the import prefix differs.
"""
from __future__ import annotations

import os
import struct
from bisect import bisect_left, bisect_right
from typing import Dict, Iterator, List, Optional, Tuple

try:
    from sortedcontainers import SortedDict
except ImportError:  # container image lacks sortedcontainers
    from repro_torch.core.sorteddict import SortedDict

from repro_torch.core.cache import BlockCache, BloomFilter, next_namespace
from repro_torch.core.faultfs import fs_fsync, fs_open, fs_remove
from repro_torch.core.metrics import Metrics

_REC = struct.Struct("<HI")  # key_len, val_len

BLOCK_BYTES = 4 << 10        # target SSTable block size


class SSTable:
    def __init__(self, path: str, metrics: Metrics,
                 cache: Optional[BlockCache] = None):
        self.path = path
        self.metrics = metrics
        self.cache = cache
        self._cache_ns = next_namespace()
        # block-sparse index: first key / file offset / byte length per block
        self.block_keys: List[bytes] = []
        self.block_offs: List[int] = []
        self.block_lens: List[int] = []
        self.bloom: Optional[BloomFilter] = None
        self.n_records = 0
        self.size = 0
        self._f = None  # persistent read handle, opened lazily

    # ----------------------------------------------------------- building
    def _index_records(self, records: Iterator[Tuple[bytes, int]]):
        """Build the block index + bloom from (key, record_len) pairs laid
        out back-to-back from offset 0."""
        off = 0
        blk_len = 0
        for k, rlen in records:
            if blk_len == 0 or blk_len + rlen > BLOCK_BYTES:
                if blk_len:
                    self.block_lens.append(blk_len)
                self.block_keys.append(k)
                self.block_offs.append(off)
                blk_len = 0
            self.bloom.add(k)
            blk_len += rlen
            off += rlen
            self.n_records += 1
        if blk_len:
            self.block_lens.append(blk_len)
        self.size = off

    @staticmethod
    def write(path: str, items: List[Tuple[bytes, bytes]], metrics: Metrics,
              category: str, cache: Optional[BlockCache] = None,
              sync: bool = False) -> "SSTable":
        with fs_open(path, "wb") as f:    # ONE buffered write for the table
            sst = SSTable(path, metrics, cache)
            sst.bloom = BloomFilter(len(items))
            chunks = []
            lens = []
            for k, v in items:
                rec = _REC.pack(len(k), len(v)) + k + v
                chunks.append(rec)
                lens.append(len(rec))
            f.write(b"".join(chunks))
            if sync:   # durable before the WAL that covers it is truncated
                fs_fsync(f)
        sst._index_records(zip((k for k, _ in items), lens))
        metrics.on_write(category, sst.size)
        return sst

    @staticmethod
    def load(path: str, metrics: Metrics,
             cache: Optional[BlockCache] = None,
             chunk_bytes: int = 1 << 20) -> "SSTable":
        """Stream-decode the file in chunks (no whole-file buffer)."""
        sst = SSTable(path, metrics, cache)
        sst.bloom = BloomFilter(max(os.path.getsize(path) // 32, 64))
        def records():
            with open(path, "rb") as f:
                buf = b""
                while True:
                    chunk = f.read(chunk_bytes)
                    if not chunk and not buf:
                        return
                    buf += chunk
                    off = 0
                    while off + _REC.size <= len(buf):
                        klen, vlen = _REC.unpack_from(buf, off)
                        rlen = _REC.size + klen + vlen
                        if off + rlen > len(buf):
                            break
                        yield buf[off + _REC.size: off + _REC.size + klen], \
                            rlen
                        off += rlen
                    buf = buf[off:]
                    if not chunk:
                        return
        sst._index_records(records())
        return sst

    # -------------------------------------------------------------- reads
    def _read_block(self, i: int, category: str) -> bytes:
        if self.cache is not None:
            blk = self.cache.get(self._cache_ns, i)
            if blk is not None:
                self.metrics.on_cache_hit(category)
                return blk
        if self._f is None:
            self._f = open(self.path, "rb")
        self._f.seek(self.block_offs[i])
        blk = self._f.read(self.block_lens[i])
        self.metrics.on_read(category, len(blk))
        if self.cache is not None:
            self.cache.put(self._cache_ns, i, blk)
        return blk

    @staticmethod
    def _iter_block(blk: bytes) -> Iterator[Tuple[bytes, bytes]]:
        off = 0
        while off + _REC.size <= len(blk):
            klen, vlen = _REC.unpack_from(blk, off)
            k = blk[off + _REC.size: off + _REC.size + klen]
            v = blk[off + _REC.size + klen: off + _REC.size + klen + vlen]
            yield k, v
            off += _REC.size + klen + vlen

    def get(self, key: bytes) -> Optional[bytes]:
        if not self.block_keys:
            return None
        if self.bloom is not None and key not in self.bloom:
            self.metrics.on_bloom_skip()    # negative: ZERO read bytes
            return None
        i = bisect_right(self.block_keys, key) - 1
        if i < 0:
            return None
        for k, v in self._iter_block(self._read_block(i, "sst_point")):
            if k == key:
                return v
        return None                          # bloom false positive

    def range(self, lo: bytes, hi: bytes) -> Iterator[Tuple[bytes, bytes]]:
        if not self.block_keys or lo > hi:
            return
        i = max(bisect_right(self.block_keys, lo) - 1, 0)
        j = bisect_right(self.block_keys, hi)
        for b in range(i, j):
            for k, v in self._iter_block(self._read_block(b, "sst_range")):
                if lo <= k <= hi:
                    yield k, v

    def items(self) -> Iterator[Tuple[bytes, bytes]]:
        """Sequential full-table read (compaction path) — one big read,
        bypassing the block cache so scans don't evict hot point blocks."""
        if not self.block_keys:
            return
        if self._f is None:
            self._f = open(self.path, "rb")
        self._f.seek(0)
        buf = self._f.read(self.size)
        self.metrics.on_read("sst_range", len(buf))
        yield from self._iter_block(buf)

    def delete(self):
        if self._f is not None:
            self._f.close()
            self._f = None
        if self.cache is not None:
            self.cache.invalidate(self._cache_ns)
        fs_remove(self.path)

    def close(self):
        if self._f is not None:
            self._f.close()
            self._f = None


class MiniLSM:
    def __init__(self, dirpath: str, metrics: Metrics, *, wal: bool = True,
                 memtable_limit: int = 1 << 22, l0_limit: int = 4,
                 name: str = "lsm", sync: bool = False,
                 group_commit: bool = False,
                 cache: Optional[BlockCache] = None):
        self.dir = dirpath
        os.makedirs(dirpath, exist_ok=True)
        self.metrics = metrics
        self.wal_enabled = wal
        self.memtable_limit = memtable_limit
        self.l0_limit = l0_limit
        self.name = name
        self.sync = sync
        self.group_commit = group_commit
        self.cache = cache
        self.mem: SortedDict = SortedDict()
        self.mem_bytes = 0
        self.l0: List[SSTable] = []
        self.l1: List[SSTable] = []
        self._sst_seq = 0
        self._wal_path = os.path.join(dirpath, "wal.log")
        self._wal = fs_open(self._wal_path, "ab") if wal else None
        self._wal_dirty = False
        self.compaction_count = 0

    # ------------------------------------------------------------- writes
    def _wal_write(self, data: bytes):
        self._wal.write(data)
        self._wal_dirty = True
        if self.sync and not self.group_commit:
            self.sync_wal()

    def put(self, key: bytes, value: bytes):
        if self._wal is not None:
            rec = _REC.pack(len(key), len(value)) + key + value
            self._wal_write(rec)
            self.metrics.on_write("wal", len(rec))
        self._mem_put(key, value)
        if self.mem_bytes >= self.memtable_limit:
            self.flush()

    def put_batch(self, items: List[Tuple[bytes, bytes]]):
        """Group commit: the whole batch becomes ONE buffered WAL write
        (and one fsync at the window boundary); per-record byte accounting
        is unchanged."""
        if self._wal is not None and items:
            recs = []
            for k, v in items:
                rec = _REC.pack(len(k), len(v)) + k + v
                recs.append(rec)
                self.metrics.on_write("wal", len(rec))
            self._wal_write(b"".join(recs))
        for k, v in items:
            self._mem_put(k, v)
        if self.mem_bytes >= self.memtable_limit:
            self.flush()

    def _mem_put(self, key: bytes, value: bytes):
        old = self.mem.get(key)
        self.mem[key] = value
        self.mem_bytes += len(key) + len(value) - \
            (len(key) + len(old) if old is not None else 0)

    def sync_wal(self):
        """Commit-window boundary: one flush + fsync for all buffered WAL
        records since the last boundary."""
        if self._wal is None or not self._wal_dirty:
            return
        self._wal.flush()
        if self.sync:
            fs_fsync(self._wal)
            self.metrics.on_fsync("wal")
        self._wal_dirty = False

    def _truncate_wal(self):
        """Atomically drop all WAL records (memtable made durable): a single
        in-place truncate on the open append handle — no close/reopen."""
        if self._wal is None:
            return
        self._wal.flush()
        self._wal.truncate(0)
        self._wal_dirty = False

    def flush(self):
        if not self.mem:
            return
        path = os.path.join(self.dir, f"sst_{self._sst_seq:06d}.sst")
        self._sst_seq += 1
        self.l0.append(SSTable.write(path, list(self.mem.items()),
                                     self.metrics, "flush", self.cache,
                                     sync=self.sync))
        self.mem.clear()
        self.mem_bytes = 0
        self._truncate_wal()
        if len(self.l0) > self.l0_limit:
            self.compact()

    def compact(self):
        """Merge all of L0 with L1 into a fresh L1 (newest versions win)."""
        self.compaction_count += 1
        merged: SortedDict = SortedDict()
        for sst in self.l1 + self.l0:  # oldest first; newer overwrite
            self.metrics.on_read("compaction", sst.size)
            for k, v in sst.items():
                merged[k] = v
        path = os.path.join(self.dir, f"sst_{self._sst_seq:06d}.sst")
        self._sst_seq += 1
        new_l1 = SSTable.write(path, list(merged.items()), self.metrics,
                               "compaction", self.cache, sync=self.sync)
        for sst in self.l0 + self.l1:
            sst.delete()
        self.l0, self.l1 = [], [new_l1]

    # -------------------------------------------------------------- reads
    def get(self, key: bytes) -> Optional[bytes]:
        v = self.mem.get(key)
        if v is not None:
            return v
        for sst in reversed(self.l0):
            v = sst.get(key)
            if v is not None:
                return v
        for sst in self.l1:
            v = sst.get(key)
            if v is not None:
                return v
        return None

    def scan(self, lo: bytes, hi: bytes) -> List[Tuple[bytes, bytes]]:
        """Merged range scan [lo, hi]; newest version wins."""
        out: Dict[bytes, bytes] = {}
        for sst in self.l1:
            for k, v in sst.range(lo, hi):
                out[k] = v
        for sst in self.l0:
            for k, v in sst.range(lo, hi):
                out[k] = v
        i = self.mem.bisect_left(lo)
        j = self.mem.bisect_right(hi)
        for k in self.mem.keys()[i:j]:
            out[k] = self.mem[k]
        return sorted(out.items())

    def iterate_all(self) -> List[Tuple[bytes, bytes]]:
        return self.scan(b"", b"\xff" * 64)

    # ----------------------------------------------------------- recovery
    def recover(self) -> int:
        """Reload SSTs + replay WAL. Returns entries replayed.  Tolerates an
        empty-but-present WAL file (post-flush truncate leaves one)."""
        self.l0, self.l1 = [], []
        ssts = sorted(f for f in os.listdir(self.dir) if f.endswith(".sst"))
        for f in ssts:
            sst = SSTable.load(os.path.join(self.dir, f), self.metrics,
                               self.cache)
            self.metrics.on_read("recover_sst", sst.size)
            self.l0.append(sst)
        if ssts:  # never reuse a live SSTable filename after restart
            self._sst_seq = max(int(f[4:10]) for f in ssts) + 1
        n = 0
        if self.wal_enabled and os.path.exists(self._wal_path):
            with open(self._wal_path, "rb") as f:
                buf = f.read()
            if buf:
                self.metrics.on_read("recover_wal", len(buf))
            off = 0
            while off + _REC.size <= len(buf):
                klen, vlen = _REC.unpack_from(buf, off)
                if off + _REC.size + klen + vlen > len(buf):
                    break  # torn tail
                k = buf[off + _REC.size: off + _REC.size + klen]
                v = buf[off + _REC.size + klen: off + _REC.size + klen + vlen]
                self.mem[k] = v
                self.mem_bytes += klen + vlen
                off += _REC.size + klen + vlen
                n += 1
            if off < len(buf):
                # cut the torn tail NOW: post-restart appends land after it
                # on the "ab" handle, and a later replay would stop here and
                # silently lose them
                self._wal.truncate(off)
        return n

    def total_disk_bytes(self) -> int:
        return sum(s.size for s in self.l0 + self.l1)

    def close(self):
        if self._wal is not None:
            self._wal.close()   # flushes buffered records, no fsync (as seed)
        for sst in self.l0 + self.l1:
            sst.close()

    def destroy(self):
        self.close()
        for sst in self.l0 + self.l1:
            sst.delete()
        fs_remove(self._wal_path)
