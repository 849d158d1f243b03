"""Storage modules of Nezha's adaptive storage management (paper §III-C).

  * StorageModule   — Active / New: a ValueLog (raft entries incl. values,
                      appended once) + a MiniLSM index of key -> offset.
  * SortedStore     — one immutable key-sorted ValueLog + hash index +
                      per-run bloom filter + (last_index, last_term) Raft
                      boundary.  Supports crash-resume (last key written =
                      interrupt point, paper §III-E).
  * SortedRun       — a SortedStore living inside the leveled hierarchy
                      (run id + level instead of a generation number).
  * LeveledStore    — the leveled-GC run hierarchy: GC of the active
                      segment seals a new L0 run (bounded work per cycle);
                      a level holding `fanout` runs merges into one run on
                      the next level.  Membership + Raft boundaries live in
                      an atomically-replaced manifest, so crash recovery
                      and InstallSnapshot semantics hold across any number
                      of runs.
  * kway_merge_newest_wins — streaming heap merge over key-ascending
                      sources with newest-wins dedup (the scan read path).

Copied from ``src/repro/core/storage.py``; only the import prefix differs.
"""
from __future__ import annotations

import heapq
import json
import os
import struct
from bisect import bisect_left, bisect_right
from typing import Dict, Iterator, List, Optional, Tuple

from repro_torch.core.cache import BlockCache, BloomFilter, next_namespace
from repro_torch.core.faultfs import (fs_fsync, fs_fsync_path, fs_open, fs_remove,
                                write_json_atomic)
from repro_torch.core.metrics import Metrics
from repro_torch.core.minilsm import MiniLSM
from repro_torch.core.valuelog import KIND_PUT, LogEntry, ValueLog, _HDR

_OFF = struct.Struct("<Q")


def pack_offset(off: int) -> bytes:
    return _OFF.pack(off)


def unpack_offset(b: bytes) -> int:
    return _OFF.unpack(b)[0]


class StorageModule:
    """ValueLog + lightweight key->offset index (the paper's 'RocksDB')."""

    def __init__(self, dirpath: str, metrics: Metrics, tag: str,
                 sync: bool = False, group_commit: bool = False,
                 cache: Optional[BlockCache] = None):
        self.dir = dirpath
        self.tag = tag
        self.metrics = metrics
        self.vlog = ValueLog(os.path.join(dirpath, f"valuelog_{tag}.log"),
                             metrics, category="valuelog", sync=sync,
                             group_commit=group_commit, cache=cache)
        self.db = MiniLSM(os.path.join(dirpath, f"db_{tag}"), metrics,
                          wal=True, name=f"db_{tag}", sync=sync,
                          group_commit=group_commit, cache=cache)

    def apply(self, entry: LogEntry, offset: int):
        """State-machine apply: store ONLY the offset (Algorithm 1 line 7)."""
        self.db.put(entry.key, pack_offset(offset))

    def apply_batch(self, pairs: List[Tuple[LogEntry, int]]):
        """Group apply: all offset records become one buffered WAL write."""
        self.db.put_batch([(e.key, pack_offset(off)) for e, off in pairs])

    def sync_now(self):
        """Commit-window boundary: one fsync each for vlog + index WAL."""
        self.vlog.sync_now()
        self.db.sync_wal()

    def get_offset(self, key: bytes) -> Optional[int]:
        v = self.db.get(key)
        return None if v is None else unpack_offset(v)

    def read_value(self, offset: int) -> bytes:
        return self.vlog.read_value_at(offset)

    def get(self, key: bytes) -> Optional[bytes]:
        off = self.get_offset(key)
        return None if off is None else self.read_value(off)

    def scan(self, lo: bytes, hi: bytes) -> List[Tuple[bytes, bytes]]:
        """Range scan: sorted key->offset pairs then scattered value reads."""
        return list(self.scan_iter(lo, hi))

    def scan_iter(self, lo: bytes, hi: bytes) -> Iterator[Tuple[bytes, bytes]]:
        """Key-ascending stream; values are fetched lazily per item so a
        k-way merge that drops a superseded key pays for it only once."""
        for k, v in self.db.scan(lo, hi):
            yield k, self.read_value(unpack_offset(v))

    def sorted_items(self) -> Iterator[Tuple[bytes, int]]:
        for k, v in self.db.iterate_all():
            yield k, unpack_offset(v)

    def destroy(self):
        self.vlog.delete()
        self.db.destroy()

    def close(self):
        self.vlog.close()
        self.db.close()


class SortedStore:
    """One immutable key-ordered ValueLog + hash index + bloom filter +
    snapshot metadata.  A range scan costs one seek + sequential bytes."""

    # stream-decode chunk size: bounds memory on the recovery/GC paths
    CHUNK_BYTES = 1 << 20

    def __init__(self, dirpath: str, metrics: Metrics, gen: int = 0,
                 cache: Optional[BlockCache] = None,
                 name: Optional[str] = None):
        self.dir = dirpath
        os.makedirs(dirpath, exist_ok=True)
        self.metrics = metrics
        self.gen = gen
        self.cache = cache
        self._cache_ns = next_namespace()
        stem = name if name is not None else f"sorted_{gen:04d}"
        self.path = os.path.join(dirpath, f"{stem}.log")
        self.meta_path = os.path.join(dirpath, f"{stem}.meta")
        self.index: Dict[bytes, Tuple[int, int]] = {}  # key -> (off, len)
        self.keys: List[bytes] = []                    # sorted
        self.bloom: Optional[BloomFilter] = None       # point-get gate
        self.last_index = 0
        self.last_term = 0
        self._complete = False
        self._rf = None   # persistent read handle, opened lazily

    def _reset_read_state(self):
        """File bytes changed (build/install/destroy): drop handle + cache."""
        if self._rf is not None:
            self._rf.close()
            self._rf = None
        if self.cache is not None:
            self.cache.invalidate(self._cache_ns)
            self._cache_ns = next_namespace()

    def _stream_records(self, category: Optional[str] = None
                        ) -> Iterator[Tuple[int, LogEntry]]:
        """Chunked sequential decode of (offset, entry); never materializes
        the whole file.  Bytes consumed are accounted to `category` exactly
        as the old whole-file read was (same totals, chunked ops)."""
        if not os.path.exists(self.path):
            return
        with open(self.path, "rb") as f:
            buf = b""
            base = 0          # file offset of buf[0]
            while True:
                chunk = f.read(self.CHUNK_BYTES)
                if chunk and category is not None:
                    self.metrics.on_read(category, len(chunk))
                if not chunk and not buf:
                    return
                buf += chunk
                off = 0
                while off + _HDR.size <= len(buf):
                    _, _, _, _, klen, vlen = _HDR.unpack_from(buf, off)
                    rlen = _HDR.size + klen + vlen
                    if off + rlen > len(buf):
                        break
                    entry, _ = LogEntry.decode(buf, off)
                    yield base + off, entry
                    off += rlen
                base += off
                buf = buf[off:]
                if not chunk:
                    return  # EOF; leftover buf is a torn tail, tolerated

    # --------------------------------------------------------------- build
    def build(self, items: Iterator[Tuple[bytes, LogEntry]],
              last_index: int, last_term: int):
        """One-shot build: write key-ascending entries and seal."""
        self._reset_read_state()
        fs_open(self.path, "wb").close()    # fresh file
        self.index.clear()
        self.keys = []
        self.append_items(items, "gc_sorted")
        self.seal(last_index, last_term)

    def append_items(self, items, category: str) -> int:
        """Incremental build: append encoded entries (key-ascending),
        maintaining index/keys.  Returns bytes written.  Shared by the GC
        flush and level-merge paths so framing + accounting can't drift."""
        written = 0
        with fs_open(self.path, "ab") as f:
            off = f.tell()
            for key, entry in items:
                data = entry.encode()
                f.write(data)
                self.metrics.on_write(category, len(data))
                self.index[key] = (off, len(data))
                self.keys.append(key)
                off += len(data)
                written += len(data)
        return written

    def seal(self, last_index: int, last_term: int):
        """Mark the run complete: Raft boundary + bloom + durable meta.
        The data file is fsynced BEFORE the meta commits — a meta that says
        `complete` over a torn data file would survive kill -9 otherwise."""
        self.last_index = last_index
        self.last_term = last_term
        self.bloom = BloomFilter.from_keys(self.keys)
        self._complete = True
        if os.path.exists(self.path):
            fs_fsync_path(self.path)
        write_json_atomic(self.meta_path,
                          {"last_index": last_index, "last_term": last_term,
                           "complete": True})
        self.metrics.on_write("gc_meta", 64)

    def last_key_on_disk(self) -> Optional[bytes]:
        """Crash-resume support: stream the partial file for its last key
        (chunked — the old implementation slurped the whole file)."""
        last = None
        try:
            for _, entry in self._stream_records("gc_resume_scan"):
                last = entry.key
        except Exception:
            pass  # torn/corrupt tail: resume from the last good key
        return last

    def load_partial(self) -> Optional[bytes]:
        """Crash-resume: rebuild index/keys from a partially-built run with
        the bounded-memory stream, cutting off any torn tail record so the
        resumed build appends at a clean boundary.  Returns the last
        complete key (the interrupt point), or None if nothing landed."""
        self.index.clear()
        self.keys = []
        last = None
        valid_end = 0
        try:
            for off, entry in self._stream_records("gc_resume_scan"):
                rlen = _HDR.size + len(entry.key) + len(entry.value)
                self.index[entry.key] = (off, rlen)
                self.keys.append(entry.key)
                last = entry.key
                valid_end = off + rlen
        except Exception:
            pass  # corrupt tail: everything before it is still good
        if os.path.exists(self.path) and \
                os.path.getsize(self.path) > valid_end:
            with fs_open(self.path, "r+b") as f:
                f.truncate(valid_end)
        self._started = last is not None
        return last

    def load(self) -> bool:
        """Recovery: reload index from the sorted file + meta, streaming in
        CHUNK_BYTES pieces; byte totals match the old whole-file read."""
        if not os.path.exists(self.meta_path):
            return False
        if not os.path.exists(self.path):
            # meta without data = real loss; fail loudly (silently loading
            # an empty index would make every GC'd key vanish)
            raise FileNotFoundError(self.path)
        with open(self.meta_path) as f:
            meta = json.load(f)
        self.last_index = meta["last_index"]
        self.last_term = meta["last_term"]
        self.index.clear()
        self.keys = []
        for off, entry in self._stream_records("recover_sorted"):
            self.index[entry.key] = (
                off, _HDR.size + len(entry.key) + len(entry.value))
            self.keys.append(entry.key)
        self.bloom = BloomFilter.from_keys(self.keys)
        self._complete = True
        self._reset_read_state()
        return True

    # --------------------------------------------------------------- reads
    def get(self, key: bytes) -> Optional[bytes]:
        if self.bloom is not None and key not in self.bloom:
            self.metrics.on_bloom_skip()   # negative: zero I/O, zero probes
            return None
        loc = self.index.get(key)          # hash index: direct lookup
        if loc is None:
            return None
        if self.cache is not None:
            buf = self.cache.get(self._cache_ns, loc[0])
            if buf is not None:
                self.metrics.on_cache_hit("sorted_point")
                entry, _ = LogEntry.decode(buf, 0)
                return entry.value
        if self._rf is None:
            self._rf = open(self.path, "rb")
        self._rf.seek(loc[0])
        buf = self._rf.read(loc[1])
        self.metrics.on_read("sorted_point", len(buf))
        if self.cache is not None:
            self.cache.put(self._cache_ns, loc[0], buf)
        entry, _ = LogEntry.decode(buf, 0)
        return entry.value

    def scan(self, lo: bytes, hi: bytes) -> List[Tuple[bytes, bytes]]:
        return list(self.scan_iter(lo, hi))

    def scan_iter(self, lo: bytes, hi: bytes) -> Iterator[Tuple[bytes, bytes]]:
        """ONE random seek to the start key, then a sequential CHUNK_BYTES
        stream — the whole range is never materialized.  Reads go through
        the persistent handle (re-seeking per chunk, so interleaved point
        gets on the same handle stay safe)."""
        i = bisect_left(self.keys, lo)
        j = bisect_right(self.keys, hi)
        if i >= j:
            return
        pos = self.index[self.keys[i]][0]
        end_off, end_len = self.index[self.keys[j - 1]]
        remaining = end_off + end_len - pos
        if self._rf is None:
            self._rf = open(self.path, "rb")
        buf = b""
        while remaining > 0:
            self._rf.seek(pos)
            chunk = self._rf.read(min(self.CHUNK_BYTES, remaining))
            if not chunk:
                break
            pos += len(chunk)
            remaining -= len(chunk)
            self.metrics.on_read("sorted_range", len(chunk))
            buf += chunk
            off = 0
            while off + _HDR.size <= len(buf):
                _, _, _, _, klen, vlen = _HDR.unpack_from(buf, off)
                rlen = _HDR.size + klen + vlen
                if off + rlen > len(buf):
                    break
                entry, _ = LogEntry.decode(buf, off)
                yield entry.key, entry.value
                off += rlen
            buf = buf[off:]

    def items(self) -> Iterator[Tuple[bytes, LogEntry]]:
        for _, entry in self._stream_records("gc_merge_read"):
            yield entry.key, entry

    def snapshot_payload(self) -> bytes:
        """Whole sorted file — Raft InstallSnapshot payload for catch-up."""
        with open(self.path, "rb") as f:
            data = f.read()
        self.metrics.on_ship("snapshot", len(data))
        return data

    def install_payload(self, payload: bytes, last_index: int,
                        last_term: int, category: str = "snapshot_install"):
        self._reset_read_state()
        with fs_open(self.path, "wb") as f:
            f.write(payload)
            fs_fsync(f)   # data durable before the meta declares `complete`
        self.metrics.on_write(category, len(payload))
        write_json_atomic(self.meta_path,
                          {"last_index": last_index, "last_term": last_term,
                           "complete": True})
        self.load()

    def data_bytes(self) -> int:
        return sum(length for _, length in self.index.values())

    def close(self):
        if self._rf is not None:
            self._rf.close()
            self._rf = None

    def destroy(self):
        self._reset_read_state()
        for p in (self.path, self.meta_path):
            fs_remove(p)


class SortedRun(SortedStore):
    """A SortedStore inside the leveled hierarchy: addressed by a run id
    (never reused, reserved in the manifest before the file is born) and a
    level.  The (last_index, last_term) boundary is the Raft log position
    this run's data is complete up to."""

    def __init__(self, dirpath: str, metrics: Metrics, rid: int,
                 level: int = 0, cache: Optional[BlockCache] = None):
        super().__init__(dirpath, metrics, cache=cache,
                         name=f"run_{rid:06d}")
        self.rid = rid
        self.level = level


def kway_merge_newest_wins(sources) -> Iterator[Tuple[bytes, object]]:
    """Streaming heap merge of key-ascending (key, payload) iterators.

    `sources` must be ordered newest-first; equal keys pop in source order
    (the heap tuple is (key, rank, ...)), so the newest version is yielded
    and older ones are skipped.  Wall-clock and memory are O(k) per item —
    nothing is materialized."""
    heap = []
    for rank, it in enumerate(sources):
        first = next(it, None)
        if first is not None:
            heap.append((first[0], rank, first[1], it))
    heapq.heapify(heap)
    last_key = None
    while heap:
        if len(heap) == 1:
            # fast path: one live source left (each source is already
            # deduped + ascending) — drain it with zero heap traffic
            key, _, payload, it = heap[0]
            if key != last_key:
                yield key, payload
            yield from it
            return
        key, rank, payload, it = heapq.heappop(heap)
        if key != last_key:
            yield key, payload
            last_key = key
        nxt = next(it, None)
        if nxt is not None:
            heapq.heappush(heap, (nxt[0], rank, nxt[1], it))


class LeveledStore:
    """Leveled run hierarchy + persisted manifest (paper §III-D's 'leveled
    garbage collection').

    Invariants:
      * `runs` is ordered newest-first by `last_index`; boundaries strictly
        increase per GC cycle, and a merge output inherits the newest input
        boundary, so recency order == last_index order.
      * Every run at level l+1 is older than every run at level l (merges
        always consume a whole level), so levels grow geometrically and a
        single L0 flush is O(active segment), independent of total data.
      * The manifest (atomic tmp+rename) is the authority on membership:
        a run file not listed there is a crashed merge output and is
        discarded on recovery; inputs of an unfinished merge stay listed,
        so the store always recovers to a Raft-boundary-consistent state.
    """
    MANIFEST = "runs_manifest.json"

    def __init__(self, dirpath: str, metrics: Metrics,
                 cache: Optional[BlockCache] = None, fanout: int = 4):
        self.dir = dirpath
        os.makedirs(dirpath, exist_ok=True)
        self.metrics = metrics
        self.cache = cache
        self.fanout = fanout
        self.runs: List[SortedRun] = []      # newest first
        self.boundary: Tuple[int, int] = (0, 0)
        self.next_rid = 0
        # manifest epoch: bumps on every committed membership mutation
        # (add_l0 / commit_merge / adopt_run / install_payload).  A leader
        # and a pure-adopter follower advance it in lock-step, which makes
        # divergence between their run hierarchies observable.
        self.epoch = 0
        # run-shipping position: (leader term, ship epoch) of the newest
        # adopted record — durable in the manifest, so a restarted follower
        # resumes adoption exactly where it left off (stale or duplicated
        # records are fenced out by comparing against this).
        self.ship_pos: Tuple[int, int] = (0, 0)
        self.manifest_path = os.path.join(dirpath, self.MANIFEST)

    # ----------------------------------------------------------- manifest
    def _persist_manifest(self):
        data = {"next_rid": self.next_rid,
                "boundary": list(self.boundary),
                "epoch": self.epoch,
                "ship_pos": list(self.ship_pos),
                "runs": [{"rid": r.rid, "level": r.level,
                          "last_index": r.last_index,
                          "last_term": r.last_term} for r in self.runs]}
        # audited atomic swap: tmp fsync + rename + parent dirsync — callers
        # delete retired run files only after this returns, so a lost rename
        # can never leave the old manifest pointing at removed files
        write_json_atomic(self.manifest_path, data)
        self.metrics.on_write("gc_meta", 64)

    def alloc_rid(self) -> int:
        """Reserve a run id durably so a crashed build never collides with
        a later run of the same id."""
        rid = self.next_rid
        self.next_rid += 1
        self._persist_manifest()
        return rid

    def load(self) -> bool:
        if not os.path.exists(self.manifest_path):
            return False
        with open(self.manifest_path) as f:
            m = json.load(f)
        self.next_rid = m["next_rid"]
        self.boundary = tuple(m["boundary"])
        self.epoch = m.get("epoch", 0)
        self.ship_pos = tuple(m.get("ship_pos", (0, 0)))
        self.runs = []
        for spec in m["runs"]:
            run = SortedRun(self.dir, self.metrics, spec["rid"],
                            level=spec["level"], cache=self.cache)
            if not run.load():
                # manifest references it => data loss; fail loudly
                raise FileNotFoundError(run.path)
            self.runs.append(run)
        self.runs.sort(key=lambda r: r.last_index, reverse=True)
        return True

    def prune_orphans(self, keep: Tuple[str, ...] = ()):
        """Remove run files the manifest does not own (crashed level-merge
        outputs); `keep` protects an in-flight L0 build being resumed."""
        live = {os.path.basename(p) for r in self.runs
                for p in (r.path, r.meta_path)}
        live.update(os.path.basename(p) for p in keep)
        for fn in os.listdir(self.dir):
            if fn.startswith("run_") and fn.split(".")[-1] in ("log", "meta") \
                    and fn not in live:
                fs_remove(os.path.join(self.dir, fn))

    # ------------------------------------------------------------ mutation
    def add_l0(self, run: SortedRun, boundary: Tuple[int, int]):
        """Commit a sealed L0 run (one GC cycle's output) + new boundary."""
        run.level = 0
        self.runs.insert(0, run)
        self.boundary = boundary
        self.epoch += 1
        self._persist_manifest()

    def level_runs(self, level: int) -> List[SortedRun]:
        return [r for r in self.runs if r.level == level]

    def needs_merge(self) -> Optional[int]:
        """Lowest level holding >= fanout runs, or None."""
        levels = sorted({r.level for r in self.runs})
        for level in levels:
            if len(self.level_runs(level)) >= self.fanout:
                return level
        return None

    def commit_merge(self, out_run: SortedRun, inputs: List[SortedRun]):
        """Atomically swap merge inputs for the sealed output, THEN delete
        the input files (crash between the two leaves only orphans)."""
        drop = {r.rid for r in inputs}
        self.runs = [r for r in self.runs if r.rid not in drop]
        self.runs.append(out_run)
        self.runs.sort(key=lambda r: r.last_index, reverse=True)
        self.epoch += 1
        self._persist_manifest()
        for r in inputs:
            r.destroy()

    # ------------------------------------------------------- run shipping
    def export_run(self, run: SortedRun) -> bytes:
        """Byte payload of one sealed run, for replication to followers."""
        with open(run.path, "rb") as f:
            data = f.read()
        self.metrics.on_read("run_export", len(data))
        return data

    def adopt_run(self, level: int, last_index: int, last_term: int,
                  data: bytes, retire: List[Tuple[int, int]],
                  boundary: Tuple[int, int],
                  ship_pos: Tuple[int, int]) -> SortedRun:
        """Install a leader-sealed run wholesale and retire the same inputs
        the leader consumed — the follower side of run shipping.

        `retire` names inputs by logical identity (level, last_index) so
        adoption survives local rid renumbering (e.g. after a snapshot
        catch-up).  Raises ValueError when an input is missing — the fence
        a diverged/lagging follower trips, falling back to snapshot
        catch-up.  Crash-safe like commit_merge: the manifest swap commits
        run + retirements + ship position atomically; files of retired
        runs are deleted only after the swap (before it, the new file is
        an orphan the next recovery prunes)."""
        drop = []
        for lvl, li in retire:
            match = [r for r in self.runs
                     if r.level == lvl and r.last_index == li]
            if not match:
                raise ValueError(f"adopt fence: no input run L{lvl}@{li}")
            drop.append(match[0])
        run = SortedRun(self.dir, self.metrics, self.alloc_rid(),
                        level=level, cache=self.cache)
        run.install_payload(data, last_index, last_term,
                            category="run_adopt")
        dropset = {r.rid for r in drop}
        self.runs = [r for r in self.runs if r.rid not in dropset]
        self.runs.append(run)
        self.runs.sort(key=lambda r: r.last_index, reverse=True)
        self.boundary = tuple(boundary)
        self.ship_pos = tuple(ship_pos)
        self.epoch += 1
        self._persist_manifest()    # the adoption commit point
        for r in drop:
            r.destroy()
        return run

    # --------------------------------------------------------------- reads
    def get(self, key: bytes) -> Optional[bytes]:
        for r in self.runs:                 # newest first; bloom-gated
            v = r.get(key)
            if v is not None:
                return v
        return None

    def scan_sources(self, lo: bytes, hi: bytes):
        """Newest-first streaming iterators for the engine's k-way merge."""
        return [r.scan_iter(lo, hi) for r in self.runs]

    def total_keys(self) -> int:
        return sum(len(r.keys) for r in self.runs)

    def total_bytes(self) -> int:
        return sum(r.data_bytes() for r in self.runs)

    def level_shape(self) -> Dict[int, int]:
        shape: Dict[int, int] = {}
        for r in self.runs:
            shape[r.level] = shape.get(r.level, 0) + 1
        return shape

    # ------------------------------------------------------------ snapshot
    def snapshot_payload(self) -> List[dict]:
        """InstallSnapshot payload: the whole run set, newest first."""
        out = []
        for r in self.runs:
            with open(r.path, "rb") as f:
                data = f.read()
            self.metrics.on_ship("snapshot", len(data))
            out.append({"level": r.level, "last_index": r.last_index,
                        "last_term": r.last_term, "data": data})
        return out

    def install_payload(self, payload: List[dict], last_index: int,
                        last_term: int):
        """Write the shipped runs, swap the manifest, THEN delete the old
        files — a crash before the swap leaves the old set authoritative
        (new files are orphans), after it the old files are orphans."""
        old_runs = self.runs
        base = self.next_rid            # reserve every rid in ONE write
        self.next_rid += len(payload)
        if payload:
            self._persist_manifest()
        new_runs = []
        for i, spec in enumerate(payload):
            run = SortedRun(self.dir, self.metrics, base + i,
                            level=spec["level"], cache=self.cache)
            run.install_payload(spec["data"], spec["last_index"],
                                spec["last_term"])
            new_runs.append(run)
        new_runs.sort(key=lambda r: r.last_index, reverse=True)
        self.runs = new_runs
        self.boundary = (last_index, last_term)
        self.epoch += 1
        self.ship_pos = (0, 0)   # shipping restarts from the snapshot state
        self._persist_manifest()    # swap point
        for r in old_runs:
            r.destroy()

    def close(self):
        for r in self.runs:
            r.close()

    def destroy(self):
        for r in self.runs:
            r.destroy()
        self.runs = []
        fs_remove(self.manifest_path)
