"""Storage engines: Nezha and every baseline the paper compares against.

Each engine is simultaneously (a) the Raft log store (persistence of log
entries) and (b) the replicated state machine (apply on commit), matching how
the paper couples/decouples the two layers:

  Original    raft log (full values) + LSM[WAL -> memtable -> SST -> compact]
              => value written >= 3x                      [paper baseline]
  PASV        Original minus the storage-engine WAL (FAST'22)   => >= 2x
  Dwisckey    Original raft log + WiscKey engine (value log below the LSM)
              => 2x value writes, scattered scan reads
  LSM-Raft    Original on the leader; followers skip WAL and receive shipped
              compacted SSTs instead of re-compacting (SIGMOD'25)
  Nezha-NoGC  KVS-Raft: raft log IS the ValueLog, LSM holds key->offset
              => exactly 1x value write; reads pay indirection
  Nezha       Nezha-NoGC + Raft-aware GC (sorted ValueLog + hash index) +
              three-phase request routing; with run_shipping=True, GC is
              leader-only and followers adopt the sealed runs (below)

Replication tiers — how bytes reach a follower, cheapest-first:

  1. Value shipping (always on): AppendEntries carries the log entries
     themselves; each follower persists them once into its own active
     segment.  This is the only tier that runs on the put critical path.
  2. Run shipping (NezhaEngine, DEFAULT — opt out with
     run_shipping=False): only the leader runs GC flushes and leveled
     merges; every sealed run is streamed to followers as a chunked,
     resumable run-adoption record (shipping.py) and installed wholesale —
     follower gc_sorted/gc_level_merge rewrite bytes stay at zero.  Fires
     whenever the leader seals a run, strictly ordered behind the applied
     log.  On by default since it soaked through the PR-4 chaos suite;
     the opt-out exists for A/B baselines (fig_runship's 'local' mode)
     and for standalone-engine tests that exercise local GC on every
     node.
  3. Snapshot shipping (always available): InstallSnapshot ships the whole
     run set.  Fires when a follower is behind the leader's log-compaction
     point (classic Raft catch-up) or when a run-adoption fence trips (a
     diverged / crashed / long-partitioned follower), making it run
     shipping's safety net.

  LSM-Raft's `_ShippedLSM` is the related-work variant of tier 2: shipped
  compacted SSTables instead of shipped value-log runs.

Read tiers mirror the replication tiers (repro/core/client.py): the
cluster's client API serves LINEARIZABLE reads via ReadIndex on the leader
(one heartbeat-quorum round covers a batch of reads), LEASE reads locally
on a leader holding a heartbeat-renewed lease (zero quorum rounds), and
SESSION reads from ANY node gated by a last-seen-index session token.
Run shipping is what makes the SESSION tier pay off: followers hold the
leader's exact sealed-run sets, so follower scans are byte-equal with the
leader and scan capacity scales with cluster size instead of serializing
through one node (benchmarks/fig_reads.py).

Batching / caching knobs (the group-commit I/O pipeline):

  max_batch (RaftNode/Cluster, default 64)
      Entries shipped per AppendEntries RPC AND the group-commit window:
      client_put_many persists a whole window with one buffered write, and
      commit_window() turns it into ONE fsync (per store) instead of one
      per record.  benchmarks/fig12_batching.py sweeps this knob.
  commit window (LogStoreBase.commit_window)
      Invoked by Raft at batch boundaries: after client_put/client_put_many
      on the leader, after the follower appends an AppendEntries batch
      (before acking), and after each _apply_committed drain.  Engines
      flush+fsync every dirty file exactly once per call.
  cache_bytes (EngineBase, default 2 MiB)
      Byte budget of the per-engine BlockCache shared by SSTable blocks,
      SortedStore point records, and ValueLog offset reads.  Per-SSTable
      bloom filters (cache-independent) skip files on point gets.

Durability contract (enforced by the FaultFS crash-point sweep,
tests/test_crashpoints.py — kill -9 at ANY numbered I/O op):

  Survives, at every crash point (sync=True):
    * every ACKED write — an entry is fsynced into the value log by
      commit_window() BEFORE Raft acks/commits it (raft.py), so the acked
      prefix of the log is always on disk; recovery replays it through the
      header-only scan.
    * the manifest epoch / run set — runs_manifest.json, gc_state.json,
      every run .meta and raft_meta.json commit via
      faultfs.write_json_atomic (tmp write -> fsync(tmp) -> rename ->
      fsync(parent dir)); run DATA files are fsynced before their meta
      declares them complete; retired files are deleted only after the
      manifest swap is fully durable.
    * the ship cursor — ship_pos rides in the manifest, same swap.
    * the membership config — the newest KIND_CONFIG entry a node has
      ADOPTED (effective on append) rides in raft_meta.json next to
      term/vote, and the entry itself is in the fsynced value log.  What
      a LEARNER persists before promotion is exactly a voter's state: the
      adopted run set + manifest (its catch-up arrived as InstallSnapshot
      + shipped runs, both durable via the manifest swap), the applied
      log tail in its own value log, and the raft meta including the
      config that added it.  Promotion adds no new durability class —
      the promote entry is just another config commit under the widened
      quorum, so a learner crashing at ANY point before/after promotion
      recovers to a state the leader can resume shipping to (ship_pos
      cursor) without re-running GC.

  May legally be lost:
    * the unacked tail — value-log bytes past the last fsync (dropped or
      torn at a sector boundary; ValueLog.repair_tail truncates them on
      recovery), unsynced index-WAL records (rebuilt by replay: the apply
      of index i happens only after index i's vlog bytes were fsynced, so
      a surviving index record can never point into a lost vlog tail),
      and un-committed GC/merge outputs (orphans pruned by the manifest).

  Reproduce any sweep point from its {seed, crash_index, mode} record:
      PYTHONPATH=src python -c "from repro.core.workload import \
          run_crashpoint; print(run_crashpoint('/tmp/cp', seed=SEED, \
          crash_index=K, mode=MODE))"

Copied from ``src/repro/core/engines.py``; only the import prefix differs.
"""
from __future__ import annotations

import json
import os
from typing import Callable, Dict, Iterator, List, Optional, Tuple

from repro_torch.core import trace as _trace
from repro_torch.core.cache import BlockCache
from repro_torch.core.faultfs import fs_open, write_json_atomic
from repro_torch.core.metrics import Metrics
from repro_torch.core.minilsm import MiniLSM
from repro_torch.core.raft import LogStoreBase
from repro_torch.core.storage import (LeveledStore, SortedRun, StorageModule,
                                kway_merge_newest_wins, pack_offset,
                                unpack_offset)
from repro_torch.core.valuelog import KIND_PUT, LogEntry, ValueLog


class EngineBase(LogStoreBase):
    name = "base"

    def __init__(self, dirpath: str, metrics: Optional[Metrics] = None, *,
                 sync: bool = False,
                 is_leader: Callable[[], bool] = lambda: True,
                 cache_bytes: int = 2 << 20):
        self.dir = dirpath
        os.makedirs(dirpath, exist_ok=True)
        self.metrics = metrics or Metrics()
        self.sync = sync
        self.is_leader = is_leader
        self.cache = BlockCache(cache_bytes)
        self.user_bytes = 0
        self._meta_path = os.path.join(dirpath, "raft_meta.json")

    # ------------------------------------------------------ LogStore parts
    def persist_meta(self, term: int, voted_for: Optional[int],
                     config: Optional[dict] = None):
        # raft safety state: a lost term/vote re-grants a vote after
        # restart, and a lost membership config re-widens a quorum the
        # node already narrowed — so this must survive kill -9 => full
        # atomic pattern.  `config` is {"index", "voters", "learners"}.
        meta = {"term": term, "voted_for": voted_for}
        if config is not None:
            meta["config"] = config
        write_json_atomic(self._meta_path, meta)
        self.metrics.on_write("raft_meta", 32)

    def load_meta(self) -> Tuple[int, Optional[int], Optional[dict]]:
        if not os.path.exists(self._meta_path):
            return 0, None, None
        with open(self._meta_path) as f:
            m = json.load(f)
        return m["term"], m["voted_for"], m.get("config")

    # -------------------------------------------------------- state machine
    def apply_batch(self, pairs: List[Tuple[LogEntry, int]]):
        """Apply one committed drain as a group; engines override to
        coalesce their index/WAL writes.  Default: per-entry apply."""
        for e, off in pairs:
            self.apply(e, off)

    # --------------------------------------------------------- maintenance
    def post_op(self):
        """Called by the cluster between requests (GC trigger point)."""

    def snapshot(self):
        return None

    def install_snapshot(self, last_index: int, last_term: int, payload,
                         keep_tail: bool = True):
        raise NotImplementedError(f"{self.name} has no snapshot support")

    def recover(self):
        """Rebuild state after a crash. Returns (entries, offsets,
        snap_index, snap_term) for the Raft log reconstruction."""
        raise NotImplementedError

    def close(self):
        pass


# =====================================================================
class OriginalEngine(EngineBase):
    """Raft + LSM-tree with WAL: the traditional >=3x-write design."""
    name = "original"
    wal = True

    def __init__(self, dirpath, metrics=None, **kw):
        super().__init__(dirpath, metrics, **kw)
        self.raft_vlog = ValueLog(os.path.join(dirpath, "raft.log"),
                                  self.metrics, category="raft_log",
                                  sync=self.sync, group_commit=True,
                                  cache=self.cache)
        self._offsets: List[int] = []  # raft index (1-based) -> offset
        self.db = MiniLSM(os.path.join(dirpath, "db"), self.metrics,
                          wal=self.wal, sync=self.sync, group_commit=True,
                          cache=self.cache)

    # LogStore
    def append(self, entry: LogEntry) -> int:
        off = self.raft_vlog.append(entry)
        if entry.index == len(self._offsets) + 1:
            self._offsets.append(off)
        else:  # replacement after truncation
            self._offsets[entry.index - 1:] = [off]
        return off

    def append_batch(self, entries: List[LogEntry]) -> List[int]:
        if not entries or entries[0].index != len(self._offsets) + 1:
            return [self.append(e) for e in entries]   # rare truncation path
        offs = self.raft_vlog.append_batch(entries)    # ONE buffered write
        self._offsets.extend(offs)
        return offs

    def commit_window(self):
        self.raft_vlog.sync_now()
        self.db.sync_wal()

    def truncate_from(self, index: int):
        self.raft_vlog.truncate_to(self._offsets[index - 1])
        self._offsets = self._offsets[:index - 1]

    # state machine
    def apply(self, entry: LogEntry, offset: int):
        self.user_bytes += len(entry.key) + len(entry.value)
        self.db.put(entry.key, entry.value)

    def apply_batch(self, pairs: List[Tuple[LogEntry, int]]):
        if not pairs:
            return
        for e, _ in pairs:
            self.user_bytes += len(e.key) + len(e.value)
        self.db.put_batch([(e.key, e.value) for e, _ in pairs])

    def get(self, key: bytes) -> Optional[bytes]:
        return self.db.get(key)

    def scan(self, lo: bytes, hi: bytes):
        return self.db.scan(lo, hi)

    def recover(self):
        self.db.recover()
        self.raft_vlog.repair_tail()   # torn tail = unacked, drop it
        entries, offsets = [], []
        for off, e in self.raft_vlog.scan():
            entries.append(e)
            offsets.append(off)
        self._offsets = offsets
        return entries, offsets, 0, 0

    def close(self):
        self.raft_vlog.close()
        self.db.close()


class PASVEngine(OriginalEngine):
    """FAST'22 PASV: drop the storage-engine WAL (passive persistence); the
    raft log doubles as the redo log on recovery."""
    name = "pasv"
    wal = False

    def recover(self):
        entries, offsets, si, st = super().recover()
        # passive data persistence: replay committed-but-unflushed entries
        for e in entries:
            if e.kind == KIND_PUT and self.db.get(e.key) is None:
                self.db.put(e.key, e.value)
        return entries, offsets, si, st


class DwisckeyEngine(EngineBase):
    """WiscKey below an unmodified Raft: value hits disk twice (raft log +
    engine value log); scans read scattered offsets (no GC reorg)."""
    name = "dwisckey"

    def __init__(self, dirpath, metrics=None, **kw):
        super().__init__(dirpath, metrics, **kw)
        self.raft_vlog = ValueLog(os.path.join(dirpath, "raft.log"),
                                  self.metrics, category="raft_log",
                                  sync=self.sync, group_commit=True,
                                  cache=self.cache)
        self._offsets: List[int] = []
        self.wisc_vlog = ValueLog(os.path.join(dirpath, "wisc_vlog.log"),
                                  self.metrics, category="wisckey_vlog",
                                  sync=self.sync, group_commit=True,
                                  cache=self.cache)
        self.db = MiniLSM(os.path.join(dirpath, "db"), self.metrics,
                          wal=True, sync=self.sync, group_commit=True,
                          cache=self.cache)

    def append(self, entry: LogEntry) -> int:
        off = self.raft_vlog.append(entry)
        if entry.index == len(self._offsets) + 1:
            self._offsets.append(off)
        else:
            self._offsets[entry.index - 1:] = [off]
        return off

    def append_batch(self, entries: List[LogEntry]) -> List[int]:
        if not entries or entries[0].index != len(self._offsets) + 1:
            return [self.append(e) for e in entries]
        offs = self.raft_vlog.append_batch(entries)
        self._offsets.extend(offs)
        return offs

    def commit_window(self):
        self.raft_vlog.sync_now()
        self.wisc_vlog.sync_now()
        self.db.sync_wal()

    def truncate_from(self, index: int):
        self.raft_vlog.truncate_to(self._offsets[index - 1])
        self._offsets = self._offsets[:index - 1]

    def apply(self, entry: LogEntry, offset: int):
        self.user_bytes += len(entry.key) + len(entry.value)
        voff = self.wisc_vlog.append(entry)       # second value write
        self.db.put(entry.key, pack_offset(voff))

    def apply_batch(self, pairs: List[Tuple[LogEntry, int]]):
        if not pairs:
            return
        for e, _ in pairs:
            self.user_bytes += len(e.key) + len(e.value)
        voffs = self.wisc_vlog.append_batch([e for e, _ in pairs])
        self.db.put_batch([(e.key, pack_offset(vo))
                           for (e, _), vo in zip(pairs, voffs)])

    def get(self, key: bytes) -> Optional[bytes]:
        v = self.db.get(key)
        if v is None:
            return None
        return self.wisc_vlog.read_value_at(unpack_offset(v))

    def scan(self, lo: bytes, hi: bytes):
        out = []
        for k, v in self.db.scan(lo, hi):
            out.append((k, self.wisc_vlog.read_value_at(unpack_offset(v))))
        return out

    def recover(self):
        self.db.recover()
        self.raft_vlog.repair_tail()
        self.wisc_vlog.repair_tail()
        entries, offsets = [], []
        for off, e in self.raft_vlog.scan():
            entries.append(e)
            offsets.append(off)
        self._offsets = offsets
        return entries, offsets, 0, 0

    def close(self):
        self.raft_vlog.close()
        self.wisc_vlog.close()
        self.db.close()


class _ShippedLSM(MiniLSM):
    """Follower LSM under LSM-Raft: compacted SSTs arrive over the network,
    so compaction costs one write ('sst_ship') and zero local reads."""

    def compact(self):
        self.compaction_count += 1
        from repro_torch.core.minilsm import SortedDict
        merged = SortedDict()
        for sst in self.l1 + self.l0:
            for k, v in sst.items():
                merged[k] = v   # bytes arrive from the leader: no local read
        path = os.path.join(self.dir, f"sst_{self._sst_seq:06d}.sst")
        self._sst_seq += 1
        from repro_torch.core.minilsm import SSTable
        new_l1 = SSTable.write(path, list(merged.items()), self.metrics,
                               "sst_ship", self.cache)
        self.metrics.on_ship("sst", new_l1.size)   # arrived over the wire
        for sst in self.l0 + self.l1:
            sst.delete()
        self.l0, self.l1 = [], [new_l1]


class LSMRaftEngine(OriginalEngine):
    """SIGMOD'25 LSM-Raft: follower-side redundancy removed (no WAL, shipped
    compaction); the LEADER still writes everything — the paper's point is
    that the leader dominates the critical path."""
    name = "lsmraft"

    def __init__(self, dirpath, metrics=None, **kw):
        super().__init__(dirpath, metrics, **kw)
        if not self.is_leader():
            self.db.close()
            self.db = _ShippedLSM(os.path.join(dirpath, "db"), self.metrics,
                                  wal=False, sync=self.sync,
                                  group_commit=True, cache=self.cache)


# =====================================================================
class NezhaNoGCEngine(EngineBase):
    """KVS-Raft without GC: the raft log IS the ValueLog (single value
    write); the LSM index holds only 8-byte offsets."""
    name = "nezha_nogc"

    def __init__(self, dirpath, metrics=None, **kw):
        super().__init__(dirpath, metrics, **kw)
        self.active = StorageModule(dirpath, self.metrics, "m0000",
                                    sync=self.sync, group_commit=True,
                                    cache=self.cache)
        self._off_of_index: Dict[int, int] = {}   # raft index -> vlog offset

    # LogStore: append == the one and only value persistence
    def append(self, entry: LogEntry) -> int:
        off = self.active.vlog.append(entry)
        self._off_of_index[entry.index] = off
        return off

    def append_batch(self, entries: List[LogEntry]) -> List[int]:
        offs = self.active.vlog.append_batch(entries)
        for e, off in zip(entries, offs):
            self._off_of_index[e.index] = off
        return offs

    def commit_window(self):
        self.active.sync_now()

    def truncate_from(self, index: int):
        off = self._off_of_index[index]           # direct lookup, O(1)
        self.active.vlog.truncate_to(off)
        self._off_of_index = {i: o for i, o in self._off_of_index.items()
                              if i < index}

    def apply(self, entry: LogEntry, offset: int):
        self.user_bytes += len(entry.key) + len(entry.value)
        self.active.apply(entry, offset)

    def apply_batch(self, pairs: List[Tuple[LogEntry, int]]):
        if not pairs:
            return
        for e, _ in pairs:
            self.user_bytes += len(e.key) + len(e.value)
        self.active.apply_batch(pairs)

    def get(self, key: bytes) -> Optional[bytes]:
        return self.active.get(key)

    def scan(self, lo: bytes, hi: bytes):
        return self.active.scan(lo, hi)

    def recover(self):
        self.active.db.recover()
        self.active.vlog.repair_tail()
        entries, offsets = [], []
        # header-only: offsets suffice to replay the state machine
        for off, e in self.active.vlog.scan_headers():
            entries.append(e)
            offsets.append(off)
            self._off_of_index[e.index] = off
        return entries, offsets, 0, 0

    def load_full_entry(self, index: int, offset: int) -> LogEntry:
        return self.active.vlog.read_at(offset)

    def close(self):
        self.active.close()


class NezhaEngine(EngineBase):
    """Full Nezha: KVS-Raft + Raft-aware leveled GC + three-phase request
    routing (paper Algorithms 1-3, Table I, §III-D).

    GC of the active segment seals a new L0 run in the LeveledStore
    (bounded work per cycle — O(active segment), independent of total
    data); when a level accumulates `level_fanout` runs they merge,
    incrementally, into one run on the next level.  Reads stream through
    a k-way newest-wins heap over (New, Active, runs newest-first); point
    gets are bloom-gated per run."""
    name = "nezha"

    def __init__(self, dirpath, metrics=None, *, gc_threshold: int = 32 << 20,
                 gc_batch: int = 64, level_fanout: int = 4,
                 on_snapshot=None, run_shipping: bool = True, **kw):
        super().__init__(dirpath, metrics, **kw)
        self.gc_threshold = gc_threshold
        self.gc_batch = gc_batch
        self.level_fanout = level_fanout
        self.on_snapshot = on_snapshot  # callback(last_index, last_term)
        # run shipping (replication tier 2, ON by default): GC is
        # leader-gated; sealed runs flow to ship_hook (the RunShipper) and
        # followers install them via adopt_run instead of compacting
        # locally.  run_shipping=False is the explicit opt-out for local-GC
        # baselines.  Standalone engines (no cluster wiring) are unaffected:
        # is_leader defaults to True, so GC still runs and ship_hook stays
        # unset.
        self.run_shipping = run_shipping
        self.ship_hook = None   # callback(record dict, run bytes)
        self.raft_role = None   # callable() -> is this node the leader NOW
        self.adopt_count = 0
        self.gen = 0
        self.active = StorageModule(dirpath, self.metrics,
                                    f"m{self.gen:04d}", sync=self.sync,
                                    group_commit=True, cache=self.cache)
        self.new: Optional[StorageModule] = None
        self.leveled = LeveledStore(dirpath, self.metrics, cache=self.cache,
                                    fanout=level_fanout)
        self.gc_started = False
        self.gc_completed = True  # no GC yet
        self.gc_count = 0
        self._state_path = os.path.join(dirpath, "gc_state.json")
        # raft index -> (segment tag, vlog offset): one map serves both
        # module routing and O(1) truncation
        self._seg_of_index: Dict[int, Tuple[str, int]] = {}
        self._gc_iter: Optional[Iterator] = None
        self._gc_last: Tuple[int, int] = (0, 0)     # last APPLIED (idx, term)
        self._building: Optional[SortedRun] = None
        self._cycle_bytes = 0                       # L0 bytes this cycle
        self._merge: Optional[dict] = None          # in-flight level merge
        self._last_by_tag: Dict[str, Tuple[int, int]] = {}
        self._boundary: Tuple[int, int] = (0, 0)    # GC snapshot point

    def _write_gc_state(self, st: dict):
        """gc_state.json is the rotation/flush commit point: it must never
        be observable half-written or lost after a rename, so it commits
        through the audited atomic pattern.  Byte accounting stays at the
        call sites (not every site charged gc_meta historically)."""
        write_json_atomic(self._state_path, st)

    # --------------------------------------------------------- log store
    def _write_module(self) -> StorageModule:
        return self.new if self.new is not None else self.active

    def _purge_module(self, tag: str):
        """Remove any files a crashed rotation left under `tag`."""
        StorageModule(self.dir, self.metrics, tag, sync=self.sync,
                      group_commit=True, cache=self.cache).destroy()

    def _fresh_module(self, tag: str) -> StorageModule:
        """Storage module at `tag`, guaranteed empty."""
        self._purge_module(tag)
        return StorageModule(self.dir, self.metrics, tag, sync=self.sync,
                             group_commit=True, cache=self.cache)

    def append(self, entry: LogEntry) -> int:
        mod = self._write_module()
        off = mod.vlog.append(entry)
        self._seg_of_index[entry.index] = (mod.tag, off)
        self._last_by_tag[mod.tag] = (entry.index, entry.term)
        return off

    def append_batch(self, entries: List[LogEntry]) -> List[int]:
        if not entries:
            return []
        mod = self._write_module()
        offs = mod.vlog.append_batch(entries)      # ONE buffered write
        for e, off in zip(entries, offs):
            self._seg_of_index[e.index] = (mod.tag, off)
        last = entries[-1]
        self._last_by_tag[mod.tag] = (last.index, last.term)
        return offs

    def commit_window(self):
        self.active.sync_now()
        if self.new is not None:
            self.new.sync_now()

    def truncate_from(self, index: int):
        mod = self._write_module()
        tag, off = self._seg_of_index[index]       # direct lookup, O(1)
        assert tag == mod.tag, \
            "conflict truncation across GC segments is not supported"
        mod.vlog.truncate_to(off)
        self._seg_of_index = {i: v for i, v in self._seg_of_index.items()
                              if i < index}
        # the segment's last-persisted marker moved back with the tail
        rest = [(i, v[1]) for i, v in self._seg_of_index.items()
                if v[0] == mod.tag]
        if rest:
            last_i, last_off = max(rest)
            self._last_by_tag[mod.tag] = (last_i,
                                          mod.vlog.read_at(last_off).term)
        else:
            self._last_by_tag.pop(mod.tag, None)

    def apply(self, entry: LogEntry, offset: int):
        self.user_bytes += len(entry.key) + len(entry.value)
        mod = self._module_of(entry.index)
        mod.apply(entry, offset)
        self._gc_last = (entry.index, entry.term)

    def apply_batch(self, pairs: List[Tuple[LogEntry, int]]):
        """Group apply; a batch may straddle the Active->New rotation, so
        coalesce per consecutive-module run (order within the drain is
        preserved)."""
        if not pairs:
            return
        run: List[Tuple[LogEntry, int]] = []
        run_mod = None
        for e, off in pairs:
            self.user_bytes += len(e.key) + len(e.value)
            mod = self._module_of(e.index)
            if mod is not run_mod and run:
                run_mod.apply_batch(run)
                run = []
            run_mod = mod
            run.append((e, off))
        if run:
            run_mod.apply_batch(run)
        last = pairs[-1][0]
        self._gc_last = (last.index, last.term)

    def _module_of(self, index: int) -> StorageModule:
        tag = self._seg_of_index.get(index, (None, 0))[0]
        return self.new if (self.new is not None and tag == self.new.tag) \
            else self.active

    def load_full_entry(self, index: int, offset: int) -> LogEntry:
        return self._module_of(index).vlog.read_at(offset)

    # ------------------------------------------------------- three-phase
    def get(self, key: bytes) -> Optional[bytes]:
        if self.new is not None:
            v = self.new.get(key)
            if v is not None:
                return v
        v = self.active.get(key)
        if v is not None:
            return v
        return self.leveled.get(key)     # newest-first runs, bloom-gated

    def scan_iter(self, lo: bytes, hi: bytes) -> Iterator[Tuple[bytes, bytes]]:
        """Streaming k-way heap merge over (New, Active, L0..Lk), newest
        first with newest-wins dedup — nothing is materialized."""
        sources = []
        if self.new is not None:
            sources.append(self.new.scan_iter(lo, hi))
        sources.append(self.active.scan_iter(lo, hi))
        sources.extend(self.leveled.scan_sources(lo, hi))
        return kway_merge_newest_wins(sources)

    def scan(self, lo: bytes, hi: bytes):
        return list(self.scan_iter(lo, hi))

    # ---------------------------------------------------------------- GC
    def post_op(self):
        """Maintenance trigger point between requests: one bounded slice of
        the in-flight job, else start the next job.  At most one job (an
        active-segment flush or a level merge) runs at a time.  With run
        shipping on, only the leader starts jobs — followers receive the
        sealed output instead (a job already in flight when leadership is
        lost still drains; the new leader's fence/resync covers us)."""
        if self.gc_started and not self.gc_completed:
            self._gc_unit("gc.flush", self.gc_step, self.gc_batch)
        elif self._merge is not None:
            self._gc_unit("gc.merge", self.merge_step, self.gc_batch)
        elif not self._gc_allowed():
            return
        elif self.active.vlog.size >= self.gc_threshold:
            self._gc_unit("gc.flush.start", self.start_gc)
        else:
            level = self.leveled.needs_merge()
            if level is not None:
                self._gc_unit("gc.merge.start", self.start_level_merge,
                              level)

    def _gc_unit(self, name: str, fn, *args):
        """Run one bounded GC slice, wrapped in a trace span when a tracer
        is installed — GC interference shows up INSIDE the client op span
        whose post_op hook paid for it."""
        t = _trace._ACTIVE
        if t is None:
            fn(*args)
            return
        sid = t.begin(name, kind="gc", node=self.metrics.node)
        try:
            fn(*args)
        finally:
            t.end(sid)

    def _gc_allowed(self) -> bool:
        if not self.run_shipping:
            return True
        role = self.raft_role if self.raft_role is not None else self.is_leader
        return bool(role())

    def start_gc(self):
        assert self.gc_completed, "GC already running"
        if self._last_by_tag.get(self.active.tag) is None:
            return   # empty active segment: nothing to compact
        while self._merge is not None:   # direct callers may race a merge
            self.merge_step(1024)
        self.gc_started, self.gc_completed = True, False
        self.gc_count += 1
        self._cycle_bytes = 0
        # snapshot point = last entry PERSISTED into the active segment; the
        # compaction may only consume (and later drop) the active segment
        # once everything up to this point has committed+applied — Raft's
        # log-completeness is preserved (paper §III-E).
        self._boundary = self._last_by_tag.get(self.active.tag, (0, 0))
        self.gen += 1
        self.new = self._fresh_module(f"m{self.gen:04d}")
        self._building = SortedRun(self.dir, self.metrics,
                                   self.leveled.alloc_rid(), level=0,
                                   cache=self.cache)
        fs_open(self._building.path, "wb").close()
        self._building._started = True
        self._write_gc_state({"started": True, "complete": False,
                              "gen": self.gen, "rid": self._building.rid,
                              "last_index": self._boundary[0],
                              "last_term": self._boundary[1]})
        self.metrics.on_write("gc_meta", 64)
        self._gc_snapshot_point = self._boundary
        self._gc_iter = None  # built once the boundary has been applied

    def _live_active_items(self):
        """Key-ascending live data of the Active segment (via its index,
        already deduped+sorted).  Unlike the old monolithic design this
        never re-reads previously compacted data: one GC cycle's work is
        O(active segment), not O(total store)."""
        for key, off in self.active.sorted_items():
            yield key, self.active.vlog.read_at(off)   # scattered GC read

    def gc_step(self, n: int):
        """Advance compaction by n entries; requests interleave freely."""
        if self._gc_iter is None:
            # barrier: wait until the whole active segment has applied
            if self._gc_last[0] < self._gc_snapshot_point[0]:
                return
            self._gc_iter = self._live_active_items()
        buf = []
        done = False
        for _ in range(n):
            item = next(self._gc_iter, None)
            if item is None:
                done = True
                break
            buf.append(item)
        if buf:
            self._cycle_bytes += self._building.append_items(buf,
                                                             "gc_sorted")
        if done:
            self.finish_gc()

    def finish_gc(self):
        li, lt = self._gc_snapshot_point
        boundary_before = self.leveled.boundary
        runs_before = len(self.leveled.runs)
        sealed = self._building
        sealed.seal(li, lt)
        self.leveled.add_l0(sealed, (li, lt))
        self._building = None
        self._gc_iter = None
        # cleanup phase: drop the consumed Active segment
        old_tag = self.active.tag
        self.active.destroy()
        # role rotation: New becomes Active
        self.active = self.new
        self.new = None
        self.gc_completed = True
        # prune raft-index maps below the GC boundary: every index <= li
        # lived in the destroyed segment (the maps stay O(live tail))
        self._seg_of_index = {i: v for i, v in self._seg_of_index.items()
                              if i > li}
        self._last_by_tag.pop(old_tag, None)
        self.metrics.on_gc_cycle("flush", self._cycle_bytes, 0,
                                 self.gc_count)
        self._write_gc_state({"started": True, "complete": True,
                              "gen": self.gen, "last_index": li,
                              "last_term": lt})
        self.metrics.on_write("gc_meta", 64)
        # _gc_allowed: a deposed leader draining its in-flight job must
        # not pay the export read — the shipper would drop it anyway
        if self.run_shipping and self.ship_hook is not None and \
                self._gc_allowed():
            self.ship_hook({"kind": "flush", "level": 0,
                            "last_index": li, "last_term": lt,
                            "boundary_before": boundary_before,
                            "runs_before": runs_before,
                            "boundary": (li, lt), "retire": []},
                           self.leveled.export_run(sealed))
        if self.on_snapshot is not None:
            self.on_snapshot(li, lt)

    # ------------------------------------------------------- level merges
    def start_level_merge(self, level: int):
        """Begin merging every run of `level` into one run on level+1.
        Progress is incremental (merge_step) and crash-safe: the output is
        invisible until commit_merge swaps the manifest, so a crash simply
        discards the partial output and retries later."""
        inputs = self.leveled.level_runs(level)    # newest-first
        out = SortedRun(self.dir, self.metrics, self.leveled.alloc_rid(),
                        level=level + 1, cache=self.cache)
        fs_open(out.path, "wb").close()
        self._merge = {
            "out": out, "inputs": inputs, "level": level, "bytes": 0,
            "iter": kway_merge_newest_wins([r.items() for r in inputs]),
        }

    def merge_step(self, n: int):
        job = self._merge
        out = job["out"]
        buf = []
        done = False
        for _ in range(n):
            item = next(job["iter"], None)
            if item is None:
                done = True
                break
            buf.append(item)
        if buf:
            job["bytes"] += out.append_items(buf, "gc_level_merge")
        if done:
            self.finish_level_merge()

    def finish_level_merge(self):
        job = self._merge
        out, inputs = job["out"], job["inputs"]
        # the merged run is complete up to its newest input's boundary
        newest = max(inputs, key=lambda r: r.last_index)
        out.seal(newest.last_index, newest.last_term)
        retire = [(r.level, r.last_index) for r in inputs]
        runs_before = len(self.leveled.runs)
        self.leveled.commit_merge(out, inputs)
        self.metrics.on_gc_cycle("merge", job["bytes"], job["level"] + 1,
                                 self.gc_count)
        self._merge = None
        if self.run_shipping and self.ship_hook is not None and \
                self._gc_allowed():
            self.ship_hook({"kind": "merge", "level": out.level,
                            "last_index": out.last_index,
                            "last_term": out.last_term,
                            "boundary_before": self.leveled.boundary,
                            "runs_before": runs_before,
                            "boundary": self.leveled.boundary,
                            "retire": retire},
                           self.leveled.export_run(out))

    # ------------------------------------------------------- run adoption
    def adopt_run(self, rec: dict, data: bytes):
        """Follower side of run shipping: install a leader-sealed run and
        retire exactly the inputs the leader consumed — in place of local
        GC.  The caller (RunAdopter) must have applied the log through
        rec['last_index'] first.  Returns (ok, new_offsets): ok=False means
        a fence tripped (divergent manifest, concurrent local GC of a
        deposed leader, stale record) and the caller should fall back to
        snapshot catch-up; new_offsets maps the surviving raft-tail indices
        to their rewritten vlog offsets after a flush adoption."""
        pos = tuple(rec["pos"])
        if pos <= tuple(self.leveled.ship_pos):
            return False, None            # stale/duplicate record
        if (self.gc_started and not self.gc_completed) or \
                self._merge is not None or self.new is not None:
            return False, None            # mid-local-GC (deposed leader)
        if tuple(rec["boundary_before"]) != tuple(self.leveled.boundary):
            return False, None            # manifests diverged
        if rec.get("runs_before", len(self.leveled.runs)) != \
                len(self.leveled.runs):
            # structural gap: records were missed (e.g. merges across a
            # leadership change leave the boundary unchanged, so the
            # boundary fence alone would not see it) — resync instead of
            # silently forking the run hierarchy
            return False, None
        li, lt = rec["last_index"], rec["last_term"]
        if rec["kind"] == "merge":
            try:
                self.leveled.adopt_run(rec["level"], li, lt, data,
                                       [tuple(x) for x in rec["retire"]],
                                       self.leveled.boundary, pos)
            except ValueError:
                return False, None        # an input run is missing
            self.adopt_count += 1
            self.metrics.on_gc_cycle("adopt", len(data), rec["level"],
                                     self.adopt_count)
            return True, None
        # flush: install the L0 run, then retire the covered Active prefix
        # (the leader dropped its whole active segment; we keep only the
        # raft tail past the boundary, rewritten into a fresh segment)
        self.leveled.adopt_run(0, li, lt, data, [], (li, lt), pos)
        new_offsets = self._retire_active_prefix(li, lt)
        self._gc_last = max(self._gc_last, (li, lt))
        self.adopt_count += 1
        self.metrics.on_gc_cycle("adopt", len(data), 0, self.adopt_count)
        return True, new_offsets

    def _retire_active_prefix(self, li: int, lt: int) -> Dict[int, int]:
        """Adopt-path rotation: replace Active with a fresh segment holding
        only the raft tail (index > li), re-applying the already-applied
        puts at their new offsets.  O(tail), not O(segment) — the adopted
        run replaces everything at or below the boundary.

        Crash ordering: the new segment is fully built + synced, THEN
        gc_state.json moves the generation (the commit point), THEN the
        old segment is deleted.  Before the state write the old segment is
        authoritative (the adopted run merely duplicates its prefix, which
        reads tolerate); after it the old files are orphans."""
        old = self.active
        tail = sorted((i, off) for i, (tag, off) in self._seg_of_index.items()
                      if i > li and tag == old.tag)
        entries = [old.vlog.read_at(off) for _, off in tail]
        self._last_by_tag.pop(old.tag, None)
        mod, new_offsets = self._build_tail_segment(entries)
        self._write_gc_state({"started": False, "complete": True,
                              "gen": self.gen, "last_index": li,
                              "last_term": lt})   # rotation commit point
        self.metrics.on_write("gc_meta", 64)
        old.destroy()
        self.active = mod
        return new_offsets

    def _build_tail_segment(self, entries: List[LogEntry]):
        """Fresh segment holding exactly `entries` (a raft tail, one per
        index, ascending), with the already-applied puts re-applied at
        their new offsets; _seg_of_index/_last_by_tag are re-pointed at
        it.  Shared by the adopt-path rotation and snapshot install so
        the rebuild rules can't drift.  Returns (module, {index: off})."""
        self.gen += 1
        mod = self._fresh_module(f"m{self.gen:04d}")
        offs = mod.vlog.append_batch(entries) if entries else []
        applied = self._gc_last[0]
        pairs = [(e, off) for e, off in zip(entries, offs)
                 if e.kind == KIND_PUT and e.index <= applied]
        if pairs:
            mod.apply_batch(pairs)
        mod.sync_now()
        self._seg_of_index = {e.index: (mod.tag, off)
                              for e, off in zip(entries, offs)}
        if entries:
            self._last_by_tag[mod.tag] = (entries[-1].index,
                                          entries[-1].term)
        return mod, {e.index: off for e, off in zip(entries, offs)}

    def run_gc_to_completion(self):
        """Drain the in-flight flush plus any cascading level merges."""
        while True:
            if self.gc_started and not self.gc_completed:
                self.gc_step(1024)
            elif self._merge is not None:
                self.merge_step(1024)
            else:
                level = self.leveled.needs_merge()
                if level is None:
                    return
                self.start_level_merge(level)

    # ----------------------------------------------------------- recovery
    def recover(self):
        state = {}
        if os.path.exists(self._state_path):
            with open(self._state_path) as f:
                state = json.load(f)
        gen = state.get("gen", 0)
        self.gen = gen
        mid_gc = bool(state.get("started")) and not state.get("complete")
        # the manifest is authoritative for the committed run set; a run
        # file it does not list is a crashed level-merge output -> pruned
        self.leveled = LeveledStore(self.dir, self.metrics, cache=self.cache,
                                    fanout=self.level_fanout)
        self.leveled.load()
        keep: Tuple[str, ...] = ()
        b: Optional[SortedRun] = None
        if mid_gc:
            # a state file without 'rid' (legacy writer) can't name its
            # partial run: allocate a fresh one and let the flush restart
            # from the barrier — the old active segment still holds it all
            rid = state.get("rid")
            if rid is None:
                rid = self.leveled.alloc_rid()
            b = SortedRun(self.dir, self.metrics, rid, level=0,
                          cache=self.cache)
            keep = (b.path, b.meta_path)
        self.leveled.prune_orphans(keep=keep)
        self._merge = None   # an unfinished merge is simply retried later
        if mid_gc and any(r.rid == state.get("rid")
                          for r in self.leveled.runs):
            # crash landed between add_l0's manifest commit and the final
            # gc_state write: the flush IS committed; only the cleanup /
            # rotation remained.  Redo it idempotently instead of
            # re-adding the run.
            old = StorageModule(self.dir, self.metrics, f"m{gen - 1:04d}",
                                sync=self.sync, group_commit=True,
                                cache=self.cache)
            old.destroy()
            self.active = StorageModule(self.dir, self.metrics,
                                        f"m{gen:04d}", sync=self.sync,
                                        group_commit=True, cache=self.cache)
            self.active.db.recover()
            self.new = None
            self.gc_started, self.gc_completed = True, True
            self._gc_last = self.leveled.boundary
            li, lt = self.leveled.boundary
            self._write_gc_state({"started": True, "complete": True,
                                  "gen": gen, "last_index": li,
                                  "last_term": lt})
        elif mid_gc:
            # crashed mid-flush: resume from the interrupt point (§III-E)
            self.active = StorageModule(self.dir, self.metrics,
                                        f"m{gen - 1:04d}", sync=self.sync,
                                        group_commit=True, cache=self.cache)
            self.active.db.recover()
            self.new = StorageModule(self.dir, self.metrics,
                                     f"m{gen:04d}", sync=self.sync,
                                     group_commit=True, cache=self.cache)
            self.new.db.recover()
            self._building = b
            resume_key = self._building.load_partial()
            self.gc_started, self.gc_completed = True, False
            self._gc_snapshot_point = (state["last_index"],
                                       state["last_term"])
            self._boundary = self._gc_snapshot_point
            self._gc_last = (0, 0)  # re-applied by raft replay after restart
            if resume_key is not None:
                # compaction had begun => the barrier had passed pre-crash
                # and the active db was WAL-recovered: resume immediately
                # after the interrupt point (paper §III-E).
                self._gc_last = self._gc_snapshot_point
                full = self._live_active_items()
                self._gc_iter = (x for x in full if x[0] > resume_key)
            else:
                self._gc_iter = None  # barrier re-evaluated in gc_step
        else:
            # every complete-state generation owns exactly one live
            # segment: m{gen-1} (crash between a rotation commit and the
            # old segment's deletion) and m{gen+1} (crash between a
            # rotation build and its commit) are orphans — purge both
            for g in (gen - 1, gen + 1):
                leftover = os.path.join(self.dir, f"valuelog_m{g:04d}.log")
                if g >= 0 and os.path.exists(leftover):
                    self._purge_module(f"m{g:04d}")
            self.active = StorageModule(self.dir, self.metrics,
                                        f"m{gen:04d}", sync=self.sync,
                                        group_commit=True, cache=self.cache)
            self.active.db.recover()
            self.new = None
            self.gc_started = bool(state.get("started"))
            self.gc_completed = True
            if self.leveled.runs:
                self._gc_last = self.leveled.boundary
        # rebuild raft tail from the live vlogs — HEADER-ONLY scan: the
        # KVS-Raft state machine replays (key, offset), never values
        # (the paper's Fig. 11 recovery win).  Values hydrate lazily via
        # load_full_entry when the node must replicate old entries.
        entries, offsets = [], []
        mods = [self.active] + ([self.new] if self.new else [])
        for mod in mods:
            mod.vlog.repair_tail()   # torn tail = unacked by contract
            for off, e in mod.vlog.scan_headers():
                entries.append(e)
                offsets.append(off)
                self._seg_of_index[e.index] = (mod.tag, off)
                self._last_by_tag[mod.tag] = (e.index, e.term)
        si, st = self.leveled.boundary if self.leveled.runs else (0, 0)
        scanned = len(entries)
        entries = [e for e in entries if e.index > si]
        offsets = offsets[-len(entries):] if entries else []
        self._seg_of_index = {i: v for i, v in self._seg_of_index.items()
                              if i > si}
        if self.gc_completed and self.new is None and si and \
                scanned != len(entries):
            # the active segment still holds records at/below the manifest
            # boundary: a crash landed between an install/adoption commit
            # and its rotation.  Rebuild the segment tail-only — stale
            # applied records must not shadow newer run data (a catch-up
            # snapshot's contents can be AHEAD of what this node applied).
            old = self.active
            full = [old.vlog.read_at(self._seg_of_index[e.index][1])
                    for e in entries]
            self._last_by_tag.clear()
            self.active, new_offs = self._build_tail_segment(full)
            self._write_gc_state({"started": False, "complete": True,
                                  "gen": self.gen, "last_index": si,
                                  "last_term": st})
            self.metrics.on_write("gc_meta", 64)
            old.destroy()
            offsets = [new_offs[e.index] for e in entries]
        return entries, offsets, si, st

    # ----------------------------------------------------------- snapshot
    def snapshot(self):
        if not self.leveled.runs:
            return None
        li, lt = self.leveled.boundary
        return li, lt, self.leveled.snapshot_payload()

    def install_snapshot(self, last_index: int, last_term: int, payload,
                         keep_tail: bool = True):
        """A shipped snapshot replaces the run hierarchy and everything at
        or below its boundary; the raft tail PAST the boundary is retained
        (rewritten into the fresh segment, like a run adoption's rotation)
        because a resync snapshot can lag entries this follower already
        applied — destroying those would silently regress the state
        machine.  keep_tail=False (raft's term check at the boundary
        failed: the local suffix is a divergent, necessarily-unapplied
        lineage the node is discarding) drops the tail instead — keeping
        it would leave stale duplicate indices in the fresh vlog for the
        leader's re-sent entries to collide with at recovery.  Returns
        {index: new vlog offset} for the retained tail so the raft node
        can re-point its log.  Any local GC/merge is aborted: its
        inputs/outputs are superseded."""
        if self._building is not None:
            self._building.destroy()
            self._building = None
        self._gc_iter = None
        if self._merge is not None:
            self._merge["out"].destroy()
            self._merge = None
        self.gc_started, self.gc_completed = False, True
        mods = {self.active.tag: self.active}
        if self.new is not None:
            mods[self.new.tag] = self.new
        entries = []
        if keep_tail:
            tail = sorted((i, v) for i, v in self._seg_of_index.items()
                          if i > last_index)
            entries = [mods[tag].vlog.read_at(off) for _, (tag, off) in tail
                       if tag in mods]
        if self.new is not None:
            self.new.destroy()
            self.new = None
        old = self.active
        self._last_by_tag.clear()
        self.active, new_offsets = self._build_tail_segment(entries)
        self.leveled.install_payload(payload, last_index, last_term)
        self._gc_last = max(self._gc_last, (last_index, last_term))
        self._write_gc_state({"started": False, "complete": True,
                              "gen": self.gen, "last_index": last_index,
                              "last_term": last_term})
        # deletion comes last: a crash anywhere above leaves the old
        # segment for recovery's orphan purge / below-boundary repair
        old.destroy()
        return new_offsets

    def close(self):
        self.active.close()
        if self.new is not None:
            self.new.close()
        if self._building is not None:
            self._building.close()
        if self._merge is not None:
            self._merge["out"].close()
        self.leveled.close()


ENGINES = {
    "original": OriginalEngine,
    "pasv": PASVEngine,
    "dwisckey": DwisckeyEngine,
    "lsmraft": LSMRaftEngine,
    "tikv": OriginalEngine,       # paper: TiKV follows the Original design
    "nezha_nogc": NezhaNoGCEngine,
    "nezha": NezhaEngine,
}
