"""Byte-level I/O accounting — the evidence layer for every paper claim.

Every file write/read in the storage stack is tagged with a category
(raft_log, wal, flush, compaction, valuelog, gc_read, ...), so write
amplification per layer can be reported exactly: the paper's central claim is
"value writes drop from >=3x to exactly 1x" and these counters prove (or
refute) it at any scale.

Copied from ``src/repro/core/metrics.py``; only the import prefix differs.
"""
from __future__ import annotations

import math
import time
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from repro_torch.core import trace as _trace


class LatencyHistogram:
    """HDR-style log-bucketed histogram: O(1) record, bounded relative
    error, exact mergeability.

    Bucket 0 covers [0, min_value); bucket i >= 1 covers
    [min_value * growth^(i-1), min_value * growth^i), so every recorded
    value lands in a bucket whose width is a fixed ~(growth-1) fraction of
    the value — the same trick HdrHistogram uses to cover a huge dynamic
    range in a handful of counters.  Quantiles report the bucket's upper
    edge, so a reported quantile is never below the exact (nearest-rank)
    sample quantile and is within ONE bucket of it (pinned by the minihyp
    property test in tests/test_chaos_harness.py).  merge() of two
    histograms is bucket-exact: identical to the histogram of the
    concatenated samples.

    Units are the caller's choice; the workload harness records
    microseconds (min_value=0.1us resolves sub-microsecond service times,
    ~4%-wide buckets keep p999 honest)."""

    __slots__ = ("min_value", "growth", "_log_g", "counts", "n", "total",
                 "max_seen", "min_seen")

    def __init__(self, min_value: float = 0.1, growth: float = 1.04):
        if min_value <= 0 or growth <= 1:
            raise ValueError("need min_value > 0 and growth > 1")
        self.min_value = min_value
        self.growth = growth
        self._log_g = math.log(growth)
        self.counts: Dict[int, int] = defaultdict(int)
        self.n = 0
        self.total = 0.0
        self.max_seen = 0.0
        self.min_seen = math.inf

    def bucket(self, value: float) -> int:
        if value < self.min_value:
            return 0
        return 1 + int(math.log(value / self.min_value) / self._log_g)

    def bucket_edge(self, idx: int) -> float:
        """Upper edge of bucket `idx` — the quantile representative."""
        return self.min_value * self.growth ** idx

    def record(self, value: float, count: int = 1):
        self.counts[self.bucket(value)] += count
        self.n += count
        self.total += value * count
        if value > self.max_seen:
            self.max_seen = value
        if value < self.min_seen:
            self.min_seen = value

    def quantile(self, q: float) -> float:
        """Nearest-rank quantile, reported as its bucket's upper edge
        (>= the exact sample quantile, < one bucket above it).

        Raises ValueError on an empty histogram — an empty phase has no
        p99, and silently reporting 0.0 once masked a mis-split phase
        window as "latency dropped to zero"."""
        if self.n == 0:
            raise ValueError(
                "quantile(%r) of an empty histogram: no samples recorded "
                "(check the phase window / label filter that built it)" % q)
        rank = max(1, math.ceil(q * self.n))
        cum = 0
        for idx in sorted(self.counts):
            cum += self.counts[idx]
            if cum >= rank:
                return self.bucket_edge(idx)
        return self.bucket_edge(max(self.counts))    # q > 1 safety

    def mean(self) -> float:
        return self.total / self.n if self.n else 0.0

    def merge(self, other: "LatencyHistogram") -> "LatencyHistogram":
        """Fold `other` into self (same geometry required) and return
        self.  Bucket-exact: merge(a, b) == histogram of a's and b's
        samples concatenated."""
        if (self.min_value, self.growth) != (other.min_value, other.growth):
            raise ValueError(
                "histogram geometries differ: cannot merge "
                "(min_value=%r, growth=%r) into (min_value=%r, growth=%r)"
                % (other.min_value, other.growth,
                   self.min_value, self.growth))
        for idx, cnt in other.counts.items():
            self.counts[idx] += cnt
        self.n += other.n
        self.total += other.total
        self.max_seen = max(self.max_seen, other.max_seen)
        self.min_seen = min(self.min_seen, other.min_seen)
        return self

    def copy(self) -> "LatencyHistogram":
        out = LatencyHistogram(self.min_value, self.growth)
        return out.merge(self)

    def summary(self) -> dict:
        if self.n == 0:     # all-zero summary, explicit about emptiness
            return {"n": 0, "mean": 0.0, "p50": 0.0, "p90": 0.0,
                    "p99": 0.0, "p999": 0.0, "max": 0.0}
        return {"n": self.n, "mean": round(self.mean(), 3),
                "p50": round(self.quantile(0.50), 3),
                "p90": round(self.quantile(0.90), 3),
                "p99": round(self.quantile(0.99), 3),
                "p999": round(self.quantile(0.999), 3),
                "max": round(self.max_seen, 3)}


# counter fields covered by Metrics.snapshot()/delta(): per-category dicts
# and flat ints.  gc_cycle_log is summarized by length (gc_cycles).
_SNAP_DICTS = ("write_bytes", "read_bytes", "write_ops", "read_ops",
               "cache_hits", "ship_bytes", "ship_ops", "read_tiers",
               "fault_injections", "membership_events", "fsync_cats")
_SNAP_INTS = ("fsyncs", "bloom_skips", "read_quorum_rounds",
              "follower_serves", "session_stalls")


@dataclass
class Metrics:
    write_bytes: Dict[str, int] = field(default_factory=lambda: defaultdict(int))
    read_bytes: Dict[str, int] = field(default_factory=lambda: defaultdict(int))
    write_ops: Dict[str, int] = field(default_factory=lambda: defaultdict(int))
    read_ops: Dict[str, int] = field(default_factory=lambda: defaultdict(int))
    fsyncs: int = 0
    # fsyncs by layer ('valuelog', 'wal', 'raft_log', ...): which store's
    # durability sat on the critical path — the per-category counterpart
    # of the flat `fsyncs` total (sum(fsync_cats.values()) == fsyncs)
    fsync_cats: Dict[str, int] = field(default_factory=lambda: defaultdict(int))
    cache_hits: Dict[str, int] = field(default_factory=lambda: defaultdict(int))
    bloom_skips: int = 0
    # replication traffic this node put on (or took off) the wire, by kind:
    #   'snapshot' — InstallSnapshot run-set payloads (sender side)
    #   'sst'      — LSM-Raft shipped compacted SSTables (receiver side)
    #   'run'      — run-shipping adoption records, per chunk per peer
    #                (sender side)
    # The single channel replaces the old ad-hoc 'snapshot_ship'/'sst_ship'
    # tags so total replication bytes per node is one sum.
    ship_bytes: Dict[str, int] = field(default_factory=lambda: defaultdict(int))
    ship_ops: Dict[str, int] = field(default_factory=lambda: defaultdict(int))
    # consistency-tiered read evidence (client.py): reads served by THIS
    # node, by tier ('linearizable' | 'lease' | 'session'), plus the costs
    # each tier pays — ReadIndex heartbeat-quorum rounds (linearizable /
    # expired-lease fallback), reads a follower served (session: followers
    # become read capacity), and reads that had to stall for the apply
    # pipeline to reach the session token.  One evidence path shared by
    # benchmarks/fig_reads.py, the smoke gate and the stale-read tests
    # (Cluster.read_report()).
    read_tiers: Dict[str, int] = field(default_factory=lambda: defaultdict(int))
    read_quorum_rounds: int = 0
    follower_serves: int = 0
    session_stalls: int = 0
    # injected-fault evidence (FaultFS / chaos): what this node was
    # subjected to, by kind ('hard_crash', 'mid_put_crash', ...) — lets
    # health_report() and the sweep artifacts state exactly how much abuse
    # a passing run absorbed.
    fault_injections: Dict[str, int] = field(
        default_factory=lambda: defaultdict(int))
    # membership-change evidence: config proposals/adoptions, learner
    # promotions, leadership transfers (raft.py self-healing path)
    membership_events: Dict[str, int] = field(
        default_factory=lambda: defaultdict(int))
    latencies_us: Dict[str, List[float]] = field(
        default_factory=lambda: defaultdict(list))
    # leveled-GC evidence: one record per completed GC unit of work —
    # {"kind": "flush"|"merge", "bytes": n, "level": l, "cycle": c} — so
    # "per-cycle compaction work stays bounded as data grows" is assertable.
    gc_cycle_log: List[dict] = field(default_factory=list)
    # which cluster node this Metrics belongs to (None = standalone) —
    # lets the tracer attribute I/O child spans to the node that did the
    # I/O even when the enclosing span is a client-side root
    node: Optional[int] = None

    def on_write(self, category: str, nbytes: int):
        self.write_bytes[category] += nbytes
        self.write_ops[category] += 1
        if _trace._ACTIVE is not None:
            _trace._ACTIVE.io("write", category, nbytes, node=self.node)

    def on_read(self, category: str, nbytes: int):
        self.read_bytes[category] += nbytes
        self.read_ops[category] += 1
        if _trace._ACTIVE is not None:
            _trace._ACTIVE.io("read", category, nbytes, node=self.node)

    def on_fsync(self, category: str = "unlabeled"):
        self.fsyncs += 1
        self.fsync_cats[category] += 1
        if _trace._ACTIVE is not None:
            _trace._ACTIVE.io("fsync", category, 0, node=self.node)

    def on_cache_hit(self, category: str):
        """A read served from the block cache: zero disk bytes."""
        self.cache_hits[category] += 1

    def on_bloom_skip(self):
        """A point get skipped an SSTable entirely via its bloom filter."""
        self.bloom_skips += 1

    def on_read_tier(self, tier: str, *, follower: bool = False,
                     stalled: bool = False):
        """One client read served by this node at `tier` ('linearizable',
        'lease' or 'session').  `follower` marks a read a non-leader served
        (scalable read capacity); `stalled` marks a session read that had
        to wait for the apply pipeline to reach its token."""
        self.read_tiers[tier] += 1
        if follower:
            self.follower_serves += 1
        if stalled:
            self.session_stalls += 1

    def on_fault(self, kind: str):
        """One injected fault applied to this node (kill -9, torn write,
        mid-op crash ...)."""
        self.fault_injections[kind] += 1

    def on_membership(self, kind: str):
        """One membership event on this node ('config_proposed',
        'config_adopted', 'promote', 'transfer')."""
        self.membership_events[kind] += 1

    def on_read_quorum_round(self):
        """One ReadIndex heartbeat-quorum round (covers every read queued
        on the leader at that moment — the batching is the point)."""
        self.read_quorum_rounds += 1

    def on_ship(self, kind: str, nbytes: int):
        """One replication payload crossing the network ('snapshot', 'sst'
        or 'run' — see ship_bytes).  Disk I/O caused by the payload is still
        accounted separately through on_read/on_write."""
        self.ship_bytes[kind] += nbytes
        self.ship_ops[kind] += 1

    def total_ship_bytes(self) -> int:
        """All replication bytes this node shipped/adopted over the wire."""
        return sum(self.ship_bytes.values())

    def on_gc_cycle(self, kind: str, nbytes: int, level: int, cycle: int):
        """One completed GC unit: an active-segment flush into L0
        ('flush') or a level-i -> level-i+1 run merge ('merge')."""
        self.gc_cycle_log.append({"kind": kind, "bytes": nbytes,
                                  "level": level, "cycle": cycle})

    def gc_flush_bytes_per_cycle(self) -> List[int]:
        """Bytes each active-segment GC flush rewrote — flat across cycles
        under leveled GC, grows O(total data) under a monolithic rewrite."""
        return [r["bytes"] for r in self.gc_cycle_log if r["kind"] == "flush"]

    def gc_total_bytes(self) -> int:
        """All bytes GC rewrote: L0 flushes + level merges."""
        return sum(v for k, v in self.write_bytes.items()
                   if k in ("gc_sorted", "gc_level_merge"))

    def gc_write_amplification(self, user_bytes: int) -> float:
        return self.gc_total_bytes() / max(user_bytes, 1)

    def record_latency(self, op: str, seconds: float):
        self.latencies_us[op].append(seconds * 1e6)

    # ------------------------------------------------------ phase windows
    # Every counter above is ENGINE-LIFETIME cumulative; any "how much did
    # phase X cost" report that reads them raw double-counts everything
    # that happened before the phase.  snapshot() freezes the counters and
    # delta() reports only what happened since — the workload harness uses
    # it for pre-fault vs post-fault accounting, fig_reads for per-tier
    # quorum-round pricing and fig_runship for per-phase byte accounting.
    def snapshot(self) -> dict:
        """Frozen copy of every counter (plain dict, JSON-able)."""
        snap = {k: dict(getattr(self, k)) for k in _SNAP_DICTS}
        for k in _SNAP_INTS:
            snap[k] = getattr(self, k)
        snap["gc_cycles"] = len(self.gc_cycle_log)
        return snap

    def delta(self, since: Optional[dict] = None) -> dict:
        """Counter movement since `since` (a snapshot() result); with no
        baseline, the full lifetime totals in snapshot() shape.  Zero
        movement in a category is omitted from the per-category dicts."""
        since = since or {}
        out = {}
        for k in _SNAP_DICTS:
            base = since.get(k, {})
            out[k] = {c: v - base.get(c, 0)
                      for c, v in getattr(self, k).items()
                      if v != base.get(c, 0)}
        for k in _SNAP_INTS:
            out[k] = getattr(self, k) - since.get(k, 0)
        out["gc_cycles"] = len(self.gc_cycle_log) - since.get("gc_cycles", 0)
        return out

    def total_writes(self) -> int:
        return sum(self.write_bytes.values())

    def write_amplification(self, user_bytes: int) -> float:
        return self.total_writes() / max(user_bytes, 1)

    def value_write_count(self, user_bytes: int) -> float:
        """How many times each user byte hit the disk (the paper's '>=3 -> 1')."""
        return self.write_amplification(user_bytes)

    def summary(self) -> dict:
        import numpy as np
        lat = {}
        for op, xs in self.latencies_us.items():
            a = np.asarray(xs)
            lat[op] = {"p50_us": float(np.percentile(a, 50)),
                       "p99_us": float(np.percentile(a, 99)),
                       "mean_us": float(a.mean()), "n": len(xs)}
        return {
            "write_bytes": dict(self.write_bytes),
            "read_bytes": dict(self.read_bytes),
            "write_ops": dict(self.write_ops),
            "read_ops": dict(self.read_ops),
            "fsyncs": self.fsyncs,
            "fsync_cats": dict(self.fsync_cats),
            "cache_hits": dict(self.cache_hits),
            "bloom_skips": self.bloom_skips,
            "ship_bytes": dict(self.ship_bytes),
            "read_tiers": dict(self.read_tiers),
            "read_quorum_rounds": self.read_quorum_rounds,
            "follower_serves": self.follower_serves,
            "session_stalls": self.session_stalls,
            "fault_injections": dict(self.fault_injections),
            "membership_events": dict(self.membership_events),
            "latency": lat,
        }

    # --------------------------------------------------- typed exposition
    def fill_registry(self, reg: Optional["_trace.MetricsRegistry"] = None,
                      **labels: str) -> "_trace.MetricsRegistry":
        """Publish every counter into a labeled `MetricsRegistry`
        (created if not given).  Extra `labels` (e.g. node="2") are
        attached to every family, so a cluster can merge all of its
        nodes' counters into one scrape — the typed replacement for
        reading the ad-hoc dict fields directly."""
        reg = reg or _trace.MetricsRegistry()
        extra_names = tuple(sorted(labels))

        def cat_counter(name, help, d, label="category"):
            fam = reg.counter(name, help, extra_names + (label,))
            for k in sorted(d):
                fam.labels(**dict(labels, **{label: k})).inc(d[k])

        def flat_counter(name, help, v):
            reg.counter(name, help, extra_names).labels(**labels).inc(v)

        cat_counter("repro_write_bytes_total", "bytes written by layer",
                    self.write_bytes)
        cat_counter("repro_read_bytes_total", "bytes read by layer",
                    self.read_bytes)
        cat_counter("repro_write_ops_total", "write ops by layer",
                    self.write_ops)
        cat_counter("repro_read_ops_total", "read ops by layer",
                    self.read_ops)
        cat_counter("repro_fsyncs_total", "fsyncs by layer",
                    self.fsync_cats)
        cat_counter("repro_cache_hits_total", "block-cache hits by layer",
                    self.cache_hits)
        cat_counter("repro_ship_bytes_total",
                    "replication payload bytes by channel",
                    self.ship_bytes, label="channel")
        cat_counter("repro_reads_total", "client reads served by tier",
                    self.read_tiers, label="tier")
        cat_counter("repro_fault_injections_total",
                    "injected faults by kind",
                    self.fault_injections, label="kind")
        cat_counter("repro_membership_events_total",
                    "membership events by kind",
                    self.membership_events, label="kind")
        flat_counter("repro_bloom_skips_total",
                     "point gets skipped via bloom filter",
                     self.bloom_skips)
        flat_counter("repro_read_quorum_rounds_total",
                     "ReadIndex heartbeat-quorum rounds",
                     self.read_quorum_rounds)
        flat_counter("repro_follower_serves_total",
                     "reads served by a non-leader", self.follower_serves)
        flat_counter("repro_session_stalls_total",
                     "session reads that waited for apply",
                     self.session_stalls)
        flat_counter("repro_gc_cycles_total", "completed GC work units",
                     len(self.gc_cycle_log))
        return reg


class Stopwatch:
    """Latency timer; `clock` defaults to wall time but accepts any
    zero-arg callable returning seconds — the workload harness passes a
    SimNet-virtual-time clock so recorded latencies are deterministic
    (immune to container CPU steal)."""

    def __init__(self, metrics: Metrics, op: str, clock=time.perf_counter):
        self.metrics, self.op, self.clock = metrics, op, clock

    def __enter__(self):
        self.t0 = self.clock()
        return self

    def __exit__(self, *exc):
        self.metrics.record_latency(self.op, self.clock() - self.t0)
