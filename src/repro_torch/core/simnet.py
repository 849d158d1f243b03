"""Deterministic discrete-event network for the Raft cluster.

Seeded delays, message drops, and pairwise partitions — the substrate for
fault-injection tests (crash, partition, heal) with fully reproducible
schedules.

Chaos-harness surface (repro/core/workload.py rides on all three):
  * per-link injection: `set_link(a, b, ...)` overrides the delay range
    and/or adds a lossy window on one {a,b} link — single-link latency
    spikes and asymmetric loss without touching the rest of the fabric;
  * forked RNG streams: `fork_rng(tag)` derives an independent seeded
    stream from (seed, tag), so a chaos schedule can draw randomness
    without perturbing the delivery sequence (same seed => same
    deliveries, with or without chaos consumers);
  * message trace: `enable_trace()` records every send, drop (with the
    reason — down node, removed address, partition, lossy window, crash
    flush) and delivery — the replayable signature the chaos determinism
    test compares across same-seed runs, and the feed that makes
    `dropped_msgs` attributable (`drop_reasons`) instead of a bare
    counter.  When a `repro.core.trace` tracer is installed the same
    records flow into its `net_events` stream, time-aligned with spans.

Copied from ``src/repro/core/simnet.py``; only the import prefix differs.
"""
from __future__ import annotations

import heapq
import random
from collections import defaultdict
from typing import Any, Dict, List, Optional, Tuple

from repro_torch.core import trace as _trace


class SimNet:
    def __init__(self, node_ids, seed: int = 0, min_delay: int = 1,
                 max_delay: int = 3, drop_prob: float = 0.0):
        self.time = 0
        self.seed = seed
        self.rng = random.Random(seed)
        self.min_delay, self.max_delay = min_delay, max_delay
        self.drop_prob = drop_prob
        self._q: Dict[int, List[Tuple[int, int, int, Any]]] = {
            n: [] for n in node_ids}
        self._seq = 0
        self.blocked: set = set()      # frozenset({a,b}) pairs
        self.down: set = set()         # crashed nodes
        self.removed: set = set()      # membership-removed node ids
        # per-link overrides: frozenset({a,b}) -> (min_delay, max_delay)
        # and -> drop probability (falls back to the net-wide defaults)
        self.link_delay: Dict[frozenset, Tuple[int, int]] = {}
        self.link_drop: Dict[frozenset, float] = {}
        self.trace: Optional[List[Tuple]] = None
        self.sent_msgs = 0
        self.sent_bytes = 0
        # every message the network discarded, whether refused at send time
        # (down / partitioned / lossy link) or destroyed in-flight by a
        # crash — the sender-visible signal that retry/resume logic (e.g.
        # run-shipping chunk retransmission) must cover.  drop_reasons
        # splits the total by cause: 'down' | 'removed' | 'partition' |
        # 'lossy' | 'crash_flush' | 'removed_flush'.
        self.dropped_msgs = 0
        self.drop_reasons: Dict[str, int] = defaultdict(int)

    def fork_rng(self, tag: str) -> random.Random:
        """Independent seeded stream derived from (seed, tag).  Chaos
        schedules / jitter sources draw here instead of from `rng`, so
        their draws can never shift a delivery delay (determinism)."""
        return random.Random(f"{self.seed}:{tag}")

    def enable_trace(self):
        """Start recording message order; see module docstring.  Records
        are ("send"|"drop"|"deliver", time, dst, src, msg_type[, reason])
        tuples — delivery records keep the historical (dst, src) order."""
        self.trace = []

    def _record(self, kind: str, src: int, dst: int, msg: Any,
                reason: Optional[str] = None):
        name = type(msg).__name__
        if self.trace is not None:
            if reason is None:
                self.trace.append((kind, self.time, dst, src, name))
            else:
                self.trace.append((kind, self.time, dst, src, name, reason))
        t = _trace._ACTIVE
        if t is not None:
            t.net_event(kind, self.time, src, dst, name, reason)

    def _drop(self, src: int, dst: int, msg: Any, reason: str):
        self.dropped_msgs += 1
        self.drop_reasons[reason] += 1
        if self.trace is not None or _trace._ACTIVE is not None:
            self._record("drop", src, dst, msg, reason)

    # ------------------------------------------------------ link injection
    def set_link(self, a: int, b: int, *,
                 min_delay: Optional[int] = None,
                 max_delay: Optional[int] = None,
                 drop_prob: Optional[float] = None):
        """Override one {a,b} link: a delay range (both bounds required
        together) and/or a loss probability.  Unset aspects keep the
        net-wide defaults; clear_link() removes the override."""
        pair = frozenset((a, b))
        if (min_delay is None) != (max_delay is None):
            raise ValueError("set_link needs both delay bounds or neither")
        if min_delay is not None:
            self.link_delay[pair] = (min_delay, max_delay)
        if drop_prob is not None:
            self.link_drop[pair] = drop_prob

    def clear_link(self, a: int = None, b: int = None):
        """Remove one {a,b} override, or every override when a is None."""
        if a is None:
            self.link_delay.clear()
            self.link_drop.clear()
        else:
            pair = frozenset((a, b))
            self.link_delay.pop(pair, None)
            self.link_drop.pop(pair, None)

    # --------------------------------------------------------- membership
    def add_node(self, nid: int):
        """Give a joining node a mailbox (idempotent); a previously
        removed id rejoining comes back with an empty queue."""
        self._q.setdefault(nid, [])
        self.removed.discard(nid)

    def remove_node(self, nid: int):
        """Membership removal: the address is dead forever — queued and
        future mail is destroyed (counted in dropped_msgs) so a zombie
        node can neither receive stale RPCs nor inject new ones."""
        self.removed.add(nid)
        for _, _, src, msg in self._q.get(nid, ()):
            self._drop(src, nid, msg, "removed_flush")
        if nid in self._q:
            self._q[nid].clear()

    # ------------------------------------------------------------ transport
    def send(self, src: int, dst: int, msg: Any, size: int = 0):
        if src in self.removed or dst in self.removed:
            self._drop(src, dst, msg, "removed")
            return
        if src in self.down or dst in self.down:
            self._drop(src, dst, msg, "down")
            return
        pair = frozenset((src, dst))
        if pair in self.blocked:
            self._drop(src, dst, msg, "partition")
            return
        p = self.link_drop.get(pair, self.drop_prob)
        if p and self.rng.random() < p:
            self._drop(src, dst, msg, "lossy")
            return
        lo, hi = self.link_delay.get(pair, (self.min_delay, self.max_delay))
        delay = self.rng.randint(lo, hi)
        self._seq += 1
        # setdefault: mail to a member that is still being provisioned
        # (config committed, node not yet constructed) queues until it
        # starts delivering instead of crashing the sender
        heapq.heappush(self._q.setdefault(dst, []),
                       (self.time + delay, self._seq, src, msg))
        self.sent_msgs += 1
        self.sent_bytes += size
        if self.trace is not None or _trace._ACTIVE is not None:
            self._record("send", src, dst, msg)

    def deliver(self, nid: int) -> List[Tuple[int, Any]]:
        if nid in self.down or nid in self.removed:
            return []
        out = []
        q = self._q.get(nid, [])
        while q and q[0][0] <= self.time:
            _, _, src, msg = heapq.heappop(q)
            if self.trace is not None or _trace._ACTIVE is not None:
                self._record("deliver", src, nid, msg)
            out.append((src, msg))
        return out

    def tick(self):
        self.time += 1

    def partition(self, a: int, b: int):
        self.blocked.add(frozenset((a, b)))

    def heal(self, a: int = None, b: int = None):
        if a is None:
            self.blocked.clear()
        else:
            self.blocked.discard(frozenset((a, b)))

    def crash(self, nid: int):
        self.down.add(nid)
        q = self._q.get(nid)
        if q:
            for _, _, src, msg in q:      # in-flight mail vanishes
                self._drop(src, nid, msg, "crash_flush")
            q.clear()

    def restart(self, nid: int):
        self.down.discard(nid)
