"""Consistency-tiered client surface for the Nezha cluster.

The paper guarantees strong consistency through Raft, but a client that
reads the leader's engine directly gets none of it: a deposed leader on the
minority side of a partition happily serves state that the majority has
already overwritten, and every read serializes through one node.  This
module is the ladder of read tiers that fixes both, mirroring the engine's
three replication tiers (engines.py):

  LINEARIZABLE  ReadIndex (Raft §6.4): the leader records its commit index,
                confirms leadership with ONE heartbeat-quorum round that
                covers every read queued at that moment (RaftNode batches
                the probe), and serves once applied >= the read index.
                Safe under partition: a deposed leader can never confirm,
                so the read is refused (StaleReadError) or redirected.
  LEASE         The leader serves locally while it holds a tick-based
                lease renewed by heartbeat acks (lease_ticks < minimum
                election timeout, so the lease expires before any new
                leader can exist).  Zero quorum rounds under a stable
                leader; falls back to LINEARIZABLE when the lease lapsed.
  SESSION       Served by ANY live node — including followers, turning
                them into read capacity for the first time.  A per-session
                token carries the client's last-seen raft index; a node
                serves only once it has applied at least that far
                (read-your-writes + monotonic reads, à la Roohitavaf et
                al.'s session guarantees over Raft).  With run shipping on
                (the NezhaEngine default) followers hold the same sealed
                run sets as the leader, so SESSION scans are byte-equal
                with the leader and aggregate scan throughput scales with
                cluster size (benchmarks/fig_reads.py).

Writes (`put`/`put_many`) always go through the leader's log; the
leadership-change retry lives HERE, as a loop (not recursion), so tests
and benchmarks stop re-implementing it.

Every read is accounted on the serving node's Metrics (on_read_tier /
on_read_quorum_round) and surfaced through Cluster.read_report() — the
single evidence path shared by the fig_reads benchmark, the smoke gate and
the stale-read regression tests.

Copied from ``src/repro/core/client.py``; only the import prefix differs.
"""
from __future__ import annotations

from typing import Iterable, List, Optional, Tuple

from repro_torch.core import trace as _trace
from repro_torch.core.raft import LEADER, RaftNode

LINEARIZABLE = "linearizable"
LEASE = "lease"
SESSION = "session"

CONSISTENCY_LEVELS = (LINEARIZABLE, LEASE, SESSION)


class StaleReadError(Exception):
    """The contacted node refused the read rather than risk staleness:
    an unconfirmable (deposed/partitioned) leader for LINEARIZABLE/LEASE,
    or a node whose applied state lags the session token for SESSION."""


class NodeRemovedError(StaleReadError):
    """The contacted node was removed from the cluster membership: its
    address is permanently dead (SimNet destroys its mail), so a pinned
    or session-routed read must fail fast with this instead of hanging
    on a dead mailbox.  Subclasses StaleReadError so existing refusal
    handling keeps working; unpinned reads simply route around it."""


class Session:
    """Client session: a token (`last_index`) of the newest raft index this
    client has observed — via its own writes or previous reads.  Any node
    that has applied at least that far may serve the session's reads."""

    def __init__(self, client: "NezhaClient"):
        self.client = client
        self.last_index = 0

    def observe(self, index: Optional[int]):
        """Fold an observed raft index into the token (monotonic)."""
        if index is not None and index > self.last_index:
            self.last_index = index

    # ------------------------------------------------------------- sugar
    def put(self, key: bytes, value: bytes, **kw) -> int:
        idx = self.client.put(key, value, **kw)
        self.observe(idx)
        return idx

    def put_many(self, items, **kw) -> int:
        # the client observes each chunk's max raft index into the token
        # as it confirms — exact read-your-writes, not a guess at the
        # current leader's applied point
        return self.client.put_many(items, session=self, **kw)

    def get(self, key: bytes, *, node: Optional[int] = None):
        return self.client.get(key, SESSION, session=self, node=node)

    def scan(self, lo: bytes, hi: bytes, *, node: Optional[int] = None):
        return self.client.scan(lo, hi, SESSION, session=self, node=node)


class NezhaClient:
    """Cluster-facing client: consistency-tiered reads, loop-retried
    writes, leader redirect handled internally.

    `node=` pins an operation to one node (the regression tests point it
    at a deposed leader; fig_reads spreads scans across followers); unpinned
    reads pick the leader (LINEARIZABLE/LEASE) or rotate round-robin over
    live nodes (SESSION)."""

    def __init__(self, cluster, *, default_consistency: str = LINEARIZABLE,
                 read_ticks: int = 400, stall_ticks: int = 120,
                 put_attempts: int = 100):
        if default_consistency not in CONSISTENCY_LEVELS:
            raise ValueError(f"unknown consistency {default_consistency!r}")
        self.cluster = cluster
        self.default_consistency = default_consistency
        self.read_ticks = read_ticks      # budget for one quorum round
        self.stall_ticks = stall_ticks    # session wait before redirecting
        self.put_attempts = put_attempts
        self._rr = 0                      # session read round-robin cursor

    def session(self) -> Session:
        return Session(self)

    # -------------------------------------------------------------- writes
    def put(self, key: bytes, value: bytes, max_ticks: int = 2000) -> int:
        """Committed write through the current leader.  Leadership churn
        retries via a bounded LOOP — the old Cluster.put recursed here,
        which meant unbounded stack depth under churny elections.

        Under an installed tracer this is a ROOT span: everything the put
        causes — the leader's append+fsync, follower appends, the apply,
        GC work piggybacked on post_op — hangs off it, across nodes."""
        t = _trace._ACTIVE
        sid = t.begin("put", kind="op",
                      key=key.decode("utf-8", "replace")) \
            if t is not None else None
        try:
            return self._put_locked(key, value, max_ticks, t, sid)
        finally:
            if sid is not None:
                t.end(sid)

    def _put_locked(self, key, value, max_ticks, t, sid) -> int:
        c = self.cluster
        for _ in range(self.put_attempts):
            ld = c.elect()
            idx = ld.client_put(key, value)
            if idx is None:               # lost leadership since elect()
                continue
            retry = False
            for _ in range(max_ticks):
                if ld.last_applied >= idx:
                    for e in c.engines:
                        if e is not None:
                            e.post_op()
                    if t is not None:
                        t.event("client_ack", ld.addr, idx)
                        t.tag(sid, index=idx, leader=ld.addr)
                    return idx
                c.tick()
                # a deposed leader may KEEP role=LEADER while partitioned;
                # watching the cluster's max-term leader catches that too
                if ld.role != LEADER or c.leader() is not ld:
                    retry = True
                    break
            if not retry:
                raise TimeoutError("put not committed")
        raise TimeoutError("put: leadership never stabilized")

    def put_many(self, items: Iterable[Tuple[bytes, bytes]],
                 window: int = 64, max_ticks: int = 200000,
                 batch: Optional[int] = None,
                 session: Optional[Session] = None) -> int:
        """Pipelined group-committed puts: submit in `batch`-sized windows
        (client_put_many => one buffered write + one fsync per window) and
        keep up to `window` entries in flight.

        In-flight chunks are tracked WITH their items: if leadership moves
        mid-flight, raft indexes the old leader assigned may now name
        different entries in the new leader's log, so every unconfirmed
        chunk is resubmitted to the new leader (at-least-once, like put)
        instead of being silently counted as committed.  A chunk counts
        as done — and feeds `session`'s read-your-writes token — only when
        its OWN indexes are applied on the leader that assigned them."""
        t = _trace._ACTIVE
        sid = t.begin("put_many", kind="op") if t is not None else None
        try:
            return self._put_many_locked(items, window, max_ticks, batch,
                                         session, t, sid)
        finally:
            if sid is not None:
                t.end(sid)

    def _put_many_locked(self, items, window, max_ticks, batch, session,
                         t, sid) -> int:
        c = self.cluster
        ld = c.elect()
        if batch is None:
            batch = max(1, min(window, ld.max_batch))

        def submit(chunk):
            nonlocal ld
            idxs = ld.client_put_many(chunk)
            while idxs is None:            # deposed since elect(): re-elect
                ld = c.elect()
                idxs = ld.client_put_many(chunk)
            return idxs

        it = iter(items)
        inflight: List[Tuple[list, List[int]]] = []   # (chunk items, idxs)
        done = 0
        exhausted = False
        for _ in range(max_ticks):
            npending = sum(len(idxs) for _, idxs in inflight)
            while not exhausted and npending < window:
                chunk = []
                room = min(batch, window - npending)
                while len(chunk) < room:
                    nxt = next(it, None)
                    if nxt is None:
                        exhausted = True
                        break
                    chunk.append(nxt)
                if not chunk:
                    break
                inflight.append((chunk, submit(chunk)))
                npending += len(chunk)
            if inflight:
                c.tick()
                if ld.role != LEADER or c.leader() is not ld:
                    # leadership changed: nothing still in flight can be
                    # trusted by index — resubmit it all to the new leader
                    ld = c.elect()
                    inflight = [(chunk, submit(chunk))
                                for chunk, _ in inflight]
                applied = ld.last_applied
                keep = []
                for chunk, idxs in inflight:
                    # idxs ascend with the chunk's items, so the confirmed
                    # part is exactly a prefix; keeping item/index pairs
                    # aligned means a later resubmit sends ONLY the
                    # unconfirmed suffix (already-counted items must not
                    # be counted — or resubmitted — twice)
                    ok = sum(1 for i in idxs if i <= applied)
                    done += ok
                    if t is not None and ok:
                        t.event("client_ack", ld.addr, idxs[ok - 1])
                    if session is not None and ok:
                        session.observe(idxs[ok - 1])
                    if ok < len(idxs):
                        keep.append((chunk[ok:], idxs[ok:]))
                inflight = keep
                for e in c.engines:
                    if e is not None:
                        e.post_op()
            if exhausted and not inflight:
                return done
        raise TimeoutError(
            f"put_many stalled: {done} done, "
            f"{sum(len(x[1]) for x in inflight)} pending")

    # --------------------------------------------------------------- reads
    def get(self, key: bytes, consistency: Optional[str] = None, *,
            session: Optional[Session] = None,
            node: Optional[int] = None) -> Optional[bytes]:
        return self._read(lambda eng: eng.get(key), consistency,
                          session=session, node=node, op_name="get")

    def scan(self, lo: bytes, hi: bytes, consistency: Optional[str] = None,
             *, session: Optional[Session] = None,
             node: Optional[int] = None):
        return self._read(lambda eng: eng.scan(lo, hi), consistency,
                          session=session, node=node, op_name="scan")

    def get_many(self, keys: List[bytes]) -> List[Optional[bytes]]:
        """Batched LINEARIZABLE gets: every key's ReadHandle is queued
        before the next tick, so ONE heartbeat-quorum round confirms the
        whole batch — N reads, 1 round (assertable via read_report)."""
        c = self.cluster
        t = _trace._ACTIVE
        sid = t.begin("get_many", kind="op", tier=LINEARIZABLE,
                      n=len(keys)) if t is not None else None
        try:
            for _ in range(8):
                nd = c.elect()
                handles = [nd.read_index_submit() for _ in keys]
                if any(h is None for h in handles):
                    continue
                if self._await_handles(handles):
                    eng, m = c.engines[nd.nid], c.metrics[nd.nid]
                    out = []
                    for k in keys:
                        m.on_read_tier(LINEARIZABLE)
                        out.append(eng.get(k))
                    return out
            raise StaleReadError("get_many: leadership never confirmed")
        finally:
            if sid is not None:
                t.end(sid)

    def _await_handles(self, handles) -> bool:
        """Tick until every ReadHandle is ready (True) or any aborts /
        the budget runs out (False; stragglers are aborted so the node
        prunes them from its queue).  The one confirm/wait state machine
        shared by the serial and batched linearizable paths."""
        c = self.cluster
        for _ in range(self.read_ticks):
            if all(h.ready for h in handles):
                return True
            if any(h.aborted for h in handles):
                return False
            c.tick()
        for h in handles:
            h.aborted = True
        return False

    def _read(self, op, consistency: Optional[str], *,
              session: Optional[Session], node: Optional[int],
              op_name: str = "read"):
        tier = consistency or \
            (SESSION if session is not None else self.default_consistency)
        if tier not in CONSISTENCY_LEVELS:
            raise ValueError(f"unknown consistency {tier!r}")
        t = _trace._ACTIVE
        sid = t.begin(op_name, kind="op", tier=tier) \
            if t is not None else None
        try:
            if tier == SESSION:
                return self._read_session(op, session, node)
            if tier == LEASE:
                return self._read_lease(op, node)
            return self._read_linearizable(op, node)
        finally:
            if sid is not None:
                t.end(sid)

    # ------------------------------------------------------- linearizable
    def _pinned(self, node: Optional[int]) -> Optional[RaftNode]:
        if node is not None and node in getattr(self.cluster, "removed",
                                                ()):
            raise NodeRemovedError(
                f"node {node} was removed from the cluster membership")
        nd = self.cluster.nodes[node] if node is not None else None
        if node is not None and (nd is None or
                                 self.cluster.addr(node) in
                                 self.cluster.net.down):
            raise StaleReadError(f"node {node} is down")
        return nd

    def _read_linearizable(self, op, node: Optional[int] = None):
        c = self.cluster
        for _ in range(8):
            nd = self._pinned(node) or c.elect()
            h = nd.read_index_submit()
            if h is None:
                if node is not None:
                    raise StaleReadError(
                        f"node {node} is not the leader")
                continue
            if self._await_handles([h]):
                c.metrics[nd.nid].on_read_tier(LINEARIZABLE)
                return op(c.engines[nd.nid])
            if node is not None:
                # pinned read refused: the node lost leadership or could
                # not confirm it within budget (minority partition)
                raise StaleReadError(
                    f"node {node} could not confirm leadership: "
                    "refusing possibly-stale read")
        raise StaleReadError("linearizable read: no confirmable leader")

    # -------------------------------------------------------------- lease
    def _read_lease(self, op, node: Optional[int] = None):
        c = self.cluster
        nd = self._pinned(node) or c.elect()
        if nd.lease_valid():
            read_index = nd.commit_index
            for _ in range(self.read_ticks):
                if nd.last_applied >= read_index:
                    c.metrics[nd.nid].on_read_tier(LEASE)
                    return op(c.engines[nd.nid])
                c.tick()
                if not nd.lease_valid():
                    break             # expired while waiting on apply
        # no (or lapsed) lease: pay the quorum round — which renews it
        return self._read_linearizable(op, node)

    # ------------------------------------------------------------ session
    def _read_session(self, op, session: Optional[Session],
                      node: Optional[int] = None):
        c = self.cluster
        self._pinned(node)                # uniform down-node diagnostic
        token = session.last_index if session is not None else 0
        if node is not None:
            candidates = [node]
        else:
            n = len(c.nodes)
            self._rr += 1
            candidates = [(self._rr + k) % n for k in range(n)]
        removed = getattr(c, "removed", ())
        candidates = [nid for nid in candidates
                      if c.nodes[nid] is not None
                      and c.addr(nid) not in c.net.down
                      and nid not in removed]

        def serve(nid, stalled):
            nd = c.nodes[nid]
            c.metrics[nid].on_read_tier(
                SESSION, follower=nd.role != LEADER, stalled=stalled)
            out = op(c.engines[nid])
            if session is not None:
                session.observe(nd.last_applied)
            return out

        # pass 1: some candidate may already satisfy the token — don't
        # burn the stall budget on a laggard when a caught-up node exists
        for nid in candidates:
            if c.nodes[nid].last_applied >= token:
                return serve(nid, stalled=False)
        # pass 2: everyone lags; wait on the apply pipeline (one shared
        # budget — ticks advance every node at once)
        for _ in range(self.stall_ticks):
            c.tick()
            for nid in candidates:
                if c.nodes[nid].last_applied >= token:
                    return serve(nid, stalled=True)
        if node is not None:
            raise StaleReadError(
                f"node {node} applied {c.nodes[node].last_applied} < "
                f"session token {token}: refusing non-monotonic read")
        raise StaleReadError(
            f"no live node has applied session token {token}")
