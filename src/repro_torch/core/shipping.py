"""Run-shipping replication: leader-driven GC with follower run adoption.

With run shipping enabled, the LEADER is the only node that performs GC
flushes and leveled merges.  Every run it seals (an L0 flush of the active
segment, or a level-merge output) becomes a *run-adoption record* — the run's
bytes plus a manifest delta (level, Raft boundary, the input identities to
retire, the new store boundary) — that is chunked and streamed to followers
over SimNet.  A follower installs the sealed run wholesale and retires the
same inputs instead of re-running GC locally, so cluster-wide compaction
rewrite work drops from N× to 1× (the RDMA index-replication design of
Vardoulakis et al., adapted to whole immutable runs).

Protocol (ShipRun / ShipRunReply in raft.py):

  * Records are totally ordered by pos = (leader term, ship epoch) and must
    be adopted in order; the follower's durable position lives in the runs
    manifest (LeveledStore.ship_pos), so restarts resume exactly.
  * Chunks are resumable: the follower acks its contiguous prefix (`have`);
    the leader sends a bounded window past it and retransmits on a timeout,
    so crashes, partitions and lossy links mid-ship never lose a record —
    they only delay it.
  * Adoption is ordered against AppendEntries: a record installs only once
    the follower has APPLIED the log through the record's last_index, so
    adopted state can never race ahead of the replicated log.
  * Fencing: a record carries the leader's pre-mutation store boundary and
    the logical identities (level, last_index) of the runs it retires.  A
    follower whose manifest does not match exactly (diverged, missed an
    epoch the leader already trimmed, crashed mid-sequence, was mid-local-GC
    as a deposed leader) answers `resync` and the leader falls back to
    InstallSnapshot-style catch-up — never divergence.

Durability: this module keeps NO durable state of its own.  In-flight
chunk assemblies are volatile by design — kill -9 anywhere (the FaultFS
crash-point sweep injects mid-adoption crashes) loses at most the record
in flight, which the leader retransmits from ship_pos; the one durable
cursor is LeveledStore.ship_pos, committed inside the adoption's atomic
manifest swap (see the durability contract in engines.py).

Copied from ``src/repro/core/shipping.py``; only the import prefix differs.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

from repro_torch.core import trace as _trace
from repro_torch.core.metrics import Metrics
from repro_torch.core.raft import LEADER, RaftNode, ShipRun, ShipRunReply

_NEVER = -(10 ** 9)


class _PeerShip:
    """Leader-side per-follower shipping cursor."""
    __slots__ = ("pos", "have", "last_send", "snap_at", "snap_tip",
                 "snap_li")

    def __init__(self):
        self.pos: Tuple[int, int] = (0, 0)  # follower's durable position
        self.have = 0             # chunks acked for the record in flight
        self.last_send = _NEVER   # net.time of the last window sent
        self.snap_at = _NEVER     # last fence-fallback snapshot sent
        self.snap_tip: Tuple[int, int] = (0, 0)  # records an in-flight
        self.snap_li: Optional[int] = None       # snapshot supersedes, and
        #                                          that snapshot's last_index


class RunShipper:
    """Leader side: queue sealed-run records, stream chunks, track acks."""

    def __init__(self, node: RaftNode, engine, metrics: Metrics, *,
                 chunk_bytes: int = 8 << 10, window: int = 4,
                 retry_ticks: int = 12, max_records: int = 16,
                 snap_interval: int = 50):
        self.node = node
        self.engine = engine
        self.metrics = metrics
        self.chunk_bytes = chunk_bytes
        self.window = window
        self.retry_ticks = retry_ticks
        self.max_records = max_records
        self.snap_interval = snap_interval
        self.epoch = 0
        self.records = []   # [(pos, rec, data)], pos-ascending, bounded
        self.peers: Dict[int, _PeerShip] = {p: _PeerShip()
                                            for p in node.peers}

    def sync_peers(self):
        """Membership changed: open a fresh cursor for every new member
        (a joining learner starts from pos (0,0) and is caught up by
        snapshot + resumable chunks) and drop removed members so their
        stale cursor can no longer pin records in _prune."""
        for p in self.node.peers:
            self.peers.setdefault(p, _PeerShip())
        for gone in set(self.peers) - set(self.node.peers):
            del self.peers[gone]
        self._prune()

    # ------------------------------------------------------------ sealing
    def on_run_sealed(self, rec: dict, data: bytes):
        """Engine hook: a run was just committed to the leader manifest."""
        node = self.node
        if node.role != LEADER or not node.peers:
            return
        self.epoch += 1
        pos = (node.current_term, self.epoch)
        nchunks = max(1, -(-len(data) // self.chunk_bytes))
        t = _trace._ACTIVE
        rec = dict(rec, pos=pos, size=len(data), nchunks=nchunks,
                   ctx=t.current() if t is not None else 0)
        self.records.append((pos, rec, data))
        if len(self.records) > self.max_records:
            # a follower that still needs a trimmed record will trip the
            # epoch-gap check below and be caught up by snapshot instead
            self.records = self.records[-self.max_records:]
        for ps in self.peers.values():
            ps.last_send = _NEVER   # dispatch on the next tick

    def _target(self, ps: _PeerShip):
        for pos, rec, data in self.records:
            if pos > ps.pos:
                return pos, rec, data
        return None

    # --------------------------------------------------------------- send
    def tick(self):
        node = self.node
        if node.role != LEADER:
            return
        if set(self.peers) != set(node.peers):
            self.sync_peers()   # config changed while we weren't leader
        if not self.records:
            return
        now = node.net.time
        for p, ps in self.peers.items():
            tgt = self._target(ps)
            if tgt is None:
                continue
            pos, rec, data = tgt
            if pos[0] == ps.pos[0] and pos[1] > ps.pos[1] + 1:
                # the record after the follower's position was trimmed:
                # the sequence is broken, only a snapshot can catch it up
                self._resync(p, ps, now)
                continue
            if now - ps.last_send < self.retry_ticks:
                continue    # window in flight; retransmit on timeout
            self._send_window(p, ps, rec, data, now)

    def _send_window(self, peer: int, ps: _PeerShip, rec: dict, data: bytes,
                     now: int):
        node = self.node
        nchunks = rec["nchunks"]
        # have == nchunks: everything delivered, follower is waiting on its
        # apply barrier — re-send the last chunk as a probe so its eventual
        # adoption ack (or a crash-reset `have`) can't be lost for good
        lo = min(ps.have, nchunks - 1)
        hi = max(min(ps.have + self.window, nchunks), lo + 1)
        for seq in range(lo, hi):
            chunk = data[seq * self.chunk_bytes:(seq + 1) * self.chunk_bytes]
            self.metrics.on_ship("run", len(chunk))
            node.net.send(node.addr, node._addr(peer),
                          ShipRun(node.current_term, node.nid, rec, seq,
                                  chunk), size=len(chunk))
        ps.last_send = now

    # -------------------------------------------------------------- acks
    def on_reply(self, src: int, m: ShipRunReply):
        node = self.node
        if m.term > node.current_term:
            node._become_follower(m.term)
            return
        if node.role != LEADER or m.term != node.current_term:
            return
        ps = self.peers.get(src)
        if ps is None:
            return
        if m.resync:
            self._resync(src, ps, node.net.time)
            return
        adopted = tuple(m.adopted)
        if adopted > ps.pos:
            ps.pos = adopted          # record(s) installed: advance
            ps.have = 0
            ps.last_send = _NEVER
            self._prune()
        tgt = self._target(ps)
        if tgt is not None and tuple(m.pos) == tgt[0] and m.have != ps.have:
            ps.have = m.have          # progress (or a restart's reset)
            ps.last_send = _NEVER     # extend the window immediately

    def _resync(self, peer: int, ps: _PeerShip, now: int):
        """Fence fallback: the follower can't adopt from where it is — ship
        the whole run set via InstallSnapshot (rate-limited); the send hook
        (on_snapshot_sent) skips the cursor past every covered record."""
        if now - ps.snap_at < self.snap_interval:
            return
        ps.snap_at = now
        self.node.send_snapshot_to(peer)

    def on_snapshot_sent(self, peer: int, last_index: int):
        """Any snapshot to `peer` (log catch-up or fence fallback) carries
        the whole current run set, superseding every record sealed so far.
        Only remember that fact here — the cursor skips when the INSTALL is
        acked, so a snapshot dropped by the network keeps old records (and
        the fence/resync retry loop) alive until one actually lands."""
        ps = self.peers.get(peer)
        if ps is None:
            return
        ps.snap_at = self.node.net.time
        if self.records:
            ps.snap_tip = self.records[-1][0]
            ps.snap_li = last_index

    def on_snapshot_acked(self, peer: int, match_index: int):
        """InstallSnapshotReply from `peer`: skip the cursor only if the
        ack proves THIS send's state (or newer) is in — a stale reply to
        an earlier snapshot must not bury records a dropped one carried."""
        ps = self.peers.get(peer)
        if ps is None or ps.snap_li is None or match_index < ps.snap_li:
            return
        if ps.snap_tip > ps.pos:
            ps.pos = ps.snap_tip
            ps.have = 0
            ps.last_send = _NEVER
            self._prune()

    def _prune(self):
        """Drop payloads every follower has passed — a record's bytes are
        pinned only while some peer may still need them (bounded anyway
        by max_records for crashed/unreachable peers)."""
        if self.peers and self.records:
            low = min(ps.pos for ps in self.peers.values())
            self.records = [r for r in self.records if r[0] > low]


class RunAdopter:
    """Follower side: assemble chunks, fence-check, install via the engine."""

    def __init__(self, node: RaftNode, engine, metrics: Metrics):
        self.node = node
        self.engine = engine
        self.metrics = metrics
        self.buf: Optional[dict] = None   # record being assembled
        self.pending: Optional[Tuple[dict, bytes]] = None  # awaiting apply
        self.awaiting_resync = False

    @property
    def pos(self) -> Tuple[int, int]:
        """Durable ship position — lives in the runs manifest."""
        return tuple(self.engine.leveled.ship_pos)

    # ------------------------------------------------------------ receive
    def on_chunk(self, src: int, m: ShipRun):
        node = self.node
        if m.term > node.current_term:
            node._become_follower(m.term)
        if m.term < node.current_term:
            self._reply(src, tuple(m.rec["pos"]), 0)
            return
        node.leader_id = m.leader
        node._note_leader_contact()       # ship traffic IS leader liveness
        rec = m.rec
        pos = tuple(rec["pos"])
        if self.awaiting_resync:
            # keep asking (the leader rate-limits): the requested snapshot
            # may have been dropped by the network
            self._reply(src, pos, 0, resync=True)
            return
        if pos <= self.pos:
            self._reply(src, pos, rec["nchunks"])   # duplicate: already in
            return
        if self.pending is not None:
            if pos == tuple(self.pending[0]["pos"]):
                self._reply(src, pos, rec["nchunks"])
                self._try_adopt(src)
            return      # never buffer ahead of an uninstalled record
        if self.buf is None or tuple(self.buf["rec"]["pos"]) != pos:
            if self.buf is not None and pos < tuple(self.buf["rec"]["pos"]):
                return  # stale chunk of an older record
            self.buf = {"rec": rec, "chunks": {}, "have": 0}
        b = self.buf
        if m.seq not in b["chunks"]:
            b["chunks"][m.seq] = m.data
            while b["have"] in b["chunks"]:
                b["have"] += 1          # contiguous prefix length
        self._reply(src, pos, b["have"])
        if b["have"] >= rec["nchunks"]:
            data = b"".join(b["chunks"][i] for i in range(rec["nchunks"]))
            self.pending = (rec, data)
            self.buf = None
            self._try_adopt(src)

    def tick(self):
        """Apply-barrier poll: a fully-received record installs as soon as
        the log has applied through its boundary."""
        if self.pending is not None and self.node.leader_id is not None:
            self._try_adopt(self.node.leader_id)

    # ------------------------------------------------------------- adopt
    def _try_adopt(self, reply_to: int):
        rec, data = self.pending
        node, eng = self.node, self.engine
        if node.last_applied < rec["last_index"]:
            return      # ordered behind AppendEntries: wait for apply
        t = _trace._ACTIVE
        # graft onto the leader-side GC span that sealed the run (its id
        # crossed the wire in the record); a ctx from a since-replaced
        # tracer shows up as a flagged orphan, never silently dropped
        sid = t.begin("adopt_run", kind="ship", node=node.addr,
                      parent=rec.get("ctx", 0),
                      level=rec.get("level"),
                      last_index=rec["last_index"]) if t is not None else None
        try:
            ok, new_offsets = eng.adopt_run(rec, data)
            if sid is not None:
                t.tag(sid, ok=bool(ok))
            self.pending = None
            if not ok:
                self.awaiting_resync = True
                self._reply(reply_to, tuple(rec["pos"]), 0, resync=True)
                return
            if rec["kind"] == "flush":
                # the adopted run covers the log through last_index:
                # compact the in-memory log like the leader did, then
                # re-point the surviving tail at its rewritten offsets
                node.compact_to(rec["last_index"], rec["last_term"])
                node.repoint_offsets(new_offsets)
            self._reply(reply_to, tuple(rec["pos"]), rec["nchunks"])
        finally:
            if sid is not None:
                t.end(sid)

    def _reply(self, dst: int, pos: Tuple[int, int], have: int,
               resync: bool = False):
        node = self.node
        node.net.send(node.addr, node._addr(dst), ShipRunReply(
            node.current_term, pos, have, self.pos, resync))

    def reset(self):
        """An installed snapshot supersedes anything in flight."""
        self.buf = None
        self.pending = None
        self.awaiting_resync = False
