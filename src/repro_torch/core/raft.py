"""Raft consensus (arXiv 1409.585 / Ongaro & Ousterhout 2014), deterministic
and storage-pluggable.

The persistence hook is the point of the paper: ``log_store.append(entry)``
is invoked exactly once per log entry, BEFORE the entry is acknowledged, and
returns the byte offset of the persisted record.  In KVS-Raft the log store
is the ValueLog itself, so that single append persists the value, and the
state machine receives (entry, offset) at apply time — storing only the
offset (paper Algorithm 1).

Safety-property surface tested by tests/test_raft_properties.py:
  Election Safety, Log Matching, Leader Completeness, State Machine Safety.

Read path (client.py's consistency tiers ride on these primitives):

  * ReadIndex (§6.4): `read_index_submit()` records the commit index and
    queues a ReadHandle; the next tick starts ONE heartbeat-quorum round
    (a `probe` sequence number piggybacked on AppendEntries and echoed in
    the reply) that confirms leadership for EVERY read queued at that
    moment.  A handle turns `ready` once confirmed and applied >= its
    read index; losing leadership turns it `aborted` instead — a deposed
    leader can never serve a possibly-stale linearizable read.
  * Leader lease: every probe ack also carries evidence the follower
    still accepted us as leader at the probe's SEND time; when a majority
    (incl. self) acked probes sent at time t, the lease extends to
    t + lease_ticks.  `lease_valid()` then authorizes local reads with no
    quorum round.  Soundness rests on two legs: lease_ticks <
    min(election_timeout), and leader stickiness — a node disregards
    RequestVote within min(election_timeout) of valid leader traffic
    (§9.6), so the followers renewing a lease can never simultaneously
    form the majority that elects the leader's replacement.

Membership (single-server changes, thesis §4):

  * The configuration = (voters, learners) rides in the log as KIND_CONFIG
    entries.  A config is EFFECTIVE ON APPEND — leader and followers adopt
    it the moment it lands in their log — and commits under its own quorum
    (the new voter set).  Only one voter add/remove per entry and at most
    one config change in flight (propose_config refuses while the previous
    one is uncommitted): adjacent configs then always share a majority, so
    two disjoint quorums can never form.
  * Learners replicate (AppendEntries / InstallSnapshot / run shipping)
    but never vote, campaign, or count toward any quorum.  The leader
    tracks each peer's applied index from replies and auto-promotes a
    learner once it has applied the config that added it AND is within
    `promote_lag` of the leader's commit index.
  * A voter refuses RequestVote from any candidate outside its current
    voter set — a removed node's runaway term cannot disturb the live
    quorum.  Graceful leader removal: `transfer_leadership()` sends
    TimeoutNow to the best-caught-up voter, whose transfer-flagged
    election bypasses leader stickiness; the old leader's lease is killed
    at send time so LEASE reads can't straddle the handoff.
  * Truncating a log suffix rolls the config back to the newest surviving
    entry; snapshots carry the config at their last index.

Durability contract (see engines.py for the full statement): this module
itself performs no file I/O — everything durable flows through the log
store.  The two commitments Raft relies on are (a) `commit_window()` is
called before any ack/commit ("durable before ack" below), so an acked
entry is on disk at every crash point the FaultFS sweep can inject, and
(b) `persist_meta()` lands term/vote — and since PR 8 the adopted
config — atomically, so kill -9 can never resurrect a pre-vote term,
double-grant a vote, or forget a membership the node acted on.

Copied from ``src/repro/core/raft.py``; only the import prefix differs.
"""
from __future__ import annotations

import json
import random
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

from repro_torch.core import trace as _trace
from repro_torch.core.simnet import SimNet
from repro_torch.core.valuelog import KIND_CONFIG, KIND_NOOP, KIND_PUT, LogEntry

FOLLOWER, CANDIDATE, LEADER = "follower", "candidate", "leader"

_NEVER = -(10 ** 9)


# ------------------------------------------------------------------ messages
@dataclass
class RequestVote:
    term: int
    candidate: int
    last_log_index: int
    last_log_term: int
    # set on elections started by TimeoutNow: an explicit leadership
    # transfer must override the receivers' leader stickiness (§3.10)
    transfer: bool = False


@dataclass
class RequestVoteReply:
    term: int
    granted: bool


@dataclass
class AppendEntries:
    term: int
    leader: int
    prev_log_index: int
    prev_log_term: int
    entries: List[LogEntry]
    leader_commit: int
    # ReadIndex/lease piggyback: the leader's heartbeat-quorum round id.
    # A follower echoes it in its reply; any reply (success or not) in the
    # leader's term proves the follower still accepted its leadership when
    # this round was SENT — which is exactly what ReadIndex confirmation
    # and lease renewal need.  0 = no round attached (legacy traffic).
    probe: int = 0
    # trace context: span id of the newest client op whose entry rides in
    # this batch (repro.core.trace), so follower-side durability work
    # grafts onto the originating op's span tree.  0 = no context.
    ctx: int = 0


@dataclass
class AppendEntriesReply:
    term: int
    success: bool
    match_index: int
    probe: int = 0    # echo of AppendEntries.probe
    applied: int = 0  # follower's last_applied — drives learner promotion
    ctx: int = 0      # echo of AppendEntries.ctx (trace context)


@dataclass
class ReadHandle:
    """One pending consistency-tiered read on the leader (client.py).

    Lifecycle: submitted (probe=None) -> assigned to the next quorum round
    (probe=round id) -> `confirmed` when a majority echoed that round ->
    `ready` once last_applied >= read_index.  `aborted` is terminal: the
    node lost leadership (or the client timed it out) before confirmation,
    so serving would risk a stale read."""
    read_index: int
    probe: Optional[int] = None
    confirmed: bool = False
    ready: bool = False
    aborted: bool = False


@dataclass
class InstallSnapshot:
    term: int
    leader: int
    last_index: int
    last_term: int
    payload: Any  # engine-defined snapshot blob (e.g. sorted ValueLog bytes)
    # membership as of last_index — a fresh learner's very first state
    # arrives this way, so the snapshot must carry the config too
    config_index: int = 0
    voters: Tuple[int, ...] = ()
    learners: Tuple[int, ...] = ()
    ctx: int = 0      # trace context of the shipping leader's span


@dataclass
class InstallSnapshotReply:
    term: int
    match_index: int
    ctx: int = 0      # echo of InstallSnapshot.ctx


@dataclass
class TimeoutNow:
    """Leadership transfer (§3.10): the leader tells the best-caught-up
    voter to start an election immediately, stickiness notwithstanding."""
    term: int
    leader: int
    ctx: int = 0      # trace context of the transfer decision


@dataclass
class ShipRun:
    """One chunk of a run-adoption record (leader-driven GC replication).

    `rec` is the adoption record metadata built by the engine when it seals
    a run: kind ('flush'|'merge'), level, (last_index, last_term) run
    boundary, boundary_before/boundary store boundaries, retire identities,
    pos=(leader term, ship epoch), size and nchunks.  Chunks are resumable:
    the follower acks its contiguous prefix and the leader retransmits from
    there, so crashes/partitions/drops mid-ship never lose the record."""
    term: int
    leader: int
    rec: dict
    seq: int          # chunk number, 0-based
    data: bytes


@dataclass
class ShipRunReply:
    term: int
    pos: Tuple[int, int]      # record this reply refers to
    have: int                 # contiguous chunks buffered for that record
    adopted: Tuple[int, int]  # follower's durable ship position
    resync: bool = False      # fence tripped: please InstallSnapshot me


class LogStoreBase:
    """Persistence interface the engines implement."""

    def append(self, entry: LogEntry) -> int:
        raise NotImplementedError

    def append_batch(self, entries: List[LogEntry]) -> List[int]:
        """Group-commit hook: persist a whole batch with one buffered write.
        Engines override to coalesce; the default just loops."""
        return [self.append(e) for e in entries]

    def commit_window(self):
        """Group-commit boundary: make everything appended/applied since the
        last call durable with at most one fsync per underlying file.
        Called by Raft BEFORE acknowledging a batch.  Default: no-op."""

    def truncate_from(self, index: int):
        raise NotImplementedError

    def persist_meta(self, term: int, voted_for: Optional[int],
                     config: Optional[dict] = None):
        pass


class RaftNode:
    def __init__(self, nid: int, peers: List[int], net: SimNet,
                 log_store: LogStoreBase,
                 apply_fn: Callable[[LogEntry, int], None],
                 apply_batch_fn: Optional[
                     Callable[[List[Tuple[LogEntry, int]]], None]] = None,
                 *, seed: int = 0,
                 election_timeout: Tuple[int, int] = (20, 40),
                 heartbeat_every: int = 5,
                 max_entries_per_rpc: int = 64,
                 max_batch: Optional[int] = None,
                 lease_ticks: Optional[int] = None,
                 snapshot_fn: Optional[Callable[[], Optional[Tuple[int, int, Any]]]] = None,
                 install_snapshot_fn: Optional[Callable[[int, int, Any], None]] = None,
                 voters: Optional[List[int]] = None,
                 learners: Optional[List[int]] = None,
                 promote_lag: int = 16,
                 auto_promote: bool = True,
                 group: Optional[int] = None):
        self.nid = nid
        # Multi-Raft: `group` names the shard consensus group this node
        # belongs to.  The protocol below is entirely group-oblivious —
        # nid/peers/quorum stay small local ints — and only the NETWORK
        # boundary translates to the shared SimNet's wire address
        # (group, nid), so many independent groups multiplex over one
        # fabric (see repro/core/shards.py).  group=None keeps the
        # original single-group addressing byte-for-byte.
        self.group = group
        # membership: by default every constructor peer (plus self) is a
        # voter; explicit voters/learners model a node joining an existing
        # cluster (a fresh learner, a restarted member).  self.peers is
        # always derived from the current config = all members minus self.
        if voters is None:
            voters = sorted(set(peers) | {nid})
        self._configs: List[Tuple[int, Tuple[int, ...], Tuple[int, ...]]] = \
            [(0, tuple(sorted(set(voters))),
              tuple(sorted(set(learners or ()) - set(voters))))]
        self.voters: set = set()
        self.learners: set = set()
        self.peers: List[int] = []
        self._set_config()
        self.promote_lag = promote_lag
        self.auto_promote = auto_promote
        self.peer_applied: Dict[int, int] = {}
        self._transfer_until = _NEVER
        self.net = net
        self.store = log_store
        self.apply_fn = apply_fn
        self.apply_batch_fn = apply_batch_fn
        self.snapshot_fn = snapshot_fn
        self.install_snapshot_fn = install_snapshot_fn
        self.rng = random.Random(seed * 7919 + nid)
        self.eto = election_timeout
        self.heartbeat_every = heartbeat_every
        # max_batch governs BOTH entries-per-AppendEntries and the
        # group-commit window (one fsync per window, see client_put_many);
        # max_entries_per_rpc is its default when unset
        self.max_batch = max_batch if max_batch is not None \
            else max_entries_per_rpc
        # leader lease duration; must stay under min(election_timeout) —
        # vote stickiness only shields that long, so a bigger lease would
        # let a rival leader be elected while the old lease reads valid
        self.lease_ticks = lease_ticks if lease_ticks is not None \
            else max(1, election_timeout[0] - heartbeat_every)
        if self.lease_ticks >= election_timeout[0]:
            # correctness invariant, not a debug check (asserts vanish
            # under python -O): an oversized lease outlives the vote-
            # stickiness window and re-opens the stale-lease-read hole
            raise ValueError(
                f"lease_ticks={self.lease_ticks} must stay under the "
                f"minimum election timeout {election_timeout[0]} "
                "(lease safety)")

        self.current_term = 0
        self.voted_for: Optional[int] = None
        # in-memory log: entries[i] covers raft index snap_index + 1 + i
        self.entries: List[LogEntry] = []
        self.offsets: List[int] = []
        self.snap_index = 0
        self.snap_term = 0

        self.role = FOLLOWER
        self.commit_index = 0
        self.last_applied = 0
        self.leader_id: Optional[int] = None
        self.next_index: Dict[int, int] = {}
        self.match_index: Dict[int, int] = {}
        self.votes: set = set()
        # run-shipping endpoints (wired by the cluster when the engine has
        # run_shipping enabled): the leader's RunShipper streams sealed-run
        # chunks, the follower's RunAdopter assembles + installs them
        self.shipper = None
        self.adopter = None
        # ReadIndex / lease state (leader-only; see module docstring).
        # _probe_sent maps round id -> send time; _probe_acked / _ack_basis
        # track, per peer, the newest round echoed and the send time of
        # that round (the lease basis).  metrics is wired by the cluster
        # so quorum rounds triggered by reads are byte-counter evidence.
        self.pending_reads: List[ReadHandle] = []
        self.lease_until = _NEVER
        self.metrics = None
        # last time valid leader traffic arrived (AppendEntries /
        # InstallSnapshot / ShipRun in a current term) — the basis for
        # leader stickiness in _on_request_vote, which is what makes the
        # lease sound: no majority can form inside a live leader's lease
        self._last_leader_contact = _NEVER
        self._probe_seq = 0
        self._probe_sent: Dict[int, int] = {}
        self._probe_acked: Dict[int, int] = {}
        self._ack_basis: Dict[int, int] = {}
        self._term_start_index = 0
        self._reset_election_deadline()
        self._next_heartbeat = 0
        # metrics for tests
        self.applied_log: List[Tuple[int, LogEntry]] = []
        self.leadership_history: List[Tuple[int, int]] = []

    # --------------------------------------------------- address plumbing
    @property
    def addr(self):
        """This node's wire address on the SimNet: the bare local id when
        ungrouped, (group, nid) when part of a shard group.  Trace events
        are keyed by addr too, so the causality auditor's per-node state
        is naturally per-group — no cross-group false positives."""
        return self.nid if self.group is None else (self.group, self.nid)

    def _addr(self, peer: int):
        return peer if self.group is None else (self.group, peer)

    def _local(self, src) -> int:
        """Incoming wire address -> local peer id (intra-group only)."""
        return src if self.group is None else src[1]

    def _send(self, dst: int, msg, size: int = 0):
        self.net.send(self.addr, self._addr(dst), msg, size=size)

    # ------------------------------------------------------------- helpers
    def _reset_election_deadline(self):
        self.election_deadline = self.net.time + self.rng.randint(*self.eto)

    @property
    def last_log_index(self) -> int:
        return self.snap_index + len(self.entries)

    def term_at(self, index: int) -> int:
        if index == self.snap_index:
            return self.snap_term
        if index < self.snap_index or index > self.last_log_index:
            return -1
        return self.entries[index - self.snap_index - 1].term

    def entry_at(self, index: int) -> LogEntry:
        return self.entries[index - self.snap_index - 1]

    def _hydrated(self, index: int) -> LogEntry:
        """Lazy-value recovery support: entries restored via header-only
        scans carry value=b'' and are re-read from the log store before
        being replicated to a follower."""
        e = self.entry_at(index)
        if getattr(e, "value_len", 0) and not e.value and \
                hasattr(self.store, "load_full_entry"):
            off = self.offsets[index - self.snap_index - 1]
            full = self.store.load_full_entry(index, off)
            self.entries[index - self.snap_index - 1] = full
            return full
        return e

    def _persist_meta(self):
        self.store.persist_meta(self.current_term, self.voted_for,
                                config=self._meta_config())

    # -------------------------------------------------------- membership
    @property
    def config_index(self) -> int:
        return self._configs[-1][0]

    @property
    def is_voter(self) -> bool:
        return self.nid in self.voters

    def _meta_config(self) -> dict:
        """The config recovery may take as its BASE: the newest one that
        is committed (or snapshot-covered).  An uncommitted config is
        recovered from its durable log entry instead — persisting it as
        the base would make it impossible to roll back after a restart
        when the new leader truncates the suffix that carried it."""
        idx, v, l = self._config_at(max(self.commit_index, self.snap_index))
        return {"index": idx, "voters": list(v), "learners": list(l)}

    def _set_config(self):
        """Derive live membership state from the newest config entry."""
        _, v, l = self._configs[-1]
        self.voters = set(v)
        self.learners = set(l)
        self.peers = sorted((self.voters | self.learners) - {self.nid})

    def _quorum(self, count: int) -> bool:
        return count * 2 > len(self.voters)

    def _config_at(self, index: int) -> Tuple[int, Tuple[int, ...],
                                              Tuple[int, ...]]:
        """Newest config entry at or below `index` (for snapshots)."""
        best = self._configs[0]
        for c in self._configs:
            if c[0] <= index:
                best = c
        return best

    def _apply_config_change(self):
        """A config was adopted or rolled back: refresh derived state,
        persist it, and (on the leader) resize replication bookkeeping."""
        self._set_config()
        self._persist_meta()
        if self.role == LEADER:
            for p in self.peers:
                self.next_index.setdefault(p, self.last_log_index + 1)
                self.match_index.setdefault(p, 0)
            gone = (set(self.next_index) | set(self.match_index)) \
                - set(self.peers) - {self.nid}
            for g in gone:
                self.next_index.pop(g, None)
                self.match_index.pop(g, None)
                self._probe_acked.pop(g, None)
                self._ack_basis.pop(g, None)
                self.peer_applied.pop(g, None)
            if self.shipper is not None:
                self.shipper.sync_peers()

    def _adopt_config_entry(self, e: LogEntry):
        """Effective on append: the entry's config governs immediately."""
        cfg = json.loads(bytes(e.value).decode())
        self._configs = [c for c in self._configs if c[0] < e.index]
        self._configs.append((e.index, tuple(cfg["voters"]),
                              tuple(cfg["learners"])))
        self._apply_config_change()
        if self.metrics is not None:
            self.metrics.on_membership("config_adopted")

    def _rollback_configs(self, from_index: int):
        """A log suffix was truncated: fall back to the newest config that
        survived (the base entry — snapshot- or meta-backed — always
        does)."""
        if self._configs[-1][0] >= from_index and len(self._configs) > 1:
            self._configs = [self._configs[0]] + \
                [c for c in self._configs[1:] if c[0] < from_index]
            self._apply_config_change()

    def restore_config(self, meta_config: Optional[dict]):
        """Recovery: rebuild the config history from the persisted meta
        base plus any KIND_CONFIG entries surviving in the recovered log
        (persist_meta is ordered after the log append, so the log can run
        ahead of the meta but never behind it)."""
        if meta_config and meta_config.get("voters"):
            base = (int(meta_config.get("index", 0)),
                    tuple(meta_config["voters"]),
                    tuple(meta_config.get("learners", ())))
        else:
            base = self._configs[0]
        cfgs = [base]
        for e in self.entries:
            if e.kind != KIND_CONFIG:
                continue
            e = self._hydrated(e.index)
            if e.index > cfgs[-1][0]:
                cfg = json.loads(bytes(e.value).decode())
                cfgs.append((e.index, tuple(cfg["voters"]),
                             tuple(cfg["learners"])))
        self._configs = cfgs
        self._set_config()

    def propose_config(self, voters, learners) -> Optional[int]:
        """Leader-only single-server membership change.  Refused while the
        previous config entry is uncommitted (at most one in flight) and
        for multi-voter jumps (adjacent configs must share a majority)."""
        if self.role != LEADER:
            return None
        if self._configs[-1][0] > self.commit_index:
            return None                      # one change in flight, max
        voters = tuple(sorted(set(voters)))
        learners = tuple(sorted(set(learners) - set(voters)))
        cur_v = tuple(sorted(self.voters))
        cur_l = tuple(sorted(self.learners))
        if (voters, learners) == (cur_v, cur_l):
            return self.config_index         # no-op: already in effect
        if len(set(voters) ^ set(cur_v)) > 1:
            raise ValueError("only single-server voter changes are safe "
                             f"({cur_v} -> {voters})")
        payload = json.dumps({"voters": list(voters),
                              "learners": list(learners)}).encode()
        entry = LogEntry(self.current_term, self.last_log_index + 1,
                         KIND_CONFIG, b"", payload)
        off = self.store.append(entry)
        self.store.commit_window()           # durable before ack
        if _trace._ACTIVE is not None:
            _trace._ACTIVE.event("durable", self.addr, entry.index)
        self.entries.append(entry)
        self.offsets.append(off)
        self.match_index[self.nid] = self.last_log_index
        self._adopt_config_entry(entry)      # effective on append
        if self.metrics is not None:
            self.metrics.on_membership("config_proposed")
        self._advance_commit()
        self._broadcast_append()
        self._next_heartbeat = self.net.time + self.heartbeat_every
        return entry.index

    def propose_add_learner(self, nid: int) -> Optional[int]:
        if nid in self.voters or nid in self.learners:
            return self.config_index
        return self.propose_config(self.voters, set(self.learners) | {nid})

    def propose_promote(self, nid: int) -> Optional[int]:
        if nid in self.voters:
            return self.config_index
        if nid not in self.learners:
            return None
        return self.propose_config(set(self.voters) | {nid},
                                   set(self.learners) - {nid})

    def propose_remove(self, nid: int) -> Optional[int]:
        if nid not in self.voters and nid not in self.learners:
            return self.config_index
        return self.propose_config(set(self.voters) - {nid},
                                   set(self.learners) - {nid})

    def _maybe_promote(self):
        """Leader tick: promote the first learner whose applied index has
        caught up — it must have applied the config that added it AND sit
        within promote_lag of our commit index."""
        if self.role != LEADER or not self.auto_promote or not self.learners:
            return
        if self._configs[-1][0] > self.commit_index:
            return                           # a change is already in flight
        for lid in sorted(self.learners):
            ap = self.peer_applied.get(lid, _NEVER)
            if ap >= self.config_index and \
                    ap + self.promote_lag >= self.commit_index:
                if self.propose_promote(lid) is not None and \
                        self.metrics is not None:
                    self.metrics.on_membership("promote")
                return

    def transfer_leadership(self, to: Optional[int] = None) -> Optional[int]:
        """Graceful handoff: pick the best-caught-up voter (unless told),
        kill our own lease so no LEASE read straddles the change, and send
        TimeoutNow.  We keep leading until the target's election deposes
        us; if it never does, leases resume after one election timeout."""
        if self.role != LEADER:
            return None
        cands = [v for v in self.voters if v != self.nid]
        if not cands:
            return None
        if to is None or to not in cands:
            to = max(cands, key=lambda p: (self.match_index.get(p, 0), -p))
        self._transfer_until = self.net.time + self.eto[0]
        self._abort_reads()                  # lease dies at send time
        t = _trace._ACTIVE
        self._send(to, TimeoutNow(
            self.current_term, self.nid,
            ctx=t.current() if t is not None else 0))
        if self.metrics is not None:
            self.metrics.on_membership("transfer")
        return to

    def _on_timeout_now(self, src: int, m: TimeoutNow):
        if m.term < self.current_term:
            return
        if m.term > self.current_term:
            self._become_follower(m.term)
        if self.role == LEADER or self.nid not in self.voters:
            return
        self._last_leader_contact = _NEVER   # the leader ASKED for this
        t = _trace._ACTIVE
        sid = t.begin("timeout_now", kind="raft", node=self.addr,
                      parent=m.ctx,
                      old_leader=self._addr(src)) if t is not None else None
        self._start_election(transfer=True)
        if sid is not None:
            t.end(sid)

    def _step_down(self):
        """We led a cluster we are no longer a voter of and the removal
        config just committed: stop leading (keep term and vote — clearing
        voted_for inside a term could double-grant)."""
        self.role = FOLLOWER
        self.leader_id = None
        self._abort_reads()
        self._reset_election_deadline()

    def _become_follower(self, term: int):
        self.current_term = term
        self.role = FOLLOWER
        self.voted_for = None
        self.votes = set()
        self._abort_reads()   # a deposed leader must refuse pending reads
        self._persist_meta()
        # NOTE: no election-deadline reset here.  The timer resets only on
        # granting a vote or on valid leader traffic (AppendEntries /
        # InstallSnapshot / ShipRun); a bare term bump must not — otherwise
        # a disruptive candidate with a stale log and a short timeout can
        # reset everyone forever and no electable node ever stands.

    # ------------------------------------------------------- read tiers
    def _abort_reads(self):
        """Leadership is gone (or never confirmed): every queued read is
        refused rather than risk serving stale state, and the lease dies."""
        for h in self.pending_reads:
            h.aborted = True
        self.pending_reads = []
        self.lease_until = _NEVER
        self._probe_acked = {}
        self._ack_basis = {}

    def read_index_submit(self) -> Optional[ReadHandle]:
        """LINEARIZABLE tier: queue a ReadIndex read.  The read index is
        the current commit index, floored at this term's no-op barrier —
        before the barrier commits the leader cannot know its commit index
        is up to date (Raft §8 / §6.4).  One heartbeat-quorum round on the
        next tick confirms leadership for the whole queue."""
        if self.role != LEADER:
            return None
        return_index = max(self.commit_index, self._term_start_index)
        h = ReadHandle(read_index=return_index)
        self.pending_reads.append(h)
        return h

    def lease_valid(self) -> bool:
        """LEASE tier: may this node serve a local read with no quorum
        round right now?  Requires leadership, the term barrier committed
        (same reason as ReadIndex), and — with peers — a lease renewed by
        a recent heartbeat-quorum ack basis."""
        if self.role != LEADER or self.commit_index < self._term_start_index:
            return False
        if self.nid not in self.voters or \
                self.net.time < self._transfer_until:
            # a demoted leader, or one mid-transfer, must not serve local
            # reads — its replacement may already be elected
            return False
        voter_peers = [v for v in self.voters if v != self.nid]
        return not voter_peers or self.net.time < self.lease_until

    def _refresh_lease(self):
        """Lease = (send time of the newest probe a MAJORITY of VOTERS has
        acked, self included) + lease_ticks.  Sort voter ack bases
        descending and take the quorum-th: every node in that set accepted
        our leadership no earlier than that instant."""
        voter_peers = [v for v in self.voters if v != self.nid]
        if not voter_peers or self.net.time < self._transfer_until:
            return
        bases = sorted((self._ack_basis.get(p, _NEVER)
                        for p in voter_peers), reverse=True)
        # voters needed beyond self (self only counts if still a voter)
        need = len(self.voters) // 2 + 1 \
            - (1 if self.nid in self.voters else 0)
        basis = bases[need - 1] if need >= 1 else self.net.time
        if basis > _NEVER:
            self.lease_until = max(self.lease_until,
                                   basis + self.lease_ticks)

    def _dispatch_read_round(self):
        """Assign every not-yet-assigned pending read to ONE fresh
        heartbeat round — the batching that makes ReadIndex cheap: a
        queue of N reads costs one quorum round, not N."""
        if not any(h.probe is None for h in self.pending_reads):
            return False
        self._broadcast_append()
        for h in self.pending_reads:
            if h.probe is None:
                h.probe = self._probe_seq
        if self.metrics is not None:
            self.metrics.on_read_quorum_round()
        self._check_read_quorum()   # single-node: quorum of 1, instantly
        return True

    def _check_read_quorum(self):
        for h in self.pending_reads:
            if h.probe is not None and not h.confirmed:
                acks = sum(1 for v in self.voters
                           if v == self.nid or
                           self._probe_acked.get(v, 0) >= h.probe)
                if self._quorum(acks):
                    h.confirmed = True
        self._serve_ready_reads()

    def _serve_ready_reads(self):
        keep = []
        for h in self.pending_reads:
            if h.confirmed and self.last_applied >= h.read_index:
                h.ready = True
            elif not h.aborted:
                keep.append(h)
        self.pending_reads = keep

    # ------------------------------------------------------------ client
    def client_put(self, key: bytes, value: bytes) -> Optional[int]:
        """Leader-only. Appends + persists once; returns the raft index."""
        if self.role != LEADER:
            return None
        entry = LogEntry(self.current_term, self.last_log_index + 1,
                         KIND_PUT, key, value)
        t = _trace._ACTIVE
        sid = t.begin("raft.append", kind="raft", node=self.addr,
                      index=entry.index) if t is not None else None
        off = self.store.append(entry)           # THE single persistence
        self.store.commit_window()               # durable before ack
        if t is not None:
            t.event("durable", self.addr, entry.index)
            t.register_index(entry.index, group=self.group)
            t.end(sid)
        self.entries.append(entry)
        self.offsets.append(off)
        self.match_index[self.nid] = self.last_log_index
        self._advance_commit()   # single-voter configs self-commit here
        return entry.index

    def client_put_many(self, items: List[Tuple[bytes, bytes]]
                        ) -> Optional[List[int]]:
        """Leader-only group commit: the whole batch is persisted with one
        buffered write + one fsync per store (append_batch/commit_window),
        then shipped to followers immediately in max_batch-sized
        AppendEntries instead of waiting for the next heartbeat."""
        if self.role != LEADER:
            return None
        entries = []
        base = self.last_log_index
        for i, (key, value) in enumerate(items):
            entries.append(LogEntry(self.current_term, base + 1 + i,
                                    KIND_PUT, key, value))
        t = _trace._ACTIVE
        sid = t.begin("raft.append_batch", kind="raft", node=self.addr,
                      n=len(entries)) if t is not None else None
        offs = self.store.append_batch(entries)  # ONE persistence pass
        self.store.commit_window()               # ONE fsync per store
        if t is not None:
            t.event("durable", self.addr, entries[-1].index if entries
                    else base)
            for e in entries:
                t.register_index(e.index, group=self.group)
            t.end(sid)
        self.entries.extend(entries)
        self.offsets.extend(offs)
        self.match_index[self.nid] = self.last_log_index
        self._advance_commit()   # single-voter configs self-commit here
        # eager dispatch: a full window should not wait for the heartbeat
        self._broadcast_append()
        self._next_heartbeat = self.net.time + self.heartbeat_every
        return [e.index for e in entries]

    # -------------------------------------------------------------- tick
    def tick(self):
        if self.addr in self.net.down:
            return
        for src, msg in self.net.deliver(self.addr):
            self._handle(self._local(src), msg)
        now = self.net.time
        if self.role == LEADER:
            # a queued ReadIndex batch rides its own round immediately
            # (read latency should not wait for the heartbeat timer); the
            # round doubles as the heartbeat
            if self._dispatch_read_round():
                self._next_heartbeat = now + self.heartbeat_every
            elif now >= self._next_heartbeat:
                self._broadcast_append()
                self._next_heartbeat = now + self.heartbeat_every
            if self.shipper is not None:
                self.shipper.tick()
            self._maybe_promote()
        elif self.nid in self.voters and now >= self.election_deadline:
            # learners and removed nodes never campaign
            self._start_election()
        self._apply_committed()
        if self.role == LEADER:
            self._serve_ready_reads()
        if self.adopter is not None and self.role != LEADER:
            self.adopter.tick()   # install pending records once applied

    # ---------------------------------------------------------- election
    def _vote_quorum(self) -> bool:
        return self._quorum(len(self.votes & self.voters))

    def _start_election(self, transfer: bool = False):
        if self.nid not in self.voters:
            return                       # a non-voter can never lead
        self.role = CANDIDATE
        self.current_term += 1
        self.voted_for = self.nid
        self._abort_reads()
        self._persist_meta()
        self.votes = {self.nid}
        self._reset_election_deadline()
        for p in sorted(self.voters - {self.nid}):
            self._send(p, RequestVote(
                self.current_term, self.nid, self.last_log_index,
                self.term_at(self.last_log_index), transfer=transfer))
        if self._vote_quorum():
            self._become_leader()

    def _become_leader(self):
        self.role = LEADER
        self.leader_id = self.nid
        self.leadership_history.append((self.current_term, self.nid))
        self.next_index = {p: self.last_log_index + 1 for p in self.peers}
        self.match_index = {p: 0 for p in self.peers}
        self.match_index[self.nid] = self.last_log_index
        # fresh term: no lease, no probe acks, no transfer carry over
        self.lease_until = _NEVER
        self._probe_acked = {}
        self._ack_basis = {}
        self.peer_applied = {}
        self._transfer_until = _NEVER
        # no-op barrier entry to commit previous-term entries (Raft §8);
        # its index is also the floor for every ReadIndex in this term
        entry = LogEntry(self.current_term, self.last_log_index + 1,
                         KIND_NOOP, b"", b"")
        self._term_start_index = entry.index
        off = self.store.append(entry)
        self.store.commit_window()
        if _trace._ACTIVE is not None:
            _trace._ACTIVE.event("durable", self.addr, entry.index)
        self.entries.append(entry)
        self.offsets.append(off)
        self.match_index[self.nid] = self.last_log_index
        self._advance_commit()   # single-voter configs self-commit here
        self._broadcast_append()
        self._next_heartbeat = self.net.time + self.heartbeat_every

    # --------------------------------------------------------- replication
    def _broadcast_append(self):
        """One full round = one probe: each broadcast opens a fresh probe
        id whose echoes confirm leadership (ReadIndex) and renew the lease
        from the round's send time."""
        self._probe_seq += 1
        self._probe_sent[self._probe_seq] = self.net.time
        if len(self._probe_sent) > 128:   # bounded: old rounds are dead
            for k in sorted(self._probe_sent)[:-64]:
                del self._probe_sent[k]
        for p in self.peers:
            self._send_append(p)

    def send_snapshot_to(self, peer: int) -> bool:
        """Ship the engine's snapshot (whole run set) to one peer — used
        for log catch-up and as run shipping's fence-mismatch fallback."""
        if self.snapshot_fn is None:
            return False
        snap = self.snapshot_fn()
        if snap is None:
            return False
        li, lt, payload = snap
        ci, cv, cl = self._config_at(li)
        t = _trace._ACTIVE
        self._send(peer, InstallSnapshot(
            self.current_term, self.nid, li, lt, payload,
            config_index=ci, voters=cv, learners=cl,
            ctx=t.current() if t is not None else 0))
        if self.shipper is not None:
            # the snapshot carries the whole current run set: skip the
            # peer's shipping cursor past every record it supersedes,
            # once the matching install ack comes back
            self.shipper.on_snapshot_sent(peer, li)
        return True

    def _send_append(self, peer: int):
        ni = self.next_index.get(peer, self.last_log_index + 1)
        if ni <= self.snap_index:
            # follower is behind our snapshot -> ship it
            if self.send_snapshot_to(peer):
                return
            ni = self.snap_index + 1  # fallback (shouldn't happen)
        prev = ni - 1
        ents = [self._hydrated(i) for i in
                range(ni, min(self.last_log_index,
                              ni + self.max_batch - 1) + 1)]
        size = sum(len(e.key) + len(e.value) + 19 for e in ents)
        t = _trace._ACTIVE
        ctx = t.ctx_for_range(ents[0].index, ents[-1].index,
                              group=self.group) \
            if (t is not None and ents) else 0
        self._send(peer, AppendEntries(
            self.current_term, self.nid, prev, self.term_at(prev), ents,
            self.commit_index, probe=self._probe_seq, ctx=ctx), size=size)

    def _handle(self, src: int, msg):
        if isinstance(msg, RequestVote):
            self._on_request_vote(src, msg)
        elif isinstance(msg, RequestVoteReply):
            self._on_vote_reply(src, msg)
        elif isinstance(msg, AppendEntries):
            self._on_append(src, msg)
        elif isinstance(msg, AppendEntriesReply):
            self._on_append_reply(src, msg)
        elif isinstance(msg, InstallSnapshot):
            self._on_install_snapshot(src, msg)
        elif isinstance(msg, InstallSnapshotReply):
            self._on_snapshot_reply(src, msg)
        elif isinstance(msg, TimeoutNow):
            self._on_timeout_now(src, msg)
        elif isinstance(msg, ShipRun):
            if self.adopter is not None:
                self.adopter.on_chunk(src, msg)
        elif isinstance(msg, ShipRunReply):
            if self.shipper is not None:
                self.shipper.on_reply(src, msg)

    def _note_leader_contact(self):
        """Valid leader traffic: reset the election timer AND remember the
        contact time for vote stickiness."""
        self._last_leader_contact = self.net.time
        self._reset_election_deadline()

    def _on_request_vote(self, src: int, m: RequestVote):
        if m.candidate not in self.voters:
            # Thesis §4.2.3: per our config this server cannot lead.  A
            # removed node's runaway term must not disturb the live
            # quorum, so we do not even adopt its term — total silence.
            return
        if not m.transfer and \
                self.net.time - self._last_leader_contact < self.eto[0]:
            # Leader stickiness (Raft §9.6 / thesis §4.2.3): we heard from
            # a live leader within the minimum election timeout, so we
            # disregard the request ENTIRELY — no term adoption, no vote.
            # Without this, a follower whose probe acks are renewing the
            # leader's lease could simultaneously vote a new leader in,
            # and a LEASE read on the old leader would serve stale data
            # inside its supposedly-safe window.
            return
        if m.term > self.current_term:
            self._become_follower(m.term)
        granted = False
        if m.term == self.current_term and self.voted_for in (None, m.candidate):
            my_last_term = self.term_at(self.last_log_index)
            up_to_date = (m.last_log_term, m.last_log_index) >= \
                (my_last_term, self.last_log_index)
            if up_to_date:
                granted = True
                self.voted_for = m.candidate
                self._persist_meta()
                self._reset_election_deadline()
        self._send(src, RequestVoteReply(self.current_term, granted))

    def _on_vote_reply(self, src: int, m: RequestVoteReply):
        if m.term > self.current_term:
            self._become_follower(m.term)
            return
        if self.role != CANDIDATE or m.term != self.current_term:
            return
        if m.granted:
            self.votes.add(src)
            if self._vote_quorum():   # only votes from voters count
                self._become_leader()

    def _on_append(self, src: int, m: AppendEntries):
        if m.term > self.current_term:
            self._become_follower(m.term)
        if m.term < self.current_term:
            self._send(src, AppendEntriesReply(
                self.current_term, False, 0))
            return
        if self.role == LEADER:
            # a second leader in our own term is impossible; reaching here
            # means m.term == current_term while we lead — never true, but
            # stepping down must abort reads if it ever becomes reachable
            self._abort_reads()
        self.role = FOLLOWER
        self.leader_id = m.leader
        self._note_leader_contact()
        # log consistency check — still echoes the probe: even a failed
        # consistency check acknowledges the sender's leadership
        if m.prev_log_index > self.last_log_index or \
                self.term_at(m.prev_log_index) != m.prev_log_term:
            self._send(src, AppendEntriesReply(
                self.current_term, False, self.snap_index, probe=m.probe,
                applied=self.last_applied))
            return
        # skip the prefix we already hold (snapshot-covered or term-matching)
        start = 0
        while start < len(m.entries):
            idx = m.prev_log_index + 1 + start
            if idx <= self.snap_index or \
                    (idx <= self.last_log_index and
                     self.term_at(idx) == m.entries[start].term):
                start += 1
            else:
                break
        t = _trace._ACTIVE
        if start < len(m.entries):
            idx = m.prev_log_index + 1 + start
            # graft this follower's durability work onto the originating
            # op's span (m.ctx crossed the wire); ctx 0 (no originating
            # client op — e.g. a no-op barrier) makes it a root span
            sid = t.begin("follower.append", kind="raft", node=self.addr,
                          parent=m.ctx, n=len(m.entries) - start,
                          first=idx) if t is not None else None
            if idx <= self.last_log_index:
                # conflict: truncate our log from idx, once
                keep = idx - self.snap_index - 1
                if keep < len(self.offsets):
                    self.store.truncate_from(idx)
                self.entries = self.entries[:keep]
                self.offsets = self.offsets[:keep]
                self._rollback_configs(idx)
            batch = m.entries[start:]
            offs = self.store.append_batch(batch)  # single persistence pass
            self.entries.extend(batch)
            self.offsets.extend(offs)
            self.store.commit_window()             # durable before the ack
            if t is not None:
                t.event("durable", self.addr, batch[-1].index)
                t.end(sid)
            for e in batch:
                if e.kind == KIND_CONFIG:          # effective on append
                    self._adopt_config_entry(e)
        idx = m.prev_log_index + len(m.entries)
        if m.leader_commit > self.commit_index:
            self.commit_index = min(m.leader_commit, self.last_log_index)
            if t is not None:
                t.event("commit_learned", self.addr, self.commit_index,
                        leader=self._addr(m.leader))
        self._apply_committed()
        if t is not None:
            t.event("ack_sent", self.addr, idx, to=self._addr(src))
        self._send(src, AppendEntriesReply(
            self.current_term, True, idx, probe=m.probe,
            applied=self.last_applied, ctx=m.ctx))

    def _on_append_reply(self, src: int, m: AppendEntriesReply):
        if m.term > self.current_term:
            self._become_follower(m.term)
            return
        if self.role != LEADER or m.term != self.current_term:
            return
        # probe echo: leadership acknowledged as of the round's send time
        # (success or not), driving ReadIndex confirmation + lease renewal
        if m.applied > self.peer_applied.get(src, _NEVER):
            self.peer_applied[src] = m.applied   # learner promotion gauge
        if m.probe and m.probe > self._probe_acked.get(src, 0):
            self._probe_acked[src] = m.probe
            basis = self._probe_sent.get(m.probe)
            if basis is not None and \
                    basis > self._ack_basis.get(src, _NEVER):
                self._ack_basis[src] = basis
                self._refresh_lease()
            self._check_read_quorum()
        if m.success:
            if _trace._ACTIVE is not None:
                _trace._ACTIVE.event("ack_recv", self.addr, m.match_index,
                                     **{"from": self._addr(src)})
            self.match_index[src] = max(self.match_index.get(src, 0),
                                        m.match_index)
            self.next_index[src] = self.match_index[src] + 1
            self._advance_commit()
            if self.next_index[src] <= self.last_log_index:
                self._send_append(src)
        else:
            self.next_index[src] = max(
                1, min(self.next_index.get(src, 1) - self.max_batch,
                       m.match_index + 1))
            self._send_append(src)

    def _advance_commit(self):
        for n in range(self.last_log_index, self.commit_index, -1):
            if self.term_at(n) != self.current_term:
                break
            # quorum over the CURRENT voter set — a config entry commits
            # under itself (effective on append); learners never count
            votes = sum(1 for v in self.voters
                        if self.match_index.get(v, 0) >= n)
            if self._quorum(votes):
                self.commit_index = n
                if _trace._ACTIVE is not None:
                    _trace._ACTIVE.event("commit", self.addr, n,
                                         voters=[self._addr(v) for v
                                                 in sorted(self.voters)])
                break
        if self.role == LEADER and self.nid not in self.voters and \
                self.config_index <= self.commit_index:
            # we led the removal of ourselves and it just committed
            self._step_down()
        self._apply_committed()

    def _apply_committed(self):
        before = self.last_applied
        batch: List[Tuple[LogEntry, int]] = []
        while self.last_applied < self.commit_index:
            self.last_applied += 1
            if self.last_applied <= self.snap_index:
                continue
            e = self.entry_at(self.last_applied)
            off = self.offsets[self.last_applied - self.snap_index - 1]
            if e.kind == KIND_PUT:
                batch.append((e, off))
            self.applied_log.append((self.last_applied, e))
        t = _trace._ACTIVE
        if batch:
            sid = None
            if t is not None:
                # graft the apply under the newest originating op in the
                # drain (cross-node: the registry is tracer-global)
                sid = t.begin("apply", kind="apply", node=self.addr,
                              parent=t.ctx_for_range(
                                  batch[0][0].index,
                                  batch[-1][0].index,
                                  group=self.group),
                              n=len(batch))
            # whole drain applied as one group: engines coalesce the index
            # WAL records into one buffered write...
            if self.apply_batch_fn is not None:
                self.apply_batch_fn(batch)
            else:
                for e, off in batch:
                    self.apply_fn(e, off)
            # ...and ONE fsync for the window, not one per entry
            self.store.commit_window()
            if sid is not None:
                t.end(sid)
        if t is not None and self.last_applied > before:
            t.event("apply", self.addr, self.last_applied)

    # ----------------------------------------------------------- snapshot
    def repoint_offsets(self, new_offsets: Optional[Dict[int, int]]):
        """The engine rewrote part of its log store (tail rotation on run
        adoption / snapshot install): update the in-memory log's offsets
        for every surviving index it re-homed."""
        for i, off in (new_offsets or {}).items():
            p = i - self.snap_index - 1
            if 0 <= p < len(self.offsets):
                self.offsets[p] = off

    def compact_to(self, index: int, term: int):
        """Drop in-memory log prefix covered by an engine snapshot."""
        if index <= self.snap_index:
            return
        keep = index - self.snap_index
        self.entries = self.entries[keep:]
        self.offsets = self.offsets[keep:]
        self.snap_index = index
        self.snap_term = term
        # collapse config history the snapshot now covers into one base,
        # and pin it in the meta: the log entries that carried it are
        # gone, so recovery can no longer replay it from the log
        base = self._config_at(index)
        self._configs = [base] + [c for c in self._configs if c[0] > index]
        self._persist_meta()

    def _on_install_snapshot(self, src: int, m: InstallSnapshot):
        if m.term > self.current_term:
            self._become_follower(m.term)
        if m.term < self.current_term:
            return
        self.role = FOLLOWER
        self.leader_id = m.leader
        self._note_leader_contact()
        if m.last_index <= self.snap_index:
            # already at (or past) this state: ack it anyway so the leader
            # advances, and clear any adoption stuck waiting for a resync
            if self.adopter is not None:
                self.adopter.reset()
            self._send(src, InstallSnapshotReply(
                self.current_term, self.snap_index, ctx=m.ctx))
            return
        # Raft §7: when our log already holds the snapshot's last entry,
        # retain the suffix past it — a resync snapshot may lag entries we
        # have applied, and dropping them would regress the state machine
        keep_suffix = (m.last_index <= self.last_log_index and
                       self.term_at(m.last_index) == m.last_term)
        t = _trace._ACTIVE
        sid = t.begin("install_snapshot", kind="raft", node=self.addr,
                      parent=m.ctx, last_index=m.last_index,
                      keep_suffix=keep_suffix) if t is not None else None
        new_offsets = None
        if self.install_snapshot_fn is not None:
            new_offsets = self.install_snapshot_fn(m.last_index, m.last_term,
                                                   m.payload,
                                                   keep_tail=keep_suffix)
        if t is not None:
            t.event("snapshot_install", self.addr, m.last_index,
                    leader=self._addr(src))
            t.end(sid)
        if self.adopter is not None:
            self.adopter.reset()   # the snapshot supersedes in-flight ships
        if keep_suffix:
            drop = m.last_index - self.snap_index
            self.entries = self.entries[drop:]
            self.offsets = self.offsets[drop:]
        else:
            self.entries = []
            self.offsets = []
        self.snap_index = m.last_index
        self.snap_term = m.last_term
        # the engine rewrote the retained tail into a fresh segment:
        # re-point the surviving log at the new offsets
        self.repoint_offsets(new_offsets)
        if m.voters:
            # the snapshot's config becomes our base; configs from a
            # retained suffix stay stacked on top of it
            tail = [c for c in self._configs if c[0] > m.last_index] \
                if keep_suffix else []
            self._configs = [(m.config_index, tuple(m.voters),
                              tuple(m.learners))] + tail
            self._apply_config_change()
        self.commit_index = max(self.commit_index, m.last_index)
        self.last_applied = max(self.last_applied, m.last_index)
        self._send(src, InstallSnapshotReply(
            self.current_term, m.last_index, ctx=m.ctx))

    def _on_snapshot_reply(self, src: int, m: InstallSnapshotReply):
        if self.role != LEADER:
            return
        if _trace._ACTIVE is not None:
            # an installed snapshot is durable applied state: it counts
            # as this peer's ack for everything through match_index
            _trace._ACTIVE.event("ack_recv", self.addr, m.match_index,
                                 **{"from": self._addr(src)})
        self.match_index[src] = max(self.match_index.get(src, 0),
                                    m.match_index)
        self.next_index[src] = self.match_index[src] + 1
        if m.match_index > self.peer_applied.get(src, _NEVER):
            # an installed snapshot IS applied state through its index
            self.peer_applied[src] = m.match_index
        if self.shipper is not None:
            self.shipper.on_snapshot_acked(src, m.match_index)
