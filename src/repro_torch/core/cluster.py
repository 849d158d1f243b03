"""In-process Raft cluster: N nodes, each with its own engine directory and
byte-accounted metrics; deterministic fault injection (crash / restart /
partition).

Client operations are thin wrappers over the consistency-tiered
NezhaClient (repro.core.client): writes loop-retry through the leader,
reads default to LINEARIZABLE (ReadIndex) and accept
`consistency=`/`session=`/`node=` for the LEASE and SESSION tiers —
`Cluster.get`/`scan` no longer touch any engine directly, because a
deposed leader's engine can serve stale state (see
tests/test_client_reads.py for the regression that proves it).

Recovery semantics: a restarted node reloads its engine from disk
(engine.recover()), reconstructs the Raft log tail, and re-applies committed
entries — exactly the replay the paper times in Fig. 11 (Nezha replays
lightweight offsets, Original replays full values through the WAL path).

Copied from ``src/repro/core/cluster.py``; only the import prefix differs.
"""
from __future__ import annotations

import json
import os
import shutil
import time
from typing import Dict, List, Optional, Tuple

from repro_torch.core import faultfs
from repro_torch.core import trace as _trace
from repro_torch.core.client import NezhaClient, Session
from repro_torch.core.engines import ENGINES, NezhaEngine
from repro_torch.core.faultfs import write_json_atomic
from repro_torch.core.metrics import Metrics
from repro_torch.core.raft import LEADER, RaftNode
from repro_torch.core.shipping import RunAdopter, RunShipper
from repro_torch.core.simnet import SimNet


class Cluster:
    def __init__(self, n: int = 3, engine: str = "nezha", workdir: str = "",
                 seed: int = 0, sync: bool = False, leader_hint: int = 0,
                 engine_kwargs: Optional[dict] = None, heartbeat_every: int = 5,
                 election_timeout=(20, 40), max_batch: int = 64,
                 drop_prob: float = 0.0, lease_ticks: Optional[int] = None,
                 default_consistency: str = "linearizable",
                 recover: bool = False, promote_lag: int = 16,
                 auto_promote: bool = True,
                 group: Optional[int] = None,
                 net: Optional[SimNet] = None):
        self.engine_name = engine
        self.workdir = workdir
        self.seed = seed
        self.sync = sync
        self.engine_kwargs = engine_kwargs or {}
        self.heartbeat_every = heartbeat_every
        self.election_timeout = election_timeout
        self.max_batch = max_batch
        self.lease_ticks = lease_ticks
        self.promote_lag = promote_lag
        self.auto_promote = auto_promote
        os.makedirs(workdir, exist_ok=True)
        # membership state: ids removed from the config (their address is
        # dead forever) and, per node, the config it was CONSTRUCTED with
        # — the recovery fallback when a node crashed before persisting
        # any raft meta.  Both live in the cluster manifest so a full
        # restart (recover=True) rebuilds the right shape.
        self.removed: set = set()
        self._construct_cfg: Dict[int, dict] = {}
        if recover:
            man = self._load_manifest()
            if man is not None:
                n = man["n"]
                self.removed = set(man.get("removed", []))
                self._construct_cfg = {int(k): dict(v) for k, v in
                                       man.get("configs", {}).items()}
        self.n = n
        # Multi-Raft: `group` scopes this cluster to one shard consensus
        # group of a larger fabric (repro/core/shards.py).  With group
        # set, wire addresses become (group, nid) and the SimNet is
        # usually SHARED — we register our addresses on it but do not own
        # its clock: tick() is delegated to the fabric owner
        # (_tick_parent) so local wait loops (elect, client retries,
        # drain_shipping) keep every group's nodes live.
        self.group = group
        self._owns_net = net is None
        self._tick_parent = None
        if net is None:
            self.net = SimNet([self.addr(i) for i in range(n)], seed=seed,
                              drop_prob=drop_prob)
        else:
            self.net = net
            for i in range(n):
                self.net.add_node(self.addr(i))
        for r in self.removed:
            self.net.remove_node(self.addr(r))
        self.metrics: List[Metrics] = [Metrics(node=self.addr(i))
                                       for i in range(n)]
        self.engines: List = [None] * n
        self.nodes: List[Optional[RaftNode]] = [None] * n
        self.leader_hint = leader_hint
        # recover=True: full-cluster restart — every node rebuilds from
        # whatever its directory holds (the durability-gate path; workdir
        # must be a previous cluster's workdir)
        for i in range(n):
            if i in self.removed:
                continue        # a removed member stays removed
            self._make_node(i, fresh=not recover)
        self._save_manifest()
        self.client = NezhaClient(self,
                                  default_consistency=default_consistency)

    # ------------------------------------------------------------ plumbing
    def addr(self, i: int):
        """Wire address of local node id i on the (possibly shared) net."""
        return i if self.group is None else (self.group, i)

    def _local_ids(self, addrs) -> List[int]:
        """Filter wire addresses down to THIS group's local ids — keeps
        shared-net health reports per-group (and sortable)."""
        if self.group is None:
            return [a for a in addrs if not isinstance(a, tuple)]
        return [a[1] for a in addrs
                if isinstance(a, tuple) and a[0] == self.group]

    def _engine_dir(self, i: int) -> str:
        return os.path.join(self.workdir, f"node{i}")

    def _manifest_path(self) -> str:
        return os.path.join(self.workdir, "cluster.json")

    def _save_manifest(self):
        write_json_atomic(self._manifest_path(), {
            "n": self.n,
            "removed": sorted(self.removed),
            "configs": {str(i): c for i, c in self._construct_cfg.items()},
        })

    def _load_manifest(self) -> Optional[dict]:
        p = self._manifest_path()
        if not os.path.exists(p):
            return None
        with open(p) as f:
            return json.load(f)

    def _make_node(self, i: int, fresh: bool,
                   voters: Optional[List[int]] = None,
                   learners: Optional[List[int]] = None):
        cls = ENGINES[self.engine_name]
        eng = cls(self._engine_dir(i), self.metrics[i], sync=self.sync,
                  is_leader=(lambda i=i: i == self.leader_hint),
                  **self.engine_kwargs)
        self.engines[i] = eng
        eto = self.election_timeout
        if fresh:
            self._construct_cfg[i] = {
                "voters": sorted(voters) if voters is not None
                else sorted(range(self.n)),
                "learners": sorted(learners or [])}
        cc = self._construct_cfg.get(i)
        node = RaftNode(
            i, list(range(self.n)), self.net, eng, eng.apply,
            apply_batch_fn=getattr(eng, "apply_batch", None),
            seed=self.seed, election_timeout=eto,
            heartbeat_every=self.heartbeat_every,
            max_batch=self.max_batch,
            lease_ticks=self.lease_ticks,
            snapshot_fn=eng.snapshot,
            install_snapshot_fn=getattr(eng, "install_snapshot", None),
            voters=(cc["voters"] if cc else None),
            learners=(cc["learners"] if cc else None),
            promote_lag=self.promote_lag,
            auto_promote=self.auto_promote,
            group=self.group)
        node.metrics = self.metrics[i]   # read-tier evidence (quorum rounds)
        # deterministic first leader: the hinted node's FIRST deadline
        # fires early; every later reset uses the full election timeout.
        # (Permanently halving its timeout — the old scheme — would let a
        # node stand for election inside another leader's lease window,
        # which must stay < the minimum election timeout to be safe.)
        # Fresh construction only: a RESTARTED hint node must come back
        # with the full timeout for exactly the same reason.
        if fresh and i == self.leader_hint:
            node.election_deadline = self.net.time + \
                node.rng.randint(eto[0] // 2, eto[0] // 2 + 2)
        if isinstance(eng, NezhaEngine):
            eng.on_snapshot = node.compact_to
            if eng.run_shipping:
                # replication tier 2: the leader's sealed runs stream to
                # followers as adoption records instead of each node
                # re-running GC (see repro/core/shipping.py)
                node.shipper = RunShipper(node, eng, self.metrics[i])
                node.adopter = RunAdopter(node, eng, self.metrics[i])
                eng.ship_hook = node.shipper.on_run_sealed
                eng.raft_role = (lambda node=node: node.role == LEADER)
        self.nodes[i] = node
        if not fresh:
            # restart vote stickiness: before crashing, this node's probe
            # acks may have renewed a lease that is STILL live, but its
            # in-memory last-leader-contact is gone.  Treat startup as
            # leader contact so it disregards RequestVote for one minimum
            # election timeout (>= any lease it could have renewed) —
            # otherwise a restarted follower could vote a rival leader in
            # mid-lease and a LEASE read on the old leader would be stale.
            node._last_leader_contact = self.net.time
            entries, offsets, si, st = eng.recover()
            node.entries = list(entries)
            node.offsets = list(offsets)
            node.snap_index = si
            node.snap_term = st
            node.commit_index = si
            node.last_applied = si
            term, vote, cfg = eng.load_meta()
            node.current_term, node.voted_for = term, vote
            # membership survives restart: persisted meta config as the
            # base, plus any KIND_CONFIG entries in the recovered log tail
            node.restore_config(cfg)
            # a recovered node's durability predates the tracer's view of
            # it — without these baseline events the causality auditor
            # would flag its first post-restart ack as ack-before-durable
            self._baseline_events(node)

    def _baseline_events(self, node: RaftNode):
        """Emit audit baseline for state that became durable/committed/
        applied before (or outside) the tracer's window."""
        t = _trace.active()
        if t is None:
            return
        last = node.entries[-1].index if node.entries else node.snap_index
        if last > 0:
            t.event("durable", node.addr, last, baseline=True)
        if node.commit_index > 0:
            t.event("commit_learned", node.addr, node.commit_index,
                    baseline=True)
        if node.last_applied > 0:
            t.event("apply", node.addr, node.last_applied, baseline=True)
        if node.role == LEADER:
            # seed the acked map: commits after a mid-run install may
            # rest on match_index earned before the tracer was watching
            for p, m in sorted(node.match_index.items()):
                if p != node.nid and m > 0:
                    t.event("ack_recv", node.addr, m, baseline=True,
                            **{"from": node._addr(p)})

    # --------------------------------------------------------------- tracing
    def enable_tracing(self) -> "_trace.Tracer":
        """Install a process-global virtual-time tracer driven by this
        cluster's SimNet clock and seed it with baseline audit events for
        every live node (state that became durable before the tracer
        existed must not read as ack-before-durable).  Returns the
        tracer; pair with disable_tracing()."""
        t = _trace.Tracer(clock=lambda: self.net.time)
        _trace.install(t)
        for nd in self.nodes:
            if nd is not None:
                self._baseline_events(nd)
        return t

    def disable_tracing(self) -> Optional["_trace.Tracer"]:
        t = _trace.active()
        _trace.uninstall()
        return t

    def registry(self, reg: Optional["_trace.MetricsRegistry"] = None,
                 **extra: str) -> "_trace.MetricsRegistry":
        """Fill a labeled MetricsRegistry from every node's Metrics plus
        cluster-level gauges (liveness, Raft progress, SimNet traffic) —
        the structured successor to health_report()'s ad-hoc dicts.
        `extra` adds constant labels to every sample (ShardedCluster
        passes shard=<g> and merges all groups into one registry);
        net-wide counters are emitted only by the net's owner so a
        shared fabric isn't double-counted."""
        reg = reg if reg is not None else _trace.MetricsRegistry()
        for i, m in enumerate(self.metrics):
            m.fill_registry(reg, node=str(i), **extra)
        lab = sorted(("node",) + tuple(extra))
        up = reg.gauge("repro_node_up", "node is running and reachable",
                       lab)
        term = reg.gauge("repro_raft_term", "current raft term", lab)
        commit = reg.gauge("repro_raft_commit_index",
                           "highest committed log index", lab)
        applied = reg.gauge("repro_raft_last_applied",
                            "highest applied log index", lab)
        for i, nd in enumerate(self.nodes):
            alive = nd is not None and self.addr(i) not in self.net.down
            up.labels(node=str(i), **extra).set(1 if alive else 0)
            if nd is not None:
                term.labels(node=str(i), **extra).set(nd.current_term)
                commit.labels(node=str(i), **extra).set(nd.commit_index)
                applied.labels(node=str(i), **extra).set(nd.last_applied)
        if self._owns_net:
            sent = reg.counter("repro_net_msgs_total",
                               "simnet messages by outcome", ["outcome"])
            sent.labels(outcome="sent").inc(self.net.sent_msgs)
            sent.labels(outcome="dropped").inc(self.net.dropped_msgs)
            drops = reg.counter("repro_net_drops_total",
                                "simnet drops by reason", ["reason"])
            for reason, cnt in sorted(self.net.drop_reasons.items()):
                drops.labels(reason=reason).inc(cnt)
        return reg

    def prometheus_text(self) -> str:
        return self.registry().prometheus_text()

    def scrape(self) -> dict:
        return self.registry().scrape()

    # ---------------------------------------------------------------- time
    def tick(self, k: int = 1):
        if self._tick_parent is not None:
            # shared fabric: the shard owner advances net time ONCE per
            # step and ticks EVERY group's nodes, so any group's local
            # wait loop keeps the whole fabric live
            self._tick_parent.tick(k)
            return
        for _ in range(k):
            self.net.tick()
            for node in self.nodes:
                if node is not None:
                    node.tick()

    def leader(self) -> Optional[RaftNode]:
        live = [nd for i, nd in enumerate(self.nodes)
                if nd is not None and self.addr(i) not in self.net.down
                and i not in self.removed]
        leaders = [nd for nd in live if nd.role == LEADER]
        if not leaders:
            return None
        return max(leaders, key=lambda nd: nd.current_term)

    def elect(self, max_ticks: int = 2000) -> RaftNode:
        for _ in range(max_ticks):
            ld = self.leader()
            if ld is not None and ld.commit_index >= ld.snap_index:
                return ld
            self.tick()
        raise TimeoutError("no leader elected")

    # --------------------------------------------------------- membership
    # Self-healing surface: single-server config changes through the Raft
    # log (raft.py).  add_node joins a non-voting learner that catches up
    # via InstallSnapshot + run shipping; the leader auto-promotes it once
    # its applied index is within promote_lag of the commit index;
    # remove_node retires an id forever (its SimNet address dies with it).
    def add_node(self, *, max_ticks: int = 8000) -> int:
        """Join a fresh node as a LEARNER; returns its id once the
        add-learner config entry has committed and the node is running."""
        nid = self.n
        self.n += 1
        self.net.add_node(self.addr(nid))
        self.metrics.append(Metrics(node=self.addr(nid)))
        self.engines.append(None)
        self.nodes.append(None)
        self.elect()
        voters = learners = None
        for _ in range(max_ticks):
            ld = self.leader()
            if ld is not None:
                if nid in ld.learners and ld.config_index <= ld.commit_index:
                    voters = sorted(ld.voters)
                    learners = sorted(ld.learners)
                    break
                ld.propose_add_learner(nid)   # no-op while one's in flight
            self.tick()
        else:
            raise TimeoutError("add_node: add-learner config never "
                               "committed")
        # construct the node with the COMMITTED config: it knows who may
        # lead (rejecting stale candidates) and that it must not campaign
        self._make_node(nid, fresh=True, voters=voters, learners=learners)
        self._save_manifest()
        return nid

    def wait_promoted(self, nid: int, max_ticks: int = 20000) -> bool:
        """Tick until the leader has auto-promoted `nid` to voter and the
        promote config entry has committed."""
        for _ in range(max_ticks):
            ld = self.leader()
            if ld is not None and nid in ld.voters and \
                    ld.config_index <= ld.commit_index:
                return True
            self.tick()
        return False

    def remove_node(self, nid: int, *, max_ticks: int = 8000):
        """Remove `nid` from the config (voter or learner, live or dead).
        A live leader removes itself gracefully: leadership is transferred
        to the best-caught-up voter first (TimeoutNow), with leader-
        proposed self-removal + step-down as the fallback."""
        ld = self.elect()
        if ld.nid == nid and len(ld.voters) > 1:
            ld.transfer_leadership()
            for _ in range(max_ticks):
                cur = self.leader()
                if cur is not None and cur.nid != nid and \
                        cur.commit_index >= cur.snap_index:
                    break
                self.tick()
        done = False
        for _ in range(max_ticks):
            ld = self.leader()
            if ld is not None:
                if ld.nid != nid and nid not in ld.voters and \
                        nid not in ld.learners and \
                        ld.config_index <= ld.commit_index:
                    done = True
                    break
                ld.propose_remove(nid)
            self.tick()
        if not done:
            raise TimeoutError("remove_node: removal config never "
                               "committed")
        # the id is retired: shut the process down and kill its address —
        # queued + future mail is destroyed (counted in dropped_msgs)
        self.removed.add(nid)
        if self.engines[nid] is not None:
            self.engines[nid].close()
        self.nodes[nid] = None
        self.engines[nid] = None
        self.net.remove_node(self.addr(nid))
        self._save_manifest()

    def replace_node(self, dead: int, *, max_ticks: int = 20000) -> int:
        """Self-healing cycle (the smoke-gate scenario): ensure `dead` is
        down, join a fresh learner, wait for snapshot + run-shipping
        catch-up to auto-promote it, then retire the dead id.  Quorum is
        restored at the original voter count; returns the new node id."""
        if self.nodes[dead] is not None:
            self.crash(dead)
        new = self.add_node(max_ticks=max_ticks)
        if not self.wait_promoted(new, max_ticks=max_ticks):
            raise TimeoutError(f"replace_node: learner {new} never "
                               "promoted")
        self.remove_node(dead, max_ticks=max_ticks)
        return new

    # -------------------------------------------------------------- client
    # Thin wrappers over the consistency-tiered client: the leadership-
    # change retry loop, ReadIndex round, lease check and session routing
    # all live in repro.core.client — not here, and not in each test.
    def put(self, key: bytes, value: bytes, max_ticks: int = 2000) -> int:
        return self.client.put(key, value, max_ticks=max_ticks)

    def put_many(self, items, window: int = 64, max_ticks: int = 200000,
                 batch: Optional[int] = None):
        return self.client.put_many(items, window=window,
                                    max_ticks=max_ticks, batch=batch)

    def get(self, key: bytes, consistency: Optional[str] = None, *,
            session: Optional[Session] = None,
            node: Optional[int] = None) -> Optional[bytes]:
        return self.client.get(key, consistency, session=session, node=node)

    def scan(self, lo: bytes, hi: bytes, consistency: Optional[str] = None,
             *, session: Optional[Session] = None,
             node: Optional[int] = None):
        return self.client.scan(lo, hi, consistency, session=session,
                                node=node)

    def session(self) -> Session:
        return self.client.session()

    def read_report(self) -> List[dict]:
        """Per-node consistency-tier evidence: reads served by tier, the
        quorum rounds paid (LINEARIZABLE / lapsed-lease fallback), reads
        followers served (SESSION's new read capacity) and session reads
        that stalled on the apply pipeline.  Shared by benchmarks/
        fig_reads.py, the smoke gate and the stale-read tests."""
        ld = self.leader()
        return [{
            "node": i,
            "role": "leader" if ld is not None and i == ld.nid
                    else "follower",
            "tiers": dict(m.read_tiers),
            "quorum_rounds": m.read_quorum_rounds,
            "follower_serves": m.follower_serves,
            "session_stalls": m.session_stalls,
        } for i, m in enumerate(self.metrics)]

    # ------------------------------------------------------- run shipping
    def drain_shipping(self, max_ticks: int = 4000) -> bool:
        """Tick until every live follower's durable ship position reaches
        the leader's newest sealed record (True), or the budget runs out.
        Also waits for the apply pipeline so scans are comparable."""
        for _ in range(max_ticks):
            ld = self.leader()
            if ld is not None:
                caught_up = all(
                    self.nodes[p] is None or
                    self.addr(p) in self.net.down or
                    self.nodes[p].last_applied >= ld.commit_index
                    for p in ld.peers)
                shipped = True
                if ld.shipper is not None and ld.shipper.records:
                    tip = ld.shipper.records[-1][0]
                    shipped = all(
                        self.addr(p) in self.net.down or
                        self.nodes[p] is None or
                        (ld.shipper.peers.get(p) is not None and
                         ld.shipper.peers[p].pos >= tip)
                        for p in ld.peers)
                if caught_up and shipped:
                    return True
            self.tick()
        return False

    def replication_report(self) -> List[dict]:
        """Per-node replication + GC byte accounting (run-shipping
        evidence: follower gc_flush_bytes ~ 0 when adoption is on)."""
        ld = self.leader()
        out = []
        for i, m in enumerate(self.metrics):
            eng = self.engines[i]
            out.append({
                "node": i,
                "role": "leader" if ld is not None and i == ld.nid
                        else "follower",
                "ship_bytes": dict(m.ship_bytes),
                "gc_flush_bytes": m.write_bytes.get("gc_sorted", 0),
                "gc_merge_bytes": m.write_bytes.get("gc_level_merge", 0),
                "adopt_bytes": m.write_bytes.get("run_adopt", 0),
                "adopted_runs": getattr(eng, "adopt_count", 0),
            })
        return out

    # --------------------------------------------------------------- health
    def health_report(self) -> dict:
        """One scrapeable document merging liveness, Raft progress, the
        network's fault state, read_report() and replication_report() —
        the /metrics analogue the ROADMAP's workload-harness item asks
        for.  The chaos harness snapshots it around every fault; anything
        external (a test, a dashboard, a future HTTP endpoint) reads this
        instead of poking node internals."""
        ld = self.leader()
        nodes = []
        for i, nd in enumerate(self.nodes):
            if nd is None:
                nodes.append({
                    "node": i, "up": False,
                    "membership": "removed" if i in self.removed
                    else "down"})
                continue
            if i in self.removed:
                membership = "removed"
            elif nd.is_voter:
                membership = "voter"
            elif nd.nid in nd.learners:
                membership = "learner"
            else:
                membership = "none"     # e.g. demoted but still running
            nodes.append({
                "node": i, "up": self.addr(i) not in self.net.down,
                "role": nd.role, "term": nd.current_term,
                "membership": membership,
                "config_index": nd.config_index,
                "commit_index": nd.commit_index,
                "last_applied": nd.last_applied,
                "lease_valid": nd.lease_valid(),
            })
        return {
            "time": self.net.time,
            "leader": ld.nid if ld is not None else None,
            "membership": {
                "voters": sorted(ld.voters) if ld is not None else None,
                "learners": sorted(ld.learners) if ld is not None else None,
                "config_index": ld.config_index if ld is not None else None,
                "removed": sorted(self.removed),
            },
            "nodes": nodes,
            "net": {"sent_msgs": self.net.sent_msgs,
                    "dropped_msgs": self.net.dropped_msgs,
                    "drop_reasons": dict(self.net.drop_reasons),
                    "drop_prob": self.net.drop_prob,
                    "down": sorted(self._local_ids(self.net.down)),
                    "removed": sorted(self._local_ids(self.net.removed)),
                    "partitions": [sorted(self._local_ids(p))
                                   for p in self.net.blocked
                                   if len(self._local_ids(p)) == len(p)]},
            "reads": self.read_report(),
            "replication": self.replication_report(),
            "faults": {
                "per_node": [dict(m.fault_injections) for m in self.metrics],
                "faultfs": (faultfs.active().counters()
                            if faultfs.active() is not None else None),
            },
            "metrics": self.scrape(),
        }

    # --------------------------------------------------------------- faults
    # The chaos scheduler (repro/core/workload.py) drives faults through
    # these hooks only — tests and schedules stay independent of SimNet
    # internals, and every hook is deterministic given the cluster seeds.
    def partition(self, a: int, b: int):
        self.net.partition(self.addr(a), self.addr(b))

    def heal(self, a: int = None, b: int = None):
        if a is None:
            if self.group is None:
                self.net.heal()
            else:
                # shared fabric: only discard partitions wholly inside
                # THIS group — other shards' faults are not ours to fix
                for p in list(self.net.blocked):
                    if len(self._local_ids(p)) == len(p):
                        self.net.blocked.discard(p)
        else:
            self.net.heal(self.addr(a), self.addr(b))

    def isolate(self, i: int):
        """Symmetric partition: cut every link touching node i."""
        for j in range(self.n):
            if j != i:
                self.net.partition(self.addr(i), self.addr(j))

    def set_drop_prob(self, p: float):
        """Net-wide lossy window (chaos 'lossy' action); 0 restores."""
        self.net.drop_prob = p

    def kill_leader(self, max_ticks: int = 2000) -> int:
        """Crash the current leader (electing one first if none is
        settled); returns its node id so the schedule can restart it."""
        ld = self.elect(max_ticks)
        self.crash(ld.nid)
        return ld.nid

    def force_gc(self, drain: bool = True, max_ticks: int = 8000) -> bool:
        """GC-storm hook: start a flush cycle on the leader's engine NOW,
        regardless of gc_threshold, and (by default) drain it plus any
        cascading level merges synchronously — the chaos scheduler uses
        it to pile GC work onto the serving path.  Returns False when the
        engine has no leveled GC (baseline engines) or the apply pipeline
        cannot catch up within max_ticks."""
        ld = self.elect()
        eng = self.engines[ld.nid]
        if not hasattr(eng, "run_gc_to_completion"):
            return False
        if eng.gc_completed and eng._merge is None:
            eng.start_gc()       # no-op on an empty active segment
        if drain:
            # gc_step parks at a barrier until the whole active segment
            # has APPLIED; tick raft forward while it lags, or a force_gc
            # issued right after a failover spins forever on a leader
            # whose apply pipeline is still replaying
            for _ in range(max_ticks):
                if not (eng.gc_started and not eng.gc_completed) or \
                        eng._gc_last[0] >= eng._gc_snapshot_point[0]:
                    break
                self.tick()
            else:
                return False
            eng.run_gc_to_completion()
        return True

    def crash(self, i: int):
        self.net.crash(self.addr(i))
        if self.engines[i] is not None:
            self.engines[i].close()
        self.nodes[i] = None
        self.engines[i] = None

    def crash_hard(self, i: int):
        """kill -9: the node is dropped WITHOUT engine.close() — nothing
        buffered gets a goodbye flush — and the installed FaultFS rewrites
        the node's directory down to its durable view (torn tails and
        all).  Falls back to crash() when no FaultFS is installed (then
        there is no unsynced state to model)."""
        fs = faultfs.active()
        if fs is None:
            return self.crash(i)
        self.net.crash(self.addr(i))
        self.nodes[i] = None
        self.engines[i] = None      # dropped un-closed on purpose
        fs.materialize(self._engine_dir(i) + os.sep)
        self.metrics[i].on_fault("hard_crash")

    def hard_crash_from(self, exc) -> Optional[int]:
        """Map a SimulatedCrash raised mid-I/O to the node whose directory
        the op touched, hard-crash that node, and return its id (None if
        the path maps to no node)."""
        p = os.path.abspath(exc.path)
        for i in range(self.n):
            d = os.path.abspath(self._engine_dir(i))
            if p == d or p.startswith(d + os.sep):
                if self.nodes[i] is not None:
                    self.crash_hard(i)
                    self.metrics[i].on_fault("mid_op_crash")
                return i
        return None

    def restart(self, i: int) -> float:
        """Returns wall-clock recovery seconds (Fig. 11 measurement)."""
        t0 = time.perf_counter()
        self._make_node(i, fresh=False)
        dt = time.perf_counter() - t0
        self.net.restart(self.addr(i))
        return dt

    def destroy(self):
        for e in self.engines:
            if e is not None:
                e.close()
        shutil.rmtree(self.workdir, ignore_errors=True)
