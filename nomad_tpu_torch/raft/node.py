"""Raft node: leader election, log replication, commit + apply.

Reference contract: hashicorp/raft as wired in nomad/server.go:1157
(setupRaft) and driven by nomad/leader.go (leadership loop). This is a
compact but real implementation: randomized election timeouts, terms and
votes persisted alongside the log, AppendEntries with the prev-entry
consistency check and conflict truncation, majority commit (only for
entries of the current term), snapshot install for lagging followers,
and log compaction.

Transports are pluggable: InProcTransport carries clusters inside one
process (the reference tests raft fully in-process too —
nomad/testing.go:42) and `rpc.transport.TcpRaftTransport` carries them
over TCP.

The counterpart of `nomad_tpu.raft.node`, with repairs that a cluster
over TCP at config-3 width needs (ROADMAP.md Queue 3):
  * each AppendEntries is cut to the transport's `max_append_bytes`
    of encoded entries (the TCP one: a frame holds at most
    `rpc.wire.MAX_FRAME` bytes) as well as to 512 entries, as
    hashicorp/raft caps a batch; the reference sends the 512 whatever
    their size, and a follower behind by more than a frame's worth
    never catches up;
  * a follower commits only up to the last entry the leader's call
    matched (raft's min(leaderCommit, index of last new entry));
  * the leader replicates on two long-lived threads per peer (appends,
    and a heartbeat beside an append in flight) that the raft loop only
    signals, and a started member applies committed entries
    on an applier thread outside the raft lock, so one slow follower
    neither starves the others' heartbeats nor reads its own apply as
    the leader's silence;
  * `barrier()` (hashicorp/raft's), which a new leader runs before it
    reads the store;
  * a member outside its own voter configuration (a server joining as a
    learner) never campaigns;
  * a leader whose snapshot point is the entry before a follower's
    next one sends that entry's term (the snapshot's), not 0: the
    reference's 0 fails the follower's consistency check, and a
    caught-up follower is sent the whole snapshot;
  * a snapshot ships in chunks (InstallSnapshot with an offset), each
    of which encodes within the transport's `max_append_bytes`: the
    reference sends the whole FSM snapshot in one call, which a frame
    cannot hold at config-3 size, so a follower behind the leader's
    compaction point never catches up.  The snapshot a node compacted
    to (or installed) is kept, so the leader ships the state at its
    snapshot index and not the store as it stands.
"""
from __future__ import annotations

import json
import logging
import os
import random
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

from .fsm import NOOP, StateFSM
from .log import LogEntry, RaftLog

_log = logging.getLogger(__name__)

#: the most snapshot bytes one InstallSnapshot chunk carries, before the
#: transport's own limit (`max_snapshot_chunk_bytes`); a chunk of this
#: size encodes to about as many bytes as one 10,000-alloc plan entry
SNAPSHOT_CHUNK_BYTES = 8 * 1024 * 1024

# membership-change entry, applied by the raft layer itself (not the
# state FSM): payload = the full new peer list (one-at-a-time changes,
# raft §6 single-server membership change)
CONFIG = "::config"

ROLE_FOLLOWER = "follower"
ROLE_CANDIDATE = "candidate"
ROLE_LEADER = "leader"


class NotLeaderError(Exception):
    def __init__(self, leader_id: Optional[str]):
        super().__init__(f"not the leader (leader={leader_id})")
        self.leader_id = leader_id


@dataclass
class RaftConfig:
    node_id: str = "node-1"
    peers: List[str] = field(default_factory=list)   # includes self
    data_dir: Optional[str] = None
    election_timeout_s: Tuple[float, float] = (0.15, 0.30)
    heartbeat_interval_s: float = 0.05
    snapshot_threshold: int = 8192      # log entries before compaction
    # Durable by default: committed entries must survive power loss
    # (reference: raft-boltdb fsyncs every append).  Tests and
    # benchmarks that churn thousands of throwaway entries may opt out.
    fsync: bool = True
    # an empty-log member waits this long for an existing leader to
    # contact it before campaigning: a freshly ADDED server would
    # otherwise inflate its term pre-join and depose a healthy leader
    # on first contact (fresh full-cluster bootstraps just wait it out)
    join_grace_s: float = 1.0


class InProcTransport:
    """Direct-call transport: a registry of live nodes. Closed nodes are
    unreachable (simulates a crashed server)."""

    #: entries and snapshot chunks pass by reference: no frame limit
    max_append_bytes: Optional[int] = None
    max_snapshot_chunk_bytes: Optional[int] = None

    def __init__(self):
        self._nodes: Dict[str, "RaftNode"] = {}
        self._lock = threading.Lock()

    def register(self, node: "RaftNode") -> None:
        with self._lock:
            self._nodes[node.id] = node

    def unregister(self, node_id: str) -> None:
        with self._lock:
            self._nodes.pop(node_id, None)

    def call(self, target: str, method: str, *args):
        with self._lock:
            node = self._nodes.get(target)
        if node is None or not node.running:
            raise ConnectionError(f"peer {target} unreachable")
        return getattr(node, method)(*args)


class _Replicator:
    """A leader's two long-lived threads for one peer, as hashicorp/raft
    keeps a replication and a heartbeat goroutine per follower: one
    sends appends (or ships the snapshot), one sends heartbeats, so at
    most one of each is in flight and a beat goes out while a large
    append is in flight.  The raft loop only signals them (`kick`):
    starting a thread per beat stalled the leader's loop for seconds in
    `Thread.start` whenever another thread held the interpreter (a
    joiner restoring a large snapshot in the same process).  A heartbeat
    interval without a signal sets each going by itself (a round, which
    to a caught-up follower is an empty append; a beat while an append
    is in flight), as hashicorp/raft's goroutines run on their own
    timers: the raft loop also runs the leadership callbacks (a new
    leader's barrier and eval restore), and the followers must not read
    that as the leader's silence."""

    def __init__(self, node: "RaftNode", peer: str):
        self.node, self.peer = node, peer
        self._cv = threading.Condition(threading.Lock())
        self._want_append = False
        self._want_beat = False
        self._appending = False
        self._beating = False
        self._stopped = False
        name = f"raft-{node.id}-{peer}"
        self._threads = (
            threading.Thread(target=self._append_loop, daemon=True,
                             name=name),
            threading.Thread(target=self._beat_loop, daemon=True,
                             name=name + "-beat"))

    def start(self) -> None:
        for t in self._threads:
            t.start()

    def stop(self) -> None:
        with self._cv:
            self._stopped = True
            self._cv.notify_all()

    def kick(self, heartbeat: bool) -> None:
        """Ask for an append round; with `heartbeat`, also a beat if an
        append is in flight and no beat is."""
        with self._cv:
            self._want_append = True
            if heartbeat and self._appending and not self._beating:
                self._want_beat = True
            self._cv.notify_all()

    def _take(self, want: str, busy: str, idle) -> bool:
        """Wait for the `want` signal, or for a heartbeat interval to pass
        without one while `idle()` holds; then mark `busy`.  False once
        stopped."""
        hb = self.node.cfg.heartbeat_interval_s
        with self._cv:
            deadline = time.monotonic() + hb
            while not (self._stopped or getattr(self, want)):
                remain = deadline - time.monotonic()
                if remain > 0:
                    self._cv.wait(remain)
                elif idle():
                    break
                else:
                    deadline = time.monotonic() + hb
            if self._stopped:
                return False
            setattr(self, want, False)
            setattr(self, busy, True)
            return True

    def _done(self, busy: str) -> None:
        with self._cv:
            setattr(self, busy, False)

    def _append_loop(self) -> None:
        self._loop("_want_append", "_appending", lambda: True,
                   self.node._replicate_round)

    def _beat_loop(self) -> None:
        self._loop("_want_beat", "_beating", lambda: self._appending,
                   self.node._heartbeat)

    def _loop(self, want: str, busy: str, idle, call) -> None:
        while self._take(want, busy, idle):
            try:
                call(self.peer)
            except Exception:
                # the thread outlives a failed call: the next kick retries
                # (a thread per call died with its call)
                _log.exception("raft %s: %s to %s failed", self.node.id,
                               call.__name__, self.peer)
            finally:
                self._done(busy)


class RaftNode:
    def __init__(self, config: RaftConfig, fsm: StateFSM,
                 transport: InProcTransport,
                 on_leader: Optional[Callable[[], None]] = None,
                 on_follower: Optional[Callable[[], None]] = None):
        self.cfg = config
        self.id = config.node_id
        self.fsm = fsm
        self.transport = transport
        self.on_leader = on_leader          # called OUTSIDE the lock
        self.on_follower = on_follower
        self.log = RaftLog(config.data_dir, fsync=config.fsync)

        self._lock = threading.RLock()
        self._cv = threading.Condition(self._lock)
        self.term = 0
        self.voted_for: Optional[str] = None
        self.role = ROLE_FOLLOWER
        self.leader_id: Optional[str] = None
        self.commit_index = 0
        self.last_applied = 0
        self.snapshot_index = 0
        self.snapshot_term = 0
        self._events_lock = threading.Lock()
        self._next: Dict[str, int] = {}
        self._match: Dict[str, int] = {}
        # learners: replicated to, never counted toward quorum — the
        # catch-up phase before a membership add (raft §6 non-voters)
        self._staging: List[str] = []
        self.running = False
        self._closed = False
        self._threads: List[threading.Thread] = []
        self._deadline = 0.0
        self._meta_saved_commit = 0
        self._last_leader_contact = 0.0
        self._role_events: List[str] = []    # deferred callbacks
        self._oversized = 0      # the entry last logged as unshippable
        # a running leader's replicator per peer and learner
        # (_sync_replicators_locked); changed under the raft lock
        self._replicators: Dict[str, "_Replicator"] = {}
        # the applier thread of a started member, and the entry it is
        # applying outside the lock (0: none)
        self._applier: Optional[threading.Thread] = None
        self._applying = 0
        # the snapshot at (snapshot_index, snapshot_term), as compacted
        # or installed, kept for shipping (None: none taken or read yet);
        # guarded by the raft lock
        self._snap_data: Optional[bytes] = None
        # snapshot_now's request to the applier thread, and its answer
        self._snapshot_wanted = False
        self._snapshot_done = False
        # leader: how far each peer's install of which snapshot got,
        # peer -> ((snap_index, snap_term), offset); follower: the
        # chunks of one install so far, keyed (leader, term, snap_index)
        self._ship_offset: Dict[str, Tuple[Tuple[int, int], int]] = {}
        self._install_key: Optional[Tuple[str, int, int]] = None
        self._install_buf = bytearray()

        self._meta_path = (os.path.join(config.data_dir, "raft.meta")
                           if config.data_dir else None)
        self._snap_path = (os.path.join(config.data_dir, "raft.snap")
                           if config.data_dir else None)
        self._restore_from_disk()
        transport.register(self)

    # ------------------------------------------------------- persistence
    def _save_meta_locked(self) -> None:
        self._meta_saved_commit = self.commit_index
        if not self._meta_path:
            return
        tmp = self._meta_path + ".tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump({"term": self.term, "voted_for": self.voted_for,
                       "commit_index": self.commit_index,
                       "snapshot_index": self.snapshot_index,
                       "snapshot_term": self.snapshot_term,
                       "peers": list(self.cfg.peers)}, f)
        os.replace(tmp, self._meta_path)

    def _restore_from_disk(self) -> None:
        if self._meta_path and os.path.exists(self._meta_path):
            with open(self._meta_path, encoding="utf-8") as f:
                meta = json.load(f)
            self.term = meta.get("term", 0)
            self.voted_for = meta.get("voted_for")
            self.commit_index = meta.get("commit_index", 0)
            self.snapshot_index = meta.get("snapshot_index", 0)
            self.snapshot_term = meta.get("snapshot_term", 0)
            # membership survives log compaction through the metadata
            # (a config entry behind the snapshot point is gone)
            if meta.get("peers"):
                self.cfg.peers = list(meta["peers"])
        if self._snap_path and os.path.exists(self._snap_path):
            with open(self._snap_path, "rb") as f:
                self.fsm.restore(f.read())
            self.last_applied = self.snapshot_index
        # Single-voter clusters replay the whole log: every appended
        # entry was self-accepted, so none can conflict, and this
        # recovers commits made after the last meta write. Multi-node
        # members replay only the committed prefix (the uncommitted
        # tail is resolved by the leader's consistency check).
        single = len(self.cfg.peers) <= 1
        replay_to = self.log.last_index() if single else self.commit_index
        for e in self.log.slice_from(self.last_applied + 1,
                                     limit=1 << 30):
            if e.index > replay_to:
                break
            if e.etype == CONFIG:
                self.cfg.peers = list(e.payload)
            else:
                self.fsm.apply(e.index, e.etype, e.payload)
            self.last_applied = e.index
        if single:
            self.commit_index = max(self.commit_index, self.last_applied)

    # ------------------------------------------------------------ control
    def start(self) -> None:
        with self._lock:
            if self.running:
                return
            self.running = True
            self._reset_election_deadline_locked()
            if self.log.last_index() == 0 and self.term == 0:
                self._deadline += self.cfg.join_grace_s
            # thread handles guarded by _lock
            t = threading.Thread(target=self._run, daemon=True,
                                 name=f"raft-{self.id}")
            self._applier = threading.Thread(
                target=self._apply_loop, daemon=True,
                name=f"raft-{self.id}-apply")
            t.start()
            self._applier.start()
            self._threads = [t, self._applier]
            self._sync_replicators_locked()    # a bootstrapped leader

    def stop(self) -> None:
        with self._lock:
            self.running = False
            self._closed = True
            self._save_meta_locked()
            self._sync_replicators_locked()
            self._cv.notify_all()
        for t in self._threads:
            t.join(timeout=2.0)
        self.transport.unregister(self.id)
        self.log.close()

    def is_leader(self) -> bool:
        with self._lock:
            return self.role == ROLE_LEADER

    def bootstrap_single(self, defer_events: bool = False) -> None:
        """Degenerate cluster of one: become leader immediately (used by
        the default single-server deployment). With defer_events the
        on_leader callback stays queued until fire_pending_role_events()
        — the Server constructor uses this so writes work immediately
        while leader services wait for start()."""
        with self._lock:
            if self.role == ROLE_LEADER:
                return
            self.term += 1
            self.voted_for = self.id
            self._become_leader_locked()
            self._save_meta_locked()
        if not defer_events:
            self._fire_role_events()

    def fire_pending_role_events(self) -> None:
        self._fire_role_events()

    # -------------------------------------------------------------- loop
    def _run(self) -> None:
        hb = self.cfg.heartbeat_interval_s
        while True:
            # read without the lock, which a large snapshot install or
            # compaction holds: heartbeats must not wait for those
            # (every decision below re-checks under the lock)
            if not self.running:
                return
            role = self.role
            timed_out = time.monotonic() >= self._deadline
            if role == ROLE_LEADER:
                self._replicate_all(heartbeat=True)
                time.sleep(hb)
            elif timed_out:
                self._start_election()
            else:
                time.sleep(0.01)
            if self._role_events:
                self._fire_role_events()

    def _reset_election_deadline_locked(self) -> None:
        lo, hi = self.cfg.election_timeout_s
        self._deadline = time.monotonic() + random.uniform(lo, hi)

    # ---------------------------------------------------------- election
    def _start_election(self) -> None:
        with self._lock:
            # the loop read the clock without the lock: an append that
            # held it (a large apply) may have reset the clock since
            if (not self.running or self.role == ROLE_LEADER
                    or time.monotonic() < self._deadline):
                return
            # a member outside its own voter configuration (a learner
            # catching up, or a removed server) never campaigns: its
            # raised term would depose the leader through the next
            # answer it gives (raft §6 non-voting members; hashicorp/raft
            # nonvoters); it campaigns once a committed config names it
            if self.cfg.peers and self.id not in self.cfg.peers:
                self._reset_election_deadline_locked()
                return
            self.role = ROLE_CANDIDATE
            self.term += 1
            self.voted_for = self.id
            self.leader_id = None
            term = self.term
            last_i = self.log.last_index()
            last_t = (self.log.term_at(last_i)
                      if last_i > self.snapshot_index
                      else self._snap_term())
            self._save_meta_locked()
            self._reset_election_deadline_locked()
        votes = 1
        for peer in self.cfg.peers:
            if peer == self.id:
                continue
            try:
                pterm, granted = self.transport.call(
                    peer, "rpc_request_vote", term, self.id, last_i, last_t)
            except ConnectionError:
                continue
            with self._lock:
                if pterm > self.term:
                    self._step_down_locked(pterm)
                    return
            if granted:
                votes += 1
        with self._lock:
            if (self.role == ROLE_CANDIDATE and self.term == term
                    and votes * 2 > len(self.cfg.peers or [self.id])):
                self._become_leader_locked()

    def _become_leader_locked(self) -> None:
        self.role = ROLE_LEADER
        self.leader_id = self.id
        last = self.log.last_index()
        for p in self.cfg.peers:
            self._next[p] = last + 1
            self._match[p] = 0
        self._match[self.id] = last
        # commit a noop barrier so the new term can commit prior-term
        # entries (raft's no-op-on-election rule)
        self._append_locked(NOOP, None)
        self._role_events.append("leader")
        self._sync_replicators_locked()

    def step_down(self) -> bool:
        """Voluntary leader step-down (the chaos plane's
        leader-failure hook, analog of raft leadership transfer):
        bump the term and drop to follower so the election timer
        picks a fresh leader.  No-op on non-leaders."""
        with self._lock:
            if self.role != ROLE_LEADER:
                return False
            self._step_down_locked(self.term + 1)
        self._fire_role_events()
        return True

    def _step_down_locked(self, term: int) -> None:
        was_leader = self.role == ROLE_LEADER
        self.term = term
        self.role = ROLE_FOLLOWER
        self.voted_for = None
        self._save_meta_locked()
        self._reset_election_deadline_locked()
        if was_leader:
            self._role_events.append("follower")
            self._sync_replicators_locked()

    def _fire_role_events(self) -> None:
        # _events_lock serializes callback execution across the _run loop
        # and peer RPC threads, so leader/follower transitions fire in
        # queue order — otherwise a flap could leave leader services
        # disabled on the actual leader
        with self._events_lock:
            while True:
                with self._lock:
                    if not self._role_events:
                        return
                    ev = self._role_events.pop(0)
                if ev == "leader" and self.on_leader:
                    self.on_leader()
                elif ev == "follower" and self.on_follower:
                    self.on_follower()

    def _snap_term(self) -> int:
        with self._lock:    # re-entrant; callers already hold it
            return self.snapshot_term

    # -------------------------------------------------------- replication
    def _append_locked(self, etype: str, payload: Any) -> int:
        index = self.log.last_index() + 1
        self.log.append([LogEntry(index, self.term, etype, payload)])
        self._match[self.id] = index
        return index

    def propose(self, etype: str, payload: Any,
                timeout: float = 10.0) -> int:
        """Append + replicate + wait for local apply. Raises
        NotLeaderError from followers (callers forward to the leader)."""
        with self._lock:
            if self._closed:
                raise NotLeaderError(None)
            if self.role != ROLE_LEADER:
                raise NotLeaderError(self.leader_id)
            index = self._append_locked(etype, payload)
            term = self.term
        return self._wait_applied(index, term, timeout)

    def barrier(self, timeout: float = 10.0) -> int:
        """Block until every entry of the leader's log, its new term's
        noop included, is applied here (hashicorp/raft `Barrier`, which
        Nomad's leader runs before reading the state store); returns
        that index.  Raises NotLeaderError off the leader and
        TimeoutError past `timeout`."""
        with self._lock:
            if self.role != ROLE_LEADER:
                raise NotLeaderError(self.leader_id)
            index, term = self.log.last_index(), self.term
        return self._wait_applied(index, term, timeout)

    def propose_async(self, etype: str, payload: Any):
        """Append + kick replication WITHOUT waiting; returns
        (index, wait_fn) where wait_fn(timeout) blocks until the entry
        is applied locally (with no timeout, until it is applied or
        leadership is lost or this member stops).  The pipelined plan
        applier overlaps the consensus round trip of plan N with
        evaluating plan N+1
        (reference: plan_apply.go:71-178 applyPlan's async raft future
        + asyncPlanWait)."""
        with self._lock:
            if self._closed:
                raise NotLeaderError(None)
            if self.role != ROLE_LEADER:
                raise NotLeaderError(self.leader_id)
            index = self._append_locked(etype, payload)
            term = self.term
        self._replicate_all()
        return index, (lambda timeout=None:
                       self._await_applied(index, term, timeout))

    def _wait_applied(self, index: int, term: int,
                      timeout: float) -> int:
        self._replicate_all()
        return self._await_applied(index, term, timeout)

    def _await_applied(self, index: int, term: int,
                       timeout: Optional[float]) -> int:
        deadline = (None if timeout is None
                    else time.monotonic() + timeout)
        with self._lock:
            while self.last_applied < index:
                if (self.role != ROLE_LEADER or self.term != term
                        or self._closed):
                    raise NotLeaderError(self.leader_id)
                if deadline is None:
                    self._cv.wait(0.5)
                    continue
                remain = deadline - time.monotonic()
                if remain <= 0:
                    raise TimeoutError("proposal not committed in time")
                self._cv.wait(remain)
            return index

    def _replicate_all(self, heartbeat: bool = False) -> None:
        """Kick replication to every peer and learner without waiting:
        each peer's long-lived `_Replicator` holds its calls, so a
        follower that takes long to answer (a large batch to decode and
        apply) delays neither the other followers' appends nor their
        heartbeats (hashicorp/raft runs a replication goroutine per
        follower).  With `heartbeat` (the leader loop's beat) a peer
        whose append is in flight is sent an empty append meanwhile, as
        hashicorp/raft's heartbeat goroutine does, so a large batch in
        flight never reads as leader silence.  Only signals: it starts
        no thread and waits on none.  A single voter commits by itself,
        here."""
        if len(self.cfg.peers) <= 1:
            with self._lock:
                if self.role == ROLE_LEADER:
                    self._advance_commit_locked()
                    self._apply_committed_locked()
        for rep in list(self._replicators.values()):
            rep.kick(heartbeat)

    def _sync_replicators_locked(self) -> None:
        """Start a replicator for each peer and learner of a running
        leader that has none, and stop those of peers that left, of a
        lost leadership and of a stopped member.  Called where the
        role or the membership changes, never from the beat."""
        want = set()
        if self.running and not self._closed and self.role == ROLE_LEADER:
            want = {p for p in list(self.cfg.peers) + list(self._staging)
                    if p != self.id}
        for peer in list(self._replicators):
            if peer not in want:
                self._replicators.pop(peer).stop()
        for peer in want:
            if peer not in self._replicators:
                rep = _Replicator(self, peer)
                self._replicators[peer] = rep
                rep.start()

    def _heartbeat(self, peer: str) -> None:
        """An empty append with no log position: it passes any
        follower's consistency check, commits nothing, and only tells it
        that this leader's term is alive."""
        try:
            term = self.term
            if self.role != ROLE_LEADER:
                return
            pterm, _ok, _match = self.transport.call(
                peer, "rpc_append_entries", term, self.id, 0, 0, [], 0)
            if pterm > term:
                with self._lock:
                    if pterm > self.term:
                        self._step_down_locked(pterm)
        except ConnectionError:
            pass

    def _replicate_round(self, peer: str) -> None:
        """One append (or snapshot shipment) to `peer`, then the commit
        it may advance."""
        self._replicate_one(peer)
        with self._lock:
            if self.role == ROLE_LEADER:
                self._advance_commit_locked()
                self._apply_committed_locked()

    def _replicate_one(self, peer: str) -> None:
        with self._lock:
            if self.role != ROLE_LEADER:
                return
            nxt = self._next.get(peer, self.log.last_index() + 1)
            if nxt <= self.snapshot_index:
                term = self.term
                key = (self.snapshot_index, self.snapshot_term)
                snap = self._read_snapshot_locked()
            else:
                snap = None
                prev = nxt - 1
                # at the snapshot point the entry is compacted away:
                # its term is the snapshot's (the reference sends 0,
                # which a follower holding that entry refuses, and the
                # refusal sends it a snapshot it does not need)
                prev_term = (self.log.term_at(prev)
                             if prev > self.snapshot_index
                             else self.snapshot_term if prev else 0)
                entries = self.log.slice_from(nxt)
                term = self.term
                commit = self.commit_index
        if snap is not None:
            self._install_snapshot(peer, term, key, snap)
            return
        # measured outside the lock: a large entry takes a while
        entries = self._frame_batch(peer, entries)
        if entries is None:
            return
        wire = [(e.index, e.term, e.etype, e.payload) for e in entries]
        try:
            pterm, ok, match = self.transport.call(
                peer, "rpc_append_entries", term, self.id, nxt - 1,
                prev_term, wire, commit)
        except ConnectionError:
            return
        with self._lock:
            if pterm > self.term:
                self._step_down_locked(pterm)
                return
            if self.role != ROLE_LEADER or self.term != term:
                return
            if ok:
                self._match[peer] = match
                self._next[peer] = match + 1
            else:
                self._next[peer] = max(1, min(nxt - 1, match + 1))

    def _install_snapshot(self, peer: str, term: int,
                          key: Tuple[int, int], snap: bytes) -> None:
        """Ship the snapshot at `key` = (snap_index, snap_term) to `peer`
        in chunks, from where the peer's install of it got.  The
        follower answers each chunk with the bytes it holds; a refused
        chunk (its offset is not the follower's) resumes from there.
        Stops at an error, a higher term or a lost leadership; the next
        round resumes."""
        snap_index, snap_term = key
        total = len(snap)
        cap = self.transport.max_snapshot_chunk_bytes
        step = SNAPSHOT_CHUNK_BYTES if cap is None else min(
            SNAPSHOT_CHUNK_BYTES, cap)
        view = memoryview(snap)
        with self._lock:
            got_key, offset = self._ship_offset.get(peer, (key, 0))
            if got_key != key:
                offset = 0
        while True:
            end = min(total, offset + step)
            done = end >= total
            try:
                pterm, held = self.transport.call(
                    peer, "rpc_install_snapshot", term, self.id,
                    snap_index, snap_term, offset, total, done,
                    bytes(view[offset:end]))
            except ConnectionError:
                return
            with self._lock:
                if pterm > self.term:
                    self._step_down_locked(pterm)
                    return
                if self.role != ROLE_LEADER or self.term != term:
                    return
                if held >= total:
                    self._ship_offset.pop(peer, None)
                    self._next[peer] = snap_index + 1
                    self._match[peer] = snap_index
                    return
                offset = held
                self._ship_offset[peer] = (key, offset)

    def _frame_batch(self, peer: str, entries: List[LogEntry]
                     ) -> Optional[List[LogEntry]]:
        """The longest prefix of `entries` whose encoded bytes fit the
        transport's `max_append_bytes` (all of them when it states
        none).  None when the first entry alone is over the limit: it
        can never be shipped, which is logged, once per entry."""
        cap = self.transport.max_append_bytes
        if cap is None or not entries:
            return entries
        total = 2                                   # the array brackets
        for k, e in enumerate(entries):
            total += e.encoded_bytes() + (1 if k else 0)
            if total > cap:
                if k == 0:
                    # replicators of several peers meet here: the
                    # once-per-entry mark is taken under the lock
                    with self._lock:
                        first = self._oversized != e.index
                        self._oversized = e.index
                    if first:
                        _log.error(
                            "raft %s: entry %d (%d bytes) exceeds the "
                            "transport's %d-byte append limit; %s cannot "
                            "catch up past it", self.id, e.index,
                            e.encoded_bytes(), cap, peer)
                    return None
                return entries[:k]
        return entries

    def _advance_commit_locked(self) -> None:
        peers = self.cfg.peers or [self.id]
        matches = sorted((self._match.get(p, 0) for p in peers),
                        reverse=True)
        majority = matches[len(peers) // 2]
        # only commit entries from the CURRENT term by counting
        # (raft §5.4.2); prior-term entries commit transitively
        if majority > self.commit_index and \
                self.log.term_at(majority) == self.term:
            self.commit_index = majority
            # commit_index persistence is an optimization (bounds replay
            # on restart), not a safety requirement — batch it off the
            # hot path; stop()/compaction write the exact value
            if self.commit_index - self._meta_saved_commit >= 64:
                self._save_meta_locked()
            self._cv.notify_all()

    def _apply_committed_locked(self) -> None:
        if self._applier is not None:
            # a started member applies on its applier thread
            self._cv.notify_all()
            return
        while self.last_applied < self.commit_index:
            e = self.log.get(self.last_applied + 1)
            if e is None:
                break
            if e.etype == CONFIG:
                self._adopt_config_locked(list(e.payload))
            else:
                self.fsm.apply(e.index, e.etype, e.payload)
            self.last_applied = e.index
        self._cv.notify_all()
        if (self.log.last_index() - self.log.offset
                > self.cfg.snapshot_threshold):
            self._compact_locked()

    def _apply_loop(self) -> None:
        """A started member's FSM apply, one committed entry at a time,
        OUTSIDE the raft lock (hashicorp/raft applies on its own FSM
        goroutine): appends, heartbeats and votes are answered while a
        large entry is decoded into the store, so a follower busy
        applying is neither a silent leader's victim (an election) nor a
        slow voter the leader's calls time out on."""
        while True:
            with self._lock:
                while (self.running and not self._snapshot_wanted
                       and self.last_applied >= self.commit_index):
                    self._cv.wait(0.5)
                if not self.running:
                    return
                snap_at = None
                if self._snapshot_wanted:
                    self._snapshot_wanted = False
                    snap_at = self.last_applied
                    self._applying = -1       # an install waits it out
                else:
                    e = self.log.get(self.last_applied + 1)
                    if e is None:
                        # behind a snapshot being installed: it moves
                        # last_applied past the compacted prefix
                        self._cv.wait(0.05)
                        continue
                    if e.etype == CONFIG:
                        self._adopt_config_locked(list(e.payload))
                        self.last_applied = e.index
                        self._cv.notify_all()
                        continue
                    self._applying = e.index
            if snap_at is not None:
                # snapshot_now, between two entries: the store holds
                # exactly the log to snap_at
                data = (self.fsm.snapshot()
                        if snap_at > self.snapshot_index else None)
                with self._lock:
                    if data is not None:
                        self._compact_locked(data, snap_at)
                    self._applying = 0
                    self._snapshot_done = True
                    self._cv.notify_all()
                continue
            try:
                self.fsm.apply(e.index, e.etype, e.payload)
            except Exception:
                _log.exception("raft %s: FSM apply of entry %d failed; "
                               "this member stops applying", self.id,
                               e.index)
                with self._lock:
                    self._applying = 0
                    self._cv.notify_all()
                raise
            with self._lock:
                self._applying = 0
                self.last_applied = e.index
                self._cv.notify_all()
                compact = (self.log.last_index() - self.log.offset
                           > self.cfg.snapshot_threshold)
            if compact:
                # the applier is the FSM's one writer, so the store holds
                # exactly the log to e.index while it takes the snapshot
                # outside the lock (a large store takes seconds, which
                # appends and heartbeats must not wait out)
                data = self.fsm.snapshot()
                with self._lock:
                    self._compact_locked(data, e.index)

    def _adopt_config_locked(self, peers: List[str]) -> None:
        """Adopt a committed membership change. Additions start
        replication from the leader's snapshot/backlog; removals stop
        counting toward quorum immediately (a removed self keeps
        applying until stopped — it simply never wins elections under
        the stickiness guard)."""
        old = set(self.cfg.peers)
        self.cfg.peers = list(peers)
        self._save_meta_locked()
        if self.role == ROLE_LEADER:
            if self.id not in peers:
                # a leader that committed its own removal steps down
                # (raft §6) — staying leader would let the stickiness
                # guard pin the cluster to a non-member forever
                self.role = ROLE_FOLLOWER
                self._reset_election_deadline_locked()
                self._role_events.append("follower")
                self._sync_replicators_locked()
                return
            for p in peers:
                if p not in old and p != self.id:
                    self._next[p] = self.log.last_index() + 1
                    self._match[p] = 0
            for p in old - set(peers):
                self._next.pop(p, None)
                self._match.pop(p, None)
            self._sync_replicators_locked()

    def add_learner(self, peer: str) -> None:
        """Start replicating to a NON-VOTING peer (it never counts
        toward quorum — _advance_commit iterates cfg.peers only)."""
        with self._lock:
            if peer not in self._staging and peer not in self.cfg.peers:
                self._staging.append(peer)
                self._next[peer] = self.log.last_index() + 1
                self._match[peer] = 0
                self._sync_replicators_locked()

    def learner_caught_up(self, peer: str) -> bool:
        with self._lock:
            # require real replicated progress: the peer must have acked
            # appends up to the current commit AND near the log head —
            # a freshly restored commit_index of 0 must not vacuously
            # pass a peer that holds nothing
            match = self._match.get(peer, 0)
            target = max(self.commit_index, self.log.last_index() - 1)
            return target > 0 and match >= target

    def remove_learner(self, peer: str) -> None:
        with self._lock:
            if peer in self._staging:
                self._staging.remove(peer)
            if peer not in self.cfg.peers:
                self._next.pop(peer, None)
                self._match.pop(peer, None)
            self._sync_replicators_locked()

    def propose_config(self, peers: List[str],
                       timeout: float = 10.0) -> int:
        """Propose a new peer set. One-at-a-time changes only (so old
        and new quorums always overlap, raft §6): the set may differ
        from the current config by a single server, and a previous
        membership change must be COMMITTED before the next — both
        checked under the same lock as the append, so concurrent
        callers cannot interleave conflicting configs into the log."""
        with self._lock:
            if self._closed:
                raise NotLeaderError(None)
            if self.role != ROLE_LEADER:
                raise NotLeaderError(self.leader_id)
            for e in self.log.slice_from(self.commit_index + 1):
                if e.etype == CONFIG:
                    raise ValueError(
                        "a membership change is already in flight")
            cur = set(self.cfg.peers)
            if len(cur.symmetric_difference(peers)) > 1:
                raise ValueError(
                    "membership changes must add or remove one server")
            index = self._append_locked(CONFIG, list(peers))
            term = self.term
        return self._wait_applied(index, term, timeout)

    # --------------------------------------------------------- snapshots
    def snapshot_now(self, timeout: float = 600.0) -> int:
        """Take a snapshot at the last applied entry and compact the log
        to it now, as hashicorp/raft's user snapshot (`Raft.Snapshot`)
        does beside the threshold; returns the snapshot index.  A started
        member's applier takes it between two entries, outside the lock,
        as it takes its threshold compactions."""
        with self._lock:
            if self._applier is None:
                if self.last_applied > self.snapshot_index:
                    self._compact_locked()
                return self.snapshot_index
            self._snapshot_wanted, self._snapshot_done = True, False
            self._cv.notify_all()
            deadline = time.monotonic() + timeout
            while not self._snapshot_done:
                remain = deadline - time.monotonic()
                if remain <= 0 or not self.running:
                    raise TimeoutError("snapshot not taken in time")
                self._cv.wait(min(remain, 0.5))
            return self.snapshot_index

    def _compact_locked(self, data: Optional[bytes] = None,
                        index: int = 0) -> None:
        """Snapshot the FSM at last_applied and drop the log up to it;
        or, given `data` taken at `index` (the applier's snapshot, taken
        outside the lock), up to that index unless a snapshot install
        has moved past it."""
        if data is None:
            data, index = self.fsm.snapshot(), self.last_applied
        elif index <= self.snapshot_index:
            return
        self.snapshot_term = self.log.term_at(index)
        self.snapshot_index = index
        self._keep_snapshot_locked(data)
        self.log.compact_to(self.snapshot_index)
        self._save_meta_locked()

    def _keep_snapshot_locked(self, data: bytes) -> None:
        """The snapshot at snapshot_index: to the snapshot file where
        there is one, and kept for shipping to a follower behind it."""
        if self._snap_path:
            tmp = self._snap_path + ".tmp"
            with open(tmp, "wb") as f:
                f.write(data)
            os.replace(tmp, self._snap_path)
        self._snap_data = data

    def _read_snapshot_locked(self) -> bytes:
        """The snapshot at snapshot_index, read once and kept while it
        ships (a node restarted from disk reads its snapshot file)."""
        if self._snap_data is None:
            if self._snap_path and os.path.exists(self._snap_path):
                with open(self._snap_path, "rb") as f:
                    self._snap_data = f.read()
            else:
                self._snap_data = self.fsm.snapshot()
        return self._snap_data

    # ------------------------------------------------------ RPC handlers
    def rpc_request_vote(self, term: int, candidate: str,
                         last_log_index: int, last_log_term: int):
        with self._lock:
            if term < self.term:
                return self.term, False
            # leader stickiness (raft §6 disruptive-server guard, the
            # reference's CheckQuorum/pre-vote analog): while appends
            # from a live leader are arriving, refuse votes — a removed
            # server with a stale config cannot depose the leader
            lo, _hi = self.cfg.election_timeout_s
            if (self.role == ROLE_FOLLOWER
                    and time.monotonic() - self._last_leader_contact < lo
                    and candidate != self.voted_for):
                return self.term, False
            if term > self.term:
                self._step_down_locked(term)
            my_last = self.log.last_index()
            my_term = (self.log.term_at(my_last)
                       if my_last > self.snapshot_index
                       else self.snapshot_term)
            up_to_date = (last_log_term > my_term
                          or (last_log_term == my_term
                              and last_log_index >= my_last))
            if (self.voted_for in (None, candidate)) and up_to_date:
                self.voted_for = candidate
                self._save_meta_locked()
                self._reset_election_deadline_locked()
                return self.term, True
            return self.term, False

    def rpc_append_entries(self, term: int, leader: str, prev_index: int,
                           prev_term: int, entries, leader_commit: int):
        events = False
        with self._lock:
            if term < self.term:
                return self.term, False, 0
            if term > self.term or self.role != ROLE_FOLLOWER:
                was_leader = self.role == ROLE_LEADER
                self.term = term
                self.role = ROLE_FOLLOWER
                self.voted_for = None
                self._save_meta_locked()
                if was_leader:
                    self._role_events.append("follower")
                    self._sync_replicators_locked()
                    events = True
            self.leader_id = leader
            self._last_leader_contact = time.monotonic()
            self._reset_election_deadline_locked()
            # consistency check
            if prev_index > self.snapshot_index:
                if (prev_index > self.log.last_index()
                        or self.log.term_at(prev_index) != prev_term):
                    return self.term, False, min(self.log.last_index(),
                                                 prev_index - 1)
            new = []
            for (i, t, y, p) in entries:
                existing_term = self.log.term_at(i)
                if i <= self.log.last_index():
                    if existing_term != t:
                        self.log.truncate_from(i)
                        new.append(LogEntry(i, t, y, p))
                else:
                    new.append(LogEntry(i, t, y, p))
            if new:
                self.log.append(new)
            match = prev_index + len(entries)
            # only what this call matched is known to equal the
            # leader's log: a tail past it may be another term's
            commit = min(leader_commit, match)
            if commit > self.commit_index:
                self.commit_index = commit
                self._save_meta_locked()
            self._apply_committed_locked()
            out = self.term, True, match
        if events:
            self._fire_role_events()
        return out

    def rpc_install_snapshot(self, term: int, leader: str,
                             snap_index: int, snap_term: int, offset: int,
                             total: int, done: bool, data: bytes):
        """One chunk of the leader's snapshot at `snap_index`, `offset`
        bytes into its `total`.  The chunks build up in a buffer keyed
        (leader, term, snap_index): a chunk of a new key starts it
        afresh, a chunk whose offset is not the buffer's length is
        refused.  Returns (term, the bytes of this snapshot held): the
        leader resumes from there; `total` once it is installed (or an
        install is not needed).  The FSM restores on `done` only.
        Every chunk resets the election deadline (hashicorp/raft's
        streamed InstallSnapshot keeps the follower quiet as well)."""
        with self._lock:
            if term < self.term:
                return self.term, 0
            self.term = term
            self.role = ROLE_FOLLOWER
            self._sync_replicators_locked()
            self.leader_id = leader
            self._last_leader_contact = time.monotonic()
            self._reset_election_deadline_locked()
            if snap_index <= self.last_applied:
                return self.term, total
            key = (leader, term, snap_index)
            if key != self._install_key:
                self._install_key = key
                self._install_buf = bytearray()
            buf = self._install_buf
            if offset != len(buf):
                return self.term, len(buf)
            buf.extend(data)
            if not done:
                return self.term, len(buf)
            if len(buf) != total:
                # a done chunk short of the total: start again
                self._install_key, self._install_buf = None, bytearray()
                return self.term, 0
            snap = bytes(buf)
            self._install_key, self._install_buf = None, bytearray()
            while self._applying:               # the applier's entry
                self._cv.wait(0.05)
            self.fsm.restore(snap)
            self.snapshot_index = snap_index
            self.snapshot_term = snap_term
            self.last_applied = snap_index
            self.commit_index = max(self.commit_index, snap_index)
            self.log.compact_to(snap_index)
            self._keep_snapshot_locked(snap)
            self._save_meta_locked()
            # restoring a large snapshot is not the leader's silence
            self._last_leader_contact = time.monotonic()
            self._reset_election_deadline_locked()
            return self.term, total
