"""SWIM-style membership over the RPC substrate.

Reference: vendored hashicorp/memberlist + serf as wired in
nomad/serf.go — gossip disseminates the member list, a probe cycle
detects failures (direct ping, then indirect ping through k peers),
suspicion protects against false positives, and incarnation numbers
let a live member refute its own death.

This implementation keeps the protocol but rides the framed-TCP RPC
layer instead of UDP packets: each round gossips full state to a
random peer (anti-entropy push-pull) and probes one member. Clusters
here are server quorums (3-5 per region plus federation peers), so
full-state sync per round is well within frame budget.

The counterpart of `nomad_tpu.membership.gossip`.  Every random draw
(the gossip peer, the probe target, the indirect-probe helpers) comes
from the agent's own `random.Random` (unseeded, as the reference's
draws from the process-wide generator are), so no other code's use of
`random` shifts or is shifted by them.
"""
from __future__ import annotations

import logging
import random
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

from ..rpc.client import DIAL_TIMEOUT_S, ClientPool, RpcError
from ..rpc.server import RpcHandlerError, RpcServer

_log = logging.getLogger(__name__)

STATUS_ALIVE = "alive"
STATUS_SUSPECT = "suspect"
STATUS_DEAD = "dead"
STATUS_LEFT = "left"

_RANK = {STATUS_ALIVE: 0, STATUS_SUSPECT: 1, STATUS_DEAD: 2,
         STATUS_LEFT: 3}


@dataclass
class Member:
    id: str
    addr: Tuple[str, int]
    region: str = "global"
    status: str = STATUS_ALIVE
    incarnation: int = 0
    tags: Dict[str, str] = field(default_factory=dict)

    def wire(self) -> dict:
        return {"id": self.id, "addr": list(self.addr),
                "region": self.region, "status": self.status,
                "incarnation": self.incarnation, "tags": self.tags}

    @staticmethod
    def from_wire(d: dict) -> "Member":
        return Member(id=d["id"], addr=(d["addr"][0], int(d["addr"][1])),
                      region=d.get("region", "global"),
                      status=d.get("status", STATUS_ALIVE),
                      incarnation=int(d.get("incarnation", 0)),
                      tags=d.get("tags", {}))


class GossipAgent:
    """One server's membership view + the gossip/probe loops.

    Callbacks (reference: serf.go:34-40 event handler):
      on_join(member)  — a member newly seen alive
      on_fail(member)  — a member transitioned to suspect->dead
    """

    def __init__(self, member: Member, rpc_server: RpcServer,
                 gossip_interval_s: float = 0.2,
                 probe_interval_s: float = 0.3,
                 probe_timeout_s: float = 0.5,
                 suspicion_timeout_s: float = 1.5,
                 indirect_probes: int = 2,
                 on_join: Optional[Callable[[Member], None]] = None,
                 on_fail: Optional[Callable[[Member], None]] = None):
        self.me = member
        self._rng = random.Random()
        self.rpc = rpc_server
        self._members: Dict[str, Member] = {member.id: member}
        self._suspect_since: Dict[str, float] = {}
        self._lock = threading.Lock()
        self._pool = ClientPool()
        self._shutdown = threading.Event()
        self._threads: List[threading.Thread] = []
        self.gossip_interval_s = gossip_interval_s
        self.probe_interval_s = probe_interval_s
        self.probe_timeout_s = probe_timeout_s
        self.suspicion_timeout_s = suspicion_timeout_s
        self.indirect_probes = indirect_probes
        self.on_join = on_join
        self.on_fail = on_fail
        rpc_server.register("Gossip.Sync", self._rpc_sync)
        rpc_server.register("Gossip.Ping", self._rpc_ping)
        rpc_server.register("Gossip.PingReq", self._rpc_ping_req)

    # ------------------------------------------------------------ API
    def join(self, addr: Tuple[str, int]) -> None:
        """Push-pull with a seed member (serf join)."""
        remote = self._sync_with(addr)
        if remote is None:
            raise ConnectionError(f"join {addr} failed")

    def members(self, alive_only: bool = False) -> List[Member]:
        with self._lock:
            out = [m for m in self._members.values()
                   if not alive_only or m.status == STATUS_ALIVE]
            return sorted(out, key=lambda m: m.id)

    def member(self, member_id: str) -> Optional[Member]:
        with self._lock:
            return self._members.get(member_id)

    def regions(self) -> List[str]:
        with self._lock:
            return sorted({m.region for m in self._members.values()
                           if m.status == STATUS_ALIVE})

    def members_of_region(self, region: str) -> List[Member]:
        with self._lock:
            return sorted((m for m in self._members.values()
                           if m.region == region
                           and m.status == STATUS_ALIVE),
                          key=lambda m: m.id)

    def start(self) -> None:
        for fn, name in ((self._gossip_loop, "gossip"),
                         (self._probe_loop, "probe")):
            t = threading.Thread(target=fn, daemon=True,
                                 name=f"{name}-{self.me.id}")
            t.start()
            self._threads.append(t)

    def leave(self) -> None:
        """Graceful exit: mark self left and push once (serf Leave)."""
        with self._lock:
            self.me.incarnation += 1
            self.me.status = STATUS_LEFT
            self._members[self.me.id] = self.me
            peers = self._gossip_targets_locked()
        for m in peers:
            self._sync_with(m.addr)
        self.stop()

    def stop(self) -> None:
        self._shutdown.set()
        self._pool.close()

    # ------------------------------------------------------ rpc verbs
    def _check_running(self) -> None:
        # a stopped agent must be unreachable even while its shared
        # RpcServer keeps serving other subsystems — peers probe
        # liveness through these verbs
        if self._shutdown.is_set():
            raise RpcHandlerError("unreachable",
                                  f"gossip agent {self.me.id} stopped")

    def _rpc_sync(self, params):
        """Anti-entropy push-pull: merge the caller's view, reply with
        ours."""
        self._check_running()
        for d in params[0]:
            self._merge(Member.from_wire(d))
        with self._lock:
            return [m.wire() for m in self._members.values()]

    def _rpc_ping(self, params):
        self._check_running()
        return self.me.id

    def _rpc_ping_req(self, params):
        """Indirect probe on behalf of a suspicious peer."""
        self._check_running()
        target_id = params[0]
        with self._lock:
            target = self._members.get(target_id)
        if target is None:
            return False
        return self._direct_ping(target)

    # ---------------------------------------------------------- loops
    def _gossip_loop(self) -> None:
        while not self._shutdown.wait(self.gossip_interval_s):
            try:
                with self._lock:
                    peers = self._gossip_targets_locked()
                if peers:
                    self._sync_with(self._rng.choice(peers).addr)
            except Exception:                   # noqa: BLE001
                _log.exception("%s: gossip round failed", self.me.id)

    def _probe_loop(self) -> None:
        while not self._shutdown.wait(self.probe_interval_s):
            try:
                self._probe_round()
            except Exception:                   # noqa: BLE001
                _log.exception("%s: probe round failed", self.me.id)

    def _probe_round(self) -> None:
        with self._lock:
            candidates = [m for m in self._members.values()
                          if m.id != self.me.id
                          and m.status in (STATUS_ALIVE,
                                           STATUS_SUSPECT)]
        if candidates:
            target = self._rng.choice(candidates)
            if self._direct_ping(target) or self._indirect_ping(target):
                self._set_alive(target.id, target.incarnation)
            else:
                self._suspect(target)
        self._expire_suspects()

    # ------------------------------------------------------- plumbing
    def _gossip_targets_locked(self) -> List[Member]:
        return [m for m in self._members.values()
                if m.id != self.me.id and m.status != STATUS_LEFT]

    def _sync_with(self, addr) -> Optional[List[Member]]:
        try:
            with self._lock:
                state = [m.wire() for m in self._members.values()]
            out = self._pool.get(f"{addr[0]}:{addr[1]}", addr).call(
                "Gossip.Sync", [state], timeout=self.probe_timeout_s)
        except (ConnectionError, RpcError):
            return None
        members = [Member.from_wire(d) for d in out]
        for m in members:
            self._merge(m)
        return members

    def _direct_ping(self, target: Member) -> bool:
        try:
            key = f"{target.addr[0]}:{target.addr[1]}"
            out = self._pool.get(key, target.addr).call(
                "Gossip.Ping", [], timeout=self.probe_timeout_s)
            return out == target.id
        except (ConnectionError, RpcError):
            return False

    def _indirect_ping(self, target: Member) -> bool:
        with self._lock:
            helpers = [m for m in self._members.values()
                       if m.status == STATUS_ALIVE
                       and m.id not in (self.me.id, target.id)]
        self._rng.shuffle(helpers)
        for helper in helpers[:self.indirect_probes]:
            try:
                key = f"{helper.addr[0]}:{helper.addr[1]}"
                ok = self._pool.get(key, helper.addr).call(
                    "Gossip.PingReq", [target.id],
                    timeout=DIAL_TIMEOUT_S + 2 * self.probe_timeout_s)
                if ok:
                    return True
            except (ConnectionError, RpcError):
                continue
        return False

    def _merge(self, incoming: Member) -> None:
        """Incarnation-ordered merge (memberlist aliveness rules):
        higher incarnation wins; at equal incarnation the worse status
        wins. News about OURSELVES that isn't alive is refuted by
        bumping our incarnation (memberlist refute)."""
        fire_join = fire_fail = None
        with self._lock:
            if incoming.id == self.me.id:
                if (incoming.status != STATUS_ALIVE
                        and incoming.incarnation >= self.me.incarnation
                        and self.me.status == STATUS_ALIVE):
                    self.me.incarnation = incoming.incarnation + 1
                return
            cur = self._members.get(incoming.id)
            applied = False
            if cur is None:
                self._members[incoming.id] = incoming
                applied = True
                if incoming.status == STATUS_ALIVE:
                    fire_join = incoming
            else:
                newer = (incoming.incarnation, _RANK[incoming.status]) \
                    > (cur.incarnation, _RANK[cur.status])
                if newer:
                    was = cur.status
                    self._members[incoming.id] = incoming
                    applied = True
                    if (was != STATUS_ALIVE
                            and incoming.status == STATUS_ALIVE):
                        fire_join = incoming
                    if (was in (STATUS_ALIVE, STATUS_SUSPECT)
                            and incoming.status == STATUS_DEAD):
                        fire_fail = incoming
            # suspicion-clock bookkeeping only follows records that WON
            # the merge: a stale alive claim (rank-losing) must not
            # clear an armed suspicion timer
            if applied and incoming.status == STATUS_ALIVE:
                self._suspect_since.pop(incoming.id, None)
            elif applied and incoming.status == STATUS_SUSPECT:
                # a suspicion learned via gossip expires here too —
                # every observer runs its own suspicion clock
                # (memberlist's suspicion timeout), otherwise a member
                # that only ever HEARD the suspicion keeps it forever
                self._suspect_since.setdefault(incoming.id,
                                               time.monotonic())
        if fire_join and self.on_join:
            self.on_join(fire_join)
        if fire_fail and self.on_fail:
            self.on_fail(fire_fail)

    def _set_alive(self, member_id: str, incarnation: int) -> None:
        with self._lock:
            m = self._members.get(member_id)
            if m and m.status == STATUS_SUSPECT \
                    and m.incarnation <= incarnation:
                m.status = STATUS_ALIVE
                self._suspect_since.pop(member_id, None)

    def _suspect(self, target: Member) -> None:
        with self._lock:
            m = self._members.get(target.id)
            if m and m.status == STATUS_ALIVE:
                m.status = STATUS_SUSPECT
                self._suspect_since[m.id] = time.monotonic()
                _log.info("%s: member %s suspect", self.me.id, m.id)

    def _expire_suspects(self) -> None:
        now = time.monotonic()
        fire: List[Member] = []
        with self._lock:
            for mid, since in list(self._suspect_since.items()):
                if now - since < self.suspicion_timeout_s:
                    continue
                m = self._members.get(mid)
                if m and m.status == STATUS_SUSPECT:
                    m.status = STATUS_DEAD
                    fire.append(m)
                self._suspect_since.pop(mid, None)
        for m in fire:
            _log.warning("%s: member %s failed", self.me.id, m.id)
            if self.on_fail:
                self.on_fail(m)
