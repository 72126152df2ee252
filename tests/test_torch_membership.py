"""The port's gossip membership (`nomad_tpu_torch.membership`) and the
autopilot it drives, against the JAX package's.

SWIM over the RPC layer: full membership from one seed, a hard-killed
member probed to dead with the fail event fired, a graceful leave that
is no failure, and a member refuting its own death; the merge rules
(incarnation order, the worse status at equal incarnation, refutation,
the join / fail events) equal the reference's on the same records.
`RegionRouter` lands a job registered by region name in that region's
cluster and not in its own.  The autopilot (`Server.attach_gossip`): a
server that gossip declares dead leaves the raft peer set and the
quorum shrinks, on the in-process transport (the reference's
`test_raft.py` case) and on a three-server TCP cluster.  Every wait is
bounded and every agent, RPC server and server is stopped in
`finally`."""
import time

import pytest

from nomad_tpu.membership import gossip as ref_gossip
from nomad_tpu_torch import mock
from nomad_tpu_torch.membership import GossipAgent, Member, RegionRouter
from nomad_tpu_torch.membership import gossip as port_gossip
from nomad_tpu_torch.membership.gossip import (STATUS_ALIVE, STATUS_DEAD,
                                               STATUS_LEFT, STATUS_SUSPECT)
from nomad_tpu_torch.raft import InProcTransport, RaftConfig
from nomad_tpu_torch.rpc import RpcServer
from nomad_tpu_torch.rpc.endpoints import serve_cluster
from nomad_tpu_torch.server.server import Server
from nomad_tpu_torch.utils.codec import to_wire


def wait_until(pred, timeout=20.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.02)
    return False


def make_agent(name, region="global", **kw):
    rpc = RpcServer()
    rpc.start()
    agent = GossipAgent(Member(id=name, addr=rpc.addr, region=region),
                        rpc, **kw)
    return agent, rpc


def stop_all(pairs):
    for agent, rpc in pairs:
        agent.stop()
        rpc.stop()


def joined(pairs):
    for agent, _ in pairs:
        agent.start()
    for agent, _ in pairs[1:]:
        agent.join(pairs[0][0].me.addr)
    return wait_until(lambda: all(
        len(agent.members(alive_only=True)) == len(pairs)
        for agent, _ in pairs))


# ------------------------------------------------------------ SWIM
def test_gossip_converges_to_full_membership():
    pairs = [make_agent(f"m{i}") for i in range(3)]
    try:
        # join through one seed only; gossip spreads the rest
        assert joined(pairs)
    finally:
        stop_all(pairs)


def test_probe_marks_dead_member_and_fires_event():
    failed = []
    pairs = [make_agent(f"f{i}") for i in range(3)]
    pairs[0][0].on_fail = lambda m: failed.append(m.id)
    try:
        assert joined(pairs)
        dead_id = pairs[2][0].me.id
        pairs[2][0].stop()                # hard kill: no leave
        pairs[2][1].stop()
        assert wait_until(lambda: (
            pairs[0][0].member(dead_id) is not None
            and pairs[0][0].member(dead_id).status == STATUS_DEAD))
        assert dead_id in failed
    finally:
        stop_all(pairs)


def test_graceful_leave_is_not_a_failure():
    failed = []
    pairs = [make_agent(f"l{i}") for i in range(2)]
    pairs[0][0].on_fail = lambda m: failed.append(m.id)
    try:
        assert joined(pairs)
        left_id = pairs[1][0].me.id
        pairs[1][0].leave()
        pairs[1][1].stop()
        assert wait_until(lambda: (
            pairs[0][0].member(left_id).status == STATUS_LEFT))
        time.sleep(0.5)
        assert left_id not in failed
    finally:
        stop_all(pairs)


def test_refute_own_death():
    a, rpc_a = make_agent("r0")
    try:
        claim = Member(id="r0", addr=a.me.addr, status=STATUS_DEAD,
                       incarnation=a.me.incarnation)
        a._merge(claim)
        assert a.me.status == STATUS_ALIVE
        assert a.me.incarnation > claim.incarnation
    finally:
        a.stop()
        rpc_a.stop()


class _NoRpc:
    def register(self, *_a, **_k):
        pass


MERGES = [
    ("p1", STATUS_ALIVE, 0), ("p2", STATUS_ALIVE, 0),
    ("p1", STATUS_SUSPECT, 0), ("p1", STATUS_ALIVE, 0),   # stale alive
    ("p1", STATUS_ALIVE, 1),                              # refuted
    ("p2", STATUS_DEAD, 0), ("p2", STATUS_SUSPECT, 0),    # worse wins
    ("p2", STATUS_ALIVE, 1), ("p3", STATUS_SUSPECT, 2),
    ("p3", STATUS_DEAD, 2), ("p1", STATUS_LEFT, 1),
    ("me", STATUS_SUSPECT, 0), ("me", STATUS_DEAD, 3),    # refutations
    ("p4", STATUS_ALIVE, 5), ("p4", STATUS_DEAD, 4),
]


def merge_run(g):
    """The same member records through one package's merge: the views
    after each step and the events fired."""
    events = []
    agent = g.GossipAgent(
        g.Member(id="me", addr=("127.0.0.1", 1), region="us"), _NoRpc(),
        on_join=lambda m: events.append(("join", m.id, m.status)),
        on_fail=lambda m: events.append(("fail", m.id, m.status)))
    views = []
    for k, (mid, status, inc) in enumerate(MERGES):
        agent._merge(g.Member(id=mid, addr=("127.0.0.1", 10 + k),
                              region="us", status=status,
                              incarnation=inc))
        views.append(([m.wire() for m in agent.members()],
                      agent.me.incarnation, agent.regions(),
                      sorted(agent._suspect_since)))
    return views, events


def test_merge_rules_match_reference():
    assert merge_run(port_gossip) == merge_run(ref_gossip)


# ------------------------------------------------------- regions
def test_region_routing_cross_region_job_register():
    """Two port clusters, one server each, in regions alpha and beta,
    joined by gossip: `RegionRouter.call_region("beta", ...)` from
    alpha lands the job in beta only."""
    servers_a, rpcs_a, _ = serve_cluster(1, server_kwargs={"device": "cpu"})
    servers_b, rpcs_b, _ = serve_cluster(1, server_kwargs={"device": "cpu"})
    gossips = []
    router = None
    try:
        ga = GossipAgent(Member(id="ga", addr=rpcs_a[0].rpc.addr,
                                region="alpha"), rpcs_a[0].rpc)
        gb = GossipAgent(Member(id="gb", addr=rpcs_b[0].rpc.addr,
                                region="beta"), rpcs_b[0].rpc)
        gossips = [ga, gb]
        ga.start()
        gb.start()
        gb.join(ga.me.addr)
        assert wait_until(lambda: set(ga.regions()) == {"alpha", "beta"})
        assert wait_until(lambda: servers_b[0].is_leader())
        router = RegionRouter(ga)
        assert router.regions() == ["alpha", "beta"]
        job = mock.job()
        router.call_region("beta", "Job.Register", [to_wire(job)])
        assert wait_until(lambda: servers_b[0].store.job_by_id(
            "default", job.id) is not None)
        assert servers_a[0].store.job_by_id("default", job.id) is None
        with pytest.raises(ConnectionError, match="gamma"):
            router.call_region("gamma", "Job.Register", [to_wire(job)])
    finally:
        if router is not None:
            router.close()
        for g in gossips:
            g.stop()
        for s, r in ((servers_a[0], rpcs_a[0]), (servers_b[0], rpcs_b[0])):
            s.stop()
            r.rpc.stop()


# ------------------------------------------------------- autopilot
def leader_of(servers):
    return next((s for s in servers if s.is_leader()), None)


def inproc_cluster(n=3):
    transport = InProcTransport()
    peers = [f"s{i}" for i in range(n)]
    servers = [Server(num_workers=1, device="cpu", raft_config=RaftConfig(
        node_id=f"s{i}", peers=peers, election_timeout_s=(0.10, 0.25),
        heartbeat_interval_s=0.03), raft_transport=transport)
        for i in range(n)]
    for s in servers:
        s.start()
    return servers


def autopilot_shrinks_quorum(servers, rpcs_of):
    """Gossip agents for `servers` (on `rpcs_of(i)`), attached with
    `attach_gossip`; a follower hard-killed with its agent; the leader
    must drop it from the peer set and still commit with the two live
    servers.  Returns the agents to stop."""
    gossips = []
    for i, s in enumerate(servers):
        rpc = rpcs_of(i)
        g = GossipAgent(Member(id=s.raft.id, addr=rpc.addr), rpc,
                        suspicion_timeout_s=1.0)
        gossips.append(g)
        s.attach_gossip(g)
        assert s.gossip is g
        g.start()
    for g in gossips[1:]:
        g.join(gossips[0].me.addr)
    assert wait_until(lambda: all(len(g.members(alive_only=True)) == 3
                                  for g in gossips))
    assert wait_until(lambda: leader_of(servers) is not None)
    leader = leader_of(servers)
    victim = next(s for s in servers if s is not leader)
    vix = servers.index(victim)
    victim.stop()
    gossips[vix].stop()
    rpcs_of(vix).stop()
    assert wait_until(lambda: leader_of(servers) is not None and
                      victim.raft.id not in leader_of(servers).raft.cfg.peers,
                      timeout=30), "dead server never left the peer set"
    live = [s for s in servers if s is not victim]
    assert len(leader_of(live).raft.cfg.peers) == 2
    job = mock.job()
    leader_of(live).register_job(job)
    assert wait_until(lambda: all(
        s.store.job_by_id(job.namespace, job.id) is not None
        for s in live))
    return gossips


def test_autopilot_removes_dead_server_and_quorum_shrinks():
    servers = inproc_cluster()
    rpcs, gossips = [], []
    try:
        for _ in servers:
            rpc = RpcServer()
            rpc.start()
            rpcs.append(rpc)
        gossips = autopilot_shrinks_quorum(servers, lambda i: rpcs[i])
    finally:
        for s in servers:
            s.stop()
        for g in gossips:
            g.stop()
        for r in rpcs:
            r.stop()


def test_autopilot_over_tcp_cluster():
    """The same on a `serve_cluster` of three: each gossip agent shares
    its server's RpcServer with raft and the endpoints."""
    servers, rpcs, _ = serve_cluster(3, server_kwargs={"device": "cpu"})
    gossips = []
    try:
        gossips = autopilot_shrinks_quorum(servers, lambda i: rpcs[i].rpc)
    finally:
        for s in servers:
            s.stop()
        for g in gossips:
            g.stop()
        for r in rpcs:
            r.rpc.stop()


def test_autopilot_is_a_noop_without_gossip_or_off_the_leader():
    s = Server(num_workers=0, device="cpu")
    try:
        assert s.gossip is None
        s._autopilot_reconcile()                 # no gossip: nothing
        agent = GossipAgent(Member(id="x", addr=("127.0.0.1", 1)),
                            _NoRpc())
        fired = []
        agent.on_fail = lambda m: fired.append(m.id)
        s.attach_gossip(agent)
        agent.on_fail(Member(id="y", addr=("127.0.0.1", 2),
                             status=STATUS_DEAD))
        assert fired == ["y"]                    # the earlier hook runs
        assert s.raft.cfg.peers == []
    finally:
        s.stop()
