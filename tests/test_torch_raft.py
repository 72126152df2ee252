"""The port's wire codec, raft FSM and single-node server write path
(`nomad_tpu_torch.utils.codec`, `.raft`, `.server.server`) against the
JAX package's, on the CPU.

One builder makes the same objects (fixed ids, names, addresses and
times) with each package's own mock and structs; `to_wire` of each must
be the same JSON, and each package's decoder must read either payload
back to the same JSON as the other's decoder.  The same sequence of writes through each
package's single-node `Server` (every write a raft proposal applied by
the FSM) must leave identical store tables and indexes; ids the server
mints itself (eval ids) are renamed by first appearance and wall-clock
stamps zeroed before the comparison.  A three-server cluster of the port
on the in-process transport elects one leader and replicates to every
follower."""
import json
import re

import pytest

from nomad_tpu import mock as ref_mock
from nomad_tpu import structs as ref_structs
from nomad_tpu.acl import ACLPolicy as RefACLPolicy
from nomad_tpu.acl import ACLToken as RefACLToken
from nomad_tpu.acl import NamespaceRule as RefNamespaceRule
from nomad_tpu.client.sim import wait_until
from nomad_tpu.raft import NotLeaderError as RefNotLeaderError
from nomad_tpu.server.server import Server as RefServer
from nomad_tpu.utils import codec as ref_codec
from nomad_tpu_torch import mock as port_mock
from nomad_tpu_torch import structs as port_structs
from nomad_tpu_torch.acl import ACLPolicy as PortACLPolicy
from nomad_tpu_torch.acl import ACLToken as PortACLToken
from nomad_tpu_torch.acl import NamespaceRule as PortNamespaceRule
from nomad_tpu_torch.raft import (InProcTransport, NotLeaderError,
                                  RaftConfig)
from nomad_tpu_torch.server.server import Server as PortServer
from nomad_tpu_torch.utils import codec as port_codec
from test_torch_state_store import dump

PKGS = {
    "ref": (ref_mock, ref_structs, ref_codec, RefServer,
            (RefACLPolicy, RefACLToken, RefNamespaceRule)),
    "port": (port_mock, port_structs, port_codec, PortServer,
             (PortACLPolicy, PortACLToken, PortNamespaceRule)),
}


class Build:
    """Objects with fixed identities for one package."""

    def __init__(self, pkg):
        self.mock, self.st, self.codec, self.Server, self.acl = PKGS[pkg]

    def node(self, i):
        n = self.mock.node(id=f"node-{i:03d}", name=f"node-{i}",
                           datacenter=f"dc{i % 2}")
        n.secret_id = f"secret-{i}"
        n.node_resources.networks[0].ip = f"10.0.0.{i + 1}"
        n.compute_class()
        return n

    def job(self, name="job-a"):
        j = self.mock.job(id=name)
        j.task_groups[0].count = 2
        j.submit_time = 1000.0
        return j

    def alloc(self, job, k, node_id):
        a = self.mock.alloc(job=job, node_id=node_id)
        a.id = f"alloc-{job.id}-{k}"
        a.eval_id = "eval-fixed"
        a.name = self.st.alloc_name(job.id, "web", k)
        a.create_time = a.modify_time = 1000.0 + k
        for tr in a.allocated_resources.tasks.values():
            tr.networks = []
        return a

    def eval(self, job):
        e = self.mock.eval_(job_id=job.id)
        e.id = f"eval-{job.id}"
        e.create_time = e.modify_time = 2000.0
        return e

    def plan(self, job, allocs, stops=()):
        p = self.st.Plan(eval_id="eval-fixed", job=job, priority=50)
        for a in allocs:
            p.append_alloc(a)
        result = self.st.PlanResult(
            node_allocation={a.node_id: [a] for a in allocs})
        for a in stops:
            result.node_update.setdefault(a.node_id, []).append(a)
        return p, result


def wire_objects(pkg):
    b = Build(pkg)
    node = b.node(1)
    job = b.job()
    alloc = b.alloc(job, 0, node.id)
    _plan, result = b.plan(job, [alloc], stops=[b.alloc(job, 1, node.id)])
    return {"node": node, "job": job, "alloc": alloc,
            "eval": b.eval(job), "plan_result": result}


def as_json(x):
    return json.dumps(x, sort_keys=True)


@pytest.mark.parametrize("kind", ["node", "job", "alloc", "eval",
                                  "plan_result"])
def test_to_wire_is_json_equal(kind):
    ref = wire_objects("ref")[kind]
    port = wire_objects("port")[kind]
    ref_wire = ref_codec.to_wire(ref)
    port_wire = port_codec.to_wire(port)
    assert as_json(port_wire) == as_json(ref_wire)
    # each decoder reads a payload back as the other package's does
    # (decoding widens JSON ints to float-typed fields in both)
    for wire in (ref_wire, port_wire):
        assert as_json(port_codec.to_wire(port_codec.from_wire(
            type(port), wire))) == as_json(ref_codec.to_wire(
                ref_codec.from_wire(type(ref), wire)))


_UUID = re.compile(r"[0-9a-f]{8}-[0-9a-f]{4}-[0-9a-f]{4}-[0-9a-f]{4}-"
                   r"[0-9a-f]{12}")


def canon(x, ids):
    """`x` with every uuid renamed by first appearance (the server mints
    eval ids) and wall-clock stamps (`*_time`) zeroed."""
    if isinstance(x, str):
        return _UUID.sub(lambda m: ids.setdefault(m.group(0),
                                                  f"<id{len(ids)}>"), x)
    if isinstance(x, dict):
        return {canon(k, ids): (0 if isinstance(k, str)
                                and k.endswith("_time") else canon(v, ids))
                for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [canon(v, ids) for v in x]
    return x


def server_writes(pkg):
    """One sequence of writes through a single-node server (not started:
    a bootstrapped single node takes writes at once)."""
    b = Build(pkg)
    s = b.Server(num_workers=0, **({"device": "cpu"} if pkg == "port"
                                   else {}))
    try:
        nodes = [b.node(i) for i in range(6)]
        for n in nodes:
            s.register_node(n)
        job = b.job()
        s.register_job(job)
        other = b.job("job-b")
        s.register_job(other)
        stored = s.store.job_by_id(job.namespace, job.id)
        allocs = [b.alloc(stored, k, nodes[k].id) for k in range(2)]
        plan, result = b.plan(stored, allocs)
        s._apply_plan(plan, result)
        stored_b = s.store.job_by_id(other.namespace, other.id)
        allocs_b = [b.alloc(stored_b, k, nodes[2 + k].id) for k in range(2)]
        plan_b, result_b = b.plan(stored_b, allocs_b)
        index, finish = s._apply_plan_batch_async([(plan_b, result_b)])
        assert finish() == index
        upd = []
        for a in allocs:
            u = s.store.alloc_by_id(a.id)
            u = type(u)(**{**vars(u)})
            u.client_status = b.st.ALLOC_CLIENT_RUNNING
            upd.append(u)
        s.update_allocs_from_client(upd)
        s.update_node_status(nodes[5].id, b.st.NODE_STATUS_DOWN)
        s.update_node_eligibility(nodes[4].id, b.st.NODE_SCHED_INELIGIBLE)
        s.upsert_secret("default", "app/db", {"password": "hunter2"})
        ACLPolicy, ACLToken, NamespaceRule = b.acl
        s.upsert_acl_policy(ACLPolicy(
            name="readers", namespaces=[NamespaceRule(name="default",
                                                      policy="read")]))
        s.upsert_acl_token(ACLToken(accessor_id="acc-1", secret_id="sec-1",
                                    name="reader", policies=["readers"]))
        s.deregister_job(other.namespace, other.id)
        return canon(dump(s.store), {})
    finally:
        s.stop()


def test_server_writes_leave_identical_store():
    ref = server_writes("ref")
    port = server_writes("port")
    assert port["index"] == ref["index"]
    assert port["indexes"] == ref["indexes"]
    assert set(port["tables"]) == set(ref["tables"])
    for name in ref["tables"]:
        assert port["tables"][name] == ref["tables"][name], name


def test_three_server_cluster_elects_and_replicates():
    transport = InProcTransport()
    peers = [f"s{i}" for i in range(3)]
    servers = [PortServer(num_workers=0, device="cpu",
                          raft_config=RaftConfig(
                              node_id=p, peers=peers,
                              election_timeout_s=(0.10, 0.25),
                              heartbeat_interval_s=0.03),
                          raft_transport=transport) for p in peers]
    try:
        for s in servers:
            s.start()
        assert wait_until(lambda: sum(s.is_leader() for s in servers) == 1,
                          timeout=15)
        leader = next(s for s in servers if s.is_leader())
        followers = [s for s in servers if s is not leader]
        b = Build("port")
        leader.register_node(b.node(0))
        job = b.job()
        leader.register_job(job)
        assert wait_until(lambda: all(
            f.store.job_by_id(job.namespace, job.id) is not None
            and f.store.latest_index() == leader.store.latest_index()
            for f in followers), timeout=15)
        want = canon(dump(leader.store), {})
        for f in followers:
            assert canon(dump(f.store), {}) == want
        with pytest.raises(NotLeaderError) as e:
            followers[0].register_job(b.job("job-b"))
        assert e.value.leader_id == leader.raft.id
    finally:
        for s in servers:
            s.stop()


# ------------------------------------------- replication over slow peers
def follower_commit_after_matched_prefix(pkg):
    """A follower holding a stale term-1 tail gets a term-2 leader's
    first append, which matches only a prefix of that tail and carries
    a commit index past it.  Returns the follower's (commit, applied)."""
    if pkg == "ref":
        from nomad_tpu.raft import InProcTransport as Transport
        from nomad_tpu.raft import RaftConfig as Config
        from nomad_tpu.raft import RaftNode, StateFSM
        from nomad_tpu.state.store import StateStore
    else:
        from nomad_tpu_torch.raft import InProcTransport as Transport
        from nomad_tpu_torch.raft import RaftConfig as Config
        from nomad_tpu_torch.raft import RaftNode, StateFSM
        from nomad_tpu_torch.state.store import StateStore
    f = RaftNode(Config(node_id="f", peers=["a", "b", "f"], fsync=False),
                 StateFSM(StateStore()), Transport())
    f.rpc_append_entries(1, "a", 0, 0, [(i, 1, "noop", None)
                                        for i in (1, 2, 3)], 0)
    f.rpc_append_entries(2, "b", 1, 1, [(2, 1, "noop", None)], 3)
    return f.commit_index, f.last_applied


def test_follower_commits_only_the_matched_prefix():
    """Raft's min(leaderCommit, index of the last new entry): the port's
    follower commits entry 2, the one the call matched, and not its own
    stale entry 3; the reference's commits up to its log's end."""
    assert follower_commit_after_matched_prefix("port") == (2, 2)
    assert follower_commit_after_matched_prefix("ref") == (3, 3)


def slow_peer_cluster():
    transport = InProcTransport()
    peers = ["s0", "s1", "s2"]
    servers = [PortServer(num_workers=0, device="cpu",
                          raft_config=RaftConfig(
                              node_id=p, peers=peers, fsync=False,
                              election_timeout_s=(1.0, 2.0),
                              heartbeat_interval_s=0.05),
                          raft_transport=transport) for p in peers]
    for s in servers:
        s.start()
    assert wait_until(lambda: sum(s.is_leader() for s in servers) == 1,
                      timeout=20)
    leader = next(s for s in servers if s.is_leader())
    return servers, leader, [s for s in servers if s is not leader]


@pytest.mark.parametrize("slow", ["append_call", "fsm_apply"])
def test_slow_follower_does_not_depose_the_leader(slow):
    """One follower answers an append with entries 3 s late, or takes
    3 s to apply one: the leader keeps its term (each peer has its own
    replication thread and an in-flight call gets heartbeats beside it;
    a follower applies off the raft lock), and the slow follower ends up
    with the entry."""
    import time
    servers, leader, (slow_f, fast_f) = slow_peer_cluster()
    try:
        if slow == "append_call":
            real = slow_f.raft.rpc_append_entries

            def late(term, ldr, prev_i, prev_t, entries, commit):
                if entries:
                    time.sleep(3.0)
                return real(term, ldr, prev_i, prev_t, entries, commit)
            slow_f.raft.rpc_append_entries = late
        else:
            real = slow_f.fsm.apply

            def late(index, etype, p):
                if etype == "secret_upsert":
                    time.sleep(3.0)
                return real(index, etype, p)
            slow_f.fsm.apply = late
        term = leader.raft.term
        leader.upsert_secret("default", "slow/1", {"k": "v"})
        assert wait_until(lambda: fast_f.store.secret_by_path(
            "default", "slow/1") is not None, timeout=10)
        assert wait_until(lambda: slow_f.store.secret_by_path(
            "default", "slow/1") is not None, timeout=20)
        time.sleep(0.5)
        assert leader.is_leader() and leader.raft.term == term
        assert [s.raft.term for s in servers] == [term] * 3
    finally:
        for s in servers:
            s.stop()


def test_barrier_applies_the_log_before_the_leader_reads_the_store():
    """`RaftNode.barrier` returns once every entry of the leader's log is
    applied, refuses off the leader, and a server's leadership runs it
    before it restores evals from the store (Nomad's leader.go:229)."""
    from nomad_tpu_torch.raft import RaftNode, StateFSM
    from nomad_tpu_torch.state.store import StateStore
    node = RaftNode(RaftConfig(node_id="n", peers=[], fsync=False),
                    StateFSM(StateStore()), InProcTransport())
    with pytest.raises(NotLeaderError):
        node.barrier()
    node.bootstrap_single()
    node.propose("noop", None)
    assert node.barrier() == node.log.last_index() == node.last_applied

    s = PortServer(num_workers=1, device="cpu")
    order = []
    real_barrier, real_restore = s.raft.barrier, s._restore_evals
    s.raft.barrier = lambda *a: (order.append("barrier"),
                                 real_barrier(*a))[1]
    s._restore_evals = lambda: (order.append("restore"), real_restore())[1]
    try:
        s.start()
        assert order == ["barrier", "restore"]
    finally:
        s.stop()


# ------------------------------------------------ chunked InstallSnapshot
def test_snapshot_ships_in_chunks_and_resumes_a_refused_chunk(monkeypatch):
    """A follower behind the leader's compaction point catches up by an
    InstallSnapshot in chunks (the chunk size patched small): one chunk
    is lost on the way, so the follower refuses the next one (its offset
    is not the buffer's length) and the leader resumes from the offset
    the refusal gives.  The follower ends with the leader's store."""
    import time
    from nomad_tpu_torch.raft import node as raft_node
    monkeypatch.setattr(raft_node, "SNAPSHOT_CHUNK_BYTES", 2048)
    transport = InProcTransport()
    peers = ["s0", "s1", "s2"]
    servers = [PortServer(num_workers=0, device="cpu",
                          raft_config=RaftConfig(
                              node_id=p, peers=peers, fsync=False,
                              election_timeout_s=(0.5, 1.0),
                              heartbeat_interval_s=0.05,
                              snapshot_threshold=16),
                          raft_transport=transport) for p in peers]
    try:
        for s in servers:
            s.start()
        assert wait_until(lambda: sum(s.is_leader() for s in servers) == 1,
                          timeout=20)
        leader = next(s for s in servers if s.is_leader())
        victim = next(s for s in servers if s is not leader)
        vid = victim.raft.id
        timeouts = victim.raft.cfg.election_timeout_s
        with victim.raft._lock:
            victim.raft.cfg.election_timeout_s = (3600.0, 3600.0)
            victim.raft._reset_election_deadline_locked()
        real_call = transport.call
        paused = [True]
        chunks, dropped = [], []

        def call(target, method, *args):
            if target == vid and paused[0]:
                raise ConnectionError(f"peer {target} paused")
            if target == vid and method == "rpc_install_snapshot":
                offset, data = args[4], args[7]
                if offset > 0 and not dropped:
                    # lost on the way: the leader reads an ack the
                    # follower never sent
                    dropped.append(offset)
                    return args[0], offset + len(data)
                out = real_call(target, method, *args)
                chunks.append((offset, len(data), out[1]))
                return out
            return real_call(target, method, *args)
        transport.call = call
        for i in range(40):
            leader.upsert_secret("default", f"s/{i}", {"v": f"{i}" * 500})
        last = leader.raft.log.last_index()
        assert wait_until(lambda: leader.raft.snapshot_index >= last - 16,
                          timeout=15)
        assert len(leader.raft._read_snapshot()) > 8 * 2048
        with victim.raft._lock:
            victim.raft.cfg.election_timeout_s = timeouts
            victim.raft._deadline = time.monotonic() + 2.0
        paused[0] = False
        assert wait_until(lambda: victim.store.secret_by_path(
            "default", "s/39") is not None, timeout=30)
        assert wait_until(lambda: victim.store.latest_index()
                          == leader.store.latest_index(), timeout=15)
        assert canon(dump(victim.store), {}) == canon(dump(leader.store), {})
        assert victim.raft.snapshot_index > 0
        # the chunk after the lost one was refused with the follower's
        # offset, and the leader resumed from there
        assert len(dropped) == 1
        refused = [k for k, (off, _n, held) in enumerate(chunks)
                   if off > held]
        assert refused, chunks
        k = refused[0]
        assert chunks[k][2] == dropped[0]
        assert chunks[k + 1][0] == dropped[0]
        assert all(n <= 2048 for _off, n, _held in chunks)
    finally:
        for s in servers:
            s.stop()


def installs_after_leader_compaction(pkg):
    """A three-member in-process cluster of `pkg`; once every member has
    applied the same entries, the leader alone compacts its log, so the
    entry before each follower's next one is its snapshot point, and one
    more entry commits.  Returns the InstallSnapshot calls the leader
    made, and whether the new entry committed and both followers hold
    it."""
    import time
    if pkg == "ref":
        from nomad_tpu.raft import InProcTransport as Transport
        from nomad_tpu.raft import RaftConfig as Config
        ServerCls, kw = RefServer, {}
    else:
        Transport, Config = InProcTransport, RaftConfig
        ServerCls, kw = PortServer, {"device": "cpu"}
    transport = Transport()
    peers = ["s0", "s1", "s2"]
    servers = [ServerCls(num_workers=0, raft_config=Config(
        node_id=p, peers=peers, fsync=False, election_timeout_s=(1.0, 2.0),
        heartbeat_interval_s=0.05), raft_transport=transport, **kw)
        for p in peers]
    try:
        for s in servers:
            s.start()
        assert wait_until(lambda: sum(s.is_leader() for s in servers) == 1,
                          timeout=20)
        leader = next(s for s in servers if s.is_leader())
        followers = [s for s in servers if s is not leader]
        for i in range(4):
            leader.upsert_secret("default", f"a/{i}", {"v": "x"})
        applied = leader.raft.last_applied
        assert wait_until(lambda: all(f.raft.last_applied == applied
                                      for f in followers), timeout=10)
        real_call = transport.call
        installs = []

        def call(target, method, *args):
            if method == "rpc_install_snapshot":
                installs.append(target)
            return real_call(target, method, *args)
        transport.call = call
        with leader.raft._lock:
            leader.raft._compact_locked()
        assert leader.raft.snapshot_index == applied
        time.sleep(0.3)
        try:
            leader.upsert_secret("default", "b", {"v": "y"})
        except (NotLeaderError, RefNotLeaderError, TimeoutError):
            return installs, False
        ok = wait_until(lambda: all(
            f.store.secret_by_path("default", "b") is not None
            for f in followers), timeout=10)
        return installs, ok
    finally:
        for s in servers:
            s.stop()


def test_leader_compaction_sends_no_snapshot_to_caught_up_followers():
    """At its snapshot point the port's leader sends the snapshot's term
    as the previous entry's, so followers that hold that entry take the
    next append and need no snapshot; the reference sends term 0, each
    follower refuses, and the leader ships each one the whole snapshot
    (which a frame over TCP cannot hold at config-3 size)."""
    port_installs, port_ok = installs_after_leader_compaction("port")
    assert port_ok and port_installs == []
    ref_installs, _ref_ok = installs_after_leader_compaction("ref")
    assert len(set(ref_installs)) == 2, ref_installs


def test_snapshot_now_compacts_at_the_applied_entry():
    """`RaftNode.snapshot_now` (hashicorp/raft's user snapshot): a
    started member's applier takes the snapshot between two entries and
    compacts the log to the last applied one; the kept snapshot restores
    to the store it was taken from, and a single-node member compacts
    inline."""
    from nomad_tpu_torch.raft import RaftNode, StateFSM
    from nomad_tpu_torch.state.store import StateStore
    servers, leader, _followers = slow_peer_cluster()
    try:
        for i in range(6):
            leader.upsert_secret("default", f"n/{i}", {"v": str(i)})
        index = leader.raft.snapshot_now()
        assert index == leader.raft.last_applied == leader.raft.log.offset
        restored = StateStore()
        StateFSM(restored).restore(leader.raft._read_snapshot())
        assert canon(dump(restored), {}) == canon(dump(leader.store), {})
    finally:
        for s in servers:
            s.stop()
    single = RaftNode(RaftConfig(node_id="n", peers=[], fsync=False),
                      StateFSM(StateStore()), InProcTransport())
    single.bootstrap_single()
    single.propose("noop", None)
    assert single.snapshot_now() == single.last_applied == single.log.offset


def test_a_learner_never_campaigns_and_joins_as_a_voter():
    """A fourth member started with the voters' configuration but not
    itself (a learner) is never contacted for several election timeouts:
    it starts no election, so no leader is deposed by its term.  Added
    by `add_server_peer`, it catches up, adopts the configuration that
    names it, and holds the leader's store."""
    import time
    servers, leader, _followers = slow_peer_cluster()
    transport = leader.raft.transport
    voters = list(leader.raft.cfg.peers)
    joiner = PortServer(num_workers=0, device="cpu",
                        raft_config=RaftConfig(
                            node_id="s3", peers=voters, fsync=False,
                            election_timeout_s=(0.2, 0.3),
                            heartbeat_interval_s=0.05),
                        raft_transport=transport)
    try:
        joiner.start()
        term = leader.raft.term
        time.sleep(1.5)
        assert joiner.raft.term == 0 and joiner.raft.role == "follower"
        assert leader.is_leader() and leader.raft.term == term
        leader.upsert_secret("default", "j/1", {"k": "v"})
        leader.add_server_peer("s3", catchup_timeout_s=15.0)
        assert wait_until(lambda: "s3" in joiner.raft.cfg.peers, timeout=10)
        assert wait_until(lambda: joiner.store.secret_by_path(
            "default", "j/1") is not None, timeout=10)
        assert leader.is_leader() and leader.raft.term == term
    finally:
        for s in servers + [joiner]:
            s.stop()
