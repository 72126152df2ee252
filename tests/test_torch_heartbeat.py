"""The port's heartbeat failure detector (`nomad_tpu_torch.server.heartbeat`)
against the JAX package's, case by case.

Each case of the reference's `tests/test_heartbeat.py` runs on both
packages (`pkg` = "ref" or "port") and must give the same outcome: the
rate-scaled TTL, the expiry and reset of the bare heartbeater, and on a
running `Server` (the port's with `device="cpu"`) a node that stops
heartbeating marked down with its alloc replaced on the live node, and
a down node restored to ready when it beats again.  Every wait is
bounded and every server is stopped in `finally`."""
import threading
import time

import pytest

from nomad_tpu import mock as ref_mock
from nomad_tpu import structs as ref_structs
from nomad_tpu.server import heartbeat as ref_heartbeat
from nomad_tpu.server.server import Server as RefServer
from nomad_tpu_torch import mock as port_mock
from nomad_tpu_torch import structs as port_structs
from nomad_tpu_torch.server import heartbeat as port_heartbeat
from nomad_tpu_torch.server.server import Server as PortServer

PKGS = {"ref": (ref_mock, ref_structs, ref_heartbeat, RefServer, {}),
        "port": (port_mock, port_structs, port_heartbeat, PortServer,
                 {"device": "cpu"})}
BOTH = pytest.mark.parametrize("pkg", ["ref", "port"])


def server(pkg, **kw):
    _mock, _st, _hb, ServerCls, extra = PKGS[pkg]
    return ServerCls(**kw, **extra)


@BOTH
def test_rate_scaled_interval(pkg):
    rate_scaled_interval = PKGS[pkg][2].rate_scaled_interval
    assert rate_scaled_interval(0.0, 10.0, 100) == 10.0
    assert rate_scaled_interval(50.0, 10.0, 100) == 10.0
    # 10_000 nodes at 50/s -> 200s between heartbeats per node
    assert rate_scaled_interval(50.0, 10.0, 10_000) == 200.0


@BOTH
def test_heartbeater_expiry_and_reset(pkg):
    expired = []
    hb = PKGS[pkg][2].NodeHeartbeater(expired.append,
                                      min_heartbeat_ttl_s=0.05,
                                      heartbeat_grace_s=0.0)
    hb.set_enabled(True)
    try:
        assert hb.reset("n1") is not None
        time.sleep(0.3)
        assert expired == ["n1"]
        assert hb.active() == 0
        # a node that keeps heartbeating never expires
        hb.reset("n2")
        for _ in range(6):
            time.sleep(0.04)
            hb.reset("n2")
        assert "n2" not in expired
        hb.clear("n2")
        time.sleep(0.2)
        assert "n2" not in expired
    finally:
        hb.set_enabled(False)


@BOTH
def test_heartbeater_disabled_is_inert(pkg):
    expired = []
    hb = PKGS[pkg][2].NodeHeartbeater(expired.append,
                                      min_heartbeat_ttl_s=0.05,
                                      heartbeat_grace_s=0.0)
    assert hb.reset("n1") is None   # not leader: no timer
    hb.set_enabled(True)
    hb.reset("n1")
    hb.set_enabled(False)           # leadership lost: timers cancelled
    time.sleep(0.3)
    assert expired == []


@BOTH
def test_missed_heartbeats_reschedule_allocs(pkg):
    """A node stops heartbeating: the leader marks it down and its alloc
    is rescheduled onto the live node with no manual status call.  The
    outcome (the node first placed on, its status, where the replacement
    runs and under which name) is the same on both packages."""
    mock, structs = PKGS[pkg][:2]
    srv = server(pkg, num_workers=2, min_heartbeat_ttl_s=0.3,
                 heartbeat_grace_s=0.2)
    srv.start()
    stop = threading.Event()
    try:
        n_live = mock.node()
        n_dead = mock.node()
        # best-fit prefers the fuller node: enlarge the live node so the
        # job lands on the doomed (default-size) node first
        n_live.node_resources.cpu = n_live.node_resources.cpu * 4
        n_live.node_resources.memory_mb = n_live.node_resources.memory_mb * 4
        srv.register_node(n_live)
        srv.register_node(n_dead)
        names = {n_live.id: "live", n_dead.id: "dead"}
        kill_dead = threading.Event()   # set -> n_dead stops heartbeating

        def beat():
            while not stop.is_set():
                srv.node_heartbeat(n_live.id)
                if not kill_dead.is_set():
                    srv.node_heartbeat(n_dead.id)
                time.sleep(0.05)
        threading.Thread(target=beat, daemon=True).start()

        job = mock.job()
        tg = job.task_groups[0]
        tg.count = 1
        for task in tg.tasks:
            task.resources.networks = []
        srv.register_job(job)

        def live():
            return [a for a in srv.store.allocs_by_job("default", job.id)
                    if not a.terminal_status()]
        deadline = time.time() + 30
        while time.time() < deadline and not live():
            time.sleep(0.05)
        assert live(), "initial placement never happened"
        first = live()[0]

        # n_dead goes silent -> down -> alloc replaced on n_live
        kill_dead.set()
        deadline = time.time() + 30
        while time.time() < deadline:
            node = srv.store.node_by_id(n_dead.id)
            if node.status == structs.NODE_STATUS_DOWN and any(
                    a.node_id == n_live.id for a in live()):
                break
            time.sleep(0.05)
        repl = [a for a in live() if a.node_id == n_live.id]
        outcome = {
            "first": (names[first.node_id], first.name),
            "dead_status": srv.store.node_by_id(n_dead.id).status,
            "replacement": sorted((names[a.node_id], a.name)
                                  for a in repl)}
        job_name = f"{job.id}.web[0]"
        assert outcome == {"first": ("dead", job_name),
                           "dead_status": structs.NODE_STATUS_DOWN,
                           "replacement": [("live", job_name)]}, pkg
    finally:
        stop.set()
        srv.stop()


@BOTH
def test_down_node_resuming_heartbeats_restored_to_ready(pkg):
    mock, structs = PKGS[pkg][:2]
    srv = server(pkg, num_workers=0, min_heartbeat_ttl_s=0.1,
                 heartbeat_grace_s=0.05)
    srv.start()
    try:
        n = mock.node()
        srv.register_node(n)
        # unknown nodes get no TTL: they must re-register
        assert srv.node_heartbeat("no-such-node") is None
        deadline = time.time() + 10
        while time.time() < deadline:
            if srv.store.node_by_id(n.id).status == \
                    structs.NODE_STATUS_DOWN:
                break
            time.sleep(0.02)
        assert srv.store.node_by_id(n.id).status == \
            structs.NODE_STATUS_DOWN
        # heartbeats resume -> restored to ready
        assert srv.node_heartbeat(n.id) is not None
        assert srv.store.node_by_id(n.id).status == \
            structs.NODE_STATUS_READY
    finally:
        srv.stop()
