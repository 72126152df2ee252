"""The port's eval broker, blocked evals, plan queue and plan applier
(`nomad_tpu_torch.server`) against the JAX package's, on the CPU.

Every scenario of tests/test_server_plane.py (broker order, per-job
serialization, type routing, nack redelivery, the delivery limit and the
failed queue, delayed evals, batch dequeue, the nack timer; blocked evals
by class, escaped, missed unblocks and duplicates; the plan queue;
`evaluate_plan` and the applier loop) is written once over a package's
modules and run in both.  Each records what it observed — which eval
came out (by its position among the evals it made, since eval ids are
fresh uuids), the stats the components report, the plan results — and
the two records must be equal; each scenario also asserts the
reference's expected behaviour itself."""
import threading
import time
from types import SimpleNamespace

import pytest

import nomad_tpu.server.blocked_evals as ref_blocked
import nomad_tpu.server.eval_broker as ref_broker
import nomad_tpu.server.plan_apply as ref_apply
import nomad_tpu.server.plan_queue as ref_queue
import nomad_tpu.state.store as ref_store
import nomad_tpu_torch.server.blocked_evals as port_blocked
import nomad_tpu_torch.server.eval_broker as port_broker
import nomad_tpu_torch.server.plan_apply as port_apply
import nomad_tpu_torch.server.plan_queue as port_queue
import nomad_tpu_torch.state.store as port_store
from nomad_tpu import mock as ref_mock
from nomad_tpu import structs as ref_structs
from nomad_tpu_torch import mock as port_mock
from nomad_tpu_torch import structs as port_structs


def package(name):
    if name == "ref":
        mods = (ref_mock, ref_structs, ref_broker, ref_blocked, ref_queue,
                ref_apply, ref_store)
    else:
        mods = (port_mock, port_structs, port_broker, port_blocked,
                port_queue, port_apply, port_store)
    mock, st, broker, blocked, queue, apply_, store = mods
    return SimpleNamespace(
        mock=mock, st=st, EvalBroker=broker.EvalBroker,
        FAILED_QUEUE=broker.FAILED_QUEUE, BlockedEvals=blocked.BlockedEvals,
        PlanQueue=queue.PlanQueue, PlanApplier=apply_.PlanApplier,
        evaluate_plan=apply_.evaluate_plan, StateStore=store.StateStore)


def make_broker(P, **kw):
    b = P.EvalBroker(**kw)
    b.set_enabled(True)
    return b


def pos(evals, ev):
    """The position of a dequeued eval among those the scenario made."""
    if ev is None:
        return None
    return next(i for i, e in enumerate(evals) if e.id == ev.id)


# ------------------------------------------------------------- broker
def sc_broker_priority_order(P):
    b = make_broker(P)
    evals = [P.mock.eval_(priority=10), P.mock.eval_(priority=90)]
    for e in evals:
        b.enqueue(e)
    ev1, t1 = b.dequeue(["service"], 1.0)
    ev2, t2 = b.dequeue(["service"], 1.0)
    out = [pos(evals, ev1), pos(evals, ev2),
           b.ack(ev1.id, t1), b.ack(ev2.id, t2)]
    assert out == [1, 0, None, None]
    return out


def sc_broker_per_job_serialization(P):
    b = make_broker(P)
    evals = [P.mock.eval_(job_id="job-1"), P.mock.eval_(job_id="job-1")]
    for e in evals:
        b.enqueue(e)
    ev, token = b.dequeue(["service"], 1.0)
    held, _ = b.dequeue(["service"], 0.05)
    stats = b.stats()
    b.ack(ev.id, token)
    ev2, t2 = b.dequeue(["service"], 1.0)
    b.ack(ev2.id, t2)
    out = [pos(evals, ev), held, stats["total_blocked"], pos(evals, ev2)]
    assert out == [0, None, 1, 1]
    return out


def sc_broker_type_routing(P):
    b = make_broker(P)
    evals = [P.mock.eval_(type="service"), P.mock.eval_(type="batch")]
    for e in evals:
        b.enqueue(e)
    ev, t = b.dequeue(["batch"], 1.0)
    b.ack(ev.id, t)
    ev2, t2 = b.dequeue(["service", "batch"], 1.0)
    b.ack(ev2.id, t2)
    out = [pos(evals, ev), pos(evals, ev2)]
    assert out == [1, 0]
    return out


def sc_broker_nack_redelivers(P):
    b = make_broker(P, initial_nack_delay_s=0.05)
    evals = [P.mock.eval_()]
    b.enqueue(evals[0])
    ev, token = b.dequeue(["service"], 1.0)
    b.nack(ev.id, token)
    ev2, t2 = b.dequeue(["service"], 2.0)
    b.ack(ev2.id, t2)
    out = [pos(evals, ev2), b.stats()["nacks"]]
    assert out == [0, 1]
    return out


def sc_broker_delivery_limit_to_failed_queue(P):
    b = make_broker(P, initial_nack_delay_s=0.01, delivery_limit=2)
    evals = [P.mock.eval_()]
    b.enqueue(evals[0])
    seen = []
    for _ in range(2):
        ev, token = b.dequeue(["service"], 2.0)
        seen.append(pos(evals, ev))
        b.nack(ev.id, token)
    ev, token = b.dequeue([P.FAILED_QUEUE], 2.0)
    seen.append(pos(evals, ev))
    b.ack(ev.id, token)
    assert seen == [0, 0, 0]
    return seen + [b.stats()["total_unacked"]]


def sc_broker_delayed_eval(P):
    b = make_broker(P)
    evals = [P.mock.eval_()]
    evals[0].wait_until = time.time() + 0.2
    b.enqueue(evals[0])
    early, _ = b.dequeue(["service"], 0.05)
    ev, t = b.dequeue(["service"], 2.0)
    b.ack(ev.id, t)
    out = [early, pos(evals, ev)]
    assert out == [None, 0]
    return out


def sc_broker_dequeue_batch_many_jobs(P):
    b = make_broker(P)
    evals = [P.mock.eval_(job_id=f"job-{i}") for i in range(6)]
    for e in evals:
        b.enqueue(e)
    batch = b.dequeue_batch(["service"], 4, 1.0)
    for ev, t in batch:
        b.ack(ev.id, t)
    out = [pos(evals, ev) for ev, _t in batch]
    assert len(out) == 4 and len({evals[i].job_id for i in out}) == 4
    return out


def sc_broker_nack_timer_auto_redelivers(P):
    b = make_broker(P, nack_delay_s=0.1, initial_nack_delay_s=0.01)
    evals = [P.mock.eval_()]
    b.enqueue(evals[0])
    b.dequeue(["service"], 1.0)            # never acked: the timer fires
    ev2, t2 = b.dequeue(["service"], 3.0)
    b.ack(ev2.id, t2)
    out = [pos(evals, ev2)]
    assert out == [0]
    return out


def sc_broker_failed_holder_promotes_backlog(P):
    b = make_broker(P, initial_nack_delay_s=0.01, delivery_limit=1)
    evals = [P.mock.eval_(job_id="j1"), P.mock.eval_(job_id="j1")]
    for e in evals:
        b.enqueue(e)
    ev, token = b.dequeue(["service"], 1.0)
    b.nack(ev.id, token)                   # the delivery limit parks it
    ev2, t2 = b.dequeue(["service"], 2.0)
    b.ack(ev2.id, t2)
    out = [pos(evals, ev), pos(evals, ev2)]
    assert out == [0, 1]
    return out


# ------------------------------------------------------- blocked evals
def blocked_pair(P):
    b = make_broker(P)
    blocked = P.BlockedEvals(b)
    blocked.set_enabled(True)
    return b, blocked


def sc_blocked_unblock_by_class(P):
    b, blocked = blocked_pair(P)
    e = P.mock.eval_(status=P.st.EVAL_STATUS_BLOCKED)
    e.class_eligibility = {"class-a": True, "class-b": False}
    e.snapshot_index = 100
    blocked.block(e)
    out = [blocked.stats()["total_blocked"]]
    blocked.unblock("class-b", 110)        # an ineligible class: nothing
    out.append(blocked.stats()["total_blocked"])
    blocked.unblock("class-a", 120)
    out.append(blocked.stats()["total_blocked"])
    ev, t = b.dequeue(["service"], 1.0)
    out += [pos([e], ev), ev.status]
    b.ack(ev.id, t)
    assert out == [1, 1, 0, 0, P.st.EVAL_STATUS_PENDING]
    return out


def sc_blocked_escaped_unblocked_by_any_class(P):
    b, blocked = blocked_pair(P)
    e = P.mock.eval_(status=P.st.EVAL_STATUS_BLOCKED)
    e.escaped_computed_class = True
    e.snapshot_index = 100
    blocked.block(e)
    out = [blocked.stats()["total_escaped"]]
    blocked.unblock("whatever-class", 150)
    ev, t = b.dequeue(["service"], 1.0)
    b.ack(ev.id, t)
    out.append(pos([e], ev))
    assert out == [1, 0]
    return out


def sc_blocked_missed_unblock(P):
    b, blocked = blocked_pair(P)
    blocked.unblock("class-a", 200)        # capacity moved at index 200
    e = P.mock.eval_(status=P.st.EVAL_STATUS_BLOCKED)
    e.class_eligibility = {"class-a": True}
    e.snapshot_index = 100                 # ... after the eval's snapshot
    blocked.block(e)
    ev, t = b.dequeue(["service"], 1.0)
    b.ack(ev.id, t)
    out = [pos([e], ev), blocked.stats()["total_blocked"]]
    assert out == [0, 0]
    return out


def sc_blocked_duplicate_jobs(P):
    _b, blocked = blocked_pair(P)
    evals = [P.mock.eval_(job_id="j1", status=P.st.EVAL_STATUS_BLOCKED)
             for _ in range(2)]
    for e in evals:
        e.class_eligibility = {"c": False}
        blocked.block(e)
    out = [[pos(evals, d) for d in blocked.get_duplicates()],
           blocked.stats()["total_blocked"]]
    assert out == [[0], 1]
    return out


# ---------------------------------------------------- plan queue / apply
def sc_plan_queue_priority_and_future(P):
    q = P.PlanQueue()
    q.set_enabled(True)
    lo = q.enqueue(P.st.Plan(priority=10))
    hi = q.enqueue(P.st.Plan(priority=90))
    first, second = q.dequeue(1.0), q.dequeue(1.0)
    second.future.respond(P.st.PlanResult(), None)
    res, err = second.future.wait(1.0)
    out = [first is hi, second is lo, err, res is not None]
    assert out == [True, True, None, True]
    return out


def store_with_node(P, cpu=4000, mem=8192):
    store = P.StateStore()
    n = P.mock.node(id="node-1", name="node-1")
    n.node_resources.cpu = cpu
    n.node_resources.memory_mb = mem
    n.reserved_resources.cpu = 0
    n.reserved_resources.memory_mb = 0
    store.upsert_node(1, n)
    return store, n


def plan_with_alloc(P, node, cpu=500, mem=256):
    job = P.mock.job(id="job-plan")
    a = P.mock.alloc(job=job, node_id=node.id)
    a.allocated_resources.tasks["web"].cpu = cpu
    a.allocated_resources.tasks["web"].memory_mb = mem
    a.allocated_resources.tasks["web"].networks = []
    p = P.st.Plan(job=job)
    p.append_alloc(a)
    return p, a


def result_shape(result):
    return [sorted((nid, len(v)) for nid, v in
                   result.node_allocation.items()),
            result.refresh_index > 0]


def sc_evaluate_plan_accepts_fitting(P):
    store, node = store_with_node(P)
    plan, _a = plan_with_alloc(P, node)
    out = result_shape(P.evaluate_plan(store.snapshot(), plan))
    assert out == [[("node-1", 1)], False]
    return out


def sc_evaluate_plan_rejects_overcommit(P):
    store, node = store_with_node(P, cpu=600, mem=300)
    occupant = P.mock.alloc(node_id=node.id)
    occupant.allocated_resources.tasks["web"].cpu = 400
    occupant.allocated_resources.tasks["web"].networks = []
    occupant.client_status = P.st.ALLOC_CLIENT_RUNNING
    store.upsert_allocs(2, [occupant])
    plan, _a = plan_with_alloc(P, node, cpu=500)
    out = result_shape(P.evaluate_plan(store.snapshot(), plan))
    assert out == [[], True]
    return out


def sc_evaluate_plan_rejects_down_node(P):
    store, node = store_with_node(P)
    store.update_node_status(5, node.id, P.st.NODE_STATUS_DOWN)
    plan, _a = plan_with_alloc(P, node)
    out = result_shape(P.evaluate_plan(store.snapshot(), plan))
    assert out[0] == []
    return out


def sc_plan_applier_loop_applies(P):
    store, node = store_with_node(P)
    q = P.PlanQueue()
    q.set_enabled(True)
    index = {"i": 100}

    def apply_fn(plan, result):
        index["i"] += 1
        store.upsert_plan_results(index["i"], result, plan.job)
        return index["i"]

    applier = P.PlanApplier(q, store, apply_fn)
    applier.start()
    try:
        plan, alloc = plan_with_alloc(P, node)
        result, err = q.enqueue(plan).future.wait(5.0)
        out = [err, result.full_commit(plan)[0],
               store.alloc_by_id(alloc.id) is not None, result.alloc_index]
    finally:
        applier.stop()
        q.set_enabled(False)
    assert out == [None, True, True, 101]
    return out


SCENARIOS = {name[3:]: fn for name, fn in globals().items()
             if name.startswith("sc_")}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_server_plane_matches_reference(name):
    ref = SCENARIOS[name](package("ref"))
    port = SCENARIOS[name](package("port"))
    assert port == ref


@pytest.mark.parametrize("group", [False, True], ids=["single", "group"])
def test_applier_answers_a_plan_before_dispatching_the_next(group):
    """The single-server raft applies an entry inside the dispatch, so
    the applier answers plan N once N+1 is evaluated and before N+1 is
    dispatched: N's worker never waits out N+1's apply.  Here N+1's
    apply holds until N is answered (one plan a round, or group commits
    of two).  The JAX package answers N after N+1's dispatch, and so
    fails this (ROADMAP.md, Queue 3); the port alone is held to it."""
    P = package("port")
    store, node = store_with_node(P, cpu=64000, mem=65536)
    q = P.PlanQueue()
    q.set_enabled(True)
    release = threading.Event()
    index = {"i": 100}

    def apply(pairs):
        index["i"] += 1
        i = index["i"]
        for plan, result in pairs:
            if plan.job.id.startswith("second"):
                release.wait(10.0)
            store.upsert_plan_results(i, result, plan.job)
        return i, (lambda timeout=10.0: i)

    if group:
        kw = {"apply_batch_async_fn": apply, "group_commit": 2}
    else:
        kw = {"apply_async_fn": lambda pl, res: apply([(pl, res)])}
    applier = P.PlanApplier(q, store, lambda pl, res: apply([(pl, res)])[0],
                            **kw)
    n = 2 if group else 1
    plans = []
    for name in [f"first{k}" for k in range(n)] + [f"second{k}"
                                                   for k in range(n)]:
        job = P.mock.job(id=name)
        a = P.mock.alloc(job=job, node_id=node.id)
        a.allocated_resources.tasks["web"].networks = []
        plan = P.st.Plan(job=job)
        plan.append_alloc(a)
        plans.append(plan)
    # all queued before the applier starts: N is held while N+1 waits
    pending = [q.enqueue(plan) for plan in plans]
    applier.start()
    try:
        firsts = [p.future.wait(5.0) for p in pending[:n]]
        before_release = not release.is_set()
    finally:
        release.set()
        seconds = [p.future.wait(5.0) for p in pending[n:]]
        applier.stop()
        q.set_enabled(False)
    assert before_release

    def answers(futs):
        return [(err, getattr(r, "alloc_index", None)) for r, err in futs]
    assert answers(firsts) == [(None, 101)] * n
    assert answers(seconds) == [(None, 102)] * n
    assert len(store.allocs_by_node(node.id)) == 2 * n


# -------------------------------------- the worker's plan wait (no deadline)
def held_plan_server(monkeypatch, hold):
    """A one-worker port `Server(device="cpu")` on the in-process raft
    whose FSM holds every plan entry's apply until `hold` is set, and a
    record of the timeout each plan future's `wait` was given."""
    from nomad_tpu_torch.server.server import Server
    waits = []
    real_wait = port_queue.PlanFuture.wait

    def wait(self, timeout=None):
        waits.append(timeout)
        return real_wait(self, timeout)
    monkeypatch.setattr(port_queue.PlanFuture, "wait", wait)
    srv = Server(num_workers=1, device="cpu")
    real_apply = srv.fsm.apply

    def apply(index, etype, payload):
        if etype in ("plan_result", "plan_results_batch"):
            hold.wait()
        return real_apply(index, etype, payload)
    srv.fsm.apply = apply
    for i in range(2):
        n = port_mock.node(id=f"node-{i}", name=f"node-{i}")
        srv.register_node(n)
    job = port_mock.job(id="held")
    job.task_groups[0].count = 2
    job.task_groups[0].tasks[0].resources.networks = []
    return srv, job, waits


def test_worker_waits_for_a_slow_plan_apply_with_no_deadline(monkeypatch):
    """The FSM's plan apply is held for 3 s: the worker waits for its
    plan with no deadline (its future's `wait` is given none) and the
    eval completes once the apply is let go, with no constant patched."""
    hold = threading.Event()
    srv, job, waits = held_plan_server(monkeypatch, hold)
    srv.start()
    try:
        ev = srv.register_job(job)
        deadline = time.monotonic() + 20.0
        while not waits and time.monotonic() < deadline:
            time.sleep(0.02)
        assert waits == [None]
        time.sleep(3.0)
        assert srv.store.eval_by_id(ev.id).status == \
            port_structs.EVAL_STATUS_PENDING
        hold.set()
        deadline = time.monotonic() + 20.0
        while (srv.store.eval_by_id(ev.id).status
               != port_structs.EVAL_STATUS_COMPLETE
               and time.monotonic() < deadline):
            time.sleep(0.02)
        assert srv.store.eval_by_id(ev.id).status == \
            port_structs.EVAL_STATUS_COMPLETE
        live = [a for a in srv.store.allocs_by_job("default", job.id)
                if not a.terminal_status()]
        assert sorted(a.name for a in live) == ["held.web[0]", "held.web[1]"]
    finally:
        hold.set()
        srv.stop()


def test_worker_with_a_plan_in_apply_returns_when_the_server_stops(
        monkeypatch):
    """The server stops while a plan's apply is held: the applier
    answers the plan it holds with an error at once, while the apply is
    still held.  The worker then fails its eval, a write that waits
    behind the held apply on the single-node raft, and once the apply
    is let go the worker and `stop()` return within a bounded time,
    the eval failed."""
    hold = threading.Event()
    srv, job, waits = held_plan_server(monkeypatch, hold)
    srv.start()
    worker = srv.workers[0]
    submits = []
    real_submit = worker.submit_plan
    worker.submit_plan = lambda plan: submits.append(real_submit(plan)) \
        or submits[-1]
    stopper = threading.Thread(target=srv.stop, daemon=True)
    try:
        ev = srv.register_job(job)
        deadline = time.monotonic() + 20.0
        while not waits and time.monotonic() < deadline:
            time.sleep(0.02)
        assert waits == [None]
        stopper.start()
        deadline = time.monotonic() + 15.0
        while not submits and time.monotonic() < deadline:
            time.sleep(0.02)
        assert submits == [(None, None)] and not hold.is_set()
        hold.set()
        worker.join(timeout=15.0)
        stopper.join(timeout=15.0)
        assert not worker.is_alive() and not stopper.is_alive()
        assert srv.store.eval_by_id(ev.id).status == \
            port_structs.EVAL_STATUS_FAILED
    finally:
        hold.set()
        if stopper.ident is None:
            srv.stop()
        else:
            stopper.join(timeout=15.0)


def test_worker_with_a_plan_in_apply_returns_when_leadership_is_lost():
    """A three-server cluster on the in-process raft: the leader's plan
    apply is held and the leader steps down meanwhile.  The applier's
    wait for the entry raises with the lost leadership, the plan is
    answered with an error and the leader's worker returns within a
    bounded time; the eval is left to the next leader."""
    from nomad_tpu_torch.raft import InProcTransport, RaftConfig
    from nomad_tpu_torch.server.server import Server
    hold = threading.Event()
    transport = InProcTransport()
    peers = ["s0", "s1", "s2"]
    servers = [Server(num_workers=1, device="cpu",
                      raft_config=RaftConfig(
                          node_id=p, peers=peers, fsync=False,
                          election_timeout_s=(1.0, 2.0),
                          heartbeat_interval_s=0.05),
                      raft_transport=transport) for p in peers]
    try:
        for s in servers:
            s.start()
        deadline = time.monotonic() + 20.0
        while (sum(s.is_leader() for s in servers) != 1
               and time.monotonic() < deadline):
            time.sleep(0.02)
        leader = next(s for s in servers if s.is_leader())
        real_apply = leader.fsm.apply
        entered = threading.Event()

        def apply(index, etype, payload):
            if etype in ("plan_result", "plan_results_batch"):
                entered.set()
                hold.wait()
            return real_apply(index, etype, payload)
        leader.fsm.apply = apply
        worker = leader.workers[0]
        submits = []
        real_submit = worker.submit_plan
        worker.submit_plan = lambda plan: submits.append(
            real_submit(plan)) or submits[-1]
        for i in range(2):
            leader.register_node(port_mock.node(id=f"node-{i}",
                                                name=f"node-{i}"))
        job = port_mock.job(id="held")
        job.task_groups[0].count = 2
        job.task_groups[0].tasks[0].resources.networks = []
        leader.register_job(job)
        assert entered.wait(20.0)
        assert leader.raft.step_down()
        worker.join(timeout=15.0)
        assert not worker.is_alive()
        assert submits and submits[0] == (None, None)
    finally:
        hold.set()
        for s in servers:
            s.stop()
