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
