"""The reference's conservation storms of tests/test_scaleout.py on the
port's scale-out control plane, each under the port's InvariantHarness.

Producers race the port's AdmissionController into a 4-shard EvalBroker
(shed evals park in BlockedEvals' shed lane), consumers race dequeue /
ack / nack across the shards, directly or through the SolveCoordinator's
fire-and-forget fan-back (acks on the drain leader's thread).  After the
drain every eval is accounted for: nothing lost, nothing held, offered
== admitted + shed, and the harness ends `ok`.
"""
import random
import threading
import time

from nomad_tpu_torch import mock
from nomad_tpu_torch.chaos.invariants import InvariantHarness
from nomad_tpu_torch.scheduler.fleet import SolveCoordinator
from nomad_tpu_torch.server.blocked_evals import BlockedEvals
from nomad_tpu_torch.server.eval_broker import EvalBroker
from nomad_tpu_torch.server.serving import AdmissionController
from nomad_tpu_torch.utils.tracing import MeshEventLog

N_PRODUCERS = N_CONSUMERS = 4
EVALS_EACH = 60


def storm_plane():
    broker = EvalBroker(nack_delay_s=30.0, initial_nack_delay_s=0.001,
                        delivery_limit=20, shards=4)
    broker.set_enabled(True)
    be = BlockedEvals(broker)
    be.set_enabled(True)
    adm = AdmissionController(max_pending=64, protect_priority=101,
                              brownout_high=0.9, brownout_low=0.5,
                              brownout_after_s=0.001,
                              ns_rate=5000.0, ns_burst=500.0)
    return broker, be, adm, InvariantHarness(event_log=MeshEventLog())


def producer(k, broker, be, adm, h):
    rng = random.Random(1000 + k)
    for i in range(EVALS_EACH):
        ev = mock.eval_(job_id=f"job-{k}-{i}",
                        priority=rng.choice([30, 50, 70]))
        h.note_enqueued(ev.id)
        if adm.offer(ev, broker.ready_count()):
            broker.enqueue(ev)
        else:
            be.shed(ev)
            h.note_outcome(ev.id, "shed")
        if rng.random() < 0.2:
            time.sleep(0.001)


def run_storm(consumer, broker, be, adm, h, idle=lambda: True):
    """Start the producers and consumers, readmit the shed lane until
    the broker is quiet, stop the consumers."""
    stop = threading.Event()
    producers = [threading.Thread(target=producer,
                                  args=(k, broker, be, adm, h))
                 for k in range(N_PRODUCERS)]
    consumers = [threading.Thread(target=consumer, args=(k, stop))
                 for k in range(N_CONSUMERS)]
    for t in producers + consumers:
        t.start()
    for t in producers:
        t.join(timeout=30.0)
    deadline = time.monotonic() + 20.0
    while time.monotonic() < deadline:
        for ev in be.pop_shed(1000):
            broker.enqueue(ev)
        st = broker.stats()
        if (st["total_ready"] == 0 and st["total_unacked"] == 0
                and st["total_waiting"] == 0 and be.shed_count() == 0
                and idle()):
            break
        time.sleep(0.02)
    stop.set()
    for t in consumers:
        t.join(timeout=10.0)
    assert not any(t.is_alive() for t in producers + consumers)


def assert_conserved(broker, adm, h, acked):
    st = broker.stats()
    assert st["total_ready"] == 0 and st["total_unacked"] == 0 \
        and st["total_waiting"] == 0
    assert h.check_eval_conservation(broker)
    assert h.check_no_double_placement()
    assert h.check_shed_accounting(admission=adm)
    h.raise_if_violated()
    assert h.ok and h.report()["evals_seen"] == N_PRODUCERS * EVALS_EACH
    assert len(acked) == N_PRODUCERS * EVALS_EACH


def test_sharded_broker_conservation_storm_with_harness():
    """Consumers dequeue batches across the shards and ack or nack each
    eval; per-job serialization holds inside one dequeue."""
    broker, be, adm, h = storm_plane()
    acked, lock = set(), threading.Lock()
    serial_ok = []

    def consumer(k, stop):
        rng = random.Random(2000 + k)
        while not stop.is_set():
            batch = broker.dequeue_batch(["service"], 4, 0.02, home=k)
            jobs = [ev.job_id for ev, _tok in batch]
            serial_ok.append(len(jobs) == len(set(jobs)))
            for ev, tok in batch:
                if rng.random() < 0.8:
                    broker.ack(ev.id, tok)
                    h.note_outcome(ev.id, "acked")
                    with lock:
                        acked.add(ev.id)
                else:
                    broker.nack(ev.id, tok)

    run_storm(consumer, broker, be, adm, h)
    assert all(serial_ok)
    assert_conserved(broker, adm, h, acked)


def test_async_fanback_conservation_storm():
    """Consumers nack a fifth of each batch, pause the rest's nack
    deadlines in bulk and hand them to the coordinator with
    submit_nowait; the acks happen on the drain leader's thread in the
    round's finish hook.  After the drain the coordinator queue is
    empty too."""
    broker, be, adm, h = storm_plane()
    acked, lock = set(), threading.Lock()

    def _dispatch(_server, _worker, batch):
        return list(batch)

    def _finish(_server, _worker, rnd):
        broker.ack_batch([(ev.id, tok) for ev, tok in rnd])
        with lock:
            for ev, _tok in rnd:
                h.note_outcome(ev.id, "acked")
                acked.add(ev.id)

    coord = SolveCoordinator(None, max_fused=8, dispatch_fn=_dispatch,
                             finish_fn=_finish)

    def consumer(k, stop):
        rng = random.Random(2000 + k)
        while not stop.is_set():
            batch = broker.dequeue_batch(["service"], 4, 0.02, home=k)
            keep = []
            for ev, tok in batch:
                if rng.random() < 0.2:
                    broker.nack(ev.id, tok)
                else:
                    keep.append((ev, tok))
            if keep:
                broker.pause_nack_batch([(ev.id, tok) for ev, tok in keep])
                coord.submit_nowait(k, keep)

    run_storm(consumer, broker, be, adm, h,
              idle=lambda: coord.pending() == 0)
    assert coord.pending() == 0
    assert_conserved(broker, adm, h, acked)
