"""EvalBroker: leader-only, at-least-once priority work queue for evals.

Semantics mirror nomad/eval_broker.go — per-scheduler-type priority heaps
(:65), per-job serialization so at most one eval per job is in flight
(:277-297), blocking Dequeue (:329), Ack/Nack with nack-timer redelivery
and a delivery limit that shunts flapping evals to a `_failed` queue
(:23, :531, :595), and delayed evals via a wait-until heap (:89, :751).

SHARDING: the broker is partitioned into S independent
shards keyed by crc32(namespace, job) — per-shard lock, ready heaps,
`_ready_since` insertion-order age tracking, job slots and nack
deadlines (a heap serviced by the broker's one delayed-watcher thread
— never a timer thread per eval).  A job maps to exactly one shard, so per-job serialization
holds by construction without any cross-shard coordination; evals
without a job route by eval id.  Dequeue starts at the caller's home
shard (its worker index) and steals from the other shards when the
home shard is dry, so no shard strands work.  One shard (the default)
is bit-identical to the pre-shard broker: same heap ordering, same
seeded nack-jitter schedule, same delivery-limit parking.

`dequeue_batch` drains up to K ready evals — each for a different job,
by construction of the per-job serialization — and is the coalescing
point for the fused multi-eval device solve (SURVEY §2.5); the stock
worker loop dequeues singly, matching the reference.  K is sized per
dequeue by the serving tier's BatchController (server/serving.py) from
the queue depth and the oldest ready eval's age, which the broker
tracks here.

The counterpart of `nomad_tpu.server.eval_broker`.
"""
from __future__ import annotations

import heapq
import itertools
import os
import threading
import time as _time
import zlib
from typing import Dict, List, Optional, Sequence, Tuple

from ..structs import Evaluation
from ..utils.ids import generate_uuid
from ..utils.tracing import global_tracer as _tr

FAILED_QUEUE = "_failed"
DEFAULT_NACK_DELAY_S = 5.0
DEFAULT_INITIAL_NACK_DELAY_S = 1.0
DEFAULT_MAX_NACK_DELAY_S = 60.0
DEFAULT_DELIVERY_LIMIT = 3
#: shard count when neither the ctor nor NOMAD_TPU_BROKER_SHARDS says
#: otherwise — 1 keeps the reference (pre-shard) behavior bit-identical
DEFAULT_BROKER_SHARDS = 1


def _default_shards() -> int:
    try:
        return max(1, int(os.environ.get("NOMAD_TPU_BROKER_SHARDS",
                                         str(DEFAULT_BROKER_SHARDS))))
    except ValueError:
        return DEFAULT_BROKER_SHARDS


class _Heap:
    """Max-priority heap with FIFO tie-break."""

    def __init__(self) -> None:
        self._h: List[tuple] = []
        self._count = itertools.count()

    def push(self, ev: Evaluation) -> None:
        heapq.heappush(self._h, (-ev.priority, next(self._count), ev))

    def pop(self) -> Optional[Evaluation]:
        if not self._h:
            return None
        return heapq.heappop(self._h)[2]

    def peek_priority(self) -> Optional[int]:
        if not self._h:
            return None
        return -self._h[0][0]

    def __len__(self) -> int:
        return len(self._h)


class _Unack:
    __slots__ = ("eval", "token", "nack_deadline")

    def __init__(self, ev: Evaluation, token: str):
        self.eval = ev
        self.token = token
        # wall-clock redelivery deadline, or None while paused.  Armed
        # entries also sit in the shard's `_nack_heap`; a pause/ack/nack
        # invalidates lazily (the heap entry's deadline no longer
        # matches), so no per-eval timer thread ever exists — the
        # broker's single delayed-watcher services every deadline.
        self.nack_deadline: Optional[float] = None


class _Shard:
    """One broker partition: its own lock, ready heaps, job slots,
    unacked set, delay heap and nack-deadline heap.  All cross-thread entry
    points take `self._lock`; `_locked`-suffixed helpers document the
    caller already holds it.  Wake-ups for blocked dequeuers go through
    the owning broker's shared ready condition (`notify_ready`) — the
    shard lock is never held while waiting, only while mutating."""

    def __init__(self, broker: "EvalBroker", index: int,
                 nack_jitter_seed: int):
        self._broker = broker
        self.index = index
        self._lock = threading.Lock()
        self._ready: Dict[str, _Heap] = {}
        self._unack: Dict[str, _Unack] = {}
        self._job_evals: Dict[Tuple[str, str], str] = {}  # (ns, job) -> eval
        self._blocked: Dict[Tuple[str, str], _Heap] = {}  # per-job backlog
        self._requeue: Dict[str, Evaluation] = {}  # token-gated re-enqueue
        self._waiting: Dict[str, Evaluation] = {}  # delayed (wait_until)
        self._delay_heap: List[tuple] = []
        # (deadline, eval_id, token) redelivery deadlines for unacked
        # evals, serviced by the broker's delayed watcher.  Replaces the
        # per-eval threading.Timer of the pre-19 broker: at thousands of
        # dequeues/s the timer threads alone (create+start+cancel ~45µs
        # each, plus scheduler churn from the live-thread population)
        # were the worker-scaling ceiling.  Entries are append-only and
        # validated lazily against the _Unack's current deadline.
        self._nack_heap: List[tuple] = []
        self._dequeues = 0
        self._nacks = 0
        # eval id -> monotonic enqueue time while sitting in a ready
        # heap: feeds oldest_ready_age(), the BatchController's
        # SLO-budget close rule input (insertion order ~ enqueue order,
        # so the first live entry is the oldest)
        self._ready_since: Dict[str, float] = {}
        self._deliveries: Dict[str, int] = {}
        # seeded per shard so chaos/replay runs see the same redelivery
        # schedule; shard 0 keeps the exact pre-shard sequence
        import random as _random
        self._nack_rng = _random.Random(nack_jitter_seed + index)

    # ------------------------------------------------------------- enqueue
    def enqueue(self, ev: Evaluation) -> None:
        with self._lock:
            self._enqueue_locked(ev, ev.type)

    def enqueue_all(self, evals: List[Tuple[Evaluation, str]]) -> None:
        with self._lock:
            for ev, token in evals:
                if token:
                    self._process_waiting_enqueue_locked(ev, token)
                else:
                    self._enqueue_locked(ev, ev.type)

    def enqueue_batch(self, evals: List[Evaluation]) -> None:
        """Bulk enqueue under ONE lock hold with ONE dequeuer wakeup.
        Per-eval enqueue costs ~3x the heap push itself in lock and
        condition traffic; plan followups and saturated ingress arrive
        in bursts, so coalescing is the hot-path shape."""
        with self._lock:
            for ev in evals:
                self._enqueue_locked(ev, ev.type, notify=False)
        self._broker.notify_ready()

    def _process_waiting_enqueue_locked(self, ev: Evaluation,
                                        token: str) -> None:
        u = self._unack.get(ev.id)
        if u is not None and u.token == token:
            self._requeue[ev.id] = ev
        else:
            self._enqueue_locked(ev, ev.type)

    def _enqueue_locked(self, ev: Evaluation, queue: str,
                        notify: bool = True) -> None:
        if not self._broker.enabled_flag:
            return
        if ev.id in self._unack or ev.id in self._waiting:
            return
        if ev.wait_until and ev.wait_until > _time.time():
            self._waiting[ev.id] = ev
            heapq.heappush(self._delay_heap, (ev.wait_until, ev.id))
            return
        namespaced = (ev.namespace, ev.job_id)
        if queue != FAILED_QUEUE and ev.job_id:
            holder = self._job_evals.get(namespaced)
            if holder is not None and holder != ev.id:
                self._blocked.setdefault(namespaced, _Heap()).push(ev)
                _tr.event(ev.id, "broker.job_blocked", queue=queue,
                          holder=holder)
                return
            self._job_evals[namespaced] = ev.id
        self._ready.setdefault(queue, _Heap()).push(ev)
        self._ready_since[ev.id] = _time.monotonic()
        _tr.event(ev.id, "broker.enqueue", queue=queue, shard=self.index)
        if notify:
            self._broker.notify_ready()

    # ------------------------------------------------------------- dequeue
    def try_dequeue(self, sched_types: Sequence[str]
                    ) -> Tuple[Optional[Evaluation], str]:
        """Non-blocking: pop the best ready eval, register the unack and
        arm its nack deadline.  Returns (eval, token) or (None, "")."""
        out = self.try_dequeue_n(sched_types, 1)
        if not out:
            return None, ""
        return out[0]

    def try_dequeue_n(self, sched_types: Sequence[str], max_n: int
                      ) -> List[Tuple[Evaluation, str]]:
        """Non-blocking bulk dequeue: pop up to `max_n` ready evals
        under ONE lock hold (the fused-solve hot path — per-eval lock
        round trips at batch 128 cost more than the pops themselves)."""
        out: List[Tuple[Evaluation, str]] = []
        with self._lock:
            while len(out) < max_n:
                ev, age = self._dequeue_locked(sched_types)
                if ev is None:
                    break
                # shard index rides in the token so ack/nack route
                # without a broker-level eval->shard map (no shared
                # lock on the ack path)
                token = f"{self.index}.{generate_uuid()}"
                u = _Unack(ev, token)
                self._unack[ev.id] = u
                self._deliveries[ev.id] = \
                    self._deliveries.get(ev.id, 0) + 1
                self._dequeues += 1
                self._arm_nack_locked(u)
                _tr.event(ev.id, "broker.dequeue",
                          queue_age_s=round(age, 6),
                          delivery=self._deliveries[ev.id],
                          shard=self.index)
                out.append((ev, token))
        return out

    def _dequeue_locked(self, sched_types: Sequence[str]
                        ) -> Tuple[Optional[Evaluation], float]:
        """Returns (eval, ready-queue age seconds)."""
        best_q, best_pri = None, None
        for q in sched_types:
            h = self._ready.get(q)
            if h is None or not len(h):
                continue
            pri = h.peek_priority()
            if best_pri is None or pri > best_pri:
                best_q, best_pri = q, pri
        if best_q is None:
            return None, 0.0
        ev = self._ready[best_q].pop()
        age = 0.0
        if ev is not None:
            t0 = self._ready_since.pop(ev.id, None)
            if t0 is not None:
                age = _time.monotonic() - t0
        return ev, age

    def _arm_nack_locked(self, u: _Unack) -> None:
        """Arm (or re-arm) the redelivery deadline.  Caller holds the
        shard lock.  A prior heap entry for the same unack is not
        removed — it carries a different deadline and fails the lazy
        validation when it surfaces."""
        deadline = _time.time() + self._broker.nack_delay_s
        u.nack_deadline = deadline
        heapq.heappush(self._nack_heap, (deadline, u.eval.id, u.token))

    def pause_nack_timeout(self, eval_id: str,
                           token: str) -> Optional[str]:
        with self._lock:
            return self._pause_nack_locked(eval_id, token)

    def _pause_nack_locked(self, eval_id: str,
                           token: str) -> Optional[str]:
        u = self._unack.get(eval_id)
        if u is None or u.token != token:
            return "token mismatch"
        # the heap entry goes stale in place: the watcher skips any
        # entry whose deadline no longer matches the live unack
        u.nack_deadline = None
        return None

    def pause_nack_batch(self, pairs: List[Tuple[str, str]]
                         ) -> List[Optional[str]]:
        """Pause redelivery for many (eval_id, token) pairs under one
        lock hold; returns per-pair errors aligned with the input."""
        with self._lock:
            return [self._pause_nack_locked(eid, tok)
                    for eid, tok in pairs]

    def resume_nack_timeout(self, eval_id: str,
                            token: str) -> Optional[str]:
        with self._lock:
            u = self._unack.get(eval_id)
            if u is None or u.token != token:
                return "token mismatch"
            self._arm_nack_locked(u)
            return None

    # ------------------------------------------------------------ ack/nack
    def ack(self, eval_id: str, token: str) -> Optional[str]:
        with self._lock:
            return self._ack_locked(eval_id, token)

    def ack_batch(self, pairs: List[Tuple[str, str]]
                  ) -> List[Optional[str]]:
        """Ack many (eval_id, token) pairs under one lock hold; returns
        per-pair errors aligned with the input."""
        with self._lock:
            return [self._ack_locked(eid, tok) for eid, tok in pairs]

    def _ack_locked(self, eval_id: str, token: str) -> Optional[str]:
        u = self._unack.get(eval_id)
        if u is None or u.token != token:
            return "token mismatch"
        del self._unack[eval_id]
        self._deliveries.pop(eval_id, None)
        ev = u.eval
        _tr.event(eval_id, "broker.ack")
        self._release_job_slot_locked(ev, eval_id)
        requeue = self._requeue.pop(eval_id, None)
        if requeue is not None:
            self._enqueue_locked(requeue, requeue.type)
        return None

    def _release_job_slot_locked(self, ev: Evaluation,
                                 eval_id: str) -> None:
        """Free the job's serialization slot and promote its next
        blocked eval, if any."""
        namespaced = (ev.namespace, ev.job_id)
        if self._job_evals.get(namespaced) != eval_id:
            return
        del self._job_evals[namespaced]
        backlog = self._blocked.get(namespaced)
        if backlog is not None and len(backlog):
            nxt = backlog.pop()
            if not len(backlog):
                del self._blocked[namespaced]
            self._job_evals[namespaced] = nxt.id
            self._ready.setdefault(nxt.type, _Heap()).push(nxt)
            self._ready_since[nxt.id] = _time.monotonic()
            self._broker.notify_ready()

    def nack(self, eval_id: str, token: str) -> Optional[str]:
        with self._lock:
            return self._nack_locked(eval_id, token)

    def _nack_locked(self, eval_id: str, token: str) -> Optional[str]:
        """Nack body; the caller holds self._lock (the nack timer's
        check-then-act shares one hold with the requeue)."""
        u = self._unack.get(eval_id)
        if u is None or u.token != token:
            return "token mismatch"
        del self._unack[eval_id]
        self._requeue.pop(eval_id, None)
        self._nacks += 1
        from ..utils.metrics import global_metrics as _m
        _m.incr_counter("broker.nack")
        ev = u.eval
        # keep the per-job serialization slot held by the nacked eval
        # until it is acked (reference Nack semantics) so a newer eval
        # for the job can't jump ahead of the redelivery; the slot is
        # only freed when the eval is parked for the failed-eval reaper
        if self._deliveries.get(eval_id, 0) >= \
                self._broker.delivery_limit:
            self._release_job_slot_locked(ev, eval_id)
            # too many failed deliveries: park it for the leader reaper
            self._ready.setdefault(FAILED_QUEUE, _Heap()).push(ev)
            self._ready_since[ev.id] = _time.monotonic()
            _tr.event(eval_id, "broker.nack", parked=True,
                      deliveries=self._deliveries.get(eval_id, 0))
            self._broker.notify_ready()
            return None
        # redeliver after a capped jittered exponential delay:
        # linear compounding barely separates a flapping eval from
        # healthy redeliveries, and unjittered delays re-collide a
        # burst of nacked evals at every retry (thundering herd)
        n = max(1, self._deliveries.get(eval_id, 1))
        delay = min(self._broker.max_nack_delay_s,
                    self._broker.initial_nack_delay_s * (2 ** (n - 1)))
        delay *= 0.5 + self._nack_rng.random() / 2.0
        _tr.event(eval_id, "broker.nack", parked=False,
                  deliveries=self._deliveries.get(eval_id, 0),
                  redeliver_delay_s=round(delay, 6))
        deadline = _time.time() + delay
        self._waiting[ev.id] = ev
        heapq.heappush(self._delay_heap, (deadline, ev.id))
        return None

    # ------------------------------------------------------------ plumbing
    def pop_due_delayed(self) -> float:
        """Promote delayed evals whose wait has expired AND fire due
        nack deadlines (called by the broker's single delayed-watcher
        thread).  Returns the seconds until this shard's next deadline
        (or 0.1 when idle).  Nack redelivery is a multi-second safety
        net, so the watcher's 10-100ms cadence is far inside its
        tolerance — and one thread servicing every deadline replaces
        the one-Timer-thread-per-dequeue storm."""
        with self._lock:
            now = _time.time()
            wait = 0.1
            while self._delay_heap and self._delay_heap[0][0] <= now:
                _, eid = heapq.heappop(self._delay_heap)
                ev = self._waiting.pop(eid, None)
                if ev is not None:
                    ev2 = ev
                    if ev2.wait_until:
                        import copy
                        ev2 = copy.copy(ev)
                        ev2.wait_until = 0.0
                    self._enqueue_locked(ev2, ev2.type)
            while self._nack_heap and self._nack_heap[0][0] <= now:
                deadline, eid, token = heapq.heappop(self._nack_heap)
                u = self._unack.get(eid)
                if u is None or u.token != token \
                        or u.nack_deadline != deadline:
                    continue    # stale: acked, paused, or re-armed
                # check and act under ONE lock hold (a
                # check-then-act race otherwise): no window for an ack or an
                # explicit nack to slip between validate and requeue
                self._nack_locked(eid, token)
            if self._delay_heap:
                wait = min(wait, max(0.0, self._delay_heap[0][0] - now))
            if self._nack_heap:
                wait = min(wait, max(0.0, self._nack_heap[0][0] - now))
            return wait

    def flush(self) -> None:
        with self._lock:
            self._nack_heap.clear()
            self._ready.clear()
            self._unack.clear()
            self._job_evals.clear()
            self._blocked.clear()
            self._requeue.clear()
            self._waiting.clear()
            self._delay_heap.clear()
            self._deliveries.clear()
            self._ready_since.clear()

    def ready_count(self) -> int:
        with self._lock:
            return sum(len(h) for h in self._ready.values())

    def oldest_ready_t0(self) -> Optional[float]:
        """Monotonic enqueue time of this shard's oldest ready eval."""
        with self._lock:
            for t0 in self._ready_since.values():
                return t0
            return None

    def outstanding(self, eval_id: str) -> Optional[str]:
        with self._lock:
            u = self._unack.get(eval_id)
            return u.token if u else None

    def snapshot_stats(self) -> dict:
        with self._lock:
            return {
                "ready": {q: len(h) for q, h in self._ready.items()},
                "unacked": len(self._unack),
                "blocked": sum(len(h) for h in self._blocked.values()),
                "waiting": len(self._waiting),
                "dequeues": self._dequeues,
                "nacks": self._nacks,
                "oldest_t0": next(iter(self._ready_since.values()), None),
                "redelivered": {eid: n
                                for eid, n in self._deliveries.items()
                                if n > 1},
            }


class EvalBroker:
    """Facade over S `_Shard` partitions (see module docstring).  All
    public methods keep the pre-shard signatures; `dequeue`/
    `dequeue_batch` additionally accept a `home` shard hint (the
    worker's index) for locality-first stealing."""

    def __init__(self, nack_delay_s: float = DEFAULT_NACK_DELAY_S,
                 initial_nack_delay_s: float = DEFAULT_INITIAL_NACK_DELAY_S,
                 delivery_limit: int = DEFAULT_DELIVERY_LIMIT,
                 max_nack_delay_s: float = DEFAULT_MAX_NACK_DELAY_S,
                 nack_jitter_seed: int = 0xACED,
                 shards: Optional[int] = None):
        # shared ready condition: blocked dequeuers wait here; shards
        # notify through notify_ready().  A generation counter closes
        # the scan-then-wait race (an enqueue landing between a dry
        # scan and the wait bumps the gen, so the waiter re-scans
        # instead of sleeping through the wake-up).
        self._ready_cv = threading.Condition()
        self._ready_gen = 0
        self._enabled = False
        self.nack_delay_s = nack_delay_s
        self.initial_nack_delay_s = initial_nack_delay_s
        self.max_nack_delay_s = max_nack_delay_s
        self.delivery_limit = delivery_limit
        n = shards if shards is not None else _default_shards()
        self.num_shards = max(1, int(n))
        self._shards = [_Shard(self, i, nack_jitter_seed)
                        for i in range(self.num_shards)]
        self._rr = itertools.count()
        self._delay_thread: Optional[threading.Thread] = None
        self._stop_delay = threading.Event()
        # export_metrics rate gate: hot loops pass
        # min_interval_s >= 1 so queue-shape gauges cost one monotonic
        # read per call instead of S lock holds
        self._export_lock = threading.Lock()
        self._last_export = 0.0

    # ------------------------------------------------------------ lifecycle
    def set_enabled(self, enabled: bool) -> None:
        with self._ready_cv:
            prev = self._enabled
            self._enabled = enabled
            if enabled and not prev:
                self._stop_delay.clear()
                self._delay_thread = threading.Thread(
                    target=self._run_delayed_watcher, daemon=True)
                self._delay_thread.start()
        if prev and not enabled:
            self.flush()
        if not enabled:
            self._stop_delay.set()

    @property
    def enabled(self) -> bool:
        with self._ready_cv:    # guarded by _ready_cv: see set_enabled
            return self._enabled

    @property
    def enabled_flag(self) -> bool:
        """Enabled read for the shards' enqueue path.  Nests the shared
        condition inside the calling shard's lock — the one sanctioned
        order (shard lock -> ready condition, same as notify_ready);
        the condition never wraps a shard lock."""
        with self._ready_cv:
            return self._enabled

    def notify_ready(self) -> None:
        """Wake blocked dequeuers (called by shards after making work
        ready; the caller holds only its shard lock — the shared
        condition nests strictly inside shard locks, never around
        them)."""
        with self._ready_cv:
            self._ready_gen += 1
            self._ready_cv.notify_all()

    def ready_count(self) -> int:
        """Evals ready for dequeue right now (not delayed/unacked)."""
        return sum(s.ready_count() for s in self._shards)

    def oldest_ready_age(self) -> float:
        """Seconds the oldest currently-ready eval has been waiting —
        the max across shards (each shard's dict insertion order tracks
        enqueue order, so its first live entry is its oldest)."""
        t0s = [t0 for t0 in (s.oldest_ready_t0() for s in self._shards)
               if t0 is not None]
        if not t0s:
            return 0.0
        return _time.monotonic() - min(t0s)

    def export_metrics(self, min_interval_s: float = 0.0) -> None:
        """Publish queue-shape gauges through the global metrics path
        (read back with the registry's dump, next to the
        worker.dequeue_eval counters).  `min_interval_s` rate-gates hot callers: a call
        landing inside the window is a no-op (one monotonic read), so
        per-dequeue loops can't turn the gauge walk into lock traffic —
        the leader's 1s export beat passes the default 0 and always
        publishes."""
        from ..utils.metrics import global_metrics as _m
        if min_interval_s > 0.0:
            now = _time.monotonic()
            with self._export_lock:
                if now - self._last_export < min_interval_s:
                    return
                self._last_export = now
        ready: Dict[str, int] = {}
        unacked = waiting = blocked = 0
        oldest_t0: Optional[float] = None
        redelivered: Dict[str, int] = {}
        for s in self._shards:
            st = s.snapshot_stats()
            for q, cnt in st["ready"].items():
                ready[q] = ready.get(q, 0) + cnt
            unacked += st["unacked"]
            waiting += st["waiting"]
            blocked += st["blocked"]
            if st["oldest_t0"] is not None and \
                    (oldest_t0 is None or st["oldest_t0"] < oldest_t0):
                oldest_t0 = st["oldest_t0"]
            # per-eval delivery counts: only evals past their first
            # delivery (the interesting, bounded set — at most
            # delivery_limit redeliveries each before parking), so
            # gauge cardinality stays proportional to flapping evals,
            # not throughput; the registry's namespace cap absorbs
            # pathological storms as metrics.overflow
            redelivered.update(st["redelivered"])
        oldest = (_time.monotonic() - oldest_t0) if oldest_t0 else 0.0
        _m.set_gauge("broker.ready_count", float(sum(ready.values())))
        _m.set_gauge("broker.redelivering", float(len(redelivered)))
        for eid, cnt in redelivered.items():
            _m.set_gauge(f"broker.deliveries.{eid}", float(cnt))
        _m.set_gauge("broker.oldest_ready_age_s", oldest)
        _m.set_gauge("broker.unacked", float(unacked))
        _m.set_gauge("broker.waiting", float(waiting))
        _m.set_gauge("broker.job_blocked", float(blocked))
        _m.set_gauge("broker.shards", float(self.num_shards))
        for q, cnt in ready.items():
            _m.set_gauge(f"broker.ready.{q}", float(cnt))

    def flush(self) -> None:
        for s in self._shards:
            s.flush()
        self.notify_ready()

    # -------------------------------------------------------------- routing
    def shard_of(self, ev: Evaluation) -> _Shard:
        """A job maps to exactly ONE shard (per-job serialization by
        construction); job-less evals spread by eval id.  crc32, not
        hash(): stable across processes and PYTHONHASHSEED, so replay
        and chaos runs shard identically."""
        if self.num_shards == 1:
            return self._shards[0]
        if ev.job_id:
            key = f"{ev.namespace}\x00{ev.job_id}"
        else:
            key = ev.id
        idx = (zlib.crc32(key.encode("utf-8", "replace")) & 0xFFFFFFFF) \
            % self.num_shards
        return self._shards[idx]

    def _shard_by_token(self, eval_id: str, token: str
                        ) -> Optional[_Shard]:
        """The shard that issued `token` (its index is the token's
        prefix).  Falls back to a scan for foreign token formats."""
        head, _, rest = token.partition(".")
        if rest:
            try:
                idx = int(head)
            except ValueError:
                idx = -1
            if 0 <= idx < self.num_shards:
                return self._shards[idx]
        for s in self._shards:
            if s.outstanding(eval_id) == token:
                return s
        return None

    # ------------------------------------------------------------- enqueue
    def enqueue(self, ev: Evaluation) -> None:
        self.shard_of(ev).enqueue(ev)

    def enqueue_batch(self, evals: List[Evaluation]) -> None:
        """Bulk enqueue, grouped by shard so each shard takes its lock
        once and wakes dequeuers once per group instead of per eval."""
        if self.num_shards == 1:
            self._shards[0].enqueue_batch(evals)
            return
        by_shard: Dict[int, List[Evaluation]] = {}
        for ev in evals:
            by_shard.setdefault(self.shard_of(ev).index, []).append(ev)
        for idx, group in by_shard.items():
            self._shards[idx].enqueue_batch(group)

    def enqueue_all(self, evals: List[Tuple[Evaluation, str]]) -> None:
        """Enqueue (eval, token) pairs; a matching token for an unacked
        eval defers the re-enqueue until that eval is acked.  Routing
        is deterministic by eval content, so the token's unack entry —
        if any — lives in the same shard the eval routes to."""
        by_shard: Dict[int, List[Tuple[Evaluation, str]]] = {}
        for ev, token in evals:
            sh = self.shard_of(ev)
            by_shard.setdefault(sh.index, []).append((ev, token))
        for idx, group in by_shard.items():
            self._shards[idx].enqueue_all(group)

    # ------------------------------------------------------------- dequeue
    def dequeue(self, sched_types: Sequence[str], timeout: float = 0.0,
                home: Optional[int] = None
                ) -> Tuple[Optional[Evaluation], str]:
        """Blocking dequeue: home shard first, then steal round-robin
        across the rest.  `home` defaults to a rotating pick so
        anonymous callers spread load."""
        deadline = _time.monotonic() + timeout
        start = (home if home is not None else next(self._rr)) \
            % self.num_shards
        while True:
            with self._ready_cv:
                gen = self._ready_gen
                enabled = self._enabled
            for k in range(self.num_shards):
                ev, token = self._shards[(start + k) % self.num_shards] \
                    .try_dequeue(sched_types)
                if ev is not None:
                    return ev, token
            remain = deadline - _time.monotonic()
            if remain <= 0 or not enabled:
                return None, ""
            with self._ready_cv:
                if self._ready_gen == gen:
                    self._ready_cv.wait(remain)

    def dequeue_batch(self, sched_types: Sequence[str], max_batch: int,
                      timeout: float = 0.0, home: Optional[int] = None
                      ) -> List[Tuple[Evaluation, str]]:
        """Drain up to max_batch ready evals (the fused-solve coalescing point).
        Blocks for the first eval only; the rest are taken
        opportunistically — home shard first, stealing across the other
        shards when it runs dry so no shard strands work."""
        first, token = self.dequeue(sched_types, timeout, home=home)
        if first is None:
            return []
        out = [(first, token)]
        start = (home if home is not None else 0) % self.num_shards
        for k in range(self.num_shards):
            if len(out) >= max_batch:
                break
            shard = self._shards[(start + k) % self.num_shards]
            out.extend(shard.try_dequeue_n(sched_types,
                                           max_batch - len(out)))
        # dequeue-batch size histogram (p50/p99 via the metrics
        # reservoir) — the observability face of the BatchController
        from ..utils.metrics import global_metrics as _m
        _m.add_sample("broker.dequeue_batch_size", float(len(out)))
        return out

    # --------------------------------------------------------- nack timers
    def pause_nack_timeout(self, eval_id: str, token: str) -> Optional[str]:
        """Stop the redelivery timer while the holder does long work
        (reference: eval_broker PauseNackTimeout, used while waiting on
        raft / the fused solve). The holder must still ack or nack."""
        sh = self._shard_by_token(eval_id, token)
        if sh is None:
            return "token mismatch"
        return sh.pause_nack_timeout(eval_id, token)

    def resume_nack_timeout(self, eval_id: str,
                            token: str) -> Optional[str]:
        sh = self._shard_by_token(eval_id, token)
        if sh is None:
            return "token mismatch"
        return sh.resume_nack_timeout(eval_id, token)

    def pause_nack_batch(self, pairs: Sequence[Tuple[str, str]]
                         ) -> List[Optional[str]]:
        """Pause redelivery for many (eval_id, token) pairs with one
        lock hold per touched shard (the fused-batch hot path)."""
        return self._batch_by_shard(pairs, "pause_nack_batch")

    # ------------------------------------------------------------ ack/nack
    def ack(self, eval_id: str, token: str) -> Optional[str]:
        sh = self._shard_by_token(eval_id, token)
        if sh is None:
            return "token mismatch"
        return sh.ack(eval_id, token)

    def ack_batch(self, pairs: Sequence[Tuple[str, str]]
                  ) -> List[Optional[str]]:
        """Ack many (eval_id, token) pairs with one lock hold per
        touched shard; per-pair errors aligned with the input."""
        return self._batch_by_shard(pairs, "ack_batch")

    def _batch_by_shard(self, pairs: Sequence[Tuple[str, str]],
                        method: str) -> List[Optional[str]]:
        """Group (eval_id, token) pairs by issuing shard and apply the
        shard's batch method once per group, preserving input order in
        the returned error list."""
        out: List[Optional[str]] = [None] * len(pairs)
        by_shard: Dict[int, List[Tuple[int, str, str]]] = {}
        for i, (eid, tok) in enumerate(pairs):
            sh = self._shard_by_token(eid, tok)
            if sh is None:
                out[i] = "token mismatch"
                continue
            by_shard.setdefault(sh.index, []).append((i, eid, tok))
        for idx, group in by_shard.items():
            errs = getattr(self._shards[idx], method)(
                [(eid, tok) for _i, eid, tok in group])
            for (i, _eid, _tok), err in zip(group, errs):
                out[i] = err
        return out

    def nack(self, eval_id: str, token: str) -> Optional[str]:
        sh = self._shard_by_token(eval_id, token)
        if sh is None:
            return "token mismatch"
        return sh.nack(eval_id, token)

    # ------------------------------------------------------ delayed watcher
    def _run_delayed_watcher(self) -> None:
        while not self._stop_delay.is_set():
            wait = 0.1
            for s in self._shards:
                wait = min(wait, s.pop_due_delayed())
            self._stop_delay.wait(max(wait, 0.01))

    # --------------------------------------------------------------- stats
    def stats(self) -> dict:
        shard_stats = [s.snapshot_stats() for s in self._shards]
        by_sched: Dict[str, int] = {}
        for st in shard_stats:
            for q, cnt in st["ready"].items():
                by_sched[q] = by_sched.get(q, 0) + cnt
        t0s = [st["oldest_t0"] for st in shard_stats
               if st["oldest_t0"] is not None]
        oldest = (_time.monotonic() - min(t0s)) if t0s else 0.0
        return {
            "total_ready": sum(by_sched.values()),
            "total_unacked": sum(st["unacked"] for st in shard_stats),
            "total_blocked": sum(st["blocked"] for st in shard_stats),
            "total_waiting": sum(st["waiting"] for st in shard_stats),
            "by_scheduler": by_sched,
            "dequeues": sum(st["dequeues"] for st in shard_stats),
            "nacks": sum(st["nacks"] for st in shard_stats),
            "oldest_ready_age_s": round(oldest, 6),
            "shards": self.num_shards,
            "ready_by_shard": [sum(st["ready"].values())
                               for st in shard_stats],
        }

    def outstanding(self, eval_id: str) -> Optional[str]:
        for s in self._shards:
            token = s.outstanding(eval_id)
            if token is not None:
                return token
        return None
