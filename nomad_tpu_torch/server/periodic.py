"""Leader-only periodic (cron) job dispatcher.

Tracks periodic jobs, computes each one's next launch from its cron spec,
and at the launch time derives a child job `<id>/periodic-<unix>` and
registers it (which creates the eval that actually schedules it).
Reference: nomad/periodic.go — PeriodicDispatch, Add/Remove, run loop,
`job.Periodic.Next` :228, derived jobs + `periodic_launch` table,
prohibit_overlap via ChildrenSummary.

The counterpart of `nomad_tpu.server.periodic`.
"""
from __future__ import annotations

import copy
import heapq
import logging
import threading
import time as _time
from datetime import datetime, timezone
from typing import Dict, List, Optional, Tuple

_log = logging.getLogger(__name__)

from ..structs import Job
from ..utils.cron import Cron, CronParseError

PERIODIC_LAUNCH_SUFFIX = "/periodic-"


def _job_tz(job: Job):
    """Periodic specs evaluate in UTC unless the job names a time_zone
    (reference: structs.go PeriodicConfig.GetLocation) — never the
    server-local zone, which would shift launches with host TZ."""
    name = getattr(job.periodic, "timezone", "") or "UTC"
    if name.upper() in ("UTC", "LOCAL", ""):
        return timezone.utc
    try:
        from zoneinfo import ZoneInfo
        return ZoneInfo(name)
    except Exception:
        _log.warning("periodic job %s/%s: unknown time_zone %r, "
                     "falling back to UTC", job.namespace, job.id, name)
        return timezone.utc


def next_launch(job: Job, after: float) -> Optional[float]:
    """Next cron fire time for a periodic job, as a unix timestamp."""
    if job.periodic is None or not job.periodic.enabled:
        return None
    try:
        cron = Cron(job.periodic.spec)
    except CronParseError:
        return None
    dt = datetime.fromtimestamp(after, tz=_job_tz(job))
    # DST fall-back can make a "later" wall-clock time an EARLIER instant
    # (the repeated hour, fold=0); keep advancing until the launch is
    # strictly in the future so the dispatcher never fires a burst of
    # stale launches (≤62 steps covers the repeated hour at minute grain)
    for _ in range(62):
        nxt = cron.next(dt)
        if nxt is None:
            return None
        if nxt.timestamp() > after:
            return nxt.timestamp()
        dt = nxt
    return None


def derive_job(job: Job, launch: float) -> Job:
    """The child job actually scheduled at a launch (periodic.go derivedJob):
    a copy with the periodic config stripped and the parent recorded."""
    child = copy.deepcopy(job)
    child.id = f"{job.id}{PERIODIC_LAUNCH_SUFFIX}{int(launch)}"
    child.parent_id = job.id
    child.periodic = None
    return child


class PeriodicDispatcher:
    def __init__(self, server):
        self.server = server
        self._tracked: Dict[Tuple[str, str], Job] = {}
        self._heap: List[Tuple[float, Tuple[str, str]]] = []
        self._cv = threading.Condition()
        self._enabled = False
        self._runner: Optional[threading.Thread] = None

    # ------------------------------------------------------------ control
    def set_enabled(self, enabled: bool) -> None:
        runner = None
        with self._cv:
            if enabled == self._enabled:
                return
            self._enabled = enabled
            if enabled:
                # thread handle guarded by _cv
                self._runner = threading.Thread(target=self._run, daemon=True)
                self._runner.start()
            else:
                self._tracked.clear()
                self._heap.clear()
                runner, self._runner = self._runner, None
                self._cv.notify_all()
        if runner is not None:
            runner.join(timeout=1.0)

    def add(self, job: Job) -> None:
        """Track (or retrack) a periodic job; untracks if it stopped being
        periodic / was stopped (reference periodic.go Add)."""
        key = (job.namespace, job.id)
        with self._cv:
            if not self._enabled:
                return
            if job.periodic is None or not job.periodic.enabled \
                    or job.stopped():
                self._tracked.pop(key, None)
                return
            self._tracked[key] = job
            nxt = next_launch(job, _time.time())
            if nxt is not None:
                heapq.heappush(self._heap, (nxt, key))
                self._cv.notify_all()

    def remove(self, namespace: str, job_id: str) -> None:
        with self._cv:
            self._tracked.pop((namespace, job_id), None)

    def tracked(self) -> List[Job]:
        with self._cv:
            return list(self._tracked.values())

    def force_launch(self, namespace: str, job_id: str) -> Optional[Job]:
        """Launch now regardless of schedule (`nomad job periodic force`)."""
        with self._cv:
            job = self._tracked.get((namespace, job_id))
        if job is None:
            return None
        return self._launch(job, _time.time())

    # -------------------------------------------------------------- loop
    def _run(self) -> None:
        while True:
            launch_job: Optional[Job] = None
            launch_time = 0.0
            with self._cv:
                if not self._enabled:
                    return
                now = _time.time()
                while self._heap and self._heap[0][0] <= now:
                    when, key = heapq.heappop(self._heap)
                    job = self._tracked.get(key)
                    if job is None:
                        continue
                    # skip stale heap entries from retracking
                    launch_job, launch_time = job, when
                    # schedule the following launch before running this one
                    nxt = next_launch(job, max(now, when))
                    if nxt is not None:
                        heapq.heappush(self._heap, (nxt, key))
                    break
                if launch_job is None:
                    wait = 0.5
                    if self._heap:
                        wait = min(wait, max(self._heap[0][0] - now, 0.01))
                    self._cv.wait(wait)
                    continue
            self._launch(launch_job, launch_time)

    def _launch(self, job: Job, launch: float) -> Optional[Job]:
        if job.periodic and job.periodic.prohibit_overlap:
            if self._has_running_child(job):
                return None
        child = derive_job(job, launch)
        self.server.register_job(child)
        self.server.record_periodic_launch(job.namespace, job.id, launch)
        return child

    def _has_running_child(self, job: Job) -> bool:
        prefix = f"{job.id}{PERIODIC_LAUNCH_SUFFIX}"
        for j in self.server.store.jobs_by_namespace(job.namespace):
            if j.parent_id == job.id and j.id.startswith(prefix) \
                    and not j.stopped() and j.status != "dead":
                return True
        return False
