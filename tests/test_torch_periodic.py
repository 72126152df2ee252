"""The port's periodic dispatcher, cron parser and timetable
(`nomad_tpu_torch.server.periodic`, `utils/cron.py`, `utils/timetable.py`)
against the JAX package's, case by case.

Each case of the reference's `tests/test_periodic.py` runs on both
packages (`pkg` = "ref" or "port") and must give the same outcome: cron
fields and next times, launch times and derived children, and on a
`Server` (the port's with `device="cpu"`) a periodic job tracked without
an eval, restored on leadership, force-launched with its child's eval
and launch record, refused a second overlapping launch, and fired from
the run loop.  Every wait is bounded and every server is stopped or
disabled in `finally`."""
import time
from datetime import datetime, timezone

import pytest

from nomad_tpu import mock as ref_mock
from nomad_tpu import structs as ref_structs
from nomad_tpu.server import periodic as ref_periodic
from nomad_tpu.server.server import Server as RefServer
from nomad_tpu.utils import cron as ref_cron
from nomad_tpu.utils import timetable as ref_timetable
from nomad_tpu_torch import mock as port_mock
from nomad_tpu_torch import structs as port_structs
from nomad_tpu_torch.server import periodic as port_periodic
from nomad_tpu_torch.server.server import Server as PortServer
from nomad_tpu_torch.utils import cron as port_cron
from nomad_tpu_torch.utils import timetable as port_timetable


class Pkg:
    def __init__(self, mock, structs, periodic, cron, timetable, server,
                 server_kw):
        self.mock, self.structs, self.periodic = mock, structs, periodic
        self.cron, self.timetable = cron, timetable
        self._server, self._server_kw = server, server_kw

    def Server(self, **kw):
        return self._server(**kw, **self._server_kw)


PKGS = {"ref": Pkg(ref_mock, ref_structs, ref_periodic, ref_cron,
                   ref_timetable, RefServer, {}),
        "port": Pkg(port_mock, port_structs, port_periodic, port_cron,
                    port_timetable, PortServer, {"device": "cpu"})}
BOTH = pytest.mark.parametrize("pkg", ["ref", "port"])


def _periodic_job(p, spec="* * * * *", **kw):
    j = p.mock.job(**kw)
    j.periodic = p.structs.PeriodicConfig(spec=spec)
    return j


# ------------------------------------------------------------------- cron
def _dt(*args):
    return datetime(*args, tzinfo=timezone.utc)


@BOTH
def test_cron_every_minute(pkg):
    p = PKGS[pkg]
    c = p.cron.Cron("* * * * *")
    assert c.next(_dt(2026, 1, 1, 0, 0)) == _dt(2026, 1, 1, 0, 1)


@BOTH
def test_cron_fixed_time_rolls_to_next_day(pkg):
    p = PKGS[pkg]
    c = p.cron.Cron("30 9 * * *")
    assert c.next(_dt(2026, 1, 1, 10, 0)) == _dt(2026, 1, 2, 9, 30)


@BOTH
def test_cron_step_ranges(pkg):
    p = PKGS[pkg]
    c = p.cron.Cron("*/15 * * * *")
    assert c.minutes == {0, 15, 30, 45}
    c2 = p.cron.Cron("0-30/10 * * * *")
    assert c2.minutes == {0, 10, 20, 30}


@BOTH
def test_cron_dow_seven_is_sunday(pkg):
    p = PKGS[pkg]
    c = p.cron.Cron("0 0 * * 7")
    nxt = c.next(_dt(2026, 1, 1))  # Thursday
    assert nxt.weekday() == 6      # python Sunday


@BOTH
def test_cron_dom_dow_or_rule(pkg):
    p = PKGS[pkg]
    # both restricted: matches if EITHER matches (standard cron)
    c = p.cron.Cron("0 0 13 * 5")       # 13th OR Friday
    nxt = c.next(_dt(2026, 1, 1))
    assert nxt == _dt(2026, 1, 2)   # Jan 2 2026 is a Friday


@BOTH
def test_cron_month_field(pkg):
    p = PKGS[pkg]
    c = p.cron.Cron("0 0 1 6 *")
    assert c.next(_dt(2026, 1, 15)) == _dt(2026, 6, 1)


@BOTH
def test_cron_rejects_bad_specs(pkg):
    p = PKGS[pkg]
    for bad in ("* * * *", "61 * * * *", "* 25 * * *", "a * * * *",
                "*/0 * * * *", "5-1 * * * *"):
        with pytest.raises(p.cron.CronParseError):
            p.cron.Cron(bad)


@BOTH
def test_cron_comma_lists(pkg):
    p = PKGS[pkg]
    c = p.cron.Cron("5,35 0,12 * * *")
    assert c.minutes == {5, 35}
    assert c.hours == {0, 12}


# --------------------------------------------------------------- periodic
@BOTH
def test_next_launch_minute_boundary(pkg):
    p = PKGS[pkg]
    j = _periodic_job(p, "* * * * *")
    after = 1_700_000_000.0
    nxt = p.periodic.next_launch(j, after)
    assert nxt is not None and nxt > after
    assert nxt % 60 == 0 and nxt - after <= 60


@BOTH
def test_next_launch_disabled_or_bad_spec(pkg):
    p = PKGS[pkg]
    j = _periodic_job(p, "* * * * *")
    j.periodic.enabled = False
    assert p.periodic.next_launch(j, time.time()) is None
    j2 = _periodic_job(p, "not a cron")
    assert p.periodic.next_launch(j2, time.time()) is None


@BOTH
def test_derive_job_strips_periodic_and_links_parent(pkg):
    p = PKGS[pkg]
    j = _periodic_job(p)
    child = p.periodic.derive_job(j, 1_700_000_123.0)
    assert child.parent_id == j.id
    assert child.periodic is None
    assert child.id == f"{j.id}{p.periodic.PERIODIC_LAUNCH_SUFFIX}1700000123"
    # the parent template is untouched
    assert j.periodic is not None


@BOTH
def test_register_periodic_job_tracks_without_eval(pkg):
    p = PKGS[pkg]
    srv = p.Server(num_workers=0)
    srv.periodic.set_enabled(True)
    try:
        j = _periodic_job(p, "0 0 1 1 *")
        ev = srv.register_job(j)
        assert ev is None          # templates are never evaluated directly
        assert [t.id for t in srv.periodic.tracked()] == [j.id]
        # deregister untracks
        srv.deregister_job(j.namespace, j.id)
        assert srv.periodic.tracked() == []
    finally:
        srv.periodic.set_enabled(False)


@BOTH
def test_periodic_restore_on_leadership(pkg):
    """Tracked jobs are rebuilt from state on start (leader.go
    restorePeriodicDispatcher)."""
    p = PKGS[pkg]
    srv = p.Server(num_workers=0)
    j = _periodic_job(p, "0 0 1 1 *")
    srv.store.upsert_job(srv.store.latest_index() + 1, j)
    srv.start()
    try:
        assert [t.id for t in srv.periodic.tracked()] == [j.id]
    finally:
        srv.stop()


@BOTH
def test_periodic_launch_derives_child_and_records_launch(pkg):
    p = PKGS[pkg]
    srv = p.Server(num_workers=0)
    srv.periodic.set_enabled(True)
    try:
        j = _periodic_job(p, "0 0 1 1 *")
        srv.register_job(j)
        child = srv.periodic.force_launch(j.namespace, j.id)
        assert child is not None and child.parent_id == j.id
        assert srv.store.job_by_id(j.namespace, child.id) is not None
        # an eval exists for the child
        evs = srv.store.evals_by_job(j.namespace, child.id)
        assert len(evs) == 1
        launch = srv.store.periodic_launch(j.namespace, j.id)
        assert launch is not None
    finally:
        srv.periodic.set_enabled(False)


@BOTH
def test_periodic_prohibit_overlap_blocks_second_launch(pkg):
    p = PKGS[pkg]
    srv = p.Server(num_workers=0)
    srv.periodic.set_enabled(True)
    try:
        j = _periodic_job(p, "0 0 1 1 *")
        j.periodic.prohibit_overlap = True
        srv.register_job(j)
        first = srv.periodic.force_launch(j.namespace, j.id)
        assert first is not None
        # the first child is still pending -> overlap prohibited
        assert srv.periodic.force_launch(j.namespace, j.id) is None
    finally:
        srv.periodic.set_enabled(False)


@BOTH
def test_periodic_fires_on_schedule(pkg):
    """An every-minute job launches from the run loop without force."""
    p = PKGS[pkg]
    srv = p.Server(num_workers=0)
    srv.periodic.set_enabled(True)
    try:
        j = _periodic_job(p, "* * * * *")
        srv.register_job(j)
        # shrink the wait by faking the heap entry to fire immediately
        with srv.periodic._cv:
            assert srv.periodic._heap
            _, key = srv.periodic._heap[0]
            srv.periodic._heap[0] = (time.time() - 1.0, key)
            srv.periodic._cv.notify_all()
        deadline = time.time() + 3.0
        child = None
        while time.time() < deadline:
            kids = [x for x in srv.store.jobs_by_namespace(j.namespace)
                    if x.parent_id == j.id]
            if kids:
                child = kids[0]
                break
            time.sleep(0.05)
        assert child is not None
    finally:
        srv.periodic.set_enabled(False)


# -------------------------------------------------------------- timetable
@BOTH
def test_timetable_basic_witness_and_lookup(pkg):
    p = PKGS[pkg]
    tt = p.timetable.TimeTable(granularity_s=1.0)
    tt.witness(5, when=10.0)
    tt.witness(9, when=20.0)
    assert tt.nearest_index(9.0) == 0
    assert tt.nearest_index(10.0) == 5
    assert tt.nearest_index(15.0) == 5
    assert tt.nearest_index(25.0) == 9


@BOTH
def test_timetable_limit_evicts_oldest(pkg):
    p = PKGS[pkg]
    tt = p.timetable.TimeTable(granularity_s=0.0, limit=4)
    for i in range(10):
        tt.witness(i + 1, when=float(i))
    assert len(tt._witnesses) == 4
    # the oldest rows are gone: cutoffs before them find nothing
    assert tt.nearest_index(4.0) == 0
    assert tt.nearest_index(9.0) == 10


@BOTH
def test_timetable_zero_granularity_records_every_witness(pkg):
    p = PKGS[pkg]
    tt = p.timetable.TimeTable(granularity_s=0.0)
    tt.witness(1, when=1.0)
    tt.witness(2, when=1.0)
    assert tt.nearest_index(1.0) == 2
