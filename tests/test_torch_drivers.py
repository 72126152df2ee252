"""The port's task drivers and client state DB (`nomad_tpu_torch.drivers`,
`nomad_tpu_torch.plugins.drivers`, `nomad_tpu_torch.client.state`)
against the JAX package's, on the CPU.

Each case of `tests/test_drivers.py` runs on both packages (`pkg` =
"ref" / "port"), each side with its own modules (`agent_pkg`), and
returns an outcome of what it saw: exit codes and signals, task states,
what a task wrote, which errors were raised, what came back from the
codec and the state DB.  The port's outcome must equal the reference's.
The port registers no `exec` driver yet (ROADMAP.md Queue 1 item 16b):
the registry case compares the other drivers and checks that.  Every
task a case starts is stopped or has exited before the case returns.
"""
import json
import os
import subprocess
import sys
import time
import types

import pytest

PKG_NAMES = ("ref", "port")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def agent_pkg(name):
    """The modules one side of a node-agent case uses, by package."""
    if name == "ref":
        from nomad_tpu import mock, structs
        from nomad_tpu.api import client as api_client
        from nomad_tpu.api import http_server
        from nomad_tpu.client import agent, allocdir, allocrunner, sim
        from nomad_tpu.client import state
        from nomad_tpu.drivers import executor, mock as mock_driver
        from nomad_tpu.drivers import rawexec
        from nomad_tpu.plugins import device, drivers
        from nomad_tpu.server.server import Server
        from nomad_tpu.structs import funcs
        from nomad_tpu.utils import codec
        server_kw = {}
    else:
        from nomad_tpu_torch import mock, structs
        from nomad_tpu_torch.api import client as api_client
        from nomad_tpu_torch.api import http_server
        from nomad_tpu_torch.client import agent, allocdir, allocrunner
        from nomad_tpu_torch.client import sim, state
        from nomad_tpu_torch.drivers import executor, mock as mock_driver
        from nomad_tpu_torch.drivers import rawexec
        from nomad_tpu_torch.plugins import device, drivers
        from nomad_tpu_torch.server.server import Server
        from nomad_tpu_torch.structs import funcs
        from nomad_tpu_torch.utils import codec
        server_kw = {"device": "cpu"}
    return types.SimpleNamespace(
        name=name, mock=mock, structs=structs, ApiClient=api_client.ApiClient,
        APIError=api_client.APIError, http_server=http_server,
        HTTPAgentServer=http_server.HTTPAgentServer, agent=agent,
        Client=agent.Client,
        AllocDir=allocdir.AllocDir, allocrunner=allocrunner,
        wait_until=sim.wait_until, StateDB=state.StateDB, MemDB=state.MemDB,
        executor=executor, MockDriver=mock_driver.MockDriver,
        RawExecDriver=rawexec.RawExecDriver, rawexec_module=rawexec,
        device=device, drivers=drivers,
        funcs=funcs, codec=codec,
        Server=lambda **kw: Server(**server_kw, **kw))


class Outcomes:
    """Each case's outcome per package, computed once: the port's case
    compares its outcome with the reference's (run on demand).  Each run
    of a case gets a fresh tmp dir of its own."""

    def __init__(self, cases):
        self.cases = cases
        self.seen = {}

    def get(self, case, pkg, tmp_path_factory):
        key = (case, pkg)
        if key not in self.seen:
            tmp = tmp_path_factory.mktemp(f"{case[:24]}-{pkg}")
            self.seen[key] = self.cases[case](agent_pkg(pkg), tmp)
        return self.seen[key]

    def check(self, case, pkg, tmp_path_factory):
        out = self.get(case, pkg, tmp_path_factory)
        if pkg == "port":
            assert out == self.get(case, "ref", tmp_path_factory)
        return out


class Agents:
    """One package's server (its secrets upserted first) and `n` agents
    on data dirs `agent<i>` under `tmp`, each with its own HTTP agent when
    `http`; on exit the agents shut down with `halt_tasks=True`, so no
    task outlives the case, and the server stops."""

    def __init__(self, P, tmp, n=1, num_workers=2, http=False,
                 acl_enabled=False, secrets=(), **client_kw):
        self.P = P
        self.server = P.Server(num_workers=num_workers)
        self.server.start()
        self.clients, self.https = [], []
        try:
            for path, data in secrets:
                self.server.upsert_secret("default", path, data)
            for i in range(n):
                self.add(tmp / f"agent{i}", http, acl_enabled, **client_kw)
        except BaseException:
            self.close()
            raise
        self.client = self.clients[0] if self.clients else None

    def add(self, data_dir, http=False, acl_enabled=False, **client_kw):
        c = self.P.Client(self.server, data_dir=str(data_dir), **client_kw)
        self.clients.append(c)
        c.start()
        if http:
            h = self.P.HTTPAgentServer(self.server, c, port=0,
                                       acl_enabled=acl_enabled)
            self.https.append(h)
            h.start()
        return c

    def close(self):
        for h in self.https:
            h.stop()
        for c in self.clients:
            c.shutdown(halt_tasks=True)
        self.server.stop()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def task_cfg(P, tmp_path, name="t1", command="/bin/sh", args=None, env=None):
    task_dir = str(tmp_path / name)
    logs = str(tmp_path / "logs")
    os.makedirs(task_dir, exist_ok=True)
    os.makedirs(logs, exist_ok=True)
    return P.drivers.TaskConfig(
        id=f"alloc1/{name}", name=name, alloc_id="alloc1",
        env=env or {}, config={"command": command, "args": args or []},
        task_dir=task_dir, alloc_dir=str(tmp_path),
        stdout_path=os.path.join(logs, f"{name}.stdout.0"),
        stderr_path=os.path.join(logs, f"{name}.stderr.0"))


def raised(fn):
    """The exception class name `fn` raised, or None."""
    try:
        fn()
    except Exception as e:          # noqa: BLE001
        return type(e).__name__
    return None


# ------------------------------------------------------------ rawexec
def case_rawexec_runs_and_exits_zero(P, tmp_path):
    drv = P.RawExecDriver()
    cfg = task_cfg(P, tmp_path, args=["-c", "echo hello; exit 0"])
    handle = drv.start_task(cfg)
    result = drv.wait_task(cfg.id, timeout=10.0)
    out = {"pid": handle.driver_state["pid"] > 0,
           "exit": (result.exit_code, result.signal, result.err),
           "stdout": open(cfg.stdout_path).read()}
    drv.destroy_task(cfg.id)
    return out


def case_rawexec_nonzero_exit(P, tmp_path):
    drv = P.RawExecDriver()
    cfg = task_cfg(P, tmp_path, args=["-c", "exit 3"])
    drv.start_task(cfg)
    result = drv.wait_task(cfg.id, timeout=10.0)
    return [result.exit_code, result.successful()]


def case_rawexec_stop_kills_process_group(P, tmp_path):
    drv = P.RawExecDriver()
    # the child spawns a grandchild; killpg must take both down
    cfg = task_cfg(P, tmp_path, args=["-c", "sleep 60 & wait"])
    pid = drv.start_task(cfg).driver_state["pid"]
    alive = P.executor.pid_alive(pid)
    drv.stop_task(cfg.id, timeout_s=2.0)
    result = drv.wait_task(cfg.id, timeout=5.0)
    return {"alive_before": alive, "alive_after": P.executor.pid_alive(pid),
            "signalled": result is not None and result.signal != 0}


def case_rawexec_recover_live_task(P, tmp_path):
    drv = P.RawExecDriver()
    cfg = task_cfg(P, tmp_path, args=["-c", "sleep 30"])
    handle = drv.start_task(cfg)
    # a fresh driver instance (agent restart) re-attaches from the wire
    wire = json.loads(json.dumps(P.codec.to_wire(handle)))
    drv2 = P.RawExecDriver()
    drv2.recover_task(P.codec.from_wire(P.drivers.TaskHandle, wire))
    status = drv2.inspect_task(cfg.id)
    out = {"state": status.state,
           "pid": status.driver_attributes["pid"]
           == str(handle.driver_state["pid"])}
    drv2.stop_task(cfg.id, timeout_s=2.0)
    out["waited"] = drv2.wait_task(cfg.id, timeout=5.0) is not None
    return out


def case_rawexec_recover_finished_task_reads_exit_file(P, tmp_path):
    drv = P.RawExecDriver()
    cfg = task_cfg(P, tmp_path, args=["-c", "exit 7"])
    handle = drv.start_task(cfg)
    drv.wait_task(cfg.id, timeout=10.0)
    drv2 = P.RawExecDriver()
    drv2.recover_task(P.codec.from_wire(P.drivers.TaskHandle,
                                        P.codec.to_wire(handle)))
    return drv2.wait_task(cfg.id, timeout=5.0).exit_code


def case_rawexec_bad_command_fails_start(P, tmp_path):
    drv = P.RawExecDriver()
    cfg = task_cfg(P, tmp_path, command="/no/such/binary")
    return raised(lambda: drv.start_task(cfg))


def case_rawexec_rejects_unknown_config_key(P, tmp_path):
    drv = P.RawExecDriver()
    cfg = task_cfg(P, tmp_path)
    cfg.config["image"] = "nope"
    err = []

    def start():
        try:
            drv.start_task(cfg)
        except P.drivers.DriverError as e:
            err.append(str(e))
            raise
    return [raised(start), err]


def case_pid_reuse_protection(P, tmp_path):
    ticks = P.executor.proc_start_ticks(os.getpid())
    return [P.executor.pid_alive(os.getpid(), ticks),
            P.executor.pid_alive(os.getpid(), ticks + 12345)]


# --------------------------------------------------------------- mock
def case_mock_driver_run_for_and_exit_code(P, tmp_path):
    drv = P.MockDriver()
    cfg = P.drivers.TaskConfig(id="a/m", name="m",
                               config={"run_for": 0.05, "exit_code": 2})
    drv.start_task(cfg)
    return drv.wait_task("a/m", timeout=5.0).exit_code


def case_mock_driver_start_error(P, tmp_path):
    drv = P.MockDriver()
    return raised(lambda: drv.start_task(P.drivers.TaskConfig(
        id="a/m", name="m", config={"start_error": "boom"})))


def case_mock_driver_recover_always_lost(P, tmp_path):
    drv = P.MockDriver()
    return raised(lambda: drv.recover_task(P.drivers.TaskHandle(
        driver="mock_driver", task_id="gone")))


def case_registry_fingerprints(P, tmp_path):
    reg = P.drivers.default_registry()
    fps = reg.fingerprints()
    return {"names": sorted(set(reg.names()) - {"exec"}),
            "exec": "exec" in reg.names(),
            "raw_exec": fps["raw_exec"].attributes,
            "mock_driver": fps["mock_driver"].attributes,
            "health": sorted({fp.health for n, fp in fps.items()
                              if n != "exec"})}


# -------------------------------------------------------------- codec
def case_codec_roundtrips_allocation(P, tmp_path):
    a = P.mock.alloc()
    a.job.payload = b"\x00\x01binary"
    wire = json.loads(json.dumps(P.codec.to_wire(a)))
    back = P.codec.from_wire(P.structs.Allocation, wire)
    return [back.id == a.id, back.job.payload,
            back.job.task_groups[0].tasks[0].resources.cpu
            == a.job.task_groups[0].tasks[0].resources.cpu,
            back.allocated_resources.tasks["web"].networks[0].ip
            == a.allocated_resources.tasks["web"].networks[0].ip]


def case_codec_roundtrips_node(P, tmp_path):
    n = P.mock.gpu_node()
    back = P.codec.from_wire(P.structs.Node,
                             json.loads(json.dumps(P.codec.to_wire(n))))
    return [back.id == n.id,
            back.node_resources.devices[0].instances[0].id
            == n.node_resources.devices[0].instances[0].id,
            back.attributes == n.attributes]


# ----------------------------------------------------------- state DB
def state_db_roundtrip(P, db):
    a = P.mock.alloc()
    db.put_allocation(a)
    out = [[x.id == a.id for x in db.get_all_allocations()]]
    handle = P.drivers.TaskHandle(driver="raw_exec", task_id=f"{a.id}/web",
                                  driver_state={"pid": 42})
    ts = P.structs.TaskState(state="running", started_at=1.0)
    db.put_task_runner_state(a.id, "web", handle, ts)
    h2, s2 = db.get_task_runner_state(a.id, "web")
    out.append([h2.driver_state["pid"], s2.state])
    # a None handle clears the stored re-attach token (the task exited);
    # a restarted agent must not recover a dead task
    db.put_task_runner_state(a.id, "web", None,
                             P.structs.TaskState(state="dead"))
    h3, s3 = db.get_task_runner_state(a.id, "web")
    out.append([h3, s3.state])
    db.delete_allocation(a.id)
    out.append([db.get_all_allocations(),
                db.get_task_runner_state(a.id, "web")])
    db.close()
    return out


def case_state_db_roundtrip_sqlite(P, tmp_path):
    return state_db_roundtrip(P, P.StateDB(str(tmp_path / "state.db")))


def case_state_db_roundtrip_mem(P, tmp_path):
    return state_db_roundtrip(P, P.MemDB())


def case_state_db_persists_across_reopen(P, tmp_path):
    path = str(tmp_path / "state.db")
    db = P.StateDB(path)
    a = P.mock.alloc()
    db.put_allocation(a)
    db.close()
    db2 = P.StateDB(path)
    out = [x.id == a.id for x in db2.get_all_allocations()]
    db2.close()
    return out


OUTCOMES = Outcomes({
    "rawexec_runs_and_exits_zero": case_rawexec_runs_and_exits_zero,
    "rawexec_nonzero_exit": case_rawexec_nonzero_exit,
    "rawexec_stop_kills_process_group":
        case_rawexec_stop_kills_process_group,
    "rawexec_recover_live_task": case_rawexec_recover_live_task,
    "rawexec_recover_finished_task_reads_exit_file":
        case_rawexec_recover_finished_task_reads_exit_file,
    "rawexec_bad_command_fails_start": case_rawexec_bad_command_fails_start,
    "rawexec_rejects_unknown_config_key":
        case_rawexec_rejects_unknown_config_key,
    "pid_reuse_protection": case_pid_reuse_protection,
    "mock_driver_run_for_and_exit_code":
        case_mock_driver_run_for_and_exit_code,
    "mock_driver_start_error": case_mock_driver_start_error,
    "mock_driver_recover_always_lost": case_mock_driver_recover_always_lost,
    "registry_fingerprints": case_registry_fingerprints,
    "codec_roundtrips_allocation": case_codec_roundtrips_allocation,
    "codec_roundtrips_node": case_codec_roundtrips_node,
    "state_db_roundtrip_sqlite": case_state_db_roundtrip_sqlite,
    "state_db_roundtrip_mem": case_state_db_roundtrip_mem,
    "state_db_persists_across_reopen": case_state_db_persists_across_reopen,
})
BOTH = pytest.mark.parametrize("pkg", PKG_NAMES)


@BOTH
def test_rawexec_runs_and_exits_zero(pkg, tmp_path_factory):
    out = OUTCOMES.check("rawexec_runs_and_exits_zero", pkg,
                         tmp_path_factory)
    assert out == {"pid": True, "exit": (0, 0, ""), "stdout": "hello\n"}


@BOTH
def test_rawexec_nonzero_exit(pkg, tmp_path_factory):
    assert OUTCOMES.check("rawexec_nonzero_exit", pkg,
                          tmp_path_factory) == [3, False]


@BOTH
def test_rawexec_stop_kills_process_group(pkg, tmp_path_factory):
    out = OUTCOMES.check("rawexec_stop_kills_process_group", pkg,
                         tmp_path_factory)
    assert out == {"alive_before": True, "alive_after": False,
                   "signalled": True}


@BOTH
def test_rawexec_recover_live_task(pkg, tmp_path_factory):
    out = OUTCOMES.check("rawexec_recover_live_task", pkg, tmp_path_factory)
    assert out == {"state": "running", "pid": True, "waited": True}


@BOTH
def test_rawexec_recover_finished_task_reads_exit_file(pkg,
                                                       tmp_path_factory):
    assert OUTCOMES.check("rawexec_recover_finished_task_reads_exit_file",
                          pkg, tmp_path_factory) == 7


@BOTH
def test_rawexec_bad_command_fails_start(pkg, tmp_path_factory):
    assert OUTCOMES.check("rawexec_bad_command_fails_start", pkg,
                          tmp_path_factory) == "DriverError"


@BOTH
def test_rawexec_rejects_unknown_config_key(pkg, tmp_path_factory):
    name, err = OUTCOMES.check("rawexec_rejects_unknown_config_key", pkg,
                               tmp_path_factory)
    assert name == "DriverError" and "'image'" in err[0]


@BOTH
def test_pid_reuse_protection(pkg, tmp_path_factory):
    assert OUTCOMES.check("pid_reuse_protection", pkg,
                          tmp_path_factory) == [True, False]


@BOTH
def test_mock_driver_run_for_and_exit_code(pkg, tmp_path_factory):
    assert OUTCOMES.check("mock_driver_run_for_and_exit_code", pkg,
                          tmp_path_factory) == 2


@BOTH
def test_mock_driver_start_error(pkg, tmp_path_factory):
    assert OUTCOMES.check("mock_driver_start_error", pkg,
                          tmp_path_factory) == "DriverError"


@BOTH
def test_mock_driver_recover_always_lost(pkg, tmp_path_factory):
    assert OUTCOMES.check("mock_driver_recover_always_lost", pkg,
                          tmp_path_factory) == "TaskNotFoundError"


@BOTH
def test_registry_fingerprints(pkg, tmp_path_factory):
    port = OUTCOMES.get("registry_fingerprints", "port", tmp_path_factory)
    ref = OUTCOMES.get("registry_fingerprints", "ref", tmp_path_factory)
    out = port if pkg == "port" else ref
    assert out["names"] == ["mock_driver", "raw_exec"]
    assert out["raw_exec"]["driver.raw_exec"] == "1"
    # the reference registers `exec` too; the port does not yet
    assert out["exec"] is (pkg == "ref")
    if pkg == "port":
        assert {k: v for k, v in port.items() if k != "exec"} == \
            {k: v for k, v in ref.items() if k != "exec"}


@BOTH
def test_codec_roundtrips_allocation(pkg, tmp_path_factory):
    assert OUTCOMES.check("codec_roundtrips_allocation", pkg,
                          tmp_path_factory) == [True, b"\x00\x01binary",
                                                True, True]


@BOTH
def test_codec_roundtrips_node(pkg, tmp_path_factory):
    assert OUTCOMES.check("codec_roundtrips_node", pkg,
                          tmp_path_factory) == [True, True, True]


@pytest.mark.parametrize("db", ["sqlite", "mem"])
@BOTH
def test_state_db_roundtrip(pkg, db, tmp_path_factory):
    out = OUTCOMES.check(f"state_db_roundtrip_{db}", pkg, tmp_path_factory)
    assert out == [[True], [42, "running"], [None, "dead"],
                   [[], (None, None)]]


@BOTH
def test_state_db_persists_across_reopen(pkg, tmp_path_factory):
    assert OUTCOMES.check("state_db_persists_across_reopen", pkg,
                          tmp_path_factory) == [True]


# --------------------------------------- a task that exits at once
class SlowLook(types.ModuleType):
    """`os` as a driver module sees it, except that its second look for
    the executor's state file (the first is the start's stale-file
    check) comes only once the task has exited, and answers that the
    file is not there: the driver's thread descheduled between its looks
    while a task that exits at once runs to its end."""

    def __init__(self, real):
        super().__init__("os")
        self._real = real
        self.looks = 0
        outer = self

        class Path(types.ModuleType):
            def __getattr__(self, name):
                return getattr(real.path, name)

            def exists(self, p):
                if p.endswith("state.json"):
                    outer.looks += 1
                    if outer.looks == 2:
                        exit_file = p[:-len("state.json")] + "exit.json"
                        for _ in range(1000):
                            if real.path.exists(exit_file):
                                break
                            time.sleep(0.01)
                        return False
                return real.path.exists(p)
        self.path = Path("os.path")

    def __getattr__(self, name):
        return getattr(self._real, name)


@BOTH
def test_rawexec_start_of_a_task_that_exits_at_once(pkg, tmp_path,
                                                     monkeypatch):
    """A task that starts and exits between the driver's two looks (its
    state file, then its exit record) started: the port looks at the
    exit record first and takes the state file beside it; the reference
    takes the exit record alone for a failed start.  Phase 16's 32
    tasks of `echo`, started at once on a busy agent, met this."""
    P = agent_pkg(pkg)
    look = SlowLook(os)
    monkeypatch.setattr(P.rawexec_module, "os", look)
    drv = P.RawExecDriver()
    cfg = task_cfg(P, tmp_path, args=["-c", "exit 0"])
    if pkg == "ref":
        with pytest.raises(P.drivers.DriverError,
                           match="failed to start task"):
            drv.start_task(cfg)
    else:
        handle = drv.start_task(cfg)
        assert handle.driver_state["pid"] > 0
        assert drv.wait_task(cfg.id, timeout=10.0).exit_code == 0
        drv.destroy_task(cfg.id)
    assert look.looks >= 2


# ----------------------------------------------------- import hygiene
def test_executor_child_imports_no_torch_and_no_reference():
    """The per-task executor starts as its own interpreter for each task
    (phase 16 starts 32 at once inside the driver's 10 s start timeout):
    its import chain loads neither torch nor the JAX package."""
    code = ("import nomad_tpu_torch.drivers.executor, sys\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('torch', 'jax', 'jaxlib', 'nomad_tpu'))\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=60)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_port_rawexec_spawns_the_port_executor(tmp_path, monkeypatch):
    """The port's raw_exec runs each task under the port's executor
    (`python -m nomad_tpu_torch.drivers.executor`), never the
    reference's."""
    from nomad_tpu_torch.drivers import rawexec
    argvs = []
    real = subprocess.Popen

    def spy(argv, *a, **kw):
        argvs.append(list(argv))
        return real(argv, *a, **kw)
    monkeypatch.setattr(rawexec.subprocess, "Popen", spy)
    P = agent_pkg("port")
    drv = P.RawExecDriver()
    cfg = task_cfg(P, tmp_path, args=["-c", "exit 0"])
    drv.start_task(cfg)
    assert drv.wait_task(cfg.id, timeout=10.0).exit_code == 0
    drv.destroy_task(cfg.id)
    assert argvs == [[sys.executable, "-m",
                      "nomad_tpu_torch.drivers.executor",
                      os.path.join(cfg.task_dir, ".executor", "spec.json")]]
    assert rawexec.EXECUTOR_MODULE == "nomad_tpu_torch.drivers.executor"
