"""The port's device plugins (`nomad_tpu_torch.plugins.device`) and their
wiring through the node agent, against the JAX package's, on the CPU.

The three cases of `tests/test_device_plugin.py` run on both packages
(`pkg` = "ref" / "port"), with `CUDADevicePlugin` in the place of the
reference's `TPUDevicePlugin`: routing of fingerprints and reservations
by vendor/type/name, an empty inventory where the host has no such
accelerator (the CPU here), and a job's device ask placed and its
plugin's env recipe in the task's env.  Further cases hold
`CUDADevicePlugin`'s own fingerprint (on a stand-in for `torch.cuda`
that reports two H100s) and its reserve recipe against the reference's
TPU recipe, and an alloc that asks for a CSI volume failing on an agent
with no CSI manager with the reference's message.  The port's outcome
must equal the reference's.  Every agent is shut down with
`halt_tasks=True` and every server stopped in `finally`.
"""
import os
import sys
import types

import pytest

from tests.test_torch_drivers import PKG_NAMES, Outcomes

BOTH = pytest.mark.parametrize("pkg", PKG_NAMES)
#: each package's first-party accelerator plugin
FIRST_PARTY = {"ref": "TPUDevicePlugin", "port": "CUDADevicePlugin"}


def fake_group(P, model="v4", count=2):
    return P.structs.NodeDeviceResource(
        vendor="acme", type="fpga", name=model,
        instances=[P.structs.NodeDevice(id=f"{model}-{i}", healthy=True)
                   for i in range(count)])


def case_registry_fingerprint_and_reserve_routing(P, tmp):
    p1 = P.device.MockDevicePlugin([fake_group(P, "a", 2)], env_key="DEV_A")
    p2 = P.device.MockDevicePlugin([fake_group(P, "b", 1)], env_key="DEV_B")
    reg = P.device.DevicePluginRegistry([p1, p2])
    groups = reg.fingerprint_all()
    res = reg.reserve("acme", "fpga", "b", ["b-0"])
    return [[g.name for g in groups], res.envs, res.devices, p2.reserved,
            reg.reserve("acme", "fpga", "zzz", ["x"])]


def case_first_party_plugin_is_failure_tolerant(P, tmp):
    # the CPU test platform has neither a TPU nor a CUDA device: the
    # first-party plugin offers an empty inventory, never raises
    plugin = getattr(P.device, FIRST_PARTY[P.name])()
    return [plugin.fingerprint(),
            P.device.default_device_registry().fingerprint_all(),
            [type(p).__name__ for p in
             P.device.default_device_registry().plugins]]


def case_device_ask_e2e_env_injection(P, tmp):
    """A job asking for device instances gets them assigned by the
    solver, and its task env carries the plugin's reservation recipe."""
    srv = P.Server(num_workers=2)
    srv.start()
    plugin = P.device.MockDevicePlugin([fake_group(P, "v9", 2)],
                                       env_key="ACME_VISIBLE")
    reg = P.device.DevicePluginRegistry([plugin])
    client = P.Client(srv, data_dir=str(tmp / "agent"), device_registry=reg)
    try:
        client.start()
        job = P.mock.job()
        tg = job.task_groups[0]
        tg.count = 1
        task = tg.tasks[0]
        task.driver = "raw_exec"
        out_file = str(tmp / "envdump")
        # write-then-rename so the watcher never reads a half-written dump
        task.config = {"command": "/bin/sh",
                       "args": ["-c", f"env > {out_file}.tmp && "
                                      f"mv {out_file}.tmp {out_file}; "
                                      "sleep 30"]}
        task.resources.networks = []
        task.resources.devices = [P.structs.RequestedDevice(
            name="acme/fpga/v9", count=2)]
        srv.register_job(job)
        ran = P.wait_until(lambda: any(
            a.client_status == P.structs.ALLOC_CLIENT_RUNNING
            for a in srv.store.allocs_by_job("default", job.id)),
            timeout=25)
        dumped = P.wait_until(lambda: os.path.exists(out_file), timeout=5)
        env = dict(line.split("=", 1)
                   for line in open(out_file).read().splitlines()
                   if "=" in line)
        alloc = srv.store.allocs_by_job("default", job.id)[0]
        assigned = [(d.vendor, d.type, d.name, sorted(d.device_ids))
                    for d in alloc.allocated_resources.tasks["web"].devices]
        return {"ran": ran, "dumped": dumped,
                "env": sorted(env["ACME_VISIBLE"].split(",")),
                "reserved": [sorted(r) for r in plugin.reserved],
                "assigned": assigned}
    finally:
        client.shutdown(halt_tasks=True)
        srv.stop()


OUTCOMES = Outcomes({
    "registry_fingerprint_and_reserve_routing":
        case_registry_fingerprint_and_reserve_routing,
    "first_party_plugin_is_failure_tolerant":
        case_first_party_plugin_is_failure_tolerant,
    "device_ask_e2e_env_injection": case_device_ask_e2e_env_injection,
})


@BOTH
def test_registry_fingerprint_and_reserve_routing(pkg, tmp_path_factory):
    assert OUTCOMES.check("registry_fingerprint_and_reserve_routing", pkg,
                          tmp_path_factory) == [
        ["a", "b"], {"DEV_B": "b-0"}, ["b-0"], [["b-0"]], None]


@BOTH
def test_first_party_plugin_is_failure_tolerant(pkg, tmp_path_factory):
    port = OUTCOMES.get("first_party_plugin_is_failure_tolerant", "port",
                        tmp_path_factory)
    ref = OUTCOMES.get("first_party_plugin_is_failure_tolerant", "ref",
                       tmp_path_factory)
    out = port if pkg == "port" else ref
    assert out[:2] == [[], []]
    assert out[2] == [FIRST_PARTY[pkg]]
    assert port[:2] == ref[:2]


@BOTH
def test_device_ask_e2e_env_injection(pkg, tmp_path_factory):
    out = OUTCOMES.check("device_ask_e2e_env_injection", pkg,
                         tmp_path_factory)
    assert out == {"ran": True, "dumped": True, "env": ["v9-0", "v9-1"],
                   "reserved": [["v9-0", "v9-1"]],
                   "assigned": [("acme", "fpga", "v9", ["v9-0", "v9-1"])]}


# ------------------------------------------------- CUDADevicePlugin
def fake_torch(names):
    """A stand-in `torch` module whose `torch.cuda` reports `names`."""
    cuda = types.SimpleNamespace(
        is_available=lambda: bool(names),
        device_count=lambda: len(names),
        get_device_name=lambda i: names[i])
    return types.SimpleNamespace(cuda=cuda)


def test_cuda_plugin_fingerprints_what_torch_cuda_reports(monkeypatch):
    """One group per device name, instances gpu-<ordinal>, attributes as
    the reference's TPU plugin gives them; no device, no group."""
    from nomad_tpu_torch.plugins.device import CUDADevicePlugin
    names = ["NVIDIA H100 80GB HBM3", "NVIDIA H100 80GB HBM3"]
    monkeypatch.setitem(sys.modules, "torch", fake_torch(names))
    groups = CUDADevicePlugin().fingerprint()
    assert [(g.vendor, g.type, g.name, g.attributes,
             [(i.id, i.healthy) for i in g.instances]) for g in groups] == [
        ("nvidia", "gpu", "NVIDIA H100 80GB HBM3",
         {"device_kind": "NVIDIA H100 80GB HBM3", "count": 2},
         [("gpu-0", True), ("gpu-1", True)])]
    assert groups[0].id_tuple() == ("nvidia", "gpu", "NVIDIA H100 80GB HBM3")
    monkeypatch.setitem(sys.modules, "torch", fake_torch([]))
    assert CUDADevicePlugin().fingerprint() == []


def test_cuda_plugin_reserve_recipe_matches_the_tpu_recipe():
    """reserve: the ordinals in CUDA_VISIBLE_DEVICES and the instance ids
    in NOMAD_DEVICE_GPU, as the reference's TPU plugin gives
    TPU_VISIBLE_DEVICES and NOMAD_DEVICE_TPU."""
    from nomad_tpu.plugins.device import TPUDevicePlugin
    from nomad_tpu_torch.plugins.device import CUDADevicePlugin
    cuda = CUDADevicePlugin().reserve(["gpu-0", "gpu-2"])
    tpu = TPUDevicePlugin().reserve(["tpu-0", "tpu-2"])
    assert cuda.envs == {"CUDA_VISIBLE_DEVICES": "0,2",
                         "NOMAD_DEVICE_GPU": "gpu-0,gpu-2"}
    assert tpu.envs == {"TPU_VISIBLE_DEVICES": "0,2",
                        "NOMAD_DEVICE_TPU": "tpu-0,tpu-2"}
    assert (cuda.devices, cuda.mounts) == (["gpu-0", "gpu-2"], [])
    assert (tpu.devices, tpu.mounts) == (["tpu-0", "tpu-2"], [])


# ----------------------------------------- an alloc that asks for CSI
def csi_failure(P, tmp):
    """Run an alloc whose group asks for a CSI volume on an agent with no
    CSI manager (the port's has none; the reference's is set to none)
    and return the update its runner queued."""
    client = P.Client(P.agent.ServerEndpoints(), data_dir=str(tmp),
                      dev_mode=True)
    try:
        had = client.csi_manager
        client.csi_manager = None
        alloc = P.mock.alloc()
        tg = alloc.job.task_groups[0]
        tg.volumes = {"data": P.structs.VolumeRequest(
            name="data", type="csi", source="vol-1")}
        task = tg.tasks[0]
        task.driver = "mock_driver"
        task.config = {"run_for": 5}
        client._run_allocs([alloc])
        upd = client._updates[alloc.id]
        ts = upd.task_states[task.name]
        return {"had_manager": had is not None,
                "status": upd.client_status, "task": ts.state,
                "failed": ts.failed,
                "events": [(e.type, e.message, e.failure)
                           for e in ts.events]}
    finally:
        client.shutdown(halt_tasks=True)


@BOTH
def test_csi_alloc_fails_without_a_csi_manager(pkg, tmp_path_factory):
    from tests.test_torch_drivers import agent_pkg
    port = csi_failure(agent_pkg("port"), tmp_path_factory.mktemp("port"))
    ref = csi_failure(agent_pkg("ref"), tmp_path_factory.mktemp("ref"))
    out = port if pkg == "port" else ref
    # the reference's agent builds a CSI manager; the port's has none yet
    assert out["had_manager"] is (pkg == "ref")
    assert (out["status"], out["task"], out["failed"]) == (
        "failed", "dead", True)
    assert out["events"][-1] == (
        "Driver Failure", "csi volume setup failed: alloc requests CSI "
        "volumes but this client has no CSI manager", True)
    assert {k: v for k, v in port.items() if k != "had_manager"} == \
        {k: v for k, v in ref.items() if k != "had_manager"}


# ------------------------------- the resident world and a device ask
def world_on_a_device_ask(P):
    """The worker's path (a scheduler on a store-attached solver) as the
    node agent's device ask meets it: 8 nodes without devices and a job
    placed on them (the world is built), 2 nodes that bring a GPU join
    and a second job without devices is placed (the world follows by
    delta or rebuilds), then a job asking for `nvidia/gpu` is placed.
    Returns, per step, the solver.resident.rebuild count it added, the
    world's counters and where the step's allocs landed."""
    if P.name == "ref":
        from nomad_tpu.scheduler.harness import Harness
        from nomad_tpu.solver.solve import Solver
        from nomad_tpu.utils.metrics import global_metrics
        solver_kw = {}
    else:
        from nomad_tpu_torch.scheduler.harness import Harness
        from nomad_tpu_torch.solver.solve import Solver
        from nomad_tpu_torch.utils.metrics import global_metrics
        solver_kw = {"device": "cpu", "host": "never"}
    h = Harness()
    h.solver = Solver(store=h.store, resident_min_nodes=1, **solver_kw)

    def node(i, gpus=0):
        n = P.mock.node(id=f"node-{i:04d}", name=f"node-{i}")
        n.node_resources.networks[0].ip = f"10.0.0.{i + 1}"
        if gpus:
            n.node_resources.devices = [P.structs.NodeDeviceResource(
                vendor="nvidia", type="gpu", name="NVIDIA H100 80GB HBM3",
                instances=[P.structs.NodeDevice(id=f"gpu-{g}", healthy=True)
                           for g in range(gpus)],
                attributes={"device_kind": "NVIDIA H100 80GB HBM3",
                            "count": gpus})]
        n.compute_class()
        h.store.upsert_node(h.next_index(), n)

    def place(name, gpu=False):
        job = P.mock.job(id=name)
        tg = job.task_groups[0]
        tg.count = 1 if gpu else 4
        tg.tasks[0].resources.networks = []
        if gpu:
            tg.tasks[0].resources.devices = [P.structs.RequestedDevice(
                name="nvidia/gpu", count=1)]
        h.store.upsert_job(h.next_index(), job)
        ev = P.mock.eval_(job_id=job.id, type=job.type,
                          triggered_by=P.structs.EVAL_TRIGGER_JOB_REGISTER)
        h.store.upsert_evals(h.next_index(), [ev])
        before = global_metrics.dump()["counters"].get(
            "solver.resident.rebuild", 0)
        h.process("service", ev)
        after = global_metrics.dump()["counters"].get(
            "solver.resident.rebuild", 0)
        allocs = h.store.allocs_by_job("default", name)
        return {"rebuilds": after - before,
                "world": h.solver.resident_counters(),
                "nodes": sorted(a.node_id for a in allocs),
                "devices": sorted(
                    (d.vendor, d.type, d.name, tuple(d.device_ids))
                    for a in allocs
                    for d in a.allocated_resources.tasks["web"].devices)}

    for i in range(8):
        node(i)
    steps = [place("plain-1")]
    node(8, gpus=1)
    node(9, gpus=1)
    steps.append(place("plain-2"))
    steps.append(place("gpu-1", gpu=True))
    return steps


@BOTH
def test_first_device_ask_rebuilds_the_resident_world(pkg):
    """Both packages rebuild the worker's resident world when the first
    job asking for a device arrives (its ask escapes the world's probe
    asks, which are grown and the world rebuilt once), with the same
    counters and the same placements at every step."""
    from tests.test_torch_drivers import agent_pkg
    port = world_on_a_device_ask(agent_pkg("port"))
    ref = world_on_a_device_ask(agent_pkg("ref"))
    out = port if pkg == "port" else ref
    assert out[0]["rebuilds"] == 1           # the world's first build
    assert out[2]["rebuilds"] == 1           # the device ask's rebuild
    assert out[2]["nodes"][0] in ("node-0008", "node-0009")
    assert out[2]["devices"] == [
        ("nvidia", "gpu", "NVIDIA H100 80GB HBM3", ("gpu-0",))]
    assert port == ref
