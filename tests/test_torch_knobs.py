"""The port's `NOMAD_TPU_*` environment layer against the JAX package's,
on the CPU.

Every knob the reference reads, less the three the port leaves out on
purpose (`NOMAD_TPU_SOLVE_DEADLINE_S`, `NOMAD_TPU_PALLAS`,
`NOMAD_TPU_COMPILE_CACHE`), is one parametrised case with three parts:
with the name unset both packages resolve the reference's default; with
a valid setting (through `monkeypatch`) both resolve the same value and
the object that reads it acts on it; with an invalid setting both reach
the same outcome (the same exception type and message, or the same
fallback to the default).  The import-time constants are compared in
subprocesses, the reference's under `JAX_PLATFORMS=cpu`.  A last case
scans both packages' ASTs for the names they read.
"""
import ast
import os
import subprocess
import sys

import pytest
import torch

from nomad_tpu import mock as ref_mock
from nomad_tpu.parallel import sharded as ref_sh
from nomad_tpu.server import eval_broker as ref_broker
from nomad_tpu.server import serving as ref_serving
from nomad_tpu.solver import resident as ref_resident
from nomad_tpu.solver import tensorize as ref_tz
from nomad_tpu.utils import metrics as ref_metrics
from nomad_tpu.utils import tracing as ref_tracing
from nomad_tpu_torch import mock as port_mock
from nomad_tpu_torch.parallel import sharded as port_sh
from nomad_tpu_torch.server import eval_broker as port_broker
from nomad_tpu_torch.server import serving as port_serving
from nomad_tpu_torch.solver import resident as port_resident
from nomad_tpu_torch.solver import tensorize as port_tz
from nomad_tpu_torch.utils import metrics as port_metrics
from nomad_tpu_torch.utils import tracing as port_tracing

REPO = __file__.rsplit("/tests/", 1)[0]
CPU = torch.device("cpu")
#: the reference's knobs the port does not read, each for a stated
#: reason (ROADMAP.md "Not to port")
NOT_PORTED = {"NOMAD_TPU_SOLVE_DEADLINE_S", "NOMAD_TPU_PALLAS",
              "NOMAD_TPU_COMPILE_CACHE"}


class Pkg:
    def __init__(self, name, **mods):
        self.name = name
        self.__dict__.update(mods)

    def __repr__(self):
        return self.name


REF = Pkg("ref", mock=ref_mock, sh=ref_sh, broker=ref_broker,
          serving=ref_serving, resident=ref_resident, tz=ref_tz,
          metrics=ref_metrics, tracing=ref_tracing)
PORT = Pkg("port", mock=port_mock, sh=port_sh, broker=port_broker,
           serving=port_serving, resident=port_resident, tz=port_tz,
           metrics=port_metrics, tracing=port_tracing)


# ------------------------------------------------------------ readers
def _scalars(obj):
    return {k: v for k, v in vars(obj).items()
            if isinstance(v, (bool, int, float, str)) and k != "evict_e"}


def tier_state(P):
    """Everything a ServingTier resolved from its knobs, as the objects
    it configured hold it (the tier, the batch controller, admission and
    the SLO burn tracker)."""
    t = P.serving.ServingTier()
    return {"tier": _scalars(t), "batch": _scalars(t.batch_controller),
            "admission": _scalars(t.admission),
            "burn": (t.burn.objective, t.burn.windows)}


def router_state(P):
    r = P.serving.SpilloverRouter(regions={"us": 1.0})
    return (r.slo_budget_s, r.spill_margin, r.default_cost, r.max_pending,
            r.region("us").admission.max_pending)


def broker_state(P):
    return (P.broker.EvalBroker().num_shards,
            P.serving.ServingTier().broker_shards)


def _nodes_asks(P, n=8):
    nodes = []
    for i in range(n):
        node = P.mock.node()
        node.id = f"node-{i:03d}"
        node.compute_class()
        nodes.append(node)
    job = P.mock.job()
    job.id = "knob-job"
    asks = [P.tz.PlacementAsk(job=job, tg=tg, count=tg.count)
            for tg in job.task_groups]
    return nodes, asks


def resident_state(P):
    """The stream solver's three knobs as a built solver holds them."""
    nodes, asks = _nodes_asks(P)
    kw = {"device": "cpu"} if P is PORT else {}
    rs = P.resident.ResidentSolver(nodes, asks, pallas="off", **kw)
    return (rs.shortlist_c, rs.fused_lanes, rs.delta_threshold)


def elastic_slack(P):
    nodes, asks = _nodes_asks(P, 16)
    if P is PORT:
        mesh = P.sh.make_node_mesh(2, devices=[CPU])
        s = P.sh.ElasticShardedResidentSolver(nodes, asks, mesh=mesh,
                                              pallas="off", device="cpu")
    else:
        s = P.sh.ElasticShardedResidentSolver(nodes, asks,
                                              mesh=P.sh.make_node_mesh(2),
                                              pallas="off")
    return s._slack_tiles


def two_tier_shape(P):
    if P is PORT:
        m = P.sh.make_two_tier_mesh(n_devices=8, devices=[CPU])
    else:
        m = P.sh.make_two_tier_mesh(n_devices=8)
    return (P.sh.env_mesh_hosts(), tuple(m.devices.shape))


def three_tier_shape(P):
    if P is PORT:
        m = P.sh.make_three_tier_mesh(n_devices=8, devices=[CPU])
    else:
        m = P.sh.make_three_tier_mesh(n_devices=8)
    return (P.sh.env_mesh_regions(), tuple(m.devices.shape))


def recorder_state(P):
    rec = P.tracing.FlightRecorder()
    return (rec.enabled, rec.depth_limit, rec.sample, rec.spill_limit,
            rec._sink_path)


def event_log_sink(P):
    return P.tracing.MeshEventLog()._sink_path


def metrics_cap(P):
    return P.metrics.MetricsRegistry().max_keys_per_ns


#: env name -> (reader, a valid setting, an invalid setting)
SERVING = {
    "NOMAD_TPU_SLO_BUDGET_S": ("0.2", "fast"),
    "NOMAD_TPU_MAX_BATCH": ("7", "7.5"),
    "NOMAD_TPU_BYPASS_PRIORITY": ("90", "high"),
    "NOMAD_TPU_ADMIT_MAX_PENDING": ("128", "many"),
    "NOMAD_TPU_NS_RATE": ("12.5", "x"),
    "NOMAD_TPU_NS_BURST": ("33", "x"),
    "NOMAD_TPU_BROWNOUT_HIGH": ("0.9", "x"),
    "NOMAD_TPU_BROWNOUT_LOW": ("0.1", "x"),
    "NOMAD_TPU_BROWNOUT_AFTER_S": ("2.5", "x"),
    "NOMAD_TPU_SLO_MARGIN": ("0.4", "x"),
    "NOMAD_TPU_SLO_OBJECTIVE": ("0.99", "x"),
    "NOMAD_TPU_SLO_FAST_WINDOW_S": ("30", "x"),
    "NOMAD_TPU_SLO_FAST_BURN": ("10", "x"),
    "NOMAD_TPU_SLO_SLOW_WINDOW_S": ("900", "x"),
    "NOMAD_TPU_SLO_SLOW_BURN": ("3", "x"),
    "NOMAD_TPU_NUM_WORKERS": ("3", "three"),
    "NOMAD_TPU_GROUP_COMMIT": ("2", "x"),
    "NOMAD_TPU_COORDINATOR": ("0", "no"),
    "NOMAD_TPU_PIPELINE": ("0", "no"),
    "NOMAD_TPU_WORKER_PAUSE_FRACTION": ("0.5", "x"),
    "NOMAD_TPU_FUSED_LANES": ("4", "wide"),
    "NOMAD_TPU_MAX_LANES": ("16", "x"),
    "NOMAD_TPU_LANE_WIDEN_BELOW": ("0.1", "x"),
    "NOMAD_TPU_LANE_NARROW_ABOVE": ("0.5", "x"),
}
KNOBS = {name: (tier_state, valid, bad)
         for name, (valid, bad) in SERVING.items()}
KNOBS.update({
    "NOMAD_TPU_BROKER_SHARDS": (broker_state, "4", "four"),
    "NOMAD_TPU_SPILL_MARGIN": (router_state, "0.5", "x"),
    "NOMAD_TPU_REGION_COST": (router_state, "2.5", "x"),
    "NOMAD_TPU_MAX_PENDING": (router_state, "64", "x"),
    "NOMAD_TPU_EVICT_E": (lambda P: P.tz.evict_width(), "0", "-x"),
    "NOMAD_TPU_SHARD_TILE": (lambda P: P.tz.pick_tile_np(1024, 4), "128",
                             "48"),
    "NOMAD_TPU_SHORTLIST_C": (resident_state, "off", "wide"),
    "NOMAD_TPU_DELTA_THRESHOLD": (resident_state, "0.5", "x"),
    "NOMAD_TPU_MESH_HOSTS": (two_tier_shape, "2", "-1"),
    "NOMAD_TPU_MESH_REGIONS": (three_tier_shape, "4", "some"),
    "NOMAD_TPU_RESHARD_SLACK": (elastic_slack, "2", "x"),
    "NOMAD_TPU_TRACE": (recorder_state, "0", "off"),
    "NOMAD_TPU_TRACE_DEPTH": (recorder_state, "16", "x"),
    "NOMAD_TPU_TRACE_SAMPLE": (recorder_state, "0.25", "x"),
    "NOMAD_TPU_TRACE_SPILL": (recorder_state, "64", "x"),
    "NOMAD_TPU_TRACE_SINK": (recorder_state, "<tmp>/t.jsonl", ""),
    "NOMAD_TPU_MESH_EVENT_LOG": (event_log_sink, "<tmp>/m.jsonl", ""),
    "NOMAD_TPU_METRICS_MAX_KEYS": (metrics_cap, "8", "x"),
})
# the serving tier also reads NOMAD_TPU_FUSED_LANES; the stream solver
# reads it too: both readers in one case
KNOBS["NOMAD_TPU_FUSED_LANES"] = (
    lambda P: (tier_state(P), resident_state(P)), "4", "wide")

#: read at import: module, attribute, valid, invalid
IMPORT_TIME = {
    "NOMAD_TPU_RESIDENT_MIN_NODES": ("solver.solve", "RESIDENT_MIN_NODES",
                                     "1", "x"),
    "NOMAD_TPU_BROWNOUT_MAX_WAVES": ("solver.solve", "BROWNOUT_MAX_WAVES",
                                     "3", "3.5"),
    "NOMAD_TPU_RPC_RETRIES": ("rpc.client", "MAX_RETRIES", "0", "none"),
}


def _outcome(fn, P):
    try:
        return ("ok", fn(P))
    except Exception as e:          # compared across the packages
        return (type(e).__name__, str(e))


@pytest.fixture(autouse=True)
def _no_knobs(monkeypatch):
    """Each case starts with no NOMAD_TPU_* variable set."""
    for name in list(os.environ):
        if name.startswith("NOMAD_TPU_"):
            monkeypatch.delenv(name)


@pytest.mark.parametrize("name", sorted(KNOBS))
def test_knob_default_setting_and_invalid_value_match_reference(
        name, monkeypatch, tmp_path):
    read, valid, bad = KNOBS[name]
    valid = valid.replace("<tmp>", str(tmp_path))
    unset = {P.name: _outcome(read, P) for P in (REF, PORT)}
    assert unset["port"] == unset["ref"]
    assert unset["port"][0] == "ok"
    monkeypatch.setenv(name, valid)
    got = {P.name: _outcome(read, P) for P in (REF, PORT)}
    assert got["port"] == got["ref"]
    assert got["port"][0] == "ok"
    # the setting reached the object that reads it
    assert got["port"] != unset["port"]
    monkeypatch.setenv(name, bad)
    got = {P.name: _outcome(read, P) for P in (REF, PORT)}
    assert got["port"] == got["ref"]


def _import_value(pkg, module, attr, env):
    code = (f"import importlib; m = importlib.import_module("
            f"'{pkg}.{module}'); print(repr(m.{attr}))")
    full = {k: v for k, v in os.environ.items()
            if not k.startswith("NOMAD_TPU_")}
    full.update(env, JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          env=full, capture_output=True, text=True,
                          timeout=300)
    if proc.returncode:
        return ("raised", proc.stderr.strip().splitlines()[-1])
    return ("ok", proc.stdout.strip())


@pytest.mark.parametrize("name", sorted(IMPORT_TIME))
def test_import_time_knob_matches_reference(name):
    module, attr, valid, bad = IMPORT_TIME[name]
    seen = {}
    for label, env in (("unset", {}), ("valid", {name: valid}),
                       ("invalid", {name: bad})):
        seen[label] = {pkg: _import_value(pkg, module, attr, env)
                       for pkg in ("nomad_tpu", "nomad_tpu_torch")}
        assert seen[label]["nomad_tpu_torch"] == seen[label]["nomad_tpu"]
    assert seen["valid"]["nomad_tpu_torch"] == ("ok", valid)
    assert seen["unset"]["nomad_tpu_torch"] != seen["valid"][
        "nomad_tpu_torch"]
    assert seen["invalid"]["nomad_tpu_torch"][0] == "raised"


def _names_read(package):
    """The NOMAD_TPU_* names a package's code holds as whole string
    constants (the names it reads; docstrings and messages that mention
    one are longer strings)."""
    out = set()
    root = os.path.join(REPO, package)
    for dirpath, _dirs, files in os.walk(root):
        for f in files:
            if not f.endswith(".py"):
                continue
            with open(os.path.join(dirpath, f)) as fh:
                tree = ast.parse(fh.read())
            for node in ast.walk(tree):
                if (isinstance(node, ast.Constant)
                        and isinstance(node.value, str)
                        and node.value.startswith("NOMAD_TPU_")
                        and node.value.replace("_", "").isalnum()
                        and node.value.upper() == node.value):
                    out.add(node.value)
    return out


def test_port_reads_the_reference_knobs_less_the_three_left_out():
    ref, port = _names_read("nomad_tpu"), _names_read("nomad_tpu_torch")
    assert NOT_PORTED <= ref
    assert port == ref - NOT_PORTED
    assert port == set(KNOBS) | set(IMPORT_TIME)
