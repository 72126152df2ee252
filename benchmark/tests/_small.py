"""Small cells for the CPU tests: the configured cells cut to a few
hundred nodes and a few seconds, run through the harness on the CPU."""
from __future__ import annotations

import contextlib
import os
import time

from benchmark import harness

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
SPEC = harness.load_spec(ROOT)
#: the server cell's metrics, kept with its files for the cell a later
#: benchmark change adds (BENCHMARK.json does not name them yet)
SERVER_SPEC = {
    "end_to_end": [{"name": "server_placements_per_s",
                    "unit": "placements/s"},
                   {"name": "setup_s", "unit": "s"}],
    "per_layer": [{"name": n, "unit": u} for n, u in (
        ("eval_p95_ms.server", "ms"), ("queue_ms.server", "ms"),
        ("reconcile_ms.server", "ms"), ("solve_ms.server", "ms"),
        ("plan_submit_ms.server", "ms"), ("device_idle.server", "%"))]}


#: every cell the harness has files for, in BENCHMARK.json or not yet
CELLS = {"c2-stream": ("c2-10k-binpack", "stream-passes"),
         "c3-server-burst": ("c3-10k-constrained", "server-deployers")}


def cell(name: str):
    config, traffic = CELLS[name]
    return {"name": name, "config": config, "traffic": traffic, "chips": 1}


def small(name: str, nodes: int = 600):
    """(cell, cfg, mix, limits) of `name` at test size."""
    c = cell(name)
    cfg = harness.load_json(harness.HERE, "configs", f"{c['config']}.json")
    mix = harness.load_json(harness.HERE, "traffic", f"{c['traffic']}.json")
    limits = harness.load_json(harness.HERE, "limits", f"{c['name']}.json")
    per_node = cfg["resident"]["allocs"] // cfg["nodes"]["count"]
    cfg["nodes"]["count"] = nodes
    cfg["resident"]["allocs"] = nodes * per_node
    if mix["entry"] == "stream":
        mix.update(evals_per_pass=64, evals_per_chunk=16, job_sets=2)
    else:
        mix.update(clients=6, warm_burst=2, drain_s=60, ramp_s=1)
    return c, cfg, mix, limits


@contextlib.contextmanager
def device_path():
    """Small server solves take the wave loop, as at full size (the port
    sends problems under its host gate to the numpy twin)."""
    from nomad_tpu_torch.solver import solve
    real = solve.prefer_host
    solve.prefer_host = lambda *a: False
    try:
        yield
    finally:
        solve.prefer_host = real


def run(name: str, seed: int = 2**31 + 11, seconds: float = 2.0,
        trace: int = 0, control: str = "", nodes: int = 600):
    c, cfg, mix, limits = small(name, nodes)
    os.environ["NOMAD_TPU_TRACE_DEPTH"] = "1000000"
    spec = SPEC if c["name"] in {w["name"] for w in SPEC["workloads"]} \
        else SERVER_SPEC
    with device_path():
        return harness.run_cell(ROOT, spec, c, seed, seconds, trace, "cpu",
                                time.perf_counter(), control=control,
                                cfg=cfg, mix=mix, limits=limits)
