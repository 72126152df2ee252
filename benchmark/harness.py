"""Load a cell by name, run its driver, and build the result line."""
from __future__ import annotations

import gc
import importlib
import importlib.util
import json
import os
import sys
from dataclasses import dataclass
from typing import Dict, Optional

HERE = os.path.dirname(os.path.abspath(__file__))


@dataclass
class Run:
    """What a driver gets: the cell's data and the run's arguments."""
    cfg: Dict
    mix: Dict
    limits: Dict
    seed: int
    seconds: float
    trace: int
    device: str
    t0: float
    control: str = ""


def settle() -> None:
    """End of set-up: collect once and move what set-up built out of the
    collector's reach, so that no full collection of the cluster's
    objects lands in the window."""
    gc.collect()
    gc.freeze()


def load_json(*parts) -> Dict:
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def load_spec(root: str) -> Dict:
    return load_json(root, "BENCHMARK.json")


def workload(spec: Dict, name: str) -> Dict:
    for w in spec["workloads"]:
        if w["name"] == name:
            return w
    raise SystemExit(f"no workload {name!r} in BENCHMARK.json")


def config_file(spec: Dict, name: str) -> str:
    for c in spec["configs"]:
        if c["name"] == name:
            return c["file"]
    raise SystemExit(f"no config {name!r} in BENCHMARK.json")


def applies(metric: Dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def reader(name: str):
    """The per-layer metric's reader module, `metrics/<name>.py`."""
    path = os.path.join(HERE, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        f"benchmark.metrics.{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_cell(root: str, spec: Dict, cell: Dict, seed: int, seconds: float,
             trace: int, device: str, t0: float, control: str = "",
             cfg: Optional[Dict] = None, mix: Optional[Dict] = None,
             limits: Optional[Dict] = None) -> Dict:
    """One run of `cell`; returns the result object.  `cfg`, `mix` and
    `limits` replace the files a cell names (the tests' small cells)."""
    cfg = cfg or load_json(root, config_file(spec, cell["config"]))
    mix = mix or load_json(HERE, "traffic", f"{cell['traffic']}.json")
    limits = limits or load_json(HERE, "limits", f"{cell['name']}.json")
    run = Run(cfg=cfg, mix=mix, limits=limits, seed=seed, seconds=seconds,
              trace=trace, device=device, t0=t0, control=control)
    driver = importlib.import_module(f"benchmark.drivers.{mix['entry']}")
    out = driver.run(run)
    checks = out["checks"]
    correct = all(v <= lim for _, v, lim in checks)
    metrics = {}
    if trace:
        for m in spec["per_layer"]:
            if applies(m, cell["name"]):
                v = reader(m["name"]).read(out)
                if v is not None:
                    metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        for m in spec["end_to_end"]:
            if applies(m, cell["name"]):
                metrics[m["name"]] = {"value": out["e2e"][m["name"]],
                                      "unit": m["unit"]}
    if device == "cuda":
        import torch
        dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
               "count": cell["chips"],
               "memory_peak_bytes": int(out["memory_peak_bytes"])}
    else:
        dev = {"platform": "cpu", "kind": "cpu", "count": 0,
               "memory_peak_bytes": 0}
    result = {"correct": correct, "attempted": int(out["attempted"]),
              "failed": int(out["failed"]), "metrics": metrics,
              "device": dev}
    traced = out["layer"].get("traced")
    if trace and traced is not None:
        s = traced["summary"]
        dev["busy_s"] = s["busy_s"]
        dev["window_s"] = s["window_s"]
        result["breakdown"] = {
            "device_ops": [[k, v] for k, v in s["device_ops"][:10]],
            "idle_gaps": [[k, v] for k, v in s["idle_gaps"][:10]]}
    result["checks"] = {k: {"value": v, "limit": lim}
                        for k, v, lim in checks}
    print("diag " + json.dumps(out.get("diag", {}), default=str),
          file=sys.stderr)
    return result


def emit(result: Dict) -> None:
    """The compared numbers as the last lines of standard error, then
    the result as the last line of standard output."""
    sys.stdout.flush()
    for k, c in result["checks"].items():
        print(f"check {k} = {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
