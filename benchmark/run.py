"""Run one cell of the benchmark of `nomad_tpu_torch` once.

    python benchmark/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

Everything a cell is made of is found by name: the workload in
`BENCHMARK.json`, its configuration in `benchmark/configs/<config>.json`,
its traffic in `benchmark/traffic/<traffic>.json` (whose `entry` names
the driver in `benchmark/drivers/`), its limits in
`benchmark/limits/<workload>.json`, and each per-layer metric's reader
in `benchmark/metrics/<metric>.py`.  The last line of standard output
is one JSON object; the numbers that decided `correct` end standard
error.  `--control bf16` runs the control instead of the program's
answers (never in the benchmark's own runs).
"""
from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: top-level module names that must not be loaded in a run
FORBIDDEN = ("jax", "jaxlib", "flax", "nomad_tpu")


def cache_env(root: str) -> None:
    """Fixed build and kernel cache directories inside the checkout, a
    flight recorder deep enough to hold every eval of a window, and one
    thread for each numeric library."""
    cache = os.path.join(root, ".bench_cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache, "torch_ext")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    os.environ["USE_FLAX"] = "0"
    os.environ["NOMAD_TPU_TRACE_DEPTH"] = "1000000"
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS",
                "OPENBLAS_NUM_THREADS"):
        os.environ[var] = "1"       # one process, few threads: steadier


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules
                   if m.split(".")[0] in FORBIDDEN})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", default="", choices=("", "bf16"))
    args = ap.parse_args(argv)
    cache_env(ROOT)
    sys.path[0] = ROOT          # the checkout, not this script's folder
    from benchmark import harness
    spec = harness.load_spec(ROOT)
    cell = harness.workload(spec, args.workload)
    import torch
    torch.set_num_threads(1)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        print(f"no CUDA device for {args.workload} (needs {cell['chips']})",
              file=sys.stderr)
        return 2
    result = harness.run_cell(ROOT, spec, cell, args.seed, args.seconds,
                              args.trace, device="cuda", t0=T0,
                              control=args.control)
    bad = forbidden_modules()
    if bad:
        print(f"the run loaded {bad}", file=sys.stderr)
        return 3
    harness.emit(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
