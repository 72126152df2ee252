"""Nothing the harness runs loads JAX or the JAX package, and the
reference loads nothing of the port (top-level names compared whole:
the port's name begins with the JAX package's)."""
import ast
import glob
import os
import subprocess
import sys

from benchmark.tests import _small

FORBIDDEN = {"jax", "jaxlib", "flax", "nomad_tpu"}
BENCH = os.path.join(_small.ROOT, "benchmark")


def imported_tops(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0], 0
        elif isinstance(node, ast.ImportFrom):
            yield (node.module or "").split(".")[0], node.level


def loaded_after(code):
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys\nprint(sorted({m.split"
         "('.')[0] for m in sys.modules}))"],
        cwd=_small.ROOT, capture_output=True, text=True, check=True,
        env=dict(os.environ, PYTHONPATH=_small.ROOT))
    return set(eval(out.stdout.strip().splitlines()[-1]))


def test_no_source_of_the_benchmark_imports_jax():
    for path in glob.glob(os.path.join(BENCH, "**", "*.py"),
                          recursive=True):
        for top, _level in imported_tops(path):
            assert top not in FORBIDDEN, path


def test_a_run_loads_no_jax():
    loaded = loaded_after(
        "import benchmark.run, benchmark.harness, benchmark.port\n"
        "import benchmark.drivers.stream, benchmark.drivers.server\n"
        "from benchmark import harness\n"
        "spec = harness.load_spec('.')\n"
        "[harness.reader(m['name']) for m in spec['per_layer']]\n"
        "import nomad_tpu_torch.server.server\n"
        "import nomad_tpu_torch.solver.resident\n")
    assert "nomad_tpu_torch" in loaded
    assert not loaded & FORBIDDEN


def test_the_reference_imports_nothing_of_the_port():
    for path in glob.glob(os.path.join(BENCH, "reference", "*.py")):
        for top, level in imported_tops(path):
            assert top not in FORBIDDEN | {"nomad_tpu_torch", "torch"}
            assert level <= 1, f"{path} reaches out of the reference"
    loaded = loaded_after("import benchmark.reference.solver\n"
                          "import benchmark.reference.stream\n"
                          "import benchmark.reference.server\n")
    assert not loaded & (FORBIDDEN | {"nomad_tpu_torch", "torch"})
