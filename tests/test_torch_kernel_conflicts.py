"""The reference's tests/test_kernel_conflicts.py on both packages: the
same-wave conflict rule (the matmul and the sort implementations agree),
spread placements on nodes missing the attribute, the fused wave under
both conflict implementations in both modes, distinct hosts on the sort
path.

Each reference case runs once on the JAX package and once on the port
(`pkg` = "ref" / "port"; tests/torch_twin.py).  The port's copy solves
on the CPU through the torch wave loop: `_run_kernel(pb, "cpu",
host_mode="never")` (the reference's `_run_kernel(pb)`; the port's host
route would otherwise take these small problems), and has no JAX cache
to clear.
"""
import jax
import pytest

from nomad_tpu.solver import kernel as ref_kernel
from nomad_tpu_torch.solver import kernel as port_kernel
from tests.torch_twin import pin_port_to_cpu, twin_cases  # noqa: F401


def _port_source(src):
    src = src.replace("import jax\n", "")
    src = src.replace("jax.clear_caches()", "None")
    return src.replace("_run_kernel(pb)",
                       '_run_kernel(pb, "cpu", host_mode="never")')


@pytest.fixture
def both_paths():
    """The reference's fixture, for both packages: the conflict rule
    back to its default after the case."""
    yield
    ref_kernel._FORCE_SORT_CONFLICTS = False
    port_kernel._FORCE_SORT_CONFLICTS = False
    jax.clear_caches()


globals().update(twin_cases("tests.test_kernel_conflicts",
                            transform=_port_source))
