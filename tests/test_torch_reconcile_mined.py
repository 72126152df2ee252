"""The reference's tests/test_reconcile_mined.py on both packages: the
reconciler's mined cases (canaries, deployments, reschedules,
disconnects).

Each reference case runs once on the JAX package and once on the port
(`pkg` = "ref" / "port"; tests/torch_twin.py), with the port's default
solver device pinned to the CPU.
"""
from tests.torch_twin import pin_port_to_cpu, twin_cases  # noqa: F401

globals().update(twin_cases("tests.test_reconcile_mined"))
