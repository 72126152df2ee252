"""The reference's tests/test_plan_pipeline.py on both packages: the
pipelined plan applier (the overlay snapshot that catches a double
booking, consensus overlap, a singleton plan, an apply that already
landed).

Each reference case runs once on the JAX package and once on the port
(`pkg` = "ref" / "port"; tests/torch_twin.py).  The microbenchmark case
(`test_applier_microbench_shows_speedup`) times the reference's applier
against a wall-clock bar and is not part of the comparison.
"""
import pytest

from tests.torch_twin import (pin_port_to_cpu, port_module,  # noqa: F401
                              twin_cases)

_MODULES = port_module("tests.test_plan_pipeline")

globals().update(twin_cases(
    "tests.test_plan_pipeline",
    exclude=("test_applier_microbench_shows_speedup",),
    modules=_MODULES))


@pytest.mark.parametrize("pkg", ["ref", "port"])
def test_overlay_catches_double_booking_three_plans(pkg):
    """Plans A, B and C (600 MHz each) are queued back to back for one
    1,000 MHz node while each apply takes 80 ms: C is evaluated against
    B's overlay only, so A must have landed in the store by then.  Only
    A commits, and the node never holds two of them."""
    m = _MODULES[0] if pkg == "ref" else _MODULES[1]
    store, nodes = m.small_cluster(n=1, cpu=1000)
    slow = m._SlowApply(store, latency_s=0.08)
    queue = m.PlanQueue()
    queue.set_enabled(True)
    applier = m.PlanApplier(queue, store, None, None,
                            apply_async_fn=slow.async_fn)
    # all three are queued before the loop takes the first
    pendings = [queue.enqueue(m.plan_with(m.mock.job(), nodes[0], cpu=600))
                for _ in range(3)]
    applier.start()
    try:
        results = []
        for p in pendings:
            result, err = p.future.wait(10.0)
            assert err is None
            results.append(result)
        placed = [sum(len(v) for v in r.node_allocation.values())
                  for r in results]
        assert placed == [1, 0, 0]
        assert results[1].refresh_index and results[2].refresh_index
        live = [a for a in store.allocs_by_node(nodes[0].id)
                if not a.terminal_status()]
        assert len(live) == 1
    finally:
        applier.stop()
        queue.set_enabled(False)
