"""waves_per_solve.constrained: the wave loop's waves over its solves,
from the program's counters (`solver.waves` over `solver.solves` in its
metrics registry, folded once a dispatch) over the whole run; nothing
where the program keeps no such counters."""


def read(out):
    from nomad_tpu_torch.utils.metrics import global_metrics
    counters = global_metrics.dump()["counters"]
    solves, waves = counters.get("solver.solves"), counters.get(
        "solver.waves")
    if not solves or waves is None:
        return None
    return waves / solves
