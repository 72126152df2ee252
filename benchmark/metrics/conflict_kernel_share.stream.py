"""conflict_kernel_share.stream: the share of the wave loop's waves whose
same-wave conflict check and commits ran on the node-segmented CUDA
kernels, from the program's counters (`solver.waves_conflict_kernel`
over `solver.waves` in its metrics registry, folded once a dispatch)
over the whole run, in %; nothing where the program keeps no such
counter."""


def read(out):
    from nomad_tpu_torch.utils.metrics import global_metrics
    counters = global_metrics.dump()["counters"]
    waves = counters.get("solver.waves")
    seg = counters.get("solver.waves_conflict_kernel")
    if not waves or seg is None:
        return None
    return 100.0 * seg / waves
