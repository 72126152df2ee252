"""wave_graph_share.stream: the share of the wave loop's waves whose
body replayed a CUDA graph, from the program's counters
(`solver.waves_graphed` over `solver.waves` in its metrics registry,
folded once a dispatch) over the whole run, in %; nothing where the
program keeps no such counter."""


def read(out):
    from nomad_tpu_torch.utils.metrics import global_metrics
    counters = global_metrics.dump()["counters"]
    waves = counters.get("solver.waves")
    graphed = counters.get("solver.waves_graphed")
    if not waves or graphed is None:
        return None
    return 100.0 * graphed / waves
