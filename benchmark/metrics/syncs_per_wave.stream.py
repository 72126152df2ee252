"""syncs_per_wave.stream: the times the wave loop waited for the card
over its waves, from the program's counters (`solver.syncs` over
`solver.waves` in its metrics registry, folded once a dispatch) over the
whole run; nothing where the program keeps no such counters."""


def read(out):
    from nomad_tpu_torch.utils.metrics import global_metrics
    counters = global_metrics.dump()["counters"]
    waves, syncs = counters.get("solver.waves"), counters.get("solver.syncs")
    if not waves or syncs is None:
        return None
    return syncs / waves
