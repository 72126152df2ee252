"""The reference agrees with the port's CPU path: the wave solve on
packed planes, and both cells end to end at test size."""
import dataclasses

import numpy as np
import pytest

from benchmark import gen, port
from benchmark.reference import solver as ref_solver
from benchmark.tests import _small


def packed(workload, nodes, evals, residents):
    """The port's packed batch of `evals` jobs of the cell's
    configuration on `nodes` nodes, usage seeded from the residents."""
    from nomad_tpu_torch.solver.tensorize import Tensorizer
    _c, cfg, _m, _l = _small.small(workload, nodes=nodes)
    cfg["resident"]["allocs"] = residents
    cl = gen.cluster(cfg, 5)
    maker = port.JobMaker(gen.job(cfg, "x"))
    asks = sum((port.asks(maker.make(f"j{e}")) for e in range(evals)), [])
    pb = Tensorizer().pack(port.nodes(cl), asks)
    pb.used0[:nodes, :4] = cl.resident_usage()
    return pb


@pytest.mark.parametrize("workload,nodes,evals", [
    ("c3-server-burst", 300, 6), ("c3-server-burst", 1100, 3),
    ("c2-stream", 700, 8)])
@pytest.mark.parametrize("seed", [0, 977])
def test_reference_solve_equals_the_port_twin(workload, nodes, evals, seed):
    from nomad_tpu_torch.solver.host import host_solve_kernel
    from nomad_tpu_torch.solver.solve import _plane_args
    pb = packed(workload, nodes, evals, residents=nodes * 9)
    has_spread = bool((pb.sp_col[:, 0] >= 0).any())
    twin = host_solve_kernel(*_plane_args(pb), pb.n_place, seed,
                             has_spread=has_spread)
    planes = {f.name: getattr(pb, f.name) for f in dataclasses.fields(pb)
              if isinstance(getattr(pb, f.name), np.ndarray)}
    ref = ref_solver.solve(planes, pb.n_place, seed, has_spread=has_spread)
    n = pb.n_place
    assert np.array_equal(ref.choice[:n], twin.choice[:n, 0])
    assert np.array_equal(ref.ok[:n], twin.choice_ok[:n, 0])
    assert np.array_equal(ref.score[:n], twin.score[:n, 0])
    assert np.array_equal(ref.used, twin.used_final)
    assert ref.waves == int(twin.n_waves)


@pytest.mark.parametrize("workload", ["c2-stream", "c3-server-burst"])
def test_the_cell_is_correct_on_the_cpu(workload):
    r = _small.run(workload, seconds=2.0)
    assert r["correct"], r["checks"]
    assert r["attempted"] > 0
    assert set(r["checks"]) == set(_small.small(workload)[3])
