"""A merged multi-job batch at the 12-wave budget, the port against the
JAX package on the CPU.

The kind of batch a fused fleet round solves: many config-3 jobs
(bench.py `make_job`: two constraints, a rack affinity, a datacenter
spread, 4 groups) merged into one solve over a cluster that already
holds resident allocs.  At this size a good share of the placements is
still undecided when the wave budget (`MAX_WAVES` = 12) runs out and
comes back retryable.  Both packages solve the same packed batch (the
reference's `Tensorizer.pack`, handed to the port through
`packed_from_numpy`) with the same fused-wave mode, and every choice,
the `unfinished` flags, `n_waves` and the explainability counters must
be equal — so the port leaves exactly the reference's share to a retry.
"""
import numpy as np
import pytest

import chip_smoke
from test_torch_solver import assert_identical, port_solve

from nomad_tpu import mock as ref_mock
from nomad_tpu import structs as ref_structs
from nomad_tpu.solver.kernel import MAX_WAVES
from nomad_tpu.solver.kernel import solve_kernel as ref_solve_kernel
from nomad_tpu.solver.solve import _kernel_args as ref_kernel_args
from nomad_tpu.solver.tensorize import PlacementAsk, Tensorizer
from nomad_tpu.structs import (AllocatedResources, AllocatedSharedResources,
                               AllocatedTaskResources)


def merged_batch(n_nodes, n_jobs, per_node):
    """bench.py's config-3 cluster cut to `n_nodes` nodes, `per_node`
    resident allocs on each (chip_smoke.R_VEC), and `n_jobs` config-3
    jobs of 64 placements merged into one packed batch."""
    nodes = chip_smoke.make_nodes(ref_mock, n_nodes)
    res_job = ref_mock.job()
    res_job.id = "resident"
    by_node = {}
    cpu, mem, disk = chip_smoke.R_VEC
    for k in range(n_nodes * per_node):
        nd = nodes[k % n_nodes]
        a = ref_mock.alloc(job=res_job, node_id=nd.id)
        a.allocated_resources = AllocatedResources(
            tasks={"web": AllocatedTaskResources(cpu=cpu, memory_mb=mem)},
            shared=AllocatedSharedResources(disk_mb=disk))
        by_node.setdefault(nd.id, []).append(a)
    jobs = [chip_smoke.make_job(ref_mock, ref_structs, e, chip_smoke.COUNT)
            for e in range(n_jobs)]
    asks = [PlacementAsk(job=j, tg=tg, count=tg.count)
            for j in jobs for tg in j.task_groups]
    return Tensorizer().pack(nodes, asks, by_node)


@pytest.mark.parametrize("n_nodes,n_jobs,per_node,mode", [
    (512, 16, 5, "score"),
    (512, 32, 10, "score"),
    (1024, 32, 10, "off"),
])
def test_merged_batch_retry_share_matches_reference(n_nodes, n_jobs,
                                                    per_node, mode):
    assert MAX_WAVES == 12
    pb = merged_batch(n_nodes, n_jobs, per_node)
    assert pb.n_place == n_jobs * chip_smoke.COUNT
    kw = dict(has_spread=True, has_distinct=False, pallas_mode=mode)
    res = port_solve(pb, 0, **kw)
    ref = ref_solve_kernel(*ref_kernel_args(pb), 0, **kw)
    assert_identical(res, ref)
    # the budget ran out with placements undecided, in both packages
    assert res.n_waves == MAX_WAVES
    unfinished = int(res.unfinished.sum())
    assert unfinished == int(np.asarray(ref.unfinished).sum()) > 0
    assert unfinished < pb.n_place
