"""The seeded inputs: the same seed gives the same data; every seed gives
the same sizes in another order."""
import numpy as np
import pytest

from benchmark import gen
from benchmark.tests import _small


@pytest.mark.parametrize("workload", ["c3-server-burst", "c2-stream"])
@pytest.mark.parametrize("seed", [0, 7, 2**31 + 3, 3 * 2**31 - 1])
def test_cluster_is_a_function_of_the_seed(workload, seed):
    _c, cfg, _m, _l = _small.small(workload, nodes=300)
    a, b = gen.cluster(cfg, seed), gen.cluster(cfg, seed)
    assert [n.id for n in a.nodes] == [n.id for n in b.nodes]
    assert np.array_equal(a.capacity(), b.capacity())
    assert np.array_equal(a.resident_usage(), b.resident_usage())
    other = gen.cluster(cfg, seed + 1)
    assert [n.id for n in a.nodes] != [n.id for n in other.nodes]
    key = lambda c: sorted((n.datacenter, n.rack, n.zone, tuple(n.cap))
                           for n in c.nodes)
    assert key(a) == key(other)
    assert a.resident_usage().sum() == other.resident_usage().sum()


def test_tie_seeds_are_nonzero_31_bit_and_repeat():
    s = gen.tie_seeds(2**31 + 5, "pass0", 64)
    assert s == gen.tie_seeds(2**31 + 5, "pass0", 64)
    assert s != gen.tie_seeds(2**31 + 5, "pass1", 64)
    assert all(0 < x < 2**31 for x in s)


def test_job_is_the_configuration_s():
    _c, cfg, _m, _l = _small.small("c3-server-burst")
    j = gen.job(cfg, "x")
    assert [g.count for g in j.groups] == [16, 16, 16, 16]
    assert [int(g.ask[0]) for g in j.groups] == [400, 550, 700, 850]
    assert j.constraints and j.affinities and j.spreads
