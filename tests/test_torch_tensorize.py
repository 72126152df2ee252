"""The port's packer (`nomad_tpu_torch.solver.tensorize`) against the JAX
package's: identically built clusters and asks, one built from each
package's mock and structs, must pack plane for plane the same (only
the node ids, fresh uuids, differ)."""
import copy
import dataclasses

import numpy as np
import pytest
import torch

from nomad_tpu import mock as ref_mock
from nomad_tpu import structs as ref_structs
from nomad_tpu.solver import tensorize as ref_tz
from nomad_tpu_torch import mock as port_mock
from nomad_tpu_torch import structs as port_structs
from nomad_tpu_torch.solver import tensorize as port_tz

PKGS = {"ref": (ref_mock, ref_structs, ref_tz),
        "port": (port_mock, port_structs, port_tz)}


def build(pkg, style, n_nodes=40, count=6, with_allocs=False):
    """One scheduling problem from `pkg`'s own mock/structs/tensorizer
    (the same builder code for both packages)."""
    mock, st, tz = PKGS[pkg]
    nodes = []
    for i in range(n_nodes):
        nd = mock.node(datacenter=f"dc{i % 3}")
        nd.attributes["rack"] = f"r{i % 7}"
        nd.attributes["zone"] = f"z{i % 4}"
        nd.attributes["os.version"] = f"1.{i % 5}.0"
        nd.node_resources.cpu = 4000 + (i % 8) * 1000
        nd.node_resources.memory_mb = 8192 + (i % 4) * 4096
        if style == "devices" and i % 2 == 0:
            nd.node_resources.devices = [st.NodeDeviceResource(
                vendor="google", type="tpu", name="v4",
                instances=[st.NodeDevice(id=f"tpu-{i}-{k}",
                                         healthy=k != 3)
                           for k in range(4)])]
        nd.compute_class()
        nodes.append(nd)
    job = mock.job()
    job.id = f"job-{style}"
    job.datacenters = ["dc0", "dc1", "dc2"]
    job.constraints = []
    base = job.task_groups[0]
    tgs = []
    for g in range(3):
        tg = copy.deepcopy(base)
        tg.name = f"g{g}"
        tg.count = count
        t = tg.tasks[0]
        t.resources.cpu = 400 + g * 150
        t.resources.memory_mb = 256 + g * 128
        if style == "devices" and g == 0:
            t.resources.devices = [st.RequestedDevice(name="google/tpu/v4",
                                                      count=1)]
        if style == "distinct" and g > 0:
            tg.constraints = [st.Constraint("", "", "distinct_hosts")]
        tgs.append(tg)
    job.task_groups = tgs
    if style == "rich":
        job.constraints = [
            st.Constraint("${attr.rack}", "r6", "!="),
            st.Constraint("${attr.zone}", "z1", ">="),
            st.Constraint("${attr.os.version}", ">= 1.1.0", "version"),
            st.Constraint("${attr.rack}", "r[0-5]", "regexp")]
        job.affinities = [
            st.Affinity(ltarget="${attr.rack}", rtarget="r2", operand="=",
                        weight=35),
            st.Affinity(ltarget="${attr.os.version}", rtarget=">= 1.3.0",
                        operand="version", weight=-20)]
        job.spreads = [st.Spread(attribute="${node.datacenter}", weight=50)]
        tgs[1].spreads = [st.Spread(
            attribute="${attr.zone}", weight=25,
            spread_targets=[st.SpreadTarget(value="z2", percent=50),
                            st.SpreadTarget(value="z3", percent=25)])]
    asks = []
    for g, tg in enumerate(tgs):
        kw = {}
        if style == "rich" and g == 0:
            kw = dict(penalty_nodes=frozenset({nodes[1].id, nodes[5].id}),
                      existing_by_node={nodes[2].id: 2, nodes[9].id: 1},
                      spread_seed={"${node.datacenter}": {"dc1": 3}},
                      distinct_hosts_blocked=frozenset({nodes[4].id}))
        asks.append(tz.PlacementAsk(job=job, tg=tg, count=tg.count, **kw))
    allocs = None
    if with_allocs:
        allocs = {}
        for i, nd in enumerate(nodes[:12]):
            a = mock.alloc(node_id=nd.id)
            for tr in a.allocated_resources.tasks.values():
                tr.networks = []
            allocs[nd.id] = [a] * (1 + i % 3)
    return nodes, asks, allocs


def packed_pair(style, **kw):
    out = []
    for pkg in ("ref", "port"):
        nodes, asks, allocs = build(pkg, style, **kw)
        out.append(PKGS[pkg][2].Tensorizer().pack(nodes, asks, allocs))
    return out


META_FIELDS = ("n_real", "n_asks", "n_place", "attr_targets",
               "constraint_labels", "class_ids", "dc_ids",
               "dev_pattern_ids")


@pytest.mark.parametrize("style,kw", [
    ("binpack", {}),
    ("rich", {}),
    ("rich", {"with_allocs": True, "n_nodes": 70}),
    ("devices", {"with_allocs": True}),
    ("distinct", {"n_nodes": 24}),
])
def test_pack_matches_reference_plane_for_plane(style, kw):
    ref, port = packed_pair(style, **kw)
    for name in port_tz.ARRAY_FIELDS:
        r, p = getattr(ref, name), getattr(port, name)
        assert r.dtype == p.dtype, name
        np.testing.assert_array_equal(p, r, err_msg=name)
    for name in META_FIELDS:
        assert getattr(port, name) == getattr(ref, name), name
    assert ([rc._values for rc in port.rank_columns]
            == [rc._values for rc in ref.rank_columns])
    assert len(port.node_ids) == len(ref.node_ids)


def test_packed_from_numpy_carries_reference_batch():
    """The reference batch's fields, as numpy arrays, become the port's
    batch on a device with every plane and dtype intact."""
    ref, _ = packed_pair("rich", with_allocs=True)
    arrays = {f.name: getattr(ref, f.name) for f in dataclasses.fields(ref)}
    pb = port_tz.packed_from_numpy(arrays, "cpu")
    for name in port_tz.ARRAY_FIELDS:
        t = getattr(pb, name)
        assert isinstance(t, torch.Tensor) and t.device.type == "cpu"
        np.testing.assert_array_equal(t.numpy(), getattr(ref, name))
    assert pb.n_place == ref.n_place and pb.node_ids == ref.node_ids
