"""The port's system scheduler (`nomad_tpu_torch.scheduler.system`) and
its static-feasibility pass (`masks._feas_kernel` / `static_feasibility`)
against the JAX package's, on the CPU.

Each case of tests/test_system_sched.py is built by ONE function for
both packages (each package's own mock, structs and Harness) with fixed
node and job ids, and everything the scheduler wrote must be equal: the
allocs by name and node index (placements, stops, lost allocs, in-place
replacements), the plans, the evals with their `failed_tg_allocs`, and
the scores.  The feasibility words of the port's `_feas_kernel` must
equal the reference's bit for bit on random packed batches, the node
axis a multiple of 32 or not, and the numpy pack twins must agree."""
import dataclasses

import numpy as np
import pytest
import torch

from test_torch_generic_sched import Pkg, assert_same_schedule

from nomad_tpu.solver import masks as ref_masks
from nomad_tpu.solver import tensorize as ref_tz
from nomad_tpu_torch.solver import masks
from nomad_tpu_torch.solver.kernel import static_feas
from nomad_tpu_torch.solver.tensorize import packed_from_numpy


def setup(P, h, n=5):
    nodes = [P.node(i) for i in range(n)]
    for node in nodes:
        h.store.upsert_node(h.next_index(), node)
    return nodes


def register(P, h, job, trigger=None):
    h.store.upsert_job(h.next_index(), job)
    return P.mock.eval_(job_id=job.id, type="system",
                        triggered_by=trigger
                        or P.st.EVAL_TRIGGER_JOB_REGISTER)


def running(P, h, job_id):
    """Mark the job's allocs running one by one, in node order (alloc
    ids are fresh uuids; the write order sets each modify index)."""
    for a in sorted(h.store.allocs_by_job("default", job_id),
                    key=lambda a: a.node_id):
        a.client_status = P.st.ALLOC_CLIENT_RUNNING
        h.store.upsert_allocs(h.next_index(), [a])


# ---------------------------------------------------------------- scenarios
# tests/test_system_sched.py, one per test; each returns (harness, nodes,
# job id)

def sc_runs_on_every_node(P):
    h = P.harness()
    nodes = setup(P, h, 5)
    job = P.mock.system_job(id="sys-every")
    h.process("system", register(P, h, job))
    return h, nodes, job.id


def sc_skips_infeasible_nodes(P):
    h = P.harness()
    nodes = setup(P, h, 4)
    for n in nodes[:2]:
        n.attributes["kernel.name"] = "windows"
        n.compute_class()
        h.store.upsert_node(h.next_index(), n)
    job = P.mock.system_job(id="sys-infeasible")   # kernel.name = linux
    h.process("system", register(P, h, job))
    return h, nodes, job.id


def sc_new_node_gets_alloc(P):
    h = P.harness()
    nodes = setup(P, h, 2)
    job = P.mock.system_job(id="sys-new-node")
    h.process("system", register(P, h, job))
    new_node = P.node(2)
    h.store.upsert_node(h.next_index(), new_node)
    nodes.append(new_node)
    h.process("system", P.mock.eval_(
        job_id=job.id, type="system",
        triggered_by=P.st.EVAL_TRIGGER_NODE_UPDATE))
    return h, nodes, job.id


def sc_node_down_marks_lost(P):
    h = P.harness()
    nodes = setup(P, h, 3)
    job = P.mock.system_job(id="sys-node-down")
    h.process("system", register(P, h, job))
    running(P, h, job.id)
    h.store.update_node_status(h.next_index(), nodes[0].id,
                               P.st.NODE_STATUS_DOWN)
    h.process("system", P.mock.eval_(
        job_id=job.id, type="system",
        triggered_by=P.st.EVAL_TRIGGER_NODE_UPDATE))
    return h, nodes, job.id


def sc_deregister_stops_all(P):
    h = P.harness()
    nodes = setup(P, h, 3)
    job = P.mock.system_job(id="sys-dereg")
    h.process("system", register(P, h, job))
    job2 = P.mock.system_job(id=job.id)
    job2.stop = True
    h.store.upsert_job(h.next_index(), job2)
    h.process("system", P.mock.eval_(
        job_id=job.id, type="system",
        triggered_by=P.st.EVAL_TRIGGER_JOB_DEREGISTER))
    return h, nodes, job.id


def sc_update_replaces_in_place(P):
    h = P.harness()
    nodes = setup(P, h, 3)
    job = P.mock.system_job(id="sys-update")
    h.process("system", register(P, h, job))
    running(P, h, job.id)
    job2 = P.mock.system_job(id=job.id)
    job2.task_groups[0].tasks[0].config = {"command": "/bin/other"}
    h.process("system", register(P, h, job2))
    return h, nodes, job.id


def sc_drain_stops_allocs(P):
    h = P.harness()
    nodes = setup(P, h, 2)
    job = P.mock.system_job(id="sys-drain")
    h.process("system", register(P, h, job))
    running(P, h, job.id)
    h.store.update_node_drain(h.next_index(), nodes[0].id,
                              P.st.DrainStrategy(), False)
    h.process("system", P.mock.eval_(
        job_id=job.id, type="system",
        triggered_by=P.st.EVAL_TRIGGER_NODE_DRAIN))
    target = [a for a in h.store.allocs_by_job("default", job.id)
              if a.node_id == nodes[0].id][0]
    h.store.update_alloc_desired_transition(
        h.next_index(), [target.id], P.st.DesiredTransition(migrate=True))
    h.process("system", P.mock.eval_(
        job_id=job.id, type="system",
        triggered_by=P.st.EVAL_TRIGGER_NODE_DRAIN))
    return h, nodes, job.id


def sc_update_failure_keeps_old_alloc(P):
    h = P.harness()
    n = P.node(0)
    n.node_resources.cpu = 700
    n.node_resources.memory_mb = 400
    n.reserved_resources.cpu = 100
    n.reserved_resources.memory_mb = 0
    n.compute_class()
    h.store.upsert_node(h.next_index(), n)
    job = P.mock.system_job(id="sys-update-fail")
    h.process("system", register(P, h, job))
    allocs = h.store.allocs_by_job("default", job.id)
    allocs[0].client_status = P.st.ALLOC_CLIENT_RUNNING
    h.store.upsert_allocs(h.next_index(), allocs)
    job2 = P.mock.system_job(id=job.id)
    job2.task_groups[0].tasks[0].resources.cpu = 900
    h.process("system", register(P, h, job2))
    return h, [n], job.id


SCENARIOS = {
    "runs_on_every_node": sc_runs_on_every_node,
    "skips_infeasible_nodes": sc_skips_infeasible_nodes,
    "new_node_gets_alloc": sc_new_node_gets_alloc,
    "node_down_marks_lost": sc_node_down_marks_lost,
    "deregister_stops_all": sc_deregister_stops_all,
    "update_replaces_in_place": sc_update_replaces_in_place,
    "drain_stops_allocs": sc_drain_stops_allocs,
    "update_failure_keeps_old_alloc": sc_update_failure_keeps_old_alloc,
}

#: what each scenario must show beyond equality with the reference:
#: live allocs of the job, lost allocs, and whether the last eval
#: recorded a failed group
EXPECT = {
    "runs_on_every_node": (5, 0, False),
    "skips_infeasible_nodes": (2, 0, True),
    "new_node_gets_alloc": (3, 0, False),
    "node_down_marks_lost": (2, 1, False),
    "deregister_stops_all": (0, 0, False),
    "update_replaces_in_place": (3, 0, False),
    "drain_stops_allocs": (1, 0, False),
    "update_failure_keeps_old_alloc": (1, 0, True),
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_system_scenario_matches_reference(name):
    got = assert_same_schedule(SCENARIOS[name])
    live = [a for a in got["allocs"]
            if a[3] == "run" and a[5] not in ("lost", "complete", "failed")]
    lost = [a for a in got["allocs"] if a[5] == "lost"]
    n_live, n_lost, failed = EXPECT[name]
    assert (len(live), len(lost)) == (n_live, n_lost), got["allocs"]
    assert bool(got["evals"][-1][6]) == failed
    assert all(e[0] == "complete" for e in got["evals"])


# ------------------------------------------------------ static feasibility
FEAS_ARGS = ("valid", "node_dc", "attr_rank", "dc_ok", "host_ok", "c_op",
             "c_col", "c_rank")


def random_feas_args(seed, Gp, Np, A=5, C=4, D=3):
    """Random static-feasibility planes in the packer's dtypes: value
    ranks -1..5 (-1 missing), every constraint op (0..8), ranks -1..5."""
    rng = np.random.default_rng(seed)
    return {
        "valid": rng.random(Np) < 0.9,
        "node_dc": rng.integers(0, D, Np).astype(np.int32),
        "attr_rank": rng.integers(-1, 6, (Np, A)).astype(np.int16),
        "dc_ok": rng.random((Gp, D)) < 0.8,
        "host_ok": rng.random((Gp, Np)) < 0.9,
        "c_op": rng.integers(0, 9, (Gp, C)).astype(np.int32),
        "c_col": rng.integers(0, A, (Gp, C)).astype(np.int32),
        "c_rank": rng.integers(-1, 6, (Gp, C)).astype(np.int32),
    }


def ref_words(arrays):
    import jax.numpy as jnp
    return np.asarray(ref_masks._feas_kernel(
        *(jnp.asarray(arrays[k]) for k in FEAS_ARGS)))


@pytest.mark.parametrize("seed,Gp,Np", [(0, 4, 64), (1, 3, 37),
                                        (2, 8, 1000), (3, 1, 32),
                                        (4, 2, 5)])
def test_feas_kernel_words_match_reference(seed, Gp, Np):
    arrays = random_feas_args(seed, Gp, Np)
    words = masks._feas_kernel(*(torch.as_tensor(arrays[k])
                                 for k in FEAS_ARGS))
    assert words.dtype == torch.int32
    assert words.shape == (Gp, -(-Np // 32))
    want = ref_words(arrays)
    np.testing.assert_array_equal(words.numpy().view(np.uint32), want)
    # the mask is the wave solve's own static feasibility
    feas, _ = static_feas(*(torch.as_tensor(arrays[k]) for k in FEAS_ARGS))
    np.testing.assert_array_equal(
        masks.np_unpack_bool_u32(words.numpy(), Np), feas.numpy())


@pytest.mark.parametrize("style", ["rich", "constrained"])
def test_static_feasibility_matches_reference(style):
    """`static_feasibility` on a real packed batch (the reference's
    pack, moved through packed_from_numpy) against the reference's."""
    from test_host_solver import make_asks, make_nodes
    if style == "rich":
        from test_torch_tensorize import build
        nodes, asks, _ = build("ref", "rich", n_nodes=45)
    else:
        nodes, asks = make_nodes(60), make_asks("constrained", count=6)
    pb = ref_tz.Tensorizer().pack(nodes, asks)
    want = ref_masks.static_feasibility(pb)
    arrays = {f.name: getattr(pb, f.name) for f in dataclasses.fields(pb)}
    got = masks.static_feasibility(packed_from_numpy(arrays, "cpu"), "cpu")
    np.testing.assert_array_equal(got, want)
    assert got.shape == (pb.host_ok.shape[0], pb.valid.shape[0])
    assert want.any() and not want.all()
    # numpy planes go straight in as well
    np.testing.assert_array_equal(masks.static_feasibility(pb, "cpu"), want)


@pytest.mark.parametrize("shape", [(3, 64), (5, 37), (2, 3, 100), (1, 1)])
def test_np_pack_twins_match_reference(shape):
    rng = np.random.default_rng(sum(shape))
    mask = rng.random(shape) < 0.5
    words = masks.np_pack_bool_u32(mask)
    want = ref_masks.np_pack_bool_u32(mask)
    assert words.dtype == want.dtype == np.uint32
    np.testing.assert_array_equal(words, want)
    np.testing.assert_array_equal(
        masks.np_unpack_bool_u32(words, shape[-1]),
        ref_masks.np_unpack_bool_u32(want, shape[-1]))
    np.testing.assert_array_equal(
        masks.np_unpack_bool_u32(words, shape[-1]), mask)
    # the int32 words of pack_bool_u32 unpack the same
    tw = masks.pack_bool_u32(torch.as_tensor(mask)).numpy()
    np.testing.assert_array_equal(
        masks.np_unpack_bool_u32(tw, shape[-1]), mask)


def test_system_scheduler_uses_feas_kernel(monkeypatch):
    """The system eval's feasibility comes from one `_feas_kernel` call
    on the solver's device over the eval's packed batch."""
    calls = []
    real = masks._feas_kernel

    def spy(*args):
        calls.append(tuple(a.device.type for a in args))
        return real(*args)
    monkeypatch.setattr(masks, "_feas_kernel", spy)
    P = Pkg("port")
    h, nodes, jid = sc_skips_infeasible_nodes(P)
    assert calls == [("cpu",) * 8]
    assert len(h.store.allocs_by_job("default", jid)) == 2
