"""The fused wave CUDA kernel against its plain torch version, on the
card.  These tests import neither JAX nor the JAX package, so they also
run where only the port is installed:

    python -m pytest --noconftest -p no:cacheprovider \\
        tests/test_torch_wave_kernel_gpu.py

Without a GPU they skip (the kernel has no CPU or interpret mode).  The
input builders here are shared with test_torch_wave_kernel.py, which holds
the plain version against the JAX package's Pallas kernel."""
import numpy as np
import pytest
import torch

from nomad_tpu_torch.solver import wave_kernel as wk


def make_inputs(seed, Gp, Np, S=1, V=4, D=0, blocked=False, wave_seed=3,
                R=4, ties=False, dead=None, rare=False):
    """Numpy inputs for one wave at realistic magnitudes.  The edge
    switches (their draws come after the default ones, so the default
    cases keep their inputs):

      R     resource dimensions, 2..8 (the first four are cpu, memory,
            disk and a 1000-wide one; more are narrow and often full);
      ties  every node has the same capacity and usage, and no affinity,
            collocation or reservation: with wave_seed=0 most scores tie
            and the column order decides;
      dead  (lo, hi): no node in columns lo..hi-1 is feasible;
      rare  spread value 0 never occurs and value 1 on three nodes of a
            row, so one class table has no entry and one fewer than its
            width."""
    x = _make_inputs(seed, Gp, Np, S, V, D, blocked, wave_seed)
    rng = np.random.default_rng(seed + 1000)
    f32 = np.float32
    if R != 4:
        extra = max(0, R - 4)
        x["used"] = np.concatenate(
            [x["used"][:, :R], rng.integers(0, 6, (Np, extra)) * f32(10)],
            1).astype(f32)
        x["avail"] = np.concatenate(
            [x["avail"][:, :R], np.full((Np, extra), 45, f32)], 1)
        x["reserved"] = np.concatenate(
            [x["reserved"][:, :R], np.zeros((Np, extra), f32)], 1)
        x["ask_res"] = np.concatenate(
            [x["ask_res"][:, :R], rng.integers(0, 2, (Gp, extra)) * f32(5)],
            1).astype(f32)
    if ties:
        for k in ("used", "reserved"):
            x[k] = np.zeros_like(x[k])
        x["avail"] = np.broadcast_to(x["avail"][:1], x["avail"].shape).copy()
        for k in ("aff", "coll"):
            x[k] = np.zeros_like(x[k])
    if dead is not None:
        x["feas"][:, dead[0]:dead[1]] = False
    if rare:
        vnode = x["spread"][0]
        vnode[...] = rng.choice(np.array([2, 3, -1], np.int16), vnode.shape)
        for row in vnode.reshape(-1, Np):
            row[rng.choice(Np, 3, replace=False)] = 1
    return x


def _make_inputs(seed, Gp, Np, S, V, D, blocked, wave_seed):
    rng = np.random.default_rng(seed)
    f32 = np.float32
    cap = np.stack([4000 + (np.arange(Np) % 8) * 1000,
                    8192 + (np.arange(Np) % 4) * 4096,
                    np.full(Np, 100_000), np.full(Np, 1000)], 1).astype(f32)
    used = (rng.integers(0, 30, Np)[:, None]
            * np.array([200, 256, 300, 0])).astype(f32)
    ask = np.stack([400 + (np.arange(Gp) % 4) * 150,
                    256 + (np.arange(Gp) % 4) * 128,
                    np.full(Gp, 300), np.zeros(Gp)], 1).astype(f32)
    x = dict(
        feas=rng.random((Gp, Np)) < 0.85, pen=rng.random((Gp, Np)) < 0.1,
        blocked=(rng.random((Gp, Np)) < 0.1) if blocked else None,
        aff=(rng.random((Gp, Np)) < 0.2).astype(f32) * f32(0.35),
        jitter=(rng.integers(0, 1024, (Gp, Np)).astype(f32)
                * f32(0.05 / 1023.0)) if wave_seed else
        np.zeros((Gp, Np), f32),
        coll=rng.integers(0, 3, (Gp, Np)).astype(f32)
        * (rng.random((Gp, Np)) < 0.2),
        used=used, avail=cap,
        reserved=rng.integers(0, 2, (Np, 4)).astype(f32) * f32(100),
        ask_res=ask, ask_desired=rng.integers(1, 20, Gp).astype(f32))
    if D:
        x["dev"] = (rng.integers(0, 4, (Np, D)).astype(f32),
                    np.full((Np, D), 4.0, f32),
                    (rng.random((Gp, D)) < 0.5).astype(f32))
    if S:
        vnode = rng.integers(-1, V, (S, Gp, Np))
        sp_used = rng.integers(0, 6, (Gp, S, V)).astype(f32)
        pres = sp_used > 0
        anyp = pres.any(2)
        x["spread"] = (
            vnode.astype(np.int16),
            np.where(vnode >= 0, rng.integers(0, 8, vnode.shape),
                     -1).astype(f32),
            sp_used, rng.uniform(0.2, 1.0, (Gp, S)).astype(f32),
            rng.random((Gp, S)) < 0.5,
            (rng.random((Gp, S)) < 0.9).astype(np.int8),
            np.where(anyp, np.where(pres, sp_used, np.inf).min(2),
                     0).astype(f32),
            np.where(anyp, sp_used.max(2), 0).astype(f32),
            anyp.astype(np.int8))
    x["seed"] = wave_seed
    return x


def port_kwargs(x, device="cpu"):
    from nomad_tpu_torch.solver.masks import pack_bool_u32

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a)).to(device)

    kw = {k: (t(v) if isinstance(v, np.ndarray) else v)
          for k, v in x.items() if k not in ("dev", "spread")}
    for k in ("feas", "pen", "blocked"):
        if kw[k] is not None:
            kw[k] = pack_bool_u32(kw[k])
    kw["dev"] = tuple(t(a) for a in x["dev"]) if "dev" in x else None
    kw["spread"] = (tuple(t(a) for a in x["spread"])
                    if "spread" in x else None)
    return kw


def assert_wave_same(got, want):
    for c in ("n_feas", "n_exh", "grp_any", "dim_exh"):
        np.testing.assert_array_equal(np.asarray(got[c]), want[c], c)
    for s_key, i_key in (("score", None), ("top_score", "top_idx"),
                         ("tab_s", "tab_i")):
        if s_key not in want:
            assert s_key not in got
            continue
        gs = np.asarray(got[s_key])
        assert gs.shape == want[s_key].shape, s_key
        np.testing.assert_array_max_ulp(gs, want[s_key], maxulp=4)
        if i_key is not None:
            np.testing.assert_array_equal(np.asarray(got[i_key]),
                                          want[i_key], i_key)


CASES = [
    # name, shape kwargs, call kwargs
    ("score-single-tile", dict(Gp=8, Np=64), dict(mode="score", TK=20)),
    ("score-multi-tile-dev-blocked",
     dict(Gp=256, Np=2048, D=2, blocked=True), dict(mode="score", TK=36)),
    ("topk-single-tile", dict(Gp=8, Np=64, S=0),
     dict(mode="topk", TK=20)),
    ("topk-extract-wider", dict(Gp=8, Np=256, D=1),
     dict(mode="topk", TK=36, n_extract=128)),
    ("topk-tables-multi-tile",
     dict(Gp=256, Np=2048, V=4, blocked=True),
     dict(mode="topk", TK=36, n_extract=128, tables_v=4)),
    ("topk-tables-unseeded", dict(Gp=4, Np=128, V=8, wave_seed=0),
     dict(mode="topk", TK=36, tables_v=8)),
    # edges of the rank selection and the merge
    ("topk-mass-ties", dict(Gp=4, Np=1024, wave_seed=0, ties=True),
     dict(mode="topk", TK=36, n_extract=128, tables_v=4)),
    ("topk-dead-tile", dict(Gp=4, Np=1024, dead=(256, 512)),
     dict(mode="topk", TK=36, n_extract=128, tables_v=4)),
    ("topk-ties-dead-tile",
     dict(Gp=2, Np=768, wave_seed=0, ties=True, dead=(0, 256)),
     dict(mode="topk", TK=36, n_extract=300, tables_v=4)),
    ("topk-rare-classes", dict(Gp=4, Np=1024, rare=True),
     dict(mode="topk", TK=60, n_extract=64, tables_v=4)),
    ("topk-extract-wider-than-tile", dict(Gp=2, Np=1024, D=1),
     dict(mode="topk", TK=36, n_extract=384)),
    ("topk-np64", dict(Gp=3, Np=64),
     dict(mode="topk", TK=36, n_extract=128, tables_v=4)),
    ("topk-np96-ragged", dict(Gp=3, Np=96, blocked=True),
     dict(mode="topk", TK=36, n_extract=64, tables_v=4)),
    ("score-np96-ragged", dict(Gp=5, Np=96, D=1, blocked=True),
     dict(mode="score", TK=36)),
    ("score-r2", dict(Gp=16, Np=1024, R=2), dict(mode="score", TK=36)),
    ("score-r8", dict(Gp=16, Np=1024, R=8, D=1),
     dict(mode="score", TK=36)),
]


@pytest.mark.cuda
@pytest.mark.parametrize("name,shape,call", CASES,
                         ids=[c[0] for c in CASES])
def test_kernel_matches_plain_on_gpu(name, shape, call):
    """The CUDA kernel against its plain version on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU "
                    "or interpret mode)")
    x = make_inputs(len(name), **shape)
    kw = port_kwargs(x, "cuda")
    before = wk.fused_wave.launches
    got = wk.fused_wave(**kw, **call)
    want = wk.fused_wave_plain(**kw, **call)
    torch.cuda.synchronize()
    assert wk.fused_wave.launches == before + 1
    assert_wave_same({k: v.cpu() for k, v in got.items()},
                     {k: v.cpu().numpy() for k, v in want.items()})


def overcommit_batch(seed, n_nodes=32):
    """tests/test_preempt_kernel.py's overcommitted world built with the
    port's own mock and packer (no JAX): nodes of 3,000-6,000 MHz mostly
    full of priority 5-45 allocs, and three jobs of priority 60/50/25
    that place only by evicting.  Returns the packed batch with its
    eviction planes (width 8) and the nodes' usage in `used0`."""
    from nomad_tpu_torch import mock
    from nomad_tpu_torch.solver.tensorize import (PlacementAsk, Tensorizer,
                                                  alloc_usage_vector)
    from nomad_tpu_torch.structs import Spread
    rng = np.random.default_rng(seed)
    nodes, abn = [], {}
    for i in range(n_nodes):
        n = mock.node(id=f"node-{i:03d}", datacenter=f"dc{i % 3}")
        n.node_resources.cpu = int(rng.choice([3000, 4000, 6000]))
        n.node_resources.memory_mb = 8192
        n.reserved_resources.cpu = 0
        n.reserved_resources.memory_mb = 0
        n.compute_class()
        nodes.append(n)
        lst = []
        for k in range(int(rng.integers(2, 6))):
            a = mock.alloc()
            a.id, a.node_id = f"low-{i}-{k}", n.id
            a.job.priority = int(rng.choice([5, 10, 20, 30, 45]))
            a.create_index = len(lst)
            tr = a.allocated_resources.tasks["web"]
            tr.cpu = int(rng.choice([400, 700, 900, 1200]))
            tr.memory_mb, tr.networks = 2 * tr.cpu, []
            a.allocated_resources.shared.networks = []
            a.allocated_resources.shared.disk_mb = 0
            lst.append(a)
        abn[n.id] = lst
    asks = []
    for g, prio in enumerate((60, 50, 25)):
        j = mock.job(id=f"hi-{g}", priority=prio)
        j.datacenters = ["dc0", "dc1", "dc2"]
        if g == 0:
            j.spreads = [Spread(attribute="${node.datacenter}", weight=100)]
        tg = j.task_groups[0]
        tg.count = int(rng.integers(4, 9))
        tg.tasks[0].resources.networks = []
        tg.tasks[0].resources.cpu = int(rng.choice([2000, 2500]))
        tg.tasks[0].resources.memory_mb = 2048
        tg.ephemeral_disk.size_mb = 0
        asks.append(PlacementAsk(job=j, tg=tg, count=tg.count))
    pb = Tensorizer().pack(nodes, asks, abn, evict_e=8)
    pb.used0 = np.zeros_like(pb.used0)
    for i, n in enumerate(nodes):
        for a in abn[n.id]:
            pb.used0[i] += alloc_usage_vector(a)
    return pb


def preempt_solve(pb, device, mode):
    from nomad_tpu_torch.solver.kernel import solve_kernel
    from nomad_tpu_torch.solver.solve import _kernel_args, _to_device, \
        _to_host
    ev_res, ev_prio, ask_prio = _to_device(
        (pb.ev_res, pb.ev_prio, pb.ask_prio), device)
    res = solve_kernel(*_kernel_args(pb, device), has_distinct=False,
                       pallas_mode=mode, has_preempt=True, ev_res=ev_res,
                       ev_prio=ev_prio, ask_prio=ask_prio)
    return _to_host(res)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["score", "topk"])
@pytest.mark.parametrize("seed", [0, 1])
def test_eviction_pass_on_gpu_matches_cpu(mode, seed):
    """The solve with the eviction pass on the card (the fused wave
    kernel in `mode`, the pass in torch ops) against the same call on
    the CPU, where the wave is the kernel's plain version: the same
    placements, victim sets and commit waves."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU "
                    "or interpret mode)")
    pb = overcommit_batch(seed)
    before = wk.fused_wave.mode_launches[mode]
    got = preempt_solve(pb, "cuda", mode)
    assert wk.fused_wave.mode_launches[mode] > before
    want = preempt_solve(pb, "cpu", mode)
    assert want.evict.any(), "the world must force evictions"
    np.testing.assert_array_equal(got.choice_ok, want.choice_ok)
    np.testing.assert_array_equal(np.where(got.choice_ok, got.choice, -1),
                                  np.where(want.choice_ok, want.choice, -1))
    np.testing.assert_array_equal(got.evict, want.evict)
    np.testing.assert_array_equal(got.commit_wave, want.commit_wave)
    np.testing.assert_array_equal(got.used_final, want.used_final)


@pytest.mark.cuda
def test_feas_kernel_on_gpu_matches_cpu():
    """The system scheduler's static-feasibility words on the card equal
    the CPU's bit for bit, on a node axis that is not a multiple of 32."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from nomad_tpu_torch.solver.masks import _feas_kernel
    rng = np.random.default_rng(5)
    Gp, Np, A, C, D = 6, 1000, 5, 4, 3
    args = (rng.random(Np) < 0.9, rng.integers(0, D, Np).astype(np.int32),
            rng.integers(-1, 6, (Np, A)).astype(np.int16),
            rng.random((Gp, D)) < 0.8, rng.random((Gp, Np)) < 0.9,
            rng.integers(0, 9, (Gp, C)).astype(np.int32),
            rng.integers(0, A, (Gp, C)).astype(np.int32),
            rng.integers(-1, 6, (Gp, C)).astype(np.int32))
    got = _feas_kernel(*(torch.as_tensor(a).cuda() for a in args))
    want = _feas_kernel(*(torch.as_tensor(a) for a in args))
    assert got.is_cuda
    np.testing.assert_array_equal(got.cpu().numpy(), want.numpy())
