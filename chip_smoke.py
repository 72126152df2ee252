#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`nomad_tpu_torch`) on one GPU.

    python3 chip_smoke.py [--baseline DIR]

Phases, one JSON line each; any failed phase exits nonzero:

  1. device  — the card's name and power limit (nvidia-smi), torch/CUDA.
  2. build   — nvcc builds the fused wave kernels from
               nomad_tpu_torch/solver/csrc/ into nomad_tpu_torch/_build/;
               a `ptxas` line gives each kernel's registers, static
               shared memory and spills.
  3. kernel  — the kernels against their plain torch version on the card
               on random inputs: score mode at phase 4's merged-batch
               widths (Gp=128, Np=10,240, one spread over V=4, and once
               with device and blocked planes) and topk mode with
               per-value tables (Gp=4, Np=10,240, 128 extracted, TK=36,
               one device plane), and the topk merge kernel alone.
               Counters equal, scores within 4 ulp, indices equal
               wherever the plain scores are separated by more than that.
               Times: kernel-only (the recorded C launch repeated, no
               wrapper around it) warm over 50 back-to-back launches and
               cold as the median of 50 launches each after a 128 MB write
               that flushes the L2; the whole wrapper call; the plain
               version.  The bound share is taken on the cold time.  With
               --baseline DIR the kernels of the checkout at DIR (e.g. the
               parent commit) are timed the same way, in turns.
  4. solve   — the slice end to end through `Solver(device="cuda").solve`
               on bench.py's config-3 cluster (10,000 nodes, 4 dcs, 64
               racks, 16 zones) loaded with 100,000 resident allocs:
               32 one-job evals in turn (fused topk mode), each eval's
               placements charged into allocs_by_node, then one merged
               32-job batch (128 groups, 2048 placements; fused score
               mode).  Launch counts are zeroed just before and read just
               after; the last one-eval batch and the merged batch are
               re-solved with the plain wave function and held to the
               reference's cross-backend criteria
               (tests/test_host_solver.py assert_same), and no node may
               end oversubscribed.
  5. schedule — the scheduler path with a store-less solver (the full
               pack on every eval): a StateStore holding the same cluster
               with the 100,000 resident allocs upserted as running allocs
               of a resident job, and `Harness(store)` with one shared
               `Solver(device="cuda")`.  16 config-3 service evals (fused
               topk mode), then one batch fan-out eval, count 1,024 in 4
               groups (fused score mode), each upserted with its job and
               run by `h.process`.  Per eval: wall, and its split into
               scheduler host time before the solve (snapshot, reconcile,
               allocs by node, asks), pack, launch-to-fetch, host fixup,
               plan apply into the store and the rest (alloc emission,
               status).  Checks: every eval complete, the store holds
               exactly each job's placed allocs by name, no node's live
               allocs exceed it, topk and merge launches in the service
               evals and score launches in the batch eval, and the last
               service eval's and the batch eval's packed batches
               re-solved with the kernel and with the plain wave agree
               under assert_same.  Launch counts are zeroed just before
               the evals and read just after (a full garbage collection
               runs before that, so the evals pay only for the garbage
               they make).
  6. worker  — the reference worker's path, the main path: the same store,
               with a store-attached `Solver(device="cuda", store=store)`
               as the worker builds it, so every eval takes the resident
               cluster world (change-log sync, plan-apply feed, ask-only
               repack, usage overlay) and the scheduler's lazy
               allocs-by-node view.  One untimed warm-up service eval
               builds the world (`world_build_ms`), a full collection
               runs, then the launch counts are zeroed and the same 16
               service evals and batch eval as phase 5 run, with store
               traffic from other actors before each: 100 resident allocs
               on distinct nodes complete (a client update), and before
               every 4th eval one node turns ineligible and one config-3
               node joins.  The split is phase 5's, with pack the resident
               pack and its parts beside it (`pack_sync`, `pack_repack`,
               `pack_overlay`), and the world's counters after each eval.
               Checks: phase 5's, plus no world rebuild in the window,
               at least 16 delta syncs and 17 plan feeds, every eval on
               the resident path, and the last service eval and the batch
               eval re-solved through a store-less Solver (the full pack
               of the same snapshot) to the same node ids and scores to 9
               decimals (tests/test_solver_resident_world.py:40-57).  The
               wave loop (`_run_kernel` to the fetch) is then timed on the
               last service eval's resident batch and on the full pack of
               its snapshot, in turns (`wave_loop_turns_ms`), and one
               more service eval runs under `torch.profiler` for the
               card's busy share of an eval (`profiled_eval`).  The
               arguments of the first score launch of the batch eval and
               of the first topk launch of the last service eval are kept
               from the kernel-vs-plain re-solves, and each kernel is then
               checked and timed on them as in phase 3: the main path's
               own shapes and data.
  7. server  — the system's entry point: a port `Server(device="cuda")`
               with the reference's default serving tier (2 workers,
               solve coordinator and pipeline on, adaptive batching,
               group commit 8, 1 broker shard).  Before `start()` the
               same cluster is entered through the server: each node by
               `register_node`, the resident job and its 100,000 running
               allocs as raft entries (FSM -> store).  One untimed
               warm-up job per worker builds that worker's resident world
               (`world_build_ms`, the other worker paused).  Leg A: 16
               config-3 service jobs, each registered after the previous
               eval completed, wall from `register_job` to the eval's
               completion, split from the eval's trace spans (queue,
               `worker.wait_index`, solve with pack / launch-to-fetch /
               fixup, `plan.submit`, rest) with the FSM's apply of each
               plan beside it.  Leg B: 64 service jobs back to back, then
               the 1,024-placement batch job: wall to the last eval's
               completion, evals/s and placements/s, every fused round
               (evals, asks, Gp, K, wave modes, stages), the broker's
               dequeue sizes, the BatchController's chosen sizes and what
               its model was fed, group commits.  Checks: every eval
               complete, no `worker.batch_error` or
               `telemetry.tick_error` from `start()` on (warm-up
               included), nothing on the broker's failed queue or
               unacked, the store holds exactly each job's placed allocs
               (by name) and any placement not placed is left to a
               blocked eval of its job, no node oversubscribed or down,
               no world rebuilt in the legs (each worker ends them on the
               world object it began with, its delta syncs and plan feeds
               only grew and no repack fell back), every solve span of
               legs A and B on the device route (`backend`), a
               fused round of two or more evals, topk and merge launches
               in leg A and score launches in leg B, and the first fused
               score round's packed batch re-solved with the kernel and
               with the plain wave agrees under assert_same.  Leg C, on
               the same server after the legs' checks are read: a system
               job (one group of cpu 100, memory 64 MB, disk 10 MB, all
               four dcs, rack != r63), one more config-3 node joining
               (its node-update eval), then the job deregistered; each
               eval's wall and split (snapshot and diff, the full pack,
               the feasibility pass `static_feasibility` from launch to
               unpacked mask, the host walk, `plan.submit` with the
               FSM's apply).  Checks: every eval complete, one live
               alloc of the job on each eligible node and none on r63,
               `failed_tg_allocs` counting the filtered nodes, the
               joined node's alloc from its own eval, no node
               oversubscribed, none left after the deregistration, and
               the card's feasibility words equal, bit for bit, to the
               same `_feas_kernel` run on the CPU on the eval's batch.
  8. preempt — service preemption on the server: phase 7's serving tier
               with `preemption_service_enabled`, the config-3 nodes each
               filled with low-priority running allocs (sizes and
               priorities of bench.py's overcommit fill, drawn from a
               seeded generator) until no config-3 ask fits without an
               eviction, entered as raft entries of five fill jobs.  One
               warm-up per worker builds its world with the eviction
               planes.  Priority-70 config-3 jobs of 64 placements, each
               pinned to one zone: leg P1, 16 in turn (the single lane:
               topk plus the eviction pass), leg P2, 16 registered while
               the workers are paused and released together (a fused
               round: score plus the eviction pass).  Per leg: walls and
               splits, waves against the doubled budget, evictions,
               `scheduler.preempt.kernel` / `host_fallback`, launches,
               the eviction pass's calls, placed and left to blocked
               evals, the card's peak memory.  Checks: every eval
               complete, no batch error, none on the broker's failed
               queue, the kernel committed evictions in both legs,
               every preempting alloc's victims are exactly the allocs
               the store marks evicted by it and each is at least 10
               below in priority,
               no node oversubscribed, no world rebuilt in the legs, and
               one leg-P1 batch and the fused round's batch re-solved
               with the kernel and with the plain wave agree under
               assert_same with equal victim sets and commit waves; the
               eviction pass is then timed on both batches.

  9. stream  — the streaming ResidentSolver, bench.py run_ours at config 3:
               `ResidentSolver(device="cuda", pallas="auto",
               max_waves=18)` on phase 4's 10,000 nodes, gp 4 (the
               distinct ask signatures) and kp 8,192, its carried usage
               seeded from 100,000 resident allocs (bench.py
               resident_used0) after a warm pass.  Main leg: 896 config-3
               evals in 7 pipelined chunks of 128 (`merge_asks`, seeds
               b + 1, `solve_stream_pipelined`), up to 4 retry-drain
               rounds in rows of at most 64 (seeds 1009 + 17 t + i), then
               the steady delta leg: 4 chunks re-dispatched, each after a
               net-zero delta of 32 place+stop pairs.  Printed: evals/s,
               placements/s, placed / failed / retried / unresolved, the
               pack / dispatch / fetch split with waves and rescore waves
               per chunk, launches by mode (zeroed before the leg, read
               after it), the steady leg's per-wave pack, dispatch and
               delta-apply ms and bytes, `delta_counters`, peak card
               memory, and the card's busy share of one more chunk under
               torch.profiler.  Checks: placed + failed + unresolved =
               57,344; no valid node's carried usage above its avail; the
               carried usage equal to the seeded usage plus the committed
               asks summed on the host; a fused wave launch in the leg;
               `plane_checksum()` equal to `template_checksum`; the health
               kernel equal to `health_host`.  Kernel against plain, on
               the card: a main-leg chunk re-solved from the seeded usage
               with the kernel and with `pallas="off"`; a serial stream of
               4 batches, a lane stream (L 4, 8 batches) and
               `solve_parallel` over 4 batches, each batch 16 evals; and a
               preempting stream (phase 8's fill, eviction planes of
               width 8, 2 batches, evictions fed back as stop deltas).
               Statuses, ok flags and waves equal, scores within 4 ulp, a
               choice differing only where its scores tie, victim masks
               and carried usage equal.

  10. host route — the host route of the solve and the optional score
               planes, three legs, one line each.  L1: bench.py config 1
               as run_ours_latency runs it (100 nodes of the bench's
               generator, 12 evals of one job of 10 groups x 10 under a
               `kernel.name = linux` constraint, after one warm-up eval;
               `prefer_host` must pick the host for its padded shape):
               the bench's own pick, `HostResidentSolver` at the exact
               pads (10, 100), native and numpy, timed; then the same
               evals at the card's pads (16, 128) through
               `HostResidentSolver(device_parity=True)` native and numpy
               and the card's `ResidentSolver(device="cuda")`, each with
               its own fresh usage and one `solve_stream` per eval.
               Every eval's choices, ok flags, statuses and carried usage
               equal across the three, scores within rtol 2e-5; p50 /
               p99 per eval and evals/s for each, the card's wave-kernel
               launches.  L2: `Server(device="cuda")` over 100 such
               nodes, 12 config-1 jobs in turn: every eval complete, the
               store holds each job's placed allocs, no node
               oversubscribed, every solve span `backend == "host"` and
               no wave-kernel launch; p50 / p99 eval wall and its split
               as leg A's.  L3: one config-3 job's packed batch (Gp 4,
               Np 10,240) on phase 4's cluster with its 100,000 resident
               allocs, with a learned plane (a quarter of its entries
               zero) and a three-level region plane (home dc > sibling >
               remote) from numpy's default_rng(10), each alone and both:
               the port's `solve_kernel` on the card against the numpy
               `host_solve_kernel` under assert_same, each solve's card
               ms (CUDA events), and no wave-kernel launch (a plane pins
               the torch scorer).

  11. mesh   — the mesh tiers (`nomad_tpu_torch.parallel`) with every
               shard on this one card, at bench.py run_multichip's and
               run_multiregion's size: 50,000 nodes of bench.py's
               generator (padded 50,176, 6,272 a shard), 16 evals of
               make_job(2, e, 64) in calls of 8, max_waves 18,
               `pallas="auto"`, 8 shards.  L0: one rich_solve_batch
               problem (512 placements) through `sharded_solve` and the
               flat `solve_kernel`.  L1: `ShardedResidentSolver` on a
               1-D mesh against the flat `ResidentSolver`, then again
               with the score kernel pinned and with the plain scorer,
               and one call under torch.profiler.  L2: the two-tier mesh
               (4 hosts x 2) and `CrossRegionResidentSolver` (4 regions
               x 1 host x 2), each against the flat stream, with
               `wave_traffic`'s modeled bytes and the measured counters.
               L3: `ElasticShardedResidentSolver`, `fail_shard(3)`, a
               stream against a flat solver over the live nodes,
               `recover()`, a stream against the flat one; after each,
               the plane checksum against the template's resident rows
               and the health kernel (live-row mask) against
               `health_host`.  L4: `FederatedResidentSolver`, 4 regions
               of 12,500 nodes, 4 evals each, against each region's own
               ResidentSolver.  Every comparison: ok flags, statuses,
               choices and carried usage equal, scores 0.0 apart (the
               plain and pinned re-runs: rescore waves equal, scores
               within 4 ulp).  Per leg: wall, evals/s, ms a wave, waves,
               launches per mode and per shard; every shard must launch
               the wave kernel.  L5: SLO spillover, bench.py
               run_multiregion's leg (:1066-1140, its queue simulation
               `_region_queue_sim` copied as `region_queue_sim`): 400
               seeded arrivals, 70% homed on one of 4 regions, at half
               the fleet's rate, each region serving an eval in the
               seconds L2's cross-region stream took an eval on the
               card, through the isolated policy, the port's
               `SpilloverRouter` (with a `WanLatencyModel`) and the router
               on a balanced stream: p99s, `evals_lost` (must be 0),
               `shed_accounting_intact` and `spill_ok` (spillover p99 at
               most twice the balanced one while the isolated policy
               browns out; must hold).

  12. cluster — the cluster over the wire: the port's
               `rpc.endpoints.serve_cluster(3, num_workers=2)` on
               127.0.0.1 in plaintext, raft at hashicorp/raft's own
               timeouts (election 1-2 s, heartbeat 0.1 s), each server
               with a `GossipAgent` on its own `RpcServer` (region
               "global"), joined and attached with `attach_gossip`.
               Entry: phase 7's cluster (10,000 nodes, the resident job,
               100,000 running allocs in entries of 10,000; the nodes
               from 8 threads) through the leader, replicated over TCP
               to both followers.  The collector is off for the phase
               and the entered state frozen out of it (three replicas in
               one process make a full collection's pause outgrow raft's
               election timeout).  One warm-up job per worker.  W1: 16 config-3 jobs one after
               another by `RpcServerEndpoints.register_job` at a
               follower (forwarded): p50 / p99 from the call to the eval
               complete, split into the forward, the leader's register
               (its raft commits beside it) and phase 7's eval split; the
               collector's state and the thread count; the last
               eval's packed batch re-solved with the kernel and the
               plain wave under assert_same; one more job under
               torch.profiler for the card's busy share.  W2: 64 jobs
               from 4 client threads over the three addresses, then the
               1,024-placement batch job: evals/s, placements/s, the
               fused rounds and group commits.  W3: the leader's RPC
               server, gossip agent and server stopped (a deliberate
               stop): the new leader's election, gossip marking the old
               one dead and autopilot dropping it (2 peers left), each
               first seen by a watcher thread; the first placement after
               the kill (a job through the server list, the dead address
               first), the new leader's world builds, then 16 jobs
               through the same list.  W4: a one-server region "alpha"
               joins the gossip; `RegionRouter(alpha's agent)
               .call_region("global", "Job.Register", ...)` lands the job
               here and not in alpha.  After every leg: each live
               replica's allocs (ids, nodes, client statuses) equal the
               leader's, no node oversubscribed, each eval complete with
               its unplaced work in a blocked eval, the wave kernel
               launched (topk in W1, W3, W4, W5 with as many merges;
               score in W2).  W5: the leader takes a snapshot of the
               whole state (`RaftNode.snapshot_now`; the entry's 10,000
               node entries passed `snapshot_threshold` = 8,192, so its
               log was compacted, but at a point that held only nodes),
               then a fourth server joins with an empty log through
               `add_server_peer` (a learner, then a voter): it is behind
               the compaction point and catches up by the chunked
               InstallSnapshot of a snapshot larger than `MAX_FRAME`,
               and a job registered at it is forwarded and placed.
               Recorded: the snapshot's bytes and chunks, the largest
               frame read (at most `MAX_FRAME`), the time to catch up;
               its allocs must equal the leader's; leadership is looked
               up each time, and a move during the join is recorded.
               Recorded for the phase: the largest AppendEntries (encoded
               entries) and the batches the frame limit cut, W5's
               snapshot bytes, each against `MAX_FRAME`, and the
               loopback bytes per leg.

  13. lifecycle — on phase 7's server after phase 7's checks (its
               state, no cut: 10,001 nodes, the resident job's 100,000
               allocs): the lifecycle of jobs.  The server's heartbeater
               gets Nomad's options min_heartbeat_ttl 2 s,
               max_heartbeats_per_second 10,000 and heartbeat_grace 1 s
               (a missed beat noticed within about 5 s at 10,000 nodes;
               the default 50 beats a second would give a 200 s TTL); one
               thread heartbeats every live node every half second, and
               a `SimClient` runs the allocs of every node an alloc
               placed in the phase lands on, without registering it again
               (at most 600 client threads).  The heap is frozen for the
               phase, and the blocked evals phase 7 left run first.  J: the
               config-3 job written as an HCL jobspec (with update
               max_parallel 8 and migrate max_parallel 2) parsed by the
               port's `jobspec` (it must equal make_job's, field by field
               in the wire encoding) and registered; its 64 allocs
               running and its deployment successful.  H: 16 nodes that
               hold its allocs stop heartbeating: the time to `down`, and
               until every lost alloc has a replacement running on a
               ready node.  D: 4 such nodes drained (deadline 10 s): the
               most migrations in flight per group before the deadline
               (at most migrate max_parallel), the time until drained.
               R: a rolling update of the job (a new env): the time until
               the deployment succeeds and the fewest healthy allocs.  P:
               a periodic batch job of the same shape in HCL, forced by
               `periodic.force_launch` (`nomad job periodic force`): its
               child placed and complete.  After every leg: every eval
               written in it complete, blocked or cancelled, no node
               oversubscribed, the wave kernel launched, and the leg's
               last solve re-solved with the kernel and the plain wave
               under assert_same.

The line before the last lists every kernel with its launches on the
worker's path (phase 6; phases 5, 7, 8, 9, 10, 11, 12 and 13 as
`launches_phase5`, `launches_phase7`, `launches_phase8`,
`launches_phase9`, `launches_phase10`, `launches_phase11`,
`launches_phase12` and `launches_phase13` beside them),
and its error against the plain version, times (`ms` is the kernel-only
cold time) and bound on phase 6's own arguments; the score kernel also
on the first fused score round's arguments (`fused_round`), each kernel
on a mesh shard's (`mesh_shard`: phase 11's shard 0, L0's topk call and
L1's pinned score call), and each
kernel on the arguments of its first call in phase 9's re-solves
(`stream`).  The last line is
{"ok": true, "device": {...}}.  Without a CUDA device the script exits
nonzero before printing any result.
"""
from __future__ import annotations

import collections
import contextlib
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
DEVICE = "cuda"

#: H100 SXM data-sheet peaks (NVIDIA, dense, 700 W): HBM bytes/s and
#: f32 operations/s outside the tensor cores
HBM_BYTES_S = 3.35e12
F32_OPS_S = 67e12
#: scores of kernel and plain version may differ by this many ulp (the
#: reference's own cross-backend bound for 10**x, test_score_spec.py)
ULP_TOL = 4
#: bench.py config 3
N_NODES = 10_000
RESIDENT = 100_000
R_VEC = (200, 256, 300)          # resident alloc cpu, memory, disk
N_EVALS = 32
COUNT = 64
#: phase 5: config-3 service evals, then one batch fan-out eval
N_SERVICE_EVALS = 16
BATCH_COUNT = 1024
#: phase 6: resident allocs a client completes before each eval
TRAFFIC_ALLOCS = 100


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


class PhaseError(RuntimeError):
    pass


def check(cond, msg) -> None:
    if not cond:
        raise PhaseError(msg)


# ------------------------------------------------------------ phase 1
def phase_device(torch):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    emit({"phase": "device", "nvidia_smi": card,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "kind": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count()})
    return card


# ------------------------------------------------------------ phase 2
def ptxas_kernels(text):
    """Registers, static shared memory and spill bytes per kernel from
    `nvcc -Xptxas -v` output, keyed `name<N>` for a kernel instantiated
    with the integer template argument N."""
    import re
    out, name = {}, None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m.group(1)
            z = re.match(r"_Z(\d+)", name)          # Itanium-mangled
            if z:
                end = z.end() + int(z.group(1))
                t = re.match(r"ILi(\d+)E", name[end:])
                name = name[z.end():end] + (f"<{t.group(1)}>" if t else "")
            out[name] = {}
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            out[name]["spill_store_bytes"] = int(m.group(1))
            out[name]["spill_load_bytes"] = int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[name]["registers"] = int(m.group(1))
            s = re.search(r"(\d+) bytes smem", line)
            out[name]["static_smem_bytes"] = int(s.group(1)) if s else 0
    return out


def phase_build(wk):
    t0 = time.perf_counter()
    path = wk.build()
    secs = time.perf_counter() - t0
    report = open(str(path) + ".ptxas.txt").read()
    emit({"phase": "build", "seconds": round(secs, 3),
          "library": os.path.relpath(path, HERE)})
    emit({"phase": "ptxas", "kernels": ptxas_kernels(report)})


# ------------------------------------------------------------ phase 3
def wave_inputs(torch, Gp, Np, S, V, D, with_blocked, seed, device):
    """Random fused-wave inputs at realistic magnitudes (integral cpu /
    memory / disk figures, small collocation counts, seeded jitter)."""
    from nomad_tpu_torch.solver.masks import pack_bool_u32
    rng = np.random.default_rng(seed)
    f32 = np.float32
    R = 4
    cap = np.stack([4000 + (np.arange(Np) % 8) * 1000,
                    8192 + (np.arange(Np) % 4) * 4096,
                    np.full(Np, 100_000), np.full(Np, 1000)], 1).astype(f32)
    n_res = rng.integers(0, 25, Np)
    used = (n_res[:, None] * np.array([200, 256, 300, 0])).astype(f32)
    ask = np.stack([400 + (np.arange(Gp) % 4) * 150,
                    256 + (np.arange(Gp) % 4) * 128,
                    np.full(Gp, 300), np.zeros(Gp)], 1).astype(f32)

    def t(x):
        return torch.as_tensor(np.ascontiguousarray(x)).to(device)

    bits = lambda p: t(rng.random((Gp, Np)) < p)   # noqa: E731
    kw = dict(
        feas=pack_bool_u32(bits(0.85)), pen=pack_bool_u32(bits(0.05)),
        blocked=pack_bool_u32(bits(0.05)) if with_blocked else None,
        aff=t((rng.random((Gp, Np)) < 0.1).astype(f32) * f32(0.5)),
        jitter=t((rng.integers(0, 1024, (Gp, Np)).astype(f32)
                  * f32(0.05 / 1023.0))),
        coll=t((rng.random((Gp, Np)) < 0.05).astype(f32)),
        used=t(used), avail=t(cap), reserved=t(np.zeros((Np, R), f32)),
        ask_res=t(ask), ask_desired=t(np.full(Gp, 16.0, f32)))
    if D:
        kw["dev"] = (t(rng.integers(0, 4, (Np, D)).astype(f32)),
                     t(np.full((Np, D), 4.0, f32)),
                     t((rng.random((Gp, D)) < 0.5).astype(f32)))
    vnode = np.broadcast_to(np.arange(Np) % V, (S, Gp, Np)).copy()
    vnode[rng.random((S, Gp, Np)) < 0.02] = -1
    sp_used = rng.integers(0, 6, (Gp, S, V)).astype(f32)
    pres = sp_used > 0
    anyp = pres.any(2)
    kw["spread"] = (
        t(vnode.astype(np.int16)),
        t(np.where(vnode >= 0, f32(16 / V), f32(-1.0)).astype(f32)),
        t(sp_used), t(np.ones((Gp, S), f32)),
        # int8, as the kernel reads it, so no wrapper makes a temporary
        # copy that a replayed launch (raw_launch) would not own
        t((rng.random((Gp, S)) < 0.5).astype(np.int8)),
        t(np.ones((Gp, S), np.int8)),
        t(np.where(anyp, np.where(pres, sp_used, np.inf).min(2), 0)
          .astype(f32)),
        t(np.where(anyp, sp_used.max(2), 0).astype(f32)),
        t(anyp.astype(np.int8)))
    return kw


def ulp_dist(torch, a, b):
    ia = a.view(torch.int32).to(torch.int64)
    ib = b.view(torch.int32).to(torch.int64)
    ia = torch.where(ia < 0, -(ia & 0x7FFFFFFF), ia)
    ib = torch.where(ib < 0, -(ib & 0x7FFFFFFF), ib)
    return (ia - ib).abs()


def time_ms(torch, fn, reps=30, warm=3):
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def raw_launch(torch, wk, kw):
    """Record the C launch that one `wk.fused_wave(**kw)` call makes and
    return a function that repeats exactly that launch: the same
    arguments, pointers and output buffers, with none of the wrapper's
    Python, checks, allocations or torch ops around it.  The buffers the
    wrapper allocates are kept alive in the closure.  Works on any
    checkout of `wave_kernel.py` whose wrapper allocates with
    `torch.empty` / `torch.zeros` and calls `_load().nomad_wave_launch`,
    so an older commit's kernel runs through the same timer."""
    lib = wk._load()
    real = lib.nomad_wave_launch
    rec, kept = {}, []

    class Lib:
        def __getattr__(self, name):
            return getattr(lib, name)

        def nomad_wave_launch(self, *args):
            rec["args"] = args
            return real(*args)

    class Torch:
        def __getattr__(self, name):
            return getattr(torch, name)

        def empty(self, *a, **k):
            kept.append(torch.empty(*a, **k))
            return kept[-1]

        def zeros(self, *a, **k):
            kept.append(torch.zeros(*a, **k))
            return kept[-1]

    launches = wk.fused_wave.launches
    wk._lib, wk.torch = Lib(), Torch()
    try:
        wk.fused_wave(**kw)
    finally:
        wk._lib, wk.torch = lib, torch
    wk.fused_wave.launches = launches
    args = rec["args"]

    return replay(real, args, kept)


def replay(real, args, kept):
    def launch():
        rc = real(*args)
        check(rc == 0, f"raw launch failed with CUDA error {rc}")
    launch.real, launch.args, launch.kept = real, args, kept
    return launch


def keys_to_pairs(torch, keys):
    """(score, column) of the topk kernel's int64 order keys (the inverse
    of csrc/wave_kernel.cu key_of)."""
    hi = (keys >> 32) & 0xFFFFFFFF
    bits = torch.where(hi >= 1 << 31, hi & 0x7FFFFFFF, ~hi & 0xFFFFFFFF)
    bits = torch.where(bits >= 1 << 31, bits - (1 << 32), bits)
    return (bits.to(torch.int32).view(torch.float32),
            (~keys & 0xFFFFFFFF).to(torch.int32))


def merge_case(torch, wk, launch, name, shape):
    """The topk merge kernel alone (mode 2 of the C launch) on the
    partials `launch` left, against the plain version of that merge (the
    stable sort `_lex_topk_rows` over the same partials)."""
    Gp, Np = shape["Gp"], shape["Np"]
    plan = wk.launch_plan("topk", Gp, Np,
                          NE=shape["n_extract"] or shape["TK"],
                          TK=shape["TK"], tables_v=shape["tables_v"])
    launch()
    torch.cuda.synchronize()
    part, vpart = [t for t in launch.kept if t.dtype == torch.int64]
    top_s, tab_s = [t for t in launch.kept if t.dtype == torch.float32]
    cnt, tcnt, top_i, tab_i = [t for t in launch.kept
                               if t.dtype == torch.int32]
    ps, pi = keys_to_pairs(torch, part.reshape(Gp, -1))
    vs, vi = keys_to_pairs(torch, vpart.transpose(0, 1).reshape(
        Gp, plan["Vs"] + 1, -1))

    def plain():
        return (wk._lex_topk_rows(ps, pi, plan["NE"], Np),
                wk._lex_topk_rows(vs, vi, plan["TKv"], Np))
    (ws, wi), (wvs, wvi) = plain()
    merge = replay(launch.real, (2,) + tuple(launch.args[1:]), launch.kept)
    merge()
    torch.cuda.synchronize()
    for got, want in ((top_s, ws), (top_i, wi), (tab_s, wvs), (tab_i, wvi)):
        check(torch.equal(got, want), "merge kernel differs from the "
              "plain merge of the same partials")
    cold, warm = kernel_ms(torch, merge)
    # keys read, tile counters read; scores, columns and counters written
    nbytes = (8 * (part.numel() + vpart.numel()) + 4 * tcnt.numel()
              + 8 * (top_s.numel() + tab_s.numel()) + 4 * cnt.numel())
    bound = nbytes / HBM_BYTES_S * 1e3
    row = {"phase": "kernel", "case": name, "max_abs_err": 0.0,
           "ms": cold, "kernel_ms_cold": cold, "kernel_ms_warm": warm,
           "wrapper_ms": None, "plain_ms": time_ms(torch, plain),
           "bytes": nbytes, "bound_ms": bound, "bound_by": "bytes",
           "bound_share_cold": bound / cold, **plan}
    emit(row)
    return row


#: GPU cycles the timer stalls the card for (torch.cuda._sleep) before a
#: timed window, so the host has queued the whole window before the card
#: reaches it and the events time the card, not the host's submissions
#: (a ctypes launch takes longer on the host than the smallest kernels
#: take on the card)
STALL_WARM, STALL_COLD = 4_000_000, 200_000


def kernel_ms(torch, launch, reps=50):
    """Kernel-only times of a prepared launch: warm = CUDA events around
    `reps` back-to-back launches, over `reps`; cold = the median of
    `reps` single launches, each after writing a 128 MB scratch tensor
    (outside the events) so the 50 MB L2 holds none of the inputs."""
    launch()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(STALL_WARM)
    a.record()
    for _ in range(reps):
        launch()
    b.record()
    b.synchronize()
    warm = a.elapsed_time(b) / reps
    scratch = torch.empty(32 << 20, dtype=torch.float32, device=DEVICE)
    cold = []
    for i in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        scratch.fill_(float(i))
        torch.cuda._sleep(STALL_COLD)
        a.record()
        launch()
        b.record()
        b.synchronize()
        cold.append(a.elapsed_time(b))
    del scratch
    return statistics.median(cold), warm


def ops_per_pair(R, D, S):
    """f32 operations of the scoring chain for one (group, node) pair,
    counted from csrc/wave_kernel.cu: fit (2 per dimension + 2 utils),
    device fit (2 per device), bin-pack 14, anti 3, spread 15 per
    constraint, combine 13."""
    return 2 * R + 2 + 2 * D + 14 + 3 + 15 * S + 13


def compare_wave(torch, name, kw, res_k, res_p):
    for c in ("n_feas", "n_exh", "grp_any", "dim_exh"):
        check(torch.equal(res_k[c], res_p[c]), f"{name}: counter {c} "
              "differs between kernel and plain version")
    errs = []
    for s_key, i_key in (("score", None), ("top_score", "top_idx"),
                         ("tab_s", "tab_i")):
        if s_key not in res_p:
            continue
        sk, sp = res_k[s_key], res_p[s_key]
        check(sk.shape == sp.shape, f"{name}: {s_key} shape")
        mk, mp = sk > -1e29, sp > -1e29
        check(torch.equal(mk, mp), f"{name}: {s_key} masks differ")
        d = ulp_dist(torch, sk[mp], sp[mp])
        check(d.numel() == 0 or int(d.max()) <= ULP_TOL,
              f"{name}: {s_key} off by {int(d.max())} ulp")
        errs.append(float((sk[mp] - sp[mp]).abs().max())
                    if mp.any() else 0.0)
        if i_key is not None:
            sp2 = sp.reshape(-1, sp.shape[-1])
            ik = res_k[i_key].reshape(sp2.shape)
            ip = res_p[i_key].reshape(sp2.shape)
            gap = ulp_dist(torch, sp2[:, 1:], sp2[:, :-1]) > ULP_TOL
            sep = torch.ones_like(ik, dtype=torch.bool)
            sep[:, 1:] &= gap
            sep[:, :-1] &= gap
            check(torch.equal(ik[sep], ip[sep]),
                  f"{name}: {i_key} differs at separated scores")
    return max(errs)


def wave_bytes(torch, kw, res):
    seen, total = set(), 0

    def add(x):
        nonlocal total
        if isinstance(x, torch.Tensor) and x.data_ptr() not in seen:
            seen.add(x.data_ptr())
            total += x.numel() * x.element_size()
        elif isinstance(x, (tuple, list)):
            for y in x:
                add(y)

    for v in kw.values():
        add(v)
    for v in res.values():
        add(v)
    return total


KERNEL_CASES = [
    ("score", dict(Gp=128, Np=10240, S=1, V=4, D=0, with_blocked=False),
     dict(mode="score", TK=260, n_extract=384)),
    ("score+dev+blocked",
     dict(Gp=128, Np=10240, S=1, V=4, D=1, with_blocked=True),
     dict(mode="score", TK=260, n_extract=384)),
    ("topk+tables", dict(Gp=4, Np=10240, S=1, V=4, D=1, with_blocked=False),
     dict(mode="topk", TK=36, n_extract=128, tables_v=4)),
]


def load_baseline(path):
    """`nomad_tpu_torch.solver.wave_kernel` of another checkout (for
    example the parent commit, unpacked with `git archive`), imported
    under the package name `baseline_nomad_tpu_torch`; it builds its own
    library into that checkout's `nomad_tpu_torch/_build/`."""
    import importlib
    import importlib.util
    root = os.path.join(os.path.abspath(path), "nomad_tpu_torch")
    spec = importlib.util.spec_from_file_location(
        "baseline_nomad_tpu_torch", os.path.join(root, "__init__.py"),
        submodule_search_locations=[root])
    pkg = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = pkg
    spec.loader.exec_module(pkg)
    return importlib.import_module(spec.name + ".solver.wave_kernel")


def phase_kernel(torch, wk, base_wk=None):
    """Each kernel against its plain version at the main path's shapes,
    then its times: kernel-only cold and warm (`kernel_ms`), the whole
    wrapper call and the plain version.  With `base_wk` (another
    checkout's module) both kernels are also timed kernel-only in turns,
    baseline, this tree, this tree, baseline."""
    dev = torch.device(DEVICE)
    out = {}
    for i, (name, shape, call) in enumerate(KERNEL_CASES):
        kw = wave_inputs(torch, seed=100 + i, device=dev, **shape)
        kw.update(call, seed=1 + i)
        out.update(kernel_case(torch, wk, name, kw, base_wk))
    return out


def wave_shape(kw):
    """The launch-shape figures of a fused-wave call's arguments."""
    dev, spread = kw.get("dev"), kw.get("spread")
    return {"Gp": kw["feas"].shape[0], "Np": kw["used"].shape[0],
            "R": kw["used"].shape[1],
            "S": spread[0].shape[0] if spread is not None else 0,
            "V": spread[2].shape[2] if spread is not None else 0,
            "D": dev[0].shape[1] if dev is not None else 0,
            "with_blocked": kw.get("blocked") is not None,
            "TK": kw.get("TK", 4), "n_extract": kw.get("n_extract", 0),
            "tables_v": kw.get("tables_v", 0)}


def kernel_case(torch, wk, name, kw, base_wk=None):
    """One fused-wave call `kw` through the kernel and the plain version,
    held to each other, then timed: kernel-only cold and warm
    (`kernel_ms`), the whole wrapper call and the plain version, with the
    bound from the bytes the call moves and the operations it does.
    With `base_wk` the other checkout's kernel is timed kernel-only in
    turns.  A topk call also gives its merge kernel's row.  Returns the
    rows by case name."""
    out = {}
    shape = wave_shape(kw)
    res_k = wk.fused_wave(**kw)
    res_p = wk.fused_wave_plain(**kw)
    torch.cuda.synchronize()
    err = compare_wave(torch, name, kw, res_k, res_p)
    launch = raw_launch(torch, wk, kw)
    cold, warm = kernel_ms(torch, launch)
    wrapper_ms = time_ms(torch, lambda: wk.fused_wave(**kw))
    plain_ms = time_ms(torch, lambda: wk.fused_wave_plain(**kw))
    nbytes = wave_bytes(torch, kw, res_k)
    ops = (shape["Gp"] * shape["Np"]
           * ops_per_pair(shape["R"], shape["D"], shape["S"]))
    t_bytes = nbytes / HBM_BYTES_S * 1e3
    t_ops = ops / F32_OPS_S * 1e3
    bound = max(t_bytes, t_ops)
    row = {"phase": "kernel", "case": name, "max_abs_err": err,
           "ms": cold, "kernel_ms_cold": cold, "kernel_ms_warm": warm,
           "wrapper_ms": wrapper_ms, "plain_ms": plain_ms,
           "bytes": nbytes, "ops": ops, "bound_ms": bound,
           "bound_by": "bytes" if t_bytes >= t_ops else "operations",
           "bound_share_cold": bound / cold, **shape}
    if base_wk is not None:
        res_b = base_wk.fused_wave(**kw)
        torch.cuda.synchronize()
        compare_wave(torch, name + " (baseline)", kw, res_b, res_p)
        base = raw_launch(torch, base_wk, kw)
        turns = [kernel_ms(torch, f) for f in (base, launch, launch,
                                               base)]
        row["turns"] = {
            "order": ["baseline", "this", "this", "baseline"],
            "cold_ms": [t[0] for t in turns],
            "warm_ms": [t[1] for t in turns],
            "baseline_wrapper_ms": time_ms(
                torch, lambda: base_wk.fused_wave(**kw))}
        del base
    emit(row)
    out[name] = row
    if kw["mode"] == "topk":
        check(shape["tables_v"] > 0, f"{name}: the merge check needs tables")
        name_m = name.replace("topk", "topk merge", 1)
        out[name_m] = merge_case(torch, wk, launch, name_m, shape)
    del launch
    return out


# ------------------------------------------------------------ phase 4
def make_nodes(mock, n_nodes, start=0):
    """bench.py make_nodes (config 3 cluster, no devices, gen_seed 0);
    `start` numbers the nodes from there (a later join)."""
    nodes = []
    for i in range(start, start + n_nodes):
        n = mock.node(datacenter=f"dc{i % 4}")
        n.reserved_resources.cpu = 0
        n.reserved_resources.memory_mb = 0
        n.reserved_resources.disk_mb = 0
        n.attributes["kernel.name"] = "linux"
        n.attributes["rack"] = f"r{i % 64}"
        n.attributes["zone"] = f"z{i % 16}"
        n.node_resources.cpu = 4000 + (i % 8) * 1000
        n.node_resources.memory_mb = 8192 + (i % 4) * 4096
        n.node_resources.disk_mb = 100_000
        for net in n.node_resources.networks:
            net.mbits = 1000
        n.compute_class()
        nodes.append(n)
    return nodes


def make_job(mock, structs, eval_ix, count):
    """bench.py make_job, config 3: two constraints, a rack affinity, a
    datacenter spread, 4 groups of count // 4."""
    job = mock.job()
    job.id = f"job-3-{eval_ix}"
    job.name = job.id
    job.datacenters = [f"dc{d}" for d in range(4)]
    job.constraints = [
        structs.Constraint("${attr.rack}", "r63", "!="),
        structs.Constraint("${attr.zone}", "z1", ">="),       # lexical
    ]
    job.affinities = [structs.Affinity(ltarget="${attr.rack}", rtarget="r7",
                                       operand="=", weight=35)]
    job.spreads = [structs.Spread(attribute="${node.datacenter}",
                                  weight=50)]
    job.task_groups = [bench_group(job.task_groups[0], g, count // 4)
                       for g in range(4)]
    return job


def bench_group(base, g, count):
    """bench.py make_job's group g: a copy of `base` with cpu
    400-850 MHz, memory 256-640 MB, disk 300 MB, no network or device."""
    import copy
    tg = copy.deepcopy(base)
    tg.name = f"g{g}"
    tg.count = count
    tg.constraints = []
    t = tg.tasks[0]
    t.resources.networks = []
    t.resources.cpu = 400 + (g % 4) * 150
    t.resources.memory_mb = 256 + (g % 4) * 128
    t.resources.devices = []
    tg.ephemeral_disk.size_mb = 300
    return tg


def asks_for(job):
    from nomad_tpu_torch.solver.tensorize import PlacementAsk
    return [PlacementAsk(job=job, tg=tg, count=tg.count)
            for tg in job.task_groups]


def resident_allocs(mock, nodes, n_allocs):
    """n_allocs live allocs spread round-robin, each using R_VEC.  Their
    job declares what they hold (count n_allocs, R_VEC, no network, one
    name index each), so an eval of it, such as the follow-up of a
    preemption, keeps them and replaces only what was preempted."""
    from nomad_tpu_torch.structs import (AllocatedResources,
                                         AllocatedSharedResources,
                                         AllocatedTaskResources)
    job = mock.job()
    job.id = "resident"
    tg = job.task_groups[0]
    tg.count = n_allocs
    tg.networks = []
    tg.ephemeral_disk.size_mb = R_VEC[2]
    for t in tg.tasks:
        t.resources.cpu, t.resources.memory_mb = R_VEC[0], R_VEC[1]
        t.resources.networks = []
    by_node = {}
    for k in range(n_allocs):
        nd = nodes[k % len(nodes)]
        a = mock.alloc(job=job, node_id=nd.id)
        a.name = f"{job.id}.{tg.name}[{k}]"
        a.allocated_resources = AllocatedResources(
            tasks={"web": AllocatedTaskResources(cpu=R_VEC[0],
                                                 memory_mb=R_VEC[1])},
            shared=AllocatedSharedResources(disk_mb=R_VEC[2]))
        by_node.setdefault(nd.id, []).append(a)
    return by_node


def charge(mock, by_node, job, asks, out):
    """Apply an eval's placements the way the plan applier would: each
    placed alloc joins its node's live allocs."""
    placed = 0
    for p in out.placements:
        if p.node is None:
            continue
        a = mock.alloc(job=job, node_id=p.node.id,
                       task_group=asks[p.ask_index].tg.name)
        a.allocated_resources = p.resources
        by_node.setdefault(p.node.id, []).append(a)
        placed += 1
    return placed


@contextlib.contextmanager
def plain_wave(wk):
    """Route solve_kernel's wave calls to the plain torch version."""
    real = wk.fused_wave
    wk.fused_wave = wk.fused_wave_plain
    try:
        yield
    finally:
        wk.fused_wave = real


@contextlib.contextmanager
def capture_wave(wk, mode, into):
    """Keep a copy of the arguments of the first `mode` wave call made
    inside the block in `into["kw"]`; every call goes on to the wrapper
    as before."""
    real = wk.fused_wave

    def copy(x):
        if isinstance(x, tuple):
            return tuple(copy(y) for y in x)
        return x.clone() if hasattr(x, "clone") else x

    def wave(**kw):
        if "kw" not in into and kw["mode"] == mode:
            into["kw"] = {k: copy(v) for k, v in kw.items()}
        return real(**kw)
    # the wrapper counts its launches on the module's `fused_wave`
    wave.launches, wave.mode_launches = real.launches, real.mode_launches
    wk.fused_wave = wave
    try:
        yield
    finally:
        wk.fused_wave = real


def launch_to_fetch(trace):
    """The wave loop on the card and its host driving: the launch wall
    after the pack (`dispatch_wall_s`) plus the wall blocked on the
    fetch (`fetch_wall_s`)."""
    return trace["dispatch_wall_s"] + trace["fetch_wall_s"]


def pct(xs, p):
    xs = sorted(xs)
    return xs[min(len(xs) - 1, int(round(p * (len(xs) - 1))))]


def assert_same(a, b, what):
    """tests/test_host_solver.py assert_same, plus wave counters."""
    ok_a, ok_b = a.choice_ok, b.choice_ok
    check(np.array_equal(ok_a, ok_b), f"{what}: choice_ok differs")
    check(np.array_equal(np.where(ok_a, a.choice, -1),
                         np.where(ok_b, b.choice, -1)),
          f"{what}: choice differs")
    check(np.allclose(np.where(ok_a, a.score, 0.0),
                      np.where(ok_b, b.score, 0.0), rtol=2e-5, atol=2e-5),
          f"{what}: scores differ")
    check(np.allclose(a.used_final, b.used_final, rtol=1e-5),
          f"{what}: used_final differs")
    for f in ("unfinished", "n_feasible", "feas"):
        check(np.array_equal(getattr(a, f), getattr(b, f)),
              f"{what}: {f} differs")
    check(a.n_waves == b.n_waves and a.n_rescore == b.n_rescore,
          f"{what}: waves {a.n_waves}/{b.n_waves} rescore "
          f"{a.n_rescore}/{b.n_rescore}")


def phase_solve(torch, wk, n_nodes, resident, n_evals):
    from nomad_tpu_torch import mock, structs
    from nomad_tpu_torch.solver.solve import (Solver, _run_kernel,
                                              _to_host)
    t0 = time.perf_counter()
    nodes = make_nodes(mock, n_nodes)
    by_node = resident_allocs(mock, nodes, resident)
    setup_s = time.perf_counter() - t0
    jobs = [make_job(mock, structs, e, COUNT) for e in range(2 * n_evals)]
    solver = Solver(device=DEVICE)
    merged_jobs = jobs[n_evals:]
    merged_asks = [a for j in merged_jobs for a in asks_for(j)]

    # ---- the main path, launch counts zeroed just before ----
    wk.fused_wave.launches = 0
    wk.fused_wave.mode_launches = {"score": 0, "topk": 0, "merge": 0}
    torch.cuda.synchronize()
    walls, placed, failed, waves, resc = [], 0, 0, [], []
    packs, devs = [], []
    for e, job in enumerate(jobs[:n_evals]):
        asks = asks_for(job)
        if e == n_evals - 1:
            # the last eval's batch, packed here for the checks below
            pb_one = solver._tensorizer.pack(nodes, asks, by_node)
        t1 = time.perf_counter()
        out = solver.solve(nodes, asks, by_node)
        walls.append(time.perf_counter() - t1)
        packs.append(out.trace["pack_wall_s"])
        devs.append(launch_to_fetch(out.trace))
        waves.append(out.trace["waves"])
        resc.append(out.trace["rescore_waves"])
        n = charge(mock, by_node, job, asks, out)
        placed += n
        failed += len(out.placements) - n
    topk_launches = wk.fused_wave.mode_launches["topk"]
    # the merged batch: packed once here so the checks below re-solve
    # exactly what Solver.solve solved
    pb = solver._tensorizer.pack(nodes, merged_asks, by_node)
    t1 = time.perf_counter()
    m_out = solver.solve(nodes, merged_asks, by_node)
    merged_s = time.perf_counter() - t1
    torch.cuda.synchronize()
    counts = dict(wk.fused_wave.mode_launches)
    m_placed = sum(p.node is not None for p in m_out.placements)
    check(counts["topk"] > 0, "one-eval solves launched no topk kernel")
    check(counts["score"] > 0, "merged batch launched no score kernel")
    check(topk_launches == counts["topk"],
          "merged batch unexpectedly ran topk mode")
    check(counts["merge"] == counts["topk"],
          "a topk launch ran without its merge kernel")
    check(placed > 0 and m_placed > 0, "nothing was placed")
    for p in m_out.placements:
        check(p.node is None or np.isfinite(p.score), "non-finite score")

    # ---- checks (launches here are not counted) ----
    for what, batch in (("last one-eval batch", pb_one),
                        ("merged batch", pb)):
        res_k = _to_host(_run_kernel(batch, DEVICE))
        with plain_wave(wk):
            res_p = _to_host(_run_kernel(batch, DEVICE))
        assert_same(res_k, res_p, f"{what}: kernel vs plain")
        real = batch.n_real
        check(bool(np.all(res_k.used_final[:real] <= batch.avail[:real])),
              f"{what}: a node is oversubscribed")
        check(np.isfinite(res_k.score[res_k.choice_ok]).all(),
              f"{what}: non-finite committed score")
    row = {"phase": "solve", "nodes": n_nodes, "resident_allocs": resident,
           "resident_cut": RESIDENT - resident, "setup_s": setup_s,
           "one_eval": {"evals": n_evals, "placed": placed,
                        "failed": failed, "waves": waves,
                        "rescore_waves": resc,
                        "p50_ms": 1e3 * pct(walls, 0.5),
                        "p99_ms": 1e3 * pct(walls, 0.99),
                        "pack_p50_ms": 1e3 * pct(packs, 0.5),
                        "device_solve_p50_ms": 1e3 * pct(devs, 0.5)},
           "merged": {"groups": len(merged_asks),
                      "placements": len(m_out.placements),
                      "placed": m_placed,
                      "failed": len(m_out.placements) - m_placed,
                      "failed_reasons": dict(collections.Counter(
                          p.failed_reason for p in m_out.placements
                          if p.node is None)),
                      "waves": m_out.trace["waves"],
                      "rescore_waves": m_out.trace["rescore_waves"],
                      "wall_s": merged_s,
                      "pack_s": m_out.trace["pack_wall_s"],
                      "device_solve_s": launch_to_fetch(m_out.trace),
                      "placements_per_s": m_placed / merged_s},
           "launches": counts}
    emit(row)
    return counts


# ------------------------------------------------------------ phase 5
class EvalClock:
    """Times the parts of each `Harness.process` call from outside: the
    store's `snapshot` (the scheduler's first step), the shared solver's
    `solve_async` (its PendingSolve carries pack, launch, fetch and fixup
    walls, and the packed batch), the harness's `submit_plan` (plan apply
    into the store), and the garbage collector's pauses (which overlap
    the other parts).  With `resident` it also times the three parts of
    the resident pack: the world's change-log sync, the ask repack and
    the usage overlay."""

    def __init__(self, h, resident=False):
        import gc
        from nomad_tpu_torch.solver import solve as solve_mod
        self.solves, self.applies, self.snaps = [], [], []
        self.gc_s, self._gc_t = 0.0, 0.0
        self.parts = collections.Counter()
        solver, store = h.solver, h.store
        real_solve, real_submit, real_snap = (
            solver.solve_async, h.submit_plan, store.snapshot)

        def solve_async(*a, **kw):
            t = time.perf_counter()
            pending = real_solve(*a, **kw)
            self.solves.append((t, pending, a, kw))
            return pending

        def timed(fn, key):
            def run(*a, **kw):
                t = time.perf_counter()
                try:
                    return fn(*a, **kw)
                finally:
                    self.parts[key] += time.perf_counter() - t
            return run

        restore = []
        if resident:
            tz, world_cls = solver._tensorizer, solve_mod._ResidentWorld
            restore = [(world_cls, "sync", world_cls.sync),
                       (solve_mod, "_overlay_usage",
                        solve_mod._overlay_usage),
                       (tz, "repack_asks", tz.repack_asks)]
            world_cls.sync = timed(world_cls.sync, "pack_sync")
            solve_mod._overlay_usage = timed(solve_mod._overlay_usage,
                                             "pack_overlay")
            tz.repack_asks = timed(tz.repack_asks, "pack_repack")

        def submit_plan(plan):
            t = time.perf_counter()
            out = real_submit(plan)
            self.applies.append(time.perf_counter() - t)
            return out

        def snapshot():
            t = time.perf_counter()
            out = real_snap()
            self.snaps.append(time.perf_counter() - t)
            return out

        def on_gc(phase, _info):
            if phase == "start":
                self._gc_t = time.perf_counter()
            else:
                self.gc_s += time.perf_counter() - self._gc_t

        solver.solve_async, h.submit_plan, store.snapshot = (
            solve_async, submit_plan, snapshot)
        gc.callbacks.append(on_gc)

        def close():
            gc.callbacks.remove(on_gc)
            for obj, name, fn in restore:
                setattr(obj, name, fn)
        self.close = close

    def process(self, h, sched, ev):
        """One eval through the harness; returns its wall and split (s):
        the store snapshot, the rest of the scheduler's host work before
        the solve (reconcile, allocs by node, asks), pack,
        launch-to-fetch, host fixup, plan apply, and the rest after the
        solve (alloc emission, status); `gc` overlaps them, and the
        resident pack's parts (`pack_sync`, `pack_repack`,
        `pack_overlay`) are inside `pack`.  Also returns the solve's
        output, its PendingSolve and its arguments."""
        self.solves, self.applies, self.snaps = [], [], []
        self.gc_s = 0.0
        self.parts.clear()
        t0 = time.perf_counter()
        h.process(sched, ev)
        wall = time.perf_counter() - t0
        check(len(self.solves) == 1, f"eval {ev.job_id}: "
              f"{len(self.solves)} solves, expected one")
        t_solve, p, args, kwargs = self.solves[0]
        split = {"snapshot": sum(self.snaps),
                 "reconcile_prepare": t_solve - t0 - sum(self.snaps),
                 "pack": p.pack_wall_s,
                 "launch_to_fetch": p.dispatch_wall_s + p.fetch_wall_s,
                 "fixup": p.finish_wall_s, "plan_apply": sum(self.applies)}
        split["after_solve"] = wall - sum(split.values())
        split["gc"] = self.gc_s
        split.update(self.parts)
        return wall, split, p.wait(), p, (args, kwargs)


def schedule_store(mock, structs, n_nodes, resident):
    """A StateStore holding bench.py's config-3 cluster, upserted in
    order, and `resident` running allocs of one resident job (R_VEC
    each, round-robin over the nodes).  Returns the store, the nodes and
    the resident allocs in that round-robin order."""
    from nomad_tpu_torch.state.store import StateStore
    store = StateStore()
    nodes = make_nodes(mock, n_nodes)
    for i, n in enumerate(nodes):
        store.upsert_node(1 + i, n)
    by_node = resident_allocs(mock, nodes, resident)
    res_job = next(iter(by_node.values()))[0].job
    store.upsert_job(n_nodes + 1, res_job)
    allocs = [by_node[nodes[k % n_nodes].id][k // n_nodes]
              for k in range(resident)]
    for a in allocs:
        a.client_status = structs.ALLOC_CLIENT_RUNNING
    store.upsert_allocs(n_nodes + 2, allocs)
    return store, nodes, allocs


def batch_job(mock, structs, count):
    """config-3's job shape as a batch fan-out job: the same constraints,
    affinity and spread, `count` placements in 4 groups."""
    job = make_job(mock, structs, "batch", count)
    job.id = job.name = "batch-fanout"
    job.type = structs.JOB_TYPE_BATCH
    for tg in job.task_groups:
        tg.reschedule_policy = structs.ReschedulePolicy.default_batch()
    return job


def check_store(structs, store, jobs, nodes):
    """The store holds exactly each job's placed allocs (by name, as the
    plans placed them), and no node's non-terminal allocs exceed it."""
    for job, placed_names in jobs:
        names = sorted(a.name for a in store.allocs_by_job(job.namespace,
                                                           job.id))
        check(names == sorted(placed_names),
              f"{job.id}: the store holds {len(names)} allocs, the plans "
              f"placed {len(placed_names)}")
        check(len(set(names)) == len(names), f"{job.id}: duplicate names")
    for n in nodes:
        live = store.allocs_by_node_terminal(n.id, False)
        fit, dim, _used = structs.allocs_fit(n, live)
        check(fit, f"node {n.name} oversubscribed ({dim})")


class EvalRunner:
    """Registers a job with its eval, runs it through the harness under
    an EvalClock and checks it ended complete with every placement
    placed or queued."""

    def __init__(self, h, mock, structs, clock):
        self.h, self.mock, self.structs, self.clock = h, mock, structs, clock

    def __call__(self, sched, job):
        h, structs = self.h, self.structs
        h.store.upsert_job(h.next_index(), job)
        ev = self.mock.eval_(job_id=job.id, type=job.type,
                             priority=job.priority)
        h.store.upsert_evals(h.next_index(), [ev])
        n_plans = len(h.plans)
        wall, split, out, pending, call = self.clock.process(h, sched, ev)
        final = h.evals[-1]
        check(final.id == ev.id and final.status
              == structs.EVAL_STATUS_COMPLETE,
              f"{job.id}: eval ended {final.status!r} "
              f"({final.status_description})")
        names = [a.name for p in h.plans[n_plans:]
                 for lst in p.node_allocation.values() for a in lst
                 if a.job_id == job.id]
        failed = sum(final.queued_allocations.values())
        check(len(names) + failed == sum(tg.count
                                         for tg in job.task_groups),
              f"{job.id}: {len(names)} placed + {failed} queued")
        for p in out.placements:
            check(p.node is None or np.isfinite(p.score),
                  f"{job.id}: non-finite score")
        reasons = collections.Counter(p.failed_reason
                                      for p in out.placements
                                      if p.node is None)
        return {"wall": wall, "split": split, "placed": len(names),
                "failed": failed, "reasons": reasons,
                "waves": out.trace["waves"],
                "rescore_waves": out.trace["rescore_waves"],
                "names": names, "pb": pending.packed, "out": out,
                "call": call}


def zero_launches(torch, wk):
    wk.fused_wave.launches = 0
    wk.fused_wave.mode_launches = {"score": 0, "topk": 0, "merge": 0}
    torch.cuda.synchronize()


def check_launch_split(svc_counts, bat_counts):
    check(svc_counts["topk"] > 0, "service evals launched no topk kernel")
    check(svc_counts["merge"] == svc_counts["topk"],
          "a topk launch ran without its merge kernel")
    check(svc_counts["score"] == 0, "a service eval ran score mode")
    check(bat_counts["score"] > 0, "the batch eval launched no score kernel")
    check(bat_counts["topk"] == 0, "the batch eval ran topk mode")
    check(bat_counts["merge"] == 0, "the batch eval ran the merge kernel")


def kernel_vs_plain(wk, items):
    """Each (what, packed batch, mode[, preempt]) re-solved with the
    kernel and with the plain wave (launches here are not counted on the
    main path), held to `assert_same`, no node oversubscribed.  With
    `preempt` the solve runs the eviction pass, and the victim sets and
    commit waves must be equal too.  Returns the arguments of the first
    wave call of each mode, copied during the re-solves."""
    from nomad_tpu_torch.solver.solve import _run_kernel, _to_host
    calls = {}
    for what, pb, mode, *rest in items:
        preempt = bool(rest and rest[0])
        into = calls.setdefault(mode, {})
        with capture_wave(wk, mode, into):
            res_k = _to_host(_run_kernel(pb, DEVICE, preempt=preempt))
        check("kw" in into, f"{what}: no {mode} wave call")
        with plain_wave(wk):
            res_p = _to_host(_run_kernel(pb, DEVICE, preempt=preempt))
        assert_same(res_k, res_p, f"{what}: kernel vs plain")
        if preempt:
            check(res_k.evict is not None and res_k.evict.any(),
                  f"{what}: the re-solve committed no eviction")
            check(np.array_equal(res_k.evict, res_p.evict)
                  and np.array_equal(res_k.commit_wave, res_p.commit_wave),
                  f"{what}: victim sets or commit waves differ")
        real = pb.n_real
        check(bool(np.all(res_k.used_final[:real] <= pb.avail[:real])),
              f"{what}: a node is oversubscribed")
    return {m: c["kw"] for m, c in calls.items()}


def split_ms(rows, p):
    return {k: 1e3 * pct([r["split"].get(k, 0.0) for r in rows], p)
            for k in rows[0]["split"]}


def service_row(rows, svc_counts):
    walls = [r["wall"] for r in rows]
    return {"evals": len(rows), "count": COUNT,
            "p50_ms": 1e3 * pct(walls, 0.5),
            "p99_ms": 1e3 * pct(walls, 0.99),
            "split_p50_ms": split_ms(rows, 0.5),
            "split_p99_ms": split_ms(rows, 0.99),
            "walls_ms": [1e3 * w for w in walls],
            "gc_ms": [1e3 * r["split"]["gc"] for r in rows],
            "placed": sum(r["placed"] for r in rows),
            "failed": sum(r["failed"] for r in rows),
            "failed_reasons": dict(sum((r["reasons"] for r in rows),
                                       collections.Counter())),
            "waves": [r["waves"] for r in rows],
            "launches": svc_counts}


def batch_row(bat, bjob, batch_count, bat_counts):
    return {"count": batch_count, "groups": len(bjob.task_groups),
            "wall_ms": 1e3 * bat["wall"],
            "split_ms": {k: 1e3 * v for k, v in bat["split"].items()},
            "placed": bat["placed"], "failed": bat["failed"],
            "failed_reasons": dict(bat["reasons"]),
            "waves": bat["waves"], "rescore_waves": bat["rescore_waves"],
            "launches": bat_counts}


def phase_schedule(torch, wk, n_nodes, resident, n_evals, batch_count):
    """The scheduler path end to end with a store-less solver (the full
    pack on every eval): evals through Harness.process -> GenericScheduler
    -> reconciler -> Solver on the card -> plan applied into the
    StateStore.  Returns the launch counts of its evals."""
    import gc
    from nomad_tpu_torch import mock, structs
    from nomad_tpu_torch.scheduler.harness import Harness
    from nomad_tpu_torch.solver.solve import Solver
    t0 = time.perf_counter()
    store, nodes, _ = schedule_store(mock, structs, n_nodes, resident)
    setup_s = time.perf_counter() - t0
    h = Harness(store)
    h.solver = Solver(device=DEVICE)
    clock = EvalClock(h)
    run = EvalRunner(h, mock, structs, clock)
    service = [make_job(mock, structs, e, COUNT) for e in range(n_evals)]
    bjob = batch_job(mock, structs, batch_count)

    # ---- the path, launch counts zeroed just before ----
    gc.collect()        # earlier phases' garbage is not this path's cost
    zero_launches(torch, wk)
    svc = [run("service", job) for job in service]
    torch.cuda.synchronize()
    svc_counts = dict(wk.fused_wave.mode_launches)
    bat = run("batch", bjob)
    torch.cuda.synchronize()
    clock.close()
    counts = dict(wk.fused_wave.mode_launches)
    bat_counts = {k: counts[k] - svc_counts[k] for k in counts}
    check_launch_split(svc_counts, bat_counts)

    # ---- checks (launches here are not counted) ----
    check_store(structs, store, [(j, r["names"]) for j, r in
                                 zip(service + [bjob], svc + [bat])],
                nodes)
    kernel_vs_plain(wk, (("last service eval", svc[-1]["pb"], "topk"),
                         ("batch eval", bat["pb"], "score")))
    emit({"phase": "schedule", "nodes": n_nodes,
          "resident_allocs": resident, "resident_cut": RESIDENT - resident,
          "setup_s": setup_s,
          "service": service_row(svc, svc_counts),
          "batch": batch_row(bat, bjob, batch_count, bat_counts),
          "launches": counts})
    return counts


def placements(out):
    return [(p.ask_index, p.node.id if p.node is not None else None,
             round(p.score, 9)) for p in out.placements]


def full_pack_resolve(structs, rec):
    """The eval's solve re-run through a store-less Solver (the full
    pack) on the same snapshot, nodes, asks and proposed allocs by node
    (the snapshot's live allocs minus the plan's stops, plus its sticky
    probes): the reference's resident-vs-full criterion
    (tests/test_solver_resident_world.py:40-57)."""
    from nomad_tpu_torch.solver.solve import Solver
    (nodes, asks, _abn, by_dc), kw = rec["call"]
    snap = kw["snapshot"]
    stops, probes = kw["proposed_delta"]
    stopped = {a.id for a in stops}
    abn = {}
    for n in nodes:
        live = [a for a in snap.allocs_by_node(n.id)
                if not a.terminal_status() and a.id not in stopped]
        if live:
            abn[n.id] = live
    for a in probes:
        abn.setdefault(a.node_id, []).append(a)
    pending = Solver(device=DEVICE).solve_async(nodes, asks, abn, by_dc)
    return pending.wait(), pending.packed


def wave_loop_turns(torch, batches, reps=5):
    """Launch-to-fetch of `_run_kernel` on each named packed batch, host
    clock to a synchronize, in turns (a, b, b, a) of `reps` solves each;
    ms per solve."""
    from nomad_tpu_torch.solver.solve import _run_kernel, _to_host
    out = {name: [] for name in batches}
    names = list(batches)
    for name in names + names[::-1]:
        for _ in range(reps):
            t = time.perf_counter()
            _to_host(_run_kernel(batches[name], DEVICE))
            torch.cuda.synchronize()
            out[name].append(1e3 * (time.perf_counter() - t))
    return out


def store_traffic(structs, h, allocs, nodes, e, stats):
    """What other actors write between two evals of a live cluster, seen
    only through the store's change log: 100 resident allocs on distinct
    nodes complete (a client update); every 4th eval one node turns
    ineligible and one config-3 node joins (its dc, rack and zone are in
    the cluster's universe)."""
    import copy
    from nomad_tpu_torch import mock
    upd = []
    for a in allocs[e * TRAFFIC_ALLOCS:(e + 1) * TRAFFIC_ALLOCS]:
        u = copy.copy(a)
        u.client_status = structs.ALLOC_CLIENT_COMPLETE
        upd.append(u)
    check(len({a.node_id for a in upd}) == len(upd) == TRAFFIC_ALLOCS,
          "client updates must land on distinct nodes")
    h.store.update_allocs_from_client(h.next_index(), upd)
    stats["completed"] += len(upd)
    if e % 4 == 0:
        victim = nodes[(37 * e + 5) % len(nodes)]
        h.store.update_node_eligibility(h.next_index(), victim.id,
                                        structs.NODE_SCHED_INELIGIBLE)
        joined = make_nodes(mock, 1, start=len(nodes) + stats["joined"])[0]
        h.store.upsert_node(h.next_index(), joined)
        stats["ineligible"] += 1
        stats["joined"] += 1


def profile_card(torch, fn):
    """fn() under `torch.profiler`: its result and the card's time by
    kernel name in ms (the kernels and copies it ran, names cut to 100
    characters; one stream, so no overlap)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    by_name = collections.Counter()
    for ev in prof.events():
        if ev.device_type == DeviceType.CUDA:
            by_name[ev.name[:100]] += ev.time_range.elapsed_us() / 1e3
    return out, by_name


def device_share(torch, run, job):
    """One more service eval under `torch.profiler`: the card's busy time
    over the eval's wall, and the device time by kernel name.
    `busy_share` is None where the profiler recorded no device event
    (not measured)."""
    rec, by_name = profile_card(torch, lambda: run("service", job))
    busy_ms = sum(by_name.values())
    wall_ms = 1e3 * rec["wall"]
    return {"wall_ms": wall_ms, "busy_ms": busy_ms,
            "busy_share": busy_ms / wall_ms if busy_ms else None,
            "split_ms": {k: 1e3 * v for k, v in rec["split"].items()},
            "top_device_ms": dict(by_name.most_common(8))}


def phase_worker(torch, wk, n_nodes, resident, n_evals, batch_count):
    """The worker's path: the same store and evals as phase 5, through a
    Harness whose solver is store-attached (`Solver(store=store)`, as
    the reference worker builds it), so every eval takes the resident
    cluster world (change-log sync, plan-apply feed, ask-only repack,
    usage overlay) and the lazy allocs-by-node view.  Store traffic from
    other actors lands between evals.  Returns the launch counts of its
    evals and the arguments of their first score and topk wave calls."""
    import gc
    from nomad_tpu_torch import mock, structs
    from nomad_tpu_torch.scheduler.harness import Harness
    from nomad_tpu_torch.solver.solve import Solver
    t0 = time.perf_counter()
    store, nodes, allocs = schedule_store(mock, structs, n_nodes, resident)
    setup_s = time.perf_counter() - t0
    h = Harness(store)
    h.solver = Solver(device=DEVICE, store=store)
    clock = EvalClock(h, resident=True)
    run = EvalRunner(h, mock, structs, clock)
    warm = make_job(mock, structs, "warm", COUNT)
    service = [make_job(mock, structs, e, COUNT) for e in range(n_evals)]
    profiled = make_job(mock, structs, "profiled", COUNT)
    bjob = batch_job(mock, structs, batch_count)

    # ---- warm-up: the first eval builds the world, as a worker's would
    first = run("service", warm)
    check(first["out"].trace["resident"], "the first eval took no world")
    world_build_ms = 1e3 * first["wall"]
    gc.collect()

    # ---- the path, launch counts zeroed just before ----
    before = h.solver.resident_counters()
    stats = collections.Counter()
    world = []
    zero_launches(torch, wk)
    svc = []
    for e, job in enumerate(service):
        store_traffic(structs, h, allocs, nodes, e, stats)
        svc.append(run("service", job))
        world.append(h.solver.resident_counters())
    torch.cuda.synchronize()
    svc_counts = dict(wk.fused_wave.mode_launches)
    store_traffic(structs, h, allocs, nodes, n_evals, stats)
    bat = run("batch", bjob)
    world.append(h.solver.resident_counters())
    torch.cuda.synchronize()
    clock.close()
    counts = dict(wk.fused_wave.mode_launches)
    bat_counts = {k: counts[k] - svc_counts[k] for k in counts}
    check_launch_split(svc_counts, bat_counts)
    after = world[-1]

    # ---- checks (launches here are not counted) ----
    for r in svc + [bat]:
        check(r["out"].trace["resident"], "an eval left the resident path")
    check(after["repack_fallbacks"] - before["repack_fallbacks"] == 0,
          f"the world was rebuilt in the timed window: {after}")
    check(after["delta_syncs"] - before["delta_syncs"] >= n_evals,
          f"too few delta syncs in the timed window: {before} -> {after}")
    check(after["plan_feeds"] - before["plan_feeds"] >= n_evals + 1,
          f"too few plan feeds in the timed window: {before} -> {after}")
    all_nodes = list(store.nodes())
    check(len(all_nodes) == n_nodes + stats["joined"], "a join was lost")
    check_store(structs, store, [(j, r["names"]) for j, r in
                                 zip([warm] + service + [bjob],
                                     [first] + svc + [bat])], all_nodes)
    full_pbs = {}
    for what, rec in (("last service eval", svc[-1]), ("batch eval", bat)):
        full, full_pbs[what] = full_pack_resolve(structs, rec)
        check(placements(full) == placements(rec["out"]),
              f"{what}: the resident placements differ from the full "
              "pack's")
    # the wave loop on the last service eval's resident batch and on the
    # full pack of the same snapshot (same shapes), in turns
    turns = wave_loop_turns(torch, {
        "full_pack": full_pbs["last service eval"],
        "resident": svc[-1]["pb"]})
    calls = kernel_vs_plain(wk, (("last service eval", svc[-1]["pb"],
                                  "topk"),
                                 ("batch eval", bat["pb"], "score")))
    # the card's busy share of one more service eval (after the checks:
    # the profiled eval is not part of the measured window)
    clock = EvalClock(h, resident=True)
    share = device_share(torch, EvalRunner(h, mock, structs, clock),
                         profiled)
    clock.close()
    row = {"phase": "worker", "nodes": n_nodes,
           "resident_allocs": resident, "resident_cut": RESIDENT - resident,
           "setup_s": setup_s, "world_build_ms": world_build_ms,
           "world_build_split_ms": {k: 1e3 * v
                                    for k, v in first["split"].items()},
           "traffic": dict(stats),
           "service": service_row(svc, svc_counts),
           "batch": batch_row(bat, bjob, batch_count, bat_counts),
           "world_before": before, "world_after": after,
           "world_per_eval": world,
           "wave_loop_turns_ms": turns,
           "profiled_eval": share,
           "checks": {"resident_vs_full_pack": "passed",
                      "kernel_vs_plain": "passed"},
           "launches": counts}
    emit(row)
    return counts, calls, row


# ------------------------------------------------------------ phase 7
#: leg B: config-3 service jobs registered back to back
N_BURST_JOBS = 64
#: resident allocs per raft entry while the cluster is entered
RESIDENT_CHUNK = 10_000


def server_cluster(srv, mock, structs, n_nodes, resident, node_threads=1):
    """Enter bench.py's config-3 cluster into a Server that has not
    started (or a cluster's leader): each node through `register_node`
    (from `node_threads` threads, as many clients register at once),
    then the resident job and its running allocs through raft entries
    (`_propose` -> FSM -> store; the job without an eval, the allocs as
    plan results of RESIDENT_CHUNK allocs).  Returns the nodes and the
    seconds each part took."""
    from concurrent.futures import ThreadPoolExecutor
    from nomad_tpu_torch.utils.codec import to_wire
    t0 = time.perf_counter()
    nodes = make_nodes(mock, n_nodes)
    if node_threads > 1:
        with ThreadPoolExecutor(node_threads) as pool:
            for f in [pool.submit(srv.register_node, n) for n in nodes]:
                f.result()
    else:
        for n in nodes:
            srv.register_node(n)
    t1 = time.perf_counter()
    by_node = resident_allocs(mock, nodes, resident)
    res_job = next(iter(by_node.values()))[0].job
    srv._propose("job_upsert", {"job": to_wire(res_job)})
    allocs = [by_node[nodes[k % n_nodes].id][k // n_nodes]
              for k in range(resident)]
    for a in allocs:
        a.client_status = structs.ALLOC_CLIENT_RUNNING
        a.job = None                  # the entry carries the job once
    for c in range(0, resident, RESIDENT_CHUNK):
        result = structs.PlanResult()
        for a in allocs[c:c + RESIDENT_CHUNK]:
            result.node_allocation.setdefault(a.node_id, []).append(a)
        srv._propose("plan_result", {"result": to_wire(result),
                                     "job": to_wire(res_job)})
    return nodes, {"nodes_s": t1 - t0,
                   "resident_allocs_s": time.perf_counter() - t1}


class ServerProbe:
    """Watches a Server from outside while it runs: the FSM's apply of
    every plan entry (seconds, and the allocs it placed by job), each
    fused round the coordinator runs (its evals, asks, packed batch,
    wave modes and stages), the broker's dequeue batch sizes, the
    BatchController's chosen sizes and what its model was fed.  The wave
    modes of a round come from a per-thread count of the wrapper's
    launches: the port's `solve_async` runs the whole wave loop inside
    `fleet_dispatch`, on the drain leader's thread."""

    PLAN_ENTRIES = ("plan_result", "plan_results_batch")

    def __init__(self, srv, wk, min_kept_evals=0):
        """`min_kept_evals`: keep the packed batch of every score round
        of at least that many evals; 0 keeps only the first score
        round's."""
        import threading
        from nomad_tpu_torch.scheduler import fleet
        self.applies, self.rounds = [], []
        self.dequeues, self.targets, self.model_feed = [], [], []
        self.placed = collections.defaultdict(list)
        local = threading.local()
        restore = []

        def patch(obj, name, fn):
            restore.append((obj, name, getattr(obj, name)))
            setattr(obj, name, fn)

        real_apply = srv.fsm.apply

        def apply(index, etype, p):
            t = time.perf_counter()
            real_apply(index, etype, p)
            if etype not in self.PLAN_ENTRIES:
                return
            items = p["items"] if etype == "plan_results_batch" else [p]
            evals = set()
            for it in items:
                for lst in it["result"]["node_allocation"].values():
                    for a in lst:
                        self.placed[a["job_id"]].append(a["name"])
                        evals.add(a["eval_id"])
            t1 = time.perf_counter()
            self.applies.append({"s": t1 - t, "t1": t1,
                                 "plans": len(items), "evals": evals})
        patch(srv.fsm, "apply", apply)

        real_wave = wk.fused_wave

        def wave(**kw):
            modes = getattr(local, "modes", None)
            if modes is not None:
                modes[kw["mode"]] += 1
            return real_wave(**kw)
        wave.launches = real_wave.launches
        wave.mode_launches = real_wave.mode_launches
        patch(wk, "fused_wave", wave)

        real_dispatch, real_finish = fleet.fleet_dispatch, fleet.fleet_finish

        def fleet_dispatch(server, worker, rnd):
            local.modes = collections.Counter()
            try:
                real_dispatch(server, worker, rnd)
            finally:
                modes, local.modes = local.modes, None
            pb = rnd.pending.packed if rnd.pending is not None else None
            if min_kept_evals:
                keep = modes["score"] and len(rnd.fused) >= min_kept_evals
            else:
                keep = modes["score"] and not any(r["pb"] is not None
                                                  for r in self.rounds)
            self.rounds.append({
                "rnd": rnd, "evals": len(rnd.fused),
                "solvable": len(rnd.solvable), "asks": len(rnd.all_asks),
                "Gp": int(pb.ask_res.shape[0]) if pb is not None else 0,
                "K": int(pb.n_place) if pb is not None else 0,
                "modes": dict(modes),
                # the batches re-solved after the phase
                "pb": snapshot_pb(pb) if keep else None})

        def fleet_finish(server, worker, rnd, prev_fetch_done=0.0):
            real_finish(server, worker, rnd, prev_fetch_done)
            # wait() again returns the fetched output it cached
            trace = (rnd.pending.wait().trace if rnd.pending is not None
                     else {})
            for r in self.rounds:
                if r["rnd"] is rnd:
                    r["stages_ms"] = {k: 1e3 * v
                                      for k, v in rnd.stages.items()}
                    r["waves"] = trace.get("waves")
                    r["evict_commits"] = trace.get("evict_commits")
                    r["rnd"] = None
        patch(fleet, "fleet_dispatch", fleet_dispatch)
        patch(fleet, "fleet_finish", fleet_finish)

        broker, serving = srv.broker, srv.serving
        real_dequeue = broker.dequeue_batch

        def dequeue_batch(*a, **kw):
            out = real_dequeue(*a, **kw)
            if out:
                self.dequeues.append(len(out))
            return out
        patch(broker, "dequeue_batch", dequeue_batch)
        real_target = serving.batch_controller.target_batch

        def target_batch(ready, oldest_age_s):
            n = real_target(ready, oldest_age_s)
            if ready > 0:
                self.targets.append({"ready": ready, "age_ms":
                                     1e3 * oldest_age_s, "target": n})
            return n
        patch(serving.batch_controller, "target_batch", target_batch)
        real_observe = serving.solve_model.observe

        def observe(n_evals, wall_s):
            self.model_feed.append({"evals": n_evals, "ms": 1e3 * wall_s})
            return real_observe(n_evals, wall_s)
        patch(serving.solve_model, "observe", observe)

        def close():
            for obj, name, fn in reversed(restore):
                setattr(obj, name, fn)
            wk.fused_wave.launches = wave.launches
            wk.fused_wave.mode_launches = wave.mode_launches
        self.close = close

    def mark(self):
        """Positions to slice every record from, for one leg."""
        return {k: len(getattr(self, k)) for k in
                ("applies", "rounds", "dequeues", "targets",
                 "model_feed")}

    def since(self, m):
        return {k: getattr(self, k)[v:] for k, v in m.items()}


def snapshot_pb(pb):
    """A copy of a packed batch that later plan feeds cannot change: a
    resident batch shares the world template's eviction planes, which
    the feeds edit in place."""
    import copy
    pb = copy.copy(pb)
    pb.used0, pb.dev_used0 = pb.used0.copy(), pb.dev_used0.copy()
    if pb.ev_prio is not None:
        pb.ev_prio, pb.ev_res = pb.ev_prio.copy(), pb.ev_res.copy()
        pb.ev_ids = list(pb.ev_ids)
    return pb


def wait_evals(srv, ids, timeout):
    """Block until every eval id is terminal in the store (waking on
    store writes, not polling); returns the seconds waited."""
    from nomad_tpu_torch.structs import EVAL_STATUS_PENDING
    t0 = time.perf_counter()
    deadline = t0 + timeout
    pending = set(ids)
    while True:
        head = srv.store.latest_index()
        for eid in list(pending):
            ev = srv.store.eval_by_id(eid)
            if ev is not None and ev.status != EVAL_STATUS_PENDING:
                pending.discard(eid)
        if not pending:
            return time.perf_counter() - t0
        remain = deadline - time.perf_counter()
        check(remain > 0, f"{len(pending)} eval(s) still pending after "
              f"{timeout} s")
        srv.store.wait_for_change(head, min(remain, 1.0))


def eval_split(tracer, ev_id):
    """One eval's wall split from its trace spans (ms): queue (create to
    dequeue), `worker.wait_index`, `pre_solve` (the scheduler's store
    snapshot, reconcile and asks, up to the solve span), the solve span
    (the solver call and the placements turned into the plan) with its
    pack, launch-to-fetch and the rest after the fetch (`fixup`: the
    host fixup walk and the plan build), and `plan.submit` (plan queue,
    the applier's snapshot and evaluation, raft apply and the solver's
    plan feed)."""
    spans = {s["name"]: s for s in tracer.get(ev_id) or ()}
    check("solve" in spans and "plan.submit" in spans,
          f"eval {ev_id}: trace lacks solve / plan.submit "
          f"({sorted(spans)})")
    solve, attrs = spans["solve"], spans["solve"]["attrs"]
    wait = spans["worker.wait_index"]
    out = {"queue": spans["broker.dequeue"]["t_start"]
           - spans["create"]["t_start"],
           "wait_index": wait["dur_s"],
           "pre_solve": solve["t_start"] - wait["t_end"],
           "solve": solve["dur_s"],
           "pack": attrs["pack_wall_s"],
           "launch_to_fetch": launch_to_fetch(attrs),
           "fixup": solve["dur_s"] - attrs["kernel_wall_s"],
           "plan_submit": spans["plan.submit"]["dur_s"]}
    return {k: 1e3 * v for k, v in out.items()}, attrs


def warm_worlds(srv, make, registered):
    """One untimed job per worker (`make(i)`) builds that worker's
    resident world, the other worker paused (a paused worker stays idle
    while the queue holds no more than a batch).  Appends the evals to
    `registered`; returns each build's wall (ms)."""
    from nomad_tpu_torch.server.worker import DEQUEUE_TIMEOUT_S
    build_ms = []
    for i, w in enumerate(srv.workers):
        for o in srv.workers:
            if o is not w:
                o.paused.set()
        # a dequeue already waiting when the pause was set returns
        # within its timeout; the worker then sees the pause
        time.sleep(2 * DEQUEUE_TIMEOUT_S)
        t = time.perf_counter()
        ev = srv.register_job(make(i))
        registered.append(ev.id)
        wait_evals(srv, [ev.id], 300)
        build_ms.append(1e3 * (time.perf_counter() - t))
        for o in srv.workers:
            o.paused.clear()
    check(all(c is not None for c in world_counters(srv)),
          f"a worker built no resident world: {world_counters(srv)}")
    return build_ms


def world_counters(srv):
    return [w._solver.resident_counters() if w._solver is not None
            else None for w in srv.workers]


# ------------------------------------------------------ phase 7, leg C
#: the system job's rack filter: 156 of the 10,000 config-3 nodes
SYSTEM_FILTER_RACK = "r63"


def system_job(mock, structs):
    """A daemon on every node outside rack r63: one group of cpu 100,
    memory 64 MB, disk 10 MB, no network, all four datacenters."""
    job = mock.system_job(id="system-3")
    job.name = job.id
    job.datacenters = [f"dc{d}" for d in range(4)]
    job.constraints = [structs.Constraint("${attr.rack}",
                                          SYSTEM_FILTER_RACK, "!=")]
    tg = job.task_groups[0]
    t = tg.tasks[0]
    t.resources.cpu, t.resources.memory_mb = 100, 64
    t.resources.networks = []
    tg.networks = []
    tg.ephemeral_disk.size_mb = 10
    return job


class SystemProbe:
    """Times the parts of each system eval from outside, by eval id:
    `process` (the scheduler's attempt: snapshot, diff, placements, plan
    submit), `placements`, within it the full `pack` and the
    feasibility pass `feas` (`static_feasibility`: planes to the card,
    `_feas_kernel`, the words back and unpacked), and `plan_submit` with
    its windows (the FSM's applies inside them are the eval's).  Keeps
    each packed batch the pass saw."""

    def __init__(self):
        import threading
        from nomad_tpu_torch.scheduler import system
        from nomad_tpu_torch.server.worker import Worker
        from nomad_tpu_torch.solver import masks
        from nomad_tpu_torch.solver.tensorize import Tensorizer
        self.evals, self.batches = {}, []
        local = threading.local()
        restore = []

        def patch(obj, name, fn):
            restore.append((obj, name, getattr(obj, name)))
            setattr(obj, name, fn)

        def timed(real, key, keep=None):
            def fn(*a, **kw):
                rec = getattr(local, "rec", None)
                t = time.perf_counter()
                try:
                    return real(*a, **kw)
                finally:
                    if rec is not None:
                        t1 = time.perf_counter()
                        rec[key] += t1 - t
                        if key == "plan_submit":
                            rec["windows"].append((t, t1))
                        if keep is not None:
                            keep(a)
            return fn

        real_process = system.SystemScheduler._process

        def _process(sched):
            rec = self.evals.setdefault(sched.eval.id, {
                "process": 0.0, "placements": 0.0, "pack": 0.0,
                "feas": 0.0, "plan_submit": 0.0, "attempts": 0,
                "windows": []})
            local.rec = rec
            try:
                return timed(real_process, "process")(sched)
            finally:
                rec["attempts"] += 1
                local.rec = None
        patch(system.SystemScheduler, "_process", _process)
        patch(system.SystemScheduler, "_compute_placements",
              timed(system.SystemScheduler._compute_placements,
                    "placements"))
        patch(Tensorizer, "pack", timed(Tensorizer.pack, "pack"))
        patch(masks, "static_feasibility",
              timed(masks.static_feasibility, "feas",
                    keep=lambda a: self.batches.append(a[0])))
        patch(Worker, "submit_plan", timed(Worker.submit_plan,
                                           "plan_submit"))

        def close():
            for obj, name, fn in reversed(restore):
                setattr(obj, name, fn)
        self.close = close

    def split(self, eval_id, wall_s, applies):
        """The eval's wall split (ms): snapshot and diff (the attempt
        before and around its placements, plan submit apart), full pack,
        feasibility pass, host walk, plan submit with the FSM's apply
        inside it, and the rest (queue, status write)."""
        r = self.evals[eval_id]
        fsm = sum(a["s"] for a in applies
                  if any(t0 <= a["t1"] <= t1 for t0, t1 in r["windows"]))
        out = {"snapshot_diff": r["process"] - r["placements"]
               - r["plan_submit"],
               "pack": r["pack"], "feas": r["feas"],
               "host_walk": r["placements"] - r["pack"] - r["feas"],
               "plan_submit": r["plan_submit"], "fsm_apply": fsm,
               "rest": wall_s - r["process"]}
        return {k: 1e3 * v for k, v in out.items()}, r["attempts"]


def feas_kernel_ms(torch, args, reps=20):
    """`_feas_kernel` alone on the card, inputs resident: the median of
    `reps` runs between CUDA events."""
    from nomad_tpu_torch.solver.masks import _feas_kernel
    _feas_kernel(*args)
    ts = []
    for _ in range(reps):
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        e0.record()
        _feas_kernel(*args)
        e1.record()
        torch.cuda.synchronize()
        ts.append(e0.elapsed_time(e1))
    return statistics.median(ts)


def leg_system(torch, srv, probe, mock, structs, nodes):
    """Phase 7, leg C, on the running server: a system job on the
    config-3 cluster (one alloc per node outside rack r63), one new
    config-3 node whose node-update eval places there, then the job
    deregistered.  Each eval's wall (from the call to its completion)
    and split, and the checks; raises PhaseError on a failed one."""
    job = system_job(mock, structs)
    sp = SystemProbe()
    walls, evals = {}, {}
    index0 = srv.store.latest_index()
    try:
        for step in ("register", "node_join", "deregister"):
            t = time.perf_counter()
            if step == "register":
                ev_id = srv.register_job(job).id
            elif step == "node_join":
                new = make_nodes(mock, 1, start=len(nodes))[0]
                srv.register_node(new)
                ev_id = next(e.id for e in srv.store.evals()
                             if e.job_id == job.id and e.triggered_by
                             == structs.EVAL_TRIGGER_NODE_UPDATE)
            else:
                ev_id = srv.deregister_job(structs.DEFAULT_NAMESPACE,
                                           job.id).id
            wait_evals(srv, [ev_id], 300)
            walls[step], evals[step] = time.perf_counter() - t, ev_id
            if step == "node_join":
                live = {}
                for a in srv.store.allocs_by_job(structs.DEFAULT_NAMESPACE,
                                                 job.id):
                    if not a.terminal_status():
                        live.setdefault(a.node_id, []).append(a)
                over = []
                for n in srv.store.nodes():
                    fit, dim, _ = structs.allocs_fit(
                        n, srv.store.allocs_by_node_terminal(n.id, False))
                    if not fit:
                        over.append((n.name, dim))
        # the evals the leg set off besides its own (the preempted jobs'
        # follow-ups) run to their end before the checks
        deadline = time.perf_counter() + 300
        while True:
            b = srv.broker.stats()
            if not (b["total_ready"] or b["total_unacked"]
                    or srv.plan_queue.depth()):
                break
            check(time.perf_counter() < deadline, "leg C: the server "
                  f"did not go idle in 300 s ({b})")
            time.sleep(0.01)
    finally:
        sp.close()
    all_nodes = nodes + [new]
    finals = {k: srv.store.eval_by_id(v) for k, v in evals.items()}
    after = [a for a in srv.store.allocs_by_job(structs.DEFAULT_NAMESPACE,
                                                job.id)
             if not a.terminal_status()]
    eligible = {n.id for n in all_nodes
                if n.attributes["rack"] != SYSTEM_FILTER_RACK}
    filtered = len(all_nodes) - len(eligible)
    applies = probe.applies
    row = {"evals": {}, "placed": sum(len(v) for v in live.values()),
           "eligible_nodes": len(eligible), "filtered_nodes": filtered}
    for step, ev_id in evals.items():
        split, attempts = sp.split(ev_id, walls[step], applies)
        row["evals"][step] = {"wall_ms": 1e3 * walls[step],
                              "split_ms": split, "attempts": attempts}
    from nomad_tpu_torch.utils.tracing import global_tracer

    def submits(ev_id):
        """The eval's plan submissions: outcome and seconds."""
        return [(s["attrs"].get("outcome"), round(s["dur_s"], 3))
                for s in global_tracer.get(ev_id) or ()
                if s["name"] == "plan.submit"]
    bad = [(k, e.status, e.status_description, submits(e.id))
           for k, e in finals.items()
           if e.status != structs.EVAL_STATUS_COMPLETE]
    check(not bad, f"leg C evals not complete: {bad}")
    follow = [e for e in srv.store.evals() if e.create_index > index0
              and e.id not in evals.values()]
    row["follow_up_evals"] = collections.Counter(
        f"{e.job_id}:{e.triggered_by}:{e.status}" for e in follow)
    failed = [(e.job_id, e.status_description, submits(e.id))
              for e in follow if e.status == structs.EVAL_STATUS_FAILED]
    check(not failed, f"leg C: follow-up evals failed: {failed}")
    check(sp.batches, "leg C: no feasibility pass ran")
    check(set(live) == eligible
          and all(len(v) == 1 for v in live.values()),
          f"leg C: {len(live)} nodes hold the system job, "
          f"{len(eligible)} are eligible "
          f"({sum(len(v) > 1 for v in live.values())} hold more than one)")
    check(len(live.get(new.id, ())) == 1,
          "leg C: the joined node holds no system alloc")
    joined = [a for a in live.get(new.id, ())
              if a.eval_id == evals["node_join"]]
    check(len(joined) == 1, "leg C: the node-update eval placed "
          f"{len(joined)} allocs on the joined node")
    # the eval's metric comes back from raft in its wire form
    m = finals["register"].failed_tg_allocs.get(job.task_groups[0].name)
    failures = (None if m is None else 1 + (
        m["coalesced_failures"] if isinstance(m, dict)
        else m.coalesced_failures))
    row["failed_tg_allocs"] = failures
    check(failures == filtered, f"leg C: failed_tg_allocs counts "
          f"{failures} filtered nodes, want {filtered}")
    check(not over, f"leg C: oversubscribed nodes {over[:5]}")
    check(not after, f"leg C: {len(after)} allocs of the deregistered "
          "job still live")
    return row, sp.batches[0]


def feas_words(torch, pb):
    """The register eval's feasibility words: the card's against the
    plain version's (the same torch program on the CPU), and the pass
    alone on the card, timed once the server has stopped."""
    from nomad_tpu_torch.solver.masks import _feas_kernel, feas_planes
    words = _feas_kernel(*feas_planes(pb, DEVICE)).cpu().numpy()
    plain = _feas_kernel(*feas_planes(pb, "cpu")).numpy()
    out = {"shape": list(words.shape),
           "equal": bool(np.array_equal(words, plain))}
    if DEVICE == "cuda":
        out["feas_kernel_ms"] = feas_kernel_ms(torch,
                                               feas_planes(pb, DEVICE))
    return out


def phase_server(torch, wk, n_nodes, resident, n_serial, n_burst,
                 batch_count, phase6=None, then=None):
    """The server plane: a port `Server(device=DEVICE)` with the
    reference's default serving tier, register -> raft -> FSM -> store
    -> broker -> workers (single lane, or fused rounds on the solve
    coordinator) -> scheduler -> store-attached solver -> kernels -> plan
    queue -> applier (group commit) -> raft -> store.  Returns the
    launch counts of its legs, the first fused score round's wave
    arguments, its row, and what `then(srv)` returns: a later phase run
    on the same server once this one's checks passed (None without
    `then`)."""
    import gc
    from nomad_tpu_torch import mock, structs
    from nomad_tpu_torch.server.eval_broker import FAILED_QUEUE
    from nomad_tpu_torch.server.server import Server
    from nomad_tpu_torch.utils.metrics import global_metrics
    from nomad_tpu_torch.utils.tracing import global_tracer
    wk._load()          # the kernels are built and bound by this thread
    srv = Server(device=DEVICE)
    tier = {"workers": len(srv.workers),
            "coordinator": srv.solve_coordinator is not None,
            "pipeline": srv.serving.pipeline,
            "adaptive": srv.serving.adaptive,
            "group_commit": srv.serving.group_commit,
            "broker_shards": srv.serving.broker_shards,
            "max_batch": srv.serving.max_batch}
    check(tier == {"workers": 2, "coordinator": True, "pipeline": True,
                   "adaptive": True, "group_commit": 8,
                   "broker_shards": 1, "max_batch": 64},
          f"not the default serving tier: {tier}")
    nodes, setup = server_cluster(srv, mock, structs, n_nodes, resident)
    probe = ServerProbe(srv, wk)
    registered = []
    # the fault counters are read over the whole phase, warm-up included:
    # the warm-up is where each worker first builds its world and first
    # launches the kernels from its own thread
    m_start = global_metrics.dump()
    try:
        srv.start()
        world_build_ms = warm_worlds(
            srv, lambda i: make_job(mock, structs, f"warm{i}", COUNT),
            registered)
        worlds0 = world_counters(srv)
        # a world dropped and built anew (a failed plan feed sets it to
        # None) restarts its counters, so the legs must end on the same
        # world objects
        world_objs0 = [w._solver._world for w in srv.workers]
        m0 = global_metrics.dump()

        # ---- leg A: serial, each job after the previous eval completes
        gc.collect()
        zero_launches(torch, wk)
        mark = probe.mark()
        walls, splits, evals_a = [], [], []
        for e in range(n_serial):
            t = time.perf_counter()
            ev = srv.register_job(make_job(mock, structs, f"a{e}", COUNT))
            t_reg = time.perf_counter()
            registered.append(ev.id)
            wait_evals(srv, [ev.id], 120)
            walls.append(time.perf_counter() - t)
            split, attrs = eval_split(global_tracer, ev.id)
            split["register"] = 1e3 * (t_reg - t)
            # rest: the eval's status write and what the spans miss
            split["rest"] = 1e3 * walls[-1] - sum(
                split[k] for k in ("register", "queue", "wait_index",
                                   "pre_solve", "solve", "plan_submit"))
            splits.append(split)
            evals_a.append(ev.id)
            check(attrs.get("resident"), f"leg A eval {e} left the "
                  "resident path")
            check(attrs.get("backend") == "device", f"leg A eval {e} "
                  f"solved on the {attrs.get('backend')!r} route")
        torch.cuda.synchronize()
        counts_a = dict(wk.fused_wave.mode_launches)
        rec_a = probe.since(mark)
        applies_a = [1e3 * r["s"] for r in rec_a["applies"]
                     if set(evals_a) & r["evals"]]

        # ---- leg B: a burst of service jobs, then the batch fan-out job
        gc.collect()
        zero_launches(torch, wk)
        mark = probe.mark()
        jobs_b = [make_job(mock, structs, f"b{e}", COUNT)
                  for e in range(n_burst)]
        bjob = batch_job(mock, structs, batch_count)
        t = time.perf_counter()
        evals_b = [srv.register_job(j).id for j in jobs_b + [bjob]]
        register_s = time.perf_counter() - t
        registered += evals_b
        wait_evals(srv, evals_b, 600)
        wall_b = time.perf_counter() - t
        # a fused round acks its members together after the last one's
        # plan: wait for the acks too (not part of the wall)
        deadline = time.perf_counter() + 60
        while srv.broker.stats()["total_unacked"] \
                and time.perf_counter() < deadline:
            time.sleep(0.001)
        acked_b = time.perf_counter() - t
        torch.cuda.synchronize()
        counts_b = dict(wk.fused_wave.mode_launches)
        rec_b = probe.since(mark)
        worlds1 = world_counters(srv)
        world_objs1 = [w._solver._world for w in srv.workers]
        m1 = global_metrics.dump()
        down = [n.id for n in srv.store.nodes()
                if n.status == structs.NODE_STATUS_DOWN]
        broker = srv.broker.stats()
        blocked = srv.blocked_evals.stats()
        # the legs' allocs and blocked evals, read before leg C's node
        # join unblocks evals of theirs
        finals = [srv.store.eval_by_id(eid) for eid in registered]
        blocked_jobs = {e.job_id for e in srv.store.evals()
                        if e.status == structs.EVAL_STATUS_BLOCKED}
        names = {ev.job_id: sorted(a.name for a in srv.store.allocs_by_job(
            structs.DEFAULT_NAMESPACE, ev.job_id)) for ev in finals}
        plans_placed = {j: sorted(v) for j, v in probe.placed.items()}
        # the route of every config-3 solve of the legs (Np 10,240 is
        # above the host twin's gate)
        solve_backends = collections.Counter(
            s["attrs"].get("backend") for eid in evals_a + evals_b
            for s in global_tracer.get(eid) or () if s["name"] == "solve")

        # ---- leg C: a system job, a node join, the job deregistered
        gc.collect()
        leg_c_pb = None
        try:
            leg_c, leg_c_pb = leg_system(torch, srv, probe, mock, structs,
                                         nodes)
        except PhaseError as e:
            leg_c = {"failed": str(e)}
        m_end = global_metrics.dump()
    finally:
        probe.close()
        if then is None or sys.exc_info()[0] is not None:
            srv.stop()

    # ---- the record, then the checks (launches here are not counted)
    if leg_c_pb is not None:
        leg_c["feas_words"] = feas_words(torch, leg_c_pb)
    unplaced = {ev.job_id: (batch_count if ev.job_id == bjob.id else COUNT)
                - len(names[ev.job_id]) for ev in finals}
    rounds_b = rec_b["rounds"]
    fused_score = [r for r in rounds_b if r["modes"].get("score")]

    def hist_delta(key):
        h1 = m1["histograms"].get(key, {"sum": 0.0, "count": 0})
        h0 = m0["histograms"].get(key, {"sum": 0.0, "count": 0})
        return {"sum_ms": 1e3 * (h1["sum"] - h0["sum"]),
                "count": h1["count"] - h0["count"]}

    def counter_delta(key):
        return (m1["counters"].get(key, 0.0)
                - m0["counters"].get(key, 0.0))

    jobs_a = [srv.store.eval_by_id(x).job_id for x in evals_a]
    ids_b = [j.id for j in jobs_b + [bjob]]
    placed_b = sum(len(names[j]) for j in ids_b)
    svc_walls = [1e3 * w for w in walls]
    counts = {"leg_a": counts_a, "leg_b": counts_b}
    row = {
        "phase": "server", "nodes": n_nodes, "resident_allocs": resident,
        "resident_cut": RESIDENT - resident, "serving_tier": tier,
        "setup_s": setup, "world_build_ms": world_build_ms,
        "worlds_before_legs": worlds0, "worlds_after_legs": worlds1,
        "leg_a": {
            "evals": n_serial, "count": COUNT,
            "p50_ms": pct(svc_walls, 0.5), "p99_ms": pct(svc_walls, 0.99),
            "walls_ms": svc_walls,
            "split_p50_ms": {k: pct([s[k] for s in splits], 0.5)
                             for k in splits[0]},
            "split_p99_ms": {k: pct([s[k] for s in splits], 0.99)
                             for k in splits[0]},
            "raft_fsm_plan_apply_ms": {
                "p50": pct(applies_a, 0.5) if applies_a else None,
                "p99": pct(applies_a, 0.99) if applies_a else None},
            "phase6_p50_ms": phase6 and phase6["p50_ms"],
            "phase6_p99_ms": phase6 and phase6["p99_ms"],
            "dequeue_sizes": rec_a["dequeues"],
            "rounds": len(rec_a["rounds"]),
            "placed": sum(len(names[j]) for j in jobs_a),
            "unplaced": sum(unplaced[j] for j in jobs_a),
            "launches": counts_a},
        "leg_b": {
            "service_jobs": n_burst, "batch_count": batch_count,
            "register_s": register_s, "wall_s": wall_b,
            "acked_s": acked_b,
            "evals_per_s": len(evals_b) / wall_b,
            "placed": placed_b,
            "unplaced": sum(unplaced[j] for j in ids_b),
            "unplaced_batch_job": unplaced[bjob.id],
            "placements_per_s": placed_b / wall_b,
            "rounds": [{k: r.get(k) for k in ("evals", "solvable", "asks",
                                              "Gp", "K", "modes",
                                              "stages_ms")}
                       for r in rounds_b],
            "stage_totals_ms": {
                s: hist_delta(f"coordinator.stage.{s}_s")
                for s in ("reconcile", "pack", "dispatch", "device",
                          "fetch", "plan_build", "apply")},
            "group_commits": counter_delta("plan.group_commits"),
            "raft_applies": counter_delta("plan.raft_applies"),
            "cross_worker_rounds":
                counter_delta("coordinator.cross_worker_rounds"),
            "dequeue_sizes": rec_b["dequeues"],
            "batch_targets": [t["target"] for t in rec_b["targets"]],
            "model_feed": rec_b["model_feed"],
            "raft_fsm_plan_apply_ms": [1e3 * r["s"]
                                       for r in rec_b["applies"]],
            "launches": counts_b},
        "leg_c": leg_c, "solve_backends": dict(solve_backends),
        "blocked_evals": blocked, "broker": broker,
        "first_fused_score_round": (
            {k: fused_score[0][k] for k in ("evals", "asks", "Gp", "K",
                                            "modes")}
            if fused_score else None),
        "launches": counts}
    try:
        bad = [(e.job_id, e.status, e.status_description) for e in finals
               if e.status != structs.EVAL_STATUS_COMPLETE]
        check(not bad, f"evals not complete: {bad[:5]}")
        check("failed" not in leg_c, f"leg C: {leg_c.get('failed')}")
        check(leg_c["feas_words"]["equal"], "leg C: the card's "
              "feasibility words differ from the plain version's")
        for key in ("worker.batch_error", "telemetry.tick_error"):
            errors = (m_end["counters"].get(key, 0.0)
                      - m_start["counters"].get(key, 0.0))
            check(errors == 0, f"{errors} {key} in the phase")
        check(broker["by_scheduler"].get(FAILED_QUEUE, 0) == 0,
              "evals parked on the broker's failed queue")
        check(broker["total_unacked"] == 0, f"unacked evals: {broker}")
        check(not down, f"{len(down)} node(s) went down")
        check(all(a is b for a, b in zip(world_objs0, world_objs1)),
              "a worker's world was dropped and built anew in the legs")
        for w0, w1 in zip(worlds0, worlds1):
            check(w1["repack_fallbacks"] == w0["repack_fallbacks"]
                  and w1["delta_syncs"] >= w0["delta_syncs"]
                  and w1["plan_feeds"] >= w0["plan_feeds"],
                  f"a worker's world was rebuilt in the legs: {w0} -> {w1}")
        check(set(solve_backends) == {"device"}
              and solve_backends["device"] >= n_serial,
              f"config-3 solve spans by route: {dict(solve_backends)}")
        check(counts_a["topk"] > 0
              and counts_a["merge"] == counts_a["topk"],
              f"leg A launches {counts_a}")
        check(counts_b["score"] > 0,
              f"leg B launched no score kernel: {counts_b}")
        # placements the wave budget left undecided go to a blocked eval
        # of their job (the eval's own queued_allocations is not read:
        # the server path never decrements it, in the reference too)
        for job_id, got in names.items():
            check(got == plans_placed.get(job_id, []),
                  f"{job_id}: the store holds {len(got)} allocs, the "
                  f"plans placed {len(plans_placed.get(job_id, []))}")
            check(len(set(got)) == len(got), f"{job_id}: duplicate names")
            check(unplaced[job_id] == 0 or job_id in blocked_jobs,
                  f"{job_id}: {unplaced[job_id]} placements neither "
                  "placed nor left to a blocked eval")
        for n in srv.store.nodes():
            live = srv.store.allocs_by_node_terminal(n.id, False)
            fit, dim, _used = structs.allocs_fit(n, live)
            check(fit, f"node {n.name} oversubscribed ({dim})")
        check(any(r["evals"] >= 2 for r in rounds_b),
              f"leg B fused no round of two or more evals: "
              f"{[r['evals'] for r in rounds_b]}")
        check(fused_score, "no fused round ran the score kernel")
        calls = kernel_vs_plain(wk, (("first fused score round",
                                      fused_score[0]["pb"], "score"),))
    except PhaseError as e:
        row["failed"] = str(e)
        emit(row)
        if then is not None:
            srv.stop()
        raise
    row["checks"] = {"kernel_vs_plain": "passed"}
    emit(row)
    total = {m: counts_a[m] + counts_b[m] for m in counts_a}
    if then is None:
        return total, calls, row, None
    try:
        return total, calls, row, then(srv)
    finally:
        srv.stop()


# ------------------------------------------------------------ phase 13
#: Nomad's server options min_heartbeat_ttl, max_heartbeats_per_second and
#: heartbeat_grace, set on the server's heartbeater so that a node that
#: stops heartbeating is noticed within about 5 s at 10,000 nodes (a TTL
#: of 2 s, its stagger of up to 2 s, a grace of 1 s; at Nomad's default
#: of 50 beats a second the rate-scaled TTL would be 200 s)
LIFE_MIN_TTL_S = 2.0
LIFE_BEATS_PER_S = 10_000.0
LIFE_GRACE_S = 1.0
#: the beat thread beats every live node once a period
LIFE_BEAT_S = 0.5
#: a simulated client's poll of its node's allocs, and the most clients
#: the phase runs (one thread each; the legs' placements land on ≈ 450
#: nodes of 10,000)
LIFE_POLL_S = 0.5
LIFE_MAX_CLIENTS = 600
LIFE_COUNT = 64
LIFE_LOST = 16
LIFE_DRAIN = 4
LIFE_MIGRATE_PARALLEL = 2
LIFE_UPDATE_PARALLEL = 8
#: the drain's deadline (`nomad node drain -deadline 10s`): the resident
#: job's one-at-a-time migrations take the rest past it
LIFE_DRAIN_DEADLINE_S = 10.0
LIFE_BATCH_RUNTIME_S = 1.0
LIFE_WAIT_S = 120.0
#: the cron of the periodic leg: it never fires by itself in a run
LIFE_CRON = "0 0 1 1 *"
#: job fields the store stamps at registration, not part of a jobspec
STORE_STAMPED = ("create_index", "modify_index", "job_modify_index")


def lifecycle_hcl(name, count, batch=False):
    """make_job's config-3 job written as an HCL jobspec, with Nomad's
    update (max_parallel 8) and migrate (max_parallel 2) stanzas; with
    `batch` a periodic batch job of the same shape whose tasks complete
    (no update stanza: batch jobs roll no deployment)."""
    def group(g):
        cpu, mem = 400 + (g % 4) * 150, 256 + (g % 4) * 128
        outcome = (f'mock_outcome = "complete"  mock_runtime_s = '
                   f'{LIFE_BATCH_RUNTIME_S}' if batch else "")
        return f'''
  group "g{g}" {{
    count = {count // 4}
    restart {{ attempts = 3  interval = "10m"  delay = "1m"  mode = "delay" }}
    reschedule {{
      attempts = 2
      interval = "10m"
      delay = "5s"
      delay_function = "constant"
      unlimited = false
    }}
    ephemeral_disk {{ size = 300 }}
    migrate {{ max_parallel = {LIFE_MIGRATE_PARALLEL} }}
    meta {{ elb_check_type = "http" }}
    task "web" {{
      driver = "exec"
      config {{ command = "/bin/date"  {outcome} }}
      env {{ FOO = "bar" }}
      resources {{ cpu = {cpu}  memory = {mem} }}
    }}
  }}'''
    head = (f'type = "batch"\n  periodic {{ cron = "{LIFE_CRON}"  '
            'prohibit_overlap = true }' if batch else
            f'update {{\n    max_parallel = {LIFE_UPDATE_PARALLEL}\n'
            '    min_healthy_time = "0s"\n  }')
    return f'''
job "{name}" {{
  datacenters = ["dc0", "dc1", "dc2", "dc3"]
  {head}
  meta {{ owner = "armon" }}
  constraint {{ attribute = "${{attr.rack}}"  operator = "!="  value = "r63" }}
  constraint {{ attribute = "${{attr.zone}}"  operator = ">="  value = "z1" }}
  affinity {{ attribute = "${{attr.rack}}"  value = "r7"  weight = 35 }}
  spread {{ attribute = "${{node.datacenter}}"  weight = 50 }}
{"".join(group(g) for g in range(4))}
}}
'''


def lifecycle_job(mock, structs, name, count, batch=False):
    """The job lifecycle_hcl describes, built as make_job builds it."""
    job = make_job(mock, structs, name, count)
    job.id = job.name = name
    if batch:
        job.type = structs.JOB_TYPE_BATCH
        job.periodic = structs.PeriodicConfig(spec=LIFE_CRON,
                                              prohibit_overlap=True)
    else:
        job.update = structs.UpdateStrategy(
            max_parallel=LIFE_UPDATE_PARALLEL, min_healthy_time_s=0.0)
    for tg in job.task_groups:
        tg.update = job.update
        tg.migrate = structs.MigrateStrategy(
            max_parallel=LIFE_MIGRATE_PARALLEL)
        if batch:
            tg.tasks[0].config = {"command": "/bin/date",
                                  "mock_outcome": "complete",
                                  "mock_runtime_s": LIFE_BATCH_RUNTIME_S}
    return job


def parsed_job(structs, hcl, built):
    """The port's jobspec parse of `hcl`; it must equal `built` field by
    field in the wire encoding (but for what the store stamps)."""
    from nomad_tpu_torch.jobspec import parse_job
    from nomad_tpu_torch.utils.codec import to_wire
    job = parse_job(hcl)
    got, want = to_wire(job), to_wire(built)
    for k in STORE_STAMPED:
        got.pop(k, None)
        want.pop(k, None)
    diff = sorted(k for k in set(got) | set(want) if got.get(k)
                  != want.get(k))
    check(not diff, f"the HCL job differs from make_job's in {diff}")
    return job


class LifecycleClients:
    """Phase 13's client side.  One thread heartbeats every live node
    once a LIFE_BEAT_S (`silence` takes nodes out), and a `SimClient`
    runs the allocs of each node that an alloc placed in the phase lands
    on (the FSM's plan entries name the nodes), started when it lands
    and without registering the node again (it is registered and the
    beat thread heartbeats it; a registration would unblock every blocked
    eval of its class); at most LIFE_MAX_CLIENTS, once `tracking` is on.
    `last_pb` is the packed batch of the last solve
    (`Solver.solve_async`)."""

    def __init__(self, srv):
        import gc
        import threading
        from nomad_tpu_torch.client.sim import SimClient
        from nomad_tpu_torch.solver.solve import Solver

        class AllocRunner(SimClient):
            def start(self):
                self._stop.clear()
                self._thread = threading.Thread(target=self._run,
                                                daemon=True)
                self._thread.start()
        self.srv, self.AllocRunner = srv, AllocRunner
        self.clients, self.silent = {}, set()
        self.overflow = 0
        self.last_pb = None
        self.tracking = False
        self._landed, self._lock = set(), threading.Lock()
        self._stop = threading.Event()
        self.beat_max_s, self.beat_rounds = 0.0, 0
        # what a missed beat is read against: each node's last beat, the
        # expiries (s into the phase, node, s since its last beat), the
        # slow beat rounds and the collector's pauses
        self.t0 = time.perf_counter()
        self.last_beat, self.expired, self.slow_rounds = {}, [], []
        self.gc_pauses = collections.Counter()
        self.gc_max_s = 0.0
        restore = []
        hb = srv.heartbeater
        real_expire = hb._on_expire

        def on_expire(nid):
            now = time.perf_counter()
            self.expired.append((round(now - self.t0, 3), nid[:8], round(
                now - self.last_beat.get(nid, self.t0), 3)))
            return real_expire(nid)
        hb._on_expire = on_expire
        restore.append(lambda: setattr(hb, "_on_expire", real_expire))
        gc_start = []

        def on_gc(phase, info):
            if phase == "start":
                gc_start[:] = [time.perf_counter()]
            elif gc_start:
                took = time.perf_counter() - gc_start[0]
                self.gc_pauses[info["generation"]] += 1
                self.gc_max_s = max(self.gc_max_s, took)
        gc.callbacks.append(on_gc)
        restore.append(lambda: gc.callbacks.remove(on_gc))
        real_apply = srv.fsm.apply

        def apply(index, etype, payload):
            out = real_apply(index, etype, payload)
            items = (payload.get("items", ()) if etype == "plan_results_batch"
                     else (payload,) if etype == "plan_result" else ())
            nodes = {nid for it in items
                     for nid in it["result"].get("node_allocation") or ()}
            if nodes and self.tracking:
                with self._lock:
                    self._landed |= nodes
            return out
        srv.fsm.apply = apply
        restore.append(lambda: setattr(srv.fsm, "apply", real_apply))
        real_async = Solver.solve_async

        def solve_async(solver, *a, **kw):
            pending = real_async(solver, *a, **kw)
            self.last_pb = snapshot_pb(pending.packed)
            return pending
        Solver.solve_async = solve_async
        restore.append(lambda: setattr(Solver, "solve_async", real_async))
        self._restore = restore
        self._threads = [threading.Thread(target=fn, daemon=True)
                         for fn in (self._beat, self._start_clients)]
        for t in self._threads:
            t.start()

    def _beat(self):
        from nomad_tpu_torch.structs import NODE_STATUS_DOWN
        ids = [n.id for n in list(self.srv.store.nodes())
               if n.status != NODE_STATUS_DOWN]
        while not self._stop.is_set():
            t = time.perf_counter()
            for nid in ids:
                if nid not in self.silent:
                    self.srv.node_heartbeat(nid)
                    self.last_beat[nid] = time.perf_counter()
            took = time.perf_counter() - t
            self.beat_max_s = max(self.beat_max_s, took)
            self.beat_rounds += 1
            if took > LIFE_BEAT_S:
                self.slow_rounds.append((round(t - self.t0, 3),
                                         round(took, 3)))
            self._stop.wait(max(0.0, LIFE_BEAT_S - took))

    def _start_clients(self):
        while not self._stop.wait(0.05):
            with self._lock:
                landed, self._landed = self._landed, set()
            for nid in landed - set(self.clients) - self.silent:
                if len(self.clients) >= LIFE_MAX_CLIENTS:
                    self.overflow += 1
                    continue
                node = self.srv.store.node_by_id(nid)
                c = self.AllocRunner(self.srv, node,
                                     poll_interval_s=LIFE_POLL_S)
                c.start()
                self.clients[nid] = c

    def silence(self, node_ids):
        """The nodes stop heartbeating and their clients stop."""
        self.silent |= set(node_ids)
        for nid in node_ids:
            c = self.clients.pop(nid, None)
            if c is not None:
                c.stop()

    def diagnostics(self):
        return {"beat_max_s": self.beat_max_s,
                "beat_rounds": self.beat_rounds,
                "slow_rounds": self.slow_rounds[:20],
                "expired": len(self.expired),
                "first_expiries": self.expired[:10],
                "gc_pauses": dict(self.gc_pauses),
                "gc_max_s": self.gc_max_s}

    def close(self):
        self._stop.set()
        for t in self._threads:
            t.join(5.0)
        for c in self.clients.values():
            c.stop()
        for fn in reversed(self._restore):
            fn()


def settle(srv, structs, what, idx0):
    """Wait until the broker holds nothing ready or unacked and no eval
    written since index `idx0` is pending; then every such eval must be
    complete, blocked (the rest of an eval) or cancelled (a duplicate
    blocked eval).  Returns those evals."""
    def quiet():
        b = srv.broker.stats()
        return (b["total_ready"] == 0 and b["total_unacked"] == 0
                and not any(e.status == structs.EVAL_STATUS_PENDING
                            for e in list(srv.store.evals())
                            if e.modify_index > idx0))
    try:
        wait_for(quiet, f"{what}: the evals to settle", LIFE_WAIT_S)
    except PhaseError as e:
        raise PhaseError(f"{e}: {settle_state(srv, structs, idx0)}") \
            from None
    evals = [e for e in list(srv.store.evals()) if e.modify_index > idx0]
    bad = [(e.job_id, e.triggered_by, e.status, e.status_description)
           for e in evals if e.status not in (
               structs.EVAL_STATUS_COMPLETE, structs.EVAL_STATUS_BLOCKED,
               structs.EVAL_STATUS_CANCELLED)]
    check(not bad, f"{what}: evals neither complete nor blocked: {bad[:5]}")
    for e in evals:
        check(not e.blocked_eval or srv.store.eval_by_id(e.blocked_eval)
              is not None, f"{what}: eval {e.id} names a missing blocked "
              "eval")
    return evals


def settle_state(srv, structs, idx0):
    """What an unsettled leg left: the broker's and the blocked evals'
    counts, the evals written since `idx0` by (status, trigger), the
    nodes down."""
    evals = collections.Counter(
        (e.status, e.triggered_by) for e in list(srv.store.evals())
        if e.modify_index > idx0)
    b = srv.broker.stats()
    return {"broker": {k: b[k] for k in ("total_ready", "total_unacked",
                                         "total_blocked", "total_waiting")},
            "blocked_evals": srv.blocked_evals.stats(),
            "evals": {f"{s}/{t}": n for (s, t), n in evals.items()},
            "nodes_down": sum(n.status == structs.NODE_STATUS_DOWN
                              for n in list(srv.store.nodes()))}


def drain_blocked(srv, structs):
    """Run the blocked evals a phase left (phase 7's leg B leaves
    thousands of placements to them) until they place no more, so that
    phase 13's legs start from a quiet server; each round unblocks them
    all and waits until they settled.  Returns the rounds' record."""
    rounds = []
    t = time.perf_counter()
    for _ in range(4):
        blocked = srv.blocked_evals.stats()["total_blocked"]
        allocs = len(srv.store.allocs())
        if not blocked:
            break
        idx0 = srv.store.latest_index()
        srv.blocked_evals.unblock_all(idx0)
        settle(srv, structs, "phase 7's blocked evals", idx0)
        placed = len(srv.store.allocs()) - allocs
        rounds.append({"blocked": blocked, "placed": placed})
        if not placed:
            break
    return {"rounds": rounds, "seconds": time.perf_counter() - t,
            "blocked_after": srv.blocked_evals.stats()["total_blocked"]}


def leg_resolve(torch, wk, what, pb):
    """The leg's captured packed batch re-solved with the kernel and the
    plain wave under assert_same, in the mode its wave loop takes."""
    from nomad_tpu_torch.solver.solve import _run_kernel
    check(pb is not None, f"{what}: no solve captured")
    seen = collections.Counter()
    real = wk.fused_wave

    def wave(**kw):
        seen[kw["mode"]] += 1
        return real(**kw)
    wave.launches, wave.mode_launches = real.launches, real.mode_launches
    wk.fused_wave = wave
    try:
        _run_kernel(pb, DEVICE)
    finally:
        wk.fused_wave = real
    torch.cuda.synchronize()
    check(seen, f"{what}: the re-solve launched no wave kernel")
    mode = "topk" if seen["topk"] else "score"
    kernel_vs_plain(wk, ((what, pb, mode),))
    return mode


def nodes_fit(srv, structs, what):
    for n in list(srv.store.nodes()):
        live = srv.store.allocs_by_node_terminal(n.id, False)
        fit, dim, _used = structs.allocs_fit(n, live)
        check(fit, f"{what}: node {n.name} oversubscribed ({dim})")


def phase_lifecycle(torch, wk, srv):
    """Phase 13 on phase 7's server (its state, no cut): the lifecycle
    of jobs.  Legs J (an HCL jobspec parsed and registered), H (nodes
    stop heartbeating), D (a drain), R (a rolling update), P (a periodic
    batch job forced).  Returns the launch counts of the legs."""
    import copy
    import gc
    import threading
    from nomad_tpu_torch import mock, structs
    from nomad_tpu_torch.utils.metrics import global_metrics
    t_phase = time.perf_counter()
    # a full collection over phase 7's heap (100,000 allocs) stops every
    # thread for seconds, past the heartbeat TTL: the state is frozen out
    # of the collector for the phase (phase 12 does the same), which
    # keeps collecting what the phase makes
    gc.collect()
    gc.freeze()
    hb = srv.heartbeater
    hb.min_ttl, hb.max_rate, hb.grace = (LIFE_MIN_TTL_S, LIFE_BEATS_PER_S,
                                         LIFE_GRACE_S)
    row = {"phase": "lifecycle", "nodes": len(srv.store.nodes()),
           "reduced": {
               "heartbeat": {"min_heartbeat_ttl_s": LIFE_MIN_TTL_S,
                             "max_heartbeats_per_second": LIFE_BEATS_PER_S,
                             "heartbeat_grace_s": LIFE_GRACE_S,
                             "why": "a missed beat noticed within about "
                                    "5 s at 10,000 nodes; Nomad's 50 beats "
                                    "a second give a 200 s TTL"},
               "clients": f"SimClients on the nodes the phase's allocs "
                          f"land on (at most {LIFE_MAX_CLIENTS}), one "
                          "thread heartbeating every node",
               "client_poll_s": LIFE_POLL_S},
           "gc_frozen_objects": gc.get_freeze_count()}
    legs = {}
    total = collections.Counter()
    m_start = global_metrics.dump()
    clients = LifecycleClients(srv)
    ns = structs.DEFAULT_NAMESPACE

    def allocs(job_id):
        return srv.store.allocs_by_job(ns, job_id)

    def running(job_id):
        return [a for a in allocs(job_id) if not a.terminal_status()
                and a.client_status == structs.ALLOC_CLIENT_RUNNING]

    def leg(name, idx0, modes=("topk", "score")):
        """The leg's checks after it settled: evals, fit, launches, the
        kernel against the plain wave on the leg's last solve."""
        evals = settle(srv, structs, name, idx0)
        nodes_fit(srv, structs, name)
        torch.cuda.synchronize()
        counts = dict(wk.fused_wave.mode_launches)
        check(any(counts[m] for m in modes),
              f"{name}: no wave kernel launch ({counts})")
        check(counts["merge"] == counts["topk"],
              f"{name}: merge launches {counts}")
        total.update(counts)
        out = {"evals": len(evals),
               "evals_by_trigger": dict(collections.Counter(
                   e.triggered_by for e in evals)),
               "launches": counts,
               "resolved_mode": leg_resolve(torch, wk, name,
                                            clients.last_pb)}
        legs[name] = out
        return out

    def start_leg():
        zero_launches(torch, wk)
        clients.last_pb = None
        return srv.store.latest_index()

    try:
        row["phase7_blocked_drained"] = drain_blocked(srv, structs)
        clients.tracking = True

        # ---- J: the config-3 job as an HCL jobspec, parsed, registered
        idx0 = start_leg()
        name = "job-3-life"
        built = lifecycle_job(mock, structs, name, LIFE_COUNT)
        t = time.perf_counter()
        job = parsed_job(structs, lifecycle_hcl(name, LIFE_COUNT), built)
        parse_ms = 1e3 * (time.perf_counter() - t)
        t = time.perf_counter()
        ev = srv.register_job(job)
        wait_evals(srv, [ev.id], LIFE_WAIT_S)
        eval_s = time.perf_counter() - t
        wait_for(lambda: len(running(job.id)) == LIFE_COUNT,
                 "J: the job's allocs running", LIFE_WAIT_S)
        running_s = time.perf_counter() - t
        wait_for(lambda: any(d.status == structs.DEPLOYMENT_STATUS_SUCCESSFUL
                             for d in srv.store.deployments_by_job(
                                 ns, job.id)), "J: the deployment",
                 LIFE_WAIT_S)
        out = leg("J", idx0)
        out.update(parse_ms=parse_ms, eval_s=eval_s, running_s=running_s,
                   deployment_s=time.perf_counter() - t,
                   hcl_equals_make_job=True,
                   clients=len(clients.clients))

        # ---- H: nodes holding the job's allocs stop heartbeating
        idx0 = start_leg()
        on = sorted({a.node_id for a in running(job.id)})
        check(len(on) >= LIFE_LOST, f"H: the job runs on {len(on)} nodes")
        lost_nodes = on[:LIFE_LOST]
        lost = [(a.job_id, a.name) for nid in lost_nodes
                for a in srv.store.allocs_by_node(nid)
                if not a.terminal_status()]
        t = time.perf_counter()
        clients.silence(lost_nodes)
        down_s = wait_for(lambda: all(
            srv.store.node_by_id(nid).status == structs.NODE_STATUS_DOWN
            for nid in lost_nodes), "H: the silent nodes down", LIFE_WAIT_S)
        gone = set(lost_nodes)
        lost_names = collections.defaultdict(set)
        for job_id, n in lost:
            lost_names[job_id].add(n)
        job_done_s = {}

        def replaced():
            # each job's lost allocs replaced and running, first seen
            for job_id, names in lost_names.items():
                if job_id in job_done_s:
                    continue
                up = {a.name for a in allocs(job_id)
                      if a.node_id not in gone and not a.terminal_status()
                      and a.client_status == structs.ALLOC_CLIENT_RUNNING}
                if names <= up:
                    job_done_s[job_id] = time.perf_counter() - t
            return len(job_done_s) == len(lost_names)
        replaced_s = wait_for(replaced, "H: every lost alloc replaced and "
                              "running", LIFE_WAIT_S)
        out = leg("H", idx0)
        out.update(nodes=LIFE_LOST, lost_allocs=len(lost),
                   lost_by_job=dict(collections.Counter(j for j, _ in lost)),
                   down_s=down_s, replaced_running_s=replaced_s,
                   replaced_running_s_by_job=job_done_s,
                   clients=len(clients.clients))

        # ---- D: a drain of nodes holding the job's allocs
        idx0 = start_leg()
        on = sorted({a.node_id for a in running(job.id)} - gone)
        check(len(on) >= LIFE_DRAIN, f"D: the job runs on {len(on)} nodes")
        drained = on[:LIFE_DRAIN]
        groups = {tg.name: tg.count for tg in job.task_groups}
        in_flight = collections.Counter()
        marked_max = collections.Counter()
        sampling = threading.Event()

        def sample():
            # a group's migrations in flight, as the drainer counts them:
            # its count less its healthy allocs (running, not marked)
            while not sampling.is_set():
                healthy = collections.Counter(
                    a.task_group for a in allocs(job.id)
                    if not a.terminal_status()
                    and not a.desired_transition.should_migrate()
                    and a.client_status == structs.ALLOC_CLIENT_RUNNING)
                for g, c in groups.items():
                    in_flight[g] = max(in_flight[g], c - healthy[g])
                marked = collections.Counter(
                    (a.job_id, a.task_group) for nid in drained
                    for a in srv.store.allocs_by_node(nid)
                    if not a.terminal_status()
                    and a.desired_transition.should_migrate())
                for k, c in marked.items():
                    marked_max[f"{k[0]}.{k[1]}"] = max(
                        marked_max[f"{k[0]}.{k[1]}"], c)
                time.sleep(0.02)
        sampler = threading.Thread(target=sample, daemon=True)
        t = time.perf_counter()
        for nid in drained:
            srv.update_node_drain(nid, structs.DrainStrategy(
                deadline_s=LIFE_DRAIN_DEADLINE_S))
        sampler.start()
        try:
            # the pacing holds until the deadline forces the rest
            paced = {}
            while time.perf_counter() - t < LIFE_DRAIN_DEADLINE_S - 1.0:
                paced = dict(in_flight)
                if all(srv.store.node_by_id(nid).drain_strategy is None
                       for nid in drained):
                    break
                time.sleep(0.05)
            wait_for(lambda: all(
                srv.store.node_by_id(nid).drain_strategy is None
                for nid in drained), "D: the drains", LIFE_WAIT_S)
            drained_s = time.perf_counter() - t
        finally:
            sampling.set()
            sampler.join(5.0)
        check(all(v <= LIFE_MIGRATE_PARALLEL for v in paced.values())
              and any(paced.values()), f"D: migrations in flight per group "
              f"before the deadline {paced} (migrate max_parallel "
              f"{LIFE_MIGRATE_PARALLEL})")
        for nid in drained:
            n = srv.store.node_by_id(nid)
            left = [a.name for a in srv.store.allocs_by_node(nid)
                    if not a.terminal_status()]
            check(not left and n.scheduling_eligibility == "ineligible",
                  f"D: node {n.name} drained with {left} left, "
                  f"{n.scheduling_eligibility}")
        wait_for(lambda: len(running(job.id)) == LIFE_COUNT,
                 "D: the job's allocs running again", LIFE_WAIT_S)
        out = leg("D", idx0)
        out.update(nodes=LIFE_DRAIN, deadline_s=LIFE_DRAIN_DEADLINE_S,
                   drained_s=drained_s,
                   max_in_flight_before_deadline=paced,
                   max_in_flight=dict(in_flight),
                   max_marked_on_drained_nodes=dict(marked_max),
                   job_running_s=time.perf_counter() - t,
                   clients=len(clients.clients))

        # ---- R: a rolling update, health from the clients
        idx0 = start_leg()
        v1 = copy.deepcopy(srv.store.job_by_id(ns, job.id))
        for tg in v1.task_groups:
            tg.tasks[0].env = {"FOO": "bar", "VERSION": "2"}
        v1.create_index = v1.modify_index = v1.job_modify_index = 0
        low = [LIFE_COUNT]
        sampling = threading.Event()

        def healthy_low():
            while not sampling.is_set():
                low[0] = min(low[0], len(running(job.id)))
                time.sleep(0.02)
        sampler = threading.Thread(target=healthy_low, daemon=True)
        sampler.start()
        t = time.perf_counter()
        try:
            srv.register_job(v1)
            version = srv.store.job_by_id(ns, job.id).version

            def rolled():
                d = [d for d in srv.store.deployments_by_job(ns, job.id)
                     if d.job_version == version]
                return d and d[0].status == \
                    structs.DEPLOYMENT_STATUS_SUCCESSFUL
            rolled_s = wait_for(rolled, "R: the rolling deployment",
                                LIFE_WAIT_S)
        finally:
            sampling.set()
            sampler.join(5.0)
        new = [a for a in running(job.id)
               if a.job is not None and a.job.version == version]
        check(len(new) == LIFE_COUNT, f"R: {len(new)} of {LIFE_COUNT} "
              "allocs run the new version")
        floor = LIFE_COUNT - len(job.task_groups) * LIFE_UPDATE_PARALLEL
        check(low[0] >= floor, f"R: {low[0]} healthy allocs at the low, "
              f"below {floor}")
        out = leg("R", idx0)
        out.update(count=LIFE_COUNT, max_parallel=LIFE_UPDATE_PARALLEL,
                   version=version, rolled_s=rolled_s,
                   fewest_healthy=low[0], clients=len(clients.clients))

        # ---- P: a periodic batch job, forced
        idx0 = start_leg()
        pname = "job-3-cron"
        pjob = parsed_job(structs, lifecycle_hcl(pname, LIFE_COUNT,
                                                 batch=True),
                          lifecycle_job(mock, structs, pname, LIFE_COUNT,
                                        batch=True))
        check(srv.register_job(pjob) is None, "P: the periodic template "
              "was evaluated")
        t = time.perf_counter()
        child = srv.periodic.force_launch(ns, pjob.id)
        check(child is not None and child.parent_id == pjob.id
              and child.id.startswith(f"{pjob.id}/periodic-"),
              f"P: force_launch gave {child and child.id}")
        evs = srv.store.evals_by_job(ns, child.id)
        check(len(evs) == 1, f"P: {len(evs)} evals of the child")
        wait_evals(srv, [evs[0].id], LIFE_WAIT_S)
        placed_s = time.perf_counter() - t
        done_s = wait_for(lambda: sum(
            a.client_status == structs.ALLOC_CLIENT_COMPLETE
            for a in allocs(child.id)) == LIFE_COUNT,
            "P: the child's allocs complete", LIFE_WAIT_S)
        check(srv.store.periodic_launch(ns, pjob.id) is not None,
              "P: no launch recorded")
        out = leg("P", idx0)
        out.update(child=child.id, placed_s=placed_s,
                   complete_s=placed_s + done_s,
                   clients=len(clients.clients))

        check(clients.overflow == 0, f"{clients.overflow} nodes got no "
              f"client past {LIFE_MAX_CLIENTS}")
        m_end = global_metrics.dump()
        for key in ("worker.batch_error", "telemetry.tick_error"):
            errs = (m_end["counters"].get(key, 0.0)
                    - m_start["counters"].get(key, 0.0))
            check(errs == 0, f"{errs} {key} in the phase")
        down = [n.name for n in list(srv.store.nodes())
                if n.status == structs.NODE_STATUS_DOWN
                and n.id not in gone]
        check(not down, f"nodes down that kept beating: {down[:5]}")
    except PhaseError as e:
        row.update(failed=str(e), legs=legs,
                   diagnostics=clients.diagnostics())
        emit(row)
        raise
    finally:
        clients.close()
        gc.unfreeze()
    row.update(legs=legs, clients=len(clients.clients),
               diagnostics=clients.diagnostics(),
               seconds=time.perf_counter() - t_phase,
               launches={m: total[m] for m in ("score", "topk", "merge")})
    emit(row)
    return row["launches"]


# ------------------------------------------------------------ phase 8
#: the fill tier (bench.py _oc_fill_job): alloc cpu in MHz (memory the
#: same figure in MB, disk FILL_DISK MB) and job priorities
FILL_CPU = (400, 700, 900, 1200)
FILL_PRIOS = (5, 10, 20, 30, 45)
FILL_DISK = 100
#: the smallest config-3 group ask (cpu MHz, memory MB)
MIN_ASK = (400, 256)
#: priority of the jobs that preempt the fill
PREEMPT_PRIORITY = 70
N_PREEMPT_JOBS = 16


def fill_allocs(mock, structs, nodes, seed=0):
    """Fill every node with low-priority running allocs until no config-3
    group ask fits on it without an eviction, each alloc's size and
    priority drawn from a seeded generator.  The five fill jobs (one per
    priority) name a datacenter no node is in.  Returns (jobs by
    priority, allocs by priority)."""
    from nomad_tpu_torch.structs import (AllocatedResources,
                                         AllocatedSharedResources,
                                         AllocatedTaskResources)
    rng = np.random.default_rng(seed)
    jobs, by_job = {}, {p: [] for p in FILL_PRIOS}
    for p in FILL_PRIOS:
        job = mock.job(priority=p)
        job.id = job.name = f"fill-p{p}"
        job.datacenters = ["dc-fill"]
        job.constraints = []
        tg = job.task_groups[0]
        tg.constraints, tg.networks = [], []
        t = tg.tasks[0]
        t.resources.networks = []
        t.resources.cpu = t.resources.memory_mb = FILL_CPU[0]
        tg.ephemeral_disk.size_mb = FILL_DISK
        jobs[p] = job
    for n in nodes:
        free_cpu = n.node_resources.cpu - n.reserved_resources.cpu
        free_mem = n.node_resources.memory_mb - n.reserved_resources.memory_mb
        while free_cpu >= MIN_ASK[0] and free_mem >= MIN_ASK[1]:
            sizes = [c for c in FILL_CPU if c <= min(free_cpu, free_mem)]
            check(sizes, f"node {n.name}: no fill size fits the room a "
                  "config-3 ask still has")
            cpu, p = int(rng.choice(sizes)), int(rng.choice(FILL_PRIOS))
            job = jobs[p]
            a = mock.alloc(job=job, node_id=n.id,
                           name=f"{job.id}.web[{len(by_job[p])}]")
            a.allocated_resources = AllocatedResources(
                tasks={"web": AllocatedTaskResources(cpu=cpu,
                                                     memory_mb=cpu)},
                shared=AllocatedSharedResources(disk_mb=FILL_DISK))
            a.client_status = structs.ALLOC_CLIENT_RUNNING
            by_job[p].append(a)
            free_cpu -= cpu
            free_mem -= cpu
    return jobs, by_job


def fill_cluster(srv, mock, structs, nodes, seed=0):
    """`fill_allocs` entered into a Server that has not started: the
    five fill jobs, then their allocs as plan results of RESIDENT_CHUNK
    allocs.  The follow-up eval the plan applier makes for a job whose
    allocs were preempted then finds no node (the fill jobs' datacenter
    holds none) and leaves a blocked eval, instead of replacing the
    evicted allocs by preempting other fill allocs.  Returns the alloc
    count and seconds."""
    from nomad_tpu_torch.utils.codec import to_wire
    t0 = time.perf_counter()
    jobs, by_job = fill_allocs(mock, structs, nodes, seed)
    for p, job in jobs.items():
        job.task_groups[0].count = len(by_job[p])
        srv._propose("job_upsert", {"job": to_wire(job)})
        allocs = by_job[p]
        for a in allocs:
            a.job = None              # the entry carries the job once
        for c in range(0, len(allocs), RESIDENT_CHUNK):
            result = structs.PlanResult()
            for a in allocs[c:c + RESIDENT_CHUNK]:
                result.node_allocation.setdefault(a.node_id, []).append(a)
            srv._propose("plan_result", {"result": to_wire(result),
                                         "job": to_wire(job)})
    return sum(len(v) for v in by_job.values()), time.perf_counter() - t0


def preempt_job(mock, structs, name, zone=None):
    """A priority-70 config-3 job; with `zone` its zone constraint pins
    it to that one zone (leg P2)."""
    job = make_job(mock, structs, name, COUNT)
    job.priority = PREEMPT_PRIORITY
    if zone is not None:
        job.constraints[1] = structs.Constraint("${attr.zone}", f"z{zone}",
                                                "=")
    return job


def drain_broker(srv, timeout=300):
    """Wait until the broker holds no ready or unacked eval (the
    follow-up evals of preempted jobs); returns the seconds waited."""
    t0 = time.perf_counter()
    while True:
        b = srv.broker.stats()
        if not (b["total_ready"] or b["total_unacked"]):
            return time.perf_counter() - t0
        check(time.perf_counter() - t0 < timeout,
              f"the broker did not drain in {timeout} s: {b}")
        time.sleep(0.01)


def evict_pass_ms(torch, pb):
    """The eviction pass on the card, on one re-solve of `pb` with the
    kernel: each call between CUDA events (the pass reads the wanting
    groups back to the host, so a call's time includes that wait)."""
    from nomad_tpu_torch.solver import kernel as kmod
    from nomad_tpu_torch.solver.solve import _run_kernel, _to_host
    real, marks = kmod.evict_pass, []

    def timed(*a, **kw):
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        e0.record()
        out = real(*a, **kw)
        e1.record()
        marks.append((e0, e1))
        return out
    kmod.evict_pass = timed
    try:
        t = time.perf_counter()
        _to_host(_run_kernel(pb, DEVICE, preempt=True))
        solve_ms = 1e3 * (time.perf_counter() - t)
    finally:
        kmod.evict_pass = real
    torch.cuda.synchronize()
    ms = [a.elapsed_time(b) for a, b in marks]
    return {"calls": len(ms), "total_ms": sum(ms),
            "per_call_p50_ms": pct(ms, 0.5) if ms else None,
            "per_call_max_ms": max(ms) if ms else None,
            "solve_ms": solve_ms}


def victims_ok(store, structs, allocs):
    """Every preempting alloc's `preempted_allocations` equals the set
    of allocs the store marks evicted by it, and each victim's priority
    is at least the gate below the preemptor's.  Returns the faults."""
    from nomad_tpu_torch.scheduler.preemption import PRIORITY_DELTA
    by = collections.defaultdict(set)
    victim = {}
    for a in store.allocs():
        if a.preempted_by_allocation:
            by[a.preempted_by_allocation].add(a.id)
            victim[a.id] = a
    bad = []
    for a in allocs:
        if not a.preempted_allocations:
            continue
        if set(a.preempted_allocations) != by.get(a.id, set()):
            bad.append((a.name, "victim set"))
        for v in (victim.get(x) for x in a.preempted_allocations):
            if v is None or v.desired_status != structs.ALLOC_DESIRED_EVICT:
                bad.append((a.name, "victim not evicted"))
                continue
            prio = store.job_by_id(v.namespace, v.job_id).priority
            if PREEMPT_PRIORITY - prio < PRIORITY_DELTA:
                bad.append((a.name, f"victim priority {prio}"))
    return bad


def phase_preempt(torch, wk, n_nodes, n_serial, n_burst):
    """Service preemption on the server: a port `Server(device=DEVICE)`
    with phase 7's serving tier and `preemption_service_enabled`, the
    config-3 nodes each filled by `fill_cluster`, then priority-70
    config-3 jobs that place only by evicting: leg P1 one at a time (the
    single lane: topk wave plus the eviction pass), leg P2 a burst
    registered while the workers are paused and released together (a
    fused round: score wave plus the eviction pass).  Returns the launch
    counts of the legs."""
    import gc
    from nomad_tpu_torch import mock, structs
    from nomad_tpu_torch.server.eval_broker import FAILED_QUEUE
    from nomad_tpu_torch.server.server import Server
    from nomad_tpu_torch.server.worker import DEQUEUE_TIMEOUT_S
    from nomad_tpu_torch.solver import kernel as kmod
    from nomad_tpu_torch.solver.kernel import MAX_WAVES
    from nomad_tpu_torch.solver.solve import Solver, _run_kernel, _to_host
    from nomad_tpu_torch.utils.metrics import global_metrics
    from nomad_tpu_torch.utils.tracing import global_tracer
    on_card = DEVICE == "cuda"
    wk._load()
    srv = Server(device=DEVICE)
    check(srv.serving.evict_e == 8 and len(srv.workers) == 2
          and srv.solve_coordinator is not None,
          "not phase 7's serving tier with eviction planes of width 8")
    t0 = time.perf_counter()
    nodes = make_nodes(mock, n_nodes)
    for n in nodes:
        srv.register_node(n)
    nodes_s = time.perf_counter() - t0
    srv._propose("scheduler_config", {"config": {
        "preemption_service_enabled": True}})
    n_fill, fill_s = fill_cluster(srv, mock, structs, nodes)
    # leg P2's round fuses its jobs; the follow-up rounds of the
    # preempted fill jobs fuse at most five evals
    probe = ServerProbe(srv, wk, min_kept_evals=8)
    # the eviction pass's calls (one per wave it runs in), and the first
    # single-lane batches of leg P1 as they were solved
    real_pass, real_async = kmod.evict_pass, Solver.solve_async
    pass_calls = collections.Counter()
    capture = {"on": False, "batches": []}

    def counted_pass(*a, **kw):
        pass_calls["n"] += 1
        return real_pass(*a, **kw)

    def solve_async(solver, *a, **kw):
        pending = real_async(solver, *a, **kw)
        if capture["on"] and kw.get("preempt") \
                and len(capture["batches"]) < n_serial:
            capture["batches"].append(snapshot_pb(pending.packed))
        return pending
    kmod.evict_pass, Solver.solve_async = counted_pass, solve_async
    registered, legs = [], {}
    m_start = global_metrics.dump()
    try:
        srv.start()
        world_build_ms = warm_worlds(
            srv, lambda i: preempt_job(mock, structs, f"pwarm{i}"),
            registered)
        worlds0 = world_counters(srv)
        world_objs0 = [w._solver._world for w in srv.workers]

        for leg in ("p1", "p2"):
            gc.collect()
            zero_launches(torch, wk)
            pass_calls.clear()
            if on_card:
                torch.cuda.reset_peak_memory_stats()
            mark, m0 = probe.mark(), global_metrics.dump()
            rec = {"evals": [], "walls": [], "splits": [], "attrs": []}
            if leg == "p1":
                capture["on"] = True
                rec["drain_s"] = []
                for e in range(n_serial):
                    # the previous plan's follow-up evals first, so this
                    # eval rides the single lane alone
                    rec["drain_s"].append(drain_broker(srv))
                    t = time.perf_counter()
                    ev = srv.register_job(preempt_job(
                        mock, structs, f"p1-{e}", zone=e % 16))
                    registered.append(ev.id)
                    wait_evals(srv, [ev.id], 120)
                    rec["walls"].append(time.perf_counter() - t)
                    split, attrs = eval_split(global_tracer, ev.id)
                    rec["splits"].append(split)
                    rec["attrs"].append(attrs)
                    rec["evals"].append(ev.id)
                capture["on"] = False
            else:
                rec["drain_s"] = [drain_broker(srv)]
                for w in srv.workers:
                    w.paused.set()
                time.sleep(2 * DEQUEUE_TIMEOUT_S)
                t = time.perf_counter()
                rec["evals"] = [srv.register_job(preempt_job(
                    mock, structs, f"p2-{e}", zone=e % 16)).id
                    for e in range(n_burst)]
                rec["register_s"] = time.perf_counter() - t
                registered += rec["evals"]
                t = time.perf_counter()
                for w in srv.workers:
                    w.paused.clear()
                wait_evals(srv, rec["evals"], 600)
                rec["wall_s"] = time.perf_counter() - t
                deadline = time.perf_counter() + 60
                while srv.broker.stats()["total_unacked"] \
                        and time.perf_counter() < deadline:
                    time.sleep(0.001)
            torch.cuda.synchronize()
            rec["launches"] = dict(wk.fused_wave.mode_launches)
            rec["evict_pass_calls"] = pass_calls["n"]
            rec["peak_mem_mb"] = (torch.cuda.max_memory_allocated() / 2**20
                                  if on_card else None)
            rec["m0"], rec["m1"] = m0, global_metrics.dump()
            rec["probe"] = probe.since(mark)
            legs[leg] = rec
        worlds1 = world_counters(srv)
        world_objs1 = [w._solver._world for w in srv.workers]
        m_end = global_metrics.dump()
        broker = srv.broker.stats()
        blocked = srv.blocked_evals.stats()
    finally:
        kmod.evict_pass, Solver.solve_async = real_pass, real_async
        probe.close()
        srv.stop()

    # ---- the record, then the checks (launches here are not counted)
    finals = {eid: srv.store.eval_by_id(eid) for eid in registered}
    blocked_jobs = {e.job_id for e in srv.store.evals()
                    if e.status == structs.EVAL_STATUS_BLOCKED}
    rows, counts = {}, {}
    for leg, rec in legs.items():
        jobs = [finals[x].job_id for x in rec["evals"]]
        allocs = [a for j in jobs for a in srv.store.allocs_by_job(
            structs.DEFAULT_NAMESPACE, j)]
        names = {j: sorted(a.name for a in allocs if a.job_id == j)
                 for j in jobs}
        evictions = sum(len(a.preempted_allocations) for a in allocs)

        def moved(key, rec=rec):
            return (rec["m1"]["counters"].get(key, 0.0)
                    - rec["m0"]["counters"].get(key, 0.0))
        wall_s = (sum(rec["walls"]) if leg == "p1" else rec["wall_s"])
        row = {"evals": len(rec["evals"]), "count": COUNT,
               "placed": len(allocs),
               "unplaced": COUNT * len(jobs) - len(allocs),
               "evictions": evictions,
               "evictions_per_s": evictions / wall_s,
               "preempting_allocs": sum(bool(a.preempted_allocations)
                                        for a in allocs),
               "scheduler.preempt.kernel": moved("scheduler.preempt.kernel"),
               "scheduler.preempt.host_fallback":
                   moved("scheduler.preempt.host_fallback"),
               "wave_budget": 2 * MAX_WAVES,
               "evict_pass_calls": rec["evict_pass_calls"],
               "launches": rec["launches"],
               "peak_mem_mb": rec["peak_mem_mb"],
               "dequeue_sizes": rec["probe"]["dequeues"],
               "follow_up_drain_s": rec["drain_s"]}
        if leg == "p1":
            walls = [1e3 * w for w in rec["walls"]]
            row.update({
                "p50_ms": pct(walls, 0.5), "p99_ms": pct(walls, 0.99),
                "walls_ms": walls,
                "split_p50_ms": {k: pct([x[k] for x in rec["splits"]], 0.5)
                                 for k in rec["splits"][0]},
                "split_p99_ms": {k: pct([x[k] for x in rec["splits"]], 0.99)
                                 for k in rec["splits"][0]},
                "waves": [a["waves"] for a in rec["attrs"]],
                "evict_commits": [a.get("evict_commits")
                                  for a in rec["attrs"]]})
        else:
            row.update({
                "register_s": rec["register_s"], "wall_s": rec["wall_s"],
                "evals_per_s": len(rec["evals"]) / rec["wall_s"],
                "rounds": [{k: r.get(k) for k in (
                    "evals", "solvable", "asks", "Gp", "K", "modes",
                    "waves", "evict_commits", "stages_ms")}
                    for r in rec["probe"]["rounds"]]})
        rows[leg] = (row, names, allocs)
        counts[leg] = rec["launches"]
    fused_score = sorted((r for r in legs["p2"]["probe"]["rounds"]
                          if r["pb"] is not None),
                         key=lambda r: -r["evals"])
    out = {"phase": "preempt", "nodes": n_nodes, "fill_allocs": n_fill,
           "setup_s": {"nodes_s": nodes_s, "fill_s": fill_s},
           "world_build_ms": world_build_ms,
           "worlds_before_legs": worlds0, "worlds_after_legs": worlds1,
           "leg_p1": rows["p1"][0], "leg_p2": rows["p2"][0],
           "follow_up_evals": sum(1 for e in srv.store.evals()
                                  if e.triggered_by
                                  == structs.EVAL_TRIGGER_PREEMPTION),
           "blocked_evals": blocked, "broker": broker,
           "launches": counts}
    try:
        bad = [(e.job_id, e.status, e.status_description)
               for e in finals.values()
               if e.status != structs.EVAL_STATUS_COMPLETE]
        check(not bad, f"evals not complete: {bad[:5]}")
        for key in ("worker.batch_error", "telemetry.tick_error"):
            errors = (m_end["counters"].get(key, 0.0)
                      - m_start["counters"].get(key, 0.0))
            check(errors == 0, f"{errors} {key} in the phase")
        # follow-up evals of the last plans may still be in flight
        check(broker["by_scheduler"].get(FAILED_QUEUE, 0) == 0,
              "evals parked on the broker's failed queue")
        check(all(a is b for a, b in zip(world_objs0, world_objs1)),
              "a worker's world was dropped and built anew in the legs")
        for w0, w1 in zip(worlds0, worlds1):
            check(w1["repack_fallbacks"] == w0["repack_fallbacks"],
                  f"a worker's world was rebuilt in the legs: {w0} -> {w1}")
        for leg, (row, names, allocs) in rows.items():
            check(row["scheduler.preempt.kernel"] > 0,
                  f"leg {leg}: the kernel's eviction pass committed nothing")
            bad = victims_ok(srv.store, structs, allocs)
            check(not bad, f"leg {leg}: victims {bad[:5]}")
            for job_id, got in names.items():
                check(got == sorted(probe.placed[job_id]),
                      f"{job_id}: the store holds {len(got)} allocs, the "
                      f"plans placed {len(probe.placed[job_id])}")
                check(len(got) == COUNT or job_id in blocked_jobs,
                      f"{job_id}: {COUNT - len(got)} placements neither "
                      "placed nor left to a blocked eval")
        check(counts["p1"]["topk"] > 0
              and counts["p1"]["merge"] == counts["p1"]["topk"],
              f"leg P1 launches {counts['p1']}")
        check(counts["p2"]["score"] > 0,
              f"leg P2 launched no score kernel: {counts['p2']}")
        check(fused_score, "leg P2 fused no score round of eight or more "
              f"evals: {[r['evals'] for r in legs['p2']['probe']['rounds']]}")
        for n in srv.store.nodes():
            live = srv.store.allocs_by_node_terminal(n.id, False)
            fit, dim, _used = structs.allocs_fit(n, live)
            check(fit, f"node {n.name} oversubscribed ({dim})")
        # one leg-P1 batch that evicts, and the first fused score round's
        p1_pb = None
        for pb in capture["batches"]:
            if _to_host(_run_kernel(pb, DEVICE, preempt=True)).evict.any():
                p1_pb = pb
                break
        check(p1_pb is not None, "no leg-P1 batch evicts when re-solved")
        kernel_vs_plain(wk, (
            ("leg P1 batch", p1_pb, "topk", True),
            ("leg P2 fused round", fused_score[0]["pb"], "score", True)))
    except PhaseError as e:
        out["failed"] = str(e)
        emit(out)
        raise
    if on_card:
        out["evict_pass"] = {
            "leg_p1_batch": evict_pass_ms(torch, p1_pb),
            "leg_p2_fused_round": evict_pass_ms(torch,
                                                fused_score[0]["pb"])}
    out["resolved_round"] = {k: fused_score[0][k] for k in (
        "evals", "asks", "Gp", "K", "modes", "waves", "evict_commits")}
    out["checks"] = {"kernel_vs_plain": "passed"}
    emit(out)
    return {m: counts["p1"][m] + counts["p2"][m] for m in counts["p1"]}


# ------------------------------------------------------------ phase 9
#: phase 9, bench.py run_ours at config 3: 896 evals of 64 placements in
#: pipelined chunks of 128 (merged to 4 rows), up to 4 retry-drain
#: rounds, then 4 re-dispatched chunks of the steady delta leg
N_STREAM_EVALS = 896
STREAM_EPC = 128
DRAIN_ROUNDS = 4
DRAIN_ROW = 64
STEADY_CHUNKS = 4
STEADY_PAIRS = 32
#: the smaller kernel-vs-plain streams: evals merged into one batch
SMALL_EPC = 16


def pow2(n):
    return 1 << max(0, (n - 1).bit_length())


def resident_used0(template, n_nodes, resident):
    """bench.py resident_used0: `resident` allocs of R_VEC round-robin
    over the nodes, as the carried usage."""
    used0 = np.zeros_like(template.used0)
    counts = np.bincount(np.arange(resident) % n_nodes,
                         minlength=n_nodes).astype(np.float32)
    used0[:n_nodes, :len(R_VEC)] = (counts[:, None]
                                    * np.asarray(R_VEC, np.float32))
    return used0


def steady_alloc(mock, aid):
    """bench.py _steady_alloc: a plan-apply-feedback alloc of the steady
    delta leg."""
    a = mock.alloc()
    a.id = aid
    tr = a.allocated_resources.tasks["web"]
    tr.cpu, tr.memory_mb, tr.networks = 200, 256, []
    a.allocated_resources.shared.networks = []
    a.allocated_resources.shared.disk_mb = 300
    return a


def steady_delta(mock, nodes, w, pairs, ClusterDelta):
    """A net-zero delta: `pairs` allocs placed and stopped, on nodes
    (w * 977 + k * 131) mod N (bench.py's steady waves)."""
    d = ClusterDelta()
    for k in range(pairs):
        nid = nodes[(w * 977 + k * 131) % len(nodes)].id
        a = steady_alloc(mock, f"steady-{w}-{k}")
        d.place.append((nid, a))
        d.stop.append((nid, a))
    return d


def harvest(status_row, pb, asks):
    """bench.py _harvest: (placed, failed, [(ask, retries), ...])."""
    st = status_row[:pb.n_place]
    placed = int((st == 1).sum())
    failed = int((st == 0).sum())
    retry = st == 2
    if not retry.any():
        return placed, failed, []
    per_ask = np.bincount(pb.p_ask[:pb.n_place][retry],
                          minlength=len(asks))
    return placed, failed, [(a, int(r)) for a, r in zip(asks, per_ask) if r]


def drain_chunks(cur, gp_cap, kp_cap):
    """bench.py's merged drain rows: each retry count split into rows of
    at most DRAIN_ROW, filled greedily into chunks under the solver's
    gp / kp caps."""
    import dataclasses
    split = []
    for a, r in cur:
        while r > DRAIN_ROW:
            split.append(dataclasses.replace(a, count=DRAIN_ROW))
            r -= DRAIN_ROW
        split.append(dataclasses.replace(a, count=r))
    chunks, chunk, k = [], [], 0
    for a in split:
        if chunk and (len(chunk) + 1 > gp_cap or k + a.count > kp_cap):
            chunks.append(chunk)
            chunk, k = [], 0
        chunk.append(a)
        k += a.count
    if chunk:
        chunks.append(chunk)
    return chunks


def charge_committed(expect, out, pbs):
    """Add each committed placement's ask to its node's row of the
    host-side usage `expect`."""
    choice, _ok, _score, status = out
    for b, pb in enumerate(pbs):
        k = np.nonzero(status[b, :pb.n_place] == 1)[0]
        np.add.at(expect, choice[b, k, 0],
                  pb.ask_res[pb.p_ask[k]].astype(np.float64))


def streams_agree(what, k_out, p_out, k_waves=None, p_waves=None):
    """A stream with the fused kernel against the same stream with the
    plain scorer: statuses and ok flags equal, wave counts equal, scores
    within ULP_TOL ulp, and a choice may differ only where its two
    scores tie within that (the scores are not separated).  Returns the
    largest score difference."""
    kc, kok, ks, kst = k_out
    pc, pok, ps, pst = p_out
    check(np.array_equal(kst, pst), f"{what}: statuses differ")
    check(np.array_equal(kok, pok), f"{what}: ok flags differ")
    if k_waves is not None:
        for a, b in zip(k_waves, p_waves):
            check(np.array_equal(np.asarray(a), np.asarray(b)),
                  f"{what}: wave counts {a} / {b}")

    def ulps(a, b):
        ia = a.astype(np.float32).view(np.int32).astype(np.int64)
        ib = b.astype(np.float32).view(np.int32).astype(np.int64)
        ia = np.where(ia < 0, -(ia & 0x7FFFFFFF), ia)
        ib = np.where(ib < 0, -(ib & 0x7FFFFFFF), ib)
        return np.abs(ia - ib)
    d = ulps(ks[kok], ps[pok])
    check(d.size == 0 or int(d.max()) <= ULP_TOL,
          f"{what}: scores off by {int(d.max()) if d.size else 0} ulp")
    differ = kok & (kc != pc)
    check(not differ.any() or int(ulps(ks[differ], ps[differ]).max())
          <= ULP_TOL, f"{what}: a choice differs at separated scores")
    return float(np.abs(ks[kok] - ps[pok]).max()) if kok.any() else 0.0


def stream_busy_share(torch, fn):
    """fn() under `torch.profiler`: the card's busy time over the wall
    to a synchronize, and the device time by kernel name; busy_share is
    None where the profiler recorded no device event (not measured)."""
    def timed():
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t)
    wall_ms, by_name = profile_card(torch, timed)
    busy_ms = sum(by_name.values())
    return {"wall_ms": wall_ms, "busy_ms": busy_ms,
            "busy_share": busy_ms / wall_ms if busy_ms else None,
            "top_device_ms": dict(by_name.most_common(8))}


def small_streams(rs, jobs, used0, mock, structs):
    """The three smaller kernel-vs-plain calls on the main solver, each
    from the seeded usage: a serial stream of 4 batches in one dispatch,
    a lane stream (L 4, 8 batches) and solve_parallel over 4 batches;
    each batch SMALL_EPC evals merged.  Returns the rows."""
    def batch(i):
        asks = sum((asks_for(j) for j in
                    jobs[i * SMALL_EPC:(i + 1) * SMALL_EPC]), [])
        merged, keys = rs.merge_asks(asks)
        pb = rs.pack_batch(merged, job_keys=keys)
        check(pb is not None, "a small batch fell outside the universe")
        return pb
    pbs = [batch(i) for i in range(8)]
    calls = {
        "serial_stream": lambda: rs.finish_stream(rs.solve_stream_async(
            pbs[:4], seeds=[1, 2, 3, 4])),
        "lane_stream": lambda: rs.finish_stream(rs.solve_stream_async(
            pbs, seeds=list(range(1, 9)), lanes=4)),
        "parallel": lambda: rs.solve_parallel(pbs[:4]),
    }
    rows = {}
    for name, call in calls.items():
        runs = []
        for pallas in ("auto", "off"):
            rs.pallas = pallas
            rs.reset_usage(used0=used0)
            out = call()
            # solve_parallel keeps no wave or lane counters
            runs.append((out, rs.usage()[0]) + (
                (None, None, None) if name == "parallel" else
                (rs.last_waves, rs.last_rescore_waves, rs.lane_counters())))
        rs.pallas = "auto"
        (ko, ku, kw_, kr, klc), (po, pu, pw, pr, plc) = runs
        err = streams_agree(f"{name}: kernel vs plain", ko, po,
                            kw_ is not None and [kw_, kr] or None,
                            pw is not None and [pw, pr] or None)
        check(klc == plc, f"{name}: lane counters {klc} / {plc}")
        check(np.array_equal(ku, pu), f"{name}: carried usage differs")
        n_b = 8 if name == "lane_stream" else 4
        rows[name] = {"batches": n_b,
                      "placements": int(sum(pb.n_place
                                            for pb in pbs[:n_b])),
                      "committed": int((ko[3] == 1).sum()),
                      "waves": (None if kw_ is None
                                else [int(x) for x in np.asarray(kw_)]),
                      "lane_counters": klc, "max_abs_err": err}
    return rows


def preempt_stream(torch, mock, structs, n_nodes, on_card):
    """One preempting stream, kernel against plain: nodes filled by
    `fill_allocs` (phase 8's fill), a ResidentSolver with eviction planes
    of width 8 (wave budget doubled, as the worker's preempting solves
    have) per scorer, two batches of one priority-70 config-3 job each,
    the first batch's evictions fed back before the second as the stops
    of `apply_delta(evicted=True)` (the pass already freed them).  Each
    batch's choices, statuses, waves and victim masks agree, and the
    carried usage is the surviving allocs plus the committed asks."""
    from nomad_tpu_torch.solver.kernel import MAX_WAVES
    from nomad_tpu_torch.solver.resident import ResidentSolver
    from nomad_tpu_torch.solver.tensorize import (ClusterDelta,
                                                  alloc_usage_vector)
    t0 = time.perf_counter()
    nodes = make_nodes(mock, n_nodes)
    _jobs, by_job = fill_allocs(mock, structs, nodes)
    abn = {}
    for allocs in by_job.values():
        for a in allocs:
            abn.setdefault(a.node_id, []).append(a)
    jobs = [preempt_job(mock, structs, f"pstream-{b}") for b in range(2)]
    setup_s = time.perf_counter() - t0
    runs = {}
    for pallas in ("auto", "off"):
        rs = ResidentSolver(nodes, asks_for(jobs[0]), abn, gp=4,
                            kp=pow2(COUNT), max_waves=2 * MAX_WAVES,
                            pallas=pallas, evict_e=8, device=DEVICE)
        rs._compact = False
        used0 = np.zeros_like(rs.template.used0)
        for i, n in enumerate(nodes):
            for a in abn.get(n.id, ()):
                used0[i] += alloc_usage_vector(a)
        rs.reset_usage(used0=used0)
        live = {a.id: (a.node_id, a) for lst in abn.values() for a in lst}
        rec, placed = [], []
        for b, job in enumerate(jobs):
            t = time.perf_counter()
            pb = rs.pack_batch(asks_for(job))
            out = rs.solve_stream([pb], seeds=[b + 1])
            placed.append((out, [pb]))
            if on_card:
                torch.cuda.synchronize()
            wall = time.perf_counter() - t
            ev = np.asarray(rs.last_evict[0].cpu())
            rec.append((out, ev, rs.last_waves, rs.last_rescore_waves, wall))
            ch, ok = out[0][0], out[1][0]
            d = ClusterDelta()
            for p in np.nonzero(ok[:, 0] & ev.any(axis=1))[0]:
                ni = int(ch[p, 0])
                for e in np.nonzero(ev[p])[0]:
                    aid = rs.template.ev_ids[ni][e]
                    if aid in live:
                        d.stop.append(live.pop(aid))
            if not d.empty():
                # the pass already freed the victims in the carried usage
                check(rs.apply_delta(d, evicted=True) == "delta",
                      "the eviction feedback repacked the world")
        expect = np.zeros(used0.shape, np.float64)
        for nid, a in live.values():
            expect[rs.node_index[nid]] += alloc_usage_vector(a)
        for out, pbs in placed:
            charge_committed(expect, out, pbs)
        check(np.array_equal(rs.usage()[0], expect.astype(np.float32)),
              f"preempting stream ({pallas}): the carried usage is not "
              "the surviving allocs plus the committed asks")
        runs[pallas] = (rs, rec)
    (krs, krec), (prs, prec) = runs["auto"], runs["off"]
    row = {"nodes": n_nodes, "setup_s": setup_s, "batches": []}
    for b, (k, p) in enumerate(zip(krec, prec)):
        streams_agree(f"preempting batch {b}: kernel vs plain", k[0], p[0],
                      [k[2], k[3]], [p[2], p[3]])
        check(np.array_equal(k[1], p[1]),
              f"preempting batch {b}: victim masks differ")
        row["batches"].append({
            "placed": int((k[0][3] == 1).sum()),
            "evict_commits": int(k[1].any(axis=1).sum()),
            "victims": int(k[1].sum()), "waves": int(k[2][0]),
            "wall_ms": 1e3 * k[4]})
    check(any(b["evict_commits"] for b in row["batches"]),
          "the preempting stream evicted nothing")
    check(np.array_equal(krs.usage()[0], prs.usage()[0]),
          "preempting stream: carried usage differs")
    check(krs.plane_checksum() == prs.plane_checksum(),
          "preempting stream: the eviction planes differ")
    return row


def phase_stream(torch, wk, n_nodes, resident, n_evals, epc=STREAM_EPC,
                 preempt_nodes=None):
    """The streaming ResidentSolver, bench.py run_ours at config 3: the
    solver built once on the cluster (usage seeded from `resident`
    allocs), a warm pass, then the main leg (n_evals evals in pipelined
    chunks of `epc`, merged), the retry drain and the steady delta leg,
    with launch counts zeroed just before and read just after.  Returns
    (launch counts, the first score / topk wave calls of the
    kernel-vs-plain re-solve, the row)."""
    import gc
    from nomad_tpu_torch import mock, structs
    from nomad_tpu_torch.solver.resident import ResidentSolver
    from nomad_tpu_torch.solver.tensorize import (ClusterDelta, Tensorizer,
                                                  template_checksum)
    from nomad_tpu_torch.telemetry.health import health_host
    on_card = DEVICE == "cuda"
    wk._load()
    t0 = time.perf_counter()
    nodes = make_nodes(mock, n_nodes)
    probe = make_job(mock, structs, "probe", COUNT)
    gp = pow2(len({Tensorizer.ask_signature(a) for a in asks_for(probe)}))
    epc = min(epc, n_evals)
    rs = ResidentSolver(nodes, asks_for(probe), gp=gp, kp=pow2(COUNT * epc),
                        max_waves=18, pallas="auto", device=DEVICE)
    used0 = resident_used0(rs.template, n_nodes, resident)
    jobs = [make_job(mock, structs, e, COUNT) for e in range(n_evals)]
    NB = -(-n_evals // epc)
    build_s = time.perf_counter() - t0

    # ---- warm pass (the kernels' first launches, the scatters), then
    # the seeded usage again
    t0 = time.perf_counter()
    warm_asks, _keys = rs.merge_asks(sum((asks_for(j)
                                          for j in jobs[:epc]), []))
    warm = rs.pack_batch(warm_asks)
    warm.job_keys = None
    rs.solve_stream_pipelined([warm], seeds=[1])
    dwarm = rs.pack_batch(drain_chunks([(a, 8) for a in warm_asks[:2]],
                                       rs.gp, rs.kp)[0])
    dwarm.job_keys = None
    rs.solve_stream([dwarm], seeds=[1])
    rs.apply_delta(steady_delta(mock, nodes, 99, STEADY_PAIRS,
                                ClusterDelta))
    rs.reset_usage(used0=used0)
    if on_card:
        torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0

    # ---- the main path, launch counts zeroed just before ----
    gc.collect()
    zero_launches(torch, wk)
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    placed = failed = retried = 0
    asks_all, batches, outs = [], [], []

    def pack_one(i):
        asks, keys = rs.merge_asks(sum((asks_for(j)
                                        for j in jobs[i:i + epc]), []))
        pb = rs.pack_batch_cached(asks, job_keys=keys)
        check(pb is not None, "a config-3 chunk fell outside the universe")
        asks_all.append(asks)
        batches.append(pb)
        return pb

    t_start = time.perf_counter()
    main = rs.solve_stream_pipelined([b * epc for b in range(NB)],
                                     seeds=[b + 1 for b in range(NB)],
                                     pack=pack_one)
    main_stats = dict(rs.last_pipeline_stats)
    main_waves = [int(np.asarray(w)[0]) for w in rs.last_waves]
    main_resc = [int(np.asarray(w)[0]) for w in rs.last_rescore_waves]
    outs.append((main, batches))
    cur = []
    for b, pb in enumerate(batches):
        pl, fl, retries = harvest(main[3][b], pb, asks_all[b])
        placed += pl
        failed += fl
        cur.extend(retries)
    drains = []
    for t_retry in range(DRAIN_ROUNDS):
        if not cur:
            break
        retried += sum(r for _, r in cur)
        chunks = drain_chunks(cur, rs.gp, rs.kp)
        pbs = [rs.pack_batch(c) for c in chunks]
        check(all(pb is not None for pb in pbs),
              "a drain chunk fell outside the universe")
        t = time.perf_counter()
        douts = [rs.solve_stream_async([pb], seeds=[1009 + 17 * t_retry + i])
                 for i, pb in enumerate(pbs)]
        dout = rs.finish_stream(torch.cat(douts))
        drains.append({"chunks": len(pbs), "rows": sum(map(len, chunks)),
                       "placements": sum(pb.n_place for pb in pbs),
                       "wall_ms": 1e3 * (time.perf_counter() - t)})
        outs.append((dout, pbs))
        nxt = []
        for b, (pb, chunk) in enumerate(zip(pbs, chunks)):
            pl, fl, retries = harvest(dout[3][b], pb, chunk)
            placed += pl
            failed += fl
            nxt.extend(retries)
        cur = nxt
    unresolved = sum(r for _, r in cur)
    elapsed = time.perf_counter() - t_start

    # ---- the steady delta leg: the same chunks re-dispatched, each
    # after a net-zero delta of place+stop pairs
    n_steady = min(STEADY_CHUNKS, NB)
    deltas = [steady_delta(mock, nodes, w, STEADY_PAIRS, ClusterDelta)
              for w in range(n_steady)]
    t = time.perf_counter()
    steady = rs.solve_stream_pipelined(
        batches[:n_steady], seeds=[7001 + b for b in range(n_steady)],
        deltas=deltas)
    steady_s = time.perf_counter() - t
    st = rs.last_pipeline_stats
    outs.append((steady, batches[:n_steady]))
    if on_card:
        torch.cuda.synchronize()
    counts = dict(wk.fused_wave.mode_launches)
    peak = torch.cuda.max_memory_allocated() if on_card else None

    total = n_evals * COUNT
    row = {
        "phase": "stream", "nodes": n_nodes, "resident_allocs": resident,
        "evals": n_evals, "placements": total, "chunks": NB,
        "evals_per_chunk": epc, "gp": rs.gp, "kp": rs.kp,
        "Np": int(rs.template.avail.shape[0]),
        "build_s": build_s, "warm_s": warm_s,
        "elapsed_s": elapsed, "evals_per_s": n_evals / elapsed,
        "placements_per_s": placed / elapsed,
        "placed": placed, "failed": failed, "retried": retried,
        "unresolved": unresolved,
        "split_s": {k: main_stats[k] for k in ("pack_s", "dispatch_s",
                                               "fetch_s")},
        "bytes_dispatched": main_stats["bytes_dispatched"],
        "waves": main_waves, "rescore_waves": main_resc,
        "drains": drains,
        "steady": {
            "chunks": n_steady, "elapsed_s": steady_s,
            "pack_ms_per_wave": 1e3 * st["pack_s"] / n_steady,
            "dispatch_ms_per_wave": 1e3 * st["dispatch_s"] / n_steady,
            "delta_apply_ms_per_wave": 1e3 * st["delta_apply_s"] / n_steady,
            "bytes_dispatched": st["bytes_dispatched"],
            "placed": int((steady[3] == 1).sum())},
        "delta_counters": dict(rs.delta_counters),
        "wave_traffic": {k: v for k, v in rs.wave_traffic(
            batches[:1]).items() if k != "delta"},
        "peak_card_bytes": peak, "launches": counts}
    calls = {}
    try:
        # ---- checks (launches here are not counted) ----
        check(placed + failed + unresolved == total,
              f"{placed} placed + {failed} failed + {unresolved} "
              f"unresolved != {total}")
        check(counts["score"] + counts["topk"] > 0,
              f"the leg launched no fused wave kernel: {counts}")
        used, _dev = rs.usage()
        t = rs.template
        real = t.valid
        check(bool(np.all(used[real] <= t.avail[real])),
              "a node's carried usage exceeds its avail")
        expect = used0.astype(np.float64)
        for out, pbs in outs:
            charge_committed(expect, out, pbs)
        check(np.array_equal(used, expect.astype(np.float32)),
              "the carried usage is not the seeded usage plus the "
              "committed asks")
        check(rs.plane_checksum() == template_checksum(t),
              "the card's node planes differ from the host template")
        check(rs.health_counters() == health_host(t, used, _dev),
              "the health kernel differs from health_host")
        # one main-leg chunk from the same starting usage, with the
        # kernel and with the plain scorer (f32 payload)
        rs._compact = False
        runs = []
        for pallas in ("auto", "off"):
            rs.pallas = pallas
            rs.reset_usage(used0=used0)
            into = {}
            with capture_wave(wk, "score", into):
                out = rs.finish_stream(rs.solve_stream_async(
                    [batches[0]], seeds=[1]))
            runs.append((out, rs.last_waves, rs.last_rescore_waves))
            calls.update({"score": into["kw"]} if "kw" in into else {})
        rs.pallas = "auto"
        (ko, kw_, kr), (po, pw, pr) = runs
        row["chunk_max_abs_err"] = streams_agree(
            "main-leg chunk: kernel vs plain", ko, po, [kw_, kr], [pw, pr])
        check(np.array_equal(ko[0], main[0][:1])
              and np.array_equal(ko[3], main[3][:1]),
              "the re-solved chunk differs from the main leg's")
        if drains and counts["topk"]:
            # a drain-sized batch runs the topk kernel: its first call
            into = {}
            rs.reset_usage(used0=used0)
            with capture_wave(wk, "topk", into):
                rs.solve_stream([outs[1][1][0]], seeds=[1])
            calls.update({"topk": into["kw"]} if "kw" in into else {})
        row["small_streams"] = small_streams(rs, jobs, used0, mock,
                                             structs)
        rs._compact = True
        row["preempt_stream"] = preempt_stream(
            torch, mock, structs, preempt_nodes or n_nodes, on_card)
    except PhaseError as e:
        row["failed"] = str(e)
        emit(row)
        raise
    if on_card:
        # the card's busy share of one more pipelined chunk (after the
        # checks: not part of the measured leg), then the health kernel
        # and one delta scatter (32 zero rows into the carried usage) on
        # their own, CUDA events around each call
        from nomad_tpu_torch.solver.kernel import delta_scatter_add
        from nomad_tpu_torch.telemetry.health import device_health_raw
        rs.reset_usage(used0=used0)
        row["profiled_chunk"] = stream_busy_share(
            torch, lambda: rs.solve_stream_pipelined([batches[0]],
                                                     seeds=[1]))
        row["health_kernel_ms"] = time_ms(
            torch, lambda: device_health_raw(rs))
        idx = (np.arange(STEADY_PAIRS, dtype=np.int32) * 131) % n_nodes
        rows = np.zeros((STEADY_PAIRS, used0.shape[1]), np.float32)
        row["delta_scatter_ms"] = time_ms(
            torch, lambda: delta_scatter_add(rs._used, idx, rows))
    row["checks"] = {"accounting": "passed", "usage": "passed",
                     "plane_checksum": "passed", "health": "passed",
                     "kernel_vs_plain": "passed"}
    emit(row)
    return counts, calls, row


# ----------------------------------------------------------- phase 10
#: bench.py config 1 (`CONFIGS[1]`): 100 nodes, 12 evals of one service
#: job of 10 groups x 10, no resident allocs
LAT_NODES = 100
LAT_EVALS = 12
LAT_COUNT = 100
#: the card's pow2 pads of config 1 (bench.py run_ours_latency's device
#: branch): 10 groups -> 16, 100 placements -> 128
LAT_GP, LAT_KP = 16, 128
#: the plane seed of leg L3
PLANE_SEED = 10


def make_job1(mock, structs, eval_ix, count):
    """bench.py make_job, config 1: a `kernel.name = linux` constraint,
    10 groups of count // 10 (`bench_group`)."""
    job = mock.job()
    job.id = f"job-1-{eval_ix}"
    job.name = job.id
    job.datacenters = [f"dc{d}" for d in range(4)]
    job.constraints = [structs.Constraint("${attr.kernel.name}", "linux",
                                          "=")]
    job.affinities = []
    job.spreads = []
    job.task_groups = [bench_group(job.task_groups[0], g,
                                   max(1, count // 10)) for g in range(10)]
    return job


def latency_run(rs, jobs):
    """bench.py run_ours_latency's loop on one engine: one warm-up eval
    (the first job, seed 1), the usage reset, then per eval
    `pack_batch_cached` and one `solve_stream` (seed e + 1).  Returns
    the per-eval outputs and carried usage, and the walls."""
    from nomad_tpu_torch.solver.resident import STATUS_RETRY
    rs.reset_usage()
    rs.solve_stream([rs.pack_batch(asks_for(jobs[0]))], seeds=[1])
    rs.reset_usage()
    outs, usage, walls = [], [], []
    for e, job in enumerate(jobs):
        t = time.perf_counter()
        pb = rs.pack_batch_cached(asks_for(job))
        out = rs.solve_stream([pb], seeds=[e + 1])
        walls.append(time.perf_counter() - t)
        outs.append((pb.n_place, out))
        usage.append(rs.usage()[0].copy())
    placed = failed = retried = 0
    for n, (_c, ok, _s, status) in outs:
        placed += int(ok[0, :n, 0].sum())
        failed += int((status[0, :n] == 0).sum())
        retried += int((status[0, :n] == STATUS_RETRY).sum())
    ms = [1e3 * w for w in walls]
    row = {"p50_ms": statistics.median(ms), "p99_ms": pct(ms, 0.99),
           "evals_per_s": len(jobs) / sum(walls), "walls_ms": ms,
           "placed": placed, "failed": failed, "retried": retried}
    return outs, usage, row


def latency_agree(what, a, b, exact_usage):
    """Two engines' per-eval outputs: ok flags, choices where ok and
    statuses equal, scores within the reference's rtol 2e-5, and the
    carried usage after every eval equal (to rtol 1e-5 against the
    card's f32 sums)."""
    (outs_a, use_a), (outs_b, use_b) = a, b
    worst = 0.0
    for e, ((n, oa), (_n, ob)) in enumerate(zip(outs_a, outs_b)):
        c_a, ok_a, s_a, st_a = (x[0, :n] for x in oa)
        c_b, ok_b, s_b, st_b = (x[0, :n] for x in ob)
        check(np.array_equal(ok_a, ok_b), f"{what}: eval {e} ok differs")
        check(np.array_equal(np.where(ok_a, c_a, -1),
                             np.where(ok_b, c_b, -1)),
              f"{what}: eval {e} choices differ")
        check(np.array_equal(st_a, st_b), f"{what}: eval {e} statuses "
              "differ")
        check(np.allclose(np.where(ok_a, s_a, 0.0), np.where(ok_b, s_b, 0.0),
                          rtol=2e-5, atol=2e-5),
              f"{what}: eval {e} scores differ")
        if ok_a.any():
            worst = max(worst, float(np.abs(s_a[ok_a] - s_b[ok_a]).max()))
        same = (np.array_equal(use_a[e], use_b[e]) if exact_usage
                else np.allclose(use_a[e], use_b[e], rtol=1e-5))
        check(same, f"{what}: eval {e} carried usage differs")
    return worst


def leg_latency(torch, wk, mock, structs, nodes):
    """L1: bench config 1 as run_ours_latency runs it, on the host
    engines and on the card."""
    from nomad_tpu_torch.solver.host import HostResidentSolver, prefer_host
    from nomad_tpu_torch.solver.resident import ResidentSolver
    jobs = [make_job1(mock, structs, e, LAT_COUNT) for e in range(LAT_EVALS)]
    probe = asks_for(jobs[0])
    gp_need, kp_need = len(jobs[0].task_groups), LAT_COUNT
    check(prefer_host(pow2(LAT_NODES), gp_need, kp_need),
          "config 1 is not routed to the host")
    check((pow2(gp_need), pow2(kp_need)) == (LAT_GP, LAT_KP),
          "the card's pads of config 1")
    row = {"nodes": LAT_NODES, "evals": LAT_EVALS, "count": LAT_COUNT,
           "groups": gp_need, "prefer_host": True}
    # the bench's own pick: the host engine at exact pads (10, 100)
    timing = {}
    for name, native in (("native", True), ("numpy", False)):
        t = time.perf_counter()
        rs = HostResidentSolver(nodes, probe, gp=gp_need, kp=kp_need,
                                use_native=native)
        build_s = time.perf_counter() - t
        _o, _u, timing[name] = latency_run(rs, jobs)
        timing[name]["startup_s"] = build_s
    row["exact_pads"] = timing
    # the comparison: every engine at the card's pads, host engines with
    # device_parity, each with its own fresh usage
    runs, parity = {}, {}
    for name, native in (("native", True), ("numpy", False)):
        rs = HostResidentSolver(nodes, probe, gp=LAT_GP, kp=LAT_KP,
                                use_native=native, device_parity=True)
        outs, usage, parity[name] = latency_run(rs, jobs)
        runs[name] = (outs, usage)
    t = time.perf_counter()
    rs = ResidentSolver(nodes, probe, gp=LAT_GP, kp=LAT_KP, device=DEVICE)
    # the f32 result layout, so scores compare to rtol 2e-5 (the compact
    # fetch carries bfloat16 scores)
    rs._compact = False
    build_s = time.perf_counter() - t
    zero_launches(torch, wk)
    outs, usage, parity["card"] = latency_run(rs, jobs)
    torch.cuda.synchronize()
    launches = dict(wk.fused_wave.mode_launches)
    parity["card"]["startup_s"] = build_s
    parity["card"]["launches"] = launches
    runs["card"] = (outs, usage)
    row["parity_pads"] = parity
    row["max_abs_score_diff"] = {
        "native_vs_numpy": latency_agree("native vs numpy", runs["native"],
                                         runs["numpy"], True),
        "card_vs_numpy": latency_agree("card vs numpy", runs["card"],
                                       runs["numpy"], False)}
    check(wk.fused_wave.launches > 0, "the card's stream launched no "
          f"wave kernel: {launches}")
    check(parity["card"]["placed"] > 0, "config 1 placed nothing")
    return row, launches


def leg_server_latency(torch, wk, mock, structs, nodes):
    """L2: the server at config-1 size: every eval routed to the host
    twin, no wave-kernel launch."""
    from nomad_tpu_torch.server.server import Server
    from nomad_tpu_torch.utils.tracing import global_tracer
    srv = Server(device=DEVICE)
    for n in nodes:
        srv.register_node(n)
    probe = ServerProbe(srv, wk)
    jobs, walls, splits, evals, backends = [], [], [], [], []
    try:
        srv.start()
        zero_launches(torch, wk)
        for e in range(LAT_EVALS):
            job = make_job1(mock, structs, f"s{e}", LAT_COUNT)
            t = time.perf_counter()
            ev = srv.register_job(job)
            t_reg = time.perf_counter()
            wait_evals(srv, [ev.id], 120)
            walls.append(time.perf_counter() - t)
            split, attrs = eval_split(global_tracer, ev.id)
            split["register"] = 1e3 * (t_reg - t)
            split["rest"] = 1e3 * walls[-1] - sum(
                split[k] for k in ("register", "queue", "wait_index",
                                   "pre_solve", "solve", "plan_submit"))
            splits.append(split)
            backends.append(attrs.get("backend"))
            jobs.append(job)
            evals.append(ev.id)
        torch.cuda.synchronize()
        launches = dict(wk.fused_wave.mode_launches)
        n_launches = wk.fused_wave.launches
        finals = [srv.store.eval_by_id(x) for x in evals]
        placed = {j.id: sorted(probe.placed.get(j.id, [])) for j in jobs}
        check_store(structs, srv.store, [(j, placed[j.id]) for j in jobs],
                    nodes)
    finally:
        probe.close()
        srv.stop()
    ms = [1e3 * w for w in walls]
    row = {"evals": LAT_EVALS, "p50_ms": statistics.median(ms),
           "p99_ms": pct(ms, 0.99), "walls_ms": ms,
           "split_p50_ms": {k: statistics.median([s[k] for s in splits])
                            for k in splits[0]},
           "split_p99_ms": {k: pct([s[k] for s in splits], 0.99)
                            for k in splits[0]},
           "placed": sum(len(v) for v in placed.values()),
           "backends": dict(collections.Counter(backends)),
           "launches": launches}
    bad = [(f.job_id, f.status) for f in finals
           if f.status != structs.EVAL_STATUS_COMPLETE]
    check(not bad, f"L2 evals not complete: {bad}")
    check(backends == ["host"] * LAT_EVALS,
          f"L2 solve spans by route: {backends}")
    check(n_launches == 0 and not any(launches.values()),
          f"L2 launched the wave kernel: {launches}")
    return row


def region_plane(pb, nodes):
    """Three levels by datacenter: a group's home dc (g % 4) 0.5, its
    sibling ((g + 1) % 4) 0.2, the rest 0 (padded nodes 0)."""
    Gp, Np = pb.ask_res.shape[0], pb.avail.shape[0]
    dc = np.full(Np, -1)
    dc[:len(nodes)] = [int(n.datacenter[2:]) for n in nodes]
    g = np.arange(Gp)[:, None]
    plane = np.where(dc[None, :] == g % 4, 0.5,
                     np.where(dc[None, :] == (g + 1) % 4, 0.2, 0.0))
    return plane.astype(np.float32)


def leg_planes(torch, wk, mock, structs):
    """L3: the learned and region planes at config-3 width, the card's
    torch solve against the numpy twin."""
    from nomad_tpu_torch.solver.host import host_solve_kernel
    from nomad_tpu_torch.solver.kernel import solve_kernel
    from nomad_tpu_torch.solver.solve import (_kernel_args, _plane_args,
                                              _to_host)
    from nomad_tpu_torch.solver.tensorize import Tensorizer
    t = time.perf_counter()
    nodes = make_nodes(mock, N_NODES)
    by_node = resident_allocs(mock, nodes, RESIDENT)
    pb = Tensorizer().pack(nodes, asks_for(make_job(mock, structs, "p10",
                                                    COUNT)), by_node)
    setup_s = time.perf_counter() - t
    Gp, Np = pb.ask_res.shape[0], pb.avail.shape[0]
    rng = np.random.default_rng(PLANE_SEED)
    learned = (0.5 * rng.standard_normal((Gp, Np))).astype(np.float32)
    learned[rng.random((Gp, Np)) < 0.25] = 0.0
    planes = {"learned": {"learned": learned},
              "region": {"region_bias": region_plane(pb, nodes)},
              "both": {"learned": learned,
                       "region_bias": region_plane(pb, nodes)}}
    has_spread = bool((pb.sp_col[:, 0] >= 0).any())
    has_distinct = bool((pb.distinct >= 0).any())
    args = _kernel_args(pb, DEVICE)
    base = host_solve_kernel(*_plane_args(pb), pb.n_place, 0,
                             has_spread=has_spread)
    rows = {}
    zero_launches(torch, wk)
    for name, kw in planes.items():
        card_kw = {k: torch.as_tensor(v).to(DEVICE) for k, v in kw.items()}

        def card():
            return solve_kernel(*args, 0, has_spread=has_spread,
                                has_distinct=has_distinct,
                                pallas_mode="auto", **card_kw)
        card()                                       # warm
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        res = card()
        end.record()
        torch.cuda.synchronize()
        res = _to_host(res)
        t = time.perf_counter()
        twin = host_solve_kernel(*_plane_args(pb), pb.n_place, 0,
                                 has_spread=has_spread, **kw)
        host_ms = 1e3 * (time.perf_counter() - t)
        assert_same(res, twin, f"L3 {name}: card vs twin")
        moved = int((np.where(twin.choice_ok, twin.choice, -1)
                     != np.where(base.choice_ok, base.choice, -1)).sum())
        rows[name] = {"card_ms": start.elapsed_time(end),
                      "host_twin_ms": host_ms, "waves": int(res.n_waves),
                      "rescore_waves": int(res.n_rescore),
                      "placed": int(res.choice_ok[:pb.n_place, 0].sum()),
                      "choices_moved_vs_no_plane": moved,
                      "max_abs_score_diff": float(np.abs(
                          np.where(res.choice_ok, res.score, 0.0)
                          - np.where(twin.choice_ok, twin.score,
                                     0.0)).max())}
    torch.cuda.synchronize()
    launches = dict(wk.fused_wave.mode_launches)
    check(wk.fused_wave.launches == 0 and not any(launches.values()),
          f"L3 handed a plane to the wave kernel: {launches}")
    check(any(r["choices_moved_vs_no_plane"] for r in rows.values()),
          "L3: no plane moved a choice")
    return {"nodes": N_NODES, "resident_allocs": RESIDENT, "Gp": Gp,
            "Np": Np, "K": int(pb.n_place), "plane_seed": PLANE_SEED,
            "learned_zero_share": float((learned == 0).mean()),
            "setup_s": setup_s, "solves": rows, "launches": launches}


def phase_host_route(torch, wk):
    """Phase 10: the host route of the solve and the optional score
    planes.  Returns the wave-kernel launch counts of the phase (L1's
    card stream; L2 and L3 must launch none)."""
    import gc
    from nomad_tpu_torch import mock, structs
    t0 = time.perf_counter()
    nodes = make_nodes(mock, LAT_NODES)
    legs, counts = {}, {"score": 0, "topk": 0, "merge": 0}
    try:
        # each leg starts from a full collection, so it pays only for
        # the garbage it makes (the earlier phases leave gigabytes)
        gc.collect()
        legs["l1_latency"], counts = leg_latency(torch, wk, mock, structs,
                                                 nodes)
        emit({"phase": "host_route", "leg": "L1", **legs["l1_latency"]})
        gc.collect()
        legs["l2_server"] = leg_server_latency(
            torch, wk, mock, structs, make_nodes(mock, LAT_NODES))
        emit({"phase": "host_route", "leg": "L2", **legs["l2_server"]})
        gc.collect()
        legs["l3_planes"] = leg_planes(torch, wk, mock, structs)
        emit({"phase": "host_route", "leg": "L3", **legs["l3_planes"]})
    except PhaseError as e:
        emit({"phase": "host_route", "failed": str(e),
              "legs_done": sorted(legs)})
        raise
    emit({"phase": "host_route", "seconds": time.perf_counter() - t0,
          "launches": counts})
    return counts


# ----------------------------------------------------------- phase 11
#: bench.py run_multichip / run_multiregion: 50,000 nodes of bench.py's
#: generator, 16 evals of make_job(2, e, 64) in calls of 8, 8 shards (4
#: hosts of 2 chips; 4 regions of 1 host of 2 chips), max_waves 18
MESH_NODES = 50_000
MESH_EVALS = 16
MESH_EPC = 8
MESH_SHARDS = 8
MESH_HOSTS = 4
MESH_REGIONS = 4
MESH_FAIL_SHARD = 3
#: L0: one rich_solve_batch problem of this many placements
MESH_RICH_COUNT = 512


def make_job2(mock, eval_ix, count):
    """bench.py make_job, config 2: one group of `count` (cpu 400 MHz,
    memory 256 MB, disk 300 MB), all four dcs, no constraint."""
    job = mock.job()
    job.id = job.name = f"job-2-{eval_ix}"
    job.datacenters = [f"dc{d}" for d in range(4)]
    job.constraints, job.affinities, job.spreads = [], [], []
    job.task_groups = [bench_group(job.task_groups[0], 0, count)]
    return job


@contextlib.contextmanager
def shard_launches(wk, planes, into):
    """Count, per shard and mode, the wave calls made inside the block
    (`planes`: each shard's resident `avail` tensor, which every wave
    call of that shard passes); an observer only, every call goes on to
    the wrapper as before."""
    real = wk.fused_wave
    ptrs = {t.data_ptr(): i for i, t in enumerate(planes)}

    def wave(**kw):
        res = real(**kw)
        shard = ptrs.get(kw["avail"].data_ptr())
        if shard is not None:
            into[shard][kw["mode"]] += 1
        return res
    wave.launches, wave.mode_launches = real.launches, real.mode_launches
    wk.fused_wave = wave
    try:
        yield
    finally:
        wk.fused_wave = real


def mesh_stream(torch, rs, batches, epc):
    """The stream as bench.py run_multichip drives it (usage reset, then
    calls of `epc` batches, unseeded, one fetch a call): (outputs a call,
    waves, rescores, wall s)."""
    rs.reset_usage()
    if DEVICE == "cuda":
        torch.cuda.synchronize()
    t = time.perf_counter()
    outs, waves, resc = [], [], []
    for b in range(0, len(batches), epc):
        outs.append(rs.solve_stream(batches[b:b + epc]))
        inner = getattr(rs, "solver", rs)        # the cross-region union
        waves.append(np.asarray(inner.last_waves).tolist())
        resc.append(np.asarray(inner.last_rescore_waves).tolist())
    return outs, waves, resc, time.perf_counter() - t


def outs_equal(what, a, b):
    """Two streams' (choice, ok, score, status) a call: ok flags,
    statuses, choices where ok equal, scores 0.0 apart."""
    for i, (x, y) in enumerate(zip(a, b)):
        xc, xok, xs, xst = x
        yc, yok, ys, yst = y
        check(np.array_equal(xok, yok), f"{what}: call {i} ok flags")
        check(np.array_equal(xst, yst), f"{what}: call {i} statuses")
        check(np.array_equal(np.where(xok, xc, -1), np.where(yok, yc, -1)),
              f"{what}: call {i} choices")
        check(np.array_equal(np.where(xok, xs, 0.0), np.where(yok, ys, 0.0)),
              f"{what}: call {i} scores not 0.0 apart")


def mesh_leg_row(name, outs, waves, wall, n_evals, per_shard, counts,
                 n_shards):
    """A leg's record: wall, evals/s, ms a wave, waves, launches per mode
    and per shard; checks that every shard launched the wave kernel."""
    n_waves = int(sum(sum(w) for w in waves))
    placed = int(sum(int((o[3] == 1).sum()) for o in outs))
    check(all(sum(per_shard[s].values()) > 0 for s in range(n_shards)),
          f"{name}: a shard launched no wave kernel: {per_shard}")
    return {"wall_ms": 1e3 * wall, "evals_per_s": n_evals / wall,
            "waves": waves, "ms_per_wave": 1e3 * wall / max(n_waves, 1),
            "placed": placed, "launches": counts,
            "launches_per_shard": [dict(per_shard[s])
                                   for s in range(n_shards)]}


def count_leg(torch, wk, total):
    """Add the launches since the last zero_launches to `total`; returns
    the leg's own."""
    if DEVICE == "cuda":
        torch.cuda.synchronize()
    c = dict(wk.fused_wave.mode_launches)
    for k in total:
        total[k] += c.get(k, 0)
    return c


def masked_checksum(tmpl, mask):
    """template_checksum with the rows outside `mask` zeroed: what the
    device holds when those rows' tiles are not resident."""
    from nomad_tpu_torch.solver.tensorize import plane_crc

    def z(a):
        out = np.zeros_like(a)
        out[mask] = a[mask]
        return out
    meta = f"{tmpl.n_real}:{','.join(tmpl.node_ids)}".encode()
    return plane_crc(z(tmpl.avail), z(tmpl.reserved), z(tmpl.valid),
                     z(tmpl.node_dc), z(tmpl.attr_rank), z(tmpl.dev_cap),
                     ev_prio=None if tmpl.ev_prio is None
                     else z(tmpl.ev_prio),
                     ev_res=None if tmpl.ev_res is None else z(tmpl.ev_res),
                     meta=meta)


# ------------------------------------------------------ phase 11, L5
#: the spillover leg of bench.py run_multiregion (bench.py:1066-1140):
#: arrivals, the hot region's share, the smoke-scale watermark, the WAN
#: hop in units of the measured per-eval time
SPILL_ARRIVALS = 400
SPILL_HOT_SHARE = 0.7
SPILL_MAX_PENDING = 64
SPILL_WAN_VS_SVC = 0.5
SPILL_SEED = 13


def region_queue_sim(arrivals, regions, svc, router=None, watermark=None):
    """The deterministic FIFO queue simulation of bench.py
    `_region_queue_sim` (:896): arrivals [(t, home)] ascending, each
    region one server taking `svc` seconds an eval.  With a router the
    router picks the region per arrival (backlogs fed by `note_ready`,
    the shed lane drained as capacity returns, every cross-region hop
    charged its WAN delay); without one every eval runs at home and a
    backlog at `watermark` marks the region browned out.  Returns
    (latencies, browned regions, evals completed)."""
    comp = {r: collections.deque() for r in regions}
    last = {r: 0.0 for r in regions}
    lat, browned = [], set()

    def depth(r, t):
        dq = comp[r]
        while dq and dq[0] <= t:
            dq.popleft()
        return len(dq)

    def enqueue(r, t, t_arr):
        done = max(last[r], t) + svc
        last[r] = done
        comp[r].append(done)
        lat.append(done - t_arr)

    for t, home in arrivals:
        if router is None:
            if depth(home, t) >= watermark:
                browned.add(home)
            enqueue(home, t, t)
            continue
        for r in regions:
            router.region(r).note_ready(depth(r, t))
        for ev, r in router.drain_shed():
            enqueue(r, t + router.wan_delay(ev[1], r), ev[0])
        reg, _cause = router.route((t, home), home=home)
        if reg is not None:
            enqueue(reg, t + router.wan_delay(home, reg), t)
    # what the router shed completes once capacity returns (never
    # dropped)
    t = max(last.values())
    for _ in range(100_000):
        if router is None or not router.shed_depth():
            break
        t += svc
        for r in regions:
            router.region(r).note_ready(depth(r, t))
        for ev, r in router.drain_shed():
            enqueue(r, t + router.wan_delay(ev[1], r), ev[0])
    return lat, browned, len(lat)


def spillover_leg(svc, n_regions, SpilloverRouter, WanLatencyModel):
    """Leg L5: bench.py run_multiregion's spillover leg at `svc` seconds
    an eval.  400 seeded Poisson arrivals at half the fleet's rate, 70%
    homed on one region, through three policies: isolated (every eval at
    home), the spillover router, and the router on a balanced stream.
    Returns the reference's figures (p99s in seconds)."""
    import random
    regions = [f"r{i}" for i in range(n_regions)]
    rng = random.Random(SPILL_SEED)
    lam = 2.0 / svc                      # total load: 50% of the fleet
    t_a, arrivals = 0.0, []
    for _ in range(SPILL_ARRIVALS):
        t_a += rng.expovariate(lam)
        hot = rng.random() < SPILL_HOT_SHARE
        arrivals.append((t_a, regions[0] if hot else regions[
            1 + rng.randrange(n_regions - 1)]))
    balanced = [(t, regions[i % n_regions])
                for i, (t, _h) in enumerate(arrivals)]
    lat_iso, browned, done_iso = region_queue_sim(
        arrivals, regions, svc, watermark=int(0.75 * SPILL_MAX_PENDING))
    wan_base = SPILL_WAN_VS_SVC * svc

    def router():
        r = SpilloverRouter(
            regions={name: 1.0 + 0.1 * i for i, name in enumerate(regions)},
            overrides={"slo_budget_s": 2.5 * svc, "spill_margin": 1.0,
                       "max_pending": SPILL_MAX_PENDING},
            wan_model=WanLatencyModel(default_s=wan_base, jitter=0.25))
        for name in regions:
            for b in (1, 2, 4, 8, 16, 32, 64):
                r.note_solve(name, b, b * svc)
        return r

    r_sp = router()
    lat_sp, _b, done_sp = region_queue_sim(arrivals, regions, svc,
                                           router=r_sp)
    lat_bal, _b, done_bal = region_queue_sim(balanced, regions, svc,
                                             router=router())
    def p99(xs):                         # bench.py pct: floor rank
        return sorted(xs)[int(0.99 * (len(xs) - 1))]
    p99_iso, p99_sp, p99_bal = p99(lat_iso), p99(lat_sp), p99(lat_bal)
    stats = r_sp.stats()
    return {
        "n_arrivals": SPILL_ARRIVALS, "svc_per_eval_s": svc,
        "hot_region_share": SPILL_HOT_SHARE,
        "isolated_browned_regions": sorted(browned),
        "p99_isolated_s": p99_iso, "p99_spillover_s": p99_sp,
        "p99_balanced_s": p99_bal,
        "p99_vs_balanced": p99_sp / max(p99_bal, 1e-9),
        "evals_lost": 3 * SPILL_ARRIVALS - done_sp - done_iso - done_bal,
        "shed_lane_depth_end": r_sp.shed_depth(),
        "routed": stats["routed"],
        "wan": {"base_s": wan_base, "base_vs_svc": SPILL_WAN_VS_SVC,
                "jitter": 0.25, **stats.get("wan", {})},
        "shed_accounting_intact": (
            stats["routed"]["shed"] == stats["routed"]["readmitted"]
            and r_sp.shed_depth() == 0),
        "spill_ok": bool(p99_sp <= 2 * p99_bal and browned
                         and done_sp == SPILL_ARRIVALS)}


def phase_mesh(torch, wk, n_nodes=MESH_NODES, n_evals=MESH_EVALS,
               epc=MESH_EPC, rich_count=MESH_RICH_COUNT):
    """Phase 11: the mesh tiers on shards of the card.  Returns (launch
    counts of the phase's mesh drives, the first wave call of shard 0 by
    mode: topk from L0, score from L1's pinned run, the legs' rows)."""
    import gc
    from collections import Counter
    from nomad_tpu_torch import mock
    from nomad_tpu_torch.parallel import federated as fd
    from nomad_tpu_torch.parallel import sharded as sh
    from nomad_tpu_torch.solver.kernel import solve_kernel
    from nomad_tpu_torch.solver.resident import ResidentSolver
    from nomad_tpu_torch.solver.solve import _kernel_args
    from nomad_tpu_torch.solver.tensorize import (Tensorizer,
                                                  template_checksum)
    from nomad_tpu_torch.telemetry.health import health_host
    on_card = DEVICE == "cuda"
    dev = torch.device(DEVICE)
    S = MESH_SHARDS
    total = {"score": 0, "topk": 0, "merge": 0}
    legs = {}
    t_phase = time.perf_counter()

    def per_shard(n):
        return [Counter() for _ in range(n)]
    try:
        # ---- L0: one rich solve, stateless, split over 8 shards ----
        gc.collect()
        t0 = time.perf_counter()
        pb = mock.rich_solve_batch(n_nodes, rich_count)
        pack_s = time.perf_counter() - t0
        mesh = sh.make_node_mesh(S, devices=[dev])
        into, into_s = {}, {}
        zero_launches(torch, wk)
        t0 = time.perf_counter()
        with capture_wave(wk, "topk", into):
            res_m = sh.sharded_solve(pb, mesh, pallas_mode="auto")
        if on_card:
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        c0 = count_leg(torch, wk, total)
        res_f = solve_kernel(*_kernel_args(pb, dev), pallas_mode="auto")
        for f in ("choice_ok", "n_feasible", "n_exhausted", "dim_exhausted",
                  "unfinished", "feas", "cons_filtered", "used_final"):
            check(torch.equal(getattr(res_m, f), getattr(res_f, f)),
                  f"L0: {f} differs from the flat solve")
        ok = res_f.choice_ok
        check(torch.equal(torch.where(ok, res_m.choice, -1),
                          torch.where(ok, res_f.choice, -1)),
              "L0: choices differ from the flat solve")
        check(torch.equal(torch.where(ok, res_m.score, 0.0),
                          torch.where(ok, res_f.score, 0.0)),
              "L0: scores not 0.0 apart from the flat solve")
        check(res_m.n_waves == res_f.n_waves, "L0: wave counts differ")
        # every full pass of every shard launched one wave kernel
        check(sum(c0[m] for m in ("score", "topk")) == res_m.n_rescore
              and res_m.n_rescore >= S,
              f"L0: {c0} launches for {res_m.n_rescore} shard passes")
        check("kw" in into, "L0: no topk wave call")
        legs["L0"] = {"nodes": n_nodes, "np_local": int(
            pb.avail.shape[0]) // S, "placements": int(pb.n_place),
            "placed": int(ok[:pb.n_place, 0].sum()), "pack_s": pack_s,
            "wall_ms": 1e3 * wall, "waves": res_m.n_waves,
            "shard_passes": res_m.n_rescore, "launches": c0}
        emit({"phase": "mesh", "leg": "L0", **legs["L0"]})
        del pb, res_m, res_f

        # ---- the cluster and the stream of bench.py run_multichip ----
        gc.collect()
        t0 = time.perf_counter()
        nodes = make_nodes(mock, n_nodes)
        probe = asks_for(make_job2(mock, "probe", COUNT))
        gp = pow2(len({Tensorizer.ask_signature(a) for a in probe}))
        kw = dict(gp=gp, kp=pow2(COUNT), max_waves=18, pallas="auto")
        jobs = [make_job2(mock, e, COUNT) for e in range(n_evals)]
        flat = ResidentSolver(nodes, probe, device=DEVICE, **kw)
        build = {"flat_s": time.perf_counter() - t0}
        f_b = [flat.pack_batch(asks_for(j)) for j in jobs]
        f_outs, f_waves, _, f_wall = mesh_stream(torch, flat, f_b, epc)

        # ---- L1: the 1-D mesh stream ----
        t0 = time.perf_counter()
        rs = sh.ShardedResidentSolver(
            nodes, probe, mesh=sh.make_node_mesh(S, devices=[dev]), **kw)
        build["l1_s"] = time.perf_counter() - t0
        batches = [rs.pack_batch(asks_for(j)) for j in jobs]
        shards = per_shard(S)
        zero_launches(torch, wk)
        with shard_launches(wk, rs._dev_node["avail"], shards):
            outs, waves, resc, wall = mesh_stream(torch, rs, batches, epc)
        c1 = count_leg(torch, wk, total)
        outs_equal("L1 mesh vs flat", outs, f_outs)
        check(waves == f_waves, f"L1: waves {waves} vs flat {f_waves}")
        for a, b in zip(rs.usage(), flat.usage()):
            check(np.array_equal(a, b), "L1: carried usage differs")
        legs["L1"] = mesh_leg_row("L1", outs, waves, wall, n_evals, shards,
                                  c1, S)
        legs["L1"].update(flat_wall_ms=1e3 * f_wall, rescore_waves=resc,
                          flat_evals_per_s=n_evals / f_wall)
        # one call under torch.profiler: the card's busy share
        legs["L1"]["profiled_call"] = stream_busy_share(
            torch, lambda: rs.solve_stream(batches[:epc]))
        # the same stream with the score kernel pinned, then the plain
        # scorer: equal, rescores too
        rs.pallas = "score"
        shards_s = per_shard(S)
        zero_launches(torch, wk)
        with capture_wave(wk, "score", into_s), \
                shard_launches(wk, rs._dev_node["avail"], shards_s):
            s_outs, s_waves, s_resc, s_wall = mesh_stream(torch, rs,
                                                          batches, epc)
        c1s = count_leg(torch, wk, total)
        check(all(shards_s[i]["score"] > 0 for i in range(S)),
              "L1 score: a shard launched no score kernel")
        rs.pallas = "off"
        p_outs, p_waves, p_resc, p_wall = mesh_stream(torch, rs, batches,
                                                      epc)
        rs.pallas = "auto"
        for what, o, w, r in (("L1 score", s_outs, s_waves, s_resc),
                              ("L1 plain", p_outs, p_waves, p_resc)):
            for x, y in zip(outs, o):
                streams_agree(what, x, y)
            check(w == waves and r == resc, f"{what}: waves / rescores")
        legs["L1"]["score_pinned"] = mesh_leg_row(
            "L1 score", s_outs, s_waves, s_wall, n_evals, shards_s, c1s, S)
        legs["L1"]["plain_wall_ms"] = 1e3 * p_wall
        wt = rs.wave_traffic(batches[:epc])
        legs["L1"]["wave_traffic"] = {k: wt[k] for k in ("ici",
                                                         "per_shard")}
        legs["L1"]["measured"] = rs.measured_wave_counters()
        check(wt["ici"]["bytes_ici_per_wave"]
              <= wt["ici"]["bound_candidate_keys"],
              "L1: modeled key bytes above the candidate-keys bound")
        emit({"phase": "mesh", "leg": "L1", **legs["L1"]})
        del rs

        # ---- L2: two tiers, then three tiers (cross-region) ----
        gc.collect()
        t0 = time.perf_counter()
        rs2 = sh.ShardedResidentSolver(
            nodes, probe, mesh=sh.make_two_tier_mesh(MESH_HOSTS, S,
                                                     devices=[dev]), **kw)
        per_region = n_nodes // MESH_REGIONS
        cr = fd.CrossRegionResidentSolver(
            [nodes[r * per_region:(r + 1) * per_region]
             for r in range(MESH_REGIONS)], probe, n_hosts_per_region=1,
            n_devices=S, devices=[dev], **kw)
        build["l2_s"] = time.perf_counter() - t0
        legs["L2"] = {}
        for name, solver in (("two_tier", rs2), ("cross_region", cr)):
            inner = getattr(solver, "solver", solver)
            bs = [solver.pack_batch(asks_for(j)) for j in jobs]
            shards = per_shard(S)
            zero_launches(torch, wk)
            with shard_launches(wk, inner._dev_node["avail"], shards):
                o, w, r, wall = mesh_stream(torch, solver, bs, epc)
            c = count_leg(torch, wk, total)
            outs_equal(f"L2 {name} vs flat", o, f_outs)
            check(w == f_waves, f"L2 {name}: waves {w} vs flat {f_waves}")
            u = solver.usage()[0][:flat.template.avail.shape[0]]
            check(np.array_equal(u, flat.usage()[0]),
                  f"L2 {name}: carried usage differs")
            row = mesh_leg_row(f"L2 {name}", o, w, wall, n_evals, shards,
                               c, S)
            wt = solver.wave_traffic(bs[:epc])
            row["rescore_waves"] = r
            row["wave_traffic"] = {k: wt[k] for k in ("ici", "dcn", "wan")
                                   if k in wt}
            row["bound_candidate_keys"] = wt["ici"]["bound_candidate_keys"]
            row["measured"] = inner.measured_wave_counters()
            legs["L2"][name] = row
        emit({"phase": "mesh", "leg": "L2", **legs["L2"]})
        del rs2, cr

        # ---- L3: the elastic mesh through a shard loss ----
        gc.collect()
        t0 = time.perf_counter()
        es = sh.ElasticShardedResidentSolver(
            nodes, probe, mesh=sh.make_node_mesh(S, devices=[dev]), **kw)
        build["l3_s"] = time.perf_counter() - t0
        check(es.plane_checksum() == template_checksum(es.template),
              "L3: checksum before the loss")
        legs["L3"] = {}
        for step in ("fail", "recover"):
            if step == "fail":
                lost = es.fail_shard(MESH_FAIL_SHARD)
                live = es.health_row_mask()
                live_nodes = [n for i, n in enumerate(es.nodes)
                              if live[i]]
                ref = ResidentSolver(live_nodes, probe, device=DEVICE, **kw)
                want_sum = masked_checksum(es.template, live)
            else:
                rec_bytes = es.recover()
                ref = flat
                want_sum = template_checksum(es.template)
            ns = es.n_shards
            shards = per_shard(ns)
            bs = [es.pack_batch(asks_for(j)) for j in jobs]
            zero_launches(torch, wk)
            with shard_launches(wk, es._dev_node["avail"], shards):
                o, w, r, wall = mesh_stream(torch, es, bs, epc)
            c = count_leg(torch, wk, total)
            ro = (f_outs if ref is flat else mesh_stream(
                torch, ref, [ref.pack_batch(asks_for(j)) for j in jobs],
                epc)[0])
            check(c["score"] > 0 and c["topk"] == 0,
                  f"L3 {step}: the elastic layout ran {c}")
            # by node id: the live solver numbers its nodes apart
            for x, y in zip(o, ro):
                ids_x = np.array(es.template.node_ids + [""])[
                    np.where(x[1], x[0], -1)]
                ids_y = np.array(ref.template.node_ids + [""])[
                    np.where(y[1], y[0], -1)]
                check(np.array_equal(ids_x, ids_y)
                      and np.array_equal(x[3], y[3])
                      and np.array_equal(np.where(x[1], x[2], 0.0),
                                         np.where(y[1], y[2], 0.0)),
                      f"L3 {step}: the stream differs from the flat "
                      "solver over the live nodes")
            check(es.plane_checksum() == want_sum,
                  f"L3 {step}: plane checksum")
            hc = es.health_counters()
            check(hc == health_host(es.template, *es.usage(),
                                    row_mask=es.health_row_mask()),
                  f"L3 {step}: health kernel vs health_host")
            row = mesh_leg_row(f"L3 {step}", o, w, wall, n_evals, shards,
                               c, ns)
            row.update(shards=ns, rescore_waves=r, mesh_state=es.mesh_state,
                       nodes_valid_health=hc.nodes_valid,
                       reshard_counters=dict(es.reshard_counters))
            if step == "fail":
                row["lost_tiles"] = lost
                row["live_nodes"] = len(live_nodes)
            else:
                row["recovery_bytes"] = rec_bytes
            legs["L3"][step] = row
        emit({"phase": "mesh", "leg": "L3", **legs["L3"]})
        del es

        # ---- L4: the federated stream, 4 regions of 12,500 nodes ----
        gc.collect()
        t0 = time.perf_counter()
        regions = [nodes[r * per_region:(r + 1) * per_region]
                   for r in range(MESH_REGIONS)]
        fed = fd.FederatedResidentSolver(regions, probe, gp=kw["gp"],
                                         kp=kw["kp"], max_waves=18,
                                         device=DEVICE, pallas="auto")
        build["l4_s"] = time.perf_counter() - t0
        per = n_evals // MESH_REGIONS
        rjobs = [[jobs[r * per + i] for i in range(per)]
                 for r in range(MESH_REGIONS)]
        fb = [[fed.pack_batch(r, asks_for(j)) for j in rj]
              for r, rj in enumerate(rjobs)]
        shards = per_shard(MESH_REGIONS)
        zero_launches(torch, wk)
        t0 = time.perf_counter()
        with shard_launches(wk, [fed._node_stack["avail"][r]
                                 for r in range(MESH_REGIONS)], shards):
            fout = fed.solve_stream(fb)
        wall = time.perf_counter() - t0
        c4 = count_leg(torch, wk, total)
        for r, s_ in enumerate(fed.solvers):
            sb = [s_.pack_batch(asks_for(j)) for j in rjobs[r]]
            so = s_.solve_stream(sb)
            ok = so[1]
            check(np.array_equal(ok, fout[1][r])
                  and np.array_equal(so[3], fout[3][r])
                  and np.array_equal(np.where(ok, so[0], -1),
                                     np.where(ok, fout[0][r], -1))
                  and np.array_equal(np.where(ok, so[2], 0.0),
                                     np.where(ok, fout[2][r], 0.0)),
                  f"L4: region {r} differs from its own ResidentSolver")
        check(all(sum(shards[r].values()) > 0
                  for r in range(MESH_REGIONS)),
              f"L4: a region launched no wave kernel: {shards}")
        check(fed.health_counters() == fed.health_host_twin(),
              "L4: health of the stacked regions vs the merged twins")
        legs["L4"] = {"wall_ms": 1e3 * wall, "evals_per_s": n_evals / wall,
                      "placed": int((fout[3] == 1).sum()),
                      "launches": c4,
                      "launches_per_region": [dict(x) for x in shards]}
        emit({"phase": "mesh", "leg": "L4", **legs["L4"]})

        # ---- L5: SLO spillover across the regions, at the card's rate
        # (seconds an eval of L2's cross-region stream, as bench.py
        # run_multiregion takes its own WAN leg's)
        from nomad_tpu_torch.server.serving import (SpilloverRouter,
                                                    WanLatencyModel)
        svc = legs["L2"]["cross_region"]["wall_ms"] / 1e3 / n_evals
        legs["L5"] = spillover_leg(svc, MESH_REGIONS, SpilloverRouter,
                                   WanLatencyModel)
        emit({"phase": "mesh", "leg": "L5", **legs["L5"]})
        l5 = legs["L5"]
        check(l5["evals_lost"] == 0, f"L5: {l5['evals_lost']} evals lost")
        check(l5["shed_accounting_intact"], "L5: shed lane accounting")
        check(l5["spill_ok"], "L5: spillover p99 above 2x balanced, or the "
              "isolated policy did not brown out")
    except PhaseError as e:
        emit({"phase": "mesh", "failed": str(e), "legs_done": sorted(legs)})
        raise
    emit({"phase": "mesh", "seconds": time.perf_counter() - t_phase,
          "build_s": build, "launches": total})
    return total, {"topk": into["kw"], "score": into_s["kw"]}, legs


# ------------------------------------------------------------ phase 12
#: W1 / W2 / W3 jobs, W2's client threads
CLUSTER_W1 = 16
CLUSTER_W2 = 64
CLUSTER_W2_CLIENTS = 4
CLUSTER_W3 = 16
#: the phase fails at any wait past this many seconds
CLUSTER_WAIT_S = 300.0
#: raft's own timeouts, as Nomad's servers run them (hashicorp/raft's
#: defaults: an election timeout of 1-2 s, a heartbeat every 0.1 s)
CLUSTER_RAFT = {"election_timeout_s": (1.0, 2.0),
                "heartbeat_interval_s": 0.1}
#: SWIM timings for three servers that share one process, its GIL and a
#: 100,000-alloc entry's decode: a probe waits 2 s, a suspect is dead
#: after 4 s
CLUSTER_GOSSIP = {"probe_interval_s": 0.5, "probe_timeout_s": 2.0,
                  "suspicion_timeout_s": 4.0}
#: the nodes carry no client agent: their heartbeat TTL outlasts the run
CLUSTER_SERVER = {"min_heartbeat_ttl_s": 3600.0,
                  "failover_heartbeat_ttl_s": 3600.0}
HOME_REGION = "global"
#: the resident allocs phase 12 enters, cut from RESIDENT: each entry of
#: RESIDENT_CHUNK allocs is decoded into three replicas' stores in one
#: process, ≈ 6.4 s an entry on the H100's host, so 100,000 took 63.6 s
#: of a 94.2 s entry; 60,000 keeps the entry near a minute
CLUSTER_RESIDENT = 60_000


def wait_for(pred, what, timeout=CLUSTER_WAIT_S):
    """Poll `pred` until true; the phase fails past `timeout` seconds.
    Returns the seconds waited."""
    t0 = time.perf_counter()
    while not pred():
        check(time.perf_counter() - t0 < timeout,
              f"{what}: not within {timeout} s")
        time.sleep(0.01)
    return time.perf_counter() - t0


class ClusterProbe:
    """What phase 12 reads from outside the cluster: the bytes every
    RPC frame carried over loopback (each frame is read once, by its
    receiver) and the largest frame read, the largest AppendEntries
    each raft leader cut (encoded entries) and how many batches the
    frame limit cut, every resident
    world built (when it ended, ms), and the packed batch of the last
    single-lane solve while `capture` is on."""

    def __init__(self, servers):
        import threading
        from nomad_tpu_torch.rpc import wire
        from nomad_tpu_torch.solver import solve as solve_mod
        from nomad_tpu_torch.solver.solve import Solver
        self.loopback = 0
        #: the largest read of one frame's body (W5 resets it)
        self.max_frame = 0
        self.appends = {"max_bytes": 0, "batches": 0, "cut_by_bytes": 0}
        self.world_builds = []
        self.capture, self.last_pb = False, None
        lock = threading.Lock()
        restore = []
        real_recv = wire._recv_exact

        def recv_exact(sock, n):
            b = real_recv(sock, n)
            with lock:
                self.loopback += len(b)
                self.max_frame = max(self.max_frame, n)
            return b
        wire._recv_exact = recv_exact
        restore.append(lambda: setattr(wire, "_recv_exact", real_recv))
        for s in servers:
            self.watch_raft(s)
        real_async = Solver.solve_async

        def solve_async(solver, *a, **kw):
            pending = real_async(solver, *a, **kw)
            if self.capture:
                self.last_pb = snapshot_pb(pending.packed)
            return pending
        Solver.solve_async = solve_async
        restore.append(lambda: setattr(Solver, "solve_async", real_async))
        real_world = solve_mod._ResidentWorld
        builds = self.world_builds

        class TimedWorld(real_world):
            def __init__(self, *a, **kw):
                t = time.perf_counter()
                super().__init__(*a, **kw)
                t1 = time.perf_counter()
                builds.append((t1, 1e3 * (t1 - t)))
        solve_mod._ResidentWorld = TimedWorld
        restore.append(lambda: setattr(solve_mod, "_ResidentWorld",
                                       real_world))
        self.close = lambda: [fn() for fn in reversed(restore)]

    def watch_raft(self, srv):
        real = srv.raft._frame_batch

        def frame_batch(peer, entries):
            out = real(peer, entries)
            if out:
                n = 1 + sum(e.encoded_bytes() + 1 for e in out)
                a = self.appends
                a["max_bytes"] = max(a["max_bytes"], n)
                a["batches"] += 1
                a["cut_by_bytes"] += len(out) < len(entries)
            return out
        srv.raft._frame_batch = frame_batch


def cluster_state(structs, servers, leader, jobs, evals, what):
    """Phase 12's hard checks after a leg: every live replica holds the
    leader's allocs (ids, nodes, client statuses) once it has applied
    the leader's log; no node oversubscribed; each leg eval complete and
    its job's placements all in the store or left to a blocked eval of
    the job.  Returns (placed by the leg's jobs, unplaced)."""
    target = leader.raft.last_applied
    wait_for(lambda: all(s.raft.last_applied >= target for s in servers),
             f"{what}: a replica to apply the leader's log")

    def allocs(s):
        return {(a.id, a.node_id, a.client_status) for a in s.store.allocs()}
    want = allocs(leader)
    for s in servers:
        if s is not leader:
            got = allocs(s)
            check(got == want, f"{what}: replica {s.raft.id} holds "
                  f"{len(got ^ want)} allocs unlike the leader's")
    for n in leader.store.nodes():
        live = leader.store.allocs_by_node_terminal(n.id, False)
        fit, dim, _used = structs.allocs_fit(n, live)
        check(fit, f"{what}: node {n.name} oversubscribed ({dim})")
    blocked = {e.job_id for e in leader.store.evals()
               if e.status == structs.EVAL_STATUS_BLOCKED}
    placed = unplaced = 0
    for job, ev_id in zip(jobs, evals):
        ev = leader.store.eval_by_id(ev_id)
        check(ev is not None and ev.status == structs.EVAL_STATUS_COMPLETE,
              f"{what}: eval of {job.id} is "
              f"{ev.status if ev else None!r}")
        names = [a.name for a in leader.store.allocs_by_job(
            structs.DEFAULT_NAMESPACE, job.id)]
        check(len(set(names)) == len(names), f"{what}: {job.id} has "
              "duplicate alloc names")
        want_n = sum(tg.count for tg in job.task_groups)
        check(len(names) == want_n or job.id in blocked,
              f"{what}: {job.id} placed {len(names)} of {want_n} and no "
              "blocked eval holds the rest")
        placed += len(names)
        unplaced += want_n - len(names)
    return placed, unplaced


def leg_launches(torch, wk, what, modes):
    """The leg's launch counts (zeroed just before it); the leg must
    have launched the wave kernel in each of `modes`."""
    torch.cuda.synchronize()
    counts = dict(wk.fused_wave.mode_launches)
    for m in modes:
        check(counts[m] > 0, f"{what}: no {m} launch ({counts})")
    check(counts["merge"] == counts["topk"],
          f"{what}: merge launches {counts}")
    return counts


def leg_join(torch, wk, structs, mock, servers, live, leader, probe, kw,
             endpoints, legs, joined):
    """Phase 12 W5: the leader takes a snapshot of the whole state (the
    threshold compaction of the entry held only the nodes), then a
    fourth server joins as a learner with an empty log.  It is behind
    the leader's compaction point, so it catches up by a chunked
    InstallSnapshot of a snapshot larger than MAX_FRAME, then joins the
    voters, and a job registered at it is forwarded and placed.  Records
    the snapshot's bytes, its chunks, the largest frame read, the time
    to catch up.  Leadership is looked up each time: should it move, the
    join goes on through the new leader, and the leg records it.  The
    joiner and its RpcServer go into `joined`, for the phase's clean-up;
    its allocs must equal the leader's."""
    from nomad_tpu_torch.raft import NotLeaderError, RaftConfig
    from nomad_tpu_torch.rpc import wire
    from nomad_tpu_torch.rpc.endpoints import RpcServerEndpoints, ServerRpc
    from nomad_tpu_torch.rpc.server import RpcServer
    from nomad_tpu_torch.rpc.transport import TcpRaftTransport
    from nomad_tpu_torch.server.server import Server
    zero_launches(torch, wk)
    b0 = probe.loopback
    lead = leader()
    threshold_index = lead.raft.snapshot_index
    check(threshold_index > 0, "W5: the leader never compacted its log")
    t = time.perf_counter()
    snap_index = lead.raft.snapshot_now()
    snap_s = time.perf_counter() - t
    snap_bytes = len(lead.raft._read_snapshot())
    check(snap_bytes > wire.MAX_FRAME, f"W5: the snapshot ({snap_bytes} "
          f"bytes) fits one frame ({wire.MAX_FRAME})")
    jid = f"s{len(servers) + 1}"
    rpc = RpcServer("127.0.0.1", 0)
    addrs = {**lead.raft.transport.peer_addrs, jid: rpc.addr}
    # the joiner knows the voters, not itself: a learner until the
    # configuration that adds it commits
    joiner = Server(num_workers=2, raft_config=RaftConfig(
        node_id=jid, peers=list(lead.raft.cfg.peers), **CLUSTER_RAFT),
        raft_transport=TcpRaftTransport(rpc, addrs), **kw)
    ServerRpc(joiner, rpc, addrs)
    joined.append((joiner, rpc))          # the phase stops them
    rpc.start()
    joiner.start()
    for s in live():
        s.raft.transport.peer_addrs[jid] = rpc.addr
    # every InstallSnapshot call to the joiner, from whichever server
    # leads: (leader, offset, bytes, total, done, bytes held after, s)
    chunks, restore = [], []

    def watch(server):
        transport = server.raft.transport
        real_call = transport.call

        def call(target, method, *args):
            if target != jid or method != "rpc_install_snapshot":
                return real_call(target, method, *args)
            t0, held = time.perf_counter(), None
            try:
                out = real_call(target, method, *args)
                held = out[1]
                return out
            finally:
                chunks.append((server.raft.id, args[4], len(args[7]),
                               args[5], args[6], held,
                               time.perf_counter() - t0))
        transport.call = call
        restore.append(lambda: setattr(transport, "call", real_call))
    for s in live():
        watch(s)
    probe.max_frame = 0
    leaders, moves = [], []
    t = time.perf_counter()
    try:
        while True:
            lead = leader()
            leaders.append(lead.raft.id)
            try:
                lead.add_server_peer(jid, rpc.addr,
                                     catchup_timeout_s=CLUSTER_WAIT_S)
                break
            except NotLeaderError:
                moves.append({"s": time.perf_counter() - t,
                              "chunks_sent": len(chunks),
                              "members": [(m.raft.id, m.raft.role,
                                           m.raft.term, m.raft.last_applied)
                                          for m in live() + [joiner]],
                              # the old leader's dial back-off: peer ->
                              # failed calls in a row
                              "backoff": {p: f for p, (_u, f) in dict(
                                  lead.raft.transport._backoff).items()}})
                check(len(moves) < 3, f"W5: leadership moved {len(moves)} "
                      f"times during the join: {moves}")
    finally:
        for fn in restore:
            fn()
    joined_s = time.perf_counter() - t
    max_frame = probe.max_frame
    lead = leader()
    target = lead.raft.last_applied
    wait_for(lambda: joiner.raft.last_applied >= target,
             "W5: the joiner to apply the leader's log")
    caught_s = time.perf_counter() - t
    # the installs the joiner completed: (leader, total) -> chunks
    installs = collections.Counter(
        (who, total) for who, _o, _n, total, _d, _h, _s in chunks)
    done = [(who, total) for who, _o, _n, total, d, held, _s in chunks
            if d and held == total]
    legs["W5"] = row = {
        "joiner": jid, "threshold_snapshot_index": threshold_index,
        "snapshot_index": snap_index, "snapshot_bytes": snap_bytes,
        "snapshot_take_s": snap_s,
        "snapshot_over_max_frame": snap_bytes / wire.MAX_FRAME,
        "installs_done": [{"leader": w, "bytes": n, "chunks": installs[
            (w, n)]} for w, n in done],
        "chunks": len(chunks),
        "chunk_bytes_max": max((n for _w, _o, n, *_r in chunks), default=0),
        "refused_chunks": sum(1 for c in chunks
                              if c[5] is not None and c[5] < c[1] + c[2]
                              and c[5] < c[3]),
        "largest_frame_bytes": max_frame, "max_frame": wire.MAX_FRAME,
        "install_calls_s": {"sum": sum(c[6] for c in chunks),
                            "max": max((c[6] for c in chunks), default=0)},
        "learner_caught_up_s": joined_s, "caught_up_s": caught_s,
        "leaders": leaders, "leadership_moves": moves}
    check(jid in lead.raft.cfg.peers and jid in joiner.raft.cfg.peers,
          f"W5: {jid} is not a voter")
    check(any(n > wire.MAX_FRAME and installs[(w, n)] > 1 for w, n in done),
          f"W5: no install of a snapshot past MAX_FRAME completed "
          f"({row['installs_done']}, {len(chunks)} chunks)")
    check(max_frame <= wire.MAX_FRAME, f"W5: a frame of {max_frame} bytes "
          f"past the limit {wire.MAX_FRAME}")
    ep = RpcServerEndpoints([rpc.addr])
    endpoints.append(ep)
    job = make_job(mock, structs, "c5-joiner", COUNT)
    t = time.perf_counter()
    ev_id = ep.register_job(job)["id"]
    wait_evals(lead, [ev_id], 120)
    row["eval_via_joiner_ms"] = 1e3 * (time.perf_counter() - t)
    row["launches"] = leg_launches(torch, wk, "W5", ("topk",))
    row["placed"], row["unplaced"] = cluster_state(
        structs, live() + [joiner], lead, [job], [ev_id], "W5")
    row.update(peers=lead.raft.cfg.peers,
               loopback_bytes=probe.loopback - b0)


def phase_cluster(torch, wk, n_nodes, resident):
    """Phase 12: a three-server cluster of the port over TCP (the
    reference's `serve_cluster`) with gossip and autopilot, the
    config-3 state entered through the leader, and four legs: W1 jobs
    registered at a follower and forwarded, W2 jobs from four client
    threads over all three servers, W3 the leader killed (election,
    gossip, autopilot, the new leader's world, jobs through the server
    list's failover), W4 a job registered from another region through
    gossip.  Returns the launch counts of the legs."""
    import gc
    import resource
    import threading
    from nomad_tpu_torch import mock, structs
    from nomad_tpu_torch.membership import GossipAgent, Member, RegionRouter
    from nomad_tpu_torch.membership.gossip import STATUS_DEAD
    from nomad_tpu_torch.rpc import wire
    from nomad_tpu_torch.rpc.endpoints import (RpcServerEndpoints,
                                               serve_cluster)
    from nomad_tpu_torch.server.eval_broker import FAILED_QUEUE
    from nomad_tpu_torch.utils.codec import to_wire
    from nomad_tpu_torch.utils.metrics import global_metrics
    from nomad_tpu_torch.utils.tracing import global_tracer
    wk._load()          # the kernels are built and bound by this thread
    t_phase = time.perf_counter()
    kw = {"device": DEVICE, **CLUSTER_SERVER}
    servers, srpcs, _addrs = serve_cluster(3, num_workers=2,
                                           server_kwargs=kw,
                                           raft_kwargs=CLUSTER_RAFT)
    rpcs = [r.rpc for r in srpcs]
    gossips = [GossipAgent(Member(id=s.raft.id, addr=r.addr,
                                  region=HOME_REGION), r, **CLUSTER_GOSSIP)
               for s, r in zip(servers, rpcs)]
    stopped = set()                   # W3's deliberate stop
    alpha, alpha_rpc, alpha_gossip, router = None, None, None, None
    joined = []                       # W5's member: (server, its rpc)
    endpoints, rounds_probe = [], None
    row = {"phase": "cluster", "servers": len(servers),
           "nodes": n_nodes, "resident_allocs": resident,
           "resident_cut": RESIDENT - resident, "raft": CLUSTER_RAFT,
           "gossip": CLUSTER_GOSSIP, "max_frame": wire.MAX_FRAME}
    legs = {}
    total = collections.Counter()

    def live():
        return [s for i, s in enumerate(servers) if i not in stopped]

    def leader():
        found = []

        def one():
            found[:] = [s for s in live() if s.is_leader()]
            return len(found) == 1
        wait_for(one, "a single leader")
        return found[0]

    def loopback(leg, b0):
        legs[leg]["loopback_bytes"] = probe.loopback - b0

    probe = ClusterProbe(servers)
    m_start = global_metrics.dump()
    # three replicas of the config-3 state in one process make a full
    # collection a stop-the-world pause that grows with the legs' objects
    # past raft's election timeout and gossip's probe timeout (1.3 s at
    # 10,000 allocs in a CPU rehearsal): the collector is off for the
    # phase, and the entered state is frozen out of it
    gc.collect()
    gc.disable()
    try:
        for s, g in zip(servers, gossips):
            s.attach_gossip(g)
            g.start()
        for g in gossips[1:]:
            g.join(gossips[0].me.addr)
        wait_for(lambda: all(len(g.members(alive_only=True)) == 3
                             for g in gossips), "gossip membership of 3")
        lead = leader()

        # ---- entry: the config-3 state through the leader, over TCP
        b0 = probe.loopback
        t0 = time.perf_counter()
        nodes, setup = server_cluster(lead, mock, structs, n_nodes,
                                      resident, node_threads=8)
        target = lead.raft.last_applied
        setup["replicated_s"] = wait_for(
            lambda: all(s.raft.last_applied >= target for s in servers),
            "the entry's replication")
        setup["entry_s"] = time.perf_counter() - t0
        gc.freeze()
        setup["frozen_objects"] = gc.get_freeze_count()
        legs["entry"] = setup
        loopback("entry", b0)
        check(leader() is lead, "leadership changed during the entry")
        registered = []
        warm_ms = warm_worlds(
            lead, lambda i: make_job(mock, structs, f"cw{i}", COUNT),
            registered)
        rounds_probe = ServerProbe(lead, wk)

        # ---- W1: jobs registered at a follower, forwarded to the leader
        follower = next(i for i, s in enumerate(servers) if s is not lead)
        ep1 = RpcServerEndpoints([rpcs[follower].addr])
        endpoints.append(ep1)
        reg_s, commit_s = {}, {}
        local = threading.local()
        real_reg, real_prop = lead.register_job, lead._propose

        def register_job(job, *a, **kw):
            local.commit = commit_s.setdefault(job.id, [])
            t = time.perf_counter()
            try:
                return real_reg(job, *a, **kw)
            finally:
                reg_s[job.id] = time.perf_counter() - t
                local.commit = None

        def propose(etype, payload):
            t = time.perf_counter()
            try:
                return real_prop(etype, payload)
            finally:
                sink = getattr(local, "commit", None)
                if sink is not None:
                    sink.append(time.perf_counter() - t)
        lead.register_job, lead._propose = register_job, propose
        zero_launches(torch, wk)
        b0 = probe.loopback
        probe.capture = True
        walls, splits, evals_w1, jobs_w1 = [], [], [], []
        for e in range(CLUSTER_W1):
            job = make_job(mock, structs, f"c1-{e}", COUNT)
            t = time.perf_counter()
            ev_id = ep1.register_job(job)["id"]
            t_rpc = time.perf_counter()
            wait_evals(lead, [ev_id], 120)
            walls.append(time.perf_counter() - t)
            split, attrs = eval_split(global_tracer, ev_id)
            split["register"] = 1e3 * reg_s[job.id]
            split["raft_commit"] = 1e3 * sum(commit_s[job.id])
            split["rpc_forward"] = 1e3 * (t_rpc - t) - split["register"]
            split["rest"] = 1e3 * walls[-1] - sum(
                split[k] for k in ("rpc_forward", "register", "queue",
                                   "wait_index", "pre_solve", "solve",
                                   "plan_submit"))
            splits.append(split)
            evals_w1.append(ev_id)
            jobs_w1.append(job)
            check(attrs.get("resident") and attrs.get("backend")
                  == "device", f"W1 eval {e}: off the resident card "
                  f"route ({attrs.get('backend')!r})")
        probe.capture = False
        counts = leg_launches(torch, wk, "W1", ("topk",))
        ms = [1e3 * w for w in walls]
        legs["W1"] = {
            "jobs": CLUSTER_W1, "via": f"follower {servers[follower].raft.id}",
            "p50_ms": pct(ms, 0.5), "p99_ms": pct(ms, 0.99), "walls_ms": ms,
            "split_p50_ms": {k: pct([s[k] for s in splits], 0.5)
                             for k in splits[0]},
            "split_p99_ms": {k: pct([s[k] for s in splits], 0.99)
                             for k in splits[0]},
            "gc": {"enabled": gc.isenabled(), "counts": gc.get_count(),
                   "frozen": gc.get_freeze_count()},
            "threads": threading.active_count(), "launches": counts}
        total.update(counts)
        loopback("W1", b0)
        placed, unplaced = cluster_state(structs, live(), lead, jobs_w1,
                                             evals_w1, "W1")
        legs["W1"].update(placed=placed, unplaced=unplaced)
        pb_w1 = probe.last_pb
        check(pb_w1 is not None, "W1: no packed batch captured")
        kernel_vs_plain(wk, (("last W1 eval", pb_w1, "topk"),))
        lead.register_job, lead._propose = real_reg, real_prop

        # one more W1 job under torch.profiler: the card's busy share
        def one_eval():
            t = time.perf_counter()
            ev_id = ep1.register_job(make_job(mock, structs, "c1-prof",
                                              COUNT))["id"]
            wait_evals(lead, [ev_id], 120)
            return 1e3 * (time.perf_counter() - t)
        wall_ms, by_name = profile_card(torch, one_eval)
        busy_ms = sum(by_name.values())
        legs["W1"]["profiled_eval"] = {
            "wall_ms": wall_ms, "busy_ms": busy_ms,
            "busy_share": busy_ms / wall_ms if busy_ms else None,
            "top_device_ms": dict(by_name.most_common(8))}

        # ---- W2: four client threads over all three servers
        zero_launches(torch, wk)
        b0 = probe.loopback
        mark, m0 = rounds_probe.mark(), global_metrics.dump()
        addrs = [r.addr for r in rpcs]
        jobs_w2 = [make_job(mock, structs, f"c2-{e}", COUNT)
                   for e in range(CLUSTER_W2)]
        bjob = batch_job(mock, structs, BATCH_COUNT)
        bjob.id = bjob.name = "batch-fanout-cluster"
        per = CLUSTER_W2 // CLUSTER_W2_CLIENTS
        shares = [jobs_w2[k * per:(k + 1) * per]
                  for k in range(CLUSTER_W2_CLIENTS)]
        shares[0].append(bjob)
        evals_w2, errors = {}, []

        def client(k):
            ep = RpcServerEndpoints(addrs[k % 3:] + addrs[:k % 3])
            endpoints.append(ep)
            try:
                for job in shares[k]:
                    evals_w2[job.id] = ep.register_job(job)["id"]
            except Exception as exc:        # read after the join
                errors.append(f"client {k}: {type(exc).__name__}: {exc}")
        threads = [threading.Thread(target=client, args=(k,))
                   for k in range(CLUSTER_W2_CLIENTS)]
        t = time.perf_counter()
        for th in threads:
            th.start()
        for th in threads:
            th.join(CLUSTER_WAIT_S)
        check(not any(th.is_alive() for th in threads),
              "W2: a client thread is still registering")
        check(not errors, f"W2: {errors}")
        register_s = time.perf_counter() - t
        all_w2 = jobs_w2 + [bjob]
        ids_w2 = [evals_w2[j.id] for j in all_w2]
        wait_evals(lead, ids_w2, CLUSTER_WAIT_S)
        wall = time.perf_counter() - t
        wait_for(lambda: lead.broker.stats()["total_unacked"] == 0,
                 "W2: the fused rounds' acks")
        counts = leg_launches(torch, wk, "W2", ("score",))
        total.update(counts)
        m1 = global_metrics.dump()
        rounds = rounds_probe.since(mark)["rounds"]
        placed, unplaced = cluster_state(structs, live(), lead, all_w2,
                                             ids_w2, "W2")
        legs["W2"] = {
            "jobs": CLUSTER_W2, "batch_count": BATCH_COUNT,
            "clients": CLUSTER_W2_CLIENTS, "register_s": register_s,
            "wall_s": wall, "evals_per_s": len(ids_w2) / wall,
            "placed": placed, "unplaced": unplaced,
            "placements_per_s": placed / wall,
            "fused_rounds": len(rounds),
            "round_evals": [r["evals"] for r in rounds],
            "score_rounds": sum(1 for r in rounds
                                if r["modes"].get("score")),
            "group_commits": (m1["counters"].get("plan.group_commits", 0.0)
                              - m0["counters"].get("plan.group_commits",
                                                   0.0)),
            "launches": counts}
        loopback("W2", b0)
        rounds_probe.close()
        rounds_probe = None

        # ---- W3: the leader killed
        zero_launches(torch, wk)
        b0 = probe.loopback
        li = servers.index(lead)
        dead_id = lead.raft.id
        # the new leader restores these first (leader.go restoreEvals)
        blocked_at_kill = sum(1 for e in lead.store.evals()
                              if e.status == structs.EVAL_STATUS_BLOCKED)
        marks, watching = {}, threading.Event()

        def watch():
            # each event's first sight, seconds after the kill
            others = [(s, g) for i, (s, g) in enumerate(zip(servers,
                                                            gossips))
                      if i != li]
            while not watching.is_set():
                now = time.perf_counter() - t_kill
                if any(s.is_leader() for s, _g in others):
                    marks.setdefault("election_s", now)
                if all(g.member(dead_id) is not None
                       and g.member(dead_id).status == STATUS_DEAD
                       for _s, g in others):
                    marks.setdefault("gossip_dead_s", now)
                if any(s.is_leader() and dead_id not in s.raft.cfg.peers
                       and len(s.raft.cfg.peers) == 2 for s, _g in others):
                    marks.setdefault("autopilot_s", now)
                time.sleep(0.005)
        watcher = threading.Thread(target=watch, daemon=True)
        t_kill = time.perf_counter()
        rpcs[li].stop()
        gossips[li].stop()
        lead.stop()
        stopped.add(li)
        w3 = {"killed": dead_id, "stop_s": time.perf_counter() - t_kill,
              "blocked_evals_restored": blocked_at_kill}
        watcher.start()
        new = leader()
        w3["new_leader"] = new.raft.id
        ep3 = RpcServerEndpoints([rpcs[li].addr] + [
            rpcs[i].addr for i in range(3) if i != li])
        endpoints.append(ep3)
        first = make_job(mock, structs, "c3-first", COUNT)
        t = time.perf_counter()
        ev_first = ep3.register_job(first)["id"]
        wait_evals(new, [ev_first], 120)
        w3["first_eval_ms"] = 1e3 * (time.perf_counter() - t)
        w3["first_placement_s"] = time.perf_counter() - t_kill
        try:
            wait_for(lambda: len(marks) == 3, "W3: the election, gossip "
                     f"marking {dead_id} dead and autopilot dropping it")
        except PhaseError as e:
            raise PhaseError(f"{e} (seen: {dict(marks)})") from None
        finally:
            watching.set()
            watcher.join(5.0)
        w3.update(marks)
        check(leader() is new, "W3: leadership moved again")
        w3["warm_eval_ms"] = warm_worlds(
            new, lambda i: make_job(mock, structs, f"c3w{i}", COUNT),
            registered)
        # the new leader's worlds, each built by the first eval its
        # worker took (seconds after the kill it ended, ms it took)
        w3["world_builds"] = [{"done_s": t - t_kill, "ms": ms}
                              for t, ms in probe.world_builds if t > t_kill]
        check(len(w3["world_builds"]) >= 2, "W3: the new leader's "
              f"workers built {len(w3['world_builds'])} worlds")
        walls, evals_w3, jobs_w3 = [], [ev_first], [first]
        for e in range(CLUSTER_W3):
            job = make_job(mock, structs, f"c3-{e}", COUNT)
            t = time.perf_counter()
            ev_id = ep3.register_job(job)["id"]
            wait_evals(new, [ev_id], 120)
            walls.append(1e3 * (time.perf_counter() - t))
            evals_w3.append(ev_id)
            jobs_w3.append(job)
        counts = leg_launches(torch, wk, "W3", ("topk",))
        total.update(counts)
        placed, unplaced = cluster_state(structs, live(), new, jobs_w3,
                                             evals_w3, "W3")
        w3.update(jobs=CLUSTER_W3, p50_ms=pct(walls, 0.5),
                  p99_ms=pct(walls, 0.99), walls_ms=walls, placed=placed,
                  unplaced=unplaced, deliberate_stops=len(stopped),
                  peers=leader().raft.cfg.peers, launches=counts)
        legs["W3"] = w3
        loopback("W3", b0)
        lead = new

        # ---- W4: a job registered from another region, through gossip
        zero_launches(torch, wk)
        b0 = probe.loopback
        a_servers, a_rpcs, _ = serve_cluster(
            1, num_workers=1, server_kwargs=kw, raft_kwargs=CLUSTER_RAFT)
        alpha, alpha_rpc = a_servers[0], a_rpcs[0].rpc
        alpha_gossip = GossipAgent(Member(id="alpha-1", addr=alpha_rpc.addr,
                                          region="alpha"), alpha_rpc,
                                   **CLUSTER_GOSSIP)
        alpha_gossip.start()
        alpha_gossip.join(gossips[next(i for i in range(3)
                                       if i not in stopped)].me.addr)
        wait_for(lambda: alpha_gossip.regions() == sorted(
            ["alpha", HOME_REGION]) and len(alpha_gossip.members_of_region(
                HOME_REGION)) == 2, "W4: the regions' gossip")
        wait_for(alpha.is_leader, "W4: region alpha's leader")
        router = RegionRouter(alpha_gossip)
        job = make_job(mock, structs, "c4-remote", COUNT)
        t = time.perf_counter()
        ev_id = router.call_region(HOME_REGION, "Job.Register",
                                   [to_wire(job)])["id"]
        wait_evals(lead, [ev_id], 120)
        w4 = {"wall_ms": 1e3 * (time.perf_counter() - t),
              "regions": router.regions()}
        check(alpha.store.job_by_id(structs.DEFAULT_NAMESPACE, job.id)
              is None, "W4: the job landed in region alpha")
        counts = leg_launches(torch, wk, "W4", ("topk",))
        total.update(counts)
        placed, unplaced = cluster_state(structs, live(), lead, [job],
                                             [ev_id], "W4")
        w4.update(placed=placed, unplaced=unplaced, launches=counts)
        legs["W4"] = w4
        loopback("W4", b0)

        # ---- W5: a fourth server joins behind the compaction point
        leg_join(torch, wk, structs, mock, servers, live, leader, probe,
                 kw, endpoints, legs, joined)
        total.update(legs["W5"]["launches"])
        lead = leader()

        # ---- the record: frames and the snapshot against the limit
        m_end = global_metrics.dump()
        for key in ("worker.batch_error", "telemetry.tick_error"):
            errs = (m_end["counters"].get(key, 0.0)
                    - m_start["counters"].get(key, 0.0))
            check(errs == 0, f"{errs} {key} in the phase")
        broker = lead.broker.stats()
        check(broker["by_scheduler"].get(FAILED_QUEUE, 0) == 0,
              "evals parked on the broker's failed queue")
        snap = legs["W5"]["snapshot_bytes"]       # the whole state
        row["frames"] = {
            "max_append_bytes": probe.appends["max_bytes"],
            "append_batches": probe.appends["batches"],
            "cut_by_bytes": probe.appends["cut_by_bytes"],
            "snapshot_bytes": snap,
            "snapshot_s": legs["W5"]["snapshot_take_s"],
            "snapshot_over_max_frame": snap > wire.MAX_FRAME}
        check(probe.appends["max_bytes"] <= wire.MAX_FRAME,
              "an AppendEntries past the frame limit")
        row["warm_eval_ms"] = warm_ms
        row["world_builds_ms"] = [ms for _t, ms in probe.world_builds]
        row["peak_rss_gb"] = resource.getrusage(
            resource.RUSAGE_SELF).ru_maxrss / 2 ** 20
    except PhaseError as e:
        row.update(failed=str(e), legs=legs)
        emit(row)
        raise
    finally:
        if rounds_probe is not None:
            rounds_probe.close()
        probe.close()
        if router is not None:
            router.close()
        for ep in endpoints:
            ep.close()
        for g in gossips + ([alpha_gossip] if alpha_gossip else []):
            g.stop()
        for i, s in enumerate(servers):
            if i not in stopped:
                s.stop()
            rpcs[i].stop()
        if alpha is not None:
            alpha.stop()
            alpha_rpc.stop()
        for j_srv, j_rpc in joined:
            j_srv.stop()
            j_rpc.stop()
        gc.unfreeze()
        gc.enable()
    row.update(legs=legs, seconds=time.perf_counter() - t_phase,
               launches=dict(total))
    emit(row)
    return {m: total[m] for m in ("score", "topk", "merge")}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--baseline", metavar="DIR",
                    help="also time the fused wave kernel of the checkout "
                    "at DIR (e.g. the parent commit), kernel-only, in "
                    "turns with this tree's")
    args = ap.parse_args()
    sys.path.insert(0, HERE)
    from nomad_tpu_torch.solver import wave_kernel as wk

    card = phase_device(torch)
    phase_build(wk)
    base_wk = load_baseline(args.baseline) if args.baseline else None
    kern = phase_kernel(torch, wk, base_wk)
    phase_solve(torch, wk, N_NODES, RESIDENT, N_EVALS)
    counts5 = phase_schedule(torch, wk, N_NODES, RESIDENT, N_SERVICE_EVALS,
                             BATCH_COUNT)
    counts, calls, row6 = phase_worker(torch, wk, N_NODES, RESIDENT,
                                       N_SERVICE_EVALS, BATCH_COUNT)
    # phase 13 runs on phase 7's server, after phase 7's checks
    counts7, calls7, _row7, counts13 = phase_server(
        torch, wk, N_NODES, RESIDENT, N_SERVICE_EVALS, N_BURST_JOBS,
        BATCH_COUNT, phase6=row6["service"],
        then=lambda srv: phase_lifecycle(torch, wk, srv))
    counts8 = phase_preempt(torch, wk, N_NODES, N_PREEMPT_JOBS,
                            N_PREEMPT_JOBS)
    counts9, calls9, _row9 = phase_stream(torch, wk, N_NODES, RESIDENT,
                                          N_STREAM_EVALS)
    counts10 = phase_host_route(torch, wk)
    counts11, calls11, _legs11 = phase_mesh(torch, wk)
    counts12 = phase_cluster(torch, wk, N_NODES, CLUSTER_RESIDENT)
    # the kernels on the main path's own arguments (phase 6), and the
    # score kernel on the first fused score round's (phase 7)
    kern.update(kernel_case(torch, wk, "score (batch eval)",
                            calls["score"], base_wk))
    kern.update(kernel_case(torch, wk, "topk (service eval)",
                            calls["topk"], base_wk))
    kern.update(kernel_case(torch, wk, "score (fused round)",
                            calls7["score"], base_wk))
    # and on a mesh shard's (phase 11, shard 0: L0's topk call, L1's
    # pinned score call)
    for mode in ("score", "topk"):
        kern.update(kernel_case(torch, wk, f"{mode} (mesh shard)",
                                calls11[mode], base_wk))
    # and on the resident stream's (phase 9): a main-leg chunk's first
    # score call, a drain batch's first topk call where the leg drained
    stream_cases = {"score": "score (stream chunk)",
                    "topk": "topk (stream drain)"}
    for mode, case in stream_cases.items():
        if mode in calls9:
            kern.update(kernel_case(torch, wk, case, calls9[mode],
                                    base_wk))
    src = "nomad_tpu_torch/solver/csrc/wave_kernel.cu"
    kernels = []
    # fused_wave[topk] is the whole topk launch (tile kernel + merge);
    # fused_wave[topk merge] is the merge kernel alone
    for name, mode, case, line in (
            ("fused_wave[score]", "score", "score (batch eval)", 317),
            ("fused_wave[topk]", "topk", "topk (service eval)", 543),
            ("fused_wave[topk merge]", "merge",
             "topk merge (service eval)", 333)):
        r = kern[case]
        kernels.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": f"nomad_tpu/solver/pallas_kernel.py:{line}",
            "launches": counts[mode], "launches_phase5": counts5[mode],
            "launches_phase7": counts7[mode],
            "launches_phase8": counts8[mode],
            "launches_phase9": counts9[mode],
            "launches_phase10": counts10[mode],
            "launches_phase11": counts11[mode],
            "launches_phase12": counts12[mode],
            "launches_phase13": counts13[mode],
            "max_abs_err": r["max_abs_err"],
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": None, "kernel_ms_cold": r["kernel_ms_cold"],
            "kernel_ms_warm": r["kernel_ms_warm"],
            "wrapper_ms": r["wrapper_ms"]})
        keys = ("Gp", "Np", "TK", "n_extract", "ms", "kernel_ms_warm",
                "wrapper_ms", "plain_ms", "bound_ms", "bound_by",
                "max_abs_err")
        if mode == "score":
            f = kern["score (fused round)"]
            kernels[-1]["fused_round"] = {k: f[k] for k in keys}
        m_case = {"score": "score (mesh shard)", "topk": "topk (mesh shard)",
                  "merge": "topk merge (mesh shard)"}[mode]
        kernels[-1]["mesh_shard"] = {k: kern[m_case][k] for k in keys
                                     if k in kern[m_case]}
        s_case = {"merge": "topk merge (stream drain)"}.get(
            mode, stream_cases.get(mode))
        if s_case in kern:
            kernels[-1]["stream"] = {k: kern[s_case][k] for k in keys
                                     if k in kern[s_case]}
    print(card, flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
