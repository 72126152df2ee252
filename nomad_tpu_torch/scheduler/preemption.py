"""Preemption: evict lower-priority allocs to make room.

Reference semantics: scheduler/preemption.go — Preemptor :96,
PreemptForTaskGroup :198, resource-distance scoring
`basicResourceDistance` :608, priority grouping with delta >= 10
`filterAndGroupPreemptibleAllocs` :663, redundant-victim filtering :702.

Host-side second pass: the device solve surfaces which placements
exhausted resources on otherwise-feasible nodes; this module picks the
minimum-distance victim set per candidate node.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

from ..structs import Allocation, Node

PRIORITY_DELTA = 10


def resource_distance(delta_cpu: float, delta_mem: float, delta_disk: float,
                      delta_net: float) -> float:
    """Normalized euclidean distance between a victim's resources and the
    still-needed resources (reference: basicResourceDistance :608)."""
    return (delta_cpu ** 2 + delta_mem ** 2 + delta_disk ** 2
            + delta_net ** 2) ** 0.5


def victim_distance(shortfall: Tuple[float, float, float, float],
                    usage: Tuple[float, float, float, float]) -> float:
    """Distance between a victim's usage and the remaining shortfall,
    each dimension normalized by the shortfall (floored at 1).

    This is THE single victim-cost contract: every host pass
    scores candidates through it, and the device eviction pass
    (the reference's solver/kernel.py preemption waves) mirrors it
    float-op-for-float-op.
    Term order inside resource_distance is part of the contract."""
    sc, sm, sd, sn = shortfall
    c, m, d, nw = usage
    return resource_distance((sc - c) / max(sc, 1.0),
                             (sm - m) / max(sm, 1.0),
                             (sd - d) / max(sd, 1.0),
                             (sn - nw) / max(sn, 1.0))


def take_from_groups(job_priority: int, allocs: Sequence[Allocation],
                     met, charge, order_key=None
                     ) -> Tuple[List[Allocation], bool]:
    """Shared victim-accumulation walk: priority groups lowest first
    (group_preemptible), victims inside a group consumed in `order_key`
    order (stable sort; None keeps candidate order), `charge`-ing each
    pick until `met()` — the one loop behind preempt_for_network and
    preempt_for_device (pick_victims re-sorts against a MOVING shortfall
    every pick, so it keeps its own loop over the same cost helper)."""
    victims: List[Allocation] = []
    for grp in group_preemptible(job_priority, allocs):
        if order_key is not None:
            grp.sort(key=order_key)
        for a in grp:
            charge(a)
            victims.append(a)
            if met():
                return victims, True
    return victims, False


def prune_superset(victims: List[Allocation], covers_without, order_key,
                   protected: frozenset = frozenset()
                   ) -> List[Allocation]:
    """Shared redundancy filter (reference :702): walk victims in
    `order_key` order and drop any whose eviction is redundant once the
    rest are out (`covers_without(trial)`), keeping `protected` ids."""
    pruned = list(victims)
    for a in sorted(victims, key=order_key):
        if a.id in protected:
            continue
        trial = [v for v in pruned if v.id != a.id]
        if covers_without(trial):
            pruned = trial
    return pruned


def _usage(alloc: Allocation) -> Tuple[float, float, float, float]:
    c = alloc.comparable_resources()
    return (float(c.cpu), float(c.memory_mb), float(c.disk_mb),
            float(sum(n.mbits for n in c.networks)))


def preemptible_allocs(job_priority: int, allocs: Sequence[Allocation]
                       ) -> List[Allocation]:
    """Victim candidates: non-terminal allocs at least PRIORITY_DELTA
    lower priority, lowest priority first."""
    out = []
    for a in allocs:
        if a.terminal_status():
            continue
        if a.job is None:
            # placeholder/probe allocs without a job snapshot have no
            # knowable priority — never victims
            continue
        prio = a.job.priority
        if job_priority - prio >= PRIORITY_DELTA:
            out.append((prio, a))
    out.sort(key=lambda t: (t[0], t[1].create_index))
    return [a for _p, a in out]


def pick_victims(node: Node, proposed: Sequence[Allocation],
                 job_priority: int, need_cpu: float, need_mem: float,
                 need_disk: float, need_net: float
                 ) -> Optional[List[Allocation]]:
    """Greedy minimum-distance victim selection on one node: repeatedly
    take the candidate closest to the remaining shortfall until the ask
    fits, then drop victims made redundant by later picks (reference:
    PreemptForTaskGroup :198 + :702)."""
    res = node.comparable_resources()
    reserved = node.comparable_reserved_resources()
    used_cpu = float(reserved.cpu)
    used_mem = float(reserved.memory_mb)
    used_disk = float(reserved.disk_mb)
    used_net = 0.0
    for a in proposed:
        c, m, d, nw = _usage(a)
        used_cpu += c
        used_mem += m
        used_disk += d
        used_net += nw
    cap_cpu = float(res.cpu)
    cap_mem = float(res.memory_mb)
    cap_disk = float(res.disk_mb)
    cap_net = float(sum(n.mbits for n in res.networks))

    def shortfall(freed):
        fc, fm, fd, fn = freed
        return (max(0.0, used_cpu - fc + need_cpu - cap_cpu),
                max(0.0, used_mem - fm + need_mem - cap_mem),
                max(0.0, used_disk - fd + need_disk - cap_disk),
                max(0.0, used_net - fn + need_net - cap_net))

    candidates = preemptible_allocs(job_priority, proposed)
    if not candidates:
        return None
    freed = (0.0, 0.0, 0.0, 0.0)
    victims: List[Allocation] = []
    remaining = list(candidates)
    while any(s > 0 for s in shortfall(freed)):
        if not remaining:
            return None
        short = shortfall(freed)
        remaining.sort(key=lambda a: victim_distance(short, _usage(a)))
        pick = remaining.pop(0)
        victims.append(pick)
        c, m, d, nw = _usage(pick)
        freed = (freed[0] + c, freed[1] + m, freed[2] + d, freed[3] + nw)

    # redundancy filter: drop any victim whose resources are not needed
    # once the rest are evicted (check highest-priority victims first so
    # the cheapest evictions survive)
    def covers_without(trial):
        fc = sum(_usage(v)[0] for v in trial)
        fm = sum(_usage(v)[1] for v in trial)
        fd = sum(_usage(v)[2] for v in trial)
        fn = sum(_usage(v)[3] for v in trial)
        return not any(s > 0 for s in shortfall((fc, fm, fd, fn)))

    pruned = prune_superset(
        victims, covers_without,
        order_key=lambda v: -(v.job.priority if v.job else 50))
    return pruned or None


def group_preemptible(job_priority: int, allocs: Sequence[Allocation]
                      ) -> List[List[Allocation]]:
    """Victim candidates grouped by job priority, lowest group first
    (reference: filterAndGroupPreemptibleAllocs :663)."""
    by_prio: Dict[int, List[Allocation]] = {}
    for a in allocs:
        if a.terminal_status() or a.job is None:
            continue
        if job_priority - a.job.priority < PRIORITY_DELTA:
            continue
        by_prio.setdefault(a.job.priority, []).append(a)
    return [by_prio[p] for p in sorted(by_prio)]


def _first_network(alloc: Allocation):
    nets = alloc.comparable_resources().networks
    return nets[0] if nets else None


def preempt_for_network(job_priority: int, proposed: Sequence[Allocation],
                        ask_net, node: Node
                        ) -> Optional[List[Allocation]]:
    """Find victims freeing bandwidth / reserved ports for one network
    ask (reference: PreemptForNetwork :270).  Victims must share the
    ask's network DEVICE; a needed reserved port held by a
    non-preemptible alloc disqualifies the whole device.  Within a
    device, victims are taken lowest-priority-first, closest MBits
    first (networkResourceDistance :627), until the ask fits; a final
    pass drops superset victims."""
    from ..structs.network import NetworkIndex

    if not proposed:
        return None
    mbits_needed = int(ask_net.mbits)
    ports_needed = [p.value for p in ask_net.reserved_ports]

    ni = NetworkIndex()
    ni.set_node(node)
    ni.add_allocs(proposed)

    device_allocs: Dict[str, List[Allocation]] = {}
    filtered_ports: Dict[str, set] = {}
    for a in proposed:
        if a.terminal_status() or a.job is None:
            continue
        net = _first_network(a)
        if net is None:
            continue
        if job_priority - a.job.priority < PRIORITY_DELTA:
            for pt in net.reserved_ports:
                filtered_ports.setdefault(net.device, set()).add(pt.value)
            continue
        device_allocs.setdefault(net.device, []).append(a)
    if not device_allocs:
        return None

    def net_distance(used_mbits: float) -> float:
        if mbits_needed <= 0:
            return float("inf")
        return abs((mbits_needed - used_mbits) / mbits_needed)

    for device, current in device_allocs.items():
        total_bw = ni.avail_bandwidth.get(device, 0)
        if total_bw < mbits_needed:
            continue
        free_bw = total_bw - ni.used_bandwidth.get(device, 0)
        victims: List[Allocation] = []
        preempted_bw = 0

        if ports_needed:
            used_port_to_alloc = {}
            for a in current:
                for n in a.comparable_resources().networks:
                    for pt in n.reserved_ports:
                        used_port_to_alloc[pt.value] = a
            blocked = False
            for port in ports_needed:
                holder = used_port_to_alloc.get(port)
                if holder is not None:
                    if holder not in victims:
                        net = _first_network(holder)
                        preempted_bw += int(net.mbits) if net else 0
                        victims.append(holder)
                elif port in filtered_ports.get(device, ()):
                    blocked = True        # higher-priority holder
                    break
            if blocked:
                continue
            current = [a for a in current if a not in victims]

        met = preempted_bw + free_bw >= mbits_needed
        if not met:
            bw = {"freed": preempted_bw}

            def charge(a):
                net = _first_network(a)
                bw["freed"] += int(net.mbits) if net else 0

            taken, met = take_from_groups(
                job_priority, current,
                met=lambda: bw["freed"] + free_bw >= mbits_needed,
                charge=charge,
                order_key=lambda a: net_distance(
                    _first_network(a).mbits if _first_network(a) else 0))
            victims.extend(taken)
            preempted_bw = bw["freed"]
        if not met:
            continue
        # superset filter: drop victims (largest distance first) whose
        # bandwidth is not needed once the rest are evicted, keeping
        # reserved-port holders (their eviction is what frees the port)
        port_holders = set()
        for a in victims:
            net = _first_network(a)
            if net and any(p.value in ports_needed
                           for p in net.reserved_ports):
                port_holders.add(a.id)

        def covers_without(trial):
            freed = sum(int(_first_network(v).mbits)
                        for v in trial if _first_network(v))
            return freed + free_bw >= mbits_needed

        pruned = prune_superset(
            victims, covers_without,
            order_key=lambda v: -net_distance(
                _first_network(v).mbits if _first_network(v) else 0),
            protected=frozenset(port_holders))
        return pruned or None
    return None


def preempt_for_device(job_priority: int, proposed: Sequence[Allocation],
                       ask, node: Node, extra_needed: int = 0
                       ) -> Optional[List[Allocation]]:
    """Find victims freeing device instances for one device ask
    (reference: PreemptForDevice :472).  Allocations are grouped by the
    device group they hold instances of; per group, victims accumulate
    lowest-priority-first until freed + free >= ask.count; across groups
    the option with the smallest net priority (sum of unique victim
    priorities) wins (selectBestAllocs :559).  Device-attribute
    constraints on the ask are not re-checked here (the solver's device
    dimension already filtered candidate nodes)."""
    from ..structs.devices import DeviceAccounter

    acct = DeviceAccounter(node)
    acct.add_allocs(proposed)

    matching = {dev.id_tuple() for dev in node.node_resources.devices
                if ask.matches(*dev.id_tuple())}
    if not matching:
        return None

    # device group -> (allocs using it, instance count per alloc)
    group_use: Dict[Tuple[str, str, str],
                    Tuple[List[Allocation], Dict[str, int]]] = {}
    for a in proposed:
        if a.terminal_status() or a.job is None:
            continue
        for tr in a.allocated_resources.tasks.values():
            for ad in tr.devices:
                key = (ad.vendor, ad.type, ad.name)
                if key not in matching:
                    continue
                allocs, counts = group_use.setdefault(key, ([], {}))
                if a.id not in counts:
                    allocs.append(a)
                counts[a.id] = counts.get(a.id, 0) + len(ad.device_ids)

    needed = int(ask.count) + int(extra_needed)
    options: List[Tuple[List[Allocation], Dict[str, int]]] = []
    for key, (allocs, counts) in group_use.items():
        free = len(acct.free_instances(*key))
        got = {"n": 0}
        picked, enough = take_from_groups(
            job_priority, allocs,
            met=lambda: got["n"] + free >= needed,
            charge=lambda a: got.__setitem__("n", got["n"] + counts[a.id]))
        if enough:
            options.append((picked, counts))
    if not options:
        return None

    # selectBestAllocs: within an option, biggest instance holders
    # first, trimmed at the needed count; lowest net priority wins
    best: Optional[List[Allocation]] = None
    best_prio = float("inf")
    for allocs, counts in options:
        allocs = sorted(allocs, key=lambda a: -counts[a.id])
        picked, prios, got = [], set(), 0
        for a in allocs:
            if got >= needed:
                break
            got += counts[a.id]
            picked.append(a)
            prios.add(a.job.priority)
        net_priority = sum(prios)
        if net_priority < best_prio:
            best_prio = net_priority
            best = picked
    return best


def free_device_instances_by_group(node: Node,
                                   allocs: Sequence[Allocation], ask
                                   ) -> Dict[Tuple[str, str, str],
                                             List[str]]:
    """Free matching instance ids per device GROUP given the current
    allocs — device asks must be satisfied within a single group
    (solve.py _assign_devices), so callers look at the per-group max,
    not a cross-group sum."""
    from ..structs.devices import DeviceAccounter
    acct = DeviceAccounter(node)
    acct.add_allocs(allocs)
    out: Dict[Tuple[str, str, str], List[str]] = {}
    for dev in node.node_resources.devices:
        if ask.matches(*dev.id_tuple()):
            out[dev.id_tuple()] = acct.free_instances(*dev.id_tuple())
    return out


def find_preemption(node: Node, proposed: Sequence[Allocation], job,
                    tg) -> Optional[List[Allocation]]:
    """Full preemption pass for one (node, task group): task-group
    resources first, then network asks, then device asks — each pass
    only runs when the group actually requests that dimension, and later
    passes see earlier victims as already evicted (the reference runs
    the analogous passes inside BinPackIterator as each dimension fails:
    PreemptForTaskGroup :198, PreemptForNetwork :270,
    PreemptForDevice :472)."""
    from ..solver.tensorize import group_resource_vector

    from ..structs import (AllocatedResources, AllocatedTaskResources,
                           NetworkResource)

    vec = group_resource_vector(tg)
    victims = list(pick_victims(node, proposed, job.priority,
                                float(vec[0]), float(vec[1]),
                                float(vec[2]), float(vec[3])) or [])
    victim_ids = {v.id for v in victims}
    remaining = [a for a in proposed if a.id not in victim_ids]

    # The group's OWN earlier asks consume capacity the later passes
    # must see: modelled as a job-less in-flight alloc (counts toward
    # usage, never a victim) that grows as asks are processed.
    pending_nets: List[NetworkResource] = []
    net_asks = list(tg.networks)
    for t in tg.tasks:
        net_asks.extend(t.resources.networks)
    for net in net_asks:
        if not (net.mbits or net.reserved_ports):
            continue
        probe_pool = list(remaining)
        if pending_nets:
            probe_pool.append(Allocation(
                id="_pending", allocated_resources=AllocatedResources(
                    tasks={"_pending": AllocatedTaskResources(
                        networks=list(pending_nets))})))
        nv = preempt_for_network(job.priority, probe_pool, net, node)
        if nv:
            victims.extend(nv)
            victim_ids |= {v.id for v in nv}
            remaining = [a for a in remaining if a.id not in victim_ids]
        pending_nets.append(NetworkResource(
            device=net.device or "", mbits=net.mbits,
            reserved_ports=list(net.reserved_ports)))

    pending_dev = 0        # instances asked so far by this group
    for t in tg.tasks:
        for d in t.resources.devices:
            need = int(d.count) + pending_dev
            free_by_grp = free_device_instances_by_group(
                node, remaining, d)
            if any(len(f) >= need for f in free_by_grp.values()):
                pending_dev += int(d.count)
                continue
            dv = preempt_for_device(job.priority, remaining, d, node,
                                    extra_needed=pending_dev)
            if dv:
                victims.extend(dv)
                victim_ids |= {v.id for v in dv}
                remaining = [a for a in remaining
                             if a.id not in victim_ids]
            pending_dev += int(d.count)
    return victims or None


def preemption_enabled(config, sched_type: str) -> bool:
    if config is None:
        return sched_type == "system"
    return {
        "system": config.preemption_system_enabled,
        "service": config.preemption_service_enabled,
        "batch": config.preemption_batch_enabled,
    }.get(sched_type, False)
