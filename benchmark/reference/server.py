"""The plain reference of the server path, from the seeded data.

Three parts, none of which imports the port:

* `store_errors`: what the store committed, against the configuration's
  guarantees: each live alloc charged at its group's plain ask on top of
  the residents (no node over its capacity), each placement on a node
  its job's constraints and datacenters allow, each eval done and each
  job placed in full or its remainder in a blocked eval, each stopped
  job left with nothing running.
* `plane_errors`: the start of a sampled solve.  The solve runs from the
  program's own state (the world's carried usage at the moment of the
  round), so the reference follows it from there; what it can check on
  its own it checks here: each node row's capacity, each ask row's
  resources, the feasibility, affinity and spread planes against the
  plain node attributes, and the carried usage against the residents
  and the capacity.
* `resolve`: the sampled solve again with `solver.solve`.
"""
from __future__ import annotations

from typing import Dict, Iterable, Tuple

import numpy as np

from . import solver

#: the wave budget of a solve while the serving tier is in brownout
#: (the port's default)
BROWNOUT_MAX_WAVES = 6


def node_attr(node, target: str):
    """The plain node's value for an interpolated target, or None."""
    return {"${attr.rack}": node.rack, "${attr.zone}": node.zone,
            "${node.datacenter}": node.datacenter,
            "${attr.kernel.name}": "linux"}.get(target)


def holds(op: str, l, r) -> bool:
    """A constraint on one node (Nomad's operators; lexical order)."""
    if l is None:
        return False
    if op in ("=", "==", "is"):
        return l == r
    if op in ("!=", "not"):
        return l != r
    if op in ("<", "<=", ">", ">="):
        return {"<": l < r, "<=": l <= r, ">": l > r, ">=": l >= r}[op]
    raise ValueError(f"operator {op!r} is not in the reference")


def feasible(spec, node) -> bool:
    if node.datacenter not in spec.datacenters:
        return False
    return all(holds(op, node_attr(node, l), r)
               for l, op, r in spec.constraints)


def affine(spec, node) -> bool:
    return any(holds(op, node_attr(node, l), r)
               for l, op, r, _ in spec.affinities)


def store_errors(cl, spec, store) -> Iterable[Tuple[str, int]]:
    nodes = {n.id: n for n in cl.nodes}
    cap = {n.id: n.cap for n in cl.nodes}
    used = {n.id: cl.resident_ask * k
            for n, k in zip(cl.nodes, cl.resident_per_node)}
    group = {g.name: g for g in spec.groups}
    violations = 0
    per_job: Dict[str, int] = {}
    live_jobs = set()
    for a in store["allocs"]:
        node = nodes.get(a["node"])
        if node is None or not feasible(spec, node):
            violations += 1
            continue
        per_job[a["job"]] = per_job.get(a["job"], 0) + 1
        if a["desired"] == "run":
            used[a["node"]] = used[a["node"]] + group[a["group"]].ask
            live_jobs.add(a["job"])
    over = sum(1 for nid, u in used.items() if (u > cap[nid]).any())
    want = sum(g.count for g in spec.groups)
    errors = len(store["errors"])
    for r in store["records"]:
        e = store["evals"].get(r["eval"])
        if e is None or e["status"] != "complete" or not r["done"]:
            errors += 1
            continue
        if r["kind"] == "register":
            placed = store["placed_by_eval"].get(r["eval"], 0)
            if placed > want or (placed < want and not e["blocked"]):
                errors += 1
        elif r["job"] in live_jobs:
            errors += 1
    errors += sum(1 for n in per_job.values() if n > want)
    yield "oversubscribed_nodes", over
    yield "constraint_violations", violations
    yield "eval_errors", errors


def plane_errors(cl, spec, sv) -> int:
    """Rows and cells of a captured solve's planes that disagree with
    the plain data."""
    p = sv["planes"]
    pos = {n.id: k for k, n in enumerate(cl.nodes)}
    ids = sv["node_ids"]
    n_real = len(ids)
    try:
        order = np.array([pos[i] for i in ids])
    except KeyError:
        return n_real
    nodes = [cl.nodes[k] for k in order]
    cap = cl.capacity()[order]
    resident = cl.resident_usage()[order]
    R = cap.shape[1]
    errs = int((~p["valid"][:n_real]).sum() + p["valid"][n_real:].sum())
    errs += int((p["avail"][:n_real, :R] != cap).any(axis=1).sum())
    errs += int((p["reserved"][:n_real] != 0).any(axis=1).sum())
    used0 = p["used0"][:n_real, :R]
    errs += int(((used0 < resident) | (used0 > cap)).any(axis=1).sum())
    groups = {g.name: g for g in spec.groups}
    feas, aff, vnode, _ = solver.static_program(p)
    counts = np.bincount(np.asarray(p["p_ask"][:sv["n_place"]]),
                         minlength=sv["n_asks"])
    want_feas = np.array([feasible(spec, nd) for nd in nodes])
    want_aff = np.array([affine(spec, nd) for nd in nodes])
    for g, (_job, name, count) in enumerate(sv["asks"]):
        grp = groups.get(name)
        if grp is None or (p["ask_res"][g, :R] != grp.ask).any() \
                or counts[g] != count or count > grp.count:
            errs += 1
        errs += int((feas[g, :n_real] != want_feas).sum())
        errs += int(((aff[g, :n_real] != 0) != want_aff).sum())
        for s, (attr, _w) in enumerate(spec.spreads):
            vals: Dict[str, set] = {}
            for nd, v in zip(nodes, vnode[s, g, :n_real]):
                vals.setdefault(node_attr(nd, attr), set()).add(int(v))
            seen = [v for vs in vals.values() for v in vs]
            errs += (len(seen) - len(vals)) + (len(seen) - len(set(seen)))
            errs += sum(1 for v in seen if v < 0)
    return errs


def resolve(sv, max_waves: int, precision: str = "f32") -> solver.Result:
    """The captured solve again, from its own starting planes."""
    p = sv["planes"]
    has_spread = bool((p["sp_col"][:, 0] >= 0).any())
    res = solver.solve(p, sv["n_place"], 0, has_spread=has_spread,
                       max_waves=max_waves, precision=precision)
    n = sv["n_place"]
    return res._replace(choice=res.choice[:n], ok=res.ok[:n],
                        score=res.score[:n], status=res.status[:n])
