"""The plain reference of the resident stream for jobs with constraints,
affinities and spreads, from the seeded data.

As `stream.follow_pass`, a pass is a list of batches (the merged chunks,
then the retry drains), and each batch is solved with `solver.solve`
from the resident usage plus every placement the program committed in
the pass's earlier batches.  Here the planes are built from the plain
nodes and the plain job spec by these rules, the semantics the port
states for its stream (`ResidentSolver`), written down without it:

* Attribute columns: one for each target that a constraint, an
  affinity or a spread of the job reads, in that order of first use.  A
  node's value of a target is `server.node_attr`; a node without it
  holds -1.  Values are ranked in lexical order over the column's
  universe, the nodes' values and the operands compared with it, so an
  ordered operator on ranks is Nomad's lexical comparison
  (scheduler/feasible.go checkLexicalOrder) and `!=` holds where the
  attribute is missing.
* Feasibility: a real node whose datacenter the job lists (or `*`) and
  which every constraint of the job allows.
* Affinity: each matched affinity adds its weight over the sum of the
  absolute weights of the job's affinities.
* Spread: each spread's weight over the sum of the job's spread
  weights; with no targets the spread is even over the values of its
  attribute, which a node without the attribute does not hold.  The
  value tables are as wide as the attribute's values rounded up to a
  power of two (at least 2).  A fresh job has no placement yet, so
  every row starts with no spread usage.
* Anti-affinity's desired count is the group's `count` in the job spec.

Departure from Nomad: the stream's throughput mode merges a chunk's
identical asks (every job of one spec and no per-eval state) into one
row a group whose count is their sum.  Spread and anti-affinity are
then scored over the chunk's merged population of a group, not per job
as Nomad's spread iterator scores them, while the hard quotas stay
exact per row.  A batch's rows are the program's merged rows, which
the judge maps back to the plain groups by name; each row starts, as a
fresh job would, with no spread usage, and so does each row of a drain.

Nothing here imports the port.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

from . import solver, stream
from .server import feasible, node_attr

#: Nomad's operators as the solve's operator codes
OPS = {"=": solver.OP_EQ, "==": solver.OP_EQ, "is": solver.OP_EQ,
       "!=": solver.OP_NE, "not": solver.OP_NE, "<": solver.OP_LT,
       "<=": solver.OP_LE, ">": solver.OP_GT, ">=": solver.OP_GE}


def pow2(n: int, floor: int) -> int:
    p = floor
    while p < n:
        p *= 2
    return p


class NodeSide:
    """The planes of the node axis that one job's program reads: the
    rank-interned attribute columns and the datacenter ids."""

    def __init__(self, nodes: Sequence, spec):
        targets: List[str] = []
        for t in ([c[0] for c in spec.constraints]
                  + [a[0] for a in spec.affinities]
                  + [s[0] for s in spec.spreads]):
            if t not in targets:
                targets.append(t)
        self.col = {t: i for i, t in enumerate(targets)}
        n_real = len(nodes)
        self.n = stream.pad_nodes(n_real)
        A = max(len(targets), 1)
        self.rank: List[Dict[str, int]] = []
        self.attr_rank = np.full((self.n, A), -1, np.int64)
        for col, t in enumerate(targets):
            vals = [node_attr(nd, t) for nd in nodes]
            universe = {v for v in vals if v is not None}
            universe |= {c[2] for c in spec.constraints if c[0] == t}
            universe |= {a[2] for a in spec.affinities if a[0] == t}
            rank = {v: r for r, v in enumerate(sorted(universe))}
            self.rank.append(rank)
            for i, v in enumerate(vals):
                if v is not None:
                    self.attr_rank[i, col] = rank[v]
        self.dcs = sorted({nd.datacenter for nd in nodes})
        dc_id = {d: k for k, d in enumerate(self.dcs)}
        self.node_dc = np.zeros(self.n, np.int64)
        self.node_dc[:n_real] = [dc_id[nd.datacenter] for nd in nodes]

    def values(self, target: str) -> int:
        return len(self.rank[self.col[target]])


def job_planes(ns: NodeSide, spec, G: int) -> Dict:
    """The job's program rows, alike for each of its G rows (a merged
    chunk holds one job spec)."""
    cons, affs, sps = spec.constraints, spec.affinities, spec.spreads
    C = max(len(cons), 1)
    c_op = np.zeros((G, C), np.int64)
    c_col = np.zeros((G, C), np.int64)
    c_rank = np.zeros((G, C), np.int64)
    for k, (t, op, r) in enumerate(cons):
        c_op[:, k] = OPS[op]
        c_col[:, k] = ns.col[t]
        c_rank[:, k] = ns.rank[ns.col[t]][r]
    CA = max(len(affs), 1)
    a_op = np.zeros((G, CA), np.int64)
    a_col = np.zeros((G, CA), np.int64)
    a_rank = np.zeros((G, CA), np.int64)
    a_weight = np.zeros((G, CA), np.float32)
    total = sum(abs(a[3]) for a in affs)
    for k, (t, op, r, w) in enumerate(affs):
        a_op[:, k] = OPS[op]
        a_col[:, k] = ns.col[t]
        a_rank[:, k] = ns.rank[ns.col[t]][r]
        a_weight[:, k] = w / total if total else 0.0
    S = max(len(sps), 1)
    V = pow2(max((ns.values(t) for t, _ in sps), default=1), floor=2)
    sp_col = np.full((G, S), -1, np.int64)
    sp_weight = np.zeros((G, S), np.float32)
    sum_w = sum(w for _, w in sps)
    for s, (t, w) in enumerate(sps):
        sp_col[:, s] = ns.col[t]
        sp_weight[:, s] = w / sum_w if sum_w else 0.0
    dc_ok = np.array([d in spec.datacenters or "*" in spec.datacenters
                      for d in ns.dcs])
    return {
        "dc_ok": np.broadcast_to(dc_ok, (G, len(ns.dcs))),
        "c_op": c_op, "c_col": c_col, "c_rank": c_rank,
        "a_op": a_op, "a_col": a_col, "a_rank": a_rank,
        "a_weight": a_weight,
        "sp_col": sp_col, "sp_weight": sp_weight,
        "sp_targeted": np.zeros((G, S), bool),
        "sp_desired": np.full((G, S, V), -1.0, np.float32),
        "sp_implicit": np.full((G, S), -1.0, np.float32),
        "sp_used0": np.zeros((G, S, V), np.float32),
    }


def planes(ns: NodeSide, spec, cap: np.ndarray, used: np.ndarray,
           rows) -> Dict:
    """Planes of one batch of the job `spec` from the usage `used`."""
    p = stream.planes(cap, used, rows)
    p.update(job_planes(ns, spec, len(rows)))
    p["attr_rank"] = ns.attr_rank
    p["node_dc"] = ns.node_dc
    return p


def follow_pass(nodes: Sequence, spec, cap: np.ndarray,
                resident: np.ndarray, batches: List[Dict], max_waves: int,
                precision: str = "f32", own: bool = False) -> List[Dict]:
    """`stream.follow_pass` for the job `spec` on the plain `nodes` (in
    the cluster's order): each batch from the resident usage plus the
    program's commits in the earlier batches (with `own`, plus its own
    commits: the control's full pass)."""
    ns = NodeSide(nodes, spec)
    used = resident.astype(np.float64).copy()
    out = []
    for b in batches:
        rows = b["rows"]
        counts = [c for _, c in rows]
        p = planes(ns, spec, cap, used, rows)
        res = solver.solve(p, sum(counts), b["seed"],
                           has_spread=bool(spec.spreads),
                           group_count_hint=stream.group_count_hint(
                               counts, len(rows)),
                           max_waves=max_waves, precision=precision)
        out.append({"choice": res.choice, "status": res.status,
                    "waves": res.waves})
        src = out[-1] if own else b
        stream.add_commits(used, src["choice"], src["status"],
                           p["ask_res"], p["p_ask"])
    return out


def violations(nodes: Sequence, spec, batches: List[Dict]) -> int:
    """Committed placements on a node the plain job forbids (its
    datacenters and constraints)."""
    allowed = np.array([feasible(spec, nd) for nd in nodes])
    bad = 0
    for b in batches:
        k = np.asarray(b["status"]) == solver.STATUS_COMMITTED
        bad += int((~allowed[np.asarray(b["choice"])[k]]).sum())
    return bad
