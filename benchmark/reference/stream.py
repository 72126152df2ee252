"""The plain reference of the resident stream, from the seeded data.

A pass is a list of batches (the merged chunks, then the retry drains).
For each batch the reference builds the solve's planes itself from the
plain cluster and job specs, starts from the resident usage plus every
placement the program committed in the pass's earlier batches, solves
with `solver.solve` and sets its answer beside the program's.  Nothing
here imports the port.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

from . import solver

MERGED_GP_MAX = 16
MERGED_W_CAP = 1024
WIDE_W_CAP = 256


def merge_rows(specs: Sequence) -> List[Tuple[object, int]]:
    """The chunk's ask rows: groups with one spec collapse into one row
    with the summed count, in first-seen order (the stream's merge)."""
    rows: Dict[tuple, list] = {}
    for spec in specs:
        for g in spec.groups:
            key = (tuple(g.ask), g.count, g.name,
                   tuple(map(tuple, spec.constraints)),
                   tuple(map(tuple, spec.affinities)),
                   tuple(map(tuple, spec.spreads)))
            if key in rows:
                rows[key][1] += g.count
            else:
                rows[key] = [g, g.count]
    return [(g, c) for g, c in rows.values()]


def group_count_hint(counts: Sequence[int], gp: int) -> int:
    """The stream's wave-window hint: the largest row count rounded up
    to a power of two, at least 64, at most half the window cap."""
    m = max(max(counts), 1)
    cap = (MERGED_W_CAP if gp <= MERGED_GP_MAX else WIDE_W_CAP) // 2
    return min(1 << max(6, (m - 1).bit_length()), cap)


def pad_nodes(n: int) -> int:
    """The solve's node axis: a power of two (at least 8) up to 4,096
    nodes, a multiple of 1,024 above; the padding rows are not nodes."""
    if n <= 4096:
        return 1 << max(3, (max(n, 1) - 1).bit_length())
    return -(-n // 1024) * 1024


def ask_rows(rows):
    """(ask_res [G, R], p_ask [K]) of a batch's rows, placements of a
    row contiguous in row order."""
    return (np.stack([g.ask for g, _ in rows]).astype(np.float32),
            np.repeat(np.arange(len(rows)), [c for _, c in rows]))


def planes(cap: np.ndarray, used: np.ndarray, rows) -> Dict:
    """Planes of one batch with no constraint, affinity or spread (the
    stream configurations' jobs): every real node feasible."""
    n_real, R = cap.shape
    n = pad_nodes(n_real)
    G = len(rows)
    ask_res, p_ask = ask_rows(rows)

    def rows_of(x):
        out = np.zeros((n, R), np.float32)
        out[:n_real] = x
        return out

    valid = np.zeros(n, bool)
    valid[:n_real] = True
    return {
        "avail": rows_of(cap),
        "reserved": np.zeros((n, R), np.float32),
        "used0": rows_of(used),
        "valid": valid,
        "node_dc": np.zeros(n, np.int64),
        "attr_rank": np.zeros((n, 1), np.int64),
        "ask_res": ask_res,
        "ask_desired": np.array([max(g.count, 1) for g, _ in rows],
                                np.float32),
        "distinct": np.full(G, -1, np.int64),
        "dc_ok": np.ones((G, 1), bool),
        "host_ok": np.ones((G, n), bool),
        "coll0": np.zeros((G, n), np.float32),
        "penalty": np.zeros((G, n), bool),
        "c_op": np.zeros((G, 1), np.int64),
        "c_col": np.zeros((G, 1), np.int64),
        "c_rank": np.zeros((G, 1), np.int64),
        "a_op": np.zeros((G, 1), np.int64),
        "a_col": np.zeros((G, 1), np.int64),
        "a_rank": np.zeros((G, 1), np.int64),
        "a_weight": np.zeros((G, 1), np.float32),
        "a_host": np.zeros((G, n), np.float32),
        "sp_col": np.full((G, 1), -1, np.int64),
        "sp_weight": np.zeros((G, 1), np.float32),
        "sp_targeted": np.zeros((G, 1), bool),
        "sp_desired": np.zeros((G, 1, 1), np.float32),
        "sp_implicit": np.zeros((G, 1), np.float32),
        "sp_used0": np.zeros((G, 1, 1), np.float32),
        "dev_cap": np.zeros((n, 1), np.float32),
        "dev_used0": np.zeros((n, 1), np.float32),
        "dev_ask": np.zeros((G, 1), np.float32),
        "p_ask": p_ask,
    }


def follow_pass(cap: np.ndarray, resident: np.ndarray, batches: List[Dict],
                max_waves: int, precision: str = "f32",
                own: bool = False) -> List[Dict]:
    """Solve each batch of a pass as the reference, each from the
    resident usage plus the program's commits in the earlier batches
    (with `own`, plus its own commits: the control's full pass).

    A batch is {"rows": [(group, count)], "seed": int, "choice": [K]
    node positions (the program's, in the cluster's order),
    "status": [K]}.  Returns per batch the reference's choice, status
    and wave count."""
    used = resident.astype(np.float64).copy()
    out = []
    for b in batches:
        rows = b["rows"]
        counts = [c for _, c in rows]
        p = planes(cap, used, rows)
        res = solver.solve(p, sum(counts), b["seed"], has_spread=False,
                           group_count_hint=group_count_hint(
                               counts, len(rows)),
                           max_waves=max_waves, precision=precision)
        out.append({"choice": res.choice, "status": res.status,
                    "waves": res.waves})
        src = out[-1] if own else b
        add_commits(used, src["choice"], src["status"], p["ask_res"],
                    p["p_ask"])
    return out


def add_commits(used: np.ndarray, choice, status, ask_res, p_ask) -> None:
    """Charge each committed placement's ask to its node."""
    k = np.nonzero(np.asarray(status) == solver.STATUS_COMMITTED)[0]
    np.add.at(used, np.asarray(choice)[k],
              np.asarray(ask_res, np.float64)[np.asarray(p_ask)[k]])
