"""Pass 1: FSM determinism.

The raft FSM (StateFSM.apply -> state store mutators) must produce
bit-identical state on every replica from (index, payload, prior
state). Anything nondeterministic inside that call graph — wall-clock
reads, randomness, hash-order iteration feeding writes — silently forks
replicas; and any StateStore mutation reachable from OUTSIDE the apply
path bypasses the raft log entirely (a write that exists on one server
only).

Rules
  FSM101  wall-clock read reachable from the apply path
  FSM102  randomness reachable from the apply path
  FSM103  iteration over an unordered set feeding logic in an
          apply-reachable function (Python set order varies with
          PYTHONHASHSEED across replica processes)
  FSM104  StateStore mutator called from outside the apply path
"""
from __future__ import annotations

import ast
from typing import List, Set

from .core import AnalysisConfig, Finding, PackageIndex, _dotted

WALL_CLOCK = {
    "time.time", "time.time_ns", "time.monotonic", "time.monotonic_ns",
    "time.perf_counter", "time.perf_counter_ns", "time.clock_gettime",
    "datetime.datetime.now", "datetime.datetime.utcnow",
    "datetime.datetime.today", "datetime.date.today", "time.localtime",
    "time.gmtime",
}
RANDOM_EXACT = {"uuid.uuid1", "uuid.uuid4", "os.urandom", "os.getrandom"}
RANDOM_PREFIXES = ("random.", "secrets.", "numpy.random.", "np.random.",
                   "torch.rand", "torch.random.", "torch.manual_seed",
                   "torch.normal", "torch.bernoulli", "torch.multinomial")


def _is_wall_clock(name: str) -> bool:
    return name in WALL_CLOCK


def _is_random(name: str) -> bool:
    return (name in RANDOM_EXACT
            or any(name.startswith(p) for p in RANDOM_PREFIXES))


def _set_producing(node, set_vars: Set[str]) -> bool:
    """Does this expression produce a plain `set` (unordered)?"""
    if isinstance(node, (ast.SetComp, ast.Set)):
        return True
    if isinstance(node, ast.Call):
        d = _dotted(node.func)
        if d in ("set", "frozenset"):
            return True
    if isinstance(node, ast.BinOp) and isinstance(
            node.op, (ast.Sub, ast.BitOr, ast.BitAnd, ast.BitXor)):
        # keys() - keys() and friends are set algebra
        for side in (node.left, node.right):
            if isinstance(side, ast.Call):
                d = _dotted(side.func)
                if d and d.endswith(".keys"):
                    return True
            if _set_producing(side, set_vars):
                return True
    if isinstance(node, ast.Name):
        return node.id in set_vars
    return False


def _sorted_wrapped(node) -> bool:
    if isinstance(node, ast.Call):
        d = _dotted(node.func)
        return d in ("sorted", "list.sort", "min", "max", "sum", "len",
                     "frozenset")
    return False


def run_fsm_pass(index: PackageIndex, cfg: AnalysisConfig
                 ) -> List[Finding]:
    findings: List[Finding] = []
    roots = index.match_funcs(list(cfg.fsm_roots))
    reach = index.reachable(roots)

    # ---- FSM101/102: nondeterministic leaf calls in the apply closure
    for fkey in sorted(reach):
        fi = index.functions[fkey]
        for name, lineno in index.external_calls(fkey):
            if _is_wall_clock(name):
                findings.append(Finding(
                    "FSM101", fi.module, fi.qual, name, fi.path, lineno,
                    f"wall-clock read `{name}` is reachable from the "
                    "raft apply path; replicas applying the same log "
                    "entry would diverge",
                    hint="carry the timestamp in the raft log entry "
                         "payload (stamped by the proposer) and pass "
                         "it down"))
            elif _is_random(name):
                findings.append(Finding(
                    "FSM102", fi.module, fi.qual, name, fi.path, lineno,
                    f"randomness `{name}` is reachable from the raft "
                    "apply path; replicas would diverge",
                    hint="generate ids/choices on the proposer and "
                         "ship them in the log entry payload"))

    # ---- FSM103: unordered-set iteration inside the apply closure
    for fkey in sorted(reach):
        fi = index.functions[fkey]
        set_vars: Set[str] = set()
        # first sweep: locals assigned from set-producing expressions
        for node in index._own_nodes(fi):
            if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                    and isinstance(node.targets[0], ast.Name):
                if _set_producing(node.value, set_vars):
                    set_vars.add(node.targets[0].id)
        for node in index._own_nodes(fi):
            if not isinstance(node, ast.For):
                continue
            it = node.iter
            if _sorted_wrapped(it):
                continue
            if _set_producing(it, set_vars):
                sym = (it.id if isinstance(it, ast.Name)
                       else type(it).__name__)
                findings.append(Finding(
                    "FSM103", fi.module, fi.qual, f"for:{sym}",
                    fi.path, node.lineno,
                    "iteration over an unordered set in an "
                    "apply-reachable function; set order varies with "
                    "PYTHONHASHSEED across replica processes",
                    hint="wrap the iterable in sorted(...) so every "
                         "replica visits elements in the same order"))

    # ---- FSM104: store mutators called from outside the apply path
    store_ck = f"{cfg.store_module}:{cfg.store_class}"
    mutators = _store_mutators(index, store_ck)
    exempt_modules = {cfg.store_module} | {
        r.split(":")[0] for r in cfg.fsm_roots}
    for fkey, fi in sorted(index.functions.items()):
        if fkey in reach or fi.module in exempt_modules:
            continue
        if not (index.callees(fkey) & mutators):
            continue
        la = index._local_imports(fi)
        lt = index._local_var_types(fi)
        for node in index._own_nodes(fi):
            if not isinstance(node, ast.Call):
                continue
            r = index.resolve_call(fi, node, la, lt)
            if r in mutators:
                mname = r.split(":")[1]
                findings.append(Finding(
                    "FSM104", fi.module, fi.qual, mname, fi.path,
                    node.lineno,
                    f"StateStore mutator `{mname}` is called outside "
                    "the raft apply path; the write never enters the "
                    "log and exists on this server only",
                    hint="propose a raft entry and let the FSM apply "
                         "it, or baseline with a justification if "
                         "this component is deliberately raft-free"))
    return findings


_MUTATING_METHODS = {"pop", "clear", "setdefault", "update", "append",
                     "add", "discard", "insert", "remove", "extend"}


def _store_mutators(index: PackageIndex, store_ck: str) -> Set[str]:
    """StateStore methods that write replicated state: any method that
    subscript-stores into self._t, deletes from it, or calls a
    write-barrier helper (self._bump*)."""
    out: Set[str] = set()
    ci = index.classes.get(store_ck)
    if ci is None:
        return out
    for mname, fkey in ci.methods.items():
        fi = index.functions[fkey]
        writes = False
        for node in index._own_nodes(fi):
            if isinstance(node, (ast.Assign, ast.AugAssign, ast.Delete)):
                targets = (node.targets if isinstance(node, ast.Assign)
                           else [node.target] if isinstance(
                               node, ast.AugAssign) else node.targets)
                for t in targets:
                    if _writes_self_table(t):
                        writes = True
            if isinstance(node, ast.Call):
                d = _dotted(node.func)
                if d and d.startswith("self._bump"):
                    writes = True
                if isinstance(node.func, ast.Attribute) and \
                        node.func.attr in _MUTATING_METHODS:
                    base = node.func.value
                    while isinstance(base, ast.Subscript):
                        base = base.value
                    bd = _dotted(base)
                    if bd == "self._t":
                        writes = True
        if writes:
            out.add(fkey)
    # transitive closure within the class: a method calling a mutator
    # is a mutator
    changed = True
    while changed:
        changed = False
        for mname, fkey in ci.methods.items():
            if fkey in out:
                continue
            if index.callees(fkey) & out:
                out.add(fkey)
                changed = True
    return out


def _writes_self_table(target) -> bool:
    """Matches self._t[...] = / self._t[...][k] = style stores."""
    node = target
    while isinstance(node, ast.Subscript):
        node = node.value
    d = _dotted(node)
    return bool(d and (d == "self._t" or d.startswith("self._t.")))
