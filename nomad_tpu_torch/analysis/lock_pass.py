"""Pass 3: lock discipline over the threaded server plane.

The server plane (RPC server, eval broker, plan applier, heartbeat,
drainer, raft node) shares per-class state across thread entry points.
Convention enforced here: a class that owns a lock guards ALL its
shared-attribute writes with it; helpers that rely on the caller
already holding the lock say so with a `_locked` name suffix; module
globals mutated at runtime are guarded by a module-level lock.

Rules
  LOCK301  self-attribute write outside the class lock in a
           lock-owning thread-shared class
  LOCK302  racy getter: a lockless method whose body just returns a
           lock-guarded attribute
  LOCK303  module-global mutated from function scope without a
           module-level lock held
  LOCK304  lock-ordering cycle (nested acquisitions in inconsistent
           order)

"Thread-shared" is a fixpoint over composition: a class that
starts threads/timers is shared, and so is every class reachable from a
shared class through constructor attribute types — controller state
objects (EWMA solve models, token buckets, admission counters) held by
the broker/worker/server are mutated from many threads even though they
never start one themselves, so they carry the same write discipline.
"""
from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set, Tuple

from .core import (AnalysisConfig, ClassInfo, Finding, PackageIndex,
                   _dotted, with_lock_names)

LOCK_FACTORIES = ("threading.Lock", "threading.RLock",
                  "threading.Condition", "threading.Semaphore",
                  "threading.BoundedSemaphore")


def _lock_attrs(index: PackageIndex, ci: ClassInfo) -> Set[str]:
    """self attrs assigned a threading.Lock/RLock/Condition anywhere in
    the class (usually __init__), plus the same on package bases."""
    out: Set[str] = set()
    stack = [ci.key]
    seen: Set[str] = set()
    while stack:
        ck = stack.pop()
        if ck in seen or ck not in index.classes:
            continue
        seen.add(ck)
        c = index.classes[ck]
        mi = index.modules[c.module]
        for fkey in c.methods.values():
            fi = index.functions[fkey]
            for node in index._own_nodes(fi):
                if not isinstance(node, ast.Assign):
                    continue
                if not isinstance(node.value, ast.Call):
                    continue
                d = _dotted(node.value.func)
                if not d:
                    continue
                head = d.split(".")[0]
                full = (mi.aliases.get(head) or head) + d[len(head):]
                if full in LOCK_FACTORIES:
                    for t in node.targets:
                        if isinstance(t, ast.Attribute) and isinstance(
                                t.value, ast.Name) and t.value.id == "self":
                            out.add(t.attr)
        stack.extend(c.bases)
    return out


def _is_multithreaded(index: PackageIndex, ci: ClassInfo) -> bool:
    """Does the class start threads/timers, or are its methods used as
    thread targets anywhere in the package?"""
    for fkey in ci.methods.values():
        fi = index.functions[fkey]
        for name, _ in index.external_calls(fkey):
            if name in ("threading.Thread", "threading.Timer"):
                return True
    return False


def _thread_shared_classes(index: PackageIndex) -> Set[str]:
    """Thread-starting classes plus the fixpoint of everything they
    hold by composition (constructor attr types): an instance hung off
    a threaded class is reached from its threads, so its state carries
    the same lock discipline whether or not it starts threads itself."""
    shared: Set[str] = {ck for ck, ci in index.classes.items()
                        if _is_multithreaded(index, ci)}
    changed = True
    while changed:
        changed = False
        for ck in sorted(shared):
            ci = index.classes.get(ck)
            if ci is None:
                continue
            # composition edges: scalar attrs AND list-of-instances
            # containers (a shard hung off a threaded broker is reached
            # from every dequeue thread)
            for tkey in list(ci.attr_types.values()) \
                    + list(ci.attr_elem_types.values()):
                if tkey in index.classes and tkey not in shared:
                    shared.add(tkey)
                    changed = True
    return shared


def _locked_regions(fi, lock_attrs: Set[str]):
    """Line spans covered by `with self.<lock>:` in this function."""
    spans = []
    for node in ast.walk(fi.node):
        if not isinstance(node, ast.With):
            continue
        for name in with_lock_names(node):
            if name.startswith("self.") and name[5:] in lock_attrs:
                spans.append((node.lineno, _end(node)))
    return spans


def _end(node) -> int:
    return getattr(node, "end_lineno", node.lineno) or node.lineno


def _in_spans(line: int, spans) -> bool:
    return any(a <= line <= b for a, b in spans)


def _in_scope(module: str, cfg: AnalysisConfig) -> bool:
    return any(module == p or module.startswith(p + ".")
               for p in cfg.lock_module_prefixes)


def run_lock_pass(index: PackageIndex, cfg: AnalysisConfig
                  ) -> List[Finding]:
    findings: List[Finding] = []
    lock_owners: Dict[str, Set[str]] = {}
    for ck, ci in index.classes.items():
        attrs = _lock_attrs(index, ci)
        if attrs:
            lock_owners[ck] = attrs

    # ---- LOCK301: unlocked self-attr writes in thread-shared lock
    # owners (started threads OR reached by composition from one)
    thread_shared = _thread_shared_classes(index)
    for ck, locks in sorted(lock_owners.items()):
        ci = index.classes[ck]
        if not _in_scope(ci.module, cfg):
            continue
        if ck not in thread_shared:
            continue
        guarded = _guarded_attrs(index, ci, locks)
        for mname, fkey in sorted(ci.methods.items()):
            if mname == "__init__" or mname.endswith("_locked"):
                continue
            fi = index.functions[fkey]
            spans = _locked_regions(fi, locks)
            for node in index._own_nodes(fi):
                tgt = _self_attr_write(node)
                if tgt is None:
                    continue
                attr, line = tgt
                if attr in locks:
                    continue
                if _in_spans(line, spans):
                    continue
                findings.append(Finding(
                    "LOCK301", ci.module, f"{ci.name}.{mname}", attr,
                    ci.path, line,
                    f"`self.{attr}` is written outside "
                    f"{_lock_label(locks)} in multithreaded class "
                    f"{ci.name}",
                    hint="move the write under the lock, or rename "
                         "the method with a `_locked` suffix if the "
                         "caller is documented to hold it"))
            _ = guarded  # (used by LOCK302 below; kept for symmetry)

    # ---- LOCK301 (sharded containers): a write that reaches
    # an ELEMENT of a lock-owning class through a subscripted container
    # (`self._shards[i].attr = v`) must hold the element's OWN lock —
    # the owning class's lock (if any) does not guard shard state
    for ck in sorted(thread_shared):
        ci = index.classes.get(ck)
        if ci is None or not _in_scope(ci.module, cfg):
            continue
        for cont, elem_key in sorted(ci.attr_elem_types.items()):
            elem_locks = lock_owners.get(elem_key)
            if not elem_locks:
                continue
            elem_name = index.classes[elem_key].name
            for mname, fkey in sorted(ci.methods.items()):
                if mname == "__init__" or mname.endswith("_locked"):
                    continue
                fi = index.functions[fkey]
                spans = _elem_locked_regions(fi, cont, elem_locks)
                for node in index._own_nodes(fi):
                    w = _subscript_attr_write(node)
                    if w is None:
                        continue
                    wcont, attr, line = w
                    if wcont != cont or attr in elem_locks:
                        continue
                    if _in_spans(line, spans):
                        continue
                    findings.append(Finding(
                        "LOCK301", ci.module, f"{ci.name}.{mname}",
                        f"{cont}[].{attr}", ci.path, line,
                        f"`self.{cont}[...].{attr}` is written without "
                        f"the owning {elem_name} shard's "
                        f"{_lock_label(elem_locks)}; per-shard state "
                        "must be guarded by the element's own lock",
                        hint="wrap the write in `with "
                             f"self.{cont}[i].{sorted(elem_locks)[0]}:`"
                             " or route it through a shard method that "
                             "takes its lock"))

    # ---- LOCK302: racy getters
    for ck, locks in sorted(lock_owners.items()):
        ci = index.classes[ck]
        if not _in_scope(ci.module, cfg):
            continue
        guarded = _guarded_attrs(index, ci, locks)
        for mname, fkey in sorted(ci.methods.items()):
            if mname == "__init__" or mname.endswith("_locked"):
                continue
            fi = index.functions[fkey]
            if _locked_regions(fi, locks):
                continue
            body = [n for n in fi.node.body
                    if not isinstance(n, ast.Expr)
                    or not isinstance(n.value, ast.Constant)]
            if len(body) != 1 or not isinstance(body[0], ast.Return):
                continue
            ret = body[0].value
            attr = None
            for sub in ast.walk(ret) if ret is not None else ():
                if isinstance(sub, ast.Attribute) and isinstance(
                        sub.value, ast.Name) and sub.value.id == "self":
                    attr = sub.attr
                    break
            if attr and attr in guarded and attr not in locks:
                findings.append(Finding(
                    "LOCK302", ci.module, f"{ci.name}.{mname}", attr,
                    ci.path, body[0].lineno,
                    f"lockless getter returns `self.{attr}`, which is "
                    f"written under {_lock_label(locks)} elsewhere; "
                    "readers can observe torn/stale state",
                    hint="take the lock for the read (cheap, and makes "
                         "the memory-visibility contract explicit)"))

    # ---- LOCK303: module-global mutation without a module lock
    for fkey, fi in sorted(index.functions.items()):
        mi = index.modules[fi.module]
        if not _in_scope(fi.module, cfg):
            continue
        module_locks = _module_locks(index, fi.module)
        spans = _module_lock_spans(fi, module_locks)
        gdecl = {n for node in index._own_nodes(fi)
                 if isinstance(node, ast.Global) for n in node.names}
        for node in index._own_nodes(fi):
            name, line = _global_write(node, mi.globals, gdecl) \
                or (None, 0)
            if name is None:
                continue
            if _in_spans(line, spans):
                continue
            findings.append(Finding(
                "LOCK303", fi.module, fi.qual, name, fi.path, line,
                f"module global `{name}` is mutated from function "
                "scope without a module-level lock; concurrent "
                "callers race the write",
                hint="guard with a module-level threading.Lock "
                     "(double-checked if the write is a cache fill)"))

    # ---- LOCK304: lock-ordering cycles (syntactic nesting)
    edges: Dict[Tuple[str, str], Tuple[str, int]] = {}
    for fkey, fi in sorted(index.functions.items()):
        if not _in_scope(fi.module, cfg):
            continue
        ci = index.class_of_func(fi)
        locks = lock_owners.get(ci.key) if ci else None
        if not locks:
            continue
        _collect_nesting(fi, ci, locks, edges)
    findings.extend(_report_cycles(index, edges))
    return findings


def _lock_label(locks: Set[str]) -> str:
    return " / ".join(f"self.{a}" for a in sorted(locks))


def _self_attr_write(node) -> Optional[Tuple[str, int]]:
    """(attr, line) when the node writes self.<attr> or a container
    reached through it (self.attr[...] = ...)."""
    targets = []
    if isinstance(node, ast.Assign):
        targets = node.targets
    elif isinstance(node, ast.AugAssign):
        targets = [node.target]
    elif isinstance(node, ast.Delete):
        targets = node.targets
    for t in targets:
        base = t
        while isinstance(base, ast.Subscript):
            base = base.value
        if isinstance(base, ast.Attribute) and isinstance(
                base.value, ast.Name) and base.value.id == "self":
            return base.attr, node.lineno
    return None


def _subscript_attr_write(node) -> Optional[Tuple[str, str, int]]:
    """(container_attr, leaf_attr, line) for writes of the shape
    `self.<cont>[...].<attr> = v` (one subscript hop off self)."""
    targets = []
    if isinstance(node, ast.Assign):
        targets = node.targets
    elif isinstance(node, ast.AugAssign):
        targets = [node.target]
    elif isinstance(node, ast.Delete):
        targets = node.targets
    for t in targets:
        leaf = t
        while isinstance(leaf, ast.Subscript):
            leaf = leaf.value
        if not isinstance(leaf, ast.Attribute):
            continue
        sub = leaf.value
        if not isinstance(sub, ast.Subscript):
            continue
        base = sub.value
        if isinstance(base, ast.Attribute) and isinstance(
                base.value, ast.Name) and base.value.id == "self":
            return base.attr, leaf.attr, node.lineno
    return None


def _elem_locked_regions(fi, cont: str, elem_locks: Set[str]):
    """Line spans covered by `with self.<cont>[...].<lock>:` — the
    subscripted form with_lock_names can't render (its _dotted walker
    stops at a Subscript)."""
    spans = []
    for node in ast.walk(fi.node):
        if not isinstance(node, ast.With):
            continue
        for item in node.items:
            ce = item.context_expr
            if not (isinstance(ce, ast.Attribute)
                    and ce.attr in elem_locks
                    and isinstance(ce.value, ast.Subscript)):
                continue
            base = ce.value.value
            if isinstance(base, ast.Attribute) and isinstance(
                    base.value, ast.Name) and base.value.id == "self" \
                    and base.attr == cont:
                spans.append((node.lineno, _end(node)))
    return spans


def _guarded_attrs(index: PackageIndex, ci: ClassInfo,
                   locks: Set[str]) -> Set[str]:
    """Attrs written under the class lock outside __init__ (i.e. state
    the class treats as lock-protected)."""
    out: Set[str] = set()
    for mname, fkey in ci.methods.items():
        if mname == "__init__":
            continue
        fi = index.functions[fkey]
        spans = _locked_regions(fi, locks)
        if not spans:
            continue
        for node in index._own_nodes(fi):
            w = _self_attr_write(node)
            if w and w[0] not in locks and _in_spans(w[1], spans):
                out.add(w[0])
    return out


def _module_locks(index: PackageIndex, module: str) -> Set[str]:
    """Module-level names assigned a threading.Lock()."""
    mi = index.modules[module]
    out: Set[str] = set()
    for node in mi.tree.body:
        if isinstance(node, ast.Assign) and isinstance(
                node.value, ast.Call):
            d = _dotted(node.value.func)
            if not d:
                continue
            head = d.split(".")[0]
            full = (mi.aliases.get(head) or head) + d[len(head):]
            if full in LOCK_FACTORIES:
                for t in node.targets:
                    if isinstance(t, ast.Name):
                        out.add(t.id)
    return out


def _module_lock_spans(fi, module_locks: Set[str]):
    spans = []
    for node in ast.walk(fi.node):
        if isinstance(node, ast.With):
            for name in with_lock_names(node):
                if name in module_locks:
                    spans.append((node.lineno, _end(node)))
    return spans


def _global_write(node, module_globals: Set[str],
                  global_decls: Set[str]
                  ) -> Optional[Tuple[str, int]]:
    targets = []
    if isinstance(node, ast.Assign):
        targets = node.targets
    elif isinstance(node, ast.AugAssign):
        targets = [node.target]
    for t in targets:
        base = t
        while isinstance(base, ast.Subscript):
            base = base.value
        if not isinstance(base, ast.Name):
            continue
        # container mutation through subscript reaches the shared
        # module object directly; a plain NAME rebinding only does so
        # under a `global` declaration (else it creates a local)
        if base is not t and base.id in module_globals:
            return base.id, node.lineno
        if base is t and base.id in global_decls:
            return base.id, node.lineno
    return None


def _collect_nesting(fi, ci, locks: Set[str],
                     edges: Dict[Tuple[str, str], Tuple[str, int]]
                     ) -> None:
    """Record (outer, inner) pairs for nested with-lock acquisitions."""
    def walk(node, held: List[str]):
        if isinstance(node, ast.With):
            acquired = [f"{ci.name}.{n[5:]}" for n in
                        with_lock_names(node)
                        if n.startswith("self.") and n[5:] in locks]
            for outer in held:
                for inner in acquired:
                    if outer != inner:
                        edges.setdefault((outer, inner),
                                         (fi.path, node.lineno))
            held = held + acquired
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef,
                                  ast.AsyncFunctionDef)):
                continue
            walk(child, held)

    walk(fi.node, [])


def _report_cycles(index: PackageIndex, edges) -> List[Finding]:
    graph: Dict[str, Set[str]] = {}
    for (a, b) in edges:
        graph.setdefault(a, set()).add(b)
    findings: List[Finding] = []
    seen_cycles: Set[Tuple[str, ...]] = set()
    for start in sorted(graph):
        stack = [(start, [start])]
        while stack:
            cur, path = stack.pop()
            for nxt in sorted(graph.get(cur, ())):
                if nxt == start and len(path) > 1:
                    cyc = tuple(sorted(path))
                    if cyc in seen_cycles:
                        continue
                    seen_cycles.add(cyc)
                    where, line = edges[(cur, start)]
                    findings.append(Finding(
                        "LOCK304", "-", "-",
                        "->".join(path + [start]), where, line,
                        "lock-ordering cycle: "
                        + " -> ".join(path + [start])
                        + "; two threads taking these locks in "
                          "opposite order deadlock",
                        hint="impose a single acquisition order (or "
                             "collapse to one lock)"))
                elif nxt not in path:
                    stack.append((nxt, path + [nxt]))
    return findings
