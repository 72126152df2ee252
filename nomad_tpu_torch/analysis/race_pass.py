"""Pass 9: interprocedural lockset race detection (Eraser-style).

Go's upstream Nomad keeps its concurrent server plane honest with
`go test -race`; Python has no race sanitizer, so this pass is ours.
Where the syntactic LOCK pass checks one function at a time, this pass
computes, per call site, the set of locks *statically held* — tracking
`with self._lock:` regions and acquire()/release() pairs through
`_locked`-convention helpers and arbitrary call depth via a fixpoint
over the package call graph — then runs guarded-by inference over
every shared attribute reachable from two or more thread roots.

Machinery
  * canonical lock ids: `Class.attr` for instance locks (Condition
    objects wrapping a lock — `threading.Condition(self._lock)` —
    collapse onto the wrapped lock's id so `with self._cv:` counts as
    holding `self._lock`), `module:name` for module-level locks;
  * entry-lockset fixpoint: thread roots and public entry points pin
    to the empty set, `*_locked` helpers pin to their class's main
    lock (the convention IS the contract), everything else starts at ⊤
    and intersects `held_at(call site) ∪ entry(caller)` over all known
    callers until stable;
  * thread roots: `threading.Thread(target=...)` / `threading.Timer`
    targets, executor `.submit`/`.map` first arguments that resolve
    into the package, and `run()` of `threading.Thread` subclasses;
    one synthetic "external" root covers the public API surface of
    thread-shared classes (any client thread may call in);
  * guarded-by inference: for each shared `self.attr` of an in-scope
    thread-shared class, intersect held-lock sets over its WRITES
    (unguarded reads stay LOCK302's domain).

Rules
  RACE901  shared attribute written with an empty guard intersection
           across ≥2 thread roots (error)
  RACE902  inconsistent guard: every write is locked, but no common
           lock exists — the sharded-broker hazard class (error)
  RACE903  check-then-act: a guarded read is released before the
           dependent guarded write re-acquires the same lock (warn)
  LOCK305  blocking call (device solve, fsync, RPC, Future.result /
           Event.wait, blocking queue.get, thread join) reached while
           a hot-path lock is held (error)

Known limits (documented in STATIC_ANALYSIS.md): lock identity is
attr-name-based (two instances of a class share one static id — right
for per-shard discipline, blind to instance aliasing); LOCK305 is not
fully transitive (the entry fixpoint carries context into callees, and
call sites into known-blocking callees are checked, but a blocking op
two resolution failures away is missed); guarded-by inference is
writes-only and skips `__init__` (construction happens-before
publication).
"""
from __future__ import annotations

import ast
from typing import Dict, FrozenSet, List, Optional, Set, Tuple

from .core import (AnalysisConfig, Finding, FuncInfo, PackageIndex,
                   _dotted)
from .lock_pass import (LOCK_FACTORIES, _end, _module_locks,
                        _self_attr_write, _thread_shared_classes)

# attrs assigned one of these hold synchronization primitives, not
# shared data — they are excluded from guarded-by inference
SYNC_FACTORIES = LOCK_FACTORIES + (
    "threading.Event", "threading.Barrier", "queue.Queue",
    "queue.SimpleQueue", "queue.LifoQueue", "queue.PriorityQueue",
)

# container-method calls that mutate the receiver in place:
# `self.pending.append(x)` is a WRITE to self.pending.  "set" is
# deliberately absent (Event.set() would drown the signal).
MUTATORS = frozenset({
    "append", "extend", "insert", "add", "update", "setdefault",
    "pop", "popleft", "popitem", "remove", "discard", "clear",
})

# external calls that block by contract
BLOCKING_EXTERNALS = frozenset({
    "time.sleep", "os.fsync", "os.fdatasync", "select.select",
    "socket.create_connection", "subprocess.run",
    "subprocess.check_call", "subprocess.check_output",
    "subprocess.Popen",
})

# method names that block: Future.result, Event/Condition.wait,
# Thread.join, socket recv/accept.  `.join` needs the timeout-shaped
# argument check below to stay clear of str.join.
BLOCKING_METHODS = frozenset({"result", "wait", "join", "recv",
                              "accept"})

_EXTERNAL_ROOT = "external"


def _in_scope(module: str, cfg: AnalysisConfig) -> bool:
    return any(module == p or module.startswith(p + ".")
               for p in cfg.race_module_prefixes)


class _Facts:
    """Per-function lock facts: with-region spans, explicit
    acquire/release events, resolved internal call sites."""
    __slots__ = ("spans", "events", "calls")

    def __init__(self):
        self.spans: List[Tuple[int, int, str]] = []   # (a, b, lock id)
        self.events: List[Tuple[int, str, int]] = []  # (line, id, ±1)
        self.calls: List[Tuple[int, str]] = []        # (line, fkey)


class _Engine:
    def __init__(self, index: PackageIndex, cfg: AnalysisConfig):
        self.index = index
        self.cfg = cfg
        self._facts_cache: Dict[str, _Facts] = {}
        self._held_cache: Dict[Tuple[str, int], FrozenSet[str]] = {}
        self._locks_cache: Dict[str, Dict[str, str]] = {}
        self._sync_cache: Dict[str, Dict[str, str]] = {}
        self._ltypes_cache: Dict[str, Dict[str, str]] = {}
        self._modlocks_cache: Dict[str, Set[str]] = {}
        self.entry: Dict[str, Optional[FrozenSet[str]]] = {}
        self.rootsets: Dict[str, Set[str]] = {}
        # (class key, attr) -> inferred guard (non-empty write
        # intersection); the lockdep runtime witness cross-checks this
        self.guards: Dict[Tuple[str, str], FrozenSet[str]] = {}

    # ------------------------------------------------ lock identities
    def _sync_attrs(self, ck: str) -> Dict[str, str]:
        """self attrs assigned a sync primitive (class + package
        bases): attr -> full factory name."""
        cached = self._sync_cache.get(ck)
        if cached is not None:
            return cached
        out: Dict[str, str] = {}
        stack, seen = [ck], set()
        while stack:
            c = stack.pop()
            if c in seen or c not in self.index.classes:
                continue
            seen.add(c)
            ci = self.index.classes[c]
            mi = self.index.modules[ci.module]
            for fkey in ci.methods.values():
                fi = self.index.functions[fkey]
                for node in self.index._own_nodes(fi):
                    if not (isinstance(node, ast.Assign)
                            and isinstance(node.value, ast.Call)):
                        continue
                    d = _dotted(node.value.func)
                    if not d:
                        continue
                    head = d.split(".")[0]
                    full = (mi.aliases.get(head) or head) + d[len(head):]
                    if full not in SYNC_FACTORIES:
                        continue
                    for t in node.targets:
                        if isinstance(t, ast.Attribute) and isinstance(
                                t.value, ast.Name) \
                                and t.value.id == "self":
                            out.setdefault(t.attr, full)
            stack.extend(ci.bases)
        self._sync_cache[ck] = out
        return out

    def _class_locks(self, ck: str) -> Dict[str, str]:
        """attr -> canonical lock id ("Class.rep") for lock-ish attrs,
        Condition-wraps-lock alias groups collapsed onto the wrapped
        attr so `with self._cv:` and `with self._lock:` unify."""
        cached = self._locks_cache.get(ck)
        if cached is not None:
            return cached
        out: Dict[str, str] = {}
        if ck not in self.index.classes:
            self._locks_cache[ck] = out
            return out
        cname = self.index.classes[ck].name
        own: Set[str] = set()
        alias: Dict[str, str] = {}
        stack, seen = [ck], set()
        while stack:
            c = stack.pop()
            if c in seen or c not in self.index.classes:
                continue
            seen.add(c)
            ci = self.index.classes[c]
            mi = self.index.modules[ci.module]
            for fkey in ci.methods.values():
                fi = self.index.functions[fkey]
                for node in self.index._own_nodes(fi):
                    if not (isinstance(node, ast.Assign)
                            and isinstance(node.value, ast.Call)):
                        continue
                    d = _dotted(node.value.func)
                    if not d:
                        continue
                    head = d.split(".")[0]
                    full = (mi.aliases.get(head) or head) + d[len(head):]
                    if full not in LOCK_FACTORIES:
                        continue
                    for t in node.targets:
                        if not (isinstance(t, ast.Attribute)
                                and isinstance(t.value, ast.Name)
                                and t.value.id == "self"):
                            continue
                        if full == "threading.Condition" \
                                and node.value.args:
                            ad = _dotted(node.value.args[0])
                            if ad and ad.startswith("self."):
                                alias.setdefault(t.attr, ad[5:])
                                continue
                        own.add(t.attr)
            stack.extend(ci.bases)
        for a in own:
            out[a] = f"{cname}.{a}"
        for a, tgt in alias.items():
            rep, hops = tgt, 0
            while rep in alias and hops < 5:
                rep, hops = alias[rep], hops + 1
            out[a] = f"{cname}.{rep}" if rep in own else f"{cname}.{a}"
        self._locks_cache[ck] = out
        return out

    def _mod_locks(self, module: str) -> Set[str]:
        cached = self._modlocks_cache.get(module)
        if cached is None:
            cached = _module_locks(self.index, module)
            self._modlocks_cache[module] = cached
        return cached

    # -------------------------------------------------- local typing
    def _ltypes(self, fi: FuncInfo) -> Dict[str, str]:
        """core's local var types, extended with shard-element and
        self-attr hops: `sh = self._shards[i]`, `for sh in
        self._shards:`, `st = self._store`."""
        cached = self._ltypes_cache.get(fi.key)
        if cached is not None:
            return cached
        lt = dict(self.index._local_var_types(fi))
        ci = self.index.class_of_func(fi)
        if ci is not None:
            for node in self.index._own_nodes(fi):
                tgt = val = None
                elem_only = False
                if isinstance(node, ast.Assign) \
                        and len(node.targets) == 1 \
                        and isinstance(node.targets[0], ast.Name):
                    tgt, val = node.targets[0].id, node.value
                elif isinstance(node, ast.For):
                    it = node.iter
                    # for sh in self._shards: / enumerate(self._shards)
                    if isinstance(it, ast.Call) and isinstance(
                            it.func, ast.Name) \
                            and it.func.id == "enumerate" and it.args:
                        it = it.args[0]
                        if isinstance(node.target, ast.Tuple) and len(
                                node.target.elts) == 2 and isinstance(
                                node.target.elts[1], ast.Name):
                            tgt = node.target.elts[1].id
                    elif isinstance(node.target, ast.Name):
                        tgt = node.target.id
                    val, elem_only = it, True
                if tgt is None or val is None:
                    continue
                t = None
                if isinstance(val, ast.Subscript):
                    base = val.value
                    if isinstance(base, ast.Attribute) and isinstance(
                            base.value, ast.Name) \
                            and base.value.id == "self":
                        t = self._elem_type(ci.key, base.attr)
                elif isinstance(val, ast.Attribute) and isinstance(
                        val.value, ast.Name) and val.value.id == "self":
                    t = (self._elem_type(ci.key, val.attr) if elem_only
                         else self.index._attr_type(ci, val.attr))
                if t:
                    lt.setdefault(tgt, t)
        self._ltypes_cache[fi.key] = lt
        return lt

    def _elem_type(self, ck: str, attr: str) -> Optional[str]:
        stack, seen = [ck], set()
        while stack:
            c = stack.pop()
            if c in seen or c not in self.index.classes:
                continue
            seen.add(c)
            ci = self.index.classes[c]
            if attr in ci.attr_elem_types:
                return ci.attr_elem_types[attr]
            stack.extend(ci.bases)
        return None

    # ----------------------------------------------- lock resolution
    def _lock_id_of_expr(self, fi: FuncInfo, node) -> Optional[str]:
        """Canonical lock id of an expression used as a lock (with-
        item, acquire receiver), or None."""
        ci = self.index.class_of_func(fi)
        # self.cont[i].X — the per-shard form _dotted can't render
        if isinstance(node, ast.Attribute) and isinstance(
                node.value, ast.Subscript):
            base = node.value.value
            if isinstance(base, ast.Attribute) and isinstance(
                    base.value, ast.Name) and base.value.id == "self" \
                    and ci is not None:
                ek = self._elem_type(ci.key, base.attr)
                if ek:
                    return self._class_locks(ek).get(node.attr)
            return None
        d = _dotted(node)
        if d is None:
            return None
        parts = d.split(".")
        if parts[0] == "self" and ci is not None:
            if len(parts) == 2:
                return self._class_locks(ci.key).get(parts[1])
            if len(parts) == 3:
                t = self.index._attr_type(ci, parts[1])
                if t:
                    return self._class_locks(t).get(parts[2])
            return None
        if len(parts) == 1:
            if d in self._mod_locks(fi.module):
                return f"{fi.module}:{d}"
            return None
        if len(parts) == 2:
            lt = self._ltypes(fi)
            if parts[0] in lt:
                return self._class_locks(lt[parts[0]]).get(parts[1])
        return None

    # ------------------------------------------------ per-func facts
    def _facts(self, fkey: str) -> _Facts:
        cached = self._facts_cache.get(fkey)
        if cached is not None:
            return cached
        fi = self.index.functions[fkey]
        la = self.index._local_imports(fi)
        lt = self._ltypes(fi)
        f = _Facts()
        for node in self.index._own_nodes(fi):
            if isinstance(node, ast.With):
                for item in node.items:
                    lid = self._lock_id_of_expr(fi, item.context_expr)
                    if lid:
                        f.spans.append((node.lineno, _end(node), lid))
            elif isinstance(node, ast.Call):
                fn = node.func
                if isinstance(fn, ast.Attribute) \
                        and fn.attr in ("acquire", "release"):
                    lid = self._lock_id_of_expr(fi, fn.value)
                    if lid:
                        f.events.append(
                            (node.lineno, lid,
                             1 if fn.attr == "acquire" else -1))
                r = self.index.resolve_call(fi, node, la, lt)
                if r:
                    f.calls.append((node.lineno, r))
        f.events.sort()
        f.calls.sort()
        self._facts_cache[fkey] = f
        return f

    def _held_at(self, fkey: str, line: int) -> FrozenSet[str]:
        cached = self._held_cache.get((fkey, line))
        if cached is not None:
            return cached
        f = self._facts(fkey)
        held = {lid for (a, b, lid) in f.spans if a <= line <= b}
        bal: Dict[str, int] = {}
        for (ln, lid, d) in f.events:
            if ln < line:
                bal[lid] = bal.get(lid, 0) + d
        held.update(lid for lid, n in bal.items() if n > 0)
        out = frozenset(held)
        self._held_cache[(fkey, line)] = out
        return out

    # ------------------------------------------------- thread roots
    def _resolve_ref(self, fi: FuncInfo, node) -> Optional[str]:
        """Function key a non-call reference resolves to (thread
        targets, executor submissions)."""
        ci = self.index.class_of_func(fi)
        mi = self.index.modules[fi.module]
        if isinstance(node, ast.Name):
            cur: Optional[FuncInfo] = fi
            while cur is not None:
                for nk in cur.nested:
                    if self.index.functions[nk].name == node.id:
                        return nk
                cur = (self.index.functions.get(cur.parent)
                       if cur.parent else None)
            r = self.index._resolve_symbol(mi, node.id)
            if r:
                return self.index._callable_target(r)
            la = self.index._local_imports(fi)
            if node.id in la and la[node.id].startswith(
                    self.index.package):
                r = self.index._resolve_dotted_abs(la[node.id])
                if r:
                    return self.index._callable_target(r)
            return None
        if isinstance(node, ast.Attribute):
            d = _dotted(node)
            if not d:
                return None
            parts = d.split(".")
            if parts[0] == "self" and ci is not None:
                if len(parts) == 2:
                    return self.index.method_on(ci.key, parts[1])
                if len(parts) == 3:
                    t = self.index._attr_type(ci, parts[1])
                    if t:
                        return self.index.method_on(t, parts[2])
                return None
            if len(parts) == 2:
                lt = self._ltypes(fi)
                if parts[0] in lt:
                    return self.index.method_on(lt[parts[0]], parts[1])
        return None

    def _thread_roots(self) -> Set[str]:
        roots: Set[str] = set()
        for fkey, fi in self.index.functions.items():
            mi = self.index.modules[fi.module]
            la = self.index._local_imports(fi)
            for node in self.index._own_nodes(fi):
                if not isinstance(node, ast.Call):
                    continue
                d = _dotted(node.func)
                full = None
                if d:
                    head = d.split(".")[0]
                    tgt = la.get(head) or mi.aliases.get(head)
                    if tgt:
                        full = tgt + d[len(head):]
                if full == "threading.Thread":
                    for kw in node.keywords:
                        if kw.arg == "target":
                            r = self._resolve_ref(fi, kw.value)
                            if r:
                                roots.add(r)
                elif full == "threading.Timer":
                    texpr = None
                    for kw in node.keywords:
                        if kw.arg == "function":
                            texpr = kw.value
                    if texpr is None and len(node.args) >= 2:
                        texpr = node.args[1]
                    if texpr is not None:
                        r = self._resolve_ref(fi, texpr)
                        if r:
                            roots.add(r)
                elif isinstance(node.func, ast.Attribute) \
                        and node.func.attr in ("submit", "map") \
                        and node.args:
                    r = self._resolve_ref(fi, node.args[0])
                    if r:
                        roots.add(r)
        # run() of threading.Thread subclasses starts as its own thread
        for ck, ci in self.index.classes.items():
            mi = self.index.modules[ci.module]
            for b in ci.node.bases:
                bd = _dotted(b)
                if not bd:
                    continue
                head = bd.split(".")[0]
                full = (mi.aliases.get(head) or head) + bd[len(head):]
                if full == "threading.Thread" and "run" in ci.methods:
                    roots.add(ci.methods["run"])
        return roots

    def _compute_rootsets(self, roots: Set[str],
                          scope_shared: Set[str]) -> None:
        rs: Dict[str, Set[str]] = {}
        for rk in sorted(roots):
            for f in self.index.reachable({rk}):
                rs.setdefault(f, set()).add(rk)
        # the synthetic external root: any client thread may enter a
        # thread-shared class through its public surface
        ext: List[str] = []
        for ck in sorted(scope_shared):
            ci = self.index.classes[ck]
            for mname, fkey in ci.methods.items():
                if mname.startswith("_") or fkey in roots:
                    continue
                ext.append(fkey)
        for f in self.index.reachable(ext):
            rs.setdefault(f, set()).add(_EXTERNAL_ROOT)
        self.rootsets = rs

    # ------------------------------------------- entry-set fixpoint
    def _pin(self, fkey: str, fi: FuncInfo,
             roots: Set[str]) -> Optional[FrozenSet[str]]:
        if fkey in roots:
            return frozenset()
        name = fi.name
        if name.endswith("_locked"):
            # the suffix IS the contract: the caller holds the class's
            # main lock.  Prefer `_lock`, else every class lock (a
            # multi-lock class using the convention holds them all or
            # names its helpers more precisely).
            ci = self.index.class_of_func(fi)
            if ci is not None:
                locks = self._class_locks(ci.key)
                if locks:
                    main = locks.get("_lock")
                    if main:
                        return frozenset({main})
                    return frozenset(set(locks.values()))
            return frozenset()
        if not name.startswith("_"):
            # public entry: callable lock-free from anywhere
            return frozenset()
        return None

    def _compute_entries(self, roots: Set[str]) -> None:
        callers: Dict[str, List[Tuple[str, int]]] = {}
        for fkey in self.index.functions:
            for (line, callee) in self._facts(fkey).calls:
                callers.setdefault(callee, []).append((fkey, line))
        entry: Dict[str, Optional[FrozenSet[str]]] = {}
        pinned: Set[str] = set()
        for fkey, fi in self.index.functions.items():
            p = self._pin(fkey, fi, roots)
            entry[fkey] = p
            if p is not None:
                pinned.add(fkey)
        for _ in range(64):
            changed = False
            for callee, sites in callers.items():
                if callee in pinned or callee not in entry:
                    continue
                acc: Optional[FrozenSet[str]] = None
                for (ck, line) in sites:
                    ce = entry.get(ck)
                    if ce is None:
                        continue          # ⊤ caller: no information
                    s = self._held_at(ck, line) | ce
                    acc = s if acc is None else (acc & s)
                if acc is not None and acc != entry[callee]:
                    entry[callee] = acc
                    changed = True
            if not changed:
                break
        self.entry = entry

    # ---------------------------------------------- access analysis
    def _mutator_write(self, node) -> Optional[Tuple[str, int]]:
        if isinstance(node, ast.Call) and isinstance(
                node.func, ast.Attribute) \
                and node.func.attr in MUTATORS:
            base = node.func.value
            while isinstance(base, ast.Subscript):
                base = base.value
            if isinstance(base, ast.Attribute) and isinstance(
                    base.value, ast.Name) and base.value.id == "self":
                return base.attr, node.lineno
        return None

    def _collect_accesses(self, scope_shared: Set[str]) -> Dict[
            Tuple[str, str],
            List[Tuple[str, int, bool, Optional[FrozenSet[str]]]]]:
        """(class key, attr) -> [(fkey, line, is_write, lockset)].
        lockset None means the method's entry context is unknown (⊤:
        never called from a resolved site) — excluded from inference.
        """
        acc: Dict[Tuple[str, str],
                  List[Tuple[str, int, bool,
                             Optional[FrozenSet[str]]]]] = {}
        for ck in sorted(scope_shared):
            ci = self.index.classes[ck]
            sync = set(self._sync_attrs(ck))
            for mname, fkey in sorted(ci.methods.items()):
                if mname == "__init__":
                    continue
                if not self.rootsets.get(fkey):
                    continue
                fi = self.index.functions[fkey]
                ent = self.entry.get(fkey)
                for node in self.index._own_nodes(fi):
                    pairs: List[Tuple[str, int, bool]] = []
                    w = _self_attr_write(node)
                    if w:
                        pairs.append((w[0], w[1], True))
                    mw = self._mutator_write(node)
                    if mw:
                        pairs.append((mw[0], mw[1], True))
                    if isinstance(node, ast.Attribute) and isinstance(
                            node.ctx, ast.Load) and isinstance(
                            node.value, ast.Name) \
                            and node.value.id == "self":
                        pairs.append((node.attr, node.lineno, False))
                    for (attr, line, isw) in pairs:
                        if attr in sync:
                            continue
                        if self.index.method_on(ck, attr):
                            continue     # bound-method ref, not data
                        ls = (None if ent is None
                              else self._held_at(fkey, line) | ent)
                        acc.setdefault((ck, attr), []).append(
                            (fkey, line, isw, ls))
        return acc

    # ------------------------------------------------------- rules
    def run(self, prior=()) -> List[Finding]:
        findings: List[Finding] = []
        roots = self._thread_roots()
        self._compute_entries(roots)
        shared = _thread_shared_classes(self.index)
        scope_shared = {
            ck for ck in shared
            if ck in self.index.classes
            and _in_scope(self.index.classes[ck].module, self.cfg)}
        self._compute_rootsets(roots, scope_shared)
        accesses = self._collect_accesses(scope_shared)
        findings += self._guard_inference(accesses, prior)
        findings += self._check_then_act(accesses)
        findings += self._blocking_under_lock(scope_shared, roots)
        return findings

    def _guard_inference(self, accesses, prior) -> List[Finding]:
        findings: List[Finding] = []
        prior301 = {(f.module, f.func.split(".")[0], f.symbol)
                    for f in prior if f.rule == "LOCK301"}
        for (ck, attr), accs in sorted(accesses.items()):
            ci = self.index.classes[ck]
            roots_here: Set[str] = set()
            for (fkey, _line, _w, _ls) in accs:
                roots_here |= self.rootsets.get(fkey, set())
            if len(roots_here) < 2:
                continue
            writes = [(fk, ln, ls) for (fk, ln, w, ls) in accs
                      if w and ls is not None]
            if not writes:
                continue
            inter: Optional[FrozenSet[str]] = None
            for (_fk, _ln, ls) in writes:
                inter = ls if inter is None else (inter & ls)
            if inter:
                self.guards[(ck, attr)] = inter
                continue
            unguarded = sorted(
                (ln, fk) for (fk, ln, ls) in writes if not ls)
            if unguarded:
                if (ci.module, ci.name, attr) in prior301:
                    continue            # LOCK301 already owns this one
                line, fk = unguarded[0]
                fi = self.index.functions[fk]
                findings.append(Finding(
                    "RACE901", ci.module, fi.qual, attr, ci.path, line,
                    f"shared `self.{attr}` of {ci.name} is written "
                    "with no lock held; its accesses are reachable "
                    f"from {len(roots_here)} thread roots and the "
                    "guard intersection over writes is empty",
                    hint="guard every write with the owning lock, or "
                         "baseline with the happens-before argument "
                         "that makes the write safe"))
            else:
                locks_seen = sorted(
                    {lid for (_fk, _ln, ls) in writes for lid in ls})
                line, fk = min((ln, fk) for (fk, ln, _ls) in writes)
                fi = self.index.functions[fk]
                findings.append(Finding(
                    "RACE902", ci.module, fi.qual, attr, ci.path, line,
                    f"`self.{attr}` of {ci.name} is guarded "
                    "inconsistently: every write holds a lock but no "
                    "common one exists "
                    f"({', '.join(locks_seen)})",
                    hint="pick ONE lock to own the attribute; "
                         "inconsistent guards protect nothing"))
        return findings

    def _check_then_act(self, accesses) -> List[Finding]:
        """RACE903: within one method (directly, or through a same-
        class callee), a read of a multi-root attribute under lock L in
        one region and a dependent write under L in a LATER, disjoint
        region — the lock was dropped between check and act."""
        findings: List[Finding] = []
        # multi-root attrs with at least one write
        multi: Dict[Tuple[str, str], List] = {}
        writers: Dict[Tuple[str, str],
                      List[Tuple[str, FrozenSet[str]]]] = {}
        for (ck, attr), accs in accesses.items():
            roots_here: Set[str] = set()
            for (fk, _ln, _w, _ls) in accs:
                roots_here |= self.rootsets.get(fk, set())
            if len(roots_here) < 2 or not any(w for (_f, _l, w, _s)
                                              in accs):
                continue
            multi[(ck, attr)] = accs
            for (fk, _ln, w, ls) in accs:
                if w and ls:
                    writers.setdefault((ck, attr), []).append((fk, ls))
        done: Set[Tuple[str, str]] = set()
        for (ck, attr), accs in sorted(multi.items()):
            ci = self.index.classes[ck]
            by_func: Dict[str, List[Tuple[int, bool]]] = {}
            for (fk, ln, w, _ls) in accs:
                by_func.setdefault(fk, []).append((ln, w))
            for fk in sorted(by_func):
                if (fk, attr) in done:
                    continue
                fi = self.index.functions[fk]
                spans = self._facts(fk).spans
                reads = [(ln, a, b, lid) for (ln, w) in by_func[fk]
                         if not w
                         for (a, b, lid) in spans if a <= ln <= b]
                if not reads:
                    continue
                hit = self._ctamatch(ck, attr, fk, by_func[fk], reads,
                                     spans, writers)
                if hit is not None:
                    line, desc = hit
                    findings.append(Finding(
                        "RACE903", ci.module, fi.qual, attr, fi.path,
                        line,
                        f"check-then-act on `self.{attr}`: {desc} — "
                        "the state checked can change while the lock "
                        "is dropped",
                        hint="restructure so the check and the act "
                             "share one lock hold (a `*_locked` "
                             "helper keeps the pass informed)"))
                    done.add((fk, attr))
        return findings

    def _ctamatch(self, ck, attr, fk, accs, reads, spans, writers):
        # (a) direct: read under L in span S1, write under the same L
        # in a later disjoint span S2 of the same method
        for (rln, ra, rb, rlid) in reads:
            for (wln, w) in accs:
                if not w or wln <= rb:
                    continue
                for (wa, wb, wlid) in spans:
                    if wlid == rlid and wa <= wln <= wb and wa > rb:
                        return (wln,
                                f"read under {rlid} (line {rln}), "
                                f"lock released, write re-acquires it "
                                f"(line {wln})")
        # (b) call-mediated: read under L, then a later call made with
        # L NOT held into a same-class method that writes attr under L
        fi = self.index.functions[fk]
        ent = self.entry.get(fk) or frozenset()
        class_meths = set(self.index.classes[ck].methods.values())
        for (rln, ra, rb, rlid) in reads:
            for (cln, callee) in self._facts(fk).calls:
                if cln <= rb or callee == fk:
                    continue
                if callee not in class_meths:
                    continue
                if rlid in (self._held_at(fk, cln) | ent):
                    continue             # still held: no window
                for (wfk, wls) in writers.get((ck, attr), ()):
                    if wfk == callee and rlid in wls:
                        cq = self.index.functions[callee].qual
                        return (cln,
                                f"read under {rlid} (line {rln}), "
                                f"then `{cq}` re-acquires it for the "
                                f"dependent write (call at line {cln})")
        return None

    # --------------------------------------------- LOCK305 blocking
    def _direct_blocking(self) -> Dict[str, List[Tuple[int, str,
                                                       Optional[str]]]]:
        """fkey -> [(line, symbol, receiver lock id or None)] for ops
        that block by contract, regardless of lock state."""
        out: Dict[str, List[Tuple[int, str, Optional[str]]]] = {}
        for fkey, fi in self.index.functions.items():
            ops: List[Tuple[int, str, Optional[str]]] = []
            for (name, line) in self.index.external_calls(fkey):
                if name in BLOCKING_EXTERNALS:
                    ops.append((line, name, None))
            mi = self.index.modules[fi.module]
            la = self.index._local_imports(fi)
            ci = self.index.class_of_func(fi)
            qattrs = {a for a, fac in
                      (self._sync_attrs(ci.key) if ci else {}).items()
                      if fac.startswith("queue.")}
            for node in self.index._own_nodes(fi):
                if not (isinstance(node, ast.Call) and isinstance(
                        node.func, ast.Attribute)):
                    continue
                meth = node.func.attr
                recv = node.func.value
                d = _dotted(recv)
                if meth in BLOCKING_METHODS:
                    if d is None:
                        continue        # literal receiver: str.join etc
                    head = d.split(".")[0]
                    tgt = la.get(head) or mi.aliases.get(head)
                    if tgt and not tgt.startswith(self.index.package):
                        continue        # os.path.join, shutil.move...
                    if meth == "join" and not _timeout_shaped(node):
                        continue        # separator.join(parts)
                    lid = self._lock_id_of_expr(fi, recv)
                    ops.append((line_of(node), f"{d}.{meth}",
                                lid if meth == "wait" else None))
                elif meth == "get" and d and d.startswith("self.") \
                        and d[5:] in qattrs:
                    if any(kw.arg == "block" and isinstance(
                            kw.value, ast.Constant)
                            and kw.value.value is False
                            for kw in node.keywords):
                        continue
                    ops.append((line_of(node), f"{d}.get", None))
            if ops:
                out[fkey] = sorted(ops)
        return out

    def _blocking_under_lock(self, scope_shared: Set[str],
                             roots: Set[str]) -> List[Finding]:
        findings: List[Finding] = []
        hot: Set[str] = set()
        for ck in scope_shared:
            hot |= set(self._class_locks(ck).values())
        for mod in self.index.modules:
            if _in_scope(mod, self.cfg):
                hot |= {f"{mod}:{n}" for n in self._mod_locks(mod)}
        direct = self._direct_blocking()
        blocking = set(direct) | set(
            self.index.match_funcs(list(self.cfg.blocking_roots)))
        seen: Set[Tuple[str, str]] = set()
        for fkey, fi in sorted(self.index.functions.items()):
            if not _in_scope(fi.module, self.cfg):
                continue
            ent = self.entry.get(fkey) or frozenset()
            for (line, symbol, recv_lock) in direct.get(fkey, ()):
                held = self._held_at(fkey, line) | ent
                hh = held & hot
                if recv_lock:
                    # Condition.wait releases its OWN lock while parked
                    hh = hh - {recv_lock}
                if not hh:
                    continue
                key = (fkey, symbol)
                if key in seen:
                    continue
                seen.add(key)
                findings.append(self._b305(fi, line, symbol, hh))
            for (line, callee) in self._facts(fkey).calls:
                if callee == fkey or callee not in blocking:
                    continue
                held = self._held_at(fkey, line) | ent
                hh = (held & hot) - (self.entry.get(callee)
                                     or frozenset())
                if not hh:
                    continue            # the callee's own frame reports
                sym = self.index.functions[callee].qual
                key = (fkey, sym)
                if key in seen:
                    continue
                seen.add(key)
                findings.append(self._b305(fi, line, sym, hh,
                                           via_call=True))
        return findings

    def _b305(self, fi: FuncInfo, line: int, symbol: str,
              held: Set[str], via_call: bool = False) -> Finding:
        what = ("call into blocking" if via_call else "blocking call")
        return Finding(
            "LOCK305", fi.module, fi.qual, symbol, fi.path, line,
            f"{what} `{symbol}` while holding "
            f"{', '.join(sorted(held))}; a hot-path lock held across "
            "a solve/fsync/RPC/wait stalls every thread contending it",
            hint="move the blocking op outside the critical section "
                 "(snapshot under the lock, block after release), or "
                 "baseline with the durability/ordering argument that "
                 "requires it")


def _timeout_shaped(call: ast.Call) -> bool:
    """`t.join()` / `t.join(5.0)` / `t.join(timeout=...)` — excludes
    the one-iterable str.join form."""
    if any(kw.arg == "timeout" for kw in call.keywords):
        return True
    if not call.args:
        return not call.keywords
    if len(call.args) == 1:
        a = call.args[0]
        if isinstance(a, ast.Constant) and isinstance(
                a.value, (int, float)):
            return True
        if isinstance(a, ast.Name) and a.id in ("timeout", "deadline",
                                                "remain", "wait_s"):
            return True
    return False


def line_of(node) -> int:
    return getattr(node, "lineno", 0)


def run_race_pass(index: PackageIndex, cfg: AnalysisConfig,
                  prior=()) -> List[Finding]:
    return _Engine(index, cfg).run(prior)


def infer_guards(index: PackageIndex, cfg: AnalysisConfig
                 ) -> Dict[Tuple[str, str], FrozenSet[str]]:
    """Static guarded-by map for the lockdep runtime witness:
    (class key, attr) -> the non-empty lock-id intersection over all
    writes.  `utils.lockdep` cross-checks recorded runtime held-sets
    against this: static says guarded ⇒ the storm never saw an
    unguarded access."""
    eng = _Engine(index, cfg)
    eng.run(())
    return dict(eng.guards)
