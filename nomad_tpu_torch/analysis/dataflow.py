"""Dataflow layer for nomadlint v2.

The v1 passes are pure AST pattern matches over a call graph; every
bug class we have actually shipped and later caught by hand — the
zero-copy `device_put` aliasing double-charge, the GSPMD double-applied
scatter on a NamedSharding-sharded operand, the donated-carry
read-after-dispatch — is a *dataflow* property: where a buffer came
from, whether a copy intervened, which call killed it. This module
adds exactly that layer, still pure `ast` (nothing analyzed is ever
imported):

  * per-function linear def-use scanning with buffer-identity
    provenance: a `BufferValue` tracks the identity sources of a value
    (parameters, `self` attributes), whether it crossed `device_put`,
    whether a NamedSharding was pinned, and whether a genuine copy
    (`np.array`, `.copy()`, fresh allocation) intervened —
    `np.asarray`/`ascontiguousarray` and dtype casts are
    identity-PRESERVING and propagate provenance unchanged;
  * interprocedural summaries (fixpoint with a recursion guard):
    return-value provenance (`_put_node`-style hooks advertise
    "returns a device buffer, copied, sharded"), transitive donation
    positions (a wrapper passing its parameter into a donated slot
    donates that parameter too, to any depth), and scatter positions
    (a parameter that flows into an `x.at[...].set/add` scatter);
  * class-level buffer facts with subclass-bound dispatch: methods are
    analyzed against the *concrete* class so an inherited
    `_put_node_side` picks up the subclass's `_put_node` override —
    this is what lets SHARD401 distinguish `ResidentSolver` (plain
    device buffers, plain jit scatter: fine) from a subclass that pins
    NamedSharding but forgets to reroute its delta scatters (the GSPMD
    double-apply).

The three v2 passes (shard_pass, alias_pass, score_pass) are queries
over this engine; the v1 passes keep their original machinery.

The counterpart of `nomad_tpu.analysis.dataflow`.  In this package no
pass queries the engine yet: its queries are the reference's device
passes (jit, shard and alias), whose torch counterparts are ROADMAP.md
Queue 1 item 19b.  Their root sets are the two hooks below: torch has
no `donate_argnums`, so the donation map starts empty, and the
per-shard roots (the generators `kernel.solve_shards` drives) are named
by those passes when they come.
"""
from __future__ import annotations

import ast
import dataclasses
from typing import Dict, List, Optional, Sequence, Set, Tuple

from .core import AnalysisConfig, FuncInfo, PackageIndex, _dotted

# -- call classification ------------------------------------------------
# identity-preserving wrappers: the result aliases the argument's buffer
PASSTHROUGH_SUFFIXES = (
    "asarray", "ascontiguousarray", "asanyarray", "atleast_1d",
    "atleast_2d", "ravel", "reshape", "view", "squeeze", "astype",
)
# genuine copies / fresh allocations: the result owns its buffer
COPY_SUFFIXES = (
    "array", "copy", "deepcopy", "zeros", "ones", "empty", "full",
    "zeros_like", "ones_like", "full_like", "empty_like", "arange",
    "stack", "concatenate", "vstack", "hstack", "tile", "repeat",
    "frombuffer", "fromiter", "linspace",
)
# single-argument cast wrappers that merely relabel a value
CAST_NAMES = {"f32", "i32", "u32", "float32", "float64", "int32",
              "int16", "int8", "uint32", "bool_", "int", "float"}
# in-place ndarray mutators (host-side writes through the buffer)
INPLACE_METHODS = {"fill", "sort", "put", "partition", "setfield",
                   "itemset", "resize", "setflags", "byteswap"}


def _last(name: str) -> str:
    return name.rsplit(".", 1)[-1]


@dataclasses.dataclass(frozen=True)
class BufferValue:
    """Provenance of one expression's value.

    atoms   identity sources still aliased by the value:
            "param:<name>" / "attr:<name>" (a `self` attribute).
            Empty for fresh/copied/opaque values.
    device  the value is (or contains) a device_put result
    sharded a NamedSharding was pinned somewhere on the way
    copied  a genuine copy separates the value from its atoms
    key     linear-scan expression key of the SOURCE buffer at the
            point of use ("t", "self._template") — used for
            order-sensitive same-function matching; None when the
            source is not a simple name/attr chain.
    """
    atoms: frozenset = frozenset()
    device: bool = False
    sharded: bool = False
    copied: bool = False
    key: Optional[str] = None

    @staticmethod
    def merge(vals: Sequence["BufferValue"]) -> "BufferValue":
        vals = [v for v in vals if v is not None]
        if not vals:
            return BufferValue()
        return BufferValue(
            atoms=frozenset().union(*[v.atoms for v in vals]),
            device=any(v.device for v in vals),
            sharded=any(v.sharded for v in vals),
            copied=all(v.copied for v in vals),
            key=vals[0].key if len(vals) == 1 else None)


@dataclasses.dataclass
class PutEvent:
    line: int
    src: BufferValue          # provenance of the device_put ARGUMENT
    sharded: bool             # NamedSharding pinned at this call
    stored_attr: Optional[str]   # `self.<a> = device_put(...)` target
    stored_name: Optional[str]   # `x = device_put(...)` target


@dataclasses.dataclass
class MutEvent:
    line: int
    target: BufferValue       # provenance of the mutated buffer
    desc: str                 # rendered mutation site ("x[...] = ")


@dataclasses.dataclass
class FuncDataflow:
    puts: List[PutEvent]
    mutations: List[MutEvent]
    attr_assigns: Dict[str, List[BufferValue]]   # self.<attr> = value
    returns: List[BufferValue]


@dataclasses.dataclass
class Summary:
    returns: BufferValue
    donates: Tuple[int, ...] = ()      # positional params donated
    scatter: Tuple[int, ...] = ()      # positional params scattered


@dataclasses.dataclass
class AttrFact:
    sharded: bool = False
    uncopied_puts: List[Tuple[str, int]] = dataclasses.field(
        default_factory=list)          # (fkey, line) device_put sites
    mutations: List[Tuple[str, int, str]] = dataclasses.field(
        default_factory=list)          # (fkey, line, desc)
    holds_param: bool = False          # aliases a caller-owned buffer


class DataflowEngine:
    def __init__(self, index: PackageIndex, cfg: AnalysisConfig):
        self.index = index
        self.cfg = cfg
        self._flow_cache: Dict[Tuple[str, Optional[str]],
                               FuncDataflow] = {}
        self._summary_cache: Dict[Tuple[str, Optional[str]],
                                  Summary] = {}
        self._in_progress: Set[Tuple[str, Optional[str]]] = set()
        self._class_facts: Dict[str, Dict[str, AttrFact]] = {}
        self._mesh_roots: Optional[Set[str]] = None
        self._shard_safe: Optional[Set[str]] = None
        self._donation: Optional[Dict[str, Tuple[int, ...]]] = None
        self._scatter_map: Optional[Dict[str, Tuple[int, ...]]] = None

    # ------------------------------------------------- mesh membership
    def mesh_roots(self) -> Set[str]:
        """Functions that run per shard: none named until the device
        passes define the port's per-shard roots."""
        if self._mesh_roots is None:
            self._mesh_roots = set()
        return self._mesh_roots

    def shard_safe(self) -> Set[str]:
        """Functions running under a shard_map/pmap context (roots plus
        everything reachable from them): scatters here see per-shard
        local blocks, not the global sharded operand."""
        if self._shard_safe is None:
            self._shard_safe = self.index.reachable(self.mesh_roots())
            self._shard_safe |= self.mesh_roots()
        return self._shard_safe

    # ----------------------------------------------- name/alias helpers
    def _full_name(self, fi: FuncInfo, node) -> str:
        d = _dotted(node)
        if not d:
            return ""
        head = d.split(".")[0]
        mi = self.index.modules[fi.module]
        la = self.index._local_imports(fi)
        target = la.get(head) or mi.aliases.get(head)
        return (target + d[len(head):]) if target else d

    def _is_device_put(self, fi: FuncInfo, call: ast.Call) -> bool:
        return self._full_name(fi, call.func).endswith("device_put")

    def _sharding_arg(self, fi: FuncInfo, call: ast.Call,
                      env: Dict[str, BufferValue],
                      shardy: Set[str]) -> bool:
        """Does this device_put pin a NamedSharding? (second positional
        arg or device=/sharding= kwarg that is a NamedSharding(...)
        call or a local bound to one)."""
        cands = list(call.args[1:]) + [
            kw.value for kw in call.keywords
            if kw.arg in ("device", "sharding", "out_shardings")]
        for c in cands:
            if isinstance(c, ast.Call) and self._full_name(
                    fi, c.func).endswith("NamedSharding"):
                return True
            if isinstance(c, ast.Name) and c.id in shardy:
                return True
        return False

    # ----------------------------------------------- expression values
    def _eval(self, fi: FuncInfo, node, env: Dict[str, BufferValue],
              bound_cls: Optional[str], depth: int = 0) -> BufferValue:
        """Provenance of an expression. Conservative: anything not
        understood is an opaque fresh-ish value with no atoms."""
        if depth > 12:
            return BufferValue()
        if isinstance(node, ast.Name):
            if node.id in env:
                v = env[node.id]
                return dataclasses.replace(v, key=node.id)
            params = _param_names(fi)
            if node.id in params:
                return BufferValue(atoms=frozenset({f"param:{node.id}"}),
                                   key=node.id)
            return BufferValue(key=node.id)
        if isinstance(node, ast.Attribute):
            d = _dotted(node)
            if d and d.startswith("self."):
                attr = d.split(".")[1]
                return BufferValue(atoms=frozenset({f"attr:{attr}"}),
                                   key=d)
            return BufferValue(key=d)
        if isinstance(node, ast.Subscript):
            # a subscript VIEW aliases the base buffer (numpy slicing)
            base = self._eval(fi, node.value, env, bound_cls, depth + 1)
            return dataclasses.replace(base, key=None)
        if isinstance(node, (ast.Tuple, ast.List)):
            return BufferValue.merge([
                self._eval(fi, e, env, bound_cls, depth + 1)
                for e in node.elts])
        if isinstance(node, ast.Dict):
            return BufferValue.merge([
                self._eval(fi, v, env, bound_cls, depth + 1)
                for v in node.values])
        if isinstance(node, ast.IfExp):
            return BufferValue.merge([
                self._eval(fi, node.body, env, bound_cls, depth + 1),
                self._eval(fi, node.orelse, env, bound_cls, depth + 1)])
        if isinstance(node, ast.BoolOp):
            return BufferValue.merge([
                self._eval(fi, v, env, bound_cls, depth + 1)
                for v in node.values])
        if isinstance(node, ast.Call):
            return self._eval_call(fi, node, env, bound_cls, depth)
        return BufferValue()

    def _eval_call(self, fi: FuncInfo, call: ast.Call,
                   env: Dict[str, BufferValue],
                   bound_cls: Optional[str], depth: int) -> BufferValue:
        full = self._full_name(fi, call.func)
        last = _last(full)
        # x.copy() / x.astype(...) method forms
        if isinstance(call.func, ast.Attribute) and not call.args \
                and call.func.attr == "copy":
            return BufferValue(copied=True)
        if isinstance(call.func, ast.Attribute) \
                and call.func.attr in PASSTHROUGH_SUFFIXES:
            # `x.astype(...)` (method: descend the receiver) vs
            # `np.asarray(x)` (module function: descend the argument)
            based = _dotted(call.func.value)
            head = based.split(".")[0] if based else ""
            la = self.index._local_imports(fi)
            mi = self.index.modules[fi.module]
            if head and (head in mi.aliases or head in la):
                if call.args:
                    return self._eval(fi, call.args[0], env, bound_cls,
                                      depth + 1)
                return BufferValue()
            return self._eval(fi, call.func.value, env, bound_cls,
                              depth + 1)
        if last in CAST_NAMES and len(call.args) == 1:
            return self._eval(fi, call.args[0], env, bound_cls,
                              depth + 1)
        if full.endswith("device_put"):
            src = (self._eval(fi, call.args[0], env, bound_cls,
                              depth + 1) if call.args else BufferValue())
            sharded = self._sharding_arg(fi, call, env, set())
            return BufferValue(atoms=src.atoms if not src.copied
                               else frozenset(),
                               device=True, sharded=sharded,
                               copied=src.copied)
        if last in PASSTHROUGH_SUFFIXES and call.args:
            return self._eval(fi, call.args[0], env, bound_cls,
                              depth + 1)
        if last in COPY_SUFFIXES:
            return BufferValue(copied=True)
        # internal call: substitute the callee's return summary
        target = self._resolve(fi, call, bound_cls)
        if target is not None:
            tfi = self.index.functions[target]
            tcls = (bound_cls if _is_self_call(call) and bound_cls
                    else (f"{tfi.module}:{tfi.cls}" if tfi.cls else None))
            ret = self.summary(target, tcls).returns
            if ret.atoms:
                # map "param:<name>" atoms through the argument list;
                # "attr:" atoms name the CALLEE's self and only survive
                # a self-call (same object)
                mapped: List[BufferValue] = []
                rest: Set[str] = set()
                pnames = _param_list(tfi)
                off = 1 if (tfi.cls is not None and pnames
                            and pnames[0] == "self") else 0
                for atom in ret.atoms:
                    if atom.startswith("param:"):
                        pname = atom[6:]
                        try:
                            pos = pnames.index(pname) - off
                        except ValueError:
                            pos = -1
                        arg = None
                        if 0 <= pos < len(call.args):
                            arg = call.args[pos]
                        for kw in call.keywords:
                            if kw.arg == pname:
                                arg = kw.value
                        if arg is not None:
                            mapped.append(self._eval(
                                fi, arg, env, bound_cls, depth + 1))
                            continue
                    elif atom.startswith("attr:") and _is_self_call(call):
                        rest.add(atom)
                base = BufferValue.merge(mapped) if mapped \
                    else BufferValue(copied=ret.copied)
                return BufferValue(
                    atoms=base.atoms | frozenset(rest),
                    device=ret.device or base.device,
                    sharded=ret.sharded or base.sharded,
                    copied=ret.copied and base.copied)
            return dataclasses.replace(ret, key=None)
        return BufferValue()

    def _resolve(self, fi: FuncInfo, call: ast.Call,
                 bound_cls: Optional[str]) -> Optional[str]:
        """resolve_call, with self-dispatch bound to the concrete
        class (subclass overrides win for inherited methods)."""
        if bound_cls and _is_self_call(call):
            target = self.index.method_on(bound_cls, call.func.attr)
            if target:
                return target
        la = self.index._local_imports(fi)
        lt = self.index._local_var_types(fi)
        return self.index.resolve_call(fi, call, la, lt)

    # -------------------------------------------------- per-func facts
    def flow(self, fkey: str,
             bound_cls: Optional[str] = None) -> FuncDataflow:
        ck = (fkey, bound_cls)
        cached = self._flow_cache.get(ck)
        if cached is not None:
            return cached
        fi = self.index.functions[fkey]
        env: Dict[str, BufferValue] = {}
        shardy: Set[str] = set()     # locals bound to NamedSharding(...)
        assigns: List[Tuple[int, str, str]] = []
        out = FuncDataflow([], [], {}, [])
        for node in _linear_nodes(self.index, fi):
            if isinstance(node, ast.Assign) and isinstance(
                    node.value, ast.Call) and self._full_name(
                    fi, node.value.func).endswith("NamedSharding"):
                for t in node.targets:
                    if isinstance(t, ast.Name):
                        shardy.add(t.id)
            if isinstance(node, ast.Call) and self._is_device_put(
                    fi, node):
                src = (self._eval(fi, node.args[0], env, bound_cls)
                       if node.args else BufferValue())
                out.puts.append(PutEvent(
                    line=node.lineno, src=src,
                    sharded=self._sharding_arg(fi, node, env, shardy),
                    stored_attr=None, stored_name=None))
            mut = self._mutation(fi, node, env, bound_cls)
            if mut is not None:
                out.mutations.append(mut)
            if isinstance(node, ast.Assign):
                val = self._eval(fi, node.value, env, bound_cls)
                params = _param_names(fi)
                for t in node.targets:
                    if isinstance(t, ast.Name):
                        if t.id in params:
                            # a rebind of a PARAMETER is usually a
                            # conditional default fill (`if x is None:
                            # x = np.stack(...)`); the linear scan
                            # cannot see the branch, so the caller's
                            # buffer identity must survive the merge
                            val = BufferValue(
                                atoms=val.atoms
                                | frozenset({f"param:{t.id}"}),
                                device=val.device, sharded=val.sharded,
                                copied=False)
                        env[t.id] = val
                        assigns.append((node.lineno, "name", t.id))
                    elif isinstance(t, ast.Attribute) and isinstance(
                            t.value, ast.Name) and t.value.id == "self":
                        out.attr_assigns.setdefault(
                            t.attr, []).append(val)
                        assigns.append((node.lineno, "attr", t.attr))
            if isinstance(node, ast.Return) and node.value is not None:
                out.returns.append(
                    self._eval(fi, node.value, env, bound_cls))
        # attach `x = device_put(...)` / `self.a = device_put(...)`
        # storage targets (the Assign statement and the Call expression
        # are visited separately; match them up by line)
        for put in out.puts:
            for line, kind, name in assigns:
                if line == put.line:
                    if kind == "name":
                        put.stored_name = name
                    else:
                        put.stored_attr = name
        self._flow_cache[ck] = out
        return out

    def _mutation(self, fi: FuncInfo, node, env, bound_cls
                  ) -> Optional[MutEvent]:
        """In-place HOST mutation through a buffer: subscript stores,
        augmented assigns, and the in-place ndarray method calls."""
        targets: List = []
        if isinstance(node, ast.Assign):
            targets = [t for t in node.targets
                       if isinstance(t, ast.Subscript)]
        elif isinstance(node, ast.AugAssign):
            targets = [node.target]
        elif isinstance(node, ast.Call) and isinstance(
                node.func, ast.Attribute) \
                and node.func.attr in INPLACE_METHODS:
            base = self._eval(fi, node.func.value, env, bound_cls)
            if base.atoms or base.key:
                return MutEvent(node.lineno, base,
                                f".{node.func.attr}()")
        elif isinstance(node, ast.Call) and self._full_name(
                fi, node.func).endswith("copyto") and node.args:
            base = self._eval(fi, node.args[0], env, bound_cls)
            if base.atoms or base.key:
                return MutEvent(node.lineno, base, "np.copyto")
        for t in targets:
            base = t
            while isinstance(base, ast.Subscript):
                base = base.value
            if isinstance(t, ast.Name):
                continue        # plain rebind, not a mutation
            v = self._eval(fi, base, env, bound_cls)
            if v.atoms or v.key:
                return MutEvent(node.lineno, v, "subscript store")
        return None

    # ----------------------------------------------------- summaries
    def summary(self, fkey: str,
                bound_cls: Optional[str] = None) -> Summary:
        ck = (fkey, bound_cls)
        cached = self._summary_cache.get(ck)
        if cached is not None:
            return cached
        if ck in self._in_progress:         # recursion: stay opaque
            return Summary(BufferValue())
        self._in_progress.add(ck)
        try:
            fl = self.flow(fkey, bound_cls)
            ret = BufferValue.merge(fl.returns) if fl.returns \
                else BufferValue()
            summ = Summary(returns=ret,
                           donates=self.donation_map().get(fkey, ()),
                           scatter=self.scatter_map().get(fkey, ()))
        finally:
            self._in_progress.discard(ck)
        self._summary_cache[ck] = summ
        return summ

    # --------------------------------------------- donation (fixpoint)
    def donation_map(self) -> Dict[str, Tuple[int, ...]]:
        """fkey -> positional parameter indices whose buffers are dead
        after the call, to ANY wrapper depth: base case is the
        donate_argnums jit roots; a function passing its own parameter
        into a donated position donates that parameter too."""
        if self._donation is not None:
            return self._donation
        # torch donates no buffer: no base case, so nothing propagates
        donation: Dict[str, Set[int]] = {}
        changed = True
        while changed:
            changed = False
            for fkey, fi in self.index.functions.items():
                pnames = _param_list(fi)
                if not pnames:
                    continue
                for call, target in self._resolved_calls(fkey):
                    tpos = donation.get(target)
                    if not tpos:
                        continue
                    off = _self_offset(self.index, target, call)
                    for pos in tpos:
                        apos = pos - off
                        if not (0 <= apos < len(call.args)):
                            continue
                        arg = call.args[apos]
                        if isinstance(arg, ast.Name) \
                                and arg.id in pnames:
                            ppos = pnames.index(arg.id)
                            cur = donation.setdefault(fkey, set())
                            if ppos not in cur:
                                cur.add(ppos)
                                changed = True
        self._donation = {k: tuple(sorted(v))
                          for k, v in donation.items()}
        return self._donation

    # ---------------------------------------------- scatter (fixpoint)
    def scatter_map(self) -> Dict[str, Tuple[int, ...]]:
        """fkey -> positional parameter indices that receive an
        `x.at[...].set/add` scatter (directly or transitively) OUTSIDE
        a shard_map context. Mesh-rooted functions are excluded: their
        scatters act on per-shard local blocks and are partition-safe
        by construction."""
        if self._scatter_map is not None:
            return self._scatter_map
        safe = self.shard_safe()
        scatter: Dict[str, Set[int]] = {}
        # config-registered helpers (e.g. kernel.delta_scatter_set
        # whose jit body is built dynamically and defeats resolution)
        for spec in getattr(self.cfg, "scatter_helpers", ()):
            name, _, pos = spec.partition("@")
            if name in self.index.functions:
                scatter.setdefault(name, set()).add(
                    int(pos) if pos else 0)
        for fkey, fi in self.index.functions.items():
            if fkey in safe:
                continue
            pnames = _param_list(fi)
            for node in self.index._own_nodes(fi):
                tgt = _at_scatter_base(node)
                if tgt is not None and isinstance(tgt, ast.Name) \
                        and tgt.id in pnames:
                    scatter.setdefault(fkey, set()).add(
                        pnames.index(tgt.id))
        changed = True
        while changed:
            changed = False
            for fkey, fi in self.index.functions.items():
                if fkey in safe:
                    continue
                pnames = _param_list(fi)
                if not pnames:
                    continue
                for call, target in self._resolved_calls(fkey):
                    tpos = scatter.get(target)
                    if not tpos:
                        continue
                    off = _self_offset(self.index, target, call)
                    for pos in tpos:
                        apos = pos - off
                        if not (0 <= apos < len(call.args)):
                            continue
                        arg = call.args[apos]
                        if isinstance(arg, ast.Name) \
                                and arg.id in pnames:
                            ppos = pnames.index(arg.id)
                            cur = scatter.setdefault(fkey, set())
                            if ppos not in cur:
                                cur.add(ppos)
                                changed = True
        self._scatter_map = {k: tuple(sorted(v))
                             for k, v in scatter.items()}
        return self._scatter_map

    def _resolved_calls(self, fkey: str):
        fi = self.index.functions[fkey]
        la = self.index._local_imports(fi)
        lt = self.index._local_var_types(fi)
        for node in self.index._own_nodes(fi):
            if isinstance(node, ast.Call):
                r = self.index.resolve_call(fi, node, la, lt)
                if r is not None:
                    yield node, r

    # ------------------------------------------------- class buffers
    def class_facts(self, ckey: str) -> Dict[str, AttrFact]:
        """Per-attribute buffer facts for one concrete class, with
        inherited methods analyzed under subclass-bound dispatch."""
        cached = self._class_facts.get(ckey)
        if cached is not None:
            return cached
        facts: Dict[str, AttrFact] = {}
        for mname, fkey in self._mro_methods(ckey).items():
            fl = self.flow(fkey, bound_cls=ckey)
            for attr, vals in fl.attr_assigns.items():
                fact = facts.setdefault(attr, AttrFact())
                for v in vals:
                    if v.sharded:
                        fact.sharded = True
                    if (not v.device and not v.copied
                            and any(a.startswith("param:")
                                    for a in v.atoms)):
                        fact.holds_param = True
            for put in fl.puts:
                if put.sharded:
                    continue        # sharded puts are SHARD territory
                if put.src.copied:
                    continue
                for atom in put.src.atoms:
                    if atom.startswith("attr:"):
                        facts.setdefault(
                            atom[5:], AttrFact()).uncopied_puts.append(
                            (fkey, put.line))
            for mut in fl.mutations:
                for atom in mut.target.atoms:
                    if atom.startswith("attr:"):
                        facts.setdefault(
                            atom[5:], AttrFact()).mutations.append(
                            (fkey, mut.line, mut.desc))
        # one propagation round: `self.b = self.a` shardedness
        for mname, fkey in self._mro_methods(ckey).items():
            fl = self.flow(fkey, bound_cls=ckey)
            for attr, vals in fl.attr_assigns.items():
                for v in vals:
                    for atom in v.atoms:
                        if atom.startswith("attr:") and facts.get(
                                atom[5:], AttrFact()).sharded:
                            facts.setdefault(attr,
                                             AttrFact()).sharded = True
        self._class_facts[ckey] = facts
        return facts

    def _mro_methods(self, ckey: str) -> Dict[str, str]:
        """name -> fkey over the class and its package bases, own
        definitions winning."""
        out: Dict[str, str] = {}
        seen: Set[str] = set()
        stack = [ckey]
        while stack:
            ck = stack.pop(0)
            if ck in seen or ck not in self.index.classes:
                continue
            seen.add(ck)
            ci = self.index.classes[ck]
            for name, fkey in ci.methods.items():
                out.setdefault(name, fkey)
            stack.extend(ci.bases)
        return out

    def value_is_sharded(self, val: BufferValue,
                         facts: Optional[Dict[str, AttrFact]]) -> bool:
        if val.sharded:
            return True
        if facts:
            for atom in val.atoms:
                if atom.startswith("attr:"):
                    f = facts.get(atom[5:])
                    if f is not None and f.sharded:
                        return True
        return False


# ---------------------------------------------------------- utilities
def _param_names(fi: FuncInfo) -> Set[str]:
    args = fi.node.args
    return set(_param_list(fi)) | {a.arg for a in args.kwonlyargs}


def _param_list(fi: FuncInfo) -> List[str]:
    args = fi.node.args
    return [a.arg for a in
            list(args.posonlyargs) + list(args.args)]


def _self_offset(index: PackageIndex, target: str,
                 call: ast.Call) -> int:
    """Positional shift between the callee's def params and the call's
    args when the callee is a method invoked through an instance."""
    tfi = index.functions.get(target)
    if tfi is None or tfi.cls is None:
        return 0
    if isinstance(call.func, ast.Attribute):
        return 1
    return 0


def _is_self_call(call: ast.Call) -> bool:
    return (isinstance(call.func, ast.Attribute)
            and isinstance(call.func.value, ast.Name)
            and call.func.value.id == "self")


def _linear_nodes(index: PackageIndex, fi: FuncInfo):
    """Own statements + expressions in source-line order (excludes
    nested def/class bodies, like PackageIndex._own_nodes, but sorted
    so the env scan sees defs before uses)."""
    nodes = list(index._own_nodes(fi))
    nodes.sort(key=lambda n: (getattr(n, "lineno", 0),
                              getattr(n, "col_offset", 0)))
    return nodes


def _at_scatter_base(node) -> Optional[ast.AST]:
    """`X.at[idx].set/add/...(rows)` -> the X expression, else None."""
    if not isinstance(node, ast.Call):
        return None
    f = node.func
    if not isinstance(f, ast.Attribute) or f.attr not in (
            "set", "add", "mul", "min", "max", "apply", "get"):
        return None
    sub = f.value
    if not isinstance(sub, ast.Subscript):
        return None
    at = sub.value
    if isinstance(at, ast.Attribute) and at.attr == "at":
        return at.value
    return None


def scatter_call_has_drop_mode(node: ast.Call) -> bool:
    for kw in node.keywords:
        if kw.arg == "mode" and isinstance(kw.value, ast.Constant) \
                and kw.value.value == "drop":
            return True
    return False
