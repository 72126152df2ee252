"""Dataflow layer for nomadlint v2.

The v1 passes are pure AST pattern matches over a call graph; every
bug class the reference shipped and later caught by hand — the
zero-copy `device_put` aliasing double-charge, the GSPMD double-applied
scatter on a NamedSharding-sharded operand, the donated-carry
read-after-dispatch — is a *dataflow* property: where a buffer came
from, whether a copy intervened, which call changed it.  This module
adds exactly that layer, still pure `ast` (nothing analyzed is ever
imported):

  * per-function linear def-use scanning with buffer-identity
    provenance: a `BufferValue` tracks the identity sources of a value
    (parameters, `self` attributes), whether it crossed onto the device
    (`torch.as_tensor` / `torch.from_numpy`, with or without
    `.to(device)`: on `cpu` the tensor IS the numpy buffer), whether it
    is split per shard, and whether a genuine copy (`np.array`,
    `.copy()`, `.clone()`, `torch.tensor`, fresh allocation)
    intervened — `np.asarray`/`ascontiguousarray`, dtype casts, views
    and `.to(...)` are identity-PRESERVING and propagate provenance
    unchanged;
  * interprocedural summaries (fixpoint with a recursion guard):
    return-value provenance (`_put_node`-style hooks advertise
    "returns a device buffer, copied, split"), uncopied-put positions
    (a parameter that reaches `torch.as_tensor` without a copy), the
    transitive IN-PLACE map (a wrapper passing its parameter into a
    position some callee mutates in place mutates that parameter too,
    to any depth) and scatter positions (a parameter that receives a
    row scatter);
  * class-level buffer facts with subclass-bound dispatch: methods are
    analyzed against the *concrete* class so an inherited
    `_put_node_side` picks up the subclass's `_put_node` override —
    this is what lets SHARD401 tell `ResidentSolver` (one plane a
    device, plain scatters: fine) from a subclass that splits its
    planes per shard but inherits the plain delta scatter.

A plane is split per shard when it comes from a comprehension that
moves one piece to each device (`[x[i].to(d) for i, d in ...]`, the
shape of `ShardedResidentSolver._split_rows` / `_split_cols`), or from
a function that returns one.  The per-shard roots are the generators
handed to `kernel.solve_shards` (`jit_pass.find_mesh_roots`).  The
in-place map's base case is every function whose own body mutates a
parameter in place (`index_put_` and the other `*_` methods, a
subscript store or augmented assignment through it, `out=`): the
kernel's `delta_scatter_set` / `delta_scatter_add` at position 0 and
`tensorize.apply_node_delta_host` on the numpy template.

The device passes (jit, shard, alias) query this engine; the other
passes keep their original machinery.
"""
from __future__ import annotations

import ast
import dataclasses
from typing import Dict, List, Optional, Sequence, Set, Tuple

from .core import AnalysisConfig, FuncInfo, PackageIndex, _dotted

# -- call classification ------------------------------------------------
# identity-preserving wrappers: the result aliases the argument's buffer
# (numpy's and torch's views, casts that may return the input, and
# `.to(...)`, which on `cpu` returns the tensor itself)
PASSTHROUGH_SUFFIXES = (
    "asarray", "ascontiguousarray", "asanyarray", "atleast_1d",
    "atleast_2d", "ravel", "reshape", "view", "squeeze", "astype",
    "to", "detach", "contiguous", "expand", "expand_as", "narrow",
    "unsqueeze", "flatten", "view_as", "reshape_as", "cuda", "permute",
    "transpose", "movedim", "unflatten",
)
# genuine copies / fresh allocations: the result owns its buffer
COPY_SUFFIXES = (
    "array", "copy", "deepcopy", "zeros", "ones", "empty", "full",
    "zeros_like", "ones_like", "full_like", "empty_like", "arange",
    "stack", "concatenate", "vstack", "hstack", "tile", "repeat",
    "frombuffer", "fromiter", "linspace", "tensor", "clone", "cat",
)
# calls that hand a host buffer to torch WITHOUT a copy: on `cpu` the
# tensor shares the numpy buffer (and `.to("cpu")` returns it as is)
PUT_SUFFIXES = ("as_tensor", "from_numpy")
# single-argument cast wrappers that merely relabel a value
CAST_NAMES = {"f32", "i32", "u32", "float32", "float64", "int32",
              "int16", "int8", "uint32", "bool_", "int", "float"}
# in-place ndarray mutators (host-side writes through the buffer)
INPLACE_METHODS = {"fill", "sort", "put", "partition", "setfield",
                   "itemset", "resize", "setflags", "byteswap"}
# row scatters: the receiver takes rows at an index operand
SCATTER_METHODS = {"index_put", "index_put_", "index_add", "index_add_",
                   "index_copy", "index_copy_", "index_fill",
                   "index_fill_", "scatter", "scatter_", "scatter_add",
                   "scatter_add_", "scatter_reduce", "scatter_reduce_",
                   "put_", "masked_scatter", "masked_scatter_"}
# attributes that describe a buffer rather than alias it
META_ATTRS = {"shape", "dtype", "device", "ndim", "size", "nbytes",
              "itemsize", "is_cuda", "layout"}


def _last(name: str) -> str:
    return name.rsplit(".", 1)[-1]


def is_inplace_method(attr: str) -> bool:
    """torch's in-place spelling: a trailing underscore (`add_`,
    `index_put_`), not a dunder."""
    return attr.endswith("_") and not attr.endswith("__") \
        and not attr.startswith("_")


def root_name(node) -> Optional[str]:
    """The Name under a chain of subscripts/attributes (`a` of
    `a.b[0].c`), else None."""
    while isinstance(node, (ast.Subscript, ast.Attribute)):
        node = node.value
    return node.id if isinstance(node, ast.Name) else None


@dataclasses.dataclass(frozen=True)
class BufferValue:
    """Provenance of one expression's value.

    atoms   identity sources still aliased by the value:
            "param:<name>" / "attr:<name>" (a `self` attribute).
            Empty for fresh/copied/opaque values.
    device  the value is (or contains) a torch tensor made from a host
            buffer (`torch.as_tensor` / `torch.from_numpy`)
    sharded the value is a plane split per shard (one tensor a device)
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
    src: BufferValue          # provenance of the host buffer handed over
    sharded: bool             # split per shard at this call
    stored_attr: Optional[str]   # `self.<a> = torch.as_tensor(...)`
    stored_name: Optional[str]   # `x = torch.as_tensor(...)`
    via_call: bool = False    # made by a callee on its parameter


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
    mutates: Tuple[int, ...] = ()      # positional params changed in place
    scatter: Tuple[int, ...] = ()      # positional params scattered
    puts: Tuple[int, ...] = ()         # params handed to torch uncopied


@dataclasses.dataclass
class AttrFact:
    sharded: bool = False
    uncopied_puts: List[Tuple[str, int]] = dataclasses.field(
        default_factory=list)          # (fkey, line) put sites
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
        self._inplace: Optional[Dict[str, Tuple[int, ...]]] = None
        self._inplace_base: Optional[Dict[str, Tuple[int, ...]]] = None
        self._scatter_map: Optional[Dict[str, Tuple[int, ...]]] = None
        self._calls_cache: Dict[str, List[Tuple[ast.Call, str]]] = {}

    # ------------------------------------------------- mesh membership
    def mesh_roots(self) -> Set[str]:
        """Functions that run per shard: the generators handed to
        `kernel.solve_shards` (the counterpart of the reference's
        shard_map bodies)."""
        if self._mesh_roots is None:
            from .jit_pass import find_mesh_roots
            self._mesh_roots = set(find_mesh_roots(self.index))
        return self._mesh_roots

    def shard_safe(self) -> Set[str]:
        """Functions running per shard (roots plus everything reachable
        from them): scatters here see one shard's local rows, not a
        plane split across shards."""
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

    def _is_put(self, fi: FuncInfo, call: ast.Call) -> bool:
        full = self._full_name(fi, call.func)
        return _last(full) in PUT_SUFFIXES or full == "torch.asarray"

    def _module_head(self, fi: FuncInfo, node) -> bool:
        """Is the call's receiver a module (np.asarray(x)) rather than a
        value (x.astype(...))?"""
        based = _dotted(node)
        head = based.split(".")[0] if based else ""
        la = self.index._local_imports(fi)
        mi = self.index.modules[fi.module]
        return bool(head) and (head in mi.aliases or head in la)

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
            if node.attr in META_ATTRS:
                return BufferValue()
            if d and d.startswith("self."):
                attr = d.split(".")[1]
                return BufferValue(atoms=frozenset({f"attr:{attr}"}),
                                   key=d)
            # a field of a tracked object shares its identity (`t.used0`
            # of `t = self.template`)
            base = self._eval(fi, node.value, env, bound_cls, depth + 1)
            if base.atoms:
                return dataclasses.replace(base, key=d)
            return BufferValue(key=d)
        if isinstance(node, ast.Subscript):
            # a subscript VIEW aliases the base buffer (numpy slicing);
            # one element of a split plane is one shard's tensor
            base = self._eval(fi, node.value, env, bound_cls, depth + 1)
            return dataclasses.replace(base, key=None, sharded=False)
        if isinstance(node, (ast.Tuple, ast.List)):
            return BufferValue.merge([
                self._eval(fi, e, env, bound_cls, depth + 1)
                for e in node.elts])
        if isinstance(node, ast.Dict):
            return BufferValue.merge([
                self._eval(fi, v, env, bound_cls, depth + 1)
                for v in node.values])
        if isinstance(node, (ast.ListComp, ast.GeneratorExp, ast.DictComp)):
            elt = node.value if isinstance(node, ast.DictComp) else node.elt
            if _splits_over_devices(node, elt):
                return BufferValue(device=True, sharded=True, copied=True)
            inner = self._eval(fi, elt, env, bound_cls, depth + 1)
            return dataclasses.replace(inner, key=None)
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
        # x.copy() / x.clone() method forms
        if isinstance(call.func, ast.Attribute) and not call.args \
                and call.func.attr in ("copy", "clone"):
            return BufferValue(copied=True)
        if full == "getattr" and call.args:
            return self._eval(fi, call.args[0], env, bound_cls, depth + 1)
        if self._is_put(fi, call):
            src = (self._eval(fi, call.args[0], env, bound_cls,
                              depth + 1) if call.args else BufferValue())
            return BufferValue(atoms=src.atoms if not src.copied
                               else frozenset(),
                               device=True, sharded=src.sharded,
                               copied=src.copied)
        if isinstance(call.func, ast.Attribute) \
                and call.func.attr in PASSTHROUGH_SUFFIXES:
            # `x.astype(...)` (method: descend the receiver) vs
            # `np.asarray(x)` (module function: descend the argument)
            if self._module_head(fi, call.func.value):
                if call.args:
                    return self._eval(fi, call.args[0], env, bound_cls,
                                      depth + 1)
                return BufferValue()
            return self._eval(fi, call.func.value, env, bound_cls,
                              depth + 1)
        if last in CAST_NAMES and len(call.args) == 1:
            return self._eval(fi, call.args[0], env, bound_cls,
                              depth + 1)
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
                for atom in ret.atoms:
                    if atom.startswith("param:"):
                        arg = _arg_for(tfi, call, atom[6:])
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
        assigns: List[Tuple[int, str, str]] = []
        out = FuncDataflow([], [], {}, [])
        for node in _linear_nodes(self.index, fi):
            if isinstance(node, ast.Call) and self._is_put(fi, node):
                src = (self._eval(fi, node.args[0], env, bound_cls)
                       if node.args else BufferValue())
                out.puts.append(PutEvent(
                    line=node.lineno, src=src, sharded=src.sharded,
                    stored_attr=None, stored_name=None))
            elif isinstance(node, ast.Call):
                # a callee that hands one of its parameters to torch
                # uncopied puts the argument at this call
                target = self._resolve(fi, node, bound_cls)
                if target is not None:
                    tfi = self.index.functions[target]
                    pnames = _param_list(tfi)
                    for pos in self._summary_for_call(
                            target, node, bound_cls).puts:
                        arg = _arg_for(tfi, node, pnames[pos])
                        if arg is None:
                            continue
                        src = self._eval(fi, arg, env, bound_cls)
                        if src.atoms and not src.copied:
                            out.puts.append(PutEvent(
                                line=node.lineno, src=src, sharded=False,
                                stored_attr=None, stored_name=None,
                                via_call=True))
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
        # attach `x = torch.as_tensor(...)` / `self.a = ...` storage
        # targets (the Assign statement and the Call expression are
        # visited separately; match them up by line)
        for put in out.puts:
            for line, kind, name in assigns:
                if line == put.line:
                    if kind == "name":
                        put.stored_name = name
                    else:
                        put.stored_attr = name
        self._flow_cache[ck] = out
        return out

    def _summary_for_call(self, target: str, call: ast.Call,
                          bound_cls: Optional[str]) -> Summary:
        tfi = self.index.functions[target]
        tcls = (bound_cls if _is_self_call(call) and bound_cls
                else (f"{tfi.module}:{tfi.cls}" if tfi.cls else None))
        return self.summary(target, tcls)

    def _mutation(self, fi: FuncInfo, node, env, bound_cls
                  ) -> Optional[MutEvent]:
        """In-place mutation through a buffer: subscript stores,
        augmented assigns, numpy's in-place methods, torch's `*_`
        methods, `out=` and calls into the in-place map."""
        targets: List = []
        if isinstance(node, ast.Assign):
            targets = [t for t in node.targets
                       if isinstance(t, ast.Subscript)]
        elif isinstance(node, ast.AugAssign):
            targets = [node.target]
        elif isinstance(node, ast.Call):
            f = node.func
            if isinstance(f, ast.Attribute) and (
                    f.attr in INPLACE_METHODS or is_inplace_method(f.attr)) \
                    and not self._module_head(fi, f.value):
                base = self._eval(fi, f.value, env, bound_cls)
                if base.atoms or base.key:
                    return MutEvent(node.lineno, base, f".{f.attr}()")
            if self._full_name(fi, f).endswith("copyto") and node.args:
                base = self._eval(fi, node.args[0], env, bound_cls)
                if base.atoms or base.key:
                    return MutEvent(node.lineno, base, "np.copyto")
            for kw in node.keywords:
                if kw.arg == "out":
                    base = self._eval(fi, kw.value, env, bound_cls)
                    if base.atoms or base.key:
                        return MutEvent(node.lineno, base, "out=")
            target = self._resolve(fi, node, bound_cls)
            if target is not None:
                tfi = self.index.functions[target]
                pnames = _param_list(tfi)
                for pos in self.inplace_map().get(target, ()):
                    arg = _arg_for(tfi, node, pnames[pos])
                    if arg is None:
                        continue
                    base = self._eval(fi, arg, env, bound_cls)
                    if base.atoms or base.key:
                        return MutEvent(node.lineno, base,
                                        f"{tfi.qual}() in place")
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
            pnames = _param_list(self.index.functions[fkey])
            puts = sorted({pnames.index(a[6:]) for p in fl.puts
                           if not p.src.copied for a in p.src.atoms
                           if a.startswith("param:")
                           and a[6:] in pnames})
            summ = Summary(returns=ret,
                           mutates=self.inplace_map().get(fkey, ()),
                           scatter=self.scatter_map().get(fkey, ()),
                           puts=tuple(puts))
        finally:
            self._in_progress.discard(ck)
        self._summary_cache[ck] = summ
        return summ

    # --------------------------------------------- in place (fixpoint)
    def inplace_base(self) -> Dict[str, Tuple[int, ...]]:
        """fkey -> positional parameter indices its OWN body changes in
        place (a `*_` method, a subscript store or augmented assignment
        through the parameter, `out=`, numpy's in-place methods).  A
        method's `self` is never listed: changing the receiver's state
        is what methods are for."""
        if self._inplace_base is not None:
            return self._inplace_base
        base: Dict[str, Set[int]] = {}
        for fkey, fi in self.index.functions.items():
            pnames = _param_list(fi)
            if fi.cls is not None and pnames and pnames[0] == "self":
                pnames = [None] + pnames[1:]
            if not any(pnames):
                continue
            hit: Set[int] = set()

            def mark(expr):
                r = root_name(expr)
                if r is not None and r in pnames:
                    hit.add(pnames.index(r))

            for node in self.index._own_nodes(fi):
                if isinstance(node, ast.Assign):
                    for t in node.targets:
                        if isinstance(t, ast.Subscript):
                            mark(t)
                elif isinstance(node, ast.AugAssign) and isinstance(
                        node.target, (ast.Subscript, ast.Attribute)):
                    mark(node.target)
                elif isinstance(node, ast.Call):
                    f = node.func
                    if isinstance(f, ast.Attribute) and (
                            is_inplace_method(f.attr)
                            or f.attr in INPLACE_METHODS) \
                            and not self._module_head(fi, f.value):
                        mark(f.value)
                    for kw in node.keywords:
                        if kw.arg == "out":
                            mark(kw.value)
                    if _last(self._full_name(fi, f)) == "copyto" \
                            and node.args:
                        mark(node.args[0])
            if hit:
                base[fkey] = hit
        self._inplace_base = {k: tuple(sorted(v)) for k, v in base.items()}
        return self._inplace_base

    def inplace_map(self) -> Dict[str, Tuple[int, ...]]:
        """fkey -> positional parameter indices whose buffers the call
        changes in place, to ANY wrapper depth: the base case is
        `inplace_base`; a function passing its own parameter into a
        position its callee changes in place changes that parameter
        too (the reference's donation map, where torch's hazard is the
        opposite one: the buffer lives on, changed)."""
        if self._inplace is not None:
            return self._inplace
        mutates: Dict[str, Set[int]] = {
            k: set(v) for k, v in self.inplace_base().items()}
        changed = True
        while changed:
            changed = False
            for fkey, fi in self.index.functions.items():
                pnames = _param_list(fi)
                if not pnames:
                    continue
                for call, target in self._resolved_calls(fkey):
                    tpos = mutates.get(target)
                    if not tpos:
                        continue
                    off = _self_offset(self.index, target, call)
                    for pos in tpos:
                        apos = pos - off
                        if not (0 <= apos < len(call.args)):
                            continue
                        arg = call.args[apos]
                        if isinstance(arg, ast.Name) \
                                and arg.id in pnames and not (
                                    fi.cls is not None
                                    and arg.id == "self"):
                            ppos = pnames.index(arg.id)
                            cur = mutates.setdefault(fkey, set())
                            if ppos not in cur:
                                cur.add(ppos)
                                changed = True
        self._inplace = {k: tuple(sorted(v)) for k, v in mutates.items()}
        return self._inplace

    # ---------------------------------------------- scatter (fixpoint)
    def scatter_map(self) -> Dict[str, Tuple[int, ...]]:
        """fkey -> positional parameter indices that receive a row
        scatter (`index_put(_)`, `index_add(_)`, `scatter_add(_)` ...),
        directly or transitively, OUTSIDE a per-shard context.  Per-shard
        functions are excluded: their scatters act on one shard's local
        rows."""
        if self._scatter_map is not None:
            return self._scatter_map
        safe = self.shard_safe()
        scatter: Dict[str, Set[int]] = {}
        # config-registered helpers (kernel.delta_scatter_set / _add)
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
                tgt = scatter_base(node)
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
        out = self._calls_cache.get(fkey)
        if out is None:
            fi = self.index.functions[fkey]
            la = self.index._local_imports(fi)
            lt = self.index._local_var_types(fi)
            out = []
            for node in self.index._own_nodes(fi):
                if isinstance(node, ast.Call):
                    r = self.index.resolve_call(fi, node, la, lt)
                    if r is not None:
                        out.append((node, r))
            self._calls_cache[fkey] = out
        return iter(out)

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
                    continue        # split planes are SHARD territory
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
        # one propagation round: `self.b = self.a` splitness
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


def _arg_for(tfi: FuncInfo, call: ast.Call, pname: str):
    """The argument expression a call passes for the callee's parameter
    `pname` (positional or keyword), else None."""
    pnames = _param_list(tfi)
    off = 1 if (tfi.cls is not None and pnames and pnames[0] == "self"
                and isinstance(call.func, ast.Attribute)) else 0
    for kw in call.keywords:
        if kw.arg == pname:
            return kw.value
    try:
        pos = pnames.index(pname) - off
    except ValueError:
        return None
    if 0 <= pos < len(call.args) and not any(
            isinstance(a, ast.Starred) for a in call.args[:pos + 1]):
        return call.args[pos]
    return None


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
    cache = index._linear_cache
    nodes = cache.get(fi.key)
    if nodes is None:
        nodes = list(index._own_nodes(fi))
        nodes.sort(key=lambda n: (getattr(n, "lineno", 0),
                                  getattr(n, "col_offset", 0)))
        cache[fi.key] = nodes
    return nodes


def _comp_targets(node) -> Set[str]:
    out: Set[str] = set()
    for gen in node.generators:
        for n in ast.walk(gen.target):
            if isinstance(n, ast.Name):
                out.add(n.id)
    return out


def _splits_over_devices(comp, elt) -> bool:
    """A comprehension that moves one piece to each device: its element
    is `<x>.to(d)` (or carries `device=d`) with `d` a comprehension
    variable — the shape of `_split_rows` / `_split_cols`."""
    names = _comp_targets(comp)
    if not isinstance(elt, ast.Call):
        return False
    cands = [kw.value for kw in elt.keywords if kw.arg == "device"]
    if isinstance(elt.func, ast.Attribute) and elt.func.attr == "to" \
            and elt.args:
        cands.append(elt.args[0])
    return any(isinstance(c, ast.Name) and c.id in names for c in cands)


def scatter_base(node) -> Optional[ast.AST]:
    """`X.index_put(...)` / `X.index_add_(...)` / `X.scatter_add(...)`
    ... -> the X expression, else None."""
    if not isinstance(node, ast.Call):
        return None
    f = node.func
    if isinstance(f, ast.Attribute) and f.attr in SCATTER_METHODS:
        return f.value
    return None


def scatter_index(node: ast.Call) -> Optional[ast.AST]:
    """The index operand of a scatter call: the `indices` tuple of
    `index_put(_)`, the `index` of `index_add(_)` / `scatter*`."""
    attr = node.func.attr
    if attr.startswith("index_put") or attr in ("put_",):
        return node.args[0] if node.args else None
    if attr.startswith("masked_scatter"):
        return node.args[0] if node.args else None
    for kw in node.keywords:
        if kw.arg == "index":
            return kw.value
    return node.args[1] if len(node.args) > 1 else None
