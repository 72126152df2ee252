"""Package index + module-level call graph for nomadlint.

Everything here is pure `ast` over source text: no module in the
analyzed package is ever imported, so the analyzer runs in environments
without torch, a GPU, or the package's optional deps.

Resolution is deliberately conservative name/alias/annotation
propagation — enough to follow the call chains the passes care about
(apply handlers -> store mutators, thread roots -> the attributes they
reach, `self.attr` method dispatch through constructor-assigned or
annotation-typed attributes) without attempting full type inference.
Unresolvable calls are kept as dotted external names so deny-list
checks (time.*, random.*, ...) still see them.
"""
from __future__ import annotations

import ast
import dataclasses
import difflib
import fnmatch
import os
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

# severity tiers: "error" findings gate CI (exit 1); "warn" findings
# are advisory heuristics (exit 3 when they are the only findings).
# Everything not listed here is an error.
WARN_RULES = frozenset({"LOCK302", "SHARD403", "ALIAS503", "OBS802",
                        "RACE903"})

# rule-id prefix -> pass name (used by --json/by_pass and bench's
# lint_summary so BENCH_DETAIL records per-pass lint state)
RULE_PASSES: Tuple[Tuple[str, str], ...] = (
    ("FSM", "fsm"), ("JIT", "jit"), ("LOCK", "lock"),
    ("SHARD", "shard"), ("ALIAS", "alias"), ("SCORE", "score"),
    ("ROBUST", "robust"), ("OBS", "obs"), ("RACE", "race"),
)

# rules whose id prefix belongs to another pass: LOCK305 is produced by
# the lockset race pass (it needs the interprocedural held-set fixpoint
# the syntactic lock pass doesn't compute)
_RULE_PASS_OVERRIDES = {"LOCK305": "race"}


def severity_of(rule: str) -> str:
    return "warn" if rule in WARN_RULES else "error"


def pass_of(rule: str) -> str:
    if rule in _RULE_PASS_OVERRIDES:
        return _RULE_PASS_OVERRIDES[rule]
    for prefix, name in RULE_PASSES:
        if rule.startswith(prefix):
            return name
    return "other"


@dataclasses.dataclass(frozen=True)
class Finding:
    rule: str           # e.g. "FSM101"
    module: str         # dotted module ("nomad_tpu_torch.state.store")
    func: str           # qualname within module ("Class.method", "f.inner")
    symbol: str         # the offending name (baseline-key component)
    path: str           # file path (repo-relative where possible)
    line: int
    message: str
    hint: str = ""

    @property
    def key(self) -> str:
        """Line-number-free identity used by baseline suppressions, so
        unrelated edits don't invalidate entries."""
        return f"{self.rule}:{self.module}:{self.func}:{self.symbol}"

    @property
    def severity(self) -> str:
        return severity_of(self.rule)

    def render(self) -> str:
        loc = f"{self.path}:{self.line}"
        out = f"{loc}: {self.rule} [{self.module}:{self.func}] {self.message}"
        if self.hint:
            out += f"\n    hint: {self.hint}"
        return out


@dataclasses.dataclass
class Report:
    version: str
    findings: List[Finding]          # unsuppressed
    suppressed: List[Finding]
    stale_baseline_keys: List[str]   # baseline entries matching nothing
    # stale key -> nearest current finding key (rename forensics: a
    # mid-PR file/function rename silently strands baseline entries;
    # the nearest miss names the probable new spelling)
    stale_suggestions: Dict[str, str] = dataclasses.field(
        default_factory=dict)

    @classmethod
    def build(cls, findings: Sequence[Finding], baseline,
              version: str) -> "Report":
        if baseline is None:
            return cls(version, list(findings), [], [])
        kept, supp = [], []
        used: Set[str] = set()
        for f in findings:
            if baseline.matches(f.key):
                supp.append(f)
                used.add(baseline.match_key(f.key))
            else:
                kept.append(f)
        stale = [k for k in baseline.keys() if k not in used]
        all_keys = sorted({f.key for f in findings})
        suggestions: Dict[str, str] = {}
        for k in stale:
            near = difflib.get_close_matches(k, all_keys, n=1,
                                             cutoff=0.5)
            if near:
                suggestions[k] = near[0]
        return cls(version, kept, supp, stale, suggestions)

    def counts_by_rule(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for f in self.findings:
            out[f.rule] = out.get(f.rule, 0) + 1
        return dict(sorted(out.items()))

    def counts_by_pass(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for f in self.findings:
            p = pass_of(f.rule)
            out[p] = out.get(p, 0) + 1
        return dict(sorted(out.items()))

    @property
    def errors(self) -> List[Finding]:
        return [f for f in self.findings if f.severity == "error"]

    @property
    def warnings(self) -> List[Finding]:
        return [f for f in self.findings if f.severity == "warn"]

    @property
    def ok(self) -> bool:
        return not self.findings


@dataclasses.dataclass
class AnalysisConfig:
    """Pass configuration; tests point these at synthetic fixture
    packages."""
    # FSM pass: glob patterns over "module:qualname" naming the raft
    # apply roots, and the (module, class) of the replicated store.
    fsm_roots: Tuple[str, ...] = (
        "nomad_tpu_torch.raft.fsm:StateFSM.apply",
        "nomad_tpu_torch.raft.fsm:StateFSM._ap_*",
        "nomad_tpu_torch.raft.fsm:StateFSM.restore",
    )
    store_module: str = "nomad_tpu_torch.state.store"
    store_class: str = "StateStore"
    # Lock pass scope: the threaded server plane. Attr-write/read
    # discipline is only enforced for modules under these prefixes;
    # module-global mutation (LOCK303) is package-wide.
    lock_module_prefixes: Tuple[str, ...] = (
        "nomad_tpu_torch.server", "nomad_tpu_torch.state",
        "nomad_tpu_torch.rpc", "nomad_tpu_torch.raft",
        "nomad_tpu_torch.solver",
    )
    # JIT2xx: override of the device-root registry (None = the package
    # registry in jit_pass.DEFAULT_DEVICE_ROOTS); torch marks no device
    # program the way `jax.jit` does, so the roots are named here.
    device_roots: Optional[Tuple] = None
    # SHARD401: row-scatter helpers, as "module:qualname@param_pos" —
    # passing a plane split per shard at that position outside the
    # owner-routed path writes global rows into one shard's tensor.
    scatter_helpers: Tuple[str, ...] = (
        "nomad_tpu_torch.solver.kernel:delta_scatter_set@0",
        "nomad_tpu_torch.solver.kernel:delta_scatter_add@0",
    )
    # SCORE6xx: override of the scoring-site registry (None = the
    # package registry in score_pass.DEFAULT_SCORER_SITES); tests
    # point this at synthetic fixture backends.
    scorer_sites: Optional[Tuple] = None
    # ROBUST701 scope: recovery-critical planes where a swallowed
    # exception turns an injected fault into silent state divergence.
    robust_module_prefixes: Tuple[str, ...] = (
        "nomad_tpu_torch.raft", "nomad_tpu_torch.rpc",
        "nomad_tpu_torch.server", "nomad_tpu_torch.parallel",
        "nomad_tpu_torch.solver",
    )
    # OBS8xx: metric/series name hygiene.  Names must be lowercase
    # dotted paths whose first segment (the namespace) is registered
    # here; dynamically-built names are cardinality hazards (OBS802,
    # warn) that carry a baseline justification naming the bound.
    obs_metric_prefixes: Tuple[str, ...] = (
        "broker", "coordinator", "health", "mesh", "metrics", "plan",
        "rpc", "scheduler", "serving", "slo", "solver", "telemetry",
        "watchdog", "worker",
    )
    # the sinks themselves (name arrives as a parameter there)
    obs_exclude_modules: Tuple[str, ...] = (
        "nomad_tpu_torch.utils.metrics", "nomad_tpu_torch.telemetry.series",
    )
    # RACE9xx / LOCK305 scope: the planes whose thread-shared classes
    # get Eraser-style guarded-by inference and blocking-under-lock
    # checks (the scale-out control plane plus everything it locks).
    race_module_prefixes: Tuple[str, ...] = (
        "nomad_tpu_torch.server", "nomad_tpu_torch.state",
        "nomad_tpu_torch.rpc", "nomad_tpu_torch.raft",
        "nomad_tpu_torch.solver", "nomad_tpu_torch.scheduler.fleet",
    )
    # LOCK305: package functions that block BY CONTRACT (device solve,
    # store index waits, raft proposal round-trips, RPC) — calling one
    # with a hot-path lock held is an error even when the blocking op
    # itself hides behind a resolution boundary.  fnmatch patterns
    # over "module:qualname".
    blocking_roots: Tuple[str, ...] = (
        "nomad_tpu_torch.solver.solve:*.solve",
        "nomad_tpu_torch.solver.resident:*.solve*",
        "nomad_tpu_torch.state.store:*.wait_for_index",
        "nomad_tpu_torch.state.store:*.wait_for_change",
        "nomad_tpu_torch.raft.node:RaftNode.propose*",
        "nomad_tpu_torch.rpc.client:RpcClient.call",
        "nomad_tpu_torch.rpc.transport:*.call",
        "nomad_tpu_torch.rpc.wire:send_frame",
        "nomad_tpu_torch.rpc.wire:recv_frame",
        "nomad_tpu_torch.scheduler.fleet:process_fleet",
        "nomad_tpu_torch.scheduler.fleet:SolveCoordinator.submit",
        # pipelined hot path: the fetch/future-wait entry
        # points block until the DEVICE finishes a round — holding a
        # hot-path lock across one serializes every other worker behind
        # the solve, exactly the stall the async split exists to remove.
        "nomad_tpu_torch.solver.resident:*.finish_stream",
        "nomad_tpu_torch.solver.solve:PendingSolve.wait",
        "nomad_tpu_torch.scheduler.fleet:fleet_finish",
        "nomad_tpu_torch.scheduler.fleet:SolveCoordinator.submit_nowait",
    )


class FuncInfo:
    __slots__ = ("key", "module", "qual", "cls", "node", "path",
                 "nested", "parent")

    def __init__(self, key: str, module: str, qual: str,
                 cls: Optional[str], node: ast.AST, path: str,
                 parent: Optional[str]):
        self.key = key            # "module:qual"
        self.module = module
        self.qual = qual
        self.cls = cls            # enclosing class name, if a method
        self.node = node
        self.path = path
        self.nested: List[str] = []   # keys of directly nested defs
        self.parent = parent

    @property
    def name(self) -> str:
        return self.qual.rsplit(".", 1)[-1]


class ClassInfo:
    __slots__ = ("key", "module", "name", "node", "bases", "methods",
                 "attr_types", "attr_elem_types", "path")

    def __init__(self, key: str, module: str, name: str,
                 node: ast.ClassDef, path: str):
        self.key = key            # "module:Class"
        self.module = module
        self.name = name
        self.node = node
        self.path = path
        self.bases: List[str] = []          # resolved class keys
        self.methods: Dict[str, str] = {}   # name -> func key
        self.attr_types: Dict[str, str] = {}  # self attr -> class key
        # self attr -> ELEMENT class key for list-of-instances attrs
        # (`self._shards = [_Shard(...) for ...]`) — the sharded-
        # container composition edge
        self.attr_elem_types: Dict[str, str] = {}


class ModuleInfo:
    __slots__ = ("name", "path", "tree", "aliases", "globals")

    def __init__(self, name: str, path: str, tree: ast.Module):
        self.name = name
        self.path = path
        self.tree = tree
        # import alias -> dotted target ("_time" -> "time",
        # "X" -> "nomad_tpu_torch.structs.X")
        self.aliases: Dict[str, str] = {}
        self.globals: Set[str] = set()      # module-level assigned names


def _resolve_relative(module: str, node: ast.ImportFrom) -> str:
    """Turn `from ..a import b` inside `module` into the absolute
    source module for the import."""
    if not node.level:
        return node.module or ""
    parts = module.split(".")
    # a module's package is itself minus the last component
    base = parts[: len(parts) - node.level]
    if node.module:
        base = base + node.module.split(".")
    return ".".join(base)


def _collect_imports(module: str, body: Iterable[ast.stmt],
                     out: Dict[str, str]) -> None:
    for node in body:
        if isinstance(node, ast.Import):
            for al in node.names:
                if al.asname:
                    out[al.asname] = al.name
                else:
                    # `import a.b` binds `a`
                    head = al.name.split(".")[0]
                    out[head] = head
        elif isinstance(node, ast.ImportFrom):
            src = _resolve_relative(module, node)
            for al in node.names:
                if al.name == "*":
                    continue
                out[al.asname or al.name] = (
                    f"{src}.{al.name}" if src else al.name)


class PackageIndex:
    def __init__(self, package_name: str):
        self.package = package_name
        self.modules: Dict[str, ModuleInfo] = {}
        self.functions: Dict[str, FuncInfo] = {}
        self.classes: Dict[str, ClassInfo] = {}
        self._edges: Dict[str, Set[str]] = {}
        self._externals: Dict[str, List[Tuple[str, int]]] = {}
        # per-function walks, kept because every pass walks every body
        self._own_cache: Dict[str, List[ast.AST]] = {}
        self._linear_cache: Dict[str, List[ast.AST]] = {}
        # the device passes' generator drivers (jit_pass._scan_drivers)
        self._driver_cache: Dict[str, Dict] = {}

    # ------------------------------------------------------------ build
    @classmethod
    def build(cls, package_dir: str, package_name: str,
              cache_dir: Optional[str] = None) -> "PackageIndex":
        """Index the package.  `cache_dir` (opt-in, off in CI) enables
        the on-disk incremental cache: parsed ASTs are pickled per
        file, keyed by content hash, so an unchanged file never
        re-parses.  The key salts in the Python minor version — pickled
        ast nodes do not travel across interpreters — and any cache
        miss/corruption silently falls back to a fresh parse."""
        idx = cls(package_name)
        pkg_root = os.path.join(package_dir, package_name)
        if cache_dir:
            os.makedirs(cache_dir, exist_ok=True)
        for dirpath, dirnames, filenames in os.walk(pkg_root):
            dirnames[:] = sorted(d for d in dirnames
                                 if d != "__pycache__")
            for fn in sorted(filenames):
                if not fn.endswith(".py"):
                    continue
                path = os.path.join(dirpath, fn)
                rel = os.path.relpath(path, package_dir)
                mod = rel[:-3].replace(os.sep, ".")
                if mod.endswith(".__init__"):
                    mod = mod[: -len(".__init__")]
                with open(path, "r", encoding="utf-8") as f:
                    src = f.read()
                tree = _parse_cached(src, path, cache_dir)
                if tree is None:
                    continue
                idx._index_module(mod, rel, tree)
        idx._resolve_class_bases()
        idx._infer_attr_types()
        return idx

    def _index_module(self, mod: str, path: str, tree: ast.Module) -> None:
        mi = ModuleInfo(mod, path, tree)
        _collect_imports(mod, ast.walk(tree), mi.aliases)
        for node in tree.body:
            if isinstance(node, (ast.Assign, ast.AnnAssign, ast.AugAssign)):
                for t in (node.targets if isinstance(node, ast.Assign)
                          else [node.target]):
                    if isinstance(t, ast.Name):
                        mi.globals.add(t.id)
        self.modules[mod] = mi
        for node in tree.body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self._index_func(mi, node, qual_prefix="", cls=None,
                                 parent=None)
            elif isinstance(node, ast.ClassDef):
                ckey = f"{mod}:{node.name}"
                ci = ClassInfo(ckey, mod, node.name, node, path)
                self.classes[ckey] = ci
                for sub in node.body:
                    if isinstance(sub, (ast.FunctionDef,
                                        ast.AsyncFunctionDef)):
                        fkey = self._index_func(
                            mi, sub, qual_prefix=node.name + ".",
                            cls=node.name, parent=None)
                        ci.methods[sub.name] = fkey

    def _index_func(self, mi: ModuleInfo, node, qual_prefix: str,
                    cls: Optional[str], parent: Optional[str]) -> str:
        qual = qual_prefix + node.name
        key = f"{mi.name}:{qual}"
        if key in self.functions:        # same-name re-def (branch-local)
            key = f"{key}#{node.lineno}"
            qual = f"{qual}#{node.lineno}"
        fi = FuncInfo(key, mi.name, qual, cls, node, mi.path, parent)
        self.functions[key] = fi
        if parent is not None and parent in self.functions:
            self.functions[parent].nested.append(key)
        for sub in _direct_defs(node):
            self._index_func(mi, sub, qual_prefix=qual + ".",
                             cls=cls, parent=key)
        return key

    def _resolve_class_bases(self) -> None:
        for ci in self.classes.values():
            mi = self.modules[ci.module]
            for b in ci.node.bases:
                name = _dotted(b)
                if not name:
                    continue
                resolved = self._resolve_symbol(mi, name)
                if resolved and resolved in self.classes:
                    ci.bases.append(resolved)

    # ----------------------------------------------- attr type inference
    def _infer_attr_types(self) -> None:
        for ci in self.classes.values():
            mi = self.modules[ci.module]
            for mname, fkey in ci.methods.items():
                fn = self.functions[fkey].node
                ann: Dict[str, str] = {}
                for a in list(fn.args.args) + list(fn.args.kwonlyargs):
                    t = self._annotation_class(mi, a.annotation)
                    if t:
                        ann[a.arg] = t
                for node in ast.walk(fn):
                    if not isinstance(node, ast.Assign):
                        continue
                    for tgt in node.targets:
                        if (isinstance(tgt, ast.Attribute)
                                and isinstance(tgt.value, ast.Name)
                                and tgt.value.id == "self"):
                            t = self._expr_class(mi, ann, node.value)
                            if t:
                                ci.attr_types.setdefault(tgt.attr, t)
                            et = self._elem_class(mi, ann, node.value)
                            if et:
                                ci.attr_elem_types.setdefault(tgt.attr,
                                                              et)

    def _annotation_class(self, mi: ModuleInfo, node) -> Optional[str]:
        if node is None:
            return None
        if isinstance(node, ast.Subscript):      # Optional[X], List[X]
            return self._annotation_class(mi, node.slice)
        if isinstance(node, ast.BinOp):          # X | None
            return self._annotation_class(mi, node.left)
        if isinstance(node, ast.Constant) and isinstance(node.value, str):
            try:
                return self._annotation_class(
                    mi, ast.parse(node.value, mode="eval").body)
            except SyntaxError:
                return None
        name = _dotted(node)
        if not name:
            return None
        r = self._resolve_symbol(mi, name)
        return r if r in self.classes else None

    def _elem_class(self, mi: ModuleInfo, ann: Dict[str, str],
                    node) -> Optional[str]:
        """Element class key of a list-of-instances expression —
        `[_Shard(...) for ...]` or `[Foo(), Foo()]` — if every element
        infers to the same package class."""
        if isinstance(node, ast.ListComp):
            return self._expr_class(mi, ann, node.elt)
        if isinstance(node, ast.List) and node.elts:
            ts = {self._expr_class(mi, ann, e) for e in node.elts}
            ts.discard(None)
            if len(ts) == 1:
                return ts.pop()
        return None

    def _expr_class(self, mi: ModuleInfo, ann: Dict[str, str],
                    node) -> Optional[str]:
        """Class key of an expression's value, if inferable."""
        if isinstance(node, ast.Call):
            name = _dotted(node.func)
            if name:
                r = self._resolve_symbol(mi, name)
                if r in self.classes:
                    return r
            return None
        if isinstance(node, ast.Name):
            return ann.get(node.id)
        if isinstance(node, ast.BoolOp):         # x = store or StateStore()
            for v in node.values:
                t = self._expr_class(mi, ann, v)
                if t:
                    return t
        if isinstance(node, ast.IfExp):
            return (self._expr_class(mi, ann, node.body)
                    or self._expr_class(mi, ann, node.orelse))
        return None

    # ------------------------------------------------------- resolution
    def _resolve_symbol(self, mi: ModuleInfo, dotted: str) -> Optional[str]:
        """Resolve a dotted name in a module to a package-internal key
        ("mod:Thing") or None."""
        head, _, rest = dotted.partition(".")
        target = mi.aliases.get(head)
        if target is None:
            # plain module-level name
            if not rest and f"{mi.name}:{dotted}" in self.functions:
                return f"{mi.name}:{dotted}"
            if not rest and f"{mi.name}:{dotted}" in self.classes:
                return f"{mi.name}:{dotted}"
            return None
        full = target + ("." + rest if rest else "")
        if not full.startswith(self.package):
            return None
        # try splitting "pkg.mod.Sym" into module + symbol
        parts = full.split(".")
        for cut in range(len(parts), 0, -1):
            mod = ".".join(parts[:cut])
            if mod in self.modules:
                sym = ".".join(parts[cut:])
                if not sym:
                    return None
                for cand in (f"{mod}:{sym}",):
                    if cand in self.functions or cand in self.classes:
                        return cand
                # one more hop: re-exported through __init__ aliases
                sub = self.modules[mod].aliases.get(parts[cut])
                if sub is not None and cut + 1 <= len(parts):
                    deeper = sub + "." + ".".join(parts[cut + 1:]) \
                        if parts[cut + 1:] else sub
                    return self._resolve_dotted_abs(deeper)
                return None
        return None

    def _resolve_dotted_abs(self, full: str) -> Optional[str]:
        parts = full.split(".")
        for cut in range(len(parts), 0, -1):
            mod = ".".join(parts[:cut])
            if mod in self.modules:
                sym = ".".join(parts[cut:])
                cand = f"{mod}:{sym}"
                if cand in self.functions or cand in self.classes:
                    return cand
        return None

    def method_on(self, class_key: str, name: str) -> Optional[str]:
        """Look a method up on a class and its (package) bases."""
        seen = set()
        stack = [class_key]
        while stack:
            ck = stack.pop(0)
            if ck in seen or ck not in self.classes:
                continue
            seen.add(ck)
            ci = self.classes[ck]
            if name in ci.methods:
                return ci.methods[name]
            stack.extend(ci.bases)
        return None

    def class_of_func(self, fi: FuncInfo) -> Optional[ClassInfo]:
        if fi.cls is None:
            return None
        return self.classes.get(f"{fi.module}:{fi.cls}")

    def _local_imports(self, fi: FuncInfo) -> Dict[str, str]:
        cache = getattr(self, "_li_cache", None)
        if cache is None:
            cache = self._li_cache = {}
        out = cache.get(fi.key)
        if out is None:
            out = {}
            _collect_imports(fi.module, ast.walk(fi.node), out)
            cache[fi.key] = out
        return out

    def _param_annotations(self, fi: FuncInfo) -> Dict[str, str]:
        mi = self.modules[fi.module]
        out: Dict[str, str] = {}
        args = fi.node.args
        for a in list(args.args) + list(args.kwonlyargs):
            t = self._annotation_class(mi, a.annotation)
            if t:
                out[a.arg] = t
        return out

    def _local_var_types(self, fi: FuncInfo) -> Dict[str, str]:
        """Single-pass local inference: `x = Cls(...)` / annotated
        params / loop vars and subscripts over self-attr containers
        with a known element class (`for s in self._shards:` /
        `s = self._shards[i]`).  The container cases keep the call
        graph honest for the fan-out-over-helpers shape: a single
        watcher thread iterating a list of shard objects is a call
        edge into the shard class, and thread-rootset propagation
        (race pass) depends on seeing it."""
        cache = getattr(self, "_lvt_cache", None)
        if cache is None:
            cache = self._lvt_cache = {}
        cached = cache.get(fi.key)
        if cached is not None:
            return cached
        mi = self.modules[fi.module]
        ci = self.class_of_func(fi)
        ann = self._param_annotations(fi)
        out = dict(ann)
        for node in ast.walk(fi.node):
            tgt = val = None
            elem_only = False
            if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                    and isinstance(node.targets[0], ast.Name):
                tgt, val = node.targets[0].id, node.value
            elif isinstance(node, ast.AnnAssign) \
                    and isinstance(node.target, ast.Name):
                # an annotated local names its class where the value
                # cannot (`c: Optional["Coordinator"] = getattr(...)`)
                t = self._annotation_class(mi, node.annotation)
                if t:
                    out.setdefault(node.target.id, t)
                continue
            elif isinstance(node, ast.For):
                it = node.iter
                if isinstance(it, ast.Call) \
                        and isinstance(it.func, ast.Name) \
                        and it.func.id == "enumerate" and it.args:
                    it = it.args[0]
                    if isinstance(node.target, ast.Tuple) \
                            and len(node.target.elts) == 2 \
                            and isinstance(node.target.elts[1], ast.Name):
                        tgt = node.target.elts[1].id
                elif isinstance(node.target, ast.Name):
                    tgt = node.target.id
                val, elem_only = it, True
            if tgt is None or val is None:
                continue
            t = None if elem_only else self._expr_class(mi, ann, val)
            if t is None and ci is not None:
                base = val.value if isinstance(val, ast.Subscript) else \
                    (val if elem_only else None)
                if isinstance(base, ast.Attribute) \
                        and isinstance(base.value, ast.Name) \
                        and base.value.id == "self":
                    t = self._attr_elem_type(ci, base.attr)
            if t:
                out.setdefault(tgt, t)
        cache[fi.key] = out
        return out

    def resolve_call(self, fi: FuncInfo, call: ast.Call,
                     local_aliases: Optional[Dict[str, str]] = None,
                     local_types: Optional[Dict[str, str]] = None
                     ) -> Optional[str]:
        """Internal func key a call resolves to, or None."""
        mi = self.modules[fi.module]
        fnode = call.func
        ci = self.class_of_func(fi)
        if isinstance(fnode, ast.Name):
            # nested def in the enclosing scope chain
            cur: Optional[FuncInfo] = fi
            while cur is not None:
                for nk in cur.nested:
                    if self.functions[nk].name == fnode.id:
                        return nk
                cur = (self.functions.get(cur.parent)
                       if cur.parent else None)
            if local_aliases and fnode.id in local_aliases:
                full = local_aliases[fnode.id]
                if full.startswith(self.package):
                    r = self._resolve_dotted_abs(full)
                    if r:
                        return self._callable_target(r)
            r = self._resolve_symbol(mi, fnode.id)
            if r:
                return self._callable_target(r)
            return None
        if isinstance(fnode, ast.Attribute):
            base = fnode.value
            meth = fnode.attr
            # self.m()
            if isinstance(base, ast.Name) and base.id == "self" and ci:
                return self.method_on(ci.key, meth)
            # self.attr.m()
            if (isinstance(base, ast.Attribute)
                    and isinstance(base.value, ast.Name)
                    and base.value.id == "self" and ci):
                t = self._attr_type(ci, base.attr)
                if t:
                    return self.method_on(t, meth)
                return None
            # self.attr[i].m() — container of known element class
            if (isinstance(base, ast.Subscript)
                    and isinstance(base.value, ast.Attribute)
                    and isinstance(base.value.value, ast.Name)
                    and base.value.value.id == "self" and ci):
                t = self._attr_elem_type(ci, base.value.attr)
                if t:
                    return self.method_on(t, meth)
                return None
            # var.m() / alias.m() / alias.sub.m()
            name = _dotted(fnode)
            if name:
                head = name.split(".")[0]
                if local_types and head in local_types and "." not in \
                        name[len(head) + 1:]:
                    return self.method_on(local_types[head], meth)
                for amap in (local_aliases or {}, mi.aliases):
                    if head in amap:
                        full = amap[head] + name[len(head):]
                        if full.startswith(self.package):
                            r = self._resolve_dotted_abs(full)
                            if r:
                                return self._callable_target(r)
                        return None
        return None

    def _attr_type(self, ci: ClassInfo, attr: str) -> Optional[str]:
        seen = set()
        stack = [ci.key]
        while stack:
            ck = stack.pop(0)
            if ck in seen or ck not in self.classes:
                continue
            seen.add(ck)
            c = self.classes[ck]
            if attr in c.attr_types:
                return c.attr_types[attr]
            stack.extend(c.bases)
        return None

    def _attr_elem_type(self, ci: ClassInfo, attr: str) -> Optional[str]:
        """Element class of a self-attr container (mro walk), mirroring
        `_attr_type` for `attr_elem_types`."""
        seen = set()
        stack = [ci.key]
        while stack:
            ck = stack.pop(0)
            if ck in seen or ck not in self.classes:
                continue
            seen.add(ck)
            c = self.classes[ck]
            if attr in c.attr_elem_types:
                return c.attr_elem_types[attr]
            stack.extend(c.bases)
        return None

    def _callable_target(self, key: str) -> Optional[str]:
        if key in self.functions:
            return key
        if key in self.classes:                 # instantiation
            return self.method_on(key, "__init__")
        return None

    # ------------------------------------------------------- call graph
    def callees(self, fkey: str) -> Set[str]:
        cached = self._edges.get(fkey)
        if cached is not None:
            return cached
        fi = self.functions[fkey]
        la = self._local_imports(fi)
        lt = self._local_var_types(fi)
        out: Set[str] = set(fi.nested)   # tracing/threads run nested defs
        for node in self._own_nodes(fi):
            if isinstance(node, ast.Call):
                r = self.resolve_call(fi, node, la, lt)
                if r:
                    out.add(r)
        self._edges[fkey] = out
        return out

    def _own_nodes(self, fi: FuncInfo):
        """Walk a function body EXCLUDING nested function/class bodies
        (nested defs have their own FuncInfo).  The walk is computed
        once per function: every pass walks every body, several
        times."""
        cache = self._own_cache
        nodes = cache.get(fi.key)
        if nodes is None:
            nodes = []
            stack: List[ast.AST] = [fi.node]
            while stack:
                node = stack.pop()
                if node is not fi.node and isinstance(
                        node, (ast.FunctionDef, ast.AsyncFunctionDef,
                               ast.ClassDef)):
                    continue
                nodes.append(node)
                stack.extend(ast.iter_child_nodes(node))
            cache[fi.key] = nodes
        return iter(nodes)

    def external_calls(self, fkey: str) -> List[Tuple[str, int]]:
        """(dotted-name, lineno) for every call whose base resolves
        outside the package (through import aliases), plus builtins."""
        cached = self._externals.get(fkey)
        if cached is not None:
            return cached
        fi = self.functions[fkey]
        mi = self.modules[fi.module]
        la = self._local_imports(fi)
        out: List[Tuple[str, int]] = []
        for node in self._own_nodes(fi):
            if not isinstance(node, ast.Call):
                continue
            name = _dotted(node.func)
            if not name:
                continue
            head, _, rest = name.partition(".")
            target = la.get(head) or mi.aliases.get(head)
            if target is not None:
                full = target + ("." + rest if rest else "")
                if not full.startswith(self.package):
                    out.append((full, node.lineno))
            elif "." not in name and f"{mi.name}:{name}" not in \
                    self.functions and f"{mi.name}:{name}" not in \
                    self.classes:
                out.append((name, node.lineno))   # builtin-ish
        self._externals[fkey] = out
        return out

    def reachable(self, roots: Iterable[str]) -> Set[str]:
        seen: Set[str] = set()
        stack = [r for r in roots if r in self.functions]
        while stack:
            k = stack.pop()
            if k in seen:
                continue
            seen.add(k)
            stack.extend(self.callees(k) - seen)
        return seen

    def match_funcs(self, patterns: Sequence[str]) -> List[str]:
        out = []
        for k in self.functions:
            base = k.split("#")[0]
            if any(fnmatch.fnmatchcase(base, p) for p in patterns):
                out.append(k)
        return sorted(out)


def _parse_cached(src: str, path: str,
                  cache_dir: Optional[str]) -> Optional[ast.Module]:
    """ast.parse with an optional content-hash-keyed pickle cache."""
    if not cache_dir:
        try:
            return ast.parse(src, filename=path)
        except SyntaxError:
            return None
    import hashlib
    import pickle
    import sys
    salt = f"py{sys.version_info[0]}.{sys.version_info[1]}|"
    digest = hashlib.sha256(
        (salt + src).encode("utf-8")).hexdigest()
    cpath = os.path.join(cache_dir, digest + ".ast.pkl")
    try:
        with open(cpath, "rb") as f:
            tree = pickle.load(f)
        if isinstance(tree, ast.Module):
            return tree
    except (OSError, pickle.PickleError, EOFError, AttributeError,
            ValueError):
        pass
    try:
        tree = ast.parse(src, filename=path)
    except SyntaxError:
        return None
    try:
        tmp = cpath + ".tmp"
        with open(tmp, "wb") as f:
            pickle.dump(tree, f, protocol=pickle.HIGHEST_PROTOCOL)
        os.replace(tmp, cpath)
    except OSError:
        pass
    return tree


def _direct_defs(node) -> List[ast.AST]:
    """Function defs DIRECTLY nested in `node`'s body (not inside a
    deeper def/class)."""
    out: List[ast.AST] = []
    stack = list(ast.iter_child_nodes(node))
    while stack:
        n = stack.pop()
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef)):
            out.append(n)
            continue
        if isinstance(n, ast.ClassDef):
            continue
        stack.extend(ast.iter_child_nodes(n))
    out.sort(key=lambda n: n.lineno)
    return out


def _dotted(node) -> Optional[str]:
    """a.b.c -> "a.b.c" for pure Name/Attribute chains."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def with_lock_names(node: ast.With) -> List[str]:
    """Lock-ish names acquired by a with statement: `with self._lock:`
    -> "self._lock", `with _CACHE_LOCK:` -> "_CACHE_LOCK"."""
    out = []
    for item in node.items:
        d = _dotted(item.context_expr)
        if d:
            out.append(d)
        elif isinstance(item.context_expr, ast.Call):
            d = _dotted(item.context_expr.func)
            if d:
                out.append(d)
    return out
