"""Pass 6: scoring-spec conformance (SCORE6xx, v3).

The exact scorer used to be replicated float-order-exact in five hand
backends, held identical only by backend-vs-backend drift fingerprints
(v2 of this pass).  `nomad_tpu_torch/solver/score_spec.py` is now the single
declarative source of truth: each term carries its exact float-op
sequence, constants and combine order, and the backends split in two:

  * DRIVEN — the host twin (`host.host_solve_kernel.group_scores`)
    and the jit wave scorer (`kernel._wave_scores`) call
    `score_spec.evaluate_wave`; they are bit-identical to the spec by
    construction and must contain NO scoring arithmetic of their own.
  * HAND, SPEC-VERIFIED — the shortlist VMEM twin
    (`kernel._sl_eval`), the pallas fused pass (`_wave_tile_kernel`)
    and the native C++ engine (`host_solve.cc`) stay hand-written for
    performance; this pass compiles the spec into per-term reference
    fingerprints and statically proves each of them implements the
    spec.

The spec registry (`score_spec.TERMS`) is a pure literal read with
`ast.literal_eval` — the analyzer never imports the solver.  Each
entry names the reference term function, the fingerprint groups
(group -> the assignment-target aliases backends may use), whether a
group compares as a constant SET only (loop structure genuinely
differs per backend), and exactly which backends must implement it.

A term fingerprint is the multiset of float CONSTANTS plus the counts
of arithmetic ops (+ - * / ** neg) in the group's assignments — leaf
variable names, indexing and where/select CONDITIONS are excluded
(they legitimately differ between vectorized numpy, pallas refs and
scalar C++), cast wrappers (`f32(...)`, `.astype(...)`) are
transparent.  The native backend is tokenized from C++ source with a
small translation layer (`std::pow` -> `**`,
`std::min(std::max(x,a),b)` -> `clip`, ternaries drop their condition
like `where`, bool-to-float coercions fold away, subscripts are
stripped).

Rules
  SCORE601  a backend's term fingerprint diverges from the SPEC
            reference (or a spec-driven backend carries hand scoring
            arithmetic — by construction that IS drift-vs-spec)
  SCORE602  scoring-shaped arithmetic outside the spec and the
            registered sites: an assignment combining two or more
            registered score terms (the "new term hand-added in one
            backend" shape) — move it into the spec / a registered
            site
  SCORE603  a registered site no longer resolves, or the spec registry
            itself is missing/unparseable (registry rot: the
            conformance check would go silently blind) (error tier;
            baseline with a justification for intentional removals)
  SCORE604  spec/backend coverage drift: a backend misses a spec term
            it is registered for, implements a term it is NOT
            registered for, a term names an unknown backend, or a
            driven backend no longer calls the spec term loop

Configs without a spec-kind site row (fixtures, older registries)
fall back to the v2 behavior: the first registered site is the drift
reference and terms are grouped by the built-in TERM_NAMES map.
"""
from __future__ import annotations

import ast
import dataclasses
import fnmatch
import os
import re
from typing import Dict, List, Optional, Sequence, Set, Tuple

from .core import AnalysisConfig, Finding, FuncInfo, PackageIndex, \
    _dotted

# ---------------------------------------------------------- registry
@dataclasses.dataclass(frozen=True)
class ScorerSite:
    backend: str          # "spec" | "host" | "kernel" | ...
    kind: str             # "spec" | "driven" | "python" | "native"
    site: str             # spec: the spec MODULE name; python/driven:
                          # "module:qualname" fnmatch pattern; native:
                          # a package-relative source path
    terms: Tuple[str, ...] = ()   # v2 path only: terms this backend
                                  # must carry; empty = DEFAULT_TERMS
    scope: Tuple[str, ...] = ()   # native only: the functions the
                                  # fingerprint is limited to (empty =
                                  # the section markers, else the file)


#: the spec module every v3 registry row is verified against
SPEC_MODULE = "nomad_tpu_torch.solver.score_spec"
#: the term-loop entry point every DRIVEN backend must call
DRIVEN_ENTRY = "evaluate_wave"

DEFAULT_TERMS = ("free", "binpack", "anti", "pen", "n_scorers",
                 "total", "spread")

#: the scoring-site registry: the spec row is the reference; "driven"
#: rows must defer to it, "python"/"native" rows are hand replicas
#: verified against it.  Adding a backend scorer = adding a row here
#: AND listing the backend in the relevant score_spec.TERMS entries;
#: writing scoring arithmetic anywhere else trips SCORE602.
DEFAULT_SCORER_SITES: Tuple[ScorerSite, ...] = (
    ScorerSite("spec", "spec", SPEC_MODULE),
    ScorerSite("host", "driven",
               "nomad_tpu_torch.solver.host:host_solve_kernel.group_scores"),
    ScorerSite("kernel", "driven",
               "nomad_tpu_torch.solver.kernel:_wave_scores"),
    ScorerSite("shortlist", "python",
               "nomad_tpu_torch.solver.kernel:_sl_eval"),
    # the fused wave kernel ("pallas" in score_spec.TERMS): its one copy
    # of the scoring, the CUDA device functions that score a pair
    ScorerSite("pallas", "python",
               "nomad_tpu_torch.solver.wave_kernel:fused_wave_plain"),
    ScorerSite("pallas", "native",
               os.path.join("nomad_tpu_torch", "solver", "csrc",
                            "wave_kernel.cu"),
               scope=("spread_params", "spread_contrib", "score_pair")),
    ScorerSite("native", "native",
               os.path.join("nomad_tpu_torch", "solver", "native",
                            "host_solve.cc")),
)

# v2 fallback: canonical term -> assignment-target names (the v3 path
# derives this mapping from score_spec.TERMS instead)
TERM_NAMES: Dict[str, Tuple[str, ...]] = {
    "free": ("free_cpu", "free_mem"),
    "binpack": ("raw", "binpack"),
    "anti": ("anti",),
    "pen": ("pen", "pen_score", "pen_sc"),
    "n_scorers": ("n_scorers",),
    "total": ("total",),
    "spread": ("cur", "boost", "targeted", "delta_boost", "even",
               "contrib", "spread_total", "sp_total", "minc", "maxc",
               "desired"),
}
# terms compared as {const set} only (loop structure differs/backend)
CONST_SET_TERMS = {"spread"}

# where/select-family calls whose FIRST argument is a condition
_COND_CALLS = {"where", "select"}
# calls that are the power operator spelled as a function
_POW_CALLS = {"pow", "power"}
# calls that are transparent casts
_CAST_CALLS = {"f32", "float32", "int32", "astype", "asarray", "int8",
               "int16", "uint32", "u32", "i32", "float", "f64",
               "float64", "bool_"}
# composite term names whose co-occurrence outside a registered site
# is scoring-shaped arithmetic (SCORE602)
_COMPOSITE_NAMES = {"binpack", "anti", "pen", "pen_score", "pen_sc",
                    "aff_score", "aff_sc", "spread_total", "sp_total",
                    "n_scorers"}


@dataclasses.dataclass
class TermPrint:
    consts: Tuple[float, ...] = ()       # sorted multiset
    ops: Tuple[Tuple[str, int], ...] = ()  # sorted (op, count)
    const_set: Tuple[float, ...] = ()    # sorted set (spread policy)

    def describe(self) -> str:
        ops = ", ".join(f"{o}x{n}" for o, n in self.ops) or "-"
        return f"ops[{ops}] consts{list(self.consts)}"

    def empty(self) -> bool:
        return not self.consts and not self.ops


# ====================================================== python extract
class _PyPrinter:
    """Collect one term-group fingerprint from python assignment
    expressions."""

    def __init__(self):
        self.consts: List[float] = []
        self.ops: Dict[str, int] = {}

    def feed(self, node) -> None:
        self._walk(node)

    def _op(self, name: str) -> None:
        self.ops[name] = self.ops.get(name, 0) + 1

    def _walk(self, node) -> None:
        if node is None:
            return
        if isinstance(node, ast.Constant):
            if isinstance(node.value, (int, float)) \
                    and not isinstance(node.value, bool):
                self.consts.append(float(node.value))
            return
        if isinstance(node, ast.UnaryOp) and isinstance(node.op,
                                                        ast.USub):
            # fold -1.0 into a constant; keep neg as an op otherwise
            if isinstance(node.operand, ast.Constant) and isinstance(
                    node.operand.value, (int, float)):
                self.consts.append(-float(node.operand.value))
                return
            self._op("neg")
            self._walk(node.operand)
            return
        if isinstance(node, ast.BinOp):
            opname = {ast.Add: "add", ast.Sub: "sub", ast.Mult: "mul",
                      ast.Div: "div", ast.Pow: "pow"}.get(
                          type(node.op))
            if opname:
                self._op(opname)
            self._walk(node.left)
            self._walk(node.right)
            return
        if isinstance(node, ast.Call):
            name = _dotted(node.func) or ""
            last = name.rsplit(".", 1)[-1]
            if not last and isinstance(node.func, ast.Attribute):
                # method on a non-trivial expression, e.g.
                # `(a + b).astype(f32)` — _dotted can't chain it
                last = node.func.attr
            if last in _CAST_CALLS:
                # transparent: f32(20.0) -> 20.0, x.astype(f32) -> x
                if isinstance(node.func, ast.Attribute) \
                        and last == "astype":
                    self._walk(node.func.value)
                    return
                for a in node.args:
                    self._walk(a)
                return
            if last in _POW_CALLS:
                # torch.pow(x, y) / np.power(x, y) spell `x ** y`
                self._op("pow")
            args = node.args
            if last in _COND_CALLS and args:
                args = args[1:]          # drop the condition
            for a in args:
                self._walk(a)
            for kw in node.keywords:
                if kw.arg not in ("axis", "keepdims", "dtype",
                                  "num_keys", "mode"):
                    self._walk(kw.value)
            return
        if isinstance(node, ast.Subscript):
            # indexing is layout plumbing, not scoring structure
            self._walk(node.value)
            return
        if isinstance(node, (ast.Name, ast.Attribute, ast.Compare,
                             ast.BoolOp)):
            # leaves and conditions are excluded by design
            return
        if isinstance(node, ast.IfExp):
            self._walk(node.body)
            self._walk(node.orelse)
            return
        for child in ast.iter_child_nodes(node):
            self._walk(child)


def _collect_assigns(index: PackageIndex, fi: FuncInfo,
                     names: Tuple[str, ...], nested: bool
                     ) -> List[ast.AST]:
    out: List[ast.AST] = []
    keys = [fi.key]
    while keys:
        cur = index.functions[keys.pop(0)]
        for node in index._own_nodes(cur):
            tgt = None
            if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                    and isinstance(node.targets[0], ast.Name):
                tgt = node.targets[0].id
            elif isinstance(node, ast.AugAssign) and isinstance(
                    node.target, ast.Name):
                tgt = node.target.id
            if tgt in names:
                out.append(node)
        if nested:
            keys.extend(cur.nested)
    return out


def _term_assignments(index: PackageIndex, fi: FuncInfo,
                      names: Tuple[str, ...]) -> List[ast.AST]:
    """Assignments to any of `names` in the site function INCLUDING its
    nested helper defs (kernel's spread lives in a nested
    `one_spread`); when a term is not defined there at all, climb the
    enclosing-def chain own-nodes-only (host's `pen_score` lives in
    host_solve_kernel's scope, one level above group_scores — own
    nodes only, so a sibling nested scorer is not double-collected)."""
    out = _collect_assigns(index, fi, names, nested=True)
    cur: Optional[FuncInfo] = fi
    while not out and cur is not None and cur.parent:
        cur = index.functions.get(cur.parent)
        if cur is None:
            break
        out = _collect_assigns(index, cur, names, nested=False)
    return out


def _print_nodes(nodes: Sequence[ast.AST]) -> TermPrint:
    p = _PyPrinter()
    for node in nodes:
        p.feed(node.value)
        if isinstance(node, ast.AugAssign):
            p._op({ast.Add: "add", ast.Sub: "sub",
                   ast.Mult: "mul", ast.Div: "div"}.get(
                       type(node.op), "add"))
    return TermPrint(consts=tuple(sorted(p.consts)),
                     ops=tuple(sorted(p.ops.items())),
                     const_set=tuple(sorted(set(p.consts))))


def python_fingerprint(index: PackageIndex, fi: FuncInfo,
                       terms: Sequence[str],
                       names: Optional[Dict[str, Tuple[str, ...]]]
                       = None) -> Dict[str, TermPrint]:
    names = names or TERM_NAMES
    prints: Dict[str, TermPrint] = {}
    for term in terms:
        nodes = _term_assignments(index, fi, tuple(names[term]))
        if not nodes:
            continue
        prints[term] = _print_nodes(nodes)
    return prints


# ====================================================== spec registry
def load_spec_literal(index: PackageIndex, module: str, name: str):
    """Evaluate a module-level pure-literal assignment (TERMS /
    SPEC_VERSION) from the spec module's AST — never imports it."""
    mi = index.modules.get(module)
    if mi is None:
        return None
    for node in mi.tree.body:
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name) \
                and node.targets[0].id == name:
            try:
                return ast.literal_eval(node.value)
            except (ValueError, SyntaxError, TypeError):
                return None
    return None


def spec_reference(index: PackageIndex, module: str = SPEC_MODULE):
    """Compile the spec into its reference fingerprints.

    Returns (terms_reg, prints, names_map, const_set_groups, errors):
    `terms_reg` the parsed TERMS literal, `prints` group -> TermPrint
    fingerprinted from the registered term functions, `names_map`
    group -> backend assignment-target aliases, `errors` human
    strings for anything that failed to resolve (registry rot)."""
    errors: List[str] = []
    terms_reg = load_spec_literal(index, module, "TERMS")
    if not terms_reg:
        return None, {}, {}, set(), [
            f"spec registry `{module}.TERMS` missing or not a pure "
            "literal"]
    prints: Dict[str, TermPrint] = {}
    names_map: Dict[str, Tuple[str, ...]] = {}
    const_set_groups: Set[str] = set()
    for entry in terms_reg:
        fkey = f"{module}:{entry['fn']}"
        fi = index.functions.get(fkey)
        if fi is None and entry.get("groups"):
            errors.append(
                f"spec term `{entry['name']}` names function "
                f"`{entry['fn']}` which does not exist in {module}")
            continue
        for group, aliases in (entry.get("groups") or {}).items():
            names_map[group] = tuple(aliases)
            if entry.get("const_set"):
                const_set_groups.add(group)
            nodes = _collect_assigns(index, fi, tuple(aliases),
                                     nested=True)
            prints[group] = _print_nodes(nodes)
    return terms_reg, prints, names_map, const_set_groups, errors


# ====================================================== native extract
_C_FLOAT = re.compile(r"(?<![\w.])(-?\d+(?:\.\d*)?(?:e-?\d+)?)f?\b")
_C_STMT = re.compile(
    r"(?:const\s+)?(?:float|double|auto)?\s*"
    r"(?P<name>\w+)\s*(?P<aug>[+\-*/]?)=\s*(?P<rhs>[^;]+);")


def _c_statements(src: str) -> List[Tuple[str, str, str]]:
    """(name, augop, rhs) for every simple assignment statement, with
    line comments stripped and continuation lines joined."""
    src = re.sub(r"//[^\n]*", "", src)
    src = re.sub(r"\s+", " ", src)
    return [(m.group("name"), m.group("aug"), m.group("rhs"))
            for m in _C_STMT.finditer(src)]


def _c_normalize(rhs: str) -> str:
    """Translate C++ scoring idioms onto the python canonical form."""
    # subscripts are plumbing: strip [...] including nested ones
    prev = None
    while prev != rhs:
        prev = rhs
        rhs = re.sub(r"\[[^\[\]]*\]", "", rhs)
    # bool->float coercions fold away like implicit casts, of a flag
    # or of a comparison (`(aff != 0.0f ? 1.0f : 0.0f)`)
    rhs = re.sub(r"\(\s*\w+\s*\?\s*1\.0f?\s*:\s*0\.0f?\s*\)", "B", rhs)
    rhs = re.sub(r"\(\s*\w+\s*[!=<>]=?\s*[\w.]+\s*\?\s*1\.0f?\s*:"
                 r"\s*0\.0f?\s*\)", "B", rhs)
    # clip spelled as min(max(x, lo), hi)
    rhs = re.sub(
        r"std::min\s*\(\s*std::max\s*\(([^,]+),([^)]+)\)\s*,([^)]+)\)",
        r"clip(\1,\2,\3)", rhs)
    # the CUDA single-precision spellings: fminf / fmaxf / powf / floorf
    rhs = re.sub(
        r"\bfminf\s*\(\s*fmaxf\s*\(([^,]+),([^)]+)\)\s*,([^)]+)\)",
        r"clip(\1,\2,\3)", rhs)
    rhs = re.sub(r"\bpowf\b", "POW", rhs)
    rhs = re.sub(r"\bfloorf\b", "floor", rhs)
    rhs = re.sub(r"\bfmaxf\b", "MAXF", rhs)
    rhs = re.sub(r"\bfminf\b", "MINF", rhs)
    rhs = rhs.replace("std::pow", "POW").replace("std::floor", "floor")
    rhs = rhs.replace("std::max", "MAXF").replace("std::min", "MINF")
    return rhs


def _c_term_print(stmts: List[Tuple[str, str, str]],
                  names: Tuple[str, ...], term: str) -> TermPrint:
    consts: List[float] = []
    ops: Dict[str, int] = {}

    def add_op(name, n=1):
        ops[name] = ops.get(name, 0) + n

    for name, aug, rhs in stmts:
        if name not in names:
            continue
        rhs = _c_normalize(rhs)
        # ternary: drop the condition (like where)
        if "?" in rhs:
            cond, _, branches = rhs.partition("?")
            rhs = branches.replace(":", " ")
        if aug:
            add_op({"+": "add", "-": "sub", "*": "mul",
                    "/": "div"}[aug])
        # constants (before op counting so signs bind to numbers)
        for m in _C_FLOAT.finditer(rhs):
            consts.append(float(m.group(1)))
        body = _C_FLOAT.sub("C", rhs)
        add_op("pow", body.count("POW"))
        body = body.replace("POW", "")
        # unary minus: only when no operand precedes it (start of the
        # expression or right after an opener/separator); a minus
        # after an operand is the binary sub counted below
        for m in re.finditer(r"(?:^|[(,?:=])\s*-\s*(?=[A-Za-z_(])",
                             body.strip()):
            add_op("neg")
        # binary ops: a token on each side
        for opch, opname in (("+", "add"), ("*", "mul"),
                             ("/", "div")):
            add_op(opname, len(re.findall(
                re.escape(opch) if opch != "+" else r"(?<!\+)\+(?!\+)",
                body)))
        # binary minus: preceded by an identifier/paren/constant
        add_op("sub", len(re.findall(r"(?<=[\w)C])\s*-\s*(?=[\w(C])",
                                     body)))
    # neg got double-counted as sub when preceded by '(' -> already
    # excluded by the lookbehind; pow args contribute their own consts
    zero = {k: v for k, v in ops.items() if v}
    return TermPrint(consts=tuple(sorted(consts)),
                     ops=tuple(sorted(zero.items())),
                     const_set=tuple(sorted(set(consts))))


def _c_function_bodies(src: str, scope: Sequence[str]) -> str:
    """The bodies of the named C / CUDA functions (qualifiers such as
    `__device__ __forceinline__` and template heads are skipped with the
    signature), joined in the order given; a name that is not defined
    contributes nothing."""
    out: List[str] = []
    for name in scope:
        for m in re.finditer(r"\b%s\s*\(" % re.escape(name), src):
            # a definition: the parameter list closes, then a body opens
            depth, i = 0, m.end() - 1
            while i < len(src):
                depth += {"(": 1, ")": -1}.get(src[i], 0)
                i += 1
                if depth == 0:
                    break
            rest = src[i:]
            head = re.match(r"\s*(?:const\s*)?\{", rest)
            if not head:
                continue
            j = i + head.end()
            depth = 1
            k = j
            while k < len(src) and depth:
                depth += {"{": 1, "}": -1}.get(src[k], 0)
                k += 1
            out.append(src[j:k - 1])
            break
    return "\n".join(out)


def native_fingerprint(path: str, terms: Sequence[str],
                       names: Optional[Dict[str, Tuple[str, ...]]]
                       = None, scope: Sequence[str] = ()
                       ) -> Dict[str, TermPrint]:
    names = names or TERM_NAMES
    with open(path, "r", encoding="utf-8") as f:
        src = f.read()
    src = re.sub(r"/\*.*?\*/", "", src, flags=re.S)
    src = re.sub(r"//[^\n]*", "", src) if scope else src
    if scope:
        # scope to the named scoring functions (a CUDA kernel's device
        # helpers): the kernel bodies around them reuse the term names
        # for loads and scratch
        src = _c_function_bodies(src, scope)
    else:
        # scope to the scoring region when the source carries the
        # standard section markers, so same-named scratch vars elsewhere
        # (top-k scratch `score`, commit loops) don't pollute the
        # fingerprint
        lo = src.find("batched scoring")
        hi = src.find("per-group top-k")
        if 0 <= lo < hi:
            src = src[lo:hi]
    stmts = _c_statements(src)
    out: Dict[str, TermPrint] = {}
    for term in terms:
        tp = _c_term_print(stmts, tuple(names[term]), term)
        if tp.consts or tp.ops:
            out[term] = tp
    return out


# ============================================================== pass
def run_score_pass(index: PackageIndex, cfg: AnalysisConfig,
                   package_dir: Optional[str] = None
                   ) -> List[Finding]:
    sites = getattr(cfg, "scorer_sites", None) or DEFAULT_SCORER_SITES
    spec_sites = [s for s in sites if s.kind == "spec"]
    findings: List[Finding] = []
    site_fn_patterns: List[str] = []
    for site in sites:
        if site.kind == "spec":
            site_fn_patterns.append(site.site + ":*")
        elif site.kind in ("python", "driven"):
            site_fn_patterns.append(site.site)

    if spec_sites:
        findings += _spec_conformance(index, sites, spec_sites[0],
                                      package_dir)
    else:
        findings += _legacy_drift(index, sites, package_dir)

    # ---- SCORE602: scoring-shaped arithmetic outside the registry
    for fkey, fi in sorted(index.functions.items()):
        base = fkey.split("#")[0]
        if any(fnmatch.fnmatchcase(base, p) or
               fnmatch.fnmatchcase(_parent_chain(index, fi), p)
               for p in site_fn_patterns):
            continue
        if fi.module.startswith("nomad_tpu_torch.analysis"):
            continue
        for node in index._own_nodes(fi):
            if not isinstance(node, (ast.Assign, ast.AugAssign)):
                continue
            val = node.value
            used: Set[str] = set()
            for sub in ast.walk(val):
                if isinstance(sub, ast.Name) \
                        and sub.id in _COMPOSITE_NAMES:
                    used.add(sub.id)
                elif isinstance(sub, ast.Attribute) \
                        and sub.attr in _COMPOSITE_NAMES:
                    used.add(sub.attr)
            if len(used) >= 2:
                findings.append(Finding(
                    "SCORE602", fi.module, fi.qual,
                    "+".join(sorted(used)), fi.path, node.lineno,
                    "scoring-shaped arithmetic (combines "
                    f"{sorted(used)}) outside the registered scorer "
                    "sites; a term added here exists in ONE backend "
                    "only and the twins silently diverge",
                    hint="move the logic into the scoring spec "
                         "(solver/score_spec.py) or register the site "
                         "in analysis/score_pass.py"))
    return findings


# ------------------------------------------------------ v3: spec path
def _spec_conformance(index: PackageIndex, sites: Sequence[ScorerSite],
                      spec_site: ScorerSite,
                      package_dir: Optional[str]) -> List[Finding]:
    findings: List[Finding] = []
    terms_reg, spec_prints, names_map, const_set_groups, errors = \
        spec_reference(index, spec_site.site)
    mi = index.modules.get(spec_site.site)
    spec_path = mi.path if mi is not None else spec_site.site
    for err in errors:
        findings.append(Finding(
            "SCORE603", "-", "-", spec_site.backend, spec_path, 0,
            err + "; the spec-conformance check is blind",
            hint="fix score_spec.TERMS (it must stay a pure literal "
                 "naming existing term functions)"))
    if not terms_reg:
        return findings

    known_backends = {s.backend for s in sites}
    all_groups = tuple(names_map)
    # group -> the term entry that owns it
    group_term: Dict[str, dict] = {}
    for entry in terms_reg:
        for group in (entry.get("groups") or {}):
            group_term[group] = entry
        for b in entry.get("backends", ()):
            if b not in known_backends:
                findings.append(Finding(
                    "SCORE604", "-", "spec", entry["name"], spec_path,
                    0,
                    f"spec term `{entry['name']}` names backend `{b}` "
                    "which has no row in the scoring-site registry; "
                    "its conformance is never checked",
                    hint="add the ScorerSite row in "
                         "analysis/score_pass.py or fix the term's "
                         "backends tuple"))

    for site in sites:
        if site.kind == "spec":
            continue
        if site.kind in ("python", "driven"):
            fkeys = index.match_funcs([site.site])
            if not fkeys:
                findings.append(_stale(site))
                continue
            fi = index.functions[fkeys[0]]
            path, line = fi.path, fi.node.lineno
            if site.kind == "driven":
                findings += _check_driven(index, site, fi, all_groups,
                                          names_map)
                continue
            fp = python_fingerprint(index, fi, all_groups, names_map)
        else:
            path = site.site if os.path.isabs(site.site) else \
                os.path.join(package_dir or "", site.site)
            if not os.path.exists(path):
                findings.append(_stale(site, native=True))
                continue
            fp, line = native_fingerprint(path, all_groups,
                                          names_map, site.scope), 0
        # ---- coverage (SCORE604) + drift (SCORE601) per group
        for group in all_groups:
            entry = group_term[group]
            listed = site.backend in entry.get("backends", ())
            tp = fp.get(group)
            has = tp is not None and not tp.empty()
            if listed and not has:
                findings.append(Finding(
                    "SCORE604", "-", site.backend, group, path, line,
                    f"backend `{site.backend}` is registered for spec "
                    f"term `{entry['name']}` but carries no `{group}` "
                    "fingerprint (term missing in this backend)",
                    hint="replicate the term float-order-exactly from "
                         "score_spec, or drop the backend from the "
                         "term's backends tuple"))
                continue
            if not listed:
                if has:
                    findings.append(Finding(
                        "SCORE604", "-", site.backend, group, path,
                        line,
                        f"backend `{site.backend}` implements spec "
                        f"term `{entry['name']}` (group `{group}`) "
                        "but the term does not list it — coverage "
                        "drift: the fingerprint is never verified",
                        hint="add the backend to the term's backends "
                             "tuple in score_spec.TERMS"))
                continue
            a = spec_prints.get(group)
            if a is None:
                continue
            if group in const_set_groups:
                if set(a.const_set) != set(tp.const_set):
                    findings.append(_drift(site.backend, group, path,
                                           line, a, tp, "spec",
                                           consts_only=True))
            elif (a.consts, a.ops) != (tp.consts, tp.ops):
                findings.append(_drift(site.backend, group, path,
                                       line, a, tp, "spec"))
    return findings


def _check_driven(index: PackageIndex, site: ScorerSite, fi: FuncInfo,
                  all_groups: Tuple[str, ...],
                  names_map: Dict[str, Tuple[str, ...]]
                  ) -> List[Finding]:
    """A driven backend must (a) call the spec term loop and (b) carry
    ZERO scoring arithmetic of its own — any non-empty group
    fingerprint here is drift-vs-spec by construction."""
    findings: List[Finding] = []
    calls_spec = any(
        isinstance(n, ast.Call)
        and (_dotted(n.func) or "").rsplit(".", 1)[-1] == DRIVEN_ENTRY
        for n in ast.walk(fi.node))
    if not calls_spec:
        findings.append(Finding(
            "SCORE604", "-", site.backend, DRIVEN_ENTRY, fi.path,
            fi.node.lineno,
            f"spec-driven backend `{site.backend}` no longer calls "
            f"score_spec.{DRIVEN_ENTRY}; it is not evaluating the "
            "spec's terms at all",
            hint="drive the backend from score_spec.evaluate_wave "
                 "(or re-register it as a hand backend and replicate "
                 "every term)"))
    fp = python_fingerprint(index, fi, all_groups, names_map)
    for group, tp in sorted(fp.items()):
        if tp.empty():
            continue
        findings.append(Finding(
            "SCORE601", "-", site.backend, group, fi.path,
            fi.node.lineno,
            f"spec-driven backend `{site.backend}` carries hand "
            f"scoring arithmetic for `{group}` ({tp.describe()}); "
            "driven backends must defer every float op to score_spec "
            "(hand edits here silently drift from the spec)",
            hint="move the arithmetic into the term function in "
                 "solver/score_spec.py (both driven backends pick it "
                 "up) and delete it here"))
    return findings


def _stale(site: ScorerSite, native: bool = False) -> Finding:
    what = ("registered native scorer source"
            if native else "registered scorer site")
    return Finding(
        "SCORE603", "-", "-", site.backend, site.site, 0,
        f"{what} `{site.site}` (backend {site.backend}) resolves to "
        "nothing; the spec-conformance check is blind to this backend",
        hint="update the registry entry in analysis/score_pass.py (or "
             "AnalysisConfig.scorer_sites) after renaming the scorer; "
             "baseline with a justification for intentional removals")


# ------------------------------------------------- v2: legacy fallback
def _legacy_drift(index: PackageIndex, sites: Sequence[ScorerSite],
                  package_dir: Optional[str]) -> List[Finding]:
    findings: List[Finding] = []
    prints: List[Tuple[ScorerSite, str, Dict[str, TermPrint],
                       str, int]] = []
    for site in sites:
        terms = site.terms or DEFAULT_TERMS
        if site.kind == "python":
            fkeys = index.match_funcs([site.site])
            if not fkeys:
                findings.append(_stale(site))
                continue
            fi = index.functions[fkeys[0]]
            fp = python_fingerprint(index, fi, terms)
            prints.append((site, site.backend, fp, fi.path,
                           fi.node.lineno))
        else:
            path = site.site if os.path.isabs(site.site) else \
                os.path.join(package_dir or "", site.site)
            if not os.path.exists(path):
                findings.append(_stale(site, native=True))
                continue
            fp = native_fingerprint(path, terms, scope=site.scope)
            prints.append((site, site.backend, fp, site.site, 0))

    # ---- SCORE601: compare every backend against the reference
    if prints:
        ref_site, ref_name, ref_fp, ref_path, _ = prints[0]
        for site, backend, fp, path, line in prints[1:]:
            terms = site.terms or DEFAULT_TERMS
            for term in terms:
                a = ref_fp.get(term)
                b = fp.get(term)
                if a is None:
                    continue          # reference doesn't carry it
                if b is None:
                    findings.append(Finding(
                        "SCORE601", "-", backend, term, path, line,
                        f"backend `{backend}` is missing scoring term "
                        f"`{term}` (reference backend `{ref_name}` "
                        "carries it)",
                        hint="replicate the term float-order-exactly "
                             "or register the backend with an "
                             "explicit reduced term list"))
                    continue
                if term in CONST_SET_TERMS:
                    if set(a.const_set) != set(b.const_set):
                        findings.append(_drift(backend, term, path,
                                               line, a, b, ref_name,
                                               consts_only=True))
                elif (a.consts, a.ops) != (b.consts, b.ops):
                    findings.append(_drift(backend, term, path, line,
                                           a, b, ref_name))
    return findings


def _parent_chain(index: PackageIndex, fi: FuncInfo) -> str:
    """module:qual of the OUTERMOST enclosing def, so nested helpers of
    a registered site count as inside it."""
    cur = fi
    while cur.parent and cur.parent in index.functions:
        cur = index.functions[cur.parent]
    return cur.key.split("#")[0]


def _drift(backend: str, term: str, path: str, line: int,
           a: TermPrint, b: TermPrint, ref: str,
           consts_only: bool = False) -> Finding:
    what = ("constant set" if consts_only
            else "float-op fingerprint")
    return Finding(
        "SCORE601", "-", backend, term, path, line,
        f"scoring term `{term}` {what} diverges between backend "
        f"`{backend}` ({b.describe()}) and reference `{ref}` "
        f"({a.describe()}); the twins are no longer float-order-"
        "identical and placements can differ per backend",
        hint="make the term's constants and op structure identical in "
             "every registered backend (see STATIC_ANALYSIS.md "
             "SCORE6xx for the canonicalization rules)")
