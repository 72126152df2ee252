"""Pass 4: partition safety over the per-shard planes (SHARD4xx).

The port splits a mesh solver's node planes the way the reference's
NamedShardings did: `ShardedResidentSolver` keeps each node-axis plane
as a list with one tensor a shard (`_split_rows` / `_split_cols`), and
the elastic tier remaps node ownership by tile instead of contiguous
blocks.  The silent-wrong-answer family the reference's pass guards
carries over with torch's spelling:

Rules
  SHARD401  a row scatter with GLOBAL row indices (`delta_scatter_*`, a
            `scatter_helpers` entry, or `index_put(_)` / `index_add(_)`
            / `scatter_add(_)` ...) applied to a plane split per shard,
            outside the owner-routed path (`_sharded_scatter`, which
            walks the shards and hands each its own rows).  The
            reference's double-applied GSPMD scatter; here the global
            rows land in one shard's tensor, or the call fails on the
            list.
  SHARD402  an unmasked scatter inside a per-shard root (a generator
            handed to `kernel.solve_shards`) or a def nested in it: the
            index must pin non-owned rows to the dropped slot, through
            `kernel._add_drop` (the reference's `mode="drop"`) or a
            `masked_fill` / `torch.where` of the index before the
            scatter.  Torch wraps a negative index Python-style, as
            `.at[]` does, into another shard's rows.  Scatters in the
            branch where the mesh is off (`if in_mesh: ... else: ...`,
            `in_mesh` bound to `mesh_axis is not None`) are skipped.
  SHARD403  contiguous-block axis arithmetic inside a per-shard root:
            ownership/locality derived with `//` or `%` from an
            axis-size expression (`x.shape[0]`, n_shards-like names).
            Correct for the static block layout, silently wrong under
            an elastic TileLayout remap.  (warn tier: heuristic)

A plane is split per shard by provenance (dataflow.py): a comprehension
moving one piece to each device, what a function returning one hands
back, and the class attributes assigned from either — with inherited
methods bound to the concrete subclass, so a subclass that splits its
planes but inherits `ResidentSolver._delta_set` is seen as the hazard
it is, while `ShardedResidentSolver` and `ElasticShardedResidentSolver`,
which override it, stay quiet.
"""
from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set

from .core import AnalysisConfig, Finding, PackageIndex, _dotted
from .dataflow import (AttrFact, DataflowEngine, _linear_nodes,
                       _param_list, _self_offset, scatter_base,
                       scatter_index)

# names that look like a shard/axis count when used as a `//`/`%`
# denominator inside a shard body
_AXIS_SIZE_NAMES = {"n_shards", "num_shards", "nshards", "n_shard",
                    "chips_per_host", "n_hosts", "npl", "np_local",
                    "tile_np", "shard_count", "world_size"}
# a scatter's index is masked when it was bound through one of these
_MASK_CALLS = {"where", "masked_fill", "masked_fill_"}
# the drop-mode helper: its index pins non-owned rows to a dropped slot
_DROP_HELPERS = {"_add_drop"}
# the attribute of a solve's options that says the mesh is on
_IN_MESH = "in_mesh"


def run_shard_pass(index: PackageIndex, cfg: AnalysisConfig,
                   engine: Optional[DataflowEngine] = None
                   ) -> List[Finding]:
    engine = engine or DataflowEngine(index, cfg)
    findings: List[Finding] = []
    findings += _shard401(index, cfg, engine)
    findings += _shard402_403(index, cfg, engine)
    return findings


# ------------------------------------------------------------ SHARD401
def _shard401(index: PackageIndex, cfg: AnalysisConfig,
              engine: DataflowEngine) -> List[Finding]:
    findings: List[Finding] = []
    seen: Set[str] = set()
    safe = engine.shard_safe()
    scatter_map = engine.scatter_map()

    def check_function(fkey: str, bound_cls: Optional[str],
                       facts: Optional[Dict[str, AttrFact]]) -> None:
        if fkey in safe:
            return
        fi = index.functions[fkey]
        env: Dict = {}
        for node in _linear_nodes(index, fi):
            if isinstance(node, ast.Assign):
                val = engine._eval(fi, node.value, env, bound_cls)
                for t in node.targets:
                    if isinstance(t, ast.Name):
                        env[t.id] = val
            if not isinstance(node, ast.Call):
                continue
            # a direct row scatter on a split plane
            base = scatter_base(node)
            if base is not None:
                val = engine._eval(fi, base, env, bound_cls)
                if engine.value_is_sharded(val, facts):
                    _emit(findings, seen, fi, node.lineno,
                          _render(base), direct=True)
                continue
            # a scatter helper handed a split plane
            target = engine._resolve(fi, node, bound_cls)
            if target is None:
                continue
            positions = scatter_map.get(target)
            if not positions:
                continue
            off = _self_offset(index, target, node)
            for pos in positions:
                apos = pos - off
                if not (0 <= apos < len(node.args)):
                    continue
                val = engine._eval(fi, node.args[apos], env, bound_cls)
                if engine.value_is_sharded(val, facts):
                    _emit(findings, seen, fi, node.lineno,
                          _render(node.args[apos]), direct=False,
                          helper=target.split(":")[-1])

    # module-level functions (no attr facts)
    for fkey, fi in sorted(index.functions.items()):
        if fi.cls is None:
            check_function(fkey, None, None)
    # methods, bound to each concrete class that reaches them — an
    # inherited method is re-checked under every subclass, because the
    # subclass's _put_node / _delta overrides change what is split
    for ckey in sorted(index.classes):
        facts = engine.class_facts(ckey)
        for mname, fkey in engine._mro_methods(ckey).items():
            check_function(fkey, ckey, facts)
    return findings


def _render(node) -> str:
    d = _dotted(node)
    if d:
        return d
    if isinstance(node, ast.Subscript):
        b = _render(node.value)
        return f"{b}[...]"
    if isinstance(node, ast.Call):
        f = _dotted(node.func)
        return f"{f.rsplit('.', 1)[-1]}(...)" if f else "<expr>"
    return "<expr>"


def _emit(findings: List[Finding], seen: Set[str], fi, line: int,
          operand: str, direct: bool, helper: str = "") -> None:
    sym = operand
    key = f"{fi.key}:{line}:{sym}"
    if key in seen:
        return
    seen.add(key)
    via = "a row scatter" if direct else f"scatter helper `{helper}`"
    findings.append(Finding(
        "SHARD401", fi.module, fi.qual, sym, fi.path, line,
        f"`{operand}` is a plane split per shard but is updated through "
        f"{via} with global rows, outside the owner-routed path; the "
        "rows land in the wrong shard's tensor (the reference's "
        "double-applied scatter class)",
        hint="route the update through the owner-routed scatter (each "
             "shard takes only the rows it owns, translated to its local "
             "slots), as ShardedResidentSolver._sharded_scatter does"))


# ----------------------------------------------------- SHARD402 / 403
def _shard402_403(index: PackageIndex, cfg: AnalysisConfig,
                  engine: DataflowEngine) -> List[Finding]:
    findings: List[Finding] = []
    for root in sorted(engine.mesh_roots()):
        fi = index.functions.get(root)
        if fi is None:
            continue
        flags = _mesh_flags(index, fi)
        # the body itself, the defs nested in it and the module's own
        # functions it calls (they run inline, on the shard's planes;
        # the drop helper is the masked path itself)
        stack = [root]
        bodies = []
        while stack:
            k = stack.pop()
            if k in bodies:
                continue
            bodies.append(k)
            stack.extend(index.functions[k].nested)
            stack.extend(
                c for c in sorted(index.callees(k))
                if c in index.functions
                and index.functions[c].module == fi.module
                and index.functions[c].parent is None
                and index.functions[c].qual not in _DROP_HELPERS)
        for fkey in bodies:
            sfi = index.functions[fkey]
            sizeish = _axis_size_locals(index, sfi)
            masked = _masked_names(index, sfi)
            off = _mesh_off_nodes(sfi, flags | _mesh_flags(index, sfi))
            for node in index._own_nodes(sfi):
                if id(node) in off:
                    continue
                if isinstance(node, ast.Call):
                    base = scatter_base(node)
                    if base is not None:
                        idx = scatter_index(node)
                        if idx is not None and not _is_masked(idx, masked):
                            sym = f"{_render(base)}@{_index_text(idx)}"
                            findings.append(Finding(
                                "SHARD402", sfi.module, sfi.qual, sym,
                                sfi.path, node.lineno,
                                f"scatter `{sym}` inside a per-shard root "
                                "with an unmasked index: non-owned rows "
                                "are not pinned to a dropped slot, and a "
                                "negative local index WRAPS python-style "
                                "into another shard's rows",
                                hint="scatter through kernel._add_drop, or "
                                     "masked_fill / torch.where the "
                                     "non-owned indices before the "
                                     "scatter"))
                if isinstance(node, ast.BinOp) and isinstance(
                        node.op, (ast.FloorDiv, ast.Mod)):
                    why = _axis_size_expr(node.right, sizeish)
                    if why:
                        op = "//" if isinstance(node.op,
                                                ast.FloorDiv) else "%"
                        findings.append(Finding(
                            "SHARD403", sfi.module, sfi.qual,
                            f"{op}:{why}", sfi.path, node.lineno,
                            f"ownership arithmetic `{op} {why}` inside "
                            "a per-shard root assumes the contiguous "
                            "block layout; under an elastic TileLayout "
                            "remap slot order is not id order and the "
                            "derived owner/local is silently wrong",
                            hint="route global rows through the "
                                 "owner/slot tables (pass them in as "
                                 "operands) instead of deriving them "
                                 "from axis sizes"))
    return findings


def _index_text(node) -> str:
    elts = node.elts if isinstance(node, ast.Tuple) else [node]
    parts = []
    for e in elts:
        d = _dotted(e)
        if d is None and isinstance(e, ast.Subscript):
            d = _dotted(e.value)
        if d is None and isinstance(e, ast.Call):
            d = _dotted(e.func.value) if isinstance(
                e.func, ast.Attribute) else None
        parts.append(d or "...")
    return ",".join(parts)


def _masked_names(index: PackageIndex, fi) -> Set[str]:
    """Locals bound to a masked index: `torch.where(...)`,
    `.masked_fill(...)`, or a subscript / `.to` / `.clamp` of a masked
    name (fixpoint over the body; a parent's masked names count inside
    a nested def)."""
    out: Set[str] = set()
    cur = fi
    bodies = []
    while cur is not None:
        bodies.append(cur)
        cur = index.functions.get(cur.parent) if cur.parent else None
    assigns = []
    for b in bodies:
        for node in index._own_nodes(b):
            if isinstance(node, ast.Assign):
                assigns.append(node)
    changed = True
    while changed:
        changed = False
        for node in assigns:
            names = {n.id for t in node.targets for n in ast.walk(t)
                     if isinstance(n, ast.Name)}
            if _is_masked(node.value, out, names):
                for t in node.targets:
                    for n in ast.walk(t):
                        if isinstance(n, ast.Name) and n.id not in out:
                            out.add(n.id)
                            changed = True
    return out


def _is_masked(node, masked: Set[str], target: Set[str] = frozenset()
               ) -> bool:
    """Does the index expression pin non-owned rows to a dropped slot?
    `torch.where(own, loc, Np)` does (its fill is a slot, not the value
    being rebound: `x = torch.where(c, y, x)` is an update, not a mask),
    `.masked_fill(...)` and `_add_drop` do, and so does a subscript,
    cast or clamp of a masked name."""
    if isinstance(node, ast.Tuple):
        # the masked element is the row axis the shard owns
        return any(_is_masked(e, masked) for e in node.elts)
    if isinstance(node, ast.Name):
        return node.id in masked
    if isinstance(node, ast.Subscript):
        return _is_masked(node.value, masked)
    if isinstance(node, ast.Call):
        f = node.func
        last = (_dotted(f) or "").rsplit(".", 1)[-1] if not isinstance(
            f, ast.Attribute) else f.attr
        if last == "where" and len(node.args) == 3:
            fill = node.args[2]
            return not (isinstance(fill, ast.Name) and fill.id in target)
        if last in _MASK_CALLS or last in _DROP_HELPERS:
            return True
        if isinstance(f, ast.Attribute) and f.attr in (
                "to", "long", "int", "clamp", "clamp_", "contiguous"):
            return _is_masked(f.value, masked)
    return False


def _mesh_flags(index: PackageIndex, fi) -> Set[str]:
    """Names that say the mesh is on: a mesh-axis parameter, locals
    bound to `<it> is not None`, and the `.in_mesh` attribute of a
    solve's options (a test of `<x>.in_mesh`, or a local bound to
    it)."""
    params = [p for p in _param_list(fi)] + [
        a.arg for a in fi.node.args.kwonlyargs]
    axis = {p for p in params if "mesh_axis" in p}
    flags: Set[str] = {_IN_MESH}
    for node in index._own_nodes(fi):
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name) \
                and isinstance(node.value, ast.Attribute) \
                and node.value.attr == _IN_MESH:
            flags.add(node.targets[0].id)
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name) \
                and isinstance(node.value, ast.Compare) \
                and isinstance(node.value.left, ast.Name) \
                and node.value.left.id in axis \
                and len(node.value.ops) == 1 \
                and isinstance(node.value.ops[0], ast.IsNot):
            flags.add(node.targets[0].id)
    return flags


def _mesh_off_nodes(fi, flags: Set[str]) -> Set[int]:
    """ids of the nodes under the branch where the mesh is off."""
    out: Set[int] = set()
    if not flags:
        return out
    for node in ast.walk(fi.node):
        if not isinstance(node, (ast.If, ast.IfExp)):
            continue
        t = node.test
        neg = isinstance(t, ast.UnaryOp) and isinstance(t.op, ast.Not)
        if neg:
            t = t.operand
        if not ((isinstance(t, ast.Name) and t.id in flags)
                or (isinstance(t, ast.Attribute) and t.attr in flags)):
            continue
        off = node.body if neg else node.orelse
        for st in (off if isinstance(off, list) else [off]):
            for n in ast.walk(st):
                out.add(id(n))
    return out


def _axis_size_locals(index: PackageIndex, fi) -> Set[str]:
    """Local names bound to an axis-size-like expression."""
    out: Set[str] = set()
    for node in index._own_nodes(fi):
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name):
            if _axis_size_expr(node.value, set()):
                out.add(node.targets[0].id)
    # parameters with axis-size names count too (closures over
    # n_shards/tile_np are the usual spelling)
    for name in _param_list(fi):
        if name.lower() in _AXIS_SIZE_NAMES:
            out.add(name)
    return out


def _axis_size_expr(node, sizeish: Set[str]) -> str:
    """Human-readable description when the expression is an axis-size
    source; '' otherwise."""
    if isinstance(node, ast.Subscript):
        b = node.value
        if isinstance(b, ast.Attribute) and b.attr == "shape":
            d = _dotted(b)
            return d or "shape[...]"
    if isinstance(node, ast.Name):
        if node.id in sizeish or node.id.lower() in _AXIS_SIZE_NAMES:
            return node.id
    if isinstance(node, ast.Attribute):
        d = _dotted(node)
        if d and d.split(".")[-1].lower() in _AXIS_SIZE_NAMES:
            return d
    if isinstance(node, ast.BinOp):
        # N // n_shards and friends: size-of-size is still a size
        return (_axis_size_expr(node.left, sizeish)
                or _axis_size_expr(node.right, sizeish))
    return ""
