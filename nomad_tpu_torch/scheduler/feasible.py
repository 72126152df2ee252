"""Host-side (scalar) feasibility semantics — the checks the tensorizer
evaluates per node where a constraint does not reduce to a rank compare.

Reference: scheduler/feasible.go — constraint operand zoo `checkConstraint`
:671, version parsing :694-706, DriverChecker :319, HostVolumeChecker :117,
FeasibilityWrapper computed-class memoization :915.
"""
from __future__ import annotations

import re
from typing import Dict, List, Optional

from ..structs import (CONSTRAINT_ATTR_IS_NOT_SET, CONSTRAINT_ATTR_IS_SET,
                       CONSTRAINT_DISTINCT_HOSTS, CONSTRAINT_DISTINCT_PROPERTY,
                       CONSTRAINT_REGEX, CONSTRAINT_SEMVER,
                       CONSTRAINT_SET_CONTAINS, CONSTRAINT_SET_CONTAINS_ALL,
                       CONSTRAINT_SET_CONTAINS_ANY, CONSTRAINT_VERSION,
                       Constraint, Node, TaskGroup, resolve_node_target)

_REGEX_CACHE: Dict[str, Optional[re.Pattern]] = {}
_VERSION_CACHE: Dict[str, Optional[list]] = {}


# --- version constraint handling (reference: helper go-version semantics) ---

_VERSION_RE = re.compile(
    r"^v?(\d+(?:\.\d+)*)([-.]?(?:[0-9A-Za-z-]+(?:\.[0-9A-Za-z-]+)*))?"
    r"(?:\+([0-9A-Za-z-]+(?:\.[0-9A-Za-z-]+)*))?$")


def parse_version(s: str):
    """Parse into (segments tuple, prerelease) or None."""
    m = _VERSION_RE.match(s.strip())
    if not m:
        return None
    segs = [int(p) for p in m.group(1).split(".")]
    while len(segs) < 3:
        segs.append(0)
    pre = m.group(2) or ""
    if pre.startswith("-") or pre.startswith("."):
        pre = pre[1:]
    return tuple(segs), pre


def _cmp_version(a, b) -> int:
    (sa, pa), (sb, pb) = a, b
    # compare numeric segments
    if sa != sb:
        return -1 if sa < sb else 1
    # a version WITH prerelease sorts before one without
    if pa == pb:
        return 0
    if pa == "":
        return 1
    if pb == "":
        return -1
    return -1 if pa < pb else 1


_CONSTRAINT_OP_RE = re.compile(r"^\s*(>=|<=|!=|~>|=|>|<)?\s*(.+?)\s*$")


def parse_version_constraint(expr: str):
    """Parse ">= 1.0, < 2.0" style expressions into [(op, version), ...]."""
    out = []
    for part in expr.split(","):
        m = _CONSTRAINT_OP_RE.match(part)
        if not m:
            return None
        op = m.group(1) or "="
        ver = parse_version(m.group(2))
        if ver is None:
            return None
        out.append((op, ver, m.group(2)))
    return out


_SEMVER_RE = re.compile(
    r"^(\d+)\.(\d+)\.(\d+)(?:-([0-9A-Za-z-]+(?:\.[0-9A-Za-z-]+)*))?"
    r"(?:\+([0-9A-Za-z-]+(?:\.[0-9A-Za-z-]+)*))?$")


def parse_semver(s: str):
    """Strict Semver 2.0 parse: exactly MAJOR.MINOR.PATCH, no 'v' prefix
    (reference: helper/constraints/semver — 'only accept properly
    formatted Semver versions')."""
    m = _SEMVER_RE.match(s.strip())
    if not m:
        return None
    return (int(m.group(1)), int(m.group(2)), int(m.group(3))), m.group(4) or ""


def parse_semver_constraint(expr: str):
    out = []
    for part in expr.split(","):
        m = _CONSTRAINT_OP_RE.match(part)
        if not m:
            return None
        op = m.group(1) or "="
        ver = parse_semver(m.group(2))
        if ver is None:
            return None
        out.append((op, ver, m.group(2)))
    return out


def check_version_match(lval: str, constraint_expr: str,
                        strict_semver: bool = False) -> bool:
    key = ("s:" if strict_semver else "v:") + constraint_expr
    parsed = _VERSION_CACHE.get(key)
    if key not in _VERSION_CACHE:
        parsed = (parse_semver_constraint(constraint_expr) if strict_semver
                  else parse_version_constraint(constraint_expr))
        _VERSION_CACHE[key] = parsed
    if parsed is None:
        return False
    ver = (parse_semver(str(lval)) if strict_semver
           else parse_version(str(lval)))
    if ver is None:
        return False
    for op, cver, raw in parsed:
        # prerelease gate (go-version constraint.go prereleaseCheck): a
        # non-prerelease constraint never matches a prerelease version; a
        # prerelease constraint only matches prereleases with equal base.
        v_pre, c_pre = ver[1] != "", cver[1] != ""
        if not c_pre and v_pre:
            return False
        if c_pre and v_pre and ver[0] != cver[0]:
            return False
        c = _cmp_version(ver, cver)
        if op == "=" and c != 0:
            return False
        if op == "!=" and c == 0:
            return False
        if op == ">" and c <= 0:
            return False
        if op == ">=" and c < 0:
            return False
        if op == "<" and c >= 0:
            return False
        if op == "<=" and c > 0:
            return False
        if op == "~>":
            # pessimistic: >= cver and < next significant release
            if c < 0:
                return False
            raw_segs = raw.strip().lstrip("v").split("-")[0].split(".")
            n = len(raw_segs)
            if n >= 2:
                upper = list(cver[0])
                upper[n - 2] += 1
                for i in range(n - 1, len(upper)):
                    upper[i] = 0
                if not _cmp_version(ver, (tuple(upper), "")) < 0:
                    return False
    return True


def check_regexp_match(lval: str, pattern: str) -> bool:
    pat = _REGEX_CACHE.get(pattern)
    if pattern not in _REGEX_CACHE:
        try:
            pat = re.compile(pattern)
        except re.error:
            pat = None
        _REGEX_CACHE[pattern] = pat
    if pat is None:
        return False
    return pat.search(str(lval)) is not None


def check_set_contains_all(lval: str, rval: str) -> bool:
    have = {p.strip() for p in str(lval).split(",")}
    need = [p.strip() for p in str(rval).split(",")]
    return all(n in have for n in need)


def check_set_contains_any(lval: str, rval: str) -> bool:
    have = {p.strip() for p in str(lval).split(",")}
    need = [p.strip() for p in str(rval).split(",")]
    return any(n in have for n in need)


def check_lexical_order(operand: str, lval: str, rval: str) -> bool:
    lval, rval = str(lval), str(rval)
    if operand == "<":
        return lval < rval
    if operand == "<=":
        return lval <= rval
    if operand == ">":
        return lval > rval
    if operand == ">=":
        return lval >= rval
    return False


def check_constraint(operand: str, lval, rval, lfound: bool,
                     rfound: bool) -> bool:
    """Reference: scheduler/feasible.go:671 checkConstraint."""
    if operand in (CONSTRAINT_DISTINCT_HOSTS, CONSTRAINT_DISTINCT_PROPERTY):
        return True  # handled by dedicated iterators
    if operand in ("=", "==", "is"):
        return lfound and rfound and str(lval) == str(rval)
    if operand in ("!=", "not"):
        return not (lfound and rfound and str(lval) == str(rval))
    if operand in ("<", "<=", ">", ">="):
        return lfound and rfound and check_lexical_order(operand, lval, rval)
    if operand == CONSTRAINT_ATTR_IS_SET:
        return lfound
    if operand == CONSTRAINT_ATTR_IS_NOT_SET:
        return not lfound
    if operand == CONSTRAINT_VERSION:
        return lfound and rfound and check_version_match(lval, str(rval))
    if operand == CONSTRAINT_SEMVER:
        return lfound and rfound and check_version_match(lval, str(rval),
                                                         strict_semver=True)
    if operand == CONSTRAINT_REGEX:
        return lfound and rfound and check_regexp_match(lval, str(rval))
    if operand in (CONSTRAINT_SET_CONTAINS, CONSTRAINT_SET_CONTAINS_ALL):
        return lfound and rfound and check_set_contains_all(lval, str(rval))
    if operand == CONSTRAINT_SET_CONTAINS_ANY:
        return lfound and rfound and check_set_contains_any(lval, str(rval))
    return False


def node_meets_constraint(node: Node, c: Constraint) -> bool:
    lval, lok = _resolve(node, c.ltarget)
    rval, rok = _resolve(node, c.rtarget)
    return check_constraint(c.operand, lval, rval, lok, rok)


def _resolve(node: Node, target: str):
    if target and target.startswith("${"):
        return resolve_node_target(node, target)
    # literal operand
    return target, target != ""


def driver_feasible(node: Node, driver: str) -> bool:
    """Reference: DriverChecker (feasible.go:319) — driver health via node
    driver info, falling back to the legacy `driver.<name>` attribute."""
    info = node.drivers.get(driver)
    if info is not None:
        return info.detected and info.healthy
    raw = node.attributes.get(f"driver.{driver}", "")
    if raw in ("1", "true"):
        return True
    return False


def merged_constraints(job, tg: TaskGroup) -> List[Constraint]:
    """Job + group + per-task constraints plus implicit driver checks,
    deduplicated (reference: stack.go SetJob/Select wiring)."""
    seen = set()
    out: List[Constraint] = []

    def _add(c: Constraint):
        if c.key() not in seen:
            seen.add(c.key())
            out.append(c)

    for c in job.constraints:
        _add(c)
    for c in tg.constraints:
        _add(c)
    for t in tg.tasks:
        for c in t.constraints:
            _add(c)
    return out


def group_drivers(tg: TaskGroup) -> List[str]:
    return sorted({t.driver for t in tg.tasks if t.driver})


def host_volumes_feasible(node: Node, tg: TaskGroup) -> bool:
    """Reference: HostVolumeChecker (feasible.go:117)."""
    for vol in tg.volumes.values():
        if vol.type not in ("", "host"):
            continue
        cfg = node.host_volumes.get(vol.source)
        if cfg is None:
            return False
        if not vol.read_only and cfg.read_only:
            return False
    return True
