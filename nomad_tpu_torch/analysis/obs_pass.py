"""Pass 8: observability hygiene — metric & series name discipline.

The telemetry plane gives every subsystem three sinks: the
MetricsRegistry (counters/gauges/samples/histograms), the
TimeSeriesStore (multi-resolution rings) and the Prometheus
exposition derived from both.  All three key on dotted metric names,
and two classes of naming bugs are invisible at runtime until a
dashboard breaks:

  * a malformed or unregistered name ("WorkerLatency", "foo") lands in
    the JSON dump but mangles unpredictably in Prometheus and never
    joins its subsystem's namespace — dashboards silently miss it;
  * a name built from runtime data (f-string over an eval id, a queue
    name, an exception type) is an unbounded-cardinality hazard: the
    registry's per-namespace cap absorbs the storm, but every key it
    sheds is a metric an operator expected to see.

Rules
  OBS801  (error) literal metric/series name that is not a lowercase
          dotted path, or whose namespace (first dot-segment) is not
          in the registered-prefix set
  OBS802  (warn)  dynamically-built metric/series name — bounded-
          cardinality sites are fine but must say so in the baseline

Sites checked: calls to the registry methods (incr_counter /
set_gauge / add_sample / measure_since / observe_hist / timed) on any
receiver, and `record(...)` calls whose receiver resolves to the
telemetry series store.  The registries themselves (where the name is
a parameter) are excluded via `AnalysisConfig.obs_exclude_modules`.
"""
from __future__ import annotations

import ast
import re
from typing import List, Optional, Tuple

from .core import AnalysisConfig, Finding, PackageIndex, _dotted

#: MetricsRegistry entry points whose first argument is a metric name
METRIC_METHODS = frozenset({
    "incr_counter", "set_gauge", "add_sample", "measure_since",
    "observe_hist", "timed"})

#: name-expr keyword spellings across the two sinks
_NAME_KWARGS = ("key", "name")

#: lowercase dotted path: at least two segments, [a-z0-9_] characters
_NAME_RE = re.compile(r"^[a-z][a-z0-9_]*(\.[a-z0-9_]+)+$")


def _series_receiver(index: PackageIndex, fi, call: ast.Call) -> bool:
    """True when a `record(...)` call's receiver is (or aliases) the
    telemetry series store — so job/event `record` methods elsewhere
    never enter the pass."""
    if not isinstance(call.func, ast.Attribute):
        return False
    recv = _dotted(call.func.value)
    if not recv:
        return False
    head = recv.split(".")[0]
    if "series" in recv:
        return True
    la = index._local_imports(fi)
    mi = index.modules[fi.module]
    target = la.get(head) or mi.aliases.get(head)
    return bool(target and "telemetry.series" in target)


def _name_expr(call: ast.Call) -> Optional[ast.expr]:
    if call.args:
        return call.args[0]
    for kw in call.keywords:
        if kw.arg in _NAME_KWARGS:
            return kw.value
    return None


def _fstring_pattern(node: ast.JoinedStr) -> str:
    """Reconstruct an f-string as a pattern: literal runs kept,
    interpolations collapsed to `*` — readable, stable baseline keys
    ("broker.deliveries.*", "*.burn_*")."""
    out: List[str] = []
    for v in node.values:
        if isinstance(v, ast.Constant) and isinstance(v.value, str):
            out.append(v.value)
        else:
            out.append("*")
    return "".join(out)


def _check_literal(name: str, prefixes: Tuple[str, ...]
                   ) -> Optional[str]:
    """OBS801 message for a literal name, or None when clean."""
    if not _NAME_RE.match(name):
        return (f"metric name {name!r} is not a lowercase dotted "
                f"path (expected e.g. 'worker.solve_latency_s')")
    ns = name.split(".", 1)[0]
    if ns not in prefixes:
        return (f"metric namespace {ns!r} is not registered "
                f"(known: {', '.join(prefixes)})")
    return None


def run_obs_pass(index: PackageIndex,
                 cfg: AnalysisConfig) -> List[Finding]:
    findings: List[Finding] = []
    prefixes = cfg.obs_metric_prefixes
    for fkey, fi in sorted(index.functions.items()):
        if fi.module in cfg.obs_exclude_modules:
            continue
        for node in index._own_nodes(fi):
            if not isinstance(node, ast.Call) or \
                    not isinstance(node.func, ast.Attribute):
                continue
            meth = node.func.attr
            if meth in METRIC_METHODS:
                pass
            elif meth == "record" and _series_receiver(index, fi, node):
                pass
            else:
                continue
            expr = _name_expr(node)
            if expr is None:
                continue
            if isinstance(expr, ast.Constant):
                if not isinstance(expr.value, str):
                    continue
                msg = _check_literal(expr.value, prefixes)
                if msg:
                    findings.append(Finding(
                        rule="OBS801", module=fi.module, func=fi.qual,
                        symbol=expr.value, path=fi.path,
                        line=node.lineno, message=msg,
                        hint=("use a lowercase dotted name under a "
                              "registered namespace, or register the "
                              "new namespace in "
                              "AnalysisConfig.obs_metric_prefixes")))
                continue
            if isinstance(expr, ast.JoinedStr):
                pattern = _fstring_pattern(expr)
                ns = pattern.split(".", 1)[0]
                if "." in pattern and "*" not in ns \
                        and ns not in prefixes:
                    findings.append(Finding(
                        rule="OBS801", module=fi.module, func=fi.qual,
                        symbol=pattern, path=fi.path,
                        line=node.lineno,
                        message=(f"metric namespace {ns!r} is not "
                                 f"registered (known: "
                                 f"{', '.join(prefixes)})"),
                        hint=("register the namespace in "
                              "AnalysisConfig.obs_metric_prefixes")))
                symbol = pattern
            else:
                symbol = "<dynamic>"
            findings.append(Finding(
                rule="OBS802", module=fi.module, func=fi.qual,
                symbol=symbol, path=fi.path, line=node.lineno,
                message=(f"metric name {symbol!r} is built at runtime "
                         f"— unbounded cardinality grows the registry "
                         f"until the namespace cap sheds keys"),
                hint=("fold runtime values into label-free names or "
                      "bound the value set; if cardinality is "
                      "provably bounded, baseline with the bound as "
                      "justification")))
    return findings
