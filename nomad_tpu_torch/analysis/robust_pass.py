"""Pass 7: swallowed exceptions in recovery-critical modules.

The chaos plane injects faults precisely where this repo's
recovery code runs: raft step-down, rpc transport, broker redelivery,
shard fail/recover, solver failover.  A `except: pass` or a broad
`except Exception` that discards the error in those modules converts
an injected (or real) fault into silent state divergence — the exact
class of bug the invariant harness exists to catch, found here
statically instead.

Rules
  ROBUST701  bare `except:` or broad `except Exception/BaseException`
             whose handler discards the error: no re-raise, no
             reference to the bound exception, and no logging/metrics/
             event call in the handler body

Scope is `AnalysisConfig.robust_module_prefixes` (default: the raft,
rpc, server, parallel and solver planes).  Narrow handlers
(`except OSError: pass` around a socket close) are deliberate cleanup
idiom and are never flagged — only bare/Exception/BaseException
catches.  A handler "handles" the error if it re-raises, references
the bound name (wrapping, storing, returning it), or calls anything
logging-shaped (dotted path containing log/warn/error/exc/debug/
info/print/record/trace/metric/incr/event/fail/abort).
"""
from __future__ import annotations

import ast
from typing import List, Optional

from .core import AnalysisConfig, Finding, PackageIndex, _dotted

BROAD_TYPES = ("Exception", "BaseException")

#: substrings of a dotted call path that count as surfacing the error
_SURFACING_TOKENS = ("log", "warn", "error", "exc", "debug", "info",
                     "print", "record", "trace", "metric", "incr",
                     "event", "fail", "abort")


def _broad_caught(h: ast.ExceptHandler) -> Optional[str]:
    """The broad type name a handler catches, or None if narrow."""
    if h.type is None:
        return "bare"
    types = (h.type.elts if isinstance(h.type, ast.Tuple)
             else [h.type])
    for t in types:
        d = _dotted(t)
        if d and d.split(".")[-1] in BROAD_TYPES:
            return d.split(".")[-1]
    return None


def _handles_error(h: ast.ExceptHandler) -> bool:
    for node in ast.walk(h):
        if isinstance(node, ast.Raise):
            return True
        if (h.name and isinstance(node, ast.Name)
                and node.id == h.name
                and isinstance(node.ctx, ast.Load)):
            return True
        if isinstance(node, ast.Call):
            d = _dotted(node.func)
            if d and any(tok in d.lower()
                         for tok in _SURFACING_TOKENS):
                return True
    return False


def run_robust_pass(index: PackageIndex,
                    cfg: AnalysisConfig) -> List[Finding]:
    findings: List[Finding] = []
    prefixes = cfg.robust_module_prefixes
    for fkey, fi in sorted(index.functions.items()):
        if not fi.module.startswith(prefixes):
            continue
        for node in index._own_nodes(fi):
            if not isinstance(node, ast.Try):
                continue
            for h in node.handlers:
                etype = _broad_caught(h)
                if etype is None or _handles_error(h):
                    continue
                what = ("bare except" if etype == "bare"
                        else f"except {etype}")
                findings.append(Finding(
                    rule="ROBUST701", module=fi.module, func=fi.qual,
                    symbol=etype, path=fi.path, line=h.lineno,
                    message=(f"{what} swallows the error in a "
                             f"recovery-critical module: no re-raise, "
                             f"no use of the bound exception, no "
                             f"logging/metrics call in the handler"),
                    hint=("narrow the except, re-raise, or surface "
                          "the error (bind it and log/count it); if "
                          "the drop is deliberate, baseline with a "
                          "justification")))
    return findings
