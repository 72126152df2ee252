"""Prefix search over the ID spaces.

Reference: nomad/search_endpoint.go — fuzzy/prefix matches across
jobs, evals, allocs, nodes and deployments, truncated per context.

The counterpart of `nomad_tpu.server.search`.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

TRUNCATE_LIMIT = 20     # reference: search_endpoint.go truncateLimit

CONTEXTS = ("jobs", "evals", "allocs", "nodes", "deployment")
ALL_CONTEXT = "all"


def search(store, prefix: str, context: str = ALL_CONTEXT,
           namespace: str = "default"
           ) -> Tuple[Dict[str, List[str]], Dict[str, bool]]:
    """Returns (matches per context, truncation flags per context)."""
    contexts = CONTEXTS if context in ("", ALL_CONTEXT) else (context,)
    matches: Dict[str, List[str]] = {}
    truncations: Dict[str, bool] = {}
    for ctx in contexts:
        ids = _ids_for(store, ctx, namespace)
        hit = sorted(i for i in ids if i.startswith(prefix))
        truncations[ctx] = len(hit) > TRUNCATE_LIMIT
        matches[ctx] = hit[:TRUNCATE_LIMIT]
    return matches, truncations


def _ids_for(store, ctx: str, namespace: str) -> List[str]:
    if ctx == "jobs":
        return [j.id for j in store.jobs()
                if j.namespace == namespace]
    if ctx == "evals":
        return [e.id for e in store.evals()
                if e.namespace == namespace]
    if ctx == "allocs":
        return [a.id for a in store.allocs()
                if a.namespace == namespace]
    if ctx == "nodes":
        return [n.id for n in store.nodes()]       # nodes are global
    if ctx == "deployment":
        return [d.id for d in store.deployments()
                if d.namespace == namespace]
    raise ValueError(f"unknown search context {ctx!r}")
