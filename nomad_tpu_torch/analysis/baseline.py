"""Baseline (suppression) file for nomadlint.

Format: a TOML subset (parsed here by hand — the container's Python
predates tomllib and the repo adds no deps):

    version = 1

    [[suppress]]
    rule = "FSM104"
    key = "FSM104:nomad_tpu_torch.scheduler.harness:Harness.submit_plan:*"
    justification = "why this is accepted, mandatory"

`key` matches Finding.key (rule:module:func:symbol) and may use
fnmatch-style wildcards so one entry can cover a family of symbols.
Every entry MUST carry a non-empty justification; loading fails loudly
otherwise — an unexplained suppression is indistinguishable from a
swept-under-the-rug bug.
"""
from __future__ import annotations

import fnmatch
from typing import Dict, List


class BaselineError(Exception):
    pass


_HEADER = """\
# nomadlint baseline: accepted pre-existing findings.
#
# Keys match Finding.key = "RULE:module:qualname:symbol" (fnmatch
# wildcards allowed). Every entry MUST explain why the finding is
# accepted — the analyzer refuses to load entries without a
# justification. Remove entries as the underlying code is fixed; stale
# entries are reported as warnings (`--prune-stale` rewrites the file
# without them).

version = 1
"""


class Baseline:
    def __init__(self, entries: List[Dict[str, str]]):
        self.entries = entries

    def keys(self) -> List[str]:
        return [e["key"] for e in self.entries]

    def matches(self, finding_key: str) -> bool:
        return self.match_key(finding_key) is not None

    def match_key(self, finding_key: str):
        for e in self.entries:
            if fnmatch.fnmatchcase(finding_key, e["key"]):
                return e["key"]
        return None

    def without(self, dead_keys) -> "Baseline":
        dead = set(dead_keys)
        return Baseline([e for e in self.entries
                         if e["key"] not in dead])

    def render(self) -> str:
        """Regenerate the TOML-subset text (used by --prune-stale)."""
        parts = [_HEADER]
        for e in self.entries:
            parts.append("\n[[suppress]]")
            for k in ("rule", "key", "justification"):
                if k in e:
                    parts.append(f'{k} = "{e[k]}"')
            for k in sorted(e):
                if k not in ("rule", "key", "justification"):
                    parts.append(f'{k} = "{e[k]}"')
        return "\n".join(parts) + "\n"

    def save(self, path: str) -> None:
        with open(path, "w", encoding="utf-8") as f:
            f.write(self.render())


def _parse_scalar(raw: str, path: str, lineno: int):
    raw = raw.strip()
    if raw.startswith('"') and raw.endswith('"') and len(raw) >= 2:
        return raw[1:-1]
    if raw.startswith("'") and raw.endswith("'") and len(raw) >= 2:
        return raw[1:-1]
    try:
        return int(raw)
    except ValueError:
        raise BaselineError(
            f"{path}:{lineno}: unquoted non-integer value {raw!r}")


def _strip_comment(line: str) -> str:
    out = []
    quote = None
    for ch in line:
        if quote:
            out.append(ch)
            if ch == quote:
                quote = None
        elif ch in ('"', "'"):
            quote = ch
            out.append(ch)
        elif ch == "#":
            break
        else:
            out.append(ch)
    return "".join(out)


def parse_baseline_text(text: str, path: str = "<baseline>") -> Baseline:
    entries: List[Dict[str, str]] = []
    current: Dict[str, str] = {}
    in_suppress = False
    for lineno, line in enumerate(text.splitlines(), 1):
        stripped = _strip_comment(line).strip()
        if not stripped:
            continue
        if stripped == "[[suppress]]":
            if in_suppress:
                entries.append(current)
            current = {}
            in_suppress = True
            continue
        if stripped.startswith("["):
            raise BaselineError(
                f"{path}:{lineno}: unsupported table {stripped!r}")
        if "=" not in stripped:
            raise BaselineError(
                f"{path}:{lineno}: expected key = value")
        k, _, v = stripped.partition("=")
        k = k.strip()
        val = _parse_scalar(v, path, lineno)
        if in_suppress:
            current[k] = val
        # top-level keys (version = 1) are accepted and ignored
    if in_suppress:
        entries.append(current)

    for e in entries:
        if "key" not in e:
            raise BaselineError(f"{path}: [[suppress]] entry missing "
                                f"'key' ({e})")
        if "rule" not in e:
            raise BaselineError(f"{path}: entry {e['key']!r} missing "
                                "'rule'")
        just = str(e.get("justification", "")).strip()
        if not just:
            raise BaselineError(
                f"{path}: entry {e['key']!r} has no justification — "
                "every suppression must explain why the finding is "
                "accepted")
        if not str(e["key"]).startswith(str(e["rule"])):
            raise BaselineError(
                f"{path}: entry key {e['key']!r} does not start with "
                f"its rule {e['rule']!r}")
    return Baseline(entries)


def load_baseline(path: str) -> Baseline:
    with open(path, "r", encoding="utf-8") as f:
        return parse_baseline_text(f.read(), path)
