"""CLI for nomadlint.

Exit-code contract (stable, scripted against by CI):

  0  no unsuppressed findings (clean, or everything baselined)
  1  at least one unsuppressed ERROR-tier finding
  2  baseline/config error (unjustified entry, unreadable file)
  3  unsuppressed WARN-tier findings only (advisory heuristics:
     LOCK302 / SHARD403 / ALIAS503 / OBS802 / RACE903)

`--no-baseline` is a REPORTING mode, not a gating mode: it lists every
finding (each tagged with whether the checked-in baseline would
suppress it) but the exit code is still computed from the
baseline-aware verdict — so `--no-baseline --json` in a CI pipeline
does not fail a clean tree just because accepted findings exist.

`--paths FILE...` is file-scoped INCREMENTAL mode for pre-commit
hooks: the whole package is still indexed (cross-file facts — mesh
reachability, spec reference fingerprints — need the full call
graph), but only findings in the named files are reported, and the
registry-rot/coverage rules (SCORE603/SCORE604, JIT200) are muted
because a per-file view cannot judge them.  CI must keep running WITHOUT
`--paths` so the whole-package invariants stay enforced.

`--diff` resolves the changed-file set from `git diff --name-only
HEAD` and feeds it to the same --paths machinery (the pre-commit
ergonomic).  It refuses cleanly (exit 2) outside a git checkout.

`--cache-dir DIR` turns on the on-disk incremental index cache:
parsed ASTs are stored per file keyed by content hash, so repeat runs
only re-parse what changed.  Off by default — CI runs cold on purpose
so a poisoned cache can never mask a finding.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

from . import (ANALYZER_VERSION, BaselineError, analyze,
               default_baseline_path, load_baseline, pass_of)


def _exit_code(rep) -> int:
    if rep.errors:
        return 1
    if rep.warnings:
        return 3
    return 0


def _diff_paths() -> list:
    """Changed .py files from git (worktree vs HEAD, plus staged and
    untracked), for --diff mode.  Raises RuntimeError outside a git
    checkout or without git."""
    here = os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))
    try:
        out = subprocess.run(
            ["git", "diff", "--name-only", "HEAD"],
            cwd=here, capture_output=True, text=True, timeout=30)
        untracked = subprocess.run(
            ["git", "ls-files", "--others", "--exclude-standard"],
            cwd=here, capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired) as e:
        raise RuntimeError(f"git unavailable: {e}")
    if out.returncode != 0:
        raise RuntimeError(
            (out.stderr or "git diff failed").strip())
    names = out.stdout.splitlines()
    if untracked.returncode == 0:
        names += untracked.stdout.splitlines()
    return sorted({os.path.join(here, n) for n in names
                   if n.endswith(".py") and os.path.exists(
                       os.path.join(here, n))})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m nomad_tpu_torch.analysis",
        description="nomadlint: FSM determinism / device-program "
                    "purity and host syncs / lock discipline / partition "
                    "safety / buffer aliasing / scoring drift / "
                    "swallowed exceptions / metric hygiene / lockset "
                    "races analyzer",
        epilog="exit codes: 0 clean, 1 unsuppressed errors, "
               "2 baseline error, 3 unsuppressed warnings only")
    ap.add_argument("--no-baseline", action="store_true",
                    help="report every finding (tagged with its "
                         "baseline status); the EXIT CODE still "
                         "follows the baseline-aware verdict")
    ap.add_argument("--json", action="store_true",
                    help="machine-readable output")
    ap.add_argument("--baseline", default=None,
                    help="alternate baseline file "
                         f"(default: {default_baseline_path()})")
    ap.add_argument("--prune-stale", action="store_true",
                    help="rewrite the baseline file without entries "
                         "that no longer match any finding")
    ap.add_argument("--paths", nargs="+", metavar="FILE", default=None,
                    help="file-scoped incremental mode: report ONLY "
                         "findings in these files (pre-commit); "
                         "SCORE603/SCORE604/JIT200 are muted — CI must "
                         "run without --paths")
    ap.add_argument("--diff", action="store_true",
                    help="pre-commit mode: resolve changed files from "
                         "`git diff --name-only HEAD` (plus untracked) "
                         "and run as if passed via --paths; refuses "
                         "outside a git checkout")
    ap.add_argument("--cache-dir", default=None, metavar="DIR",
                    help="on-disk incremental index cache (per-file "
                         "content-hash keyed ASTs); off by default so "
                         "CI always runs cold")
    args = ap.parse_args(argv)
    if args.diff and args.paths:
        print("--diff and --paths are mutually exclusive (--diff IS "
              "a computed --paths)", file=sys.stderr)
        return 2
    if args.diff:
        try:
            diff_paths = _diff_paths()
        except RuntimeError as e:
            print(f"--diff needs a git checkout: {e}", file=sys.stderr)
            return 2
        if not diff_paths:
            print(f"nomadlint v{ANALYZER_VERSION}: --diff found no "
                  "changed .py files")
            return 0
        args.paths = diff_paths
    if args.paths and args.prune_stale:
        # a partial index makes most baseline entries look stale;
        # pruning on that view would wrongly delete live entries
        print("--prune-stale needs the whole-package view; run it "
              "without --paths", file=sys.stderr)
        return 2

    bl_path = args.baseline or default_baseline_path()
    try:
        baseline = load_baseline(bl_path)
        rep = analyze(baseline=baseline, paths=args.paths,
                      cache_dir=args.cache_dir)
    except BaselineError as e:
        print(f"baseline error: {e}", file=sys.stderr)
        return 2
    except OSError as e:
        if args.baseline is not None:
            print(f"baseline error: {e}", file=sys.stderr)
            return 2
        baseline = None
        rep = analyze(use_baseline=False, paths=args.paths,
                      cache_dir=args.cache_dir)

    if args.prune_stale and rep.stale_baseline_keys:
        pruned = baseline.without(rep.stale_baseline_keys)
        pruned.save(bl_path)
        print(f"pruned {len(rep.stale_baseline_keys)} stale baseline "
              f"entr{'y' if len(rep.stale_baseline_keys) == 1 else 'ies'}"
              f" from {bl_path}", file=sys.stderr)
        rep = analyze(baseline=pruned)

    shown = (rep.findings + rep.suppressed) if args.no_baseline \
        else rep.findings
    shown = sorted(shown, key=lambda f: (f.path, f.line, f.rule))
    suppressed_keys = {id(f) for f in rep.suppressed}

    if args.json:
        print(json.dumps({
            "version": rep.version,
            "unsuppressed": [
                vars(f) | {"key": f.key, "severity": f.severity,
                           "pass": pass_of(f.rule),
                           "baselined": id(f) in suppressed_keys}
                for f in shown],
            "suppressed": len(rep.suppressed),
            "stale_baseline_keys": rep.stale_baseline_keys,
            "stale_suggestions": rep.stale_suggestions,
            "by_rule": rep.counts_by_rule(),
            "by_pass": rep.counts_by_pass(),
            "errors": len(rep.errors),
            "warnings": len(rep.warnings),
            "exit_code": _exit_code(rep),
        }, indent=1))
    else:
        for f in shown:
            tag = " [baselined]" if id(f) in suppressed_keys else ""
            sev = "" if f.severity == "error" else " (warn)"
            print(f.render() + tag + sev)
        # a partial --paths view strands most baseline entries; only a
        # whole-package run can call an entry stale
        for k in ([] if args.paths else rep.stale_baseline_keys):
            near = rep.stale_suggestions.get(k)
            extra = f" (nearest current key: {near})" if near else ""
            print("warning: stale baseline entry matches nothing: "
                  f"{k}{extra}", file=sys.stderr)
        print(f"nomadlint v{rep.version}: "
              f"{len(rep.errors)} error(s), "
              f"{len(rep.warnings)} warning(s), "
              f"{len(rep.suppressed)} baselined"
              + (f" [{rep.counts_by_rule()}]" if rep.findings else ""))
    return _exit_code(rep)


if __name__ == "__main__":
    sys.exit(main())
