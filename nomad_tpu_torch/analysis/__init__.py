"""nomadlint: static invariant analyzer for the nomad_tpu_torch package.

The counterpart of `nomad_tpu.analysis`: nine passes over a
module-level call graph (core.py) plus a dataflow layer (def-use
chains, buffer-identity provenance, interprocedural summaries — see
dataflow.py).  No analyzed module is ever imported: everything is `ast`
on source text (and, for the CUDA and C++ scorers, regex over their
source), so the analyzer runs without torch, a GPU or a compiler.

  * FSM determinism (fsm_pass):   the raft apply path must be
    bit-deterministic across replicas — no wall clock, no randomness
    (python, numpy or torch), no unordered-set iteration feeding state
    writes, and no StateStore mutation reachable from outside the
    apply path.
  * device-program purity and host syncs (jit_pass): the port's
    device roots (a registry, `jit_pass.DEFAULT_DEVICE_ROOTS`, with
    the reference's static_argnames; JIT200 when one no longer
    resolves) are what a CUDA graph capture would take, so their reach
    must stay free of host effects and torch's global RNG (JIT201) and
    of global writes (JIT202); every place a device tensor's value
    reaches the host there — `bool()` / `int()`, `.item()`, a tensor
    as a Python test, `nonzero`, a host copy onto the card — is a
    JIT203 site, baselined with the reference predicate it stands for;
    a name bound to the same storage as another must not be read after
    an in-place op on the other (JIT204, the counterpart of a donated
    read); a collective request (`yield ("psum", ...)`) needs a
    per-shard root, a generator handed to `kernel.solve_shards`, and an
    axis its mesh carries (JIT205).
  * lock discipline (lock_pass):  shared attributes of the threaded
    server plane must be written under their class lock; racy getters,
    unlocked module-global mutation and lock-ordering cycles are
    flagged.
  * partition safety (shard_pass): a plane split one tensor a shard
    (`ShardedResidentSolver._split_rows` / `_split_cols`) takes global
    rows only through the owner-routed scatter (SHARD401); a scatter in
    a per-shard root pins non-owned rows to a dropped slot (SHARD402,
    `kernel._add_drop`, the reference's mode="drop"); block-layout
    `//` / `%` ownership arithmetic there is a warning (SHARD403).
  * buffer aliasing and in-place lifetime (alias_pass): on `cpu`
    `torch.as_tensor` / `torch.from_numpy` share the numpy buffer, so a
    host in-place write after an uncopied hand-over reaches the tensor
    there and not on the card (ALIAS501); a snapshot read after an
    in-place op reached through wrappers of wrappers (ALIAS502, what
    JIT204's one hop cannot see); `self.attr = torch.as_tensor(param)`
    without a copy (ALIAS503, warn).
  * scoring-spec conformance (score_pass): solver/score_spec.py is
    the single declarative scoring spec; the spec-driven backends
    (host twin, torch wave scorer) must defer every float op to it,
    the hand backends (shortlist `_sl_eval`, the CUDA wave kernel's
    `score_pair` with its spread helpers and its plain torch version
    `fused_wave_plain`, native C++) are fingerprinted per term and
    verified against the spec, term coverage is checked both ways, and
    scoring-shaped arithmetic outside the spec/registered sites is
    flagged.
  * swallowed exceptions (robust_pass): bare/broad except handlers in
    the recovery-critical planes (raft, rpc, server, parallel, solver)
    must re-raise, use the bound error, or surface it through
    logging/metrics — silent drops turn injected faults (the chaos
    plane) into undetected state divergence.
  * observability hygiene (obs_pass): metric/series names must be
    lowercase dotted paths under a registered namespace (OBS801);
    names built at runtime are unbounded-cardinality hazards (OBS802,
    warn) that must carry a baseline justification naming the bound.
  * lockset race detection (race_pass): interprocedural Eraser-style
    guarded-by inference over the scale-out control plane — shared
    attributes reachable from ≥2 thread roots must keep a non-empty
    lock intersection over their writes (RACE901/902), check-then-act
    windows are flagged (RACE903, warn), and no hot-path lock may be
    held across a blocking call — device solve, fsync, RPC, waits
    (LOCK305).  `utils/lockdep.py` is its runtime witness.

Checked-in suppressions live in baseline.toml next to this file; every
entry must carry a non-empty justification. Run `python -m
nomad_tpu_torch.analysis`; exit 0 means zero unsuppressed findings
(exit 3: warn-tier only; exit 2: baseline error — see __main__).
"""
from __future__ import annotations

import os
from typing import List, Optional

from .core import (AnalysisConfig, Finding, PackageIndex, Report,
                   pass_of, severity_of)
from .baseline import Baseline, BaselineError, load_baseline

ANALYZER_VERSION = "4.1"

# the directory CONTAINING the nomad_tpu_torch package (analysis/ ->
# pkg -> root)
_PKG_DIR = os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__))))


def default_baseline_path() -> str:
    return os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "baseline.toml")


def analyze(package_dir: Optional[str] = None,
            package_name: str = "nomad_tpu_torch",
            baseline: Optional[Baseline] = None,
            use_baseline: bool = True,
            config: Optional[AnalysisConfig] = None,
            paths: Optional[List[str]] = None,
            cache_dir: Optional[str] = None) -> Report:
    """Run all passes; returns a Report with unsuppressed findings,
    suppressed count and the per-rule tally.

    `paths` switches on file-scoped INCREMENTAL mode (the CLI's
    `--paths`): the whole package is still indexed — cross-file facts
    like mesh-root reachability and spec reference fingerprints need
    the full call graph, so a partial index would manufacture false
    positives — but findings are limited to the named files, and the
    registry-rot/coverage rules (SCORE603/SCORE604, JIT200) are muted
    because judging them is a whole-package statement, not a per-file
    one.
    CI must keep running without `paths`."""
    from .fsm_pass import run_fsm_pass
    from .jit_pass import run_jit_pass
    from .lock_pass import run_lock_pass
    from .score_pass import run_score_pass
    from .robust_pass import run_robust_pass
    from .obs_pass import run_obs_pass
    from .race_pass import run_race_pass
    from .shard_pass import run_shard_pass
    from .alias_pass import run_alias_pass
    from .dataflow import DataflowEngine

    package_dir = package_dir or _PKG_DIR
    cfg = config or AnalysisConfig()
    only_files = None
    if paths is not None:
        only_files = {
            os.path.normpath(os.path.relpath(os.path.abspath(p),
                                             os.path.abspath(package_dir)))
            for p in paths}
    index = PackageIndex.build(package_dir, package_name,
                               cache_dir=cache_dir)
    engine = DataflowEngine(index, cfg)
    findings: List[Finding] = []
    findings += run_fsm_pass(index, cfg)
    findings += run_jit_pass(index, cfg, engine)
    findings += run_lock_pass(index, cfg)
    findings += run_shard_pass(index, cfg, engine)
    # alias pass sees prior findings so ALIAS502 never double-reports
    # a read JIT204 already covers
    findings += run_alias_pass(index, cfg, engine, prior=findings)
    findings += run_score_pass(index, cfg, package_dir=package_dir)
    findings += run_robust_pass(index, cfg)
    findings += run_obs_pass(index, cfg)
    # race pass sees prior findings so RACE901 never double-reports a
    # write LOCK301 already covers syntactically
    findings += run_race_pass(index, cfg, prior=findings)
    if only_files is not None:
        findings = [f for f in findings
                    if f.rule not in ("SCORE603", "SCORE604", "JIT200")
                    and os.path.normpath(f.path) in only_files]
    findings.sort(key=lambda f: (f.path, f.line, f.rule))

    if baseline is None and use_baseline:
        path = default_baseline_path()
        if os.path.exists(path):
            baseline = load_baseline(path)
    return Report.build(findings, baseline, version=ANALYZER_VERSION)


__all__ = ["ANALYZER_VERSION", "AnalysisConfig", "Baseline",
           "BaselineError", "Finding", "PackageIndex", "Report",
           "analyze", "default_baseline_path", "load_baseline",
           "pass_of", "severity_of"]
