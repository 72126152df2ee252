"""The port's analyzer (`nomad_tpu_torch.analysis`) against the JAX
package's, on the CPU.

The host-pass cases of tests/test_analysis.py (FSM, lock, race, robust,
obs, score, baseline, CLI and index cache) run on both analyzers
(`pkg` = "ref" / "port"): each writes the same fixtures and checks the
same rule ids, and each case about "the real package" checks that
analyzer's own package with its own baseline.  The device passes' cases
(JIT, SHARD, ALIAS) and the `nomadlint` console script are the
reference's alone.

The port's own cases: the two analyzers give the same findings on the
shared fixtures; the scorer registry resolves the CUDA wave kernel's
`score_pair` and its spread helpers, and `fused_wave_plain`, to the
spec's fingerprints term by term; perturbing one float op of a copy of
`wave_kernel.cu` fails the score pass; the analyzer and `lockdep`
import neither JAX nor the JAX package.
"""
import ast
import os
import re
import shutil

import pytest

from nomad_tpu_torch.analysis import AnalysisConfig
from nomad_tpu_torch.analysis.core import PackageIndex
from nomad_tpu_torch.analysis.score_pass import (DEFAULT_SCORER_SITES,
                                                 ScorerSite,
                                                 native_fingerprint,
                                                 python_fingerprint,
                                                 run_score_pass,
                                                 spec_reference)
from tests.torch_twin import port_module, twin_cases

REPO = __file__.rsplit("/tests/", 1)[0]
#: the host passes' cases: every reference case but these prefixes
DEVICE_PASS_CASES = ("test_jit_", "test_shard_", "test_alias_")
REFERENCE_ONLY = ("test_nomadlint_console_script_declared",)


def _port_source(src):
    # the port's config has no SHARD401 scatter helpers; its registry
    # holds the CUDA kernel's scorer, scoped to its scoring functions
    src = re.sub(r"\n\s*scatter_helpers=\(\),", "", src)
    return src.replace(
        "fp = native_fingerprint(path, all_groups, names_map)",
        "fp = native_fingerprint(path, all_groups, names_map, "
        "site.scope)")


REF, PORT = port_module("tests.test_analysis", _port_source)
MODS = {"ref": REF, "port": PORT}


def _memo_whole_package(mod):
    """The cases about the real package each call `analyze()`; the
    analyzer is a pure function of the tree, so each package's whole-
    tree report is computed once here."""
    real = mod.analyze
    memo = {}

    def analyze(*a, **kw):
        if a or kw:
            return real(*a, **kw)
        if "rep" not in memo:
            memo["rep"] = real()
        return memo["rep"]
    mod.analyze = analyze


for _m in MODS.values():
    _memo_whole_package(_m)


@pytest.fixture(scope="module")
def fixture_report(tmp_path_factory):
    out = {}
    for pkg, m in MODS.items():
        root = m.write_fixture(tmp_path_factory.mktemp(f"lintfix-{pkg}"),
                               m.FIX_FILES)
        out[pkg] = m.analyze(package_dir=root, package_name="fixpkg",
                             use_baseline=False, config=m.FIX_CFG)
    return out


@pytest.fixture(scope="module")
def race_report(tmp_path_factory):
    out = {}
    for pkg, m in MODS.items():
        root = m.write_fixture(tmp_path_factory.mktemp(f"racefix-{pkg}"),
                               {"racemod.py": m.FIX_RACE},
                               pkg_name="racepkg")
        out[pkg] = m.analyze(package_dir=root, package_name="racepkg",
                             use_baseline=False, config=m.RACE_CFG)
    return out


globals().update(twin_cases(
    "tests.test_analysis", modules=(REF, PORT),
    exclude=DEVICE_PASS_CASES + REFERENCE_ONLY,
    per_pkg=("fixture_report", "race_report")))


# --------------------------------------------------- the port's own
HOST_RULES = ("FSM", "LOCK", "RACE", "ROBUST", "OBS", "SCORE")


def test_host_passes_agree_on_the_shared_fixtures(fixture_report,
                                                  race_report):
    """The same fixtures give the same host-pass findings, key for key,
    from both analyzers."""
    for reports in (fixture_report, race_report):
        keys = {pkg: sorted(f.key for f in rep.findings
                            if f.rule.startswith(HOST_RULES))
                for pkg, rep in reports.items()}
        assert keys["port"] == keys["ref"]
        assert keys["port"]


@pytest.fixture(scope="module")
def port_index():
    return PackageIndex.build(REPO, "nomad_tpu_torch")


CORE_GROUPS = ("free", "binpack", "anti", "pen", "n_scorers", "total")


def _cuda_site():
    sites = [s for s in DEFAULT_SCORER_SITES
             if s.kind == "native" and s.site.endswith(".cu")]
    assert len(sites) == 1
    return sites[0]


def test_scorer_registry_resolves_the_cuda_kernel(port_index):
    """The CUDA kernel's one copy of the scoring (`score_pair` and its
    spread helpers) and its plain torch version (`fused_wave_plain`)
    carry every term of the port's spec with the spec's fingerprint;
    the Pallas row of the reference is gone."""
    _terms, spec, names, const_set, errors = spec_reference(port_index)
    assert not errors and "spread" in const_set
    site = _cuda_site()
    assert site.backend == "pallas"
    assert set(site.scope) == {"score_pair", "spread_params",
                               "spread_contrib"}
    assert not any("pallas_kernel" in s.site for s in DEFAULT_SCORER_SITES)
    groups = tuple(names)
    plain = [s for s in DEFAULT_SCORER_SITES if s.site.endswith(
        "wave_kernel:fused_wave_plain")]
    assert len(plain) == 1 and plain[0].backend == "pallas"
    fi = port_index.functions[port_index.match_funcs([plain[0].site])[0]]
    prints = {
        "cuda": native_fingerprint(os.path.join(REPO, site.site), groups,
                                   names, site.scope),
        "plain": python_fingerprint(port_index, fi, groups, names)}
    for fp in prints.values():
        for group in CORE_GROUPS:
            assert (fp[group].consts, fp[group].ops) == (
                spec[group].consts, spec[group].ops), group
        assert set(fp["spread"].const_set) == set(
            spec["spread"].const_set)
        assert "learned" not in fp and "region" not in fp


@pytest.mark.parametrize("old, new", [
    ("fminf(fmaxf(raw, 0.0f), 18.0f) / 18.0f",
     "fminf(fmaxf(raw, 0.0f), 17.0f) / 18.0f"),
    ("20.0f - (powf(10.0f, free_cpu)", "20.0f + (powf(10.0f, free_cpu)"),
    ("+ spread_total)\n                / n_scorers",
     "+ spread_total)\n                * n_scorers"),
    ("-(coll + 1.0f) / ask_desired", "-(coll + 1.0f) * ask_desired"),
    ("((desired - (cur + 1.0f)) / fmaxf(desired, 1e-9f))",
     "((desired - (cur + 2.0f)) / fmaxf(desired, 1e-9f))"),
])
def test_score_pass_fails_on_a_perturbed_cuda_kernel(port_index, tmp_path,
                                                     old, new):
    """One float op or constant changed in a copy of `wave_kernel.cu`'s
    scoring makes the score pass report drift for the kernel's backend;
    the unchanged copy is clean."""
    site = _cuda_site()
    src_path = os.path.join(REPO, site.site)
    with open(src_path) as f:
        src = f.read()
    assert src.count(old) == 1
    findings = {}
    for label, text in (("clean", src), ("perturbed", src.replace(old,
                                                                  new))):
        path = tmp_path / f"{label}.cu"
        path.write_text(text)
        cfg = AnalysisConfig(scorer_sites=(
            DEFAULT_SCORER_SITES[0],
            ScorerSite("pallas", "native", str(path), scope=site.scope)))
        findings[label] = [f.key for f in run_score_pass(
            port_index, cfg, package_dir=REPO)
            if f.rule == "SCORE601"]
    assert findings["clean"] == []
    assert any(":pallas:" in k for k in findings["perturbed"])


def test_cli_on_a_copy_of_the_port_tree(tmp_path):
    """`python -m nomad_tpu_torch.analysis` judges the tree it sits in:
    a copy of the package exits 0 with its baseline, and 1 once a copy
    of a hot-path module writes shared state without its lock."""
    import subprocess
    import sys
    dst = tmp_path / "nomad_tpu_torch"
    shutil.copytree(os.path.join(REPO, "nomad_tpu_torch"), dst,
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    run = [sys.executable, "-m", "nomad_tpu_torch.analysis"]
    env = dict(os.environ, PYTHONPATH=str(tmp_path))
    assert subprocess.run(run, cwd=tmp_path, env=env,
                          capture_output=True).returncode == 0
    broker = dst / "server" / "eval_broker.py"
    text = broker.read_text()
    anchor = "    def stats(self) -> dict:"
    assert text.count(anchor) >= 1
    broker.write_text(text.replace(
        anchor, "    def poke(self):\n        self._dequeues = 0\n\n"
        + anchor, 1))
    out = subprocess.run(run, cwd=tmp_path, env=env, capture_output=True,
                         text=True)
    assert out.returncode == 1, out.stdout[-2000:]
    assert "_dequeues" in out.stdout


def test_analysis_and_lockdep_import_no_jax():
    """The analyzer and lockdep keep their own copies: neither imports
    `jax` nor anything of the JAX package."""
    paths = [os.path.join(REPO, "nomad_tpu_torch", "utils", "lockdep.py")]
    adir = os.path.join(REPO, "nomad_tpu_torch", "analysis")
    paths += [os.path.join(adir, f) for f in os.listdir(adir)
              if f.endswith(".py")]
    for path in paths:
        with open(path) as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            for n in names:
                root = n.split(".")[0]
                assert root not in ("jax", "jaxlib", "nomad_tpu"), (path, n)


def test_dataflow_engine_builds_over_the_port(port_index):
    """The dataflow layer the device passes will query: it walks the
    port's tree, and with no `donate_argnums` in torch its donation map
    is empty."""
    from nomad_tpu_torch.analysis.dataflow import DataflowEngine
    eng = DataflowEngine(port_index, AnalysisConfig())
    assert eng.donation_map() == {}
    assert eng.mesh_roots() == set()
    key = port_index.match_funcs(
        ["nomad_tpu_torch.solver.resident:ResidentSolver.apply_delta"])[0]
    assert eng.summary(key).donates == ()
