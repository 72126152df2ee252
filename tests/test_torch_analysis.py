"""The port's analyzer (`nomad_tpu_torch.analysis`) against the JAX
package's, on the CPU.

Every case of tests/test_analysis.py but the `nomadlint` console script
runs on both analyzers (`pkg` = "ref" / "port"): each writes its
fixtures and checks the same rule ids, and each case about "the real
package" checks that analyzer's own package with its own baseline.  The
host passes (FSM, lock, race, robust, obs, score) read the same
fixtures on both sides.  The device passes (JIT, SHARD, ALIAS) read the
reference's JAX fixtures on the reference and their torch counterparts
(below) on the port: the same function names, the same hazard in
PyTorch's spelling, so a case's keys carry over.  The port names its
device roots through `AnalysisConfig.device_roots`.

The port's own cases: the two analyzers give the same host-pass
findings on the shared fixtures and the same device-pass rule counts,
case by case, with every clean twin quiet; the scorer registry resolves
the CUDA wave kernel's `score_pair` and its spread helpers, and
`fused_wave_plain`, to the spec's fingerprints term by term; perturbing
one float op of a copy of `wave_kernel.cu` fails the score pass; five
perturbations of a copy of the port's tree each trip exactly their
device rule; the solve's host syncs are pinned by function and count;
the analyzer and `lockdep` import neither JAX nor the JAX package (and
the analyzer no torch).
"""
import ast
import collections
import dataclasses
import os
import re
import shutil
import subprocess
import sys

import pytest

from nomad_tpu_torch.analysis import AnalysisConfig, analyze
from nomad_tpu_torch.analysis.core import PackageIndex
from nomad_tpu_torch.analysis.jit_pass import DeviceRoot
from nomad_tpu_torch.analysis.score_pass import (DEFAULT_SCORER_SITES,
                                                 ScorerSite,
                                                 native_fingerprint,
                                                 python_fingerprint,
                                                 run_score_pass,
                                                 spec_reference)
from tests.torch_twin import port_module, twin_cases

REPO = __file__.rsplit("/tests/", 1)[0]
REFERENCE_ONLY = ("test_nomadlint_console_script_declared",)


def _port_source(src):
    # the port's registry holds the CUDA kernel's scorer, scoped to its
    # scoring functions
    return src.replace(
        "fp = native_fingerprint(path, all_groups, names_map)",
        "fp = native_fingerprint(path, all_groups, names_map, "
        "site.scope)")


# ------------------------------------ the device passes' torch fixtures
# The reference's FIX_JIT / FIX_SHARD / FIX_ALIAS with each hazard in
# PyTorch's spelling: `jax.jit` roots become registered device roots
# (TORCH_DEVICE_ROOTS), shard_map bodies become the generators handed
# to `solve_shards`, donation becomes an in-place update read through a
# snapshot, device_put becomes torch.as_tensor / torch.from_numpy.
TORCH_FIX_JIT = """
    import functools
    import logging

    import torch
    from nomad_tpu_torch.solver.kernel import solve_shards

    _log = logging.getLogger(__name__)
    _CACHE = {}


    def good_kernel(x, mode="a"):
        if mode == "a":          # static branch: fine
            return x + 1
        return x - 1


    def noisy_kernel(x):
        print("tracing")                                   # JIT201
        _log.info("traced")                                # JIT201
        return x


    def branchy_kernel(x, flag):
        if flag:                                           # JIT203
            return x
        return -x


    def leaky_kernel(x):
        _CACHE["k"] = x                                    # JIT202
        return x


    def scatter_rows_(arr, rows):
        arr[0] = rows            # changes its parameter in place
        return arr


    def bad_caller(arr, rows):
        work = arr.view(-1)
        scatter_rows_(work, rows)
        return arr.sum()                                   # JIT204


    def good_caller(arr, rows):
        work = arr.clone()
        scatter_rows_(work, rows)
        return arr.sum()              # the snapshot is a copy: fine


    def loopy_kernel(x, n):
        for i in range(n):                                 # JIT203
            x = x + i
        return x


    def loopy_static(x, n=4):
        for i in range(n):            # static bound: fine
            x = x + i
        return x


    def bad_carry_reader(carry, x):
        live = carry
        live[0].add_(x)
        return live[0] + carry[1]                          # JIT204


    def good_carry_reader(carry, x):
        live = [c.clone() for c in carry]
        live[0].add_(x)
        return live[0] + carry[1]     # cloned carry: fine


    def lane_scan_(used, dev_used, stacked):
        used.add_(stacked.sum(0))
        dev_used.add_(1)
        return stacked.sum()


    class LaneCarry:
        # the lane kernel updates the usage carry in place; binding the
        # carried attributes to fresh names is a snapshot only when the
        # names hold copies
        def good_lane_solve(self, stacked):
            (used, dev_used) = (self._used.clone(), self._dev_used.clone())
            out = lane_scan_(used, dev_used, stacked)
            return out, self._used.sum()    # copies updated: fine

        def bad_lane_solve(self, stacked):
            (used, dev_used) = (self._used, self._dev_used)
            out = lane_scan_(used, dev_used, stacked)
            return out + self._used.sum() + self._dev_used.sum()  # JIT204


    class EvPlanes:
        # node planes held in a dict attribute, updated through a name
        # bound to one plane
        def __init__(self):
            self._dev_node = {}

        def bad_ev_carry_reader(self, rows):
            ev = self._dev_node["ev_prio"]
            scatter_rows_(ev, rows)
            return self._dev_node["ev_prio"].sum()         # JIT204

        def good_ev_carry_reader(self, rows):
            ev = self._dev_node["ev_prio"].clone()
            scatter_rows_(ev, rows)
            self._dev_node["ev_prio"] = ev
            return self._dev_node["ev_prio"].sum()


    def meshless_kernel(x):
        total = yield ("psum", x)                          # JIT205
        idx = yield ("axis_index", "nodes")                # JIT205
        return total + idx


    def meshy_body(x):
        g = yield ("merge", x, x, 4)
        s = yield ("psum", x)         # per-shard root: fine
        return g, s


    def meshy_helper(x):
        # reachable FROM the per-shard root: fine
        return (yield ("psum", x))


    def meshy_partial_body(x, scale):
        s = yield from meshy_helper(x)
        return s * scale


    def run_meshy(mesh, parts):
        f = solve_shards([meshy_body(p) for p in parts], mesh)
        body = functools.partial(meshy_partial_body, scale=2)
        g = solve_shards([body(p) for p in parts], mesh)
        return f, g


    HOST_AX = "hosts"


    def two_tier_body(x):
        # both axes bound by the enclosing ("hosts", "chips") mesh
        c = yield ("axis_index", "chips")
        h = yield ("axis_index", HOST_AX)
        return c + h


    def wrong_axis_body(x):
        # the enclosing mesh binds hosts/chips, not the flat "nodes"
        return (yield ("axis_index", "nodes"))             # JIT205


    def run_two_tier(devices, parts):
        import numpy as np
        from nomad_tpu_torch.parallel.sharded import Mesh
        mesh = Mesh(np.array(devices).reshape(2, 2),
                    ("hosts", "chips"))
        f = solve_shards([two_tier_body(p) for p in parts], mesh)
        g = solve_shards([wrong_axis_body(p) for p in parts], mesh)
        return f, g


    REGION_AX = "regions"


    def make_region_mesh(devices):
        # internal helper returning a three-tier Mesh: axes must
        # resolve through ONE return level
        import numpy as np
        from nomad_tpu_torch.parallel.sharded import Mesh
        grid = np.array(devices).reshape(2, 2, 2)
        return Mesh(grid, (REGION_AX, HOST_AX, "chips"))


    def three_tier_body(x):
        # all three axes bound by the helper-built mesh: fine
        c = yield ("axis_index", "chips")
        h = yield ("axis_index", HOST_AX)
        r = yield ("axis_index", REGION_AX)
        return c + h + r


    def inner_only_body(x):
        # also driven under the two-tier mesh in run_nested below,
        # where "regions" is NOT an axis
        return (yield ("axis_index", REGION_AX))           # JIT205


    def run_three_tier(devices, parts):
        return solve_shards([three_tier_body(p) for p in parts],
                            make_region_mesh(devices))


    def run_nested(devices, parts):
        import numpy as np
        from nomad_tpu_torch.parallel.sharded import Mesh
        inner = make_region_mesh(devices)
        outer = Mesh(np.array(devices).reshape(2, 4), (HOST_AX, "chips"))
        f = solve_shards([inner_only_body(p) for p in parts], inner)
        g = solve_shards([inner_only_body(p) for p in parts], outer)
        return f, g
"""

TORCH_FIX_SHARD = """
    import torch
    from nomad_tpu_torch.solver.kernel import solve_shards


    def plain_scatter_add(arr, idx, rows):
        # generic one-plane scatter helper: fine on an unsplit plane
        return arr.index_add(0, idx, rows)


    def shard_planes(mesh, arr):
        devs = mesh.flat_devices()
        n = arr.shape[0] // len(devs)
        return [arr[i * n:(i + 1) * n].to(d) for i, d in enumerate(devs)]


    class DoubleApply:
        # node planes split one tensor a shard, but the delta path
        # still scatters global rows through the one-plane helper
        def __init__(self, mesh, plane):
            self._plane = shard_planes(mesh, plane)

        def apply_delta(self, idx, rows):
            self._plane = plain_scatter_add(self._plane, idx, rows)


    class OwnerRouted:
        # clean twin: same split planes, each shard takes only the rows
        # it owns, translated to its local slots and masked
        def __init__(self, mesh, plane):
            self._mesh = mesh
            self._plane = shard_planes(mesh, plane)

        def apply_delta(self, idx, rows):
            out, lo = [], 0
            for a_l in self._plane:
                loc = idx - lo
                own = (loc >= 0) & (loc < a_l.shape[0])
                out.append(a_l.index_add(
                    0, loc.masked_fill(~own, 0),
                    torch.where(own[:, None], rows, 0)))
                lo += a_l.shape[0]
            self._plane = out


    def naked_scatter_body(a_l, idx_, rows_):
        # SHARD402: no ownership mask — negative locals wrap into
        # another shard's rows
        lin = yield ("axis_index", "nodes")
        return a_l.index_add(0, idx_ - lin * a_l.shape[0], rows_)


    def masked_scatter_body(a_l, idx_, rows_):
        lin = yield ("axis_index", "nodes")
        loc = idx_ - lin * a_l.shape[0]
        own = (loc >= 0) & (loc < a_l.shape[0])
        loc = torch.where(own, loc, 0)
        return a_l.index_add(0, loc, torch.where(own[:, None], rows_, 0))


    def block_owner_body(a_l, idx_, rows_):
        # SHARD403: contiguous-block owner arithmetic breaks under the
        # elastic TileLayout remap
        lin = yield ("axis_index", "nodes")
        owner = idx_ // a_l.shape[0]
        own = owner == lin
        loc = (idx_ - owner * a_l.shape[0]).masked_fill(~own, 0)
        return a_l.index_add(0, loc, torch.where(own[:, None], rows_, 0))


    def table_routed_body(a_l, slot_map, idx_, rows_):
        # clean twin: global rows routed through the owner/slot table
        lin = yield ("axis_index", "nodes")
        loc = slot_map[lin][idx_]
        own = loc >= 0
        return a_l.index_add(0, loc.masked_fill(~own, 0),
                             torch.where(own[:, None], rows_, 0))


    def run_bodies(mesh, parts, slot_map, idx, rows):
        f = solve_shards([naked_scatter_body(p, idx, rows)
                          for p in parts], mesh)
        g = solve_shards([block_owner_body(p, idx, rows)
                          for p in parts], mesh)
        h = solve_shards([masked_scatter_body(p, idx, rows)
                          for p in parts], mesh)
        k = solve_shards([table_routed_body(p, slot_map, idx, rows)
                          for p in parts], mesh)
        return f, g, h, k
"""

TORCH_FIX_ALIAS = """
    import numpy as np
    import torch


    def set_rows_(arr, idx, rows):
        arr[idx] = rows          # changes its parameter in place
        return arr


    def layer_one(buf, idx, rows):
        return set_rows_(buf, idx, rows)


    def layer_two(state, idx, rows):
        return layer_one(state, idx, rows)


    def deep_dead_read(state, idx, rows):
        # a snapshot read after an in-place update two wrapper hops
        # deep: JIT204's direct/one-hop scan cannot see this
        before = state
        layer_two(state, idx, rows)
        return before.sum()                            # ALIAS502


    def deep_live_read(state, idx, rows):
        before = state.clone()
        layer_two(state, idx, rows)
        return before.sum()         # the snapshot owns a copy: fine


    class Planes:
        # template planes handed to torch WITHOUT a copy (np.asarray
        # keeps identity), then changed host-side in place: on the CPU
        # the tensor shares the buffer and sees both writes
        def __init__(self, template):
            self._template = template
            self._dev = torch.as_tensor(np.asarray(self._template))

        def host_apply(self, rows):
            self._template[: rows.shape[0]] += rows    # ALIAS501


    class PlanesCopied:
        # clean twin: the copy severs the alias at the boundary
        def __init__(self, template):
            self._template = template
            self._dev = torch.as_tensor(np.array(self._template))

        def host_apply(self, rows):
            self._template[: rows.shape[0]] += rows


    def local_alias_mutation(t):
        dev = torch.from_numpy(t)
        t[0] = 7                                       # ALIAS501
        return dev


    def local_copy_mutation(t):
        dev = torch.from_numpy(t.copy())
        t[0] = 7              # the tensor owns a copy: fine
        return dev


    class EscapedAlias:
        def reset(self, used0):
            self._used = torch.as_tensor(used0)        # ALIAS503


    class EscapedAliasCopied:
        def reset(self, used0):
            self._used = torch.as_tensor(np.array(used0))
"""

TORCH_DEVICE_ROOTS = (
    DeviceRoot("fixpkg.jitmod:good_kernel", ("mode",)),
    DeviceRoot("fixpkg.jitmod:noisy_kernel"),
    DeviceRoot("fixpkg.jitmod:branchy_kernel"),
    DeviceRoot("fixpkg.jitmod:leaky_kernel"),
    DeviceRoot("fixpkg.jitmod:scatter_rows_"),
    DeviceRoot("fixpkg.jitmod:loopy_kernel"),
    DeviceRoot("fixpkg.jitmod:loopy_static", ("n",)),
    DeviceRoot("fixpkg.jitmod:lane_scan_"),
    DeviceRoot("fixpkg.jitmod:meshless_kernel"),
    DeviceRoot("fixpkg.shardmod:plain_scatter_add"),
    DeviceRoot("fixpkg.aliasmod:set_rows_"),
)

REF, PORT = port_module("tests.test_analysis", _port_source)
PORT.FIX_FILES.update({"jitmod.py": TORCH_FIX_JIT,
                       "shardmod.py": TORCH_FIX_SHARD,
                       "aliasmod.py": TORCH_FIX_ALIAS})
PORT.FIX_CFG = dataclasses.replace(PORT.FIX_CFG,
                                   device_roots=TORCH_DEVICE_ROOTS)
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
    exclude=REFERENCE_ONLY,
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
    `jax` nor anything of the JAX package, and the analyzer (the device
    passes included) imports no torch: it reads source text."""
    paths = [os.path.join(REPO, "nomad_tpu_torch", "utils", "lockdep.py")]
    adir = os.path.join(REPO, "nomad_tpu_torch", "analysis")
    apaths = [os.path.join(adir, f) for f in os.listdir(adir)
              if f.endswith(".py")]
    assert {"jit_pass.py", "shard_pass.py", "alias_pass.py"} <= {
        os.path.basename(p) for p in apaths}
    paths += apaths
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
                if path in apaths:
                    assert root not in ("torch", "triton"), (path, n)


def test_dataflow_engine_builds_over_the_port(port_index):
    """The dataflow layer the device passes query: its per-shard roots
    are the generators handed to `solve_shards`, and its in-place map
    starts at the kernel's delta scatters (position 0) and the host
    template update, and reaches the resident solver's wrappers."""
    from nomad_tpu_torch.analysis.dataflow import DataflowEngine
    eng = DataflowEngine(port_index, AnalysisConfig())
    k = "nomad_tpu_torch.solver.kernel:"
    assert {k + "solve_steps",
            "nomad_tpu_torch.solver.resident:_solve_steps"} <= \
        eng.mesh_roots()
    base = eng.inplace_base()
    assert base[k + "delta_scatter_set"] == (0,)
    assert base[k + "delta_scatter_add"] == (0,)
    assert base["nomad_tpu_torch.solver.tensorize:apply_node_delta_host"
                ][0] == 0
    full = eng.inplace_map()
    r = "nomad_tpu_torch.solver.resident:ResidentSolver."
    assert full[r + "_delta_set"] == (1,)
    assert full[r + "_delta_add"] == (1,)
    assert eng.summary(r + "apply_delta").mutates == ()


# ------------------------------------ device passes: both analyzers
#: (case, rule, functions that carry the hazard, their clean twins): the
#: reference's 21 device-pass cases of tests/test_analysis.py
DEVICE_CASES = [
    ("jit_host_effects", "JIT201", ("noisy_kernel",), ("good_kernel",)),
    ("jit_global_mutation", "JIT202", ("leaky_kernel",), ("good_kernel",)),
    ("jit_retrace_hazard", "JIT203", ("branchy_kernel", "loopy_kernel"),
     ("good_kernel", "loopy_static")),
    ("jit_for_range_static", "JIT203", ("loopy_kernel",),
     ("loopy_static",)),
    ("jit_donated_read", "JIT204", ("bad_caller", "bad_carry_reader"),
     ("good_caller", "good_carry_reader")),
    ("jit_donated_lane_carry", "JIT204", ("LaneCarry.bad_lane_solve",),
     ("LaneCarry.good_lane_solve",)),
    ("jit_donated_alias_carry", "JIT204",
     ("EvPlanes.bad_ev_carry_reader",), ("EvPlanes.good_ev_carry_reader",)),
    ("jit_collective_outside_mesh", "JIT205", ("meshless_kernel",),
     ("meshy_body", "meshy_helper", "meshy_partial_body")),
    ("jit_collective_axis_not_bound", "JIT205", ("wrong_axis_body",),
     ("two_tier_body",)),
    ("jit_three_tier_helper_mesh", "JIT205", (),
     ("three_tier_body", "run_three_tier", "make_region_mesh")),
    ("jit_inner_only_axis", "JIT205", ("inner_only_body",),
     ("three_tier_body",)),
    ("jit_donated_carry_subscript", "JIT204", ("bad_carry_reader",),
     ("good_carry_reader",)),
    ("shard_double_apply", "SHARD401", ("DoubleApply.apply_delta",),
     ("OwnerRouted.apply_delta", "OwnerRouted.__init__")),
    ("shard_helper_itself", "SHARD401", (), ("plain_scatter_add",)),
    ("shard_maskfree_scatter", "SHARD402", ("naked_scatter_body",),
     ("masked_scatter_body", "table_routed_body")),
    ("shard_block_arithmetic", "SHARD403", ("block_owner_body",),
     ("table_routed_body", "masked_scatter_body")),
    ("alias_uncopied_put", "ALIAS501", ("Planes.host_apply",),
     ("PlanesCopied.host_apply", "PlanesCopied.__init__")),
    ("alias_local_order", "ALIAS501", ("local_alias_mutation",),
     ("local_copy_mutation",)),
    ("alias_deep_donated_read", "ALIAS502", ("deep_dead_read",),
     ("deep_live_read", "layer_one", "layer_two")),
    ("alias_escaped_param", "ALIAS503", ("EscapedAlias.reset",),
     ("EscapedAliasCopied.reset",)),
    ("alias_warn_tier", "ALIAS503", ("EscapedAlias.reset",),
     ("EscapedAliasCopied.reset", "Planes.__init__")),
]


@pytest.mark.parametrize("case, rule, bad, clean", DEVICE_CASES,
                         ids=[c[0] for c in DEVICE_CASES])
def test_device_passes_agree_case_by_case(fixture_report, case, rule, bad,
                                          clean):
    """The reference's analyzer on its JAX fixture and the port's on the
    torch fixture report the rule as many times in the hazard's
    functions, both clean twins are quiet, and the rule has the same
    severity in both."""
    counts = {}
    for pkg, rep in fixture_report.items():
        hits = collections.Counter(f.func for f in rep.findings
                                   if f.rule == rule)
        counts[pkg] = [hits[f] for f in bad]
        assert not any(hits[f] for f in clean), (pkg, rule, hits)
        assert all(counts[pkg]), (pkg, rule, hits)
    assert counts["port"] == counts["ref"]
    from nomad_tpu.analysis import severity_of as ref_sev
    from nomad_tpu_torch.analysis import severity_of as port_sev
    assert port_sev(rule) == ref_sev(rule)


def test_device_rule_totals_agree(fixture_report):
    """Over the whole fixture package each device rule fires as often
    on the port's torch fixture as on the reference's JAX one."""
    tally = {pkg: collections.Counter(
        f.rule for f in rep.findings
        if f.rule.startswith(("JIT", "SHARD", "ALIAS")))
        for pkg, rep in fixture_report.items()}
    assert tally["port"] == tally["ref"]
    assert set(tally["port"]) == {
        "JIT201", "JIT202", "JIT203", "JIT204", "JIT205", "SHARD401",
        "SHARD402", "SHARD403", "ALIAS501", "ALIAS502", "ALIAS503"}


# ---------------------------------- device passes: the port's own tree
def _tree_copy(tmp_path, edit=None):
    dst = tmp_path / "nomad_tpu_torch"
    shutil.copytree(os.path.join(REPO, "nomad_tpu_torch"), dst,
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    if edit is not None:
        rel, old, new = edit
        path = dst / rel
        text = path.read_text()
        assert text.count(old) == 1, (rel, old)
        path.write_text(text.replace(old, new))
    return str(tmp_path)


PERTURBATIONS = [
    ("SHARD402", "solver/kernel.py",
     "used = _add_drop(used, (loc,), ask_k * cm)",
     "used = used.index_put((loc,), ask_k * cm, accumulate=True)"),
    ("SHARD401", "parallel/sharded.py",
     "    def _delta_set(self, arr, idx, rows):\n"
     "        return self._sharded_scatter(\"set\", arr, idx, rows)\n\n"
     "    def _delta_add(self, arr, idx, rows):\n"
     "        return self._sharded_scatter(\"add\", arr, idx, rows)\n", ""),
    ("JIT204", "solver/kernel.py",
     "    used_pre, dev_used_pre = used, dev_used\n",
     "    used_pre, dev_used_pre = used, dev_used\n    used += 0\n"),
    ("JIT203", "solver/kernel.py",
     "    Gw = wg.shape[0]\n",
     "    Gw = wg.shape[0]\n    n_want = want_g.sum().item()\n"),
    ("ALIAS501", "solver/resident.py",
     "        return torch.as_tensor(np.array(arr)).to(self.device)\n\n"
     "    def _put_ask",
     "        return torch.as_tensor(np.asarray(arr)).to(self.device)\n\n"
     "    def _put_ask"),
]


@pytest.mark.parametrize("rule, rel, old, new", PERTURBATIONS,
                         ids=[p[0] for p in PERTURBATIONS])
def test_perturbed_port_trips_exactly_its_rule(tmp_path, rule, rel, old,
                                               new):
    """One edit of a copy of the port's tree — an unmasked scatter in
    the mesh solve, the sharded solver's delta overrides removed, an
    in-place `used +=` after the wave's usage snapshot, an `.item()` in
    the eviction pass, the node-plane put without its copy — makes the
    analyzer report that edit's rule and no other."""
    rep = analyze(package_dir=_tree_copy(tmp_path, (rel, old, new)))
    assert rep.findings, rule
    assert {f.rule for f in rep.findings} == {rule}, [
        f.render() for f in rep.findings]


def test_unresolved_device_root_fails(port_index):
    """Registry rot fails: a registered device root that no longer
    resolves is an error (JIT200), as a stale scorer site is."""
    from nomad_tpu_torch.analysis.jit_pass import (DEFAULT_DEVICE_ROOTS,
                                                   run_jit_pass)
    cfg = AnalysisConfig(device_roots=DEFAULT_DEVICE_ROOTS + (
        DeviceRoot("nomad_tpu_torch.solver.kernel:solve_kernel_gone"),))
    stale = [f for f in run_jit_pass(port_index, cfg)
             if f.rule == "JIT200"]
    assert [f.symbol for f in stale] == [
        "nomad_tpu_torch.solver.kernel:solve_kernel_gone"]
    assert stale[0].severity == "error"
    assert not [f for f in run_jit_pass(port_index, AnalysisConfig())
                if f.rule == "JIT200"]


def test_solve_steps_host_syncs_pinned():
    """The wave solve's host syncs, by function and count (every one is
    baselined with the reference predicate it stands for): in the wave
    loop one `.tolist()` of a wave's flags (the next entry test and the
    carried window's premise, read together) and one `bool()` of the
    rerank's test, the `int()`s of seed, n_place, the axis index and the
    rescore psum, and one host copy onto the card (the mesh's rescore
    count); in the wave body the eviction pass's gate.  The entry test
    rides on the flags, and the seed's constants no longer cross from
    the host."""
    rep = analyze()
    syncs = collections.Counter(
        (f.func, f.symbol.split(":")[0]) for f in
        rep.findings + rep.suppressed if f.rule == "JIT203"
        and f.module == "nomad_tpu_torch.solver.kernel"
        and f.func.startswith(("solve_steps", "_wave", "_rerank")))
    assert syncs == {("solve_steps", "tolist"): 1,
                     ("solve_steps", "bool"): 1,
                     ("solve_steps", "int"): 4,
                     ("solve_steps", "h2d"): 1,
                     ("_wave_body", "bool"): 1}
    assert not [f for f in rep.findings if f.rule == "JIT203"]


# ------------------------------ device passes: torch's own spellings
TORCH_SPELLINGS = """
    import numpy as np
    import torch

    from .tensorize import PackedBatch


    def rng_root(x, g):
        a = torch.rand(4)                                  # JIT201
        b = torch.randint(0, 9, (4,), generator=g)         # quiet
        return x + a + b


    def sync_root(x, learned, pb: PackedBatch, k=4):
        if learned is not None:       # structural: quiet
            x = x + learned
        if k > 2:                     # static: quiet
            x = x * 2
        n = x.sum().item()                                 # JIT203 item
        idx = torch.nonzero(x > 0)                         # JIT203 nonzero
        pos = x[x > 0]                                     # JIT203 mask
        rows = x.tolist()                                  # JIT203 tolist
        rep = x.repeat_interleave(2)                       # JIT203
        rep2 = x.repeat_interleave(2, output_size=8)       # quiet
        one = torch.tensor(n, device=x.device)             # JIT203 h2d
        up = torch.as_tensor(rows).to(x.device)            # JIT203 h2d
        while pb.avail.any():                              # JIT203 pb
            break
        y = x if x.all() else -x                           # JIT203 x
        return idx, pos, rep, rep2, one, up, y


    def alias_root(x, src):
        view = x[:2]
        view.add_(1)
        a = x.sum()                                        # JIT204 x
        flat = src.flatten()
        torch.add(src, 1, out=flat)
        b = src.sum()                                      # JIT204 src
        snap = x.clone()
        x.mul_(2)
        return a + b + snap.sum()     # the clone: quiet
"""

SPELLING_ROOTS = (
    DeviceRoot("spellpkg.spell:rng_root"),
    DeviceRoot("spellpkg.spell:sync_root", ("k",)),
    DeviceRoot("spellpkg.spell:alias_root"),
)


def test_device_rules_read_torch_spellings(tmp_path):
    """The jit pass's torch-only spellings, each on its line: the global
    RNG without `generator=`, `.item()`, `nonzero`, boolean-mask
    indexing, `.tolist()`, `repeat_interleave` without `output_size`,
    a host value or buffer copied onto the card, a PackedBatch field and
    a tensor ternary as Python tests; `is None`, static parameters and
    `output_size=` stay quiet.  JIT204 reads a slice view and an `out=`
    alias; a clone is quiet."""
    root = PORT.write_fixture(tmp_path, {
        "spell.py": TORCH_SPELLINGS,
        "tensorize.py": "class PackedBatch:\n    pass\n"
                        "ARRAY_FIELDS = ('avail',)\n"},
        pkg_name="spellpkg")
    rep = analyze(package_dir=root, package_name="spellpkg",
                  use_baseline=False,
                  config=AnalysisConfig(device_roots=SPELLING_ROOTS,
                                        scorer_sites=()))
    got = sorted((f.rule, f.func, f.symbol) for f in rep.findings
                 if f.rule.startswith("JIT"))
    assert got == sorted([
        ("JIT201", "rng_root", "torch.rand"),
        ("JIT203", "sync_root", "item:x"),
        ("JIT203", "sync_root", "nonzero:x"),
        ("JIT203", "sync_root", "mask:x"),
        ("JIT203", "sync_root", "tolist:x"),
        ("JIT203", "sync_root", "repeat_interleave:x"),
        ("JIT203", "sync_root", "h2d:n"),
        ("JIT203", "sync_root", "h2d:rows"),
        ("JIT203", "sync_root", "pb"),
        ("JIT203", "sync_root", "x"),
        ("JIT204", "alias_root", "x"),
        ("JIT204", "alias_root", "src"),
    ])
