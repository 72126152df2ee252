"""Pass 2: device-program purity and host syncs (JIT2xx).

The counterpart of the reference's jit pass, for eager PyTorch on a
CUDA card.  The reference's `jax.jit` programs become the port's device
roots: the functions whose whole body is meant to run as work queued on
the card (the wave solve, the resident streams, the delta scatters, the
health reduction, the fused wave kernel's wrapper).  The hazards are
the ones a CUDA graph capture of such a root would hit, since capture
has `jax.jit`'s semantics: a host effect runs once at capture and never
on replay, a Python branch on a device value is a host sync (which
capture forbids), and buffers are fixed.  Torch marks no program the
way `jax.jit` does, so the roots are a registry (`DEFAULT_DEVICE_ROOTS`,
overridable through `AnalysisConfig.device_roots`), each with the
reference's `static_argnames` as its static parameters.

Rules
  JIT200  a registered device root resolves to nothing (registry rot:
          the pass would be blind to that program)
  JIT201  host side effect (I/O, logging, env, clock, python / numpy
          randomness, torch's global RNG without `generator=`)
          reachable from a device root
  JIT202  global/closure mutation reachable from a device root (a
          capture-time write that replay never repeats)
  JIT203  a device tensor's value reaches the host inside a device
          root's reach: `bool()` / `int()` / `float()`, `.item()`,
          `.tolist()`, `.cpu()`, `.numpy()`; a tensor as an if / while /
          ternary / assert test or a `range()` bound; `nonzero`,
          boolean-mask indexing, `masked_select`, `unique`,
          `repeat_interleave` without `output_size`; and a host buffer
          copied onto the card (`torch.tensor(..., device=)`,
          `torch.as_tensor(x).to(device)`), which from pageable memory
          synchronizes the stream.  A value is a tensor by provenance:
          a `torch.*` call or a tensor method, a root parameter not in
          its static list (and what flows into a callee's parameter
          from one), a PackedBatch array field, or the answer to a
          collective request (`yield ("psum" | "merge" |
          "axis_index", ...)`).  `x is None` tests are structural and
          stay quiet.
  JIT204  a snapshot read after an in-place mutation: a name bound to
          the same storage as another (plain or tuple assignment, basic
          slicing, `.view` / `.reshape` / `.flatten` / `.detach()` /
          `.expand` / `.T` / `.t()` / `.narrow` / `.squeeze` /
          `.unsqueeze`, `torch.as_tensor` of a tensor), then an in-place
          op on either name (a `*_` method, a subscript store or
          augmented assignment on a tensor, `out=`, or a direct call to
          a function that changes that parameter in place), then a read
          of the other name.  `.clone()` or an out-of-place op is the
          clean form.  Torch's mutable aliasing is the hazard that the
          reference's immutable arrays hid: its counterpart there is a
          read of a donated buffer.
  JIT205  a collective request (`yield ("psum" | "merge" |
          "axis_index", ...)`) in a function that no per-shard root
          reaches (`kernel.solve_lanes` raises on one), or an
          `axis_index` naming an axis the enclosing mesh does not carry
          (meshes built by an internal helper resolve one return level
          deep; a body under several meshes only binds the axes they
          all carry)
"""
from __future__ import annotations

import ast
import dataclasses
from typing import Dict, FrozenSet, List, Optional, Sequence, Set, Tuple

from .core import AnalysisConfig, Finding, PackageIndex, _dotted
from .dataflow import (META_ATTRS, DataflowEngine, _arg_for,
                       _linear_nodes, _param_list, is_inplace_method)

HOST_EFFECT_EXACT = {"print", "input", "open", "exec", "eval"}
HOST_EFFECT_PREFIXES = (
    "os.", "sys.", "io.", "logging.", "time.", "random.",
    "numpy.random.", "np.random.", "subprocess.", "socket.",
    "builtins.print", "shutil.", "pathlib.",
)
# benign stdlib the prefixes above would otherwise catch
HOST_EFFECT_ALLOW = {"os.path.join", "os.path.dirname",
                     "os.path.abspath", "os.path.basename"}
LOG_METHODS = {"debug", "info", "warning", "warn", "error", "exception",
               "critical", "log"}
# torch's global generator: a draw without `generator=` advances the
# process-wide RNG state once at capture, never on replay
TORCH_RNG = ("torch.rand", "torch.randn", "torch.randint", "torch.randperm",
             "torch.rand_like", "torch.randn_like", "torch.randint_like",
             "torch.bernoulli", "torch.multinomial", "torch.normal",
             "torch.poisson", "torch.manual_seed", "torch.seed",
             "torch.cuda.manual_seed", "torch.cuda.manual_seed_all",
             "torch.cuda.seed", "torch.cuda.seed_all")

# the collective requests a per-shard generator yields to solve_shards
COLLECTIVE_KINDS = ("psum", "merge", "axis_index")
# drivers of generator solves: the per-shard one answers collectives,
# the lock-step lane one raises on them
SHARD_DRIVER = "solve_shards"
LANE_DRIVER = "solve_lanes"

# torch namespaces whose calls return no tensor
_TORCH_HOST = ("torch.cuda.", "torch.backends.", "torch.distributed.",
               "torch.profiler.", "torch.utils.", "torch.autograd.",
               "torch.jit.", "torch.library.", "torch.testing.")
_TORCH_HOST_EXACT = {
    "torch.device", "torch.Size", "torch.iinfo", "torch.finfo",
    "torch.is_tensor", "torch.is_floating_point", "torch.is_complex",
    "torch.get_default_dtype", "torch.no_grad", "torch.inference_mode",
    "torch.enable_grad", "torch.Generator", "torch.dtype", "torch.Event",
    "torch.Stream", "torch.compile", "torch.get_num_threads",
    "torch.set_num_threads", "torch.are_deterministic_algorithms_enabled",
    "torch.use_deterministic_algorithms", "torch.numel",
    "torch.set_default_dtype", "torch.set_grad_enabled"}
# tensor methods whose result lives on the host
_HOST_METHODS = {"item", "tolist", "numpy", "dim", "numel", "size",
                 "element_size", "data_ptr", "is_floating_point",
                 "is_contiguous", "stride", "nelement", "get_device",
                 "is_complex", "storage_offset", "untyped_storage",
                 "cpu", "__len__", "type", "is_pinned", "is_shared"}
# tensor methods that hand a value to the host (JIT203 kinds)
_SYNC_METHODS = {"item", "tolist", "cpu", "numpy"}
# data-dependent output shapes: the size is read back from the card
_SIZE_SYNC = {"nonzero", "argwhere", "masked_select", "unique",
              "unique_consecutive"}
_VIEW_METHODS = {"view", "reshape", "flatten", "detach", "expand",
                 "expand_as", "t", "narrow", "squeeze", "unsqueeze",
                 "view_as", "reshape_as", "permute", "transpose",
                 "movedim", "unflatten", "ravel", "as_strided"}
_VIEW_ATTRS = {"T", "mT", "H", "mH", "real", "imag", "data"}
_BOOL_CALLS = {"isfinite", "isnan", "isinf", "logical_and", "logical_or",
               "logical_not", "logical_xor", "eq", "ne", "lt", "le", "gt",
               "ge", "isin", "isclose", "any", "all", "signbit"}
_HOST_BUILTINS = {"int", "float", "bool", "len", "str", "repr", "complex",
                  "isinstance", "callable", "hash", "id", "type", "range",
                  "list", "tuple", "dict", "set", "frozenset", "sorted",
                  "enumerate", "zip", "map", "filter", "iter", "next",
                  "getattr", "hasattr", "print", "format", "divmod",
                  "any", "all"}
_SYNC_BUILTINS = ("bool", "int", "float", "complex")


@dataclasses.dataclass(frozen=True)
class DeviceRoot:
    """One registered device program: `site` is "module:qualname" (an
    fnmatch pattern, as scorer sites are), `static` its parameters that
    shape the program rather than feed it (the reference's
    `static_argnames`), `reference` the root it stands for."""
    site: str
    static: Tuple[str, ...] = ()
    reference: str = ""


_SOLVE_STATIC = ("has_spread", "group_count_hint", "max_waves",
                 "wave_mode", "has_distinct", "has_devices",
                 "stack_commit", "pallas_mode", "shortlist_c", "mesh_axis",
                 "mesh_shards", "has_preempt", "mesh_hosts", "mesh_nt",
                 "tile_np", "mesh_regions", "lane_axis",
                 # the port's own: whether the solve opens profiler ranges,
                 # and whether it is one lane (its waves may be graphs)
                 "wave_ranges", "single_lane")
_P = "nomad_tpu_torch."

DEFAULT_DEVICE_ROOTS: Tuple[DeviceRoot, ...] = (
    DeviceRoot(_P + "solver.kernel:solve_kernel", _SOLVE_STATIC,
               "nomad_tpu/solver/kernel.py:260"),
    DeviceRoot(_P + "solver.kernel:solve_steps", _SOLVE_STATIC,
               "nomad_tpu/solver/kernel.py:260"),
    DeviceRoot(_P + "solver.kernel:evict_pass", (),
               "nomad_tpu/solver/kernel.py:260"),
    DeviceRoot(_P + "solver.kernel:delta_scatter_set", (),
               "nomad_tpu/solver/kernel.py:115"),
    DeviceRoot(_P + "solver.kernel:delta_scatter_add", (),
               "nomad_tpu/solver/kernel.py:115"),
    DeviceRoot(_P + "solver.masks:_feas_kernel", (),
               "nomad_tpu/solver/masks.py:80"),
    DeviceRoot(_P + "solver.resident:_stream_kernel",
               ("has_spread", "group_count_hint", "max_waves", "wave_mode",
                "has_distinct", "has_devices", "stack_commit", "compact",
                "pallas_mode", "shortlist_c", "has_preempt"),
               "nomad_tpu/solver/resident.py:341"),
    DeviceRoot(_P + "solver.resident:_parallel_kernel",
               ("has_spread", "group_count_hint", "max_waves", "wave_mode",
                "has_distinct", "has_devices"),
               "nomad_tpu/solver/resident.py:263"),
    DeviceRoot(_P + "solver.resident:_lane_stream_kernel",
               ("lanes", "has_spread", "group_count_hint", "max_waves",
                "wave_mode", "has_distinct", "has_devices", "stack_commit",
                "compact", "pallas_mode", "shortlist_c"),
               "nomad_tpu/solver/resident.py:393"),
    DeviceRoot(_P + "telemetry.health:_health_kernel", (),
               "nomad_tpu/telemetry/health.py:75"),
    DeviceRoot(_P + "parallel.sharded:_sharded_stream",
               ("mesh", "has_spread", "group_count_hint", "max_waves",
                "wave_mode", "has_distinct", "has_devices", "stack_commit",
                "compact", "pallas_mode", "shortlist_c", "has_preempt",
                "mesh_nt", "tile_np"),
               "nomad_tpu/parallel/sharded.py:367"),
    DeviceRoot(_P + "parallel.federated:_federated_stream_kernel",
               ("has_spread", "group_count_hint", "max_waves",
                "has_distinct", "has_devices", "compact"),
               "nomad_tpu/parallel/federated.py:43"),
    DeviceRoot(_P + "solver.wave_kernel:fused_wave",
               ("mode", "seed", "TK", "n_extract", "tables_v"),
               "nomad_tpu/solver/pallas_kernel.py:317"),
)


#: every registry root's static parameter names: a value carried under
#: one of these names (a parameter, a `ctx["has_spread"]` entry) shapes
#: a program rather than feeds it, so provenance never makes it a tensor
ALL_STATIC = frozenset(n for r in DEFAULT_DEVICE_ROOTS for n in r.static)


# --------------------------------------------------------------- roots
@dataclasses.dataclass(frozen=True)
class JitRoot:
    """A registry root resolved in this package."""
    fkey: str
    static: FrozenSet[str]


def device_roots(cfg: AnalysisConfig) -> Tuple[DeviceRoot, ...]:
    roots = getattr(cfg, "device_roots", None)
    return DEFAULT_DEVICE_ROOTS if roots is None else tuple(roots)


def find_jit_roots(index: PackageIndex,
                   cfg: Optional[AnalysisConfig] = None) -> List[JitRoot]:
    """The registry's roots that resolve in this package."""
    out: List[JitRoot] = []
    for r in device_roots(cfg or AnalysisConfig()):
        for fkey in index.match_funcs([r.site]):
            out.append(JitRoot(fkey, frozenset(r.static)))
    return out


def _stale_roots(index: PackageIndex, cfg: AnalysisConfig
                 ) -> List[Finding]:
    out = []
    for r in device_roots(cfg):
        if not index.match_funcs([r.site]):
            out.append(Finding(
                "JIT200", "-", "-", r.site, r.site, 0,
                f"registered device root `{r.site}` resolves to nothing; "
                "the device passes are blind to that program",
                hint="update DEFAULT_DEVICE_ROOTS in analysis/jit_pass.py "
                     "(or AnalysisConfig.device_roots) after renaming the "
                     "root"))
    return out


def _module_str_constants(index: PackageIndex,
                          module: str) -> Dict[str, str]:
    """Module-level `NAME = "literal"` string constants (the axis-name
    spelling: MESH_HOST_AXIS = "hosts")."""
    cache = getattr(index, "_str_const_cache", None)
    if cache is None:
        cache = index._str_const_cache = {}
    out = cache.get(module)
    if out is not None:
        return out
    out = {}
    mi = index.modules.get(module)
    if mi is not None:
        for node in mi.tree.body:
            if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                    and isinstance(node.targets[0], ast.Name) \
                    and isinstance(node.value, ast.Constant) \
                    and isinstance(node.value.value, str):
                out[node.targets[0].id] = node.value.value
    cache[module] = out
    return out


def _aliases(index: PackageIndex, fi) -> Dict[str, str]:
    aliases = dict(index.modules[fi.module].aliases)
    aliases.update(index._local_imports(fi))
    return aliases


def _full(aliases: Dict[str, str], node) -> str:
    d = _dotted(node)
    if not d:
        return ""
    head = d.split(".")[0]
    resolved = aliases.get(head)
    return (resolved + d[len(head):]) if resolved else d


def _axis_str(index: PackageIndex, fi, aliases: Dict[str, str],
              node) -> Optional[str]:
    """Resolve an expression to an axis-name string: a literal, or a
    Name/Attribute bound to a module-level string constant (local or
    imported)."""
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    d = _dotted(node)
    if not d:
        return None
    head = d.split(".")[0]
    target = aliases.get(head)
    if target is not None:
        d = target + d[len(head):]
    if "." in d:
        mod, name = d.rsplit(".", 1)
        return _module_str_constants(index, mod).get(name)
    return _module_str_constants(index, fi.module).get(d)


def _mesh_ctor_axes(index: PackageIndex, fi, aliases: Dict[str, str],
                    call: ast.Call) -> Optional[Set[str]]:
    """Axis names bound by a `Mesh(devices, ("a", "b"))` constructor
    call with statically resolvable names; None when unresolvable."""
    names_arg = None
    if len(call.args) >= 2:
        names_arg = call.args[1]
    for kw in call.keywords:
        if kw.arg == "axis_names":
            names_arg = kw.value
    if names_arg is None:
        return None
    elts = (names_arg.elts if isinstance(names_arg, (ast.Tuple, ast.List))
            else [names_arg])
    axes: Set[str] = set()
    for e in elts:
        s = _axis_str(index, fi, aliases, e)
        if s is None:
            return None
        axes.add(s)
    return axes or None


def _helper_mesh_axes(index: PackageIndex,
                      fkey: Optional[str]) -> Optional[Set[str]]:
    """Axis names bound by a Mesh an internal helper constructs and
    returns (the make_three_tier_mesh shape).  Follows ONE level: every
    return path must be a visible `Mesh(devs, (...))` ctor (or a local
    bound to one) with statically resolvable names; multiple return
    paths keep only the axes bound on EVERY path.  None = not
    provable."""
    fi = index.functions.get(fkey) if fkey else None
    if fi is None:
        return None
    aliases = _aliases(index, fi)
    mesh_locals: Dict[str, Optional[Set[str]]] = {}
    for node in index._own_nodes(fi):
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name) \
                and isinstance(node.value, ast.Call) \
                and _full(aliases, node.value.func).endswith("Mesh"):
            mesh_locals[node.targets[0].id] = _mesh_ctor_axes(
                index, fi, aliases, node.value)
    axes: Optional[Set[str]] = None
    saw_return = False
    for node in index._own_nodes(fi):
        if not isinstance(node, ast.Return) or node.value is None:
            continue
        saw_return = True
        v = node.value
        if isinstance(v, ast.Call) and _full(aliases, v.func).endswith(
                "Mesh"):
            a = _mesh_ctor_axes(index, fi, aliases, v)
        elif isinstance(v, ast.Name):
            a = mesh_locals.get(v.id)
        else:
            a = None
        if a is None:
            return None
        axes = a if axes is None else (axes & a)
    return axes if saw_return and axes else None


def _driver_roots(index: PackageIndex, driver: str
                  ) -> Dict[str, Optional[Set[str]]]:
    cache = index._driver_cache
    if not cache:
        cache.update(_scan_drivers(index, (SHARD_DRIVER, LANE_DRIVER)))
    return {k: (set(v) if v is not None else None)
            for k, v in cache.get(driver, {}).items()}


def _scan_drivers(index: PackageIndex, drivers: Sequence[str]
                  ) -> Dict[str, Dict[str, Optional[Set[str]]]]:
    """Generator functions handed to `driver` (solve_shards /
    solve_lanes) -> the axis names the call's mesh binds (None when not
    statically resolvable).  The generators are the calls in the
    driver's first argument (a list, tuple or comprehension of calls),
    resolved directly, through functools.partial, or through a local
    `body = functools.partial(f, ...)` binding."""
    by_driver: Dict[str, Dict[str, Optional[Set[str]]]] = {
        d: {} for d in drivers}
    for fkey, fi in index.functions.items():
        if not any(isinstance(n, ast.Call) and (_dotted(n.func) or "")
                   .rsplit(".", 1)[-1] in drivers
                   for n in index._own_nodes(fi)):
            continue
        la = index._local_imports(fi)
        lt = index._local_var_types(fi)
        aliases = _aliases(index, fi)

        def _target_of(node):
            if isinstance(node, ast.Call) and \
                    _full(aliases, node.func) in ("functools.partial",
                                                  "partial") \
                    and node.args:
                node = node.args[0]
            if isinstance(node, (ast.Name, ast.Attribute)):
                return index.resolve_call(
                    fi, ast.Call(func=node, args=[], keywords=[]), la, lt)
            return None

        partial_locals: Dict[str, Optional[str]] = {}
        mesh_locals: Dict[str, Optional[Set[str]]] = {}
        for node in index._own_nodes(fi):
            if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                    and isinstance(node.targets[0], ast.Name) \
                    and isinstance(node.value, ast.Call):
                name = node.targets[0].id
                if _full(aliases, node.value.func).endswith("Mesh"):
                    mesh_locals[name] = _mesh_ctor_axes(
                        index, fi, aliases, node.value)
                    continue
                hk = index.resolve_call(fi, node.value, la, lt)
                hx = _helper_mesh_axes(index, hk)
                if hx is not None:
                    mesh_locals[name] = hx
                    continue
                if _full(aliases, node.value.func) in (
                        "functools.partial", "partial"):
                    tgt = _target_of(node.value)
                    if tgt:
                        partial_locals[name] = tgt

        def _axes_of(mesh_expr) -> Optional[Set[str]]:
            if isinstance(mesh_expr, ast.Call):
                if _full(aliases, mesh_expr.func).endswith("Mesh"):
                    return _mesh_ctor_axes(index, fi, aliases, mesh_expr)
                return _helper_mesh_axes(
                    index, index.resolve_call(fi, mesh_expr, la, lt))
            if isinstance(mesh_expr, ast.Name):
                return mesh_locals.get(mesh_expr.id)
            return None

        for node in index._own_nodes(fi):
            if not isinstance(node, ast.Call) or not node.args:
                continue
            full = _full(aliases, node.func)
            driver = full.rsplit(".", 1)[-1] if full else ""
            if driver not in by_driver:
                continue
            roots = by_driver[driver]
            gens = node.args[0]
            if isinstance(gens, (ast.ListComp, ast.GeneratorExp)):
                elts = [gens.elt]
            elif isinstance(gens, (ast.List, ast.Tuple)):
                elts = list(gens.elts)
            else:
                elts = []
            mesh_expr = node.args[1] if len(node.args) > 1 else None
            for kw in node.keywords:
                if kw.arg == "mesh":
                    mesh_expr = kw.value
            axes = _axes_of(mesh_expr) if mesh_expr is not None else None
            for e in elts:
                if not isinstance(e, ast.Call):
                    continue
                if isinstance(e.func, ast.Name) \
                        and e.func.id in partial_locals:
                    tgt = partial_locals[e.func.id]
                else:
                    tgt = _target_of(e.func)
                if not tgt:
                    continue
                if tgt in roots:
                    # several contexts drive the same body: only the
                    # axes EVERY known context binds are bound
                    prev = roots[tgt]
                    roots[tgt] = (prev & axes if prev is not None
                                  and axes is not None else None)
                else:
                    roots[tgt] = axes
    return by_driver


def find_mesh_roots_with_axes(
        index: PackageIndex) -> Dict[str, Optional[Set[str]]]:
    """Per-shard roots (the generators handed to `solve_shards`) -> the
    axis names their mesh binds, None when the mesh is not statically
    resolvable (a mesh passed in as a parameter: the axis check stays
    silent there)."""
    return _driver_roots(index, SHARD_DRIVER)


def find_mesh_roots(index: PackageIndex) -> List[str]:
    return sorted(find_mesh_roots_with_axes(index))


def find_lane_roots(index: PackageIndex) -> List[str]:
    """The generators handed to `solve_lanes` (lock-step lanes, which
    answer no collective)."""
    return sorted(_driver_roots(index, LANE_DRIVER))


def collective_requests(fi, index: PackageIndex):
    """(yield node, kind, request tuple) of every collective request in
    a function's own body."""
    for node in index._own_nodes(fi):
        if isinstance(node, ast.Yield) and isinstance(node.value,
                                                      ast.Tuple):
            elts = node.value.elts
            if elts and isinstance(elts[0], ast.Constant) \
                    and elts[0].value in COLLECTIVE_KINDS:
                yield node, elts[0].value, node.value


# --------------------------------------------------- tensor provenance
def _is_collective_yield(node) -> bool:
    return (isinstance(node, ast.Yield) and isinstance(node.value,
                                                       ast.Tuple)
            and bool(node.value.elts)
            and isinstance(node.value.elts[0], ast.Constant)
            and node.value.elts[0].value in COLLECTIVE_KINDS)


def _names_in(node) -> List[str]:
    return [n.id for n in ast.walk(node) if isinstance(n, ast.Name)]


class TensorScan:
    """Which names of one function hold torch tensors, by provenance,
    scanned in source order (a binding takes effect after its
    statement, so `seed = int(seed)` reads the root's `seed` and binds a
    host int).  `visit(node, scan)` hooks see every node with the
    environment in force at it."""

    def __init__(self, prov: "Provenance", fkey: str,
                 tparams: FrozenSet[str]):
        self.prov = prov
        self.index = prov.index
        self.fi = self.index.functions[fkey]
        self.fkey = fkey
        self.aliases = _aliases(self.index, self.fi)
        self.env: Dict[str, bool] = {}
        self.masks: Set[str] = set()      # names bound to bool tensors
        self.host_t: Set[str] = set()     # names bound to host tensors
        self.tparams = tparams
        self.calls: List[Tuple[ast.Call, str]] = []
        self.returns: List[bool] = []
        fi = self.fi
        args = fi.node.args
        for a in (list(args.posonlyargs) + list(args.args)
                  + list(args.kwonlyargs)):
            self.env[a.arg] = a.arg in tparams
        for a in (args.vararg, args.kwarg):
            if a is not None:
                self.env[a.arg] = a.arg in tparams
        self.closure: Dict[str, bool] = {}
        if fi.parent is not None:
            pscan = prov.scan(fi.parent, prov.seeds(fi.parent))
            self.closure = dict(pscan.env)
            self.masks |= pscan.masks

    # ------------------------------------------------------ evaluation
    def full(self, node) -> str:
        return _full(self.aliases, node)

    def is_module(self, node) -> bool:
        d = _dotted(node)
        head = d.split(".")[0] if d else ""
        return bool(head) and head in self.aliases

    def lookup(self, name: str) -> bool:
        if name in self.env:
            return self.env[name]
        return self.closure.get(name, False)

    def tensor(self, node) -> bool:
        if isinstance(node, ast.Name):
            return self.lookup(node.id)
        if isinstance(node, ast.Constant):
            return False
        if isinstance(node, ast.Attribute):
            if node.attr in META_ATTRS:
                return False
            if node.attr in _VIEW_ATTRS:
                return self.tensor(node.value)
            if isinstance(node.value, ast.Name) and self.prov.packed_field(
                    self.fi, node.value.id, node.attr):
                return True
            return False
        if isinstance(node, ast.Subscript):
            sl = node.slice
            if isinstance(sl, ast.Constant) and sl.value in ALL_STATIC:
                return False
            return self.tensor(node.value)
        if isinstance(node, ast.Starred):
            return self.tensor(node.value)
        if isinstance(node, ast.BinOp):
            return self.tensor(node.left) or self.tensor(node.right)
        if isinstance(node, ast.UnaryOp):
            return (not isinstance(node.op, ast.Not)
                    and self.tensor(node.operand))
        if isinstance(node, ast.Compare):
            if all(isinstance(op, (ast.Is, ast.IsNot, ast.In, ast.NotIn))
                   for op in node.ops):
                return False
            return any(self.tensor(x)
                       for x in [node.left] + list(node.comparators))
        if isinstance(node, ast.IfExp):
            return self.tensor(node.body) or self.tensor(node.orelse)
        if isinstance(node, (ast.Tuple, ast.List)):
            return any(self.tensor(e) for e in node.elts)
        if isinstance(node, ast.Dict):
            return any(self.tensor(v) for v in node.values
                       if v is not None)
        if isinstance(node, ast.Yield):
            return _is_collective_yield(node)
        if isinstance(node, ast.NamedExpr):
            return self.tensor(node.value)
        if isinstance(node, ast.Call):
            return self.call_tensor(node)
        return False

    def call_tensor(self, call: ast.Call) -> bool:
        f = call.func
        full = self.full(f)
        if full.startswith("torch.") and not self.is_local(f):
            return not (full.startswith(_TORCH_HOST)
                        or full in _TORCH_HOST_EXACT)
        if isinstance(f, ast.Attribute) and not self.is_module(f.value):
            if f.attr in _HOST_METHODS:
                return False
            if self.tensor(f.value):
                return True
        if isinstance(f, ast.Name) and f.id in ("min", "max", "abs",
                                                "sum", "round"):
            return any(self.tensor(a) for a in call.args)
        if isinstance(f, ast.Name) and f.id == "dict":
            return any(self.tensor(a) for a in call.args) or any(
                self.tensor(kw.value) for kw in call.keywords)
        if isinstance(f, ast.Name) and f.id in _HOST_BUILTINS:
            return False
        target = self.prov.resolve(self.fi, call)
        if target is not None:
            return self.prov.returns_tensor(
                target, self.arg_tensor_params(target, call))
        return False

    def is_local(self, f) -> bool:
        d = _dotted(f)
        head = d.split(".")[0] if d else ""
        return head in self.env or head in self.closure

    def arg_tensor_params(self, target: str, call: ast.Call
                          ) -> FrozenSet[str]:
        tfi = self.index.functions[target]
        targs = tfi.node.args
        pos = [a.arg for a in list(targs.posonlyargs) + list(targs.args)]
        if tfi.cls is not None and pos and pos[0] == "self" \
                and isinstance(call.func, ast.Attribute):
            pos = pos[1:]
        out: Set[str] = set()
        for i, a in enumerate(call.args):
            if isinstance(a, ast.Starred):
                if self.tensor(a.value):
                    out |= set(pos[i:])
                    if targs.vararg is not None:
                        out.add(targs.vararg.arg)
                break
            if i < len(pos):
                if self.tensor(a):
                    out.add(pos[i])
            elif targs.vararg is not None and self.tensor(a):
                out.add(targs.vararg.arg)
        for kw in call.keywords:
            if kw.arg is None:
                if self.tensor(kw.value):
                    if targs.kwarg is not None:
                        out.add(targs.kwarg.arg)
                    else:
                        out |= {a.arg for a in targs.kwonlyargs}
                continue
            if self.tensor(kw.value):
                names = set(pos) | {a.arg for a in targs.kwonlyargs}
                if kw.arg in names:
                    out.add(kw.arg)
                elif targs.kwarg is not None:
                    out.add(targs.kwarg.arg)
        return frozenset(out)

    def is_mask(self, node) -> bool:
        """A boolean tensor (an indexing mask)."""
        if isinstance(node, ast.Name):
            return node.id in self.masks
        if isinstance(node, ast.Compare):
            return self.tensor(node)
        if isinstance(node, ast.UnaryOp) and isinstance(node.op,
                                                        ast.Invert):
            return self.is_mask(node.operand)
        if isinstance(node, ast.BinOp) and isinstance(
                node.op, (ast.BitAnd, ast.BitOr, ast.BitXor)):
            return self.is_mask(node.left) or self.is_mask(node.right)
        if isinstance(node, ast.Call):
            last = self.full(node.func).rsplit(".", 1)[-1]
            if last in _BOOL_CALLS and self.tensor(node):
                return bool(node.args) or isinstance(node.func,
                                                     ast.Attribute)
        return False

    def host_tensor(self, node) -> bool:
        """A tensor made on the host from host data (no device= given):
        moving it to the card is a pageable copy."""
        if isinstance(node, ast.Name):
            return node.id in self.host_t
        if isinstance(node, ast.Call):
            full = self.full(node.func)
            if full in ("torch.as_tensor", "torch.tensor",
                        "torch.from_numpy", "torch.asarray") and not any(
                    kw.arg == "device" for kw in node.keywords):
                return True
            if isinstance(node.func, ast.Attribute) and \
                    node.func.attr in ("to", "contiguous") and \
                    not _device_arg(node):
                return self.host_tensor(node.func.value)
        return False

    # ---------------------------------------------------------- binding
    def bind(self, target, value) -> None:
        if isinstance(target, (ast.Tuple, ast.List)):
            if isinstance(value, (ast.Tuple, ast.List)) and len(
                    value.elts) == len(target.elts):
                for t, v in zip(target.elts, value.elts):
                    self.bind(t, v)
                return
            t_all = self.tensor(value) if value is not None else False
            for t in target.elts:
                self._set(t, t_all, False, False)
            return
        if value is None:
            self._set(target, False, False, False)
            return
        self._set(target, self.tensor(value), self.is_mask(value),
                  self.host_tensor(value))

    def _set(self, target, is_t: bool, is_m: bool, is_h: bool) -> None:
        if isinstance(target, ast.Starred):
            target = target.value
        if isinstance(target, (ast.Tuple, ast.List)):
            for t in target.elts:
                self._set(t, is_t, False, False)
            return
        if isinstance(target, ast.Name):
            self.env[target.id] = is_t
            (self.masks.add if is_m else self.masks.discard)(target.id)
            (self.host_t.add if is_h else self.host_t.discard)(target.id)

    def run(self, visit=None) -> "TensorScan":
        pending: List[Tuple[Tuple[int, int], ast.AST]] = []

        def flush(pos):
            keep = []
            for end, st in sorted(pending, key=lambda p: p[0]):
                if end <= pos:
                    self.apply(st)
                else:
                    keep.append((end, st))
            pending[:] = keep

        for node in _linear_nodes(self.index, self.fi):
            pos = (getattr(node, "lineno", 0), getattr(node, "col_offset",
                                                       0))
            flush(pos)
            if visit is not None:
                visit(node, self)
            if isinstance(node, ast.Call):
                t = self.prov.resolve(self.fi, node)
                if t is not None:
                    self.calls.append((node, t))
            if isinstance(node, ast.Return) and node.value is not None:
                self.returns.append(self.tensor(node.value))
            if isinstance(node, (ast.Assign, ast.AugAssign, ast.AnnAssign,
                                 ast.For, ast.NamedExpr, ast.withitem)):
                if isinstance(node, ast.For):
                    self.apply(node)      # the loop variable, at once
                    continue
                end = (getattr(node, "end_lineno", pos[0]) or pos[0],
                       getattr(node, "end_col_offset", pos[1]) or pos[1])
                pending.append((end, node))
        flush((1 << 30, 0))
        return self

    def apply(self, st) -> None:
        if isinstance(st, ast.Assign):
            for t in st.targets:
                self.bind(t, st.value)
        elif isinstance(st, ast.AnnAssign):
            self.bind(st.target, st.value)
        elif isinstance(st, ast.AugAssign):
            if isinstance(st.target, ast.Name):
                n = st.target.id
                self.env[n] = self.lookup(n) or self.tensor(st.value)
        elif isinstance(st, ast.NamedExpr):
            self.bind(st.target, st.value)
        elif isinstance(st, ast.For):
            it, tg = st.iter, st.target
            if isinstance(tg, (ast.Tuple, ast.List)) and isinstance(
                    it, (ast.Tuple, ast.List)) and it.elts and all(
                    isinstance(e, (ast.Tuple, ast.List))
                    and len(e.elts) == len(tg.elts) for e in it.elts):
                # `for name, t, dt in (("a", a, f32), ...)`: by position
                for i, t in enumerate(tg.elts):
                    self._set(t, any(self.tensor(e.elts[i])
                                     for e in it.elts), False, False)
                return
            self._set(tg, self.tensor(it), False, False)
        elif isinstance(st, ast.withitem) and st.optional_vars is not None:
            self._set(st.optional_vars, False, False, False)


def _device_arg(call: ast.Call):
    """The device a `.to(...)` / `.cuda()` call moves to, if it names
    one (not a dtype)."""
    f = call.func
    if isinstance(f, ast.Attribute) and f.attr == "cuda":
        return call
    for kw in call.keywords:
        if kw.arg == "device":
            return kw.value
    if not call.args:
        return None
    a = call.args[0]
    if isinstance(a, ast.Constant) and isinstance(a.value, str):
        return a
    if isinstance(a, ast.Attribute) and a.attr == "device":
        return a
    if isinstance(a, ast.Call) and (_dotted(a.func) or "").endswith(
            "device"):
        return a
    if isinstance(a, ast.Name) and (a.id in ("d", "dev", "device")
                                    or a.id.endswith("device")
                                    or a.id.endswith("_dev")):
        return a
    return None


class Provenance:
    """Tensor provenance over the device roots' reach: which parameters
    of each reached function receive tensors (a fixpoint over the call
    sites), and whether a call returns one (per calling context)."""

    def __init__(self, index: PackageIndex, roots: Sequence[JitRoot]):
        self.index = index
        self._scans: Dict[Tuple[str, FrozenSet[str]], TensorScan] = {}
        self._rets: Dict[Tuple[str, FrozenSet[str]], bool] = {}
        self._busy: Set[Tuple[str, FrozenSet[str]]] = set()
        self._packed: Dict[str, Set[str]] = {}
        self.params: Dict[str, Set[str]] = {}
        self.static: Dict[str, Set[str]] = {}
        for r in roots:
            fi = index.functions[r.fkey]
            a = fi.node.args
            names = [x.arg for x in list(a.posonlyargs) + list(a.args)
                     + list(a.kwonlyargs)]
            for x in (a.vararg, a.kwarg):
                if x is not None:
                    names.append(x.arg)
            static = set(r.static)
            self.static.setdefault(r.fkey, set()).update(static | {"self"})
            self.params.setdefault(r.fkey, set()).update(
                n for n in names if n not in static and n != "self")
        self._fixpoint()

    def seeds(self, fkey: str) -> FrozenSet[str]:
        return frozenset(self.params.get(fkey, ()))

    def resolve(self, fi, call: ast.Call) -> Optional[str]:
        la = self.index._local_imports(fi)
        lt = self.index._local_var_types(fi)
        return self.index.resolve_call(fi, call, la, lt)

    def scan(self, fkey: str, tparams: FrozenSet[str]) -> TensorScan:
        key = (fkey, tparams)
        s = self._scans.get(key)
        if s is None:
            s = TensorScan(self, fkey, tparams)
            self._scans[key] = s      # before run: closures may recurse
            s.run()
        return s

    def returns_tensor(self, fkey: str, tparams: FrozenSet[str]) -> bool:
        key = (fkey, tparams | self.seeds(fkey))
        if key in self._rets:
            return self._rets[key]
        if key in self._busy:
            return False
        self._busy.add(key)
        try:
            fi = self.index.functions[fkey]
            if any(isinstance(n, ast.Yield) for n in
                   self.index._own_nodes(fi)):
                out = False           # a generator, not its value
            else:
                out = any(self.scan(fkey, key[1]).returns)
        finally:
            self._busy.discard(key)
        self._rets[key] = out
        return out

    def _fixpoint(self) -> None:
        work = list(self.params)
        seen_rounds = 0
        while work and seen_rounds < 10000:
            seen_rounds += 1
            fkey = work.pop()
            s = self.scan(fkey, self.seeds(fkey))
            for call, target in s.calls:
                add = (s.arg_tensor_params(target, call)
                       - self.static.get(target, set()) - ALL_STATIC)
                cur = self.params.setdefault(target, set())
                if not add <= cur:
                    cur |= add
                    work.append(target)
            for nk in self.index.functions[fkey].nested:
                if nk not in self.params:
                    self.params[nk] = set()
                    work.append(nk)

    def packed_field(self, fi, name: str, attr: str) -> bool:
        """`name.attr` is a tensor field: a PackedBatch array field, or
        a field annotated `torch.Tensor` (bare or Optional) of a
        NamedTuple class of the package (the wave loop's carries), with
        `name` annotated or constructed as that class."""
        lt = self.index._local_var_types(fi)
        anns = self.index._param_annotations(fi)
        cls = lt.get(name) or anns.get(name)
        if not cls or ":" not in cls:
            return False
        mod = cls.split(":")[0]
        if not cls.endswith(":PackedBatch"):
            return attr in self._tensor_fields(cls)
        fields = self._packed.get(mod)
        if fields is None:
            fields = set()
            mi = self.index.modules.get(mod)
            for node in (mi.tree.body if mi else ()):
                if isinstance(node, ast.Assign) and any(
                        isinstance(t, ast.Name) and t.id in (
                            "ARRAY_FIELDS", "EVICT_FIELDS")
                        for t in node.targets) and isinstance(
                        node.value, (ast.Tuple, ast.List)):
                    fields |= {e.value for e in node.value.elts
                               if isinstance(e, ast.Constant)}
            self._packed[mod] = fields
        return attr in fields

    def _tensor_fields(self, cls: str) -> Set[str]:
        """The fields of the NamedTuple class `cls` ("module:Class")
        annotated `torch.Tensor` or `Optional[torch.Tensor]`."""
        fields = self._packed.get(cls)
        if fields is None:
            fields = set()
            mod, name = cls.split(":", 1)
            mi = self.index.modules.get(mod)
            for node in (mi.tree.body if mi else ()):
                if not (isinstance(node, ast.ClassDef) and node.name == name
                        and any(_dotted(b) in ("NamedTuple",
                                               "typing.NamedTuple")
                                for b in node.bases)):
                    continue
                for st in node.body:
                    if isinstance(st, ast.AnnAssign) and isinstance(
                            st.target, ast.Name) and any(
                            _dotted(n) == "torch.Tensor"
                            for n in ast.walk(st.annotation)):
                        fields.add(st.target.id)
            self._packed[cls] = fields
        return fields


# ------------------------------------------------------------ the pass
def run_jit_pass(index: PackageIndex, cfg: AnalysisConfig,
                 engine: Optional["DataflowEngine"] = None
                 ) -> List[Finding]:
    findings: List[Finding] = _stale_roots(index, cfg)
    roots = find_jit_roots(index, cfg)
    root_keys = [r.fkey for r in roots]
    reach = index.reachable(root_keys)
    prov = Provenance(index, roots)

    # ---- JIT201 / JIT202 over the device roots' reach
    for fkey in sorted(reach):
        fi = index.functions[fkey]
        findings += _host_effects(index, fi, fkey)

    # ---- JIT203: device values reaching the host
    for fkey in sorted(reach):
        findings += _host_syncs(prov, fkey)

    # ---- JIT205: collectives outside a per-shard context
    findings += _collectives(index)

    # ---- JIT204: snapshot reads after an in-place mutation
    engine = engine or DataflowEngine(index, cfg)
    base = engine.inplace_base()
    for fkey in sorted(index.functions):
        findings += snapshot_reads(index, prov, fkey, base, rule="JIT204")
    return findings


def _host_effects(index: PackageIndex, fi, fkey: str) -> List[Finding]:
    out: List[Finding] = []
    for name, lineno in index.external_calls(fkey):
        if _is_host_effect(name):
            out.append(Finding(
                "JIT201", fi.module, fi.qual, name, fi.path, lineno,
                f"host side effect `{name}` inside a device root's reach; "
                "under a CUDA graph capture it runs once, at capture, and "
                "never on replay",
                hint="hoist the effect to the dispatch wrapper, or "
                     "baseline if it is a deliberate host-side probe"))
    aliases = _aliases(index, fi)
    mi = index.modules[fi.module]
    for node in index._own_nodes(fi):
        if isinstance(node, ast.Call):
            full = _full(aliases, node.func)
            if full in TORCH_RNG and not any(
                    kw.arg == "generator" for kw in node.keywords):
                out.append(Finding(
                    "JIT201", fi.module, fi.qual, full, fi.path,
                    node.lineno,
                    f"`{full}` draws from torch's global generator inside "
                    "a device root's reach; a capture advances its state "
                    "once and every replay repeats the same draw",
                    hint="pass an explicit generator= (or derive the "
                         "values from the solve's seed)"))
            if isinstance(node.func, ast.Attribute):
                base = _dotted(node.func.value)
                if base and node.func.attr in LOG_METHODS and \
                        _looks_like_logger(base):
                    out.append(Finding(
                        "JIT201", fi.module, fi.qual,
                        f"{base}.{node.func.attr}", fi.path, node.lineno,
                        f"logging call `{base}.{node.func.attr}` inside a "
                        "device root's reach",
                        hint="log from the dispatch wrapper instead"))
        if isinstance(node, ast.Global):
            out.append(Finding(
                "JIT202", fi.module, fi.qual, ",".join(node.names),
                fi.path, node.lineno,
                "global-statement write inside a device root's reach; a "
                "capture-time mutation goes stale on replay",
                hint="return the value from the device function and "
                     "assign it on the host"))
        tgt = None
        if isinstance(node, ast.Assign):
            tgt = node.targets
        elif isinstance(node, ast.AugAssign):
            tgt = [node.target]
        if not tgt:
            continue
        for t in tgt:
            base = t
            while isinstance(base, ast.Subscript):
                base = base.value
            if isinstance(base, ast.Name) and \
                    base.id in mi.globals and base is not t:
                out.append(Finding(
                    "JIT202", fi.module, fi.qual, base.id, fi.path,
                    node.lineno,
                    f"mutation of module global `{base.id}` inside a "
                    "device root's reach",
                    hint="mutate from the host wrapper"))
    return out


def _first_name(scan: TensorScan, node) -> str:
    if isinstance(node, ast.Yield) and _is_collective_yield(node):
        return node.value.elts[0].value
    for sub in ast.walk(node):
        if isinstance(sub, ast.Yield) and _is_collective_yield(sub):
            return sub.value.elts[0].value
        if isinstance(sub, ast.Name) and scan.lookup(sub.id):
            return sub.id
    names = _names_in(node)
    return names[0] if names else "<expr>"


def _first_ref(node) -> str:
    """The first name or dotted attribute an expression reads."""
    for sub in ast.walk(node):
        if isinstance(sub, (ast.Attribute, ast.Name)):
            d = _dotted(sub)
            if d:
                return d
    return "const"


def _host_syncs(prov: Provenance, fkey: str) -> List[Finding]:
    fi = prov.index.functions[fkey]
    out: List[Finding] = []
    seen: Set[Tuple[int, str]] = set()

    def emit(scan, node, symbol, what):
        k = (node.lineno, symbol)
        if k in seen:
            return
        seen.add(k)
        out.append(Finding(
            "JIT203", fi.module, fi.qual, symbol, fi.path, node.lineno,
            f"{what} inside a device root's reach: the host waits for the "
            "card here (a CUDA graph capture cannot contain it)",
            hint="keep the value on the card (torch.where, a masked "
                 "update) or move the decision to the host wrapper; "
                 "baseline with the reference's lax.while_loop / "
                 "lax.cond predicate it stands for"))

    def test_syncs(scan, test, node):
        if isinstance(test, ast.BoolOp):
            for v in test.values:
                test_syncs(scan, v, node)
            return
        if isinstance(test, ast.UnaryOp) and isinstance(test.op, ast.Not):
            test_syncs(scan, test.operand, node)
            return
        if scan.tensor(test):
            emit(scan, node, _first_name(scan, test),
                 "a tensor used as a Python truth value")

    def visit(node, scan: TensorScan):
        if isinstance(node, (ast.If, ast.While, ast.IfExp, ast.Assert)):
            test_syncs(scan, node.test, node)
            return
        if isinstance(node, ast.For):
            it = node.iter
            if isinstance(it, ast.Call) and _dotted(it.func) in (
                    "range", "builtins.range"):
                for a in it.args:
                    if scan.tensor(a):
                        emit(scan, node, _first_name(scan, a),
                             "a tensor as a range() bound")
            return
        if isinstance(node, (ast.Assign, ast.AugAssign)):
            tgts = (node.targets if isinstance(node, ast.Assign)
                    else [node.target])
            for t in tgts:
                if isinstance(t, ast.Subscript) and scan.tensor(t.value) \
                        and _mask_index(scan, t.slice):
                    emit(scan, node, "mask:" + _first_name(scan, t.value),
                         "a boolean-mask store (its row count is read "
                         "back)")
            return
        if isinstance(node, ast.Subscript) and isinstance(
                node.ctx, ast.Load) and scan.tensor(node.value) \
                and _mask_index(scan, node.slice):
            emit(scan, node, "mask:" + _first_name(scan, node.value),
                 "boolean-mask indexing (its row count is read back)")
            return
        if not isinstance(node, ast.Call):
            return
        f = node.func
        if isinstance(f, ast.Name) and f.id in _SYNC_BUILTINS \
                and len(node.args) == 1 and not scan.is_local(f) \
                and scan.tensor(node.args[0]):
            emit(scan, node, f"{f.id}:{_first_name(scan, node.args[0])}",
                 f"`{f.id}()` of a tensor")
            return
        full = scan.full(f)
        last = full.rsplit(".", 1)[-1] if full else ""
        if isinstance(f, ast.Attribute) and not scan.is_module(f.value):
            recv = f.value
            if f.attr in _SYNC_METHODS and scan.tensor(recv):
                emit(scan, node, f"{f.attr}:{_first_name(scan, recv)}",
                     f"`.{f.attr}()` of a tensor")
                return
            if f.attr in _SIZE_SYNC and scan.tensor(recv):
                emit(scan, node, f"{f.attr}:{_first_name(scan, recv)}",
                     f"`.{f.attr}()` (a data-dependent size)")
                return
            if f.attr == "repeat_interleave" and scan.tensor(recv) and \
                    not any(kw.arg == "output_size"
                            for kw in node.keywords):
                emit(scan, node, f"{f.attr}:{_first_name(scan, recv)}",
                     "`.repeat_interleave()` without output_size")
                return
            if f.attr in ("to", "cuda") and _device_arg(node) is not None \
                    and scan.host_tensor(recv):
                emit(scan, node, f"h2d:{_first_name(scan, recv)}",
                     "a host buffer copied onto the card")
                return
        if full.startswith("torch.") and not scan.is_local(f):
            arg0 = node.args[0] if node.args else None
            if last in _SIZE_SYNC or (last == "where" and len(
                    node.args) == 1):
                emit(scan, node, f"{last}:{_first_name(scan, arg0)}"
                     if arg0 is not None else last,
                     f"`torch.{last}` (a data-dependent size)")
                return
            if last == "repeat_interleave" and not any(
                    kw.arg == "output_size" for kw in node.keywords):
                emit(scan, node, f"{last}:{_first_name(scan, arg0)}"
                     if arg0 is not None else last,
                     "`torch.repeat_interleave` without output_size")
                return
            if full in ("torch.tensor", "torch.as_tensor",
                        "torch.asarray") and any(
                    kw.arg == "device" for kw in node.keywords) and \
                    arg0 is not None and not scan.tensor(arg0):
                emit(scan, node, "h2d:" + _first_ref(arg0),
                     "a host value copied onto the card")

    TensorScan(prov, fkey, prov.seeds(fkey)).run(visit)
    return out


def _mask_index(scan: TensorScan, sl) -> bool:
    elts = sl.elts if isinstance(sl, ast.Tuple) else [sl]
    return any(scan.is_mask(e) for e in elts)


def _collectives(index: PackageIndex) -> List[Finding]:
    findings: List[Finding] = []
    mesh_roots = find_mesh_roots_with_axes(index)
    mesh_ok = index.reachable(mesh_roots)
    lane_ok = index.reachable(find_lane_roots(index))
    fn_axes: Dict[str, Optional[Set[str]]] = {}
    for root, axes in mesh_roots.items():
        for fkey in index.reachable([root]):
            if fkey in fn_axes:
                prev = fn_axes[fkey]
                fn_axes[fkey] = (prev & axes if prev is not None
                                 and axes is not None else None)
            else:
                fn_axes[fkey] = set(axes) if axes is not None else None
    for fkey, fi in sorted(index.functions.items()):
        reqs = list(collective_requests(fi, index))
        if not reqs:
            continue
        aliases = _aliases(index, fi)
        if fkey in mesh_ok:
            bound = fn_axes.get(fkey)
            if not bound:
                continue
            for node, kind, tup in reqs:
                if kind != "axis_index" or len(tup.elts) < 2:
                    continue
                e = tup.elts[1]
                elts = e.elts if isinstance(e, (ast.Tuple, ast.List)) \
                    else [e]
                for el in elts:
                    s = _axis_str(index, fi, aliases, el)
                    if s is not None and s not in bound:
                        findings.append(Finding(
                            "JIT205", fi.module, fi.qual, kind, fi.path,
                            node.lineno,
                            f"axis_index names axis {s!r}, which the "
                            "enclosing mesh does not carry (bound: "
                            f"{sorted(bound)}); the shard's index is "
                            "read against the wrong tier",
                            hint="use an axis the mesh handed to "
                                 "solve_shards carries, or thread the "
                                 "axis in as a parameter"))
                        break
            continue
        where = ("reached only by solve_lanes, which raises on a "
                 "collective request" if fkey in lane_ok else
                 "reached by no per-shard root")
        for node, kind, tup in reqs:
            findings.append(Finding(
                "JIT205", fi.module, fi.qual, kind, fi.path, node.lineno,
                f"collective request `{kind}` in a function {where}: no "
                "solve_shards is there to answer it",
                hint="drive the generator through kernel.solve_shards, "
                     "or gate the request on the mesh_axis parameter"))
    return findings


def _looks_like_logger(base: str) -> bool:
    last = base.rsplit(".", 1)[-1].lstrip("_")
    return last in ("log", "logger", "logging")


def _is_host_effect(name: str) -> bool:
    if name in HOST_EFFECT_ALLOW:
        return False
    if name in HOST_EFFECT_EXACT:
        return True
    return any(name.startswith(p) for p in HOST_EFFECT_PREFIXES)


# ------------------------------------------------------ snapshot reads
def _expr_key(node) -> Optional[str]:
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Subscript):
        base = _dotted(node.value)
        if base and isinstance(node.slice, ast.Constant):
            return f"{base}[{node.slice.value!r}]"
        return None
    return _dotted(node)


def _prefixes(key: str) -> List[str]:
    """`a.b['x']` -> [a.b['x'], a.b, a]."""
    out = [key]
    k = key
    while True:
        cut = max(k.rfind("["), k.rfind("."))
        if cut <= 0:
            break
        k = k[:cut]
        out.append(k)
    return out


def _is_basic_index(sl) -> bool:
    elts = sl.elts if isinstance(sl, ast.Tuple) else [sl]
    return all(isinstance(e, (ast.Slice, ast.Constant)) or (
        isinstance(e, ast.UnaryOp) and isinstance(e.operand, ast.Constant))
        for e in elts)


def snapshot_reads(index: PackageIndex, prov: Provenance, fkey: str,
                   hops: Dict[str, Tuple[int, ...]],
                   rule: str) -> List[Finding]:
    """Linear scan of one function: names bound to the same storage,
    then an in-place op on one of them (directly, or through a call into
    `hops`: function -> parameter positions changed in place), then a
    read of the other.  JIT204 passes the one-hop map
    (`inplace_base`); ALIAS502 the rest of the transitive map."""
    fi = index.functions[fkey]
    # single-assignment local handles of attribute chains (`dn =
    # self._dev_node`) are spellings of the same object, not snapshots
    counts: Dict[str, int] = {}
    handles: Dict[str, str] = {}
    for node in index._own_nodes(fi):
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name):
            name = node.targets[0].id
            counts[name] = counts.get(name, 0) + 1
            if isinstance(node.value, ast.Attribute):
                d = _dotted(node.value)
                if d:
                    handles[name] = d
    handles = {a: t for a, t in handles.items() if counts.get(a) == 1}

    def canon(key: Optional[str]) -> Optional[str]:
        if key is None:
            return None
        for a, full in handles.items():
            if key == a or key.startswith(a + "[") \
                    or key.startswith(a + "."):
                return full + key[len(a):]
        return key

    pairs: Dict[str, Set[str]] = {}
    poisoned: Dict[str, Tuple[int, str]] = {}   # snapshot -> (line, via)
    reported: Set[str] = set()
    out: List[Finding] = []

    def unpair(key: str) -> None:
        for p in pairs.pop(key, set()):
            pairs.get(p, set()).discard(key)
        poisoned.pop(key, None)

    def alias_source(scan: TensorScan, v) -> Optional[str]:
        """The storage key an expression aliases, if it is one of the
        binding forms that share storage."""
        if isinstance(v, (ast.Name, ast.Attribute)):
            if isinstance(v, ast.Attribute) and (
                    v.attr in META_ATTRS or v.attr in _VIEW_ATTRS):
                return (alias_source(scan, v.value)
                        if v.attr in _VIEW_ATTRS else None)
            return canon(_expr_key(v))
        if isinstance(v, ast.Subscript):
            if isinstance(v.slice, ast.Constant) and \
                    isinstance(v.slice.value, str):
                return canon(_expr_key(v))
            if _is_basic_index(v.slice):
                return alias_source(scan, v.value)
            return None
        if isinstance(v, ast.Call):
            f = v.func
            if isinstance(f, ast.Attribute) and f.attr in _VIEW_METHODS \
                    and not scan.is_module(f.value):
                return alias_source(scan, f.value)
            if scan.full(f) in ("torch.as_tensor", "torch.asarray") and \
                    v.args and scan.tensor(v.args[0]) and not any(
                        kw.arg in ("dtype", "device")
                        for kw in v.keywords):
                return alias_source(scan, v.args[0])
        return None

    def mutate(key: Optional[str], line: int, via: str) -> None:
        key = canon(key)
        if key is None:
            return
        for k in _prefixes(key):
            for p in pairs.get(k, ()):
                if p not in _prefixes(key):
                    poisoned.setdefault(p, (line, via))

    def visit(node, scan: TensorScan):
        # reads of a poisoned snapshot
        if isinstance(node, (ast.Name, ast.Subscript, ast.Attribute)) \
                and isinstance(getattr(node, "ctx", None), ast.Load):
            k = canon(_expr_key(node))
            if k is not None:
                for p, (ml, via) in list(poisoned.items()):
                    bare = "[" not in p and "." not in p
                    hit = k == p or (bare and (k.startswith(p + "[")
                                               or k.startswith(p + ".")))
                    if not hit and p.startswith("self.") and (
                            k.startswith(p + "[") or k.startswith(p + ".")):
                        hit = True
                    if hit and node.lineno > ml and p not in reported:
                        reported.add(p)
                        out.append(Finding(
                            rule, fi.module, fi.qual, p, fi.path,
                            node.lineno,
                            f"`{p}` shares its storage with a buffer "
                            f"changed in place on line {ml} ({via}); "
                            "this read sees the new values, not the "
                            "snapshot it was bound to hold",
                            hint="take the snapshot with .clone(), or "
                                 "make the update out of place "
                                 "(index_put, not index_put_)"))
        if isinstance(node, ast.Call):
            f = node.func
            if isinstance(f, ast.Attribute) and is_inplace_method(f.attr) \
                    and not scan.is_module(f.value) and rule == "JIT204":
                mutate(_expr_key(f.value) or _expr_key(_strip(f.value)),
                       node.lineno, f".{f.attr}()")
            if rule == "JIT204":
                for kw in node.keywords:
                    if kw.arg == "out":
                        mutate(_expr_key(kw.value), node.lineno, "out=")
            target = prov.resolve(fi, node)
            if target is not None and target in hops:
                tfi = index.functions[target]
                pn = _param_list(tfi)
                for pos in hops[target]:
                    arg = _arg_for(tfi, node, pn[pos])
                    if arg is not None:
                        mutate(_expr_key(arg) or _expr_key(_strip(arg)),
                               node.lineno, f"{tfi.qual}() in place")
        if rule == "JIT204" and isinstance(node, ast.AugAssign):
            t = node.target
            if isinstance(t, ast.Name) and scan.tensor(t):
                mutate(t.id, node.lineno, "augmented assignment")
            elif isinstance(t, ast.Subscript) and scan.tensor(t.value):
                mutate(_expr_key(_strip(t)), node.lineno,
                       "augmented assignment")
        if isinstance(node, ast.Assign):
            if rule == "JIT204":
                for t in node.targets:
                    if isinstance(t, ast.Subscript) and scan.tensor(
                            t.value):
                        mutate(_expr_key(_strip(t)), node.lineno,
                               "subscript store")
            # the binding itself takes effect at the statement's end;
            # the scan's visit order is source order, so record it now
            # for the keys (the value's own reads come after it but on
            # the same line, before any later line's read)
            _bind_pairs(node, scan)

    def _bind_pairs(node: ast.Assign, scan: TensorScan) -> None:
        for t in node.targets:
            tv = [(t, node.value)]
            if isinstance(t, (ast.Tuple, ast.List)) and isinstance(
                    node.value, (ast.Tuple, ast.List)) and len(
                    t.elts) == len(node.value.elts):
                tv = list(zip(t.elts, node.value.elts))
            elif isinstance(t, (ast.Tuple, ast.List)):
                tv = [(e, None) for e in t.elts]
            for tt, vv in tv:
                tk = canon(_expr_key(tt))
                if tk is None:
                    continue
                if isinstance(tt, ast.Name) and tt.id in handles:
                    continue
                src = alias_source(scan, vv) if vv is not None else None
                unpair(tk)
                if src is not None and src != tk:
                    pairs.setdefault(tk, set()).add(src)
                    pairs.setdefault(src, set()).add(tk)

    TensorScan(prov, fkey, prov.seeds(fkey)).run(visit)
    return out


def _strip(node):
    """The buffer under element/attribute access (`live` of
    `live[0]`, `x` of `x[idx]`)."""
    while isinstance(node, ast.Subscript):
        node = node.value
    return node
