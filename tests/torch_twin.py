"""Run a reference test module's cases on both packages.

`twin_cases("tests.test_x")` loads the reference module and a copy of its
source with every `nomad_tpu` module path turned into `nomad_tpu_torch`
(the port's copy of each module sits under the same name), and returns
one test per reference case, parametrised over `pkg` = "ref" / "port":
the same scenario, the same assertions, once against each package.  A
case passes only where both packages reach the reference's outcome.
The reference's own parametrisations and marks carry over; a fixture
the reference module defines must be defined by the twin file under the
same name (it then serves both sides).

`pin_port_to_cpu` is the fixture that points the port's default solver
device at the CPU: the port's entry points run on `cuda` unless the
caller asks, and the reference's scenarios never ask.
"""
import importlib
import inspect
import re
import sys
import types

import pytest


def port_module(ref_name, transform=None):
    """(reference module, its port copy)."""
    ref = importlib.import_module(ref_name)
    with open(ref.__file__) as f:
        src = f.read()
    src = re.sub(r"\bnomad_tpu\b", "nomad_tpu_torch", src)
    if transform is not None:
        src = transform(src)
    name = ref_name.rsplit(".", 1)[0] + ".port_of_" + ref_name.rsplit(
        ".", 1)[1]
    mod = types.ModuleType(name)
    mod.__file__ = ref.__file__
    sys.modules[name] = mod
    exec(compile(src, f"{ref.__file__} (port copy)", "exec"), mod.__dict__)
    return ref, mod


def twin(ref_fn, port_fn, per_pkg=()):
    """One test running `ref_fn` or `port_fn` by `pkg`; a fixture named
    in `per_pkg` yields {"ref": ..., "port": ...} and each side gets its
    own value."""
    sig = inspect.signature(port_fn)

    def case(pkg, **kw):
        kw = {k: (v[pkg] if k in per_pkg else v) for k, v in kw.items()}
        (ref_fn if pkg == "ref" else port_fn)(**kw)

    case.__name__ = case.__qualname__ = port_fn.__name__
    case.__doc__ = port_fn.__doc__
    case.__signature__ = sig.replace(parameters=[inspect.Parameter(
        "pkg", inspect.Parameter.POSITIONAL_OR_KEYWORD)] + list(
            sig.parameters.values()))
    case.pytestmark = list(getattr(port_fn, "pytestmark", [])) + [
        pytest.mark.parametrize("pkg", ["ref", "port"])]
    return case


def twin_cases(ref_name, exclude=(), transform=None, per_pkg=(),
               modules=None):
    """{test name: twin case} for every `test_*` function of the
    reference module but those in `exclude` (or whose name starts with
    one of them); `modules` is a (reference, port copy) pair already
    loaded by `port_module`."""
    ref, port = modules or port_module(ref_name, transform)
    return {name: twin(fn, getattr(port, name), per_pkg)
            for name, fn in vars(ref).items()
            if name.startswith("test_") and inspect.isfunction(fn)
            and not name.startswith(tuple(exclude))}


@pytest.fixture(autouse=True)
def pin_port_to_cpu(monkeypatch):
    from nomad_tpu_torch.parallel import sharded
    from nomad_tpu_torch.solver import resident, solve
    real = solve.resolve_device

    def on_cpu(device=None):
        return real("cpu" if device is None else device)

    for mod in (solve, resident, sharded):
        monkeypatch.setattr(mod, "resolve_device", on_cpu)
