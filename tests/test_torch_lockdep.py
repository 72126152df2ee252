"""The reference's tests/test_lockdep.py on both packages: the runtime
lockdep witness (`utils.lockdep`: `InstrumentedLock`, `LockdepRecorder`,
`watch_class`, `assert_holds`) and its cross-check against the race
pass's static guarded-by map on the 4 x 4 broker storm, the port's
`EvalBroker` / `_Shard` against the port's own `race_pass.infer_guards`.

Each reference case runs once on the JAX package and once on the port
(`pkg` = "ref" / "port"; tests/torch_twin.py).
"""
from tests.torch_twin import pin_port_to_cpu, twin_cases  # noqa: F401

globals().update(twin_cases("tests.test_lockdep"))
