"""Opt-in runtime lockdep witness for nomadlint's static lockset pass.

The race pass (``nomad_tpu_torch.analysis.race_pass``) *infers* a guarded-by
map — for each thread-shared attribute, the lock every write provably
holds.  This module is the runtime side of that contract: wrap the
real locks in :class:`InstrumentedLock`, put the interesting attributes
under :func:`watch_class`, run a real multi-threaded workload, and then
cross-check that every recorded access actually held the lock the
static pass claims guards it.  Static says guarded ⇒ the run never saw
an unguarded access; a mismatch means either the analyzer's inference
is wrong (fix the pass) or the code has a real race the type of which
the analyzer models (fix the code).

Nothing in production imports this module.  Tests and debugging runs
wire it in explicitly; the wrappers are pure pass-throughs around the
underlying ``threading`` primitives plus thread-local bookkeeping, so
the workload's locking behaviour is unchanged (only slightly slower).

Lock naming convention: use the static analyzer's canonical ids —
``"ClassName.attr"`` for instance locks (e.g. ``"_Shard._lock"``) and
``"module:name"`` for module-level locks — so recorded held-sets can be
compared against ``infer_guards()`` output without translation.  The
``owner`` token (default: ``id()`` of the owning instance) keeps four
shards that all call their lock ``"_Shard._lock"`` distinct.
"""
from __future__ import annotations

import threading
from typing import Any, Callable, Dict, FrozenSet, Iterable, List, Tuple

__all__ = ["AccessEvent", "InstrumentedLock", "LockdepRecorder",
           "assert_holds", "watch_class"]


class AccessEvent:
    """One attribute access, stamped with the accessing thread's
    held-lock set at the instant of access."""

    __slots__ = ("cls_name", "attr", "owner", "kind", "held", "thread")

    def __init__(self, cls_name: str, attr: str, owner: int, kind: str,
                 held: FrozenSet[Tuple[str, int]], thread: str):
        self.cls_name = cls_name
        self.attr = attr
        self.owner = owner          # id() of the accessed instance
        self.kind = kind            # "read" | "write"
        self.held = held            # frozenset of (lock_name, lock_owner)
        self.thread = thread

    def __repr__(self) -> str:      # pragma: no cover - debugging aid
        return (f"AccessEvent({self.cls_name}.{self.attr} {self.kind} "
                f"held={sorted(n for n, _ in self.held)} "
                f"thread={self.thread})")


class LockdepRecorder:
    """Thread-local held-set bookkeeping plus a global access log.

    ``InstrumentedLock`` wrappers push/pop onto the calling thread's
    held stack; ``watch_class`` descriptors snapshot that stack into
    :class:`AccessEvent` entries.  ``events`` is append-only under an
    internal lock, safe to read after the workload's threads join.
    """

    def __init__(self):
        self._tls = threading.local()
        self._events_lock = threading.Lock()
        self.events: List[AccessEvent] = []

    # ------------------------------------------------- held-set side
    def _stack(self) -> List[Tuple[str, int]]:
        st = getattr(self._tls, "stack", None)
        if st is None:
            st = self._tls.stack = []
        return st

    def held(self) -> FrozenSet[Tuple[str, int]]:
        """(lock_name, owner) pairs the calling thread holds now."""
        return frozenset(self._stack())

    def held_names(self) -> FrozenSet[str]:
        return frozenset(n for n, _ in self._stack())

    def _push(self, name: str, owner: int) -> None:
        self._stack().append((name, owner))

    def _pop(self, name: str, owner: int) -> None:
        st = self._stack()
        # locks may be released out of acquisition order; drop the most
        # recent matching entry (RLock reentrancy pushes twice)
        for i in range(len(st) - 1, -1, -1):
            if st[i] == (name, owner):
                del st[i]
                return

    # --------------------------------------------------- event side
    def record(self, cls_name: str, attr: str, owner: int,
               kind: str) -> None:
        ev = AccessEvent(cls_name, attr, owner, kind, self.held(),
                         threading.current_thread().name)
        with self._events_lock:
            self.events.append(ev)

    def events_for(self, cls_name: str,
                   attr: str) -> List[AccessEvent]:
        with self._events_lock:
            return [e for e in self.events
                    if e.cls_name == cls_name and e.attr == attr]


class InstrumentedLock:
    """Pass-through wrapper around a ``threading`` lock that maintains
    the recorder's per-thread held set.

    Swap it in post-construction (``obj._lock =
    InstrumentedLock(obj._lock, "Cls._lock", rec, owner=id(obj))``);
    code that resolves the attribute at call time (``with self._lock:``)
    picks up the wrapper transparently.
    """

    def __init__(self, inner: Any, name: str, recorder: LockdepRecorder,
                 owner: int = 0):
        self._inner = inner
        self.name = name
        self.owner = owner if owner else id(inner)
        self._recorder = recorder

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        ok = self._inner.acquire(blocking, timeout)
        if ok:
            self._recorder._push(self.name, self.owner)
        return ok

    def release(self) -> None:
        # pop before releasing: once another thread can take the lock,
        # this thread must no longer claim to hold it
        self._recorder._pop(self.name, self.owner)
        self._inner.release()

    def locked(self) -> bool:
        return self._inner.locked()

    def __enter__(self) -> "InstrumentedLock":
        self.acquire()
        return self

    def __exit__(self, *exc: Any) -> None:
        self.release()


def assert_holds(lock: Any) -> None:
    """Assert the calling thread holds ``lock``; raise AssertionError
    otherwise.  Exact for :class:`InstrumentedLock` (per-thread
    bookkeeping) and ``RLock`` (owner check); for a plain ``Lock`` the
    best Python exposes is ``locked()`` — held by *someone* — which
    still catches the forgot-to-acquire bug in ``*_locked`` helpers."""
    if isinstance(lock, InstrumentedLock):
        if (lock.name, lock.owner) not in lock._recorder.held():
            raise AssertionError(
                f"lockdep: {lock.name} not held by "
                f"{threading.current_thread().name}")
        return
    owned = getattr(lock, "_is_owned", None)
    if owned is not None:
        if not owned():
            raise AssertionError(
                "lockdep: RLock not owned by "
                f"{threading.current_thread().name}")
        return
    if not lock.locked():
        raise AssertionError("lockdep: lock not held")


class _Missing:
    pass


_MISSING = _Missing()


class _WatchedAttr:
    """Data descriptor that shadows a plain instance attribute and
    records every get/set with the current held-lock set.

    Values live in the instance ``__dict__`` under a mangled slot so
    the descriptor (which, being a data descriptor, takes precedence
    over instance ``__dict__``) stays in the lookup path.  Instances
    constructed *before* ``watch_class`` keep their original entry
    under the plain name; the getter falls back to it, so watching an
    already-built object graph works as long as the attribute is
    mutated in place rather than rebound (the common case for dict/
    list state guarded by a lock).
    """

    def __init__(self, cls_name: str, attr: str,
                 recorder: LockdepRecorder):
        self._cls_name = cls_name
        self._attr = attr
        self._slot = "__lockdep_" + attr
        self._recorder = recorder

    def __get__(self, obj: Any, objtype: Any = None) -> Any:
        if obj is None:
            return self
        d = obj.__dict__
        if self._slot in d:
            val = d[self._slot]
        elif self._attr in d:
            val = d[self._attr]     # pre-watch instance
        else:
            raise AttributeError(self._attr)
        self._recorder.record(self._cls_name, self._attr, id(obj),
                              "read")
        return val

    def __set__(self, obj: Any, value: Any) -> None:
        obj.__dict__[self._slot] = value
        self._recorder.record(self._cls_name, self._attr, id(obj),
                              "write")


def watch_class(cls: type, attrs: Iterable[str],
                recorder: LockdepRecorder) -> Callable[[], None]:
    """Replace ``attrs`` on ``cls`` with recording descriptors; every
    subsequent get/set on any instance lands in ``recorder.events``
    stamped with the accessing thread's held-lock set.  Returns an
    ``unwatch()`` callable that restores the class exactly."""
    saved: Dict[str, Any] = {}
    for a in attrs:
        saved[a] = cls.__dict__.get(a, _MISSING)
        setattr(cls, a, _WatchedAttr(cls.__name__, a, recorder))

    def unwatch() -> None:
        for a, old in saved.items():
            if old is _MISSING:
                delattr(cls, a)
            else:
                setattr(cls, a, old)

    return unwatch
