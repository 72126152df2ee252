"""Named injection sites: how scripted faults reach code that has no
natural external hook.  The counterpart of `nomad_tpu.chaos.injection`,
with the same semantics.

Product code consults a site by name on its hot path; the common case
(nothing armed) is one dict lookup returning None, so sites are safe
to leave in production paths.  A site is armed with a *budget* (how
many times it fires before disarming itself) so a one-shot "stuck
solve" does not wedge every subsequent solve.

Kinds understood by `Injection.fire`:
  * "sleep"  — block for args["sleep_s"] (slow/stuck solves; a stuck
               solve is a sleep longer than the watchdog deadline)
  * "raise"  — raise ChaosInjected (poisoned solve / poisoned eval)
  * "mutate" — no built-in effect; the consulting site reads
               `inj.args` and applies its own corruption (delta-row
               corruption reads args["rows"])

Sites currently consulted:
  * "device_solve"    — inside the device branch of the solve path
                        (solver/solve.py _run_kernel), just before
                        solve_kernel, under the watchdog deadline
  * "delta_row"       — ResidentSolver.apply_delta: corrupts the rows
                        bound for the card after the host template took
                        the clean apply
  * "rpc_transport"   — RpcClient._call_once (a transient transport
                        failure for the retry loop)
"""
from __future__ import annotations

import threading
import time
from typing import Dict, Optional


class ChaosInjected(Exception):
    """Raised by a "raise"-kind injection — distinguishable from real
    faults so harnesses can assert the failure path they triggered."""


class Injection:
    __slots__ = ("site", "kind", "args", "remaining", "fired")

    def __init__(self, site: str, kind: str, budget: int = 1,
                 **args):
        self.site = site
        self.kind = kind
        self.args = args
        self.remaining = int(budget)
        self.fired = 0

    def fire(self) -> None:
        """Apply the effect (called by the consulting site)."""
        self.fired += 1
        if self.kind == "sleep":
            time.sleep(float(self.args.get("sleep_s", 0.0)))
        elif self.kind == "raise":
            raise ChaosInjected(f"injected fault at {self.site}")
        # "mutate": effect applied by the consulting site via .args


class InjectionRegistry:
    """Thread-safe site table.  `get` pops one firing off the armed
    injection's budget and returns it (None when the site is idle) —
    consult-then-fire is a single atomic claim so concurrent solvers
    cannot double-spend a one-shot fault."""

    def __init__(self):
        self._sites: Dict[str, Injection] = {}
        self._lock = threading.Lock()
        self.counters: Dict[str, int] = {}

    def arm(self, site: str, kind: str, budget: int = 1,
            **args) -> Injection:
        inj = Injection(site, kind, budget, **args)
        with self._lock:
            self._sites[site] = inj
        return inj

    def disarm(self, site: str) -> None:
        with self._lock:
            self._sites.pop(site, None)

    def get(self, site: str) -> Optional[Injection]:
        with self._lock:
            inj = self._sites.get(site)
            if inj is None or inj.remaining <= 0:
                return None
            inj.remaining -= 1
            if inj.remaining <= 0:
                self._sites.pop(site, None)
            self.counters[site] = self.counters.get(site, 0) + 1
        return inj

    def armed(self, site: str) -> bool:
        with self._lock:
            inj = self._sites.get(site)
            return inj is not None and inj.remaining > 0

    def reset(self) -> None:
        with self._lock:
            self._sites.clear()
            self.counters.clear()


#: process-wide registry (idle unless a chaos harness arms a site)
global_injections = InjectionRegistry()
