"""Minimal 5-field cron expression evaluation.

Supports: "*", "*/n", "a", "a-b", "a-b/n", comma lists, in fields
minute hour day-of-month month day-of-week (0-6, Sunday=0; 7 = Sunday).
Standard cron rule: when both day-of-month and day-of-week are
restricted, a time matches if EITHER matches.

The reference delegates to the cronexpr library for
`job.Periodic.Next` (reference: nomad/periodic.go:228,
nomad/structs/structs.go Job.Periodic); this is the subset its jobspecs
use.  The counterpart of `nomad_tpu.utils.cron`.
"""
from __future__ import annotations

from datetime import datetime, timedelta
from typing import Optional, Set

_FIELD_RANGES = ((0, 59), (0, 23), (1, 31), (1, 12), (0, 7))


class CronParseError(ValueError):
    pass


def _parse_field(spec: str, lo: int, hi: int) -> Set[int]:
    out: Set[int] = set()
    for part in spec.split(","):
        step = 1
        stepped = "/" in part
        if stepped:
            part, step_s = part.split("/", 1)
            try:
                step = int(step_s)
            except ValueError:
                raise CronParseError(f"bad step {step_s!r}")
            if step <= 0:
                raise CronParseError(f"bad step {step}")
        if part == "*":
            lo2, hi2 = lo, hi
        elif "-" in part:
            a, b = part.split("-", 1)
            try:
                lo2, hi2 = int(a), int(b)
            except ValueError:
                raise CronParseError(f"bad range {part!r}")
        else:
            try:
                lo2 = hi2 = int(part)
            except ValueError:
                raise CronParseError(f"bad value {part!r}")
            if stepped:
                # cronexpr semantics: "a/n" means the range a..max stepped
                # by n, not the single value a
                hi2 = hi
        if lo2 < lo or hi2 > hi or lo2 > hi2:
            raise CronParseError(f"value out of range: {part!r}")
        out.update(range(lo2, hi2 + 1, step))
    return out


class Cron:
    def __init__(self, expr: str):
        fields = expr.split()
        if len(fields) != 5:
            raise CronParseError(
                f"want 5 cron fields, got {len(fields)}: {expr!r}")
        self.expr = expr
        (self.minutes, self.hours, self.dom, self.months,
         self.dow) = (_parse_field(f, lo, hi)
                      for f, (lo, hi) in zip(fields, _FIELD_RANGES))
        if 7 in self.dow:            # 7 is an alias for Sunday
            self.dow = (self.dow - {7}) | {0}
        # standard rule: dom/dow OR each other only when both restricted
        self.dom_star = fields[2] == "*"
        self.dow_star = fields[4] == "*"

    def _day_matches(self, dt: datetime) -> bool:
        # python weekday(): Monday=0; cron: Sunday=0
        dow = (dt.weekday() + 1) % 7
        dom_ok = dt.day in self.dom
        dow_ok = dow in self.dow
        if self.dom_star and self.dow_star:
            return True
        if self.dom_star:
            return dow_ok
        if self.dow_star:
            return dom_ok
        return dom_ok or dow_ok

    def next(self, after: datetime) -> Optional[datetime]:
        """First matching time strictly after `after` (minute granularity),
        or None if none within ~5 years."""
        t = after.replace(second=0, microsecond=0) + timedelta(minutes=1)
        for _ in range(366 * 5 + 2):
            if t.month in self.months and self._day_matches(t):
                # scan this day's matching (hour, minute) slots
                for hour in sorted(self.hours):
                    if hour < t.hour:
                        continue
                    for minute in sorted(self.minutes):
                        if hour == t.hour and minute < t.minute:
                            continue
                        return t.replace(hour=hour, minute=minute)
            # advance to next day at 00:00
            t = (t + timedelta(days=1)).replace(hour=0, minute=0)
        return None
