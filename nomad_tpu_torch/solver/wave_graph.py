"""CUDA graphs for the wave loop's fixed-shape stretches.

A single-lane wave solve on a CUDA device issues about 150 small torch
ops a wave, and the host's time to issue them, not the card's to run
them, sets its pace.  Between two host decisions the wave body has fixed
shapes for a given solve signature, so it can be captured once as a CUDA
graph (`torch.cuda.CUDAGraph`) and replayed as one launch.

This module holds what is generic about that:

  `Segment`  one captured stretch: a pure function over fixed buffers,
             its static outputs, and a commit that copies the carried
             state back into the buffers inside the same graph;
  `Plans`    the signature cache: a signature's first solve runs eagerly
             (and so warms every op up), its second builds a plan and
             captures, later ones replay.  Bounded, least recently used
             evicted; a plan serves one solve at a time.

What a plan holds and which stretches it captures is the solve's own
business (`kernel.solve_steps`).  A graph bakes every device address it
reads, so a captured function may read nothing but the plan's buffers:
per-solve inputs are copied into them before the first replay of each
solve, and a result never aliases them.
"""
from __future__ import annotations

import collections
import threading
from typing import Callable, Optional

import torch

from . import seg_kernel as _sk

#: solve signatures whose plans are kept (least recently used evicted)
PLANS_MAX = 8
#: signatures remembered as seen once (their second solve captures)
SEEN_MAX = 64

#: test hook: run the graph path on the CPU, where a replay re-runs the
#: captured function on the same buffers and copies its results into the
#: first run's outputs (the CPU has no graphs; the path's buffers, copies
#: and counters are the same)
EMULATE = False


def engages(device: torch.device) -> bool:
    """Whether a solve on `device` may run its waves as graphs."""
    return device.type == "cuda" or EMULATE


def leaves(x):
    """The tensors of a nest of tuples, lists and dicts, in order."""
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (tuple, list)):
        for y in x:
            yield from leaves(y)
    elif isinstance(x, dict):
        for key in sorted(x):
            yield from leaves(x[key])


def copy_nest(dst, src) -> None:
    """Copy every tensor of `src` into the tensor at the same place of
    `dst`, a nest of the same structure, skipping a tensor that is its
    own target.  A source that shares storage with any target is cloned
    first, so the copies can run in any order."""
    pairs = []

    def walk(d, s):
        if isinstance(d, torch.Tensor):
            if d is not s:
                pairs.append((d, s))
        elif isinstance(d, (tuple, list)):
            for a, b in zip(d, s, strict=True):
                walk(a, b)
        elif d is not None or s is not None:
            raise TypeError(f"copy_nest: {type(d)} against {type(s)}")

    walk(dst, src)
    targets = {d.untyped_storage().data_ptr() for d, _ in pairs}
    pairs = [(d, s.clone() if s.untyped_storage().data_ptr() in targets
              else s) for d, s in pairs]
    for d, s in pairs:
        d.copy_(s)


class Segment:
    """One captured stretch.  `pure()` computes the stretch's results
    from fixed buffers without writing any; `commit(out)` writes the
    carried state back into the buffers.  On CUDA both are captured as
    one graph after a warm-up run of `pure` on the capture stream (lazy
    initialisation stays out of the capture); `out` holds the graph's
    static outputs, rewritten by every `replay()`.  Capturing does not
    run the stretch: replay it.  `launches` holds the counted kernel
    launches (`seg_kernel.LAUNCHES`) the capture recorded, which each
    replay counts again."""

    def __init__(self, device: torch.device, pure: Callable,
                 commit: Callable):
        self.graph = None
        self.out = None
        self.launches = collections.Counter()
        if device.type != "cuda":
            self._pure, self._commit = pure, commit
            return
        cur = torch.cuda.current_stream(device)
        side = torch.cuda.Stream(device)
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            pure()
            graph = torch.cuda.CUDAGraph()
            before = _sk.captured()
            graph.capture_begin(capture_error_mode="thread_local")
            try:
                out = pure()
                commit(out)
            finally:
                graph.capture_end()
        cur.wait_stream(side)
        self.graph, self.out = graph, out
        self.launches = _sk.captured() - before

    def replay(self):
        """Run the stretch; its outputs (static on CUDA)."""
        if self.graph is not None:
            self.graph.replay()
            _sk.replayed(self.launches)
            return self.out
        out = self._pure()
        self._commit(out)
        if self.out is None:
            self.out = out
        else:
            for d, s in zip(leaves(self.out), leaves(out)):
                d.copy_(s)
        return self.out


class Plan:
    """What a signature's graphed solves share: the buffers `bufs` (made
    by the solve), the captured segments by key, and the use lock.
    `acquire()` takes the plan for one solve, or refuses while another
    solve holds it; `release()` marks the end of the solve's work on the
    current stream, which the next solve's stream waits for.  A capture
    that fails raises, as a failed kernel launch does: no solve falls
    back to the eager waves behind its caller's back."""

    def __init__(self, device: torch.device, bufs):
        self.device = device
        self.bufs = bufs
        self.segments: dict = {}
        self._lock = threading.Lock()
        self._done: Optional[torch.cuda.Event] = None

    def acquire(self) -> bool:
        if not self._lock.acquire(blocking=False):
            return False
        if self._done is not None:
            torch.cuda.current_stream(self.device).wait_event(self._done)
        return True

    def release(self) -> None:
        if self.device.type == "cuda":
            self._done = torch.cuda.Event()
            self._done.record(torch.cuda.current_stream(self.device))
        self._lock.release()

    def segment(self, key, pure: Callable, commit: Callable):
        """(the segment under `key`, whether this call captured it)."""
        seg = self.segments.get(key)
        if seg is not None:
            return seg, False
        seg = self.segments[key] = Segment(self.device, pure, commit)
        return seg, True


class Plans:
    """The signature cache.  `sight(sig, make)` returns the plan for
    `sig`, acquired, or None: at the signature's first sighting (the
    solve runs eagerly, which warms its ops up) or while another solve
    holds the plan.  The second sighting builds the plan with `make()`.
    At most PLANS_MAX plans and SEEN_MAX first sightings are kept, the
    least recently used dropped first."""

    def __init__(self):
        self._seen: collections.OrderedDict = collections.OrderedDict()
        self._plans: collections.OrderedDict = collections.OrderedDict()
        self._lock = threading.Lock()

    def sight(self, sig, make: Callable[[], Plan]) -> Optional[Plan]:
        with self._lock:
            plan = self._plans.get(sig)
            if plan is not None:
                self._plans.move_to_end(sig)
            elif sig in self._seen:
                del self._seen[sig]
                plan = self._plans[sig] = make()
                while len(self._plans) > PLANS_MAX:
                    self._plans.popitem(last=False)
            else:
                self._seen[sig] = True
                while len(self._seen) > SEEN_MAX:
                    self._seen.popitem(last=False)
                return None
        return plan if plan.acquire() else None

    def clear(self) -> None:
        with self._lock:
            self._seen.clear()
            self._plans.clear()

    def __len__(self) -> int:
        with self._lock:
            return len(self._plans)


#: the process's plans, over every device
PLANS = Plans()
