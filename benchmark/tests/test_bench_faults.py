"""A run with the timed path broken underneath comes out not correct:
for each fault the cell can have, planted in the port's own code for
the length of one run (the chip lookup skipped, everything else as a
run drives it)."""
import copy
import contextlib

import pytest
import torch

from benchmark.tests import _small


@contextlib.contextmanager
def patched(obj, name, make):
    real = getattr(obj, name)
    setattr(obj, name, make(real))
    try:
        yield
    finally:
        setattr(obj, name, real)


def stream_state_unchanged(real):
    """Each dispatch leaves the carried usage as it found it."""
    def f(self, batches, *a, **kw):
        before = self._used.clone()
        out = real(self, batches, *a, **kw)
        self._used = before
        return out
    return f


def stream_half_left_out(real):
    """Each dispatch solves the first half of its placements only."""
    def f(self, batches, *a, **kw):
        halves = []
        for pb in batches:
            pb = copy.copy(pb)
            pb.n_place = pb.n_place // 2
            halves.append(pb)
        return real(self, halves, *a, **kw)
    return f


def answer_altered(real):
    """The first placement of each batch is sent one node further."""
    def f(out):
        choice, ok, score, status = real(out)
        choice = choice.copy()
        choice[:, 0, 0] = (choice[:, 0, 0] + 1) % 8
        return choice, ok, score, status
    return f


def server_answer_altered(real):
    """Each solve's first ask row is sent to other nodes."""
    def f(pb, *a, **kw):
        res, backend = real(pb, *a, **kw)
        rows = torch.as_tensor(pb.p_ask[:res.choice.shape[0]]) == 0
        choice = res.choice.clone()
        choice[rows.to(choice.device), 0] = (choice[rows.to(choice.device),
                                                    0] + 7) % 64
        return res._replace(choice=choice), backend
    return f


def server_half_left_out(real):
    """Each solve places the first half of its placements only."""
    def f(pb, *a, **kw):
        half = copy.copy(pb)
        half.n_place = pb.n_place // 2
        return real(half, *a, **kw)
    return f


def stream_faults():
    from nomad_tpu_torch.solver import resident
    R = resident.ResidentSolver
    return {
        "state_unchanged": (R, "solve_stream_async", stream_state_unchanged),
        "half_left_out": (R, "solve_stream_async", stream_half_left_out),
        "answer_altered": (resident, "unpack_stream", answer_altered),
    }


def server_faults():
    from nomad_tpu_torch.solver import solve
    return {
        "answer_altered": (solve, "_run_kernel_routed",
                           server_answer_altered),
        "half_left_out": (solve, "_run_kernel_routed",
                          server_half_left_out),
    }


@pytest.mark.parametrize("fault", ["state_unchanged", "half_left_out",
                                   "answer_altered"])
def test_a_broken_stream_is_not_correct(fault):
    obj, name, make = stream_faults()[fault]
    with patched(obj, name, make):
        r = _small.run("c2-stream", seconds=1.0)
    assert not r["correct"], r["checks"]


@pytest.mark.parametrize("fault", ["half_left_out", "answer_altered"])
def test_a_broken_server_is_not_correct(fault):
    obj, name, make = server_faults()[fault]
    with patched(obj, name, make):
        r = _small.run("c3-server-burst", seconds=2.0)
    assert not r["correct"], r["checks"]
