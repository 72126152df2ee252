"""plan_submit_ms.server: the mean `plan.submit` span over the window's
evals (plan queue, applier, raft and the FSM's apply)."""
from benchmark.metrics import _spans


def read(out):
    return _spans.mean_ms(
        out, lambda by: (by["plan.submit"]["dur_s"] if "plan.submit" in by
                         else None))
