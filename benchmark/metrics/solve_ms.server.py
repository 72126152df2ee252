"""solve_ms.server: the mean `solve` span over the window's evals."""
from benchmark.metrics import _spans


def read(out):
    return _spans.mean_ms(
        out, lambda by: by["solve"]["dur_s"] if "solve" in by else None)
