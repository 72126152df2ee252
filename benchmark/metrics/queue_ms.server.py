"""queue_ms.server: the mean over the window's evals of the
`broker.dequeue` span's start less the `create` span's start."""
from benchmark.metrics import _spans


def read(out):
    def q(by):
        if "create" in by and "broker.dequeue" in by:
            return by["broker.dequeue"]["t_start"] - by["create"]["t_start"]
        return None
    return _spans.mean_ms(out, q)
