"""eval_p95_ms.server: the 95th percentile, over every register call of
the window, of the benchmark's clock from the call to its eval done."""
import numpy as np


def read(out):
    ms = out["layer"].get("eval_ms")
    if not ms:
        return None
    return float(np.percentile(ms, 95))
