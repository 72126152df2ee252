"""reconcile_ms.server: the fused rounds' `coordinator.stage.reconcile_s`
over the window, its sum over its count, in ms."""

KEY = "coordinator.stage.reconcile_s"


def read(out):
    h0 = out["layer"]["metrics0"]["histograms"].get(KEY)
    h1 = out["layer"]["metrics1"]["histograms"].get(KEY)
    if h1 is None:
        return None
    s0, c0 = (h0["sum"], h0["count"]) if h0 else (0.0, 0)
    if h1["count"] <= c0:
        return None
    return 1e3 * (h1["sum"] - s0) / (h1["count"] - c0)
