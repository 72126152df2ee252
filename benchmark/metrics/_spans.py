"""Shared by the span readers: one span's numbers over the window's
evals, from the flight recorder's traces."""


def mean_ms(out, fn):
    vals = []
    for spans in out["layer"]["spans"].values():
        by = {}
        for s in spans:
            by.setdefault(s["name"], s)
        v = fn(by)
        if v is not None:
            vals.append(v)
    return 1e3 * sum(vals) / len(vals) if vals else None
