"""device_idle.stream: the share of the traced pass with no operation
on the card, in %."""


def read(out):
    traced = out["layer"].get("traced")
    if not traced:
        return None
    s = traced["summary"]
    if s["busy_s"] <= 0 or s["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - s["busy_s"] / s["window_s"])
