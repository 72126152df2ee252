"""wave_ms.stream: the window's solve wall (each pass's wall less its
pack callbacks) over all its waves, ms per wave."""


def read(out):
    layer = out["layer"]
    if not layer.get("waves"):
        return None
    return 1e3 * layer["solve_s"] / layer["waves"]
