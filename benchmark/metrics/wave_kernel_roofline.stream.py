"""wave_kernel_roofline.stream: the fused wave kernels' bytes-bound time
(each input read once, each output written once, at the H100's 3.35
TB/s) over their device time in the traced pass, in %."""
from benchmark import devtrace, peaks


def read(out):
    traced = out["layer"].get("traced")
    if not traced or not traced["wave_bytes"]:
        return None
    t = devtrace.kernel_seconds(traced["summary"], r"wave_\w+_kernel")
    if t <= 0:
        return None
    return 100.0 * traced["wave_bytes"] / peaks.HBM_BYTES_S / t
