"""device.idle_pct: the share of the traced window in which no operation
(kernel, copy or set) ran on the card, from the union of the profiler's
device intervals, in percent.  None where the trace holds no device
operation."""


def read(trace):
    if not trace.device_ops:
        return None
    return 100.0 * (trace.window_s - trace.busy_s) / trace.window_s
