"""device.kernel_ms: kernel time on the card a sample (the profiler's
kernel durations summed over the traced window, copies and sets left
out, divided by the window's samples), in milliseconds."""


def read(trace):
    k = trace.kernels()
    if not k or not trace.n_samples:
        return None
    return 1e3 * sum(b - a for _, a, b in k) / trace.n_samples
