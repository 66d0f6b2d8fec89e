"""sw.roofline_pct: kernel B1's share of its roofline over the traced
window: the least time of each launch (roofline.sw_bound_s of the launch's
rows x query length x window) summed, over the kernel's time summed from
the profiler's trace, in percent.  None where B1 did not run, or where the
trace does not hold one kernel event for each launch."""

from pmbench import roofline


def read(trace):
    shapes = trace.launches.get("banded_sw", [])
    events = [b - a for n, a, b in trace.kernels() if "banded_sw_kernel" in n]
    if not shapes or len(events) != len(shapes) or sum(events) <= 0:
        return None
    return 100.0 * sum(roofline.sw_bound_s(*s) for s in shapes) / sum(events)
