"""b2.roofline_pct: kernel B2's share of its roofline over the traced
window: the least time of each launch (roofline_long.long_bound_s of its
items' query lengths and bands) summed, over the kernel's time summed
from the profiler's trace, in percent.  None where B2 did not run, or
where the trace does not hold one kernel event for each launch."""

from pmbench import roofline_long


def read(trace):
    items = trace.launches.get("banded_long", [])
    events = [b - a for n, a, b in trace.kernels()
              if "banded_long_kernel" in n]
    if not items or len(events) != len(items) or sum(events) <= 0:
        return None
    return 100.0 * sum(roofline_long.long_bound_s(lq, w)
                       for lq, w in items) / sum(events)
