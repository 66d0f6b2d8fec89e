"""sw.survivor_pct: the share of the rows kernel B1 scored that pass the
MIN_DP_MAX gate to the host traceback (survivors over device_scored of the
program's "align.sw" spans, summed over the traced window), in percent:
100 means the SW stage drops nothing.  None where no row was scored on the
card."""

from pmbench import program


def read(trace):
    scored = program.count(trace, "align.sw", "device_scored")
    if not scored:
        return None
    return 100.0 * (program.count(trace, "align.sw", "survivors") or 0) / \
        scored
