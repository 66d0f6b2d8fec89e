"""meta.prep_s: seconds a sample spends in the "meta.prep" span (host clock, summed
over the traced window's samples and divided by their number)."""


def read(trace):
    return trace.per_sample("meta.prep")
