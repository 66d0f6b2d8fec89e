"""align.s: seconds a sample spends in the "align" span (host clock, summed
over the traced window's samples and divided by their number)."""


def read(trace):
    return trace.per_sample("align")
