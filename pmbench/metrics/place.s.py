"""place.s: seconds a sample spends in the "place" span (host clock, summed
over the traced window's samples and divided by their number)."""


def read(trace):
    return trace.per_sample("place")
