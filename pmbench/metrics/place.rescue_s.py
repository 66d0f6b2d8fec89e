"""place.rescue_s: seconds a sample spends in the program's "place.rescue"
span, the exact float64 rescue of the placement candidates on the host (its
records summed over the traced window and divided by its samples; None
where the program keeps no such record)."""

from pmbench import program


def read(trace):
    return program.per_sample_s(trace, "place.rescue")
