"""place.sketch_s: seconds a sample spends in the program's "place.sketch"
span, the host read sketch: the reads' placement seeds and their counts
(its records summed over the traced window and divided by its samples; None
where the program keeps no such record)."""

from pmbench import program


def read(trace):
    return program.per_sample_s(trace, "place.sketch")
