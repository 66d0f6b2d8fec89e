"""ont.traceback_s: seconds a sample spends in the program's "align.traceback"
span, the z-drop replay and the traceback of the direction bytes on the
host (its records summed over the traced window and divided by its samples;
None where the program keeps no such record)."""

from pmbench import program


def read(trace):
    return program.per_sample_s(trace, "align.traceback")
