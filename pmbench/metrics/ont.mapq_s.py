"""ont.mapq_s: seconds a sample spends in the program's "align.mapq" span,
each read's alignment made from its DP, mapq included (its records summed
over the traced window and divided by its samples; None where the program
keeps no such record)."""

from pmbench import program


def read(trace):
    return program.per_sample_s(trace, "align.mapq")
