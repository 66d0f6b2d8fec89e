"""ont.indels_s: seconds a sample spends in the program's "genotype.indels"
span, the indel calls and their realignment at long-read shapes (its
records summed over the traced window and divided by its samples; None
where the program keeps no such record)."""

from pmbench import program


def read(trace):
    return program.per_sample_s(trace, "genotype.indels")
