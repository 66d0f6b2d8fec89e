"""ont.columns_s: seconds a sample spends in the program's "genotype.columns"
span, the columnar pileup walk, quality shaping, errmod and the tallies,
the card's included, at long-read shapes (its records summed over the
traced window and divided by its samples; None where the program keeps no
such record)."""

from pmbench import program


def read(trace):
    return program.per_sample_s(trace, "genotype.columns")
