"""genotype.snps_s: seconds a sample spends in the program's "genotype.snps"
span, the SNP calls over the pileup's columns (its records summed over the
traced window and divided by its samples; None where the program keeps no
such record)."""

from pmbench import program


def read(trace):
    return program.per_sample_s(trace, "genotype.snps")
