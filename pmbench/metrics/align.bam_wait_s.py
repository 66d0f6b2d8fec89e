"""align.bam_wait_s: seconds a sample spends in the program's "align.bam_wait"
span, the wait for the BAM writer thread after genotyping (its records
summed over the traced window and divided by its samples; None where the
program keeps no such record)."""

from pmbench import program


def read(trace):
    return program.per_sample_s(trace, "align.bam_wait")
