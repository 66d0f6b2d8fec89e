"""batch.worker_s: seconds a sample spends in the program's "batch.worker"
span, a forked worker's alignment, genotyping and consensus of a sample
(its records summed over the traced window and divided by its samples; None
where the program keeps no such record)."""

from pmbench import program


def read(trace):
    return program.per_sample_s(trace, "batch.worker")
