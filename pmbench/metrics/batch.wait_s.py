"""batch.wait_s: seconds a sample spends in the program's "batch.wait" span,
the main process's wait for a forked worker's result (its records summed
over the traced window and divided by its samples; None where the program
keeps no such record)."""

from pmbench import program


def read(trace):
    return program.per_sample_s(trace, "batch.wait")
