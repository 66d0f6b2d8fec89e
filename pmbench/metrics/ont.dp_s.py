"""ont.dp_s: seconds a sample spends in the program's "align.dp" span, B2's
launches to their rows on the host (the upload, the kernel and the copy of
its direction bytes back) (its records summed over the traced window and
divided by its samples; None where the program keeps no such record)."""

from pmbench import program


def read(trace):
    return program.per_sample_s(trace, "align.dp")
