"""meta.upload_s: seconds a sample spends in the program's "meta.upload" span,
the device scorer's one upload of events, carries and read keys (its
records summed over the traced window and divided by its samples; None
where the program keeps no such record)."""

from pmbench import program


def read(trace):
    return program.per_sample_s(trace, "meta.upload")
