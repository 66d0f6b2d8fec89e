"""meta.keys_s: seconds a sample spends in the program's "meta.keys" span, the
device scorer's event order, read key slots and chunk carries on the host
(its records summed over the traced window and divided by its samples; None
where the program keeps no such record)."""

from pmbench import program


def read(trace):
    return program.per_sample_s(trace, "meta.keys")
