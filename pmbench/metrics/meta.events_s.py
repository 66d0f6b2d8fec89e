"""meta.events_s: seconds a sample spends in the program's "meta.events" span,
the read hashes found in the meta index and their presence events (its
records summed over the traced window and divided by its samples; None
where the program keeps no such record)."""

from pmbench import program


def read(trace):
    return program.per_sample_s(trace, "meta.events")
