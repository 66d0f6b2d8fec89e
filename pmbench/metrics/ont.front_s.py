"""ont.front_s: seconds a sample spends in the program's "align.front" span,
the long reads' minimizer anchors and chains on the host (the chain front
end) (its records summed over the traced window and divided by its samples;
None where the program keeps no such record)."""

from pmbench import program


def read(trace):
    return program.per_sample_s(trace, "align.front")
