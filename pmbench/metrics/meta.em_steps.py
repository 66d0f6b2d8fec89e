"""meta.em_steps: SQUAREM steps of the abundance EM a sample (the "steps"
count of the program's "meta.em" spans summed over the traced window and
divided by its samples).  None where the program keeps no such record."""

from pmbench import program


def read(trace):
    steps = program.count(trace, "meta.em", "steps")
    if steps is None or not trace.n_samples:
        return None
    return steps / trace.n_samples
