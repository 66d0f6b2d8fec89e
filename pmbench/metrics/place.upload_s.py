"""place.upload_s: seconds a sample spends in the program's "place.upload"
span, the placer's index upload (TorchPlacer's device index and eligibility
masks), once a CLI call (its records summed over the traced window and
divided by its samples; None where the program keeps no such record)."""

from pmbench import program


def read(trace):
    return program.per_sample_s(trace, "place.upload")
