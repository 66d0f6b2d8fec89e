"""The program's own spans (panmap_tpu_torch/trace.py), for the per-layer
metrics that read them.

While the traced window's profiler records, the program keeps a record of
each of its spans: name, start and end (perf_counter nanoseconds), parent,
pid, sample and counts; a forked batch worker's records come back to the
main process with the worker's result.  The first reader takes the
window's records from the program (trace.take(), which empties its store)
and keeps them on the Trace for the others.  A program without that module
gives no records, and every reader of them returns None.
"""

from __future__ import annotations


def records(trace) -> list:
    """The program's span records of the traced window ([] where the
    program keeps none)."""
    got = getattr(trace, "program_records", None)
    if got is None:
        try:
            from panmap_tpu_torch import trace as spans
        except ImportError:
            got = []
        else:
            got = spans.take()
        trace.program_records = got
    return got


def named(trace, name: str) -> list:
    return [r for r in records(trace) if r["name"] == name]


def per_sample_s(trace, name: str) -> float | None:
    """Seconds a sample spends in the span ``name``: the durations of the
    window's records of that name summed, over the window's samples; None
    where there is no such record."""
    recs = named(trace, name)
    if not recs or not trace.n_samples:
        return None
    return sum(r["end_ns"] - r["start_ns"] for r in recs) / 1e9 / \
        trace.n_samples


def count(trace, name: str, key: str) -> int | None:
    """The count ``key`` summed over the window's records of span
    ``name``; None where no such record counts it."""
    got = [r["counts"][key] for r in named(trace, name)
           if key in r["counts"]]
    return sum(got) if got else None
