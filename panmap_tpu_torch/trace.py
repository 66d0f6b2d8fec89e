"""The port's spans: named intervals of its own stages, each with the counts
of its work, recorded while a torch.profiler session records in this
process (--profile, or a caller's own profiler) and never otherwise.

    with trace.span("place.sketch") as sp:
        ...
        sp.count("reads", len(seqs))

A span's record holds its name, its start and end (time.perf_counter_ns),
its id and its parent's (the span open on this thread, or the span that
started the thread or the task: carry(), resumed()), the thread and the
pid, the sample (0 for a single sample, the manifest line in --batch) and
its counts.  While it is open it is also a profiler range "panmap:<name>"
on the profiler's own clock, so a --profile trace names the stages.  The
range is a function-scope one, not a user annotation: the profiler gives a
user annotation a device-side twin that spans every kernel launched inside
it, which a reader of the device timeline would take for device work.
Records stay in memory until take().

Off, span() is one check of the profiler's state and returns a shared
no-op; it opens no range and keeps nothing.  A span never synchronizes the
device: one around a wait on the card (a .cpu()) shows the wait itself.

The profiler records the thread that started it only.  A helper thread's
spans are on when the function it runs was wrapped by carry() where tracing
was on; they are kept, but open no range.  A forked worker inherits the
profiler's flag but not the profiler: in a process other than the one that
imported this module, spans are on only under resumed(ctx) with a context
from the parent (here()), are kept in memory only, and go back to the
parent with the task's result (take() there, adopt() here).
"""

from __future__ import annotations

import contextlib
import functools
import itertools
import os
import threading
import time

import torch

_profiling = torch._C._autograd._profiler_enabled
_PID = os.getpid()
_ids = itertools.count(1)
_records: list = []
_local = threading.local()


class _Off:
    """The shared span of a run that is not traced."""

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def count(self, key, n):
        pass


_OFF = _Off()


def _stack() -> list:
    st = getattr(_local, "stack", None)
    if st is None:
        st = _local.stack = []
    return st


def _context():
    """(span id, sample) of the innermost span open on this thread, else of
    what the thread resumed; None where nothing is open."""
    st = getattr(_local, "stack", None)
    if st:
        return st[-1].id, st[-1].sample
    return getattr(_local, "origin", None)


def _on() -> bool:
    if getattr(_local, "origin", None) is not None:
        return True
    return _profiling() and os.getpid() == _PID


class Span:
    """An open span; count(key, n) adds to its counts."""

    __slots__ = ("name", "sample", "counts", "id", "parent", "start",
                 "_range")

    def __init__(self, name, sample, counts):
        self.name = name
        self.sample = sample
        self.counts = counts

    def count(self, key, n):
        self.counts[key] = self.counts.get(key, 0) + int(n)

    def __enter__(self):
        ctx = _context()
        self.parent = ctx[0] if ctx else None
        if self.sample is None:
            self.sample = ctx[1] if ctx else 0
        self.id = (os.getpid(), next(_ids))
        self._range = None
        if _profiling() and self.id[0] == _PID:
            self._range = torch._C._profiler._RecordFunctionFast(
                "panmap:" + self.name)
            self._range.__enter__()
        _stack().append(self)
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        _stack().pop()
        if self._range is not None:
            self._range.__exit__(*exc)
        _records.append(dict(
            name=self.name, start_ns=self.start, end_ns=end, id=self.id,
            parent=self.parent, thread=threading.get_native_id(),
            pid=self.id[0], sample=self.sample, counts=self.counts))
        return False


def span(name: str, sample: int | None = None, **counts):
    """A span named ``name`` over a with-block, or the shared no-op when
    tracing is off.  ``sample``: the sample it works on (by default its
    parent's, 0 at the root); ``counts``: counts known at its start."""
    if not _on():
        return _OFF
    return Span(name, sample, counts)


def spanned(name: str):
    """A decorator: each call of the function is a span ``name``."""
    def wrap(fn):
        @functools.wraps(fn)
        def run(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return run
    return wrap


def count(key: str, n):
    """Add ``n`` to ``key`` of the innermost span open on this thread (for
    code below the span's owner); nothing when tracing is off."""
    st = getattr(_local, "stack", None)
    if st:
        st[-1].count(key, n)


def here():
    """The context a helper thread or a forked task continues: (span id,
    sample) of the span open here ((None, 0) where none is), or None when
    tracing is off."""
    if not _on():
        return None
    return _context() or (None, 0)


@contextlib.contextmanager
def resumed(ctx):
    """Spans on this thread under the span ``ctx`` (here() on the thread
    that handed the work over; None: tracing stays as it is here)."""
    if ctx is None:
        yield
        return
    prev, stack = getattr(_local, "origin", None), getattr(_local, "stack",
                                                           None)
    _local.origin, _local.stack = ctx, []
    try:
        yield
    finally:
        _local.origin, _local.stack = prev, stack


def carry(fn):
    """``fn`` to run on a helper thread, its spans under the span open here
    (``fn`` itself when tracing is off)."""
    ctx = here()
    if ctx is None:
        return fn

    def run(*args, **kwargs):
        with resumed(ctx):
            return fn(*args, **kwargs)

    return run


def take() -> list:
    """The records kept so far, oldest first; the store is emptied."""
    global _records
    out, _records = _records, []
    return out


def adopt(records) -> None:
    """Keep another process's records (a forked worker's take())."""
    _records.extend(records or ())


@contextlib.contextmanager
def profiled(directory: str, log=print):
    """The block inside a torch.profiler session (host ops, and the card's
    kernels where CUDA is available) whose trace is written into
    ``directory`` in TensorBoard's format; a plain block without one."""
    if not directory:
        yield
        return
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    try:
        with profile(activities=acts, acc_events=True,
                     on_trace_ready=tensorboard_trace_handler(directory)):
            yield
    finally:
        log(f"[profile] trace written to {directory}")


def _forked():
    """In a forked child: nothing of the parent's store or open spans."""
    global _records, _local
    _records = []
    _local = threading.local()


os.register_at_fork(after_in_child=_forked)
