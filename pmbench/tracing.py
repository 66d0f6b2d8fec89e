"""Spans around the program's stage calls, and the reduction of the traced
window's profiler events to what the per-layer metrics read.

A span wraps one module-level function that the program's drivers call by
name (pipeline.run_placement, meta/driver.run_em, ...): a host-clock
interval that ends when the call has returned and the card has finished
its work (torch.cuda.synchronize), and a torch.profiler range of the same
name, so that the device's idle gaps can be named by the span open on the
host.  Spans are installed for the traced run only.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field

PREFIX = "pmbench:"


class Patches:
    """Module attributes replaced for a run and put back by ``undo``."""

    def __init__(self):
        self._undo = []

    def replace(self, module, name, make):
        orig = getattr(module, name)
        setattr(module, name, make(orig))
        self._undo.append((module, name, orig))

    def undo(self):
        while self._undo:
            module, name, orig = self._undo.pop()
            setattr(module, name, orig)


class Spans:
    """Host-clock spans by label: [(label, start, end)] in perf_counter
    seconds."""

    def __init__(self, sync):
        self.items = []
        self._sync = sync

    @contextlib.contextmanager
    def span(self, label, sync: bool = True):
        """A span of the block; with ``sync`` it ends once the card has
        finished what the block queued (a host-only call leaves the
        program's queued work in flight)."""
        from torch.profiler import record_function

        t0 = time.perf_counter()
        with record_function(PREFIX + label):
            try:
                yield
            finally:
                if sync:
                    self._sync()
        self.items.append((label, t0, time.perf_counter()))

    def wrapper(self, label, sync: bool = True):
        def make(fn):
            def run(*a, **k):
                with self.span(label, sync):
                    return fn(*a, **k)
            return run
        return make

    def total(self, label) -> float | None:
        d = [b - a for n, a, b in self.items if n == label]
        return sum(d) if d else None


def union(intervals):
    """Merged [(start, end)] of possibly overlapping intervals."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def gaps(busy, lo, hi):
    """The idle intervals of [lo, hi] between merged busy intervals."""
    out, at = [], lo
    for a, b in busy:
        if a > at:
            out.append((at, a))
        at = max(at, b)
    if at < hi:
        out.append((at, hi))
    return out


def label_gaps(idle, spans, top: int = 10):
    """Idle seconds by what the host was doing: each idle interval cut at
    the spans' ends, each piece given to the innermost span open over it
    ("harness" where none is); the ``top`` largest, [[label, seconds]]."""
    cuts = sorted({t for _, a, b in spans for t in (a, b)})
    by = {}
    for a, b in idle:
        inner = [t for t in cuts if a < t < b]
        for p0, p1 in zip([a] + inner, inner + [b]):
            mid = (p0 + p1) / 2
            open_ = [(s0, name) for name, s0, s1 in spans if s0 <= mid < s1]
            name = max(open_)[1] if open_ else "harness"
            by[name] = by.get(name, 0.0) + (p1 - p0)
    return [[n, s] for n, s in sorted(by.items(), key=lambda x: -x[1])][:top]


@dataclass
class Trace:
    """What the metric readers read: the traced window's samples, host
    spans, device operations and kernel launches."""

    n_samples: int
    window_s: float
    spans: Spans
    device_ops: list = field(default_factory=list)  # (name, start s, end s)
    launches: dict = field(default_factory=dict)  # kernel -> [shapes]
    busy_s: float | None = None
    idle: list = field(default_factory=list)  # idle intervals, seconds
    idle_by_span: list = field(default_factory=list)  # label_gaps()

    def per_sample(self, label) -> float | None:
        t = self.spans.total(label)
        return None if t is None or not self.n_samples else t / self.n_samples

    def kernels(self):
        """Device operations that are kernels (not copies or sets)."""
        return [op for op in self.device_ops
                if not op[0].startswith(("Memcpy", "Memset"))]


def reduce_profile(prof, spans: Spans, n_samples: int, launches: dict):
    """A Trace of the traced window from a finished torch.profiler run:
    the window is the "window" span's profiler range; the device busy time
    is the union of its device operations' intervals inside it."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    dev_ops, ranges = [], []
    for e in prof.events():
        a, b = e.time_range.start / 1e6, e.time_range.end / 1e6
        if e.name.startswith(PREFIX):
            if e.device_type != cuda:
                ranges.append((e.name[len(PREFIX):], a, b))
        elif e.device_type == cuda:
            dev_ops.append((e.name, a, b))
    win = [(a, b) for n, a, b in ranges if n == "window"]
    if not win:
        raise RuntimeError("the profiler holds no window range")
    lo, hi = win[0]
    dev_ops = [(n, max(a, lo), min(b, hi)) for n, a, b in dev_ops
               if b > lo and a < hi]
    busy = union([(a, b) for _, a, b in dev_ops])
    t = Trace(n_samples=n_samples, window_s=hi - lo, spans=spans,
              device_ops=dev_ops, launches=launches,
              busy_s=sum(b - a for a, b in busy),
              idle=gaps(busy, lo, hi))
    t.idle_by_span = label_gaps(
        t.idle, [(n, a, b) for n, a, b in ranges if n != "window"])
    return t


def top_ops(trace: Trace, top: int = 10, width: int = 96):
    """[[name, seconds]] of the device operations that took most time,
    each name cut to ``width`` characters."""
    by = {}
    for n, a, b in trace.device_ops:
        n = n[:width]
        by[n] = by.get(n, 0.0) + (b - a)
    return [[n, s] for n, s in sorted(by.items(), key=lambda x: -x[1])][:top]
