"""Terminal output/UX: leveled ANSI logging, action lines, progress bars.

Reimplements the reference's output layer (src/logging.hpp:24-424 leveled
spdlog wrapper with quiet/verbose/plain + NO_COLOR + TTY detection, ANSI
styling and a unicode progress bar; src/progress_tracker.hpp:10-52 counter
tracker).  Python stdlib only; all output goes to stderr so artifact streams
stay clean.
"""

from __future__ import annotations

import os
import sys
import time


class _Style:
    def __init__(self, enabled: bool):
        on = enabled
        self.bold = "\033[1m" if on else ""
        self.dim = "\033[2m" if on else ""
        self.green = "\033[32m" if on else ""
        self.yellow = "\033[33m" if on else ""
        self.red = "\033[31m" if on else ""
        self.cyan = "\033[36m" if on else ""
        self.reset = "\033[0m" if on else ""


def _want_color(plain: bool) -> bool:
    if plain or os.environ.get("NO_COLOR"):
        return False
    return sys.stderr.isatty()


class Output:
    """quiet < normal < verbose leveled logging with action lines
    (logging.hpp stage/step/done/fail equivalents)."""

    def __init__(self, quiet: bool = False, verbose: bool = False,
                 plain: bool = False, no_progress: bool = False):
        self.quiet = quiet
        self.verbose = verbose
        self.no_progress = no_progress
        self.style = _Style(_want_color(plain))
        self._t0 = {}
        self._start = time.time()

    def _emit(self, msg: str):
        stamp = f"{self.style.dim}[{time.time()-self._start:6.1f}s]{self.style.reset} "
        print(stamp + msg, file=sys.stderr, flush=True)

    def __call__(self, msg: str):  # drop-in for the old `log` callable
        if not self.quiet:
            self._emit(msg)

    def detail(self, msg: str):
        if self.verbose and not self.quiet:
            self._emit(f"{self.style.dim}{msg}{self.style.reset}")

    def stage(self, name: str, msg: str = ""):
        if self.quiet:
            return
        s = self.style
        self._t0[name] = time.time()
        tail = f" {msg}" if msg else ""
        self._emit(f"{s.bold}{s.cyan}▶ {name}{s.reset}{tail}")

    def done(self, name: str, msg: str = ""):
        if self.quiet:
            return
        s = self.style
        dt = time.time() - self._t0.pop(name, time.time())
        tail = f" {msg}" if msg else ""
        self._emit(f"{s.green}✓ {name}{s.reset}{tail}"
                   f" {s.dim}({dt:.1f}s){s.reset}")

    def warn(self, msg: str):
        if not self.quiet:
            s = self.style
            self._emit(f"{s.yellow}! {msg}{s.reset}")

    def fail(self, name: str, msg: str = ""):
        s = self.style
        tail = f" {msg}" if msg else ""
        self._emit(f"{s.red}✗ {name}{s.reset}{tail}")

    def progress(self, label: str, total: int) -> "ProgressBar":
        return ProgressBar(label, total, self)


_BLOCKS = " ▏▎▍▌▋▊▉█"


class ProgressBar:
    """Unicode in-place progress bar (logging.hpp:380-424); renders only on a
    TTY and at most ~20x/s, falls back to milestone lines otherwise."""

    WIDTH = 28

    def __init__(self, label: str, total: int, out: Output):
        self.label = label
        self.total = max(total, 1)
        self.out = out
        self.n = 0
        self._last = 0.0
        self._t0 = time.time()
        self._tty = sys.stderr.isatty() and not out.quiet
        self._milestone = 0
        self._off = getattr(out, "no_progress", False)

    def update(self, n: int = 1):
        self.n += n
        if self._off:
            return
        now = time.time()
        if self._tty:
            if now - self._last < 0.05 and self.n < self.total:
                return
            self._last = now
            frac = min(self.n / self.total, 1.0)
            cells = frac * self.WIDTH
            full = int(cells)
            part = _BLOCKS[int((cells - full) * 8)] if full < self.WIDTH else ""
            bar = "█" * full + part + " " * (self.WIDTH - full - len(part))
            rate = self.n / max(now - self._t0, 1e-9)
            s = self.out.style
            sys.stderr.write(f"\r{s.cyan}{self.label}{s.reset} "
                             f"|{bar}| {self.n}/{self.total} "
                             f"{s.dim}{rate:,.0f}/s{s.reset}")
            sys.stderr.flush()
        elif not self.out.quiet:
            pct = self.n * 10 // self.total
            if pct > self._milestone:
                self._milestone = pct
                self.out(f"[{self.label}] {self.n}/{self.total} ({pct * 10}%)")

    def close(self):
        if self._off:
            return
        if self._tty:
            sys.stderr.write("\n")
            sys.stderr.flush()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
