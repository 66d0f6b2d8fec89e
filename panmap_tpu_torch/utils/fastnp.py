"""Fast replacements for numpy operations with slow paths in this build.

np.unique(..., return_inverse=True) runs 7-10x slower than a manual
argsort-based implementation (the inverse pass in numpy 2.0 allocates and
sorts more than it needs to); these helpers are drop-in equivalents for the
hot paths (index prep, presence-event extraction).
"""

from __future__ import annotations

import numpy as np


def unique_inverse(x: np.ndarray):
    """(unique_sorted, inverse) == np.unique(x, return_inverse=True)."""
    n = len(x)
    if n == 0:
        return x[:0], np.empty(0, dtype=np.int64)
    order = np.argsort(x, kind="stable")
    xs = x[order]
    first = np.empty(n, dtype=bool)
    first[0] = True
    np.not_equal(xs[1:], xs[:-1], out=first[1:])
    uniq = xs[first]
    gid_sorted = np.cumsum(first) - 1
    inv = np.empty(n, dtype=np.int64)
    inv[order] = gid_sorted
    return uniq, inv
