"""The least time the card could take for a launch of kernel B2
(panmap_tpu_torch/csrc/banded_long.cu, the long reads' shifted-band
dual-affine DP): the larger of its operations over the card's int32 rate
and its bytes over the card's memory rate (the peaks of roofline.py).

The work is what the items need, not what the launch pads: the cells are
the sum over items of lq x worig, the rows the DP runs times the band it
needs, so that a change of padding or of tiling leaves the yardstick
where it is.  The bytes are each item's direction bytes (one a cell) and
row stats (two int32 a row) written, and its query (lq) and reference
slice (lq + worig - 1 codes) and meta (three int32) read once.

int32 operations a cell needs at the least, counted from the recurrence
(reference/long_dp.py), with the card's fused add-max and three-way max
(DPX) where they apply:
  the recurrence, 15: the substitution score (a compare and a select) and
    D = H + s (3); F_t = max(H_up - O_t, F_up - G_t) as one subtraction
    and one fused add-max, per tier (4); base = max(D, F_1, F_2, 0) as one
    three-way max with 0 (1); E_t(c) = max(E_t(c-1) - G_t, base(c-1) - O_t)
    likewise (4); H = max(base, E_1, E_2) (1); whether the cell lies on
    the reference, two compares (2);
  the source in the traceback's priority order, 12: H against 0, D, E_1,
    E_2, F_1 and F_2 (6 compares) and the select of each (6);
  the four run flags, 8: E_t(c) == E_t(c-1) - G_t and F_t(i, c) ==
    F_t(i-1, c+1) - G_t against values the recurrence holds (4 compares),
    each masked by its column's or row's validity (4);
  the byte, 5: the source and four flags packed, one bit insert each;
  the row's max and first argmax, 5: the max (1), the compare with it and
    the select of the column (2), the min of the columns (1), and whether
    the row is live (1).
15 + 12 + 8 + 5 + 5 = 45, as chip_smoke.py's LONG_OPS_PER_CELL.
"""

from __future__ import annotations

import numpy as np

from pmbench import roofline

LONG_OPS_PER_CELL = 45


def long_bound_s(lq, worig) -> float:
    """Least seconds of one B2 launch over items of query lengths ``lq``
    and bands ``worig`` (arrays, one entry an item)."""
    lq = np.asarray(lq, np.int64)
    worig = np.asarray(worig, np.int64)
    cells = int((lq * worig).sum())
    nbytes = cells + int((8 * lq + lq + lq + worig - 1 + 12).sum())
    return max(cells * LONG_OPS_PER_CELL / roofline.INT32_OPS_PER_S,
               nbytes / roofline.HBM_BYTES_PER_S)
