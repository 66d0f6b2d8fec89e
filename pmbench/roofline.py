"""The least time the card could take for a kernel's launch: the larger of
its operations over the card's peak rate and its bytes over the card's
memory rate (copied, with the derivation written out, from
chip_smoke.py's bound_ms at commit 3519e45).

Peaks are the published ones of one NVIDIA H100 SXM at its full 700 W
(NVIDIA's data sheet): 67 TFLOP/s of float32 outside the tensor cores and
3.35 TB/s of HBM3.  The data sheet gives no int32 rate.  An SM of compute
capability 9.0 issues 128 float32 lanes a clock, each a fused multiply-add
(2 flops), and 64 lanes of 32-bit integer add, compare or min/max a clock
(CUDA C++ Programming Guide, arithmetic instruction throughput), so the
int32 rate is a quarter of the float32 flop rate: 67e12 / 4 = 16.75e12
operations a second (132 SMs x 64 lanes x 1.98 GHz).  A card set below
700 W runs slower under load; the harness reports the card's power limit
beside each share.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 67e12 / 4

# int32 operations a banded affine-gap DP cell needs at the least
# (csrc/banded_sw.cu): E, F and H of the recurrence (10), the query-end
# bonus and the running (max, position) with its tie order (10).
SW_OPS_PER_CELL = 20


def sw_bound_s(rows: int, lq: int, lw: int) -> float:
    """Least seconds of one B1 launch over ``rows`` (query, window) pairs:
    cells x ops over the int32 rate, or the int8 query and window, the
    int32 lengths and the int32 [rows, 3] result over the memory rate."""
    ops = rows * lq * lw * SW_OPS_PER_CELL / INT32_OPS_PER_S
    nbytes = rows * (lq + lw + 4 + 12)
    return max(ops, nbytes / HBM_BYTES_PER_S)
