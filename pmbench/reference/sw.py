"""Plain PyTorch banded affine-gap Smith-Waterman scores of (query, window)
pairs: what kernel B1 (panmap_tpu_torch/csrc/banded_sw.cu) computes.

Per pair: the best local score of the query against its reference window,
with END_BONUS for starting at the query's first base or ending at its
last, and the 1-based (query end, window end) of the first best cell in
row order, then column order.  Match +2, mismatch -8, a gap of n bases
costs 12 + 2 (n - 1); code 4 (N or padding) never matches.  The scoring
and the tie order are those of panmap_tpu_torch/align/core.py's
banded_affine_dp as at commit 3519e45; the recurrence runs a row at a time
over all pairs, the horizontal gap by a running maximum, in int32 on
whatever device its inputs are on (the card, after the measured window).
"""

from __future__ import annotations

import torch

MATCH, MISMATCH, GAP_OPEN, GAP_EXT, END_BONUS = 2, 8, 12, 2, 10
NEG = -(1 << 28)


def banded_sw_scores(q: torch.Tensor, r: torch.Tensor,
                     qlens: torch.Tensor) -> torch.Tensor:
    """q int8 [B, LQ], r int8 [B, LW], qlens [B] -> int32 [B, 3]:
    (score, query end, window end)."""
    B, LQ = q.shape
    LW = r.shape[1]
    dev = q.device
    i32 = torch.int32
    qi, ri = q.to(i32), r.to(i32)
    ql = qlens.to(i32).clamp(0, LQ)
    idx = torch.arange(LW, dtype=i32, device=dev)
    gap_pen = idx * GAP_EXT
    ext_off = (gap_pen - GAP_EXT).clamp_min(0)
    H = torch.full((B, LW), END_BONUS, dtype=i32, device=dev)
    F = torch.full((B, LW), NEG, dtype=i32, device=dev)
    neg = torch.full((B, 1), NEG, dtype=i32, device=dev)
    best = torch.zeros(B, dtype=i32, device=dev)
    best_i = torch.zeros_like(best)
    best_j = torch.zeros_like(best)
    for i in range(min(int(ql.max()), LQ) if B else 0):
        qc = qi[:, i:i + 1]
        sub = torch.where((ri == qc) & (qc < 4), MATCH, -MISMATCH).to(i32)
        F = torch.maximum(H - GAP_OPEN, F - GAP_EXT)
        edge = torch.full((B, 1), END_BONUS if i == 0 else 0, dtype=i32,
                          device=dev)
        diag = torch.cat([edge, H[:, :-1]], 1) + sub
        base = torch.maximum(diag, F).clamp_min(0)
        pm = torch.cummax(base + gap_pen, 1).values
        E = torch.cat([neg, pm[:, :-1]], 1) - GAP_OPEN - ext_off
        H = torch.maximum(base, E)
        rowmax = H.max(1).values
        jrow = torch.where(H == rowmax[:, None], idx, LW).min(1).values
        row_best = rowmax + torch.where(ql - 1 == i, END_BONUS, 0).to(i32)
        better = (i < ql) & (row_best > best)
        best = torch.where(better, row_best, best)
        best_i = torch.where(better, i + 1, best_i)
        best_j = torch.where(better, jrow + 1, best_j)
    return torch.stack([best, best_i, best_j], 1)
