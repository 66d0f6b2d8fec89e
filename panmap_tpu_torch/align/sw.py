"""Batched banded-SW window scoring (counterpart of
panmap_tpu/align/pallas_sw.py).

``banded_sw_scores`` launches the CUDA kernel csrc/banded_sw.cu for CUDA
tensors and runs ``banded_sw_scores_reference``, its plain PyTorch version,
for CPU tensors; any other device raises.  Both return, per pair, (best
score incl. end bonuses, query end, window end) with the tie order of
align/core.py::banded_affine_dp and bit-equal to the Pallas kernel.
"""

from __future__ import annotations

import torch

from .core import END_BONUS, GAP_EXT, GAP_OPEN, MATCH, MISMATCH

MAX_LW = 2048  # window columns one kernel block covers (256 threads x 8)
NEG = -(1 << 28)

# kernel launches made by banded_sw_scores (the reference runs do not count)
LAUNCHES = 0


def _check(q, r, qlens):
    if q.dtype != torch.int8 or r.dtype != torch.int8:
        raise TypeError(f"q and r must be int8, got {q.dtype}, {r.dtype}")
    if qlens.dtype != torch.int32:
        raise TypeError(f"qlens must be int32, got {qlens.dtype}")
    if q.dim() != 2 or r.dim() != 2 or qlens.dim() != 1:
        raise ValueError("expected q [B, LQ], r [B, LW], qlens [B]")
    B = q.shape[0]
    if r.shape[0] != B or qlens.shape[0] != B:
        raise ValueError(f"batch sizes differ: {q.shape[0]}, {r.shape[0]}, "
                         f"{qlens.shape[0]}")
    if not (q.is_contiguous() and r.is_contiguous() and qlens.is_contiguous()):
        raise ValueError("q, r and qlens must be contiguous")
    if not (q.device == r.device == qlens.device):
        raise ValueError(f"tensors on different devices: {q.device}, "
                         f"{r.device}, {qlens.device}")
    if q.shape[1] == 0 or r.shape[1] == 0 or r.shape[1] > MAX_LW:
        raise ValueError(f"need 0 < LQ and 0 < LW <= {MAX_LW}, got "
                         f"LQ {q.shape[1]}, LW {r.shape[1]}")


def banded_sw_scores(q, r, qlens):
    """q int8 [B, LQ] codes 0-3 (4 = N/pad), r int8 [B, LW] (LW <= MAX_LW),
    qlens int32 [B] with 0 <= qlens <= LQ.  Returns int32 [B, 3] on q's
    device: (score, query end, window end)."""
    global LAUNCHES
    _check(q, r, qlens)
    if q.device.type == "cpu":
        return banded_sw_scores_reference(q, r, qlens)
    if q.device.type != "cuda":
        raise ValueError(f"banded_sw_scores: unsupported device {q.device}")
    from .. import _kernels

    B, LQ = q.shape
    out = torch.empty((B, 3), dtype=torch.int32, device=q.device)
    if B == 0:
        return out
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = _kernels.lib().panmap_banded_sw(
            q.data_ptr(), r.data_ptr(), qlens.data_ptr(), out.data_ptr(),
            B, LQ, r.shape[1], stream)
    if rc != 0:
        raise RuntimeError(f"banded_sw kernel launch failed: CUDA error {rc}")
    LAUNCHES += 1
    return out


def banded_sw_scores_reference(q, r, qlens):
    """Plain PyTorch version of the kernel, row-vectorized over the batch
    and the window like align/core.py::banded_affine_dp (runs on any
    device).  Window column l is banded_affine_dp's column l + 1."""
    B, LQ = q.shape
    LW = r.shape[1]
    dev = q.device
    qi = q.to(torch.int32)
    ri = r.to(torch.int32)
    ql = qlens.clamp(0, LQ)  # as the kernel does

    def i32(v):  # 0-d int32 operand: keeps every row op in int32
        return torch.tensor(v, dtype=torch.int32, device=dev)

    match, mismatch, bonus, zero = (i32(MATCH), i32(-MISMATCH),
                                    i32(END_BONUS), i32(0))
    idx = torch.arange(LW, dtype=torch.int32, device=dev)
    gap_pen = idx * GAP_EXT
    ext_off = (gap_pen - GAP_EXT).clamp_min(0)
    H = torch.full((B, LW), END_BONUS, dtype=torch.int32, device=dev)
    F = torch.full((B, LW), NEG, dtype=torch.int32, device=dev)
    neg_col = torch.full((B, 1), NEG, dtype=torch.int32, device=dev)
    best = torch.zeros(B, dtype=torch.int32, device=dev)
    best_i = torch.zeros_like(best)
    best_j = torch.zeros_like(best)
    n_rows = min(int(ql.max()), LQ) if B else 0
    for i in range(n_rows):
        qc = qi[:, i : i + 1]
        sub = torch.where((ri == qc) & (qc < 4), match, mismatch)
        F = torch.maximum(H - GAP_OPEN, F - GAP_EXT)
        # boundary column: END_BONUS on the first row, the local floor after
        first = torch.full((B, 1), END_BONUS if i == 0 else 0,
                           dtype=torch.int32, device=dev)
        diag = torch.cat([first, H[:, :-1]], dim=1) + sub
        base = torch.maximum(diag, F).clamp_min(0)
        pm = torch.cummax(base + gap_pen, dim=1).values
        E = torch.cat([neg_col, pm[:, :-1]], dim=1) - GAP_OPEN - ext_off
        H = torch.maximum(base, E)
        rowmax = H.max(dim=1, keepdim=True).values
        jrow = torch.where(H == rowmax, idx, LW).min(dim=1).values
        row_best = rowmax[:, 0] + torch.where(ql - 1 == i, bonus, zero)
        better = (i < ql) & (row_best > best)
        best = torch.where(better, row_best, best)
        best_i = torch.where(better, i + 1, best_i)
        best_j = torch.where(better, jrow + 1, best_j)
    return torch.stack([best, best_i, best_j], dim=1)
