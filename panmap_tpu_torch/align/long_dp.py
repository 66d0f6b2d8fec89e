"""Long-read shifted-band dual-affine DP on the device (counterpart of
panmap_tpu/align/pallas_long.py).

``long_dp_rows`` launches the CUDA kernel csrc/banded_long.cu for CUDA
tensors and runs ``long_dp_rows_reference``, its plain PyTorch version, for
CPU tensors; any other device raises.  Both compute, for every row of every
item, what align/longread.py::banded_dp_shifted computes: a direction byte
per band cell and the row's (max, first argmax).  ``long_dp_batch`` drives
them for a list of (query, dlo, dhi) items and replays the z-drop rule and
the traceback on the host (``_finish_one``), so its results equal
banded_dp_shifted's item by item.

Layout: q int8 [B, LQ] (code 4 past each query), the reference int8 [lr]
read directly by the kernel (no per-row band matrix), meta int32 [B, 3] =
(lq, dlo, worig) with worig = dhi - dlo + 1, and outputs dirs int8
[B, LQ, W] and stats int32 [B, LQ, 2].  Padded cells (rows >= lq, columns
>= worig) are 0, stats rows >= lq (0, 0), so the kernel and the plain
version agree over the whole arrays.  Codes are 0-3 and 4 (N / pad).
``long_dp_batch`` rounds a launch's W up to a multiple of 16, so every row
of dirs starts on a 16-byte boundary and a thread's 8 direction bytes leave
as one store; ``long_dp_rows`` takes any width (an unaligned one stores
bytes).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import trace
from .longread import banded_dp_shifted

NEG = -(1 << 28)
MAX_W = 16384  # band columns of one block: 1,024 threads x 16 columns
# the kernel packs a row's (max, argmax) as (h << 14) | (16383 - c), and
# h <= match * LQ
MAX_PACKED_H = 1 << 17
W_ALIGN = 16  # long_dp_batch launches at a multiple of this width
# items whose Pallas-padded direction matrix would exceed this run the host
# DP, as in panmap_tpu/align/pallas_long.py::long_dp_device_batch
MAX_ITEM_CELLS = 32 << 20
DIRS_CAP = 1 << 30  # direction bytes of one launch

# kernel launches made by long_dp_rows (the reference runs do not count)
LAUNCHES = 0


def _check(q, ref, meta, pre, width):
    if q.dtype != torch.int8 or ref.dtype != torch.int8:
        raise TypeError(f"q and ref must be int8, got {q.dtype}, {ref.dtype}")
    if meta.dtype != torch.int32:
        raise TypeError(f"meta must be int32, got {meta.dtype}")
    if q.dim() != 2 or ref.dim() != 1 or meta.dim() != 2 \
            or meta.shape[1] != 3:
        raise ValueError("expected q [B, LQ], ref [lr], meta [B, 3]")
    if meta.shape[0] != q.shape[0]:
        raise ValueError(f"batch sizes differ: {q.shape[0]}, {meta.shape[0]}")
    if not (q.is_contiguous() and ref.is_contiguous()
            and meta.is_contiguous()):
        raise ValueError("q, ref and meta must be contiguous")
    if not (q.device == ref.device == meta.device):
        raise ValueError(f"tensors on different devices: {q.device}, "
                         f"{ref.device}, {meta.device}")
    if q.shape[1] == 0 or not 0 < width <= MAX_W:
        raise ValueError(f"need 0 < LQ and 0 < width <= {MAX_W}, got "
                         f"LQ {q.shape[1]}, width {width}")
    if pre.match <= 0 or pre.match * q.shape[1] >= MAX_PACKED_H:
        raise ValueError(f"need 0 < match * LQ < {MAX_PACKED_H}, got match "
                         f"{pre.match}, LQ {q.shape[1]}")


def long_dp_rows(q, ref, meta, pre, width: int):
    """Direction bytes and row stats of every item (see the module doc);
    ``pre`` is a LongPreset (its scoring constants), ``width`` the batch's
    band width W >= every worig.  Returns (dirs, stats) on q's device."""
    global LAUNCHES
    _check(q, ref, meta, pre, width)
    if q.device.type == "cpu":
        return long_dp_rows_reference(q, ref, meta, pre, width)
    if q.device.type != "cuda":
        raise ValueError(f"long_dp_rows: unsupported device {q.device}")
    from .. import _kernels

    B, LQ = q.shape
    dirs = torch.empty((B, LQ, width), dtype=torch.int8, device=q.device)
    stats = torch.empty((B, LQ, 2), dtype=torch.int32, device=q.device)
    if B == 0:
        return dirs, stats
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = _kernels.lib().panmap_banded_long(
            q.data_ptr(), ref.data_ptr(), meta.data_ptr(), dirs.data_ptr(),
            stats.data_ptr(), B, LQ, width, ref.shape[0], pre.match,
            pre.mismatch, pre.gap_open, pre.gap_ext, pre.gap_open2,
            pre.gap_ext2, stream)
    if rc != 0:
        raise RuntimeError(f"banded_long kernel launch failed: CUDA error "
                           f"{rc}")
    LAUNCHES += 1
    return dirs, stats


def long_dp_rows_reference(q, ref, meta, pre, width: int):
    """Plain PyTorch version of the kernel, row-vectorized over [B, W] like
    the body of pallas_long.py::_make_kernel (runs on any device)."""
    B, LQ = q.shape
    W = width
    dev = q.device
    lr = ref.shape[0]
    A, MM, GO, GE = pre.match, pre.mismatch, pre.gap_open, pre.gap_ext
    GO2, GE2 = pre.gap_open2, pre.gap_ext2
    lq = meta[:, 0].clamp(0, LQ)
    dlo = meta[:, 1:2]
    worig = meta[:, 2:3].clamp(0, W)
    qi = q.to(torch.int32)
    # the reference with a code-4 cell at index lr for out-of-band reads
    refp = torch.cat([ref.to(torch.int32),
                      torch.full((1,), 4, dtype=torch.int32, device=dev)])

    def i32(v):  # 0-d int32 operand: keeps every row op in int32
        return torch.tensor(v, dtype=torch.int32, device=dev)

    neg, zero = i32(NEG), i32(0)
    match, mismatch = i32(A), i32(-MM)
    idx = torch.arange(W, dtype=torch.int32, device=dev)
    act = idx < worig  # [B, W]
    nxt = idx + 1 < worig
    e_off = torch.where(idx >= 1, GO + (idx - 1) * GE, zero)
    e2_off = torch.where(idx >= 1, GO2 + (idx - 1) * GE2, zero)
    neg_col = torch.full((B, 1), NEG, dtype=torch.int32, device=dev)
    H = torch.zeros((B, W), dtype=torch.int32, device=dev)
    F = torch.full((B, W), NEG, dtype=torch.int32, device=dev)
    F2 = torch.full((B, W), NEG, dtype=torch.int32, device=dev)
    dirs = torch.zeros((B, LQ, W), dtype=torch.int8, device=dev)
    stats = torch.zeros((B, LQ, 2), dtype=torch.int32, device=dev)
    n_rows = int(lq.max()) if B else 0
    for i in range(n_rows):
        live = (i < lq)[:, None]
        qc = qi[:, i : i + 1]
        pos = idx + dlo + i  # 0-based reference index of each cell
        inb = act & (pos >= 0) & (pos < lr)
        rj = refp[torch.where(inb, pos, lr)]
        sub = torch.where((rj == qc) & (qc < 4), match, mismatch)
        diag = H + sub
        # insertion: (i-1, j) is band column c + 1 of the row above
        h_up = torch.cat([H[:, 1:], neg_col], dim=1)
        f_up = torch.cat([F[:, 1:], neg_col], dim=1) - GE
        f2_up = torch.cat([F2[:, 1:], neg_col], dim=1) - GE2
        f = torch.where(nxt, torch.maximum(h_up - GO, f_up), neg)
        f2 = torch.where(nxt, torch.maximum(h_up - GO2, f2_up), neg)
        base = torch.maximum(torch.maximum(diag, torch.maximum(f, f2)), zero)
        base = torch.where(inb, base, neg)
        # deletion: in-row prefix max, one per gap tier
        pm = torch.cummax(base + idx * GE, dim=1).values
        e = torch.where(idx >= 1, torch.cat([neg_col, pm[:, :-1]], dim=1)
                        - e_off, neg)
        pm2 = torch.cummax(base + idx * GE2, dim=1).values
        e2 = torch.where(idx >= 1, torch.cat([neg_col, pm2[:, :-1]], dim=1)
                         - e2_off, neg)
        h = torch.where(inb, torch.maximum(base, torch.maximum(e, e2)), zero)

        # direction byte in the host traceback's priority order
        src = torch.where(
            h == 0, 0, torch.where(
                h == diag, 1, torch.where(
                    h == e, 2, torch.where(
                        h == e2, 3, torch.where(
                            h == f, 4, torch.where(h == f2, 5, 1))))))
        e_ext = (idx > 1) & (e == torch.cat([neg_col, e[:, :-1]], dim=1) - GE)
        e2_ext = (idx > 1) & (e2 == torch.cat([neg_col, e2[:, :-1]], dim=1)
                              - GE2)
        f_ext = nxt & (i >= 1) & (f == f_up)
        f2_ext = nxt & (i >= 1) & (f2 == f2_up)
        byte = (src | (e_ext.to(torch.int32) << 3)
                | (e2_ext.to(torch.int32) << 4)
                | (f_ext.to(torch.int32) << 5)
                | (f2_ext.to(torch.int32) << 6))
        dirs[:, i] = torch.where(act & live, byte, zero).to(torch.int8)
        rowmax = h.max(dim=1, keepdim=True).values
        jarg = torch.where(h == rowmax, idx, W).min(dim=1, keepdim=True).values
        stats[:, i] = torch.where(live, torch.cat([rowmax, jarg], dim=1), zero)
        H, F, F2 = h, f, f2
    return dirs, stats


def _round_up(x, m):
    return -(-x // m) * m


def _on_host(q, dlo, dhi) -> bool:
    """Items the device path does not take: over the JAX package's cell cap
    (its padded (LQ, W) rule, so the same items route the same way), or
    wider than a block of the kernel covers.  (The presets' bands are at
    least 1,001 wide, so under the cell cap a query has at most 32,768
    bases and match * LQ stays below MAX_PACKED_H.)"""
    W = dhi - dlo + 1
    cells = max(_round_up(len(q), 512), 512) * _round_up(W, 128)
    return cells > MAX_ITEM_CELLS or _round_up(W, W_ALIGN) > MAX_W


def long_dp_batch(items: list, ref_codes: np.ndarray, pre, device,
                  stats: dict | None = None, ref_dev=None) -> list:
    """items: [(q_codes, dlo, dhi)].  Runs the DP rows on ``device`` (the
    kernel, or its plain version for a CPU device) in launches of at most
    DIRS_CAP direction bytes, then the z-drop replay and the traceback on
    the host.  Returns banded_dp_shifted's (score, qs, qe, rs, re, cigar)
    per item.  ``ref_dev``: ref_codes already on the device (int8).
    ``stats`` accumulates items, device_dp and host_dp.  Each launch is an
    "align.dp" span (to its rows on the host) and an "align.traceback"
    span."""
    device = torch.device(device)
    st = {} if stats is None else stats
    for key in ("items", "device_dp", "host_dp"):
        st.setdefault(key, 0)
    st["items"] += len(items)
    out = [None] * len(items)
    dev_ids = []
    for n, (q, dlo, dhi) in enumerate(items):
        if _on_host(q, dlo, dhi):
            out[n] = banded_dp_shifted(q, ref_codes, dlo, dhi, pre)
            st["host_dp"] += 1
        else:
            dev_ids.append(n)
    if not dev_ids:
        return out
    if ref_dev is None:
        ref_dev = torch.from_numpy(ref_codes.astype(np.int8)).to(device)
    # shortest queries first, so each launch pads little
    dev_ids.sort(key=lambda n: len(items[n][0]))
    chunks = []  # ([item], LQ, W)
    for n in dev_ids:
        q, dlo, dhi = items[n]
        lq, w = max(len(q), 1), _round_up(dhi - dlo + 1, W_ALIGN)
        if chunks:
            ids, LQ, W = chunks[-1]
            LQ, W = max(LQ, lq), max(W, w)
            if (len(ids) + 1) * LQ * W <= DIRS_CAP:
                chunks[-1] = (ids + [n], LQ, W)
                continue
        chunks.append(([n], lq, w))
    for chunk, LQ, W in chunks:
        qb = np.full((len(chunk), LQ), 4, np.int8)
        meta = np.zeros((len(chunk), 3), np.int32)
        for s, n in enumerate(chunk):
            q, dlo, dhi = items[n]
            qb[s, : len(q)] = q
            meta[s] = (len(q), dlo, dhi - dlo + 1)
        with trace.span("align.dp"):
            dirs, rows = long_dp_rows(torch.from_numpy(qb).to(device),
                                      ref_dev,
                                      torch.from_numpy(meta).to(device), pre,
                                      W)
            dirs = dirs.cpu().numpy()  # waits on the launch
            rows = rows.cpu().numpy()
        with trace.span("align.traceback"):
            for s, n in enumerate(chunk):
                q, dlo, dhi = items[n]
                out[n] = _finish_one(q, dlo, dirs[s, :, : dhi - dlo + 1],
                                     rows[s], pre)
        st["device_dp"] += len(chunk)
    return out


# Carried over line for line from panmap_tpu/align/pallas_long.py, whose
# module imports jax at its top; tests/test_torch_long.py holds the two equal.
def _finish_one(q, dlo, dirs, stats, pre):
    """Host back half: z-drop replay over row stats + direction-byte
    traceback (mirrors banded_dp_shifted's loop and state machine)."""
    lq = len(q)
    GE = pre.gap_ext
    best = (0, 0, 0)
    rm = stats[:, 0]
    ja = stats[:, 1]
    for i in range(1, lq + 1):
        row_max = int(rm[i - 1])
        cmax = int(ja[i - 1])
        if row_max > best[0]:
            best = (row_max, i, cmax)
        elif best[0] - row_max > pre.zdrop + GE * abs(cmax - best[2]):
            break
    score, bi, bc = best
    if score <= 0:
        return 0, 0, 0, 0, 0, []
    W = dirs.shape[1]
    i, c = bi, bc
    ops = []
    state = "H"
    while i > 0:
        j = c + dlo + i
        if j <= 0:
            break
        byte = int(dirs[i - 1, c])
        src = byte & 7
        if state == "H":
            if src == 0:
                break
            if src == 1:
                ops.append("M")
                i -= 1
            elif src == 2:
                state = "E"
            elif src == 3:
                state = "E2"
            elif src == 4:
                state = "F"
            else:
                state = "F2"
        elif state in ("E", "E2"):
            bit = 3 if state == "E" else 4
            ops.append("D")
            if not (byte >> bit) & 1:
                state = "H"
            c -= 1
        else:  # F / F2
            bit = 5 if state == "F" else 6
            ops.append("I")
            cont = (byte >> bit) & 1
            i -= 1
            c += 1
            if not cont:
                state = "H"
        if c < 0 or c >= W:
            break
    ops.reverse()
    cigar = []
    for op in ops:
        if cigar and cigar[-1][1] == op:
            cigar[-1] = (cigar[-1][0] + 1, op)
        else:
            cigar.append((1, op))
    qs = i
    rs = c + dlo + i
    qe = bi
    re_ = bc + dlo + bi
    return score, qs, qe, max(rs, 0), re_, cigar
