"""Plain PyTorch rows of the shifted-band dual-affine DP of long reads:
what kernel B2 (panmap_tpu_torch/csrc/banded_long.cu) computes for a
launch.  Written from the recurrence; it imports nothing of the program.

An item is a query of lq codes and a band: row i (1-based) covers the
reference columns j = dlo + i + c, c = 0 .. worig - 1, so that the cell
(i - 1, j - 1) of a diagonal step sits in the same band column c of the
row above and the cell (i - 1, j) of an insertion in column c + 1.  A
cell is on the reference where 1 <= j <= lr.  Codes are 0-3 and 4 (N, or
padding), which never matches.  With a match A, a mismatch -B and two gap
tiers t (open O_t, extension G_t; minimap2's -O q,q2 -E e,e2), H of row 0
is 0 and F_t of row 0 is minus infinity (NEG), and for a cell on the
reference:

    D      = H(i-1, c) + (A if q_i == r_j < 4 else -B)
    F_t    = max(H(i-1, c+1) - O_t, F_t(i-1, c+1) - G_t)  (c < worig - 1)
    base   = max(0, D, F_1, F_2)
    E_t(c) = max(E_t(c-1) - G_t, base(c-1) - O_t)          (c > 0)
    H      = max(base, E_1, E_2)

with F_t NEG in the band's last column and E_t NEG in its first.

A cell off the reference has base NEG and H 0, and its E_t and F_t follow
the same lines.  E_t's line unrolls into a prefix maximum,
E_t(c) = max over c' < c of base(c') + c' G_t, less O_t + (c - 1) G_t,
which a row computes in one scan.

Each cell in the band of a row i <= lq gets a direction byte: bits 0-2
the first of H == 0 (0), D (1), E_1 (2), E_2 (3), F_1 (4), F_2 (5), or 1
where none holds; bit 3 + t' (t' = 0, 1 for the two E tiers) where
c >= 2 and E_t(c) == E_t(c-1) - G_t; bit 5 + t' where c + 1 < worig,
i >= 2 and F_t(i, c) == F_t(i-1, c+1) - G_t.  Each such row gets
(max H, the first column that holds it), H being 0 off the band.  The
layout is the kernel's: dirs int8 [B, LQ, W], stats int32 [B, LQ, 2],
zero outside rows <= lq and columns < worig (lq and worig taken at most
LQ and W).  All arithmetic is int32, on whatever device the inputs are
on (the card, after the measured window)."""

from __future__ import annotations

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

NEG = -(1 << 28)


def long_dp_rows(q, ref, meta, scores, width: int):
    """q int8 [B, LQ], ref int8 [lr], meta int32 [B, 3] = (lq, dlo, worig),
    scores = (A, B, O_1, G_1, O_2, G_2) -> (dirs int8 [B, LQ, width],
    stats int32 [B, LQ, 2])."""
    A, B_, O1, G1, O2, G2 = (int(v) for v in scores)
    nb, LQ = q.shape
    W = width
    dev = q.device
    i32 = torch.int32
    lr = ref.shape[0]
    lq = meta[:, 0].to(i32).clamp(0, LQ)[:, None]
    dlo = meta[:, 1].to(i32)[:, None]
    worig = meta[:, 2].to(i32).clamp(0, W)[:, None]
    col = torch.arange(W, dtype=i32, device=dev)[None, :]
    band = col < worig  # [B, W]
    up_ok = col + 1 < worig  # column c + 1 is in the band
    codes = torch.cat([ref.to(i32), torch.tensor([4], dtype=i32,
                                                 device=dev)])
    tiers = ((O1, G1), (O2, G2))
    neg = torch.full((nb, W), NEG, dtype=i32, device=dev)
    H = torch.zeros((nb, W), dtype=i32, device=dev)
    F = [neg.clone(), neg.clone()]
    dirs = torch.zeros((nb, LQ, W), dtype=torch.int8, device=dev)
    stats = torch.zeros((nb, LQ, 2), dtype=i32, device=dev)

    def shift_left(x):  # x(c + 1), NEG past the last column
        return torch.cat([x[:, 1:], neg[:, :1]], 1)

    def shift_right(x):  # x(c - 1), NEG before the first column
        return torch.cat([neg[:, :1], x[:, :-1]], 1)

    for i in range(1, int(lq.max()) + 1 if nb else 1):
        j = dlo + i + col  # 1-based reference column of each cell
        on_ref = band & (j >= 1) & (j <= lr)
        rj = codes[torch.where(on_ref, j - 1, lr).long()]
        qi = q[:, i - 1].to(i32)[:, None]
        D = H + torch.where((rj == qi) & (qi < 4), A, -B_).to(i32)
        H_up = shift_left(H)
        F_new, F_ext = [], []
        for t, (o, g) in enumerate(tiers):
            F_up = shift_left(F[t]) - g
            f = torch.where(up_ok, torch.maximum(H_up - o, F_up), neg)
            F_new.append(f)
            F_ext.append(up_ok & (i >= 2) & (f == F_up))
        base = torch.maximum(D, torch.maximum(*F_new)).clamp_min(0)
        base = torch.where(on_ref, base, neg)
        E, E_ext = [], []
        for o, g in tiers:
            run = torch.cummax(base + col * g, 1).values
            e = torch.where(col >= 1, shift_right(run) - o - (col - 1) * g,
                            neg)
            E.append(e)
            E_ext.append((col >= 2) & (e == shift_right(e) - g))
        Hn = torch.where(on_ref, torch.maximum(base, torch.maximum(*E)),
                         torch.zeros_like(base))
        src = torch.ones_like(Hn)
        for code, val in reversed(((0, torch.zeros_like(Hn)), (1, D),
                                   (2, E[0]), (3, E[1]), (4, F_new[0]),
                                   (5, F_new[1]))):
            src = torch.where(Hn == val, code, src)
        byte = (src | E_ext[0].to(i32) << 3 | E_ext[1].to(i32) << 4
                | F_ext[0].to(i32) << 5 | F_ext[1].to(i32) << 6)
        live = i <= lq  # [B, 1]
        dirs[:, i - 1] = torch.where(band & live, byte, 0).to(torch.int8)
        top = Hn.max(1, keepdim=True).values  # H is 0 off the band
        at = torch.where(Hn == top, col, W).min(1, keepdim=True).values
        stats[:, i - 1] = torch.where(live, torch.cat([top, at], 1), 0)
        H, F = Hn, F_new
    return dirs, stats
