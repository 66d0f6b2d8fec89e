"""BAQ (Base Alignment Quality): probabilistic realignment quality caps.

Reimplements the --baq path of the reference's genotyping stack:
 - the banded glocal profile-HMM posterior runs in the native library
   (panmap_native.cpp pt_baq_glocal; htslib probaln.c:77-420 semantics);
 - per-read gluing mirrors htslib realn.c:106-330 sam_prob_realn with
   BAQ_APPLY|BAQ_EXTEND (flag 3, as bcftools mpileup passes): window
   derivation from the cigar, extended-BAQ min-of-running-maxima smoothing,
   and qual[i] -= bq[i] - 64 application;
 - column gating mirrors bcftools mpileup.c:420-545 mplp_realn with
   MPLP_REALN_PARTIAL: a column triggers realignment only when its read
   stack shows indel/clip evidence, and individual reads that span the
   column by a comfortable margin of pure matches are left alone.
"""

from __future__ import annotations

import math

import numpy as np

from ..native import baq_glocal_native

_BIDX = {"A": 0, "C": 1, "G": 2, "T": 3}


def baq_glocal_py(ref: np.ndarray, query: np.ndarray, quals: np.ndarray,
                  bw_cap: int, gapd: float, gape: float):
    """Banded glocal profile-HMM posterior — the numpy formulation and test
    oracle of the native kernel (pt_baq_glocal mirrors this function the way
    every other native kernel mirrors its python twin).

    Model semantics match htslib BAQ (probaln_glocal behavior, which bcftools
    mpileup -B-off relies on): three states M/I/D over ref columns, the query
    may enter/leave the reference anywhere (glocal), banded so row i only
    holds columns |k - i| <= bw, forward/backward with per-row scaling, then
    a per-query-base MAP state and a phred-scaled posterior error.

    Band layout (the repo's formulation): each query row i carries vectors of
    width 2*bw+3 over OFFSETS j = k - (i - bw) + 1 with zero guard slots at
    j=0 and j=2*bw+2.  Under this indexing the diagonal predecessor
    (i-1, k-1) sits at the SAME j, the vertical predecessor (i-1, k) at j+1,
    and the in-row predecessor (i, k-1) at j-1 — so the M and I updates are
    pure elementwise vector ops and only the D state needs a short in-row
    scan (a first-order linear recurrence).

    Returns (state i32[Lq], q u8[Lq]): state = (ref_col << 2) | tag
    (tag 0 = M, 1 = I), q = phred posterior error, capped at 99.
    """
    lr, lq = len(ref), len(query)
    if lr <= 0 or lq <= 0:
        return None
    bw = min(max(lr, lq), bw_cap)
    bw = max(bw, abs(lr - lq))
    W = 2 * bw + 3  # band vector width incl. guard slots

    qp = 10.0 ** (-quals.astype(np.float64) / 10.0)
    # transition probabilities (rows: from M, from I, from D)
    sM = sI = 1.0 / (2 * lq + 2)
    mm = (1 - 2 * gapd) * (1 - sM)   # M->M
    mi = md = gapd * (1 - sM)        # M->I, M->D
    im = (1 - gape) * (1 - sI)       # I->M
    ii = gape * (1 - sI)             # I->I
    dm = 1 - gape                    # D->M
    dd = gape                        # D->D
    bM = (1 - gapd) / lr             # glocal begin
    bI = gapd / lr

    def row_cols(i):
        """(k_lo, k_hi, j_lo) for query row i (1-based), k 1-based."""
        k_lo, k_hi = max(1, i - bw), min(lr, i + bw)
        return k_lo, k_hi, k_lo - (i - bw) + 1

    def emit(i):
        """Match-emission vector for row i over its band columns."""
        k_lo, k_hi, j_lo = row_cols(i)
        rseg = ref[k_lo - 1 : k_hi]
        qb = query[i - 1]
        e = np.where(rseg == qb, 1.0 - qp[i - 1], qp[i - 1] / 3.0)
        e = np.where((rseg > 3) | (qb > 3), 1.0, e)
        return e, k_lo, k_hi, j_lo

    fM = np.zeros((lq + 1, W))
    fI = np.zeros((lq + 1, W))
    fD = np.zeros((lq + 1, W))
    s = np.zeros(lq + 2)
    s[0] = 1.0

    # forward row 1: glocal entry at any column
    e, k_lo, k_hi, j_lo = emit(1)
    sl = slice(j_lo, j_lo + (k_hi - k_lo + 1))
    fM[1, sl] = e * bM
    fI[1, sl] = 0.25 * bI
    s[1] = fM[1].sum() + fI[1].sum()

    for i in range(2, lq + 1):
        e, k_lo, k_hi, j_lo = emit(i)
        n = k_hi - k_lo + 1
        sl = slice(j_lo, j_lo + n)
        M = 1.0 / s[i - 1]
        # diagonal predecessor at same j; vertical predecessor at j+1
        pM, pI, pD = fM[i - 1], fI[i - 1], fD[i - 1]
        fM[i, sl] = e * (mm * pM[sl] + im * pI[sl]
                         + dm * pD[sl]) * M
        up = slice(j_lo + 1, j_lo + n + 1)
        fI[i, sl] = 0.25 * (mi * pM[up] + ii * pI[up]) * M
        # in-row D scan: fD[j] = md*fM[j-1] + dd*fD[j-1]
        d = 0.0
        for j in range(j_lo, j_lo + n):
            d = md * fM[i, j - 1] + dd * d
            fD[i, j] = d
        s[i] = fM[i, sl].sum() + fI[i, sl].sum() + fD[i, sl].sum()

    ML = 1.0 / s[lq]
    s[lq + 1] = (fM[lq].sum() * sM + fI[lq].sum() * sI) * ML

    bMk = np.zeros((lq + 1, W))
    bIk = np.zeros((lq + 1, W))
    bDk = np.zeros((lq + 1, W))
    k_lo, k_hi, j_lo = row_cols(lq)
    sl = slice(j_lo, j_lo + (k_hi - k_lo + 1))
    bMk[lq, sl] = sM / s[lq] / s[lq + 1]
    bIk[lq, sl] = sI / s[lq] / s[lq + 1]

    for i in range(lq - 1, 0, -1):
        k_lo, k_hi, j_lo = row_cols(i)
        n = k_hi - k_lo + 1
        sl = slice(j_lo, j_lo + n)
        # emission of row i+1 evaluated at column k+1 (same j under the
        # shifted row-(i+1) indexing), zero past the reference end
        rseg = np.zeros(n)
        ks = np.arange(k_lo, k_hi + 1)  # this row's columns; child col = k+1
        valid = ks < lr
        qb = query[i]
        rnext = ref[np.minimum(ks, lr - 1)]
        ev = np.where(rnext == qb, 1.0 - qp[i], qp[i] / 3.0)
        ev = np.where((rnext > 3) | (qb > 3), 1.0, ev)
        rseg[:] = np.where(valid, ev, 0.0)
        nM, nI = bMk[i + 1], bIk[i + 1]
        eM = rseg * nM[sl]  # e(i+1, k+1) * bM(i+1, k+1) — diagonal term
        dn = slice(j_lo - 1, j_lo + n - 1)  # (i+1, k) = j-1 in row i+1
        bMk[i, sl] = eM * mm + 0.25 * mi * nI[dn]
        bIk[i, sl] = eM * im + 0.25 * ii * nI[dn]
        # in-row right-to-left D scan (row 1 has no D state: y factor)
        if i > 1:
            d = 0.0
            for j in range(j_lo + n - 1, j_lo - 1, -1):
                d = rseg[j - j_lo] * nM[j] * dm + dd * d
                bDk[i, j] = d
        # the D contribution to M comes through the in-row D at k+1
        bMk[i, sl] += md * bDk[i, sl.start + 1 : sl.stop + 1]
        N = 1.0 / s[i]
        bMk[i, sl] *= N
        bIk[i, sl] *= N
        bDk[i, sl] *= N

    state = np.zeros(lq, dtype=np.int32)
    q = np.zeros(lq, dtype=np.uint8)
    for i in range(1, lq + 1):
        k_lo, k_hi, j_lo = row_cols(i)
        n = k_hi - k_lo + 1
        sl = slice(j_lo, j_lo + n)
        M = 1.0 / s[i]
        zM = M * fM[i, sl] * bMk[i, sl]
        zI = M * fI[i, sl] * bIk[i, sl]
        tot = zM.sum() + zI.sum()
        if tot <= 0.0:  # degenerate posterior: no information
            state[i - 1] = -1
            q[i - 1] = 0
            continue
        # first-maximum in (k asc, M before I) scan order
        z = np.empty(2 * n)
        z[0::2] = zM
        z[1::2] = zI
        best = int(np.argmax(z))
        mx = z[best] / tot
        kbest = k_lo + best // 2
        tag = best & 1
        state[i - 1] = (kbest - 1) << 2 | tag
        kq = int(-4.343 * np.log(1.0 - mx) + 0.499)
        q[i - 1] = 99 if kq > 100 else kq
    return state, q


def _codes(s: str) -> np.ndarray:
    out = np.full(len(s), 4, dtype=np.uint8)
    for i, ch in enumerate(s):
        out[i] = _BIDX.get(ch, 4)
    return out


def glocal_score_py(ref: np.ndarray, query: np.ndarray, quals: np.ndarray,
                    bw_cap: int, gapd: float, gape: float) -> int:
    """Forward-only glocal score (htslib probaln score semantics, the
    realignment objective of the bcftools indel model): the phred-scaled
    likelihood -4.343 * (sum log s_i + log(l_ref * l_query)) over the same
    banded forward recursion as baq_glocal_py.  Returns int phred (higher =
    worse fit), or a large sentinel when the recursion degenerates."""
    lr, lq = len(ref), len(query)
    if lr <= 0 or lq <= 0:
        return 0x7FFFFF
    bw = min(max(lr, lq), bw_cap)
    bw = max(bw, abs(lr - lq))
    W = 2 * bw + 3

    qp = 10.0 ** (-quals.astype(np.float64) / 10.0)
    sM = sI = 1.0 / (2 * lq + 2)
    mm = (1 - 2 * gapd) * (1 - sM)
    mi = md = gapd * (1 - sM)
    im = (1 - gape) * (1 - sI)
    ii = gape * (1 - sI)
    dm = 1 - gape
    dd = gape
    beginM = (1 - gapd) / lr
    beginI = gapd / lr

    def row_cols(i):
        k_lo, k_hi = max(1, i - bw), min(lr, i + bw)
        return k_lo, k_hi, k_lo - (i - bw) + 1

    def emit(i):
        k_lo, k_hi, j_lo = row_cols(i)
        rseg = ref[k_lo - 1 : k_hi]
        qb = query[i - 1]
        e = np.where(rseg == qb, 1.0 - qp[i - 1], qp[i - 1] / 3.0)
        e = np.where((rseg > 3) | (qb > 3), 1.0, e)
        return e, k_lo, k_hi, j_lo

    pM = np.zeros(W)
    pI = np.zeros(W)
    pD = np.zeros(W)
    s = np.zeros(lq + 2)
    s[0] = 1.0
    e, k_lo, k_hi, j_lo = emit(1)
    sl = slice(j_lo, j_lo + (k_hi - k_lo + 1))
    pM[sl] = e * beginM
    pI[sl] = 0.25 * beginI
    s[1] = pM.sum() + pI.sum()
    for i in range(2, lq + 1):
        e, k_lo, k_hi, j_lo = emit(i)
        n = k_hi - k_lo + 1
        sl = slice(j_lo, j_lo + n)
        if s[i - 1] <= 0:
            return 0x7FFFFF
        M = 1.0 / s[i - 1]
        nM = np.zeros(W)
        nI = np.zeros(W)
        nD = np.zeros(W)
        nM[sl] = e * (mm * pM[sl] + im * pI[sl] + dm * pD[sl]) * M
        up = slice(j_lo + 1, j_lo + n + 1)
        nI[sl] = 0.25 * (mi * pM[up] + ii * pI[up]) * M
        d = 0.0
        for j in range(j_lo, j_lo + n):
            d = md * nM[j - 1] + dd * d
            nD[j] = d
        pM, pI, pD = nM, nI, nD
        s[i] = pM[sl].sum() + pI[sl].sum() + pD[sl].sum()
    if s[lq] <= 0:
        return 0x7FFFFF
    s[lq + 1] = (pM.sum() * sM + pI.sum() * sI) / s[lq]

    # probaln's product-chunked log accumulation, kept verbatim for parity
    p = 1.0
    pr1 = 0.0
    for i in range(lq + 2):
        p *= s[i]
        if p < 1e-100:
            pr1 += -4.343 * math.log(p)
            p = 1.0
    if p <= 0:
        return 0x7FFFFF
    pr1 += -4.343 * math.log(p * lr * lq)
    return int(pr1 + 0.499)


def baq_realign_read(read, ref_codes: np.ndarray) -> bool:
    """Adjust read.quals in place (sam_prob_realn, BAQ_APPLY|BAQ_EXTEND).
    `read` is a PlacedRead whose cigar covers read.seq[qs:...] from ref rs.
    Returns True if adjusted."""
    lq = len(read.seq)
    if lq == 0:
        return False
    # alignment extent in query (y) and ref (x) coords over M ops
    x, y = read.rs, read.qs
    xb = yb = xe = ye = -1
    for ln, op in read.cigar:
        if op in ("M", "=", "X"):
            if yb < 0:
                yb = y
            if xb < 0:
                xb = x
            ye, xe = y + ln, x + ln
            x += ln
            y += ln
        elif op == "I":
            y += ln
        elif op in ("D", "N"):
            x += ln
    if xb < 0:
        return False
    bw = 7
    if abs((xe - xb) - (ye - yb)) > bw:
        bw = abs((xe - xb) - (ye - yb)) + 3
    xb -= yb + bw // 2
    if xb < 0:
        xb = 0
    xe += lq - ye + bw // 2
    if xe - xb - lq > bw:
        shrink = (xe - xb - lq - bw) // 2
        xb += shrink
        xe -= shrink
    xe = min(xe, len(ref_codes))
    if xe <= xb:
        return False

    tref = ref_codes[xb:xe]
    tseq = _codes(read.seq)
    quals = np.array(read.quals, dtype=np.uint8)
    out = baq_glocal_native(tref, tseq, quals, bw, 0.001, 0.1)
    if out is None:
        return False
    state, q = out

    bq = quals.copy()
    # extended BAQ over merged M runs: posterior where aligned on-diagonal,
    # 0 elsewhere, then min(running-left-max, running-right-max)
    runs = []  # (y_start, length, x_start) merged M segments
    x, y = read.rs, read.qs
    pend = None
    for ln, op in read.cigar:
        if op in ("M", "=", "X"):
            if pend is not None and pend[0] + pend[1] == y:
                pend = (pend[0], pend[1] + ln, pend[2])
            else:
                if pend is not None:
                    runs.append(pend)
                pend = (y, ln, x)
            x += ln
            y += ln
        elif op == "I":
            if pend is not None:
                runs.append(pend)
                pend = None
            y += ln
        elif op in ("D", "N"):
            if pend is not None:
                runs.append(pend)
                pend = None
            x += ln
    if pend is not None:
        runs.append(pend)

    for y0, ln, x0 in runs:
        ln = min(ln, lq - y0)
        if ln <= 0:
            continue
        seg = np.empty(ln, dtype=np.int32)
        for i in range(ln):
            yi = y0 + i
            on_diag = (state[yi] & 3) == 0 and (state[yi] >> 2) == (x0 - xb + i)
            seg[i] = q[yi] if on_diag else 0
        left = np.maximum.accumulate(seg)
        right = np.maximum.accumulate(seg[::-1])[::-1]
        bq[y0 : y0 + ln] = np.minimum(left, right)

    # apply: qual -= (bq_final - 64) with bq_final = 64 + max(0, qual - baq)
    adj = np.maximum(quals.astype(np.int32) - bq.astype(np.int32), 0)
    new_quals = quals.astype(np.int32) - adj
    read.quals = np.maximum(new_quals, 0).astype(np.int64).tolist()
    return True


def _read_has_indel(read) -> bool:
    return any(op in ("I", "D", "N") for _, op in read.cigar)


def _realn_column_gate(stack: list, pos: int) -> bool:
    """mplp_realn's MPLP_REALN_PARTIAL column trigger (mpileup.c:424-451)."""
    nt = len(stack)
    if nt == 0:
        return False
    has_indel = sum(1 for r in stack if _read_has_indel(r))
    has_clip = sum(1 for r in stack if getattr(r, "has_clip", False))
    indels = [_indel_after(r, pos) for r in stack]
    if has_indel == 0:
        return False
    if (has_clip < 0.2 * nt and max(indels) == min(indels)
            and (has_indel < 0.1 * nt or has_indel == 1)):
        return False
    return True


def _indel_after(read, pos: int) -> int:
    """Length of the indel immediately following ref position pos (+ins/-del),
    the pileup p->indel field."""
    x = read.rs
    for j, (ln, op) in enumerate(read.cigar):
        if op in ("M", "=", "X"):
            if x <= pos < x + ln:
                if pos == x + ln - 1 and j + 1 < len(read.cigar):
                    nop = read.cigar[j + 1]
                    if nop[1] == "I":
                        return nop[0]
                    if nop[1] in ("D", "N"):
                        return -nop[0]
                return 0
            x += ln
        elif op in ("D", "N"):
            x += ln
    return 0


def _read_gate(read, nt: int, has_clip_n: int) -> bool:
    """Per-read skip rules (mpileup.c:470-545): spanning the region with long
    clean match flanks means BAQ will not help."""
    realn_dist = 40 + 10 * (nt < 40) + 10 * (nt < 20)
    cig = read.cigar
    if len(cig) > 1:
        lm = 0
        nm = 0
        for ln, op in cig:
            if op in ("M", "=", "X"):
                lm += ln
                nm += 1
            else:
                break
        if nm != len(cig):
            rm = 0
            for ln, op in reversed(cig):
                if op in ("M", "=", "X"):
                    rm += ln
                else:
                    break
            if lm >= realn_dist * 4 and rm >= realn_dist * 4:
                return False
            if (lm >= realn_dist and rm >= realn_dist
                    and has_clip_n < (0.15 + 0.05 * (nt > 20)) * nt):
                return False
    return True


def apply_baq(reads: list, ref: str, max_read_len: int = 500) -> int:
    """Column-gated BAQ pass over the placed reads (quals adjusted in place).
    Returns the number of realigned reads."""
    ref_codes = _codes(ref)
    events = []  # (ref_pos, read) start events
    for r in reads:
        events.append(r)
    events.sort(key=lambda r: r.rs)
    # active stacks per column would be O(n^2); instead walk columns where
    # indel evidence can exist: positions adjacent to any read's indels
    cand_cols = set()
    for r in events:
        x = r.rs
        for ln, op in r.cigar:
            if op in ("M", "=", "X"):
                x += ln
            elif op in ("D", "N"):
                cand_cols.add(x - 1)
                x += ln
            elif op == "I":
                cand_cols.add(x - 1)
    if not cand_cols:
        return 0
    starts = np.array([r.rs for r in events], dtype=np.int64)
    ends = np.array([r.ref_end() for r in events], dtype=np.int64)
    realigned = set()
    n_done = 0
    for pos in sorted(cand_cols):
        idx = np.flatnonzero((starts <= pos) & (pos < ends))
        stack = [events[i] for i in idx]
        if not _realn_column_gate(stack, pos):
            continue
        nt = len(stack)
        has_clip_n = sum(1 for r in stack if getattr(r, "has_clip", False))
        for i in idx:
            r = events[i]
            if id(r) in realigned:
                continue
            realigned.add(id(r))
            if len(r.seq) > max_read_len:
                continue
            if not _read_gate(r, nt, has_clip_n):
                continue
            if baq_realign_read(r, ref_codes):
                n_done += 1
    return n_done
