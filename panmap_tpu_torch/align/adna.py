"""Ancient-DNA alignment backend (--aligner bwa equivalent).

The reference shells bwa **aln** in-process with aDNA settings
(src/bwa_align.c:260-268: -l 1024 seed disabled, -n 0.01, -o 2, -q 0) because
damage (C->T at 5' ends, G->A at 3' ends) breaks seed-and-extend heuristics
tuned for modern reads.  bwa aln is a whole-read (glocal) aligner: the entire
read must align within max_diff differences (bwtaln.c:42-55 bwa_cal_maxdiff
Poisson threshold).

TPU-native equivalent, same behavioral contract: dense small-k minimizer
anchoring (high sensitivity, no long seed requirement), then whole-read
SEMI-GLOBAL affine DP (no soft clips — damaged read ends stay aligned, unlike
the sr local path), accepted only when the edit distance is within
bwa_cal_maxdiff(len, 0.02, fnr).  mapq follows bwa aln's unique/repeat scheme
(37 unique, 25 one sub-optimal, 0 many)."""

from __future__ import annotations

import math

import numpy as np

from .core import Alignment, RefIndex, _RC_CODE, encode, minimizer_sketch

BWA_AVG_ERR = 0.02


def bwa_cal_maxdiff(length: int, err: float = BWA_AVG_ERR,
                    thres: float = 0.01) -> int:
    """Poisson-tail difference threshold (bwtaln.c:42-55)."""
    elambda = math.exp(-length * err)
    s = elambda
    y = 1.0
    x = 1
    for k in range(1, 1000):
        y *= length * err
        x *= k
        s += elambda * y / x
        if 1.0 - s < thres:
            return k
    return 2


def semiglobal_dp(q: np.ndarray, r: np.ndarray, gap_open: int = 2,
                  gap_ext: int = 1):
    """Whole-read vs window edit alignment: every query base must be aligned
    (free ref ends).  Unit mismatch cost, affine gaps (bwa aln -o 2 gap opens,
    extensions cost 1).  Returns (diffs, rs, re, cigar)."""
    lq, lr = len(q), len(r)
    BIG = np.int32(1 << 20)
    H = np.zeros((lq + 1, lr + 1), dtype=np.int32)  # min cost, free ref prefix
    E = np.full((lq + 1, lr + 1), BIG, dtype=np.int32)  # gap in query (D)
    F = np.full((lq + 1, lr + 1), BIG, dtype=np.int32)  # gap in ref (I)
    sub = np.where((q[:, None] == r[None, :]) & (q[:, None] < 4), 0, 1
                   ).astype(np.int32)
    idx = np.arange(lr + 1, dtype=np.int32)
    for i in range(1, lq + 1):
        F[i] = np.minimum(H[i - 1] + gap_open + gap_ext, F[i - 1] + gap_ext)
        base = np.full(lr + 1, BIG, dtype=np.int32)
        base[0] = F[i, 0]
        base[1:] = np.minimum(H[i - 1, :-1] + sub[i - 1], F[i, 1:])
        # deletions along the row via the prefix-min identity:
        # E[j] = go + ge*j + min_{j'<j}(base[j'] - ge*j')
        pm = np.minimum.accumulate(base - idx * gap_ext)
        E[i, 1:] = pm[:-1] + gap_open + gap_ext * idx[1:]
        E[i, 0] = BIG
        H[i] = np.minimum(base, E[i])
    j_end = int(np.argmin(H[lq]))
    diffs = int(H[lq, j_end])
    # traceback
    i, j = lq, j_end
    ops = []
    state = "H"
    while i > 0:
        if state == "H":
            h = H[i, j]
            if j > 0 and h == H[i - 1, j - 1] + sub[i - 1, j - 1]:
                ops.append("M")
                i -= 1
                j -= 1
            elif h == E[i, j]:
                state = "E"
            else:
                state = "F"
        elif state == "E":
            ops.append("D")
            if j > 1 and E[i, j] == E[i, j - 1] + gap_ext:
                j -= 1
            else:
                j -= 1
                state = "H"
        else:
            ops.append("I")
            if i > 1 and F[i, j] == F[i - 1, j] + gap_ext:
                i -= 1
            else:
                i -= 1
                state = "H"
    ops.reverse()
    cigar = []
    for op in ops:
        if cigar and cigar[-1][1] == op:
            cigar[-1] = (cigar[-1][0] + 1, op)
        else:
            cigar.append((1, op))
    return diffs, j, j_end, cigar


class AdnaAligner:
    """Whole-read aDNA-tolerant mapper with bwa-aln acceptance semantics."""

    def __init__(self, ref: str, k: int = 13, w: int = 5, fnr: float = 0.01,
                 gap_open: int = 2):
        self.ref = ref
        self.k = k
        self.w = w
        self.fnr = fnr
        self.gap_open = gap_open
        self.index = RefIndex(ref, k, w)

    def align_read(self, seq: str) -> Alignment:
        codes2 = encode(np.frombuffer(seq.encode(), dtype=np.uint8))
        lq = len(codes2)
        aln = Alignment()
        if lq < self.k:
            return aln
        maxdiff = bwa_cal_maxdiff(lq, BWA_AVG_ERR, self.fnr)
        qpos, qh, qstrand = minimizer_sketch(codes2, self.k, self.w)
        if len(qpos) == 0:
            return aln
        start, end = self.index.lookup_many(qh)
        counts = (end - start).astype(np.int64)
        tot = int(counts.sum())
        if tot == 0:
            return aln
        rpos = np.empty(tot, np.int64)
        qq = np.empty(tot, np.int64)
        rel = np.empty(tot, np.uint8)
        o = 0
        for a in range(len(qpos)):
            c = int(counts[a])
            if c == 0:
                continue
            s0, e0 = int(start[a]), int(end[a])
            rpos[o : o + c] = self.index.pos[s0:e0]
            qq[o : o + c] = qpos[a]
            rel[o : o + c] = self.index.strand[s0:e0] ^ qstrand[a]
            o += c

        # candidate diagonals per strand, ranked by votes
        cands = []
        for strand_rel in (0, 1):
            m = rel == strand_rel
            if not m.any():
                continue
            if strand_rel == 0:
                diags = rpos[m] - qq[m]
            else:
                diags = rpos[m] - (lq - self.k - qq[m])
            order = np.argsort(diags, kind="stable")
            d = diags[order]
            splits = np.flatnonzero(np.diff(d) > maxdiff + 2)
            starts = np.concatenate(([0], splits + 1))
            ends_ = np.concatenate((splits + 1, [len(d)]))
            for a0, b0 in zip(starts, ends_):
                cands.append((b0 - a0, strand_rel, int(np.median(d[a0:b0]))))
        cands.sort(reverse=True)

        lr = len(self.index.codes2)
        results = []
        seen = set()
        for votes, strand_rel, diag in cands[:4]:
            key = (strand_rel, diag // (maxdiff + 2))
            if key in seen:
                continue
            seen.add(key)
            oriented = codes2 if strand_rel == 0 else _RC_CODE[codes2[::-1]]
            pad = maxdiff + 2
            wlo = max(0, diag - pad)
            whi = min(lr, diag + lq + pad)
            if whi - wlo < lq:
                continue
            diffs, ws, we, cigar = semiglobal_dp(
                oriented, self.index.codes2[wlo:whi], self.gap_open)
            if diffs <= maxdiff and cigar:
                results.append((diffs, votes, strand_rel, wlo + ws, wlo + we,
                                cigar))
        if not results:
            return aln
        results.sort(key=lambda t: (t[0], -t[1]))
        diffs, votes, strand_rel, rs, re_, cigar = results[0]
        n_opt = sum(1 for t in results if t[0] == diffs)
        n_subopt = sum(1 for t in results if t[0] == diffs + 1)
        aln.mapped = True
        aln.rs, aln.re = rs, re_
        aln.qs, aln.qe = 0, lq  # whole read aligned: no clips
        aln.rev = bool(strand_rel)
        aln.cigar = cigar
        aln.nm = diffs
        aln.score = -diffs
        # bwa aln mapq scheme (bwase.c approx): unique 37, degraded by repeats
        if n_opt > 1:
            aln.mapq = 0
        elif n_subopt > 0:
            aln.mapq = 25
        else:
            aln.mapq = 37
        return aln

    def align_batch(self, seqs: list) -> list:
        return [self.align_read(s) for s in seqs]
