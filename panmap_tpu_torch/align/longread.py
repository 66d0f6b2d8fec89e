"""Long-read alignment presets (map-ont / map-hifi equivalents).

The reference selects a minimap2 preset by mean read length
(src/mm_align.c:38-118: <500 -> sr, <5000 -> map-ont, else map-hifi;
preset constants from src/3rdparty/minimap2/options.c:5-114).  This module
provides the long-read side: (w,k)-minimizer anchoring (same hash/sketch as
the sr path), diagonal-band chaining, and a shifted-band affine-gap DP whose
memory scales with read_len x band instead of read_len x window — the sr
whole-matrix DP would need GBs at ONT lengths.

Gap model: minimap2's dual affine cost min(q + |g|*e, q2 + |g|*e2)
(options.c q/e defaults + the long-gap tier), realized as two E/F DP lanes.
Extension stops on z-drop with ksw2's diagonal-movement slack (row max more
than `zdrop + e*|diag - diag_max|` below the global best ends the scan — the
slack is what lets a long gap traversal survive the drop test).  Chains come
from the minimap2 chain DP (mm_chain_dp,
chain.c:81-180: f[j] = max f[i] + min(dq, dr, k) - gamma(dd), gamma =
0.01*k*dd + 0.5*log2(dd), predecessor window capped), so a read spanning a
large indel chains across it and the banded DP gets the full diagonal range.
Short reads keep using the bit-exact sr path in align/core.py /
align/batch.py.

mapq takes its secondary score as minimap2 does: chains are backtracked
with each anchor used once (mm_chain_backtrack), and the secondary is the
best other chain, on either strand, whose query span overlaps the
primary's by at least half the shorter span (mm_set_parent, mask level
0.5).  The JAX package takes the best f of any anchor off the primary
chain, which an anchor beside the chain nearly always matches, so nearly
every read there gets mapq 1; chain_dp and _chain_front differ from its
for that alone, and every other field of a read's alignment is the JAX
package's.

The host half (presets, ``banded_dp_shifted``, LongReadAligner's
``_finish``) is carried over from panmap_tpu/align/longread.py unchanged;
its device routing
(_resolve_long_device: a locally attached TPU, PANMAP_PALLAS_LONG) served a
remote TPU link and is not carried.  ``LongReadAligner.align_batch`` here is
the host path (the JAX package's ``device=None``); TorchLongReadAligner
sends every chained read's (query, dlo, dhi) through
align/long_dp.py::long_dp_batch on one device instead (the CUDA kernel, or
its plain PyTorch version for a CPU device), bit-equal by construction.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch

from .. import trace
from ..native import chain_dp_native, require_lib
from .core import Alignment, RefIndex, _RC_CODE, encode, minimizer_sketch


@dataclass(frozen=True)
class LongPreset:
    name: str
    k: int
    w: int
    match: int
    mismatch: int
    gap_open: int
    gap_ext: int
    min_cnt: int
    min_chain_score: int  # in matching bases
    min_dp_max: int
    bw: int
    max_gap: int
    gap_open2: int = 24  # long-gap tier (minimap2 -O q,q2 / -E e,e2)
    gap_ext2: int = 1
    zdrop: int = 400


# options.c:14-63 defaults (= map-ont) and :108-114 map-hifi overrides
MAP_ONT = LongPreset("map-ont", k=15, w=10, match=2, mismatch=4, gap_open=4,
                     gap_ext=2, min_cnt=3, min_chain_score=40, min_dp_max=80,
                     bw=500, max_gap=5000, gap_open2=24, gap_ext2=1, zdrop=400)
MAP_HIFI = LongPreset("map-hifi", k=19, w=19, match=1, mismatch=4, gap_open=6,
                      gap_ext=2, min_cnt=3, min_chain_score=40, min_dp_max=200,
                      bw=500, max_gap=10000, gap_open2=26, gap_ext2=1,
                      zdrop=400)


def pick_preset(avg_len: float) -> LongPreset:
    """mm_align.c:39-41 length thresholds (sr below 500 is handled upstream)."""
    return MAP_ONT if avg_len < 5000 else MAP_HIFI


@functools.lru_cache(maxsize=None)
def _gap_penalty(k: int, max_gap: int) -> np.ndarray:
    """gamma(dd) of chain_dp for every dd < max_gap, by numpy's float64
    arithmetic (its log2 may differ from libm's in the last place, and
    ties pick the predecessors); read-only, one array per (k, max_gap)."""
    dd = np.arange(max_gap)
    pen = np.where(dd > 0,
                   0.01 * k * dd + 0.5 * np.log2(np.maximum(dd, 2)), 0.0)
    pen.setflags(write=False)
    return pen


def chain_dp(qv: np.ndarray, rv: np.ndarray, k: int, max_gap: int,
             min_cnt: int, min_sc: float, h: int = 50):
    """minimap2 chain DP (chain.c mm_chain_dp semantics): anchors sorted by
    (rpos, qpos); f[j] = max over the last `h` predecessors of
    f[i] + min(dq, dr, k) - gamma(dd) with gamma(dd) = 0.01*k*dd +
    0.5*log2(dd); anchors start at f = k.  The best chain ends at the first
    anchor of the highest f and follows, on ties, the first predecessor.

    Then the chains as mm_chain_backtrack makes them, on minimap2's
    predecessors (the last one on ties): from the anchor of the highest f
    down (the first anchor on ties, so that the first chain ends where the
    best one does), each chain walks back until it meets an anchor an
    earlier chain took, so that every anchor is used once, and scores
    f[end] - f[met] (f[end] where it met none).  The first predecessor
    leaves anchors of a colinear run off the best chain, as parallel chains
    of their own that minimap2 never makes; its choice is kept for the best
    chain, whose anchors set the DP's band.

    Returns (best_score, chain_anchor_indices ascending, chains): chains is
    [(score, anchor indices ascending)], the first chain, then the later
    ones that end at an f of at least ``min_sc`` and have ``min_cnt``
    anchors and ``min_sc`` score; indices are into the input arrays,
    ascending in (rpos, qpos) order.

    The DP and the backtrack are one native call (pt_chain_dp); without
    the library it raises, under PANMAP_TPU_NO_NATIVE too.  Counts on the
    open span (align.front): chain_calls and anchors."""
    if require_lib() is None:
        raise RuntimeError(
            "the chain DP needs the native library, which "
            "PANMAP_TPU_NO_NATIVE turns off; it has no numpy twin (its "
            "oracles are the JAX package's best chain, "
            "panmap_tpu/align/longread.py::chain_dp, and the benchmark's "
            "chains, pmbench/reference/chains.py)")
    n = len(qv)
    if n == 0:
        return 0.0, np.empty(0, np.int64), []
    trace.count("chain_calls", 1)
    trace.count("anchors", n)
    order = np.lexsort((qv, rv))
    best, path, chains = chain_dp_native(
        qv[order], rv[order], k, max_gap, min_cnt, min_sc, h,
        _gap_penalty(k, max_gap))
    return best, order[path], [(sc, order[ids]) for sc, ids in chains]


def banded_dp_shifted(q: np.ndarray, r: np.ndarray, dlo: int, dhi: int,
                      pre: LongPreset):
    """Local affine DP in a diagonal band: row i covers ref positions
    [dlo + i, dhi + i] (band coordinates shift with the row, so storage is
    lq x band).  Returns (score, qs, qe, rs, re, cigar)."""
    lq, lr = len(q), len(r)
    W = dhi - dlo + 1
    NEG = np.int32(-(1 << 28))
    A, B, GO, GE = pre.match, pre.mismatch, pre.gap_open, pre.gap_ext
    GO2, GE2 = pre.gap_open2, pre.gap_ext2

    H = np.zeros((lq + 1, W), dtype=np.int32)
    E = np.full((lq + 1, W), NEG, dtype=np.int32)   # deletion, short tier
    E2 = np.full((lq + 1, W), NEG, dtype=np.int32)  # deletion, long tier
    F = np.full((lq + 1, W), NEG, dtype=np.int32)   # insertion, short tier
    F2 = np.full((lq + 1, W), NEG, dtype=np.int32)  # insertion, long tier
    cidx = np.arange(W, dtype=np.int64)

    best = (0, 0, 0)
    for i in range(1, lq + 1):
        off = dlo + i  # ref position of band column 0 at this row
        j = cidx + off  # 1-based ref column per band cell
        inb = (j >= 1) & (j <= lr)
        # diagonal: (i-1, j-1) sits at the SAME band column of the prev row
        qc = q[i - 1]
        rj = np.where(inb, r[np.clip(j - 1, 0, lr - 1)], 4)
        sub = np.where((rj == qc) & (qc < 4), A, -B).astype(np.int32)
        diag = H[i - 1] + sub
        # insertion (consume query): (i-1, j) = band column c+1 of prev row
        up = np.full(W, NEG, dtype=np.int32)
        up[:-1] = np.maximum(H[i - 1, 1:] - GO, F[i - 1, 1:] - GE)
        F[i] = up
        up2 = np.full(W, NEG, dtype=np.int32)
        up2[:-1] = np.maximum(H[i - 1, 1:] - GO2, F2[i - 1, 1:] - GE2)
        F2[i] = up2
        base = np.maximum(np.maximum(diag, np.maximum(up, up2)), 0)
        base = np.where(inb, base, NEG)
        # deletion (consume ref): same-row prefix-max over band columns,
        # one prefix-max per gap tier
        pm = np.maximum.accumulate(base + cidx.astype(np.int32) * GE)
        E[i, 1:] = pm[:-1] - GO - (cidx[1:].astype(np.int32) - 1) * GE
        E[i, 0] = NEG
        pm2 = np.maximum.accumulate(base + cidx.astype(np.int32) * GE2)
        E2[i, 1:] = pm2[:-1] - GO2 - (cidx[1:].astype(np.int32) - 1) * GE2
        E2[i, 0] = NEG
        H[i] = np.where(inb, np.maximum(base, np.maximum(E[i], E2[i])), 0)
        cmax = int(np.argmax(H[i]))
        row_max = int(H[i, cmax])
        if row_max > best[0]:
            best = (row_max, i, cmax)
        elif best[0] - row_max > pre.zdrop + GE * abs(cmax - best[2]):
            # ksw2 z-drop with the diagonal-movement slack term
            # (|diag - diag_max| * e): a long gap traversal lowers the row
            # max by its gap cost but moves diagonally, so it is forgiven
            break

    score, bi, bc = best
    if score <= 0:
        return 0, 0, 0, 0, 0, []
    # traceback
    i, c = bi, bc
    ops = []
    state = "H"
    while i > 0:
        j = c + dlo + i
        if j <= 0:
            break
        if state == "H":
            h = int(H[i, c])
            if h == 0:
                break
            qc = q[i - 1]
            rj = r[j - 1] if 1 <= j <= lr else 4
            s = A if (rj == qc and qc < 4) else -B
            if h == H[i - 1, c] + s:
                ops.append("M")
                i -= 1  # same band column: diagonal move
            elif h == E[i, c]:
                state = "E"
            elif h == E2[i, c]:
                state = "E2"
            elif h == F[i, c]:
                state = "F"
            elif h == F2[i, c]:
                state = "F2"
            else:
                ops.append("M")
                i -= 1
        elif state in ("E", "E2"):  # deletion run in one gap tier
            lane, ext = (E, GE) if state == "E" else (E2, GE2)
            ops.append("D")
            if not (c > 1 and lane[i, c] == lane[i, c - 1] - ext):
                state = "H"
            c -= 1
        else:  # F/F2: insertion, predecessor at (i-1, band column c+1)
            lane, ext = (F, GE) if state == "F" else (F2, GE2)
            ops.append("I")
            nc = c + 1
            cont = nc < W and i > 1 and lane[i, c] == lane[i - 1, nc] - ext
            i -= 1
            c = nc
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


class LongReadAligner:
    """Single-reference long-read mapper: minimizer anchors -> diagonal-band
    cluster -> shifted-band DP (mm_align.c:105-118 map-ont/map-hifi path)."""

    def __init__(self, ref: str, preset: LongPreset):
        self.pre = preset
        self.ref = ref
        self.index = RefIndex(ref, preset.k, preset.w)

    def align_read(self, seq: str) -> Alignment:
        front = self._chain_front(seq)
        if front is None:
            return Alignment()
        oriented, dlo, dhi, meta = front
        dp = banded_dp_shifted(oriented, self.index.codes2, dlo, dhi,
                               self.pre)
        return self._finish(dp, meta)

    def _anchors(self, codes2: np.ndarray):
        """The read's minimizer hits on the reference: (query position,
        reference position, strand relative to the reference) arrays, or
        None where it has none."""
        pre = self.pre
        qpos, qh, qstrand = minimizer_sketch(codes2, pre.k, pre.w)
        if len(qpos) == 0:
            return None
        start, end = self.index.lookup_many(qh)
        counts = (end - start).astype(np.int64)
        tot = int(counts.sum())
        if tot == 0:
            return None
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
        return qq, rpos, rel

    def _chain_front(self, seq: str):
        """Anchor + chain phase: returns (oriented_codes, dlo, dhi, meta)
        where meta carries what _finish needs, or None when unmapped."""
        pre = self.pre
        codes2 = encode(np.frombuffer(seq.encode(), dtype=np.uint8))
        lq = len(codes2)
        hits = self._anchors(codes2)
        if hits is None:
            return None
        qq, rpos, rel = hits

        # per-strand minimap2 chain DP; primary = best chain across strands
        best = None
        found = []  # per strand: minimap2's chains, (score, anchors, span)
        for strand_rel in (0, 1):
            m = rel == strand_rel
            if not m.any():
                continue
            if strand_rel == 0:
                qv = qq[m]
            else:
                qv = lq - pre.k - qq[m]
            score, chain_idx, chains = chain_dp(
                qv, rpos[m], pre.k, pre.max_gap, pre.min_cnt,
                pre.min_chain_score)
            qs = qq[m]  # query span on the read: [first, last + k)
            found.append([(sc, len(ix), (int(qs[ix].min()),
                                         int(qs[ix].max()) + pre.k))
                          for sc, ix in chains])
            diags = rpos[m][chain_idx] - qv[chain_idx]
            cand = (score, len(chain_idx), strand_rel,
                    int(diags.min()), int(diags.max()), len(found) - 1)
            if best is None or score > best[0]:
                best = cand
        if best is None:
            return None
        chain_score, votes, strand_rel, dmin, dmax, at = best
        if votes < pre.min_cnt or chain_score < pre.min_chain_score:
            return None
        # secondary (mm_set_parent, mask level 0.5): the best other chain
        # of min_cnt anchors and min_chain_score, on either strand, whose
        # query span overlaps the primary's by at least half the shorter
        ps, pe = found[at][0][2]
        others = [c for n, chains in enumerate(found)
                  for c in (chains[1:] if n == at else chains)]
        second_score = max(
            (sc for sc, cnt, (a, b) in others
             if cnt >= pre.min_cnt and sc >= pre.min_chain_score
             and 2 * (min(b, pe) - max(a, ps)) >= min(b - a, pe - ps)),
            default=0.0)

        oriented = codes2 if strand_rel == 0 else _RC_CODE[codes2[::-1]]
        dlo = int(dmin) - pre.bw
        dhi = int(dmax) + pre.bw
        meta = (lq, strand_rel, chain_score, votes, second_score)
        return oriented, dlo, dhi, meta

    def _finish(self, dp, meta) -> Alignment:
        """DP result -> Alignment (clips/strand/mapq)."""
        lq, strand_rel, chain_score, votes, second_score = meta
        pre = self.pre
        aln = Alignment()
        score, qs, qe, rs, re_, cigar = dp
        if score < pre.min_dp_max or not cigar:
            return aln
        aln.mapped = True
        aln.score = score
        aln.qs, aln.qe, aln.rs, aln.re = qs, qe, rs, re_
        aln.cigar = cigar
        aln.rev = bool(strand_rel)
        if aln.rev:
            aln.qs, aln.qe = lq - aln.qe, lq - aln.qs
        # mm2-style mapq from primary/secondary chain scores
        # (mm_mapq: 40*(1-sub/pri)*min(1, n/10)*ln-ish scale, clamped)
        if second_score <= 0:
            aln.mapq = 60
        else:
            frac = 1.0 - second_score / max(chain_score, 1e-9)
            aln.mapq = max(1, min(60, int(40 * frac * min(1.0, votes / 10))))
        return aln

    def align_batch(self, seqs: list) -> list:
        """One Alignment per read, every DP on the host."""
        return [self.align_read(s) for s in seqs]


class TorchLongReadAligner(LongReadAligner):
    """LongReadAligner whose DP rows run on ``device`` (the kernel, or its
    plain PyTorch version for a CPU device)."""

    def __init__(self, ref: str, preset: LongPreset, device,
                 stats: dict | None = None):
        """``stats``: a dict that accumulates long_dp_batch's counters
        (items, device_dp, host_dp)."""
        super().__init__(ref, preset)
        self.device = torch.device(device)
        self.stats = {} if stats is None else stats
        # the reference codes go to the device once per aligner
        self._ref_dev = torch.from_numpy(
            self.index.codes2.astype(np.int8)).to(self.device)

    def align_batch(self, seqs: list) -> list:
        """One Alignment per read, equal field for field to
        LongReadAligner.align_batch(seqs)."""
        with trace.span("align.front"):
            fronts = [self._chain_front(s) for s in seqs]
        items = [(f[0], f[1], f[2]) for f in fronts if f is not None]
        from .long_dp import long_dp_batch  # imports this module

        dps = iter(long_dp_batch(items, self.index.codes2, self.pre,
                                 self.device, self.stats, self._ref_dev))
        with trace.span("align.mapq") as sp:
            out = [Alignment() if f is None else self._finish(next(dps), f[3])
                   for f in fronts]
            mapq = [a.mapq for a in out if a.mapped]
            sp.count("mapped", len(mapq))
            sp.count("mapq_low", sum(m < 20 for m in mapq))
        return out
