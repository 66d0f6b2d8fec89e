"""True BWT bwa-aln: FM-index bounded-difference search (the --aligner bwa
algorithm itself, not a behavioral substitute).

Implements the used subset of bwa-backtrack for the reference's
ancient-DNA mode (src/bwa_align.c:260-268: fnr=0.01, max_gapo=2, seed
disabled, trim 0) with the exact bwt_match_gap search semantics
(src/3rdparty/bwa/bwtgap.c:109-260):

 - best-first exploration over per-score stacks (pop lowest
   aln_score = 3*mm + 11*gapo + 4*gape, LIFO within a score);
 - the D-array lower bound (bwt_cal_width over the reversed text) pruning
   `m < width[i-1].bid`, with the allow_M equal-width refinement;
 - M/I/D state machine: gap opens only from M (max_gapo), extensions up to
   max_gape, indel_end_skip=5 with the gap-count widening, max_del_occ=10
   deletion-extension occupancy rule; GAPE mode (extensions consume the
   diff budget m);
 - stop rules: popped score > best+s_mm, top2 max_diff shrink after the
   first hit, best_cnt > max_top2 break, max_entries safety valve,
   gap_shadow width reduction after each hit, tandem-gap interval dedup;
 - hit selection/mapQ exactly as bwase.c: c1/c2 interval mass at
   best/other scores, bwa_approx_mapQ with the g_log_n table.

Conventions differ from bwa internally (we search the oriented read
right-to-left against the FORWARD reference's FM index and run both
orientations explicitly; bwa searches one pattern against a fwd+revcomp
doubled reference, making its pruning bounds global across strands).  The
two-search formulation threads each strand's best_score/best_diff/best_cnt
into the other's initial bounds and re-runs the first strand when the
second improved the global best (match_gap seed_best), so the cross-strand
top2 shrink / best_score stop / MAX_TOP2 counter match the combined
search; the one remaining deviation is pop INTERLEAVING, which can only
matter through the MAX_ENTRIES safety valve on pathological reads.  CIGARs
for gapped hits come from the same whole-read semiglobal DP the behavioral
backend uses (bwa's refine_gapped analog).

The genomes this pipeline places against are tiny (16-30kb), so the full
suffix array and dense occ table are built directly in numpy.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

from .adna import bwa_cal_maxdiff, semiglobal_dp
from .core import Alignment, _RC_CODE, encode

S_MM, S_GAPO, S_GAPE = 3, 11, 4
MAX_GAPO = 2          # bwa_align.c:265 (-o 2)
MAX_GAPE = 6
INDEL_END_SKIP = 5
MAX_DEL_OCC = 10
MAX_ENTRIES = 2_000_000
MAX_TOP2 = 30

_G_LOG_N = np.array([int(4.343 * math.log(n) + 0.5) if n else 0
                     for n in range(256)])

STATE_M, STATE_I, STATE_D = 0, 1, 2

# Envelopes for the TRUE search.  With the native core (pt_bwt_aln: the same
# best-first search in threaded C++) the bound is index memory + suffix-array
# build time, not per-read python interpretation — 64 Mb covers every genome
# class the reference's aDNA mode targets, with unlimited reads.  The
# interpreted-python search keeps the old tight bounds (it is the ORACLE, not
# the product path).  Beyond the active envelope the caller dispatches to the
# vectorized minimizer backend (align/adna.py) WITH A LOUD WARNING — it is a
# different algorithm (behavioral substitute, concordance quantified in
# tests/test_bwt_aln.py).
BWT_MAX_REF = 1 << 20        # 1 Mb reference (python search)
BWT_MAX_READS = 50_000       # (python search)
BWT_MAX_REF_NATIVE = 64 << 20


def _native_bwt_available() -> bool:
    from ..native import get_lib

    lib = get_lib()
    return lib is not None and hasattr(lib, "pt_bwt_aln")


def pick_adna_aligner(ref: str, n_reads: int, log=None):
    """The production --aligner bwa dispatch: the true BWT search within its
    practical envelope (native C++ core when available), the minimizer
    behavioral backend beyond it — loudly, never silently."""
    if _native_bwt_available():
        if len(ref) <= BWT_MAX_REF_NATIVE:
            return BwtAligner(ref), "bwt"
    elif len(ref) <= BWT_MAX_REF and n_reads <= BWT_MAX_READS:
        return BwtAligner(ref), "bwt"
    msg = (f"[align] WARNING: workload ({len(ref)} bp reference, {n_reads} "
           f"reads) exceeds the bwa-aln search envelope"
           + ("" if _native_bwt_available()
              else " (native core unavailable: python-search bounds apply)")
           + "; substituting the minimizer backend (a DIFFERENT algorithm — "
           "behavioral concordance, not bwa-aln semantics; see "
           "tests/test_bwt_aln.py)")
    (log or print)(msg)
    from .adna import AdnaAligner

    return AdnaAligner(ref), "minimizer"


def _suffix_array(codes: np.ndarray) -> np.ndarray:
    """Suffix array by prefix doubling (text includes a unique sentinel)."""
    n = len(codes)
    rank = codes.astype(np.int64)
    sa = np.argsort(rank, kind="stable").astype(np.int64)
    tmp = np.empty(n, dtype=np.int64)
    k = 1
    while k < n:
        key2 = np.full(n, -1, dtype=np.int64)
        key2[: n - k] = rank[k:]
        order = np.lexsort((key2, rank))
        tmp[order[0]] = 0
        prev = order[:-1]
        cur = order[1:]
        diff = (rank[cur] != rank[prev]) | (key2[cur] != key2[prev])
        tmp[cur] = np.cumsum(diff)
        rank, tmp = tmp.copy(), rank
        if rank[order[-1]] == n - 1:
            sa = order
            break
        sa = order
        k <<= 1
    return sa


class FmIndex:
    """FM index over a 0..3 coded text + sentinel (code 4, lexicographically
    largest so ACGT order matches bwa's L2).  The dense occ table (32 B/base)
    is built LAZILY: the native search (pt_bwt_aln) only needs bwt/C/sa and
    builds its own 64-base checkpoints, so the python-search table is paid
    for only when the python oracle path actually runs."""

    def __init__(self, codes: np.ndarray):
        text = np.concatenate([codes.astype(np.int64), [4]])
        self.n = len(text)
        sa = _suffix_array(text)
        self.sa = sa
        self.bwt = text[(sa - 1) % self.n].astype(np.uint8)
        self._occ = None
        counts = np.bincount(text, minlength=5)
        # C[c] = # of symbols strictly smaller than c ('$' sorts last here,
        # mirroring bwa's primary-index handling; L2 skips it)
        self.C = np.zeros(5, dtype=np.int64)
        self.C[1:] = np.cumsum(counts[:4])[: 4]
        # interval convention: [k, l] inclusive over SA rows
        self.full = (0, self.n - 1)

    @property
    def occ(self):
        """occ[c, i] = # of c in bwt[:i] (python-search path only)."""
        if self._occ is None:
            self._occ = np.zeros((4, self.n + 1), dtype=np.int64)
            for c in range(4):
                self._occ[c, 1:] = np.cumsum(self.bwt == c)
        return self._occ

    def extend(self, k: int, l: int, c: int):
        """Backward-search step: prepend symbol c."""
        k2 = self.C[c] + self.occ[c, k]
        l2 = self.C[c] + self.occ[c, l + 1] - 1
        return k2, l2


def cal_width(fm_rev: FmIndex, pat: np.ndarray):
    """bwt_cal_width: D-array lower bounds — scan the pattern left-to-right
    over the REVERSED text's index; each time the interval empties, one more
    difference is provably needed.  Returns (bid i32[len], w i64[len])."""
    L = len(pat)
    bid = np.zeros(L, dtype=np.int64)
    wid = np.zeros(L, dtype=np.int64)
    k, l = fm_rev.full
    b = 0
    for i in range(L):
        c = int(pat[i])
        if c > 3:
            k, l = 0, -1
        else:
            k, l = fm_rev.extend(k, l, c)
        if k > l:
            b += 1
            k, l = fm_rev.full
        bid[i] = b
        wid[i] = l - k + 1
    return bid, wid


@dataclass
class BwtHit:
    k: int
    l: int
    n_mm: int
    n_gapo: int
    n_gape: int
    n_ins: int
    n_del: int
    score: int


def match_gap(fm: FmIndex, pat: np.ndarray, width_bid, width_w,
              max_diff: int, seed_best=None):
    """bwt_match_gap port: all alignments of `pat` within the bounds.
    Returns (hits, best_cnt_c1, other_cnt_c2, best_score).

    `seed_best` = (best_score, best_diff, best_cnt) threads another strand's
    results into this search's initial pruning bounds: real bwa searches one
    pattern against a fwd+revcomp doubled reference, so the top2 max-diff
    shrink, the best_score stop, and the MAX_TOP2 counter are GLOBAL across
    strands — seeding reproduces that for the two-search formulation
    (BwtAligner.align_read runs the strands to a fixed point)."""
    L = len(pat)
    if int((pat > 3).sum()) > max_diff:
        return [], 0, 0, 1 << 30
    if seed_best is not None:
        best_score, best_diff, best_cnt = seed_best
        cur_max_diff = min(best_diff + 1, max_diff)
    else:
        best_score = S_MM * (max_diff + 1) + S_GAPO * (MAX_GAPO + 1) \
            + S_GAPE * (MAX_GAPE + 1)
        best_diff = max_diff + 1
        cur_max_diff = max_diff
        best_cnt = 0
    width_bid = width_bid.copy()
    width_w = width_w.copy()
    hits: list = []
    # per-score LIFO stacks (gap_stack_t)
    stacks: dict = {}

    n_entries = 0

    def push(score, i, k, l, mm, go, ge, ni, nd, state, is_diff, ldp):
        nonlocal n_entries
        stacks.setdefault(score, []).append(
            (i, k, l, mm, go, ge, ni, nd, state, i if is_diff else ldp))
        n_entries += 1

    push(0, L, 0, fm.n - 1, 0, 0, 0, 0, 0, STATE_M, 0, 0)

    c1 = c2 = 0
    while n_entries:
        if n_entries > MAX_ENTRIES:
            break
        score = min(s for s, st in stacks.items() if st)
        if score > best_score + S_MM:
            break
        e = stacks[score].pop()
        n_entries -= 1
        i, k, l, n_mm, n_gapo, n_gape, n_ins, n_del, state, ldp = e

        m = cur_max_diff - (n_mm + n_gapo) - n_gape  # GAPE mode
        if m < 0:
            continue
        if i > 0 and m < width_bid[i - 1]:
            continue

        hit_found = False
        if i == 0:
            hit_found = True
        elif m == 0:
            # exact-match completion of the remaining prefix
            kk, ll = k, l
            ok = True
            for j in range(i - 1, -1, -1):
                c = int(pat[j])
                if c > 3:
                    ok = False
                    break
                kk, ll = fm.extend(kk, ll, c)
                if kk > ll:
                    ok = False
                    break
            if ok:
                k, l = kk, ll
                hit_found = True
            else:
                continue

        if hit_found:
            sc = S_MM * n_mm + S_GAPO * n_gapo + S_GAPE * n_gape
            # pops are in increasing score order, so only the FIRST hit can
            # improve best_score (sc < best_score also covers beating a
            # seeded cross-strand bound)
            if sc < best_score:
                best_score = sc
                best_diff = n_mm + n_gapo + n_gape
                cur_max_diff = min(best_diff + 1, max_diff)  # top2
            if sc == best_score:
                best_cnt += l - k + 1
                c1 += l - k + 1
            else:
                if best_cnt > MAX_TOP2:
                    break
                c2 += l - k + 1
            dup = False
            if n_gapo:  # tandem-repeat gap dedup
                dup = any(h.k == k and h.l == l for h in hits)
            if not dup:
                # gap_shadow: damp widths below the last diff position
                x = l - k + 1
                jj = 0
                for t2 in range(ldp):
                    if width_w[t2] > x:
                        width_w[t2] -= x
                    elif width_w[t2] == x:
                        jj += 1
                        width_bid[t2] = 1
                        width_w[t2] = fm.n - 1 - jj
                hits.append(BwtHit(k, l, n_mm, n_gapo, n_gape, n_ins, n_del,
                                   sc))
            continue

        i -= 1
        occ = l - k + 1
        # per-symbol sub-intervals
        subs = [fm.extend(k, l, c) for c in range(4)]
        allow_diff = allow_m = True
        if i > 0:
            if width_bid[i - 1] > m - 1:
                allow_diff = False
            elif (width_bid[i - 1] == m - 1 and width_bid[i] == m - 1
                  and width_w[i - 1] == width_w[i]):
                allow_m = False

        tmp = n_gapo + n_gape
        if (allow_diff and i >= INDEL_END_SKIP + tmp
                and L - i >= INDEL_END_SKIP + tmp):
            if state == STATE_M:
                if n_gapo < MAX_GAPO:
                    push(S_MM * n_mm + S_GAPO * (n_gapo + 1)
                         + S_GAPE * n_gape,
                         i, k, l, n_mm, n_gapo + 1, n_gape, n_ins + 1,
                         n_del, STATE_I, 1, ldp)
                    for c in range(4):
                        k2, l2 = subs[c]
                        if k2 <= l2:
                            push(S_MM * n_mm + S_GAPO * (n_gapo + 1)
                                 + S_GAPE * n_gape,
                                 i + 1, k2, l2, n_mm, n_gapo + 1, n_gape,
                                 n_ins, n_del + 1, STATE_D, 1, ldp)
            elif state == STATE_I:
                if n_gape < MAX_GAPE:
                    push(S_MM * n_mm + S_GAPO * n_gapo
                         + S_GAPE * (n_gape + 1),
                         i, k, l, n_mm, n_gapo, n_gape + 1, n_ins + 1,
                         n_del, STATE_I, 1, ldp)
            elif state == STATE_D:
                if n_gape < MAX_GAPE and (n_gape + n_gapo < cur_max_diff
                                          or occ < MAX_DEL_OCC):
                    for c in range(4):
                        k2, l2 = subs[c]
                        if k2 <= l2:
                            push(S_MM * n_mm + S_GAPO * n_gapo
                                 + S_GAPE * (n_gape + 1),
                                 i + 1, k2, l2, n_mm, n_gapo, n_gape + 1,
                                 n_ins, n_del + 1, STATE_D, 1, ldp)

        if allow_diff and allow_m:
            for j in range(1, 5):
                c = (int(pat[i]) + j) & 3
                is_mm = 1 if (j != 4 or pat[i] > 3) else 0
                k2, l2 = subs[c]
                if k2 <= l2:
                    push(S_MM * (n_mm + is_mm) + S_GAPO * n_gapo
                         + S_GAPE * n_gape,
                         i, k2, l2, n_mm + is_mm, n_gapo, n_gape, n_ins,
                         n_del, STATE_M, is_mm, ldp)
        elif pat[i] < 4:
            c = int(pat[i])
            k2, l2 = subs[c]
            if k2 <= l2:
                push(S_MM * n_mm + S_GAPO * n_gapo + S_GAPE * n_gape,
                     i, k2, l2, n_mm, n_gapo, n_gape, n_ins, n_del,
                     STATE_M, 0, ldp)
    return hits, c1, c2, best_score


class BwtAligner:
    """bwa-aln with the reference's aDNA settings over the true FM index."""

    def __init__(self, ref: str, fnr: float = 0.01):
        self.ref = ref
        self.fnr = fnr
        codes = encode(np.frombuffer(ref.encode(), dtype=np.uint8))
        # bwa replaces ambiguous bases to keep the 2-bit pack; use 'A'
        codes = np.where(codes > 3, 0, codes).astype(np.int64)
        self.codes = codes
        self.fm = FmIndex(codes)
        self.fm_rev = FmIndex(codes[::-1])

    def align_read(self, seq: str) -> Alignment:
        codes = encode(np.frombuffer(seq.encode(), dtype=np.uint8)) \
            .astype(np.int64)
        lq = len(codes)
        aln = Alignment()
        if lq == 0:
            return aln
        max_diff = bwa_cal_maxdiff(lq, thres=self.fnr)

        # bwa searches one pattern against a fwd+revcomp doubled reference, so
        # its pruning bounds (top2 shrink / best_score stop / MAX_TOP2) are
        # global across strands.  Two-search formulation: run fwd, seed rev
        # with fwd's best; if rev improved the global best, re-run fwd seeded
        # with the tightened bounds (fixed point — the unseeded fwd pass may
        # have kept hits the combined search would have pruned, inflating c2)
        def _best_of(hits):
            if not hits:
                return None
            bsc = min(h.score for h in hits)
            bdiff = min(h.n_mm + h.n_gapo + h.n_gape
                        for h in hits if h.score == bsc)
            bcnt = sum(h.l - h.k + 1 for h in hits if h.score == bsc)
            return bsc, bdiff, bcnt

        def _merge_seed(a, b):
            if a is None or b is None:
                return a if b is None else b
            if a[0] != b[0]:
                return a if a[0] < b[0] else b
            return a[0], min(a[1], b[1]), a[2] + b[2]

        pats = {rev: (codes if not rev
                      else _RC_CODE[codes[::-1]].astype(np.int64))
                for rev in (False, True)}
        # D-array over pat PREFIXES: left-to-right scan on the reversed
        # text's index (prepending pat[i] there matches reverse(prefix)
        # in rev(T) <=> the prefix in T)
        widths = {rev: cal_width(self.fm_rev, pats[rev])
                  for rev in (False, True)}
        hits_by = {}
        seed = None
        for rev in (False, True):
            bid, wid = widths[rev]
            hits_by[rev], _c1, _c2, _bs = match_gap(
                self.fm, pats[rev], bid, wid, max_diff, seed_best=seed)
            seed = _merge_seed(seed, _best_of(hits_by[rev]))
        fwd_best = _best_of(hits_by[False])
        if (seed is not None and hits_by[False]
                and (fwd_best is None or seed[0] < fwd_best[0])):
            bid, wid = widths[False]
            # exclude fwd's own best from the seed to avoid double-counting
            hits_by[False], _c1, _c2, _bs = match_gap(
                self.fm, pats[False], bid, wid, max_diff,
                seed_best=_best_of(hits_by[True]))
        all_scored = []
        for rev in (False, True):
            for h in hits_by[rev]:
                all_scored.append((h.score, rev, h))
        if not all_scored:
            return aln
        all_scored.sort(key=lambda t: t[0])
        best_score = all_scored[0][0]
        # c1/c2 across both strands at the global best score
        c1 = sum(h.l - h.k + 1 for s, _r, h in all_scored if s == best_score)
        c2 = sum(h.l - h.k + 1 for s, _r, h in all_scored if s != best_score)
        score, rev, hit = all_scored[0]
        # deterministic position choice: smallest coordinate of the best hit
        pos = int(self.fm.sa[hit.k : hit.l + 1].min())
        ref_len = lq - hit.n_ins + hit.n_del

        aln.mapped = True
        aln.rev = rev
        aln.qs, aln.qe = 0, lq
        if hit.n_gapo == 0:
            aln.rs, aln.re = pos, pos + lq
            aln.cigar = [(lq, "M")]
        else:
            oriented = codes if not rev else _RC_CODE[codes[::-1]] \
                .astype(np.int64)
            wlo = max(0, pos - 2)
            whi = min(len(self.codes), pos + ref_len + 2)
            _diffs, ws, we, cigar = semiglobal_dp(
                np.asarray(oriented), self.codes[wlo:whi])
            aln.rs, aln.re = wlo + ws, wlo + we
            aln.cigar = cigar
        # NM = substitutions + gap bases (bwa refine_gapped semantics)
        aln.nm = hit.n_mm + hit.n_ins + hit.n_del
        aln.score = -(hit.n_mm + hit.n_gapo + hit.n_gape)
        # bwa_approx_mapQ (bwase.c:101-110): the max_diff saturation test is
        # on MISMATCHES alone (p->n_mm == mm), not total diffs
        if c1 == 0:
            aln.mapq = 23
        elif c1 > 1:
            aln.mapq = 0
        elif hit.n_mm == max_diff:
            aln.mapq = 25
        elif c2 == 0:
            aln.mapq = 37
        else:
            g = int(_G_LOG_N[min(c2, 255)])
            aln.mapq = 0 if g > 23 else 23 - g
        return aln

    def align_batch(self, seqs: list) -> list:
        out = self._align_batch_native(seqs)
        if out is not None:
            return out
        return [self.align_read(s) for s in seqs]

    def _align_batch_native(self, seqs: list):
        """Threaded C++ search (pt_bwt_aln); gapped hits get their CIGAR from
        the same whole-read semiglobal DP as the python path.  None without
        the native library (callers fall back to the per-read python
        search)."""
        from ..native import bwt_aln_native

        res = bwt_aln_native(self.fm, self.fm_rev, seqs, self.fnr)
        if res is None:
            return None
        out = []
        for i, seq in enumerate(seqs):
            aln = Alignment()
            if res["mapped"][i]:
                lq = len(seq)
                rev = bool(res["rev"][i])
                pos = int(res["pos"][i])
                n_ins = int(res["nins"][i])
                n_del = int(res["ndel"][i])
                aln.mapped = True
                aln.rev = rev
                aln.qs, aln.qe = 0, lq
                if res["ngapo"][i] == 0:
                    aln.rs, aln.re = pos, pos + lq
                    aln.cigar = [(lq, "M")]
                else:
                    codes = encode(np.frombuffer(seq.encode(),
                                                 dtype=np.uint8)) \
                        .astype(np.int64)
                    oriented = codes if not rev \
                        else _RC_CODE[codes[::-1]].astype(np.int64)
                    ref_len = lq - n_ins + n_del
                    wlo = max(0, pos - 2)
                    whi = min(len(self.codes), pos + ref_len + 2)
                    _d, ws, we, cigar = semiglobal_dp(
                        np.asarray(oriented), self.codes[wlo:whi])
                    aln.rs, aln.re = wlo + ws, wlo + we
                    aln.cigar = cigar
                aln.nm = int(res["nmm"][i]) + n_ins + n_del
                aln.score = int(res["score"][i])
                aln.mapq = int(res["mapq"][i])
            out.append(aln)
        return out
