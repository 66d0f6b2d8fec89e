"""Pileup genotyping: bcftools-equivalent haploid caller + mutation-spectrum prior.

Reimplements the *used subset* of the reference's embedded bcftools
(src/conversion.cpp:83-184: `mpileup -Ou -B` + `call --ploidy 1 -m -A`) as array
programs, faithful to the numerical model:

 - read selection: bcftools' default orphan skip (paired reads without the
   proper-pair flag are excluded, mpileup.c:294) and per-column depth cap;
 - mate-overlap quality tweak (htslib sam.c tweak_overlap_quality): for proper
   pairs the overlapping bases collapse onto one mate — agreeing bases carry the
   summed quality (cap 200) on the kept mate and 0 on the other; disagreeing
   bases keep the higher at 80%; the kept mate is chosen by
   Wang(X31(qname)) & 1;
 - base quality: neighbour cap (min(q, q[i-1]+30, q[i+1]+30)), min-BQ 1,
   max-BQ 60, capped by mapq, clamped to [4, 63] (bam2bcf.c:415-460);
 - genotype likelihoods: the revised MAQ error model with correlated-error
   decay fk[n] = 0.83^n * 0.97 + 0.03 and conditional-quality beta table
   (htslib errmod.c) — this is what keeps deep one-sided artifact columns at
   GT=0 where an independent-error model would call an ALT;
 - allele ordering by normalized quality sums, genotype-subset PL normalization
   with 255 cap (bam2bcf.c bcf_call_combine), haploid GT = argmin over the
   homozygous PLs (ties -> REF);
 - spectrum prior + consensus gate (src/genotyping.cpp:200-279).
"""

from __future__ import annotations

import math
import os
from collections import defaultdict
from dataclasses import dataclass
import numpy as np
import torch

BASES = "ACGT"
_BIDX = {b: i for i, b in enumerate(BASES)}
for b in "acgt":
    _BIDX[b] = _BIDX[b.upper()]
_BLUT = np.full(256, 4, dtype=np.int8)  # ASCII base -> 0..3 code (4 = other)
for _ch, _bi in _BIDX.items():
    _BLUT[ord(_ch)] = _bi

MIN_BQ = 1
MAX_BQ = 60
DELTA_BQ = 30
MAX_DEPTH = 250
ERRMOD_MAXN = 255


# ----------------------------------------------------------------------
# revised MAQ error model (htslib errmod.c semantics)
# ----------------------------------------------------------------------
class ErrMod:
    def __init__(self, depcorr: float = 1.0 - 0.83, eta: float = 0.03):
        n = np.arange(256)
        self.fk = np.power(1.0 - depcorr, n) * (1.0 - eta) + eta
        self.fk[0] = 1.0
        self._beta_cache: dict[int, np.ndarray] = {}
        # log binomial coefficients
        lg = np.zeros(257)
        lg[1:] = np.cumsum(np.log(np.arange(1, 257)))
        self._lfact = lg  # lfact[n] = log(n!)

    def beta_row(self, q: int, n: int) -> np.ndarray:
        """beta[q, n, k] for k=0..n: -4.343*(T[k+1]-T[k]) with T = log tail sums
        of Binom(n, e)."""
        key = q << 16 | n
        row = self._beta_cache.get(key)
        if row is not None:
            return row
        e = 10.0 ** (-q / 10.0)
        le = math.log(e)
        le1 = math.log1p(-e)
        j = np.arange(n + 1)
        lC = self._lfact[n] - self._lfact[j] - self._lfact[n - j]
        terms = lC + j * le + (n - j) * le1
        # T[k] = logsumexp(terms[k:]) computed right-to-left
        T = np.logaddexp.accumulate(terms[::-1])[::-1]
        row = np.empty(n + 1)
        row[:n] = -10.0 / math.log(10.0) * (T[1:] - T[:n + 1 - 1])
        row[n] = np.inf
        self._beta_cache[key] = row
        return row

    def cal(self, entries: list):
        """entries: (qual 4..63, strand 0/1, base 0..4). Returns (phred
        q[5,5], bsum[16], c[16]) — the homozygous diagonal is what haploid
        calling uses; bsum/c are reused by the het term."""
        n = len(entries)
        if n == 0:
            return np.zeros((5, 5)), np.zeros(16), np.zeros(16, np.int64)
        if n > ERRMOD_MAXN:
            entries = entries[:ERRMOD_MAXN]  # htslib shuffles; we keep order
            n = ERRMOD_MAXN
        packed = sorted(entries, key=lambda t: (t[0] << 5 | t[1] << 4 | t[2]),
                        reverse=True)
        fsum = np.zeros(16)
        bsum = np.zeros(16)
        c = np.zeros(16, dtype=np.int64)
        w = np.zeros(32, dtype=np.int64)
        for q, strand, base in packed:
            bs = strand << 4 | base
            beta = self.beta_row(q, n)
            bsum[base] += self.fk[w[bs & 0x1F]] * beta[c[base]]
            fsum[base] += self.fk[w[bs & 0x1F]]
            c[base] += 1
            w[bs & 0x1F] += 1
        m = 5
        out = np.zeros((m, m))
        tot_b = bsum[:m].sum()
        tot_c = c[:m].sum()
        for j in range(m):
            if tot_c - c[j] > 0:
                out[j, j] = tot_b - bsum[j]
        np.maximum(out, 0.0, out=out)
        return out, bsum, c

    def cal_columns(self, col: np.ndarray, q: np.ndarray, s: np.ndarray,
                    b: np.ndarray, ncol: int):
        """All-columns twin of cal_arrays (which is its oracle): entries of
        every pileup column processed in one pass.  `col` is the column id
        (non-decreasing); entries must already be capped at ERRMOD_MAXN per
        column in column order.  Returns (diag [ncol,5] homozygous phred,
        bsum [ncol,16], c [ncol,16])."""
        if len(col) == 0:
            return (np.zeros((ncol, 5)), np.zeros((ncol, 16)),
                    np.zeros((ncol, 16), np.int64))
        col = col.astype(np.int64)
        key = (q.astype(np.int64) << 5) | (s.astype(np.int64) << 4) | b
        order = np.lexsort((-key, col))
        cols_, qs_, bs_ = col[order], q[order].astype(np.int64), \
            b[order].astype(np.int64)
        bs5 = (s[order].astype(np.int64) << 4) | bs_
        cb = cols_ * 16 + bs_
        cbs = cols_ * 32 + bs5
        c_t = _cumcount(cb)
        w_t = _cumcount(cbs)
        n_of = np.bincount(cols_, minlength=ncol)
        nv = n_of[cols_]
        pairkey = qs_ * 1024 + nv
        up, pinv = np.unique(pairkey, return_inverse=True)
        maxn = int(nv.max())
        M = np.zeros((len(up), maxn + 1))
        for r, pk in enumerate(up.tolist()):
            qv, nn = pk >> 10, pk & 1023
            M[r, : nn + 1] = self.beta_row(int(qv), int(nn))
        contrib = self.fk[w_t] * M[pinv, c_t]
        bsum = np.bincount(cb, weights=contrib,
                           minlength=ncol * 16).reshape(ncol, 16)
        cc = np.bincount(cb, minlength=ncol * 16).reshape(ncol, 16) \
            .astype(np.int64)
        tot_b = bsum[:, :5].sum(axis=1)
        tot_c = cc[:, :5].sum(axis=1)
        diag = np.where((tot_c[:, None] - cc[:, :5]) > 0,
                        np.maximum(tot_b[:, None] - bsum[:, :5], 0.0), 0.0)
        return diag, bsum, cc

    def cal_arrays(self, q: np.ndarray, s: np.ndarray, b: np.ndarray):
        """Array twin of cal() (tests cross-check them float-exact): grouped
        cumulative counts replace the scalar state machine, and np.bincount
        preserves the per-base summation order the scalar walk uses."""
        n = len(q)
        if n == 0:
            return np.zeros((5, 5)), np.zeros(16), np.zeros(16, np.int64)
        if n > ERRMOD_MAXN:
            q, s, b = q[:ERRMOD_MAXN], s[:ERRMOD_MAXN], b[:ERRMOD_MAXN]
            n = ERRMOD_MAXN
        key = (q.astype(np.int64) << 5) | (s.astype(np.int64) << 4) | b
        order = np.argsort(-key, kind="stable")
        qs_, bs_ = q[order].astype(np.int64), b[order].astype(np.int64)
        bs5 = (s[order].astype(np.int64) << 4) | bs_
        c_t = _cumcount(bs_)
        w_t = _cumcount(bs5)
        uq, q_inv = np.unique(qs_, return_inverse=True)
        B = np.stack([self.beta_row(int(v), n) for v in uq.tolist()])
        contrib = self.fk[w_t] * B[q_inv, c_t]
        bsum = np.bincount(bs_, weights=contrib, minlength=16)
        c = np.bincount(bs_, minlength=16).astype(np.int64)
        out = np.zeros((5, 5))
        tot_b = bsum[:5].sum()
        tot_c = c[:5].sum()
        for j in range(5):
            if tot_c - c[j] > 0:
                out[j, j] = tot_b - bsum[j]
        np.maximum(out, 0.0, out=out)
        return out, bsum, c


def _cumcount(x: np.ndarray) -> np.ndarray:
    """Occurrence index of each element within its value-group, in array
    order (the 'count of prior equal elements' the errmod walk maintains)."""
    n = len(x)
    order = np.argsort(x, kind="stable")
    xs = x[order]
    starts = np.concatenate(([0], np.flatnonzero(xs[1:] != xs[:-1]) + 1))
    run_id = np.zeros(n, np.int64)
    run_id[starts] = 1
    run_id = np.cumsum(run_id) - 1
    within = np.arange(n) - starts[run_id]
    out = np.empty(n, np.int64)
    out[order] = within
    return out


_ERRMOD = ErrMod()


def _x31(s: str) -> int:
    h = 0
    for ch in s:
        h = ((h << 5) - h + ord(ch)) & 0xFFFFFFFF
    return h


def _wang(key: int) -> int:
    key = (key + (~(key << 15) & 0xFFFFFFFF)) & 0xFFFFFFFF
    key ^= key >> 10
    key = (key + (key << 3)) & 0xFFFFFFFF
    key ^= key >> 6
    key = (key + (~(key << 11) & 0xFFFFFFFF)) & 0xFFFFFFFF
    key ^= key >> 16
    return key


def _wang_x31_lsb_batch(names: list) -> np.ndarray:
    """Vectorized `_wang(_x31(name)) & 1` over a name list (the per-pair
    strand multiplier of the overlap tweak).  Bit-exact twin of the scalar
    pair — masked Horner over a padded byte matrix, then the Wang mix in
    u32 lanes."""
    nn = len(names)
    if nn == 0:
        return np.zeros(0, np.int64)
    try:
        # latin-1 keeps byte value == ord(ch), matching the scalar _x31;
        # qnames with codepoints > 0xFF (never produced by the FASTQ
        # readers) fall back to the scalar oracle pair
        bs = [s.encode("latin-1") for s in names]
    except UnicodeEncodeError:
        return np.fromiter(((_wang(_x31(s)) & 1) for s in names),
                           np.int64, nn)
    lens = np.fromiter((len(b) for b in bs), np.int64, nn)
    L = int(lens.max()) if nn else 0
    mat = np.zeros((nn, L), dtype=np.uint32)
    flat = np.frombuffer(b"".join(bs), np.uint8)
    offs = np.concatenate(([0], np.cumsum(lens)))
    rows = np.repeat(np.arange(nn), lens)
    cols = np.arange(int(offs[-1])) - np.repeat(offs[:-1], lens)
    mat[rows, cols] = flat
    h = np.zeros(nn, dtype=np.uint32)
    alive = lens[:, None] > np.arange(L)[None, :]
    c31 = np.uint32(31)
    for j in range(L):
        h = np.where(alive[:, j], h * c31 + mat[:, j], h)
    key = h
    key = key + (~(key << np.uint32(15)))
    key ^= key >> np.uint32(10)
    key = key + (key << np.uint32(3))
    key ^= key >> np.uint32(6)
    key = key + (~(key << np.uint32(11)))
    key ^= key >> np.uint32(16)
    return (key & np.uint32(1)).astype(np.int64)


@dataclass
class SiteRecord:
    pos: int  # 0-based
    ref: str
    alts: list
    qual: float
    dp: int
    gt: int
    pls: list
    ads: list

    def vcf_line(self, chrom: str) -> str:
        alt = ",".join(self.alts) if self.alts else "."
        pls = ",".join(str(int(p)) for p in self.pls)
        ads = ",".join(str(int(a)) for a in self.ads)
        return (
            f"{chrom}\t{self.pos + 1}\t.\t{self.ref}\t{alt}\t{self.qual:.4f}\t.\t"
            f"DP={self.dp}\tGT:PL:AD\t{self.gt}:{pls}:{ads}"
        )


@dataclass
class PlacedRead:
    """One aligned read for pileup: ref-orientation bases/quals."""

    rs: int
    cigar: list
    seq: str
    quals: list  # phred ints, ref orientation, mutable
    qs: int  # offset of cigar start within seq
    qname: str = ""
    is_proper: bool = True
    is_paired: bool = True
    mapq: int = 60
    rev: bool = False
    has_clip: bool = False  # soft-clip present (BAQ column heuristics)

    def ref_end(self) -> int:
        return self.rs + sum(ln for ln, op in self.cigar if op in "MDN=X")


def _apply_overlap_tweaks_flat(pairedok, qnames, rs_arr, flat_p, aqi,
                               flat_rid, Qcat, Scat, n, pair_ids=None):
    """Vectorized mate-overlap quality tweak (tweak_overlap_quality semantics,
    identical to the legacy per-pair `_apply_overlap_tweaks` below, which is
    kept as the test oracle).  Operates in place on the concatenated qual
    array: ref positions covered by both mates of a proper pair are located
    as duplicate (pair, refpos) keys among the flat pileup entries.
    pairedok/qnames/rs_arr describe the kept reads (arrays, not objects —
    shared by the object and columnar pileup front-ends)."""
    n_kept = len(rs_arr)
    ids = np.flatnonzero(pairedok)
    if len(ids) < 2:
        return
    if pair_ids is not None:
        # structural pair identity: int group instead of qname string-unique.
        # The qname oracle skips names seen != 2 times among the kept paired
        # reads (two distinct pairs sharing a name -> cnt==4 -> no tweak);
        # mirror that with a cheap Counter so duplicate qnames behave
        # identically to the object-path oracle.
        # INTENTIONAL DIVERGENCE on one malformed input: a qname that appears
        # exactly twice but in two DIFFERENT structural pairs (each
        # fragment's true mate dropped by filters, duplicate names across
        # fragments).  The qname oracle pairs the two unrelated reads and
        # tweaks them; this path sees two distinct pair groups of size 1 and
        # correctly applies no tweak.  Duplicate read names violate the BAM
        # contract the reference also assumes (tweak_overlap_quality keys on
        # qname), so the structural answer is kept — see
        # tests/test_pileup_tweaks.py::test_duplicate_qname_cross_pairs.
        from collections import Counter

        grp = pair_ids[ids]
        ok = grp >= 0
        name_cnt = Counter(qnames[i] for i in ids)
        if ok.any():
            ok &= np.fromiter((name_cnt[qnames[i]] == 2 for i in ids),
                              bool, len(ids))
        ids = ids[ok]
        if len(ids) < 2:
            return
        un, inv, cnt = np.unique(grp[ok], return_inverse=True,
                                 return_counts=True)
    else:
        un, inv, cnt = np.unique(np.array([qnames[i] for i in ids]),
                                 return_inverse=True, return_counts=True)
    two = cnt == 2
    if not two.any():
        return
    # members of each qname group in kept order (stable sort on group id)
    gorder = np.argsort(inv, kind="stable")
    gstart = np.concatenate(([0], np.cumsum(cnt)))[:-1]
    gi2 = np.flatnonzero(two)
    mi = ids[gorder[gstart[gi2]]]       # first occurrence (dict order i)
    mj = ids[gorder[gstart[gi2] + 1]]   # second occurrence j
    ma = np.where(rs_arr[mj] < rs_arr[mi], mj, mi)  # leftmost mate 'a'
    pid = np.full(n_kept, -1, dtype=np.int64)
    amul_of = np.zeros(n_kept, dtype=np.int64)
    a_read = np.zeros(n_kept, dtype=bool)
    npairs = len(gi2)
    pid[mi] = pid[mj] = np.arange(npairs)
    amv = _wang_x31_lsb_batch([qnames[i] for i in mi.tolist()])
    amul_of[mi] = amul_of[mj] = amv
    a_read[ma] = True
    # entry extent per read (flat entries are grouped by read id, ascending
    # positions) -> each pair's candidate window = intersection of extents;
    # duplicate (pair, refpos) keys can only occur inside it, so the sort
    # below runs on the few overlapping bases instead of every paired entry
    bounds = np.searchsorted(flat_rid, np.arange(n_kept + 1))

    def _tweak(ix, iy, am):
        qa = Qcat[ix].astype(np.int64)
        qb = Qcat[iy].astype(np.int64)
        same = (Scat[ix] & 0xDF) == (Scat[iy] & 0xDF)
        bm = 1 - am
        qsum = np.minimum(qa + qb, 200)
        frac_a = (qa * 8) // 10  # int(0.8*q) for q >= 0
        frac_b = (qb * 8) // 10
        Qcat[ix] = np.where(same, qsum * am,
                            np.where(qa > qb, frac_a,
                                     np.where(qa < qb, 0, frac_a * am)))
        Qcat[iy] = np.where(same, qsum * bm,
                            np.where(qa > qb, 0,
                                     np.where(qa < qb, frac_b, frac_b * bm)))

    if not os.environ.get("PANMAP_TPU_NO_NATIVE"):
        # native two-pointer merge over each pair's entry ranges replaces
        # the global (pair, refpos) key sort (~12M rows on the sars demo,
        # was the genotype stage's hottest section); identical match set —
        # a common position is necessarily inside both mates' extents
        from ..native import pair_overlap_match_native

        nat = pair_overlap_match_native(flat_p, aqi, bounds, mi, mj, a_read)
        if nat is not None:
            ixn, iyn, prn = nat
            if len(ixn):
                _tweak(ixn, iyn, amv[prn])
            return
    has_e = bounds[1:] > bounds[:-1]
    first_p = np.full(n_kept, np.int64(n))
    last_p = np.full(n_kept, np.int64(-1))
    he = np.flatnonzero(has_e)
    first_p[he] = flat_p[bounds[:-1][he]]
    last_p[he] = flat_p[bounds[1:][he] - 1]
    win_lo = np.full(n_kept, np.int64(n))   # per read: its pair's window
    win_hi = np.full(n_kept, np.int64(-1))
    lo = np.maximum(first_p[mi], first_p[mj])
    hi = np.minimum(last_p[mi], last_p[mj])
    win_lo[mi] = win_lo[mj] = lo
    win_hi[mi] = win_hi[mj] = hi
    rid_pid = pid[flat_rid]
    sidx = np.flatnonzero((rid_pid >= 0) & (flat_p >= win_lo[flat_rid])
                          & (flat_p <= win_hi[flat_rid]))
    if not len(sidx):
        return
    key = rid_pid[sidx] * np.int64(n) + flat_p[sidx]
    order = np.argsort(key, kind="stable")
    sk = key[order]
    dup = sk[1:] == sk[:-1]
    if not dup.any():
        return
    e1 = sidx[order[:-1][dup]]
    e2 = sidx[order[1:][dup]]
    is_a1 = a_read[flat_rid[e1]]
    ex = np.where(is_a1, e1, e2)  # entry from mate 'a' (leftmost)
    ey = np.where(is_a1, e2, e1)
    ix, iy = aqi[ex], aqi[ey]
    _tweak(ix, iy, amul_of[flat_rid[ex]])


def _apply_overlap_tweaks(reads: list):
    """Mate-overlap quality tweak for proper pairs (same qname, both mapped)."""
    by_name: dict[str, list] = {}
    for r in reads:
        if r.is_paired and r.is_proper:
            by_name.setdefault(r.qname, []).append(r)
    for name, pair in by_name.items():
        if len(pair) != 2:
            continue
        a, b = pair
        if a.rs > b.rs:
            a, b = b, a
        if a.ref_end() <= b.rs:
            continue  # mates don't overlap on the reference
        amul = 1 if (_wang(_x31(name)) & 1) else 0
        bmul = 1 - amul
        # walk both CIGARs over the overlapping ref window
        amap = _ref_to_seq_map(a)
        bmap = _ref_to_seq_map(b)
        common = amap.keys() & bmap.keys()
        for p in common:
            ai = amap[p]
            bi = bmap[p]
            if a.seq[ai].upper() == b.seq[bi].upper():
                q = min(a.quals[ai] + b.quals[bi], 200)
                a.quals[ai] = q * amul
                b.quals[bi] = q * bmul
            else:
                if a.quals[ai] > b.quals[bi]:
                    a.quals[ai] = int(0.8 * a.quals[ai])
                    b.quals[bi] = 0
                elif a.quals[ai] < b.quals[bi]:
                    b.quals[bi] = int(0.8 * b.quals[bi])
                    a.quals[ai] = 0
                else:
                    a.quals[ai] = int(0.8 * a.quals[ai]) * amul
                    b.quals[bi] = int(0.8 * b.quals[bi]) * bmul


def _ref_to_seq_map(r: PlacedRead) -> dict:
    out = {}
    rpos = r.rs
    qpos = r.qs
    for ln, op in r.cigar:
        if op in ("M", "=", "X"):
            for x in range(ln):
                out[rpos + x] = qpos + x
            rpos += ln
            qpos += ln
        elif op == "I":
            qpos += ln
        elif op in ("D", "N"):
            rpos += ln
        elif op == "S":
            qpos += ln
    return out


_NOPRUNE = object()  # sentinel: no column prefilter (oracle-exact record list)


def _snp_prefilter(DIAG, QS, ref_idx, g_p, gstart, ncol, spectrum):
    """Sound vectorized prune of SNP columns that PROVABLY cannot survive
    apply_spectrum (the caller's final filter), so the per-column caller
    loop runs only on plausible sites.

    A column can emit a surviving record only if some ALT hom genotype val
    d[a] (the errmod DIAG) plus its spectrum prior can reach the REF hom's
    d[r] + prior within PL-floor slack: the min-normalization shift cancels
    in the comparison, each floor(x+0.499) distorts a difference by < 1,
    and the 255 PL cap cannot flip a call when every off-diagonal prior
    exceeds every diagonal one (capped ALT PLs equal the capped/near-capped
    REF PL at best, and the larger off-diagonal prior then keeps REF as the
    last zero).  When that matrix guard fails — off-diagonal <= diagonal
    anywhere — pruning is disabled entirely (returns None).  spectrum=None
    (no prior) uses the zero matrix, where the guard holds trivially with
    equality slack absorbed by SLACK.  Verified against the unpruned oracle
    by tests/test_pileup_tweaks.py::test_snp_prefilter_sound."""
    SLACK = 4.0
    if spectrum is not None:
        sp = np.asarray(spectrum, dtype=np.float64)
        off = sp[~np.eye(4, dtype=bool)]
        if off.min() <= sp[np.eye(4, dtype=bool)].max():
            return None  # guard fails: prune nothing
    cols = np.arange(ncol)
    r4v = ref_idx[g_p[gstart[:-1]]]
    valid = (r4v < 4) & (QS.sum(axis=1) > 0)
    r4c = np.where(valid, r4v, 0)
    D4 = DIAG[:, :4]
    dref = D4[cols, r4c]
    if spectrum is None:
        offv = np.zeros((ncol, 4))
        diagv = np.zeros(ncol)
    else:
        offv = sp[r4c][:, :4]
        diagv = sp[r4c, r4c]
    alt_ok = QS > 0
    alt_ok[cols, r4c] = False
    cand = np.where(alt_ok, D4 + offv, np.inf)
    return valid & (cand.min(axis=1) <= dref + diagv + SLACK)


def pileup_call(ref: str, reads: list, max_depth: int = MAX_DEPTH,
                baq: bool = False, spectrum=_NOPRUNE,
                device_tally=None):
    """reads: list[PlacedRead]. Returns list[SiteRecord] for alt-bearing sites."""
    if baq:
        from .baq import apply_baq

        apply_baq(reads, ref)
    n = len(ref)
    ref_idx = _BLUT[np.frombuffer(ref.encode(), dtype=np.uint8)]

    # orphan skip (mpileup.c:294) + per-start depth cap
    usable = [r for r in reads if not (r.is_paired and not r.is_proper)]
    usable.sort(key=lambda r: r.rs)
    kept = []
    import heapq

    heap: list[int] = []
    for r in usable:
        while heap and heap[0] <= r.rs:
            heapq.heappop(heap)
        if len(heap) >= max_depth:
            continue
        heapq.heappush(heap, r.ref_end())
        kept.append(r)

    # column accumulation, vectorized over all M-segment bases.  Entry order
    # within a column matches the per-base loop it replaces (kept-read order,
    # bases in cigar order — the stable argsort below preserves it), which
    # matters because the errmod is order-dependent on q-key ties.
    depth = np.zeros(n, dtype=np.int64)
    seg_p0, seg_q0, seg_len, seg_rid = [], [], [], []
    indel_events = []  # (anchor, rid, ("I", seq) | ("D", len), event_qual)
    for rid, r in enumerate(kept):
        rpos = r.rs
        qpos = r.qs
        for ln, op in r.cigar:
            if op in ("M", "=", "X"):
                seg_p0.append(rpos)
                seg_q0.append(qpos)
                seg_len.append(ln)
                seg_rid.append(rid)
                rpos += ln
                qpos += ln
            elif op == "I":
                if 0 < rpos <= n and ln > 0:
                    qev = min(r.quals[qpos : qpos + ln], default=0)
                    # left-align: the same haplotype can be encoded at
                    # several anchors; normalize so supports merge (VCF /
                    # bcftools left-aligned convention)
                    a = rpos - 1
                    ins = r.seq[qpos : qpos + ln]
                    while a >= 1 and ins[-1] == ref[a]:
                        ins = ref[a] + ins[:-1]
                        a -= 1
                    indel_events.append((a, rid, ("I", ins), qev))
                qpos += ln
            elif op == "S":
                qpos += ln
            elif op in ("D", "N"):
                if op == "D" and 0 < rpos and rpos + ln <= n:
                    qa = r.quals[qpos - 1] if qpos > 0 else 0
                    qb = r.quals[qpos] if qpos < len(r.quals) else qa
                    s0 = rpos
                    while s0 >= 2 and ref[s0 - 1] == ref[s0 + ln - 1]:
                        s0 -= 1
                    indel_events.append((s0 - 1, rid, ("D", ln),
                                         min(qa, qb)))
                rpos += ln

    if not seg_len:
        return []
    sl = np.asarray(seg_len, dtype=np.int64)
    csum = np.concatenate(([0], np.cumsum(sl)))
    rel = np.arange(csum[-1]) - np.repeat(csum[:-1], sl)
    flat_p = np.repeat(np.asarray(seg_p0, dtype=np.int64), sl) + rel
    flat_qi = np.repeat(np.asarray(seg_q0, dtype=np.int64), sl) + rel
    flat_rid = np.repeat(np.asarray(seg_rid, dtype=np.int64), sl)
    in_ref = (flat_p >= 0) & (flat_p < n)
    flat_p, flat_qi, flat_rid = (flat_p[in_ref], flat_qi[in_ref],
                                 flat_rid[in_ref])
    depth += np.bincount(flat_p, minlength=n)

    rlens = np.array([len(r.seq) for r in kept], dtype=np.int64)
    Qcat = np.concatenate(
        [np.asarray(r.quals, dtype=np.int64) for r in kept])
    Scat = np.frombuffer("".join(r.seq for r in kept).encode(), np.uint8)
    mqs = np.minimum(np.array([r.mapq for r in kept], dtype=np.int64), 60)
    revs = np.array([1 if r.rev else 0 for r in kept], dtype=np.int8)
    pairedok = np.fromiter((r.is_paired and r.is_proper for r in kept),
                           bool, len(kept))
    qnames = [r.qname for r in kept]
    rs_arr = np.fromiter((r.rs for r in kept), np.int64, len(kept))

    # object-path IndelInput: cigar codes with the 5' soft clip restored
    # (PlacedRead cigars exclude clips; qs carries the 5' one)
    from .indel import IndelInput

    _OPC = {"M": 0, "I": 1, "D": 2, "N": 3, "S": 4, "=": 7, "X": 8}
    o_ops, o_lns, o_off = [], [], [0]
    for r in kept:
        if r.qs > 0:
            o_ops.append(4)
            o_lns.append(r.qs)
        for ln, op in r.cigar:
            o_ops.append(_OPC.get(op, 0))
            o_lns.append(ln)
        o_off.append(len(o_ops))
    indel_input = IndelInput(
        rs=rs_arr, ops=np.asarray(o_ops, np.int64),
        lns=np.asarray(o_lns, np.int64), opoff=np.asarray(o_off, np.int64),
        seq=Scat, quals=Qcat,
        soff=np.concatenate(([0], np.cumsum(rlens))).astype(np.int64),
        mapq=mqs, rev=revs)
    return _pileup_finish(ref, ref_idx, n, depth, flat_p, flat_qi, flat_rid,
                          indel_events, rlens, Qcat, Scat, mqs, revs,
                          pairedok, qnames, rs_arr, indel_input=indel_input,
                          spectrum=spectrum, device_tally=device_tally)


@dataclass
class ColumnarReads:
    """Emit-order columnar alignment set (the BAM writer's arrays), the
    zero-object input of pileup_call_columnar.  stream is the BAM-coded
    cigar stream (op = word & 0xF, len = word >> 4) incl. soft clips;
    seq/qual blobs are ORIENTED (as aligned) with 0-based quals."""

    rs: np.ndarray       # i64[nrec] leftmost ref pos
    stream: np.ndarray   # u32 flat cigar words
    coff: np.ndarray     # i64[nrec+1] cigar offsets
    seq_blob: np.ndarray  # u8 concatenated oriented bases (ASCII)
    qual_blob: np.ndarray  # u8 concatenated quals
    soff: np.ndarray     # i64[nrec+1] seq/qual offsets
    mapq: np.ndarray     # i64[nrec]
    rev: np.ndarray      # bool[nrec]
    proper: np.ndarray   # bool[nrec]
    paired: bool
    qnames: list         # str[nrec]
    # structural pair identity (emit order pairs mates adjacently): records
    # with the same id >= 0 are mates — lets the overlap tweak skip the
    # qname string-unique (the object path still pairs by name = the oracle)
    pair_ids: np.ndarray | None = None  # i64[nrec] or None


def pileup_call_columnar(ref: str, cols: ColumnarReads,
                         max_depth: int = MAX_DEPTH, spectrum=_NOPRUNE,
                         device_tally=None):
    """Columnar twin of pileup_call: the per-read python cigar walk is
    replaced by one vectorized pass over the flat cigar stream (the object
    path stays the oracle; tests assert record equality).  No PlacedRead
    objects are built — the pipeline feeds the BAM writer's arrays straight
    in (conversion.cpp:83-184 runs bcftools on the BAM; we run on the
    columns)."""
    n = len(ref)
    ref_idx = _BLUT[np.frombuffer(ref.encode(), dtype=np.uint8)]

    nrec = len(cols.rs)
    usable = np.ones(nrec, dtype=bool)
    if cols.paired:
        usable = cols.proper.astype(bool)  # orphan skip (mpileup.c:294)
    uidx = np.flatnonzero(usable)
    order = uidx[np.argsort(cols.rs[uidx], kind="stable")]

    # per-record ref span from the cigar stream (ops M/D/N/=/X advance ref)
    ops_all = (cols.stream & np.uint32(0xF)).astype(np.int64)
    lens_all = (cols.stream >> np.uint32(4)).astype(np.int64)
    is_ref = (ops_all == 0) | (ops_all == 2) | (ops_all == 3) \
        | (ops_all == 7) | (ops_all == 8)
    drc = np.concatenate(([0], np.cumsum(np.where(is_ref, lens_all, 0))))
    spans = drc[cols.coff[1:]] - drc[cols.coff[:-1]]
    ends = cols.rs + spans

    # depth cap (per-start heap in the object path): skip entirely when the
    # uncapped coverage never reaches max_depth — the heap size at any read
    # equals the kept reads overlapping its start, bounded by true depth
    cover = np.zeros(n + 2, dtype=np.int64)
    np.add.at(cover, np.minimum(cols.rs[order], n), 1)
    np.add.at(cover, np.minimum(ends[order], n + 1), -1)
    if int(np.cumsum(cover).max()) >= max_depth:
        import heapq

        heap: list = []
        kept_l = []
        rs_o = cols.rs[order].tolist()
        en_o = ends[order].tolist()
        for j, (r0, e0) in enumerate(zip(rs_o, en_o)):
            while heap and heap[0] <= r0:
                heapq.heappop(heap)
            if len(heap) >= max_depth:
                continue
            heapq.heappush(heap, e0)
            kept_l.append(order[j])
        order = np.asarray(kept_l, dtype=np.int64)
    kept = order  # emit-order record ids, sorted by rs
    nk = len(kept)
    if nk == 0:
        return []

    # kept reads' flat cigar tables
    nops = (cols.coff[1:] - cols.coff[:-1])[kept]
    row_of = np.repeat(np.arange(nk, dtype=np.int64), nops)
    op_src = np.repeat(cols.coff[:-1][kept], nops) + (
        np.arange(int(nops.sum())) - np.repeat(
            np.concatenate(([0], np.cumsum(nops)[:-1])), nops))
    ops = ops_all[op_src]
    lns = lens_all[op_src]
    dq = np.where((ops == 0) | (ops == 1) | (ops == 4) | (ops == 7)
                  | (ops == 8), lns, 0)
    dr = np.where((ops == 0) | (ops == 2) | (ops == 3) | (ops == 7)
                  | (ops == 8), lns, 0)
    opstart = np.concatenate(([0], np.cumsum(nops)))[:-1]
    exq = np.concatenate(([0], np.cumsum(dq)[:-1]))
    exr = np.concatenate(([0], np.cumsum(dr)[:-1]))
    qpos0 = exq - exq[opstart][row_of]          # query pos before each op
    rpos0 = cols.rs[kept][row_of] + (exr - exr[opstart][row_of])

    # M segments -> flat per-base entries
    is_m = (ops == 0) | (ops == 7) | (ops == 8)
    sl = lns[is_m]
    seg_p0 = rpos0[is_m]
    seg_q0 = qpos0[is_m]
    seg_rid = row_of[is_m]
    csum = np.concatenate(([0], np.cumsum(sl)))
    relb = np.arange(csum[-1]) - np.repeat(csum[:-1], sl)
    flat_p = np.repeat(seg_p0, sl) + relb
    flat_qi = np.repeat(seg_q0, sl) + relb
    flat_rid = np.repeat(seg_rid, sl)
    in_ref = (flat_p >= 0) & (flat_p < n)
    flat_p, flat_qi, flat_rid = (flat_p[in_ref], flat_qi[in_ref],
                                 flat_rid[in_ref])
    depth = np.bincount(flat_p, minlength=n).astype(np.int64)

    # kept blobs (gather the kept reads' seq/qual segments)
    lq = (cols.soff[1:] - cols.soff[:-1])[kept]
    roffs = np.concatenate(([0], np.cumsum(lq)))
    bsrc = np.repeat(cols.soff[:-1][kept], lq) + (
        np.arange(int(lq.sum())) - np.repeat(roffs[:-1], lq))
    Qcat = cols.qual_blob[bsrc].astype(np.int64)
    Scat = cols.seq_blob[bsrc]
    mqs = np.minimum(cols.mapq[kept], 60).astype(np.int64)
    revs = cols.rev[kept].astype(np.int8)

    # indel events (rare: python loop only over I/D ops, as the object path)
    indel_events = []
    quals_of = Qcat  # kept-concatenated, offsets roffs
    idl = np.flatnonzero((ops == 1) | ((ops == 2) & (lns > 0)))
    for oi in idl.tolist():
        rid = int(row_of[oi])
        ln = int(lns[oi])
        rpos = int(rpos0[oi])
        qpos = int(qpos0[oi])
        base = int(roffs[rid])
        rl = int(lq[rid])
        if ops[oi] == 1:  # insertion
            if 0 < rpos <= n and ln > 0:
                w = quals_of[base + qpos : base + qpos + ln]
                qev = int(w.min()) if len(w) else 0
                a = rpos - 1
                ins = Scat[base + qpos : base + qpos + ln].tobytes().decode()
                while a >= 1 and ins[-1] == ref[a]:
                    ins = ref[a] + ins[:-1]
                    a -= 1
                indel_events.append((a, rid, ("I", ins), qev))
        else:  # deletion
            if 0 < rpos and rpos + ln <= n:
                qa = int(quals_of[base + qpos - 1]) if qpos > 0 else 0
                qb = int(quals_of[base + qpos]) if qpos < rl else qa
                s0 = rpos
                while s0 >= 2 and ref[s0 - 1] == ref[s0 + ln - 1]:
                    s0 -= 1
                indel_events.append((s0 - 1, rid, ("D", ln), min(qa, qb)))

    pairedok = (np.full(nk, cols.paired) & cols.proper[kept]
                if cols.paired else np.zeros(nk, dtype=bool))
    qnames = [cols.qnames[i] for i in kept.tolist()]
    from .indel import IndelInput

    indel_input = IndelInput(
        rs=cols.rs[kept].astype(np.int64), ops=ops, lns=lns,
        opoff=np.concatenate(([0], np.cumsum(nops))).astype(np.int64),
        seq=Scat, quals=Qcat, soff=roffs.astype(np.int64), mapq=mqs,
        rev=revs)
    pair_kept = (cols.pair_ids[kept]
                 if cols.pair_ids is not None and cols.paired else None)
    return _pileup_finish(ref, ref_idx, n, depth, flat_p, flat_qi, flat_rid,
                          indel_events, lq, Qcat, Scat, mqs, revs,
                          pairedok, qnames, cols.rs[kept],
                          indel_input=indel_input, pair_ids=pair_kept,
                          spectrum=spectrum, device_tally=device_tally)


def resolve_device_pileup(mode: str, device):
    """--device-pileup policy: the device the per-column tallies run on, or
    None for the host bincounts.  "on"/"off" are explicit; "auto" tallies on
    ``device`` when it is a CUDA device (attached to this host: dispatch is
    microseconds) and on the host for a CPU device.  The
    PANMAP_TPU_DEVICE_PILEUP env var (0/1) overrides for experiments."""
    env = os.environ.get("PANMAP_TPU_DEVICE_PILEUP", "")
    if env == "1":
        return device
    if env == "0":
        return None
    if mode == "on":
        return device
    if mode == "off":
        return None
    return device if torch.device(device).type == "cuda" else None


def tally_columns_device(col_id, g_q, g_s, g_b, ncol, device):
    """Device twin of the per-column tallies: base counts (BCF) [ncol, 5],
    quality sums (QS) [ncol, 4] and strand allele depths (ADF/ADR)
    [ncol, 4] as index_add_ over ref columns on ``device`` (reference:
    bcftools fills these walking the pileup, conversion.cpp:83-184).  All
    four sums are int32 (qualities are ints <= 63 and a column holds at most
    MAX_DEPTH entries), so they are exact in any order; they come back as
    int64 / float64 / int64 / int64, the types of the numpy bincounts in
    _pileup_finish, which are the oracle."""
    dev = torch.device(device)
    cid = torch.from_numpy(np.asarray(col_id, dtype=np.int64)).to(dev)
    q = torch.from_numpy(np.asarray(g_q, dtype=np.int32)).to(dev)
    s = torch.from_numpy(np.asarray(g_s, dtype=np.int8)).to(dev)
    b = torch.from_numpy(np.asarray(g_b, dtype=np.int64)).to(dev)
    one = torch.ones(len(cid), dtype=torch.int32, device=dev)

    def table(width, index, src):
        out = torch.zeros(ncol * width, dtype=torch.int32, device=dev)
        return out.index_add_(0, index, src).view(ncol, width).cpu().numpy()

    bcf = table(5, cid * 5 + b.clamp(max=4), one)
    v = b < 4
    cb = cid * 4 + b
    qs = table(4, cb[v], q[v])
    fwd, rev = v & (s == 0), v & (s == 1)
    adf = table(4, cb[fwd], one[fwd])
    adr = table(4, cb[rev], one[rev])
    return (bcf.astype(np.int64), qs.astype(np.float64),
            adf.astype(np.int64), adr.astype(np.int64))


def _pileup_finish(ref, ref_idx, n, depth, flat_p, flat_qi, flat_rid,
                   indel_events, rlens, Qcat, Scat, mqs, revs, pairedok,
                   qnames, rs_arr, indel_input=None, pair_ids=None,
                   spectrum=_NOPRUNE, device_tally=None):
    """Shared pileup back half: overlap tweaks, quality shaping, per-column
    errmod + tallies, SNP calling, indel calling.  Consumed by both the
    object front-end (pileup_call) and the columnar one
    (pileup_call_columnar).  ``device_tally`` is the device the per-column
    tallies run on (resolve_device_pileup), None for the host bincounts."""
    records: list = []
    roffs = np.concatenate(([0], np.cumsum(rlens)))
    aqi = roffs[flat_rid] + flat_qi
    _apply_overlap_tweaks_flat(pairedok, qnames, rs_arr, flat_p, aqi,
                               flat_rid, Qcat, Scat, n, pair_ids=pair_ids)
    q = Qcat[aqi]
    left_ok = flat_qi > 0
    q = np.where(left_ok,
                 np.minimum(q, Qcat[np.maximum(aqi - 1, 0)] + DELTA_BQ), q)
    right_ok = flat_qi + 1 < rlens[flat_rid]
    q = np.where(right_ok,
                 np.minimum(q, Qcat[np.minimum(aqi + 1, len(Qcat) - 1)]
                            + DELTA_BQ), q)
    keep_q = q >= MIN_BQ
    q = np.minimum(q, MAX_BQ)
    q = np.minimum(q, mqs[flat_rid])
    q = np.clip(q, 4, 63)
    b = _BLUT[Scat[aqi]]
    e_p = flat_p[keep_q]
    e_q = q[keep_q]
    e_s = revs[flat_rid[keep_q]]
    e_b = b[keep_q]
    nonref = (e_b != ref_idx[e_p]) & (e_b < 4)
    has_nonref = np.unique(e_p[nonref])
    # group surviving entries of nonref columns, preserving order (stable)
    want = np.zeros(n, dtype=bool)
    want[has_nonref] = True
    sel = want[e_p]
    g_p, g_q, g_s, g_b = e_p[sel], e_q[sel], e_s[sel], e_b[sel]
    order = np.argsort(g_p, kind="stable")
    g_p, g_q, g_s, g_b = g_p[order], g_q[order], g_s[order], g_b[order]
    if len(g_p) == 0:
        records.extend(_indel_records(ref, n, indel_events, flat_p,
                                      flat_rid, q, keep_q, revs, mqs, depth,
                                      indel_input))
        records.sort(key=lambda rec: rec.pos)
        return records
    gstart = np.concatenate(
        ([0], np.flatnonzero(g_p[1:] != g_p[:-1]) + 1, [len(g_p)]))
    ncol = len(gstart) - 1
    # column ids + all-columns errmod (cal_columns; per-column cal_arrays is
    # its oracle) and full-column base/qual/AD tallies in one pass
    col_id = np.cumsum(np.concatenate(
        ([0], (g_p[1:] != g_p[:-1]).astype(np.int64))))
    capped = _cumcount(col_id) < ERRMOD_MAXN
    DIAG, BSUM, _CC = _ERRMOD.cal_columns(
        col_id[capped], g_q[capped], g_s[capped], g_b[capped], ncol)
    if device_tally is not None:
        BCF, QS, ADF, ADR = tally_columns_device(col_id, g_q, g_s, g_b, ncol,
                                                 device_tally)
    else:
        BCF = np.bincount(col_id * 5 + np.minimum(g_b, 4),
                          minlength=ncol * 5).reshape(ncol, 5)
        v_all = g_b < 4
        QS = np.bincount(col_id[v_all] * 4 + g_b[v_all],
                         weights=g_q[v_all].astype(np.float64),
                         minlength=ncol * 4).reshape(ncol, 4)
        ADF = np.bincount(
            col_id[v_all & (g_s == 0)] * 4 + g_b[v_all & (g_s == 0)],
            minlength=ncol * 4).reshape(ncol, 4)
        ADR = np.bincount(
            col_id[v_all & (g_s == 1)] * 4 + g_b[v_all & (g_s == 1)],
            minlength=ncol * 4).reshape(ncol, 4)

    snp_cols = range(ncol)
    if spectrum is not _NOPRUNE:
        keep_col = _snp_prefilter(DIAG, QS, ref_idx, g_p, gstart, ncol,
                                  spectrum)
        if keep_col is not None:
            snp_cols = np.flatnonzero(keep_col).tolist()
    for gi in snp_cols:
        a0 = int(gstart[gi])
        p = int(g_p[a0])
        r4 = int(ref_idx[p])
        if r4 >= 4:
            continue
        qs = QS[gi]
        adf = ADF[gi]
        adr = ADR[gi]
        tot = qs.sum()
        if tot <= 0:
            continue
        qsum = qs / tot
        alt_order = sorted((b for b in range(4) if b != r4 and qsum[b] > 0),
                           key=lambda b: (-qsum[b], b))
        if not alt_order:
            continue
        alleles = [r4] + alt_order

        col_bsum = BSUM[gi]
        base_counts = BCF[gi]
        na = len(alleles)
        # genotype-subset normalization incl. het entries (bcf_call_combine)
        gvals = []
        hom_idx = []
        z = 0
        for i2 in range(na):
            for j2 in range(i2 + 1):
                ai, aj = alleles[j2], alleles[i2]
                if i2 == j2:
                    gvals.append(DIAG[gi, ai])
                    hom_idx.append(z)
                else:
                    # het likelihood for haploid calling never wins, but it
                    # participates in the min-normalization; approximate with
                    # the average of the two homs minus the lhet term's scale
                    gvals.append(_het_phred(base_counts, ai, aj, col_bsum))
                z += 1
        gvals = np.array(gvals)
        gmin = gvals.min()
        pl_all = np.minimum(np.floor(gvals - gmin + 0.499), 255).astype(int)
        pls = [int(pl_all[h]) for h in hom_idx]
        gt = int(np.argmin(pls))
        ads = [int(adf[a] + adr[a]) for a in alleles]
        qual = float(pls[0]) if gt != 0 else (float(pls[1]) if len(pls) > 1 else 0.0)
        records.append(
            SiteRecord(
                pos=p,
                ref=BASES[r4],
                alts=[BASES[a] for a in alt_order],
                qual=qual,
                dp=int(depth[p]),
                gt=gt,
                pls=pls,
                ads=ads,
            )
        )
    records.extend(_indel_records(ref, n, indel_events, flat_p, flat_rid,
                                  q, keep_q, revs, mqs, depth, indel_input))
    records.sort(key=lambda rec: rec.pos)
    return records




def _indel_records(ref, n, indel_events, flat_p, flat_rid, q, keep_q, revs,
                   mqs, depth, indel_input):
    """Indel dispatch: the bcftools-realignment caller (genotype/indel.py)
    by default; the simplified left-normalized CIGAR-event caller
    (_call_indels) as the legacy oracle (PANMAP_TPU_LEGACY_INDELS=1 or no
    IndelInput available)."""
    import os as _os

    if (indel_input is None
            or _os.environ.get("PANMAP_TPU_LEGACY_INDELS") == "1"):
        return _call_indels(ref, n, indel_events, flat_p, flat_rid, q,
                            keep_q, revs, mqs, depth)
    from .indel import call_indels_realign

    return call_indels_realign(ref, indel_input, depth, _ERRMOD)

def _call_indels(ref: str, n: int, indel_events: list, flat_p, flat_rid,
                 flat_q, keep_q, revs, mqs, depth):
    """Haploid indel calls from CIGAR I/D events (bcftools calls indels via
    bam2bcf_indel.c's type-collection + per-read realignment; this is the
    SIMPLIFIED equivalent documented in PARITY.md: per anchor the dominant
    indel type competes against the no-indel reads through the same
    revised-MAQ errmod used for SNPs, with the event quality = min base
    quality inside/flanking the event).  VCF left-anchored convention:
    insertion REF=anchor ALT=anchor+seq, deletion REF=anchor+run ALT=anchor."""
    if not indel_events:
        return []
    by_anchor: dict = defaultdict(dict)  # anchor -> rid -> [(typekey, qev)]
    for anchor, rid, tk, qev in indel_events:
        by_anchor[anchor].setdefault(rid, []).append((tk, qev))
    anchors = np.array(sorted(by_anchor), dtype=np.int64)
    sel = np.isin(flat_p, anchors)
    sp_p = flat_p[sel]
    sp_rid = flat_rid[sel]
    sp_q = flat_q[sel]
    sp_keep = keep_q[sel]
    order = np.argsort(sp_p, kind="stable")  # pileup order within anchor
    sp_p, sp_rid, sp_q, sp_keep = (sp_p[order], sp_rid[order], sp_q[order],
                                   sp_keep[order])
    lo_b = np.searchsorted(sp_p, anchors, side="left")
    hi_b = np.searchsorted(sp_p, anchors, side="right")
    recs = []
    for ai, anchor in enumerate(anchors.tolist()):
        evmap = by_anchor[anchor]
        support: dict = defaultdict(lambda: [0, 0])
        for _rid, evs in evmap.items():
            for tk, qev in evs:
                c = support[tk]
                c[0] += 1
                c[1] += qev
        tk_dom = max(support.items(),
                     key=lambda kv: (kv[1][0], kv[1][1], kv[0]))[0]
        if tk_dom[0] == "D" and anchor + 1 + tk_dom[1] > n:
            continue

        def dom_qual(evs):
            """Event quality of the dominant type, or None."""
            for tk, qev in evs:
                if tk == tk_dom:
                    return qev
            return None

        q_list, s_list, b_list = [], [], []
        ad = [0, 0]
        seen_rids = set()
        for i in range(int(lo_b[ai]), int(hi_b[ai])):
            rid = int(sp_rid[i])
            seen_rids.add(rid)
            evs = evmap.get(rid)
            if evs is None:
                if not sp_keep[i]:
                    continue
                code = 0
                qv = int(sp_q[i])
            else:
                qev = dom_qual(evs)
                if qev is None:
                    continue  # other indel type: counts toward DP only
                if qev < MIN_BQ:
                    continue
                code = 1
                qv = max(4, min(int(qev), MAX_BQ, int(mqs[rid]), 63))
            q_list.append(qv)
            s_list.append(int(revs[rid]))
            b_list.append(code)
            ad[code] += 1
        # supporting reads whose matched columns do not cover the
        # left-normalized anchor (e.g. a deletion left-shifted past the
        # read's start in a homopolymer) are still real observations
        for rid in sorted(evmap):
            if rid in seen_rids:
                continue
            qev = dom_qual(evmap[rid])
            if qev is None or qev < MIN_BQ:
                continue
            q_list.append(max(4, min(int(qev), MAX_BQ, int(mqs[rid]), 63)))
            s_list.append(int(revs[rid]))
            b_list.append(1)
            ad[1] += 1
        if ad[1] == 0 or not q_list:
            continue
        qa = np.array(q_list, dtype=np.int64)
        sa = np.array(s_list, dtype=np.int64)
        ba = np.array(b_list, dtype=np.int64)
        DIAG, bsum, _cc = _ERRMOD.cal_arrays(qa, sa, ba)
        base_counts = np.bincount(ba, minlength=5)
        gvals = np.array([DIAG[0, 0],
                          _het_phred(base_counts, 0, 1, bsum),
                          DIAG[1, 1]])
        gmin = gvals.min()
        pl_all = np.minimum(np.floor(gvals - gmin + 0.499), 255).astype(int)
        pls = [int(pl_all[0]), int(pl_all[2])]
        gt = int(np.argmin(pls))
        qual = (float(pls[0]) if gt != 0
                else (float(pls[1]) if len(pls) > 1 else 0.0))
        if tk_dom[0] == "I":
            ref_s = ref[anchor]
            alt_s = ref[anchor] + tk_dom[1]
        else:
            ref_s = ref[anchor : anchor + 1 + tk_dom[1]]
            alt_s = ref[anchor]
        recs.append(SiteRecord(pos=int(anchor), ref=ref_s, alts=[alt_s],
                               qual=qual, dp=int(depth[anchor]), gt=gt,
                               pls=pls, ads=ad))
    return recs


_LN2 = math.log(2.0)


def _het_phred(base_counts: np.ndarray, a1: int, a2: int,
               bsum: np.ndarray) -> float:
    """Heterozygous genotype phred (errmod.c:193-201): -4.343*lhet(c1+c2, c2)
    + sum of bsum over other bases (bsum reused from ErrMod.cal — the walk
    there is identical).  Participates only in the min-normalization for
    haploid calls.  base_counts = full-column per-base counts (uncapped)."""
    c1 = int(base_counts[a1])
    c2 = int(base_counts[a2])
    n12 = c1 + c2
    # lhet[n,k] = log C(n,k) - n log 2
    lc = (math.lgamma(n12 + 1) - math.lgamma(c2 + 1) - math.lgamma(n12 - c2 + 1)
          - n12 * _LN2)
    other = sum(bsum[b] for b in range(5) if b != a1 and b != a2)
    val = -4.343 * lc + other
    return max(val, 0.0)


def phred_scale_matrix(substitution_matrix: np.ndarray):
    """index 4x4 rates -> phred prior (main.cpp:293-311); None when all off-diag 0."""
    m = np.asarray(substitution_matrix, dtype=np.float64).reshape(4, 4)
    if np.all(m[~np.eye(4, dtype=bool)] == 0):
        return None
    phred = np.where(m > 0, -10.0 * np.log10(np.where(m > 0, m, 1.0)), 100.0)
    return phred


def load_mutation_matrix(path: str):
    """Parse a .mm mutation-matrix file (genotyping.cpp:42-109
    fillMutationMatricesFromFile): 4 rows of 4 phred-scaled substitution
    probabilities, then one "size:prob" row each for insertions and
    deletions.  Returns (submat f64[4,4], insmat dict, delmat dict)."""
    submat = np.zeros((4, 4), dtype=np.float64)
    insmat: dict = {}
    delmat: dict = {}
    idx = 0
    with open(path) as fh:
        for line in fh:
            fields = line.split()
            if not fields:
                break
            if idx < 4:
                if len(fields) != 4:
                    raise ValueError("invalid mutation matrix (.mm) file")
                submat[idx] = [float(f) for f in fields]
            elif idx in (4, 5):
                out = insmat if idx == 4 else delmat
                for f in fields:
                    size, _, prob = f.partition(":")
                    if not prob:
                        raise ValueError("invalid size:prob field in .mm file")
                    out[int(size)] = float(prob)
            idx += 1
    if idx != 6:
        raise ValueError("invalid mutation matrix (.mm) file")
    return submat, insmat, delmat


def apply_spectrum(records: list, phred: np.ndarray | None, min_depth: int,
                   min_qual: float) -> list:
    """applyMutationSpectrum + consensus gate (src/genotyping.cpp:200-279)."""
    out = []
    for rec in records:
        if not rec.alts:
            continue
        if phred is None:
            if rec.gt == 0 or rec.qual < min_qual:
                continue
            if not _passes_gate(rec.gt, rec.ads, min_depth):
                continue
            out.append(rec)
            continue
        r = _BIDX.get(rec.ref, -1)
        is_indel = len(rec.ref) > 1 or any(len(a) > 1 for a in rec.alts)
        if is_indel:
            # indel/multi-base record (insertions have a single-base REF, so
            # test the ALTs too): no SNP spectrum; apply the same quality
            # threshold and consensus gate as the no-spectrum path
            if rec.gt == 0 or rec.qual < min_qual:
                continue
            if not _passes_gate(rec.gt, rec.ads, min_depth):
                continue
            out.append(rec)
            continue
        if r < 0 or r > 3:
            # single-base degenerate REF (N/ambiguous): the reference emits
            # these bare on gt != 0 with no spectrum, gate, or quality
            # threshold (genotyping.cpp:222-223)
            if rec.gt != 0:
                out.append(rec)
            continue
        gls = np.array(rec.pls, dtype=np.float64)
        gls[0] += phred[r][r]
        for i, alt in enumerate(rec.alts):
            a = _BIDX.get(alt, 5)
            if a <= 3:
                gls[i + 1] += phred[r][a]
        gls -= gls.min()
        zeros = np.flatnonzero(gls == 0)
        called = int(zeros[-1])  # cpp keeps the last zero index
        if called == 0:
            continue
        if not _passes_gate(called, rec.ads, min_depth):
            continue
        qual = float(gls[0])
        if qual < min_qual:
            continue
        rec.gt = called
        rec.qual = qual
        out.append(rec)
    return out


def _passes_gate(called_idx: int, ad: list, min_depth: int) -> bool:
    if called_idx <= 0:
        return False
    if not ad or called_idx >= len(ad):
        return True
    total = sum(ad)
    if total < min_depth:
        return False
    return ad[called_idx] * 2 > total


def write_vcf(path: str, chrom: str, ref_len: int, records: list, sample: str = "sample"):
    with open(path, "w") as fh:
        fh.write("##fileformat=VCFv4.2\n")
        fh.write('##FILTER=<ID=PASS,Description="All filters passed">\n')
        fh.write("##source=panmap-tpu\n")
        fh.write(f"##contig=<ID={chrom},length={ref_len}>\n")
        fh.write('##INFO=<ID=DP,Number=1,Type=Integer,Description="Raw read depth">\n')
        fh.write('##FORMAT=<ID=PL,Number=G,Type=Integer,Description="Phred-scaled genotype likelihoods">\n')
        fh.write('##FORMAT=<ID=AD,Number=R,Type=Integer,Description="Allelic depths">\n')
        fh.write('##FORMAT=<ID=GT,Number=1,Type=String,Description="Genotype">\n')
        fh.write(f"#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\t{sample}\n")
        for rec in records:
            fh.write(rec.vcf_line(chrom) + "\n")


def build_consensus(ref: str, records: list, header: str) -> str:
    """Apply called variants to the reference (bcftools consensus equivalent),
    60-column wrapping."""
    seq = list(ref)

    def _is_indel(r):
        return len(r.ref) > 1 or any(len(a) > 1 for a in r.alts)

    # descending position order: length-changing (indel) edits must not
    # shift the coordinates of records applied after them.  At EQUAL pos the
    # indel applies first (its REF/ALT embeds the anchor reference base, so
    # a later SNP at the anchor must overwrite it, not be clobbered by it)
    for rec in sorted(records, key=lambda r: (-r.pos, not _is_indel(r))):
        if rec.gt <= 0 or rec.gt > len(rec.alts):
            continue
        alt = rec.alts[rec.gt - 1]
        if len(alt) == 1 and len(rec.ref) == 1:
            seq[rec.pos] = alt
        else:
            seq[rec.pos : rec.pos + len(rec.ref)] = list(alt)
    s = "".join(seq)
    lines = [f">{header}"]
    for i in range(0, len(s), 60):
        lines.append(s[i : i + 60])
    return "\n".join(lines) + "\n"
