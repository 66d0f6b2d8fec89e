"""Indel genotyping with bcftools realignment semantics.

Re-implements the *used subset* of the reference's embedded bcftools indel
model (src/3rdparty/bcftools/bam2bcf_indel.c bcf_call_gap_prep, driven by
`mpileup -Ou` via src/conversion.cpp:83-128) as the default indel caller:

 1. candidate positions = ref base BEFORE any CIGAR I/D (p->indel != 0);
 2. type collection with support gates (min_support=2, min_frac=0.05 over
    the sample; bcf_cgp_find_types);
 3. per-sample consensus window with the 70%-mismatch N-masking
    (bcf_cgp_ref_sample) and majority insertion consensus (bcf_cgp_calc_cons);
 4. per (read x type) banded-glocal realignment score (probaln score mode;
    genotype/baq.py::glocal_score_py) over the consensus with the type
    applied, quals clamped to [7, 30], bw = |type| + 3;
 5. STR adjustment of the length-normalized score (find_STR port) and
    per-read indelQ/seqQ (bcf_cgp_compute_indelQ + est_seqQ with
    openQ=40 extQ=20 tandemQ=500);
 6. glfgen entries (q<<5|strand<<4|type_slot; the e4e161068 low-coverage
    heuristic included) -> revised-MAQ errmod -> PL/GT exactly like the SNP
    path (bam2bcf.c:250-470);
 7. alleles with est_indelreg extension (bcf_call2bcf:1190-1210).

The previous simplified left-normalized CIGAR-event caller remains in
caller.py::_call_indels as a comparison oracle (PANMAP_TPU_LEGACY_INDELS=1).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .baq import glocal_score_py


def _glocal_score(ref_codes, q_codes, qq, bw, gapd, gape) -> int:
    """Native forward-only glocal score (pt_glocal_score — exact-equality
    fuzz-tested twin of glocal_score_py, which remains the oracle and the
    fallback)."""
    from ..native import glocal_score_native

    sc = glocal_score_native(ref_codes, q_codes, qq, bw, gapd, gape)
    if sc is None:
        return glocal_score_py(ref_codes, q_codes, qq, bw, gapd, gape)
    return sc

# bcftools mpileup defaults (mpileup.c:1363-1384)
MIN_SUPPORT = 2
MIN_FRAC = 0.05
INDEL_WIN_SIZE = 110
OPEN_Q = 40
EXT_Q = 20
TANDEM_Q = 500
INDEL_BIAS = 1.0
MAX_TYPES = 64
MIN_BASEQ = 1
MAX_BASEQ = 60
CAP_Q = 60  # bam2bcf.c:49
MAX_DEPTH_INDEL = 250


@dataclass
class IndelInput:
    """Per-kept-read view the realignment needs (both pileup front-ends
    construct it from what they already hold).  ops/lns are the flat cigar
    op table (BAM codes, soft clips included), opoff its per-read offsets;
    seq/quals are the ORIENTED blobs with soff offsets."""

    rs: np.ndarray      # i64[nk]
    ops: np.ndarray     # i64 flat
    lns: np.ndarray     # i64 flat
    opoff: np.ndarray   # i64[nk+1]
    seq: np.ndarray     # u8 ASCII blob
    quals: np.ndarray   # i64 blob (0-based phred)
    soff: np.ndarray    # i64[nk+1]
    mapq: np.ndarray    # i64[nk]
    rev: np.ndarray     # i8[nk]


def find_str(codes: np.ndarray) -> list:
    """Short-tandem-repeat finder over 0..3 codes — port of bcftools
    str_finder.c find_STR (unpadded input, lower_only=0).  Returns
    [(start, end, rep_len)] in append order with the same containment
    pruning."""
    reps: list = []

    def add_rep(pos: int, rlen: int):
        if reps:
            s0, e0, _ = reps[-1]
            if s0 <= pos - rlen * 2 + 1 and e0 >= pos:
                return
        # extend forward while the repeat continues
        i1 = pos + 1 - rlen
        i2 = pos + 1
        n = len(codes)
        while i2 < n and codes[i1] == codes[i2]:
            i1 += 1
            i2 += 1
        end = pos + (i2 - (pos + 1))
        start = pos - 2 * rlen + 1
        # prune older items entirely contained within [start, end]
        while reps:
            s0, e0, _ = reps[-1]
            if e0 < start:
                break
            if s0 >= start:
                reps.pop()
            else:
                break
        reps.append((start, end, rlen))

    w = 0
    n = len(codes)
    i = 0
    j = 0
    while i < n and j < 15:
        w = ((w << 2) | int(codes[i])) & 0xFFFFFFFF
        for r in range(1, 8):
            if j >= 2 * r - 1 and (w & ((1 << (2 * r)) - 1)) == \
                    ((w >> (2 * r)) & ((1 << (2 * r)) - 1)):
                add_rep(i, r)
        j += 1
        i += 1
    while i < n:
        w = ((w << 2) | int(codes[i])) & 0xFFFFFFFF
        for r in range(8, 0, -1):  # else-if chain: longest first, one hit
            if (w & ((1 << (2 * r)) - 1)) == \
                    ((w >> (2 * r)) & ((1 << (2 * r)) - 1)):
                add_rep(i, r)
                break
        i += 1
    return reps


def est_seqq(l: int, l_run: int) -> int:
    """est_seqQ (bam2bcf_indel.c:80-87)."""
    q = OPEN_Q + EXT_Q * (abs(l) - 1)
    qh = int(TANDEM_Q * abs(l) / l_run + 0.499) if l_run >= 3 else 1000
    return min(q, qh)


def est_indelreg(pos: int, ref: str, l: int, ins: str | None) -> int:
    """est_indelreg (bam2bcf_indel.c:89-100)."""
    l = abs(l)
    max_ = 0
    max_i = pos
    score = 0
    j = 0
    i = pos + 1
    n = len(ref)
    while i < n:
        if ins is not None:
            score += 1 if ref[i].upper() == ins[j % l] else -10
        else:
            score += 1 if ref[i].upper() == ref[pos + 1 + j % l].upper() \
                else -10
        if score < 0:
            break
        if max_ < score:
            max_ = score
            max_i = i
        i += 1
        j += 1
    return max_i - pos


def l_run_of(ref: str, pos: int) -> int:
    """Homopolymer run length around pos (bcf_cgp_l_run)."""
    n = len(ref)
    if pos + 1 >= n:
        return 1
    c = ref[pos + 1].upper()
    if c not in "ACGT":
        return 1
    i = pos + 2
    while i < n and ref[i].upper() == c:
        i += 1
    l_run = i
    i = pos
    while i >= 0 and ref[i].upper() == c:
        i -= 1
    return l_run - (i + 1)


_QADV = {0: 1, 1: 1, 4: 1, 7: 1, 8: 1}
_RADV = {0: 1, 2: 1, 3: 1, 7: 1, 8: 1}


def _tpos2qpos(rs: int, ops, lns, tpos: int, is_left: bool):
    """tpos2qpos (bam2bcf_indel.c:49-78): query index aligned at ref tpos.
    Returns (qpos, actual_tpos)."""
    x = rs
    y = 0
    last_y = 0
    for op, ln in zip(ops, lns):
        op = int(op)
        ln = int(ln)
        if op in (0, 7, 8):
            if rs > tpos:
                return y, rs
            if x + ln > tpos:
                return y + (tpos - x), tpos
            x += ln
            y += ln
            last_y = y
        elif op in (1, 4):
            y += ln
        elif op in (2, 3):
            if x + ln > tpos:
                return y, (x if is_left else x + ln)
            x += ln
    return last_y, x


def _read_state_at(rs: int, ops, lns, pos: int):
    """(covers, indel_after, qpos, is_del) of a read at ref pos — the pileup
    fields p->indel / p->qpos / p->is_del."""
    x = rs
    y = 0
    nop = len(ops)
    for k in range(nop):
        op = int(ops[k])
        ln = int(lns[k])
        if op in (0, 7, 8):
            if x <= pos < x + ln:
                indel = 0
                if pos == x + ln - 1 and k + 1 < nop:
                    nxt = int(ops[k + 1])
                    if nxt == 1:
                        indel = int(lns[k + 1])
                    elif nxt == 2:
                        indel = -int(lns[k + 1])
                return True, indel, y + (pos - x), False
            x += ln
            y += ln
        elif op in (1, 4):
            y += ln
        elif op in (2, 3):
            if x <= pos < x + ln:
                return True, 0, y, True  # spanning deletion
            x += ln
    return False, 0, 0, False


def call_indels_realign(ref: str, inp: IndelInput, depth: np.ndarray,
                        errmod) -> list:
    """The full gap_prep + glfgen + combine chain over every candidate
    position.  Returns SiteRecord list (caller.SiteRecord)."""
    from .caller import SiteRecord, _het_phred

    n = len(ref)
    nk = len(inp.rs)
    if nk == 0:
        return []

    # candidate positions (base before any I/D op) + per-position support
    # counts, vectorized over the flat op stream.  The support count is an
    # UPPER BOUND on gap_prep's n_alt (uncapped, can double-count a read
    # with two ops at one pos), so `count < MIN_SUPPORT` is a sound skip:
    # the full per-read walk would hit the same `n_alt < MIN_SUPPORT` gate.
    ops_f = np.asarray(inp.ops, dtype=np.int64)
    lns_f = np.asarray(inp.lns, dtype=np.int64)
    op_read = np.repeat(np.arange(nk, dtype=np.int64), np.diff(inp.opoff))
    radv = np.where((ops_f == 0) | (ops_f == 2) | (ops_f == 3)
                    | (ops_f == 7) | (ops_f == 8), lns_f, 0)
    cs = np.cumsum(radv)
    excl = cs - radv
    off0 = inp.opoff[:-1].astype(np.int64)
    first_excl = np.zeros(nk, dtype=np.int64)
    ne = np.diff(inp.opoff) > 0
    first_excl[ne] = excl[off0[ne]]
    x_at_op = inp.rs[op_read] + (excl - first_excl[op_read])
    is_cand_op = (ops_f == 1) | (ops_f == 2)
    p_all = x_at_op[is_cand_op] - 1
    p_all = p_all[(p_all > 0) & (p_all < n)]
    if len(p_all) == 0:
        return []
    p_uniq, p_cnt = np.unique(p_all, return_counts=True)
    cand = p_uniq[p_cnt >= MIN_SUPPORT]
    if len(cand) == 0:
        return []

    # read extents for overlap queries (segment sums of ref-advancing ops)
    spans = np.zeros(nk, dtype=np.int64)
    sums = np.add.reduceat(radv, off0[ne]) if ne.any() else np.empty(0)
    spans[ne] = sums
    ends = inp.rs + spans

    seq_codes_blob = np.full(len(inp.seq), 4, dtype=np.int64)
    from .caller import _BLUT

    seq_codes_blob[:] = _BLUT[inp.seq]

    records = []
    for pos in cand.tolist():
        rows = np.flatnonzero((inp.rs <= pos) & (pos < ends))
        if len(rows) == 0:
            continue
        plp = []  # (row, indel, qpos, is_del)
        for r in rows.tolist():
            a, b = int(inp.opoff[r]), int(inp.opoff[r + 1])
            covers, indel, qpos, is_del = _read_state_at(
                int(inp.rs[r]), inp.ops[a:b], inp.lns[a:b], pos)
            if covers:
                plp.append((r, indel, qpos, is_del))
                if len(plp) >= MAX_DEPTH_INDEL:  # bcftools --max-idepth gate
                    break
        if not plp:
            continue

        rec = _gap_prep_and_call(ref, n, inp, seq_codes_blob, plp, pos,
                                 errmod, depth, SiteRecord, _het_phred)
        if rec is not None:
            records.append(rec)
    return records


_str_cache: dict = {}


def _gap_prep_and_call(ref, n, inp, codes_blob, plp, pos, errmod, depth,
                       SiteRecord, _het_phred):
    if len(_str_cache) > 4096:
        _str_cache.clear()
    # ---- bcf_cgp_find_types ----
    sizes = [indel for (_r, indel, _q, _d) in plp if indel != 0]
    n_tot = len(plp)
    n_alt = len(sizes)
    if n_alt == 0:
        return None
    if n_alt < MIN_SUPPORT or (n_alt / n_tot) < MIN_FRAC:
        return None
    types = sorted(set(sizes) | {0})
    if len(types) < 2 or len(types) >= MAX_TYPES:
        return None
    # N-run guard
    max_rd_len = max(int(inp.soff[r + 1] - inp.soff[r])
                     for (r, _i, _q, _d) in plp)
    i_end = pos + min(2 * INDEL_WIN_SIZE, max_rd_len)
    seg = ref[pos : min(i_end, n)]
    if seg and 2 * seg.upper().count("N") > len(seg):
        return None
    ref_type = types.index(0)
    n_types = len(types)

    # ---- window ----
    left = max(pos - INDEL_WIN_SIZE, 0)
    right = pos + INDEL_WIN_SIZE
    if types[0] < 0:
        right -= types[0]
    right = min(right, n)

    # ---- per-sample consensus (bcf_cgp_ref_sample; one sample) ----
    L = right - left
    ref0 = np.array([c for c in ref[left:right]], dtype="U1")
    ref0u = np.char.upper(ref0)
    cns_ref = np.zeros(L, dtype=np.int64)
    cns_alt = np.zeros(L, dtype=np.int64)
    for (r, _indel, _qpos, _isdel) in plp:
        a, b = int(inp.opoff[r]), int(inp.opoff[r + 1])
        x = int(inp.rs[r])
        y = 0
        base = int(inp.soff[r])
        for k in range(a, b):
            op = int(inp.ops[k])
            ln = int(inp.lns[k])
            if op in (0, 7, 8):
                if x + ln >= left:
                    j0 = max(left - x, 0)
                    j1 = min(right - x, ln)
                    for j in range(j0, j1):
                        code = codes_blob[base + y + j]
                        rc = ref0u[x + j - left]
                        same = (code < 4 and "ACGT"[code] == rc)
                        if same:
                            cns_ref[x + j - left] += 1
                        else:
                            cns_alt[x + j - left] += 1
                x += ln
                y += ln
            elif op in (2, 3):
                x += ln
            elif op in (1, 4):
                y += ln
            if x > right:
                break
    cons = ref0u.copy()  # sample consensus, 'N' where masked
    # deepest and 2nd-deepest ALT loci (>= comparisons as in the C walk)
    max_v = max2_v = (0, 0)
    max_i = max2_i = -1
    for i in range(L):
        v = (cns_alt[i], cns_ref[i])
        if v[0] >= max_v[0]:
            max2_v, max2_i = max_v, max_i
            max_v, max_i = v, i
        elif v[0] >= max2_v[0]:
            max2_v, max2_i = v, i
    if max_v[0] + max_v[1] > 0 and max_v[1] / (max_v[1] + max_v[0]) >= 0.7:
        max_i = -1
    if max2_v[0] + max2_v[1] > 0 and \
            max2_v[1] / (max2_v[1] + max2_v[0]) >= 0.7:
        max2_i = -1
    if max_i >= 0:
        cons[max_i] = "N"
    if max2_i >= 0:
        cons[max2_i] = "N"
    cons_codes = np.full(L, 4, dtype=np.int64)
    for i, ch in enumerate(cons):
        cons_codes[i] = "ACGT".find(ch) if ch in "ACGT" else 4

    l_run = l_run_of(ref, pos)

    # ---- insertion consensus (bcf_cgp_calc_cons) ----
    max_ins = types[-1]
    inscns = {}
    types = list(types)
    for t, ty in enumerate(types):
        if ty <= 0:
            continue
        counts = np.zeros((ty, 5), dtype=np.int64)
        for (r, indel, qpos, _isdel) in plp:
            if indel == ty:
                base = int(inp.soff[r])
                for k in range(1, ty + 1):
                    c = codes_blob[base + qpos + k] \
                        if base + qpos + k < int(inp.soff[r + 1]) else 4
                    counts[k - 1, min(int(c), 4)] += 1
        s = []
        dead = False
        for j in range(ty):
            mx = counts[j].max()
            mk = int(np.argmax(counts[j])) if mx > 0 else 4
            if mk == 4:
                types[t] = 0  # discard: contains N (duplicate REF type)
                dead = True
                break
            s.append("ACGT"[mk])
        if not dead:
            inscns[ty] = "".join(s)

    # ---- per (read x type) realignment scores ----
    N = len(plp)
    score = np.full((N, n_types), 0xFFFFFF, dtype=np.int64)
    right_t = right
    for t, ty in enumerate(types):
        # ref2: consensus with the type applied at pos (insertions that were
        # discarded by calc_cons have ty == 0 here and behave as REF)
        parts = [cons_codes[: pos - left + 1]]
        if ty > 0 and ty in inscns:
            parts.append(np.array(["ACGT".find(c) for c in inscns[ty]],
                                  dtype=np.int64))
            j = pos + 1
        else:
            j = pos + 1 - min(ty, 0)  # deletion skips -ty bases
        parts.append(cons_codes[j - left : right - left])
        ref2 = np.concatenate(parts)
        left2, right2 = left, right_t

        for K, (r, indel, qpos_p, _isdel) in enumerate(plp):
            a, b = int(inp.opoff[r]), int(inp.opoff[r + 1])
            ops_r = inp.ops[a:b]
            lns_r = inp.lns[a:b]
            if any(int(o) == 3 for o in ops_r):  # BAM_CREF_SKIP
                continue
            rs_r = int(inp.rs[r])
            qbeg, tbeg = _tpos2qpos(rs_r, ops_r, lns_r, left2, False)
            qpos_t, _ = _tpos2qpos(rs_r, ops_r, lns_r, pos, False)
            qpos_t -= qbeg
            qend, _tend = _tpos2qpos(rs_r, ops_r, lns_r, right2, True)
            if ty < 0:
                tbeg = max(tbeg + ty, left2)
            if qend <= qbeg:
                continue
            base = int(inp.soff[r])
            query = codes_blob[base + qbeg : base + qend]
            qq = np.clip(inp.quals[base + qbeg : base + qend], 7, 30) \
                .astype(np.uint8)
            tend = _tend
            if tend <= tbeg:
                continue  # read entirely within a deletion: keep 0xffffff
            # htslib aligns against ref2[tbeg-left .. +(tend-tbeg+type)]
            # (insertion lengthens the target, deletion shortens); the C
            # buffer is N-padded past construction, mirror that
            seg_lo = tbeg - left
            seg_len = tend - tbeg + ty
            if seg_len <= 0:
                continue
            seg = ref2[seg_lo : seg_lo + seg_len]
            if len(seg) < seg_len:
                seg = np.concatenate(
                    [seg, np.full(seg_len - len(seg), 4, np.int64)])
            if len(seg) == 0:
                continue
            sc = _glocal_score(seg, query, qq, abs(ty) + 3, 1e-4, 1e-2)
            if sc < 0:
                continue
            lnorm = int(100.0 * sc / (qend - qbeg) + 0.499) * INDEL_BIAS
            s_packed = (sc << 8) | min(255, int(lnorm))
            # STR adjustment over the aligned consensus segment (memoized:
            # many reads share tbeg/tend windows of the same ref2)
            iscore = 0
            r_start = rs_r
            r_end = rs_r + sum(int(l) for o, l in zip(ops_r, lns_r)
                               if int(o) in _RADV) - 1
            skey = seg.tobytes()
            reps = _str_cache.get(skey)
            if reps is None:
                reps = _str_cache[skey] = find_str(seg)
            for (st, en, rlen) in reps:
                if st <= qpos_t <= en:
                    iscore += (en - st) // rlen
                    if st + tbeg <= r_start or en + tbeg >= r_end:
                        iscore += 2 * (en - st)
            l2 = int((s_packed & 0xFF) * 0.8 + iscore * 2)
            s_packed = (s_packed & ~0xFF) | min(255, l2)
            score[K, t] = s_packed

    # ---- compute_indelQ ----
    aux = np.zeros(N, dtype=np.int64)
    sumq = [0] * n_types
    for K in range(N):
        sc = sorted((int(score[K, t]) << 6 | t) for t in range(n_types))
        if (sc[0] & 0x3F) == ref_type:
            indelq = (sc[1] >> 14) - (sc[0] >> 14)
            seqq = est_seqq(types[sc[1] & 0x3F], l_run)
        else:
            tt = next(t for t in range(n_types)
                      if (sc[t] & 0x3F) == ref_type)
            indelq = (sc[tt] >> 14) - (sc[0] >> 14)
            seqq = est_seqq(types[sc[0] & 0x3F], l_run)
        tmp = sc[0] >> 6 & 0xFF
        indelq = 0 if tmp > 111 else int((1.0 - tmp / 111.0) * indelq + 0.499)
        indelq = min(indelq, seqq, 255)
        seqq = min(seqq, 255)
        aux[K] = (sc[0] & 0x3F) << 16 | seqq << 8 | indelq
        sumq[sc[0] & 0x3F] += min(indelq, seqq)

    # order types by the C's packed key (sumq<<6 | t) DESCENDING — on equal
    # sumq the HIGHER type index sorts first (bcf_cgp_compute_indelQ's
    # insertion sort over the packed ints); REF type moved to slot 0
    order = sorted(range(n_types), key=lambda t: -((sumq[t] << 6) | t))
    order.remove(ref_type)
    order.insert(0, ref_type)
    indel_types = [types[t] for t in order[:4]]
    slot_of = {t: j for j, t in enumerate(order[:4])}
    n_alt_reads = 0
    for K in range(N):
        t0 = int(aux[K]) >> 16 & 0x3F
        j = slot_of.get(t0, 4)
        aux[K] = j << 16 | (0 if j == 4 else (int(aux[K]) & 0xFFFF))
        if (aux[K] >> 16 & 0x3F) > 0:
            n_alt_reads += 1
    if n_alt_reads == 0:
        return None

    # ---- glfgen entries (indel mode, bam2bcf.c:309-470) ----
    _n = N
    entries = []  # (q, strand, slot)
    for K, (r, indel, qpos_p, _isdel) in enumerate(plp):
        b_slot = int(aux[K]) >> 16 & 0x3F
        q = seqq = int(aux[K]) & 0xFF
        base = int(inp.soff[r])
        rl = int(inp.soff[r + 1] - inp.soff[r])
        if indel == 0 and (q < _n / 2 or _n > 20):
            b_slot = 0
            q = int(inp.quals[base + min(qpos_p, rl - 1)]) if rl else 0
            seqq = (3 * seqq + 2 * q) // 8
        if _n > 20 and seqq > 40:
            seqq = 40
        if q < MIN_BASEQ:
            continue
        mapq = int(inp.mapq[r])
        q = min(q, seqq)
        mapq = min(mapq, CAP_Q)
        q = min(q, mapq)
        q = max(4, min(q, 63))
        if b_slot >= 4:
            continue
        entries.append((q, int(inp.rev[r]), b_slot))
    if not entries:
        return None

    # ---- errmod + combine (same machinery as the SNP column) ----
    eq = np.array([e[0] for e in entries], dtype=np.int64)
    es = np.array([e[1] for e in entries], dtype=np.int64)
    eb = np.array([e[2] for e in entries], dtype=np.int64)
    DIAG, col_bsum, _cc = errmod.cal_arrays(eq, es, eb)
    qs = np.zeros(4)
    adf = np.zeros(4, dtype=np.int64)
    adr = np.zeros(4, dtype=np.int64)
    for (q, s, b_) in entries:
        if b_ < 4:
            qs[b_] += q
            if s:
                adr[b_] += 1
            else:
                adf[b_] += 1
    tot = qs.sum()
    if tot <= 0:
        return None
    qsum = qs / tot
    alt_order = sorted((b_ for b_ in range(min(4, len(indel_types)))
                        if b_ != 0 and qsum[b_] > 0
                        and indel_types[b_] != 0),  # dup-REF slots excluded
                       key=lambda b_: (-qsum[b_], b_))
    if not alt_order:
        return None
    alleles = [0] + alt_order
    base_counts = np.bincount(eb, minlength=5)
    na = len(alleles)
    gvals = []
    hom_idx = []
    z = 0
    for i2 in range(na):
        for j2 in range(i2 + 1):
            ai, aj = alleles[j2], alleles[i2]
            if i2 == j2:
                gvals.append(DIAG[ai, ai])
                hom_idx.append(z)
            else:
                gvals.append(_het_phred(base_counts, ai, aj, col_bsum))
            z += 1
    gvals = np.array(gvals)
    gmin = gvals.min()
    pl_all = np.minimum(np.floor(gvals - gmin + 0.499), 255).astype(int)
    pls = [int(pl_all[h]) for h in hom_idx]
    gt = int(np.argmin(pls))
    ads = [int(adf[a] + adr[a]) for a in alleles]
    qual = float(pls[0]) if gt != 0 else (float(pls[1]) if len(pls) > 1
                                          else 0.0)

    # ---- allele strings (bcf_call2bcf) ----
    indelreg = 0
    for t, ty in enumerate(types):
        if ty == 0:
            continue
        ir = est_indelreg(pos, ref, ty, inscns.get(ty) if ty > 0 else None)
        indelreg = max(indelreg, ir)
    ref_allele = ref[pos] + ref[pos + 1 : pos + 1 + indelreg]
    alts = []
    for b_ in alt_order:
        ty = indel_types[b_]
        if ty < 0:
            alts.append(ref[pos] + ref[pos + 1 - ty : pos + 1 + indelreg])
        else:
            ins = inscns.get(ty, "")
            alts.append(ref[pos] + ins + ref[pos + 1 : pos + 1 + indelreg])
    return SiteRecord(pos=pos, ref=ref_allele, alts=alts, qual=qual,
                      dp=int(depth[pos]), gt=gt, pls=pls, ads=ads)
