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

Steps 2-6 run for all candidate sites in one threaded native call
(native/panmap_native.cpp::pt_indel_sites), and _site_record finishes each
site in Python.  The stage has no Python twin: the JAX package's per-site
walk (panmap_tpu/genotype/indel.py::call_indels_realign) is its oracle,
held record- and entry-equal to it in tests/test_torch_indel_native.py.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np

# bcftools mpileup's min_support (mpileup.c:1363-1384); pt_indel_sites
# holds the other defaults
MIN_SUPPORT = 2


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


def call_indels_realign(ref: str, inp: IndelInput, depth: np.ndarray,
                        errmod, threads: int = 0) -> list:
    """The full gap_prep + glfgen + combine chain over every candidate
    position.  Returns SiteRecord list (caller.SiteRecord).

    The per-site work, from the covering reads to the glfgen entries, is one
    native call over all candidates on ``threads`` host threads (<= 0:
    min(cpu_count, 16)), and _site_record finishes each site.  Without the
    library it raises, under PANMAP_TPU_NO_NATIVE too.  Counts on the open
    span (genotype.indels): sites, threads and jobs (the realignments
    scored)."""
    from .. import trace
    from ..native import require_lib

    if require_lib() is None:
        raise RuntimeError(
            "the indel realignment needs the native library, which "
            "PANMAP_TPU_NO_NATIVE turns off; it has no numpy twin (its "
            "oracle is the JAX package's walk, "
            "panmap_tpu/genotype/indel.py::call_indels_realign)")
    if threads <= 0:
        threads = min(os.cpu_count() or 1, 16)
    trace.count("threads", threads)
    found = _candidates(len(ref), inp)
    trace.count("sites", 0 if found is None else len(found[0]))
    if found is None:
        return []
    cand, ins_cap = found
    return _realign_native(ref, inp, cand, ins_cap, depth, errmod, threads)


def _candidates(n: int, inp: IndelInput):
    """(cand, ins_cap), or None where no position qualifies: the candidate
    positions (base before any I/D op) with their per-position support,
    vectorized over the flat op stream; per candidate the sum of its
    insertions' lengths (a bound on its insertion consensus)."""
    nk = len(inp.rs)
    if nk == 0:
        return None

    # The support count is an UPPER BOUND on gap_prep's n_alt (uncapped, can
    # double-count a read with two ops at one pos), so `count < MIN_SUPPORT`
    # is a sound skip: pt_indel_sites' per-read walk would hit the same
    # `n_alt < MIN_SUPPORT` gate.
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
        return None
    p_uniq, p_cnt = np.unique(p_all, return_counts=True)
    cand = p_uniq[p_cnt >= MIN_SUPPORT]
    if len(cand) == 0:
        return None

    p_ins = x_at_op[ops_f == 1] - 1
    at = np.searchsorted(cand, p_ins)
    hit = (at < len(cand)) & (cand[np.minimum(at, len(cand) - 1)] == p_ins)
    ins_cap = np.bincount(at[hit], weights=lns_f[ops_f == 1][hit],
                          minlength=len(cand)).astype(np.int64)
    return cand, ins_cap


def _realign_native(ref, inp, cand, ins_cap, depth, errmod, threads):
    """The per-site work in one native call (pt_indel_sites), then
    _site_record over the sites that have entries."""
    from .. import trace
    from ..native import indel_sites_native
    from .caller import _BLUT

    raw = np.frombuffer(ref.encode(), dtype=np.uint8)
    ref_codes = _BLUT[raw].astype(np.uint8)
    ref_codes[(ref_codes == 4) & (raw != ord("N")) & (raw != ord("n"))] = 5
    jobs, out = indel_sites_native(inp, _BLUT[inp.seq], ref_codes, cand,
                                   ins_cap, threads)
    trace.count("jobs", jobs)
    ins = np.frombuffer(b"ACGT", np.uint8)[out["ins_codes"]].tobytes().decode()
    records = []
    for i in np.flatnonzero(out["status"] == 1).tolist():
        pos = int(cand[i])
        types = out["types"][i, : out["n_types"][i]].tolist()
        inscns = {ty: ins[a : a + ty]
                  for ty, a in zip(types, out["ins_at"][i].tolist())
                  if ty > 0}
        indel_types = out["slot_types"][i, : out["n_slots"][i]].tolist()
        ne = int(out["n_entries"][i])
        rec = _site_record(ref, pos, types, inscns, indel_types,
                           out["e_q"][i, :ne].astype(np.int64),
                           out["e_s"][i, :ne].astype(np.int64),
                           out["e_b"][i, :ne].astype(np.int64),
                           errmod, depth)
        if rec is not None:
            records.append(rec)
    return records


def _site_record(ref, pos, types, inscns, indel_types, eq, es, eb, errmod,
                 depth):
    """The tail of gap_prep + combine over one site's glfgen entries (eq,
    es, eb: q, strand, slot): errmod, PL/GT, est_indelreg and the allele
    strings, line for line as the JAX package's walk ends each site."""
    from .caller import SiteRecord, _het_phred

    # ---- errmod + combine (same machinery as the SNP column) ----
    DIAG, col_bsum, _cc = errmod.cal_arrays(eq, es, eb)
    qs = np.bincount(eb, weights=eq.astype(np.float64), minlength=4)
    adf = np.bincount(eb[es == 0], minlength=4)
    adr = np.bincount(eb[es != 0], minlength=4)
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
    for ty in types:
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
