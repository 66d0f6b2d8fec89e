"""Plain checks of a sample's outputs: the pileup tallies of given
columns, and the true genome's tiles that a consensus lacks."""

from __future__ import annotations

import numpy as np


def tallies(col_id, g_q, g_s, g_b, ncol: int):
    """Per-column base counts [ncol, 5] (code 4 and above counted as N),
    quality sums [ncol, 4] and forward / reverse strand depths [ncol, 4]
    of the bases of ACGT, as bcftools fills them walking a pileup."""
    col_id = np.asarray(col_id, np.int64)
    g_b = np.asarray(g_b, np.int64)
    g_q = np.asarray(g_q, np.int64)
    g_s = np.asarray(g_s, np.int64)
    bcf = np.bincount(col_id * 5 + np.minimum(g_b, 4),
                      minlength=ncol * 5).reshape(ncol, 5)
    v = g_b < 4
    cb = col_id[v] * 4 + g_b[v]
    qs = np.bincount(cb, weights=g_q[v], minlength=ncol * 4).reshape(ncol, 4)
    adf = np.bincount(cb[g_s[v] == 0], minlength=ncol * 4).reshape(ncol, 4)
    adr = np.bincount(cb[g_s[v] == 1], minlength=ncol * 4).reshape(ncol, 4)
    return bcf, qs, adf, adr


def missing_tiles(consensus: str, truth: str, rows, tile: int = 41,
                  near: int = 50, margin: int = 500) -> int:
    """How many of the true genome's tiles the consensus lacks.

    ``truth`` is a genome with the planted mutations ``rows`` ((1-based
    position, ref, alt) in the unmutated genome's coordinates, sorted).
    The tiles are ``tile``-base pieces of ``truth`` laid end to end,
    ``margin`` bases in from either end, leaving out those within ``near``
    bases of a planted indel or of a SNP that has another mutation within
    ``near`` bases: where its reads cover it well, the consensus holds
    every other tile as it is, each isolated SNP included."""
    spans, at = [], 0
    for pos1, ref, alt in rows:
        start = pos1 - 1 + at
        spans.append((pos1, start, start + len(alt), len(ref) == len(alt)))
        at += len(alt) - len(ref)
    out = []
    for i, (pos1, a, b, snp) in enumerate(spans):
        alone = all(abs(pos1 - q) > near for j, (q, *_) in enumerate(spans)
                    if j != i)
        if not (snp and alone):
            out.append((a - near, b + near))
    missing = 0
    for t0 in range(margin, len(truth) - margin - tile + 1, tile):
        if any(a < t0 + tile and t0 < b for a, b in out):
            continue
        missing += consensus.find(truth[t0:t0 + tile]) < 0
    return missing


def vcf_calls(path: str) -> list:
    """(chrom, 1-based position, ref, called allele) of each record of a
    VCF whose genotype names an alternate allele."""
    out = []
    with open(path) as fh:
        for ln in fh:
            if ln.startswith("#"):
                continue
            f = ln.rstrip("\n").split("\t")
            gt = f[9].split(":")[0]
            if not gt.isdigit() or int(gt) == 0:
                continue
            alts = f[4].split(",")
            if int(gt) > len(alts):
                continue
            out.append((f[0], int(f[1]), f[3], alts[int(gt) - 1]))
    return out


def normalize(genome: str, pos1: int, ref: str, alt: str):
    """A variant left-aligned and trimmed to its shortest form (Tan et al.
    2015): (0-based position, ref, alt), or None where ``ref`` does not
    match ``genome`` or the variant changes nothing."""
    p = pos1 - 1
    if genome[p:p + len(ref)] != ref or ref == alt:
        return None
    while True:
        moved = False
        if ref and alt and ref[-1] == alt[-1]:
            ref, alt, moved = ref[:-1], alt[:-1], True
        if (not ref or not alt) and p > 0:
            p -= 1
            ref, alt, moved = genome[p] + ref, genome[p] + alt, True
        if not moved:
            break
    while len(ref) > 1 and len(alt) > 1 and ref[0] == alt[0]:
        ref, alt, p = ref[1:], alt[1:], p + 1
    return p, ref, alt


def apply_calls(genome: str, calls) -> str:
    """``genome`` with the called alleles put in place of their reference
    bases, as bcftools consensus does: from the last position to the first,
    an indel before a SNP at its anchor base."""
    seq = list(genome)
    for _, pos1, ref, alt in sorted(
            calls, key=lambda c: (-c[1], len(c[2]) == len(c[3]) == 1)):
        seq[pos1 - 1:pos1 - 1 + len(ref)] = alt
    return "".join(seq)


def planted_missed(genome: str, rows, calls) -> tuple:
    """(SNPs, indels) among the planted ``rows`` that no call matches once
    both are normalized on ``genome``, the genome the sample was mutated
    from and the calls were made against."""
    called = {normalize(genome, pos1, ref, alt) for _, pos1, ref, alt in calls}
    snps = indels = 0
    for pos1, ref, alt in rows:
        if normalize(genome, pos1, ref, alt) not in called:
            if len(ref) == len(alt):
                snps += 1
            else:
                indels += 1
    return snps, indels
