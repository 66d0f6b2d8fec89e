"""Frozen copy of the long-read sample maker: _ont_errors and _long_reads
of panmap_tpu_torch/synthetic.py as of commit c577db3 (the reads of
make_panman_long_workload and chip_smoke.py's phase 17).  The draws are
the same, in the same order; _long_reads here also returns what it
planted and where each read came from, for the checks, and takes the
indel lengths from its caller.  simulate_mutations is the frozen one of
samples.py.  Nothing here imports the program.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np

from .samples import simulate_mutations


@dataclass
class LongSample:
    """What _long_reads made of a genome."""

    genome: str  # the sample's true genome
    rows: list  # simulate_mutations' rows, in the source genome's coordinates
    small: str  # the genome with those rows, before the large deletion
    big_del: tuple  # (0-based position in ``small``, length)
    starts: np.ndarray  # each read's first base on ``genome`` (-1: junk)
    lens: np.ndarray  # each read's length on ``genome``
    reverse: np.ndarray  # reads reverse-complemented
    junk: np.ndarray  # random reads


def _ont_errors(rng, codes: np.ndarray, err: float) -> np.ndarray:
    """Per-base errors at rate ``err``: 40% substitutions, 30% deletions,
    30% insertions after the base (tests/test_align_long.py::_mutate)."""
    u = rng.random(len(codes))
    sub = u < err * 0.4
    dele = (u >= err * 0.4) & (u < err * 0.7)
    ins = (u >= err * 0.7) & (u < err)
    out = codes.copy()
    out[sub] = rng.integers(0, 4, int(sub.sum()))
    reps = np.where(dele, 0, np.where(ins, 2, 1))
    out = np.repeat(out, reps)
    # the second copy of an inserted base becomes a random one
    second = np.cumsum(reps)[ins] - 1
    out[second] = rng.integers(0, 4, len(second))
    return out


def _long_reads(rng, pyrng, genome: str, path: str, n_reads: int,
                len_lo: int = 1000, len_hi: int = 1400, err: float = 0.02,
                junk_share: float = 0.01, n_snp: int = 30, n_ins: int = 4,
                n_del: int = 4, indel_len: tuple = (1, 9),
                big_del: tuple = (150, 300)) -> LongSample:
    """A single-end long-read sample of ``genome`` written to ``path``:
    the genome with SNPs and short indels (simulate_mutations) and one
    deletion of ``big_del`` bp; Nanopore-like reads of ``len_lo``-
    ``len_hi`` bp from uniform starts, with ``err`` errors per base (40%
    substitutions, 30% deletions, 30% insertions), half of them
    reverse-complemented, phred Q10-Q20; and a ``junk_share`` of random
    reads (at least one), named junk_<i>."""
    acgt = np.frombuffer(b"ACGT", np.uint8)
    small, rows = simulate_mutations(genome, n_snp, n_ins, n_del,
                                     tuple(indel_len), pyrng)
    d = int(rng.integers(big_del[0], big_del[1] + 1))
    p = int(rng.integers(len(small) // 4, 3 * len(small) // 4))
    sample = small[:p] + small[p + d:]
    scodes = np.frombuffer(sample.encode(), np.uint8)
    scodes = np.searchsorted(acgt, scodes).astype(np.int64)
    lens = rng.integers(len_lo, len_hi + 1, n_reads)
    junk = np.zeros(n_reads, bool)
    if junk_share > 0:
        junk[rng.choice(n_reads, max(1, round(n_reads * junk_share)),
                        replace=False)] = True
    starts = np.full(n_reads, -1, np.int64)
    reverse = np.zeros(n_reads, bool)
    names, seqs, quals = [], [], []
    for i in range(n_reads):
        L = int(lens[i])
        if junk[i]:
            codes = rng.integers(0, 4, L)
            names.append(f"junk_{i}")
        else:
            s0 = int(rng.integers(0, len(scodes) - L + 1))
            starts[i] = s0
            codes = _ont_errors(rng, scodes[s0 : s0 + L], err)
            if rng.random() < 0.5:
                codes = 3 - codes[::-1]  # reverse complement (A,C,G,T = 0-3)
                reverse[i] = True
            names.append(f"read_{i}")
        seqs.append(acgt[codes].tobytes().decode())
        quals.append((rng.integers(10, 21, len(codes)) + 33)
                     .astype(np.uint8).tobytes().decode())
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as fh:
        fh.write("".join(f"@{n}\n{s}\n+\n{q}\n"
                         for n, s, q in zip(names, seqs, quals)))
    return LongSample(genome=sample, rows=rows, small=small, big_del=(p, d),
                      starts=starts, lens=lens.astype(np.int64),
                      reverse=reverse, junk=junk)
