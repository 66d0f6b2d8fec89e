"""Synthetic single-sample workloads made from a seed: a placement index,
a genome, and reads simulated from a mutated copy of it, paired 150 bp
reads (make_workload) or single-end Nanopore-like long reads
(make_long_workload).

The repo bundles no PanMAN file and has no PanMAN writer, so chip_smoke.py
and the CPU tests drive the port's stage functions with this workload
instead of the CLI.  Its default size is that of the sars_20000 demo: 39,999
tree nodes, ~2.42 M index rows (~60 per node), a 29,903 bp genome and
51,169 read pairs of 150 bp (102,338 reads).

 - The tree is a random DFS-preorder tree, built the way
   tests/test_tpu_paths.py builds its large stress index.
 - Index rows draw a share of their hashes from the reads' own k-min-mer
   sketch, so placement finds real rows; the rest are random.  The root
   holds ``root_rows`` seeds of its own genome (parent count 0), the other
   nodes random count changes.
 - The genome is mutated with SNPs and indels
   (panmap_tpu.simulate.simulate_mutations) and reads are simulated from
   the mutated copy (simulate.generate_reads); aligned back to the original
   genome, reads across an indel need the full-window DP, which is where the
   banded-SW kernel runs.
 - ``tree`` is a stub whose get_string returns the original genome for every
   node (the stub tests/test_align_columnar.py uses).
"""

from __future__ import annotations

import os
import random
from dataclasses import dataclass

import numpy as np

from panmap_tpu.index.builder import IndexArrays, IndexParams
from panmap_tpu.place.engine import sketch_reads
from panmap_tpu.simulate import ERROR_MODELS, generate_reads, simulate_mutations


class GenomeTree:
    """Tree stub: every node's sequence is the same genome."""

    def __init__(self, genome: str):
        self.genome = genome

    def get_string(self, node) -> str:
        return self.genome


@dataclass
class Workload:
    idx: IndexArrays
    tree: GenomeTree
    reads1: str  # FASTQ paths
    reads2: str
    n_reads: int
    n_rows: int
    junk: tuple = ()  # names of reads that must come out unmapped


def random_preorder_parents(rng, n_nodes: int) -> np.ndarray:
    """Parent array of a random tree numbered in DFS preorder: each new node
    hangs off a random node of the current root-to-leaf chain."""
    parent = np.zeros(n_nodes, np.uint32)
    chain = [0]
    picks = rng.random(n_nodes)
    for i in range(1, n_nodes):
        d = int(picks[i] * len(chain))
        parent[i] = chain[d]
        del chain[d + 1:]
        chain.append(i)
    return parent


def _write_fastq(path: str, names, seqs, quals):
    with open(path, "w") as fh:
        fh.write("".join(f"@{n}\n{s}\n+\n{q}\n"
                         for n, s, q in zip(names, seqs, quals)))


def make_workload(out_dir: str, seed: int = 0, n_nodes: int = 39999,
                  rows_lo: int = 30, rows_hi: int = 92,
                  genome_len: int = 29903, n_pairs: int = 51169,
                  n_snp: int = 30, n_ins: int = 4, n_del: int = 4,
                  read_share: float = 0.3, root_rows: int = 6000) -> Workload:
    """Build the workload; FASTQ files go to ``out_dir``."""
    rng = np.random.default_rng(seed)
    pyrng = random.Random(seed)
    genome = "".join(np.array(list("ACGT"))[rng.integers(0, 4, genome_len)])
    sample, _ = simulate_mutations(genome, n_snp, n_ins, n_del, (1, 9), pyrng)
    reads = generate_reads(sample, n_pairs, ERROR_MODELS["NovaSeq"], pyrng)
    os.makedirs(out_dir, exist_ok=True)
    r1 = os.path.join(out_dir, "reads_R1.fastq")
    r2 = os.path.join(out_dir, "reads_R2.fastq")
    names = [r[0] for r in reads]
    _write_fastq(r1, [n + "/1" for n in names], [r[1] for r in reads],
                 [r[2] for r in reads])
    _write_fastq(r2, [n + "/2" for n in names], [r[3] for r in reads],
                 [r[4] for r in reads])

    idx = _make_index(rng, [r[1] for r in reads] + [r[3] for r in reads],
                      n_nodes, rows_lo, rows_hi, read_share, root_rows)
    return Workload(idx=idx, tree=GenomeTree(genome), reads1=r1, reads2=r2,
                    n_reads=2 * n_pairs, n_rows=int(idx.node_offsets[-1]))


def _make_index(rng, seqs, n_nodes, rows_lo, rows_hi, read_share,
                root_rows) -> IndexArrays:
    """The placement index: ``n_nodes`` nodes of ``rows_lo``-``rows_hi``
    rows (the root ``root_rows``), a ``read_share`` of whose hashes come
    from the k-min-mer sketch of ``seqs``."""
    params = IndexParams()
    freq = sketch_reads(seqs, params.k, params.s, params.t, params.l,
                        params.open)
    read_h = (np.unique(freq[0]) if isinstance(freq, tuple)
              else np.array(sorted(freq), dtype=np.uint64))

    parent = random_preorder_parents(rng, n_nodes)
    rows = rng.integers(rows_lo, rows_hi, n_nodes)
    rows[0] = root_rows
    offs = np.zeros(n_nodes + 1, np.uint64)
    offs[1:] = np.cumsum(rows)
    T = int(offs[-1])
    hashes = rng.integers(1, 1 << 62, T).astype(np.uint64)
    from_reads = rng.random(T) < read_share
    from_reads[:root_rows] = rng.random(root_rows) < 0.8
    hashes[from_reads] = read_h[rng.integers(0, len(read_h),
                                             int(from_reads.sum()))]
    pc = rng.integers(0, 4, T).astype(np.int16)
    cc = rng.integers(0, 4, T).astype(np.int16)
    # the root's rows are its genome's seeds (absent in the empty parent), so
    # every node's genome magnitude carries that positive baseline, as in a
    # built index; without it a random walk of child deltas can cancel the
    # magnitude to ~0, where f32 and f64 scores part by up to 1.0
    pc[:root_rows] = 0
    cc[:root_rows] = rng.integers(1, 4, root_rows)
    # a substitution spectrum with transitions 3x transversions
    sub = np.full((4, 4), 1e-4)
    for a, b in ((0, 2), (2, 0), (1, 3), (3, 1)):
        sub[a, b] = 3e-4
    np.fill_diagonal(sub, 0.999)
    return IndexArrays(
        params=params, node_ids=[f"node_{i}" for i in range(n_nodes)],
        parent_index=parent, identical_to_parent=np.zeros(n_nodes, bool),
        block_ranges=np.zeros((1, 2), np.uint32), seed_hashes=hashes,
        parent_counts=pc, child_counts=cc, node_offsets=offs,
        substitution_matrix=sub.reshape(-1))


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


def make_long_workload(out_dir: str, seed: int = 0, n_reads: int = 5000,
                       n_nodes: int = 39999, rows_lo: int = 30,
                       rows_hi: int = 92, genome_len: int = 29903,
                       len_lo: int = 1000, len_hi: int = 1400,
                       err: float = 0.02, junk_share: float = 0.01,
                       n_snp: int = 30, n_ins: int = 4, n_del: int = 4,
                       big_del: tuple = (150, 300), read_share: float = 0.3,
                       root_rows: int = 6000) -> Workload:
    """A single-end long-read sample (FASTQ in ``out_dir``): Nanopore-like
    reads of ``len_lo``-``len_hi`` bp, like the 1,200 bp tiled amplicons of
    the Midnight protocol (Freed et al., 2020, Biology Methods and
    Protocols), with ``err`` errors per base (40% substitutions, 30%
    deletions, 30% insertions), half of them reverse-complemented, phred
    Q10-Q20, and a ``junk_share`` of random reads (at least one; ``junk``
    names them), which must come out unmapped.  The sample genome carries
    SNPs and short indels (simulate_mutations) plus one deletion of
    ``big_del`` bp, which reads across it align through the long-gap tier.
    The index has make_workload's shape, its read share drawn from these
    reads.

    The default error rate, 2%, is that of current Nanopore chemistry
    (R10.4.1).  At an R9.4.1-like 6%, the host genotyper that both packages
    share spends ~20 minutes in its indel realignment on 5,000 reads and
    calls no variant (PERF.md, ROADMAP C)."""
    rng = np.random.default_rng(seed)
    pyrng = random.Random(seed)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    genome = acgt[rng.integers(0, 4, genome_len)].tobytes().decode()
    sample, _ = simulate_mutations(genome, n_snp, n_ins, n_del, (1, 9), pyrng)
    d = int(rng.integers(big_del[0], big_del[1] + 1))
    p = int(rng.integers(len(sample) // 4, 3 * len(sample) // 4))
    sample = sample[:p] + sample[p + d:]
    scodes = np.frombuffer(sample.encode(), np.uint8)
    scodes = np.searchsorted(acgt, scodes).astype(np.int64)
    lens = rng.integers(len_lo, len_hi + 1, n_reads)
    junk = np.zeros(n_reads, bool)
    if junk_share > 0:
        junk[rng.choice(n_reads, max(1, round(n_reads * junk_share)),
                        replace=False)] = True
    names, seqs, quals = [], [], []
    for i in range(n_reads):
        L = int(lens[i])
        if junk[i]:
            codes = rng.integers(0, 4, L)
            names.append(f"junk_{i}")
        else:
            s0 = int(rng.integers(0, len(scodes) - L + 1))
            codes = _ont_errors(rng, scodes[s0 : s0 + L], err)
            if rng.random() < 0.5:
                codes = 3 - codes[::-1]  # reverse complement (A,C,G,T = 0-3)
            names.append(f"read_{i}")
        seqs.append(acgt[codes].tobytes().decode())
        quals.append((rng.integers(10, 21, len(codes)) + 33)
                     .astype(np.uint8).tobytes().decode())
    os.makedirs(out_dir, exist_ok=True)
    r1 = os.path.join(out_dir, "long_reads.fastq")
    _write_fastq(r1, names, seqs, quals)
    idx = _make_index(rng, seqs, n_nodes, rows_lo, rows_hi, read_share,
                      root_rows)
    return Workload(idx=idx, tree=GenomeTree(genome), reads1=r1, reads2="",
                    n_reads=n_reads, n_rows=int(idx.node_offsets[-1]),
                    junk=tuple(n for n, j in zip(names, junk) if j))
