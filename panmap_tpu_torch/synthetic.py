"""Synthetic workloads made from a seed: a placement index, a genome, and
reads simulated from a mutated copy of it, paired 150 bp reads
(make_workload) or single-end Nanopore-like long reads
(make_long_workload); a metagenomic mixture of five haplotypes over a
meta index (make_meta_workload, see its docstring); an ancient-DNA-like
sample over a meta index of many taxa for read assignment
(make_assign_workload); and a PanMAN file with samples of its leaves
(make_panman_workload and its long-read and meta variants).

The first four hand the port's stage functions an index in memory (the
first two with a stub tree).  Their default size is that of the sars_20000 demo: 39,999
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

The PanMAN workloads need no stub: write_panman writes a PanmanModel (a
tree in preorder with its blocks, gap runs and mutations) as the file
io/panman.py's load_panman decodes, make_panman_model draws such a tree at
the sars_20000 demo's size (its node count, genome length and index rows),
and the CLI builds its index from the file.
"""

from __future__ import annotations

import lzma
import os
import random
from dataclasses import dataclass

import numpy as np

from .index.builder import IndexArrays, IndexParams
from .io.refidx import _CapnpEncoder
from .meta.engine import sketch_meta_reads_full
from .meta.index import MetaIndexArrays
from .place.engine import sketch_reads
from .simulate import (
    ERROR_MODELS,
    INSERT_MEAN,
    INSERT_SD,
    READ_LEN,
    generate_reads,
    simulate_mutations,
)


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


def deep_preorder_parents(rng, n_nodes: int) -> np.ndarray:
    """Like random_preorder_parents, but each new node hangs off the node
    geometric(0.5) - 1 steps above the chain's end, so the depth is a
    critical random walk: ~180 on average and ~20,000 leaves at 39,999
    nodes, the shape of a binary tree of 20,000 genomes (the uniform pick
    gives depth <= 9 there)."""
    parent = np.zeros(n_nodes, np.uint32)
    chain = [0]
    ups = rng.geometric(0.5, n_nodes) - 1
    for i in range(1, n_nodes):
        d = max(len(chain) - 1 - int(ups[i]), 0)
        parent[i] = chain[d]
        del chain[d + 1:]
        chain.append(i)
    return parent


def _write_fastq(path: str, names, seqs, quals):
    with open(path, "w") as fh:
        fh.write("".join(f"@{n}\n{s}\n+\n{q}\n"
                         for n, s, q in zip(names, seqs, quals)))


def _write_pairs(out_dir: str, reads) -> tuple:
    """generate_reads' pairs as R1 / R2 FASTQ files in ``out_dir``."""
    os.makedirs(out_dir, exist_ok=True)
    r1 = os.path.join(out_dir, "reads_R1.fastq")
    r2 = os.path.join(out_dir, "reads_R2.fastq")
    names = [r[0] for r in reads]
    _write_fastq(r1, [n + "/1" for n in names], [r[1] for r in reads],
                 [r[2] for r in reads])
    _write_fastq(r2, [n + "/2" for n in names], [r[3] for r in reads],
                 [r[4] for r in reads])
    return r1, r2


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
    r1, r2 = _write_pairs(out_dir, reads)
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
    r1, seqs, junk = _long_reads(rng, pyrng, genome, out_dir, n_reads, len_lo,
                                 len_hi, err, junk_share, n_snp, n_ins, n_del,
                                 big_del)
    idx = _make_index(rng, seqs, n_nodes, rows_lo, rows_hi, read_share,
                      root_rows)
    return Workload(idx=idx, tree=GenomeTree(genome), reads1=r1, reads2="",
                    n_reads=n_reads, n_rows=int(idx.node_offsets[-1]),
                    junk=junk)


def _long_reads(rng, pyrng, genome: str, out_dir: str, n_reads: int,
                len_lo: int = 1000, len_hi: int = 1400, err: float = 0.02,
                junk_share: float = 0.01, n_snp: int = 30, n_ins: int = 4,
                n_del: int = 4, big_del: tuple = (150, 300)):
    """make_long_workload's sample of ``genome`` (see there), written as
    ``out_dir``/long_reads.fastq; returns (path, read sequences, names of
    the junk reads)."""
    acgt = np.frombuffer(b"ACGT", np.uint8)
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
    return r1, seqs, tuple(n for n, j in zip(names, junk) if j)


@dataclass
class MetaWorkload:
    midx: MetaIndexArrays
    reads1: str  # FASTQ paths
    reads2: str
    haplotypes: tuple  # node ids of the haplotype leaves
    proportions: tuple  # their true proportions, in the same order
    n_reads: int
    n_rows: int  # delta rows of the meta index


def _haplotype(genome: str, rows):
    """(haplotype, coords) rebuilt from simulate_mutations' VCF rows, with
    the genome coordinate each haplotype base came from (an inserted base
    takes its anchor's)."""
    parts, coords = [], []
    prev = 0
    for pos1, ref, alt in rows:
        a = pos1 - 1
        parts += [genome[prev:a], alt]
        coords += [np.arange(prev, a), np.full(len(alt), a)]
        prev = a + len(ref)
    parts.append(genome[prev:])
    coords.append(np.arange(prev, len(genome)))
    return "".join(parts), np.concatenate(coords).astype(np.int64)


def _seed_records(seq: str, coords: np.ndarray, p: IndexParams):
    """(pos, hash, rev, end) of a sequence's k-min-mers, sketched as reads
    are (sketch_meta_reads_full), placed in genome coordinates."""
    reads, _, _ = sketch_meta_reads_full([seq], p.k, p.s, p.t, p.l, p.open)
    r = reads[0]
    return (coords[r.qbeg], r.hashes.astype(np.uint64),
            np.asarray(r.revs, bool), coords[r.qend])


def _simulate_pairs(rng, haps: list, props, n_pairs: int, err: float):
    """Paired 150 bp reads as simulate.generate_reads makes them (normal
    insert size, uniform start, substitutions at rate ``err``, phred ~Q37,
    Q12-25 on errors), drawn from ``haps`` by ``props``, vectorised.
    Returns (r1 codes, r2 codes, r1 quals, r2 quals) as uint8 arrays."""
    codes = [np.searchsorted(np.frombuffer(b"ACGT", np.uint8),
                             np.frombuffer(h.encode(), np.uint8))
             for h in haps]
    lens = np.array([len(c) for c in codes])
    offs = np.concatenate(([0], np.cumsum(lens)[:-1]))
    allc = np.concatenate(codes).astype(np.uint8)
    hap = rng.choice(len(haps), n_pairs, p=np.asarray(props) / sum(props))
    ins = rng.normal(INSERT_MEAN, INSERT_SD, n_pairs).astype(np.int64)
    ins = np.minimum(np.maximum(ins, READ_LEN + 10), lens[hap])
    start = (rng.random(n_pairs) * (lens[hap] - ins + 1)).astype(np.int64)
    col = np.arange(READ_LEN)
    base = (offs[hap] + start)[:, None]
    r1 = allc[base + col]
    r2 = 3 - allc[base + ins[:, None] - READ_LEN + col][:, ::-1]
    out = []
    for r in (r1, r2):
        bad = rng.random(r.shape) < err
        r = np.where(bad, (r + rng.integers(1, 4, r.shape)) % 4, r)
        q = np.clip(rng.normal(37, 3, r.shape).astype(np.int64), 25, 40)
        q = np.where(bad, rng.integers(12, 26, r.shape), q)
        out.append((r.astype(np.uint8), (q + 33).astype(np.uint8)))
    return out[0][0], out[1][0], out[0][1], out[1][1]


def _write_fastq_codes(path: str, mate: int, codes, quals):
    acgt = np.frombuffer(b"ACGT", np.uint8)
    n, L = codes.shape
    seqs = acgt[codes].tobytes().decode()
    qs = quals.tobytes().decode()
    with open(path, "w") as fh:
        fh.write("".join(f"@sim_{i}/{mate}\n{seqs[i * L:(i + 1) * L]}\n+\n"
                         f"{qs[i * L:(i + 1) * L]}\n" for i in range(n)))


META_PROPORTIONS = (0.40, 0.25, 0.15, 0.12, 0.08)


def make_meta_workload(out_dir: str, seed: int = 0, n_nodes: int = 39999,
                       genome_len: int = 29903,
                       n_pairs: int = 200000) -> MetaWorkload:
    """A metagenomic sample of the shape of the reference's demo 2 (the
    sars_20000 PanMAN and a 200,000-pair mixture of five SARS-CoV-2
    haplotypes): a random ``genome_len`` bp genome; five haplotypes at
    META_PROPORTIONS, each mutated from the genome (simulate_mutations: 30
    SNPs, 2 insertions and 2 deletions of 1-9 bp); ``n_pairs`` read pairs
    of 150 bp with NovaSeq-like errors, each pair drawn from a haplotype by
    its proportion, written as R1/R2 FASTQ into ``out_dir``.

    The meta index (MetaIndexArrays, IndexParams() k 19, s 8, l 3) lies on
    a random DFS-preorder tree of ``n_nodes`` nodes whose depth is a
    critical random walk (deep_preorder_parents):
     - the root adds the genome's k-min-mers, sketched as reads are;
     - each haplotype sits at its own leaf (node id ``hap_<j>``), whose
       delta is its k-min-mer set against the state at its parent;
     - every other node deletes 1-9 present genome seeds and adds 1-9 new
       random ones (drawn apart), about 10 rows a node, consistent along
       every root-to-leaf path.
    Independent deletion and addition counts on a deep tree give the
    overlap coefficients enough distinct values that demo 2's top 1,000
    shared ranks hold ~1,500 nodes, not the whole tree.
    Seed positions are genome coordinates; the degap fields hold no gap or
    block event, so save_meta_index / load_meta_index round-trip it."""
    props = META_PROPORTIONS
    rng = np.random.default_rng(seed)
    pyrng = random.Random(seed)
    p = IndexParams()
    acgt = np.frombuffer(b"ACGT", np.uint8)
    genome = acgt[rng.integers(0, 4, genome_len)].tobytes().decode()
    haps, recs = [], [_seed_records(genome, np.arange(genome_len), p)]
    for _ in props:
        mutated, rows = simulate_mutations(genome, 30, 2, 2, (1, 9), pyrng)
        hap, coords = _haplotype(genome, rows)
        assert hap == mutated
        haps.append(hap)
        recs.append(_seed_records(hap, coords, p))

    r1, r2, q1, q2 = _simulate_pairs(rng, haps, props, n_pairs,
                                     ERROR_MODELS["NovaSeq"])
    os.makedirs(out_dir, exist_ok=True)
    path1 = os.path.join(out_dir, "meta_R1.fastq")
    path2 = os.path.join(out_dir, "meta_R2.fastq")
    _write_fastq_codes(path1, 1, r1, q1)
    _write_fastq_codes(path2, 2, r2, q2)

    parent = deep_preorder_parents(rng, n_nodes)
    has_child = np.zeros(n_nodes, bool)
    has_child[parent[1:]] = True
    leaves = np.flatnonzero(~has_child[1:]) + 1
    hap_nodes = rng.choice(leaves, len(props), replace=False)
    hap_of = {int(n): j for j, n in enumerate(hap_nodes)}
    n_dels, n_adds = rng.integers(1, 10, (2, n_nodes))
    n_dels[0] = n_dels[hap_nodes] = 0
    n_adds[0] = n_adds[hap_nodes] = 0
    n_new = int(n_adds.sum())
    recs.append((rng.integers(0, genome_len, n_new),
                 rng.integers(1, 1 << 62, n_new).astype(np.uint64),
                 rng.random(n_new) < 0.5, np.zeros(n_new, np.int64)))
    recs[-1] = recs[-1][:3] + (recs[-1][0] + 40,)

    # intern (pos, hash, rev) records into the seed table
    pos, hsh, rev, end = (np.concatenate(x) for x in zip(*recs))
    order = np.lexsort((rev, hsh, pos))
    sp, sh, sr = pos[order], hsh[order], rev[order]
    first = np.concatenate(([True], (sp[1:] != sp[:-1]) | (sh[1:] != sh[:-1])
                            | (sr[1:] != sr[:-1])))
    rid = np.empty(len(pos), np.int64)
    rid[order] = np.cumsum(first) - 1
    bounds = np.cumsum([0] + [len(r[0]) for r in recs])
    ids = [rid[bounds[i]:bounds[i + 1]] for i in range(len(recs))]
    base_ids, hap_ids, new_ids = ids[0], ids[1:-1], ids[-1]
    new_off = np.concatenate(([0], np.cumsum(n_adds)))

    # one preorder pass with an explicit root-to-node path keeps every
    # deletion on a present seed and every addition on an absent one
    count = np.zeros(int(first.sum()), np.int64)
    picks = rng.integers(0, len(base_ids), (n_nodes, 36))
    node_rows, path = [], []
    for i in range(n_nodes):
        while path and path[-1][0] != parent[i]:
            _, dels, adds = path.pop()
            count[dels] += 1
            count[adds] -= 1
        if i == 0:
            dels, adds = np.empty(0, np.int64), np.unique(base_ids)
        elif i in hap_of:
            cur = np.flatnonzero(count > 0)
            want = np.unique(hap_ids[hap_of[i]])
            dels = np.setdiff1d(cur, want)
            adds = np.setdiff1d(want, cur)
        else:
            got = []
            for b in picks[i]:
                s = int(base_ids[b])
                if len(got) == n_dels[i]:
                    break
                if count[s] > 0 and s not in got:
                    got.append(s)
            dels = np.array(got, np.int64)
            adds = new_ids[new_off[i]:new_off[i + 1]]
        count[dels] -= 1
        count[adds] += 1
        path.append((i, dels, adds))
        node_rows.append((dels, adds))

    delta_seed = np.concatenate([np.concatenate(x) for x in node_rows])
    delta_is_del = np.concatenate([np.repeat([True, False],
                                             [len(d), len(a)])
                                   for d, a in node_rows])
    offsets = np.zeros(n_nodes + 1, np.int64)
    offsets[1:] = np.cumsum([len(d) + len(a) for d, a in node_rows])
    node_ids = [f"node_{i}" for i in range(n_nodes)]
    for n, j in hap_of.items():
        node_ids[n] = f"hap_{j}"
    seed_end = np.empty(int(first.sum()), np.int64)
    seed_end[rid[::-1]] = end[::-1]  # the first occurrence's end
    midx = MetaIndexArrays(
        params=p, node_ids=node_ids, parent_index=parent,
        seed_hash=sh[first], seed_rev=sr[first], seed_pos=sp[first],
        delta_seed=delta_seed.astype(np.int32), delta_is_del=delta_is_del,
        node_offsets=offsets, seed_end=seed_end,
        gev_offsets=np.zeros(n_nodes + 1, np.int64),
        gev_pos=np.empty(0, np.int64), gev_nongap=np.empty(0, bool),
        bev_offsets=np.zeros(n_nodes + 1, np.int64),
        bev_block=np.empty(0, np.int32), bev_code=np.empty(0, np.int8),
        block_lo=np.zeros(1, np.int64),
        block_hi=np.full(1, genome_len - 1, np.int64),
        nongap0=np.packbits(np.ones(genome_len, np.uint8), bitorder="little"),
        n_scalar=genome_len)
    return MetaWorkload(midx=midx, reads1=path1, reads2=path2,
                        haplotypes=tuple(f"hap_{j}" for j in range(len(props))),
                        proportions=tuple(props), n_reads=2 * n_pairs,
                        n_rows=int(offsets[-1]))


@dataclass
class AssignWorkload:
    midx: MetaIndexArrays
    reads1: str  # FASTQ path (single-end)
    taxonomy: str  # metadata TSV: sample, species, genus
    taxa: tuple  # node ids of the leaves the target reads were drawn from
    n_reads: int
    n_target: int  # reads drawn from ``taxa``
    n_rows: int  # delta rows of the meta index


def _adna_reads(rng, sources: list, n_target: int, n_background: int,
                n_low: int, len_lo: int, len_hi: int):
    """(codes uint8 [n, len_hi], lengths, quals uint8 [n, len_hi]), shuffled:
    ``n_target`` fragments of ``len_lo``-``len_hi`` bp drawn uniformly from
    the code arrays in ``sources``, half reverse-complemented, then damaged
    as sequenced (C->T in the first four bases and G->A in the last four,
    each with probability 0.3, as tests/test_e2e.py draws ancient DNA);
    ``n_background`` random fragments; ``n_low`` low-complexity ones
    (repeats of a unit of 1-3 bases).  Phred 12 on the four bases of either
    end, 40 elsewhere."""
    n = n_target + n_background + n_low
    lens = rng.integers(len_lo, len_hi + 1, n)
    col = np.arange(len_hi)
    codes = rng.integers(0, 4, (n, len_hi)).astype(np.uint8)
    # target fragments
    slen = np.array([len(c) for c in sources])
    offs = np.concatenate(([0], np.cumsum(slen)[:-1]))
    allc = np.concatenate(sources).astype(np.uint8)
    src = rng.integers(0, len(sources), n_target)
    tl = lens[:n_target]
    start = (rng.random(n_target) * (slen[src] - tl + 1)).astype(np.int64)
    at = (offs[src] + start)[:, None] + np.minimum(col, tl[:, None] - 1)
    frag = allc[at]
    flip = rng.random(n_target) < 0.5
    back = np.maximum(tl[:, None] - 1 - col, 0)  # reversed column per read
    frag = np.where(flip[:, None], 3 - np.take_along_axis(frag, back, 1),
                    frag)
    hit = rng.random((n_target, len_hi)) < 0.3
    from_end = tl[:, None] - 1 - col
    frag = np.where(hit & (col < 4) & (frag == 1), 3, frag)  # C -> T
    frag = np.where(hit & (from_end >= 0) & (from_end < 4) & (frag == 2), 0,
                    frag)  # G -> A
    codes[:n_target] = frag
    # low-complexity fragments: a unit of 1-3 bases repeated
    unit = rng.integers(0, 4, (n_low, 3)).astype(np.uint8)
    period = rng.integers(1, 4, n_low)
    lo0 = n_target + n_background
    codes[lo0:] = np.take_along_axis(unit, col[None, :] % period[:, None], 1)
    quals = np.where((col < 4) | ((lens[:, None] - 1 - col) < 4), 12 + 33,
                     40 + 33).astype(np.uint8)
    order = rng.permutation(n)
    return codes[order], lens[order], quals[order]


def make_assign_workload(out_dir: str, seed: int = 0, n_clades: int = 400,
                         clade_nodes: int = 25, genome_len: int = 16500,
                         n_reads: int = 250_000, n_taxa: int = 10,
                         target_share: float = 0.035,
                         sister_genera: int = 4, low_share: float = 0.01,
                         len_lo: int = 35, len_hi: int = 120,
                         k: int = 15, s: int = 8, l: int = 1
                         ) -> AssignWorkload:
    """A filter-and-assign sample of the shape of the reference's demo 3
    (a mitochondrial PanMAN of many vertebrate taxa, ancient-DNA reads,
    ``-k 15 -s 8 -l 1``, a taxonomy TSV), written into ``out_dir``.

    The meta index lies on a tree of a root, genus nodes without seeds, and
    under each genus 1-3 clades ("species") of ``clade_nodes`` nodes: a
    clade's first node adds the seedmers of the clade's own random
    ``genome_len`` bp genome (mtDNA size), every other node those of its
    parent's sequence with 1-4 substitutions (each node is sketched as
    reads are; a node's rows are its seedmer set against its parent's).
    The first ``sister_genera`` genera hold two sister species 1% apart, so
    reads from their conserved stretches tie across species: their LCA is
    the genus node, and --maximum-taxon-number 1 at the species rank drops
    them.  Clade c's seeds lie at c * genome_len + their own coordinates.
    The taxonomy TSV maps every leaf to a ``species`` and a ``genus``.

    Reads (single-end FASTQ): ``len_lo``-``len_hi`` bp; a ``target_share``
    drawn from one leaf each of ``n_taxa`` species (both species of the
    first sister genus among them) with ancient-DNA damage (_adna_reads); a
    ``low_share`` of low-complexity repeats for --dust; the rest random
    background that hits no seed."""
    rng = np.random.default_rng(seed)
    p = IndexParams(k=k, s=s, l=l)
    acgt = np.frombuffer(b"ACGT", np.uint8)

    # the tree in preorder: root, then genus by genus, clade by clade
    sizes = [2] * sister_genera
    while sum(sizes) < n_clades:
        sizes.append(min(int(rng.integers(1, 4)), n_clades - sum(sizes)))
    parent, node_ids, genus_of, clade_lo = [0], ["root"], [], []
    for g, size in enumerate(sizes):
        gnode = len(parent)
        parent.append(0)
        node_ids.append(f"genus_{g}")
        for _ in range(size):
            c = len(clade_lo)
            lo = len(parent)
            local = random_preorder_parents(rng, clade_nodes).astype(np.int64)
            parent += [gnode] + (local[1:] + lo).tolist()
            node_ids += [f"sp{c}_n{j}" for j in range(clade_nodes)]
            genus_of.append(g)
            clade_lo.append(lo)
    n_nodes = len(parent)
    parent = np.array(parent, np.uint32)

    # node sequences: substitutions down each clade
    seq_codes = np.empty((n_clades * clade_nodes, genome_len), np.uint8)
    for c, lo in enumerate(clade_lo):
        rows = seq_codes[c * clade_nodes:(c + 1) * clade_nodes]
        if c < 2 * sister_genera and c % 2 == 1:  # 1% off its sister
            rows[0] = seq_codes[(c - 1) * clade_nodes]
            at = rng.choice(genome_len, genome_len // 100, replace=False)
            rows[0, at] = (rows[0, at] + rng.integers(1, 4, len(at))) % 4
        else:
            rows[0] = rng.integers(0, 4, genome_len)
        for j in range(1, clade_nodes):
            rows[j] = rows[int(parent[lo + j]) - lo]
            at = rng.choice(genome_len, int(rng.integers(1, 5)),
                            replace=False)
            rows[j, at] = (rows[j, at] + rng.integers(1, 4, len(at))) % 4
    text = acgt[seq_codes].tobytes().decode()
    seqs = [text[i * genome_len:(i + 1) * genome_len]
            for i in range(len(seq_codes))]
    del text
    sk, dup_index, _ = sketch_meta_reads_full(seqs, p.k, p.s, p.t, p.l,
                                              p.open)
    del seqs
    set_of = np.full(len(seq_codes), -1, np.int64)
    for u, members in enumerate(dup_index):
        set_of[np.asarray(members, np.int64)] = u
    if (set_of < 0).any():
        raise ValueError("a node's sequence has no seedmer: genome_len is "
                         "too small for k, s and l")

    # per clade: intern (pos, hash, rev) into seeds, rows against the parent
    seed_parts, rows_dels, rows_adds = [], {}, {}
    n_seeds = 0
    for c, lo in enumerate(clade_lo):
        recs = [sk[set_of[c * clade_nodes + j]] for j in range(clade_nodes)]
        pos = np.concatenate([r.qbeg for r in recs]) + c * genome_len
        end = np.concatenate([r.qend for r in recs]) + c * genome_len
        hsh = np.concatenate([r.hashes for r in recs]).astype(np.uint64)
        rev = np.concatenate([np.asarray(r.revs, bool) for r in recs])
        order = np.lexsort((rev, hsh, pos))
        sp, sh, sr = pos[order], hsh[order], rev[order]
        first = np.concatenate(([True], (sp[1:] != sp[:-1])
                                | (sh[1:] != sh[:-1]) | (sr[1:] != sr[:-1])))
        rid = np.empty(len(pos), np.int64)
        rid[order] = np.cumsum(first) - 1 + n_seeds
        seed_parts.append((sh[first], sr[first], sp[first],
                           end[order][first]))
        n_seeds += int(first.sum())
        bounds = np.cumsum([0] + [len(r.hashes) for r in recs])
        ids = [np.unique(rid[bounds[j]:bounds[j + 1]])
               for j in range(clade_nodes)]
        for j in range(clade_nodes):
            up = (ids[int(parent[lo + j]) - lo] if j
                  else np.empty(0, np.int64))
            rows_dels[lo + j] = np.setdiff1d(up, ids[j])
            rows_adds[lo + j] = np.setdiff1d(ids[j], up)

    none = np.empty(0, np.int64)
    node_rows = [(rows_dels.get(i, none), rows_adds.get(i, none))
                 for i in range(n_nodes)]
    delta_seed = np.concatenate([np.concatenate(x) for x in node_rows])
    delta_is_del = np.concatenate([np.repeat([True, False], [len(d), len(a)])
                                   for d, a in node_rows])
    offsets = np.zeros(n_nodes + 1, np.int64)
    offsets[1:] = np.cumsum([len(d) + len(a) for d, a in node_rows])
    n_scalar = n_clades * genome_len
    seed_hash, seed_rev, seed_pos, seed_end = (
        np.concatenate(x) for x in zip(*seed_parts))
    midx = MetaIndexArrays(
        params=p, node_ids=node_ids, parent_index=parent,
        seed_hash=seed_hash, seed_rev=seed_rev,
        seed_pos=seed_pos.astype(np.int64),
        delta_seed=delta_seed.astype(np.int32), delta_is_del=delta_is_del,
        node_offsets=offsets, seed_end=seed_end.astype(np.int64),
        gev_offsets=np.zeros(n_nodes + 1, np.int64),
        gev_pos=np.empty(0, np.int64), gev_nongap=np.empty(0, bool),
        bev_offsets=np.zeros(n_nodes + 1, np.int64),
        bev_block=np.empty(0, np.int32), bev_code=np.empty(0, np.int8),
        block_lo=np.zeros(1, np.int64),
        block_hi=np.full(1, n_scalar - 1, np.int64),
        nongap0=np.packbits(np.ones(n_scalar, np.uint8), bitorder="little"),
        n_scalar=n_scalar)

    # the taxonomy: every leaf names its species and its genus
    has_child = np.zeros(n_nodes, bool)
    has_child[parent[1:]] = True
    os.makedirs(out_dir, exist_ok=True)
    taxonomy = os.path.join(out_dir, "assign.meta.tsv")
    with open(taxonomy, "w") as fh:
        fh.write("sample\tspecies\tgenus\n")
        for c, lo in enumerate(clade_lo):
            for i in range(lo, lo + clade_nodes):
                if not has_child[i]:
                    fh.write(f"{node_ids[i]}\tspecies_{c}\t"
                             f"genus_{genus_of[c]}\n")

    # target taxa: both species of the first sister genus, then others
    clades = [0, 1] + (rng.choice(np.arange(2, n_clades), n_taxa - 2,
                                  replace=False).tolist()
                       if n_taxa > 2 else [])
    taxa_nodes = []
    for c in clades[:n_taxa]:
        lo = clade_lo[c]
        leaves = np.flatnonzero(~has_child[lo:lo + clade_nodes]) + lo
        taxa_nodes.append(int(rng.choice(leaves)))
    sources = [seq_codes[(n - clade_lo[c]) + c * clade_nodes]
               for n, c in zip(taxa_nodes, clades)]
    n_target = int(round(n_reads * target_share))
    n_low = int(round(n_reads * low_share))
    codes, lens, quals = _adna_reads(rng, sources, n_target,
                                     n_reads - n_target - n_low, n_low,
                                     len_lo, len_hi)
    st = acgt[codes].tobytes().decode()
    qt = quals.tobytes().decode()
    reads1 = os.path.join(out_dir, "assign_reads.fastq")
    with open(reads1, "w") as fh:
        fh.write("".join(
            f"@r{i}\n{st[i * len_hi:i * len_hi + n]}\n+\n"
            f"{qt[i * len_hi:i * len_hi + n]}\n"
            for i, n in enumerate(lens.tolist())))
    return AssignWorkload(midx=midx, reads1=reads1, taxonomy=taxonomy,
                          taxa=tuple(node_ids[n] for n in taxa_nodes),
                          n_reads=n_reads, n_target=n_target,
                          n_rows=int(offsets[-1]))


# ---- a PanMAN file, written from a seed ----------------------------------

# block mutation flags of a Mutation record (io/panman.py's wire layout)
BLOCK_MUT, BLOCK_INS, BLOCK_INV = 2, 4, 8
# panman's NucMutationType (the low bits of a NucMut's mutInfo)
NS, ND, NI, NSNPS = 0, 1, 2, 3
_BASE_OF_CODE = np.frombuffer(b"-ACMGRSVTWYHKDBN", np.uint8)
_ACGT_CODES = np.array([1, 2, 4, 8], np.uint8)
_COMPLEMENT_CODE = np.zeros(16, np.uint8)
_COMPLEMENT_CODE[[1, 2, 4, 8]] = [8, 4, 2, 1]


def pack_nuc_mut(mut_type: int, codes) -> int:
    """A NucMut's ``packed`` word: mutInfo (length << 4 | type) in the low
    byte, then the 1-6 codes as nibbles, the first base highest."""
    n = len(codes)
    if not 1 <= n <= 6:
        raise ValueError(f"a NucMut holds 1-6 bases, not {n}")
    word = (n << 4) | mut_type
    for i, c in enumerate(codes):
        word |= int(c) << (8 + 4 * (n - 1 - i))
    return word


@dataclass
class PanmanModel:
    """One PanMAN tree as write_panman writes it.

    names: node identifiers in DFS preorder (the root first); parent: each
    node's parent's preorder index (the root's is 0); blocks: each block's
    consensus as uint8 one-hot codes (A=1, C=2, G=4, T=8); gaps: [g, 3]
    int64 rows (block, slot, length), a run of ``length`` gap columns
    before main column ``slot`` (the GapList); block_muts: [b, 3] rows
    (node, block, flags), flags BLOCK_INS for an insertion (with BLOCK_INV
    inverted), BLOCK_INV for an inversion, 0 for a deletion; nuc_muts:
    [m, 5] rows (node, block, position, gap position or -1, packed) in the
    order a node applies them (by block, as the file groups them)."""

    names: list
    parent: np.ndarray
    blocks: list
    gaps: np.ndarray
    block_muts: np.ndarray
    nuc_muts: np.ndarray

    def __post_init__(self):
        self.index = {n: i for i, n in enumerate(self.names)}
        n = len(self.names)
        self._bm_off = np.searchsorted(self.block_muts[:, 0], np.arange(n + 1))
        self._nm_off = np.searchsorted(self.nuc_muts[:, 0], np.arange(n + 1))

    def leaves(self) -> list:
        has_child = np.zeros(len(self.names), bool)
        has_child[self.parent[1:]] = True
        return [self.names[i] for i in np.flatnonzero(~has_child)]

    def newick(self) -> str:
        """The topology with a branch length of 1 everywhere, built from
        the leaves up (a preorder index is above its parent's), without
        recursion: the tree may be hundreds of levels deep."""
        kids = [[] for _ in self.names]
        for i in range(1, len(self.names)):
            kids[int(self.parent[i])].append(i)
        text = [""] * len(self.names)
        for i in range(len(self.names) - 1, -1, -1):
            inner = (f"({','.join(text[c] for c in kids[i])})" if kids[i]
                     else "")
            text[i] = inner + self.names[i] + (":1" if i else "")
            for c in kids[i]:
                text[c] = ""
        return text[0] + ";"

    def get_string(self, identifier: str, aligned: bool = False) -> str:
        """The node's sequence from the model alone: each block switched
        on or off and turned along the path from the root, its consensus
        and gap runs overwritten by the path's mutations in order; a block
        that is off is left out, an inverted one reverse-complemented;
        ``aligned`` keeps the '-' columns of the blocks that are on."""
        path = [self.index[identifier]]
        while path[-1]:
            path.append(int(self.parent[path[-1]]))
        nb = len(self.blocks)
        on = np.zeros(nb, bool)
        fwd = np.ones(nb, bool)
        main = [b.copy() for b in self.blocks]
        runs = {(int(b), int(s)): np.zeros(int(n), np.uint8)
                for b, s, n in self.gaps}
        for node in reversed(path):
            for _, b, flags in self.block_muts[self._bm_off[node]:
                                               self._bm_off[node + 1]]:
                if flags & BLOCK_INS:
                    on[b], fwd[b] = True, not flags & BLOCK_INV
                elif flags & BLOCK_INV:
                    fwd[b] = not fwd[b]
                else:
                    on[b] = False
            for _, b, pos, gap, packed in self.nuc_muts[
                    self._nm_off[node]:self._nm_off[node + 1]]:
                n = (int(packed) & 0xFF) >> 4
                codes = [(int(packed) >> (8 + 4 * (n - 1 - i))) & 0xF
                         for i in range(n)]
                if gap < 0:
                    main[b][pos:pos + n] = codes
                else:
                    runs[(int(b), int(pos))][gap:gap + n] = codes
        out = []
        for b in range(nb):
            if not on[b]:
                continue
            parts = []
            for p in range(len(main[b]) + 1):
                if (b, p) in runs:
                    parts.append(runs[(b, p)])
                parts.append(main[b][p:p + 1])
            codes = np.concatenate(parts)
            if not fwd[b]:
                codes = _COMPLEMENT_CODE[codes[::-1]]
            if not aligned:
                codes = codes[codes != 0]
            out.append(_BASE_OF_CODE[codes].tobytes())
        return b"".join(out).decode()


def write_panman(path: str, model: PanmanModel):
    """Write ``model`` as an xz-compressed PanMAN file, the layout that
    io/panman.py's load_panman decodes:

      TreeGroup {ptrs: [List(Tree)]}
      Tree {ptrs: [newick Text, List(Node), List(ConsensusSeqToBlockIds),
                   List(GapList)]}
      Node {ptrs: [List(Mutation), annotations (null)]}, one record per
           node in preorder plus the trailing empty record
      Mutation {blockId << 32 @0, flags @8; ptrs: [List(NucMut)]}, one per
           block a node touches, every list of 2 data words and 1 pointer
           (the layout the vectorised decoder takes)
      NucMut {pos i32 @0, gapPos i32 @4, gapExist bit @8, packed u32 @12}
      ConsensusSeqToBlockIds {ptrs: [List(u64) blockId << 32, List(u32)
           8 codes a word, big nibble first, ended by a 0 code,
           List(bool) blockGapExist]}
      GapList {blockId << 32 @0; ptrs: [List(i32) lengths, List(i32)
           positions]} (the wire order, the reverse of the schema's)"""
    n = len(model.names)
    e = _CapnpEncoder()
    group = e.alloc(2)
    e.put_struct_ptr(0, group, 0, 2)
    tree = e.composite_list(group, 1, 0, 4)
    e.text(tree, model.newick())
    nodes = e.composite_list(tree + 1, n + 1, 0, 2)
    bm, nm = model.block_muts, model.nuc_muts
    gap = np.where(nm[:, 3] < 0, 0, nm[:, 3])
    nm_words = np.stack([
        (nm[:, 2] & 0xFFFFFFFF) | ((gap & 0xFFFFFFFF) << 32),
        (nm[:, 3] >= 0).astype(np.int64) | (nm[:, 4] << 32)], 1
    ).astype(np.uint64)
    for i in range(n):
        rows = np.arange(model._nm_off[i], model._nm_off[i + 1])
        flags = dict(zip(bm[model._bm_off[i]:model._bm_off[i + 1], 1].tolist(),
                         bm[model._bm_off[i]:model._bm_off[i + 1], 2].tolist()))
        touched = sorted(set(flags) | set(nm[rows, 1].tolist()))
        if not touched:
            continue
        rec = e.composite_list(nodes + 2 * i, len(touched), 2, 1)
        for r, b in enumerate(touched):
            at = rec + 3 * r
            e.words[at] = b << 32
            e.words[at + 1] = (flags.get(b, 0)
                               | (BLOCK_MUT if b in flags else 0))
            mine = rows[nm[rows, 1] == b]
            if len(mine):
                first = e.composite_list(at + 2, len(mine), 2, 0)
                e.words[first:first + 2 * len(mine)] = \
                    nm_words[mine].reshape(-1).tolist()
    cmap = e.composite_list(tree + 2, len(model.blocks), 0, 3)
    for b, cons in enumerate(model.blocks):
        codes = np.concatenate([cons, np.zeros(8 - len(cons) % 8, np.uint8)])
        words = (codes.reshape(-1, 8).astype(np.uint32)
                 << np.arange(28, -1, -4, dtype=np.uint32)).sum(1)
        e.prim_list(cmap + 3 * b, [b << 32], 5, 8)
        e.prim_list(cmap + 3 * b + 1, words, 4, 4)
        e.prim_list(cmap + 3 * b + 2, [0], 1, 1)  # one bit: False
    gap_blocks = np.unique(model.gaps[:, 0])
    glist = e.composite_list(tree + 3, len(gap_blocks), 1, 2)
    for j, b in enumerate(gap_blocks.tolist()):
        at = glist + 3 * j
        mine = model.gaps[model.gaps[:, 0] == b]
        e.words[at] = b << 32
        e.prim_list(at + 1, mine[:, 2], 4, 4)
        e.prim_list(at + 2, mine[:, 1], 4, 4)
    with lzma.open(path, "wb", preset=1) as fh:
        fh.write(e.message())


def make_panman_model(rng, n_nodes: int = 39999, genome_len: int = 29903,
                      n_blocks: int = 30,
                      indel_rate: float = 0.005) -> PanmanModel:
    """A PanMAN tree from ``rng``: deep_preorder_parents' shape (a binary
    tree of ~n_nodes / 2 genomes); a random root genome of ``genome_len``
    bp cut into ``n_blocks`` blocks of 0.5-1.5x the mean length, each the
    consensus of its block and switched on at the root; two gap runs of
    12 columns declared in every block.  Every other node carries 2-5 SNPs
    (NSNPS), with probability 0.4 a substitution of 2-6 bases (NS) and
    with probability ``indel_rate`` an indel of 1-9 bp: a deletion writes
    '-' over main columns (ND), an insertion writes bases into a declared
    gap run (NI).  One block is switched off at the root of one subtree
    and another inverted at the root of a second, disjoint one, each
    subtree 1-5% of the nodes.

    The SNP and substitution rates are fitted to the sars_20000 demo's
    index: at the default size and seed 0 the CLI's index parameters give
    2,436,878 rows (~61 a node), against the 2,422,142 rows that
    BENCH_r01.json's log records for the demo's tree."""
    gaps_per_block, gap_len, mnp_rate = 2, 12, 0.4
    parent = deep_preorder_parents(rng, n_nodes).astype(np.int64)
    weights = rng.uniform(0.5, 1.5, n_blocks)
    lens = np.floor(weights / weights.sum() * genome_len).astype(np.int64)
    lens[-1] += genome_len - lens.sum()
    boff = np.concatenate(([0], np.cumsum(lens)))
    block_of = np.repeat(np.arange(n_blocks), lens)
    cur = _ACGT_CODES[rng.integers(0, 4, genome_len)]
    blocks = [cur[boff[b]:boff[b + 1]].copy() for b in range(n_blocks)]
    gaps = np.array([(b, s, gap_len) for b in range(n_blocks)
                     for s in np.sort(rng.choice(np.arange(1, lens[b]),
                                                 gaps_per_block,
                                                 replace=False))],
                    np.int64).reshape(-1, 3)
    goff = np.concatenate(([0], np.cumsum(gaps[:, 2])))
    gcur = np.zeros(int(goff[-1]), np.uint8)

    # the block events, on two disjoint subtrees of 1-5% of the nodes
    size = np.ones(n_nodes, np.int64)
    for i in range(n_nodes - 1, 0, -1):
        size[parent[i]] += size[i]
    fit = np.flatnonzero((size >= max(2, n_nodes // 100))
                         & (size <= max(3, n_nodes // 20)))
    fit = fit[fit > 0]
    off_at = int(rng.choice(fit))
    fit = fit[(fit + size[fit] <= off_at) | (fit >= off_at + size[off_at])]
    inv_at = int(rng.choice(fit))
    off_block, inv_block = (int(b) for b in
                            rng.choice(np.arange(1, n_blocks - 1), 2,
                                       replace=False))
    block_muts = [(0, b, BLOCK_INS) for b in range(n_blocks)]
    block_muts += sorted([(off_at, off_block, 0), (inv_at, inv_block,
                                                   BLOCK_INV)])

    R = random.Random(int(rng.integers(1 << 62)))
    idx_of = np.zeros(16, np.int64)
    idx_of[_ACGT_CODES] = np.arange(4)
    rows, stack = [], [(0, [])]
    for i in range(1, n_nodes):
        while stack[-1][0] != parent[i]:
            for at, old in reversed(stack.pop()[1]):
                if at >= 0:
                    cur[at] = old
                else:
                    gcur[-at - 1] = old
        undo = []

        def substitute(g, n, mut_type):
            olds = cur[g:g + n]
            if (olds == 0).any() or block_of[g] != block_of[g + n - 1]:
                return
            new = _ACGT_CODES[(idx_of[olds] + [R.randrange(1, 4)
                                                for _ in range(n)]) % 4]
            undo.extend(zip(range(g, g + n), olds.tolist()))
            cur[g:g + n] = new
            b = int(block_of[g])
            rows.append((i, b, g - boff[b], -1, pack_nuc_mut(mut_type, new)))

        for _ in range(R.randint(2, 5)):
            substitute(R.randrange(genome_len), 1, NSNPS)
        if R.random() < mnp_rate:
            n = R.randint(2, 6)
            substitute(R.randrange(genome_len - n), n, NS)
        if R.random() < indel_rate:
            n = R.randint(1, 9)
            if R.random() < 0.5:
                g = R.randrange(genome_len - n)
                b = int(block_of[g])
                if block_of[g + n - 1] == b:
                    undo.extend(zip(range(g, g + n), cur[g:g + n].tolist()))
                    cur[g:g + n] = 0
                    for j in range(0, n, 6):
                        rows.append((i, b, g - boff[b] + j, -1,
                                     pack_nuc_mut(ND, [0] * min(6, n - j))))
            else:
                k = R.randrange(len(gaps))
                b, slot, glen = (int(x) for x in gaps[k])
                new = _ACGT_CODES[[R.randrange(4) for _ in range(min(n, glen))]]
                at = int(goff[k])
                undo.extend((-(at + j) - 1, int(gcur[at + j]))
                            for j in range(len(new)))
                gcur[at:at + len(new)] = new
                for j in range(0, len(new), 6):
                    rows.append((i, b, slot, j,
                                 pack_nuc_mut(NI, new[j:j + 6])))
        stack.append((i, undo))

    nuc = np.array(rows, np.int64).reshape(-1, 5)
    nuc = nuc[np.lexsort((nuc[:, 1], nuc[:, 0]))]  # stable: by node, block
    names = [f"node_{i}" for i in range(n_nodes)]
    has_child = np.zeros(n_nodes, bool)
    has_child[parent[1:]] = True
    for i in np.flatnonzero(~has_child):
        names[i] = f"S{i}/2020"  # leaves: sample names with a '/'
    return PanmanModel(names=names, parent=parent, blocks=blocks, gaps=gaps,
                       block_muts=np.array(block_muts, np.int64),
                       nuc_muts=nuc)


@dataclass
class PanmanWorkload:
    panman: str  # the written PanMAN file
    model: PanmanModel
    reads1: str  # FASTQ paths
    reads2: str
    leaf: str  # the leaf whose genome the reads were simulated from
    n_reads: int
    junk: tuple = ()  # names of reads that must come out unmapped
    haplotypes: tuple = ()  # meta: the leaves of the mixture
    proportions: tuple = ()  # and their true proportions


def make_panman_workload(out_dir: str, seed: int = 0, n_nodes: int = 39999,
                         genome_len: int = 29903, n_pairs: int = 51169,
                         n_blocks: int = 30) -> PanmanWorkload:
    """A PanMAN file (``out_dir``/tree.panman, make_panman_model's tree)
    and a sample of paired 150 bp reads simulated from a mutated copy of a
    random leaf's genome (30 SNPs, 4 insertions and 4 deletions), as
    make_workload simulates them."""
    rng = np.random.default_rng(seed)
    pyrng = random.Random(seed)
    model = make_panman_model(rng, n_nodes, genome_len, n_blocks)
    os.makedirs(out_dir, exist_ok=True)
    panman = os.path.join(out_dir, "tree.panman")
    write_panman(panman, model)
    leaves = model.leaves()
    leaf = leaves[int(rng.integers(len(leaves)))]
    sample, _ = simulate_mutations(model.get_string(leaf), 30, 4, 4, (1, 9),
                                   pyrng)
    reads = generate_reads(sample, n_pairs, ERROR_MODELS["NovaSeq"], pyrng)
    r1, r2 = _write_pairs(out_dir, reads)
    return PanmanWorkload(panman=panman, model=model, reads1=r1, reads2=r2,
                          leaf=leaf, n_reads=2 * n_pairs)


def make_panman_long_workload(w: PanmanWorkload, out_dir: str, seed: int = 0,
                              n_reads: int = 1000, **kw) -> PanmanWorkload:
    """Long reads on ``w``'s PanMAN file: a random leaf's genome mutated
    and read as make_long_workload reads (``kw``: its read options)."""
    rng = np.random.default_rng(seed)
    pyrng = random.Random(seed)
    leaves = w.model.leaves()
    leaf = leaves[int(rng.integers(len(leaves)))]
    r1, _, junk = _long_reads(rng, pyrng, w.model.get_string(leaf), out_dir,
                              n_reads, **kw)
    return PanmanWorkload(panman=w.panman, model=w.model, reads1=r1,
                          reads2="", leaf=leaf, n_reads=n_reads, junk=junk)


def make_panman_meta_workload(w: PanmanWorkload, out_dir: str, seed: int = 0,
                              n_pairs: int = 200000) -> PanmanWorkload:
    """A mixture on ``w``'s PanMAN file: ``n_pairs`` read pairs of 150 bp
    (_simulate_pairs, NovaSeq-like errors) from five random leaves' genomes
    at META_PROPORTIONS."""
    rng = np.random.default_rng(seed)
    leaves = w.model.leaves()
    haps = tuple(leaves[int(i)] for i in
                 rng.choice(len(leaves), len(META_PROPORTIONS),
                            replace=False))
    r1, r2, q1, q2 = _simulate_pairs(
        rng, [w.model.get_string(h) for h in haps], META_PROPORTIONS,
        n_pairs, ERROR_MODELS["NovaSeq"])
    os.makedirs(out_dir, exist_ok=True)
    path1 = os.path.join(out_dir, "meta_R1.fastq")
    path2 = os.path.join(out_dir, "meta_R2.fastq")
    _write_fastq_codes(path1, 1, r1, q1)
    _write_fastq_codes(path2, 2, r2, q2)
    return PanmanWorkload(panman=w.panman, model=w.model, reads1=path1,
                          reads2=path2, leaf=haps[0], n_reads=2 * n_pairs,
                          haplotypes=haps, proportions=META_PROPORTIONS)
