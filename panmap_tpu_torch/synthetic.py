"""Synthetic workloads made from a seed: a placement index, a genome, and
reads simulated from a mutated copy of it, paired 150 bp reads
(make_workload) or single-end Nanopore-like long reads
(make_long_workload); a metagenomic mixture of five haplotypes over a
meta index (make_meta_workload, see its docstring); and an ancient-DNA-like
sample over a meta index of many taxa for read assignment
(make_assign_workload).

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

from .index.builder import IndexArrays, IndexParams
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
