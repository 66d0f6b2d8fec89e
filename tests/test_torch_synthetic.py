"""The synthetic workloads that chip_smoke.py and the CPU tests drive the
port with (panmap_tpu_torch.synthetic), made from a seed.

 - make_workload's output for a seed is pinned: factoring its index code
   out for make_long_workload changed no byte of it;
 - make_long_workload, make_meta_workload and make_assign_workload have
   the shapes their docstrings state.
"""

import hashlib

import numpy as np

from panmap_tpu.meta.index import load_meta_index, save_meta_index
from panmap_tpu_torch.synthetic import (
    make_assign_workload,
    make_long_workload,
    make_meta_workload,
    make_workload,
)


def test_make_workload_output_is_pinned(tmp_path):
    w = make_workload(str(tmp_path), seed=3, n_nodes=40, genome_len=30000,
                      n_pairs=300)
    h = hashlib.sha256()
    for a in (w.idx.parent_index, w.idx.seed_hashes, w.idx.parent_counts,
              w.idx.child_counts, w.idx.node_offsets,
              w.idx.substitution_matrix):
        h.update(np.ascontiguousarray(a).tobytes())
    for path in (w.reads1, w.reads2):
        with open(path, "rb") as fh:
            h.update(fh.read())
    h.update(w.tree.genome.encode())
    assert (w.n_rows, w.n_reads) == (8353, 600)
    assert h.hexdigest() == ("f3cbb8305e4713dcdf5f746d747cd275"
                             "ab80e75418766cd5c8bb729c7d3dbced")


def _fastq(path):
    with open(path) as fh:
        lines = fh.read().split("\n")
    return lines[0::4][:-1], lines[1::4], lines[3::4]


def test_long_workload_shape(tmp_path):
    w = make_long_workload(str(tmp_path), seed=1, n_reads=300, n_nodes=50)
    names, seqs, quals = _fastq(w.reads1)
    assert len(names) == len(seqs) == len(quals) == w.n_reads == 300
    assert w.reads2 == "" and len(w.tree.genome) == 29903
    assert len(w.junk) == 3 and all(f"@{j}" in names for j in w.junk)
    # insertions and deletions balance: lengths stay near
    # the 1,000-1,400 bp drawn
    lens = np.array([len(s) for s in seqs])
    assert 900 < lens.min() and lens.max() < 1500
    assert 1150 < lens.mean() < 1250
    assert set("".join(seqs)) == set("ACGT")
    q = np.frombuffer("".join(quals).encode(), np.uint8) - 33
    assert q.min() == 10 and q.max() == 20
    assert len(w.idx.node_ids) == 50
    # about half the reads are reverse-complemented: count 25-mers of the
    # genome on each strand
    g = w.tree.genome
    rc = g[::-1].translate(str.maketrans("ACGT", "TGCA"))
    fwd = {g[i:i + 25] for i in range(0, len(g) - 25, 5)}
    rev = {rc[i:i + 25] for i in range(0, len(rc) - 25, 5)}
    strands = []
    for s in seqs:
        kms = {s[i:i + 25] for i in range(0, len(s) - 25)}
        strands.append((len(kms & fwd) > 0, len(kms & rev) > 0))
    n_fwd = sum(f and not r for f, r in strands)
    n_rev = sum(r and not f for f, r in strands)
    assert n_fwd + n_rev == 297  # every read but the junk
    assert 100 < n_fwd < 200


def test_meta_workload_shape(tmp_path):
    """Reads, haplotype leaves, consistent deltas, a save/load round trip."""
    w = make_meta_workload(str(tmp_path), seed=2, n_nodes=400,
                           genome_len=6000, n_pairs=3000)
    m = w.midx
    n1, s1, q1 = _fastq(w.reads1)
    n2, s2, _ = _fastq(w.reads2)
    assert len(n1) == len(n2) == 3000 == w.n_reads // 2
    assert n1[7] == "@sim_7/1" and n2[7] == "@sim_7/2"
    assert {len(s) for s in s1 + s2} == {150} and set("".join(s1)) == set(
        "ACGT")
    q = np.frombuffer("".join(q1).encode(), np.uint8) - 33
    assert q.min() >= 12 and q.max() <= 40
    assert w.proportions == (0.40, 0.25, 0.15, 0.12, 0.08)
    # each haplotype is a leaf; every other node holds ~10 delta rows
    parent = m.parent_index.astype(np.int64)
    has_child = np.zeros(len(parent), bool)
    has_child[parent[1:]] = True
    hap = [m.node_ids.index(h) for h in w.haplotypes]
    assert not has_child[hap].any() and len(set(hap)) == 5
    rows = np.diff(m.node_offsets)
    other = np.setdiff1d(np.arange(1, len(parent)), hap)
    assert 8 < rows[other].mean() < 12 and rows[0] > 1000
    assert w.n_rows == m.node_offsets[-1] == len(m.delta_seed)
    # replayed in preorder, a deletion always hits a present seed and an
    # addition an absent one
    count = np.zeros(len(m.seed_hash), np.int64)
    path = []
    for i in range(len(parent)):
        while path and path[-1][0] != parent[i]:
            _, sl, dl = path.pop()
            count[sl] += np.where(dl, 1, -1)
        sl = m.delta_seed[m.node_offsets[i]:m.node_offsets[i + 1]]
        dl = m.delta_is_del[m.node_offsets[i]:m.node_offsets[i + 1]]
        assert (count[sl[dl]] == 1).all() and (count[sl[~dl]] == 0).all()
        count[sl] += np.where(dl, -1, 1)
        path.append((i, sl, dl))
    # the tree is deep (a critical random walk), not bushy
    depth = np.zeros(len(parent), np.int64)
    for i in range(1, len(parent)):
        depth[i] = depth[parent[i]] + 1
    assert depth.max() > 15
    path = str(tmp_path / "x.ptmidx.npz")
    save_meta_index(path, m)
    back = load_meta_index(path)
    for f in ("parent_index", "seed_hash", "seed_rev", "seed_pos", "seed_end",
              "delta_seed", "delta_is_del", "node_offsets", "nongap0"):
        assert np.array_equal(getattr(back, f), getattr(m, f)), f
    assert back.node_ids == m.node_ids


def test_assign_workload_shape(tmp_path):
    """A root, genus nodes without rows, species of ``clade_nodes`` nodes
    whose rows are consistent along every path (a deletion removes a present
    seed, an addition an absent one); sister species share most seedmer
    hashes; the taxonomy names every leaf; reads of 35-120 bp, the target
    share drawn from the named taxa, some of them damaged at the ends."""
    from panmap_tpu.meta.assign import load_taxonomy
    from panmap_tpu_torch.meta.engine import dust_score

    w = make_assign_workload(str(tmp_path), seed=5, n_clades=7,
                             clade_nodes=8, genome_len=1500, n_reads=2000,
                             n_taxa=3, sister_genera=2, target_share=0.4,
                             low_share=0.05)
    m = w.midx
    n = len(m.node_ids)
    parent = m.parent_index.astype(np.int64)
    genera = [i for i, nm in enumerate(m.node_ids) if nm.startswith("genus_")]
    assert m.node_ids[0] == "root" and n == 1 + len(genera) + 7 * 8
    assert (m.params.k, m.params.s, m.params.l) == (15, 8, 1)
    assert all(parent[g] == 0 for g in genera)
    assert (parent[1:] < np.arange(1, n)).all()  # preorder numbering
    offs = m.node_offsets
    assert all(offs[g] == offs[g + 1] for g in [0] + genera)
    assert w.n_rows == offs[-1] == len(m.delta_seed)
    # replay every root-to-node path: presence stays 0/1
    present = [None] * n
    for i in range(n):
        cur = set() if i == 0 else set(present[parent[i]])
        for r in range(int(offs[i]), int(offs[i + 1])):
            sid = int(m.delta_seed[r])
            if m.delta_is_del[r]:
                assert sid in cur
                cur.remove(sid)
            else:
                assert sid not in cur
                cur.add(sid)
        present[i] = cur
    first = {nm: i for i, nm in enumerate(m.node_ids)}

    def hashes(name):
        return {int(m.seed_hash[s]) for s in present[first[name]]}

    a, b, c = hashes("sp0_n0"), hashes("sp1_n0"), hashes("sp4_n0")
    assert len(a) > 200 and len(a & b) > 0.6 * len(a)  # sisters, 1% apart
    assert len(a & c) < 0.05 * len(a)  # unrelated species
    # positions: clade c lies in its own block of the coordinate space
    sp4 = np.array(sorted(present[first["sp4_n0"]]))
    assert (m.seed_pos[sp4] // 1500 == 4).all()
    assert (m.seed_end[sp4] >= m.seed_pos[sp4]).all()
    # round trip through the JAX package's file format
    path = str(tmp_path / "a.ptmidx.npz")
    save_meta_index(path, m)
    back = load_meta_index(path)
    assert np.array_equal(back.delta_seed, m.delta_seed)
    assert back.node_ids == m.node_ids

    is_parent = np.zeros(n, bool)
    is_parent[parent[1:]] = True
    for rank in ("species", "genus"):
        sample_to_taxon, taxa = load_taxonomy(w.taxonomy, rank)
        assert set(sample_to_taxon) == {nm for i, nm in enumerate(m.node_ids)
                                        if not is_parent[i]}
        assert len(taxa) == (7 if rank == "species" else len(genera))
    assert sample_to_taxon["sp0_n7"] == sample_to_taxon["sp1_n7"]  # genus
    assert len(w.taxa) == 3 and w.taxa[0].startswith("sp0_")
    assert w.taxa[1].startswith("sp1_")
    assert not any(is_parent[first[t]] for t in w.taxa)

    names, seqs, quals = _fastq(w.reads1)
    assert len(seqs) == w.n_reads == 2000 and w.n_target == 800
    lens = np.array([len(s) for s in seqs])
    assert lens.min() >= 35 and lens.max() <= 120
    assert all(len(s) == len(q) for s, q in zip(seqs, quals))
    assert set(quals[0][:4] + quals[0][-4:]) == {"-"} and quals[0][5] == "I"
    low = sum(dust_score(s) > 5 for s in seqs)
    assert 90 <= low <= 140  # the 100 repeats, and a random read or two
    # the target reads come from the taxa's sequences: 35-mers of them (the
    # middle of a read carries no damage) are found in the index's k-mers
    # only indirectly, so count reads that share a seedmer hash with a taxon
    from panmap_tpu_torch.meta.engine import sketch_meta_reads_full

    p = m.params
    reads, dup, _ = sketch_meta_reads_full(seqs, p.k, p.s, p.t, p.l, p.open)
    taxa_h = set().union(*(hashes(t) for t in w.taxa))
    hit = sum(len(d) for r, d in zip(reads, dup)
              if len(set(r.hashes.tolist()) & taxa_h) >= 0.6 * len(r.hashes))
    assert 0.8 * w.n_target <= hit <= 1.02 * w.n_target
