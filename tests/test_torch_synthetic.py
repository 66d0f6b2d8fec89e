"""The synthetic workloads that chip_smoke.py and the CPU tests drive the
port with (panmap_tpu_torch.synthetic), made from a seed.

 - make_workload's output for a seed is pinned: factoring its index code
   out for make_long_workload changed no byte of it;
 - make_long_workload and make_meta_workload have the shapes their
   docstrings state.
"""

import hashlib

import numpy as np

from panmap_tpu.meta.index import load_meta_index, save_meta_index
from panmap_tpu_torch.synthetic import (
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
