"""The plain reference under pmbench/reference/ agrees with the program on
CPU tensors at a tiny tree, and imports nothing of the program or JAX."""

import ast
import glob
import os
import random

import numpy as np
import pytest
import torch

from pmbench import manifest
from pmbench.frozen import panman as fpanman
from pmbench.frozen import samples as fsamples
from pmbench.reference import em as ref_em
from pmbench.reference import outputs as ref_out
from pmbench.reference import placement as ref_place
from pmbench.reference import seeds as ref_seeds
from pmbench.reference import sw as ref_sw

K, S, T, L, OPEN, FLANK = 19, 8, 0, 3, False, 250
ACGT = np.frombuffer(b"ACGT", np.uint8)


def test_reference_imports_neither_program_nor_jax():
    banned = {"jax", "jaxlib", "flax", "panmap_tpu", "panmap_tpu_torch"}
    for path in glob.glob(os.path.join(manifest.HERE, "reference", "*.py")):
        for node in ast.walk(ast.parse(open(path).read())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module] if not node.level else []
            for n in names:
                assert n.split(".")[0] not in banned, (path, n)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    from panmap_tpu_torch.index.builder import IndexParams, build_index
    from panmap_tpu_torch.io.panman import load_panman

    rng = np.random.default_rng(7)
    model = fpanman.make_panman_model(rng, n_nodes=500, genome_len=6000,
                                      n_blocks=8)
    path = str(tmp_path_factory.mktemp("tree") / "tree.panman")
    fpanman.write_panman(path, model)
    idx = build_index(load_panman(path), IndexParams(), workers=1)
    return model, idx


def index_counts(idx):
    """Each node's seed counts, replayed from the index's delta rows."""
    offs = idx.node_offsets.astype(np.int64)
    state = []
    for i in range(len(idx.node_ids)):
        d = dict(state[int(idx.parent_index[i])]) if i else {}
        for r in range(offs[i], offs[i + 1]):
            h, c = int(idx.seed_hashes[r]), int(idx.child_counts[r])
            if c:
                d[h] = c
            else:
                d.pop(h, None)
        state.append(d)
    return state


def test_genome_seeds_are_the_index_s(tree):
    model, idx = tree
    state = index_counts(idx)
    fixed = 0
    for i, name in enumerate(idx.node_ids):
        if not ref_place.mask_fixed(model, name, FLANK):
            continue
        fixed += 1
        h, c = ref_seeds.genome_seed_counts(model.get_string(name), K, S, T,
                                            L, OPEN, FLANK)
        assert dict(zip(h.tolist(), c.tolist())) == state[i], name
    assert fixed > 0.9 * len(idx.node_ids)


def sample_reads(model, seed, pairs=1500):
    rng = np.random.default_rng(seed)
    leaf = model.leaves()[3]
    c1, c2, _, _ = fsamples._simulate_pairs(
        rng, [model.get_string(leaf)], [1.0], pairs, fsamples.NOVASEQ_ERROR)
    return leaf, [ACGT[c].tobytes().decode() for c in (c1, c2)], c1, c2


def test_scores_are_the_programs(tree):
    from panmap_tpu_torch.place.engine import (
        prepare_read_sketch, score_nodes, sketch_reads)

    model, idx = tree
    leaf, (r1, r2), c1, c2 = sample_reads(model, 1)
    seqs = [r1[i:i + 150] for i in range(0, len(r1), 150)] + \
        [r2[i:i + 150] for i in range(0, len(r2), 150)]
    sk = prepare_read_sketch(sketch_reads(seqs, K, S, T, L, OPEN), K,
                             len(seqs))
    want = score_nodes(idx, sk)
    h, c = ref_seeds.read_seed_counts(ACGT[np.concatenate([c1, c2])], K, S,
                                      T, L, OPEN)
    table = ref_place.ReadTable(h, c, K)
    assert np.array_equal(table.hashes, sk.sorted_hashes)
    root = ref_seeds.genome_seed_counts(model.get_string(model.names[0]), K,
                                        S, T, L, OPEN, FLANK)
    for name in (leaf, model.names[0], model.names[5]):
        node = ref_seeds.genome_seed_counts(model.get_string(name), K, S, T,
                                            L, OPEN, FLANK)
        got = ref_place.node_scores(table, node, root)
        i = idx.node_ids.index(name)
        for m, metric in enumerate(ref_place.METRICS):
            assert got[metric] == pytest.approx(want.scores[i, m],
                                                rel=1e-12, abs=1e-15)


def test_sw_is_the_kernels_plain_version():
    from panmap_tpu_torch.align import sw

    g = torch.Generator().manual_seed(3)
    B, LQ, LW = 64, 150, 379
    r = torch.randint(0, 4, (B, LW), generator=g, dtype=torch.int8)
    off = torch.randint(0, LW - LQ, (B,), generator=g)
    q = torch.stack([r[b, o:o + LQ] for b, o in enumerate(off.tolist())])
    noise = torch.rand(B, LQ, generator=g) < 0.05
    q = torch.where(noise, torch.randint(0, 4, (B, LQ), generator=g,
                                         dtype=torch.int8), q).contiguous()
    q[1::2, 70:] = torch.roll(q[1::2, 70:], 3, 1)
    ql = torch.randint(100, LQ + 1, (B,), generator=g, dtype=torch.int32)
    q[torch.arange(LQ)[None] >= ql[:, None]] = 4
    assert torch.equal(ref_sw.banded_sw_scores(q, r, ql),
                       sw.banded_sw_scores_reference(q, r, ql))


def test_tallies_are_the_programs():
    from panmap_tpu_torch.genotype.caller import tally_columns_device

    rng = np.random.default_rng(4)
    n, ncol = 5000, 300
    args = (np.sort(rng.integers(0, ncol, n)), rng.integers(2, 41, n),
            rng.integers(0, 2, n), rng.integers(0, 6, n), ncol)
    for got, want in zip(tally_columns_device(*args, device="cpu"),
                         ref_out.tallies(*args)):
        assert np.array_equal(got, want)


def test_missing_tiles():
    rng = np.random.default_rng(5)
    g = ACGT[rng.integers(0, 4, 6000)].tobytes().decode()
    rows = [(2001, g[2000], "A" if g[2000] != "A" else "C")]
    truth = g[:2000] + rows[0][2] + g[2001:]
    assert ref_out.missing_tiles(truth, truth, rows) == 0
    assert ref_out.missing_tiles(g, truth, rows) == 1  # the SNP not called
    assert ref_out.missing_tiles(truth[:4000] + "T" + truth[4001:], truth,
                                 rows) >= 1


def test_em_residual_and_control():
    rng = np.random.default_rng(6)
    R, M = 4000, 6
    lens = rng.integers(8, 14, R)
    src = rng.choice(M, R, p=[0.4, 0.25, 0.15, 0.12, 0.05, 0.03])
    S = (lens[:, None] * (rng.random((R, M)) < 0.3)).astype(np.int64)
    S[np.arange(R), src] = lens
    w = np.ones(R)
    keep, groups, p64 = ref_em.em(torch.from_numpy(S), lens, w,
                                  torch.float64, 1e-9)
    assert ref_em.residual(S[:, keep], lens, w, p64) < 1e-8
    keep16, _, p16 = ref_em.em(torch.from_numpy(S), lens, w,
                               torch.bfloat16, 1e-5)
    assert ref_em.residual(S[:, keep16], lens, w, p16 / p16.sum()) > 1e-4


def test_calls_normalized_applied_and_matched(tmp_path):
    """Equivalent placements of an indel in a repeat normalize alike, the
    calls applied give the mutated genome, and a planted mutation that no
    call matches is counted by kind."""
    rng = np.random.default_rng(8)
    g = "".join("ACGT"[i] for i in rng.integers(0, 4, 3000))
    g = g[:1000] + "TAGCAATCA" + g[1009:]
    # the same deletion of AGCAAT written at two bases, and an insertion
    assert ref_out.normalize(g, 1001, "TAGCAAT", "T") == \
        ref_out.normalize(g, 1000, g[999] + "TAGCAA", g[999])
    truth, rows = fsamples.simulate_mutations(g, 6, 2, 2, (1, 9),
                                              random.Random(4))
    vcf = tmp_path / "x.vcf"
    with open(vcf, "w") as fh:
        fh.write("#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\ts\n")
        for pos1, ref, alt in rows:
            fh.write(f"n1\t{pos1}\t.\t{ref}\t{alt},N\t50\t.\tDP=9\tGT:PL\t1:0\n")
        fh.write("n1\t5\t.\tA\tC\t50\t.\tDP=9\tGT:PL\t0:0\n")  # not called
    calls = ref_out.vcf_calls(str(vcf))
    assert len(calls) == len(rows)
    assert ref_out.apply_calls(g, calls) == truth
    assert ref_out.planted_missed(g, rows, calls) == (0, 0)
    kinds = [len(r) == len(a) for _, r, a in rows]
    dropped = [c for c, snp in zip(calls, kinds) if snp]
    assert ref_out.planted_missed(g, rows, dropped) == (0, kinds.count(False))
