"""A PanMAN file written by panmap_tpu_torch.synthetic.write_panman: both
packages decode it, through their vectorised decoders, to the writer's
tree, and their index builders give equal arrays on it.

The tree (make_panman_model, 300 nodes, a 8 kb genome in 8 blocks) holds
every kind of record the writer emits: SNPs (NSNPS), substitutions of 2-6
bases (NS), deletions (ND) and insertions into declared gap runs (NI) of
1-9 bp, the root's block insertions, a block switched off in one subtree
and a block inverted in another.
"""

import filecmp
import lzma
import os
from unittest import mock

import numpy as np
import pytest

from panmap_tpu.index import builder as jax_builder
from panmap_tpu.io import index_io as jax_index_io
from panmap_tpu.io import panman as jax_panman
from panmap_tpu.meta import index as jax_meta_index
from panmap_tpu_torch import synthetic
from panmap_tpu_torch.index import builder
from panmap_tpu_torch.io import index_io
from panmap_tpu_torch.io import panman
from panmap_tpu_torch.io.capnp import CapnpMessage
from panmap_tpu_torch.meta import index as meta_index

PACKAGES = {"torch": panman, "jax": jax_panman}
N_NODES, GENOME_LEN = 300, 8000


@pytest.fixture(scope="module")
def written(tmp_path_factory):
    rng = np.random.default_rng(5)
    model = synthetic.make_panman_model(rng, N_NODES, GENOME_LEN, n_blocks=8,
                                        indel_rate=0.1)
    path = str(tmp_path_factory.mktemp("panman") / "tree.panman")
    synthetic.write_panman(path, model)
    return model, path


def _load_fast(mod, path):
    """load_panman with the scalar decoder patched to raise: the
    vectorised decoder must take the file."""
    with mock.patch.object(mod, "_decode_mutations_scalar",
                           side_effect=AssertionError("scalar decoder ran")):
        return mod.load_panman(path)


@pytest.fixture(scope="module")
def trees(written):
    _, path = written
    return {name: _load_fast(mod, path) for name, mod in PACKAGES.items()}


def test_the_tree_holds_every_record_kind(written):
    model, _ = written
    types = set((model.nuc_muts[:, 4] & 0x7).tolist())
    assert types == {synthetic.NS, synthetic.ND, synthetic.NI,
                     synthetic.NSNPS}
    lens = (model.nuc_muts[:, 4] & 0xFF) >> 4
    assert lens.min() == 1 and lens.max() == 6
    assert (model.nuc_muts[:, 3] >= 0).any()  # insertions into gap runs
    flags = model.block_muts[model.block_muts[:, 0] > 0, 2].tolist()
    assert sorted(flags) == [0, synthetic.BLOCK_INV]
    assert (model.block_muts[model.block_muts[:, 0] == 0, 2]
            == synthetic.BLOCK_INS).all()
    assert len(model.blocks) == 8 and len(model.gaps) == 16


@pytest.mark.parametrize("name", sorted(PACKAGES))
def test_the_file_decodes_to_the_writers_tree(written, trees, name):
    model, _ = written
    tree = trees[name]
    assert tree.newick == model.newick()
    assert [n.identifier for n in tree.dfs_order] == model.names
    for i, node in enumerate(tree.dfs_order):
        want = model.nuc_muts[model.nuc_muts[:, 0] == i]
        assert np.array_equal(node.nm_block, want[:, 1])
        assert np.array_equal(node.nm_pos, want[:, 2])
        assert np.array_equal(node.nm_gap, want[:, 3])
        assert np.array_equal(node.nm_packed, want[:, 4])
        bms = model.block_muts[model.block_muts[:, 0] == i]
        assert [(m.block_id, m.is_insertion, m.is_inversion)
                for m in node.block_mutations] == [
            (b, bool(f & synthetic.BLOCK_INS), bool(f & synthetic.BLOCK_INV))
            for _, b, f in bms.tolist()]
        if i:
            assert node.parent.dfs_index == model.parent[i]
    assert [b.block_id for b in tree.blocks] == list(range(len(model.blocks)))
    for b, cons in zip(tree.blocks, model.blocks):
        assert np.array_equal(b.consensus_codes, cons)
    got = sorted((g.block_id, p, n) for g in tree.gaps
                 for p, n in zip(g.nuc_positions.tolist(),
                                 g.nuc_gap_lengths.tolist()))
    assert got == sorted(map(tuple, model.gaps.tolist()))


def test_both_packages_decode_the_same_arrays(trees):
    a, b = trees["torch"], trees["jax"]
    for x, y in zip(a.dfs_order, b.dfs_order):
        assert x.identifier == y.identifier
        assert x.branch_length == y.branch_length
        for field in ("nm_block", "nm_pos", "nm_gap", "nm_packed"):
            u, v = getattr(x, field), getattr(y, field)
            assert u.dtype == v.dtype and np.array_equal(u, v), field
        assert ([vars(m) for m in x.nuc_mutations]
                == [vars(m) for m in y.nuc_mutations])


@pytest.mark.parametrize("aligned", [False, True])
def test_every_node_sequence_equals_the_model(written, trees, aligned):
    model, _ = written
    off = model.block_muts[(model.block_muts[:, 0] > 0)
                           & (model.block_muts[:, 2] == 0)][0]
    lens = set()
    for name in model.names:
        want = model.get_string(name, aligned=aligned)
        for tree in trees.values():
            assert tree.get_string(name, aligned=aligned) == want, name
        lens.add(len(want))
    if aligned:
        # every row is as wide as the alignment, less the deleted block's
        # columns below its deletion
        width = GENOME_LEN + int(model.gaps[:, 2].sum())
        gone = (len(model.blocks[off[1]])
                + int(model.gaps[model.gaps[:, 0] == off[1], 2].sum()))
        assert lens == {width, width - gone}
        assert len(model.get_string(model.names[off[0]], aligned=True)) \
            == width - gone
    else:
        assert len(lens) > 10  # the indels


@pytest.mark.parametrize("name", sorted(PACKAGES))
def test_fast_decoder_agrees_with_the_scalar_one(written, trees, name):
    _, path = written
    mod = PACKAGES[name]
    fast = trees[name]
    scalar = mod.load_panman(path)
    with lzma.open(path, "rb") as fh:
        msg = CapnpMessage(fh.read())
    nodes = msg.root().ptr(0).struct(0).ptr(1)
    assert len(nodes) == N_NODES + 1  # the trailing empty record
    mod._decode_mutations_scalar(nodes, scalar.dfs_order)
    for x, y in zip(fast.dfs_order, scalar.dfs_order):
        for field in ("nm_block", "nm_pos", "nm_gap", "nm_packed"):
            assert np.array_equal(getattr(x, field), getattr(y, field))
        assert ([vars(m) for m in x.block_mutations]
                == [vars(m) for m in y.block_mutations])


def test_pack_nuc_mut_is_the_decoders_layout():
    word = synthetic.pack_nuc_mut(synthetic.NS, [1, 2, 4, 8, 0, 15])
    node = panman.PanmanNode("n")
    node.set_nuc_mutation_arrays(np.array([3]), np.array([7], np.int32),
                                 np.array([-1], np.int32),
                                 np.array([word], np.uint32))
    (m,) = node.nuc_mutations
    assert (m.length, m.codes, m.mut_type) == (6, (1, 2, 4, 8, 0, 15),
                                               synthetic.NS)
    with pytest.raises(ValueError):
        synthetic.pack_nuc_mut(synthetic.NS, [1] * 7)


def _same_arrays(a, b):
    """Every field of two dataclasses (one of each package) equal."""
    for key, x in vars(a).items():
        y = getattr(b, key)
        if key == "params":
            assert vars(x) == vars(y)
        elif isinstance(x, np.ndarray):
            assert x.dtype == y.dtype and np.array_equal(x, y), key
        else:
            assert x == y, key


@pytest.mark.parametrize("workers", [0, 3])
def test_index_builders_give_equal_arrays(trees, workers):
    params = dict(k=19, s=8, l=3)
    ours = builder.build_index(trees["torch"], builder.IndexParams(**params),
                               workers=workers)
    theirs = jax_builder.build_index(
        trees["jax"], jax_builder.IndexParams(**params), workers=workers)
    _same_arrays(ours, theirs)
    assert len(ours.seed_hashes) > 20 * N_NODES
    assert not ours.identical_to_parent[1:].any()  # every branch mutates


@pytest.mark.parametrize("workers", [0, 3])
def test_meta_index_builders_give_equal_arrays(trees, workers):
    ours = meta_index.build_meta_index(
        trees["torch"], builder.IndexParams(), workers=workers)
    theirs = jax_meta_index.build_meta_index(
        trees["jax"], jax_builder.IndexParams(), workers=workers)
    _same_arrays(ours, theirs)
    assert len(ours.bev_block) > 0  # the block events reach the degap data


def test_stop_index_files_load_in_the_other_package(written, tmp_path,
                                                    monkeypatch):
    """--stop index of each package's CLI, the single-sample and the meta
    index, beside its own copy of the file; each loads in the other.  The
    port is asked for the CPU."""
    import torch

    from panmap_tpu.__main__ import main as jax_main
    from panmap_tpu_torch.__main__ import main as torch_main
    from panmap_tpu_torch.utils import device

    monkeypatch.setattr(device, "cuda_device",
                        lambda index=0: torch.device("cpu"))

    _, path = written
    built = {}
    for name, main in (("jax", jax_main), ("torch", torch_main)):
        os.makedirs(tmp_path / name)
        copy = str(tmp_path / name / "tree.panman")
        with open(path, "rb") as src, open(copy, "wb") as dst:
            dst.write(src.read())
        assert main([copy, "--stop", "index", "-t", "2", "-q"]) == 0
        assert main([copy, "--meta", "--stop", "index", "-t", "2", "-q"]) == 0
        built[name] = copy
    _same_arrays(index_io.load_index(built["jax"] + ".ptidx.npz"),
                 jax_index_io.load_index(built["torch"] + ".ptidx.npz"))
    _same_arrays(meta_index.load_meta_index(built["jax"] + ".ptmidx.npz"),
                 jax_meta_index.load_meta_index(
                     built["torch"] + ".ptmidx.npz"))


# ---- the CLI modes that read the file alone: --meta, --simulate, --dump-*

@pytest.fixture
def own_copies(written, tmp_path, monkeypatch):
    """Per package a directory with its own copy of the file (each CLI
    caches its index beside it); the port is asked for the CPU."""
    import torch

    from panmap_tpu.__main__ import main as jax_main
    from panmap_tpu_torch.__main__ import main as torch_main
    from panmap_tpu_torch.utils import device

    monkeypatch.setattr(device, "cuda_device",
                        lambda index=0: torch.device("cpu"))
    _, path = written
    runs = {}
    for name, main in (("jax", jax_main), ("torch", torch_main)):
        os.makedirs(tmp_path / name)
        copy = str(tmp_path / name / "tree.panman")
        with open(path, "rb") as src, open(copy, "wb") as dst:
            dst.write(src.read())
        runs[name] = (main, copy)
    return runs


def _abundance(path):
    with open(path) as fh:
        return {frozenset(names.split(",")): float(p) for names, p in
                (ln.rstrip("\n").split("\t") for ln in fh)}


MIXTURE_EM = {
    # the f32 EM run to convergence (max |dp| < 1e-6 a step)
    "converged": ["--em-delta-threshold", "0.000001"],
    # the host numpy f64 EM
    "f64": ["--em-f64"],
    # the CLI's default stop: |d llh| < 1e-5, below f32's resolution of
    # the log-likelihood here (ROADMAP C)
    "default": [],
}
# the default stop's gap between the packages on this file: 3x the reading
# of 3.5e-3 (ROADMAP C); a port that stopped 8 steps or fewer into the EM
# lands 0.016 or more from the JAX package's result here
DEFAULT_STOP_GAP = 3 * 3.5e-3


@pytest.mark.parametrize("em", sorted(MIXTURE_EM))
def test_meta_abundance_from_the_file(written, own_copies, tmp_path, em):
    """--meta on a mixture of five leaves at META_PROPORTIONS: each package
    builds its meta index from the file; the mixture's every leaf named;
    the abundances within the recorded f32 bound (2e-4) of each other with
    the EM run to convergence and with the f64 EM.  At the default stop
    the f32 EM of either package ends before convergence on this tree,
    where summation order decides the step (ROADMAP C): the same output
    lines, the same top node and abundances within DEFAULT_STOP_GAP."""
    model, path = written
    w = synthetic.PanmanWorkload(panman=path, model=model, reads1="",
                                 reads2="", leaf="", n_reads=0)
    mw = synthetic.make_panman_meta_workload(w, str(tmp_path / "reads"),
                                             seed=5, n_pairs=3000)
    got = {}
    for name, (main, copy) in own_copies.items():
        out = str(tmp_path / name / "meta")
        assert main([copy, mw.reads1, mw.reads2, "--meta", *MIXTURE_EM[em],
                     "--mesh", "1", "-t", "2", "-o", out, "-q"]) == 0
        assert os.path.exists(copy + ".ptmidx.npz")
        got[name] = _abundance(out + ".mgsr.abundance.out")
    a, b = got["jax"], got["torch"]
    assert set(a) == set(b)
    assert set(mw.haplotypes) <= set().union(*b)
    gap = max(abs(a[k] - b[k]) for k in a)
    if em == "default":
        assert max(a, key=a.get) == max(b, key=b.get)
        assert gap <= DEFAULT_STOP_GAP
    else:
        assert gap <= 2e-4


TOOLS = {
    "simulate": (["--simulate", "--random-seed", "11", "-o", "{out}/sim"],
                 ("sim.fa", "sim.truth.vcf", "sim_R1.fastq",
                  "sim_R2.fastq")),
    "dump_node": (["--dump-node", "{leaf}", "-o", "{out}/node.fa"],
                  ("node.fa",)),
    "dump_sequences": (["--dump-sequences", "{leaf} node_0",
                        "--simulate-snps", "3", "0", "--random-seed", "4",
                        "-o", "{out}/seqs"], ("seqs.dump-sequences.fa",)),
    "dump_random_node_ids": (["--dump-random-nodeIDs", "5", "-o",
                              "{out}/ids"], ("ids.randomNodeIDs.txt",)),
}


@pytest.mark.parametrize("tool", sorted(TOOLS))
def test_tools_write_the_same_files(written, own_copies, tmp_path, tool):
    model, _ = written
    argv, files = TOOLS[tool]
    leaf = model.leaves()[0]
    for name, (main, copy) in own_copies.items():
        out = str(tmp_path / name)
        assert main([copy] + [a.format(out=out, leaf=leaf) for a in argv]
                    + ["-q"]) == 0
    for f in files:
        a, b = (str(tmp_path / name / f) for name in ("jax", "torch"))
        assert filecmp.cmp(a, b, shallow=False), f
    if tool == "dump_node":
        with open(tmp_path / "torch" / "node.fa") as fh:
            lines = fh.read().split()
        assert lines[0] == ">" + leaf
        assert "".join(lines[1:]) == model.get_string(leaf)


@pytest.mark.parametrize("meta", [False, True])
def test_index_cache_rules(own_copies, meta):
    """Each CLI builds its index beside the file once, loads it while it
    is newer than the file, and builds it again when the file is newer."""
    suffix = ".ptmidx.npz" if meta else ".ptidx.npz"
    mode = ["--meta"] if meta else []
    for name, (main, copy) in own_copies.items():
        def stop_index():
            assert main([copy, *mode, "--stop", "index", "-t", "2",
                         "-q"]) == 0
            return os.stat(copy + suffix).st_mtime_ns

        built = stop_index()
        os.utime(copy + suffix, ns=(built - 10**9, built - 10**9))
        os.utime(copy, ns=(built - 2 * 10**9, built - 2 * 10**9))
        assert stop_index() == built - 10**9, name  # loaded, not rebuilt
        os.utime(copy, ns=(built, built))
        assert stop_index() > built - 10**9, name  # the file is newer
