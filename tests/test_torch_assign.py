"""The port's read assignment (--meta --filter-and-assign) against the JAX
package's, on the CPU at a small size (panmap_tpu_torch.synthetic.
make_assign_workload: ~64 nodes in 6 species of 4 genera, 2 kb genomes,
3,000 ancient-DNA-like reads).

 (a) TorchMetaScorer.assignment_pass against TpuMetaScorer.assignment_pass on
     the same numpy inputs: the four values equal, the dict in the same
     insertion order (it fixes the order of the output files);
 (b) the fast route against the replay DFS of the host route;
 (c) run_meta(filter_and_assign=True) of both packages on the same sample:
     all seven output files byte-equal, on every route;
 (d) the 2,000-read routing threshold taken on both sides.

Everything compared is integer or text: no tolerance.
"""

import filecmp
import os

import numpy as np
import pytest
import torch

from panmap_tpu.meta import driver as hd
from panmap_tpu.meta.engine import MetaRead as JaxMetaRead
from panmap_tpu.meta.engine_tpu import TpuMetaScorer
from panmap_tpu.native import get_lib
from panmap_tpu_torch import convert
from panmap_tpu_torch.meta import assign as ta
from panmap_tpu_torch.meta import driver as td
from panmap_tpu_torch.meta.engine import MetaScorer, sketch_meta_reads_full
from panmap_tpu_torch.meta.engine_torch import TorchMetaScorer
from panmap_tpu_torch.synthetic import make_assign_workload
from test_torch_standalone import jax_meta_index

CPU = torch.device("cpu")
FILES = ("mgsr.assignedReads.fastq", "mgsr.assignedReads.out",
         "mgsr.assignedReadsLCANode.out", "mgsr.assignedReads.jplace",
         "mgsr.assignedReadsLCANode.jplace", "mgsr.breadths.out",
         "read_scores_info.filtered.tsv")

pytestmark = pytest.mark.skipif(get_lib() is None,
                                reason="native library unavailable")


def _workload(path, n_reads=3000, seed=1):
    return make_assign_workload(str(path), seed=seed, n_clades=6,
                                clade_nodes=10, genome_len=2000,
                                n_reads=n_reads, n_taxa=4, sister_genera=1,
                                target_share=0.5)


@pytest.fixture(scope="module")
def sample(tmp_path_factory):
    return _workload(tmp_path_factory.mktemp("assign"))


def _sketch(w, long_read=False):
    """The sample's unique read sets under demo 3's --dust 5; with
    ``long_read`` also one read of more than 256 seedmers."""
    from panmap_tpu_torch.io import fastq

    p = w.midx.params
    _, seqs, _ = fastq.read_full(w.reads1)
    if long_read:
        rng = np.random.default_rng(3)
        seqs = seqs + ["".join(np.array(list("ACGT"))[rng.integers(0, 4,
                                                                   2400)])]
    reads, dup_index, _ = sketch_meta_reads_full(
        seqs, p.k, p.s, p.t, p.l, p.open, dust_threshold=5)
    return reads, dup_index


def _inputs(w, reads):
    """(keep, eff) as _assign_one_batch makes them (--discard 0.6)."""
    scorer = MetaScorer(w.midx, reads)
    max_score, _, _ = scorer.score_all([], collect_node_scores=True)
    lens = np.array([len(r.hashes) for r in reads], dtype=np.int64)
    eff = max_score.copy()
    eff[eff < lens * 0.6] = 0
    return scorer.tree.keep, eff


@pytest.mark.parametrize("case", ["plain", "amb_thr", "amb_ratio",
                                  "partial_last_chunk", "int32_slots"])
def test_assignment_pass_equals_tpu_scorer(sample, case):
    reads, _ = _sketch(sample, long_read=case == "int32_slots")
    keep, eff = _inputs(sample, reads)
    assert (eff > 0).sum() > 500
    kw = {"amb_thr": dict(amb_thr=2), "amb_ratio": dict(amb_ratio=0.25)}.get(
        case, {})
    # TpuMetaScorer packs 32 nodes a word: chunks are multiples of 32
    chunk = 96 if case == "partial_last_chunk" else 32
    assert (len(sample.midx.node_ids) % chunk != 0) == (chunk == 96)
    saved = TpuMetaScorer.NODE_CHUNK, TorchMetaScorer.NODE_CHUNK
    TpuMetaScorer.NODE_CHUNK = TorchMetaScorer.NODE_CHUNK = chunk
    try:
        jx = TpuMetaScorer(jax_meta_index(sample.midx),
                           [JaxMetaRead(**convert.as_dict(r)) for r in reads])
        pt = TorchMetaScorer(sample.midx, reads, CPU)
    finally:
        TpuMetaScorer.NODE_CHUNK, TorchMetaScorer.NODE_CHUNK = saved
    assert (pt.n_slots >= 256) == (case == "int32_slots")
    want_by, want_near, want_epp, (want_lo, want_hi) = jx.assignment_pass(
        keep, eff, **kw)
    got_by, got_near, got_epp, (got_lo, got_hi) = pt.assignment_pass(
        keep, eff, **kw)
    assert list(got_by) == list(want_by) and len(got_by) > 10
    for node in want_by:
        assert got_by[node] == want_by[node], node
    assert [r for r, _ in got_near] == [r for r, _ in want_near]
    for (_, a), (_, b) in zip(got_near, want_near):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    if kw:  # the threshold widens some read's near set past its max set
        n_max = {r: 0 for r, _ in got_near}
        for rs in got_by.values():
            for r in rs:
                n_max[r] += 1
        assert any(len(ns) > n_max[r] for r, ns in got_near)
    for a, b in ((got_epp, want_epp), (got_lo, want_lo), (got_hi, want_hi)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert (got_lo[eff > 0] >= 0).all() and (got_lo[eff == 0] == -1).all()
    assert pt.pairs_copied >= sum(len(v) for v in got_by.values())
    # two nonzero calls (max, near) a node chunk x read block
    blocks = -(-int((eff > 0).sum()) // pt.READ_CHUNK)
    assert pt.nonzero_syncs == 2 * -(-pt.n_nodes // chunk) * blocks


def test_assignment_pass_without_a_live_read(sample):
    reads, _ = _sketch(sample)
    keep, eff = _inputs(sample, reads)
    pt = TorchMetaScorer(sample.midx, reads, CPU)
    by, near, epp, (lo, hi) = pt.assignment_pass(keep, np.zeros_like(eff))
    assert by == {} and near == [] and not epp.any()
    assert (lo == -1).all() and (hi == -1).all()


class _Cfg:
    """The fields _assign_one_batch reads."""

    taxonomy_path = ""
    discard = 0.6
    ambiguous_score_threshold = 0
    ambiguous_score_threshold_ratio = 0.0
    breadth_ratio = False
    pseudochain = False
    write_read_scores_filtered = False
    log = staticmethod(lambda *a, **k: None)


def test_fast_route_equals_the_replay_dfs(sample, tmp_path):
    """One batch through _assign_one_batch on the fast route
    (assignment_pass) and on the host route (the replay DFS over
    MetaScorer's per-node scores): the same reads at the same nodes and the
    same LCA per read."""
    from collections import defaultdict

    from panmap_tpu_torch.io import fastq

    names, seqs, quals = fastq.read_full(sample.reads1)
    reads, dup_index = _sketch(sample)
    parent = sample.midx.parent_index.astype(np.int64)
    n_nodes = len(parent)
    children = [[] for _ in range(n_nodes)]
    for i in range(1, n_nodes):
        children[parent[i]].append(i)
    results = []
    for route in ("fast", "host"):
        cfg = _Cfg()
        cfg.fast_threshold = 0 if route == "fast" else 1 << 30
        node_idxs, lca_idxs = defaultdict(list), defaultdict(list)
        jp_names = []
        with open(tmp_path / f"{route}.fastq", "w") as fh:
            n_fq = ta._assign_one_batch(
                cfg, sample.midx, MetaScorer(sample.midx, reads), reads,
                dup_index, names, seqs, quals, ta.Lca(parent), children,
                [set() for _ in range(n_nodes)], np.zeros(n_nodes, bool), 1,
                fh, 0, node_idxs, lca_idxs, jp_names, [], [],
                defaultdict(dict), [], device=CPU)
        assert n_fq == len(jp_names) > 500
        results.append(tuple(
            {node: sorted(jp_names[i] for i in idxs)
             for node, idxs in mapping.items()}
            for mapping in (node_idxs, lca_idxs)))
    assert results[0] == results[1]
    by_node, by_lca = results[0]
    assert len(by_node) > 10
    # some read ties across the sister species: its LCA is their genus node
    assert sample.midx.node_ids.index("genus_0") in by_lca


CASES = {
    "fast": dict(fast_threshold=0),
    "fast_genus_ambiguous": dict(fast_threshold=0, taxonomic_rank="genus",
                                 max_taxon_number=2,
                                 ambiguous_score_threshold=1,
                                 ambiguous_score_threshold_ratio=0.1),
    "fast_no_taxonomy": dict(fast_threshold=0, taxonomy_path=""),
    "fast_batches": dict(fast_threshold=0, batch_size=1100),
    "fast_mask_reads": dict(fast_threshold=0, mask_reads=1),
    "host": dict(fast_threshold=1 << 30),
    "host_score": dict(host_score=True),
    "pseudochain": dict(pseudochain=True),
    "host_batches_mask_seeds": dict(fast_threshold=1 << 30, batch_size=1700,
                                    mask_seeds=1),
}


def _run_both(w, tmp_path, opts):
    """run_meta(filter_and_assign=True) of both packages with demo 3's
    options; returns (log lines of the JAX package, of the port)."""
    opts = dict(opts)
    fast_threshold = opts.pop("fast_threshold", None)
    lines = {"jax": [], "torch": []}

    def cfg(mod, name):
        c = mod.MetaConfig(
            panman="synthetic", reads1=w.reads1, output=str(tmp_path / name),
            filter_and_assign=True, discard=0.6, dust=5,
            **{"taxonomy_path": w.taxonomy, "taxonomic_rank": "species",
               "breadth_ratio": True, "jplace": True,
               "write_read_scores_filtered": True, **opts},
            log=lambda m, *a, **k: lines[name].append(m))
        if fast_threshold is not None:
            c.fast_threshold = fast_threshold
        return c

    assert hd.run_meta(cfg(hd, "jax"), midx=jax_meta_index(w.midx)) == 0
    assert td.run_meta(cfg(td, "torch"), midx=w.midx, device=CPU) == 0
    for ext in FILES:
        a, b = (str(tmp_path / f"{name}.{ext}") for name in ("jax", "torch"))
        assert filecmp.cmp(a, b, shallow=False), ext
    return lines["jax"], lines["torch"]


def _out_lines(path):
    with open(path) as fh:
        return [ln.rstrip("\n").split("\t") for ln in fh]


@pytest.mark.parametrize("case", sorted(CASES))
def test_filter_and_assign_files_byte_equal_to_jax_package(sample, tmp_path,
                                                           case):
    jl, tl = _run_both(sample, tmp_path, CASES[case])
    fast = case.startswith("fast")
    for lines in (jl, tl):
        assert bool([x for x in lines if "batched scoring" in x]) == fast
        if "batches" in case:
            assert [x for x in lines if "pass A" in x]
            assert len([x for x in lines if "[assign] batch " in x]) == -(
                -sample.n_reads // CASES[case]["batch_size"])
        if "mask" in case:
            assert [x for x in lines if " masked)" in x]
    out = _out_lines(tmp_path / "torch.mgsr.assignedReads.out")
    assert len(out) > 5 and os.path.getsize(
        tmp_path / "torch.mgsr.breadths.out") > 200
    if case == "fast":
        # species rank, at most one taxon: reads that tie across the sister
        # species are dropped, the genus node is poisoned (no taxon)
        scores = _out_lines(tmp_path / "torch.read_scores_info.filtered.tsv")
        head = scores[0]
        assert "OverMaximumTaxons" in head or len(head) > 3
        lca = {ln[0].split(",")[0]: ln for ln in _out_lines(
            tmp_path / "torch.mgsr.assignedReadsLCANode.out")}
        assert "genus_0" not in lca
    if case == "fast_genus_ambiguous":
        lca = {ln[0].split(",")[0]: ln for ln in _out_lines(
            tmp_path / "torch.mgsr.assignedReadsLCANode.out")}
        assert "genus_0" in lca and int(lca["genus_0"][2]) > 0


def test_maximum_taxon_number_drops_reads(sample, tmp_path):
    """The same sample keeps more reads at the genus rank with two taxa
    allowed than at the species rank with one (the reads that tie across
    the sister species)."""
    def n_assigned(name, **opts):
        cfg = td.MetaConfig(
            panman="synthetic", reads1=sample.reads1,
            output=str(tmp_path / name), filter_and_assign=True, discard=0.6,
            dust=5, taxonomy_path=sample.taxonomy,
            log=lambda *a, **k: None, **opts)
        cfg.fast_threshold = 0
        assert td.run_meta(cfg, midx=sample.midx, device=CPU) == 0
        with open(cfg.output + ".mgsr.assignedReads.fastq") as fh:
            return sum(1 for _ in fh) // 4

    strict = n_assigned("species", taxonomic_rank="species")
    loose = n_assigned("genus", taxonomic_rank="genus", max_taxon_number=2)
    assert 0 < strict < loose


@pytest.mark.parametrize("n_reads", [1500, 3000])
def test_routing_threshold_on_both_sides(tmp_path, n_reads):
    """Under the default threshold of 2,000 unique read sets the small
    sample takes the replay DFS and the large one the batched scorer, in
    both packages."""
    w = _workload(tmp_path / "reads", n_reads=n_reads)
    jl, tl = _run_both(w, tmp_path, {})
    for lines in (jl, tl):
        uniq = [x for x in lines if "unique sets" in x]
        assert len(uniq) == 1
        n_unique = int(uniq[0].split("->")[1].split()[0])
        assert (n_unique >= 2000) == (n_reads == 3000)
        assert bool([x for x in lines if "batched scoring" in x]) == (
            n_reads == 3000)


def test_load_taxonomy_and_lca_are_the_jax_packages(sample):
    from panmap_tpu.meta import assign as ha

    for rank in ("species", "genus"):
        assert ta.load_taxonomy(sample.taxonomy, rank) == ha.load_taxonomy(
            sample.taxonomy, rank)
    with pytest.raises(ValueError):
        ta.load_taxonomy(sample.taxonomy, "sample")
    parent = sample.midx.parent_index.astype(np.int64)
    a, b = ta.Lca(parent), ha.Lca(parent)
    rng = np.random.default_rng(0)
    for u, v in rng.integers(0, len(parent), (50, 2)).tolist():
        assert a.lca(u, v) == b.lca(u, v)


@pytest.mark.gpu
def test_cuda_assignment_pass_matches_cpu(sample):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    reads, _ = _sketch(sample)
    keep, eff = _inputs(sample, reads)
    want = TorchMetaScorer(sample.midx, reads, CPU).assignment_pass(
        keep, eff, 1, 0.1)
    got = TorchMetaScorer(sample.midx, reads, "cuda").assignment_pass(
        keep, eff, 1, 0.1)
    assert list(got[0].items()) == list(want[0].items())
    assert all(r == s and np.array_equal(a, b)
               for (r, a), (s, b) in zip(got[1], want[1]))
    assert np.array_equal(got[2], want[2])
    assert all(np.array_equal(a, b) for a, b in zip(got[3], want[3]))
