"""Metagenomic abundance (--meta) on the GPU: the port's copy of
panmap_tpu/meta/driver.py::run_meta, split into its stages.

The stages and every host piece are carried over from the JAX package
(MetaConfig and ensure_meta_index here, unchanged; meta/engine.py's read
sketchers and MetaScorer: tree collapse, kept and identical nodes, the
native host scorer, pseudochain, the scores TSV), as are the shared-rank
candidate ranking, --em-candidates, --discard and the abundance writer.
What changes:

 - the device scorer is TorchMetaScorer, under the same routing rule
   (>= 2,000 unique read sets, no pseudochain, no scores TSV, no
   --host-score);
 - the EM is the port's run_squarem (torch EM for a device snapshot or a
   host matrix past 5 M cells, else the numpy f64 EM), or the
   numpy f64 EM at any size under --em-f64;
 - --filter-and-assign goes to meta/assign.py::run_filter_and_assign with
   the device (its batched scorer is TorchMetaScorer.assignment_pass);
 - --mesh resolves to a parallel.mesh.Mesh (_resolve_meta_mesh), given to
   the device scorer (this process's shards) and the torch EM (every
   rank's shards);
 - no backend warm-up (jax programs).
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass

import numpy as np

from .. import native, trace
from ..index.builder import IndexParams
from ..io import fastq
from ..io.panman import load_panman
from ..utils.device import as_device
from .em import run_squarem
from .engine import MetaScorer
from .engine import run_squarem as host_run_squarem
from .engine_torch import TorchMetaScorer
from .index import (
    build_meta_index,
    load_meta_index,
    read_meta_params,
    save_meta_index,
)

FAST_MIN_READS = 2000  # the device scorer's floor (panmap_tpu/meta/driver.py:175)


@dataclass
class MetaConfig:
    panman: str = ""
    reads1: str = ""
    reads2: str = ""
    output: str = "sample"
    index_path: str = ""  # load a pre-built .ptmidx from this path
    index_out: str = ""  # write the built meta index here (main.cpp --index-out)
    k: int = 19
    s: int = 8
    t: int = 0
    l: int = 3
    open: bool = False
    em_convergence_threshold: float = 1e-5
    em_delta_threshold: float = 0.0
    em_maximum_rounds: int = 5
    em_maximum_iterations: int = 1000
    top_oc: int = 1000
    dust: float = 100.0
    discard: float = 0.0
    mask_reads: int = 0
    mask_seeds: int = 0
    mask_reads_rf: float = 0.0
    mask_seeds_rf: float = 0.0
    amplicon_depth: str = ""
    mask_read_ends: int = 0
    pseudochain: bool = False
    filter_and_assign: bool = False
    batch_size: int = 1_000_000  # filter-and-assign read-stream batch
    host_score: bool = False  # --host-score: threaded native CPU scoring
    em_f64: bool = False  # --em-f64: host float64 EM (reference precision)
    mesh: int = 0  # --mesh: shard the EM's reads over N devices (0 = auto)
    taxonomy_path: str = ""
    taxonomic_rank: str = "Family"
    max_taxon_number: int = 1
    ambiguous_score_threshold: int = 0
    ambiguous_score_threshold_ratio: float = 0.0
    breadth_ratio: bool = False
    jplace: bool = False
    align_reads: bool = False
    min_num_align: int = 10
    write_ocranks: bool = False
    write_read_scores_unfiltered: bool = False
    write_read_scores_filtered: bool = False
    leaves_only: bool = False
    em_candidates: str = ""  # dev: file of node ids; restrict the EM to them
    threads: int = 0
    stop: str = ""
    log: object = print


def ensure_meta_index(cfg: MetaConfig, tree=None):
    path = cfg.index_path or cfg.index_out or cfg.panman + ".ptmidx.npz"
    want = dict(k=cfg.k, s=cfg.s, t=cfg.t, l=cfg.l, open=cfg.open)
    if os.path.exists(path):
        try:
            hdr = read_meta_params(path)
            if (all(hdr.get(kk) == vv for kk, vv in want.items())
                    and os.path.getmtime(path) >= os.path.getmtime(cfg.panman)):
                return load_meta_index(path), tree
        except Exception:
            pass
    if tree is None:
        tree = load_panman(cfg.panman)
    t0 = time.time()
    midx = build_meta_index(
        tree, IndexParams(k=cfg.k, s=cfg.s, t=cfg.t, l=cfg.l, open=cfg.open),
        workers=cfg.threads or (os.cpu_count() or 1))
    cfg.log(f"[meta-index] built in {time.time()-t0:.1f}s "
            f"({len(midx.delta_seed)} deltas, {len(midx.seed_hash)} seeds)")
    try:
        save_meta_index(path, midx)
    except OSError:
        cfg.log(f"[meta-index] warning: could not cache at {path}")
    return midx, tree


def _resolve_meta_mesh(cfg: MetaConfig):
    """--mesh for the meta path (the placement pipeline's semantics: 0 =
    auto, a mesh when the run has more than one card; 1 = off; N = N
    shards, at most the run's cards).  Returns a parallel.mesh.Mesh or
    None."""
    if cfg.mesh == 1:
        return None
    from ..parallel.mesh import global_device_count, make_mesh

    n_avail = global_device_count()
    want = cfg.mesh if cfg.mesh > 0 else (n_avail if n_avail > 1 else 1)
    if want <= 1:
        return None
    return make_mesh(min(want, n_avail))


@trace.spanned("meta.sketch")
def sketch(cfg: MetaConfig, midx):
    """Read seedmer sets of the sample, deduplicated: (reads, dup_index)."""
    p = midx.params
    masking = (cfg.mask_reads or cfg.mask_seeds or cfg.mask_reads_rf
               or cfg.mask_seeds_rf or cfg.amplicon_depth or cfg.mask_read_ends)
    if masking:
        from .engine import sketch_meta_reads_grouped

        names, seqs, _ = fastq.read_full(cfg.reads1)
        if cfg.reads2:
            n2, s2, _ = fastq.read_full(cfg.reads2)
            names += n2
            seqs += s2
        reads, dup_index, n_dust, n_masked = sketch_meta_reads_grouped(
            seqs, names, p, cfg)
        cfg.log(f"[meta] {len(seqs)} reads -> {len(reads)} unique seedmer sets"
                f" ({n_dust} low-complexity, {n_masked} masked)")
    else:
        from .engine import sketch_meta_reads_full

        seqs = fastq.read_paired_for_placement(cfg.reads1, cfg.reads2 or None)
        reads, dup_index, n_dust = sketch_meta_reads_full(
            seqs, p.k, p.s, p.t, p.l, p.open, dust_threshold=cfg.dust)
        cfg.log(f"[meta] {len(seqs)} reads -> {len(reads)} unique seedmer sets "
                f"({n_dust} low-complexity discarded)")
    trace.count("reads", len(seqs))
    trace.count("read_sets", len(reads))
    return reads, dup_index


def make_scorers(cfg: MetaConfig, midx, reads, device, mesh=None):
    """(MetaScorer, TorchMetaScorer on ``device`` or None): the device
    scorer takes large read sets unless pseudochain, the scores TSV or
    --host-score asks for the host one.  ``mesh``: its shards split the
    device scorer's reads."""
    with trace.span("meta.collapse"):
        scorer = MetaScorer(midx, reads)
    fast = None
    if (not cfg.pseudochain and not cfg.write_read_scores_unfiltered
            and len(reads) >= FAST_MIN_READS and not cfg.host_score):
        t0 = time.time()
        fast = TorchMetaScorer(midx, reads, device, mesh=mesh)
        cfg.log(f"[meta] presence events built in {time.time()-t0:.1f}s "
                f"({len(fast.ev_pos)} events)")
    return scorer, fast


@trace.spanned("meta.rank")
def rank_candidates(cfg: MetaConfig, midx, scorer, fast):
    """The EM's candidate nodes: the top --top-oc shared overlap-coefficient
    ranks over kept nodes (leaves only with --em-leaves-only), or the nodes
    --em-candidates names.  None after an --em-candidates error."""
    if fast is not None:
        oc_arr = fast.overlap_coefficients()
        oc = {n: float(oc_arr[n]) for n in range(len(midx.node_ids))}
    else:
        oc = scorer.overlap_coefficients()
    if cfg.write_ocranks:
        # shared-rank TSV (main.cpp:430-445 writeOCRanks)
        path = cfg.output + ".overlapCoefficients.tsv"
        with open(path, "w") as fh:
            rank = 0
            prev_oc = None
            for n, v in sorted(oc.items(), key=lambda kv: -kv[1]):
                if prev_oc is not None and v != prev_oc:
                    rank += 1
                prev_oc = v
                fh.write(f"{midx.node_ids[n]}\t{v:.6f}\t{rank}\n")
        cfg.log(f"[meta] wrote {path}")
    # shared-rank assignment over surviving nodes (mgsr.cpp:141-154)
    kept_nodes = [n for n in oc if scorer.tree.keep[n]]
    if cfg.leaves_only:
        # --em-leaves-only (mgsr.cpp:8018): candidates restricted to leaves
        has_child = np.zeros(len(midx.node_ids), dtype=bool)
        has_child[midx.parent_index[1:]] = True
        kept_nodes = [n for n in kept_nodes if not has_child[n]]
    kept_sorted = sorted(kept_nodes, key=lambda n: -oc[n])
    candidates = []
    rank = 0
    prev = None
    for n in kept_sorted:
        if prev is None or oc[n] != prev:
            prev = oc[n]
            rank += 1
            if rank > cfg.top_oc:
                break
        candidates.append(n)
    cfg.log(f"[meta] {len(candidates)} candidate nodes from overlap coefficients")
    if cfg.em_candidates:
        # --em-candidates: pin the EM's haplotype columns to a node list
        try:
            with open(cfg.em_candidates) as fh:
                want = [ln.split("\t")[0].strip() for ln in fh if ln.strip()]
        except OSError as exc:
            cfg.log(f"[meta] error: --em-candidates unreadable: {exc}")
            return None
        want = list(dict.fromkeys(want))  # dedup, order-preserving
        id_of = {nm: i for i, nm in enumerate(midx.node_ids)}
        missing = [nm for nm in want if nm not in id_of]
        if missing:
            cfg.log(f"[meta] error: --em-candidates names not in the panman: "
                    f"{missing[:3]}")
            return None
        candidates = [id_of[nm] for nm in want]
        cfg.log(f"[meta] EM candidates pinned to {len(candidates)} nodes "
                f"(--em-candidates)")
    return candidates


@trace.spanned("meta.score")
def score(cfg: MetaConfig, scorer, fast, candidates):
    """(max_score int32 [R], snap, node_scores or None).  snap is the device
    scorer's [R, len(candidates)] tensor, or the host scorer's [len
    (candidates), R] uint16 array."""
    trace.count("candidates", len(candidates))
    trace.count("device", fast is not None)
    if fast is not None:
        max_score, snap = fast.score_all(candidates)
        return max_score, snap, None
    if cfg.write_read_scores_unfiltered:
        score_fn = (scorer.score_all_pseudo if cfg.pseudochain
                    else scorer.score_all)
        return score_fn(candidates, collect_node_scores=True)
    if cfg.pseudochain:
        return (*scorer.score_all_pseudo(candidates), None)
    return (*scorer.score_all(candidates), None)


def em_inputs(cfg: MetaConfig, reads, max_score):
    """(read lengths, weights): duplicate counts, zeroed for unmapped reads
    and those --discard drops."""
    read_lens = np.array([len(r.hashes) for r in reads], dtype=np.int64)
    weights = np.array([r.n_dup for r in reads], dtype=np.float64)
    eff_max = max_score.copy()
    n_unmapped = int((eff_max == 0).sum())
    low = eff_max < (read_lens * cfg.discard)
    eff_max[low] = 0
    weights[eff_max == 0] = 0.0
    cfg.log(f"[meta] {n_unmapped} unmapped, {int(low.sum())} discarded by "
            f"--discard {cfg.discard}")
    return read_lens, weights


@trace.spanned("meta.em")
def run_em(cfg: MetaConfig, snap, read_lens, weights, cand_names, device,
           mesh=None):
    """The abundance EM on the snapshot: host numpy f64 with --em-f64,
    else the port's run_squarem routing (over ``mesh``'s shards where it
    routes to the torch EM)."""
    kw = dict(eta=cfg.em_convergence_threshold,
              max_change_threshold=cfg.em_delta_threshold,
              max_iterations=cfg.em_maximum_iterations,
              max_rounds=cfg.em_maximum_rounds)
    if cfg.em_f64:
        # --em-f64: the reference's precision envelope via the host
        # numpy-f64 SQUAREM at any size (the JAX package forces
        # backend="numpy"); a device snapshot [R, M] comes over as [M, R]
        S_np = (snap.cpu().numpy().T if not isinstance(snap, np.ndarray)
                else snap)
        return host_run_squarem(S_np.astype(np.uint16), read_lens, weights,
                                cand_names, backend="numpy", **kw)
    return run_squarem(snap, read_lens, weights, cand_names,
                       prefer_cpu=cfg.host_score, device=device, mesh=mesh,
                       **kw)


def write_abundance(cfg: MetaConfig, midx, scorer, res) -> str:
    """<out>.mgsr.abundance.out: one line per surviving column, by
    decreasing proportion, naming the node, its identical-group columns
    and every node collapsed into either."""
    members_of: dict = {}
    for keeper, absorbed in scorer.tree.identical_members.items():
        members_of[midx.node_ids[keeper]] = [midx.node_ids[a] for a in absorbed]
    order = np.argsort(-res.props)
    out_path = cfg.output + ".mgsr.abundance.out"
    with open(out_path, "w") as fh:
        for i in order:
            name = res.node_names[i]
            parts = [name] + members_of.get(name, [])
            for g in res.identical_groups.get(name, []):
                parts.append(g)
                parts.extend(members_of.get(g, []))
            fh.write(",".join(parts) + f"\t{res.props[i]:.5f}\n")
    cfg.log(f"[meta] wrote {out_path}")
    return out_path


@trace.spanned("run")
def run_meta(cfg: MetaConfig, midx=None, device=None) -> int:
    """Abundance deconvolution of one sample, or its read assignment with
    cfg.filter_and_assign; ``device`` defaults to the
    first CUDA device (a CPU device is for the parity tests).  Its stages
    are spans (trace.py): meta.sketch counts the reads and read sets,
    meta.score the candidates and the route (device 1 or 0), meta.em the
    torch EM's SQUAREM steps and rounds."""
    native.require_lib()  # a failed build raises here, not a silent slow path
    # the index is built (forking build workers) or loaded BEFORE the first
    # CUDA call: a CUDA context does not survive fork
    if midx is None:
        with trace.span("index.read"):
            midx, _ = ensure_meta_index(cfg)
    if cfg.stop == "index" or not cfg.reads1:
        return 0
    device = as_device(device)
    if cfg.filter_and_assign:
        from .assign import run_filter_and_assign

        return run_filter_and_assign(cfg, midx, device)

    # CPU tensors (the parity tests' choice) get no mesh
    mesh = _resolve_meta_mesh(cfg) if device.type == "cuda" else None
    if mesh is not None:
        device = mesh.devices[0]
    reads, dup_index = sketch(cfg, midx)
    scorer, fast = make_scorers(cfg, midx, reads, device, mesh)
    candidates = rank_candidates(cfg, midx, scorer, fast)
    if candidates is None:
        return 1
    t0 = time.time()
    max_score, snap, node_scores = score(cfg, scorer, fast, candidates)
    if fast is not None and device.type == "cuda":
        import torch

        torch.cuda.synchronize(device)  # the logged seconds hold the card's
    cfg.log(f"[meta] scored {len(reads)} read sets over the tree in "
            f"{time.time() - t0:.1f}s")

    if cfg.write_read_scores_unfiltered:
        from .engine import count_epp, write_read_scores_tsv

        epp = count_epp(node_scores, max_score,
                        midx.parent_index.astype(np.int64), scorer.tree.keep,
                        len(reads))
        path = cfg.output + ".read_scores_info.unfiltered.tsv"
        write_read_scores_tsv(path, reads, dup_index, max_score, epp)
        cfg.log(f"[meta] wrote {path}")

    read_lens, weights = em_inputs(cfg, reads, max_score)
    if (weights > 0).sum() == 0:
        cfg.log("[meta] no reads remain for EM")
        return 0
    cand_names = [midx.node_ids[n] for n in candidates]
    t0 = time.time()
    res = run_em(cfg, snap, read_lens, weights, cand_names, device, mesh)
    em_dt = time.time() - t0
    if res.n_iterations:
        cfg.log(f"[meta] EM: {res.n_iterations} SQUAREM steps in {em_dt:.1f}s "
                f"({res.n_iterations / max(em_dt, 1e-9):.0f} iters/s)")
    write_abundance(cfg, midx, scorer, res)
    return 0
