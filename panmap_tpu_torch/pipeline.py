"""Single-sample pipeline on one GPU: index -> place -> align ->
genotype -> consensus (counterpart of panmap_tpu/pipeline.py).

The stage order is that of panmap_tpu.pipeline._run_pipeline_inner, and
everything host-side is the JAX package's own code: the index cache, the
read sketch, the f64 placement engine, the alignment prefetch, the columnar
BAM emit, genotyping and consensus.  This module writes only the stages that
touch the device:

 - run_placement: TorchPlacer.place_exact_async (device scoring + exact f64
   rescue); the host engine runs only where the JAX package runs it by
   contract (place_exact returned None, --host-place, --dump-all-scores,
   --refine, --verify-scores);
 - run_alignment: TorchBatchAligner (deferred windows on the SW kernel)
   for short reads; for long reads (mean length >= 500, map-ont /
   map-hifi) TorchLongReadAligner (the banded DP rows on the long-read
   kernel), whose records _emit_records builds and writes.

Genotyping always uses the host pileup tally: the device tally
(--device-pileup on) is not ported yet.  Left out on purpose, since they
served only a remote TPU link: the backend warm-up, the watchdog, the
one-shot remote policy and the cold-dispatch race.
"""

from __future__ import annotations

import os
import threading
import time
from dataclasses import replace

import numpy as np

from panmap_tpu import pipeline as host
from panmap_tpu.align.longread import pick_preset
from panmap_tpu.genotype.caller import PlacedRead
from panmap_tpu.io import fastq
from panmap_tpu.io.bam import compute_sam_flags, write_bam
from panmap_tpu.io.panman import load_panman
from panmap_tpu.pipeline import (  # noqa: F401  (re-exported)
    PipelineConfig,
    _emit_columnar,
    _finish_placement,
    _start_align_prefetch,
    ensure_index,
    run_consensus,
)
from panmap_tpu.place.engine import (
    METRICS,
    prepare_read_sketch,
    score_nodes,
    sketch_reads,
)
from panmap_tpu.sketch.cpu import reverse_complement

from .align.batch import TorchBatchAligner
from .align.longread import TorchLongReadAligner
from .place.query_torch import TorchPlacer
from .utils.device import as_device


def check_supported(cfg: PipelineConfig):
    """Raise NotImplementedError for options whose device path this port
    does not have yet (each names its ROADMAP item)."""
    if cfg.batch_file:
        raise NotImplementedError("--batch is not ported yet (ROADMAP A: "
                                  "batch mode)")
    if cfg.mesh > 1:
        raise NotImplementedError("--mesh > 1 is not ported yet (ROADMAP B7)")
    if cfg.profile_dir:
        raise NotImplementedError("--profile writes a jax.profiler trace; "
                                  "not ported")
    if (cfg.device_pileup == "on"
            or os.environ.get("PANMAP_TPU_DEVICE_PILEUP") == "1"):
        raise NotImplementedError("the device pileup tally is not ported yet "
                                  "(ROADMAP B4); use --device-pileup off")


def read_sketch(cfg: PipelineConfig, idx):
    """The reads' placement sketch under the index's parameters (the
    sketch branches of panmap_tpu.pipeline.run_placement).  Returns
    (ReadSketch, n_reads)."""
    p = idx.params
    seqs = fastq.read_paired_for_placement(cfg.reads1, cfg.reads2 or None)
    if cfg.min_seed_quality > 0:
        from panmap_tpu.place.engine import sketch_reads_quality

        qseqs, quals = fastq.read_paired_for_placement_with_quals(
            cfg.reads1, cfg.reads2 or None)
        freq = sketch_reads_quality(
            qseqs, quals, p.k, p.s, p.t, p.l, p.open, cfg.min_seed_quality,
            trim_start=cfg.trim_start, trim_end=cfg.trim_end)
    elif cfg.seed_mask_fraction > 0:
        # top-fraction masking breaks count ties by insertion order: the
        # order-preserving python sketcher
        from panmap_tpu.place.engine import _sketch_reads_py
        from panmap_tpu.sketch.cpu import hpc_compress

        mseqs = [hpc_compress(x) for x in seqs] if p.hpc else seqs
        freq = _sketch_reads_py(mseqs, p.k, p.s, p.t, p.l, p.open,
                                dedup_reads=cfg.dedup_reads,
                                trim_start=cfg.trim_start,
                                trim_end=cfg.trim_end)
    else:
        freq = sketch_reads(seqs, p.k, p.s, p.t, p.l, p.open,
                            dedup_reads=cfg.dedup_reads,
                            trim_start=cfg.trim_start, trim_end=cfg.trim_end,
                            hpc=p.hpc)
    sk = prepare_read_sketch(freq, p.k, len(seqs),
                             min_read_support=cfg.min_read_support,
                             seed_mask_fraction=cfg.seed_mask_fraction)
    if cfg.dump_seed_freq:
        path = cfg.output + ".seed_freq.tsv"
        with open(path, "w") as fh:
            fh.write("seed_hash\tcount\n")
            for h, c in zip(sk.sorted_hashes.tolist(),
                            np.expm1(sk.log_counts).round().astype(int)
                            .tolist()):
                fh.write(f"{h}\t{c}\n")
        cfg.log(f"[place] wrote {path} ({len(sk.sorted_hashes)} seeds)")
    return sk, len(seqs)


def place(cfg: PipelineConfig, idx, sk, device):
    """PlacementScores of the sketch: TorchPlacer.place_exact on ``device``,
    or the f64 host engine where the JAX package runs it by contract
    (--host-place, --dump-all-scores, --refine, or place_exact refused);
    --verify-scores checks the device result against the host engine."""
    res = None
    if cfg.device_place and not (cfg.dump_all_scores or cfg.refine):
        res = TorchPlacer(idx, device).place_exact(sk,
                                                   force_leaf=cfg.force_leaf)
        if res is None:
            cfg.log("[place] device tie-candidates inconclusive; host engine")
    if res is None:
        res = score_nodes(idx, sk, force_leaf=cfg.force_leaf)
        if cfg.verify_scores:
            cfg.log("[place] verify-scores: SKIPPED — the host f64 "
                    "engine produced this result (no device path to "
                    "cross-check)")
    elif cfg.verify_scores:
        oracle = score_nodes(idx, sk, force_leaf=cfg.force_leaf)
        bad = [m for m in METRICS
               if (res.best_index[m] != oracle.best_index[m]
                   or res.best_score[m] != oracle.best_score[m]
                   or res.tied_indices[m] != oracle.tied_indices[m])]
        if bad:
            cfg.log(f"[place] VERIFY FAILED for metrics {bad}; "
                    f"using the f64 host engine result")
            res = oracle
        else:
            cfg.log("[place] verify-scores: device path == f64 host "
                    "engine on all 5 metrics")
    return res


def run_placement(cfg: PipelineConfig, idx, device):
    """Sketch the reads, place them on the device (exact f64 rescue), write
    <out>.placement.tsv.  Returns (PlacementScores, best node id, n_reads)."""
    sk, n_reads = read_sketch(cfg, idx)
    return _finish_placement(cfg, idx, place(cfg, idx, sk, device), n_reads)


def run_alignment(cfg: PipelineConfig, tree, best_node: str, device,
                  defer_bam: bool = False, prefetch=None, stats=None):
    """Align the reads to the best node's sequence, write <out>.ref.fa and
    <out>.bam; returns (ref, placed) or, with ``defer_bam``, (ref, placed,
    join_fn) with the BAM write still running on a worker thread.  A
    ``stats`` dict receives the device stage's counters: for short reads
    the SW stage's (deferred, device_scored, survivors), for long reads
    (mean length >= 500) the long DP's (items, device_dp, host_dp) and its
    stage seconds."""
    if cfg.aligner == "bwa":  # aDNA whole-read mode: all host code
        return host.run_alignment(cfg, tree, best_node, defer_bam=defer_bam,
                                  prefetch=prefetch)
    ref = tree.get_string(best_node)
    with open(cfg.output + ".ref.fa", "w") as fh:
        fh.write(f">{best_node}\n{ref}\n")
    pre = None
    if prefetch is not None:
        names, seqs, quals, pre = prefetch()
    else:
        names, seqs, quals = fastq.read_paired_for_alignment(
            cfg.reads1, cfg.reads2 or None)
    paired = bool(cfg.reads2)
    t0 = time.time()
    avg_len = sum(len(s) for s in seqs) / max(len(seqs), 1)
    if avg_len >= 500:
        # long reads: preset by mean length (mm_align.c:38-41), unpaired
        lpre = pick_preset(avg_len)
        cfg.log(f"[align] long-read preset {lpre.name} (avg len "
                f"{avg_len:.0f})")
        aligner = TorchLongReadAligner(ref, lpre, device, stats=stats)
        alns = aligner.align_batch(seqs)
        cfg.log(f"[align] {len(seqs)} reads in {time.time()-t0:.1f}s")
        return _emit_records(cfg, names, seqs, quals, alns, ref, best_node,
                             defer_bam)
    aligner = TorchBatchAligner(ref, device, log=cfg.log, stats=stats)
    res = aligner.align_batch_arrays(seqs, pre=pre, deferred_async=True)
    if res is None:
        raise RuntimeError("the native host library (panmap_tpu/native) is "
                           "unavailable; the port's aligner needs it")
    cfg.log(f"[align] {len(seqs)} reads in {time.time()-t0:.1f}s")
    return _emit_columnar(cfg, names, seqs, quals, res, paired, ref,
                          best_node, defer_bam)


def _emit_records(cfg: PipelineConfig, names, seqs, quals, alns,
                  ref: str, best_node: str, defer_bam: bool):
    """BAM records and PlacedReads of single-end alignments (one per read),
    sorted by position, and the BAM write (on a worker thread with
    ``defer_bam``).  A copy of the unpaired half of the block at the end of
    panmap_tpu.pipeline.run_alignment, which keeps it inline."""
    # BAM records (conversion.cpp:390-538 conventions)
    entries = []
    placed = []  # for genotyping: ref-orientation bases of each record

    def clip_name(name):
        if len(name) >= 2 and name[-2] == "/" and name[-1] in "12":
            return name[:-2]
        return name

    for i, aln in enumerate(alns):
        if not aln.mapped:
            continue
        seq = seqs[i]
        lq = len(seq)
        q8 = (np.frombuffer(quals[i].encode(), dtype=np.uint8)
              - 33).astype(np.uint8)
        if aln.rev:
            bam_seq = reverse_complement(seq)
            bam_qual = q8[::-1].tobytes()
        else:
            bam_seq = seq
            bam_qual = q8.tobytes()
        clip5 = (lq - aln.qe) if aln.rev else aln.qs
        clip3 = aln.qs if aln.rev else (lq - aln.qe)
        cigar = []
        if clip5:
            cigar.append((clip5, "S"))
        cigar.extend(aln.cigar)
        if clip3:
            cigar.append((clip3, "S"))
        flag = compute_sam_flags(False, False, aln.rev, False, False, False)
        entries.append(dict(qname=clip_name(names[i]), flag=flag, pos=aln.rs,
                            mapq=aln.mapq, cigar=cigar, mtid=-1, mpos=-1,
                            tlen=0, seq=bam_seq, qual=bam_qual))
        # aln.cigar spans query positions [qs, qe) of the oriented read,
        # which bam_seq / bam_qual already are
        placed.append(PlacedRead(
            rs=aln.rs, cigar=aln.cigar, seq=bam_seq,
            quals=np.frombuffer(bam_qual, dtype=np.uint8).astype(np.int64),
            qs=(lq - aln.qe) if aln.rev else aln.qs,
            qname=clip_name(names[i]), is_proper=aln.proper_frag,
            is_paired=False, mapq=aln.mapq, rev=aln.rev,
            has_clip=bool(clip5 or clip3)))

    order = sorted(range(len(entries)), key=lambda j: entries[j]["pos"])
    entries = [entries[j] for j in order]

    def _write():
        write_bam(cfg.output + ".bam", best_node, len(ref), entries)

    def _wrote():
        cfg.log(f"[align] wrote {len(entries)} records to {cfg.output}.bam")

    if defer_bam:
        th = threading.Thread(target=_write, daemon=True)
        th.start()

        def join_fn():
            th.join()
            _wrote()

        return ref, placed, join_fn
    _write()
    _wrote()
    return ref, placed


def run_genotyping(cfg: PipelineConfig, idx, ref: str, best_node: str,
                   placed):
    """Pileup genotyping with the host tally (the JAX package's stage)."""
    return host.run_genotyping(replace(cfg, device_pileup="off"), idx, ref,
                               best_node, placed)


def run_pipeline(cfg: PipelineConfig, device=None):
    """Run the single-sample pipeline; ``device`` defaults to the first CUDA
    device (a CPU device is for the parity tests)."""
    check_supported(cfg)
    device = as_device(device)
    if cfg.device_pileup == "auto":
        cfg.log("[call] pileup tally on the host (the device tally is not "
                "ported yet)")
    tree = None
    idx, tree = ensure_index(cfg, tree)
    if cfg.export_ref_idx:
        from panmap_tpu.io.refidx import write_ref_index

        write_ref_index(cfg.export_ref_idx, idx,
                        compressed=cfg.index_compressed)
        cfg.log(f"[index] exported reference-format .idx to "
                f"{cfg.export_ref_idx}")
    if cfg.stop == "index" or not cfg.reads1:
        return
    # the tree is needed from the align stage on: load it on a worker
    # thread while placement runs
    tree_box = {}
    tree_thread = None
    if tree is None and cfg.stop != "place":
        def _load():
            try:
                tree_box["tree"] = load_panman(cfg.panman)
            except Exception as exc:  # re-raised by the joining thread
                tree_box["err"] = exc

        tree_thread = threading.Thread(target=_load, daemon=True)
        tree_thread.start()
    align_prefetch = None
    if cfg.stop != "place" and not cfg.refine:
        align_prefetch = _start_align_prefetch(cfg)
    if cfg.reference_node:
        cfg.log(f"[place] placement skipped, forced reference "
                f"{cfg.reference_node}")
        res, best_id = None, cfg.reference_node
    else:
        res, best_id, _ = run_placement(cfg, idx, device)
    if tree_thread is not None:
        tree_thread.join()
        if "err" in tree_box:
            raise tree_box["err"]
        tree = tree_box["tree"]
    if cfg.refine and best_id and res is not None:
        if tree is None:
            tree = load_panman(cfg.panman)
        from panmap_tpu.place.refine import (append_refined_tsv,
                                             refine_top_candidates)

        _, rseqs, _ = fastq.read_paired_for_alignment(cfg.reads1,
                                                      cfg.reads2 or None)
        refined = refine_top_candidates(
            idx, tree, res.scores, res.best_index, rseqs, bool(cfg.reads2),
            top_pct=cfg.refine_top_pct, max_top_n=cfg.refine_max_top_n,
            neighbor_radius=cfg.refine_neighbor_radius,
            max_neighbor_n=cfg.refine_max_neighbor_n, log=cfg.log)
        append_refined_tsv(cfg.output + ".placement.tsv", refined)
    if cfg.stop == "place" or not best_id:
        return
    if tree is None:
        tree = load_panman(cfg.panman)
    ref, placed, bam_join = run_alignment(cfg, tree, best_id, device,
                                          defer_bam=True,
                                          prefetch=align_prefetch)
    if cfg.stop == "align":
        bam_join()
        return
    try:
        final = run_genotyping(cfg, idx, ref, best_id, placed)
    finally:
        bam_join()  # never leave the writer thread orphaned on an error
    if cfg.stop == "genotype":
        return
    run_consensus(cfg, ref, best_id, final)
