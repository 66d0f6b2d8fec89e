"""panmap_tpu_torch CLI: the single-sample pipeline and metagenomic
abundance (--meta) on one GPU.

    python -m panmap_tpu_torch [options] <panman> [reads1] [reads2]

The option surface is panmap_tpu's own (panmap_tpu.__main__.build_parser).
Options whose JAX path runs device code this port does not have yet raise
NotImplementedError naming their ROADMAP item; host-only tools (--simulate,
--dump-*) run the JAX package's host code unchanged.
"""

from __future__ import annotations

import sys

from panmap_tpu.__main__ import build_parser
from panmap_tpu.pipeline import PipelineConfig, default_prefix


def _unsupported(args):
    if args.meta and args.filter_and_assign:
        return ("--meta --filter-and-assign is not ported yet (ROADMAP A: "
                "filter-and-assign)")
    if args.meta and args.batch_file:
        return "--meta --batch is not ported yet (ROADMAP A: batch mode)"
    if args.dist_coordinator or args.dist_nprocs or args.dist_pid >= 0:
        return "--dist-* is not ported yet (ROADMAP B7)"
    return None


def main(argv=None):
    raw = list(sys.argv[1:] if argv is None else argv)
    parser = build_parser()
    parser.prog = "panmap_tpu_torch"
    parser.description = ("pangenome placement, alignment, and genotyping "
                          "on one NVIDIA GPU (PyTorch/CUDA port)")
    if "--help-all" in raw or "-h" in raw or "--help" in raw:
        parser.print_help()
        return 0
    args = parser.parse_args(argv)
    if (args.simulate or args.dump_node or args.dump_random_node_ids > 0
            or args.dump_sequences):
        from panmap_tpu.__main__ import main as host_main

        return host_main(argv)
    why = _unsupported(args)
    if why:
        raise NotImplementedError(why)
    out = args.output or (default_prefix(args.reads1) if args.reads1
                          else "panmap")
    from panmap_tpu.ux import Output

    log = Output(quiet=args.quiet, verbose=args.verbose, plain=args.plain,
                 no_progress=args.no_progress)
    if args.meta:
        return _run_meta(args, out, log)
    cfg = PipelineConfig(
        panman=args.panman, reads1=args.reads1, reads2=args.reads2, output=out,
        index_path=args.index, index_out=args.index_out,
        index_compressed=(args.zstd_level > 0 and not args.index_uncompressed),
        k=args.kmer, s=args.syncmer, t=args.offset,
        l=args.lmer, open=args.open, hpc=args.hpc, flank_mask_bp=args.flank_mask,
        impute=args.impute, extent_guard=args.extent_guard,
        min_depth=args.min_depth, min_qual=args.min_qual,
        min_read_support=args.min_read_support,
        min_seed_quality=args.min_seed_quality,
        reference_node=args.reference_node, reindex=args.reindex,
        seed_mask_fraction=args.seed_mask_fraction,
        aligner=args.aligner,
        refine=args.refine, refine_top_pct=args.refine_top_pct,
        refine_max_top_n=args.refine_max_top_n,
        refine_neighbor_radius=args.refine_neighbor_radius,
        refine_max_neighbor_n=args.refine_max_neighbor_n,
        no_mutation_spectrum=args.no_mutation_spectrum,
        mutation_matrix=args.mutation_matrix,
        baq=args.baq, device_pileup=args.device_pileup,
        dedup_reads=args.dedup_reads, trim_start=args.trim_start,
        trim_end=args.trim_end, force_leaf=args.force_leaf,
        device_place=args.device_place, stop=args.stop,
        threads=args.threads, batch_file=args.batch_file,
        dump_all_scores=args.dump_all_scores,
        dump_seed_freq=args.dump_seed_freq, verify_scores=args.verify_scores,
        profile_dir=args.profile_dir,
        mesh=args.mesh,
        export_ref_idx=args.export_ref_idx,
    )
    cfg.log = log
    from .pipeline import run_pipeline

    return run_pipeline(cfg) or 0


def _run_meta(args, out, log):
    """--meta: MetaConfig field for field as panmap_tpu.__main__ builds it,
    run by the port's run_meta."""
    from .meta.driver import MetaConfig, run_meta

    mcfg = MetaConfig(
        panman=args.panman, reads1=args.reads1, reads2=args.reads2,
        output=out, k=args.kmer, s=args.syncmer, t=args.offset, l=args.lmer,
        open=args.open,
        index_path=args.index, index_out=args.index_out,
        em_convergence_threshold=args.em_convergence_threshold,
        em_delta_threshold=args.em_delta_threshold,
        em_maximum_rounds=args.em_maximum_rounds,
        em_maximum_iterations=args.em_maximum_iterations,
        top_oc=args.top_oc, dust=args.dust, discard=args.discard,
        mask_reads=args.mask_reads, mask_seeds=args.mask_seeds,
        mask_reads_rf=args.mask_reads_rf, mask_seeds_rf=args.mask_seeds_rf,
        amplicon_depth=args.amplicon_depth,
        mask_read_ends=args.mask_read_ends,
        pseudochain=args.pseudochain,
        filter_and_assign=args.filter_and_assign,
        taxonomy_path=args.taxonomic_metadata,
        taxonomic_rank=args.taxonomic_rank,
        max_taxon_number=args.maximum_taxon_number,
        ambiguous_score_threshold=args.ambiguous_score_threshold,
        ambiguous_score_threshold_ratio=args.ambiguous_score_threshold_ratio,
        breadth_ratio=args.breadth_ratio,
        jplace=args.jplace,
        align_reads=args.align_reads,
        min_num_align=args.min_num_align,
        leaves_only=args.leaves_only,
        em_candidates=args.em_candidates,
        write_ocranks=args.write_ocranks,
        write_read_scores_unfiltered=args.write_meta_read_scores_unfiltered,
        write_read_scores_filtered=args.write_meta_read_scores_filtered,
        batch_size=args.batch_size,
        host_score=args.host_score,
        em_f64=args.em_f64,
        mesh=args.mesh,
        threads=args.threads,
        stop=args.stop,
        log=log,
    )
    return run_meta(mcfg)


if __name__ == "__main__":
    try:
        sys.exit(main())
    except KeyboardInterrupt:
        print("interrupted", file=sys.stderr)
        sys.exit(130)
