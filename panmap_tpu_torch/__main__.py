"""panmap_tpu_torch CLI: the single-sample pipeline on one GPU.

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
    if args.meta:
        return "--meta is not ported yet (ROADMAP: meta scorer B5, EM B6)"
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


if __name__ == "__main__":
    try:
        sys.exit(main())
    except KeyboardInterrupt:
        print("interrupted", file=sys.stderr)
        sys.exit(130)
