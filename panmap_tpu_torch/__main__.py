"""panmap_tpu_torch CLI on NVIDIA GPUs: the single-sample pipeline, batch
mode (--batch), metagenomic abundance (--meta), read assignment (--meta
--filter-and-assign) and their batch form (--meta --batch), with --mesh
(sharded placement scoring, meta scoring and EM), --dist-* (a process
group over torch.distributed, one rank per card) and --profile (a
torch.profiler trace).

    python -m panmap_tpu_torch [options] <panman> [reads1] [reads2]

The option surface is panmap_tpu's own (build_parser is carried over
unchanged, so both CLIs parse the same command lines); the host-only tools
(--simulate, --dump-*) run the carried simulate.py / tools.py.
"""

from __future__ import annotations

import argparse
import sys

from . import __version__, trace
from .pipeline import PipelineConfig, default_prefix


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="panmap_tpu",
        description="TPU-native pangenome placement, alignment, and genotyping",
    )
    p.add_argument("panman", help="PanMAN file")
    p.add_argument("reads1", nargs="?", default="", help="reads (FASTQ/FASTA, optionally .gz)")
    p.add_argument("reads2", nargs="?", default="", help="mate reads")
    p.add_argument("-o", "--output", default="", help="output prefix")
    p.add_argument("-t", "--threads", type=int, default=0, help="threads (advisory)")
    p.add_argument("--mesh", type=int, default=0, metavar="N",
                   help="shard device scoring over N chips (0 = auto: all "
                        "local devices when more than one; 1 = single device)")
    p.add_argument("--dist-coordinator", default="", metavar="HOST:PORT",
                   help="jax.distributed coordinator address (multi-host: one "
                        "process per host; see panmap_tpu/parallel/dist.py)")
    p.add_argument("--dist-nprocs", type=int, default=0, metavar="N",
                   help="total number of processes in the multi-host job")
    p.add_argument("--dist-pid", type=int, default=-1, metavar="I",
                   help="this process's id in the multi-host job")
    p.add_argument("-V", "--version", action="version",
                   version=f"panmap-tpu {__version__}")
    p.add_argument("--stop", default="", choices=["", "index", "place", "align", "genotype", "consensus"],
                   help="stop after this stage")
    p.add_argument("--batch", default="", dest="batch_file",
                   help="batch manifest: one sample per line, 'reads1 [reads2] [prefix]'")

    g = p.add_argument_group("index & seeding")
    g.add_argument("-k", "--kmer", type=int, default=19, help="syncmer k")
    g.add_argument("-s", "--syncmer", type=int, default=8, help="syncmer s")
    g.add_argument("--offset", type=int, default=0, help="syncmer offset t")
    g.add_argument("-l", "--lmer", type=int, default=3, help="syncmers per seed")
    g.add_argument("--open", "--open-syncmer", action="store_true",
                   help="open syncmers")
    g.add_argument("--hpc", action="store_true", help="homopolymer-compressed seeds")
    g.add_argument("--flank-mask", type=int, default=250, help="mask bp at genome ends")
    g.add_argument("--extent-guard", action="store_true",
                   help="guard seed deletions at genome extent boundaries")
    g.add_argument("--impute", action="store_true",
                   help="impute N's from parent (skip canonical->ambiguous mutations)")
    g.add_argument("-i", "--index", default="", help="index path override")
    g.add_argument("--index-out", default="",
                   help="write the built index to this path "
                        "(default: next to the panman)")
    g.add_argument("--export-ref-idx", default="", metavar="PATH",
                   help="also write the index in the REFERENCE binary's "
                        ".idx format (PMI1 + LiteIndex capnp) for interop")
    g.add_argument("--zstd-level", type=int, default=-1,
                   help="index container compression level; >0 stores the "
                        "index compressed instead of mmap-friendly raw")
    g.add_argument("--index-uncompressed", action="store_true",
                   help="store the index uncompressed so it is mmap'd on load "
                        "(the default here; kept for drop-in parity)")
    g.add_argument("--index-packed", action="store_true",
                   help=argparse.SUPPRESS)  # capnp-specific in the reference; no-op
    g.add_argument("--read-packed", action="store_true",
                   help=argparse.SUPPRESS)  # capnp-specific in the reference; no-op

    g = p.add_argument_group("single-sample")
    g.add_argument("--min-depth", type=int, default=1)
    g.add_argument("--min-qual", type=float, default=30.0)
    g.add_argument("--min-read-support", type=int, default=-1)
    g.add_argument("--min-seed-quality", type=float, default=0.0,
                   help="drop seeds whose mean Phred quality is below N")
    g.add_argument("--reference-node", default="",
                   help="skip placement; use this node as the reference")
    g.add_argument("-f", "--reindex", action="store_true",
                   help="rebuild the index even if a valid cache exists")
    g.add_argument("--seed-mask-fraction", type=float, default=0.0)
    g.add_argument("--dedup", action="store_true", dest="dedup_reads")
    g.add_argument("--trim-start", type=int, default=0)
    g.add_argument("--trim-end", type=int, default=0)
    g.add_argument("--force-leaf", action="store_true")
    g.add_argument("--device-place", action="store_true", default=True,
                   help="device placement scoring with exact f64 rescue of "
                        "the tie candidates (DEFAULT; byte-identical to the "
                        "host engine)")
    g.add_argument("--host-place", action="store_false", dest="device_place",
                   help="force the all-host f64 placement engine")
    g.add_argument("-a", "--aligner", default="minimap2", choices=["minimap2", "bwa"],
                   help="alignment backend (bwa = whole-read ancient-DNA mode)")
    g.add_argument("--refine", action="store_true",
                   help="alignment-based refinement of top placement candidates")
    g.add_argument("--refine-top-pct", type=float, default=0.01)
    g.add_argument("--refine-max-top-n", type=int, default=150)
    g.add_argument("--refine-neighbor-radius", type=int, default=2)
    g.add_argument("--refine-max-neighbor-n", type=int, default=150)
    g.add_argument("--baq", action="store_true",
                   help="enable BAQ (base alignment quality) in the pileup")
    g.add_argument("--no-mutation-spectrum", action="store_true",
                   help="disable mutation-spectrum priors in genotyping")
    g.add_argument("--mutation-matrix", default="",
                   help=".mm mutation-matrix file overriding the index spectrum")
    g.add_argument("--device-pileup", default="auto",
                   choices=["auto", "on", "off"],
                   help="genotype pileup tallies on the accelerator "
                        "(auto: on for locally-attached devices)")

    g = p.add_argument_group("metagenomic")
    g.add_argument("--meta", action="store_true", help="metagenomic mode")
    g.add_argument("--filter-and-assign", action="store_true")
    g.add_argument("--pseudochain", action="store_true",
                   help="colinear pseudo-chain read scoring (default: presence counts)")
    g.add_argument("--em-convergence-threshold", type=float, default=1e-5)
    g.add_argument("--em-delta-threshold", type=float, default=0.0)
    g.add_argument("--em-maximum-rounds", type=int, default=5)
    g.add_argument("--em-maximum-iterations", type=int, default=1000)
    g.add_argument("--em-f64", action="store_true",
                   help="run the abundance EM in host float64 (the "
                        "reference's precision; bounds f32 drift risk)")
    g.add_argument("--top-oc", type=int, default=1000)
    g.add_argument("--dust", type=float, default=100.0)
    g.add_argument("--discard", type=float, default=0.0)
    g.add_argument("--mask-reads", type=int, default=0,
                   help="mask reads containing k-min-mers with occurrence <= N")
    g.add_argument("--mask-seeds", type=int, default=0,
                   help="mask query k-min-mers with occurrence <= N")
    g.add_argument("--mask-reads-relative-frequency", type=float, default=0.0,
                   dest="mask_reads_rf")
    g.add_argument("--mask-seeds-relative-frequency", type=float, default=0.0,
                   dest="mask_seeds_rf")
    g.add_argument("--amplicon-depth", default="",
                   help="readId<TAB>primerId TSV for per-amplicon masking")
    g.add_argument("--mask-read-ends", type=int, default=0,
                   help="trim N bases from both read ends (aDNA damage)")
    g.add_argument("--taxonomic-metadata", default="")
    g.add_argument("--taxonomic-rank", default="Family")
    g.add_argument("--maximum-taxon-number", type=int, default=1)
    g.add_argument("--ambiguous-score-threshold", type=int, default=0)
    g.add_argument("--ambiguous-score-threshold-ratio", type=float, default=0.0)
    g.add_argument("--breadth-ratio", action="store_true")
    g.add_argument("--jplace", action="store_true")
    g.add_argument("--align-reads", action="store_true",
                   help="align assigned reads to their nodes (meta filter-and-assign)")
    g.add_argument("--min-num-align", type=int, default=10)
    g.add_argument("--em-leaves-only", "--leaves-only", action="store_true",
                   dest="leaves_only", help="only run EM on leaf (sample) nodes")
    g.add_argument("--write-ocranks", action="store_true",
                   help="write overlap-coefficient ranks to TSV")
    g.add_argument("--write-meta-read-scores-unfiltered", action="store_true")
    g.add_argument("--write-meta-read-scores-filtered", action="store_true")
    g.add_argument("--host-score", action="store_true",
                   help="meta scoring on the threaded native CPU core "
                        "instead of the device scorer")
    g.add_argument("--batch-size", type=int, default=1000000,
                   help="reads per processing batch (meta filter-and-assign)")

    g = p.add_argument_group("developer")
    g.add_argument("--em-candidates", default="",
                   help="file of node ids (one per line): restrict the "
                        "abundance EM to exactly these haplotype columns")
    g.add_argument("--dump-all-scores", default="")
    g.add_argument("--dump-seed-freq", action="store_true",
                   help="write <out>.seed_freq.tsv (kept read seeds + counts)")
    g.add_argument("--verify-scores", action="store_true",
                   help="cross-check device placement against the f64 host "
                        "engine (placement.cpp verify_scores mode)")
    g.add_argument("--dump-node", "--dump-sequence", default="",
                   help="write one node's sequence as FASTA")
    g.add_argument("--dump-random-nodeIDs", type=int, default=0,
                   dest="dump_random_node_ids")
    g.add_argument("--dump-sequences", nargs="+", default=[],
                   help="node id groups to dump (optionally with --simulate-snps)")
    g.add_argument("--simulate-snps", nargs="+", type=int, default=[],
                   help="SNP counts matching --dump-sequences positions")
    g.add_argument("--random-seed", default="")
    g.add_argument("--seed", type=int, default=42,
                   help="integer random seed (used when --random-seed is unset)")
    g.add_argument("--simulate", action="store_true",
                   help="mutation/read simulator: mutate a node per the "
                        "spectrum, write truth VCF + FASTA + reads")
    g.add_argument("--sim-ref", default="RANDOM",
                   help="node to mutate (RANDOM = sample leaves w/o replacement)")
    g.add_argument("--mutnum", nargs=3, type=float, default=[10, 0, 0],
                   metavar=("SNP", "INS", "DEL"),
                   help="mutation counts per replicate")
    g.add_argument("--indel-len", nargs=2, type=int, default=[1, 9],
                   metavar=("MIN", "MAX"))
    g.add_argument("--mut-spec-type", default="",
                   choices=["", "snp", "indel", "both"],
                   help="model mutations with --mutation-matrix")
    g.add_argument("--mutation-rate", type=float, default=-1.0,
                   help="scale factor applied to the SNP count")
    g.add_argument("--rep", type=int, default=1, help="replicates")
    g.add_argument("--n-reads", type=int, default=2000)
    g.add_argument("--sim-model", default="NovaSeq",
                   choices=["HiSeq", "NextSeq", "NovaSeq", "MiSeq"],
                   help="read error model")
    g.add_argument("--no-reads", action="store_true",
                   help="simulate mutations only, skip read generation")
    g.add_argument("--profile", default="", dest="profile_dir", metavar="DIR",
                   help="write a jax.profiler device trace to DIR")
    g.add_argument("-q", "--quiet", action="store_true")
    g.add_argument("-v", "--verbose", action="store_true",
                   help="extra detail lines (timings, counters)")
    g.add_argument("--plain", "--no-color", action="store_true",
                   help="no ANSI color/progress (also honors NO_COLOR)")
    g.add_argument("--no-progress", action="store_true",
                   help="disable progress bars")
    return p


def main(argv=None):
    """Parse, join a process group when --dist-* or the torchrun
    environment asks for one (before any device use), run, and leave the
    group again."""
    from .parallel import dist

    try:
        return _main(argv)
    finally:
        dist.shutdown()


def _main(argv):
    raw = list(sys.argv[1:] if argv is None else argv)
    parser = build_parser()
    parser.prog = "panmap_tpu_torch"
    parser.description = ("pangenome placement, alignment, and genotyping "
                          "on NVIDIA GPUs (PyTorch/CUDA port)")
    if "--help-all" in raw or "-h" in raw or "--help" in raw:
        parser.print_help()
        return 0
    args = parser.parse_args(argv)
    out = args.output or (default_prefix(args.reads1) if args.reads1
                          else "panmap")
    from .ux import Output

    log = Output(quiet=args.quiet, verbose=args.verbose, plain=args.plain,
                 no_progress=args.no_progress)
    if not args.random_seed and args.seed != 42:
        args.random_seed = str(args.seed)

    from .parallel.dist import maybe_initialize

    maybe_initialize(args.dist_coordinator, args.dist_nprocs, args.dist_pid,
                     log=log)

    if args.simulate:
        from .simulate import run_simulate

        return run_simulate(
            args.panman, args.sim_ref, out, args.mutnum, args.indel_len,
            args.mutation_matrix, args.mut_spec_type, args.mutation_rate,
            args.rep, args.n_reads, args.sim_model, args.no_reads,
            args.random_seed, log)

    if args.dump_node:
        from .tools import run_dump_node

        return run_dump_node(args.panman, args.dump_node, args.output, log)
    if args.dump_random_node_ids > 0:
        from .tools import run_dump_random_node_ids

        return run_dump_random_node_ids(args.panman, args.dump_random_node_ids,
                                        out, args.random_seed, log)
    if args.dump_sequences:
        from .tools import run_dump_sequences

        return run_dump_sequences(args.panman, args.dump_sequences,
                                  args.simulate_snps, out, args.random_seed, log)

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
    run by the port's run_meta (inside a torch.profiler session with
    --profile DIR, as run_pipeline runs the other modes)."""
    from .meta.driver import MetaConfig

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
    with trace.profiled(args.profile_dir, log):
        return _meta_samples(args, mcfg, log)


def _meta_samples(args, mcfg, log):
    """run_meta on the sample of the command line, or on each sample of its
    --batch manifest over one meta index."""
    from .meta.driver import run_meta

    if args.batch_file:
        # --batch works in both modes (main.cpp:2424-2443): meta loops the
        # run per sample; the index (and here also the in-memory arrays)
        # is shared across samples.
        from dataclasses import replace as _dc_replace

        from .meta.driver import ensure_meta_index
        from .pipeline import read_batch_file

        try:
            entries = read_batch_file(args.batch_file)
        except (OSError, FileNotFoundError) as exc:
            log.fail("batch", str(exc))
            return 1
        with trace.span("index.read"):
            midx, _ = ensure_meta_index(mcfg)
        if args.stop == "index":
            return 0
        for i, (r1, r2, prefix) in enumerate(entries):
            if len(entries) > 1:
                log(f"[{i + 1}/{len(entries)}] {r1} -> {prefix}")
            scfg = _dc_replace(mcfg, reads1=r1, reads2=r2, output=prefix)
            with trace.span("batch.sample", sample=i + 1):
                rc = run_meta(scfg, midx=midx)
            if rc:
                return rc
        return 0
    return run_meta(mcfg)


if __name__ == "__main__":
    try:
        sys.exit(main())
    except KeyboardInterrupt:
        print("interrupted", file=sys.stderr)
        sys.exit(130)
