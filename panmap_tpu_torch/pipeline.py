"""Single-sample pipeline on the GPU: index -> place -> align ->
genotype -> consensus, and its batch mode over a manifest of samples
(counterpart of panmap_tpu/pipeline.py).

Stage structure and artifact naming mirror the reference CLI
(src/main.cpp:2408-2507 stage machine, runPlacement/runAlignment/runGenotyping/
runConsensus): <prefix>.placement.tsv, .ref.fa, .bam, .vcf, .consensus.fa.

The host stages are carried over from the JAX package unchanged: the index
cache (ensure_index), the placement TSV, the alignment prefetch, the
columnar BAM emit and the record path, genotyping and consensus.  The
stages that touch the device are the port's:

 - run_placement: TorchPlacer.place_exact (device scoring + exact f64
   rescue); the host engine runs only where the JAX package runs it by
   contract (place_exact returned None, --host-place, --dump-all-scores,
   --refine, --verify-scores);
 - run_alignment: TorchBatchAligner (deferred windows on the SW kernel)
   for short reads, TorchLongReadAligner (the banded DP rows on the
   long-read kernel) for long reads;
 - run_genotyping: the per-column pileup tallies on the device
   (genotype.caller.tally_columns_device) under --device-pileup on, and
   under auto on a CUDA device;
 - run_batch: one TorchPlacer for the run, placement pipelined across the
   samples on the device, the host stages of each sample in a pre-forked
   pool of workers that never touch the device; in a process group each
   rank takes its contiguous shard of the manifest;
 - --mesh (_resolve_mesh): the placer's index rows shard over the run's
   cards, or over every rank's card in a process group (parallel/);
 - --profile: the run inside torch.profiler, its trace written to the
   directory.

Not carried, since they served only a remote TPU link: the backend warm-up,
the watchdog, the one-shot remote policy and the cold-dispatch race.  Nor
the JAX package's process-wide placer cache: batch mode holds one placer
for its run, and a single-sample run uploads its index once anyway.
"""

from __future__ import annotations

import os
import threading
import time
from dataclasses import dataclass

import numpy as np

from . import native
from .genotype.caller import (
    ColumnarReads,
    PlacedRead,
    apply_spectrum,
    build_consensus,
    phred_scale_matrix,
    pileup_call,
    pileup_call_columnar,
    write_vcf,
)
from .index.builder import IndexArrays, IndexParams, build_index
from .io import fastq
from .io.bam import compute_sam_flags, compute_tlen, write_bam
from .io.index_io import load_index, read_index_params, save_index
from .io.panman import PanmanTree, load_panman
from .place.engine import (
    METRICS,
    prepare_read_sketch,
    score_nodes,
    sketch_reads,
    write_placement_tsv,
)
from .place.query_torch import TorchPlacer
from .sketch.cpu import reverse_complement
from .utils.device import as_device


@dataclass
class PipelineConfig:
    panman: str = ""
    reads1: str = ""
    reads2: str = ""
    output: str = "sample"
    index_path: str = ""  # default: <panman>.ptidx.npz
    index_out: str = ""  # write the built index here instead of next to the panman
    index_compressed: bool = False  # compressed container (--zstd-level analog)
    k: int = 19
    s: int = 8
    t: int = 0
    l: int = 3
    open: bool = False
    hpc: bool = False
    flank_mask_bp: int = 250
    impute: bool = False  # skip canonical->ambiguous mutations in indexing
    extent_guard: bool = False  # guard seed deletions at genome extent boundaries
    min_depth: int = 1
    min_qual: float = 30.0
    min_read_support: int = -1
    min_seed_quality: float = 0.0
    reference_node: str = ""  # skip placement, use this node
    reindex: bool = False  # ignore any cached index
    seed_mask_fraction: float = 0.0
    dedup_reads: bool = False
    trim_start: int = 0
    trim_end: int = 0
    force_leaf: bool = False
    device_place: bool = True  # DEFAULT: device scoring + exact f64 rescue
    aligner: str = "minimap2"  # minimap2 | bwa (aDNA whole-read mode)
    refine: bool = False
    refine_top_pct: float = 0.01
    refine_max_top_n: int = 150
    refine_neighbor_radius: int = 2
    refine_max_neighbor_n: int = 150
    no_mutation_spectrum: bool = False
    mutation_matrix: str = ""  # .mm file overriding the index spectrum
    baq: bool = False  # probabilistic realignment quality caps in pileup
    stop: str = ""  # "", "index", "place", "align", "genotype"
    threads: int = 0
    mesh: int = 0  # devices for sharded scoring: 0=auto(all>1), 1=off, N=N
    local_mesh_only: bool = False  # pin meshes to this process's devices
    # (set by manifest-sharded batch mode; see _resolve_mesh)
    device_pileup: str = "auto"  # genotype tallies on device: auto|on|off
    # (auto = local accelerator only; see genotype.caller.resolve_device_pileup)
    export_ref_idx: str = ""  # write the index in the reference .idx format
    batch_file: str = ""
    profile_dir: str = ""  # torch.profiler trace output dir (--profile)
    dump_all_scores: str = ""
    dump_seed_freq: bool = False  # write <out>.seed_freq.tsv (placement.cpp:1804)
    verify_scores: bool = False  # device vs f64-host-engine cross-check
    log: object = print


def default_prefix(reads1: str) -> str:
    """Output-prefix derivation from the reads filename (main.cpp:2253-2276)."""
    base = os.path.basename(reads1)
    for suf in (".gz",):
        if base.endswith(suf):
            base = base[: -len(suf)]
    for suf in (".fastq", ".fq", ".fasta", ".fa"):
        if base.endswith(suf):
            base = base[: -len(suf)]
    for suf in ("_R1", "_R2", "_1", "_2", ".R1", ".R2"):
        if base.endswith(suf):
            base = base[: -len(suf)]
    return base or "sample"


def _npz_cache_usable(cfg: PipelineConfig, path: str) -> bool:
    """ONE definition of ensure_index's load-vs-build predicate (params must
    match, index newer than panman) — shared with index_cache_ready so the
    early backend warmup can never fire before a build that forks."""
    if cfg.reindex or not os.path.exists(path):
        return False
    try:
        want = dict(k=cfg.k, s=cfg.s, t=cfg.t, l=cfg.l, open=cfg.open,
                    hpc=cfg.hpc, flank_mask_bp=cfg.flank_mask_bp,
                    impute_amb=cfg.impute, extent_guard=cfg.extent_guard)
        hdr = read_index_params(path)
        return (all(hdr.get(key, False) == val for key, val in want.items())
                and os.path.getmtime(path) >= os.path.getmtime(cfg.panman))
    except Exception:
        return False


def ensure_index(cfg: PipelineConfig, tree: PanmanTree | None = None):
    """Build-or-load the index next to the panman (cache semantics of
    main.cpp:371-396: params must match, index newer than panman)."""
    path = cfg.index_path or cfg.index_out or cfg.panman + ".ptidx.npz"
    # interoperability: --index pointing at a REFERENCE-BUILT .idx ("PMI1"
    # header) loads through the compatibility reader (io/refidx.py) so a
    # reference user's existing index drives placement directly
    if cfg.index_path and os.path.exists(cfg.index_path):
        with open(cfg.index_path, "rb") as _fh:
            magic = _fh.read(4)
        if magic == b"PMI1":
            from .io.refidx import read_ref_index

            idx = read_ref_index(cfg.index_path)
            cfg.log(f"[index] loaded reference .idx "
                    f"({len(idx.seed_hashes)} seed changes, "
                    f"{len(idx.node_ids)} nodes)")
            # index params are authoritative at use time (the reference
            # overrides CLI from the index, placement.cpp:1094-1101) — but a
            # silent disagreement with configured seeding flags is a footgun,
            # so mirror the npz path's validation with a loud warning
            p = idx.params
            got = dict(k=p.k, s=p.s, t=p.t, l=p.l, open=p.open, hpc=p.hpc)
            cli = dict(k=cfg.k, s=cfg.s, t=cfg.t, l=cfg.l, open=cfg.open,
                       hpc=cfg.hpc)
            diff = {key: (cli[key], got[key]) for key in got
                    if cli[key] != got[key]}
            if diff:
                cfg.log("[index] warning: configured seeding params disagree "
                        "with the loaded reference index and are IGNORED "
                        "(index is authoritative): " + ", ".join(
                            f"{key}={a}->index {b}"
                            for key, (a, b) in sorted(diff.items())))
            return idx, tree
    want = dict(k=cfg.k, s=cfg.s, t=cfg.t, l=cfg.l, open=cfg.open, hpc=cfg.hpc,
                flank_mask_bp=cfg.flank_mask_bp, impute_amb=cfg.impute,
                extent_guard=cfg.extent_guard)

    if _npz_cache_usable(cfg, path):
        return load_index(path), tree
    # a process group: only rank 0 builds the shared cache (save_index
    # publishes it with an atomic rename); the others poll for it and build
    # it themselves only on timeout (the same content, replaced atomically)
    from .parallel.dist import process_rank_safe

    pid, nproc = process_rank_safe()
    if nproc > 1 and pid != 0 and not cfg.reindex:
        wait_s = float(os.environ.get("PANMAP_TPU_INDEX_WAIT_S", "900"))
        cfg.log(f"[index] process {pid}: waiting for process 0 to build "
                f"{path} (up to {wait_s:.0f}s)")
        deadline = time.time() + wait_s
        while time.time() < deadline:
            if _npz_cache_usable(cfg, path):
                return load_index(path), tree
            time.sleep(2.0)
        cfg.log(f"[index] process {pid}: cache did not appear; building "
                f"locally")
    if tree is None:
        tree = load_panman(cfg.panman)
    t0 = time.time()
    prog_state = {}

    def _prog(done, total):
        if not hasattr(cfg.log, "progress"):
            return
        bar = prog_state.get("bar")
        if bar is None:
            bar = prog_state["bar"] = cfg.log.progress("index build", total)
        bar.update(done - bar.n)

    idx = build_index(tree, IndexParams(**want), progress=_prog,
                      workers=cfg.threads or (os.cpu_count() or 1))
    if "bar" in prog_state:
        prog_state["bar"].close()
    cfg.log(f"[index] built in {time.time()-t0:.1f}s "
            f"({len(idx.seed_hashes)} seed changes, {len(idx.node_ids)} nodes)")
    try:
        save_index(path, idx, compressed=cfg.index_compressed)
    except OSError:
        cfg.log(f"[index] warning: could not cache index at {path}")
    return idx, tree


def _resolve_mesh(cfg: PipelineConfig):
    """--mesh semantics: 0 = auto (shard over every card of the run when
    there is more than one), 1 = one device, N > 1 = N shards (a request
    above the cards is logged and capped).  Returns a parallel.mesh.Mesh or
    None.

    The manifest-sharded batch mode (a process group, other samples on each
    rank) pins the mesh to this process's cards: a mesh reduced over the
    ranks would add up partial sums of different samples.  A single sample
    in a process group keeps the global mesh (every rank runs the same
    sample, the rows shard over the ranks)."""
    from .parallel.mesh import global_device_count, make_mesh

    local_only = bool(cfg.local_mesh_only)
    n_avail = global_device_count(local_only)
    want = cfg.mesh if cfg.mesh > 0 else (n_avail if n_avail > 1 else 1)
    if want <= 1:
        return None
    if want > n_avail:
        cfg.log(f"[mesh] {want} devices requested, {n_avail} available; "
                f"using {n_avail}")
        want = n_avail
    return make_mesh(want, local=local_only)


def _get_placer(idx: IndexArrays, cfg: PipelineConfig, device):
    """A TorchPlacer of ``idx`` (one index upload) on ``device``, or on the
    mesh --mesh resolves to, whose first card it then is.  CPU tensors (a
    caller's choice, as the parity tests make it) get no mesh."""
    mesh = _resolve_mesh(cfg) if device.type == "cuda" else None
    if mesh is not None:
        device = mesh.devices[0]
        cfg.log(f"[mesh] index rows sharded over {mesh.size} shards "
                f"({len(mesh.devices)} in this process)")
    return TorchPlacer(idx, device, mesh=mesh)


def read_sketch(cfg: PipelineConfig, idx):
    """The reads' placement sketch under the index's parameters (the
    sketch branches of panmap_tpu.pipeline.run_placement).  Returns
    (ReadSketch, n_reads)."""
    p = idx.params
    seqs = fastq.read_paired_for_placement(cfg.reads1, cfg.reads2 or None)
    if cfg.min_seed_quality > 0:
        from .place.engine import sketch_reads_quality

        qseqs, quals = fastq.read_paired_for_placement_with_quals(
            cfg.reads1, cfg.reads2 or None)
        freq = sketch_reads_quality(
            qseqs, quals, p.k, p.s, p.t, p.l, p.open, cfg.min_seed_quality,
            trim_start=cfg.trim_start, trim_end=cfg.trim_end)
    elif cfg.seed_mask_fraction > 0:
        # top-fraction masking breaks count ties by insertion order: the
        # order-preserving python sketcher
        from .place.engine import _sketch_reads_py
        from .sketch.cpu import hpc_compress

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


def place_async(cfg: PipelineConfig, idx, sk, device, placer=None):
    """PlacementScores of the sketch, in two halves: the device selection
    program (TorchPlacer.place_exact_async on ``device``) is enqueued here
    and a zero-arg finisher is returned, which waits for it and completes
    the exact f64 rescue; or the finisher runs the f64 host engine where the
    JAX package runs it by contract (--host-place, --dump-all-scores,
    --refine, or place_exact refused).  --verify-scores checks the device
    result against the host engine.  ``placer``: a TorchPlacer of ``idx`` to
    reuse (batch mode holds one for the run); built here otherwise, which
    uploads the index."""
    fin0 = None
    if cfg.device_place and not (cfg.dump_all_scores or cfg.refine):
        if placer is None:
            placer = _get_placer(idx, cfg, device)
        fin0 = placer.place_exact_async(sk, force_leaf=cfg.force_leaf)
    return lambda: _place_finish(cfg, idx, sk, fin0)


def _place_finish(cfg: PipelineConfig, idx, sk, fin0):
    res = None
    if fin0 is not None:
        res = fin0()
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


def run_placement(cfg: PipelineConfig, idx, device, placer=None,
                  _async: bool = False):
    """Sketch the reads, place them on the device (exact f64 rescue), write
    <out>.placement.tsv.  Returns (PlacementScores, best node id, n_reads);
    with ``_async`` a zero-arg finisher that returns them: the device
    selection program is then in flight, and batch mode sketches the next
    sample under it.  ``placer``: see place_async()."""
    sk, n_reads = read_sketch(cfg, idx)
    fin = place_async(cfg, idx, sk, device, placer)

    def finish():
        return _finish_placement(cfg, idx, fin(), n_reads)

    return finish if _async else finish()


def _finish_placement(cfg: PipelineConfig, idx: IndexArrays, res, n_reads: int):
    write_placement_tsv(cfg.output + ".placement.tsv", idx, res)
    if cfg.dump_all_scores:
        # main.cpp:1720-1742: positive-score nodes, descending logRaw
        s = res.scores
        keep = (s[:, 0] > 0) | (s[:, 1] > 0) | (s[:, 2] > 0) | (s[:, 4] > 0)
        order = np.flatnonzero(keep)[np.argsort(-s[keep, 0], kind="stable")]
        with open(cfg.dump_all_scores, "w") as fh:
            fh.write("node\tlogRaw\tlogCosine\tcontainment\tlogContainment\n")
            for i in order:
                fh.write(f"{idx.node_ids[i]}\t{s[i,0]:g}\t{s[i,1]:g}"
                         f"\t{s[i,2]:g}\t{s[i,4]:g}\n")
        cfg.log(f"[place] dumped {len(order)} node scores to {cfg.dump_all_scores}")
    best = res.best_index["log_containment"]
    best_id = idx.node_ids[best] if best is not None else ""
    cfg.log(f"[place] best log_containment node: {best_id} "
            f"({res.best_score['log_containment']:.4f})")
    return res, best_id, n_reads


_RC_LUT = np.full(256, ord("N"), dtype=np.uint8)
for _a, _b in zip(b"ACGTacgtNn", b"TGCATGCANN"):
    _RC_LUT[_a] = _b


def _clip_names(names, idx):
    out = []
    for i in idx:
        nm = names[i]
        if len(nm) >= 2 and nm[-2] == "/" and nm[-1] in "12":
            nm = nm[:-2]
        out.append(nm)
    return out


def _columnar_to_placed(cols):
    """PlacedRead objects from the columnar set (the BAQ path needs per-read
    realignment; cigars exclude the soft clips, qs carries the 5' clip).
    Clip geometry is derived from the cigar stream itself."""
    ops = cols.stream & np.uint32(0xF)
    lns = (cols.stream >> np.uint32(4)).astype(np.int64)
    coff = cols.coff
    first = coff[:-1]
    nonempty = coff[1:] > first
    has5 = (nonempty & (ops[np.minimum(first, max(len(ops) - 1, 0))] == 4)) \
        .astype(np.int64)
    last = np.maximum(coff[1:] - 1, 0)
    has3 = (nonempty & (ops[last] == 4)
            & (coff[1:] - first - has5 > 0)).astype(np.int64)
    nc = (coff[1:] - first) - has5 - has3
    qs_arr = np.where(has5 == 1, lns[np.minimum(first, max(len(lns) - 1, 0))],
                      0)
    has_clip = (has5 | has3) > 0

    q64 = cols.qual_blob.astype(np.int64)
    all_ln = lns.tolist()
    all_op = np.frombuffer(b"MIDNSHP=X", "S1")[ops]
    all_op = [x.decode() for x in all_op.tolist()]
    seq_all = cols.seq_blob.tobytes().decode()
    eoff_l = cols.soff.tolist()
    c0_l = (first + has5).tolist()
    c1_l = (first + has5 + nc).tolist()
    placed = []
    for r in range(len(cols.rs)):
        a, b = eoff_l[r], eoff_l[r + 1]
        c0, c1 = c0_l[r], c1_l[r]
        placed.append(PlacedRead(
            rs=int(cols.rs[r]), cigar=list(zip(all_ln[c0:c1], all_op[c0:c1])),
            seq=seq_all[a:b], quals=q64[a:b], qs=int(qs_arr[r]),
            qname=cols.qnames[r], is_proper=bool(cols.proper[r]),
            is_paired=cols.paired, mapq=int(cols.mapq[r]),
            rev=bool(cols.rev[r]), has_clip=bool(has_clip[r])))
    return placed


def _emit_columnar(cfg, names, seqs, quals, res, paired, ref, best_node,
                   defer_bam):
    """Columnar twin of the add_record/write_bam object path (which remains
    the oracle; tests/test_bam_batch.py + the golden e2e suite cross-check):
    pairing, flags, TLEN, clips, oriented seq/qual blobs and the full BAM
    stream are built as array programs; only PlacedRead construction (the
    genotyping input) stays a slim per-record loop."""
    from .align.core import MAX_GAP_REF
    from .io.bam import (BGZF_EOF, FMREVERSE, FPAIRED, FPROPER_PAIR, FREAD1,
                         FREAD2, FREVERSE, _bgzf_compress_parallel,
                         _write_bai, encode_bam_columnar)
    import struct as _struct

    from .native import join_reads, oriented_blobs_native

    # res-independent prep FIRST: while the joined read/qual buffers build,
    # the deferred Pallas window dispatch (res["_fin"]) is still in flight —
    # its device round-trip hides under this host work
    joined, roffs, _ = join_reads(seqs)
    jq = np.frombuffer("".join(quals).encode(), np.uint8)
    fin = res.pop("_fin", None)
    if fin is not None:
        fin()  # blocks on device scores; survivor host DP + overflow redo

    n = len(seqs)
    lens = res["lens"].astype(np.int64)
    mapped = res["mapped"] == 1
    rev = res["rev"].astype(bool)
    rs = res["rs"].astype(np.int64)
    re_ = res["re"].astype(np.int64)
    qs_o = res["qs"].astype(np.int64)
    qe_o = res["qe"].astype(np.int64)
    mapqs = res["mapq"].astype(np.int64)
    ncig0 = res["ncig"].astype(np.int64)
    cig = res["cig"]
    extra = res["extra_cigars"]
    for i, cg in extra.items():
        ncig0[i] = len(cg)

    if paired:
        m1, m2 = mapped[0::2], mapped[1::2]
        both = m1 & m2
        r1, r2 = rev[0::2], rev[1::2]
        same = r1 == r2
        fwd_ok = (~r1) & (rs[0::2] <= rs[1::2]) \
            & (rs[1::2] - re_[0::2] <= MAX_GAP_REF)
        rev_ok = r1 & (rs[1::2] <= rs[0::2]) \
            & (rs[0::2] - re_[1::2] <= MAX_GAP_REF)
        proper_pair = both & same & (fwd_ok | rev_ok)
        emit = np.flatnonzero(np.repeat(both, 2))
        is_r1 = emit % 2 == 0
        mate = emit ^ 1
        proper_rec = np.repeat(proper_pair, 2)[emit]
        eff_rev = np.where(is_r1, rev[emit], ~rev[emit])
        mate_eff = np.where(is_r1, ~rev[mate], rev[mate])
        flag = (np.full(len(emit), FPAIRED, np.int64)
                | np.where(proper_rec, FPROPER_PAIR, 0)
                | np.where(eff_rev, FREVERSE, 0)
                | np.where(mate_eff, FMREVERSE, 0)
                | np.where(is_r1, FREAD1, FREAD2))
        this5 = np.where(eff_rev, re_[emit] - 1, rs[emit])
        mate5 = np.where(mate_eff, re_[mate] - 1, rs[mate])
        tlen = mate5 - this5
        tlen = tlen + np.where(tlen > 0, 1, 0) + np.where(tlen < 0, -1, 0)
        mtid = np.zeros(len(emit), np.int64)
        mpos = rs[mate]
    else:
        emit = np.flatnonzero(mapped)
        is_r1 = np.ones(len(emit), bool)
        proper_rec = np.zeros(len(emit), bool)
        eff_rev = rev[emit]
        flag = np.where(eff_rev, FREVERSE, 0).astype(np.int64)
        tlen = np.zeros(len(emit), np.int64)
        mtid = np.full(len(emit), -1, np.int64)
        mpos = np.full(len(emit), -1, np.int64)

    nrec = len(emit)
    lq_r = lens[emit]
    clip5 = qs_o[emit]
    clip3 = lq_r - qe_o[emit]

    # oriented seq/qual blobs in emit order (PlacedRead slices them);
    # joined/jq were built above, before the deferred-window finish
    eoff = np.concatenate(([0], np.cumsum(lq_r)))
    blobs = oriented_blobs_native(joined, jq, roffs[emit], eoff, rev[emit],
                                  _RC_LUT)
    if blobs is not None:
        seq_blob, qual_blob = blobs
    else:  # numpy oracle (tests cross-check the native kernel against it)
        base = np.repeat(roffs[emit], lq_r)
        within = np.arange(int(eoff[-1])) - np.repeat(eoff[:-1], lq_r)
        rev_rep = np.repeat(rev[emit], lq_r)
        src = np.where(rev_rep, base + np.repeat(lq_r, lq_r) - 1 - within,
                       base + within)
        seq_blob = np.where(rev_rep, _RC_LUT[joined[src]], joined[src])
        qual_blob = (jq[src] - 33).astype(np.uint8)

    # cigar stream with soft clips, in emit order
    has5 = (clip5 > 0).astype(np.int64)
    has3 = (clip3 > 0).astype(np.int64)
    nops = has5 + ncig0[emit] + has3
    coff = np.concatenate(([0], np.cumsum(nops)))
    stream = np.zeros(int(coff[-1]), dtype=np.uint32)
    w5 = np.flatnonzero(has5)
    stream[coff[:-1][w5]] = (clip5[w5].astype(np.uint32) << 4) | 4
    w3 = np.flatnonzero(has3)
    stream[(coff[1:] - 1)[w3]] = (clip3[w3].astype(np.uint32) << 4) | 4
    nc = ncig0[emit]
    mid_dst = np.repeat(coff[:-1] + has5, nc) + (
        np.arange(int(nc.sum())) - np.repeat(np.concatenate(
            ([0], np.cumsum(nc)[:-1])), nc))
    mid_rows = np.repeat(emit, nc)
    mid_col = np.arange(int(nc.sum())) - np.repeat(
        np.concatenate(([0], np.cumsum(nc)[:-1])), nc)
    # rows from extra_cigars have ncig stored but zeros in cig: fix below
    stream[mid_dst] = cig[mid_rows, np.minimum(mid_col, cig.shape[1] - 1)]
    if extra:
        from .io.bam import _CIGAR_CODE

        e_rows = {int(i) for i in extra}
        for ridx in np.flatnonzero(np.isin(emit, list(e_rows))).tolist():
            i = int(emit[ridx])
            dst = int(coff[ridx] + has5[ridx])
            for c, (ln, op) in enumerate(extra[i]):
                stream[dst + c] = (ln << 4) | _CIGAR_CODE[op]

    # genotyping input, emit order: the same columnar arrays the BAM encode
    # uses (pileup_call_columnar walks the flat cigar stream vectorized).
    # PlacedRead objects are built only when BAQ needs per-read realignment.
    names_clip = _clip_names(names, emit.tolist())
    placed = ColumnarReads(
        rs=rs[emit], stream=stream, coff=coff, seq_blob=seq_blob,
        qual_blob=qual_blob, soff=eoff, mapq=mapqs[emit], rev=eff_rev,
        proper=proper_rec, paired=paired, qnames=names_clip,
        pair_ids=(emit // 2).astype(np.int64) if paired else None)
    if getattr(cfg, "baq", False):
        placed = _columnar_to_placed(placed)

    # final BAM order: stable sort by pos (same as the object path's sort)
    from .native import copy_rows_native

    order = np.argsort(rs[emit], kind="stable")
    # reorder blobs per record (one row-copy each; numpy gather = oracle)
    seq_off_s = np.concatenate(([0], np.cumsum(lq_r[order])))
    seq_blob_s = np.empty(len(seq_blob), np.uint8)
    qual_blob_s = np.empty(len(qual_blob), np.uint8)
    if copy_rows_native(seq_blob, eoff[:-1][order], seq_off_s[:-1],
                        lq_r[order], seq_blob_s):
        copy_rows_native(qual_blob, eoff[:-1][order], seq_off_s[:-1],
                         lq_r[order], qual_blob_s)
    else:
        sq_src = np.repeat(eoff[:-1][order], lq_r[order]) + (
            np.arange(int(eoff[-1])) - np.repeat(
                np.concatenate(([0], np.cumsum(lq_r[order])[:-1])),
                lq_r[order]))
        seq_blob_s = seq_blob[sq_src]
        qual_blob_s = qual_blob[sq_src]
    nops_s = nops[order]
    cig_off_s = np.concatenate(([0], np.cumsum(nops_s)))
    stream_s = np.empty(len(stream), np.uint32)
    if copy_rows_native(stream.view(np.uint8), coff[:-1][order] * 4,
                        cig_off_s[:-1] * 4, nops_s * 4,
                        stream_s.view(np.uint8)):
        pass
    else:
        cg_src = np.repeat(coff[:-1][order], nops_s) + (
            np.arange(int(coff[-1])) - np.repeat(
                np.concatenate(([0], np.cumsum(nops_s)[:-1])), nops_s))
        stream_s = stream[cg_src]
    # ref span per record from the sorted stream
    op_s = stream_s & 0xF
    ln_s = (stream_s >> 4).astype(np.int64)
    refc = np.isin(op_s, np.array([0, 2, 3, 7, 8], np.uint32))
    cs = np.concatenate(([0], np.cumsum(np.where(refc, ln_s, 0))))
    spans = cs[cig_off_s[1:]] - cs[cig_off_s[:-1]]
    qn_s = _clip_names(names, emit[order].tolist())
    qname_blob = ("\x00".join(qn_s) + "\x00").encode() if nrec else b""
    qn_lens = np.array([len(x) + 1 for x in qn_s], np.int64)
    qname_off = np.concatenate(([0], np.cumsum(qn_lens)))

    body = encode_bam_columnar(
        rs[emit][order], flag[order], mapqs[emit][order], mtid[order],
        mpos[order], tlen[order], spans, qname_blob, qname_off, stream_s,
        cig_off_s, seq_blob_s, qual_blob_s, seq_off_s)

    header_text = (f"@HD\tVN:1.6\tSO:coordinate\n"
                   f"@SQ\tSN:{best_node}\tLN:{len(ref)}\n").encode()
    rn = best_node.encode() + b"\x00"
    stream_head = (b"BAM\x01" + _struct.pack("<i", len(header_text))
                   + header_text + _struct.pack("<i", 1)
                   + _struct.pack("<i", len(rn)) + rn
                   + _struct.pack("<i", len(ref)))

    def _write():
        # compress in bounded 64-block windows (same SLICE boundaries as
        # io.bam's write_bam over head+body) WITHOUT materializing the
        # concatenated stream: only the first window copies (head + body
        # prefix); the rest are memoryview slices of body — peak RSS stays
        # ~1 slice of chunks + compressed blocks
        SLICE = 64 * 65000
        total = len(stream_head) + len(body)
        mv = memoryview(body)
        with open(cfg.output + ".bam", "wb") as fh:
            for o in range(0, total, SLICE):
                if o < len(stream_head):
                    win = stream_head[o:] + bytes(
                        mv[: SLICE - (len(stream_head) - o)])
                else:
                    bo = o - len(stream_head)
                    win = mv[bo : bo + SLICE]
                fh.write(_bgzf_compress_parallel(win, level=6))
            fh.write(BGZF_EOF)
        _write_bai(cfg.output + ".bam.bai", [None] * nrec, len(ref))

    if defer_bam:
        import threading

        th = threading.Thread(target=_write, daemon=True)
        th.start()

        def join_fn():
            th.join()
            cfg.log(f"[align] wrote {nrec} records to {cfg.output}.bam")

        return ref, placed, join_fn
    _write()
    cfg.log(f"[align] wrote {nrec} records to {cfg.output}.bam")
    return ref, placed


def _start_align_prefetch(cfg: PipelineConfig):
    """Kick the alignment stage's placement-independent work onto a worker
    thread: the fastq re-read and (for the short-read native aligner) the
    read-side minimizer scan.  Returns a zero-arg joiner yielding
    (names, seqs, quals, pre) — pre is None when not applicable.  Runs
    inside placement's wall time (the scan is native and releases the GIL)."""
    import threading

    box = {}

    def work():
        try:
            names, seqs, quals = fastq.read_paired_for_alignment(
                cfg.reads1, cfg.reads2 or None)
            pre = None
            avg = sum(len(s) for s in seqs) / max(len(seqs), 1)
            if cfg.aligner != "bwa" and avg < 500:
                from .align.batch import BatchAligner

                pre = BatchAligner.precompute_minimizers(seqs)
            box["v"] = (names, seqs, quals, pre)
        except Exception as exc:
            box["err"] = exc

    th = threading.Thread(target=work, daemon=True)
    th.start()

    def join():
        th.join()
        if "err" in box:
            raise box["err"]
        return box["v"]

    return join


def run_alignment(cfg: PipelineConfig, tree: PanmanTree, best_node: str,
                  device, defer_bam: bool = False, prefetch=None,
                  stats=None):
    """Align reads to the best node's sequence and write the BAM.  With
    defer_bam=True the BAM encode+write runs on a worker thread and a
    3-tuple (ref, placed, join_fn) is returned — genotyping only consumes
    `placed`, so the caller can overlap the write with the call stage.
    `prefetch` is an optional _start_align_prefetch joiner carrying the
    fastq re-read and the minimizer pre-scan done during placement.

    The device stages run on ``device``: for short reads TorchBatchAligner
    (deferred windows on the SW kernel), for long reads (mean length >= 500,
    map-ont / map-hifi) TorchLongReadAligner (the banded DP rows on the
    long-read kernel); --aligner bwa is all host code.  With ``device``
    None every DP runs on the host (batch mode's forked workers: the
    carried LongReadAligner, TorchBatchAligner without a device), which
    gives the same records.  A ``stats`` dict
    receives the device stage's counters: the SW stage's (deferred,
    device_scored, survivors) or the long DP's (items, device_dp, host_dp)
    and its stage seconds."""
    ref = tree.get_string(best_node)
    ref_path = cfg.output + ".ref.fa"
    with open(ref_path, "w") as fh:
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
    if cfg.aligner == "bwa":
        # ancient-DNA whole-read mode (main.cpp:1979, bwa_align.c): the TRUE
        # bwa-aln FM-index search within its practical envelope, the
        # vectorized minimizer backend beyond it (align/bwt.py dispatch)
        from .align.bwt import pick_adna_aligner

        ad, backend = pick_adna_aligner(ref, len(seqs), log=cfg.log)
        cfg.log(f"[align] aDNA backend: {backend}")
        paired = False
        pairs = [(a, None) for a in ad.align_batch(seqs)]
    elif avg_len >= 500:
        # long reads: preset by mean length (mm_align.c:38-41), unpaired
        from .align.longread import (LongReadAligner, TorchLongReadAligner,
                                     pick_preset)

        pre = pick_preset(avg_len)
        cfg.log(f"[align] long-read preset {pre.name} (avg len {avg_len:.0f})")
        lr = (LongReadAligner(ref, pre) if device is None
              else TorchLongReadAligner(ref, pre, device, stats=stats))
        paired = False
        pairs = [(a, None) for a in lr.align_batch(seqs)]
    else:
        from .align.batch import TorchBatchAligner

        aligner = TorchBatchAligner(ref, device, log=cfg.log, stats=stats)
        res = (aligner.align_batch_arrays(seqs, pre=pre, deferred_async=True)
               if aligner.use_native else None)
        if res is not None:
            cfg.log(f"[align] {len(seqs)} reads in {time.time()-t0:.1f}s")
            return _emit_columnar(cfg, names, seqs, quals, res, paired, ref,
                                  best_node, defer_bam)
        native.require_lib()  # raises unless PANMAP_TPU_NO_NATIVE is set:
        # then the numpy oracle, every DP on the host
        pairs = aligner.align_pairs_batch(seqs, paired)
    cfg.log(f"[align] {len(seqs)} reads in {time.time()-t0:.1f}s")

    # BAM records (conversion.cpp:390-538 conventions)
    entries = []
    placed = []  # for genotyping: (rs, cigar, seq_ref_orient, quals, qs, pair_id)

    def clip_name(name):
        if len(name) >= 2 and name[-2] == "/" and name[-1] in "12":
            return name[:-2]
        return name

    def add_record(i, aln, mate, is_read1, pair_id):
        seq = seqs[i]
        qual = quals[i]
        lq = len(seq)
        q8 = (np.frombuffer(qual.encode(), dtype=np.uint8) - 33).astype(np.uint8)
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
        if paired:
            # R2 was reverse-complemented upstream: report true strand
            eff_rev = (not aln.rev) if not is_read1 else aln.rev
            mate_eff_rev = mate.rev if is_read1 is False else (not mate.rev)
            flag = compute_sam_flags(True, is_read1, eff_rev, mate_eff_rev,
                                     aln.proper_frag, False)
            tlen = compute_tlen(aln.rs, aln.re, eff_rev, mate.rs, mate.re, mate_eff_rev)
            rec = dict(qname=clip_name(names[i]), flag=flag, pos=aln.rs,
                       mapq=aln.mapq, cigar=cigar, mtid=0, mpos=mate.rs,
                       tlen=tlen, seq=bam_seq, qual=bam_qual)
        else:
            flag = compute_sam_flags(False, False, aln.rev, False, False, False)
            rec = dict(qname=clip_name(names[i]), flag=flag, pos=aln.rs,
                       mapq=aln.mapq, cigar=cigar, mtid=-1, mpos=-1, tlen=0,
                       seq=bam_seq, qual=bam_qual)
        entries.append(rec)
        # genotyping consumes ref-orientation bases: aln.cigar spans
        # query positions [qs_oriented, qe_oriented) of the oriented read.
        # bam_seq/bam_qual are already the oriented read — reuse them.
        oseq = bam_seq
        oq = np.frombuffer(bam_qual, dtype=np.uint8).astype(np.int64)
        oqs = (lq - aln.qe) if aln.rev else aln.qs
        placed.append(PlacedRead(
            rs=aln.rs, cigar=aln.cigar, seq=oseq, quals=oq, qs=oqs,
            qname=clip_name(names[i]), is_proper=aln.proper_frag,
            is_paired=paired, mapq=aln.mapq, rev=(not aln.rev) if (paired and not is_read1) else aln.rev,
            has_clip=bool(clip5 or clip3),
        ))

    if paired:
        for idx2, (a1, a2) in enumerate(pairs):
            if not (a1.mapped and a2.mapped):
                continue
            i1, i2 = idx2 * 2, idx2 * 2 + 1
            add_record(i1, a1, a2, True, idx2)
            add_record(i2, a2, a1, False, idx2)
    else:
        for idx2, (a1, _) in enumerate(pairs):
            if a1.mapped:
                add_record(idx2, a1, None, True, None)

    order = sorted(range(len(entries)), key=lambda j: entries[j]["pos"])
    entries = [entries[j] for j in order]
    if defer_bam:
        import threading

        def _write():
            write_bam(cfg.output + ".bam", best_node, len(ref), entries)

        th = threading.Thread(target=_write, daemon=True)
        th.start()

        def join_fn():
            th.join()
            cfg.log(f"[align] wrote {len(entries)} records to {cfg.output}.bam")

        return ref, placed, join_fn
    write_bam(cfg.output + ".bam", best_node, len(ref), entries)
    cfg.log(f"[align] wrote {len(entries)} records to {cfg.output}.bam")
    return ref, placed


def run_genotyping(cfg: PipelineConfig, idx: IndexArrays, ref: str,
                   best_node: str, placed, device=None):
    """Call variants from the placed reads and write <out>.vcf.  The
    per-column pileup tallies run on ``device`` as --device-pileup says
    (resolve_device_pileup); with ``device`` None they run on the host."""
    if cfg.no_mutation_spectrum:
        phred = None  # main.cpp:2450: gate-only filtering, no prior
    elif cfg.mutation_matrix:
        from .genotype.caller import load_mutation_matrix

        phred, _, _ = load_mutation_matrix(cfg.mutation_matrix)
    else:
        phred = phred_scale_matrix(idx.substitution_matrix)
    # the prior doubles as the caller's sound column prefilter (columns that
    # provably cannot survive apply_spectrum skip the per-column PL math)
    from .genotype.caller import resolve_device_pileup

    dev_tally = (None if device is None
                 else resolve_device_pileup(cfg.device_pileup, device))
    if isinstance(placed, ColumnarReads):
        records = pileup_call_columnar(ref, placed, spectrum=phred,
                                       device_tally=dev_tally)
    else:
        records = pileup_call(ref, placed, baq=cfg.baq, spectrum=phred,
                              device_tally=dev_tally)
    final = apply_spectrum(records, phred, cfg.min_depth, cfg.min_qual)
    write_vcf(cfg.output + ".vcf", best_node, len(ref), final)
    cfg.log(f"[call] {len(final)} variants -> {cfg.output}.vcf")
    return final


def run_consensus(cfg: PipelineConfig, ref: str, best_node: str, final_records):
    sample = os.path.basename(cfg.output) or "sample"
    header = f"{sample}_consensus ref={best_node}"
    text = build_consensus(ref, final_records, header)
    with open(cfg.output + ".consensus.fa", "w") as fh:
        fh.write(text)
    cfg.log(f"[build] {cfg.output}.consensus.fa")


def read_batch_file(path: str):
    """Batch manifest: one sample per line, `reads1 [reads2] [prefix]`
    (main.cpp:1025-1090 readBatchFiles).  A single optional second field is
    reads2 if it looks like FASTQ, else an output prefix; a missing prefix is
    derived from reads1 with _R1/_1-style suffixes stripped, keeping the
    directory."""
    entries = []
    with open(path) as fh:
        for lineno, line in enumerate(fh, 1):
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            reads1, reads2, prefix = parts[0], "", ""
            if len(parts) >= 3:
                reads2, prefix = parts[1], parts[2]
            elif len(parts) == 2:
                low = parts[1].lower()
                if ".fastq" in low or ".fq" in low:
                    reads2 = parts[1]
                else:
                    prefix = parts[1]
            if not prefix:
                prefix = os.path.join(os.path.dirname(reads1) or ".",
                                      default_prefix(reads1))
            if not os.path.exists(reads1):
                raise FileNotFoundError(f"batch line {lineno}: {reads1}")
            if reads2 and not os.path.exists(reads2):
                raise FileNotFoundError(f"batch line {lineno}: {reads2}")
            entries.append((reads1, reads2, prefix))
    return entries


_BATCH_CTX: dict = {}


def _batch_host_stages(args):
    """Post-placement stages for one batch sample, run in a forked worker
    (host-only code: align, genotype, consensus — no device access).
    tree/idx/cfg come in via fork-inherited globals, not pickles.

    A CUDA context does not survive fork, so a worker passes no device
    down: every alignment DP runs on the host (run_alignment with device
    None) and the pileup tally is the host bincounts.  The records are the
    same either way (the SW stage never drops a window; the long-read host
    DP and the tally are the device stages' oracles).  Nothing here catches
    a CUDA error: a worker that reached the device would fail its sample
    with torch's own message."""
    import copy

    reads1, reads2, prefix, best_id = args
    tree = _BATCH_CTX["tree"]
    idx = _BATCH_CTX["idx"]
    scfg = copy.copy(_BATCH_CTX["cfg"])
    scfg.reads1, scfg.reads2, scfg.output = reads1, reads2, prefix
    scfg.log = lambda *a, **k: None
    ref, placed = run_alignment(scfg, tree, best_id, None)
    if scfg.stop != "align":
        final = run_genotyping(scfg, idx, ref, best_id, placed)
        if scfg.stop != "genotype":
            run_consensus(scfg, ref, best_id, final)
    return prefix


def run_batch(cfg: PipelineConfig, device=None, idx=None, tree=None):
    """Batch placement (main.cpp:1464-1700 runBatchPlacement): the index and
    tree are loaded once and shared read-only across all samples.  Placement
    streams through the one device serially, on ONE TorchPlacer (one index
    upload for the run); the host stages (align, genotype, consensus) fan
    out over a pre-forked worker pool — the equivalent of the reference's
    sample-level tbb::parallel_for (main.cpp:1575-1658).

    The pool (at most 8 workers; only for more than one sample and a stop
    past "place") is forked before this function's first CUDA call, and its
    workers run host code only (_batch_host_stages): an explicit
    --device-pileup on does not reach them, and the log says so.  With one
    sample or one worker the stages run in this process on ``device``, SW
    kernel and device tally included, as run_pipeline runs them.  ``idx`` /
    ``tree``: an index and a tree already in memory (ensure_index /
    load_panman otherwise).  Returns 0, or 1 when any sample failed."""
    try:
        samples = read_batch_file(cfg.batch_file)
    except (OSError, FileNotFoundError) as exc:
        cfg.log(f"[batch] error: {exc}")
        return 1
    if not samples:
        cfg.log("[batch] no samples in batch file")
        return 1
    # a process group: each rank takes its contiguous shard of the manifest
    # (the host stages stay data-parallel per rank, as the reference's batch
    # mode is per node)
    from .parallel.dist import process_read_shard

    shard = process_read_shard(len(samples))
    if shard != slice(0, len(samples)):
        cfg.log(f"[batch] process shard: samples "
                f"[{shard.start}, {shard.stop}) of {len(samples)}")
        samples = samples[shard]
        if not samples:
            return 0
        # each rank now owns other samples: any mesh stays in the process
        cfg.local_mesh_only = True
    cfg.log(f"[batch] {len(samples)} samples")
    native.require_lib()  # a failed build raises here, not a silent slow path
    if idx is None:
        idx, tree = ensure_index(cfg, tree)
    if cfg.stop == "index":
        return 0
    need_tree = cfg.stop not in ("index", "place")
    if need_tree and tree is None:
        tree = load_panman(cfg.panman)

    # pre-fork the host-stage pool BEFORE any device work so workers carry
    # no live device-client threads
    pool = None
    if need_tree and len(samples) > 1:
        import multiprocessing as mp

        workers = max(1, min(cfg.threads or (os.cpu_count() or 4),
                             len(samples), 8))
        if workers > 1:
            _BATCH_CTX.update(tree=tree, idx=idx, cfg=cfg)
            try:
                pool = mp.get_context("fork").Pool(processes=workers)
            except (OSError, ValueError):
                pool = None
            if pool is not None:
                cfg.log(f"[batch] {workers} forked workers run align, "
                        f"genotype and consensus on the host only (every "
                        f"DP and the pileup tally: no device in a worker); "
                        f"placement stays on the device")
                env = os.environ.get("PANMAP_TPU_DEVICE_PILEUP", "")
                if env == "1" or (cfg.device_pileup == "on" and env != "0"):
                    cfg.log("[batch] --device-pileup on does not reach the "
                            "forked workers: their tally is the host "
                            "bincounts (the same counts); it holds where the "
                            "stages run in this process (one sample, or "
                            "--threads 1)")

    try:
        device = as_device(device)
        placer = None
        if cfg.device_place and not (cfg.dump_all_scores or cfg.refine):
            placer = _get_placer(idx, cfg, device)  # the run's one upload
        return _run_batch_samples(cfg, samples, idx, tree, device, placer,
                                  pool, need_tree)
    finally:
        if pool is not None:
            pool.close()
            pool.join()
        _BATCH_CTX.clear()


def _run_batch_samples(cfg, samples, idx, tree, device, placer, pool,
                       need_tree):
    """run_batch's loop over the samples: dispatch, resolve, collect."""
    import copy

    n_ok = n_fail = 0
    t_all = time.time()
    pending = []  # (i, prefix, async_result, t0)
    # placement is software-pipelined across samples: sample i's device
    # selection program flies while sample i+1's host sketch runs (the
    # reference streams samples through shared state serially,
    # main.cpp:1575-1658; here the chip and the host cores overlap instead)
    inflight = None  # (i, sample, scfg, placement_finisher, t0)

    def _dispatch(i, sample):
        reads1, reads2, prefix = sample
        scfg = copy.copy(cfg)
        scfg.reads1, scfg.reads2, scfg.output = reads1, reads2, prefix
        scfg.log = lambda *a, **k: None
        t0 = time.time()
        try:
            # makedirs inside the capture: a bad output prefix must fail
            # THIS sample at resolve time, not abort the whole batch
            out_dir = os.path.dirname(prefix)
            if out_dir:
                os.makedirs(out_dir, exist_ok=True)
            fin = run_placement(scfg, idx, device, placer=placer, _async=True)
        except Exception as exc:
            err = exc

            def fin():
                raise err

        return i, sample, scfg, fin, t0

    def _resolve(entry):
        nonlocal n_ok, n_fail
        i, (reads1, reads2, prefix), scfg, fin, t0 = entry
        try:
            res, best_id, _ = fin()
            if not best_id:
                cfg.log(f"[{i}/{len(samples)}] {prefix} -> NO PLACEMENT "
                        f"({time.time()-t0:.1f}s)")
                n_fail += 1
                return
            if need_tree:
                if pool is not None:
                    pending.append((i, prefix, best_id, pool.apply_async(
                        _batch_host_stages,
                        ((reads1, reads2, prefix, best_id),)), t0))
                    return
                ref, placed = run_alignment(scfg, tree, best_id, device)
                if cfg.stop != "align":
                    final = run_genotyping(scfg, idx, ref, best_id, placed,
                                           device)
                    if cfg.stop != "genotype":
                        run_consensus(scfg, ref, best_id, final)
            cfg.log(f"[{i}/{len(samples)}] {prefix} -> {best_id} "
                    f"({time.time()-t0:.1f}s)")
            n_ok += 1
        except Exception as exc:  # keep going: one bad sample must not kill the batch
            cfg.log(f"[{i}/{len(samples)}] {prefix} -> FAILED ({exc})")
            n_fail += 1

    for i, sample in enumerate(samples, 1):
        entry = _dispatch(i, sample)
        if inflight is not None:
            _resolve(inflight)
        inflight = entry
    if inflight is not None:
        _resolve(inflight)
    for i, prefix, best_id, ar, t0 in pending:
        try:
            ar.get()
            cfg.log(f"[{i}/{len(samples)}] {prefix} -> {best_id} "
                    f"({time.time()-t0:.1f}s)")
            n_ok += 1
        except Exception as exc:
            cfg.log(f"[{i}/{len(samples)}] {prefix} -> FAILED ({exc})")
            n_fail += 1
    cfg.log(f"[batch] {n_ok} succeeded, {n_fail} failed in {time.time()-t_all:.1f}s")
    return 0 if n_fail == 0 else 1


def run_pipeline(cfg: PipelineConfig, device=None):
    """Run the single-sample pipeline, or batch mode with cfg.batch_file;
    ``device`` defaults to the run's CUDA card (a CPU device is for the
    parity tests).  With cfg.profile_dir the run is traced by
    torch.profiler (host ops, and the card's kernels on a CUDA host) and
    the trace written into that directory (TensorBoard's trace format)."""
    if not cfg.profile_dir:
        return _run_pipeline_inner(cfg, device)
    import torch
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    try:
        with profile(activities=acts, acc_events=True,
                     on_trace_ready=tensorboard_trace_handler(
                         cfg.profile_dir)):
            return _run_pipeline_inner(cfg, device)
    finally:
        cfg.log(f"[profile] trace written to {cfg.profile_dir}")


def _run_pipeline_inner(cfg: PipelineConfig, device=None):
    if cfg.batch_file:
        return run_batch(cfg, device)
    device = as_device(device)
    native.require_lib()  # a failed build raises here, not a silent slow path
    tree = None
    idx, tree = ensure_index(cfg, tree)
    if cfg.export_ref_idx:
        from .io.refidx import write_ref_index

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
        from .place.refine import (append_refined_tsv,
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
        final = run_genotyping(cfg, idx, ref, best_id, placed, device)
    finally:
        bam_join()  # never leave the writer thread orphaned on an error
    if cfg.stop == "genotype":
        return
    run_consensus(cfg, ref, best_id, final)
