#!/usr/bin/env python3
"""GPU smoke run of panmap_tpu_torch, the PyTorch/CUDA port: builds the
port's CUDA kernels from the checkout, holds each against its plain PyTorch
version, and drives the single-sample path (place -> align -> genotype ->
consensus) on one card, for short reads at the size of the sars_20000 demo
and for long reads at the size of a SARS-CoV-2 Nanopore run, checking every
output byte for byte against the port's own run with the kernels' plain
versions; then metagenomic abundance (--meta) at the size of the
reference's demo 2, its scores held bit-equal to the host scorer and its
abundances to the demo's own gates; then read assignment (--meta
--filter-and-assign) at the shape of the reference's demo 3, batch mode
over a manifest of 8 samples, the pileup tally on the card, and the
sharded paths (--mesh, --dist-*) and --profile, and the placement API
beside the CLI's path with the device read sketch; and last the CLI
itself from a PanMAN file written from the seed (short and long reads,
--meta, --dump-node, --simulate).

    python3 chip_smoke.py [--seed N] [--out DIR]
    python3 chip_smoke.py --walls N   # only phase 5's stage walls, N runs

(Phase 15c starts this script twice more with --dist-child, one rank
each.  --walls times the port of the checkout the script lies in: a copy
of this script in the root of another checkout, run in turns with this
one in one call, compares two commits.)

Phases, one line each with its time:
  1. card, versions
  2. both builds, started together: the port's native host library (g++,
     panmap_tpu_torch/native/panmap_native.cpp) and nvcc over
     panmap_tpu_torch/csrc/*.cu (one nvcc per source, in parallel), both
     into panmap_tpu_torch/_build/
  3. banded-SW kernel vs its plain version (>= 4,096 pairs, bit-equal)
  4. placement on the full index: TorchPlacer.place_exact on the card, on
     the sparse and the full-stream route, each equal to TorchPlacer on the
     CPU and to the f64 host engine (the port's --host-place route)
  5. the short-read pipeline through the port's stage functions on the card
     (kernel launch counts reset just before), then the same stages on CPU
     tensors; the five outputs must be byte-equal
  6. the SW kernel equals its plain version on the very inputs the
     pipeline gave it
  7. long-read DP kernel vs its plain version on the card: 256 random
     items (LQ 600-3,000, W 801-2,401; substitutions, short indels, long
     deletions and insertions, z-drop stops), half map-ont, half map-hifi;
     then launches that cross every edge of the kernel's design (W no
     multiple of 8 or 16, W < 256, W in (1,024, 2,401] and above 8,192 (where
     a thread takes 16 columns), up to the widest band the kernel takes,
     bands that start before the reference or run past its end, a query of
     one base, both presets); direction bytes and row stats bit-equal over
     whole arrays
  8. the long-read pipeline (map-ont) on the card on 5,000 reads, launch
     count reset just before, then the same stages on the same card with
     the kernel's plain version swapped in; the five outputs must be
     byte-equal, and on every launch of the first run the kernel's outputs
     equal the plain version's on the same inputs.  (The port's run on CPU
     tensors, as phase 5 does, would push ~6.6 G DP cells through the plain
     version on the CPU: minutes, so the plain version runs on the card.)
     The kernel's time over these launches is printed beside its bound and
     the time of the kernel it replaced (PERF.md); the align stage's split
     comes from the port's spans (a host-only profiler over the first run).
  9. the meta scorer on the card: the sample sketched, TorchMetaScorer's
     max scores over all nodes and its snapshot over the run's own
     overlap-coefficient candidates bit-equal to the port's --host-score
     route (the shared native MetaScorer); host prep, upload and device
     scoring walls, peak device memory, the top device ops of one node
     chunk and of the EM on that snapshot (torch.profiler)
 10. the abundance pipeline (the port's run_meta) on the card with demo 2's
     options: the card route taken, every haplotype named, demo 2's gate A
     (top node = top haplotype, |p - truth| <= 0.06, non-haplotype mass
     <= 0.25); the unpinned run on the first 20,000 read pairs of the
     same sample on the card and with --em-f64 (host numpy f64 over all
     the candidates, above the 5 M cells at which the routing would pick
     the card's EM): the same output lines, names and groups, every
     proportion within 2e-4; then, at full width, pinned to the five haplotypes
     (--em-candidates) on the card and with --em-f64: gate B, every
     proportion within 2e-4.  Launch counts of both kernels read 0 over the meta runs: this
     path runs neither.  Each run is under a host-only profiler: the route,
     R x M, the EM's steps and rounds and the stage seconds are the port's
     spans
 11. read assignment on the card (the port's run_meta with
     filter_and_assign and demo 3's options plus --jplace, --breadth-ratio,
     the filtered scores TSV and the taxonomy at the species rank) on the
     whole assign workload: the batched scorer's route taken; then the
     sample's first 40,000 reads on that route on the card and on the
     --host-score route, the replay DFS (breadths.out and the scores TSV
     byte-equal; the FASTQ, both .out and both .jplace files equal as
     assignments: the two routes write the same records in another order,
     in the JAX package too); then the whole sample's
     TorchMetaScorer.assignment_pass, as run_meta called it on the card,
     against the same call on CPU tensors, the four values equal, with its
     wall and the scorers' set-up as run_meta paid them, the pairs copied
     and the nonzero syncs it counted, peak device memory (of the whole
     run, and of the pass alone above what the scorer holds) and its top
     device ops (torch.profiler)
 12. batch mode on the card: the short workload's reads dealt into 8
     samples, through run_batch with the index and tree in memory (a pool
     of forked host workers): one TorchPlacer built (one index upload),
     exit code 0, every sample's five outputs byte-equal to the same
     sample through the single-sample stages on the card; the same
     manifest with one prefix that cannot be made: exit code 1, that
     sample failed, the others still match; a manifest of one sample runs
     in process and launches the SW kernel once, and that launch's scores
     equal the plain version's on the same inputs
 13. the pileup tally: tally_columns_device on the card on the grouped
     entries phase 5's genotyping gave it, equal to the numpy bincounts,
     its time beside theirs (phases 5 and 8 tally on the card)
 15. (runs before 14) the sharded paths on the one card, each held to
     its unsharded run: (a) a mesh of two shards on cuda:0: place_exact
     on phase 4's sketch equal to the unsharded placer and the f64 host
     engine, dispatch-to-sync walls and device kernel ms of the unsharded
     sparse and full-stream routes and the sharded one; the short pipeline
     placed on that mesh (run_placement with its placer; SW launch count
     reset just before), the five outputs byte-equal to phase 5's, B1
     launched as often as there; (b) TorchMetaScorer on the mesh, scores
     bit-equal to phase 9's; the EM with its reads sharded over the mesh
     within 2e-4 of the unsharded EM on phase 9's snapshot and on the
     matrix pinned to the five haplotypes (phase 10's pinned run); (c) two
     processes on cuda:0, ranks of one gloo group (tcp on localhost):
     place_exact over the index rows sharded across both ranks equal to
     the f64 host engine, the EM over reads sharded across both ranks the
     same in both and within 2e-4 of (b)'s unsharded run, and phase 12's
     manifest split between the ranks (run_batch), every sample's five
     outputs byte-equal to its single run there; (d) run_pipeline with
     --profile's directory on the card: the trace holds one
     banded_sw_kernel device event per B1 launch, the outputs byte-equal
     to phase 5's.  One card: the shards measure the cost of sharding,
     not scaling over cards
 16. (runs before 14) the placement API beside place_exact and the device
     read sketch, on phase 4's index and reads with pad_len 152: (a)
     TorchPlacer.sketch_device on every read, reduced on the host to
     (hash -> count), equal to the native host sketch's table, the first
     16,384-read chunk bit-equal to the same calls on CPU tensors, one
     chunk's kernel ms and launches (torch.profiler) beside the host
     sketch of the same reads; (b) place within 2e-4 of the f64 host
     engine at min-read-support -1 and 1, the device's distinct kept
     seeds (nuniq, beside MAXU) equal to the host sketch's; (c) place_best
     == place_best_host (best index and ties equal, scores within 1e-4),
     force_leaf off and on, each best node in place_exact's tie set; (d)
     place_best_host_batch over phase 12's 8 samples == each sample's
     place_best_host; (e) compute_scores_torch on phase 4's sketch within
     2e-4 of the host engine; (f) sketch_meta_reads_batch on the meta
     workload's first 20,000 pairs on the card == on CPU tensors, and on
     every read == sketch_meta_reads_full as a multiset of (read, group);
     (g) make_sharded_sketch_fn over two shards of cuda:0 bit-equal to the
     unsharded scan.  Dispatch-to-sync walls of place, place_best,
     place_best_host, one batched call of 8 samples and 8 single calls;
     peak device memory; neither kernel launches on this path
 17. (runs before 14) the CLI from a PanMAN file, in this process on
     cuda:0 with no stand-in for load_panman (panmap_tpu_torch.__main__.
     main; load_panman's scalar decoder patched to raise, the vectorised
     one counted): a file of make_panman_model's tree written from --seed
     (written twice: the same bytes) and a short sample from a mutated
     copy of a leaf; (a) cold: the index built from the file and cached
     beside it, B1 launched by the CLI (launch count reset just before)
     and each launch bit-equal to its plain version, a variant called;
     (b) warm, on the cached index: B1's launches bit-equal to its plain
     version as in (a), the five outputs byte-equal to (a)'s,
     the wall split load + place / tree wait / align / genotype+BAM /
     consensus; (c) the stages on CPU tensors with the decoded tree, the
     five outputs byte-equal to (b)'s, place_exact on both device routes
     == TorchPlacer on CPU tensors == the f64 host engine; (d) the placed
     node's genome == the source leaf's; (e) 1,000 long reads (map-ont) of
     another leaf through the CLI: B2 launched, each launch bit-equal to
     its plain version, placed on that leaf's genome; (f) --meta on
     200,000 read pairs of five leaves at 0.40 / 0.25 / 0.15 / 0.12 / 0.08:
     the meta index built from the file and cached, demo 2's gate A;
     (g) --dump-node of the placed node == (b)'s ref.fa, --simulate at its
     defaults
 14. neither jax nor any module of panmap_tpu was imported; the count of
     the port's modules that were

The JAX package itself is not driven here: tests/test_torch_*.py hold the
port against it on the CPU.

The workloads (panmap_tpu_torch.synthetic) are made from --seed: 39,999
tree nodes, ~2.42 M index rows and a 29,903 bp genome for both; 51,169 read
pairs of 150 bp for the short-read path; 5,000 single-end ONT-like reads of
1,000-1,400 bp for the long-read path; for --meta five haplotypes of a
29,903 bp genome at 0.40 / 0.25 / 0.15 / 0.12 / 0.08, 200,000 read pairs of
150 bp and a 39,999-node meta index; for read assignment 400 species of
25 nodes with a 16.5 kb genome each (10,191 nodes) and 250,000 single-end
ancient-DNA-like reads of 35-120 bp; for phase 17 a PanMAN file of a
39,999-node tree (~20,000 leaves) over a 29,903 bp genome in 30 blocks.
The last lines are the card's name and power limit again, a JSON line
of the meta readings, one of the assign,
batch and tally readings, one of phase 15's (mesh), one of phase 16's
(api), one of phase 17's (panman), a JSON line listing the kernels and the
result line;
any failure raises (exit code != 0) and prints no result.  Needs one CUDA
card; exits non-zero without one.
"""

from __future__ import annotations

import argparse
import contextlib
import filecmp
import json
import os
import shutil
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
OUTPUTS = ("placement.tsv", "ref.fa", "bam", "vcf", "consensus.fa")


def log(msg):
    print(msg, flush=True)


def cuda_time_ms(fn, reps):
    """Mean device milliseconds of fn() over reps runs (CUDA events, after
    one warm-up run)."""
    import torch

    fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def profile_kernels(fn, top=3):
    """One fn() run under torch.profiler on the card: (kernel ms, kernel
    launches, copy ms, the ``top`` costliest kernels)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    ev = [e for e in prof.key_averages()
          if e.device_type == torch.autograd.DeviceType.CUDA
          and e.self_device_time_total > 0]
    copy = [e for e in ev if e.key.startswith(("Memcpy", "Memset"))]
    kern = sorted((e for e in ev if e not in copy),
                  key=lambda e: -e.self_device_time_total)
    names = ", ".join(f"{e.key[:40]} {e.self_device_time_total / 1e3:.2f}"
                      f" ms x{e.count}" for e in kern[:top])
    return (sum(e.self_device_time_total for e in kern) / 1e3,
            sum(e.count for e in kern),
            sum(e.self_device_time_total for e in copy) / 1e3, names)


def device_kernel_ms(fn, top=3):
    """Sum of device time in one fn() run (torch.profiler: kernels and
    copies) and the ``top`` costliest kernels."""
    kern_ms, _, copy_ms, names = profile_kernels(fn, top)
    return kern_ms + copy_ms, names


# The least time the card could take (from the published
# peaks of one H100 SXM).  int32 operations outside the tensor cores run on
# 64 lanes an SM where float32 has 128 lanes doing 2 flops per FMA, so the
# int32 rate is a quarter of the 67 TFLOP/s float32 rate.
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 67e12 / 4
# int32 operations a DP cell needs at the least.  csrc/banded_sw.cu: E, F
# and H of the affine recurrence (10), the query-end bonus and the running
# (max, position) with its tie order (10).  csrc/banded_long.cu: the
# recurrences of F, F2, diag, base, E, E2 and H (15), the source choice in
# the traceback's priority order (12), the four run flags (8), the byte (5),
# the row max and the band's edge (5).
SW_OPS_PER_CELL = 20
LONG_OPS_PER_CELL = 45
# csrc/banded_long.cu before its redesign, on this workload's launches
# (PERF.md: NVIDIA H100 80GB HBM3, 700.00 W)
LONG_MS_BEFORE_REDESIGN = 119.66


def bound_ms(cells, ops_per_cell, tensors):
    """(bound ms, "bytes" or "operations"): the larger of the cells'
    operations over the card's int32 rate and the tensors' bytes (each input
    read once, each output written once) over its memory rate."""
    by_ops = cells * ops_per_cell / INT32_OPS_PER_S * 1e3
    by_bytes = sum(t.numel() * t.element_size()
                   for t in tensors) / HBM_BYTES_PER_S * 1e3
    return ((by_ops, "operations") if by_ops >= by_bytes
            else (by_bytes, "bytes"))


def sw_pairs(rng, B, lq_lo, lq_hi, lw_max):
    """Random (query, window) pairs with a planted homologous segment
    carrying substitutions and, in half the pairs, an indel (the cases of
    tests/test_pallas_sw.py at main-path sizes)."""
    import numpy as np

    lqs = rng.integers(lq_lo, lq_hi + 1, B)
    lws = rng.integers(min(lw_max, max(lq_hi, 256)), lw_max + 1, B)
    LQ, LW = int(lqs.max()), int(lws.max())
    q = np.full((B, LQ), 4, np.int8)
    r = np.full((B, LW), 4, np.int8)
    for b in range(B):
        lq, lw = int(lqs[b]), int(lws[b])
        qb = rng.integers(0, 4, lq).astype(np.int8)
        rb = rng.integers(0, 4, lw).astype(np.int8)
        seg = int(rng.integers(0, lw - lq // 2 - 8))
        core = rb[seg : seg + lq // 2].copy()
        muts = rng.integers(0, len(core), 3)
        core[muts] = (core[muts] + 1) % 4
        if rng.random() < 0.5:
            cut = int(rng.integers(4, len(core) - 4))
            core = np.concatenate([core[:cut], core[cut + int(
                rng.integers(1, 6)):]])
        qb[: len(core)] = core
        q[b, :lq] = qb
        r[b, :lw] = rb
    return q, r, lqs.astype(np.int32)


def compare_sw(sw, qt, rt, lt, reps):
    """Kernel vs plain version on the same tensors on the card: (max |diff|,
    kernel ms, plain ms).  Raises unless they are bit-equal."""
    import torch

    got = sw.banded_sw_scores(qt, rt, lt)
    want = sw.banded_sw_scores_reference(qt, rt, lt)
    torch.cuda.synchronize()
    err = int((got.long() - want.long()).abs().max()) if len(qt) else 0
    if not torch.equal(got, want):
        bad = (got != want).any(1).nonzero()[:5, 0].tolist()
        raise AssertionError(f"SW kernel != plain version at pairs {bad}")
    ms = cuda_time_ms(lambda: sw.banded_sw_scores(qt, rt, lt), reps)
    plain_ms = cuda_time_ms(lambda: sw.banded_sw_scores_reference(qt, rt, lt),
                            1)
    return err, ms, plain_ms


def same_placement(got, want, what):
    if sorted(got.best_index) != sorted(want.best_index):
        raise AssertionError(f"{what}: metrics {sorted(got.best_index)}")
    for m in want.best_index:
        if (got.best_index[m], got.best_score[m], got.tied_indices[m]) != (
                want.best_index[m], want.best_score[m], want.tied_indices[m]):
            raise AssertionError(f"{what}: metric {m} differs")


def placement_phase(tp, TorchPlacer, w, cfg, dev, cpu):
    """TorchPlacer.place_exact on ``dev`` on both routes, each equal to
    TorchPlacer on ``cpu`` on the same route and to the f64 host engine.
    Returns (the phase's report, the sketch, the host engine's result)."""
    import torch
    from dataclasses import replace

    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    sk, _ = tp.read_sketch(cfg, w.idx)
    t1 = time.perf_counter()
    exact = tp.place_async(replace(cfg, device_place=False), w.idx, sk,
                           dev)()
    host_s = time.perf_counter() - t1
    t1 = time.perf_counter()
    placer = TorchPlacer(w.idx, dev)
    sync()
    upload_s = time.perf_counter() - t1
    on_cpu = TorchPlacer(w.idx, cpu)
    routes = []
    for route, rcap in (("sparse", TorchPlacer.RCAP_MAX), ("full-stream", 0)):
        placer.RCAP_MAX = on_cpu.RCAP_MAX = rcap
        plain = on_cpu.place_exact(sk)
        placer.place_exact(sk)  # warm-up
        sync()
        step = []
        for _ in range(3):
            t1 = time.perf_counter()
            fin = placer.place_exact_async(sk)
            sync()
            step.append(time.perf_counter() - t1)
            t2 = time.perf_counter()
            got = fin()
            rescue_s = time.perf_counter() - t2
        if got is None or plain is None:
            raise AssertionError(f"place_exact ({route}) refused: the guard "
                                 "sent the query to the host engine")
        same_placement(got, exact, f"place_exact ({route}) vs host engine")
        same_placement(got, plain, f"place_exact ({route}) vs CPU tensors")
        if dev.type == "cuda":
            kern_ms, top = device_kernel_ms(
                lambda: placer.place_exact_async(sk))
            kern = f"device kernels {kern_ms:.2f} ms: {top}"
        else:
            kern = "no device"
        routes.append(f"{route} dispatch->sync {1e3 * min(step):.1f} ms "
                      f"(min of 3; {kern}), host f64 rescue "
                      f"{1e3 * rescue_s:.1f} ms")
    return ("; ".join(routes) + f"; index upload {upload_s:.2f}s; host f64 "
            f"engine {host_s:.2f}s"), sk, exact


def run_stages(tp, w, cfg, device, stats, placer=None):
    """The port's stages in _run_pipeline_inner's order (placement on
    ``placer`` where given); returns (best node, n_reads, variants, stage
    walls, placed reads)."""
    walls = {}
    t0 = time.perf_counter()
    prefetch = tp._start_align_prefetch(cfg)
    _, best, n_reads = tp.run_placement(cfg, w.idx, device, placer=placer)
    walls["place"] = time.perf_counter() - t0
    t1 = time.perf_counter()
    ref, placed, bam_join = tp.run_alignment(cfg, w.tree, best, device,
                                             defer_bam=True,
                                             prefetch=prefetch, stats=stats)
    walls["align"] = time.perf_counter() - t1
    t1 = time.perf_counter()
    final = tp.run_genotyping(cfg, w.idx, ref, best, placed, device)
    bam_join()
    walls["genotype+bam"] = time.perf_counter() - t1
    t1 = time.perf_counter()
    tp.run_consensus(cfg, ref, best, final)
    walls["consensus"] = time.perf_counter() - t1
    walls["total"] = time.perf_counter() - t0
    return best, n_reads, final, walls, placed


def traced(fn, *args, **kwargs):
    """fn(*args, **kwargs) inside a host-only torch.profiler session, so
    that the port's spans record (panmap_tpu_torch/trace.py); returns (its
    result, {span name: [records]})."""
    from torch.profiler import ProfilerActivity, profile

    from panmap_tpu_torch import trace

    trace.take()
    with profile(activities=[ProfilerActivity.CPU]):
        out = fn(*args, **kwargs)
    spans = {}
    for r in trace.take():
        spans.setdefault(r["name"], []).append(r)
    return out, spans


def span_s(spans, *names):
    """Seconds in the named spans, summed over their records."""
    return sum(r["end_ns"] - r["start_ns"] for n in names
               for r in spans.get(n, ())) / 1e9


def span_count(spans, name, key):
    return sum(r["counts"].get(key, 0) for r in spans.get(name, ()))


def same_outputs(a, b, what):
    """Raise unless the five outputs under prefixes a and b are
    byte-equal; returns their sizes."""
    sizes = []
    for ext in OUTPUTS:
        if not filecmp.cmp(f"{a}.{ext}", f"{b}.{ext}", shallow=False):
            raise AssertionError(f"{ext} differs from {what}")
        sizes.append(f"{ext} {os.path.getsize(f'{a}.{ext}')} B")
    return sizes


def pipeline_cfg(tp, w, out, name, log=None, reads=None):
    """--device-pileup stays auto: the tally runs on a CUDA device and on
    the host for CPU tensors.  ``reads``: a (reads1, reads2) pair in place
    of the workload's."""
    os.makedirs(os.path.join(out, name), exist_ok=True)
    reads1, reads2 = reads or (w.reads1, w.reads2)
    return tp.PipelineConfig(
        panman="synthetic", reads1=reads1, reads2=reads2,
        output=os.path.join(out, name, "sample"),
        log=log or (lambda *a, **k: None))


def pipeline_phase(tp, sw, w, out, dev, cpu):
    """The pipeline on ``dev`` with the SW launch count reset just before and
    the kernel's main-path inputs captured, then on CPU tensors; the five
    outputs must be byte-equal.  Returns (report, launches, captured
    [(q, r, qlens, out)], the arguments genotyping gave the device tally,
    the device run's wall)."""
    captured = []
    launch = sw.banded_sw_scores

    def capturing(q, r, qlens):
        res = launch(q, r, qlens)
        captured.append((q, r, qlens, res))
        return res

    from panmap_tpu_torch.genotype import caller

    tally, tallied = caller.tally_columns_device, []

    def capturing_tally(*args):
        tallied.append(args)
        return tally(*args)

    cfg, stats = pipeline_cfg(tp, w, out, "device"), {}
    sw.banded_sw_scores = capturing
    caller.tally_columns_device = capturing_tally
    sw.LAUNCHES = 0
    try:
        best, n_reads, final, walls, _ = run_stages(tp, w, cfg, dev, stats)
    finally:
        sw.banded_sw_scores = launch
        caller.tally_columns_device = tally
    launches = sw.LAUNCHES
    if len(tallied) != 1 or str(tallied[0][-1]) != str(dev):
        raise AssertionError(f"the pileup tally ran {len(tallied)} time(s) "
                             f"on the device")
    if launches == 0 or stats["device_scored"] == 0:
        raise AssertionError(f"the pipeline never launched the SW kernel "
                             f"(launches {launches}, stats {stats})")
    if not final:
        raise AssertionError("no variant called: the workload is broken")

    ccfg, cstats = pipeline_cfg(tp, w, out, "cpu"), {}
    t1 = time.perf_counter()
    cbest, *_ = run_stages(tp, w, ccfg, cpu, cstats)
    cpu_wall = time.perf_counter() - t1
    if cbest != best or cstats != stats:
        raise AssertionError(f"CPU run: {cbest} {cstats} vs {best} {stats}")
    sizes = same_outputs(cfg.output, ccfg.output, "the CPU-tensor run "
                         "(host tally)")
    shapes = [tuple(q.shape) + (r.shape[1],) for q, r, _, _ in captured]
    report = (f"pipeline on {n_reads} reads -> {best}: "
              + ", ".join(f"{k} {v:.2f}s" for k, v in walls.items())
              + f"; SW launches {launches}, deferred {stats['deferred']}, "
              f"device-scored {stats['device_scored']}, survivors "
              f"{stats['survivors']}, shapes (B, LQ, LW) {shapes}; "
              f"{len(final)} variants; pileup tally on the card; "
              f"byte-equal to the CPU-tensor run with the host tally "
              f"({cpu_wall:.2f}s): " + ", ".join(sizes))
    return report, launches, captured, tallied[0], walls["total"]


def long_items(rng, n, lq_lo=600, lq_hi=3000, w_lo=801, w_hi=2401):
    """(reference codes int8, [(query codes, dlo, dhi)]): random items of
    the cases of tests/test_align_long.py::test_long_device_dp_bit_equal_host
    at main-path sizes.  Every item carries 5% substitutions; in turn it
    also has short indels, an 80-300 bp deletion (the long-gap tier), an
    80-300 bp insertion, or an unrelated second half (a z-drop stop)."""
    import numpy as np

    ref = rng.integers(0, 4, 60000).astype(np.int8)
    items = []
    for t in range(n):
        L = int(rng.integers(lq_lo, lq_hi + 1))
        half = int(rng.integers(w_lo, w_hi + 1)) // 2
        p = int(rng.integers(half, len(ref) - L - half - 400))
        frag = ref[p:p + L].copy()
        subs = rng.random(L) < 0.05
        frag[subs] = (frag[subs] + 1) % 4
        kind = t % 5
        if kind == 1:  # short indels
            for cut in sorted(rng.integers(10, L - 10, 6))[::-1]:
                k = int(rng.integers(1, 6))
                frag = (np.delete(frag, range(cut, cut + k)) if cut % 2
                        else np.insert(frag, cut, rng.integers(0, 4, k)))
        elif kind == 2:  # long deletion
            d = int(rng.integers(80, min(300, half) + 1))
            frag = np.concatenate([frag[: L // 2],
                                   ref[p + L // 2 + d: p + L + d]])
        elif kind == 3:  # long insertion
            frag = np.insert(frag, L // 3, rng.integers(
                0, 4, int(rng.integers(80, 301))))
        elif kind == 4:  # unrelated second half
            frag[L // 2:] = rng.integers(0, 4, L - L // 2)
        items.append((frag.astype(np.int8), p - half, p + half))
    return ref, items


def long_inputs(items, dev):
    """q int8 [B, LQ], meta int32 [B, 3] on ``dev`` and the width W, laid
    out as long_dp.long_dp_batch lays out a launch."""
    import numpy as np
    import torch

    LQ = max(len(q) for q, _, _ in items)
    W = max(dhi - dlo + 1 for _, dlo, dhi in items)
    qb = np.full((len(items), LQ), 4, np.int8)
    meta = np.zeros((len(items), 3), np.int32)
    for s, (q, dlo, dhi) in enumerate(items):
        qb[s, : len(q)] = q
        meta[s] = (len(q), dlo, dhi - dlo + 1)
    return (torch.from_numpy(qb).to(dev), torch.from_numpy(meta).to(dev), W,
            float(sum(len(q) * (dhi - dlo + 1) for q, dlo, dhi in items)))


def same_rows(got, want, what):
    """Raise unless two (dirs, stats) pairs are bit-equal; returns max |diff|
    over both."""
    import torch

    err = max(int((g.int() - w.int()).abs().max()) if g.numel() else 0
              for g, w in zip(got, want))
    if not all(torch.equal(g, w) for g, w in zip(got, want)):
        raise AssertionError(f"long DP kernel != plain version: {what}")
    return err


def long_edge_launches(rng, lr):
    """[(B, LQ, W, meta int32 [B, 3])]: launches that cross every edge of
    the long DP kernel's design: W no multiple of 8 or 16, W below 256 (less
    than a warp of threads in use), W in (1,024, 2,401] (more than four
    warps) and above 8,192 (16 columns a thread; aligned rows, unaligned
    rows and the widest band the kernel takes), bands that start before
    the reference (dlo < 0) and run past its end (dlo + lq + W > lr), a
    query of one base, ragged lengths and widths."""
    import numpy as np

    out = []
    for LQ, W in [(1, 1), (1, 9), (40, 7), (90, 33), (300, 255), (200, 256),
                  (64, 1001), (50, 1025), (120, 1100), (30, 2401),
                  (24, 8200), (20, 8209), (8, 16384)]:
        B = 6
        meta = np.stack([rng.integers(0, LQ + 1, B),
                         rng.integers(-300, lr, B),
                         rng.integers(1, W + 1, B)], 1).astype(np.int32)
        meta[0] = (LQ, 100, W)  # a full item
        meta[1] = (LQ, -(W // 2) - 3, W)  # starts before the reference
        meta[2] = (LQ, lr - W // 2 - LQ // 2, W)  # runs past its end
        meta[3] = (1, 57, W)  # a query of one base
        out.append((B, LQ, W, meta))
    return out


def long_edge_phase(long_dp, rng, dev):
    """The kernel vs its plain version on long_edge_launches, both presets.
    Returns (launches compared, max |diff|)."""
    import numpy as np
    import torch

    from panmap_tpu_torch.align.longread import MAP_HIFI, MAP_ONT

    lr = 3000
    ref = torch.from_numpy(rng.integers(0, 5, lr).astype(np.int8)).to(dev)
    n, err = 0, 0
    for pre in (MAP_ONT, MAP_HIFI):
        for B, LQ, W, meta in long_edge_launches(rng, lr):
            q = torch.from_numpy(rng.integers(0, 5, (B, LQ)).astype(
                np.int8)).to(dev)
            mt = torch.from_numpy(meta).to(dev)
            want = long_dp.long_dp_rows_reference(q, ref, mt, pre, W)
            got = long_dp.long_dp_rows(q, ref, mt, pre, W)
            torch.cuda.synchronize()
            err = max(err, same_rows(got, want,
                                     f"{pre.name} B {B} LQ {LQ} W {W}"))
            n += 1
    return n, err


def long_kernel_phase(long_dp, rng, dev, n_items):
    """Phase 7: the kernel vs its plain version on random items, half
    map-ont, half map-hifi.  Returns (report, max |diff|)."""
    import torch

    from panmap_tpu_torch.align.longread import MAP_HIFI, MAP_ONT

    ref, items = long_items(rng, n_items)
    ref_t = torch.from_numpy(ref).to(dev)
    parts, errs = [], []
    for k, pre in enumerate((MAP_ONT, MAP_HIFI)):
        q, meta, W, cells = long_inputs(items[k::2], dev)
        args = (q, ref_t, meta, pre, W)
        got = long_dp.long_dp_rows(*args)
        want = long_dp.long_dp_rows_reference(*args)
        torch.cuda.synchronize()
        errs.append(same_rows(got, want, pre.name))
        del got, want
        ms = cuda_time_ms(lambda: long_dp.long_dp_rows(*args), 3)
        plain_ms = cuda_time_ms(
            lambda: long_dp.long_dp_rows_reference(*args), 1)
        parts.append(f"{pre.name} {q.shape[0]} x {q.shape[1]} x {W}: kernel "
                     f"{ms:.3f} ms ({cells / ms / 1e6:.1f} GCUPS), plain "
                     f"{plain_ms:.3f} ms ({cells / plain_ms / 1e6:.2f} "
                     f"GCUPS)")
    return "; ".join(parts), max(errs)


def long_pipeline_phase(tp, long_dp, w, out, dev):
    """Phase 8: the long-read pipeline on ``dev`` with the launch count reset
    just before and every launch captured; then the same stages with the
    kernel's plain version swapped in, on the same card.  The five outputs
    must be byte-equal, and each plain launch equals the captured kernel
    launch on the same inputs.
    Returns (report, launches, kernel ms summed over the launches, plain ms
    summed, max |diff|, band cells, (bound ms, what bounds it))."""
    import torch

    lines = []
    cfg = pipeline_cfg(tp, w, out, "long_device",
                       log=lambda msg, *a, **k: lines.append(msg))
    captured = []
    launch = long_dp.long_dp_rows

    def capturing(*args):
        res = launch(*args)
        captured.append((args, res))
        return res

    stats = {}
    long_dp.long_dp_rows = capturing
    long_dp.LAUNCHES = 0
    try:  # the walls under a host-only profiler, for the align spans
        (best, n_reads, final, walls, placed), spans = traced(
            run_stages, tp, w, cfg, dev, stats)
    finally:
        long_dp.long_dp_rows = launch
    launches = long_dp.LAUNCHES
    if not [x for x in lines if "long-read preset map-ont" in x]:
        raise AssertionError(f"map-ont preset not picked: {lines}")
    if launches == 0 or stats["device_dp"] == 0:
        raise AssertionError(f"the pipeline never launched the long DP "
                             f"kernel (launches {launches}, stats {stats})")
    if not final:
        raise AssertionError("no variant called: the workload is broken")
    names = {p.qname for p in placed}
    if names & set(w.junk) or not w.junk:
        raise AssertionError(f"junk reads mapped: {names & set(w.junk)}")

    # the same stages with the plain version on the card; each of its
    # launches is held against the kernel's on the same inputs
    plain_runs = []

    def plain_capturing(*args):
        (k_args, k_res) = captured[len(plain_runs)]
        if not (all(torch.equal(a, b) for a, b in zip(args[:3], k_args[:3]))
                and args[3:] == k_args[3:]):
            raise AssertionError("the plain run's launch inputs differ")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = long_dp.long_dp_rows_reference(*args)
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0)
        plain_runs.append((ms, same_rows(k_res, res, "a main-path launch")))
        return res

    pcfg, pstats = pipeline_cfg(tp, w, out, "long_plain"), {}
    long_dp.long_dp_rows = plain_capturing
    try:
        t1 = time.perf_counter()
        pbest, *_ = run_stages(tp, w, pcfg, dev, pstats)
        plain_wall = time.perf_counter() - t1
    finally:
        long_dp.long_dp_rows = launch
    counts = ("items", "device_dp", "host_dp")
    if pbest != best or len(plain_runs) != len(captured) or any(
            pstats[k] != stats[k] for k in counts):
        raise AssertionError(f"plain run: {pbest} {pstats} vs {best} "
                             f"{stats}")
    sizes = same_outputs(cfg.output, pcfg.output, "the plain-version run")
    kernel_ms = sum(cuda_time_ms(lambda a=args: long_dp.long_dp_rows(*a), 2)
                    for args, _ in captured)
    plain_ms = sum(ms for ms, _ in plain_runs)
    cells = float(sum(int((a[2][:, 0].long() * a[2][:, 2].long()).sum())
                      for a, _ in captured))  # lq x worig per item
    bound = bound_ms(cells, LONG_OPS_PER_CELL,
                     [t for a, r in captured for t in (*a[:3], *r)])
    shapes = [tuple(a[0].shape) + (a[4],) for a, _ in captured]
    report = (f"long-read pipeline on {n_reads} reads -> {best}: "
              + ", ".join(f"{k} {v:.2f}s" for k, v in walls.items())
              + f"; align split: front end "
              f"{span_s(spans, 'align.front'):.2f}s, DP launches to their "
              f"rows on the host {span_s(spans, 'align.dp'):.2f}s, host "
              f"traceback {span_s(spans, 'align.traceback'):.2f}s"
              + f"; items {stats['items']}, device DP {stats['device_dp']}, "
              f"host DP {stats['host_dp']}; {launches} launches, shapes "
              f"(B, LQ, W) {shapes}, {cells / 1e9:.3f} G band cells, "
              f"kernel {kernel_ms:.3f} ms ({cells / kernel_ms / 1e6:.1f} "
              f"GCUPS; bound {bound[0]:.3f} ms by {bound[1]} at "
              f"{LONG_OPS_PER_CELL} int32 ops a cell; before the redesign "
              f"{LONG_MS_BEFORE_REDESIGN} ms), plain version "
              f"{plain_ms:.3f} ms "
              f"({cells / plain_ms / 1e6:.2f} GCUPS); {len(final)} variants, "
              f"{len(placed)} reads placed, {len(w.junk)} junk unmapped; "
              f"byte-equal to "
              f"the plain-version run ({plain_wall:.2f}s): "
              + ", ".join(sizes))
    return (report, launches, kernel_ms, plain_ms,
            max(e for _, e in plain_runs), cells, bound)


def head_fastq(src, dst, n_records):
    """The first ``n_records`` records of a FASTQ file, as a new file."""
    with open(src) as fin, open(dst, "w") as fout:
        for _ in range(4 * n_records):
            line = fin.readline()
            if not line:
                break
            fout.write(line)
    return dst


def meta_cfg(td, w, out, name, log=None, reads=None, **kw):
    """demo 2's options (tools/check_examples.sh: --em-delta-threshold
    0.00001, the default top-oc 1000 and 5 rounds); ``reads``: a
    (reads1, reads2) pair in place of the workload's."""
    os.makedirs(os.path.join(out, name), exist_ok=True)
    reads1, reads2 = reads or (w.reads1, w.reads2)
    return td.MetaConfig(panman="synthetic", reads1=reads1, reads2=reads2,
                         output=os.path.join(out, name, "sample"),
                         em_delta_threshold=0.00001,
                         log=log or (lambda *a, **k: None), **kw)


def meta_scorer_phase(td, w, out, dev):
    """Phase 9: TorchMetaScorer on ``dev`` against the port's --host-score
    route (the shared native host scorer) on the same sketch: max scores
    over every node and the snapshot over the run's candidates bit-equal.
    Returns (report, readings, dict of what phase 15 reuses: cfg, reads,
    candidates, max scores, snapshot, the EM's result on it)."""
    import numpy as np
    import torch
    from dataclasses import replace

    cuda = dev.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    cfg = meta_cfg(td, w, out, "meta_scorer")
    t0 = time.perf_counter()
    reads, _ = td.sketch(cfg, w.midx)
    sketch_s = time.perf_counter() - t0
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    scorer, fast = td.make_scorers(cfg, w.midx, reads, dev)
    sync()
    prep_s = time.perf_counter() - t0
    if fast is None:
        raise AssertionError(f"{len(reads)} read sets: no device scorer")
    cand = td.rank_candidates(cfg, w.midx, scorer, fast)
    sync()
    t0 = time.perf_counter()
    max_score, snap = fast.score_all(cand)
    sync()
    score_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**20 if cuda else 0.0

    hcfg = replace(cfg, host_score=True)
    hscorer, hfast = td.make_scorers(hcfg, w.midx, reads, dev)
    if hfast is not None or td.rank_candidates(hcfg, w.midx, hscorer,
                                               None) != cand:
        raise AssertionError("the --host-score route differs before scoring")
    t0 = time.perf_counter()
    hmax, hsnap, _ = td.score(hcfg, hscorer, None, cand)
    oracle_s = time.perf_counter() - t0
    if not np.array_equal(max_score, hmax):
        bad = np.flatnonzero(max_score != hmax)[:5].tolist()
        raise AssertionError(f"device max scores != host scorer at {bad}")
    got = snap.cpu().numpy().astype(np.int64)
    if not np.array_equal(got, hsnap.T.astype(np.int64)):
        raise AssertionError("device snapshot != host scorer")

    ci = fast.n_chunks // 2
    ms = torch.zeros(len(reads), dtype=torch.int32, device=dev)
    if cuda:
        chunk_ms, chunk_top = device_kernel_ms(
            lambda: fast.score_chunk(ci, [ms], [snap], np.asarray(cand)),
            top=5)
    else:
        chunk_ms, chunk_top = 0.0, "no device"
    read_lens, weights = td.em_inputs(cfg, reads, max_score)
    names = [w.midx.node_ids[n] for n in cand]
    box = {}

    def em():
        box["res"] = td.run_em(cfg, snap, read_lens, weights, names, dev)

    t0 = time.perf_counter()
    if cuda:
        em_ms, em_top = device_kernel_ms(em, top=5)
    else:
        em()
        em_ms, em_top = 0.0, "no device"
    em_s = time.perf_counter() - t0
    res = box["res"]
    readings = dict(
        nodes=len(w.midx.node_ids), index_rows=w.n_rows, reads=w.n_reads,
        unique_read_sets=len(reads), events=len(fast.ev_pos),
        bitmap_rows=fast.n_rows, node_chunk=fast.NODE_CHUNK,
        n_chunks=fast.n_chunks, slots=fast.n_slots, candidates=len(cand),
        sketch_s=sketch_s, prep_upload_s=prep_s, score_s=score_s,
        peak_device_mib=peak, host_scorer_s=oracle_s,
        chunk_kernel_ms=chunk_ms, em_profiled_s=em_s,
        em_kernel_ms=em_ms, em_steps=res.n_iterations)
    report = (f"{w.n_reads} reads -> {len(reads)} unique read sets over "
              f"{len(w.midx.node_ids)} nodes / {w.n_rows} index rows; "
              f"{len(fast.ev_pos)} flip events, bitmap {fast.n_rows} x "
              f"{fast.NODE_CHUNK} in {fast.n_chunks} chunks, {fast.n_slots} "
              f"slots; {len(cand)} candidates; max scores and snapshot "
              f"bit-equal to the host scorer ({oracle_s:.1f}s); sketch "
              f"{sketch_s:.2f}s, host prep + upload {prep_s:.2f}s, device "
              f"scoring {score_s:.3f}s, peak device memory {peak:.0f} MiB; "
              f"chunk {ci} device kernels {chunk_ms:.2f} ms: {chunk_top}; "
              f"EM on this snapshot (profiled) {em_s:.2f}s, "
              f"{res.n_iterations} SQUAREM steps, device kernels "
              f"{em_ms:.2f} ms: {em_top}")
    return report, readings, dict(cfg=cfg, reads=reads, cand=cand,
                                  max_score=max_score, snap=snap, em=res)


def abundance(path):
    """({name: prop} over every name of a line, [(names, prop)])."""
    out, lines = {}, []
    with open(path) as fh:
        for ln in fh:
            ns, p = ln.rstrip("\n").split("\t")
            lines.append((ns.split(","), float(p)))
            for n in ns.split(","):
                out[n] = float(p)
    return out, lines


def meta_pipeline_phase(td, w, out, dev, f64_pairs=20000):
    """Phase 10: the port's run_meta on ``dev`` with demo 2's options and
    demo 2's gates A and B; the unpinned card run against --em-f64 on the
    sample's first ``f64_pairs`` read pairs.  Returns (report, readings)."""
    truth = dict(zip(w.haplotypes, w.proportions))
    walls = []

    def run(name, **kw):
        """run_meta under a host-only profiler; its stages from the spans
        (trace.py): the route, the EM's shape and steps, stage seconds."""
        cfg = meta_cfg(td, w, out, name, **kw)
        t0 = time.perf_counter()
        rc, spans = traced(td.run_meta, cfg, midx=w.midx, device=dev)
        if rc != 0:
            raise AssertionError(f"run_meta ({name}) failed")
        stats = dict(
            wall_s=time.perf_counter() - t0,
            route=("device" if span_count(spans, "meta.score", "device")
                   else "host"),
            R=span_count(spans, "meta.sketch", "read_sets"),
            M=span_count(spans, "meta.score", "candidates"),
            sketch_s=span_s(spans, "meta.sketch"),
            prep_s=span_s(spans, "meta.collapse", "meta.events",
                          "meta.keys", "meta.upload", "meta.rank"),
            score_s=span_s(spans, "meta.score"),
            em_s=span_s(spans, "meta.em"),
            em_iters=span_count(spans, "meta.em", "steps"),
            em_rounds=span_count(spans, "meta.em", "rounds"))
        walls.append((name, stats))
        return abundance(cfg.output + ".mgsr.abundance.out"), stats

    (un, lines), stats = run("meta")
    if stats["route"] != "device":
        raise AssertionError(f"the scorer took the {stats['route']} route")
    missing = [h for h in truth if h not in un]
    if missing:
        raise AssertionError(f"haplotypes not in the output: {missing}")
    top = max(un, key=un.get)
    spur = sum(p for names, p in lines if not set(names) & set(truth))
    errs = {h: un[h] - truth[h] for h in truth}
    if (top != max(truth, key=truth.get) or spur > 0.25
            or max(abs(e) for e in errs.values()) > 0.06):
        raise AssertionError(f"gate A: top {top}, spurious {spur:.4f}, "
                             f"p - truth {errs}")
    # the unpinned run against --em-f64 (host numpy f64 over the full
    # candidate set) on the sample's first read pairs: every output line,
    # its names and its groups, the same.  The numpy f64 EM over the whole
    # sample's 181 M cells took 239 s (NVIDIA H100 80GB HBM3 host, PERF.md).
    sub = tuple(head_fastq(src, os.path.join(out, f"head_{n}.fastq"),
                           f64_pairs)
                for n, src in ((1, w.reads1), (2, w.reads2)))
    (_, lines32), sub32 = run("meta_head", reads=sub)
    (_, lines64), sub64 = run("meta_head_f64", reads=sub, em_f64=True)
    if (sub32["route"] != "device" or (sub32["R"], sub32["M"]) != (
            sub64["R"], sub64["M"]) or sub64["R"] * sub64["M"] <= 5_000_000):
        raise AssertionError(f"the --em-f64 comparison must run the card "
                             f"route above 5 M cells: {sub32} {sub64}")
    a, b = (dict((frozenset(ns), p) for ns, p in ls)
            for ls in (lines32, lines64))
    if set(a) != set(b):
        raise AssertionError(f"f32 card vs f64 host: lines differ "
                             f"{sorted(map(sorted, set(a) ^ set(b)))[:4]}")
    full_drift = max(abs(a[k] - b[k]) for k in a)
    if full_drift > 2e-4:
        raise AssertionError(f"f32 card vs f64 host: drift {full_drift}")
    pin = os.path.join(out, "haplotypes.txt")
    with open(pin, "w") as fh:
        fh.write("".join(f"{h}\n" for h in truth))
    (r32, _), s32 = run("meta_pinned", em_candidates=pin)
    (r64, _), s64 = run("meta_pinned_f64", em_candidates=pin, em_f64=True)
    drift = {h: abs(r32.get(h, 0.0) - r64.get(h, 0.0)) for h in truth}
    if s32["route"] != "device" or max(drift.values()) > 2e-4:
        raise AssertionError(f"gate B: f32 card vs f64 host {drift}")
    parts = []
    for name, st in walls:
        # the numpy f64 EM does not count its steps
        steps = (f" ({st['em_iters']} SQUAREM steps in "
                 f"{st['em_rounds']} rounds, "
                 f"{st['em_iters'] / max(st['em_s'], 1e-9):.0f} it/s)"
                 if st["em_iters"] else " (numpy f64)")
        parts.append(f"{name}: wall {st['wall_s']:.2f}s = sketch "
                     f"{st['sketch_s']:.2f}s, events + prep "
                     f"{st['prep_s']:.2f}s, scoring {st['score_s']:.3f}s, "
                     f"EM {st['em_s']:.3f}s{steps} over R x M = {st['R']} "
                     f"x {st['M']}")
    report = (f"gate A: top {top}, |p - truth| <= "
              f"{max(abs(e) for e in errs.values()):.4f}, non-haplotype "
              f"mass {spur:.4f}; on the first {f64_pairs} pairs {len(a)} "
              f"lines equal to --em-f64's, max "
              f"|f32 card - f64 host| {full_drift:.1e}; gate B: max |f32 "
              f"card - f64 host| {max(drift.values()):.1e}; "
              + "; ".join(parts))
    readings = dict(gate_a_top=top, gate_a_max_err=max(abs(e) for e in
                                                       errs.values()),
                    gate_a_spurious=spur, full_f64_lines=len(a),
                    full_f64_max_drift=full_drift,
                    gate_b_max_drift=max(drift.values()),
                    props={h: un[h] for h in truth},
                    runs={name: st for name, st in walls})
    return report, readings


ASSIGN_BYTE_EQUAL = ("mgsr.breadths.out", "read_scores_info.filtered.tsv")
ASSIGN_OUT = ("mgsr.assignedReads.out", "mgsr.assignedReadsLCANode.out")
ASSIGN_JPLACE = ("mgsr.assignedReads.jplace",
                 "mgsr.assignedReadsLCANode.jplace")
ASSIGN_FILES = (("mgsr.assignedReads.fastq",) + ASSIGN_OUT + ASSIGN_JPLACE
                + ASSIGN_BYTE_EQUAL)


def assign_cfg(td, w, out, name, lines, reads1=None, **kw):
    """demo 3's options (tools/check_examples.sh: -k 15 -s 8 -l 1 --discard
    0.6 --dust 5, a taxonomy, --breadth-ratio) plus --jplace and the
    filtered scores TSV, at the species rank; ``lines`` collects
    (seconds since now, log line)."""
    os.makedirs(os.path.join(out, name), exist_ok=True)
    t0 = time.perf_counter()
    return td.MetaConfig(
        panman="synthetic", reads1=reads1 or w.reads1,
        output=os.path.join(out, name, "sample"), k=15, s=8, l=1,
        filter_and_assign=True, discard=0.6, dust=5,
        taxonomy_path=w.taxonomy, taxonomic_rank="species",
        breadth_ratio=True, jplace=True, write_read_scores_filtered=True,
        log=lambda m, *a, **k: lines.append((time.perf_counter() - t0, m)),
        **kw)


def assignment_view(prefix):
    """The assignment outputs under ``prefix`` free of their record order:
    the FASTQ's records sorted, each .out line as node names -> (taxa, the
    sorted names of its reads), each .jplace as (tree, fields, read name ->
    its sorted placements)."""
    with open(prefix + ".mgsr.assignedReads.fastq") as fh:
        lines = fh.read().split("\n")
    recs = list(zip(lines[0::4], lines[1::4], lines[3::4]))[:len(lines) // 4]
    names = [r[0][1:] for r in recs]
    view = {"reads": sorted(recs)}
    for ext in ASSIGN_OUT:
        table = {}
        with open(f"{prefix}.{ext}") as fh:
            for ln in fh:
                nodes, taxa, count, idxs = ln.rstrip("\n").split("\t")
                reads = sorted(names[int(i)] for i in idxs.split(","))
                if int(count) != len(reads) or nodes in table:
                    raise AssertionError(f"{ext}: malformed line for {nodes}")
                table[nodes] = (taxa, reads)
        view[ext] = table
    for ext in ASSIGN_JPLACE:
        with open(f"{prefix}.{ext}") as fh:
            jp = json.load(fh)
        view[ext] = (jp["tree"], jp["fields"],
                     {tuple(pl["n"]): sorted(map(tuple, pl["p"]))
                      for pl in jp["placements"]})
    return view


@contextlib.contextmanager
def timed_methods(calls, sync, *targets):
    """For the block, every (class, method name) of ``targets`` is wrapped:
    each call appends (its positional arguments with self first, arrays
    copied as they were at the call, its result, its seconds with the
    device drained) to calls["Class.method"]."""
    import numpy as np

    def wrap(key, real):
        def method(*args, **kw):
            args = tuple(a.copy() if isinstance(a, np.ndarray) else a
                         for a in args)
            t0 = time.perf_counter()
            res = real(*args, **kw)
            sync()
            calls.setdefault(key, []).append(
                (args, res, time.perf_counter() - t0))
            return res
        return method

    saved = [(cls, name, getattr(cls, name)) for cls, name in targets]
    for cls, name, real in saved:
        setattr(cls, name, wrap(f"{cls.__name__}.{name}", real))
    try:
        yield
    finally:
        for cls, name, real in saved:
            setattr(cls, name, real)


def assign_phase(td, w, out, dev, cpu, sub_reads=40000, min_reads=2000):
    """Phase 11 (see the module docstring).  Returns (report, readings)."""
    import numpy as np
    import torch

    from panmap_tpu_torch.meta.engine import MetaScorer
    from panmap_tpu_torch.meta.engine_torch import TorchMetaScorer

    cuda = dev.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)

    def run(name, device, **kw):
        lines = []
        cfg = assign_cfg(td, w, out, name, lines, **kw)
        t0 = time.perf_counter()
        if td.run_meta(cfg, midx=w.midx, device=device) != 0:
            raise AssertionError(f"run_meta ({name}) failed")
        sync()
        wall = time.perf_counter() - t0
        fast = bool([m for _, m in lines if "batched scoring" in m])
        if fast == bool(kw.get("host_score")):
            raise AssertionError(f"{name}: took the "
                                 f"{'batched' if fast else 'replay'} route")
        return cfg.output, lines, wall

    # the whole sample on the card, the batched scorer's route, with the
    # scorers' set-up and both device passes timed where run_meta calls them
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    calls = {}
    with timed_methods(calls, sync, (MetaScorer, "__init__"),
                       (TorchMetaScorer, "__init__"),
                       (TorchMetaScorer, "score_all"),
                       (TorchMetaScorer, "assignment_pass")):
        full, lines, wall = run("assign", dev)
    peak = torch.cuda.max_memory_allocated() / 2**20 if cuda else 0.0
    if any(len(v) != 1 for v in calls.values()) or len(calls) != 4:
        raise AssertionError(f"assign: scorer calls "
                             f"{ {k: len(v) for k, v in calls.items()} }")
    split = dict(tree_collapse_s=calls["MetaScorer.__init__"][0][2],
                 events_prep_upload_s=calls["TorchMetaScorer.__init__"][0][2],
                 score_all_s=calls["TorchMetaScorer.score_all"][0][2])
    (fast, *pass_args), got, pass_s = calls[
        "TorchMetaScorer.assignment_pass"][0]
    pairs = fast.pairs_copied
    at = {key: t for t, m in lines for key in (
        "batch 1:", "batched scoring", "read_scores_info", "reads written",
        "jplace outputs", "breadths.out") if key in m}
    uniq = next(m for _, m in lines if "unique sets" in m).split()
    n_in, n_unique, n_dust = int(uniq[3]), int(uniq[6]), int(uniq[9][1:])
    n_assigned = int(next(m for _, m in lines
                          if "reads written" in m).split()[1])
    if n_in != w.n_reads or n_unique < min_reads or not (
            0.5 * w.n_target <= n_assigned <= w.n_target):
        raise AssertionError(f"assign: {n_in} reads, {n_unique} unique, "
                             f"{n_assigned} assigned of {w.n_target} drawn "
                             f"from the taxa")
    stages = dict(
        read_dust_sketch_s=at["batch 1:"],
        events_prep_score_s=at["batched scoring"] - at["batch 1:"],
        assign_write_s=at["reads written"] - at["batched scoring"],
        jplace_s=at["jplace outputs"] - at["reads written"],
        breadth_s=at["breadths.out"] - at["jplace outputs"])

    # the first reads on both routes (CPU tensors: the whole sample's
    # assignment_pass below)
    head = head_fastq(w.reads1, os.path.join(out, "assign_head.fastq"),
                      sub_reads)
    on_card, _, card_wall = run("assign_head", dev, reads1=head)
    on_host, _, host_wall = run("assign_head_host", dev, reads1=head,
                                host_score=True)
    sizes = [f"{ext} {os.path.getsize(f'{on_card}.{ext}')} B"
             for ext in ASSIGN_FILES]
    for ext in ASSIGN_BYTE_EQUAL:
        if not filecmp.cmp(f"{on_card}.{ext}", f"{on_host}.{ext}",
                           shallow=False):
            raise AssertionError(f"assign: {ext} differs from the replay DFS")
    a, b = assignment_view(on_card), assignment_view(on_host)
    for key in a:
        if a[key] != b[key]:
            raise AssertionError(f"assign: {key} differs from the replay DFS")
    n_sub = len(a["reads"])
    n_lca_nodes = len(a[ASSIGN_OUT[1]])
    if n_sub == 0 or len(a[ASSIGN_OUT[0]]) < 10:
        raise AssertionError("assign: nothing assigned on the subset")

    # the whole batch's assignment_pass, as run_meta called it on the card,
    # against the same call on CPU tensors
    t0 = time.perf_counter()
    on_cpu_tensors = TorchMetaScorer(w.midx, fast.reads, cpu)
    cpu_setup_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    want = on_cpu_tensors.assignment_pass(*pass_args)
    cpu_pass_s = time.perf_counter() - t0
    del on_cpu_tensors
    if (list(got[0].items()) != list(want[0].items())
            or len(got[1]) != len(want[1])
            or any(r != q or not np.array_equal(x, y)
                   for (r, x), (q, y) in zip(got[1], want[1]))
            or not np.array_equal(got[2], want[2])
            or not all(np.array_equal(x, y)
                       for x, y in zip(got[3], want[3]))):
        raise AssertionError("assignment_pass on the card != on CPU tensors")
    if cuda:
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated() / 2**20
        torch.cuda.reset_peak_memory_stats()
        kern_ms, top = device_kernel_ms(
            lambda: fast.assignment_pass(*pass_args), top=5)
        pass_peak = torch.cuda.max_memory_allocated() / 2**20
    else:
        kern_ms, top, held, pass_peak = 0.0, "no device", 0.0, 0.0
    live = int((pass_args[1] > 0).sum())
    blocks = -(-live // fast.READ_CHUNK)
    chunks = sum(1 for lo in fast._chunk_lo if lo < fast.n_nodes)
    readings = dict(
        nodes=len(w.midx.node_ids), index_rows=w.n_rows,
        seeds=len(w.midx.seed_hash), reads=n_in, low_complexity=n_dust,
        unique_read_sets=n_unique, target_reads=w.n_target,
        assigned=n_assigned, wall_s=wall, peak_device_mib=peak,
        pass_held_device_mib=held, pass_peak_device_mib=pass_peak, **stages,
        head_reads=sub_reads, head_assigned=n_sub, head_card_s=card_wall,
        head_host_route_s=host_wall,
        pass_live_reads=live,
        pass_chunks=chunks, pass_blocks=blocks, pass_syncs=fast.nonzero_syncs,
        pass_pairs_copied=pairs, pass_wall_s=pass_s,
        pass_cpu_tensor_s=cpu_pass_s, cpu_tensor_setup_s=cpu_setup_s,
        pass_kernel_ms=kern_ms, bitmap_rows=fast.n_rows, slots=fast.n_slots,
        events=len(fast.ev_pos), **split)
    report = (
        f"run_meta --filter-and-assign on {n_in} reads over "
        f"{len(w.midx.node_ids)} nodes / {w.n_rows} index rows: batched "
        f"scorer's route, {n_dust} low-complexity, {n_unique} unique read "
        f"sets, {n_assigned} reads assigned of {w.n_target} drawn from "
        f"{len(w.taxa)} taxa; wall {wall:.2f}s = "
        + ", ".join(f"{k[:-2]} {v:.2f}s" for k, v in stages.items())
        + " (of events_prep_score: "
        + ", ".join(f"{k[:-2]} {v:.2f}s" for k, v in split.items())
        + f", assignment_pass {pass_s:.3f}s); peak device memory {peak:.0f} MiB; first {sub_reads} reads "
        f"({n_sub} assigned, {n_lca_nodes} LCA nodes): card {card_wall:.2f}s ("
        + ", ".join(sizes) + f") == replay DFS (--host-score, "
        f"{host_wall:.2f}s) as assignments and on "
        f"{' and '.join(ASSIGN_BYTE_EQUAL)} byte for byte; the whole "
        f"sample's assignment_pass ({live} read sets with eff > 0, bitmap "
        f"{fast.n_rows} x {fast.NODE_CHUNK}, {fast.n_slots} slots, {chunks} "
        f"chunks x {blocks} blocks, {fast.nonzero_syncs} nonzero syncs "
        f"counted, "
        f"{pairs} pairs copied; {held:.0f} MiB held before the pass, "
        f"{pass_peak:.0f} MiB at its peak): card {pass_s:.3f}s == CPU tensors "
        f"{cpu_pass_s:.2f}s (their set-up {cpu_setup_s:.2f}s) on the four "
        f"values; device kernels {kern_ms:.2f} ms: {top}")
    return report, readings


def split_fastq(src, dst_pattern, n_parts):
    """``src``'s records dealt into ``n_parts`` files of consecutive
    records; returns their paths."""
    with open(src) as fh:
        lines = fh.readlines()
    per = -(-(len(lines) // 4) // n_parts)
    paths = []
    for k in range(n_parts):
        paths.append(dst_pattern.format(k))
        with open(paths[-1], "w") as fh:
            fh.writelines(lines[4 * k * per:4 * (k + 1) * per])
    return paths


def batch_phase(tp, sw, w, out, dev, n_samples=8):
    """Phase 12 (see the module docstring).  Returns (report, readings, the
    one-sample run's SW launches, their captured [(q, r, qlens, out)], the
    samples' [(reads1, reads2)] and their single runs' prefixes)."""
    r1 = split_fastq(w.reads1, os.path.join(out, "batch_s{}_R1.fastq"),
                     n_samples)
    r2 = split_fastq(w.reads2, os.path.join(out, "batch_s{}_R2.fastq"),
                     n_samples)
    samples = list(zip(r1, r2))
    singles, single_walls = [], []
    for k, reads in enumerate(samples):
        cfg = pipeline_cfg(tp, w, out, f"batch_single_{k}", reads=reads)
        *_, walls, _ = run_stages(tp, w, cfg, dev, {})
        singles.append(cfg.output)
        single_walls.append(walls["total"])

    def manifest(name, picks, prefixes):
        path = os.path.join(out, name + ".txt")
        with open(path, "w") as fh:
            for k, prefix in zip(picks, prefixes):
                fh.write(f"{samples[k][0]} {samples[k][1]} {prefix}\n")
        return path

    class CountingPlacer(tp.TorchPlacer):
        built = 0

        def __init__(self, *a, **k):
            CountingPlacer.built += 1
            super().__init__(*a, **k)

    def run(name, picks, prefixes):
        lines = []
        cfg = tp.PipelineConfig(
            panman="synthetic", batch_file=manifest(name, picks, prefixes),
            log=lambda m, *a, **k: lines.append(m))
        CountingPlacer.built = 0
        real, tp.TorchPlacer = tp.TorchPlacer, CountingPlacer
        try:
            t0 = time.perf_counter()
            rc = tp.run_batch(cfg, device=dev, idx=w.idx, tree=w.tree)
            wall = time.perf_counter() - t0
        finally:
            tp.TorchPlacer = real
        if CountingPlacer.built != 1:
            raise AssertionError(f"batch {name}: {CountingPlacer.built} "
                                 f"TorchPlacers built (index uploads)")
        return rc, lines, wall

    every = list(range(n_samples))
    prefixes = [os.path.join(out, "batch", f"s{k}", "sample") for k in every]
    rc, lines, wall = run("batch", every, prefixes)
    pool = [x for x in lines if "forked workers" in x]
    if rc != 0 or not pool:
        raise AssertionError(f"batch: exit code {rc}, log {lines}")
    for k in every:
        same_outputs(prefixes[k], singles[k], f"sample {k}'s single run")

    # one prefix lies under a regular file: that sample fails alone
    blocker = os.path.join(out, "batch_blocker")
    with open(blocker, "w") as fh:
        fh.write("a file, not a directory\n")
    bad = n_samples // 2
    prefixes2 = [os.path.join(out, "batch_bad", f"s{k}", "sample")
                 for k in every]
    prefixes2[bad] = os.path.join(blocker, "sub", "sample")
    rc2, lines2, _ = run("batch_bad", every, prefixes2)
    failed = [x for x in lines2 if "FAILED" in x]
    if rc2 != 1 or len(failed) != 1 or f"[{bad + 1}/" not in failed[0]:
        raise AssertionError(f"batch with a bad prefix: exit code {rc2}, "
                             f"log {lines2}")
    for k in every:
        if k != bad:
            same_outputs(prefixes2[k], singles[k],
                         f"sample {k}'s single run")

    # one sample: in process, on the card, the SW kernel included, its
    # launch captured as pipeline_phase captures the main path's
    captured = []
    launch = sw.banded_sw_scores

    def capturing(q, r, qlens):
        res = launch(q, r, qlens)
        captured.append((q, r, qlens, res))
        return res

    one = os.path.join(out, "batch_one", "sample")
    sw.banded_sw_scores = capturing
    sw.LAUNCHES = 0
    try:
        rc1, lines1, one_wall = run("batch_one", [0], [one])
    finally:
        sw.banded_sw_scores = launch
    launches = sw.LAUNCHES
    if len(captured) != launches:
        raise AssertionError(f"one-sample batch: {len(captured)} calls of "
                             f"the SW wrapper, {launches} launches")
    if rc1 != 0 or launches != 1 or [x for x in lines1
                                     if "forked workers" in x]:
        raise AssertionError(f"one-sample batch: exit code {rc1}, SW "
                             f"launches {launches}, log {lines1}")
    same_outputs(one, singles[0], "sample 0's single run")
    readings = dict(samples=n_samples, batch_wall_s=wall,
                    single_walls_s=single_walls,
                    sum_single_walls_s=sum(single_walls),
                    index_uploads=CountingPlacer.built,
                    one_sample_wall_s=one_wall,
                    one_sample_sw_launches=launches)
    report = (f"run_batch on {n_samples} samples of {w.n_reads // n_samples} "
              f"reads: exit code 0, 1 TorchPlacer built (1 index upload), "
              f"wall {wall:.2f}s beside {sum(single_walls):.2f}s for the "
              f"{n_samples} single-sample runs on the card (each its own "
              f"upload; {min(single_walls):.2f}-{max(single_walls):.2f}s); "
              f"{pool[0]}; every sample's five outputs byte-equal to its "
              f"single run; with sample {bad + 1}'s prefix under a regular "
              f"file: exit code 1, that sample FAILED, the other "
              f"{n_samples - 1} byte-equal; one sample in process: "
              f"{one_wall:.2f}s, SW kernel launches {launches}, byte-equal")
    return report, readings, launches, captured, samples, singles


def tally_phase(args, dev, reps=5):
    """Phase 13: tally_columns_device on ``dev`` on the grouped entries the
    short pipeline's genotyping gave it (col_id, g_q, g_s, g_b, ncol),
    against the numpy bincounts of genotype.caller._pileup_finish.  Both
    timed as the pipeline calls them: host arrays in, host arrays out."""
    import numpy as np
    import torch

    from panmap_tpu_torch.genotype.caller import tally_columns_device

    col_id, g_q, g_s, g_b, ncol = args[:5]

    def host():
        v = g_b < 4
        f, r = v & (g_s == 0), v & (g_s == 1)
        return (np.bincount(col_id * 5 + np.minimum(g_b, 4),
                            minlength=ncol * 5).reshape(ncol, 5),
                np.bincount(col_id[v] * 4 + g_b[v],
                            weights=g_q[v].astype(np.float64),
                            minlength=ncol * 4).reshape(ncol, 4),
                np.bincount(col_id[f] * 4 + g_b[f],
                            minlength=ncol * 4).reshape(ncol, 4),
                np.bincount(col_id[r] * 4 + g_b[r],
                            minlength=ncol * 4).reshape(ncol, 4))

    def card():
        return tally_columns_device(col_id, g_q, g_s, g_b, ncol, dev)

    got, want = card(), host()
    for name, a, b in zip(("BCF", "QS", "ADF", "ADR"), got, want):
        if a.dtype != b.dtype or not np.array_equal(a, b):
            raise AssertionError(f"device tally {name} != numpy bincounts")
    times = []
    for fn in (card, host):
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        if dev.type == "cuda":
            torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0) / reps)
    readings = dict(entries=len(col_id), columns=int(ncol),
                    device_ms=times[0], numpy_ms=times[1])
    report = (f"tally_columns_device on the card == numpy bincounts on the "
              f"short pipeline's {len(col_id)} grouped entries over {ncol} "
              f"columns (BCF, QS, ADF, ADR; types too): card {times[0]:.3f} "
              f"ms (upload, 4 index_add_, 4 copies back), numpy "
              f"{times[1]:.3f} ms, mean of {reps}")
    return report, readings


def placement_view(res):
    """A PlacementScores as plain data: {metric: [best, score, ties]}."""
    return {m: [res.best_index[m], res.best_score[m], res.tied_indices[m]]
            for m in res.best_index}


def mesh_placement_phase(tp, TorchPlacer, pm, sw, w, sk, exact, out, dev,
                         main_launches):
    """Phase 15a: a mesh of two shards on ``dev``; its place_exact on phase
    4's sketch against the unsharded placer (both routes) and the f64 host
    engine, each timed; then the short pipeline placed on it (run_placement
    with that placer), its outputs byte-equal to phase 5's, the SW launch
    count reset just before and read just after.  Returns (report,
    readings, the mesh, its placer)."""
    import torch

    mesh = pm.make_mesh(devices=[dev, dev])
    t0 = time.perf_counter()
    sharded = TorchPlacer(w.idx, dev, mesh=mesh)
    torch.cuda.synchronize()
    upload_s = time.perf_counter() - t0
    if sharded.dev.csc is not None or len(sharded.dev.shards) != 2:
        raise AssertionError("the mesh placer is not sharded")
    one = TorchPlacer(w.idx, dev)
    readings, parts = dict(shards=mesh.size, sharded_upload_s=upload_s), []
    reduced = []
    real = pm.reduce_partials

    def counting(p, m):
        reduced.append(len(p))
        return real(p, m)

    pm.reduce_partials = counting
    try:
        for name, placer, rcap in (
                ("unsharded_sparse", one, TorchPlacer.RCAP_MAX),
                ("unsharded_full_stream", one, 0),
                ("sharded", sharded, TorchPlacer.RCAP_MAX)):
            placer.RCAP_MAX = rcap
            got = placer.place_exact(sk)
            if got is None:
                raise AssertionError(f"place_exact ({name}) refused")
            same_placement(got, exact, f"place_exact ({name}) vs host "
                                       f"engine")
            step = []
            for _ in range(3):
                t1 = time.perf_counter()
                fin = placer.place_exact_async(sk)
                torch.cuda.synchronize()
                step.append(time.perf_counter() - t1)
                fin()
            kern_ms, top = device_kernel_ms(
                lambda: placer.place_exact_async(sk))
            readings[name] = dict(dispatch_sync_ms=1e3 * min(step),
                                  device_ms=kern_ms)
            parts.append(f"{name} dispatch->sync {1e3 * min(step):.1f} ms "
                         f"(min of 3), device kernels {kern_ms:.2f} ms: "
                         f"{top}")
    finally:
        pm.reduce_partials = real
        one.RCAP_MAX = TorchPlacer.RCAP_MAX
    if not reduced or set(reduced) != {2}:
        raise AssertionError(f"the sharded placer reduced {reduced}")

    cfg, stats = pipeline_cfg(tp, w, out, "mesh_pipeline"), {}
    sw.LAUNCHES = 0
    best, n_reads, _, walls, _ = run_stages(tp, w, cfg, dev, stats,
                                            placer=sharded)
    launches = sw.LAUNCHES
    if launches != main_launches:
        raise AssertionError(f"the pipeline on the mesh launched the SW "
                             f"kernel {launches} times, phase 5 "
                             f"{main_launches}")
    same_outputs(cfg.output, os.path.join(out, "device", "sample"),
                 "phase 5's run")
    readings.update(pipeline_wall_s=walls["total"],
                    pipeline_place_s=walls["place"], sw_launches=launches)
    report = (f"a mesh of 2 shards on {dev}: place_exact == unsharded == "
              f"f64 host engine; sharded index upload {upload_s:.2f}s; "
              + "; ".join(parts)
              + f"; the pipeline placed on the mesh -> {best}: "
              + ", ".join(f"{k} {v:.2f}s" for k, v in walls.items())
              + f", SW launches {launches}, the five outputs byte-equal to "
              f"phase 5's")
    return report, readings, mesh


def mesh_meta_phase(td, em, pm, TorchMetaScorer, mw, scored, mesh, dev):
    """Phase 15b: TorchMetaScorer on the mesh, its scores bit-equal to
    phase 9's; the EM with its reads sharded over the mesh within 2e-4 of
    the unsharded EM, on phase 9's snapshot and on the matrix pinned to the
    five haplotypes (phase 10's --em-candidates run).  Returns (report,
    readings, the pinned EM's inputs and unsharded result)."""
    import numpy as np
    import torch

    cfg, reads, cand = scored["cfg"], scored["reads"], scored["cand"]
    t0 = time.perf_counter()
    fast = TorchMetaScorer(mw.midx, reads, dev, mesh=mesh)
    torch.cuda.synchronize()
    prep_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ms, snap = fast.score_all(cand)
    torch.cuda.synchronize()
    score_s = time.perf_counter() - t0
    if not np.array_equal(ms, scored["max_score"]) or not torch.equal(
            snap, scored["snap"]):
        raise AssertionError("the mesh scorer's scores != phase 9's")
    id_of = {nm: i for i, nm in enumerate(mw.midx.node_ids)}
    pinned = [id_of[h] for h in mw.haplotypes]
    _, psnap = fast.score_all(pinned)
    lens, weights = td.em_inputs(cfg, reads, scored["max_score"])
    readings = dict(scorer_prep_s=prep_s, scorer_score_s=score_s)
    parts = []
    kw = dict(eta=cfg.em_convergence_threshold,
              max_change_threshold=cfg.em_delta_threshold,
              max_iterations=cfg.em_maximum_iterations,
              max_rounds=cfg.em_maximum_rounds)
    for name, S, cols in (("snapshot", snap, cand), ("pinned", psnap,
                                                     pinned)):
        names = [mw.midx.node_ids[n] for n in cols]
        res = {}
        for how, m in (("unsharded", None), ("sharded", mesh)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res[how] = em.run_squarem(S, lens, weights, names, mesh=m, **kw)
            res[how + "_s"] = time.perf_counter() - t0
        a, b = res["unsharded"], res["sharded"]
        drift = float(np.abs(a.props - b.props).max()) if len(
            a.props) == len(b.props) else np.inf
        if a.node_names != b.node_names or drift > 2e-4:
            raise AssertionError(f"sharded EM ({name}) vs unsharded: "
                                 f"{len(a.node_names)} / "
                                 f"{len(b.node_names)} columns, drift "
                                 f"{drift}")
        readings[f"em_{name}"] = dict(
            R=len(reads), M=len(cols), drift=drift,
            unsharded_s=res["unsharded_s"], sharded_s=res["sharded_s"],
            unsharded_steps=a.n_iterations, sharded_steps=b.n_iterations)
        parts.append(f"EM on the {name} ({len(reads)} x {len(cols)}): "
                     f"unsharded {res['unsharded_s']:.3f}s / "
                     f"{a.n_iterations} steps, sharded {res['sharded_s']:.3f}"
                     f"s / {b.n_iterations} steps, max |diff| {drift:.1e}")
        if name == "pinned":
            em_case = dict(S=psnap.cpu().numpy(), lens=lens, weights=weights,
                           names=names, props=a.props, kw=kw)
    report = (f"TorchMetaScorer on the mesh: scores bit-equal to phase 9's "
              f"(host prep + upload {prep_s:.2f}s, scoring {score_s:.3f}s); "
              + "; ".join(parts))
    return report, readings, em_case


def free_port():
    import socket

    with socket.socket() as so:
        so.bind(("localhost", 0))
        return so.getsockname()[1]


def dist_phase(w, sk, exact, em_case, samples, singles, out, timeout=400):
    """Phase 15c: two processes on the one card over gloo (this script
    with --dist-child), each a rank of one group: place_exact over index
    rows sharded across both ranks, the EM over reads sharded across both
    ranks, and the phase-12 manifest split between them.  Every sample's
    outputs byte-equal to its single run of phase 12.  Returns (report,
    readings)."""
    import pickle

    import numpy as np

    d = os.path.join(out, "dist")
    os.makedirs(d, exist_ok=True)
    manifest = os.path.join(d, "manifest.txt")
    prefixes = [os.path.join(d, f"s{k}", "sample") for k in range(len(samples))]
    with open(manifest, "w") as fh:
        for (r1, r2), prefix in zip(samples, prefixes):
            fh.write(f"{r1} {r2} {prefix}\n")
    data = os.path.join(d, "inputs.pkl")
    with open(data, "wb") as fh:
        pickle.dump(dict(idx=w.idx, tree=w.tree, sk=sk,
                         exact=placement_view(exact), em=em_case,
                         manifest=manifest), fh)
    addr = f"localhost:{free_port()}"
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--dist-child", str(r),
         "2", addr, data, os.path.join(d, f"rank{r}.json")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(2)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    wall = time.perf_counter() - t0
    if any(p.returncode for p in procs):
        raise AssertionError("a rank failed:\n" + "\n".join(
            f"rank {r} (exit {p.returncode}):\n{log[-3000:]}"
            for r, (p, log) in enumerate(zip(procs, logs))))
    ranks = []
    for r in range(2):
        with open(os.path.join(d, f"rank{r}.json")) as fh:
            ranks.append(json.load(fh))
    a, b = ranks
    if a["em_props"] != b["em_props"] or a["em_names"] != b["em_names"]:
        raise AssertionError("the ranks' EMs differ")
    drift = float(np.abs(np.array(a["em_props"]) - em_case["props"]).max())
    if a["em_names"] != list(em_case["names"]) or drift > 2e-4:
        raise AssertionError(f"cross-rank EM vs one process: drift {drift}")
    for k, prefix in enumerate(prefixes):
        same_outputs(prefix, singles[k], f"sample {k}'s single run")
    readings = dict(wall_s=wall, em_drift=drift, ranks=ranks)
    report = (f"2 ranks on one card over gloo ({addr}), "
              f"{wall:.1f}s for both: "
              + "; ".join(f"rank {r['rank']} ({r['card']}, mesh of "
                          f"{r['mesh_size']}): index upload "
                          f"{r['upload_s']:.2f}s, place_exact == f64 host "
                          f"engine, dispatch->sync {r['place_ms']:.1f} ms; "
                          f"EM {r['em_s']:.3f}s / {r['em_steps']} steps; "
                          f"batch of {r['n_samples']} samples "
                          f"{r['batch_s']:.2f}s, exit code {r['batch_rc']}"
                          for r in ranks)
              + f"; EM equal in both ranks, max |diff| to one process "
              f"{drift:.1e}; the {len(prefixes)} samples' outputs "
              f"byte-equal to their single runs")
    return report, readings


def dist_child(rank, nprocs, addr, data, out):
    """One rank of phase 15c (see dist_phase)."""
    import pickle

    import torch

    sys.path.insert(0, REPO)
    from panmap_tpu_torch import pipeline as tp
    from panmap_tpu_torch.meta import em
    from panmap_tpu_torch.parallel import dist, mesh as pm
    from panmap_tpu_torch.place.query_torch import TorchPlacer
    from panmap_tpu_torch.utils.device import as_device

    lines = []
    if not dist.maybe_initialize(addr, nprocs, rank, log=lines.append):
        raise RuntimeError("no process group")
    dev = as_device(None)
    with open(data, "rb") as fh:
        d = pickle.load(fh)
    mesh = pm.make_mesh()
    rep = dict(rank=mesh.rank, card=str(dev), mesh_size=mesh.size)
    if mesh.size != nprocs or mesh.devices != [dev]:
        raise AssertionError(f"mesh {mesh}")
    t0 = time.perf_counter()
    placer = TorchPlacer(d["idx"], dev, mesh=mesh)
    torch.cuda.synchronize()
    rep["upload_s"] = time.perf_counter() - t0
    got = placer.place_exact(d["sk"])
    if got is None or placement_view(got) != d["exact"]:
        raise AssertionError(f"rank {rank}: place_exact != host engine")
    step = []
    for _ in range(3):
        t0 = time.perf_counter()
        placer.place_exact_async(d["sk"])()
        step.append(time.perf_counter() - t0)
    rep["place_ms"] = 1e3 * min(step)
    e = d["em"]
    t0 = time.perf_counter()
    res = em.run_squarem(torch.from_numpy(e["S"]).to(dev), e["lens"],
                         e["weights"], e["names"], mesh=mesh, **e["kw"])
    rep.update(em_s=time.perf_counter() - t0, em_steps=res.n_iterations,
               em_names=res.node_names, em_props=res.props.tolist())
    cfg = tp.PipelineConfig(panman="synthetic", batch_file=d["manifest"],
                            log=lines.append)
    t0 = time.perf_counter()
    rep["batch_rc"] = tp.run_batch(cfg, device=dev, idx=d["idx"],
                                   tree=d["tree"])
    rep["batch_s"] = time.perf_counter() - t0
    own = dist.process_read_shard(len(tp.read_batch_file(d["manifest"])))
    rep["n_samples"] = own.stop - own.start
    rep["lines"] = [str(x) for x in lines]
    dist.shutdown()
    with open(out, "w") as fh:
        json.dump(rep, fh)
    return 0 if rep["batch_rc"] == 0 else 1


def profile_phase(tp, sw, w, out, dev, main_launches):
    """Phase 15d: run_pipeline with --profile's profile_dir on the card
    (the index from a saved file, the synthetic tree in place of a PanMAN),
    SW launch count reset just before and read just after; the trace holds
    the SW kernel's device event and the outputs are byte-equal to phase
    5's.  Returns (report, readings)."""
    import glob

    from panmap_tpu_torch.io.index_io import save_index

    d = os.path.join(out, "profile")
    os.makedirs(d, exist_ok=True)
    panman = os.path.join(d, "x.panman")
    open(panman, "wb").close()
    os.utime(panman, (0, 0))  # older than the saved index: it is loaded
    idx_path = os.path.join(d, "x.ptidx.npz")
    save_index(idx_path, w.idx)
    cfg = pipeline_cfg(tp, w, out, "profile_run")
    cfg.panman, cfg.index_path = panman, idx_path
    cfg.profile_dir = os.path.join(d, "trace")
    lines = []
    cfg.log = lambda m, *a, **k: lines.append(m)
    load = tp.load_panman
    tp.load_panman = lambda path: w.tree
    sw.LAUNCHES = 0
    try:
        t0 = time.perf_counter()
        tp.run_pipeline(cfg, device=dev)
        wall = time.perf_counter() - t0
    finally:
        tp.load_panman = load
    launches = sw.LAUNCHES
    if launches != main_launches:
        raise AssertionError(f"the profiled pipeline launched the SW kernel "
                             f"{launches} times, phase 5 {main_launches}")
    same_outputs(cfg.output, os.path.join(out, "device", "sample"),
                 "phase 5's run")
    traces = glob.glob(os.path.join(cfg.profile_dir, "*.pt.trace.json"))
    if len(traces) != 1 or f"[profile] trace written to {cfg.profile_dir}" \
            not in lines:
        raise AssertionError(f"traces {traces}, log {lines[-3:]}")
    with open(traces[0]) as fh:
        events = json.load(fh)["traceEvents"]
    kern = [e for e in events if e.get("cat") == "kernel"]
    sw_ev = [e for e in kern if "banded_sw_kernel" in e.get("name", "")]
    if len(sw_ev) != launches:
        raise AssertionError(f"{len(sw_ev)} banded_sw_kernel events in the "
                             f"trace, {launches} launches")
    size = os.path.getsize(traces[0])
    readings = dict(wall_s=wall, trace_bytes=size, kernel_events=len(kern),
                    sw_launches=launches, sw_events=len(sw_ev),
                    sw_event_us=[e.get("dur") for e in sw_ev])
    report = (f"run_pipeline with --profile: {wall:.2f}s, trace "
              f"{os.path.basename(traces[0])} ({size} B, {len(events)} "
              f"events, {len(kern)} device kernels) holds "
              f"{len(sw_ev)} banded_sw_kernel event(s) "
              f"({', '.join(str(e.get('dur')) for e in sw_ev)} us); SW "
              f"launches {launches}; the five outputs byte-equal to phase "
              f"5's")
    return report, readings


def min_wall_ms(fn, sync, reps=3):
    """Least dispatch-to-sync milliseconds of fn() over reps runs, after a
    warm-up run."""
    fn()
    sync()
    walls = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        sync()
        walls.append(1e3 * (time.perf_counter() - t0))
    return min(walls)


def meta_view(res):
    """sketch_meta_reads_* output as plain data: ([(key bytes, n_dup)],
    [[read index]], n_dust)."""
    reads, dup, n_dust = res
    return ([(r.hashes.tobytes() + r.revs.tobytes()
              + r.qbeg.astype("int64").tobytes()
              + r.qend.astype("int64").tobytes(), r.n_dup) for r in reads],
            [[int(i) for i in d] for d in dup], n_dust)


def device_sketch_phase(pm, placer, seqs, mw, dev, cpu, meta_pairs=20000):
    """Phase 16a, f, g: the device read sketch (B8).  (a) TorchPlacer.
    sketch_device on every read, reduced on the host to (hash -> count),
    equal to the native host sketch's (H, C); the first chunk on the card
    bit-equal to the same calls on CPU tensors; its kernel ms and launches
    (torch.profiler) beside the host sketch of the same reads.  (f)
    sketch_meta_reads_batch on the meta workload's first ``meta_pairs``
    pairs on the card equal to its run on CPU tensors, and on every read
    equal to sketch_meta_reads_full as a multiset of (read, group) (its
    order differs; tests/test_torch_device_sketch.py).  (g)
    make_sharded_sketch_fn over two shards of the card bit-equal to the
    unsharded scan.  Returns (report, readings)."""
    import numpy as np
    import torch

    from panmap_tpu_torch.io import fastq
    from panmap_tpu_torch.meta.engine import sketch_meta_reads_full
    from panmap_tpu_torch.meta.engine_torch import sketch_meta_reads_batch
    from panmap_tpu_torch.native import sketch_count_native
    from panmap_tpu_torch.sketch import tpu as st

    sync = (torch.cuda.synchronize if dev.type == "cuda"
            else (lambda: None))
    p = placer.params
    scan = (p.k, p.s, p.t, p.open)
    chunk = seqs[: placer.batch]
    # (a) every read: the device's count table is the host sketch's
    all_ms = min_wall_ms(lambda: placer.sketch_device(seqs), sync, reps=1)
    km, valid = placer.sketch_device(seqs)
    got_h, got_c = np.unique(km[valid].cpu().numpy().view(np.uint64),
                             return_counts=True)
    del km, valid
    t0 = time.perf_counter()
    want_h, want_c = sketch_count_native(seqs, *scan, p.l)
    host_all_ms = 1e3 * (time.perf_counter() - t0)
    if not (np.array_equal(got_h, want_h) and np.array_equal(got_c, want_c)):
        raise AssertionError(f"device sketch: {len(got_h)} distinct seeds, "
                             f"the host sketch {len(want_h)}; not equal")
    # the first chunk on the card against CPU tensors
    reads, lens = st.encode_reads_batch(chunk, pad_to=placer.pad_len)
    packed, nmask = st.pack_reads_2bit(reads)
    outs = []
    for d in (dev, cpu):
        codes = st.unpack_reads_2bit(torch.from_numpy(packed).to(d),
                                     torch.from_numpy(nmask).to(d),
                                     placer.pad_len)
        h, is_sync = st.syncmer_scan_batch(codes, torch.from_numpy(lens).to(d),
                                           *scan)
        outs.append([x.cpu() for x in (codes, h, is_sync)
                     + st.kminmer_batch(h, is_sync, p.k, p.l)])
    if not all(torch.equal(a, b) for a, b in zip(*outs)):
        raise AssertionError("the first chunk's sketch on the card != on "
                             "CPU tensors")
    # the profile that decides on a hand kernel: one chunk
    chunk_ms = min_wall_ms(lambda: placer.sketch_device(chunk), sync)
    host_chunk_ms = min_wall_ms(
        lambda: sketch_count_native(chunk, *scan, p.l), lambda: None)
    if dev.type == "cuda":
        kern_ms, launches, copy_ms, top = profile_kernels(
            lambda: placer.sketch_device(chunk))
    else:
        kern_ms = launches = copy_ms = top = None
    # (g) two shards of the card against the unsharded scan
    codes = torch.from_numpy(reads).to(dev)
    lens_d = torch.from_numpy(lens).to(dev)
    one = st.syncmer_scan_batch(codes, lens_d, *scan)
    two = pm.make_sharded_sketch_fn(pm.make_mesh(devices=[dev, dev]),
                                    *scan)(codes, lens_d)
    if not all(torch.equal(a, b) for a, b in zip(one, two)):
        raise AssertionError("the sharded sketch != the unsharded scan")
    del one, two, codes
    # (f) the meta read sketch
    mp = mw.midx.params
    margs = (mp.k, mp.s, mp.t, mp.l, mp.open)
    mseqs = fastq.read_paired_for_placement(mw.reads1, mw.reads2)
    head = mseqs[: 2 * meta_pairs]
    on_card = meta_view(sketch_meta_reads_batch(head, *margs, device=dev))
    if on_card != meta_view(sketch_meta_reads_batch(head, *margs,
                                                    device=cpu)):
        raise AssertionError("sketch_meta_reads_batch on the card != on CPU "
                             "tensors")
    t0 = time.perf_counter()
    batch_view = meta_view(sketch_meta_reads_batch(mseqs, *margs,
                                                   device=dev))
    meta_dev_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    full_view = meta_view(sketch_meta_reads_full(mseqs, *margs))
    meta_host_s = time.perf_counter() - t0

    def multiset(v):
        return sorted(zip(v[0], map(tuple, v[1]))), v[2]

    if multiset(batch_view) != multiset(full_view):
        raise AssertionError("sketch_meta_reads_batch != "
                             "sketch_meta_reads_full as a multiset")
    readings = dict(
        reads=len(seqs), distinct_seeds=int(len(got_h)),
        device_sketch_all_ms=all_ms, host_sketch_all_ms=host_all_ms,
        chunk_reads=len(chunk), chunk_device_ms=chunk_ms,
        chunk_host_ms=host_chunk_ms, chunk_kernel_ms=kern_ms,
        chunk_kernel_launches=launches, chunk_copy_ms=copy_ms,
        chunk_top_kernels=top,
        meta_reads=len(mseqs), meta_unique=len(batch_view[0]),
        meta_batch_s=meta_dev_s, meta_full_s=meta_host_s)
    report = (
        f"(a) sketch_device on {len(seqs)} reads == the native host "
        f"sketch's table ({len(got_h)} distinct seeds): card {all_ms:.1f} ms "
        f"(encode, pack, upload, scan), host {host_all_ms:.1f} ms; the first "
        f"chunk ({len(chunk)} reads) bit-equal to CPU tensors; one chunk: "
        f"card {chunk_ms:.2f} ms dispatch->sync, kernels "
        + (f"{kern_ms:.2f} ms in {launches} launches (copies {copy_ms:.2f} "
           f"ms; {top})" if kern_ms is not None else "not measured")
        + f", host sketch {host_chunk_ms:.2f} ms; (g) 2-shard sketch == "
        f"unsharded; (f) sketch_meta_reads_batch on {2 * meta_pairs} reads "
        f"card == CPU tensors, on {len(mseqs)} reads == "
        f"sketch_meta_reads_full as a multiset ({len(batch_view[0])} read "
        f"sets): card {meta_dev_s:.2f}s, host {meta_host_s:.2f}s")
    return report, readings


def same_best(got, want, what, scores_within=1e-4):
    """Best index and tie set equal per metric, best scores within
    ``scores_within``."""
    for m in want.best_index:
        if (got.best_index[m] != want.best_index[m]
                or got.tied_indices[m] != want.tied_indices[m]
                or abs(got.best_score[m] - want.best_score[m])
                > scores_within):
            raise AssertionError(f"{what}: metric {m}: best "
                                 f"{got.best_index[m]} / {want.best_index[m]}"
                                 f", {len(got.tied_indices[m])} / "
                                 f"{len(want.tied_indices[m])} tied")


def place_api_phase(placer, w, sk, seqs, samples, dev):
    """Phase 16b-e: the placement API beside place_exact.  (b) place on the
    card within 2e-4 of the f64 host engine, min-read-support -1 and 1, the
    device's distinct kept seeds equal to the host sketch's; (c) place_best
    == place_best_host (best index and ties equal, scores within 1e-4),
    force_leaf off and on, each best node in place_exact's tie set; (d)
    place_best_host_batch over the batch samples == each sample's
    place_best_host; (e) compute_scores_torch on phase 4's sketch within
    2e-4 of the host engine.  Dispatch-to-sync walls of each call.  Returns
    (report, readings)."""
    import numpy as np
    import torch

    from panmap_tpu_torch.io import fastq
    from panmap_tpu_torch.native import sketch_count_native
    from panmap_tpu_torch.place import engine_torch as pe
    from panmap_tpu_torch.place.engine import (prepare_read_sketch,
                                               score_nodes)

    sync = (torch.cuda.synchronize if dev.type == "cuda"
            else (lambda: None))
    p = w.idx.params
    readings = dict(pad_len=placer.pad_len, batch=placer.batch,
                    maxu=placer.MAXU)
    H, C = sketch_count_native(seqs, p.k, p.s, p.t, p.open, p.l)
    # (b)
    want = {}
    for ms in (-1, 1):
        sk_ms = sk if ms < 0 else prepare_read_sketch(
            (H, C.astype(np.int64)), p.k, len(seqs), ms)
        want[ms] = score_nodes(w.idx, sk_ms).scores
        got = placer.place(seqs, ms)
        err = float(np.abs(got - want[ms]).max())
        km, _ = placer.sketch_device(seqs)
        nuniq = int(placer._finalize_score(km, ms)[3])
        del km
        if err > 2e-4 or nuniq != sk_ms.read_unique_seed_count:
            raise AssertionError(f"place (min-read-support {ms}): max |diff| "
                                 f"{err:.3g} from the host engine, nuniq "
                                 f"{nuniq} / {sk_ms.read_unique_seed_count}")
        readings[f"place_ms{ms}"] = dict(max_abs_err=err, nuniq=nuniq)
    # (c)
    for fl in (False, True):
        dev_best = placer.place_best(seqs, force_leaf=fl)
        host_best = placer.place_best_host(seqs, force_leaf=fl)
        same_best(dev_best, host_best, f"place_best vs place_best_host "
                                       f"(force_leaf {fl})")
        ex = placer.place_exact(sk, force_leaf=fl)
        if ex is None:
            raise AssertionError(f"place_exact (force_leaf {fl}) refused")
        for m, best in dev_best.best_index.items():
            if (best is None) != (not ex.tied_indices[m]) or (
                    best is not None and best not in ex.tied_indices[m]):
                raise AssertionError(f"place_best's {m} best {best} is not "
                                     f"in place_exact's tie set")
    # (d)
    sample_seqs = [fastq.read_paired_for_placement(r1, r2)
                   for r1, r2 in samples]
    batched = placer.place_best_host_batch(sample_seqs)
    for k, s_ in enumerate(sample_seqs):
        same_best(batched[k], placer.place_best_host(s_),
                  f"batch sample {k} vs its place_best_host")
    # (e)
    freq = dict(zip(sk.sorted_hashes.tolist(), np.rint(np.expm1(
        sk.log_counts)).astype(np.int64).tolist()))
    ids, lc, *_ = pe.map_read_table(placer.dev, freq, sk.min_support)
    got = pe.compute_scores_torch(placer.dev, ids, lc, sk.log_read_magnitude,
                                  sk.read_unique_seed_count,
                                  sk.log_containment_denominator)
    err_e = float(np.abs(got - want[-1]).max())
    if err_e > 2e-4:
        raise AssertionError(f"compute_scores_torch: max |diff| {err_e:.3g}")
    readings["compute_scores_max_abs_err"] = err_e
    # walls, dispatch to sync (min of 3 after a warm-up)
    walls = dict(
        place=min_wall_ms(lambda: placer.place(seqs), sync),
        place_best=min_wall_ms(lambda: placer.place_best(seqs), sync),
        place_best_host=min_wall_ms(lambda: placer.place_best_host(seqs),
                                    sync),
        batch_of_8=min_wall_ms(
            lambda: placer.place_best_host_batch(sample_seqs), sync),
        singles_8=min_wall_ms(lambda: [placer.place_best_host(s_)
                                       for s_ in sample_seqs], sync))
    readings["dispatch_sync_ms"] = walls
    # device kernels of the all-device query and of the batched pass (B3
    # batched; its host sketches run first, outside the device's work)
    prof = {}
    if dev.type == "cuda":
        for name, fn in (
                ("place_best", lambda: placer.place_best(seqs)),
                ("batch_of_8",
                 lambda: placer.place_best_host_batch(sample_seqs))):
            kern_ms, launches, copy_ms, top = profile_kernels(fn)
            prof[name] = dict(kernel_ms=kern_ms, launches=launches,
                              copy_ms=copy_ms, top=top)
    readings["device_kernels"] = prof
    report = (
        f"(b) place == f64 host engine within "
        f"{readings['place_ms-1']['max_abs_err']:.2g} / "
        f"{readings['place_ms1']['max_abs_err']:.2g} (min-read-support -1 / "
        f"1; nuniq {readings['place_ms-1']['nuniq']} / "
        f"{readings['place_ms1']['nuniq']} of MAXU {placer.MAXU}); (c) "
        f"place_best == place_best_host, force_leaf off and on, best nodes "
        f"in place_exact's tie sets; (d) place_best_host_batch over "
        f"{len(samples)} samples == each one's place_best_host; (e) "
        f"compute_scores_torch within {err_e:.2g}; dispatch->sync ms (min "
        f"of 3): "
        + ", ".join(f"{k} {v:.1f}" for k, v in walls.items())
        + "".join(f"; {k} device kernels {v['kernel_ms']:.2f} ms in "
                  f"{v['launches']} launches ({v['top']})"
                  for k, v in prof.items()))
    return report, readings


@contextlib.contextmanager
def wrapped(obj, name, make):
    """``obj.name`` replaced by ``make(original)`` inside the block."""
    orig = getattr(obj, name)
    setattr(obj, name, make(orig))
    try:
        yield
    finally:
        setattr(obj, name, orig)


def marking(marks, key):
    """A wrapper maker: each call of the wrapped function records its
    start and end (perf_counter) under ``key`` in ``marks``."""
    def make(fn):
        def run(*a, **k):
            marks[key + "0"] = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                marks[key + "1"] = time.perf_counter()
                marks[key + "_n"] = marks.get(key + "_n", 0) + 1
        return run
    return make


def capturing(calls):
    """A wrapper maker: each call's (arguments, result) appended to
    ``calls``."""
    def make(fn):
        def run(*args):
            res = fn(*args)
            calls.append((args, res))
            return res
        return run
    return make


def stage_split(m):
    """A CLI run's wall by stage from ``marking``'s marks."""
    return {"load+place": m["place1"] - m["main0"],
            "tree wait": m["align0"] - m["place1"],
            "align": m["align1"] - m["align0"],
            "genotype+bam": m["consensus0"] - m["align1"],
            "consensus": m["consensus1"] - m["consensus0"]}


def vcf_records(path):
    with open(path) as fh:
        return [ln for ln in fh if not ln.startswith("#")]


def fasta_seq(path):
    """(name, sequence) of a one-record FASTA file."""
    with open(path) as fh:
        head = fh.readline()[1:].strip()
        return head, "".join(ln.strip() for ln in fh)


def panman_phase(args, tp, sw, long_dp, td, TorchPlacer, dev, cpu,
                 n_nodes=39999, n_pairs=51169, long_reads=1000,
                 meta_pairs=200000):
    """Phase 17 (see the module docstring): the CLI in this process on a
    PanMAN file written from --seed, with no stand-in for load_panman.
    Returns (report lines, readings, B1's launches on the cold run, B2's
    on the long-read run)."""
    import torch
    from types import SimpleNamespace

    from panmap_tpu_torch.__main__ import main as cli
    from panmap_tpu_torch.io import panman as pio
    from panmap_tpu_torch.io.index_io import load_index
    from panmap_tpu_torch.meta.index import load_meta_index
    from panmap_tpu_torch.synthetic import (make_panman_long_workload,
                                            make_panman_meta_workload,
                                            make_panman_workload,
                                            write_panman)

    out = os.path.join(args.out, "panman")
    lines, rd = [], {}
    t0 = time.perf_counter()
    w = make_panman_workload(os.path.join(out, "reads"), seed=args.seed,
                             n_nodes=n_nodes, n_pairs=n_pairs)
    rd["workload_s"] = time.perf_counter() - t0
    # the writer alone, and deterministic: a second write, the same bytes
    t1 = time.perf_counter()
    write_panman(w.panman + ".again", w.model)
    rd["write_s"] = time.perf_counter() - t1
    if not filecmp.cmp(w.panman, w.panman + ".again", shallow=False):
        raise AssertionError("two writes of one tree differ")
    os.remove(w.panman + ".again")
    rd["panman_bytes"] = os.path.getsize(w.panman)
    rd["tree"] = dict(nodes=len(w.model.names), blocks=len(w.model.blocks),
                      gap_runs=len(w.model.gaps),
                      nuc_records=len(w.model.nuc_muts),
                      leaves=len(w.model.leaves()))
    lines.append(
        f"[17a] workload: a PanMAN file of {len(w.model.names)} nodes "
        f"({rd['tree']['leaves']} leaves), {len(w.model.blocks)} blocks, "
        f"{len(w.model.nuc_muts)} nucleotide records, "
        f"{rd['panman_bytes']} B xz (write {rd['write_s']:.2f}s), "
        f"{w.n_reads} reads from a mutated copy of {w.leaf}; "
        f"{rd['workload_s']:.1f}s")

    decodes, marks = {}, {}

    def no_scalar(fn):
        def refuse(*a, **k):
            raise AssertionError("the scalar PanMAN decoder ran")
        return refuse

    def counting(fn):
        def run(*a, **k):
            ok = fn(*a, **k)
            decodes["fast"] = decodes.get("fast", 0) + bool(ok)
            return ok
        return run

    b1, b2 = [], []
    prefix = {k: os.path.join(out, k, "sample") for k in
              ("cold", "warm", "cpu", "long", "meta")}
    for p in prefix.values():
        os.makedirs(os.path.dirname(p), exist_ok=True)

    def b1_held(run):
        """B1's captured launches of ``run`` each bit-equal to its plain
        version; their (B, LQ, LW) shapes."""
        if not b1:
            raise AssertionError(f"{run}: B1 was never called")
        for (q, r, ql), res in b1:
            if not torch.equal(res, sw.banded_sw_scores_reference(q, r, ql)):
                raise AssertionError(f"B1 != its plain version on a launch "
                                     f"of the PanMAN path ({run})")
        return [tuple(a[0].shape) + (a[1].shape[1],) for a, _ in b1]

    def run_cli(argv):
        marks.clear()
        marks["main0"] = time.perf_counter()
        rc = cli([w.panman, *argv, "-q"])
        marks["main1"] = time.perf_counter()
        if rc != 0:
            raise AssertionError(f"the CLI returned {rc}: {argv}")
        return dict(marks)

    with contextlib.ExitStack() as stack:
        for obj, name, make in (
                (pio, "_decode_mutations_scalar", no_scalar),
                (pio, "_decode_mutations_fast", counting),
                (tp, "build_index", marking(marks, "build")),
                (td, "build_meta_index", marking(marks, "meta_build")),
                (tp, "run_placement", marking(marks, "place")),
                (tp, "run_alignment", marking(marks, "align")),
                (tp, "run_genotyping", marking(marks, "genotype")),
                (tp, "run_consensus", marking(marks, "consensus")),
                (sw, "banded_sw_scores", capturing(b1)),
                (long_dp, "long_dp_rows", capturing(b2))):
            stack.enter_context(wrapped(obj, name, make))

        # (a) cold: the index is built from the file and cached
        sw.LAUNCHES = long_dp.LAUNCHES = 0
        m = run_cli([w.reads1, w.reads2, "-o", prefix["cold"]])
        launches_a = sw.LAUNCHES
        cache = w.panman + ".ptidx.npz"
        if m.get("build_n") != 1 or not os.path.exists(cache):
            raise AssertionError("the cold run did not build and cache the "
                                 "index")
        idx = load_index(cache)
        rd["index_rows"] = int(len(idx.seed_hashes))
        rd["index_build_s"] = m["build1"] - m["build0"]
        rd["cold_s"] = m["main1"] - m["main0"]
        if launches_a == 0 or long_dp.LAUNCHES:
            raise AssertionError(f"cold run: B1 launched {launches_a} times, "
                                 f"B2 {long_dp.LAUNCHES}")
        shapes = b1_held("the cold run")
        n_var = len(vcf_records(prefix["cold"] + ".vcf"))
        if n_var == 0:
            raise AssertionError("the cold run called no variant")
        lines.append(
            f"[17a] cold CLI {rd['cold_s']:.2f}s: index built from the file "
            f"in {rd['index_build_s']:.2f}s ({rd['index_rows']} rows, "
            f"{len(idx.node_ids)} nodes) and cached; B1 launched "
            f"{launches_a} time(s) {shapes}, each bit-equal to its plain "
            f"version; {n_var} variants")

        # (b) warm: the cached index, the same five outputs
        b1.clear()
        sw.LAUNCHES = 0
        m = run_cli([w.reads1, w.reads2, "-o", prefix["warm"]])
        launches_b = sw.LAUNCHES
        if m.get("build_n") or launches_b == 0:
            raise AssertionError(f"warm run: built {m.get('build_n')}, B1 "
                                 f"launches {launches_b}")
        b1_held("the warm run")
        sizes = same_outputs(prefix["cold"], prefix["warm"], "the cold run")
        rd["warm_s"] = m["main1"] - m["main0"]
        rd["warm_split_s"] = stage_split(m)
        lines.append(
            f"[17b] warm CLI {rd['warm_s']:.2f}s = "
            + ", ".join(f"{k} {v:.2f}s" for k, v in
                        rd["warm_split_s"].items())
            + f" (the tree decoded on a thread meanwhile); B1 launched "
            f"{launches_b} time(s), each bit-equal to its plain version; "
            f"the five outputs byte-equal to the cold "
            f"run's: " + ", ".join(sizes))

        # (c) the stages on CPU tensors with the loaded tree; placement on
        # both device routes == TorchPlacer on CPU tensors == f64 engine
        t1 = time.perf_counter()
        tree = pio.load_panman(w.panman)
        rd["panman_load_s"] = time.perf_counter() - t1
        wl = SimpleNamespace(idx=idx, tree=tree, reads1=w.reads1,
                             reads2=w.reads2)
        ccfg = tp.PipelineConfig(panman=w.panman, reads1=w.reads1,
                                 reads2=w.reads2, output=prefix["cpu"],
                                 log=lambda *a, **k: None)
        cbest, *_ = run_stages(tp, wl, ccfg, cpu, {})
        same_outputs(prefix["warm"], prefix["cpu"], "the CPU-tensor run")
        pcfg = tp.PipelineConfig(panman=w.panman, reads1=w.reads1,
                                 reads2=w.reads2, output="",
                                 log=lambda *a, **k: None)
        report, _, _ = placement_phase(tp, TorchPlacer, wl, pcfg, dev, cpu)
        rd["cpu_s"] = time.perf_counter() - t1
        lines.append(f"[17c] load_panman {rd['panman_load_s']:.2f}s; the "
                     f"stages on CPU tensors: the five outputs "
                     f"byte-equal to the warm run's; place_exact == "
                     f"TorchPlacer on CPU tensors == f64 host engine: "
                     f"{report}; {rd['cpu_s']:.1f}s")

        # (d) the placed node against the source leaf
        best = fasta_seq(prefix["warm"] + ".ref.fa")[0]
        if best != cbest:
            raise AssertionError(f"CPU run placed {cbest}, the CLI {best}")
        genome = w.model.get_string(w.leaf)
        rd["source_leaf"] = w.leaf
        rd["placed"] = best
        rd["placed_is_leaf"] = best == w.leaf
        if w.model.get_string(best) != genome:
            raise AssertionError(f"placed on {best}, whose genome is not "
                                 f"the source leaf {w.leaf}'s")
        lines.append(f"[17d] placed on {best}: "
                     + ("the source leaf itself" if best == w.leaf else
                        f"a node of the source leaf {w.leaf}'s genome"))

        # (e) long reads through the CLI: B2 on the CLI's own launches
        t1 = time.perf_counter()
        lw = make_panman_long_workload(w, os.path.join(out, "long_reads"),
                                       seed=args.seed, n_reads=long_reads)
        b1.clear()
        sw.LAUNCHES = long_dp.LAUNCHES = 0
        m = run_cli([lw.reads1, "-o", prefix["long"]])
        launches_e = long_dp.LAUNCHES
        if launches_e == 0 or not b2:
            raise AssertionError("the long-read CLI never launched B2")
        long_err = max(same_rows(res, long_dp.long_dp_rows_reference(*a),
                                 "a launch of the PanMAN path")
                       for a, res in b2)
        lbest = fasta_seq(prefix["long"] + ".ref.fa")[0]
        if w.model.get_string(lbest) != w.model.get_string(lw.leaf):
            raise AssertionError(f"long reads placed on {lbest}, not on "
                                 f"the genome of {lw.leaf}")
        cells = float(sum(int((a[2][:, 0].long() * a[2][:, 2].long()).sum())
                          for a, _ in b2))
        rd["long"] = dict(reads=lw.n_reads, cli_s=m["main1"] - m["main0"],
                          split_s=stage_split(m),
                          b2_launches=launches_e, b1_launches=sw.LAUNCHES,
                          cells=cells, placed=lbest, leaf=lw.leaf,
                          variants=len(vcf_records(prefix["long"] + ".vcf")))
        lines.append(
            f"[17e] long reads: {lw.n_reads} reads of {lw.leaf} -> {lbest} "
            f"(its genome) in {rd['long']['cli_s']:.2f}s = "
            + ", ".join(f"{k} {v:.2f}s" for k, v in
                        rd["long"]["split_s"].items())
            + f"; B2 launched "
            f"{launches_e} time(s) over {cells / 1e9:.3f} G band cells, "
            f"each bit-equal to its plain version (max |diff| {long_err}); "
            f"{rd['long']['variants']} variants; "
            f"{time.perf_counter() - t1:.1f}s")

        # (f) --meta: the meta index built from the file, gate A
        t1 = time.perf_counter()
        mw = make_panman_meta_workload(w, os.path.join(out, "meta_reads"),
                                       seed=args.seed, n_pairs=meta_pairs)
        sw.LAUNCHES = long_dp.LAUNCHES = 0
        m = run_cli([mw.reads1, mw.reads2, "--meta", "--em-delta-threshold",
                     "0.00001", "-o", prefix["meta"]])
        mcache = w.panman + ".ptmidx.npz"
        if m.get("meta_build_n") != 1 or not os.path.exists(mcache):
            raise AssertionError("the meta index was not built and cached")
        if sw.LAUNCHES or long_dp.LAUNCHES:
            raise AssertionError("a kernel launched on the meta path")
        midx = load_meta_index(mcache)
        truth = dict(zip(mw.haplotypes, mw.proportions))
        un, mlines = abundance(prefix["meta"] + ".mgsr.abundance.out")
        missing = [h for h in truth if h not in un]
        if missing:
            raise AssertionError(f"haplotypes not in the output: {missing}")
        top = max(un, key=un.get)
        spur = sum(p for names, p in mlines if not set(names) & set(truth))
        errs = {h: un[h] - truth[h] for h in truth}
        if (top != max(truth, key=truth.get) or spur > 0.25
                or max(abs(e) for e in errs.values()) > 0.06):
            raise AssertionError(f"gate A: top {top}, spurious {spur:.4f}, "
                                 f"p - truth {errs}")
        rd["meta"] = dict(pairs=meta_pairs, rows=int(len(midx.delta_seed)),
                          seeds=int(len(midx.seed_hash)),
                          build_s=m["meta_build1"] - m["meta_build0"],
                          cli_s=m["main1"] - m["main0"], top=top,
                          max_err=max(abs(e) for e in errs.values()),
                          spurious=spur, props={h: un[h] for h in truth})
        lines.append(
            f"[17f] --meta on {2 * meta_pairs} reads of 5 leaves at "
            f"{mw.proportions}: meta index built from the file in "
            f"{rd['meta']['build_s']:.2f}s ({rd['meta']['rows']} delta rows, "
            f"{rd['meta']['seeds']} seeds) and cached; CLI "
            f"{rd['meta']['cli_s']:.2f}s; gate A: top {top}, |p - truth| <= "
            f"{rd['meta']['max_err']:.4f}, non-haplotype mass {spur:.4f}; "
            f"{time.perf_counter() - t1:.1f}s")

        # (g) the tools on the file
        t1 = time.perf_counter()
        node_fa = os.path.join(out, "node.fa")
        run_cli(["--dump-node", best, "-o", node_fa])
        if fasta_seq(node_fa) != fasta_seq(prefix["warm"] + ".ref.fa"):
            raise AssertionError("--dump-node != the warm run's ref.fa")
        sim = os.path.join(out, "sim", "sim")
        run_cli(["--simulate", "-o", sim])
        made = sorted(f for f in os.listdir(os.path.dirname(sim)))
        if made != ["sim.fa", "sim.truth.vcf", "sim_R1.fastq",
                    "sim_R2.fastq"]:
            raise AssertionError(f"--simulate wrote {made}")
        with open(sim + "_R1.fastq") as fh:
            n_sim = sum(1 for _ in fh) // 4
        lines.append(f"[17g] --dump-node {best} == the warm run's ref.fa; "
                     f"--simulate at its defaults: {n_sim} read pairs of a "
                     f"random leaf; {time.perf_counter() - t1:.1f}s")
    rd["fast_decodes"] = decodes.get("fast", 0)
    if rd["fast_decodes"] < 7:
        raise AssertionError(f"the fast decoder ran {rd['fast_decodes']} "
                             f"times")
    rd["b1_launches"] = dict(cold=launches_a, warm=launches_b)
    rd["phase_s"] = time.perf_counter() - t0
    lines.append(f"[17] every load took the vectorised decoder "
                 f"({rd['fast_decodes']} loads, the scalar one never); "
                 f"{rd['phase_s']:.1f}s")
    return lines, rd, launches_a, launches_e


def walls_phase(args, n_runs):
    """--walls: both builds, the short and the meta workload, then phase
    5's stages and phase 10's run_meta on the card n_runs times each, after
    one run of each that warms the card up and is not counted; one JSON
    line of each run's stage walls (run_meta's whole wall: no profiler
    runs here, so its spans are off)."""
    import torch

    from panmap_tpu_torch import _kernels, native
    from panmap_tpu_torch import pipeline as tp
    from panmap_tpu_torch.meta import driver as td
    from panmap_tpu_torch.synthetic import make_meta_workload, make_workload

    dev = torch.device("cuda", 0)
    _kernels.lib()
    if native.get_lib() is None:
        raise RuntimeError(f"the native host library did not build:\n"
                           f"{native.build_error}")
    shutil.rmtree(args.out, ignore_errors=True)
    w = make_workload(os.path.join(args.out, "reads"), seed=args.seed)
    mw = make_meta_workload(os.path.join(args.out, "meta_reads"),
                            seed=args.seed)
    runs, meta = [], []
    for k in range(n_runs + 1):
        cfg = pipeline_cfg(tp, w, args.out, f"walls{k}")
        runs.append(run_stages(tp, w, cfg, dev, {})[3])
    for k in range(n_runs + 1):
        cfg = meta_cfg(td, mw, args.out, f"meta_walls{k}")
        t0 = time.perf_counter()
        if td.run_meta(cfg, midx=mw.midx, device=dev) != 0:
            raise AssertionError("run_meta failed")
        meta.append({"wall_s": time.perf_counter() - t0})
    log(json.dumps({"port": REPO, "walls": runs[1:], "meta": meta[1:]}))
    return 0


def long_phases(args, tp, long_dp, rng, dev):
    """Phases 7 and 8.  Returns (launches on the main path, kernel ms over
    them, plain ms, max |diff|, band cells, (bound ms, what bounds it))."""
    from panmap_tpu_torch.synthetic import make_long_workload

    t0 = time.perf_counter()
    report, long_err = long_kernel_phase(long_dp, rng, dev, 256)
    n_edge, e = long_edge_phase(long_dp, rng, dev)
    long_err = max(long_err, e)
    log(f"[7] long DP kernel == plain version on 256 items (LQ 600-3000, "
        f"W 801-2401), max |diff| {long_err}: {report}; and on {n_edge} "
        f"edge launches (W 1-16384, off both ends of the reference, a query "
        f"of one base, both presets); "
        f"{time.perf_counter() - t0:.1f}s")

    t0 = time.perf_counter()
    lw = make_long_workload(os.path.join(args.out, "long_reads"),
                            seed=args.seed)
    log(f"    long-read workload: {len(lw.idx.node_ids)} nodes, {lw.n_rows} "
        f"index rows, {lw.n_reads} reads ({len(lw.junk)} junk); "
        f"{time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    (report, launches, ms, plain_ms, e, cells,
     bound) = long_pipeline_phase(tp, long_dp, lw, args.out, dev)
    log(f"[8] {report}; {time.perf_counter() - t0:.1f}s")
    return launches, ms, plain_ms, max(long_err, e), cells, bound


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=os.path.join(REPO, ".smoke"),
                    help="scratch directory for reads and outputs")
    ap.add_argument("--dist-child", nargs=5, default=None,
                    metavar=("RANK", "NPROCS", "HOST:PORT", "INPUTS", "OUT"),
                    help="run one rank of phase 15c (started by phase 15c)")
    ap.add_argument("--walls", type=int, default=0, metavar="N",
                    help="only time phase 5's stages N times on the card")
    args = ap.parse_args(argv)
    t_all = time.perf_counter()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    if args.dist_child:
        rank, nprocs, addr, data, out = args.dist_child
        return dist_child(int(rank), int(nprocs), addr, data, out)
    sys.path.insert(0, REPO)
    if args.walls:
        return walls_phase(args, args.walls)
    import numpy as np

    import threading

    from panmap_tpu_torch import _kernels, native
    from panmap_tpu_torch import pipeline as tp
    from panmap_tpu_torch.align import long_dp, sw
    from panmap_tpu_torch.io import fastq
    from panmap_tpu_torch.meta import driver as td
    from panmap_tpu_torch.meta import em
    from panmap_tpu_torch.meta.engine_torch import TorchMetaScorer
    from panmap_tpu_torch.parallel import mesh as pm
    from panmap_tpu_torch.place.query_torch import TorchPlacer
    from panmap_tpu_torch.synthetic import (make_assign_workload,
                                            make_meta_workload, make_workload)

    dev = torch.device("cuda", 0)
    cpu = torch.device("cpu")
    # 1. card and versions
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    log(smi)
    log(f"[1] python {sys.version.split()[0]}  torch {torch.__version__}  "
        f"cuda {torch.version.cuda}  devices {torch.cuda.device_count()}")

    # 2. both builds, started together: the native host library (g++) on a
    # thread, the kernels (nvcc) here
    t0 = time.perf_counter()
    host_build = threading.Thread(target=native.get_lib)
    host_build.start()
    _kernels.lib()
    nvcc_s = time.perf_counter() - t0
    host_build.join()
    if native.get_lib() is None:
        raise RuntimeError("the port's native host library did not build; "
                           "without it no window is deferred to the kernel:\n"
                           f"{native.build_error}")
    built = _kernels.build_info
    ptxas = ([ln.strip() for ln in built[1].splitlines() if "Used" in ln
              or "spill" in ln] if built else ["already built"])
    hb = native.build_info
    log(f"[2] native host library (g++, panmap_tpu_torch/native/"
        f"panmap_native.cpp -> _build/): "
        + (f"{hb[0]:.2f}s" if hb else "already built")
        + f"; nvcc build {nvcc_s:.2f}s; both {time.perf_counter() - t0:.2f}s: "
        + " | ".join(ptxas))

    # 3. SW kernel vs plain version, bulk shapes
    rng = np.random.default_rng(args.seed)
    t0 = time.perf_counter()
    q, r, ql = sw_pairs(rng, 4096, 150, 512, 2048)
    err, ms, plain_ms = compare_sw(
        sw, *(torch.from_numpy(x).to(dev) for x in (q, r, ql)), reps=5)
    cells = float(np.sum(ql.astype(np.int64)) * r.shape[1])
    log(f"[3] SW kernel == plain version on {len(q)} pairs (LQ 150-512, "
        f"LW <= {r.shape[1]}), max |diff| {err}; kernel {ms:.3f} ms "
        f"({cells / ms / 1e6:.1f} GCUPS), plain {plain_ms:.3f} ms "
        f"({cells / plain_ms / 1e6:.2f} GCUPS); "
        f"{time.perf_counter() - t0:.1f}s")

    # the workload
    t0 = time.perf_counter()
    shutil.rmtree(args.out, ignore_errors=True)
    w = make_workload(os.path.join(args.out, "reads"), seed=args.seed)
    log(f"    workload: {len(w.idx.node_ids)} nodes, {w.n_rows} index rows, "
        f"{len(w.tree.genome)} bp genome, {w.n_reads} reads; "
        f"{time.perf_counter() - t0:.1f}s")

    # 4. placement on the full index, both device routes
    t0 = time.perf_counter()
    pcfg = tp.PipelineConfig(panman="synthetic", reads1=w.reads1,
                             reads2=w.reads2, output="", log=log)
    report, sk, exact = placement_phase(tp, TorchPlacer, w, pcfg, dev, cpu)
    log(f"[4] place_exact on {len(w.idx.node_ids)} nodes / {w.n_rows} rows "
        f"== TorchPlacer on CPU tensors == f64 host engine: {report}; "
        f"{time.perf_counter() - t0:.1f}s")

    # 5. the pipeline on the card, then on CPU tensors
    report, launches, captured, tallied, _ = pipeline_phase(
        tp, sw, w, args.out, dev, cpu)
    log(f"[5] {report}")

    # the kernel against its plain version on the main path's own inputs
    errs, ms_m, plain_m = [err], 0.0, 0.0
    for qm, rm, lm, out in captured:
        e, k_ms, p_ms = compare_sw(sw, qm, rm, lm, reps=20)
        if not torch.equal(out, sw.banded_sw_scores_reference(qm, rm, lm)):
            raise AssertionError("the main path's SW scores != plain version")
        errs.append(e)
        ms_m += k_ms
        plain_m += p_ms
    # query length x window columns per pair; every tensor read or written
    sw_cells = float(sum(int(lm.sum()) * rm.shape[1]
                         for _, rm, lm, _ in captured))
    sw_bound = bound_ms(sw_cells, SW_OPS_PER_CELL,
                        [t for launch in captured for t in launch])
    n, LQ = captured[0][0].shape
    LW = captured[0][1].shape[1]
    log(f"[6] SW kernel == plain version on the main path's inputs "
        f"({len(captured)} launch(es), first {n} x {LQ} x {LW}): kernel "
        f"{ms_m:.3f} ms, plain {plain_m:.3f} ms; {sw_cells / 1e6:.1f} M "
        f"cells, bound {sw_bound[0]:.3f} ms by {sw_bound[1]} at "
        f"{SW_OPS_PER_CELL} int32 ops a cell; no PyTorch call computes a "
        f"banded affine DP (library_ms null)")
    del captured

    # 7, 8. the long-read DP kernel and the long-read pipeline
    (long_launches, long_ms, long_plain_ms, long_err, long_cells,
     long_bound) = long_phases(args, tp, long_dp, rng, dev)

    # the meta workload: demo 2's shape
    t0 = time.perf_counter()
    mw = make_meta_workload(os.path.join(args.out, "meta_reads"),
                            seed=args.seed)
    log(f"    meta workload: {len(mw.midx.node_ids)} nodes, {mw.n_rows} "
        f"index rows, {len(mw.midx.seed_hash)} seeds, {mw.n_reads} reads "
        f"from {len(mw.haplotypes)} haplotypes at {mw.proportions}; "
        f"{time.perf_counter() - t0:.1f}s")

    # 9. the meta scorer on the card vs the host scorer
    t0 = time.perf_counter()
    report, meta, scored = meta_scorer_phase(td, mw, args.out, dev)
    log(f"[9] {report}; {time.perf_counter() - t0:.1f}s")

    # 10. the abundance pipeline on the card; neither kernel is on it
    t0 = time.perf_counter()
    sw.LAUNCHES = long_dp.LAUNCHES = 0
    report, readings = meta_pipeline_phase(td, mw, args.out, dev)
    if sw.LAUNCHES or long_dp.LAUNCHES:
        raise AssertionError("a kernel launched on the meta path")
    meta.update(readings)
    log(f"[10] {report}; kernel launches on this path: banded_sw "
        f"{sw.LAUNCHES}, banded_long {long_dp.LAUNCHES}; "
        f"{time.perf_counter() - t0:.1f}s")

    # 11. read assignment on the card; neither kernel is on it
    t0 = time.perf_counter()
    aw = make_assign_workload(os.path.join(args.out, "assign_reads"),
                              seed=args.seed)
    log(f"    assign workload: {len(aw.midx.node_ids)} nodes, {aw.n_rows} "
        f"index rows, {len(aw.midx.seed_hash)} seeds, {aw.n_reads} reads, "
        f"{aw.n_target} of them from {len(aw.taxa)} taxa; "
        f"{time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    sw.LAUNCHES = long_dp.LAUNCHES = 0
    report, assign = assign_phase(td, aw, args.out, dev, cpu)
    if sw.LAUNCHES or long_dp.LAUNCHES:
        raise AssertionError("a kernel launched on the assignment path")
    log(f"[11] {report}; {time.perf_counter() - t0:.1f}s")
    del aw

    # 12. batch mode on the card
    t0 = time.perf_counter()
    (report, batch, batch_launches, batch_captured, batch_samples,
     batch_singles) = batch_phase(tp, sw, w, args.out, dev)
    # the kernel against its plain version on this path's own inputs
    for qm, rm, lm, res in batch_captured:
        e, k_ms, p_ms = compare_sw(sw, qm, rm, lm, reps=20)
        if e != 0 or not torch.equal(
                res, sw.banded_sw_scores_reference(qm, rm, lm)):
            raise AssertionError("the one-sample batch's SW scores != plain "
                                 "version")
        errs.append(e)
        batch.update(one_sample_sw_shape=list(qm.shape) + [rm.shape[1]],
                     one_sample_sw_ms=k_ms, one_sample_sw_plain_ms=p_ms)
        report += (f"; its SW launch ({qm.shape[0]} x {qm.shape[1]} x "
                   f"{rm.shape[1]}) == plain version, max |diff| {e}: kernel "
                   f"{k_ms:.3f} ms, plain {p_ms:.3f} ms")
    del batch_captured
    log(f"[12] {report}; {time.perf_counter() - t0:.1f}s")

    # 13. the pileup tally on the card
    t0 = time.perf_counter()
    report, tally = tally_phase(tallied, dev)
    log(f"[13] {report}; {time.perf_counter() - t0:.1f}s")

    # 15. the mesh (two shards on the card), two ranks on the card, and
    # --profile; before 14, so that its check covers them
    t0 = time.perf_counter()
    report, mesh_r, mesh = mesh_placement_phase(
        tp, TorchPlacer, pm, sw, w, sk, exact, args.out, dev, launches)
    log(f"[15a] {report}; {time.perf_counter() - t0:.1f}s")
    t1 = time.perf_counter()
    sw.LAUNCHES = long_dp.LAUNCHES = 0
    report, meta_r, em_case = mesh_meta_phase(td, em, pm, TorchMetaScorer,
                                              mw, scored, mesh, dev)
    if sw.LAUNCHES or long_dp.LAUNCHES:
        raise AssertionError("a kernel launched on the mesh's meta path")
    mesh_r["meta"] = meta_r
    del scored
    log(f"[15b] {report}; {time.perf_counter() - t1:.1f}s")
    t1 = time.perf_counter()
    report, mesh_r["dist"] = dist_phase(w, sk, exact, em_case, batch_samples,
                                        batch_singles, args.out)
    log(f"[15c] {report}; {time.perf_counter() - t1:.1f}s")
    t1 = time.perf_counter()
    report, mesh_r["profile"] = profile_phase(tp, sw, w, args.out, dev,
                                              launches)
    log(f"[15d] {report}; {time.perf_counter() - t1:.1f}s")
    mesh_r["phase_s"] = time.perf_counter() - t0
    log(f"[15] {mesh_r['phase_s']:.1f}s")

    # 16. the placement API and the device read sketch; before 14, so that
    # its check covers them
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    sw.LAUNCHES = long_dp.LAUNCHES = 0
    seqs = fastq.read_paired_for_placement(w.reads1, w.reads2)
    api_placer = TorchPlacer(w.idx, dev, pad_len=152)
    torch.cuda.synchronize()
    api = dict(index_upload_s=time.perf_counter() - t0)
    report, readings = place_api_phase(api_placer, w, sk, seqs,
                                       batch_samples, dev)
    api.update(readings)
    log(f"[16b-e] {report}; {time.perf_counter() - t0:.1f}s")
    t1 = time.perf_counter()
    report, api["sketch"] = device_sketch_phase(pm, api_placer, seqs, mw,
                                                dev, cpu)
    log(f"[16a,f,g] {report}; {time.perf_counter() - t1:.1f}s")
    if sw.LAUNCHES or long_dp.LAUNCHES:
        raise AssertionError("a kernel launched on the placement API's path")
    del api_placer, seqs
    api.update(peak_mib=torch.cuda.max_memory_allocated() / 2**20,
               phase_s=time.perf_counter() - t0)
    log(f"[16] peak device memory {api['peak_mib']:.1f} MiB; kernel "
        f"launches on this path: banded_sw {sw.LAUNCHES}, banded_long "
        f"{long_dp.LAUNCHES}; {api['phase_s']:.1f}s")

    # 17. the CLI from a PanMAN file written from --seed; before 14, so
    # that its check covers it
    lines, panman, panman_b1, panman_b2 = panman_phase(
        args, tp, sw, long_dp, td, TorchPlacer, dev, cpu)
    for line in lines:
        log(line)

    # 14. no jax and nothing of the JAX package anywhere
    foreign = sorted(k for k in sys.modules
                     if k in ("jax", "jaxlib", "panmap_tpu")
                     or k.startswith(("jax.", "jaxlib.", "panmap_tpu.")))
    if foreign:
        raise AssertionError(f"imported: {foreign[:8]}")
    n_port = sum(k == "panmap_tpu_torch" or k.startswith("panmap_tpu_torch.")
                 for k in sys.modules)
    log(f"[14] neither jax nor panmap_tpu imported; {n_port} modules of "
        f"panmap_tpu_torch loaded; total {time.perf_counter() - t_all:.1f}s")

    log(smi)  # again, for readers of the output's tail
    log(json.dumps({"meta": meta}))
    log(json.dumps({"assign": assign, "batch": batch, "tally": tally}))
    log(json.dumps({"mesh": mesh_r}))
    log(json.dumps({"api": api}))
    log(json.dumps({"panman": panman}))

    log(json.dumps({"kernels": [{
        "name": "banded_sw",
        "route": "cuda",
        "source": "panmap_tpu_torch/csrc/banded_sw.cu",
        "replaces": "panmap_tpu/align/pallas_sw.py:211",
        "launches": launches,
        "launches_one_sample_batch": batch_launches,
        "launches_mesh_pipeline": mesh_r["sw_launches"],
        "launches_profiled_pipeline": mesh_r["profile"]["sw_launches"],
        "launches_panman_cold": panman_b1,
        "launches_panman_warm": panman["b1_launches"]["warm"],
        "max_abs_err": max(errs),
        "ms": ms_m,
        "plain_ms": plain_m,
        "bound_ms": sw_bound[0],
        "bound_by": sw_bound[1],
        "library_ms": None,
        "cells": sw_cells,
        "ops_per_cell": SW_OPS_PER_CELL,
        "shape": [n, LQ, LW],
    }, {
        "name": "banded_long",
        "route": "cuda",
        "source": "panmap_tpu_torch/csrc/banded_long.cu",
        "replaces": "panmap_tpu/align/pallas_long.py:165",
        "launches": long_launches,
        "launches_panman_long": panman_b2,
        "max_abs_err": long_err,
        "ms": long_ms,
        "plain_ms": long_plain_ms,
        "bound_ms": long_bound[0],
        "bound_by": long_bound[1],
        "library_ms": None,
        "cells": long_cells,
        "ops_per_cell": LONG_OPS_PER_CELL,
    }]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
