#!/usr/bin/env python3
"""GPU smoke run of panmap_tpu_torch, the PyTorch/CUDA port: builds the
port's CUDA kernel from the checkout, holds it against its plain PyTorch
version, and drives the single-sample path (place -> align -> genotype ->
consensus) on one card at the size of the sars_20000 demo, checking every
output byte for byte against the port's own run on CPU tensors, where the
kernel wrapper and the placement scorer use their plain PyTorch versions.

    python3 chip_smoke.py [--seed N] [--out DIR]

Phases, one line each with its time:
  1. card, versions, native host library
  2. nvcc build of panmap_tpu_torch/csrc/*.cu
  3. banded-SW kernel vs its plain version (>= 4,096 pairs, bit-equal)
  4. placement on the full index: TorchPlacer.place_exact on the card, on
     the sparse and the full-stream route, each equal to TorchPlacer on the
     CPU and to the f64 host engine (the port's --host-place route)
  5. the pipeline through the port's stage functions on the card (kernel
     launch counts reset just before), then the same stages on CPU tensors;
     the five outputs must be byte-equal, and the SW kernel equals its plain
     version on the very inputs the pipeline gave it
  6. jax was never imported

The JAX package itself is not driven here: tests/test_torch_*.py hold the
port against it on the CPU.

The workload (panmap_tpu_torch.synthetic) is made from --seed: 39,999 tree
nodes, ~2.42 M index rows, a 29,903 bp genome, 51,169 read pairs of 150 bp.
The last two lines are a JSON line per kernel and the result line; any
failure raises (exit code != 0) and prints no result.  Needs one CUDA card;
exits non-zero without one.
"""

from __future__ import annotations

import argparse
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


def device_kernel_ms(fn):
    """Sum of device kernel time in one fn() run (torch.profiler) and the
    three costliest kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    ev = [e for e in prof.key_averages()
          if e.device_type == torch.autograd.DeviceType.CUDA
          and e.self_device_time_total > 0]  # kernels, not the ops above
    ev.sort(key=lambda e: -e.self_device_time_total)
    total = sum(e.self_device_time_total for e in ev) / 1e3
    top = ", ".join(f"{e.key[:40]} {e.self_device_time_total / 1e3:.2f}"
                    for e in ev[:3])
    return total, top


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
    Returns the phase's report."""
    import torch
    from dataclasses import replace

    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    sk, _ = tp.read_sketch(cfg, w.idx)
    t1 = time.perf_counter()
    exact = tp.place(replace(cfg, device_place=False), w.idx, sk, dev)
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
            f"engine {host_s:.2f}s")


def run_stages(tp, w, cfg, device, stats):
    """The port's stages in _run_pipeline_inner's order; returns (best node,
    n_reads, variants, stage walls)."""
    walls = {}
    t0 = time.perf_counter()
    prefetch = tp._start_align_prefetch(cfg)
    _, best, n_reads = tp.run_placement(cfg, w.idx, device)
    walls["place"] = time.perf_counter() - t0
    t1 = time.perf_counter()
    ref, placed, bam_join = tp.run_alignment(cfg, w.tree, best, device,
                                             defer_bam=True,
                                             prefetch=prefetch, stats=stats)
    walls["align"] = time.perf_counter() - t1
    t1 = time.perf_counter()
    final = tp.run_genotyping(cfg, w.idx, ref, best, placed)
    bam_join()
    walls["genotype+bam"] = time.perf_counter() - t1
    t1 = time.perf_counter()
    tp.run_consensus(cfg, ref, best, final)
    walls["consensus"] = time.perf_counter() - t1
    walls["total"] = time.perf_counter() - t0
    return best, n_reads, final, walls


def pipeline_phase(tp, sw, w, out, dev, cpu):
    """The pipeline on ``dev`` with the SW launch count reset just before and
    the kernel's main-path inputs captured, then on CPU tensors; the five
    outputs must be byte-equal.  Returns (report, launches, captured
    [(q, r, qlens, out)])."""
    def cfg_for(name):
        os.makedirs(os.path.join(out, name), exist_ok=True)
        return tp.PipelineConfig(
            panman="synthetic", reads1=w.reads1, reads2=w.reads2,
            output=os.path.join(out, name, "sample"), device_pileup="off",
            log=lambda *a, **k: None)

    captured = []
    launch = sw.banded_sw_scores

    def capturing(q, r, qlens):
        res = launch(q, r, qlens)
        captured.append((q, r, qlens, res))
        return res

    cfg, stats = cfg_for("device"), {}
    sw.banded_sw_scores = capturing
    sw.LAUNCHES = 0
    try:
        best, n_reads, final, walls = run_stages(tp, w, cfg, dev, stats)
    finally:
        sw.banded_sw_scores = launch
    launches = sw.LAUNCHES
    if launches == 0 or stats["device_scored"] == 0:
        raise AssertionError(f"the pipeline never launched the SW kernel "
                             f"(launches {launches}, stats {stats})")
    if not final:
        raise AssertionError("no variant called: the workload is broken")

    ccfg, cstats = cfg_for("cpu"), {}
    t1 = time.perf_counter()
    cbest, _, _, _ = run_stages(tp, w, ccfg, cpu, cstats)
    cpu_wall = time.perf_counter() - t1
    if cbest != best or cstats != stats:
        raise AssertionError(f"CPU run: {cbest} {cstats} vs {best} {stats}")
    sizes = []
    for ext in OUTPUTS:
        a, b = f"{cfg.output}.{ext}", f"{ccfg.output}.{ext}"
        if not filecmp.cmp(a, b, shallow=False):
            raise AssertionError(f"{ext} differs from the CPU-tensor run")
        sizes.append(f"{ext} {os.path.getsize(a)} B")
    shapes = [tuple(q.shape) + (r.shape[1],) for q, r, _, _ in captured]
    report = (f"pipeline on {n_reads} reads -> {best}: "
              + ", ".join(f"{k} {v:.2f}s" for k, v in walls.items())
              + f"; SW launches {launches}, deferred {stats['deferred']}, "
              f"device-scored {stats['device_scored']}, survivors "
              f"{stats['survivors']}, shapes (B, LQ, LW) {shapes}; "
              f"{len(final)} variants; byte-equal to the CPU-tensor run "
              f"({cpu_wall:.2f}s): " + ", ".join(sizes))
    return report, launches, captured


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=os.path.join(REPO, ".smoke"),
                    help="scratch directory for reads and outputs")
    args = ap.parse_args(argv)
    t_all = time.perf_counter()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import numpy as np

    from panmap_tpu_torch import _kernels
    from panmap_tpu_torch import pipeline as tp
    from panmap_tpu_torch.align import sw
    from panmap_tpu_torch.align.batch import native_available
    from panmap_tpu_torch.place.query_torch import TorchPlacer
    from panmap_tpu_torch.synthetic import make_workload

    dev = torch.device("cuda", 0)
    cpu = torch.device("cpu")
    # 1. card and versions
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    log(smi)
    log(f"[1] python {sys.version.split()[0]}  torch {torch.__version__}  "
        f"cuda {torch.version.cuda}  devices {torch.cuda.device_count()}  "
        f"native host library: {native_available()}")
    if not native_available():
        raise RuntimeError("panmap_tpu's native host library did not build; "
                           "without it no window is deferred to the kernel")

    # 2. kernel build
    t0 = time.perf_counter()
    _kernels.lib()
    built = _kernels.build_info
    ptxas = ([ln.strip() for ln in built[1].splitlines() if "Used" in ln
              or "spill" in ln] if built else ["already built"])
    log(f"[2] nvcc build {time.perf_counter() - t0:.2f}s: "
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
    report = placement_phase(tp, TorchPlacer, w, pcfg, dev, cpu)
    log(f"[4] place_exact on {len(w.idx.node_ids)} nodes / {w.n_rows} rows "
        f"== TorchPlacer on CPU tensors == f64 host engine: {report}; "
        f"{time.perf_counter() - t0:.1f}s")

    # 5. the pipeline on the card, then on CPU tensors
    report, launches, captured = pipeline_phase(tp, sw, w, args.out, dev, cpu)
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
    n, LQ = captured[0][0].shape
    LW = captured[0][1].shape[1]
    log(f"    SW kernel == plain version on the main path's inputs "
        f"({len(captured)} launch(es), first {n} x {LQ} x {LW}): kernel "
        f"{ms_m:.3f} ms, plain {plain_m:.3f} ms")

    # 6. no jax anywhere
    if "jax" in sys.modules:
        raise AssertionError("jax was imported")
    log(f"[6] jax not imported; total {time.perf_counter() - t_all:.1f}s")

    log(json.dumps({"kernels": [{
        "name": "banded_sw",
        "route": "cuda",
        "source": "panmap_tpu_torch/csrc/banded_sw.cu",
        "replaces": "panmap_tpu/align/pallas_sw.py:211",
        "launches": launches,
        "max_abs_err": max(errs),
        "ms": ms_m,
        "plain_ms": plain_m,
        "shape": [n, LQ, LW],
    }]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
