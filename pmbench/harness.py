"""One run of one cell of panmap_tpu_torch's benchmark.

A run makes the cell's tree and samples from --seed, warms the program
with one sample (building the index from the tree the first time, as the
CLI does, and the kernels where a checkout has not built them), then runs
samples back to back through the CLI's own entry in process
(panmap_tpu_torch.__main__.main) for --seconds: a closed loop, the next
sample started when the last one's outputs are written.  The window ends
at the first completion after --seconds, so it holds whole samples only.
After it, each answer is checked against the plain reference under
pmbench/reference/, and one JSON line is printed (the contract of
BENCHMARK.json's command).

The traffic mix's "mode" is pmbench/modes/<mode>.py, found by name
(manifest.mode), whatever mode a new file brings: today "single" (one
isolate a CLI call), "plate" (a --batch manifest of isolates a call),
"meta" (a --meta mixture a call) and "ont" (one Nanopore isolate a call).
A mode draws the tree (make_tree) and the samples from the seed, and
cuts its cell for the CPU tests by its own ``tiny``; a configuration cut
from its source lists each cut key in "reduced", in BENCHMARK.json and in
its file alike (pmbench/manifest.py).
"""

from __future__ import annotations

import contextlib
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

from . import manifest, tracing

FORBIDDEN = {"jax", "jaxlib", "flax", "panmap_tpu"}


def loaded_forbidden() -> list:
    """Top-level modules of sys.modules that a run must not load."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & FORBIDDEN)


def card_info() -> dict:
    """The card's name and power limit, as nvidia-smi reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()
        return {"nvidia_smi": out}
    except (OSError, subprocess.SubprocessError) as exc:
        return {"nvidia_smi": f"unavailable: {exc}"}


def run(cell, seed: int, seconds: float, trace: bool, device, work: str,
        t_start: float, control: bool = False) -> dict:
    """One run of ``cell``: set-up, the window, the checks.  Returns the
    result's fields (the caller prints them)."""
    import shutil

    import torch

    if os.path.isdir(work):
        shutil.rmtree(work)
    os.makedirs(work)
    mode = manifest.mode(cell.traffic["mode"], cell.root)(
        cell, seed, work, device, control)
    os.makedirs(mode.out)
    cuda = device.type == "cuda"
    mode.make_tree()
    mode.make_inputs()
    spans = tracing.Spans(mode.sync) if trace else None
    launches = {} if trace else None
    mode.install(spans, launches)
    try:
        mode.warm()
        if launches:
            launches.clear()
        if spans:
            spans.items.clear()
        if cuda:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        setup_s = time.perf_counter() - t_start
        prof = None
        if trace:
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CPU] + (
                [ProfilerActivity.CUDA] if cuda else [])
            prof = profile(activities=acts, acc_events=True)
            prof.start()
        n = failed = 0
        ends = []
        win = spans.span("window") if spans else contextlib.nullcontext()
        t0 = time.perf_counter()
        with win:
            i = 0
            while True:
                with (spans.span("sample") if spans
                      else contextlib.nullcontext()):
                    done, bad = mode.run_one(i)
                mode.sync()
                n, failed, i = n + done, failed + bad, i + 1
                ends.append(time.perf_counter())
                if ends[-1] - t0 >= seconds:
                    break
        window_s = ends[-1] - t0
        if prof is not None:
            prof.stop()
        peak = torch.cuda.max_memory_allocated() if cuda else 0
    finally:
        mode.patches.undo()
    found = loaded_forbidden()
    if found:
        raise SystemExit(f"modules that must not load are loaded: {found}")
    res = dict(n=n, failed=failed, window_s=window_s, setup_s=setup_s,
               peak=peak, per_call=np.diff([t0] + ends).tolist())
    if trace:
        res["trace"] = tracing.reduce_profile(prof, spans, n, launches)
        del prof
    t_check = time.perf_counter()
    res["checks"] = mode.check()
    res["check_s"] = time.perf_counter() - t_check
    res["info"] = mode.info
    shutil.rmtree(work, ignore_errors=True)
    return res


def result_line(cell, res: dict, trace: bool, device) -> dict:
    """The result's JSON object (the contract's keys; checks last)."""
    import torch

    metrics = {}
    if trace:
        t = res["trace"]
        for m in cell.per_layer:
            v = manifest.reader(m["name"], cell.root)(t)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        values = {"sample_s": res["window_s"] / max(res["n"], 1),
                  "peak_device_mib": res["peak"] / 2 ** 20,
                  "setup_s": res["setup_s"]}
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}
    cuda = device.type == "cuda"
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": cell.chips, "memory_peak_bytes": res["peak"]}
    out = {"correct": all(v is not None and v <= lim
                          for _, v, lim in res["checks"])
           and res["failed"] == 0,
           "attempted": res["n"], "failed": res["failed"],
           "metrics": metrics, "device": dev}
    if trace:
        t = res["trace"]
        dev["busy_s"] = t.busy_s
        dev["window_s"] = t.window_s
        out["breakdown"] = {"device_ops": tracing.top_ops(t),
                            "idle_gaps": t.idle_by_span}
    out["checks"] = {name: {"value": v, "limit": lim}
                     for name, v, lim in res["checks"]}
    return out


def set_cache_env():
    """Build and kernel caches at fixed paths inside the checkout (set
    before torch loads); no library loads JAX."""
    cache = os.path.join(manifest.ROOT, "pmbench", ".cache")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache,
                                                      "torch_extensions")
    os.environ["USE_FLAX"] = "0"


def workdir(name: str) -> str:
    """A fixed directory for a cell's data under $TMPDIR."""
    return os.path.join(os.environ.get("TMPDIR") or "/tmp", "pmbench", name)


def card(chips: int):
    """The run's CUDA device, or None (with the reason on standard error)
    where the machine has fewer than ``chips`` cards."""
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"pmbench: needs {chips} CUDA card(s); torch sees "
              f"{torch.cuda.device_count()}", file=sys.stderr)
        return None
    from panmap_tpu_torch.utils.device import cuda_device

    return cuda_device()


def main(argv, t_start: float) -> int:
    import argparse

    ap = argparse.ArgumentParser(prog="pmbench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    set_cache_env()
    cell = manifest.cell(manifest.load(), args.workload)
    device = card(cell.chips)
    if device is None:
        return 2
    card_ = card_info()
    print(json.dumps({"card": card_}), file=sys.stderr)
    res = run(cell, args.seed, args.seconds, bool(args.trace), device,
              workdir(args.workload), t_start)
    out = result_line(cell, res, bool(args.trace), device)
    per = res["per_call"]
    print(json.dumps({"samples": res["n"], "calls": len(per),
                      "call_s": per, "call_s_min": min(per),
                      "call_s_median": statistics.median(per),
                      "call_s_max": max(per), "check_s": res["check_s"],
                      "info": res["info"], "card": card_}))
    for name, v, lim in res["checks"]:
        print(f"check {name} {v!r} limit {lim!r}", file=sys.stderr)
    found = loaded_forbidden()
    if found:
        print(f"pmbench: modules that must not load are loaded: {found}",
              file=sys.stderr)
        return 3
    print(json.dumps(out))
    return 0
