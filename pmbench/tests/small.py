"""Tiny cells for the CPU tests: the manifest's cells cut by their mode's
``tiny`` (pmbench.mode.Mode.tiny: as a rule a 300-node tree of 6 kb genomes
and a few thousand read pairs) to one input, run by the harness on CPU
tensors (the card is stubbed out where the program asks for it)."""

from __future__ import annotations

import contextlib
import copy
import os
import time

import torch

from pmbench import harness, manifest

CPU = torch.device("cpu")


def tiny(name: str, root: str = manifest.ROOT) -> manifest.Cell:
    cell = manifest.cell(manifest.load(root), name, root)
    mode = manifest.mode(cell.traffic["mode"], root)
    cell.config, cell.traffic = mode.tiny(copy.deepcopy(cell.config),
                                          copy.deepcopy(cell.traffic))
    cell.traffic["inputs"] = 1
    return cell


@contextlib.contextmanager
def on_cpu():
    """The program's card lookup answers the CPU, and the pileup tally
    runs its card path on CPU tensors, as it does on a card."""
    import panmap_tpu_torch.utils.device as ud

    orig = ud.cuda_device
    env = os.environ.get("PANMAP_TPU_DEVICE_PILEUP")
    ud.cuda_device = lambda *a, **k: CPU
    os.environ["PANMAP_TPU_DEVICE_PILEUP"] = "1"
    try:
        yield
    finally:
        ud.cuda_device = orig
        if env is None:
            os.environ.pop("PANMAP_TPU_DEVICE_PILEUP", None)
        else:
            os.environ["PANMAP_TPU_DEVICE_PILEUP"] = env


def run(cell, tmp_path, seed=20261018, trace=False, control=False):
    """One CPU run of ``cell``: (result line, run fields)."""
    with on_cpu():
        res = harness.run(cell, seed, 0.5, trace, CPU,
                          str(tmp_path / "work"), time.perf_counter(),
                          control=control)
    return harness.result_line(cell, res, trace, CPU), res
