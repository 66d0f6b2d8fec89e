"""Long-read aligner (map-ont / map-hifi) with the DP extension on the
device (counterpart of the device route of
panmap_tpu/align/longread.py::LongReadAligner.align_batch).

The front end (minimizer anchors and minimap2 chain DP, ``_chain_front``)
and the step that makes each Alignment (``_finish``) are the JAX package's
own host code, inherited unchanged; the presets are its LongPreset
objects, so both packages score with the same constants.  Only the banded DP moves: every
chained read's (query, dlo, dhi) goes through align/long_dp.py::
long_dp_batch on one device.  The JAX package's routing policy
(_resolve_long_device: a locally attached TPU, PANMAP_PALLAS_LONG) served a
remote TPU link and is left out: the device path always runs.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from panmap_tpu.align.core import Alignment
from panmap_tpu.align.longread import (  # noqa: F401  (presets re-exported)
    MAP_HIFI,
    MAP_ONT,
    LongPreset,
    LongReadAligner,
)

from .long_dp import long_dp_batch


class TorchLongReadAligner(LongReadAligner):
    """LongReadAligner whose DP rows run on ``device`` (the kernel, or its
    plain PyTorch version for a CPU device)."""

    def __init__(self, ref: str, preset: LongPreset, device,
                 stats: dict | None = None):
        """``stats``: a dict that accumulates long_dp_batch's counters
        (items, device_dp, host_dp) and stage seconds, plus the front end's
        seconds (front_s)."""
        super().__init__(ref, preset)
        self.device = torch.device(device)
        self.stats = {} if stats is None else stats
        self.stats.setdefault("front_s", 0.0)
        # the reference codes go to the device once per aligner
        self._ref_dev = torch.from_numpy(
            self.index.codes2.astype(np.int8)).to(self.device)

    def align_batch(self, seqs: list) -> list:
        """One Alignment per read, equal field for field to
        LongReadAligner.align_batch(seqs, device=None)."""
        t0 = time.perf_counter()
        fronts = [self._chain_front(s) for s in seqs]
        self.stats["front_s"] += time.perf_counter() - t0
        items = [(f[0], f[1], f[2]) for f in fronts if f is not None]
        dps = iter(long_dp_batch(items, self.index.codes2, self.pre,
                                 self.device, self.stats, self._ref_dev))
        return [Alignment() if f is None else self._finish(next(dps), f[3])
                for f in fronts]
