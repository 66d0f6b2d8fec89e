"""Short-read aligner with the deferred full-window rows scored by the
port's banded-SW kernel (counterpart of the device stage of
panmap_tpu/align/batch.py::BatchAligner, :282-394).

The native front end defers the reads that need a full-window banded DP
(mapped == 3).  TorchBatchAligner scores those windows with
align/sw.py::banded_sw_scores, drops the rows below MIN_DP_MAX without
traceback, and runs the inherited host DP (_host_dp_rows) for the survivors'
CIGARs.  Window padding only adds columns, so a padded score upper-bounds
the real one: the gate is exact and the outputs equal the all-host path.

Left out from the JAX stage: the shape tiers, the tunnel breakevens and the
floor below which deferred windows skipped the device (every deferred
window is launched; each batch pads to its own longest query and window),
and the catch-alls that sent rows back to the host when the device failed
(a device failure raises here).
"""

from __future__ import annotations

import types

import numpy as np
import torch

from panmap_tpu.align import batch as _jax_batch
from panmap_tpu.align.batch import _RC, BatchAligner
from panmap_tpu.align.core import MIN_DP_MAX, encode
from panmap_tpu.native import get_lib

from . import sw

# BatchAligner._align_chunk, the numpy oracle that redoes the reads whose
# CIGAR overflows the native capacity (mapped == 2), imports its read
# encoder with `from ..sketch.tpu import encode_reads_batch`, and
# panmap_tpu/sketch/tpu.py imports jax.  The same code run with its globals'
# package set to this one resolves that import to panmap_tpu_torch/sketch/tpu.py.
_align_chunk_oracle = types.FunctionType(
    BatchAligner._align_chunk.__code__,
    {**vars(_jax_batch), "__package__": __package__, "__spec__": None},
    "_align_chunk")


def native_available() -> bool:
    """Whether panmap_tpu's native host library loads (built with g++ at
    first use).  Without it the front end defers no window, so the SW
    kernel is never reached and run_alignment raises."""
    return get_lib() is not None


class TorchBatchAligner(BatchAligner):
    """BatchAligner whose deferred windows go to the banded-SW kernel on
    ``device`` (its plain PyTorch version for a CPU device)."""

    # rows longer than these stay on the host DP, as in the JAX package
    MAX_LQ = 512
    MAX_LW = sw.MAX_LW

    def __init__(self, ref: str, device, log=None, stats: dict | None = None):
        """``stats``: a dict to accumulate the SW stage's counters into
        (kept as ``pallas_stats``, the JAX stage's name): deferred windows,
        device_scored, and survivors of the MIN_DP_MAX gate."""
        super().__init__(ref)
        self.device = torch.device(device)
        self.log = log
        self.pallas_stats = {} if stats is None else stats
        for key in ("deferred", "device_scored", "survivors"):
            self.pallas_stats.setdefault(key, 0)

    def _resolve_pallas_mode(self):
        # any true value makes the native front end defer full-window rows
        return self.device.type

    def _start_deferred(self, seqs: list, res: dict, mode: str,
                        async_: bool = False):
        """Enqueue the kernel over the mapped == 3 rows; returns a zero-arg
        finisher that waits on the scores, gates on MIN_DP_MAX and runs the
        survivors' host traceback (None when no row was deferred)."""
        rows = np.flatnonzero(res["mapped"] == 3)
        if len(rows) == 0:
            return None
        stats = self.pallas_stats
        stats["deferred"] += len(rows)
        ref = self.index.codes2
        lens = res["lens"]
        queries = {}
        host_rows = []
        dev_rows = []
        for r in rows.tolist():
            codes = encode(np.frombuffer(seqs[r].encode(), dtype=np.uint8))
            if res["rev"][r]:
                codes = _RC[codes[::-1]]
            queries[r] = codes
            lw = int(res["re"][r]) - int(res["rs"][r])
            if int(lens[r]) > self.MAX_LQ or lw > self.MAX_LW:
                host_rows.append(r)
            else:
                dev_rows.append(r)
        if host_rows and self.log is not None:
            self.log(f"[align] {len(host_rows)} deferred windows above "
                     f"{self.MAX_LQ}x{self.MAX_LW}: host DP")

        out = None
        if dev_rows:
            n = len(dev_rows)
            LQ = max(len(queries[r]) for r in dev_rows)
            LW = max(int(res["re"][r]) - int(res["rs"][r]) for r in dev_rows)
            qb = np.full((n, LQ), 4, dtype=np.int8)
            rb = np.full((n, LW), 4, dtype=np.int8)
            ql = np.zeros(n, dtype=np.int32)
            for i, r in enumerate(dev_rows):
                q = queries[r]
                qb[i, : len(q)] = q
                lo, hi = int(res["rs"][r]), int(res["re"][r])
                rb[i, : hi - lo] = ref[lo:hi]
                ql[i] = len(q)
            d = self.device
            out = sw.banded_sw_scores(torch.from_numpy(qb).to(d),
                                      torch.from_numpy(rb).to(d),
                                      torch.from_numpy(ql).to(d))

        def finish():
            if out is not None:
                sc = out[:, 0].cpu().numpy()  # waits on the device
                stats["device_scored"] += len(dev_rows)
                for i, r in enumerate(dev_rows):
                    if sc[i] >= MIN_DP_MAX:
                        host_rows.append(r)  # survivor: host traceback
                    else:
                        res["mapped"][r] = 0
            stats["survivors"] += len(host_rows)
            self._host_dp_rows(seqs, res, host_rows, queries)

        return finish

    def _align_chunk(self, seqs: list):
        return _align_chunk_oracle(self, seqs)
