"""The host read encoder of panmap_tpu/sketch/tpu.py (the rest of that
module is the JAX device sketch, which the port does not carry).  The
module name mirrors the JAX package's, so the numpy oracle of
align/batch.py imports its encoder from the same place in both."""

from __future__ import annotations

import numpy as np

from ..align.core import _ENC
from ..native import encode_reads_native


def encode_reads_batch(seqs: list, pad_to: int | None = None):
    """List of read strings -> ([B, L] u8 codes with 4 as padding and for
    non-ACGT, lengths i32); the native twin when the host library loads."""
    L = pad_to or max((len(s) for s in seqs), default=1)
    out = encode_reads_native(seqs, L)
    if out is not None:
        return out
    B = len(seqs)
    lens = np.fromiter((min(len(s), L) for s in seqs), dtype=np.int32, count=B)
    joined = np.frombuffer("".join(seqs).encode(), dtype=np.uint8)
    full_lens = np.fromiter((len(s) for s in seqs), dtype=np.int64, count=B)
    starts = np.concatenate(([0], np.cumsum(full_lens)[:-1]))
    pos = starts[:, None] + np.arange(L)[None, :]
    valid = np.arange(L)[None, :] < lens[:, None]
    codes = _ENC[joined[np.minimum(pos, len(joined) - 1)]]
    return np.where(valid, codes, 4).astype(np.uint8), lens
