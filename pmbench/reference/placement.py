"""Plain numpy placement scores: the five metrics of one tree node against
a sample's reads, from the node's genome and the reads alone.

The metrics are the reference panmap's (src/placement.hpp:108-155
NodeMetrics, src/placement.cpp:957-984 and 1703-1876 of
github.com/amkram/panmap), written out over whole seed sets:

  reads: k-min-mer counts c_h over all reads, the four homopolymer hashes
  removed, then kept where c_h >= the minimum support (2 where the mean of
  the counts >= 2 exceeds 3, else 1); lrc_h = log1p(c_h).
  node: the genome's k-min-mer counts C_h (seeds.genome_seed_counts);
  found_h: h is a kept read seed.

  log_raw              sum_{found} lrc_h / C_h / sqrt(sum lrc^2)
  log_cosine           sum_{found} lrc_h log1p(C_h)
                       / (sqrt(sum lrc^2) sqrt(sum_node log1p(C_h)^2)),
                       clipped to [0, 1]
  containment          #found / #kept read seeds
  weighted_containment sum_{found} 1 / C_h / sum_{root, found} 1 / C_root
  log_containment      sum_{found} lrc_h / sum lrc_h

``dtype`` float64 is the reference; float32 is the control (the same sums
taken in single precision, the step a faster scorer would take).
"""

from __future__ import annotations

import numpy as np

from . import seeds

METRICS = ("log_raw", "log_cosine", "containment", "weighted_containment",
           "log_containment")


class ReadTable:
    """The kept read seeds of one sample, sorted, with log1p(count)."""

    def __init__(self, hashes, counts, k: int, dtype=np.float64):
        keep = ~np.isin(hashes, seeds.homopolymer_hashes(k))
        hashes, counts = hashes[keep], counts[keep]
        big = counts >= 2
        est = counts[big].sum() / big.sum() if big.any() else 0.0
        support = 2 if est > 3.0 else 1
        keep = counts >= support
        order = np.argsort(hashes[keep])
        self.hashes = hashes[keep][order]
        self.lrc = np.log1p(counts[keep][order].astype(dtype))
        self.dtype = dtype
        self.magnitude = np.sqrt(np.sum(self.lrc * self.lrc, dtype=dtype))
        self.total = np.sum(self.lrc, dtype=dtype)

    def lookup(self, hashes):
        """(found, lrc) of each hash."""
        i = np.minimum(np.searchsorted(self.hashes, hashes),
                       max(len(self.hashes) - 1, 0))
        found = (self.hashes[i] == hashes) if len(self.hashes) else \
            np.zeros(len(hashes), bool)
        return found, np.where(found, self.lrc[i], 0).astype(self.dtype)


def node_scores(reads: ReadTable, node, root) -> dict:
    """The five metrics of a node: ``node`` and ``root`` are (hashes,
    counts) of its genome's seeds and of the root's."""
    dt = reads.dtype
    h, c = node
    found, lrc = reads.lookup(h)
    C = c.astype(dt)
    logc = np.log1p(C)
    rf, _ = reads.lookup(root[0])
    wc_den = np.sum(np.where(rf, 1 / root[1].astype(dt), 0), dtype=dt)
    gm = np.sqrt(np.sum(logc * logc, dtype=dt))
    s = {
        "log_raw": np.sum(np.where(found, lrc / C, 0), dtype=dt)
        / reads.magnitude,
        "log_cosine": min(max(np.sum(lrc * logc, dtype=dt)
                              / (reads.magnitude * gm), 0.0), 1.0),
        "containment": dt(found.sum()) / dt(len(reads.hashes)),
        "weighted_containment": np.sum(np.where(found, 1 / C, 0), dtype=dt)
        / wc_den,
        "log_containment": np.sum(lrc, dtype=dt) / reads.total,
    }
    return {m: float(v) for m, v in s.items()}


def mask_fixed(model, name: str, flank: int) -> bool:
    """Whether the flank mask stays on the same alignment columns from the
    root down to ``name``.  The program's index keeps a masked position's
    seeds as its parent had them, so where an indel in a flank moves the
    mask along the path, a node's seeds near the mask's edge follow the
    path and not the genome; its scores are then not checked by value.
    Only the first and the last block hold the flanks (each block is longer
    than a flank, and neither is switched off or turned)."""
    path = [model.index[name]]
    while path[-1]:
        path.append(int(model.parent[path[-1]]))
    ends = (0, len(model.blocks) - 1)
    main = {b: model.blocks[b].copy() for b in ends}
    runs = {(int(b), int(s)): np.zeros(int(n), np.uint8)
            for b, s, n in model.gaps if b in ends}

    def edge(b, from_end):
        parts = []
        for p in range(len(main[b]) + 1):
            if (b, p) in runs:
                parts.append(runs[(b, p)])
            parts.append(main[b][p:p + 1])
        codes = np.concatenate(parts)
        if from_end:
            codes = codes[::-1]
        return int(np.flatnonzero(codes)[flank - 1])

    seen = None
    for node in reversed(path):
        bm = model.block_muts[model._bm_off[node]:model._bm_off[node + 1]]
        if node and np.isin(bm[:, 1], ends).any():
            return False
        for _, b, pos, gap, packed in model.nuc_muts[
                model._nm_off[node]:model._nm_off[node + 1]]:
            if b not in ends:
                continue
            n = (int(packed) & 0xFF) >> 4
            codes = [(int(packed) >> (8 + 4 * (n - 1 - i))) & 0xF
                     for i in range(n)]
            if gap < 0:
                main[b][pos:pos + n] = codes
            else:
                runs[(int(b), int(pos))][gap:gap + n] = codes
        at = (edge(ends[0], False), edge(ends[1], True))
        if seen is not None and at != seen:
            return False
        seen = at
    return True
