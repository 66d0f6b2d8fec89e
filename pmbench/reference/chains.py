"""Plain minimap2 chaining of a long read's anchors, and the secondary
chain score that the read's mapq is computed from: what
panmap_tpu_torch/align/longread.py's front end computes for map-ont and
map-hifi reads.

An anchor is a minimizer the read shares with the reference: its position
q on the read, its position r on the reference, and whether the two
k-mers are on opposite strands.  The anchors of each strand are chained
apart.  On the opposite strand q counts on the reverse-complemented read
(lq - k - q), so that both coordinates grow along a chain.  In (r, q)
order, each anchor j scores

    f(j) = max(k, max over the h anchors before it of
                  f(i) + min(dq, dr, k) - gamma(|dr - dq|))

over predecessors with dq > 0, dr > 0 and max(dq, dr) < max_gap, where
gamma(0) = 0 and gamma(d) = 0.01 k d + 0.5 log2(max(d, 2)) (chain.c's
scoring, as the program states it).  Its predecessor is the maximising
anchor closest to it, as minimap2's chain DP takes it (it walks from the
nearest anchor back and keeps a strictly greater score only).

Chains are backtracked as mm_chain_backtrack does: anchors in order of f,
highest first, the earlier anchor first on ties, and the best one first
of all; from each anchor no chain holds yet, the chain walks its
predecessors back until it meets an anchor an earlier chain holds, and
scores f(end) - f(met), or f(end) where it met none.  A chain other than
the first counts if it ends at an f of at least min_sc and has min_cnt
anchors and a score of min_sc.

The read's primary is the first chain of the strand whose best f is the
higher (the same strand on ties), and its secondary score is the best
score of another chain, on either strand, whose span on the read, from
its first anchor to its last anchor's end, overlaps the primary's by at
least half the shorter span (mm_set_parent at mask level 0.5), or 0.
Written anew, in numpy; it imports nothing of the program.
"""

from __future__ import annotations

import numpy as np


def _strand_chains(qv, rv, k, max_gap, h, min_cnt, min_sc):
    """[(score, anchor count, anchor ids into qv)] of one strand's chains,
    the first one first; and its best f."""
    n = len(qv)
    order = np.lexsort((qv, rv))
    q = np.asarray(qv, np.int64)[order]
    r = np.asarray(rv, np.int64)[order]
    # the window of predecessors of every anchor, nearest first
    back = np.arange(1, h + 1)
    pred = np.arange(n)[:, None] - back[None, :]  # [n, h]
    valid = pred >= 0
    p = np.where(valid, pred, 0)
    dq = q[:, None] - q[p]
    dr = r[:, None] - r[p]
    valid &= (dq > 0) & (dr > 0) & (np.maximum(dq, dr) < max_gap)
    dd = np.abs(dr - dq)
    gain = np.minimum(np.minimum(dq, dr), k)
    gamma = np.where(dd > 0,
                     0.01 * k * dd + 0.5 * np.log2(np.maximum(dd, 2)), 0.0)
    f = np.full(n, float(k))
    link = np.full(n, -1, np.int64)
    for j in range(n):
        ok = valid[j]
        if not ok.any():
            continue
        score = np.where(ok, f[p[j]] + gain[j] - gamma[j], -np.inf)
        t = int(np.argmax(score))  # the nearest of the maximising ones
        if score[t] > f[j]:
            f[j] = score[t]
            link[j] = p[j, t]
    first = int(np.argmax(f))
    rest = [j for j in np.argsort(-f, kind="stable").tolist()
            if j != first and f[j] >= min_sc]
    held = np.zeros(n, bool)
    out = []
    for end in [first] + rest:
        if held[end]:
            continue
        ids = []
        j = end
        while j >= 0 and not held[j]:
            held[j] = True
            ids.append(j)
            j = int(link[j])
        score = float(f[end] - f[j]) if j >= 0 else float(f[end])
        if not out or (len(ids) >= min_cnt and score >= min_sc):
            out.append((score, len(ids), order[np.array(ids)]))
    return out, float(f[first])


def secondary_score(qpos, rpos, opposite, lq: int, k: int, max_gap: int,
                    min_cnt: int, min_sc: float, h: int = 50):
    """(primary score, secondary score) of a read's anchors: query
    positions, reference positions and opposite-strand flags; None where
    it has no anchor."""
    qpos = np.asarray(qpos, np.int64)
    rpos = np.asarray(rpos, np.int64)
    opposite = np.asarray(opposite).astype(bool)
    strands = []
    for flip in (False, True):
        m = opposite == flip
        if not m.any():
            continue
        qv = lq - k - qpos[m] if flip else qpos[m]
        chains, best = _strand_chains(qv, rpos[m], k, max_gap, h, min_cnt,
                                      min_sc)
        on_read = qpos[m]
        strands.append((best, [(s, c, (int(on_read[ids].min()),
                                       int(on_read[ids].max()) + k))
                               for s, c, ids in chains]))
    if not strands:
        return None
    top = max(range(len(strands)), key=lambda i: (strands[i][0], -i))
    primary = strands[top][1][0]
    pa, pb = primary[2]
    second = 0.0
    for i, (_, chains) in enumerate(strands):
        for s, c, (a, b) in (chains[1:] if i == top else chains):
            overlap = min(b, pb) - max(a, pa)
            if (c >= min_cnt and s >= min_sc
                    and 2 * overlap >= min(b - a, pb - pa)):
                second = max(second, s)
    return strands[top][0], second
