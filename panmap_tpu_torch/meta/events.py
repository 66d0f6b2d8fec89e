"""Presence-flip event extraction for the TPU meta scorer.

The per-node seed deltas are path-dependent (a row's effect depends on the
running count), so one sequential DFS replay converts them into ABSOLUTE
subtree events: "hash h (ref-orientation o) becomes present/absent for the
whole DFS interval below node n".  Scoring then needs no tree walk at all —
a read's score at node n is a sum of interval indicators, evaluated for all
nodes at once with an Euler scatter + prefix sum (mgsr.cpp:4500-4603's
EXIST/NOT_EXIST transitions, re-expressed as interval arithmetic)."""

from __future__ import annotations

from collections import defaultdict

import numpy as np


def euler_intervals(parent: np.ndarray):
    """(euler_in, euler_out): DFS interval [in, out] per node (dfs order)."""
    n = len(parent)
    size = np.ones(n, dtype=np.int64)
    for i in range(n - 1, 0, -1):
        size[parent[i]] += size[i]
    euler_in = np.arange(n, dtype=np.int64)
    euler_out = euler_in + size - 1
    return euler_in, euler_out


def presence_events(midx, read_hashes: np.ndarray):
    """Vectorized presence-flip extraction (the semantics of
    `presence_events_ref`, netted per preorder position).

    Every delta row contributes two ±1 count steps for its (hash,
    orientation): one at the node's preorder position, the undo at
    euler_out+1.  Sorting all steps by (hash, position) turns each hash's
    count history into a segmented cumsum; presence flips are transitions of
    count>0 between consecutive distinct positions.  Same interval sums as
    the sequential replay (same-position churn nets out, which only REMOVES
    redundant events), at numpy speed instead of 2D python calls per row.

    Returns dict with arrays:
      ev_node, ev_uid, ev_rev, ev_delta  — read-relevant orientation flips,
        uid = index into read_hashes
      den_node, den_delta                — any-hash presence flips
      ov_node, ov_delta                  — any-orientation flips of
        read-relevant hashes (OC numerator)
    """
    offs = np.asarray(midx.node_offsets, dtype=np.int64)
    n_nodes = len(midx.node_ids)
    parent = midx.parent_index.astype(np.int64)
    _, euler_out = euler_intervals(parent)

    D = len(midx.delta_seed)
    empty = dict(
        ev_node=np.empty(0, np.int64), ev_uid=np.empty(0, np.int64),
        ev_rev=np.empty(0, bool), ev_delta=np.empty(0, np.int8),
        den_node=np.empty(0, np.int64), den_delta=np.empty(0, np.int8),
        ov_node=np.empty(0, np.int64), ov_delta=np.empty(0, np.int8))
    if D == 0:
        return empty

    row_node = np.repeat(np.arange(n_nodes, dtype=np.int32), np.diff(offs))
    sid = midx.delta_seed
    h_row = midx.seed_hash[sid]
    rv_row = midx.seed_rev[sid]
    sgn_row = np.where(midx.delta_is_del, -1, 1).astype(np.int8)

    # two steps per row: apply at preorder pos, undo after the subtree
    # (int32/int8 throughout: these arrays are ~10M elements and this VM
    # taxes every fresh page)
    pos = np.concatenate(
        [row_node, (euler_out[row_node] + 1).astype(np.int32)])
    step = np.concatenate([sgn_row, -sgn_row])
    h2 = np.concatenate([h_row, h_row])
    rv2 = np.concatenate([rv_row, rv_row])

    # group ids by hash
    from ..utils.fastnp import unique_inverse

    uniq_h, gid = unique_inverse(h2)
    gid = gid.astype(np.int32, copy=False)
    order = np.lexsort((pos, gid))
    g = gid[order]
    p = pos[order]
    s = step[order].astype(np.int32)
    r = rv2[order]

    # segmented cumsums per (gid): counts after each entry
    news = np.concatenate(([True], g[1:] != g[:-1]))
    cs_fwd = np.cumsum(np.where(r, 0, s), dtype=np.int32)
    cs_rev = np.cumsum(np.where(r, s, 0), dtype=np.int32)
    seg_start = np.flatnonzero(news)
    base_idx = np.repeat(seg_start, np.diff(np.append(seg_start, len(g))))
    # value just before the segment start
    pre_fwd = np.where(base_idx > 0, cs_fwd[np.maximum(base_idx - 1, 0)], 0)
    pre_rev = np.where(base_idx > 0, cs_rev[np.maximum(base_idx - 1, 0)], 0)
    c_fwd = cs_fwd - pre_fwd
    c_rev = cs_rev - pre_rev

    # state after the LAST entry of each (gid, pos) run
    last = np.concatenate([(g[:-1] != g[1:]) | (p[:-1] != p[1:]), [True]])
    lg = g[last]
    lp = p[last]
    lfwd = c_fwd[last] > 0
    lrev = c_rev[last] > 0
    lany = (c_fwd[last] + c_rev[last]) > 0
    # previous state within the same gid (absent before the first entry)
    firstg = np.concatenate(([True], lg[1:] != lg[:-1]))
    prev_fwd = np.concatenate(([False], lfwd[:-1])) & ~firstg
    prev_rev = np.concatenate(([False], lrev[:-1])) & ~firstg
    prev_any = np.concatenate(([False], lany[:-1])) & ~firstg

    rh = np.asarray(read_hashes, dtype=np.uint64)
    if len(rh):
        ii = np.searchsorted(rh, uniq_h)
        iic = np.minimum(ii, len(rh) - 1)
        g_rel = rh[iic] == uniq_h
        g_uid = np.where(g_rel, iic, -1)
    else:
        g_rel = np.zeros(len(uniq_h), dtype=bool)
        g_uid = np.full(len(uniq_h), -1, dtype=np.int64)
    rel = g_rel[lg]
    uid_l = g_uid[lg]

    out_node, out_uid, out_rev, out_delta = [], [], [], []
    for orient, cur, prv in ((False, lfwd, prev_fwd), (True, lrev, prev_rev)):
        m = (cur != prv) & rel
        out_node.append(lp[m])
        out_uid.append(uid_l[m])
        out_rev.append(np.full(int(m.sum()), orient, dtype=bool))
        out_delta.append(np.where(cur[m], 1, -1).astype(np.int8))
    ma = lany != prev_any
    mo = ma & rel
    return dict(
        ev_node=np.concatenate(out_node),
        ev_uid=np.concatenate(out_uid),
        ev_rev=np.concatenate(out_rev),
        ev_delta=np.concatenate(out_delta),
        den_node=lp[ma],
        den_delta=np.where(lany[ma], 1, -1).astype(np.int8),
        ov_node=lp[mo],
        ov_delta=np.where(lany[mo], 1, -1).astype(np.int8),
    )


def presence_events_ref(midx, read_hashes: np.ndarray):
    """Sequential-replay reference implementation (kept as the oracle for
    the vectorized `presence_events`; see tests/test_meta_events.py).

    Returns dict with arrays:
      ev_node, ev_uid, ev_rev, ev_delta  — read-relevant orientation flips,
        uid = index into read_hashes
      den_node, den_delta                — any-hash presence flips
    """
    offs = midx.node_offsets
    n_nodes = len(midx.node_ids)
    parent = midx.parent_index.astype(np.int64)
    children: list = [[] for _ in range(n_nodes)]
    for i in range(1, n_nodes):
        children[parent[i]].append(i)

    row_sid = midx.delta_seed
    seed_hash = midx.seed_hash
    seed_rev = midx.seed_rev
    row_del = midx.delta_is_del

    # uid lookup for read-relevant hashes
    rh = np.asarray(read_hashes, dtype=np.uint64)
    ii = np.searchsorted(rh, seed_hash[row_sid])
    iic = np.minimum(ii, max(len(rh) - 1, 0))
    relevant = (len(rh) > 0) & (rh[iic] == seed_hash[row_sid])
    row_uid = np.where(relevant, iic, -1).astype(np.int64)

    counts: dict = defaultdict(lambda: [0, 0])
    _, euler_out = euler_intervals(parent)

    ev_node, ev_uid, ev_rev, ev_delta = [], [], [], []
    den_node, den_delta = [], []
    ov_node, ov_delta = [], []  # any-orientation flips of read-relevant hashes

    hashes_row = seed_hash[row_sid]
    revs_row = seed_rev[row_sid]

    def apply_row(r, node, sign):
        h = int(hashes_row[r])
        rv = bool(revs_row[r])
        isdel = bool(row_del[r]) ^ (sign < 0)
        c = counts[h]
        oi = 1 if rv else 0
        was_any = (c[0] + c[1]) > 0
        if not isdel:
            c[oi] += 1
            fire = c[oi] == 1
            delta = 1
        else:
            fire = c[oi] == 1
            c[oi] -= 1
            delta = -1
        now_any = (c[0] + c[1]) > 0
        if now_any != was_any:
            den_node.append(node)
            den_delta.append(1 if now_any else -1)
            if row_uid[r] >= 0:
                ov_node.append(node)
                ov_delta.append(1 if now_any else -1)
        if fire and row_uid[r] >= 0:
            ev_node.append(node)
            ev_uid.append(row_uid[r])
            ev_rev.append(rv)
            ev_delta.append(delta)

    stack = [(0, False)]
    while stack:
        node, done = stack.pop()
        rows = range(int(offs[node]), int(offs[node + 1]))
        if done:
            # ascent: the undo takes effect from the first preorder position
            # AFTER this subtree
            pos_after = int(euler_out[node]) + 1
            for r in reversed(rows):
                apply_row(r, pos_after, -1)
            continue
        for r in rows:
            apply_row(r, node, +1)
        stack.append((node, True))
        for c in reversed(children[node]):
            stack.append((c, False))

    return dict(
        ev_node=np.array(ev_node, dtype=np.int64),
        ev_uid=np.array(ev_uid, dtype=np.int64),
        ev_rev=np.array(ev_rev, dtype=bool),
        ev_delta=np.array(ev_delta, dtype=np.int8),
        den_node=np.array(den_node, dtype=np.int64),
        den_delta=np.array(den_delta, dtype=np.int8),
        ov_node=np.array(ov_node, dtype=np.int64),
        ov_delta=np.array(ov_delta, dtype=np.int8),
    )


def overlap_coefficients_from_events(ev: dict, n_nodes: int) -> np.ndarray:
    """OC per dfs index: |node seeds ∩ read seeds| / |node seeds|, both as
    prefix sums of presence flips over the DFS order (mgsr.cpp:5685-5791)."""
    den = np.zeros(n_nodes + 2, dtype=np.int64)
    np.add.at(den, ev["den_node"], ev["den_delta"].astype(np.int64))
    ov = np.zeros(n_nodes + 2, dtype=np.int64)
    np.add.at(ov, ev["ov_node"], ev["ov_delta"].astype(np.int64))
    denp = np.cumsum(den)[:n_nodes]
    ovp = np.cumsum(ov)[:n_nodes]
    with np.errstate(divide="ignore", invalid="ignore"):
        oc = np.where(denp > 0, ovp / np.maximum(denp, 1), 0.0)
    return oc
