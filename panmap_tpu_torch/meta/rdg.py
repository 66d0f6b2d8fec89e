"""Read de-Bruijn graph ordering (reference: mgsr.cpp:1344-1488).

The reference's low-memory meta mode builds a de-Bruijn graph over read
seedmers (nodes = seedmer hashes, edges = adjacency within a read), finds
connected components, and re-orders reads by a component DFS — reads sharing
seedmers become contiguous, so the per-node affected-read updates of the DFS
scorer touch tight index ranges (cache locality / packed-delta compactness).
Its non-low-memory mode SHUFFLES reads instead (thread load balancing,
mgsr.cpp:2164-2176).

This is the deterministic equivalent for the NATIVE host scorer path
(pt_score_simple / pt_score_pseudo): same graph, same attach-at-middle-seedmer
rule (clamped so 1-2-seedmer reads are kept rather than dropped), components
ordered by size descending, DFS from each component's smallest-hash node with
neighbors visited in ascending hash order.  The batched device scorer
(meta/engine_tpu.py) is order-independent (vectorized gathers over the whole
read table) and never needs this — see PARITY.md for the measurement.
"""

from __future__ import annotations

import numpy as np


def debruijn_read_order(read_off: np.ndarray,
                        read_hash: np.ndarray) -> np.ndarray:
    """Permutation of read indices in component-DFS order.

    read_off: i64[R+1] CSR offsets into read_hash; read_hash: u64 seedmer
    hashes per read.  Deterministic; reads with empty seedmer lists sort
    last in original order."""
    R = len(read_off) - 1
    if R <= 1 or len(read_hash) == 0:
        return np.arange(R, dtype=np.int64)
    read_off = np.asarray(read_off, dtype=np.int64)
    lens = np.diff(read_off)
    uniq, inv = np.unique(read_hash, return_inverse=True)
    N = len(uniq)
    rid = np.repeat(np.arange(R, dtype=np.int64), lens)

    # edges: consecutive seedmers within a read (mgsr.cpp:1467 linkNodes)
    a, b = inv[:-1], inv[1:]
    same = rid[:-1] == rid[1:]
    ea, eb = a[same], b[same]
    lo = np.minimum(ea, eb)
    hi = np.maximum(ea, eb)
    keep = lo != hi
    if keep.any():
        e = np.unique(lo[keep] * np.int64(N) + hi[keep])
        lo, hi = e // N, e % N
        # symmetric adjacency CSR, neighbor lists ascending by node id
        # (uniq is sorted, so node-id order IS hash order)
        src = np.concatenate([lo, hi])
        dst = np.concatenate([hi, lo])
        order = np.lexsort((dst, src))
        src, dst = src[order], dst[order]
        adj_off = np.searchsorted(src, np.arange(N + 1))
    else:
        dst = np.empty(0, np.int64)
        adj_off = np.zeros(N + 1, np.int64)

    # reads attach at their middle seedmer's node (mgsr.cpp:1470-1472
    # readIndicesMid at j == size/2 + 1; clamped to the last seedmer so
    # short lists still attach), grouped per node in read order
    nz = lens > 0
    mid = np.minimum(lens // 2 + 1, np.maximum(lens - 1, 0))
    attach = np.full(R, -1, np.int64)
    attach[nz] = inv[(read_off[:-1] + mid)[nz]]
    rorder = np.argsort(attach[nz], kind="stable")
    rsorted = np.flatnonzero(nz)[rorder]
    rnode = attach[rsorted]
    read_at_off = np.searchsorted(rnode, np.arange(N + 1))

    # component discovery + DFS emit.  Components are collected by scanning
    # nodes in hash order, then emitted largest-first (ties: smallest hash),
    # each DFS starting at the component's smallest-hash node with neighbors
    # popped in ascending hash order.
    visited = np.zeros(N, dtype=bool)
    comp_nodes: list = []   # per component: node visit order
    comp_meta: list = []    # (size, first_node, index)
    for start in range(N):
        if visited[start]:
            continue
        stack = [start]
        visited[start] = True
        nodes = []
        while stack:
            u = stack.pop()
            nodes.append(u)
            # push descending so pops come ascending by hash
            for v in dst[adj_off[u]: adj_off[u + 1]][::-1]:
                if not visited[v]:
                    visited[v] = True
                    stack.append(v)
        comp_meta.append((-len(nodes), start, len(comp_nodes)))
        comp_nodes.append(nodes)

    comp_meta.sort()
    out = np.empty(R, dtype=np.int64)
    pos = 0
    for _, _, ci in comp_meta:
        for u in comp_nodes[ci]:
            lo_, hi_ = read_at_off[u], read_at_off[u + 1]
            if hi_ > lo_:
                out[pos: pos + (hi_ - lo_)] = rsorted[lo_:hi_]
                pos += hi_ - lo_
    # seedmer-less reads keep original relative order at the tail
    if pos < R:
        out[pos:] = np.flatnonzero(~nz)
    return out
