"""The five placement metrics' row-delta math: the numpy bodies of
panmap_tpu/place/metrics.py and their torch twins.

The reference maintains its metrics as per-row deltas streamed over each
node's SoA range (src/placement.cpp:242-345 computeChildMetrics; the metric
formulas live in the NodeMetrics getters, src/placement.hpp:108-155).

**Array-namespace bodies** (``row_metric_deltas``, ``wc_denominator``,
``finalize_scores``): carried over unchanged; place/engine.py (the numpy
float64 parity oracle) and the exact f64 rescue of place/query_torch.py call
them with ``numpy``.  The JAX package's traced functions (its jax.numpy
scoring bodies) are not carried: the ``*_torch`` functions below take their
place.

**Torch twins.**  The namespace bodies do not run on torch tensors: they pass
Python floats to ``xp.maximum`` (torch.maximum takes tensors only) and call
``.astype`` (tensors have ``.to``).  So the device path keeps its own copies
here, formula for formula (``row_metric_deltas_torch``,
``wc_denominator_torch``, ``finalize_scores_torch``, and the scoring bodies
under the JAX names ``expand_query``, ``sparse_prefix_acc``,
``row_node_sums_blocked``, ``euler_prefix``), and
tests/test_torch_place_metrics.py holds each against the JAX original and
the numpy f64 oracle.

Index conventions differ from JAX in one way that matters on a GPU: JAX
drops out-of-range scatter indices and clamps out-of-range gathers, while
torch raises on the CPU and fires a device-side assert on CUDA (which kills
the context).  Every scatter below therefore writes to an explicit dump slot
and every gather stays in range by construction.

The host-side constructors of the static index structures (``block_segments``,
``csc_index``) build the arrays of the JAX package's make_block_segments /
make_csc_index in numpy and move them to the device; the containers are the
``BlockSegments`` / ``CscIndex`` slot classes, holding torch tensors.

ACCUMULATOR ORDER (axis 1 of everything downstream):
  0 genome-magnitude^2   1 logRaw numerator   2 logCosine numerator
  3 weightedContainment numerator             4 logContainment numerator
  5 presence (containment numerator)
"""

from __future__ import annotations

import numpy as np
import torch

METRICS = ("log_raw", "log_cosine", "containment", "weighted_containment",
           "log_containment")

N_ACC = 6  # accumulator columns (see module docstring)


def row_metric_deltas(xp, lrc, P, C, found):
    """Per-row metric deltas (placement.cpp:242-345).

    xp     numpy or jax.numpy — selects host-f64 vs traced-f32 execution
    lrc    float[T] log1p(read count) of the row's hash, 0 where not found
    P, C   float[T] parent/child seed counts of the row
    found  bool[T]  row hash present in the (filtered) read seed table

    Returns the 6 delta arrays in accumulator order.  Divisions guard with
    ``maximum(x, 1)`` instead of errstate so the same expression traces under
    jit; for P >= 1 the quotient is bit-identical to the unguarded division.
    """
    one = lrc.dtype.type(1.0) if hasattr(lrc.dtype, "type") else 1.0
    log_child = xp.where(C > 0, xp.log1p(C), 0.0)
    log_parent = xp.where(P > 0, xp.log1p(P), 0.0)
    mag_delta = log_child * log_child - log_parent * log_parent

    active = ((C - P) != 0) & found
    became_present = ((P == 0) & (C != 0)).astype(lrc.dtype)
    became_absent = ((C == 0) & (P != 0)).astype(lrc.dtype)
    presence_delta = xp.where(active, became_present - became_absent, 0.0)

    old_contrib = xp.where(P > 0, lrc / xp.maximum(P, one), 0.0)
    new_contrib = xp.where(C > 0, lrc / xp.maximum(C, one), 0.0)
    old_wc = xp.where(P > 0, 1.0 / xp.maximum(P, one), 0.0)
    new_wc = xp.where(C > 0, 1.0 / xp.maximum(C, one), 0.0)
    lograw_delta = xp.where(active, new_contrib - old_contrib, 0.0)
    logcos_delta = xp.where(active, lrc * (log_child - log_parent), 0.0)
    wc_delta = xp.where(active, new_wc - old_wc, 0.0)
    logcont_delta = presence_delta * lrc
    return (mag_delta, lograw_delta, logcos_delta, wc_delta, logcont_delta,
            presence_delta)


def wc_denominator(xp, lrc_root, C_root, found_root):
    """Weighted-containment denominator over the ROOT node's rows in stored
    order (src/placement.cpp:1861-1876).  The numpy path sums via cumsum so
    the f64 addition order is sequential, matching the reference's
    accumulation loop (np.sum is pairwise and can differ in the last bit)."""
    import numpy as _np

    one = lrc_root.dtype.type(1.0) if hasattr(lrc_root.dtype, "type") else 1.0
    inv = xp.where((C_root > 0) & found_root,
                   1.0 / xp.maximum(C_root, one), 0.0)
    if xp is _np:
        return _np.cumsum(inv)[-1] if len(inv) else 0.0
    return xp.sum(inv)


def finalize_scores(xp, acc, log_mag, read_unique, logcont_den, wc_den):
    """Accumulator [N,6] -> scores [N,5] in METRICS order (the NodeMetrics
    getters, src/placement.hpp:120-149).  Division guards via where-on-both-
    sides so the same body runs as numpy f64 (scalar stats) and traced f32
    (0-d array stats)."""
    gmsq, lograw, logcos, wc_num, logcont, presence = (
        acc[:, i] for i in range(N_ACC))
    z = xp.zeros_like(lograw)
    ok_mag = log_mag > 0
    s0 = xp.where(ok_mag, lograw / xp.where(ok_mag, log_mag, 1.0), z)
    gm = xp.sqrt(xp.maximum(gmsq, 0.0))
    den = log_mag * gm
    s1 = xp.clip(xp.where(den > 0, logcos / xp.where(den > 0, den, 1.0), z),
                 0.0, 1.0)
    s2 = xp.where(read_unique > 0,
                  presence / xp.where(read_unique > 0, read_unique, 1), z)
    s3 = xp.where(wc_den > 0, wc_num / xp.where(wc_den > 0, wc_den, 1.0), z)
    s4 = xp.where(logcont_den > 0,
                  logcont / xp.where(logcont_den > 0, logcont_den, 1.0), z)
    return xp.stack([s0, s1, s2, s3, s4], axis=1)


class BlockSegments:
    """Static per-index structure for the blocked per-node reduction.

    row_node is FIXED per DeviceIndex, so every segment boundary is known on
    the host.  That turns the per-node sum into: one block-local cumsum
    (native XLA op — unlike the 2.4M-row sorted scatter it is HBM-speed and
    compiles in seconds), gathers at STATIC positions, a tiny segmented scan
    over the B block totals for segments spanning block boundaries, and one
    M-row scatter (M = #non-empty nodes, ~60x smaller than the row count).

    f32 error semantics: per-segment, bounded by the BLOCK-local cumsum
    magnitude (<= L rows) — measured ~25x tighter than the sorted scatter's
    own accumulation error at bench shapes, and far from the rejected
    global-cumsum prefix-difference (see row_node_sums note).
    """

    __slots__ = ("L", "B", "pad", "lastp", "base", "has_base", "spanning",
                 "seg_node", "eb_blk", "q_flat", "has_bnd", "n_rows")

    def __init__(self, **kw):
        for k, v in kw.items():
            setattr(self, k, v)


class CscIndex:
    """Static per-index CSC structure: index rows grouped by unique hash id.

    The full row stream has T ~ millions of rows, but a single query's read
    seed table only FINDS a few thousand distinct hashes — and every
    query-dependent metric delta is zero on rows whose hash is not found
    (row_metric_deltas: ``active`` and ``presence_delta`` both carry the
    ``found`` factor).  Grouping rows by hash id lets the device expand and
    score ONLY the found rows (typically 100-1000x fewer than T), replacing
    the reference's full-SoA stream (src/placement.cpp:242-345) with work
    proportional to the query's hit set.  The one query-independent
    accumulator (column 0, the genome-magnitude^2 deltas) is precomputed per
    node in f64 on the host (``mag_static``).
    """

    __slots__ = ("off", "P", "C", "node", "mag_static", "mag_prefix",
                 "off_np", "n_rows")

    def __init__(self, **kw):
        self.mag_prefix = None
        for k, v in kw.items():
            setattr(self, k, v)


def query_found_rows(csc: CscIndex, uids):
    """Host: number of index rows the query's found uid set touches (decides
    the RCAP bucket / dense fallback before any device dispatch)."""
    import numpy as np

    if len(uids) == 0:
        return 0
    u = np.asarray(uids, dtype=np.int64)
    return int(np.sum(csc.off_np[u + 1].astype(np.int64)
                      - csc.off_np[u].astype(np.int64)))


def row_metric_deltas_torch(lrc, P, C, found):
    """Per-row metric deltas in accumulator order (placement.cpp:242-345);
    torch twin of row_metric_deltas."""
    log_child = torch.where(C > 0, torch.log1p(C), 0.0)
    log_parent = torch.where(P > 0, torch.log1p(P), 0.0)
    mag_delta = log_child * log_child - log_parent * log_parent

    active = ((C - P) != 0) & found
    became_present = ((P == 0) & (C != 0)).to(lrc.dtype)
    became_absent = ((C == 0) & (P != 0)).to(lrc.dtype)
    presence_delta = torch.where(active, became_present - became_absent, 0.0)

    old_contrib = torch.where(P > 0, lrc / P.clamp_min(1.0), 0.0)
    new_contrib = torch.where(C > 0, lrc / C.clamp_min(1.0), 0.0)
    old_wc = torch.where(P > 0, 1.0 / P.clamp_min(1.0), 0.0)
    new_wc = torch.where(C > 0, 1.0 / C.clamp_min(1.0), 0.0)
    lograw_delta = torch.where(active, new_contrib - old_contrib, 0.0)
    logcos_delta = torch.where(active, lrc * (log_child - log_parent), 0.0)
    wc_delta = torch.where(active, new_wc - old_wc, 0.0)
    logcont_delta = presence_delta * lrc
    return (mag_delta, lograw_delta, logcos_delta, wc_delta, logcont_delta,
            presence_delta)


def wc_denominator_torch(lrc_root, C_root, found_root):
    """Weighted-containment denominator over the root node's rows
    (placement.cpp:1861-1876), as a 0-d tensor.  ``lrc_root`` only carries
    the dtype, as in the JAX body."""
    inv = torch.where((C_root > 0) & found_root,
                      1.0 / C_root.to(lrc_root.dtype).clamp_min(1.0), 0.0)
    return inv.sum()


def block_segments(row_node: np.ndarray, n_nodes: int, device,
                   L: int = 1024) -> BlockSegments:
    """Host: sorted row_node i32[T] -> BlockSegments of device tensors (the
    arrays of metrics.make_block_segments).  Pad rows join the final
    segment; their deltas are zero-padded in row_node_sums_blocked."""
    T = len(row_node)
    B = max(-(-T // L), 1)
    pad = B * L - T
    rn_pad = np.concatenate([row_node,
                             np.full(pad, row_node[-1] if T else 0, np.int32)])
    lastp = np.nonzero(np.diff(rn_pad, append=np.int32(n_nodes)))[0]
    seg_node = rn_pad[lastp]
    eb_blk = lastp // L
    prev_end = np.concatenate(([-1], lastp[:-1]))
    has_base = (prev_end >= 0) & (prev_end // L == eb_blk)
    firstp = prev_end + 1
    spanning = (firstp // L) < eb_blk
    q = np.full(B, -1, np.int64)
    np.maximum.at(q, eb_blk, lastp % L)
    has_bnd = q >= 0
    q_flat = np.arange(B) * L + np.maximum(q, 0)

    def put(x, dt=torch.int64):
        return torch.as_tensor(np.asarray(x)).to(device=device, dtype=dt)

    return BlockSegments(
        L=L, B=B, pad=pad, n_rows=T,
        lastp=put(lastp),
        base=put(np.where(has_base, prev_end, 0)),
        has_base=put(has_base, torch.bool),
        spanning=put(spanning, torch.bool),
        seg_node=put(seg_node),
        eb_blk=put(eb_blk),
        q_flat=put(q_flat),
        has_bnd=put(has_bnd, torch.bool),
    )


def csc_index(row_id, P, C, row_node, n_unique: int, n_nodes: int,
              parent_index, device) -> CscIndex:
    """Host: CSR-by-node row arrays -> CscIndex of device tensors (the arrays
    of metrics.make_csc_index).  ``off`` has n_unique + 2 entries so the
    sentinel uid n_unique dereferences to an empty range.  The
    query-independent magnitude column is accumulated down the DFS-preorder
    tree (``parent_index``) in f64 on the host.  (The per-node
    ``mag_static`` column of the JAX structure feeds only the unported
    row_node_sums_sparse and is not built.)"""
    order = np.argsort(row_id, kind="stable")
    counts = np.bincount(row_id, minlength=n_unique + 1)
    off = np.zeros(n_unique + 2, np.int32)
    np.cumsum(counts, out=off[1 : n_unique + 2])
    lp = np.log1p(P.astype(np.float64))
    lc = np.log1p(C.astype(np.float64))
    mag = np.zeros(n_nodes, np.float64)
    np.add.at(mag, row_node, lc * lc - lp * lp)
    par = np.asarray(parent_index, dtype=np.int64)
    for i in range(1, n_nodes):
        mag[i] += mag[par[i]]
    return CscIndex(
        off=torch.from_numpy(off).to(device),
        P=torch.from_numpy(P[order].astype(np.int16)).to(device),
        C=torch.from_numpy(C[order].astype(np.int16)).to(device),
        node=torch.from_numpy(row_node[order].astype(np.int64)).to(device),
        mag_prefix=torch.from_numpy(mag.astype(np.float32)).to(device),
        off_np=off,
        n_rows=len(row_id),
    )


def cumsum_rows(x):
    """Inclusive prefix sum down the rows of a narrow [R, K] matrix.  Torch
    scans the outer dimension of a contiguous tensor with one GPU thread per
    column (~9 ms for an 80,000 x 5 f32 matrix, profiled on an NVIDIA H100
    80GB HBM3 at a 700 W power limit), so scan a transposed copy along its
    contiguous dimension instead; the result is a view."""
    return torch.cumsum(x.t().contiguous(), dim=1).t()


def expand_query(q_uids, q_logc, csc: CscIndex, rcap: int):
    """Expand the compact sorted found-uid table into per-row (rowpos, lrc,
    valid) over the query's found index rows (twin of
    metrics.expand_query): each non-empty query segment stamps its id at
    its start slot, a running max assigns every position to its segment.

    q_uids  int[FCAP] sorted found uids, padded with the sentinel n_unique
    q_logc  f32[FCAP] log1p counts, 0 on padding
    rcap    expanded-row capacity; the caller guarantees F <= rcap
    """
    dev = q_uids.device
    fcap = q_uids.shape[0]
    qu = q_uids.long()
    qo = csc.off[qu].long()
    ql = csc.off[qu + 1].long() - qo
    starts = torch.cumsum(ql, 0) - ql
    F = starts[-1] + ql[-1]
    sid = torch.arange(1, fcap + 1, dtype=torch.int64, device=dev)
    # slot rcap is the dump slot (JAX's mode="drop")
    at = torch.where((ql > 0) & (starts < rcap), starts, rcap)
    mark = torch.zeros(rcap + 1, dtype=torch.int64, device=dev)
    mark.scatter_reduce_(0, at, sid, "amax")
    seg = torch.cummax(mark[:rcap], 0).values - 1
    pos = torch.arange(rcap, dtype=torch.int64, device=dev)
    valid = (pos < F) & (seg >= 0)
    segc = seg.clamp_min(0)
    rowpos = torch.where(valid, qo[segc] + (pos - starts[segc]), 0)
    lrc = torch.where(valid, q_logc[segc], 0.0)
    return rowpos, lrc, valid


def sparse_prefix_acc(q_uids, q_logc, csc: CscIndex, euler_in, euler_out,
                      n_nodes: int, rcap: int):
    """Euler-prefixed accumulator [N,6] from the query's found rows only
    (twin of metrics.sparse_prefix_acc): the expanded rows' deltas go
    straight into Euler-tour slots (+ at the node's entry, - past its exit),
    one cumsum, one gather.  Column 0 is the precomputed magnitude prefix."""
    rowpos, lrc, valid = expand_query(q_uids, q_logc, csc, rcap)
    P = csc.P[rowpos].to(lrc.dtype)
    C = csc.C[rowpos].to(lrc.dtype)
    node = csc.node[rowpos]
    deltas = row_metric_deltas_torch(lrc, P, C, valid)
    d5 = torch.stack(deltas[1:], dim=1)  # invalid rows carry all-zero deltas
    dump = 2 * n_nodes + 1
    slot_in = torch.where(valid, euler_in[node], dump)
    slot_out = torch.where(valid, euler_out[node] + 1, dump)
    slots = torch.zeros((2 * n_nodes + 2, 5), dtype=lrc.dtype,
                        device=lrc.device)
    slots.index_add_(0, slot_in, d5)
    slots.index_add_(0, slot_out, -d5)
    pref = cumsum_rows(slots)
    acc5 = pref[euler_in]
    return torch.cat([csc.mag_prefix[:, None], acc5], dim=1)


def row_node_sums(lrc, P, C, found, row_node, n_nodes: int):
    """Per-node sums of the row deltas [N,6] as one segment sum over the
    node-sorted rows (twin of metrics.row_node_sums): the reduction of the
    mesh path, which has no blocked structure per shard.  P and C may come
    as i16 (their upload dtype) and are cast to the compute dtype here."""
    P = P.to(lrc.dtype)
    C = C.to(lrc.dtype)
    deltas = torch.stack(row_metric_deltas_torch(lrc, P, C, found), dim=1)
    out = torch.zeros((n_nodes, deltas.shape[1]), dtype=lrc.dtype,
                      device=lrc.device)
    return out.index_add_(0, row_node, deltas)


def row_node_sums_blocked(lrc, P, C, found, blk: BlockSegments,
                          n_nodes: int):
    """Per-node sums of the row deltas [N,6] without a row-count-sized
    scatter (twin of metrics.row_node_sums_blocked): block-local cumsums,
    gathers at the static segment ends, and a segmented scan over the B
    block tails for segments that span blocks.

    The JAX body does that segmented scan with lax.associative_scan in f32.
    Torch has no associative scan, so it runs here as a prefix difference
    over the B block tails in f64 (B ~ T/1024 values): its error stays below
    the f32 tree scan's, which place_exact's measured guards budget."""
    P = P.to(lrc.dtype)
    C = C.to(lrc.dtype)
    deltas = torch.stack(row_metric_deltas_torch(lrc, P, C, found), dim=1)
    K = deltas.shape[1]
    dp = torch.nn.functional.pad(deltas, (0, 0, 0, blk.pad))
    # block-local prefix sums along the contiguous dimension (see
    # cumsum_rows)
    cum = torch.cumsum(dp.reshape(blk.B, blk.L, K).transpose(1, 2)
                       .contiguous(), dim=2).transpose(1, 2).reshape(-1, K)
    head = cum[blk.lastp] - torch.where(blk.has_base[:, None], cum[blk.base],
                                        0.0)
    blk_tot = cum[blk.L - 1 :: blk.L]
    tail = blk_tot - torch.where(blk.has_bnd[:, None], cum[blk.q_flat], 0.0)
    # run[b] = tail[b] if block b holds a segment end, else run[b-1] + tail[b]
    ar = torch.arange(blk.B, device=lrc.device)
    last_bnd = torch.cummax(torch.where(blk.has_bnd, ar, -1), 0).values
    cs = cumsum_rows(tail.double())
    before = torch.where((last_bnd > 0)[:, None],
                         cs[(last_bnd - 1).clamp_min(0)], 0.0)
    run = (cs - before).to(lrc.dtype)
    carry = torch.cat([torch.zeros((1, K), dtype=lrc.dtype,
                                   device=lrc.device), run[:-1]])
    out_c = head + torch.where(blk.spanning[:, None], carry[blk.eb_blk], 0.0)
    out = torch.zeros((n_nodes, K), dtype=lrc.dtype, device=lrc.device)
    out[blk.seg_node] = out_c
    return out


def euler_prefix(node_sums, euler_in, euler_out, n_nodes: int):
    """Ancestor accumulation down the DFS as an Euler-tour signed prefix sum
    (twin of metrics.euler_prefix)."""
    slots = torch.zeros((2 * n_nodes + 1, node_sums.shape[1]),
                        dtype=node_sums.dtype, device=node_sums.device)
    slots.index_add_(0, euler_in, node_sums)
    slots.index_add_(0, euler_out + 1, -node_sums)
    return cumsum_rows(slots)[euler_in]


def finalize_scores_torch(acc, log_mag, read_unique, logcont_den, wc_den):
    """Accumulator [N,6] -> scores [N,5] in METRICS order (the NodeMetrics
    getters, placement.hpp:120-149); torch twin of finalize_scores.  The
    four statistics may be Python numbers or 0-d tensors; they are taken in
    the accumulator's dtype."""
    def stat(x):
        return torch.as_tensor(x, dtype=acc.dtype, device=acc.device)

    log_mag, read_unique = stat(log_mag), stat(read_unique)
    logcont_den, wc_den = stat(logcont_den), stat(wc_den)
    gmsq, lograw, logcos, wc_num, logcont, presence = (
        acc[:, i] for i in range(N_ACC))
    z = torch.zeros_like(lograw)
    ok_mag = log_mag > 0
    s0 = torch.where(ok_mag, lograw / torch.where(ok_mag, log_mag, 1.0), z)
    gm = torch.sqrt(gmsq.clamp_min(0.0))
    den = log_mag * gm
    s1 = torch.clip(torch.where(den > 0, logcos / torch.where(den > 0, den,
                                                              1.0), z),
                    0.0, 1.0)
    s2 = torch.where(read_unique > 0,
                     presence / torch.where(read_unique > 0, read_unique, 1.0),
                     z)
    s3 = torch.where(wc_den > 0, wc_num / torch.where(wc_den > 0, wc_den, 1.0),
                     z)
    s4 = torch.where(logcont_den > 0,
                     logcont / torch.where(logcont_den > 0, logcont_den, 1.0),
                     z)
    return torch.stack([s0, s1, s2, s3, s4], dim=1)
