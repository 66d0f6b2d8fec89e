"""Torch twins of the placement metric bodies in panmap_tpu/place/metrics.py.

The JAX package's bodies take an array namespace (``numpy`` or
``jax.numpy``) but do not run on torch tensors: they pass Python floats to
``xp.maximum`` (torch.maximum takes tensors only) and call ``.astype``
(tensors have ``.to``).  So the port keeps its own copies here, formula for
formula, and tests/test_torch_place_metrics.py holds each against the JAX
original and the numpy f64 oracle.

Index conventions differ from JAX in one way that matters on a GPU: JAX
drops out-of-range scatter indices and clamps out-of-range gathers, while
torch raises on the CPU and fires a device-side assert on CUDA (which kills
the context).  Every scatter below therefore writes to an explicit dump slot
and every gather stays in range by construction.

The host-side constructors of the static index structures (``block_segments``,
``csc_index``) rebuild the arrays of metrics.make_block_segments /
make_csc_index in numpy (those call jax.numpy) and move them to the device.
The containers are the JAX package's own ``BlockSegments`` / ``CscIndex``
slot classes, holding torch tensors.
"""

from __future__ import annotations

import numpy as np
import torch

from panmap_tpu.place.metrics import (  # noqa: F401  (re-exported)
    N_ACC,
    BlockSegments,
    CscIndex,
    query_found_rows,
)


def row_metric_deltas(lrc, P, C, found):
    """Per-row metric deltas in accumulator order (placement.cpp:242-345);
    twin of panmap_tpu.place.metrics.row_metric_deltas."""
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


def wc_denominator(lrc_root, C_root, found_root):
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
    deltas = row_metric_deltas(lrc, P, C, valid)
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
    deltas = torch.stack(row_metric_deltas(lrc, P, C, found), dim=1)
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


def finalize_scores(acc, log_mag, read_unique, logcont_den, wc_den):
    """Accumulator [N,6] -> scores [N,5] in METRICS order (the NodeMetrics
    getters, placement.hpp:120-149); twin of metrics.finalize_scores.  The
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
