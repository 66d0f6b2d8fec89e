"""SQUAREM abundance EM on the GPU (counterpart of
panmap_tpu/meta/engine.py::run_squarem_device and _squarem_body, B6).

The JAX package fuses the whole EM (masked SQUAREM steps, converge -> drop
-> restart rounds) into one device while_loop.  Here the loop is Python
with ONE host sync per turn of 8 masked steps (and one more at a round
transition); the steps keep _squarem_body's arithmetic in float32, its
floors and its masking, so iteration counts agree.  Ps @ p and u @ Ps are
torch.matmul, as the JAX package leaves them to XLA.  A CUDA graph of the
8-step turn is later performance work.
"""

from __future__ import annotations

from collections import defaultdict

import numpy as np
import torch

from .engine import (
    ERROR_RATE,
    PROP_THRESHOLD_TO_REMOVE,
    EMResult,
)
from .engine import run_squarem as host_run_squarem

STEPS_PER_TURN = 8
_KEY_ROWS = 1 << 16  # row block of the collapse keys


def collapse_identical(S: torch.Tensor, R: int, names: list):
    """Identical-column collapse of the score matrix S [>= R, M] (rows past
    R are ignored), as run_squarem_device does it: returns (keep, groups)
    with keep the sorted column indices that stay (the first of each class
    of identical columns, and any column that only shares a key) and groups
    representative name -> [names of the columns it absorbed].

    Columns are bucketed by two int64 projections with random weights:
    integer sums are exact in any order, so identical columns always share
    a key (the JAX package's f32 projections count on the same of XLA's
    dot products); a key shared by unequal columns is caught by the exact
    column comparison that follows."""
    M = len(names)
    Sr = S[:R]
    rng = np.random.default_rng(12345)
    W = torch.from_numpy(rng.integers(1, 1 << 24, (R, 2))).to(S.device)
    keys = torch.zeros((M, 2), dtype=torch.int64, device=S.device)
    for r0 in range(0, R, _KEY_ROWS):
        blk = Sr[r0:r0 + _KEY_ROWS].to(torch.int64)
        w = W[r0:r0 + _KEY_ROWS]
        keys[:, 0] += (blk * w[:, :1]).sum(0)
        keys[:, 1] += (blk * w[:, 1:]).sum(0)
    buckets: dict = {}
    for i, k in enumerate(map(tuple, keys.cpu().numpy().tolist())):
        buckets.setdefault(k, []).append(i)
    pairs_a, pairs_b = [], []
    for g in buckets.values():
        for j in g[1:]:
            pairs_a.append(g[0])
            pairs_b.append(j)
    same = np.ones(len(pairs_a), dtype=bool)
    if pairs_a:
        pa = torch.tensor(pairs_a, device=S.device)
        pb = torch.tensor(pairs_b, device=S.device)
        same = (Sr[:, pa] == Sr[:, pb]).all(dim=0).cpu().numpy()
    groups: dict = defaultdict(list)
    keep = []
    vi = 0
    for g in buckets.values():
        keep.append(g[0])
        for j in g[1:]:
            if same[vi]:
                groups[names[g[0]]].append(names[j])
            else:
                keep.append(j)  # key collision: stands alone
            vi += 1
    keep.sort()
    return keep, dict(groups)


def squarem(S: torch.Tensor, lens: torch.Tensor, w: torch.Tensor,
            eta: float = 1e-5, mct: float = 0.0, max_iterations: int = 1000,
            max_rounds: int = 5, mesh=None):
    """Masked SQUAREM over the score matrix S [R, M] (scores of read j at
    column i), read lengths ``lens`` [R] and weights ``w`` [R], all columns
    alive at the start; float32 throughout.  Returns (props float32 [M],
    alive bool [M], SQUAREM steps across rounds).

    ``mesh`` (parallel/mesh.py; R a multiple of mesh.size): the reads split
    over the shards, this process computing its own, and the three sums
    over reads (the weight total, u @ Ps and the log-likelihood: the rsum
    sites of _squarem_body(axis_name=...)) reduced over the mesh; the
    column vectors stay whole on every rank, on the first shard's device.
    Without a mesh the one shard is the whole matrix and the sums are its
    own."""
    log_err = float(np.log(ERROR_RATE))
    log_1me = float(np.log1p(-ERROR_RATE))
    if mesh is None:
        dev = S.device
        parts = [(S, lens, w)]

        def rsum(xs):
            return xs[0]
    else:
        from ..parallel.mesh import reduce_partials, split_rows

        dev = mesh.devices[0]
        parts = split_rows(mesh, S, lens, w)

        def rsum(xs):
            return reduce_partials(xs, mesh)
    lps, ws = [], []
    for Sk, lk, wk in parts:
        Sf = Sk.to(torch.float32)
        lps.append((lk.to(torch.float32)[:, None] - Sf) * log_err
                   + Sf * log_1me)
        ws.append(wk.to(torch.float32))
        del Sf
    wsum = rsum([wk.sum() for wk in ws])
    M = S.shape[1]

    def scale(alive):
        out = []
        for lp in lps:
            lpm = torch.where(alive.to(lp.device)[None, :], lp, -torch.inf)
            mx = lpm.amax(dim=1, keepdim=True)
            lpm -= mx
            out.append((lpm.exp_(), mx))
        return out

    def em(plane, p):
        us = []
        for (Ps, _), wk in zip(plane, ws):
            den = Ps @ p.to(Ps.device)
            u = wk / den.clamp_min(1e-30)
            us.append(u @ Ps)
        return rsum(us) * p / wsum

    def llh(plane, p):
        ls = []
        for (Ps, mx), wk in zip(plane, ws):
            den = Ps @ p.to(Ps.device)
            ls.append((wk * (mx[:, 0] + den.clamp_min(1e-30).log())).sum())
        return rsum(ls)

    def uniform(alive):
        n_alive = alive.sum()
        return torch.where(alive, 1.0 / n_alive.clamp_min(1), 0.0)

    def norm(p, alive):
        p = torch.where(alive, p.clamp_min(1e-12), 0.0)
        return p / p.sum()

    alive = torch.ones(M, dtype=torch.bool, device=dev)
    plane = scale(alive)
    p0 = uniform(alive)
    cur = torch.tensor(-np.inf, dtype=torch.float32, device=dev)
    it = torch.zeros((), dtype=torch.int32, device=dev)
    done = torch.zeros((), dtype=torch.bool, device=dev)
    tot = torch.zeros((), dtype=torch.int32, device=dev)
    rnd = 0
    while True:
        for _ in range(STEPS_PER_TURN):
            active = (~done) & (it < max_iterations)
            p1 = norm(em(plane, p0), alive)
            p2 = norm(em(plane, p1), alive)
            r = p1 - p0
            v = (p2 - p1) - r
            vn = torch.linalg.vector_norm(v)
            alpha = torch.where(vn > 0, -torch.linalg.vector_norm(r) / vn,
                                -1.0)
            psq = norm(p0 - 2.0 * alpha * r + alpha * alpha * v, alive)
            l2 = llh(plane, p2)
            lsq = llh(plane, psq)
            use_sq = lsq > l2 - eta
            pn = torch.where(use_sq, psq, p2)
            ln = torch.where(use_sq, lsq, l2)
            if mct == 0:
                stop = (ln - cur).abs() < eta
            else:
                stop = (pn - p0).abs().amax() < mct
            p0 = torch.where(active, pn, p0)
            cur = torch.where(active, ln, cur)
            done = done | (active & stop) | (it + 1 >= max_iterations)
            it = it + active.to(torch.int32)
            tot = tot + active.to(torch.int32)
        if not bool(done):  # the turn's one host sync
            continue
        # round transition: drop columns below the threshold; finish when
        # nothing dropped, everything dropped or the rounds are spent,
        # keeping the converged p and the post-drop alive; otherwise
        # restart from uniform over the survivors on a re-scaled plane
        passed = alive & (p0 >= PROP_THRESHOLD_TO_REMOVE)
        n_pass, n_alive = int(passed.sum()), int(alive.sum())
        alive = passed
        if n_pass == n_alive or rnd + 1 >= max_rounds or n_pass == 0:
            return p0, alive, int(tot)
        rnd += 1
        del plane
        plane = scale(alive)
        p0 = uniform(alive)
        cur = torch.full_like(cur, -np.inf)
        it = torch.zeros_like(it)
        done = torch.zeros_like(done)


def run_squarem_torch(S: torch.Tensor, read_lens: np.ndarray,
                      read_weights: np.ndarray, node_names: list,
                      eta: float = 1e-5, max_change_threshold: float = 0.0,
                      max_iterations: int = 1000,
                      max_rounds: int = 5, mesh=None,
                      row_block: int = 0) -> EMResult:
    """run_squarem_device's twin on the tensor S [R, M] (read j, column i)
    on S's device: identical-column collapse, then the masked SQUAREM.

    ``mesh``: the rows are padded with inert reads (score 0, length 0,
    weight 0) to a multiple of ``row_block`` (the JAX package's padded row
    count: its scorer's read blocks, or 4,096 for a host matrix) and the
    EM runs sharded when the mesh has more than one shard and they divide
    the padded rows, as run_squarem_device routes."""
    R, M = len(read_lens), len(node_names)
    if M == 0:
        return EMResult(node_names=[], props=np.empty(0), identical_groups={})
    keep, groups = collapse_identical(S, R, node_names)
    names = [node_names[i] for i in keep]
    dev = S.device
    lens = np.asarray(read_lens, np.int32)
    w = np.asarray(read_weights, np.float32)
    n = 0 if mesh is None else mesh.size
    rows = -(-R // row_block) * row_block if n and row_block else R
    if n > 1 and rows % n == 0:
        Sk = torch.zeros((rows, len(keep)), dtype=S.dtype, device=dev)
        Sk[:R] = S[:R, torch.tensor(keep, device=dev)]
        lens, w = (np.concatenate([x, np.zeros(rows - R, x.dtype)])
                   for x in (lens, w))
    else:
        Sk, mesh = S[:R, torch.tensor(keep, device=dev)], None
    p, alive, iters = squarem(
        Sk, torch.from_numpy(lens).to(dev), torch.from_numpy(w).to(dev),
        eta=eta, mct=max_change_threshold, max_iterations=max_iterations,
        max_rounds=max_rounds, mesh=mesh)
    sel = alive.cpu().numpy()
    return EMResult(node_names=[nm for nm, ok in zip(names, sel) if ok],
                    props=p.cpu().numpy().astype(np.float64)[sel],
                    identical_groups=groups, n_iterations=iters)


READ_BLOCK = 4096  # the JAX scorer's read block (TpuMetaScorer.READ_CHUNK)


def run_squarem(score_matrix, read_lens: np.ndarray,
                read_weights: np.ndarray, node_names: list,
                eta: float = 1e-5, max_change_threshold: float = 0.0,
                max_iterations: int = 1000, max_rounds: int = 5,
                prefer_cpu: bool = False, device=None,
                mesh=None) -> EMResult:
    """engine.run_squarem's routing: a tensor [R, M] runs the torch EM on
    its own device; a host matrix [M, R] with M x R > 5,000,000 runs it on
    ``device`` (on the CPU under ``prefer_cpu``, the JAX package's
    --host-score choice); anything smaller runs the numpy f64 EM
    (meta/engine.py::run_squarem).  ``mesh``: the torch EM's reads shard
    over it (see run_squarem_torch; the device snapshot's rows pad as the
    JAX scorer's blocks do, to a multiple of 4,096 x the mesh's shards, a
    host matrix's to a multiple of 4,096)."""
    kw = dict(eta=eta, max_change_threshold=max_change_threshold,
              max_iterations=max_iterations, max_rounds=max_rounds,
              mesh=mesh)
    if isinstance(score_matrix, torch.Tensor):
        block = READ_BLOCK * (mesh.size if mesh is not None else 1)
        return run_squarem_torch(score_matrix, read_lens, read_weights,
                                 node_names, row_block=block, **kw)
    M0, R0 = score_matrix.shape
    if M0 * R0 > 5_000_000:
        dev = torch.device("cpu") if prefer_cpu else torch.device(device)
        S = torch.from_numpy(np.ascontiguousarray(
            score_matrix.T.astype(np.int32))).to(dev)
        return run_squarem_torch(S, read_lens, read_weights, node_names,
                                 row_block=READ_BLOCK, **kw)
    kw.pop("mesh")
    return host_run_squarem(score_matrix, read_lens, read_weights,
                            node_names, backend="numpy", **kw)
