"""Plain abundance EM of the reference panmap's --meta mode
(src/mgsr.cpp's squarem over its read scores, github.com/amkram/panmap),
written as the plain EM it accelerates.

A read of length n (seed occurrences) scoring s at a node has likelihood
(1 - e)^s e^(n - s) there, e = 0.005.  One EM step maps the proportions p
to T(p)_j = p_j sum_r w_r P_rj / (sum_i P_ri p_i) / sum_r w_r, with w_r a
read's duplicate weight.  Columns below 0.005 are dropped after the EM
settles and it starts again from uniform over the rest, at most 5 rounds.
Constants copied from panmap_tpu_torch/meta/engine.py at commit 3519e45.

``residual`` (numpy float64) is how far one step moves given proportions:
the check of a program's abundances.  ``em`` (torch, any dtype) runs the
EM itself: in bfloat16 it is the control that stands in for a program
computing the abundances below the float32 the configuration states.
"""

from __future__ import annotations

import math

import numpy as np

ERROR_RATE = 0.005
DROP_BELOW = 0.005


def residual(S, lens, w, p) -> float:
    """max_j |T(p)_j - p_j| for scores S [R, A], read lengths [R], weights
    [R] and proportions p [A], all in float64."""
    S = np.asarray(S, np.float64)
    lp = ((np.asarray(lens, np.float64)[:, None] - S) * math.log(ERROR_RATE)
          + S * math.log1p(-ERROR_RATE))
    P = np.exp(lp - lp.max(1, keepdims=True))
    w = np.asarray(w, np.float64)
    p = np.asarray(p, np.float64)
    den = np.maximum(P @ p, 1e-300)
    T = p * ((w / den) @ P) / w.sum()
    return float(np.abs(T - p).max())


def em(S, lens, w, dtype, mct: float, max_iterations: int = 1000,
       max_rounds: int = 5):
    """(keep, groups, props): the EM over the distinct columns of S [>= R,
    M] (torch, rows past len(lens) ignored) in ``dtype``; keep the kept
    columns' indices, groups each kept column's identical columns, props
    their proportions (numpy float64)."""
    import torch

    R = len(lens)
    St = S[:R]
    _, inv = torch.unique(St.T.contiguous(), dim=0, return_inverse=True)
    inv = inv.cpu().numpy()
    first = {}
    groups: dict = {}
    for j, g in enumerate(inv.tolist()):
        if g in first:
            groups[first[g]].append(j)
        else:
            first[g] = j
            groups[j] = []
    cols = sorted(first.values())
    dev = St.device
    Sf = St[:, torch.tensor(cols, device=dev)].to(torch.float64)
    lt = torch.as_tensor(np.asarray(lens, np.float64), device=dev)
    lp = ((lt[:, None] - Sf) * math.log(ERROR_RATE)
          + Sf * math.log1p(-ERROR_RATE))
    wt = torch.as_tensor(np.asarray(w, np.float64), device=dev).to(dtype)
    alive = torch.ones(len(cols), dtype=torch.bool, device=dev)
    for rnd in range(max_rounds):
        lpa = torch.where(alive[None, :], lp, -math.inf)
        P = (lpa - lpa.amax(1, keepdim=True)).exp().to(dtype)
        p = (alive / alive.sum()).to(dtype)
        for _ in range(max_iterations):
            den = (P @ p).clamp_min(1e-30)
            pn = p * ((wt / den) @ P) / wt.sum()
            pn = torch.where(alive, pn, 0)
            pn = pn / pn.sum()
            moved = (pn - p).abs().max()
            p = pn
            if moved < mct:
                break
        passed = alive & (p >= DROP_BELOW)
        if bool((passed == alive).all()) or not bool(passed.any()):
            break
        alive = passed
    keep = [c for c, a in zip(cols, alive.cpu().tolist()) if a]
    props = p.to(torch.float64).cpu().numpy()[alive.cpu().numpy()]
    return keep, {c: groups[c] for c in keep}, props
