"""Plain numpy seeds: closed syncmers and their k-min-mers, for reads and
for a whole genome.

The hash is the reference panmap's (ntHash-style per-base constants,
rotate-XOR rolling; src/seeding.hpp:100-120 and src/seeding.cpp:47-229 of
github.com/amkram/panmap): written out here from those definitions, with
the constants copied from panmap_tpu_torch/sketch/cpu.py at commit
3519e45.  Reads are hashed all at once as a [reads, length] array; the
program hashes them one by one in its native library.

  F_w[p] = XOR_{i<w} rol(h(S[p+i]), w-1-i), R_w[p] = XOR_{i<w}
  rol(h(comp(S[p+i])), i); a k-mer at p is a closed syncmer when the
  smallest of its k-s+1 s-mer hashes sits at its first or last s-mer
  (either strand), its bases are all ACGT and F_k != R_k; its hash is
  min(F_k, R_k).  A k-min-mer joins l consecutive syncmers H[j..j+l-1]:
  min(XOR_w rol(H[j+w], k(l-1-w)), XOR_w rol(H[j+l-1-w], k(l-1-w))),
  skipped where the two are equal.

A genome's seeds are the k-min-mers of the syncmers that start inside its
flank mask: from its flank-th base to its flank-th base from the end (the
hard mask of src/index_single_mode.cpp:1851-1854).
"""

from __future__ import annotations

import numpy as np

U64 = np.uint64
_HASH = {"A": 0x3C8BFBB395C60474, "C": 0x3193C18562A02B4C,
         "G": 0x20323ED082572324, "T": 0x295549F54BE24456}
_COMP = {"A": "T", "C": "G", "G": "C", "T": "A"}
CHASH = np.zeros(256, U64)
CHASH_COMP = np.zeros(256, U64)
for _b, _v in _HASH.items():
    for _c in (_b, _b.lower()):
        CHASH[ord(_c)] = U64(_v)
        CHASH_COMP[ord(_c)] = U64(_HASH[_COMP[_b]])


def rol(x, r: int):
    r &= 63
    if r == 0:
        return x
    return (x << U64(r)) | (x >> U64(64 - r))


def _windows(h, hc, w: int):
    """F and R hashes of every length-w window along axis 0.  A batch of
    reads, [L, n] position-major, rolls them a base at a time:
    F[p+1] = rol(F[p], 1) ^ rol(h[p], w) ^ h[p+w] and R[p+1] = ror(R[p] ^
    hc[p], 1) ^ rol(hc[p+w], w-1)."""
    m = h.shape[0] - w + 1
    F = np.zeros((m,) + h.shape[1:], U64)
    R = np.zeros_like(F)
    if h.ndim == 1:
        for i in range(w):
            F ^= rol(h[i:i + m], w - 1 - i)
            R ^= rol(hc[i:i + m], i)
        return F, R
    for i in range(w):
        F[0] ^= rol(h[i], w - 1 - i)
        R[0] ^= rol(hc[i], i)
    for p in range(m - 1):
        F[p + 1] = rol(F[p], 1) ^ rol(h[p], w) ^ h[p + w]
        R[p + 1] = rol(R[p] ^ hc[p], 63) ^ rol(hc[p + w], w - 1)
    return F, R


def _min_run(x, w: int):
    """min over each run of w consecutive entries along axis 0."""
    m = x.shape[0] - w + 1
    out = x[:m].copy()
    for j in range(1, w):
        np.minimum(out, x[j:j + m], out=out)
    return out


def syncmers(seqs: np.ndarray, k: int, s: int, t: int, open_: bool):
    """(hash, is_syncmer) of every k-mer start of ``seqs``, a uint8 ASCII
    array [L] or a batch of reads [n, L] (the result then [n, L-k+1])."""
    x = np.ascontiguousarray(seqs.T)
    h, hc = CHASH[x], CHASH_COMP[x]
    Fk, Rk = _windows(h, hc, k)
    Fs, Rs = _windows(h, hc, s)
    m = Fk.shape[0]
    Fmin = _min_run(Fs, k - s + 1)
    Rmin = _min_run(Rs, k - s + 1)
    fa, fb = Fs[t:t + m], Fs[k - s - t:k - s - t + m]
    ra, rb = Rs[t:t + m], Rs[k - s - t:k - s - t + m]
    if open_:
        sync = (fa == Fmin) | (rb == Rmin)
    else:
        sync = (fa == Fmin) | (fb == Fmin) | (rb == Rmin) | (ra == Rmin)
    bad = np.cumsum(np.concatenate(
        [np.zeros((1,) + h.shape[1:], np.int64), (h == 0).astype(np.int64)]),
        0)
    sync &= ((bad[k:] - bad[:-k]) == 0) & (Fk != Rk)
    return np.minimum(Fk, Rk).T, sync.T


def kminmers(H: np.ndarray, group: np.ndarray, k: int, l: int):
    """(canonical hash, orientation, group) of each k-min-mer over runs of
    ``l`` consecutive syncmer hashes ``H`` that share a ``group`` (a read's
    index); palindromes dropped.  The orientation is True where the
    reverse join is the smaller."""
    c = len(H) - l + 1
    if c <= 0:
        return np.empty(0, U64), np.empty(0, bool), group[:0]
    F = np.zeros(c, U64)
    R = np.zeros(c, U64)
    for w in range(l):
        F ^= rol(H[w:w + c], k * (l - 1 - w))
        R ^= rol(H[l - 1 - w:l - 1 - w + c], k * (l - 1 - w))
    keep = (group[:c] == group[l - 1:]) & (F != R)
    return np.minimum(F, R)[keep], (R < F)[keep], group[:c][keep]


def read_seeds(reads: np.ndarray, k: int, s: int, t: int, l: int,
               open_: bool):
    """kminmers() of each read of ``reads``, a uint8 ASCII array [n, L]:
    the group is the read's row."""
    hsh, sync = syncmers(reads, k, s, t, open_)
    row, _ = np.nonzero(sync)
    return kminmers(hsh[sync], row, k, l)


def read_seed_counts(reads: np.ndarray, k: int, s: int, t: int, l: int,
                     open_: bool, block: int = 1 << 14):
    """(hashes, counts) of the k-min-mers of every read of ``reads``, a
    uint8 ASCII array [n, L], counted over all reads."""
    parts = [read_seeds(reads[r0:r0 + block], k, s, t, l, open_)[0]
             for r0 in range(0, len(reads), block)]
    return np.unique(np.concatenate(parts), return_counts=True)


def genome_seeds(genome: str, k: int, s: int, t: int, l: int, open_: bool,
                 flank: int):
    """(hashes, orientations) of a genome's k-min-mers inside its flank
    mask, in genome order."""
    seq = np.frombuffer(genome.encode(), np.uint8)
    n = len(seq)
    if n < max(2 * flank, k):
        return np.empty(0, U64), np.empty(0, bool)
    hsh, sync = syncmers(seq, k, s, t, open_)
    pos = np.flatnonzero(sync)
    lo, hi = (flank - 1, n - flank) if flank > 0 else (0, n)
    pos = pos[(pos >= lo) & (pos <= hi)]
    return kminmers(hsh[pos], np.zeros(len(pos), np.int64), k, l)[:2]


def genome_seed_counts(genome: str, k: int, s: int, t: int, l: int,
                       open_: bool, flank: int):
    """(hashes, counts) of a genome's k-min-mers inside its flank mask."""
    km, _ = genome_seeds(genome, k, s, t, l, open_, flank)
    return np.unique(km, return_counts=True)


def homopolymer_hashes(k: int) -> np.ndarray:
    """Canonical hashes of the all-A, -C, -G and -T k-mers."""
    out = []
    for b in b"ACGT":
        seq = np.full(k, b, np.uint8)
        F, R = _windows(CHASH[seq], CHASH_COMP[seq], k)
        out.append(min(F[0], R[0]))
    return np.array(out, U64)
