"""Bit-exact syncmer / k-min-mer sketching, vectorized in numpy uint64.

Reimplements the hashing scheme of the reference (ntHash-style per-base constants
with rotate-XOR rolling; reference: src/seeding.hpp:100-120, src/seeding.cpp:47-229)
as array programs instead of per-position rolling loops.  Every u64 produced here
must match the reference bit-for-bit — the whole index/placement stack keys on
these hashes.

Definitions (k-mer window at position p over sequence S, s-mer windows inside it):
  F_k[p]   = XOR_{i<k}  rol(chash(S[p+i]),        k-1-i)     forward k-mer hash
  R_k[p]   = XOR_{j<k}  rol(chash(comp(S[p+j])),  j)          rc k-mer hash
  F_s/R_s  = same with s
  syncmer(open):    F_s[p+t] == min F_s[p..p+k-s]   (forward), or
                    R_s[p+k-s-t] == min R_s[p..p+k-s] (reverse)
  syncmer(closed):  additionally the mirrored offset k-s-t
  canonical hash = min(F_k, R_k); equal fwd/rc (palindrome) or any non-ACGT base
  in the window disqualifies the position.

k-min-mers combine l consecutive syncmer hashes H[j..j+l-1]:
  fwd = XOR_{w<l} rol(H[j+w],     k*(l-1-w))
  rev = XOR_{w<l} rol(H[j+l-1-w], k*(l-1-w))
  canonical = min(fwd, rev); fwd == rev (palindrome) is skipped.
(reference: src/placement.cpp:1650-1684 read side, src/index_single_mode.cpp:2004-2044
index side — identical algebra.)
"""

from __future__ import annotations

import numpy as np

U64 = np.uint64
U64_MAX = np.uint64(0xFFFFFFFFFFFFFFFF)

# per-base hash constants (src/seeding.hpp:100-112)
_HASH_A = np.uint64(0x3C8BFBB395C60474)
_HASH_C = np.uint64(0x3193C18562A02B4C)
_HASH_G = np.uint64(0x20323ED082572324)
_HASH_T = np.uint64(0x295549F54BE24456)

CHASH = np.zeros(256, dtype=U64)
for ch, v in (("A", _HASH_A), ("C", _HASH_C), ("G", _HASH_G), ("T", _HASH_T)):
    CHASH[ord(ch)] = v
    CHASH[ord(ch.lower())] = v

# chash(comp(base)) lookup
CHASH_COMP = np.zeros(256, dtype=U64)
for ch, v in (("A", _HASH_T), ("C", _HASH_G), ("G", _HASH_C), ("T", _HASH_A)):
    CHASH_COMP[ord(ch)] = v
    CHASH_COMP[ord(ch.lower())] = v

_RC_MAP = {"A": "T", "T": "A", "C": "G", "G": "C", "a": "t", "t": "a", "c": "g", "g": "c"}
RC_TABLE = bytes(ord(_RC_MAP.get(chr(c), chr(c))) for c in range(256))


def rol(h: np.ndarray | np.uint64, r: int):
    """64-bit rotate left (r taken mod 64; numpy shift by >=64 is undefined)."""
    r &= 63
    if r == 0:
        return h
    return (h << np.uint64(r)) | (h >> np.uint64(64 - r))


def ror(h: np.ndarray | np.uint64, r: int):
    r &= 63
    if r == 0:
        return h
    return (h >> np.uint64(r)) | (h << np.uint64(64 - r))


def _as_bytes(seq) -> np.ndarray:
    if isinstance(seq, np.ndarray):
        if seq.dtype == np.uint8:
            return seq
        return seq.view(np.uint8)
    if isinstance(seq, (bytes, bytearray, memoryview)):
        return np.frombuffer(seq, dtype=np.uint8)
    return np.frombuffer(seq.encode(), dtype=np.uint8)


def reverse_complement(seq: str) -> str:
    return seq.encode().translate(RC_TABLE)[::-1].decode()


def hash_seq(seq: str) -> tuple[int, int]:
    """(forward, reverse-complement) hash of a whole sequence (src/seeding.cpp:20-30)."""
    b = _as_bytes(seq)
    k = len(b)
    h = CHASH[b]
    hc = CHASH_COMP[b]
    if np.any(h == 0):
        raise ValueError("Kmer contains non canonical base")
    f = np.uint64(0)
    r = np.uint64(0)
    for i in range(k):
        f ^= rol(h[i], k - i - 1)
        r ^= rol(hc[k - i - 1], k - i - 1)
    return int(f), int(r)


def _window_hashes(h: np.ndarray, hc: np.ndarray, w: int):
    """Forward / rc hashes for every length-w window. Returns (F, R) length n-w+1."""
    n = len(h)
    m = n - w + 1
    F = np.zeros(m, dtype=U64)
    R = np.zeros(m, dtype=U64)
    for i in range(w):
        F ^= rol(h[i : i + m], w - 1 - i)
        R ^= rol(hc[i : i + m], i)
    return F, R


def _sliding_min(x: np.ndarray, w: int) -> np.ndarray:
    """min over each length-w window of x (w is small: k-s+1)."""
    try:
        from numpy.lib.stride_tricks import sliding_window_view

        return sliding_window_view(x, w).min(axis=-1)
    except Exception:  # pragma: no cover
        m = len(x) - w + 1
        out = x[:m].copy()
        for j in range(1, w):
            np.minimum(out, x[j : j + m], out=out)
        return out


def rolling_syncmers(seq, k: int, s: int, open_: bool, t: int = 0):
    """Per-position syncmer scan.

    Returns (hashes u64[n-k+1], is_reverse bool[...], is_syncmer bool[...]).
    Non-syncmer positions carry hash=U64_MAX / is_reverse=False, matching the
    returnAll=true contract of the reference (src/seeding.cpp:47-229).
    """
    b = _as_bytes(seq)
    n = len(b)
    if n < k:
        return (np.empty(0, U64), np.empty(0, bool), np.empty(0, bool))

    try:  # native twin (panmap_tpu/native): bit-exact, ~8x faster
        from ..native import rolling_syncmers_native

        out = rolling_syncmers_native(b, k, s, t, open_)
        if out is not None:
            return out
    except ImportError:  # pragma: no cover
        pass

    h = CHASH[b]
    hc = CHASH_COMP[b]
    m = n - k + 1

    Fk, Rk = _window_hashes(h, hc, k)
    Fs, Rs = _window_hashes(h, hc, s)

    # window minimum over the k-s+1 s-mers inside each k-mer
    w = k - s + 1
    Fmin = _sliding_min(Fs, w)
    Rmin = _sliding_min(Rs, w)

    if open_:
        fwd_sync = Fs[t : t + m] == Fmin
        rev_sync = Rs[k - s - t : k - s - t + m] == Rmin
    else:
        fwd_sync = (Fs[t : t + m] == Fmin) | (Fs[k - s - t : k - s - t + m] == Fmin)
        rev_sync = (Rs[k - s - t : k - s - t + m] == Rmin) | (Rs[t : t + m] == Rmin)

    # any non-ACGT base inside the k-mer window disqualifies it
    bad = (h == 0).astype(np.int32)
    cbad = np.concatenate(([0], np.cumsum(bad)))
    amb = (cbad[k:] - cbad[:-k]) > 0

    is_sync = (fwd_sync | rev_sync) & ~amb & (Fk != Rk)
    is_rev = (Rk < Fk) & is_sync
    hashes = np.where(is_sync, np.minimum(Fk, Rk), U64_MAX)
    return hashes, is_rev, is_sync


def syncmer_list(seq, k: int, s: int, open_: bool, t: int = 0):
    """(positions, hashes, is_reverse) of syncmer positions only (returnAll=false)."""
    hashes, is_rev, is_sync = rolling_syncmers(seq, k, s, open_, t)
    pos = np.flatnonzero(is_sync)
    return pos, hashes[pos], is_rev[pos]


def kminmer_hashes(H: np.ndarray, k: int, l: int):
    """Combine l consecutive syncmer hashes into k-min-mers.

    Returns (canonical u64[m-l+1], valid bool[m-l+1]) where valid=False marks
    palindromic windows (fwd==rev), which the reference skips.
    For l==1 the k-min-mer is the syncmer hash itself and nothing is skipped.
    """
    canon, valid, _ = kminmer_hashes_oriented(H, k, l)
    return canon, valid


def kminmer_hashes_oriented(H: np.ndarray, k: int, l: int,
                            syncmer_rev: np.ndarray | None = None):
    """Like kminmer_hashes but also returns is_rev (reverse combine < forward).

    For l==1 the orientation is the syncmer's own strand (pass syncmer_rev);
    the reference treats the opposite-strand hash as +inf there
    (index_single_mode.cpp:1991-2003)."""
    m = len(H)
    if m < l:
        z = np.empty(0, U64)
        return z, np.empty(0, bool), np.empty(0, bool)
    if l == 1:
        rev = (syncmer_rev.astype(bool) if syncmer_rev is not None
               else np.zeros(m, dtype=bool))
        return H.astype(U64, copy=True), np.ones(m, dtype=bool), rev
    c = m - l + 1
    F = np.zeros(c, dtype=U64)
    R = np.zeros(c, dtype=U64)
    for wdx in range(l):
        F ^= rol(H[wdx : wdx + c], k * (l - 1 - wdx))
        R ^= rol(H[l - 1 - wdx : l - 1 - wdx + c], k * (l - 1 - wdx))
    valid = F != R
    return np.minimum(F, R), valid, R < F


def read_kminmer_counts(seqs: list, k: int, s: int, t: int, l: int, open_: bool,
                        multiplicities=None, trim_start: int = 0, trim_end: int = 0):
    """seedFreqInReads construction for a batch of (unique) read sequences.

    Mirrors src/placement.cpp:1611-1684: per read, take its syncmers (optionally
    trim-filtered on the k-mer start position), then roll k-min-mers over the
    in-range sub-list; count canonical hashes weighted by read multiplicity.
    Returns dict hash->count.
    """
    counts: dict[int, int] = {}
    for idx, seq in enumerate(seqs):
        mult = 1 if multiplicities is None else int(multiplicities[idx])
        pos, H, _ = syncmer_list(seq, k, s, open_, t)
        if len(H) < max(l, 1):
            continue
        if trim_start > 0 or trim_end > 0:
            lo = trim_start
            hi = len(seq) - trim_end - k
            keep = (pos >= lo) & (pos <= hi)
            if l == 1:
                H = H[keep]
            else:
                # trimming removes contiguous ends: reduce to the in-range sub-list
                idxs = np.flatnonzero(keep)
                if len(idxs) == 0:
                    continue
                H = H[idxs[0] : idxs[-1] + 1]
        if l == 1:
            for hval in H.tolist():
                counts[hval] = counts.get(hval, 0) + mult
            continue
        if len(H) < l:
            continue
        km, valid = kminmer_hashes(H, k, l)
        for hval in km[valid].tolist():
            counts[hval] = counts.get(hval, 0) + mult
    return counts


def hpc_compress_with_mapping(seq: str):
    """Homopolymer compression with original-position mapping (src/seeding.cpp:291-306)."""
    if not seq:
        return "", np.empty(0, dtype=np.int64)
    b = _as_bytes(seq)
    up = np.frombuffer(seq.upper().encode(), dtype=np.uint8)
    keep = np.concatenate(([True], up[1:] != up[:-1]))
    mapping = np.flatnonzero(keep)
    return b[mapping].tobytes().decode(), mapping


def hpc_compress(seq: str) -> str:
    return hpc_compress_with_mapping(seq)[0]
