"""ctypes bindings for the native host kernels (panmap_native.cpp).

The library is built with g++ at first use into the package's build
directory (panmap_tpu_torch/_build/, beside the CUDA kernels' library),
named by the hash of its source, its flags and the host's CPU features (it
is compiled with -march=native) and published with an atomic rename, so
processes that share the tree never load a half-written file or one made
for another CPU.  Every entry
point has a bit-exact numpy twin (sketch/cpu.py and the callers' own
fallbacks), reached when ``get_lib()`` is None: with the documented
``PANMAP_TPU_NO_NATIVE`` switch, or when the build fails.  The port's main
paths raise in the second case (the pipeline's aligner and the meta
sketcher need the library); the twins are for that explicit switch.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import threading
import time

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "panmap_native.cpp")
BUILD_DIR = os.path.join(os.path.dirname(_DIR), "_build")
GXX_FLAGS = ["-O3", "-march=native", "-fPIC", "-shared", "-std=c++17"]

_lib = None
# Serializes first-load/build: the align-prefetch thread and the main
# thread's sketcher both call get_lib() on startup; without the lock two
# racing builds would both compile the library.
_lib_lock = threading.Lock()
# (seconds, library path) of the build this process ran; None when it loaded
# a library that was already built
build_info = None
# the g++ output of a failed build (None: no build failed)
build_error = None


def _host_id() -> bytes:
    """What -march=native compiles for: the machine type and the CPU's
    feature flags, so a library built on one CPU is never loaded on
    another that shares the tree."""
    flags = ""
    try:
        with open("/proc/cpuinfo") as fh:
            for line in fh:
                if line.startswith(("flags", "Features")):
                    flags = " ".join(sorted(line.split(":", 1)[1].split()))
                    break
    except OSError:
        pass
    return f"{platform.machine()} {flags}".encode()


def _so_path() -> str:
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    h.update(_host_id())
    with open(_SRC, "rb") as fh:
        h.update(fh.read())
    return os.path.join(BUILD_DIR,
                        f"libpanmap_native_{h.hexdigest()[:16]}.so")


def _try_build(so: str) -> bool:
    """Compile the source to a private temp name, then publish with an
    atomic rename so a concurrent loader (another process sharing the tree)
    sees the whole library or none."""
    global build_info, build_error
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    t0 = time.perf_counter()
    try:
        subprocess.run(["g++", *GXX_FLAGS, _SRC, "-o", tmp],
                       check=True, capture_output=True, timeout=300)
        os.replace(tmp, so)
        build_info = (time.perf_counter() - t0, so)
        return True
    except Exception as exc:
        build_error = (getattr(exc, "stderr", b"") or b"").decode(
            "utf-8", "replace") or repr(exc)
        try:
            if os.path.exists(tmp):
                os.unlink(tmp)
        except OSError:
            pass
        return False


def join_reads(seqs):
    """(uint8 buffer, CSR offsets i64[n+1], lens i64[n]) for a read batch —
    via the batch's cached join when available (io.fastq.ReadBatch), else a
    fresh join.  The single definition of the joining logic."""
    if hasattr(seqs, "cached_join"):
        return seqs.cached_join()
    buf = np.frombuffer("".join(seqs).encode(), dtype=np.uint8)
    lens = np.fromiter((len(s) for s in seqs), dtype=np.int64,
                       count=len(seqs))
    offsets = np.concatenate(([0], np.cumsum(lens)))
    return buf, offsets, lens


def require_lib():
    """The loaded library for the port's main paths: raises when it did not
    build or load.  Returns None only under PANMAP_TPU_NO_NATIVE, the one
    switch that sends callers to the numpy twins; a stage with no twin (the
    indel realignment, genotype/indel.py::call_indels_realign) raises then
    itself."""
    lib = get_lib()
    if lib is None and not os.environ.get("PANMAP_TPU_NO_NATIVE"):
        raise RuntimeError(
            "the native host library (panmap_tpu_torch/native/"
            "panmap_native.cpp) did not build or load; the port's main "
            "paths need it (PANMAP_TPU_NO_NATIVE=1 runs the numpy twins "
            f"instead)\n{build_error or ''}")
    return lib


def get_lib():
    global _lib
    if _lib is not None:
        return _lib or None
    with _lib_lock:
        return _get_lib_locked()


def _get_lib_locked():
    global _lib
    if _lib is not None:  # double-checked under _lib_lock
        return _lib or None
    if os.environ.get("PANMAP_TPU_NO_NATIVE"):
        # diagnostic switch: force every caller onto its numpy twin
        _lib = False
        return None
    so = _so_path()  # named by source, flags and CPU: never stale
    if not os.path.exists(so) and not _try_build(so):
        _lib = False
        return None
    try:
        lib = ctypes.CDLL(so)
    except OSError:
        _lib = False
        return None
    # contract gate: a stale binary that predates an entry point's CONTRACT
    # change (e.g. pt_sketch_count's sorted output, ABI v2) must not load —
    # the numpy twins are slower but correct
    ABI = 2
    if not hasattr(lib, "pt_abi_version"):
        _lib = False
        return None
    lib.pt_abi_version.restype = ctypes.c_int64
    if int(lib.pt_abi_version()) != ABI:
        _lib = False
        return None
    lib.pt_rolling_syncmers.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p]
    lib.pt_encode_reads.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_void_p]
    lib.pt_baq_glocal.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_double, ctypes.c_double,
        ctypes.c_void_p, ctypes.c_void_p]
    lib.pt_baq_glocal.restype = ctypes.c_int
    lib.pt_glocal_score.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_double, ctypes.c_double]
    lib.pt_glocal_score.restype = ctypes.c_int
    lib.pt_indel_sites.argtypes = (
        [ctypes.c_void_p] * 4 + [ctypes.c_int64]          # cigars
        + [ctypes.c_void_p] * 3 + [ctypes.c_int64]        # seq, quals
        + [ctypes.c_void_p] * 3 + [ctypes.c_int64]        # mapq, rev, ref
        + [ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int]
        + [ctypes.c_void_p] * 11)                         # outputs
    lib.pt_indel_sites.restype = ctypes.c_int64
    lib.pt_chain_dp.argtypes = (
        [ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int64] * 5
        + [ctypes.c_double] + [ctypes.c_void_p] * 7)
    lib.pt_chain_dp.restype = ctypes.c_int64
    lib.pt_sketch_count.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int64]
    lib.pt_sketch_count.restype = ctypes.c_int64
    lib.pt_join_u64.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    lib.pt_sketch_meta.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64]
    lib.pt_sketch_meta.restype = ctypes.c_int64
    lib.pt_align_sr.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,  # reads
        ctypes.c_void_p, ctypes.c_int64,                   # ref codes
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int,                                      # defer_dp
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # pre CSR
        ctypes.c_void_p, ctypes.c_void_p]
    if hasattr(lib, "pt_align_sr_rows"):
        lib.pt_align_sr_rows.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,  # reads
            ctypes.c_void_p, ctypes.c_int64,                   # row subset
            ctypes.c_void_p, ctypes.c_int64,                   # ref codes
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # pre CSR
            ctypes.c_void_p, ctypes.c_void_p]
    if hasattr(lib, "pt_copy_rows"):
        lib.pt_copy_rows.argtypes = [ctypes.c_void_p] * 4 + [
            ctypes.c_int64, ctypes.c_void_p]
        lib.pt_oriented_blobs.argtypes = [ctypes.c_void_p] * 5 + [
            ctypes.c_int64] + [ctypes.c_void_p] * 3
    if hasattr(lib, "pt_min_sr"):
        lib.pt_min_sr.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,  # reads
            ctypes.c_int, ctypes.c_int, ctypes.c_int,          # k, w, threads
            ctypes.c_void_p, ctypes.c_void_p,                  # wc_off, cnt
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    if hasattr(lib, "pt_score_simple"):
        lib.pt_score_simple.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,   # tree
            ctypes.c_void_p, ctypes.c_void_p,                   # deltas
            ctypes.c_void_p, ctypes.c_void_p,                   # seed table
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # reads CSR
            ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,   # rel/cand
            ctypes.c_int32, ctypes.c_int32,                     # emit/threads
            ctypes.c_void_p, ctypes.c_void_p,                   # outputs
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # ev bufs
            ctypes.c_int64]
        lib.pt_score_simple.restype = ctypes.c_int64
    if hasattr(lib, "pt_score_pseudo"):
        lib.pt_score_pseudo.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,   # tree
            ctypes.c_void_p, ctypes.c_void_p,                   # deltas
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # seed table
            ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # gev
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # bev
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,   # blocks
            ctypes.c_void_p, ctypes.c_int64,                    # nongap0
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # reads CSR
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,   # rel/cand
            ctypes.c_int32, ctypes.c_int32,                     # gap/threads
            ctypes.c_void_p, ctypes.c_void_p]                   # outputs
    _lib = lib
    return lib


def sketch_meta_native(seqs: list, k: int, s: int, t: int, open_: bool,
                       l: int, threads: int = 0):
    """Per-read seedmer lists (CSR): returns (read_offsets i64[n+1],
    hashes u64, revs bool, qb i32, qe i32, fp1 u64[n], fp2 u64[n]) — fp are
    order-dependent content fingerprints for dedup — or None without the
    library."""
    lib = get_lib()
    if lib is None:
        return None
    if threads <= 0:
        threads = min(os.cpu_count() or 1, 16)
    buf, offsets, _ = join_reads(seqs)
    cap = max(int(offsets[-1] // 4) + 1024, 1 << 16)
    for _ in range(3):
        ro = np.empty(len(seqs) + 1, dtype=np.int64)
        oh = np.empty(cap, dtype=np.uint64)
        orv = np.empty(cap, dtype=np.uint8)
        oqb = np.empty(cap, dtype=np.int32)
        oqe = np.empty(cap, dtype=np.int32)
        fp1 = np.empty(len(seqs), dtype=np.uint64)
        fp2 = np.empty(len(seqs), dtype=np.uint64)
        n = lib.pt_sketch_meta(
            buf.ctypes.data, offsets.ctypes.data, len(seqs), k, s, t,
            int(open_), l, threads, ro.ctypes.data, oh.ctypes.data,
            orv.ctypes.data, oqb.ctypes.data, oqe.ctypes.data,
            fp1.ctypes.data, fp2.ctypes.data, cap)
        if n >= 0:
            return (ro, oh[:n], orv[:n].astype(bool), oqb[:n], oqe[:n],
                    fp1, fp2)
        cap *= 4
    return None


def join_u64_native(queries: np.ndarray, table_sorted: np.ndarray,
                    threads: int = 0):
    """Threaded lower_bound of each u64 query in a sorted u64 table.
    Returns (idx i32[n] clipped, found bool[n]) or None without the lib."""
    lib = get_lib()
    if lib is None:
        return None
    if threads <= 0:
        threads = min(os.cpu_count() or 1, 16)
    q = np.ascontiguousarray(queries, dtype=np.uint64)
    U = np.ascontiguousarray(table_sorted, dtype=np.uint64)
    idx = np.empty(len(q), dtype=np.int32)
    found = np.empty(len(q), dtype=np.uint8)
    lib.pt_join_u64(q.ctypes.data, len(q), U.ctypes.data, len(U), threads,
                    idx.ctypes.data, found.ctypes.data)
    return idx, found.astype(bool)


def sketch_count_native(seqs: list, k: int, s: int, t: int, open_: bool,
                        l: int, trim_start: int = 0, trim_end: int = 0,
                        threads: int = 0):
    """Batched seedFreqInReads: distinct canonical k-min-mer counts over all
    reads (native twin of place/engine.py::sketch_reads with
    dedup_reads=False).  Returns (hashes u64[n] SORTED ascending, counts u32[n]),
    or None if the library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    if threads <= 0:
        threads = min(os.cpu_count() or 1, 16)
    buf, offsets, _ = join_reads(seqs)
    cap = 1 << 22
    for _ in range(3):
        out_hash = np.empty(cap, dtype=np.uint64)
        out_count = np.empty(cap, dtype=np.uint32)
        n = lib.pt_sketch_count(
            buf.ctypes.data, offsets.ctypes.data, len(seqs), k, s, t,
            int(open_), l, trim_start, trim_end, threads,
            out_hash.ctypes.data, out_count.ctypes.data, cap)
        if n >= 0:
            return out_hash[:n].copy(), out_count[:n].copy()
        cap *= 4
    return None


def baq_glocal_native(ref_codes: np.ndarray, q_codes: np.ndarray,
                      quals: np.ndarray, bw: int, gapd: float, gape: float):
    """Banded glocal HMM posterior (BAQ core); returns (state, q) or None."""
    lib = get_lib()
    if lib is None:
        return None
    ref_codes = np.ascontiguousarray(ref_codes, dtype=np.uint8)
    q_codes = np.ascontiguousarray(q_codes, dtype=np.uint8)
    quals = np.ascontiguousarray(quals, dtype=np.uint8)
    lq = len(q_codes)
    state = np.empty(lq, dtype=np.int32)
    q = np.empty(lq, dtype=np.uint8)
    rc = lib.pt_baq_glocal(ref_codes.ctypes.data, len(ref_codes),
                           q_codes.ctypes.data, lq, quals.ctypes.data,
                           bw, gapd, gape, state.ctypes.data, q.ctypes.data)
    if rc != 0:
        return None
    return state, q


def glocal_score_native(ref_codes: np.ndarray, q_codes: np.ndarray,
                        quals: np.ndarray, bw: int, gapd: float,
                        gape: float):
    """Forward-only glocal phred score (probaln score mode) — the indel
    realignment objective; returns None if the library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    ref_codes = np.ascontiguousarray(ref_codes, dtype=np.uint8)
    q_codes = np.ascontiguousarray(q_codes, dtype=np.uint8)
    quals = np.ascontiguousarray(quals, dtype=np.uint8)
    return int(lib.pt_glocal_score(
        ref_codes.ctypes.data, len(ref_codes), q_codes.ctypes.data,
        len(q_codes), quals.ctypes.data, bw, gapd, gape))


def indel_sites_native(inp, codes: np.ndarray, ref_codes: np.ndarray,
                       cand: np.ndarray, ins_cap: np.ndarray,
                       threads: int):
    """genotype/indel.py's per-site realignment over the candidate
    positions ``cand`` in one call on ``threads`` host threads
    (pt_indel_sites).  ``inp`` is the IndelInput, ``codes`` its seq blob as
    0..4 codes, ``ref_codes`` the reference as 0..3 / 4 (N) / 5 (other),
    ``ins_cap[i]`` a bound on the insertion consensus bases of site i.
    Returns (jobs, dict of per-site arrays: status, n_types, types [nc, 64],
    n_slots, slot_types [nc, 4], ins_at [nc, 64], ins_codes, n_entries,
    e_q, e_s, e_b [nc, 250]), or None without the library."""
    lib = get_lib()
    if lib is None:
        return None
    nk, nc = len(inp.rs), len(cand)
    i64 = [np.ascontiguousarray(a, dtype=np.int64) for a in (
        inp.rs, inp.ops, inp.lns, inp.opoff, inp.quals, inp.soff, inp.mapq,
        cand)]
    rs, ops, lns, opoff, quals, soff, mapq, cand = i64
    codes = np.ascontiguousarray(codes, dtype=np.uint8)
    rev = np.ascontiguousarray(inp.rev, dtype=np.int8)
    ref_codes = np.ascontiguousarray(ref_codes, dtype=np.uint8)
    if not (len(ops) == len(lns) == opoff[-1] and len(opoff) == nk + 1
            and len(soff) == nk + 1 and len(codes) == len(quals)
            and len(mapq) == len(rev) == nk):
        raise ValueError("indel_sites_native: inconsistent IndelInput")
    ins_off = np.zeros(nc + 1, dtype=np.int64)
    np.cumsum(ins_cap, out=ins_off[1:])
    out = dict(
        status=np.empty(nc, np.int8), n_types=np.zeros(nc, np.int32),
        types=np.zeros((nc, 64), np.int32), n_slots=np.zeros(nc, np.int32),
        slot_types=np.zeros((nc, 4), np.int32),
        ins_at=np.zeros((nc, 64), np.int64),
        ins_codes=np.zeros(int(ins_off[-1]), np.uint8),
        n_entries=np.zeros(nc, np.int32), e_q=np.zeros((nc, 250), np.uint8),
        e_s=np.zeros((nc, 250), np.uint8), e_b=np.zeros((nc, 250), np.uint8))
    jobs = lib.pt_indel_sites(
        rs.ctypes.data, ops.ctypes.data, lns.ctypes.data, opoff.ctypes.data,
        nk, codes.ctypes.data, quals.ctypes.data, soff.ctypes.data,
        len(codes), mapq.ctypes.data, rev.ctypes.data, ref_codes.ctypes.data,
        len(ref_codes), cand.ctypes.data, nc, ins_off.ctypes.data,
        int(threads), *(out[k].ctypes.data for k in (
            "status", "n_types", "types", "n_slots", "slot_types", "ins_at",
            "ins_codes", "n_entries", "e_q", "e_s", "e_b")))
    if (out["status"] < 0).any():
        raise RuntimeError("pt_indel_sites: insertion capacity short")
    return int(jobs), out


def chain_dp_native(q: np.ndarray, r: np.ndarray, k: int, max_gap: int,
                    min_cnt: int, min_sc: float, h: int, pen: np.ndarray):
    """align/longread.py::chain_dp's DP and backtrack over one strand's
    anchors ``q``, ``r`` (int64, sorted by (r, q)) in one call
    (pt_chain_dp); ``pen[d]`` is the gap penalty of a diagonal change d,
    max_gap entries.  Returns (best score, the best chain's anchors
    ascending, [(score, anchors ascending)] of the chains kept), anchors as
    positions into q; None without the library."""
    lib = get_lib()
    if lib is None:
        return None
    n = len(q)
    q = np.ascontiguousarray(q, dtype=np.int64)
    r = np.ascontiguousarray(r, dtype=np.int64)
    pen = np.ascontiguousarray(pen, dtype=np.float64)
    if len(r) != n or len(pen) != max_gap:
        raise ValueError("chain_dp_native: q, r or pen of the wrong length")
    f_best = ctypes.c_double()
    n_best = ctypes.c_int64()
    best = np.empty(n, np.int64)
    sc = np.empty(n, np.float64)
    off = np.empty(n + 1, np.int64)
    ids = np.empty(n, np.int64)
    nc = lib.pt_chain_dp(
        q.ctypes.data, r.ctypes.data, n, k, max_gap, h, min_cnt,
        float(min_sc), pen.ctypes.data, ctypes.byref(f_best),
        best.ctypes.data, ctypes.byref(n_best), sc.ctypes.data,
        off.ctypes.data, ids.ctypes.data)
    chains = [(s, ids[off[c]:off[c + 1]])
              for c, s in enumerate(sc[:nc].tolist())]
    return f_best.value, best[:n_best.value], chains


def rolling_syncmers_native(b: np.ndarray, k: int, s: int, t: int,
                            open_: bool):
    """Native twin of sketch.cpu.rolling_syncmers; returns None if the
    library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    n = len(b)
    m = n - k + 1
    if m <= 0:
        z = np.empty(0, np.uint64)
        return z, np.empty(0, bool), np.empty(0, bool)
    b = np.ascontiguousarray(b)
    hashes = np.empty(m, dtype=np.uint64)
    is_rev = np.empty(m, dtype=np.uint8)
    is_sync = np.empty(m, dtype=np.uint8)
    lib.pt_rolling_syncmers(
        b.ctypes.data, n, k, s, t, int(open_),
        hashes.ctypes.data, is_rev.ctypes.data, is_sync.ctypes.data)
    return hashes, is_rev.astype(bool), is_sync.astype(bool)


def meta_kminmers_native(c_pos, c_hash, c_rev, t0s, t1s, nz, k, l):
    """Positioned k-min-mer recombination over affected ranges (the meta
    builder's splice loop); returns (pos i64, hash u64, rev bool, end i64)
    or None."""
    lib = get_lib()
    if lib is None or not hasattr(lib, "pt_meta_kminmers"):
        return None
    if not hasattr(lib, "_mk_ready"):
        lib.pt_meta_kminmers.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p]
        lib.pt_meta_kminmers.restype = ctypes.c_int64
        lib._mk_ready = True
    c_pos = _cbuf(c_pos, np.int64)
    c_hash = _cbuf(c_hash, np.uint64)
    c_rev = _cbuf(c_rev, np.uint8)
    t0s = _cbuf(t0s, np.int64)
    t1s = _cbuf(t1s, np.int64)
    nz = _cbuf(nz, np.int64)
    # capacity: total window-span of the ranges (valid rows <= spans)
    if len(t0s):
        w0 = np.searchsorted(c_pos, t0s, side="left")
        w1 = np.minimum(np.searchsorted(c_pos, t1s, side="right") - 1,
                        max(len(c_pos) - l, 0))
        cap = int(np.maximum(w1 - w0 + 1, 0).sum())
    else:
        cap = 0
    op = np.empty(max(cap, 1), np.int64)
    oh = np.empty(max(cap, 1), np.uint64)
    orv = np.empty(max(cap, 1), np.uint8)
    oe = np.empty(max(cap, 1), np.int64)
    n = lib.pt_meta_kminmers(
        c_pos.ctypes.data, c_hash.ctypes.data, c_rev.ctypes.data,
        len(c_pos), t0s.ctypes.data, t1s.ctypes.data, len(t0s),
        nz.ctypes.data, len(nz), int(k), int(l),
        op.ctypes.data, oh.ctypes.data, orv.ctypes.data, oe.ctypes.data)
    return (op[:n].copy(), oh[:n].copy(), orv[:n].astype(bool),
            oe[:n].copy())


def pack_nibbles_native(seq_blob, seq_off, lut, out, dst_off) -> bool:
    """BAM 4-bit base packing straight into the record stream; False when
    the native library is unavailable (callers run the numpy oracle)."""
    lib = get_lib()
    if lib is None or not hasattr(lib, "pt_pack_nibbles"):
        return False
    if not hasattr(lib, "_pn_ready"):
        lib.pt_pack_nibbles.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
        lib._pn_ready = True
    seq_blob = _cbuf(seq_blob, np.uint8)
    seq_off = _cbuf(seq_off, np.int64)
    lut = _cbuf(lut, np.uint8)
    dst_off = _cbuf(dst_off, np.int64)
    lib.pt_pack_nibbles(seq_blob.ctypes.data, seq_off.ctypes.data,
                        len(seq_off) - 1, lut.ctypes.data, out.ctypes.data,
                        dst_off.ctypes.data)
    return True


def pair_overlap_match_native(flat_p, aqi, bounds, mi, mj, a_read):
    """Native mate-overlap matcher: per proper pair, two-pointer merge of
    the mates' flat pileup entry ranges; returns (ix, iy) qual indices of
    entries at common ref positions ('a' mate first), or None."""
    lib = get_lib()
    if lib is None or not hasattr(lib, "pt_pair_overlap_match"):
        return None
    if not hasattr(lib, "_pom_ready"):
        lib.pt_pair_overlap_match.argtypes = [ctypes.c_void_p] * 5 + [
            ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p]
        lib.pt_pair_overlap_match.restype = ctypes.c_int64
        lib._pom_ready = True
    flat_p = _cbuf(flat_p, np.int64)
    aqi = _cbuf(aqi, np.int64)
    bounds = _cbuf(bounds, np.int64)
    mi = _cbuf(mi, np.int64)
    mj = _cbuf(mj, np.int64)
    a_read = _cbuf(a_read, np.uint8)
    lens = bounds[1:] - bounds[:-1]
    cap = int(np.minimum(lens[mi], lens[mj]).sum()) if len(mi) else 0
    ix = np.empty(max(cap, 1), np.int64)
    iy = np.empty(max(cap, 1), np.int64)
    pr = np.empty(max(cap, 1), np.int64)
    n = lib.pt_pair_overlap_match(
        flat_p.ctypes.data, aqi.ctypes.data, bounds.ctypes.data,
        mi.ctypes.data, mj.ctypes.data, len(mi), a_read.ctypes.data,
        ix.ctypes.data, iy.ctypes.data, pr.ctypes.data)
    return ix[:n], iy[:n], pr[:n]


def rolling_syncmers_multi_native(seq, begs, ends, k, s, t, open_):
    """Multi-range twin of rolling_syncmers_native: scans seq[beg:end+1] for
    each range, results concatenated; returns (hashes, is_rev u8, is_sync
    u8, out_off i64[R+1]) or None.  Range r's windows live at
    [out_off[r], out_off[r] + max(end-beg+2-k, 0))."""
    lib = get_lib()
    if lib is None or not hasattr(lib, "pt_rolling_syncmers_multi"):
        return None
    if not hasattr(lib, "_rsm_ready"):
        lib.pt_rolling_syncmers_multi.argtypes = [
            ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p]
        lib._rsm_ready = True
    seq = _cbuf(seq, np.uint8)
    begs = _cbuf(begs, np.int64)
    ends = _cbuf(ends, np.int64)
    m = np.maximum(ends - begs + 2 - k, 0)
    off = np.zeros(len(begs) + 1, np.int64)
    np.cumsum(m, out=off[1:])
    total = int(off[-1])
    hashes = np.empty(max(total, 1), np.uint64)
    is_rev = np.empty(max(total, 1), np.uint8)
    is_sync = np.empty(max(total, 1), np.uint8)
    lib.pt_rolling_syncmers_multi(
        seq.ctypes.data, len(seq), begs.ctypes.data, ends.ctypes.data,
        len(begs), k, s, t, int(open_), off.ctypes.data,
        hashes.ctypes.data, is_rev.ctypes.data, is_sync.ctypes.data)
    return hashes[:total], is_rev[:total], is_sync[:total], off


def encode_reads_native(seqs: list, pad_to: int):
    """Native twin of the encode loop in sketch.tpu.encode_reads_batch;
    returns None if the library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    buf, offsets, lens = join_reads(seqs)
    out = np.empty((len(seqs), pad_to), dtype=np.uint8)
    lib.pt_encode_reads(buf.ctypes.data, offsets.ctypes.data, len(seqs),
                        pad_to, out.ctypes.data)
    return out, np.minimum(lens, pad_to).astype(np.int32)


_min_sr_lock = threading.Lock()


def min_sr_native(seqs: list, k: int, w: int, threads: int = 0):
    """Phase 1 of align_sr_native: per-read minimizer triples, reference-
    independent.  Returns a dict (joined byte buffer + offsets + worst-case
    CSR of (pos, hash, strand) triples) to pass as align_sr_native(pre=...),
    or None without the library.  Running this while the placement device
    program is in flight hides the alignment's read-scan cost entirely."""
    lib = get_lib()
    if lib is None or not hasattr(lib, "pt_min_sr"):
        return None
    if threads <= 0:
        threads = min(os.cpu_count() or 1, 16)
    buf, offsets, lens = join_reads(seqs)
    n = len(seqs)
    m = np.maximum(lens - k + 1, 0)
    wc_off = np.concatenate(([0], np.cumsum(m)))
    cap = int(wc_off[-1])
    cnt = np.zeros(n, dtype=np.int32)
    # worst-case triple buffers are large (~13 B per query position); fresh
    # allocations would page-fault the whole extent on every call, so reuse a
    # grow-only scratch.  The scratch and _gen counter are guarded by a lock:
    # a pre handle is valid only until the NEXT min_sr_native call (consumers
    # check gen), and concurrent producers must not interleave their triple
    # writes.  One batch in flight at a time is the supported pattern.
    with _min_sr_lock:
        sc = getattr(min_sr_native, "_scratch", None)
        if sc is None or len(sc[0]) < cap:
            sc = (np.empty(cap, dtype=np.int32),
                  np.empty(cap, dtype=np.uint64),
                  np.empty(cap, dtype=np.uint8))
            min_sr_native._scratch = sc
        pos, hsh, strand = sc
        lib.pt_min_sr(buf.ctypes.data, offsets.ctypes.data, n, k, w, threads,
                      wc_off.ctypes.data, cnt.ctypes.data, pos.ctypes.data,
                      hsh.ctypes.data, strand.ctypes.data)
        gen = min_sr_native._gen = getattr(min_sr_native, "_gen", 0) + 1
    return {"buf": buf, "offsets": offsets, "lens": lens, "k": k, "w": w,
            "wc_off": wc_off, "cnt": cnt, "pos": pos, "hash": hsh,
            "strand": strand, "gen": gen}


def align_sr_native(seqs: list, ref_codes: np.ndarray, idx_h: np.ndarray,
                    idx_pos: np.ndarray, idx_strand: np.ndarray, k: int,
                    w: int, threads: int = 0, cigar_cap: int = 64,
                    defer_dp: bool = False, pre: dict | None = None):
    """Native twin of align/batch.py::BatchAligner.align_batch.  Returns a
    dict of per-read arrays (mapped 0/1/2, rev, rs, re, qs, qe oriented,
    score, mapq, nm, ncig, cig u32[n,cap]) or None without the library.
    mapped==2 marks cigar-capacity overflow: realign those reads with the
    Python oracle path.  With defer_dp, mapped==3 marks reads whose
    full-window banded DP was deferred for the device (Pallas) scoring
    stage; their fields carry rs/re = window [lo,hi), score = cluster
    votes, nm = second-best votes, rev = rel strand."""
    lib = get_lib()
    if lib is None:
        return None
    if threads <= 0:
        threads = min(os.cpu_count() or 1, 16)
    buf, offsets, lens = join_reads(seqs)
    # the pre handle must be bound to THIS batch, not just one of matching
    # shape: identity of the joined buffer (ReadBatch caches it, so the same
    # batch yields the same object) or byte-equality for plain lists
    if pre is not None and pre["k"] == k and pre["w"] == w \
            and len(pre["lens"]) == len(seqs) \
            and pre["gen"] == getattr(min_sr_native, "_gen", 0) \
            and (pre["buf"] is buf
                 or (len(pre["buf"]) == len(buf)
                     and np.array_equal(pre["offsets"], offsets)
                     and np.array_equal(pre["buf"], buf))):
        buf, offsets, lens = pre["buf"], pre["offsets"], pre["lens"]
    else:
        pre = None
    n = len(seqs)
    ref_codes = np.ascontiguousarray(ref_codes, dtype=np.uint8)
    idx_h = np.ascontiguousarray(idx_h, dtype=np.uint64)
    idx_pos = np.ascontiguousarray(idx_pos, dtype=np.int32)
    idx_strand = np.ascontiguousarray(idx_strand, dtype=np.uint8)
    out = {
        "mapped": np.zeros(n, dtype=np.uint8),
        "rev": np.zeros(n, dtype=np.uint8),
        "rs": np.zeros(n, dtype=np.int32),
        "re": np.zeros(n, dtype=np.int32),
        "qs": np.zeros(n, dtype=np.int32),
        "qe": np.zeros(n, dtype=np.int32),
        "score": np.zeros(n, dtype=np.int32),
        "mapq": np.zeros(n, dtype=np.int32),
        "nm": np.zeros(n, dtype=np.int32),
        "ncig": np.zeros(n, dtype=np.int32),
        "cig": np.zeros((n, cigar_cap), dtype=np.uint32),
    }
    lib.pt_align_sr(
        buf.ctypes.data, offsets.ctypes.data, n, ref_codes.ctypes.data,
        len(ref_codes), idx_h.ctypes.data, idx_pos.ctypes.data,
        idx_strand.ctypes.data, len(idx_h), k, w, threads, cigar_cap,
        out["mapped"].ctypes.data, out["rev"].ctypes.data,
        out["rs"].ctypes.data, out["re"].ctypes.data, out["qs"].ctypes.data,
        out["qe"].ctypes.data, out["score"].ctypes.data,
        out["mapq"].ctypes.data, out["nm"].ctypes.data,
        out["ncig"].ctypes.data, out["cig"].ctypes.data, int(defer_dp),
        pre["wc_off"].ctypes.data if pre is not None else None,
        pre["cnt"].ctypes.data if pre is not None else None,
        pre["pos"].ctypes.data if pre is not None else None,
        pre["hash"].ctypes.data if pre is not None else None,
        pre["strand"].ctypes.data if pre is not None else None)
    out["lens"] = lens
    # retained so align_sr_rows_native can realign deferred rows without
    # re-joining the read batch (the buffers back the arrays above)
    out["_buf"] = buf
    out["_offsets"] = offsets
    out["_ref"] = (ref_codes, idx_h, idx_pos, idx_strand, k, w)
    out["_pre"] = pre
    return out


def align_sr_rows_native(res: dict, rows, threads: int = 0,
                         cigar_cap: int = 64):
    """Realign a subset of reads (deferred mapped==3 rows) natively with the
    full banded DP enabled, writing results in place into ``res``'s arrays.
    One library call replaces the per-row python DP loop.  Returns True, or
    None when the library/entry point is unavailable (caller falls back)."""
    lib = get_lib()
    if lib is None or not hasattr(lib, "pt_align_sr_rows"):
        return None
    if "_buf" not in res:
        return None
    if threads <= 0:
        threads = min(os.cpu_count() or 1, 16)
    rows64 = np.ascontiguousarray(rows, dtype=np.int64)
    buf, offsets = res["_buf"], res["_offsets"]
    ref_codes, idx_h, idx_pos, idx_strand, k, w = res["_ref"]
    pre = res.get("_pre")
    if pre is not None and pre["gen"] != getattr(min_sr_native, "_gen", 0):
        pre = None  # the grow-only triple scratch was reused since
    n = len(res["mapped"])
    lib.pt_align_sr_rows(
        buf.ctypes.data, offsets.ctypes.data, n,
        rows64.ctypes.data, len(rows64), ref_codes.ctypes.data,
        len(ref_codes), idx_h.ctypes.data, idx_pos.ctypes.data,
        idx_strand.ctypes.data, len(idx_h), k, w, threads, cigar_cap,
        res["mapped"].ctypes.data, res["rev"].ctypes.data,
        res["rs"].ctypes.data, res["re"].ctypes.data, res["qs"].ctypes.data,
        res["qe"].ctypes.data, res["score"].ctypes.data,
        res["mapq"].ctypes.data, res["nm"].ctypes.data,
        res["ncig"].ctypes.data, res["cig"].ctypes.data,
        pre["wc_off"].ctypes.data if pre is not None else None,
        pre["cnt"].ctypes.data if pre is not None else None,
        pre["pos"].ctypes.data if pre is not None else None,
        pre["hash"].ctypes.data if pre is not None else None,
        pre["strand"].ctypes.data if pre is not None else None)
    return True


def copy_rows_native(blob: np.ndarray, src_off: np.ndarray,
                     dst_off: np.ndarray, lens: np.ndarray,
                     out: np.ndarray) -> bool:
    """Ragged row copy out[dst:dst+len] = blob[src:src+len] (bytes).  Returns
    False without the library (caller uses the numpy gather)."""
    lib = get_lib()
    if lib is None or not hasattr(lib, "pt_copy_rows"):
        return False
    src_off = np.ascontiguousarray(src_off, dtype=np.int64)
    dst_off = np.ascontiguousarray(dst_off, dtype=np.int64)
    lens = np.ascontiguousarray(lens, dtype=np.int64)
    if out.dtype != np.uint8 or not out.flags.c_contiguous:
        return False  # out is written in place: no silent copies
    blob = np.ascontiguousarray(blob, dtype=np.uint8)
    lib.pt_copy_rows(blob.ctypes.data, src_off.ctypes.data,
                     dst_off.ctypes.data, lens.ctypes.data, len(lens),
                     out.ctypes.data)
    return True


def oriented_blobs_native(joined: np.ndarray, jq: np.ndarray,
                          src_off: np.ndarray, eoff: np.ndarray,
                          rev: np.ndarray, lut: np.ndarray):
    """Per-record oriented seq/qual blobs (rev records reversed, seq through
    ``lut``, quals -33).  Returns (seq_blob, qual_blob) or None."""
    lib = get_lib()
    if lib is None or not hasattr(lib, "pt_oriented_blobs"):
        return None
    src_off = np.ascontiguousarray(src_off, dtype=np.int64)
    eoff = np.ascontiguousarray(eoff, dtype=np.int64)
    rev8 = np.ascontiguousarray(rev, dtype=np.uint8)
    lut = np.ascontiguousarray(lut, dtype=np.uint8)
    total = int(eoff[-1]) if len(eoff) else 0
    seq_blob = np.empty(total, np.uint8)
    qual_blob = np.empty(total, np.uint8)
    lib.pt_oriented_blobs(joined.ctypes.data, jq.ctypes.data,
                          src_off.ctypes.data, eoff.ctypes.data,
                          rev8.ctypes.data, len(rev8), lut.ctypes.data,
                          seq_blob.ctypes.data, qual_blob.ctypes.data)
    return seq_blob, qual_blob


def banded_dp_native(q: np.ndarray, r: np.ndarray, cap: int = 256):
    """Native banded_affine_dp (bit-exact twin of align/core.py's): returns
    (score, qs, qe, rs, re, [(len, op)]) or None without the library / on
    cigar overflow (caller falls back to the numpy DP)."""
    lib = get_lib()
    if lib is None or not hasattr(lib, "pt_dbg_banded"):
        return None
    if not hasattr(lib, "_dbg_ready"):
        lib.pt_dbg_banded.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int]
        lib.pt_dbg_banded.restype = ctypes.c_int
        lib._dbg_ready = True
    q = np.ascontiguousarray(q, dtype=np.uint8)
    r = np.ascontiguousarray(r, dtype=np.uint8)
    out5 = np.zeros(5, dtype=np.int32)
    cig = np.zeros(cap, dtype=np.uint32)
    sc = lib.pt_dbg_banded(q.ctypes.data, len(q), r.ctypes.data, len(r),
                           out5.ctypes.data, cig.ctypes.data, cap)
    if out5[4] < 0:
        return None
    ops = "MIDNSHP=X"
    cigar = [(int(cig[c]) >> 4, ops[int(cig[c]) & 0xF])
             for c in range(int(out5[4]))]
    return (int(sc), int(out5[0]), int(out5[1]), int(out5[2]), int(out5[3]),
            cigar)


def _ensure_kr_types(lib):
    if hasattr(lib, "_kr_ready"):
        return
    lib.pt_count_delta.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    lib.pt_count_delta.restype = ctypes.c_int64
    lib._kr_ready = True


def count_delta_native(ph, pc, ch, cc):
    """Native twin of builder._count_delta (linear merge of two sorted
    count tables); returns (hashes, pcounts i16, ccounts i16) or None."""
    lib = get_lib()
    if lib is None or not hasattr(lib, "pt_count_delta"):
        return None
    _ensure_kr_types(lib)
    ph = np.ascontiguousarray(ph, dtype=np.uint64)
    pc = np.ascontiguousarray(pc, dtype=np.int64)
    ch = np.ascontiguousarray(ch, dtype=np.uint64)
    cc = np.ascontiguousarray(cc, dtype=np.int64)
    cap = len(ph) + len(ch)
    oh = np.empty(max(cap, 1), np.uint64)
    op = np.empty(max(cap, 1), np.int16)
    oc = np.empty(max(cap, 1), np.int16)
    n = lib.pt_count_delta(ph.ctypes.data, pc.ctypes.data, len(ph),
                           ch.ctypes.data, cc.ctypes.data, len(ch),
                           oh.ctypes.data, op.ctypes.data, oc.ctypes.data)
    return oh[:n].copy(), op[:n].copy(), oc[:n].copy()


def _cbuf(a, dt):
    """Zero-copy when already (dt, contiguous); bools pass as their u8
    bytes.  These wrappers run per DFS node — copies here were measurable."""
    if a.dtype == np.bool_ and dt == np.uint8:
        a = a.view(np.uint8)
    if a.dtype == dt and a.flags.c_contiguous:
        return a
    return np.ascontiguousarray(a, dtype=dt)


def incr_count_delta_native(p_pos, p_hash, p_rev, keep, add_pos,
                            c_pos, c_hash, c_rev, k, l):
    """Native twin of the builder's incremental counts-mode node delta
    (_change_sites + _merged_affected_intervals + _affected_window_counts
    netted); returns (hashes u64 sorted, deltas i32) or None."""
    lib = get_lib()
    if lib is None or not hasattr(lib, "pt_incr_count_delta"):
        return None
    if not hasattr(lib, "_icd_ready"):
        lib.pt_incr_count_delta.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int64, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64]
        lib.pt_incr_count_delta.restype = ctypes.c_int64
        lib._icd_ready = True
    p_pos = _cbuf(p_pos, np.int64)
    p_hash = _cbuf(p_hash, np.uint64)
    p_rev = _cbuf(p_rev, np.uint8)
    keep = _cbuf(keep, np.uint8)
    add_pos = _cbuf(add_pos, np.int64)
    c_pos = _cbuf(c_pos, np.int64)
    c_hash = _cbuf(c_hash, np.uint64)
    c_rev = _cbuf(c_rev, np.uint8)
    n_changed = int(len(p_pos) - int(keep.sum()) + len(add_pos))
    need = 2 * l * max(n_changed, 1) + 64
    scr = getattr(incr_count_delta_native, "_scratch", None)
    if scr is None or len(scr[0]) < need:
        scr = (np.empty(max(need, 4096), np.uint64),
               np.empty(max(need, 4096), np.int32))
        incr_count_delta_native._scratch = scr
    while True:
        oh, od = scr
        cap = len(oh)
        n = lib.pt_incr_count_delta(
            p_pos.ctypes.data, p_hash.ctypes.data, p_rev.ctypes.data,
            len(p_pos), keep.ctypes.data,
            c_pos.ctypes.data, c_hash.ctypes.data, c_rev.ctypes.data,
            len(c_pos), add_pos.ctypes.data, len(add_pos),
            int(k), int(l), oh.ctypes.data, od.ctypes.data, cap)
        if n <= cap:
            return oh[:n].copy(), od[:n].copy()
        scr = (np.empty(int(n) + 16, np.uint64), np.empty(int(n) + 16, np.int32))
        incr_count_delta_native._scratch = scr


def bwt_aln_native(fm, fm_rev, seqs: list, fnr: float, threads: int = 0):
    """Threaded native bwa-aln search (pt_bwt_aln — the C++ twin of
    align/bwt.py's best-first FM search, which stays as the bit-exact
    oracle).  ``fm``/``fm_rev`` are align.bwt.FmIndex instances (only their
    bwt/C/sa arrays are consumed; the dense python occ table is never
    built).  Returns a dict of per-read arrays or None without the
    library/entry point."""
    lib = get_lib()
    if lib is None or not hasattr(lib, "pt_bwt_aln"):
        return None
    if not hasattr(lib, "_bwt_ready"):
        lib.pt_bwt_aln.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # fwd
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,   # rev, n
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,   # reads CSR
            ctypes.c_double, ctypes.c_int] + [ctypes.c_void_p] * 10
        lib._bwt_ready = True
    if threads <= 0:
        threads = min(os.cpu_count() or 1, 16)
    buf, offsets, _lens = join_reads(seqs)
    n = len(seqs)
    bwt_f = np.ascontiguousarray(fm.bwt, dtype=np.uint8)
    bwt_r = np.ascontiguousarray(fm_rev.bwt, dtype=np.uint8)
    C_f = np.ascontiguousarray(fm.C, dtype=np.int64)
    C_r = np.ascontiguousarray(fm_rev.C, dtype=np.int64)
    sa_f = np.ascontiguousarray(fm.sa, dtype=np.int32)
    out = {
        "mapped": np.zeros(n, np.uint8), "rev": np.zeros(n, np.uint8),
        "pos": np.zeros(n, np.int64), "nmm": np.zeros(n, np.int32),
        "ngapo": np.zeros(n, np.int32), "ngape": np.zeros(n, np.int32),
        "nins": np.zeros(n, np.int32), "ndel": np.zeros(n, np.int32),
        "score": np.zeros(n, np.int32), "mapq": np.zeros(n, np.int32),
    }
    lib.pt_bwt_aln(
        bwt_f.ctypes.data, C_f.ctypes.data, sa_f.ctypes.data,
        bwt_r.ctypes.data, C_r.ctypes.data, int(fm.n),
        buf.ctypes.data, offsets.ctypes.data, n, float(fnr), int(threads),
        out["mapped"].ctypes.data, out["rev"].ctypes.data,
        out["pos"].ctypes.data, out["nmm"].ctypes.data,
        out["ngapo"].ctypes.data, out["ngape"].ctypes.data,
        out["nins"].ctypes.data, out["ndel"].ctypes.data,
        out["score"].ctypes.data, out["mapq"].ctypes.data)
    return out


def tree_accumulate_native(deltas_f: list, deltas_i: list, offs: np.ndarray,
                           parent: np.ndarray):
    """Native twin of score_nodes' per-node accumulation loop (bit-exact
    sequential f64 adds).  Returns (acc_f [N,5], acc_i [N,2]) or None."""
    lib = get_lib()
    if lib is None:
        return None
    if not hasattr(lib, "_ta_ready"):
        lib.pt_tree_accumulate.argtypes = [ctypes.c_void_p] * 7 + [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_void_p]
        lib._ta_ready = True
    d = [np.ascontiguousarray(x, dtype=np.float64) for x in deltas_f]
    di = [np.ascontiguousarray(x, dtype=np.int64) for x in deltas_i]
    offs = np.ascontiguousarray(offs, dtype=np.uint64)
    parent = np.ascontiguousarray(parent, dtype=np.uint32)
    n = len(offs) - 1
    acc_f = np.empty((n, 5), dtype=np.float64)
    acc_i = np.empty((n, 2), dtype=np.int64)
    lib.pt_tree_accumulate(
        d[0].ctypes.data, d[1].ctypes.data, d[2].ctypes.data,
        d[3].ctypes.data, d[4].ctypes.data, di[0].ctypes.data,
        di[1].ctypes.data, offs.ctypes.data, parent.ctypes.data, n,
        acc_f.ctypes.data, acc_i.ctypes.data)
    return acc_f, acc_i


def score_pseudo_native(midx, read_off, read_hash, read_rev, read_qbeg,
                        read_qend, relevant, candidates, maximum_gap=50,
                        threads=0):
    """Native twin of meta/engine.py::MetaScorer.score_all_pseudo (without
    node-score collection).  Returns (max_score i32[R], snap u16[C, R]) or
    None if the library is unavailable."""
    lib = get_lib()
    if lib is None or getattr(lib, "pt_score_pseudo", None) is None:
        return None
    if threads <= 0:
        threads = min(os.cpu_count() or 1, 16)
    n_reads = len(read_off) - 1
    node_offsets = np.ascontiguousarray(midx.node_offsets, dtype=np.int64)
    parent = np.ascontiguousarray(midx.parent_index, dtype=np.uint32)
    delta_seed = np.ascontiguousarray(midx.delta_seed, dtype=np.int32)
    delta_is_del = np.ascontiguousarray(midx.delta_is_del, dtype=np.uint8)
    seed_hash = np.ascontiguousarray(midx.seed_hash, dtype=np.uint64)
    seed_rev = np.ascontiguousarray(midx.seed_rev, dtype=np.uint8)
    seed_pos = np.ascontiguousarray(midx.seed_pos, dtype=np.int64)
    seed_end = np.ascontiguousarray(midx.seed_end, dtype=np.int64)
    gev_offsets = np.ascontiguousarray(midx.gev_offsets, dtype=np.int64)
    gev_pos = np.ascontiguousarray(midx.gev_pos, dtype=np.int64)
    gev_nongap = np.ascontiguousarray(midx.gev_nongap, dtype=np.uint8)
    bev_offsets = np.ascontiguousarray(midx.bev_offsets, dtype=np.int64)
    bev_block = np.ascontiguousarray(midx.bev_block, dtype=np.int32)
    bev_code = np.ascontiguousarray(midx.bev_code, dtype=np.int8)
    block_lo = np.ascontiguousarray(midx.block_lo, dtype=np.int64)
    block_hi = np.ascontiguousarray(midx.block_hi, dtype=np.int64)
    nongap0 = np.ascontiguousarray(midx.nongap0, dtype=np.uint8)
    read_off = np.ascontiguousarray(read_off, dtype=np.int64)
    read_hash = np.ascontiguousarray(read_hash, dtype=np.uint64)
    read_rev = np.ascontiguousarray(read_rev, dtype=np.uint8)
    read_qbeg = np.ascontiguousarray(read_qbeg, dtype=np.int64)
    read_qend = np.ascontiguousarray(read_qend, dtype=np.int64)
    relevant = np.ascontiguousarray(relevant, dtype=np.uint8)
    cand = np.ascontiguousarray(candidates, dtype=np.int32)
    max_score = np.zeros(n_reads, dtype=np.int32)
    snap = np.zeros((len(cand), n_reads), dtype=np.uint16)
    lib.pt_score_pseudo(
        node_offsets.ctypes.data, len(midx.node_ids), parent.ctypes.data,
        delta_seed.ctypes.data, delta_is_del.ctypes.data,
        seed_hash.ctypes.data, seed_rev.ctypes.data, seed_pos.ctypes.data,
        seed_end.ctypes.data, gev_offsets.ctypes.data, gev_pos.ctypes.data,
        gev_nongap.ctypes.data, bev_offsets.ctypes.data,
        bev_block.ctypes.data, bev_code.ctypes.data, block_lo.ctypes.data,
        block_hi.ctypes.data, len(block_lo), nongap0.ctypes.data,
        int(midx.n_scalar), read_off.ctypes.data, read_hash.ctypes.data,
        read_rev.ctypes.data, read_qbeg.ctypes.data, read_qend.ctypes.data,
        n_reads, relevant.ctypes.data, cand.ctypes.data, len(cand),
        int(maximum_gap), int(threads),
        max_score.ctypes.data, snap.ctypes.data)
    return max_score, snap


def score_simple_native(midx, read_off, read_hash, read_rev, relevant,
                        candidates, emit_node_scores=False, threads=0):
    """Native twin of meta/engine.py::MetaScorer.score_all.  Returns
    (max_score i32[R], snap u16[C, R], node_scores|None) or None if the
    library is unavailable."""
    lib = get_lib()
    if lib is None or getattr(lib, "pt_score_simple", None) is None:
        return None
    n_reads = len(read_off) - 1
    node_offsets = np.ascontiguousarray(midx.node_offsets, dtype=np.int64)
    parent = np.ascontiguousarray(midx.parent_index, dtype=np.uint32)
    delta_seed = np.ascontiguousarray(midx.delta_seed, dtype=np.int32)
    delta_is_del = np.ascontiguousarray(midx.delta_is_del, dtype=np.uint8)
    seed_hash = np.ascontiguousarray(midx.seed_hash, dtype=np.uint64)
    seed_rev = np.ascontiguousarray(midx.seed_rev, dtype=np.uint8)
    read_off = np.ascontiguousarray(read_off, dtype=np.int64)
    read_hash = np.ascontiguousarray(read_hash, dtype=np.uint64)
    read_rev = np.ascontiguousarray(read_rev, dtype=np.uint8)
    relevant = np.ascontiguousarray(relevant, dtype=np.uint8)
    cand = np.ascontiguousarray(candidates, dtype=np.int32)
    if threads <= 0:
        threads = min(os.cpu_count() or 1, 16)
    max_score = np.zeros(n_reads, dtype=np.int32)
    snap = np.zeros((len(cand), n_reads), dtype=np.uint16)
    cap = (1 << 20) if emit_node_scores else 1
    for _ in range(8):
        ev_node = np.empty(cap, dtype=np.int32)
        ev_read = np.empty(cap, dtype=np.int32)
        ev_score = np.empty(cap, dtype=np.int32)
        n_ev = lib.pt_score_simple(
            node_offsets.ctypes.data, len(midx.node_ids), parent.ctypes.data,
            delta_seed.ctypes.data, delta_is_del.ctypes.data,
            seed_hash.ctypes.data, seed_rev.ctypes.data,
            read_off.ctypes.data, read_hash.ctypes.data, read_rev.ctypes.data,
            n_reads, relevant.ctypes.data, cand.ctypes.data, len(cand),
            int(emit_node_scores), int(threads),
            max_score.ctypes.data, snap.ctypes.data,
            ev_node.ctypes.data, ev_read.ctypes.data, ev_score.ctypes.data,
            cap)
        if n_ev >= 0:
            if not emit_node_scores:
                return max_score, snap, None
            node_scores: dict = {}
            bounds = np.flatnonzero(np.diff(ev_node[:n_ev])) + 1
            starts = np.concatenate(([0], bounds, [n_ev]))
            for si in range(len(starts) - 1):
                a, b = int(starts[si]), int(starts[si + 1])
                if a == b:
                    continue
                node_scores[int(ev_node[a])] = list(
                    zip(ev_read[a:b].tolist(), ev_score[a:b].tolist()))
            return max_score, snap, node_scores
        cap *= 8
    return None
