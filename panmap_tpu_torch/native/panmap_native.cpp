// Native host-side kernels for panmap_tpu.
//
// The TPU owns the batched compute path (sketching queries, scoring,
// alignment DP); these C++ kernels cover the HOST hot loops that feed it —
// the index builder's per-window syncmer recomputation and read-table
// encoding — mirroring the roles the reference implements natively
// (src/seeding.cpp:47-229 rollingSyncmers, src/index_single_mode.cpp DFS).
//
// Contracts are bit-exact twins of sketch/cpu.py (tests/test_native.py
// cross-checks against the numpy implementations).
//
// Build: bash panmap_tpu/native/build.sh   (g++ -O3 -march=native -shared)

#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

// per-base hash constants (sketch/cpu.py:33-37; reference seeding.hpp:100-112)
constexpr uint64_t HASH_A = 0x3C8BFBB395C60474ULL;
constexpr uint64_t HASH_C = 0x3193C18562A02B4CULL;
constexpr uint64_t HASH_G = 0x20323ED082572324ULL;
constexpr uint64_t HASH_T = 0x295549F54BE24456ULL;
constexpr uint64_t U64MAX = ~0ULL;

inline uint64_t rol(uint64_t h, int r) {
    r &= 63;
    return r ? (h << r) | (h >> (64 - r)) : h;
}

struct Tables {
    uint64_t chash[256] = {0};
    uint64_t chash_comp[256] = {0};
    Tables() {
        auto set = [&](char c, uint64_t v, uint64_t vc) {
            chash[(uint8_t)c] = v;
            chash[(uint8_t)(c + 32)] = v;  // lowercase
            chash_comp[(uint8_t)c] = vc;
            chash_comp[(uint8_t)(c + 32)] = vc;
        };
        set('A', HASH_A, HASH_T);
        set('C', HASH_C, HASH_G);
        set('G', HASH_G, HASH_C);
        set('T', HASH_T, HASH_A);
    }
};
const Tables T;

// branchless variable rotates (lane-independent, so loops over these
// vectorize to vprolvq/vprorvq under -march=native on avx512)
inline uint64_t rolv(uint64_t x, uint64_t r) {
    unsigned rr = (unsigned)r & 63u;
    return (x << rr) | (x >> ((64u - rr) & 63u));
}
inline uint64_t rorv(uint64_t x, uint64_t r) {
    unsigned rr = (unsigned)r & 63u;
    return (x >> rr) | (x << ((64u - rr) & 63u));
}

// Window hashing in prefix-XOR form (sketch/cpu.py _window_hashes semantics):
//   F_i = XOR_j rol(h[i+j], w-1-j),  R_i = XOR_j rol(hc[i+j], j)
// Rotation is a bit permutation, so it commutes with XOR; substituting
// m = i+j gives
//   F_i = rol(P[i+w] ^ P[i], (w-1+i) & 63)   with P = prefix-XOR of
//                                                  u_m = ror(h[m], m & 63)
//   R_i = ror(Q[i+w] ^ Q[i], i & 63)          with Q = prefix-XOR of
//                                                  v_m = rol(hc[m], m & 63)
// ONE prefix pair serves every window size (the syncmer scan needs both k
// and s), and each output element is independent of its neighbors, so the
// per-window loops vectorize — unlike the serial rolling recurrence.
static void hash_prefixes(const uint64_t* h, const uint64_t* hc, int64_t n,
                          uint64_t* P, uint64_t* Q) {  // P,Q length n+1
    for (int64_t m = 0; m < n; ++m) {  // vectorizable rotate pass
        P[m + 1] = rorv(h[m], (uint64_t)m);
        Q[m + 1] = rolv(hc[m], (uint64_t)m);
    }
    P[0] = 0;
    Q[0] = 0;
    for (int64_t m = 0; m < n; ++m) {  // serial XOR prefix (1 op/elem)
        P[m + 1] ^= P[m];
        Q[m + 1] ^= Q[m];
    }
}

static void window_hashes_pfx(const uint64_t* P, const uint64_t* Q, int64_t n,
                              int w, uint64_t* F, uint64_t* R) {
    int64_t m = n - w + 1;
    for (int64_t i = 0; i < m; ++i)
        F[i] = rolv(P[i + w] ^ P[i], (uint64_t)(w - 1 + i));
    for (int64_t i = 0; i < m; ++i)
        R[i] = rorv(Q[i + w] ^ Q[i], (uint64_t)i);
}

static void window_hashes(const uint64_t* h, const uint64_t* hc, int64_t n,
                          int w, uint64_t* F, uint64_t* R) {
    int64_t m = n - w + 1;
    if (m <= 0) return;
    std::vector<uint64_t> P(n + 1), Q(n + 1);
    hash_prefixes(h, hc, n, P.data(), Q.data());
    window_hashes_pfx(P.data(), Q.data(), n, w, F, R);
}

// sliding minimum over windows of length w (monotonic deque)
static void sliding_min(const uint64_t* x, int64_t n, int w, uint64_t* out) {
    std::vector<int64_t> dq(n);
    int64_t head = 0, tail = 0;  // dq[head..tail)
    for (int64_t i = 0; i < n; ++i) {
        while (tail > head && x[dq[tail - 1]] >= x[i]) --tail;
        dq[tail++] = i;
        if (dq[head] <= i - w) ++head;
        if (i >= w - 1) out[i - w + 1] = x[dq[head]];
    }
}

}  // namespace

extern "C" {

// Binding ABI version: bump whenever an entry point's CONTRACT changes (not
// just when symbols are added — hasattr covers those).  v2: pt_sketch_count
// returns hashes sorted ascending.  get_lib() refuses an old binary it
// cannot rebuild, falling back to the numpy twins instead of silently
// violating a contract.
int64_t pt_abi_version() { return 2; }

// Per-position syncmer scan, twin of sketch/cpu.py::rolling_syncmers.
// hashes/is_rev/is_sync must have n-k+1 elements.
void pt_rolling_syncmers(const uint8_t* seq, int64_t n, int k, int s, int t,
                         int open_, uint64_t* hashes, uint8_t* is_rev,
                         uint8_t* is_sync) {
    int64_t m = n - k + 1;
    if (m <= 0) return;
    std::vector<uint64_t> h(n), hc(n);
    for (int64_t i = 0; i < n; ++i) {
        h[i] = T.chash[seq[i]];
        hc[i] = T.chash_comp[seq[i]];
    }
    int64_t mk = n - k + 1, ms = n - s + 1;
    std::vector<uint64_t> Fk(mk), Rk(mk), Fs(ms), Rs(ms), P(n + 1), Q(n + 1);
    hash_prefixes(h.data(), hc.data(), n, P.data(), Q.data());
    window_hashes_pfx(P.data(), Q.data(), n, k, Fk.data(), Rk.data());
    window_hashes_pfx(P.data(), Q.data(), n, s, Fs.data(), Rs.data());

    int w = k - s + 1;
    std::vector<uint64_t> Fmin(mk), Rmin(mk);
    sliding_min(Fs.data(), ms, w, Fmin.data());
    sliding_min(Rs.data(), ms, w, Rmin.data());

    // prefix counts of ambiguous bases
    std::vector<int32_t> cbad(n + 1, 0);
    for (int64_t i = 0; i < n; ++i) cbad[i + 1] = cbad[i] + (h[i] == 0);

    for (int64_t i = 0; i < m; ++i) {
        bool fwd_sync, rev_sync;
        if (open_) {
            fwd_sync = Fs[i + t] == Fmin[i];
            rev_sync = Rs[i + k - s - t] == Rmin[i];
        } else {
            fwd_sync = (Fs[i + t] == Fmin[i]) || (Fs[i + k - s - t] == Fmin[i]);
            rev_sync = (Rs[i + k - s - t] == Rmin[i]) || (Rs[i + t] == Rmin[i]);
        }
        bool amb = (cbad[i + k] - cbad[i]) > 0;
        bool sync = (fwd_sync || rev_sync) && !amb && (Fk[i] != Rk[i]);
        is_sync[i] = sync;
        is_rev[i] = sync && (Rk[i] < Fk[i]);
        hashes[i] = sync ? (Fk[i] < Rk[i] ? Fk[i] : Rk[i]) : U64MAX;
    }
}

// Batched 2-bit read encoding, twin of sketch/tpu.py::encode_reads_batch's
// host path: joined |reads| buffer -> [B, pad_to] code matrix (4 = pad/N).
void pt_encode_reads(const uint8_t* joined, const int64_t* offsets, int64_t b,
                     int64_t pad_to, uint8_t* out) {
    static uint8_t enc[256];
    static bool init = false;
    if (!init) {
        memset(enc, 4, sizeof(enc));
        enc['A'] = enc['a'] = 0;
        enc['C'] = enc['c'] = 1;
        enc['G'] = enc['g'] = 2;
        enc['T'] = enc['t'] = 3;
        init = true;
    }
    for (int64_t r = 0; r < b; ++r) {
        const uint8_t* src = joined + offsets[r];
        int64_t len = offsets[r + 1] - offsets[r];
        if (len > pad_to) len = pad_to;
        uint8_t* dst = out + r * pad_to;
        int64_t i = 0;
        for (; i < len; ++i) dst[i] = enc[src[i]];
        for (; i < pad_to; ++i) dst[i] = 4;
    }
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Batched read sketch + distinct k-min-mer counting (seedFreqInReads).
//
// Twin of place/engine.py::sketch_reads with dedup_reads=False (counting every
// read is identical to dedup + multiplicity weighting) over sketch/cpu.py's
// syncmer_list + kminmer_hashes semantics (reference: placement.cpp:1611-1684).
// Multithreaded over contiguous read ranges with per-thread open-addressing
// maps merged at the end.  Canonical hash U64MAX (p ~ 2^-64) is reserved as
// the empty sentinel and skipped — matching the device path, which uses the
// all-ones hash as its invalid-slot sentinel.
// ---------------------------------------------------------------------------

namespace {

// LSD radix sort for u64 (8 passes x 8 bits): counting into the arbitrary-
// order hash map was the dominant cost of the read sketch (every add is an
// LLC miss once the table outgrows L2); sort + run-length-count streams
// sequentially instead and yields SORTED distinct hashes, which the caller's
// index join can then consume with a merge scan.
static void radix_sort_u64(std::vector<uint64_t>& v,
                           std::vector<uint64_t>& tmp) {
    size_t n = v.size();
    if (n < 2) return;
    tmp.resize(n);
    uint64_t* a = v.data();
    uint64_t* b = tmp.data();
    // 6 passes x 11 bits (last pass 9): fewer full-array sweeps than 8x8
    constexpr int RADIX_BITS = 11, NPASS = 6;
    constexpr size_t NBUCKET = (size_t)1 << RADIX_BITS;
    std::vector<size_t> hist(NBUCKET);
    for (int pass = 0; pass < NPASS; ++pass) {
        int sh = pass * RADIX_BITS;
        std::fill(hist.begin(), hist.end(), 0);
        for (size_t i = 0; i < n; ++i)
            ++hist[(a[i] >> sh) & (NBUCKET - 1)];
        size_t sum = 0;
        for (size_t x = 0; x < NBUCKET; ++x) {
            size_t c = hist[x];
            hist[x] = sum;
            sum += c;
        }
        for (size_t i = 0; i < n; ++i)
            b[hist[(a[i] >> sh) & (NBUCKET - 1)]++] = a[i];
        std::swap(a, b);
    }
    if (a != v.data()) std::copy(a, a + n, v.data());
}

// scratch buffers reused across reads within one thread
struct SketchScratch {
    std::vector<uint64_t> h, hc, Fk, Rk, Fs, Rs, Fmin, Rmin, H, h2, P, Q;
    std::vector<int32_t> pos;
    std::vector<uint8_t> rev;  // per-syncmer strand (Rk < Fk)
};

// branchless sliding minimum (van Herk/Gil-Werman): per block of w, suffix
// minima within the block and running prefix minima across it; the deque
// variant's data-dependent branches mispredict ~50% on hash data.
static void sliding_min_vh(const uint64_t* x, int64_t n, int w, uint64_t* out,
                           std::vector<uint64_t>& scratch) {
    int64_t m = n - w + 1;
    if (m <= 0) return;
    scratch.resize(n);
    uint64_t* sfx = scratch.data();  // sfx[i] = min x[i .. block_end]
    for (int64_t b = 0; b < n; b += w) {
        int64_t e = b + w < n ? b + w : n;
        uint64_t acc = x[e - 1];
        sfx[e - 1] = acc;
        for (int64_t i = e - 2; i >= b; --i) {
            acc = x[i] < acc ? x[i] : acc;
            sfx[i] = acc;
        }
    }
    uint64_t pfx = U64MAX;
    int cnt = 0;  // j % w, maintained without division
    for (int64_t j = 0; j < n; ++j) {
        // pfx = min x[block_start(j) .. j]
        pfx = (cnt == 0) ? x[j] : (x[j] < pfx ? x[j] : pfx);
        if (++cnt == w) cnt = 0;
        if (j >= w - 1) {
            int64_t i = j - w + 1;
            out[i] = sfx[i] < pfx ? sfx[i] : pfx;
        }
    }
}

// syncmer scan of one read into scratch.H (canonical hashes, in order) and
// scratch.pos (k-mer start positions); same math as pt_rolling_syncmers.
static void scan_read_syncmers(const uint8_t* seq, int64_t nn, int k, int s,
                               int t, int open_, SketchScratch& sc) {
    sc.H.clear();
    sc.pos.clear();
    sc.rev.clear();
    int64_t m = nn - k + 1;
    if (m <= 0) return;
    sc.h.resize(nn);
    sc.hc.resize(nn);
    bool any_amb = false;
    for (int64_t i = 0; i < nn; ++i) {
        sc.h[i] = T.chash[seq[i]];
        sc.hc[i] = T.chash_comp[seq[i]];
        any_amb |= (sc.h[i] == 0);
    }
    int64_t ms = nn - s + 1;
    sc.Fs.resize(ms);
    sc.Rs.resize(ms);
    sc.P.resize(nn + 1);
    sc.Q.resize(nn + 1);
    const uint64_t* P = sc.P.data();
    const uint64_t* Q = sc.Q.data();
    hash_prefixes(sc.h.data(), sc.hc.data(), nn, sc.P.data(), sc.Q.data());
    window_hashes_pfx(P, Q, nn, s, sc.Fs.data(), sc.Rs.data());
    int w = k - s + 1;
    sc.Fmin.resize(m);
    sc.Rmin.resize(m);
    sliding_min_vh(sc.Fs.data(), ms, w, sc.Fmin.data(), sc.h2);
    sliding_min_vh(sc.Rs.data(), ms, w, sc.Rmin.data(), sc.h2);
    int32_t bad_run = 0;  // count of ambiguous bases in the current k-window
    if (any_amb)
        for (int64_t i = 0; i < k - 1 && i < nn; ++i) bad_run += (sc.h[i] == 0);
    for (int64_t i = 0; i < m; ++i) {
        if (any_amb) bad_run += (sc.h[i + k - 1] == 0);
        bool fwd_sync, rev_sync;
        if (open_) {
            fwd_sync = sc.Fs[i + t] == sc.Fmin[i];
            rev_sync = sc.Rs[i + k - s - t] == sc.Rmin[i];
        } else {
            fwd_sync = (sc.Fs[i + t] == sc.Fmin[i]) ||
                       (sc.Fs[i + k - s - t] == sc.Fmin[i]);
            rev_sync = (sc.Rs[i + k - s - t] == sc.Rmin[i]) ||
                       (sc.Rs[i + t] == sc.Rmin[i]);
        }
        if ((fwd_sync || rev_sync) && bad_run == 0) {
            // k-window hashes only at syncmer candidates (~1/6 of positions)
            uint64_t Fk = rolv(P[i + k] ^ P[i], (uint64_t)(k - 1 + i));
            uint64_t Rk = rorv(Q[i + k] ^ Q[i], (uint64_t)i);
            if (Fk != Rk) {
                sc.H.push_back(Fk < Rk ? Fk : Rk);
                sc.pos.push_back((int32_t)i);
                sc.rev.push_back(Rk < Fk);
            }
        }
        if (any_amb) bad_run -= (sc.h[i] == 0);
    }
}

static void sketch_collect_range(const uint8_t* joined, const int64_t* offsets,
                                 int64_t r0, int64_t r1, int k, int s, int t,
                                 int open_, int l, int trim_start,
                                 int trim_end, std::vector<uint64_t>& vals) {
    SketchScratch sc;
    for (int64_t r = r0; r < r1; ++r) {
        const uint8_t* seq = joined + offsets[r];
        int64_t nn = offsets[r + 1] - offsets[r];
        scan_read_syncmers(seq, nn, k, s, t, open_, sc);
        size_t nh = sc.H.size();
        if ((int64_t)nh < (l > 1 ? l : 1)) continue;
        size_t lo_i = 0, hi_i = nh;  // in-range syncmer sub-list [lo_i, hi_i)
        if (trim_start > 0 || trim_end > 0) {
            int32_t lo = trim_start;
            int32_t hi = (int32_t)(nn - trim_end - k);
            while (lo_i < nh && sc.pos[lo_i] < lo) ++lo_i;
            while (hi_i > lo_i && sc.pos[hi_i - 1] > hi) --hi_i;
            if (hi_i == lo_i) continue;
        }
        const uint64_t* H = sc.H.data() + lo_i;
        int64_t mh = (int64_t)(hi_i - lo_i);
        if (l == 1) {
            for (int64_t i = 0; i < mh; ++i)
                if (H[i] != U64MAX) vals.push_back(H[i]);
            continue;
        }
        if (mh < l) continue;
        // l-window combine: F = XOR rol(H[i+w], k*(l-1-w)), R reversed
        // (l is small — direct recompute per window)
        for (int64_t i = 0; i + l <= mh; ++i) {
            uint64_t f = 0, rr = 0;
            for (int w2 = 0; w2 < l; ++w2) {
                int e = (k * (l - 1 - w2)) & 63;
                f ^= rol(H[i + w2], e);
                rr ^= rol(H[i + l - 1 - w2], e);
            }
            if (f != rr) {  // palindromic windows skipped
                uint64_t canon = f < rr ? f : rr;
                if (canon != U64MAX) vals.push_back(canon);
            }
        }
    }
}

}  // namespace

extern "C" {

// Returns the number of distinct k-min-mers written to out_hash/out_count
// (SORTED ascending by hash), or -1 if cap was insufficient (caller retries
// with a larger cap).
int64_t pt_sketch_count(const uint8_t* joined, const int64_t* offsets,
                        int64_t n_reads, int k, int s, int t, int open_, int l,
                        int trim_start, int trim_end, int n_threads,
                        uint64_t* out_hash, uint32_t* out_count, int64_t cap) {
    if (n_threads < 1) n_threads = 1;
    if (n_threads > (int)n_reads) n_threads = n_reads > 0 ? (int)n_reads : 1;
    // per-thread: collect raw canonical hashes, radix sort, run-length count
    std::vector<std::vector<uint64_t>> keys(n_threads);
    std::vector<std::vector<uint32_t>> cnts(n_threads);
    std::vector<std::thread> threads;
    int64_t chunk = (n_reads + n_threads - 1) / n_threads;
    for (int ti = 0; ti < n_threads; ++ti) {
        int64_t r0 = ti * chunk;
        int64_t r1 = r0 + chunk < n_reads ? r0 + chunk : n_reads;
        if (r0 >= r1) continue;
        threads.emplace_back([&, ti, r0, r1]() {
            auto& v = keys[ti];
            v.reserve((size_t)((r1 - r0) * 24));
            sketch_collect_range(joined, offsets, r0, r1, k, s, t, open_, l,
                                 trim_start, trim_end, v);
            std::vector<uint64_t> tmp;
            radix_sort_u64(v, tmp);
            // run-length encode in place: v becomes distinct keys
            auto& c = cnts[ti];
            c.reserve(v.size() / 2 + 16);
            size_t w = 0;
            for (size_t i = 0; i < v.size();) {
                uint64_t h = v[i];
                size_t j = i + 1;
                while (j < v.size() && v[j] == h) ++j;
                v[w] = h;
                c.push_back((uint32_t)(j - i));
                ++w;
                i = j;
            }
            v.resize(w);
        });
    }
    for (auto& th : threads) th.join();
    // k-way merge of the sorted per-thread distinct lists
    std::vector<size_t> pos(n_threads, 0);
    int64_t w = 0;
    for (;;) {
        uint64_t best = U64MAX;
        bool any = false;
        for (int ti = 0; ti < n_threads; ++ti)
            if (pos[ti] < keys[ti].size() && keys[ti][pos[ti]] <= best) {
                best = keys[ti][pos[ti]];
                any = true;
            }
        if (!any) break;
        uint64_t total = 0;
        for (int ti = 0; ti < n_threads; ++ti)
            if (pos[ti] < keys[ti].size() && keys[ti][pos[ti]] == best)
                total += cnts[ti][pos[ti]++];
        if (w >= cap) return -1;
        out_hash[w] = best;
        out_count[w] = (uint32_t)total;
        ++w;
    }
    return w;
}

// Per-read seedmer lists for the metagenomic pipeline: canonical k-min-mer
// hash, orientation (reverse combine < forward; for l==1 the syncmer's own
// strand), and read-coordinate extent [qb, qe] per seedmer (qb = first
// member syncmer's k-mer start, qe = last member's k-mer end, inclusive).
// Twin of meta/engine.py::sketch_meta_reads_full's per-read scan
// (reference: mgsr.cpp:1774-2236 initializeQueryData).
// CSR output: read_offsets[n_reads+1] into the flat arrays.
// Returns total seedmers, or -1 if cap was insufficient.
int64_t pt_sketch_meta(const uint8_t* joined, const int64_t* offsets,
                       int64_t n_reads, int k, int s, int t, int open_, int l,
                       int n_threads, int64_t* read_offsets, uint64_t* out_hash,
                       uint8_t* out_rev, int32_t* out_qb, int32_t* out_qe,
                       uint64_t* out_fp1, uint64_t* out_fp2, int64_t cap) {
    if (n_threads < 1) n_threads = 1;
    if (n_threads > (int)n_reads) n_threads = n_reads > 0 ? (int)n_reads : 1;
    struct Buf {
        std::vector<uint64_t> h;
        std::vector<uint8_t> rv;
        std::vector<int32_t> qb, qe;
        std::vector<int32_t> cnt;  // per read in range
    };
    std::vector<Buf> bufs(n_threads);
    int64_t chunk = (n_reads + n_threads - 1) / n_threads;
    // order-dependent Horner fingerprints per read (content dedup key)
    constexpr uint64_t FP_W1 = 0x9E3779B97F4A7C15ULL;
    constexpr uint64_t FP_C1 = 0xBF58476D1CE4E5B9ULL;
    constexpr uint64_t FP_W2 = 0xC2B2AE3D27D4EB4FULL;
    constexpr uint64_t FP_C2 = 0x94D049BB133111EBULL;
    auto mix = [](uint64_t v, uint64_t c) {
        v = (v ^ (v >> 31)) * c;
        return v ^ (v >> 29);
    };
    auto work = [&](int ti, int64_t r0, int64_t r1) {
        Buf& o = bufs[ti];
        o.cnt.reserve(r1 - r0);
        // reserve once from the sequence-byte estimate (growth-doubling of
        // hundreds-of-MB vectors is the expensive part on slow-fault hosts)
        int64_t bytes = offsets[r1] - offsets[r0];
        int64_t est = bytes / 4 + 1024;
        o.h.reserve(est);
        o.rv.reserve(est);
        o.qb.reserve(est);
        o.qe.reserve(est);
        SketchScratch sc;
        for (int64_t r = r0; r < r1; ++r) {
            const uint8_t* seq = joined + offsets[r];
            int64_t nn = offsets[r + 1] - offsets[r];
            scan_read_syncmers(seq, nn, k, s, t, open_, sc);
            int64_t mh = (int64_t)sc.H.size();
            int32_t emitted = 0;
            uint64_t fp1 = 0, fp2 = 0;
            auto emit = [&](uint64_t hh, bool rv, int32_t qb, int32_t qe) {
                o.h.push_back(hh);
                o.rv.push_back(rv);
                o.qb.push_back(qb);
                o.qe.push_back(qe);
                uint64_t val = hh ^ ((uint64_t)qb << 17) ^
                               ((uint64_t)qe << 34) ^ ((uint64_t)rv << 63);
                fp1 = fp1 * FP_W1 + mix(val, FP_C1);
                fp2 = fp2 * FP_W2 + mix(val, FP_C2);
                ++emitted;
            };
            if (l == 1) {
                for (int64_t i = 0; i < mh; ++i)
                    emit(sc.H[i], sc.rev[i], sc.pos[i], sc.pos[i] + k - 1);
            } else if (mh >= l) {
                for (int64_t i = 0; i + l <= mh; ++i) {
                    uint64_t f = 0, rr = 0;
                    for (int w2 = 0; w2 < l; ++w2) {
                        int e = (k * (l - 1 - w2)) & 63;
                        f ^= rol(sc.H[i + w2], e);
                        rr ^= rol(sc.H[i + l - 1 - w2], e);
                    }
                    if (f == rr) continue;  // palindromic window
                    emit(f < rr ? f : rr, rr < f, sc.pos[i],
                         sc.pos[i + l - 1] + k - 1);
                }
            }
            o.cnt.push_back(emitted);
            out_fp1[r] = fp1;
            out_fp2[r] = fp2;
        }
    };
    std::vector<std::thread> threads;
    for (int ti = 0; ti < n_threads; ++ti) {
        int64_t r0 = ti * chunk;
        int64_t r1 = r0 + chunk < n_reads ? r0 + chunk : n_reads;
        if (r0 >= r1) {
            bufs[ti].cnt.clear();
            continue;
        }
        threads.emplace_back(work, ti, r0, r1);
    }
    for (auto& th : threads) th.join();
    int64_t total = 0;
    for (auto& b : bufs) total += (int64_t)b.h.size();
    if (total > cap) return -1;
    // global CSR offsets + parallel copy-out
    int64_t roff = 0, doff = 0;
    std::vector<int64_t> dst(n_threads);
    for (int ti = 0; ti < n_threads; ++ti) {
        dst[ti] = doff;
        Buf& b = bufs[ti];
        for (size_t j = 0; j < b.cnt.size(); ++j) {
            read_offsets[roff++] = doff;
            doff += b.cnt[j];
        }
    }
    read_offsets[roff] = doff;
    std::vector<std::thread> copies;
    for (int ti = 0; ti < n_threads; ++ti) {
        if (bufs[ti].h.empty()) continue;
        copies.emplace_back([&, ti]() {
            Buf& b = bufs[ti];
            int64_t d = dst[ti];
            memcpy(out_hash + d, b.h.data(), b.h.size() * 8);
            memcpy(out_rev + d, b.rv.data(), b.rv.size());
            memcpy(out_qb + d, b.qb.data(), b.qb.size() * 4);
            memcpy(out_qe + d, b.qe.data(), b.qe.size() * 4);
        });
    }
    for (auto& th : copies) th.join();
    return total;
}

// Threaded binary-search join of unsorted u64 queries against a sorted table.
// out_idx[i] = lower_bound(U, q[i]); found[i] = (U[out_idx[i]] == q[i]).
void pt_join_u64(const uint64_t* q, int64_t n, const uint64_t* U, int64_t m,
                 int n_threads, int32_t* out_idx, uint8_t* found) {
    if (n_threads < 1) n_threads = 1;
    auto work = [&](int64_t a, int64_t b) {
        for (int64_t i = a; i < b; ++i) {
            int64_t lo = 0, hi = m;
            uint64_t x = q[i];
            while (lo < hi) {
                int64_t mid = (lo + hi) >> 1;
                if (U[mid] < x)
                    lo = mid + 1;
                else
                    hi = mid;
            }
            int64_t c = lo < m ? lo : (m > 0 ? m - 1 : 0);
            out_idx[i] = (int32_t)c;
            found[i] = (m > 0) && (U[c] == x);
        }
    };
    if (n_threads == 1 || n < 4096) {
        work(0, n);
        return;
    }
    std::vector<std::thread> threads;
    int64_t chunk = (n + n_threads - 1) / n_threads;
    for (int ti = 0; ti < n_threads; ++ti) {
        int64_t a = ti * chunk, b = a + chunk < n ? a + chunk : n;
        if (a >= b) break;
        threads.emplace_back(work, a, b);
    }
    for (auto& th : threads) th.join();
}

}  // extern "C"

// ---------------------------------------------------------------------------
// BAQ: banded glocal profile-HMM posterior.  C++ twin of the numpy oracle in
// genotype/baq.py::baq_glocal_py (which documents the model); semantics are
// the htslib BAQ behavior bcftools mpileup relies on.
//
// Band layout: each query row i (1-based) carries M/I/D vectors of width
// 2*bw+3 over offsets j = k - (i - bw) + 1 with zero guard slots at both
// ends.  Under this indexing the diagonal predecessor (i-1, k-1) sits at the
// SAME j, the vertical predecessor (i-1, k) at j+1, the in-row predecessor
// (i, k-1) at j-1 — M and I updates are elementwise over the band and only
// the D state needs a short in-row scan (first-order linear recurrence).
// ---------------------------------------------------------------------------

extern "C" {

// ref/query: 0..3 codes (>=4 ambiguous); qual: phred per query base.
// state/q: l_query outputs; state[i] = (ref_col << 2) | tag (0=M, 1=I).
// Returns 0 on success.
int pt_baq_glocal(const uint8_t* ref, int l_ref, const uint8_t* query,
                  int l_query, const uint8_t* qual_in, int bw_cap, double gapd,
                  double gape, int* state, uint8_t* q) {
    if (l_ref <= 0 || l_query <= 0) return -1;
    const int lr = l_ref, lq = l_query;
    int bw = lr > lq ? lr : lq;
    if (bw > bw_cap) bw = bw_cap;
    int diff = lr - lq;
    if (diff < 0) diff = -diff;
    if (bw < diff) bw = diff;
    const int W = 2 * bw + 3;  // band vector width incl. guard slots

    std::vector<double> qp(lq);
    for (int i = 0; i < lq; ++i)
        qp[i] = pow(10.0, -(double)qual_in[i] / 10.0);

    // transition probabilities (named, not the htslib m[9] table)
    const double sM = 1.0 / (2 * lq + 2), sI = sM;
    const double t_mm = (1 - 2 * gapd) * (1 - sM);  // M->M
    const double t_mi = gapd * (1 - sM);            // M->I
    const double t_md = gapd * (1 - sM);            // M->D
    const double t_im = (1 - gape) * (1 - sI);      // I->M
    const double t_ii = gape * (1 - sI);            // I->I
    const double t_dm = 1 - gape;                   // D->M
    const double t_dd = gape;                       // D->D
    const double beginM = (1 - gapd) / lr;          // glocal begin
    const double beginI = gapd / lr;

    // row band extent: columns k in [k_lo(i), k_hi(i)], offset j = k-(i-bw)+1
    auto k_lo = [&](int i) { return i - bw > 1 ? i - bw : 1; };
    auto k_hi = [&](int i) { return i + bw < lr ? i + bw : lr; };
    auto j_of = [&](int i, int k) { return k - (i - bw) + 1; };

    // match-emission over a row's band columns
    auto emit_row = [&](int i, double* e) {
        const uint8_t qb = query[i - 1];
        const double pe = qp[i - 1];
        const int lo = k_lo(i), hi = k_hi(i), j0 = j_of(i, lo);
        for (int k = lo; k <= hi; ++k) {
            const uint8_t rb = ref[k - 1];
            e[j0 + k - lo] = (rb > 3 || qb > 3) ? 1.0
                             : (rb == qb ? 1.0 - pe : pe / 3.0);
        }
    };

    std::vector<double> fM((size_t)(lq + 1) * W, 0.0);
    std::vector<double> fI((size_t)(lq + 1) * W, 0.0);
    std::vector<double> fD((size_t)(lq + 1) * W, 0.0);
    std::vector<double> s(lq + 2, 0.0);
    std::vector<double> e(W, 0.0);
    s[0] = 1.0;

    // ---- forward: row 1 enters the reference anywhere (glocal) ----
    {
        emit_row(1, e.data());
        double* rM = &fM[1 * (size_t)W];
        double* rI = &fI[1 * (size_t)W];
        const int lo = k_lo(1), hi = k_hi(1), j0 = j_of(1, lo);
        double sum = 0.0;
        for (int j = j0; j <= j0 + hi - lo; ++j) {
            rM[j] = e[j] * beginM;
            rI[j] = 0.25 * beginI;
            sum += rM[j] + rI[j];
        }
        s[1] = sum;
    }
    for (int i = 2; i <= lq; ++i) {
        emit_row(i, e.data());
        const double M = 1.0 / s[i - 1];
        double* rM = &fM[(size_t)i * W];
        double* rI = &fI[(size_t)i * W];
        double* rD = &fD[(size_t)i * W];
        const double* pM = &fM[(size_t)(i - 1) * W];
        const double* pI = &fI[(size_t)(i - 1) * W];
        const double* pD = &fD[(size_t)(i - 1) * W];
        const int lo = k_lo(i), hi = k_hi(i), j0 = j_of(i, lo);
        const int j1 = j0 + hi - lo;
        double sum = 0.0, d = 0.0;
        for (int j = j0; j <= j1; ++j) {
            // diagonal predecessor at the same j, vertical at j+1
            rM[j] = e[j] * (t_mm * pM[j] + t_im * pI[j] + t_dm * pD[j]) * M;
            rI[j] = 0.25 * (t_mi * pM[j + 1] + t_ii * pI[j + 1]) * M;
            d = t_md * rM[j - 1] + t_dd * d;  // in-row D scan
            rD[j] = d;
            sum += rM[j] + rI[j] + rD[j];
        }
        s[i] = sum;
    }
    {
        const double M = 1.0 / s[lq];
        const double* rM = &fM[(size_t)lq * W];
        const double* rI = &fI[(size_t)lq * W];
        double sum = 0.0;
        for (int j = 0; j < W; ++j) sum += rM[j] * sM + rI[j] * sI;
        s[lq + 1] = sum * M;
    }

    // ---- backward ----
    std::vector<double> bM((size_t)(lq + 1) * W, 0.0);
    std::vector<double> bI((size_t)(lq + 1) * W, 0.0);
    std::vector<double> bD((size_t)(lq + 1) * W, 0.0);
    {
        double* rM = &bM[(size_t)lq * W];
        double* rI = &bI[(size_t)lq * W];
        const int lo = k_lo(lq), hi = k_hi(lq), j0 = j_of(lq, lo);
        const double vM = sM / s[lq] / s[lq + 1];
        const double vI = sI / s[lq] / s[lq + 1];
        for (int j = j0; j <= j0 + hi - lo; ++j) {
            rM[j] = vM;
            rI[j] = vI;
        }
    }
    for (int i = lq - 1; i >= 1; --i) {
        const uint8_t qb = query[i];  // next row's base (i+1, 1-based)
        const double pe = qp[i];
        double* rM = &bM[(size_t)i * W];
        double* rI = &bI[(size_t)i * W];
        double* rD = &bD[(size_t)i * W];
        const double* nM = &bM[(size_t)(i + 1) * W];
        const double* nI = &bI[(size_t)(i + 1) * W];
        const int lo = k_lo(i), hi = k_hi(i), j0 = j_of(i, lo);
        const int j1 = j0 + hi - lo;
        // right-to-left: emission of row i+1 at column k+1 shares this j
        double d = 0.0;
        for (int j = j1, k = hi; j >= j0; --j, --k) {
            double eM = 0.0;
            if (k < lr) {
                const uint8_t rb = ref[k];  // ref column k+1, 0-based k
                const double ev = (rb > 3 || qb > 3)
                                      ? 1.0
                                      : (rb == qb ? 1.0 - pe : pe / 3.0);
                eM = ev * nM[j];  // e(i+1, k+1) * bM(i+1, k+1)
            }
            if (i > 1) {  // row 1 has no D state
                d = eM * t_dm + t_dd * d;
                rD[j] = d;
            }
            rM[j] = eM * t_mm + 0.25 * t_mi * nI[j - 1] + t_md * rD[j + 1];
            rI[j] = eM * t_im + 0.25 * t_ii * nI[j - 1];
        }
        const double N = 1.0 / s[i];
        for (int j = j0; j <= j1; ++j) {
            rM[j] *= N;
            rI[j] *= N;
            rD[j] *= N;
        }
    }

    // ---- per-base MAP state + phred posterior ----
    for (int i = 1; i <= lq; ++i) {
        const double* rfM = &fM[(size_t)i * W];
        const double* rfI = &fI[(size_t)i * W];
        const double* rbM = &bM[(size_t)i * W];
        const double* rbI = &bI[(size_t)i * W];
        const int lo = k_lo(i), hi = k_hi(i), j0 = j_of(i, lo);
        const double M = 1.0 / s[i];
        double tot = 0.0, mx = 0.0;
        int best = -1;
        for (int k = lo, j = j0; k <= hi; ++k, ++j) {
            const double zM = M * rfM[j] * rbM[j];
            if (zM > mx) { mx = zM; best = (k - 1) << 2 | 0; }
            const double zI = M * rfI[j] * rbI[j];
            if (zI > mx) { mx = zI; best = (k - 1) << 2 | 1; }
            tot += zM + zI;
        }
        state[i - 1] = best;
        if (tot <= 0.0) {  // degenerate posterior: no information
            q[i - 1] = 0;
            continue;
        }
        mx /= tot;
        const int kq = (int)(-4.343 * log(1.0 - mx) + 0.499);
        q[i - 1] = kq > 100 ? 99 : (uint8_t)kq;
    }
    return 0;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Forward-only glocal score (probaln score mode) — the C++ twin of
// genotype/baq.py::glocal_score_py, used per (read x type) by the bcftools-
// realignment indel caller (genotype/indel.py).  Same band-offset
// formulation and operation order as the python oracle.
// ---------------------------------------------------------------------------

extern "C" {

// ref/query: 0..3 codes (>=4 ambiguous); qual: phred per query base.
// Returns the phred score, or 0x7FFFFF on degenerate recursions.
int pt_glocal_score(const uint8_t* ref, int l_ref, const uint8_t* query,
                    int l_query, const uint8_t* qual_in, int bw_cap,
                    double gapd, double gape) {
    const int SENT = 0x7FFFFF;
    if (l_ref <= 0 || l_query <= 0) return SENT;
    const int lr = l_ref, lq = l_query;
    int bw = lr > lq ? lr : lq;
    if (bw > bw_cap) bw = bw_cap;
    int diff = lr - lq;
    if (diff < 0) diff = -diff;
    if (bw < diff) bw = diff;
    const int W = 2 * bw + 3;

    std::vector<double> qp(lq);
    for (int i = 0; i < lq; ++i)
        qp[i] = pow(10.0, -(double)qual_in[i] / 10.0);

    const double sM = 1.0 / (2 * lq + 2), sI = sM;
    const double t_mm = (1 - 2 * gapd) * (1 - sM);
    const double t_mi = gapd * (1 - sM);
    const double t_md = gapd * (1 - sM);
    const double t_im = (1 - gape) * (1 - sI);
    const double t_ii = gape * (1 - sI);
    const double t_dm = 1 - gape;
    const double t_dd = gape;
    const double beginM = (1 - gapd) / lr;
    const double beginI = gapd / lr;

    auto k_lo = [&](int i) { return i - bw > 1 ? i - bw : 1; };
    auto k_hi = [&](int i) { return i + bw < lr ? i + bw : lr; };
    auto j_of = [&](int i, int k) { return k - (i - bw) + 1; };

    std::vector<double> pM(W, 0.0), pI(W, 0.0), pD(W, 0.0);
    std::vector<double> nM(W, 0.0), nI(W, 0.0), nD(W, 0.0);
    std::vector<double> e(W, 0.0);
    std::vector<double> s(lq + 2, 0.0);
    s[0] = 1.0;

    auto emit_row = [&](int i) {
        const uint8_t qb = query[i - 1];
        const double pe = qp[i - 1];
        const int lo = k_lo(i), hi = k_hi(i), j0 = j_of(i, lo);
        for (int k = lo; k <= hi; ++k) {
            const uint8_t rb = ref[k - 1];
            e[j0 + k - lo] = (rb > 3 || qb > 3) ? 1.0
                             : (rb == qb ? 1.0 - pe : pe / 3.0);
        }
    };

    {
        emit_row(1);
        const int lo = k_lo(1), hi = k_hi(1), j0 = j_of(1, lo);
        double sum = 0.0;
        for (int j = j0; j <= j0 + hi - lo; ++j) {
            pM[j] = e[j] * beginM;
            pI[j] = 0.25 * beginI;
            sum += pM[j] + pI[j];
        }
        s[1] = sum;
    }
    for (int i = 2; i <= lq; ++i) {
        emit_row(i);
        if (s[i - 1] <= 0) return SENT;
        const double M = 1.0 / s[i - 1];
        const int lo = k_lo(i), hi = k_hi(i), j0 = j_of(i, lo);
        const int j1 = j0 + hi - lo;
        std::fill(nM.begin(), nM.end(), 0.0);
        std::fill(nI.begin(), nI.end(), 0.0);
        std::fill(nD.begin(), nD.end(), 0.0);
        double sum = 0.0, d = 0.0;
        for (int j = j0; j <= j1; ++j) {
            nM[j] = e[j] * (t_mm * pM[j] + t_im * pI[j] + t_dm * pD[j]) * M;
            nI[j] = 0.25 * (t_mi * pM[j + 1] + t_ii * pI[j + 1]) * M;
            d = t_md * nM[j - 1] + t_dd * d;
            nD[j] = d;
            sum += nM[j] + nI[j] + nD[j];
        }
        pM.swap(nM); pI.swap(nI); pD.swap(nD);
        s[i] = sum;
    }
    if (s[lq] <= 0) return SENT;
    {
        double mm = 0.0, ii = 0.0;
        for (int j = 0; j < W; ++j) { mm += pM[j]; ii += pI[j]; }
        s[lq + 1] = (mm * sM + ii * sI) / s[lq];
    }
    // probaln's product-chunked log accumulation, kept verbatim for parity
    double p = 1.0, pr1 = 0.0;
    for (int i = 0; i <= lq + 1; ++i) {
        p *= s[i];
        if (p < 1e-100) { pr1 += -4.343 * log(p); p = 1.0; }
    }
    if (p <= 0) return SENT;
    pr1 += -4.343 * log(p * (double)lr * (double)lq);
    return (int)(pr1 + 0.499);
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Short-read seed-and-extend aligner (minimap2-sr-equivalent), the native
// twin of align/batch.py::BatchAligner._align_chunk + align/core.py::
// Aligner._extend / banded_affine_dp / extension_dp.  Semantics mirror the
// Python batch path exactly (it remains the test oracle); reference behavior
// documented at src/mm_align.c:48-118 (sr preset: k=21 w=11 match=2
// mismatch=8 gapo=12 gape=2 end_bonus=10 max_gap=100 min_cnt=2
// min_chain_score=25 min_dp_max=40).
// ---------------------------------------------------------------------------

#include <algorithm>

namespace sr {

constexpr int MATCH = 2;
constexpr int MISMATCH = 8;
constexpr int GAP_OPEN = 12;
constexpr int GAP_EXT = 2;
constexpr int END_BONUS = 10;
constexpr int MAX_GAP = 100;
constexpr int MIN_CNT = 2;
constexpr int MIN_CHAIN_SCORE = 25;
constexpr int MIN_DP_MAX = 40;
constexpr int32_t NEG = -(1 << 28);

// minimap2's invertible hash (align/core.py::_hash64)
inline uint64_t mm_hash64(uint64_t key, uint64_t mask) {
    key = (~key + (key << 21)) & mask;
    key = key ^ (key >> 24);
    key = ((key + (key << 3)) + (key << 8)) & mask;
    key = key ^ (key >> 14);
    key = ((key + (key << 2)) + (key << 4)) & mask;
    key = key ^ (key >> 28);
    key = (key + (key << 31)) & mask;
    return key;
}

struct Cigar {
    std::vector<std::pair<int, char>> ops;
    void push(int ln, char op) {
        if (ln <= 0) return;
        if (!ops.empty() && ops.back().second == op)
            ops.back().first += ln;
        else
            ops.emplace_back(ln, op);
    }
};

struct Aln {
    bool mapped = false;
    int32_t rs = 0, re = 0, qs = 0, qe = 0;  // qs/qe oriented (pre-flip)
    bool rev = false;
    int32_t mapq = 0, score = 0, nm = 0;
    Cigar cig;
    // deferred full-window DP (Ctx.defer_dp): window + cluster stats for the
    // device-scoring stage
    bool defer = false;
    int64_t wlo = 0, whi = 0;
    int votes = 0, second = 0;
};

// anchor cluster (shared by align_one's selection and Scratch reuse)
struct Clu {
    int votes;
    int span;
    int64_t med, dmin, dmax;
    int rel;
};

// DP scratch reused across reads within one thread.
struct Scratch {
    std::vector<int32_t> H, E, F, base;
    std::vector<uint64_t> h;        // minimizer hash per position
    std::vector<uint8_t> strand;    // minimizer strand per position
    std::vector<uint8_t> codes, oriented, tmp;
    std::vector<int64_t> diag0, diag1;  // (diag<<1) carrying nothing; per rel
    std::vector<int64_t> qv0, qv1;
    std::vector<int64_t> sortbuf;
    // selected minimizer triples (filled by min_scan or supplied precomputed)
    std::vector<int32_t> minpos;
    std::vector<uint64_t> minhash;
    std::vector<uint8_t> minstrand;
    std::vector<int> dq;  // min_scan monotonic deque
    // verify_diag buffers (a malloc per read dominated the verify phase)
    std::vector<int32_t> vSv, vbl;
    std::vector<uint8_t> vmt;
    // align_one cluster selection + extend's reversed-ref window
    std::vector<Clu> clus;
    std::vector<int> ord;
    std::vector<uint8_t> rw;
};

// Local affine-gap DP with query-end bonuses (align/core.py::banded_affine_dp,
// row order and tie-breaks identical).  Returns score<=0 => no alignment.
static int banded_affine_dp(const uint8_t* q, int lq, const uint8_t* r,
                            int lr, Scratch& S, int& qs, int& qe, int& rs,
                            int& re, Cigar& cig) {
    int W = lr + 1;
    S.H.assign((size_t)(lq + 1) * W, 0);
    S.E.assign((size_t)(lq + 1) * W, NEG);
    S.F.assign((size_t)(lq + 1) * W, NEG);
    int32_t* H = S.H.data();
    int32_t* E = S.E.data();
    int32_t* F = S.F.data();
    for (int j = 0; j <= lr; ++j) H[j] = END_BONUS;
    int best_sc = 0, bi = 0, bj = 0;
    for (int i = 1; i <= lq; ++i) {
        int32_t* Hi = H + (size_t)i * W;
        int32_t* Hp = H + (size_t)(i - 1) * W;
        int32_t* Ei = E + (size_t)i * W;
        int32_t* Fi = F + (size_t)i * W;
        int32_t* Fp = F + (size_t)(i - 1) * W;
        uint8_t qc = q[i - 1];
        for (int j = 0; j <= lr; ++j)
            Fi[j] = std::max(Hp[j] - GAP_OPEN, Fp[j] - GAP_EXT);
        // base[j] folded into the forward pass: base[0]=0; for j>=1
        // base[j]=max(Hp[j-1]+sub, Fi[j], 0)
        int32_t eprev = NEG;  // E[i][0]
        Hi[0] = 0;            // max(base0=0, NEG)
        int jmax = 0;
        int32_t hmax = Hi[0];
        for (int j = 1; j <= lr; ++j) {
            int32_t sub = (qc == r[j - 1] && qc < 4) ? MATCH : -MISMATCH;
            int32_t bj_ = std::max(std::max(Hp[j - 1] + sub, Fi[j]), 0);
            int32_t bprev =
                j == 1 ? 0
                       : std::max(std::max(Hp[j - 2] + ((qc == r[j - 2] && qc < 4)
                                                            ? MATCH
                                                            : -MISMATCH),
                                           Fi[j - 1]),
                                  0);
            int32_t e = std::max(bprev - GAP_OPEN, eprev - GAP_EXT);
            Ei[j] = e;
            eprev = e;
            int32_t hv = std::max(bj_, e);
            Hi[j] = hv;
            if (hv > hmax) {
                hmax = hv;
                jmax = j;
            }
        }
        int sc = hmax + (i == lq ? END_BONUS : 0);
        if (sc > best_sc) {
            best_sc = sc;
            bi = i;
            bj = jmax;
        }
    }
    if (best_sc <= 0 || bi == 0 || bj == 0) return 0;
    // traceback (state machine identical to the numpy version)
    int i = bi, j = bj;
    std::vector<char> ops;
    char state = 'H';
    while (i > 0 && j > 0) {
        int32_t* Hi = H + (size_t)i * W;
        int32_t* Hp = H + (size_t)(i - 1) * W;
        int32_t* Ei = E + (size_t)i * W;
        int32_t* Fi = F + (size_t)i * W;
        int32_t* Fp = F + (size_t)(i - 1) * W;
        if (state == 'H') {
            int32_t h = Hi[j];
            if (h == 0) break;
            int32_t sub = (q[i - 1] == r[j - 1] && q[i - 1] < 4) ? MATCH : -MISMATCH;
            if (h == Hp[j - 1] + sub) {
                ops.push_back('M');
                --i;
                --j;
            } else if (h == Ei[j]) {
                state = 'E';
            } else if (h == Fi[j]) {
                state = 'F';
            } else {
                ops.push_back('M');
                --i;
                --j;
            }
        } else if (state == 'E') {
            ops.push_back('D');
            if (j > 1 && Ei[j] == Ei[j - 1] - GAP_EXT)
                --j;
            else {
                --j;
                state = 'H';
            }
        } else {
            ops.push_back('I');
            if (i > 1 && Fi[j] == Fp[j] - GAP_EXT)
                --i;
            else {
                --i;
                state = 'H';
            }
        }
    }
    for (auto it = ops.rbegin(); it != ops.rend(); ++it) cig.push(1, *it);
    qs = i;
    qe = bi;
    rs = j;
    re = bj;
    return best_sc;
}

// Affine-gap extension anchored at (0,0) (align/core.py::extension_dp).
static int extension_dp(const uint8_t* q, int lq, const uint8_t* r, int lr,
                        Scratch& S, int& qext, int& rext, Cigar& cig) {
    if (lq == 0 || lr == 0) return 0;
    int W = lr + 1;
    S.H.assign((size_t)(lq + 1) * W, NEG);
    S.E.assign((size_t)(lq + 1) * W, NEG);
    S.F.assign((size_t)(lq + 1) * W, NEG);
    int32_t* H = S.H.data();
    int32_t* E = S.E.data();
    int32_t* F = S.F.data();
    H[0] = 0;
    for (int j = 1; j <= lr; ++j) H[j] = -(GAP_OPEN + (j - 1) * GAP_EXT);
    int best_sc = 0, bi = 0, bj = 0;
    for (int i = 1; i <= lq; ++i) {
        int32_t* Hi = H + (size_t)i * W;
        int32_t* Hp = H + (size_t)(i - 1) * W;
        int32_t* Ei = E + (size_t)i * W;
        int32_t* Fi = F + (size_t)i * W;
        int32_t* Fp = F + (size_t)(i - 1) * W;
        uint8_t qc = q[i - 1];
        for (int j = 0; j <= lr; ++j)
            Fi[j] = std::max(Hp[j] - GAP_OPEN, Fp[j] - GAP_EXT);
        int32_t base0 = -(GAP_OPEN + (i - 1) * GAP_EXT);
        int32_t eprev = NEG;
        Hi[0] = base0;  // max(base0, NEG)
        int jmax = 0;
        int32_t hmax = Hi[0];
        int32_t bprev = base0;
        for (int j = 1; j <= lr; ++j) {
            int32_t sub = (qc == r[j - 1] && qc < 4) ? MATCH : -MISMATCH;
            int32_t bj_ = std::max(Hp[j - 1] + sub, Fi[j]);
            int32_t e = std::max(bprev - GAP_OPEN, eprev - GAP_EXT);
            Ei[j] = e;
            eprev = e;
            bprev = bj_;
            int32_t hv = std::max(bj_, e);
            Hi[j] = hv;
            if (hv > hmax) {
                hmax = hv;
                jmax = j;
            }
        }
        int sc = hmax + (i == lq ? END_BONUS : 0);
        if (sc > best_sc) {
            best_sc = sc;
            bi = i;
            bj = jmax;
        }
    }
    if (best_sc <= 0) return 0;
    int i = bi, j = bj;
    std::vector<char> ops;
    char state = 'H';
    while (i > 0 || j > 0) {
        if (state == 'H') {
            if (i == 0) {
                for (int x = 0; x < j; ++x) ops.push_back('D');
                break;
            }
            if (j == 0) {
                for (int x = 0; x < i; ++x) ops.push_back('I');
                break;
            }
            int32_t h = H[(size_t)i * W + j];
            int32_t sub = (q[i - 1] == r[j - 1] && q[i - 1] < 4) ? MATCH : -MISMATCH;
            if (h == H[(size_t)(i - 1) * W + j - 1] + sub) {
                ops.push_back('M');
                --i;
                --j;
            } else if (h == E[(size_t)i * W + j]) {
                state = 'E';
            } else if (h == F[(size_t)i * W + j]) {
                state = 'F';
            } else {
                ops.push_back('M');
                --i;
                --j;
            }
        } else if (state == 'E') {
            ops.push_back('D');
            if (j > 1 && E[(size_t)i * W + j] == E[(size_t)i * W + j - 1] - GAP_EXT)
                --j;
            else {
                --j;
                state = 'H';
            }
        } else {
            ops.push_back('I');
            if (i > 1 && F[(size_t)i * W + j] == F[(size_t)(i - 1) * W + j] - GAP_EXT)
                --i;
            else {
                --i;
                state = 'H';
            }
        }
    }
    for (auto it = ops.rbegin(); it != ops.rend(); ++it) cig.push(1, *it);
    qext = bi;
    rext = bj;
    return best_sc;
}

struct Verify {
    // segment-space verify (align/batch.py lines 169-231 with shift=0)
    int score = NEG, raw = 0, qs = 0, qe = 0, nm = 0;
    int q_lo = 0, q_hi = 0;
};

static Verify verify_diag(const uint8_t* q, int lq, const uint8_t* ref,
                          int64_t lr, int64_t diag, Scratch& SC) {
    Verify V;
    int64_t q_lo = std::max<int64_t>(0, -diag);
    int64_t q_hi = std::min<int64_t>(lq, lr - diag);
    V.q_lo = (int)q_lo;
    V.q_hi = (int)q_hi;
    if (q_hi <= q_lo) {
        V.score = NEG;
        return V;
    }
    int n = (int)(q_hi - q_lo);
    // prefix sums S[0..n]; lead[c] = -S[c] + (c==0 && q_lo==0 ? EB : 0)
    // best_lead = prefix max; totals[c] = S[c] + endb(c) + best_lead[c];
    // jbest = first argmax over c in 1..n; ibest = first c<=jbest with
    // lead[c] == best_lead[jbest].
    SC.vSv.resize(n + 1);
    SC.vmt.resize(n);
    auto& Sv = SC.vSv;
    auto& mt = SC.vmt;
    Sv[0] = 0;
    for (int c = 0; c < n; ++c) {
        uint8_t qc = q[q_lo + c];
        uint8_t rc = ref[diag + q_lo + c];
        bool m = (qc == rc) && (qc < 4);
        mt[c] = m;
        Sv[c + 1] = Sv[c] + (m ? MATCH : -MISMATCH);
    }
    int32_t lead0 = (q_lo == 0) ? END_BONUS : 0;  // -S[0] + bonus
    int32_t best_lead = lead0;
    int32_t best_tot = NEG;
    int jbest = 0;
    SC.vbl.resize(n + 1);
    auto& bl = SC.vbl;
    bl[0] = best_lead;
    for (int c = 1; c <= n; ++c) {
        int32_t lead = -Sv[c];
        if (lead > best_lead) best_lead = lead;
        bl[c] = best_lead;
        int32_t tot = Sv[c] + ((c == n && q_hi == lq) ? END_BONUS : 0) + best_lead;
        if (tot > best_tot) {
            best_tot = tot;
            jbest = c;
        }
    }
    int32_t target = bl[jbest];
    int ibest = 0;
    for (int c = 0; c <= jbest; ++c) {
        int32_t lead = (c == 0) ? lead0 : -Sv[c];
        if (lead == target) {
            ibest = c;
            break;
        }
    }
    V.score = best_tot;
    V.raw = best_tot;
    if (q_lo == 0 && ibest == 0) V.raw -= END_BONUS;
    if (q_hi == lq && jbest == n) V.raw -= END_BONUS;
    V.qs = (int)q_lo + ibest;
    V.qe = (int)q_lo + jbest;
    int nm = 0;
    for (int c = ibest; c < jbest; ++c) nm += !mt[c];
    V.nm = nm;
    return V;
}

struct Ctx {
    const uint8_t* ref;
    int64_t lr;
    const uint64_t* idx_h;
    const int32_t* idx_pos;
    const uint8_t* idx_strand;
    int64_t m_idx;
    int k, w;
    // defer_dp: instead of running the full-window banded DP here, report the
    // (window, votes) so the caller can score the batch on the TPU (the
    // Pallas banded-SW kernel) and run host traceback only for survivors
    int defer_dp = 0;
    // open-addressing table over the DISTINCT hashes of the (sorted) ref
    // index: hash -> first row of its run.  Replaces the per-minimizer
    // binary search (13 dependent branches over ~5k entries) with 1-2
    // probes.  Built once per batch call; read-only across threads.
    std::vector<uint64_t> tkey;
    std::vector<int32_t> tval;
    uint64_t tmask = 0;

    void build_table() {
        if (m_idx <= 0) return;
        size_t cap = 64;
        while (cap < (size_t)m_idx * 2) cap <<= 1;
        tkey.assign(cap, U64MAX);
        tval.assign(cap, -1);
        tmask = cap - 1;
        for (int64_t i = 0; i < m_idx; ++i) {
            if (i > 0 && idx_h[i] == idx_h[i - 1]) continue;
            uint64_t hv = idx_h[i];
            size_t p = (size_t)((hv ^ (hv >> 33)) * 0xFF51AFD7ED558CCDULL) &
                       tmask;
            while (tkey[p] != U64MAX) p = (p + 1) & tmask;
            tkey[p] = hv;
            tval[p] = (int32_t)i;
        }
    }
    inline int64_t lookup(uint64_t hv) const {
        if (tmask == 0) {  // no table: fall back to binary search
            int64_t lo = 0, hi = m_idx;
            while (lo < hi) {
                int64_t mid = (lo + hi) >> 1;
                if (idx_h[mid] < hv)
                    lo = mid + 1;
                else
                    hi = mid;
            }
            return (lo < m_idx && idx_h[lo] == hv) ? lo : -1;
        }
        size_t p = (size_t)((hv ^ (hv >> 33)) * 0xFF51AFD7ED558CCDULL) & tmask;
        while (tkey[p] != U64MAX) {
            if (tkey[p] == hv) return tval[p];
            p = (p + 1) & tmask;
        }
        return -1;
    }
};

static void finish(Aln& a, int score, int qs, int qe, int rs, int re,
                   Cigar&& cig, int nm, int votes, int second) {
    if (score < MIN_DP_MAX) return;
    a.mapped = true;
    a.score = score;
    a.qs = qs;
    a.qe = qe;
    a.rs = rs;
    a.re = re;
    a.cig = std::move(cig);
    a.nm = nm;
    if (votes >= 3 && second * 2 <= votes)
        a.mapq = 60;
    else {
        int m = (int)(40.0 * (1.0 - (second + 1.0) / (votes + 1.0)));
        a.mapq = std::max(1, std::min(60, m));
    }
}

// align/core.py::Aligner._extend (oriented query, chosen diagonal cluster)
static void extend(const Ctx& C, Scratch& S, const uint8_t* q, int lq,
                   int64_t diag, int64_t dmin, int64_t dmax, int votes,
                   int second, Aln& a) {
    int64_t rs0 = diag;
    int64_t q_lo = std::max<int64_t>(0, -rs0);
    int64_t q_hi = std::min<int64_t>(lq, C.lr - rs0);
    if (q_hi - q_lo >= C.k && dmin == dmax) {
        Verify V = verify_diag(q, lq, C.ref, C.lr, diag, S);
        int qs = V.qs, qe = V.qe;
        int clip5 = qs, clip3 = lq - qe;
        if (V.score > 0 && clip5 < 10 && clip3 < 10) {
            Cigar cg;
            cg.push(qe - qs, 'M');
            finish(a, V.raw, qs, qe, (int)(rs0 + qs), (int)(rs0 + qe),
                   std::move(cg), V.nm, votes, second);
            return;
        }
        if (V.score > 0) {
            int core = V.raw;
            Cigar cg;
            cg.push(qe - qs, 'M');
            int nm = V.nm;
            int rs = (int)(rs0 + qs);
            int re = (int)(rs0 + qe);
            if (clip3 >= 10) {
                int tl = lq - qe;
                int rwe = (int)std::min<int64_t>(C.lr, re + tl + MAX_GAP + 16);
                Cigar ec;
                int qext = 0, rext = 0;
                int esc = extension_dp(q + qe, tl, C.ref + re, rwe - re, S,
                                       qext, rext, ec);
                if (esc > 0 && !ec.ops.empty()) {
                    for (auto& p : ec.ops) {
                        cg.push(p.first, p.second);
                        if (p.second != 'M') nm += p.first;
                    }
                    qe += qext;
                    re += rext;
                    core += esc - (qe == lq ? END_BONUS : 0);
                }
            }
            if (clip5 >= 10) {
                int hl = qs;
                // reversed head / reversed ref window
                S.tmp.assign(q, q + hl);
                std::reverse(S.tmp.begin(), S.tmp.end());
                int wlo = (int)std::max<int64_t>(0, rs - hl - MAX_GAP - 16);
                auto& rw = S.rw;
                rw.assign(C.ref + wlo, C.ref + rs);
                std::reverse(rw.begin(), rw.end());
                Cigar ec;
                int qext = 0, rext = 0;
                int esc = extension_dp(S.tmp.data(), hl, rw.data(),
                                       (int)rw.size(), S, qext, rext, ec);
                if (esc > 0 && !ec.ops.empty()) {
                    Cigar merged;
                    for (auto it = ec.ops.rbegin(); it != ec.ops.rend(); ++it) {
                        merged.push(it->first, it->second);
                        if (it->second != 'M') nm += it->first;
                    }
                    for (auto& p : cg.ops) merged.push(p.first, p.second);
                    cg = std::move(merged);
                    qs -= qext;
                    rs -= rext;
                    core += esc - (qs == 0 ? END_BONUS : 0);
                }
            }
            finish(a, core, qs, qe, rs, re, std::move(cg), nm, votes, second);
            return;
        }
    }
    // DP path (multi-diagonal cluster)
    int64_t lo = std::max<int64_t>(0, std::min(dmin, dmax) - MAX_GAP - 10);
    int64_t hi = std::min<int64_t>(C.lr, std::max(dmin, dmax) + lq + MAX_GAP + 10);
    if (hi <= lo) return;
    if ((int64_t)lq * (hi - lo) > 8000000 && dmin != dmax) {
        extend(C, S, q, lq, diag, diag, diag, votes, second, a);
        return;
    }
    if (C.defer_dp) {
        a.defer = true;
        a.wlo = lo;
        a.whi = hi;
        a.votes = votes;
        a.second = second;
        return;
    }
    Cigar cg;
    int qs = 0, qe = 0, rsw = 0, rew = 0;
    int score = banded_affine_dp(q, lq, C.ref + lo, (int)(hi - lo), S, qs, qe,
                                 rsw, rew, cg);
    if (score <= 0 || cg.ops.empty()) return;
    int nm = 0;
    for (auto& p : cg.ops)
        if (p.second != 'M') nm += p.first;
    finish(a, score, qs, qe, (int)(lo + rsw), (int)(lo + rew), std::move(cg),
           nm, votes, second);
}

// One read end-to-end: minimizers -> anchors -> cluster -> verify/extend.
static void encode_read(const uint8_t* seq_bytes, int lq,
                        std::vector<uint8_t>& out) {
    out.resize(lq);
    for (int i = 0; i < lq; ++i) {
        uint8_t b = seq_bytes[i];
        uint8_t c;
        switch (b) {
            case 'A': case 'a': c = 0; break;
            case 'C': case 'c': c = 1; break;
            case 'G': case 'g': c = 2; break;
            case 'T': case 't': c = 3; break;
            default: c = 4;
        }
        out[i] = c;
    }
}

// Read-side minimizer scan (reference-independent phase of align_one): fills
// S.minpos/minhash/minstrand with the selected (position, canonical hash,
// strand) triples.  Split out so callers can precompute it for a whole batch
// while the placement device program is still in flight (the alignment
// reference is not known until placement resolves, but this phase never
// touches it).
static void min_scan(int k, int w, const uint8_t* codes, int lq, Scratch& S) {
    S.minpos.clear();
    S.minhash.clear();
    S.minstrand.clear();
    int m = lq - k + 1;
    if (m <= 0) return;
    uint64_t mask = (k < 32) ? ((1ULL << (2 * k)) - 1) : ~0ULL;
    S.h.resize(m);
    S.strand.resize(m);
    // pass 1 (serial, cheap): rolling packed kmers with ambiguity tracking;
    // stage the canonical kmer per position so pass 2's mm_hash64 — the
    // expensive part (~12 ops/position) — runs position-independent and
    // auto-vectorizes
    uint64_t fwd = 0, rev = 0;
    int ambig = 0;  // count of codes>=4 in current window
    // rev holds complement(seq[j+i]) at bit 2i per window; pre-offset the
    // first k-1 bases by one slot so the loop's >>2 lands window 0 right
    for (int i = 0; i < k - 1; ++i) {
        uint8_t c = codes[i];
        fwd = (fwd << 2) | (c & 3);
        rev |= (uint64_t)(3 - std::min<int>(c, 3)) << (2 * (i + 1));
        ambig += c >= 4;
    }
    for (int j = 0; j < m; ++j) {
        uint8_t c = codes[j + k - 1];
        fwd = ((fwd << 2) | (c & 3)) & mask;
        rev = (rev >> 2) | ((uint64_t)(3 - std::min<int>(c, 3)) << (2 * (k - 1)));
        ambig += c >= 4;
        if (j > 0) ambig -= codes[j - 1] >= 4;
        uint8_t st = rev < fwd;
        bool ok = (ambig == 0) && (fwd != rev);
        S.h[j] = ok ? (st ? rev : fwd) : U64MAX;
        S.strand[j] = st;
    }
    for (int j = 0; j < m; ++j) {  // pass 2: vectorized invertible hash
        uint64_t x = S.h[j];
        S.h[j] = x == U64MAX ? U64MAX : mm_hash64(x, mask);
    }
    // minimizer selection
    S.sortbuf.clear();  // reuse as minimizer position list
    if (m <= w) {
        int jm = 0;
        for (int j = 1; j < m; ++j)
            if (S.h[j] < S.h[jm]) jm = j;
        if (S.h[jm] != U64MAX) S.sortbuf.push_back(jm);
    } else {
        // monotonic deque (buffer lives in Scratch: a per-read malloc here
        // dominated the scan cost)
        auto& dq = S.dq;
        dq.resize(m);
        // tie-preserving monotonic deque (pop on strictly-greater, so equal
        // values stay queued and the deque is value-nondecreasing from the
        // head): a position j is selected iff some window's minimum equals
        // h[j], i.e. iff j appears in the head-run of equal minima of a
        // window.  Window-min positions are nondecreasing as the window
        // slides and each head-run is position-ascending, so emitting only
        // j > last_emit yields every selected position exactly once, in
        // ascending order — identical output to the O(m*w) scan of the
        // numpy oracle (batch.py::batch_minimizers), amortized O(1)/base.
        int head = 0, tail = 0;
        int last_emit = -1;
        for (int i = 0; i < m; ++i) {
            while (tail > head && S.h[dq[tail - 1]] > S.h[i]) --tail;
            dq[tail++] = i;
            if (dq[head] <= i - w) ++head;
            if (i >= w - 1) {
                uint64_t mv = S.h[dq[head]];
                if (mv == U64MAX) continue;
                for (int x = head; x < tail && S.h[dq[x]] == mv; ++x) {
                    int j = dq[x];
                    if (j > last_emit) {
                        S.sortbuf.push_back(j);
                        last_emit = j;
                    }
                }
            }
        }
    }
    for (int64_t jj : S.sortbuf) {
        int j = (int)jj;
        S.minpos.push_back((int32_t)j);
        S.minhash.push_back(S.h[j]);
        S.minstrand.push_back(S.strand[j]);
    }
}

// Mirrors align/batch.py::_align_chunk per-read semantics (incl. best/second
// cluster selection by votes with (rel, diag) creation-order tie-break).
// mpos/mhash/mstrand/nmin: optional precomputed minimizer triples from
// min_scan (nmin < 0 => scan inline).
static void align_one(const Ctx& C, Scratch& S, const uint8_t* seq_bytes,
                      int lq, Aln& a, const int32_t* mpos = nullptr,
                      const uint64_t* mhash = nullptr,
                      const uint8_t* mstrand = nullptr, int64_t nmin = -1) {
    int k = C.k, w = C.w;
    if (lq - k + 1 <= 0) return;
    encode_read(seq_bytes, lq, S.codes);
    const uint8_t* codes = S.codes.data();
    if (nmin < 0) {
        min_scan(k, w, codes, lq, S);
        mpos = S.minpos.data();
        mhash = S.minhash.data();
        mstrand = S.minstrand.data();
        nmin = (int64_t)S.minpos.size();
    }
    if (nmin == 0) return;
    // anchors per rel strand: (diag, qv)
    S.diag0.clear();
    S.qv0.clear();
    S.diag1.clear();
    S.qv1.clear();
    for (int64_t ii = 0; ii < nmin; ++ii) {
        int j = (int)mpos[ii];
        uint64_t hv = mhash[ii];
        uint8_t st = mstrand[ii];
        int64_t lo = C.lookup(hv);  // first row of hv's run (index sorted)
        if (lo < 0) continue;
        int64_t e = lo;
        while (e < C.m_idx && C.idx_h[e] == hv) ++e;
        for (int64_t t = lo; t < e; ++t) {
            int rel = C.idx_strand[t] ^ st;
            int64_t pos = C.idx_pos[t];
            if (rel == 0) {
                S.diag0.push_back(pos - j);
                S.qv0.push_back(j);
            } else {
                S.diag1.push_back(pos - (lq - k - j));
                S.qv1.push_back(lq - k - j);
            }
        }
    }
    // cluster per rel (sorted by diag, split on gaps > MAX_GAP)
    auto& clus = S.clus;
    auto& ord = S.ord;
    clus.clear();
    for (int rel = 0; rel < 2; ++rel) {
        auto& D = rel == 0 ? S.diag0 : S.diag1;
        auto& Q = rel == 0 ? S.qv0 : S.qv1;
        size_t n = D.size();
        if (n == 0) continue;
        ord.resize(n);
        for (size_t i = 0; i < n; ++i) ord[i] = (int)i;
        if (n <= 48) {
            // insertion sort (stable): typical anchor counts are ~10-30 and
            // stable_sort's temp-buffer malloc per read dominated this phase
            for (size_t i = 1; i < n; ++i) {
                int x = ord[i];
                size_t j = i;
                while (j > 0 && D[x] < D[ord[j - 1]]) {
                    ord[j] = ord[j - 1];
                    --j;
                }
                ord[j] = x;
            }
        } else {
            std::stable_sort(ord.begin(), ord.end(),
                             [&](int x, int y) { return D[x] < D[y]; });
        }
        size_t s0 = 0;
        for (size_t i = 1; i <= n; ++i) {
            if (i == n || D[ord[i]] - D[ord[i - 1]] > MAX_GAP) {
                int64_t qmn = Q[ord[s0]], qmx = Q[ord[s0]];
                for (size_t x = s0; x < i; ++x) {
                    qmn = std::min(qmn, Q[ord[x]]);
                    qmx = std::max(qmx, Q[ord[x]]);
                }
                Clu c;
                c.votes = (int)(i - s0);
                c.span = (int)std::min<int64_t>(qmx - qmn + k, lq);
                // batch.py: med = d_s[(gstart+gend-1)//2] (lower middle)
                c.med = D[ord[s0 + (i - s0 - 1) / 2]];
                c.dmin = D[ord[s0]];
                c.dmax = D[ord[i - 1]];
                c.rel = rel;
                clus.push_back(c);
                s0 = i;
            }
        }
    }
    if (clus.empty()) return;
    // best by votes, creation-order tie-break; second = max votes among rest
    int bi = 0;
    for (size_t i = 1; i < clus.size(); ++i)
        if (clus[i].votes > clus[bi].votes) bi = (int)i;
    int second = 0;
    for (size_t i = 0; i < clus.size(); ++i)
        if ((int)i != bi) second = std::max(second, clus[i].votes);
    const Clu& B = clus[bi];
    if (B.votes < MIN_CNT || B.span < MIN_CHAIN_SCORE) return;
    // oriented read
    const uint8_t* q;
    if (B.rel == 0) {
        q = codes;
    } else {
        S.oriented.resize(lq);
        for (int i = 0; i < lq; ++i) {
            uint8_t c = codes[lq - 1 - i];
            S.oriented[i] = c < 4 ? (uint8_t)(3 - c) : 4;
        }
        q = S.oriented.data();
    }
    // batch fast path check (verify on med diagonal)
    Verify V = verify_diag(q, lq, C.ref, C.lr, B.med, S);
    bool single = B.dmin == B.dmax;
    int clip5 = V.qs, clip3 = lq - V.qe;
    bool needs_dp = !single || clip5 >= 10 || clip3 >= 10 || V.score <= 0;
    bool fast_ok = !needs_dp && V.raw >= MIN_DP_MAX && (V.qe - V.qs) >= k;
    if (fast_ok) {
        a.mapped = true;
        a.score = V.raw;
        a.rev = B.rel;
        a.rs = (int)(B.med + V.qs);
        a.re = (int)(B.med + V.qe);
        a.cig.push(V.qe - V.qs, 'M');
        a.nm = V.nm;
        if (B.votes >= 3 && second * 2 <= B.votes)
            a.mapq = 60;
        else {
            int mq = (int)(40.0 * (1.0 - (second + 1.0) / (B.votes + 1.0)));
            a.mapq = std::max(1, std::min(60, mq));
        }
        a.qs = V.qs;
        a.qe = V.qe;
        return;
    }
    extend(C, S, q, lq, B.med, B.dmin, B.dmax, B.votes, second, a);
    if (a.mapped || a.defer) a.rev = B.rel;
}

}  // namespace sr

extern "C" {

// Batched short-read alignment (native twin of BatchAligner.align_batch).
// qs/qe outputs are ORIENTED coordinates (caller flips for rev reads, like
// batch.py does).  out_mapped: 0=unmapped, 1=mapped, 2=cigar overflow (caller
// must realign that read with the Python oracle path).
// Batched read-side minimizer precompute (phase 1 of pt_align_sr; reference-
// independent, so it can run while the placement device program is in
// flight).  Caller supplies worst-case CSR offsets wc_off[i] = cumsum of
// max(lq_i - k + 1, 0); triples for read i land at [wc_off[i],
// wc_off[i] + out_cnt[i]).
void pt_min_sr(const uint8_t* joined, const int64_t* offsets, int64_t n_reads,
               int k, int w, int n_threads, const int64_t* wc_off,
               int32_t* out_cnt, int32_t* out_pos, uint64_t* out_hash,
               uint8_t* out_strand) {
    if (n_threads < 1) n_threads = 1;
    auto work = [&](int64_t a0, int64_t b0) {
        sr::Scratch S;
        for (int64_t i = a0; i < b0; ++i) {
            const uint8_t* sb = joined + offsets[i];
            int lq = (int)(offsets[i + 1] - offsets[i]);
            out_cnt[i] = 0;
            if (lq - k + 1 <= 0) continue;
            sr::encode_read(sb, lq, S.codes);
            sr::min_scan(k, w, S.codes.data(), lq, S);
            int n = (int)S.minpos.size();
            out_cnt[i] = n;
            int64_t o = wc_off[i];
            for (int x = 0; x < n; ++x) {
                out_pos[o + x] = S.minpos[x];
                out_hash[o + x] = S.minhash[x];
                out_strand[o + x] = S.minstrand[x];
            }
        }
    };
    if (n_threads == 1 || n_reads < 256) {
        work(0, n_reads);
        return;
    }
    std::vector<std::thread> threads;
    int64_t chunk = (n_reads + n_threads - 1) / n_threads;
    for (int ti = 0; ti < n_threads; ++ti) {
        int64_t a0 = ti * chunk, b0 = std::min<int64_t>(a0 + chunk, n_reads);
        if (a0 >= b0) break;
        threads.emplace_back(work, a0, b0);
    }
    for (auto& th : threads) th.join();
}

static void align_sr_impl(const uint8_t* joined, const int64_t* offsets,
                          int64_t n_reads, const int64_t* rows, int64_t n_rows,
                          const uint8_t* ref_codes, int64_t lr,
                          const uint64_t* idx_h, const int32_t* idx_pos,
                          const uint8_t* idx_strand, int64_t m_idx, int k,
                          int w, int n_threads, int cigar_cap,
                          uint8_t* out_mapped, uint8_t* out_rev,
                          int32_t* out_rs, int32_t* out_re, int32_t* out_qs,
                          int32_t* out_qe, int32_t* out_score,
                          int32_t* out_mapq, int32_t* out_nm,
                          int32_t* out_ncig, uint32_t* out_cig, int defer_dp,
                          const int64_t* pre_off, const int32_t* pre_cnt,
                          const int32_t* pre_pos, const uint64_t* pre_hash,
                          const uint8_t* pre_strand) {
    sr::Ctx C{ref_codes, lr, idx_h, idx_pos, idx_strand, m_idx, k, w,
              defer_dp};
    int64_t n_items = rows != nullptr ? n_rows : n_reads;
    // the O(m_idx) table build only pays for itself on bulk calls; small
    // subset realignments (the latency-sensitive below-breakeven routing)
    // use the binary-search fallback
    if (n_items * 64 >= m_idx) C.build_table();
    if (n_threads < 1) n_threads = 1;
    bool pre = pre_off != nullptr && pre_cnt != nullptr;
    auto work = [&](int64_t a0, int64_t b0) {
        sr::Scratch S;
        for (int64_t x = a0; x < b0; ++x) {
            int64_t i = rows != nullptr ? rows[x] : x;
            const uint8_t* sb = joined + offsets[i];
            int lq = (int)(offsets[i + 1] - offsets[i]);
            sr::Aln A;
            if (pre)
                sr::align_one(C, S, sb, lq, A, pre_pos + pre_off[i],
                              pre_hash + pre_off[i], pre_strand + pre_off[i],
                              pre_cnt[i]);
            else
                sr::align_one(C, S, sb, lq, A);
            if (A.defer) {
                // mapped==3: full-window DP deferred to the device scoring
                // stage.  Field reuse: rs/re = window [lo,hi), score = votes,
                // nm = second-best votes, rev = rel strand.
                out_mapped[i] = 3;
                out_rev[i] = A.rev;
                out_rs[i] = (int32_t)A.wlo;
                out_re[i] = (int32_t)A.whi;
                out_score[i] = A.votes;
                out_nm[i] = A.second;
                continue;
            }
            if (!A.mapped) {
                out_mapped[i] = 0;
                continue;
            }
            if ((int)A.cig.ops.size() > cigar_cap) {
                out_mapped[i] = 2;
                continue;
            }
            out_mapped[i] = 1;
            out_rev[i] = A.rev;
            out_rs[i] = A.rs;
            out_re[i] = A.re;
            out_qs[i] = A.qs;
            out_qe[i] = A.qe;
            out_score[i] = A.score;
            out_mapq[i] = A.mapq;
            out_nm[i] = A.nm;
            out_ncig[i] = (int32_t)A.cig.ops.size();
            uint32_t* oc = out_cig + (size_t)i * cigar_cap;
            static const char* OPS = "MIDNSHP=X";
            for (size_t c = 0; c < A.cig.ops.size(); ++c) {
                uint32_t op = 0;
                for (int x = 0; x < 9; ++x)
                    if (OPS[x] == A.cig.ops[c].second) {
                        op = x;
                        break;
                    }
                oc[c] = ((uint32_t)A.cig.ops[c].first << 4) | op;
            }
        }
    };
    if (n_threads == 1 || n_items < 256) {
        work(0, n_items);
        return;
    }
    std::vector<std::thread> threads;
    int64_t chunk = (n_items + n_threads - 1) / n_threads;
    for (int ti = 0; ti < n_threads; ++ti) {
        int64_t a0 = ti * chunk, b0 = std::min<int64_t>(a0 + chunk, n_items);
        if (a0 >= b0) break;
        threads.emplace_back(work, a0, b0);
    }
    for (auto& th : threads) th.join();
}

void pt_align_sr(const uint8_t* joined, const int64_t* offsets,
                 int64_t n_reads, const uint8_t* ref_codes, int64_t lr,
                 const uint64_t* idx_h, const int32_t* idx_pos,
                 const uint8_t* idx_strand, int64_t m_idx, int k, int w,
                 int n_threads, int cigar_cap, uint8_t* out_mapped,
                 uint8_t* out_rev, int32_t* out_rs, int32_t* out_re,
                 int32_t* out_qs, int32_t* out_qe, int32_t* out_score,
                 int32_t* out_mapq, int32_t* out_nm, int32_t* out_ncig,
                 uint32_t* out_cig, int defer_dp, const int64_t* pre_off,
                 const int32_t* pre_cnt, const int32_t* pre_pos,
                 const uint64_t* pre_hash, const uint8_t* pre_strand) {
    align_sr_impl(joined, offsets, n_reads, nullptr, 0, ref_codes, lr, idx_h,
                  idx_pos, idx_strand, m_idx, k, w, n_threads, cigar_cap,
                  out_mapped, out_rev, out_rs, out_re, out_qs, out_qe,
                  out_score, out_mapq, out_nm, out_ncig, out_cig, defer_dp,
                  pre_off, pre_cnt, pre_pos, pre_hash, pre_strand);
}

// Realign a SUBSET of reads (by index) with the full DP enabled — used to
// resolve deferred (mapped==3) rows natively in ONE call instead of a
// python-side per-row DP loop.  Identical outputs to align_one with
// defer_dp=0 by construction (same window formula, same banded DP).
void pt_align_sr_rows(const uint8_t* joined, const int64_t* offsets,
                      int64_t n_reads, const int64_t* rows, int64_t n_rows,
                      const uint8_t* ref_codes, int64_t lr,
                      const uint64_t* idx_h, const int32_t* idx_pos,
                      const uint8_t* idx_strand, int64_t m_idx, int k, int w,
                      int n_threads, int cigar_cap, uint8_t* out_mapped,
                      uint8_t* out_rev, int32_t* out_rs, int32_t* out_re,
                      int32_t* out_qs, int32_t* out_qe, int32_t* out_score,
                      int32_t* out_mapq, int32_t* out_nm, int32_t* out_ncig,
                      uint32_t* out_cig, const int64_t* pre_off,
                      const int32_t* pre_cnt, const int32_t* pre_pos,
                      const uint64_t* pre_hash, const uint8_t* pre_strand) {
    align_sr_impl(joined, offsets, n_reads, rows, n_rows, ref_codes, lr,
                  idx_h, idx_pos, idx_strand, m_idx, k, w, n_threads,
                  cigar_cap, out_mapped, out_rev, out_rs, out_re, out_qs,
                  out_qe, out_score, out_mapq, out_nm, out_ncig, out_cig, 0,
                  pre_off, pre_cnt, pre_pos, pre_hash, pre_strand);
}

}  // extern "C"

extern "C" {

// Ragged row copy: out[dst_off[i] : dst_off[i]+lens[i]] =
// blob[src_off[i] : src_off[i]+lens[i]].  The numpy formulation (two
// np.repeat's + arange + fancy index per section) streams ~6 passes of i64
// indices per byte moved; this is a memcpy per row.  Used by the columnar
// BAM encode's section scatter and the emit-order blob reorders (the numpy
// twin remains the fallback/oracle in io/bam.py + pipeline.py).
void pt_copy_rows(const uint8_t* blob, const int64_t* src_off,
                  const int64_t* dst_off, const int64_t* lens, int64_t n,
                  uint8_t* out) {
    for (int64_t i = 0; i < n; ++i)
        if (lens[i] > 0) memcpy(out + dst_off[i], blob + src_off[i],
                                (size_t)lens[i]);
}

// Oriented per-record seq/qual blobs (pipeline._emit_columnar lines around
// the src gather): record i copies L=eoff[i+1]-eoff[i] bytes from
// joined/jq at src_off[i]; rev records reverse and complement (seq via the
// caller-supplied 256-byte LUT — the python _RC_LUT stays the single
// definition site); quals subtract 33.
void pt_oriented_blobs(const uint8_t* joined, const uint8_t* jq,
                       const int64_t* src_off, const int64_t* eoff,
                       const uint8_t* rev, int64_t nrec, const uint8_t* lut,
                       uint8_t* seq_blob, uint8_t* qual_blob) {
    for (int64_t i = 0; i < nrec; ++i) {
        int64_t d = eoff[i];
        int64_t L = eoff[i + 1] - d;
        const uint8_t* s = joined + src_off[i];
        const uint8_t* q = jq + src_off[i];
        if (rev[i]) {
            for (int64_t j = 0; j < L; ++j) {
                seq_blob[d + j] = lut[s[L - 1 - j]];
                qual_blob[d + j] = (uint8_t)(q[L - 1 - j] - 33);
            }
        } else {
            for (int64_t j = 0; j < L; ++j) {
                seq_blob[d + j] = s[j];
                qual_blob[d + j] = (uint8_t)(q[j] - 33);
            }
        }
    }
}

}  // extern "C"

extern "C" {

// test shims for the DP kernels (cross-checked against the numpy oracles)
int pt_dbg_banded(const uint8_t* q, int lq, const uint8_t* r, int lr,
                  int32_t* out5 /*qs,qe,rs,re,ncig*/, uint32_t* cig,
                  int cap) {
    sr::Scratch S;
    sr::Cigar cg;
    int qs = 0, qe = 0, rs = 0, re = 0;
    int sc = sr::banded_affine_dp(q, lq, r, lr, S, qs, qe, rs, re, cg);
    out5[0] = qs; out5[1] = qe; out5[2] = rs; out5[3] = re;
    int n = (int)cg.ops.size();
    out5[4] = n > cap ? -1 : n;
    static const char* OPS = "MIDNSHP=X";
    for (int c = 0; c < n && c < cap; ++c) {
        uint32_t op = 0;
        for (int x = 0; x < 9; ++x) if (OPS[x] == cg.ops[c].second) { op = x; break; }
        cig[c] = ((uint32_t)cg.ops[c].first << 4) | op;
    }
    return sc;
}

int pt_dbg_extension(const uint8_t* q, int lq, const uint8_t* r, int lr,
                     int32_t* out3 /*qext,rext,ncig*/, uint32_t* cig,
                     int cap) {
    sr::Scratch S;
    sr::Cigar cg;
    int qext = 0, rext = 0;
    int sc = sr::extension_dp(q, lq, r, lr, S, qext, rext, cg);
    out3[0] = qext; out3[1] = rext;
    int n = (int)cg.ops.size();
    out3[2] = n > cap ? -1 : n;
    static const char* OPS = "MIDNSHP=X";
    for (int c = 0; c < n && c < cap; ++c) {
        uint32_t op = 0;
        for (int x = 0; x < 9; ++x) if (OPS[x] == cg.ops[c].second) { op = x; break; }
        cig[c] = ((uint32_t)cg.ops[c].first << 4) | op;
    }
    return sc;
}

}  // extern "C"

extern "C" {

// debug: minimizer positions+hashes+strands for one read (native scan)
int pt_dbg_minimizers(const uint8_t* seq, int lq, int k, int w,
                      int32_t* out_pos, uint64_t* out_h, uint8_t* out_st,
                      int cap) {
    sr::Ctx C{nullptr, 0, nullptr, nullptr, nullptr, 0, k, w};
    sr::Scratch S;
    // replicate align_one's scan up to minimizer selection
    int m = lq - k + 1;
    if (m <= 0) return 0;
    S.codes.resize(lq);
    for (int i = 0; i < lq; ++i) {
        uint8_t b = seq[i];
        uint8_t c;
        switch (b) {
            case 'A': case 'a': c = 0; break;
            case 'C': case 'c': c = 1; break;
            case 'G': case 'g': c = 2; break;
            case 'T': case 't': c = 3; break;
            default: c = 4;
        }
        S.codes[i] = c;
    }
    const uint8_t* codes = S.codes.data();
    uint64_t mask = (k < 32) ? ((1ULL << (2 * k)) - 1) : ~0ULL;
    S.h.resize(m);
    S.strand.resize(m);
    uint64_t fwd = 0, rev = 0;
    int ambig = 0;
    for (int i = 0; i < k - 1; ++i) {
        uint8_t c = codes[i];
        fwd = (fwd << 2) | (c & 3);
        rev |= (uint64_t)(3 - std::min<int>(c, 3)) << (2 * (i + 1));
        ambig += c >= 4;
    }
    for (int j = 0; j < m; ++j) {
        uint8_t c = codes[j + k - 1];
        fwd = ((fwd << 2) | (c & 3)) & mask;
        rev = (rev >> 2) | ((uint64_t)(3 - std::min<int>(c, 3)) << (2 * (k - 1)));
        ambig += c >= 4;
        if (j > 0) ambig -= codes[j - 1] >= 4;
        uint8_t st = rev < fwd;
        uint64_t canon = st ? rev : fwd;
        bool ok = (ambig == 0) && (fwd != rev);
        S.h[j] = ok ? sr::mm_hash64(canon, mask) : U64MAX;
        S.strand[j] = st;
    }
    int n = 0;
    if (m <= w) {
        int jm = 0;
        for (int j = 1; j < m; ++j)
            if (S.h[j] < S.h[jm]) jm = j;
        if (S.h[jm] != U64MAX && n < cap) {
            out_pos[n] = jm; out_h[n] = S.h[jm]; out_st[n] = S.strand[jm]; ++n;
        }
    } else {
        int nwin = m - w + 1;
        std::vector<int> dq(m);
        std::vector<uint64_t> wm(nwin);
        int head = 0, tail = 0;
        for (int i = 0; i < m; ++i) {
            while (tail > head && S.h[dq[tail - 1]] >= S.h[i]) --tail;
            dq[tail++] = i;
            if (dq[head] <= i - w) ++head;
            if (i >= w - 1) wm[i - w + 1] = S.h[dq[head]];
        }
        for (int j = 0; j < m; ++j) {
            if (S.h[j] == U64MAX) continue;
            int i0 = std::max(0, j - w + 1);
            int i1 = std::min(nwin - 1, j);
            for (int i = i0; i <= i1; ++i)
                if (wm[i] == S.h[j]) {
                    if (n < cap) { out_pos[n] = j; out_h[n] = S.h[j]; out_st[n] = S.strand[j]; ++n; }
                    break;
                }
        }
    }
    return n;
}

}  // extern "C"

extern "C" {

// Tree-prefix metric accumulation for placement scoring (the per-node loop
// of place/engine.py::score_nodes): for node i in DFS order,
//   acc[i] = acc[parent[i]]; for row r in [offs[i], offs[i+1]): acc[i] += d[r]
// with f64 adds in exactly that order (bit-exact with the numpy
// cumsum([base, rows...]) formulation it replaces).
void pt_tree_accumulate(const double* d0, const double* d1, const double* d2,
                        const double* d3, const double* d4,
                        const int64_t* i0, const int64_t* i1,
                        const uint64_t* offs, const uint32_t* parent,
                        int64_t n_nodes, double* acc_f /*[N,5]*/,
                        int64_t* acc_i /*[N,2]*/) {
    for (int64_t i = 0; i < n_nodes; ++i) {
        double f0 = 0, f1 = 0, f2 = 0, f3 = 0, f4 = 0;
        int64_t v0 = 0, v1 = 0;
        if (i) {
            const double* pf = acc_f + (size_t)parent[i] * 5;
            const int64_t* pi = acc_i + (size_t)parent[i] * 2;
            f0 = pf[0]; f1 = pf[1]; f2 = pf[2]; f3 = pf[3]; f4 = pf[4];
            v0 = pi[0]; v1 = pi[1];
        }
        for (uint64_t r = offs[i]; r < offs[i + 1]; ++r) {
            f0 += d0[r];
            f1 += d1[r];
            f2 += d2[r];
            f3 += d3[r];
            f4 += d4[r];
            v0 += i0[r];
            v1 += i1[r];
        }
        double* of = acc_f + (size_t)i * 5;
        int64_t* oi = acc_i + (size_t)i * 2;
        of[0] = f0; of[1] = f1; of[2] = f2; of[3] = f3; of[4] = f4;
        oi[0] = v0; oi[1] = v1;
    }
}

}  // extern "C"

// ======================================================================
// Pseudochain scorer (native twin of meta/engine.py::score_all_pseudo;
// reference: mgsr.cpp:4616-5526 minichains + isColinearFromMinichains,
// gapMap/getLocalGap mgsr.cpp:2273-2622,5280-5310).
//
// Exact mirror of the python oracle: only READ-RELEVANT delta rows feed the
// position structures (the python deviation from the reference's all-seed
// positionMap is documented in PARITY.md), chains are rebuilt per affected
// read, ref gaps degap through the per-node gap-event stream.  Threads
// partition READS (the reference's ThreadsManager scheme): each worker
// replays the identical global delta/gap stream but rescans only its own
// read range, so outputs are bit-equal to a single-thread run.
// ======================================================================

#include <map>
#include <set>
#include <unordered_map>

namespace pseudo {

struct Fenwick {
    int64_t n;
    std::vector<int64_t> t;
    explicit Fenwick(int64_t n_) : n(n_), t(n_ + 1, 0) {}
    void build(const std::vector<int64_t>& vals) {
        std::vector<int64_t> cs(n + 1, 0);
        for (int64_t i = 0; i < n; ++i) cs[i + 1] = cs[i] + vals[i];
        for (int64_t i = 1; i <= n; ++i) {
            int64_t low = i & (-i);
            t[i] = cs[i] - cs[i - low];
        }
    }
    void update(int64_t i, int64_t d) {
        for (++i; i <= n; i += i & (-i)) t[i] += d;
    }
    int64_t prefix(int64_t i) const {  // sum of [0, i]
        int64_t s = 0;
        for (++i; i > 0; i -= i & (-i)) s += t[i];
        return s;
    }
    int64_t range(int64_t a, int64_t b) const {
        if (b < a) return 0;
        return prefix(b) - (a ? prefix(a - 1) : 0);
    }
};

struct Ctx {
    const int64_t* node_offsets;
    int64_t n_nodes;
    const uint32_t* parent_index;
    const int32_t* delta_seed;
    const uint8_t* delta_is_del;
    const uint64_t* seed_hash;
    const uint8_t* seed_rev;
    const int64_t* seed_pos;
    const int64_t* seed_end;
    const int64_t* gev_offsets;
    const int64_t* gev_pos;
    const uint8_t* gev_nongap;
    const int64_t* bev_offsets;
    const int32_t* bev_block;
    const int8_t* bev_code;
    const int64_t* block_lo;
    const int64_t* block_hi;
    int64_t n_blocks;
    const uint8_t* nongap0_bits;
    int64_t n_scalar;
    const int64_t* read_off;
    const uint64_t* read_hash;
    const uint8_t* read_rev;
    const int64_t* read_qbeg;
    const int64_t* read_qend;
    int64_t n_reads;
    const uint8_t* relevant;  // [n_delta] global read-relevance mask
    const int32_t* cand_nodes;
    int64_t n_cand;
    int32_t maximum_gap;
    // derived (shared, read-only after setup)
    std::vector<std::vector<int32_t>> children;
    std::vector<int32_t> cand_of_node;  // -1 or candidate slot
    // global occ: sorted unique hashes + CSR of read ids
    std::vector<uint64_t> occ_hash;
    std::vector<int64_t> occ_off;
    std::vector<int32_t> occ_read;
};

struct GapTracker {
    const Ctx* c;
    std::vector<uint8_t> present, strand;
    std::vector<int64_t> tot;
    Fenwick fen, bfen;
    struct Undo {
        uint8_t kind;  // 0 = gev, 1 = bev
        int64_t a;     // gev: scalar; bev: block
        int64_t b;     // gev: block;  bev: old present | (old strand << 1)
        int64_t d;     // gev: delta
    };
    explicit GapTracker(const Ctx* c_)
        : c(c_), present(c_->n_blocks, 0), strand(c_->n_blocks, 1),
          tot(c_->n_blocks, 0), fen(c_->n_scalar), bfen(c_->n_blocks) {
        std::vector<int64_t> bits(c->n_scalar, 0);
        for (int64_t i = 0; i < c->n_scalar; ++i)
            bits[i] = (c->nongap0_bits[i >> 3] >> (i & 7)) & 1;
        fen.build(bits);
        std::vector<int64_t> cs(c->n_scalar + 1, 0);
        for (int64_t i = 0; i < c->n_scalar; ++i) cs[i + 1] = cs[i] + bits[i];
        for (int64_t b = 0; b < c->n_blocks; ++b)
            tot[b] = cs[c->block_hi[b] + 1] - cs[c->block_lo[b]];
    }
    int64_t block_of(int64_t sc) const {
        const int64_t* lo = c->block_lo;
        return (std::upper_bound(lo, lo + c->n_blocks, sc) - lo) - 1;
    }
    void enter(int64_t node, std::vector<Undo>& undo) {
        for (int64_t i = c->bev_offsets[node]; i < c->bev_offsets[node + 1];
             ++i) {
            int64_t b = c->bev_block[i];
            int code = c->bev_code[i];
            uint8_t op = present[b], os = strand[b];
            uint8_t newp = code != 0;
            if (present[b] != newp)
                bfen.update(b, newp ? tot[b] : -tot[b]);
            present[b] = newp;
            strand[b] = code != 2;
            undo.push_back({1, b, (int64_t)(op | (os << 1)), 0});
        }
        for (int64_t i = c->gev_offsets[node]; i < c->gev_offsets[node + 1];
             ++i) {
            int64_t sc = c->gev_pos[i];
            int64_t d = c->gev_nongap[i] ? 1 : -1;
            fen.update(sc, d);
            int64_t b = block_of(sc);
            tot[b] += d;
            if (present[b]) bfen.update(b, d);
            undo.push_back({0, sc, b, d});
        }
    }
    void leave(const std::vector<Undo>& undo) {
        for (auto it = undo.rbegin(); it != undo.rend(); ++it) {
            if (it->kind == 0) {
                fen.update(it->a, -it->d);
                tot[it->b] -= it->d;
                if (present[it->b]) bfen.update(it->b, -it->d);
            } else {
                int64_t b = it->a;
                uint8_t op = it->b & 1, os = (it->b >> 1) & 1;
                if (present[b] != op)
                    bfen.update(b, op ? tot[b] : -tot[b]);
                present[b] = op;
                strand[b] = os;
            }
        }
    }
    int64_t F(int64_t x) const {
        int64_t b = block_of(x);
        int64_t lo = c->block_lo[b], hi = c->block_hi[b];
        int64_t inblk = strand[b] ? fen.range(lo, x)
                                  : fen.range(lo + hi - x, hi);
        return (b ? bfen.prefix(b - 1) : 0) + inblk;
    }
    int64_t local_gap(int64_t a, int64_t b) const {
        int64_t d = F(b) - F(a);
        return d < 0 ? -d : d;
    }
};

struct PosEntry {
    int64_t pos;
    uint8_t rev;
    int64_t end;
};

struct Worker {
    const Ctx* c;
    int64_t r_lo, r_hi;
    // hash -> active positions (tiny vectors; overwrite-on-equal like dict)
    std::unordered_map<uint64_t, std::vector<PosEntry>> hash_pos;
    std::multiset<int64_t> act;  // mirrors the python pos_arr multiset
    GapTracker gap;
    std::vector<int32_t> score, max_score;
    std::vector<uint16_t> snap;  // [n_cand, n_reads] rows for ALL reads
    std::vector<int64_t> stamp;
    int64_t token = 0;
    std::vector<int32_t> touched;

    Worker(const Ctx* c_, int64_t lo, int64_t hi)
        : c(c_), r_lo(lo), r_hi(hi), gap(c_),
          score(c_->n_reads, 0), max_score(c_->n_reads, 0),
          snap((size_t)c_->n_cand * (hi - lo), 0),  // own read slice only
          stamp(c_->n_reads, -1) {}

    uint64_t apply_row(int64_t r, int sign) {
        int64_t sid = c->delta_seed[r];
        uint64_t h = c->seed_hash[sid];
        uint8_t rv = c->seed_rev[sid];
        int64_t p = c->seed_pos[sid];
        int64_t en = c->seed_end[sid];
        bool isdel = (bool)c->delta_is_del[r] != (sign < 0);
        auto& d = hash_pos[h];
        if (!isdel) {
            bool found = false;
            for (auto& e : d)
                if (e.pos == p) { e.rev = rv; e.end = en; found = true; break; }
            if (!found) d.push_back({p, rv, en});
            act.insert(p);  // python inserts unconditionally (even overwrite)
        } else {
            for (size_t i = 0; i < d.size(); ++i)
                if (d[i].pos == p) { d.erase(d.begin() + i); break; }
            auto it = act.lower_bound(p);
            if (it != act.end() && *it == p) act.erase(it);
            if (d.empty()) hash_pos.erase(h);
        }
        return h;
    }

    const PosEntry* unique_entry(uint64_t h) const {
        auto it = hash_pos.find(h);
        if (it == hash_pos.end() || it->second.size() != 1) return nullptr;
        return &it->second[0];
    }

    int32_t chain_score(int64_t ridx) {
        int64_t o = c->read_off[ridx], n = c->read_off[ridx + 1] - o;
        const uint64_t* hs = c->read_hash + o;
        const uint8_t* rvs = c->read_rev + o;
        struct Chain { int64_t b, e; bool rev; int64_t pb, pe; };
        std::vector<Chain> chains;
        int64_t i = 0;
        while (i < n) {
            int64_t cadv = 1;
            const PosEntry* pe0 = unique_entry(hs[i]);
            if (pe0) {
                int64_t p = pe0->pos;
                bool rev = ((bool)rvs[i]) != (bool)pe0->rev;
                int64_t j = i, curp = p;
                auto ia = act.lower_bound(curp);
                while (j + 1 < n) {
                    const PosEntry* pn = unique_entry(hs[j + 1]);
                    if (!pn) break;
                    int64_t np_ = pn->pos;
                    if ((((bool)rvs[j + 1]) != (bool)pn->rev) != rev) break;
                    if (rev) {
                        if (ia == act.begin() || *std::prev(ia) != np_) break;
                        --ia;
                    } else {
                        auto nx = std::next(ia);
                        if (nx == act.end() || *nx != np_) break;
                        ia = nx;
                    }
                    ++j;
                    curp = np_;
                    ++cadv;
                }
                chains.push_back({i, j, rev, p, curp});
            }
            i += cadv;
        }
        if (chains.empty()) return 0;
        if (chains.size() == 1) return (int32_t)(chains[0].e - chains[0].b + 1);
        size_t li = 0;
        for (size_t x = 1; x < chains.size(); ++x)
            if (chains[x].e - chains[x].b > chains[li].e - chains[li].b)
                li = x;
        const Chain& L = chains[li];
        int64_t total = L.e - L.b + 1;
        auto end_of = [&](int64_t idx) {
            return hash_pos.find(hs[idx])->second[0].end;
        };
        const int64_t* qb = c->read_qbeg + o;
        const int64_t* qe = c->read_qend + o;
        for (size_t x = 0; x < chains.size(); ++x) {
            if (x == li || chains[x].rev != L.rev) continue;
            const Chain& F_ = (li < x) ? L : chains[x];
            const Chain& S_ = (li < x) ? chains[x] : L;
            int64_t qgap = qb[S_.b] - qe[F_.e];
            if (qgap < 0) qgap = -qgap;
            bool ok;
            if (!chains[x].rev) {
                int64_t rgap = gap.local_gap(S_.pb, end_of(F_.e));
                int64_t dd = qgap - rgap;
                if (dd < 0) dd = -dd;
                ok = F_.pb < S_.pb && dd < c->maximum_gap;
            } else {
                int64_t rgap = gap.local_gap(F_.pe, end_of(S_.b));
                int64_t dd = qgap - rgap;
                if (dd < 0) dd = -dd;
                ok = S_.pe < F_.pe && dd < c->maximum_gap;
            }
            if (ok) total += chains[x].e - chains[x].b + 1;
        }
        return (int32_t)total;
    }

    // distinct reads in [r_lo, r_hi) touched by the node's relevant rows
    void collect_touched(int64_t row_lo, int64_t row_hi) {
        touched.clear();
        ++token;
        for (int64_t r = row_lo; r < row_hi; ++r) {
            if (!c->relevant[r]) continue;
            uint64_t h = c->seed_hash[c->delta_seed[r]];
            auto it = std::lower_bound(c->occ_hash.begin(), c->occ_hash.end(),
                                       h);
            if (it == c->occ_hash.end() || *it != h) continue;
            int64_t u = it - c->occ_hash.begin();
            for (int64_t k = c->occ_off[u]; k < c->occ_off[u + 1]; ++k) {
                int32_t ridx = c->occ_read[k];
                if (ridx < r_lo || ridx >= r_hi) continue;
                if (stamp[ridx] == token) continue;
                stamp[ridx] = token;
                touched.push_back(ridx);
            }
        }
        std::sort(touched.begin(), touched.end());
    }

    void run() {
        struct Frame {
            int32_t node;
            uint8_t done;
            int64_t undo_base;  // index into gap undo arena
        };
        std::vector<Frame> stack;
        std::vector<std::vector<GapTracker::Undo>> undo_pool;
        stack.push_back({0, 0, -1});
        while (!stack.empty()) {
            Frame fr = stack.back();
            stack.pop_back();
            int64_t node = fr.node;
            int64_t row_lo = c->node_offsets[node];
            int64_t row_hi = c->node_offsets[node + 1];
            if (fr.done) {
                for (int64_t r = row_hi - 1; r >= row_lo; --r)
                    if (c->relevant[r]) apply_row(r, -1);
                gap.leave(undo_pool[fr.undo_base]);
                undo_pool.pop_back();
                collect_touched(row_lo, row_hi);
                for (int32_t ridx : touched) score[ridx] = chain_score(ridx);
                continue;
            }
            undo_pool.emplace_back();
            int64_t ub = (int64_t)undo_pool.size() - 1;
            gap.enter(node, undo_pool[ub]);
            for (int64_t r = row_lo; r < row_hi; ++r)
                if (c->relevant[r]) apply_row(r, +1);
            collect_touched(row_lo, row_hi);
            for (int32_t ridx : touched) {
                int32_t sc = chain_score(ridx);
                score[ridx] = sc;
                if (sc > max_score[ridx]) max_score[ridx] = sc;
            }
            int32_t ci = c->cand_of_node[node];
            if (ci >= 0) {
                uint16_t* row = snap.data() + (size_t)ci * (r_hi - r_lo);
                for (int64_t ridx = r_lo; ridx < r_hi; ++ridx)
                    row[ridx - r_lo] = (uint16_t)score[ridx];
            }
            stack.push_back({(int32_t)node, 1, ub});
            const auto& ch = c->children[node];
            for (auto it = ch.rbegin(); it != ch.rend(); ++it)
                stack.push_back({*it, 0, -1});
        }
    }
};

}  // namespace pseudo

extern "C" {

void pt_score_pseudo(
    const int64_t* node_offsets, int64_t n_nodes, const uint32_t* parent_index,
    const int32_t* delta_seed, const uint8_t* delta_is_del,
    const uint64_t* seed_hash, const uint8_t* seed_rev,
    const int64_t* seed_pos, const int64_t* seed_end,
    const int64_t* gev_offsets, const int64_t* gev_pos,
    const uint8_t* gev_nongap, const int64_t* bev_offsets,
    const int32_t* bev_block, const int8_t* bev_code,
    const int64_t* block_lo, const int64_t* block_hi, int64_t n_blocks,
    const uint8_t* nongap0_bits, int64_t n_scalar,
    const int64_t* read_off, const uint64_t* read_hash,
    const uint8_t* read_rev, const int64_t* read_qbeg,
    const int64_t* read_qend, int64_t n_reads,
    const uint8_t* relevant, const int32_t* cand_nodes, int64_t n_cand,
    int32_t maximum_gap, int32_t n_threads,
    int32_t* max_score_out, uint16_t* snap_out) {
    pseudo::Ctx c;
    c.node_offsets = node_offsets;
    c.n_nodes = n_nodes;
    c.parent_index = parent_index;
    c.delta_seed = delta_seed;
    c.delta_is_del = delta_is_del;
    c.seed_hash = seed_hash;
    c.seed_rev = seed_rev;
    c.seed_pos = seed_pos;
    c.seed_end = seed_end;
    c.gev_offsets = gev_offsets;
    c.gev_pos = gev_pos;
    c.gev_nongap = gev_nongap;
    c.bev_offsets = bev_offsets;
    c.bev_block = bev_block;
    c.bev_code = bev_code;
    c.block_lo = block_lo;
    c.block_hi = block_hi;
    c.n_blocks = n_blocks;
    c.nongap0_bits = nongap0_bits;
    c.n_scalar = n_scalar;
    c.read_off = read_off;
    c.read_hash = read_hash;
    c.read_rev = read_rev;
    c.read_qbeg = read_qbeg;
    c.read_qend = read_qend;
    c.n_reads = n_reads;
    c.relevant = relevant;
    c.cand_nodes = cand_nodes;
    c.n_cand = n_cand;
    c.maximum_gap = maximum_gap;

    c.children.assign(n_nodes, {});
    for (int64_t i = 1; i < n_nodes; ++i)
        c.children[parent_index[i]].push_back((int32_t)i);
    c.cand_of_node.assign(n_nodes, -1);
    for (int64_t i = 0; i < n_cand; ++i) c.cand_of_node[cand_nodes[i]] = i;

    // occ: (hash, read) sorted by hash -> unique hashes + read CSR
    {
        int64_t total = read_off[n_reads];
        std::vector<std::pair<uint64_t, int32_t>> occ(total);
        for (int64_t rd = 0; rd < n_reads; ++rd)
            for (int64_t k = read_off[rd]; k < read_off[rd + 1]; ++k)
                occ[k] = {read_hash[k], (int32_t)rd};
        std::sort(occ.begin(), occ.end());
        c.occ_hash.reserve(total);
        c.occ_off.reserve(total + 1);
        c.occ_read.resize(total);
        for (int64_t k = 0; k < total; ++k) {
            if (k == 0 || occ[k].first != occ[k - 1].first) {
                c.occ_hash.push_back(occ[k].first);
                c.occ_off.push_back(k);
            }
            c.occ_read[k] = occ[k].second;
        }
        c.occ_off.push_back(total);
    }

    if (n_threads < 1) n_threads = 1;
    if (n_threads > n_reads) n_threads = n_reads > 0 ? (int32_t)n_reads : 1;
    std::vector<std::unique_ptr<pseudo::Worker>> workers;
    std::vector<std::thread> ths;
    int64_t per = (n_reads + n_threads - 1) / n_threads;
    for (int32_t t = 0; t < n_threads; ++t) {
        int64_t lo = (int64_t)t * per;
        int64_t hi = lo + per < n_reads ? lo + per : n_reads;
        if (lo >= hi) break;
        workers.emplace_back(new pseudo::Worker(&c, lo, hi));
    }
    for (auto& w : workers)
        ths.emplace_back([&w]() { w->run(); });
    for (auto& t : ths) t.join();

    for (int64_t r = 0; r < n_reads; ++r) max_score_out[r] = 0;
    std::memset(snap_out, 0, (size_t)n_cand * n_reads * sizeof(uint16_t));
    for (auto& w : workers) {
        for (int64_t r = w->r_lo; r < w->r_hi; ++r)
            max_score_out[r] = w->max_score[r];
        int64_t span = w->r_hi - w->r_lo;
        for (int64_t ci = 0; ci < n_cand; ++ci) {
            const uint16_t* src = w->snap.data() + (size_t)ci * span;
            uint16_t* dst = snap_out + (size_t)ci * n_reads + w->r_lo;
            std::memcpy(dst, src, (size_t)span * sizeof(uint16_t));
        }
    }
}

}  // extern "C"

// ======================================================================
// Simple-mode meta scorer (native twin of meta/engine.py::MetaScorer
// .score_all; reference: scoreReadsHelper DFS, mgsr.cpp:7225-7470).
// Per (hash, orientation) presence counters over the READ-RELEVANT delta
// rows; a 0<->1 transition fires +-1 onto the fwd/rev counts of every
// read OCCURRENCE of that hash (same-orientation occurrences -> fwd).
// Optionally emits the sparse per-node (read, score-after) pairs the
// assignment replay consumes; returns -1 if the event buffer is too
// small (caller retries with a bigger one).
// ======================================================================

extern "C" {

namespace simple_score {

struct Worker {
    int64_t r_lo, r_hi;
    // occurrence index over THIS worker's reads only
    std::vector<uint64_t> occ_hash;
    std::vector<int64_t> occ_off;
    std::vector<int32_t> occ_read;
    std::vector<uint8_t> occ_rev;
    std::vector<int32_t> ev_node, ev_read, ev_score;
    bool overflow = false;
};

}  // namespace simple_score

int64_t pt_score_simple(
    const int64_t* node_offsets, int64_t n_nodes, const uint32_t* parent_index,
    const int32_t* delta_seed, const uint8_t* delta_is_del,
    const uint64_t* seed_hash, const uint8_t* seed_rev,
    const int64_t* read_off, const uint64_t* read_hash,
    const uint8_t* read_rev, int64_t n_reads,
    const uint8_t* relevant, const int32_t* cand_nodes, int64_t n_cand,
    int32_t emit_node_scores, int32_t n_threads,
    int32_t* max_score_out,        // [R]
    uint16_t* snap_out,            // [n_cand, R]
    int32_t* ev_node_out, int32_t* ev_read_out, int32_t* ev_score_out,
    int64_t ev_cap) {
    std::vector<std::vector<int32_t>> children(n_nodes);
    for (int64_t i = 1; i < n_nodes; ++i)
        children[parent_index[i]].push_back((int32_t)i);
    std::vector<int32_t> cand_of_node(n_nodes, -1);
    for (int64_t i = 0; i < n_cand; ++i) cand_of_node[cand_nodes[i]] = i;

    for (int64_t r = 0; r < n_reads; ++r) max_score_out[r] = 0;
    std::memset(snap_out, 0, (size_t)n_cand * n_reads * sizeof(uint16_t));

    if (n_threads < 1) n_threads = 1;
    if (n_threads > n_reads) n_threads = n_reads > 0 ? (int32_t)n_reads : 1;
    int64_t per = n_threads ? (n_reads + n_threads - 1) / n_threads : 0;
    std::vector<simple_score::Worker> workers;
    for (int32_t t = 0; t < n_threads; ++t) {
        int64_t lo = (int64_t)t * per;
        int64_t hi = lo + per < n_reads ? lo + per : n_reads;
        if (lo >= hi) break;
        workers.push_back({lo, hi});
    }

    // worker body: replays the GLOBAL presence counters (read-independent)
    // but fans fired flips out only onto its own reads
    auto run_worker = [&](simple_score::Worker& w) {
        int64_t total = read_off[w.r_hi] - read_off[w.r_lo];
        {
            struct OccRec { uint64_t h; int32_t rd; uint8_t rv; };
            std::vector<OccRec> occ(total);
            int64_t kk = 0;
            for (int64_t rd = w.r_lo; rd < w.r_hi; ++rd)
                for (int64_t k = read_off[rd]; k < read_off[rd + 1]; ++k)
                    occ[kk++] = {read_hash[k], (int32_t)rd, read_rev[k]};
            std::sort(occ.begin(), occ.end(),
                      [](const OccRec& a, const OccRec& b) {
                return a.h < b.h || (a.h == b.h && (a.rd < b.rd ||
                       (a.rd == b.rd && a.rv < b.rv)));
            });
            w.occ_hash.reserve(total);
            w.occ_off.reserve(total + 1);
            w.occ_read.resize(total);
            w.occ_rev.resize(total);
            for (int64_t k = 0; k < total; ++k) {
                if (k == 0 || occ[k].h != occ[k - 1].h) {
                    w.occ_hash.push_back(occ[k].h);
                    w.occ_off.push_back(k);
                }
                w.occ_read[k] = occ[k].rd;
                w.occ_rev[k] = occ[k].rv;
            }
            w.occ_off.push_back(total);
        }
        std::unordered_map<uint64_t, std::pair<uint32_t, uint32_t>> counts;
        counts.reserve(w.occ_hash.size() * 2);
        std::vector<int32_t> fwd(n_reads, 0), rev(n_reads, 0);
        std::vector<int64_t> stamp(n_reads, -1);
        int64_t token = 0;
        std::vector<int32_t> touched;

        auto apply_row = [&](int64_t r, int sign) -> int64_t {
            int64_t sid = delta_seed[r];
            uint64_t h = seed_hash[sid];
            bool rv = seed_rev[sid] != 0;
            bool isdel = (delta_is_del[r] != 0) != (sign < 0);
            auto& c = counts[h];
            uint32_t& oi = rv ? c.second : c.first;
            bool fire;
            int32_t delta;
            if (!isdel) {
                ++oi;
                fire = oi == 1;
                delta = 1;
            } else {
                fire = oi == 1;
                --oi;
                delta = -1;
            }
            if (!fire) return -1;
            auto it = std::lower_bound(w.occ_hash.begin(), w.occ_hash.end(),
                                       h);
            if (it == w.occ_hash.end() || *it != h) return -1;
            int64_t u = it - w.occ_hash.begin();
            for (int64_t k = w.occ_off[u]; k < w.occ_off[u + 1]; ++k) {
                if ((w.occ_rev[k] != 0) == rv)
                    fwd[w.occ_read[k]] += delta;
                else
                    rev[w.occ_read[k]] += delta;
            }
            return u;
        };

        struct Frame { int32_t node; uint8_t done; };
        std::vector<Frame> stack;
        stack.push_back({0, 0});
        while (!stack.empty()) {
            Frame fr = stack.back();
            stack.pop_back();
            int64_t node = fr.node;
            int64_t lo = node_offsets[node], hi = node_offsets[node + 1];
            if (fr.done) {
                for (int64_t r = hi - 1; r >= lo; --r)
                    if (relevant[r]) apply_row(r, -1);
                continue;
            }
            ++token;
            touched.clear();
            for (int64_t r = lo; r < hi; ++r) {
                if (!relevant[r]) continue;
                int64_t u = apply_row(r, +1);
                if (u < 0) continue;
                for (int64_t k = w.occ_off[u]; k < w.occ_off[u + 1]; ++k) {
                    int32_t rd = w.occ_read[k];
                    if (stamp[rd] == token) continue;
                    stamp[rd] = token;
                    touched.push_back(rd);
                }
            }
            if (!touched.empty()) {
                std::sort(touched.begin(), touched.end());
                for (int32_t rd : touched) {
                    int32_t sc = fwd[rd] > rev[rd] ? fwd[rd] : rev[rd];
                    if (sc > max_score_out[rd]) max_score_out[rd] = sc;
                    if (emit_node_scores) {
                        w.ev_node.push_back((int32_t)node);
                        w.ev_read.push_back(rd);
                        w.ev_score.push_back(sc);
                    }
                }
            }
            int32_t ci = cand_of_node[node];
            if (ci >= 0) {
                uint16_t* row = snap_out + (size_t)ci * n_reads;
                for (int64_t rd = w.r_lo; rd < w.r_hi; ++rd) {
                    int32_t sc = fwd[rd] > rev[rd] ? fwd[rd] : rev[rd];
                    row[rd] = (uint16_t)sc;
                }
            }
            stack.push_back({(int32_t)node, 1});
            const auto& ch = children[node];
            for (auto it2 = ch.rbegin(); it2 != ch.rend(); ++it2)
                stack.push_back({*it2, 0});
        }
    };

    // max_score_out and snap_out writes are disjoint per worker (read-sliced)
    std::vector<std::thread> ths;
    for (auto& w : workers)
        ths.emplace_back([&run_worker, &w]() { run_worker(w); });
    for (auto& t : ths) t.join();

    if (!emit_node_scores) return 0;
    // merge the per-worker (node, read, score) streams: each is sorted by
    // DFS-preorder node (== node id) with reads ascending; concatenating in
    // worker order and stable-sorting by node keeps reads ascending
    int64_t n_ev = 0;
    for (auto& w : workers) n_ev += (int64_t)w.ev_node.size();
    if (n_ev > ev_cap) return -1;
    std::vector<int64_t> order(n_ev);
    std::vector<int32_t> cat_node(n_ev), cat_read(n_ev), cat_score(n_ev);
    int64_t off = 0;
    for (auto& w : workers) {
        std::copy(w.ev_node.begin(), w.ev_node.end(), cat_node.begin() + off);
        std::copy(w.ev_read.begin(), w.ev_read.end(), cat_read.begin() + off);
        std::copy(w.ev_score.begin(), w.ev_score.end(),
                  cat_score.begin() + off);
        off += (int64_t)w.ev_node.size();
    }
    for (int64_t i = 0; i < n_ev; ++i) order[i] = i;
    std::stable_sort(order.begin(), order.end(), [&](int64_t a, int64_t b) {
        return cat_node[a] < cat_node[b];
    });
    for (int64_t i = 0; i < n_ev; ++i) {
        ev_node_out[i] = cat_node[order[i]];
        ev_read_out[i] = cat_read[order[i]];
        ev_score_out[i] = cat_score[order[i]];
    }
    return n_ev;
}

}  // extern "C"

// ======================================================================
// bwa-aln FM-index bounded-difference search (align/bwt.py twin).
//
// Port of the python best-first search (itself implementing the used
// subset of src/3rdparty/bwa/bwtgap.c:109-260 semantics
// for the aDNA mode, bwa_align.c:260-268): per-score LIFO stacks, D-array
// lower-bound pruning with the allow_M refinement, M/I/D state machine,
// top2 shrink / best_score stop / MAX_TOP2 / MAX_ENTRIES / gap_shadow /
// tandem-gap dedup, and bwa_approx_mapQ hit selection.  The python
// implementation in align/bwt.py stays as the bit-exact oracle
// (tests/test_bwt_aln.py::test_native_bwt_matches_python).
//
// The FM occ() uses 64-base checkpoint blocks built here from the BWT
// string (python supplies bwt codes + C[] + the fwd suffix array; those
// are cheap vectorized numpy constructions).
// ======================================================================

#include <atomic>
#include <climits>

namespace bwtaln {

constexpr int S_MM = 3, S_GAPO = 11, S_GAPE = 4;
constexpr int MAX_GAPO = 2, MAX_GAPE = 6;
constexpr int INDEL_END_SKIP = 5, MAX_DEL_OCC = 10, MAX_TOP2 = 30;
constexpr int64_t MAX_ENTRIES = 2000000;
constexpr int ST_M = 0, ST_I = 1, ST_D = 2;

struct Fm {
    const uint8_t* bwt;  // codes 0..3, 4 = sentinel
    int64_t n;           // text length incl sentinel
    int64_t C[5];
    std::vector<int32_t> cp;  // [nblk+1][4] counts of c in bwt[:64*b)

    void build_cp() {
        int64_t nblk = (n >> 6) + 1;
        cp.assign((nblk + 1) * 4, 0);
        int32_t run[4] = {0, 0, 0, 0};
        for (int64_t b = 0; b < nblk; ++b) {
            for (int c = 0; c < 4; ++c) cp[b * 4 + c] = run[c];
            int64_t lo = b << 6, hi = std::min(n, lo + 64);
            for (int64_t j = lo; j < hi; ++j)
                if (bwt[j] < 4) ++run[bwt[j]];
        }
        cp[nblk * 4 + 0] = run[0];
        cp[nblk * 4 + 1] = run[1];
        cp[nblk * 4 + 2] = run[2];
        cp[nblk * 4 + 3] = run[3];
    }
    // occ of all four symbols in bwt[:i)
    inline void occ4(int64_t i, int64_t out[4]) const {
        int64_t b = i >> 6;
        const int32_t* base = &cp[b * 4];
        int32_t cnt[4] = {0, 0, 0, 0};
        const uint8_t* p = bwt + (b << 6);
        int64_t e = i & 63;
        for (int64_t j = 0; j < e; ++j) {
            uint8_t c = p[j];
            cnt[0] += (c == 0); cnt[1] += (c == 1);
            cnt[2] += (c == 2); cnt[3] += (c == 3);
        }
        out[0] = base[0] + cnt[0]; out[1] = base[1] + cnt[1];
        out[2] = base[2] + cnt[2]; out[3] = base[3] + cnt[3];
    }
    inline int64_t occ1(int c, int64_t i) const {
        int64_t b = i >> 6;
        int64_t o = cp[b * 4 + c];
        const uint8_t* p = bwt + (b << 6);
        int64_t e = i & 63;
        for (int64_t j = 0; j < e; ++j) o += (p[j] == c);
        return o;
    }
    // sub-intervals [k2,l2] for all four symbols of [k,l]
    inline void extend4(int64_t k, int64_t l, int64_t k2[4],
                        int64_t l2[4]) const {
        int64_t ok[4], ol[4];
        occ4(k, ok);
        occ4(l + 1, ol);
        for (int c = 0; c < 4; ++c) {
            k2[c] = C[c] + ok[c];
            l2[c] = C[c] + ol[c] - 1;
        }
    }
    inline void extend1(int64_t k, int64_t l, int c, int64_t& k2,
                        int64_t& l2) const {
        k2 = C[c] + occ1(c, k);
        l2 = C[c] + occ1(c, l + 1) - 1;
    }
};

// bwt_cal_width: D-array lower bounds over the REVERSED text's index
static void cal_width(const Fm& fmr, const uint8_t* pat, int L,
                      int32_t* bid, int64_t* wid) {
    int64_t k = 0, l = fmr.n - 1;
    int b = 0;
    for (int i = 0; i < L; ++i) {
        int c = pat[i];
        if (c > 3) { k = 0; l = -1; }
        else fmr.extend1(k, l, c, k, l);
        if (k > l) { ++b; k = 0; l = fmr.n - 1; }
        bid[i] = b;
        wid[i] = l - k + 1;
    }
}

struct Hit {
    int64_t k, l;
    int mm, gapo, gape, ins, del, score;
};

struct Ent {
    int32_t i;
    int64_t k, l;
    int8_t mm, gapo, gape, ins, del, state;
    int32_t ldp;
};

struct SeedBest {
    int score, diff;
    int64_t cnt;
    bool has = false;
};

// bwt_match_gap port; returns hits + interval mass at/below best score
static void match_gap(const Fm& fm, const uint8_t* pat, int L,
                      const int32_t* bid0, const int64_t* wid0, int max_diff,
                      const SeedBest* seed, std::vector<Hit>& hits,
                      int64_t& c1, int64_t& c2, int& best_score_out) {
    hits.clear();
    c1 = c2 = 0;
    int n_amb = 0;
    for (int i = 0; i < L; ++i) n_amb += (pat[i] > 3);
    if (n_amb > max_diff) { best_score_out = 1 << 30; return; }
    int best_score, best_diff, cur_max_diff;
    int64_t best_cnt;
    if (seed && seed->has) {
        best_score = seed->score;
        best_diff = seed->diff;
        best_cnt = seed->cnt;
        cur_max_diff = std::min(best_diff + 1, max_diff);
    } else {
        best_score = S_MM * (max_diff + 1) + S_GAPO * (MAX_GAPO + 1)
            + S_GAPE * (MAX_GAPE + 1);
        best_diff = max_diff + 1;
        cur_max_diff = max_diff;
        best_cnt = 0;
    }
    std::vector<int32_t> bid(bid0, bid0 + L);
    std::vector<int64_t> wid(wid0, wid0 + L);

    // score ceiling: pushes carry at most (max_diff + 1) mismatches
    // (m >= 0 gates pops; one more diff can be pushed) plus full gap
    // budgets; +S_MM headroom for the best+S_MM stop bound.  Sized per
    // read because max_diff grows with read length (bwa_cal_maxdiff).
    const int MAXS = S_MM * (max_diff + 2) + S_GAPO * (MAX_GAPO + 1)
        + S_GAPE * (MAX_GAPE + 1) + S_MM + 1;
    std::vector<std::vector<Ent>> stacks(MAXS);
    int64_t n_entries = 0;
    int cur = 0;
    auto push = [&](int score, int32_t i, int64_t k, int64_t l, int mm,
                    int go, int ge, int ni, int nd, int state, bool is_diff,
                    int32_t ldp) {
        if (score >= MAXS) return;  // beyond any best+S_MM stop bound
        stacks[score].push_back(Ent{i, k, l, (int8_t)mm, (int8_t)go,
                                    (int8_t)ge, (int8_t)ni, (int8_t)nd,
                                    (int8_t)state, is_diff ? i : ldp});
        ++n_entries;
        if (score < cur) cur = score;
    };
    push(0, L, 0, fm.n - 1, 0, 0, 0, 0, 0, ST_M, false, 0);

    while (n_entries) {
        if (n_entries > MAX_ENTRIES) break;
        while (stacks[cur].empty()) ++cur;
        int score = cur;
        if (score > best_score + S_MM) break;
        Ent e = stacks[cur].back();
        stacks[cur].pop_back();
        --n_entries;
        int i = e.i, n_mm = e.mm, n_gapo = e.gapo, n_gape = e.gape;
        int n_ins = e.ins, n_del = e.del, state = e.state;
        int32_t ldp = e.ldp;
        int64_t k = e.k, l = e.l;

        int m = cur_max_diff - (n_mm + n_gapo) - n_gape;  // GAPE mode
        if (m < 0) continue;
        if (i > 0 && m < bid[i - 1]) continue;

        bool hit_found = false;
        if (i == 0) {
            hit_found = true;
        } else if (m == 0) {
            int64_t kk = k, ll = l;
            bool ok = true;
            for (int j = i - 1; j >= 0; --j) {
                int c = pat[j];
                if (c > 3) { ok = false; break; }
                fm.extend1(kk, ll, c, kk, ll);
                if (kk > ll) { ok = false; break; }
            }
            if (!ok) continue;
            k = kk; l = ll;
            hit_found = true;
        }

        if (hit_found) {
            int sc = S_MM * n_mm + S_GAPO * n_gapo + S_GAPE * n_gape;
            if (sc < best_score) {
                best_score = sc;
                best_diff = n_mm + n_gapo + n_gape;
                cur_max_diff = std::min(best_diff + 1, max_diff);  // top2
            }
            if (sc == best_score) {
                best_cnt += l - k + 1;
                c1 += l - k + 1;
            } else {
                if (best_cnt > MAX_TOP2) break;
                c2 += l - k + 1;
            }
            bool dup = false;
            if (n_gapo) {
                for (const Hit& h : hits)
                    if (h.k == k && h.l == l) { dup = true; break; }
            }
            if (!dup) {
                // gap_shadow: damp widths below the last diff position
                int64_t x = l - k + 1;
                int jj = 0;
                for (int t2 = 0; t2 < ldp; ++t2) {
                    if (wid[t2] > x) wid[t2] -= x;
                    else if (wid[t2] == x) {
                        ++jj;
                        bid[t2] = 1;
                        wid[t2] = fm.n - 1 - jj;
                    }
                }
                hits.push_back(Hit{k, l, n_mm, n_gapo, n_gape, n_ins, n_del,
                                   sc});
            }
            continue;
        }

        --i;
        int64_t occ = l - k + 1;
        int64_t sk[4], sl[4];
        fm.extend4(k, l, sk, sl);
        bool allow_diff = true, allow_m = true;
        if (i > 0) {
            if (bid[i - 1] > m - 1) allow_diff = false;
            else if (bid[i - 1] == m - 1 && bid[i] == m - 1
                     && wid[i - 1] == wid[i]) allow_m = false;
        }

        int tmp = n_gapo + n_gape;
        if (allow_diff && i >= INDEL_END_SKIP + tmp
                && L - i >= INDEL_END_SKIP + tmp) {
            if (state == ST_M) {
                if (n_gapo < MAX_GAPO) {
                    push(S_MM * n_mm + S_GAPO * (n_gapo + 1) + S_GAPE * n_gape,
                         i, k, l, n_mm, n_gapo + 1, n_gape, n_ins + 1, n_del,
                         ST_I, true, ldp);
                    for (int c = 0; c < 4; ++c)
                        if (sk[c] <= sl[c])
                            push(S_MM * n_mm + S_GAPO * (n_gapo + 1)
                                     + S_GAPE * n_gape,
                                 i + 1, sk[c], sl[c], n_mm, n_gapo + 1,
                                 n_gape, n_ins, n_del + 1, ST_D, true, ldp);
                }
            } else if (state == ST_I) {
                if (n_gape < MAX_GAPE)
                    push(S_MM * n_mm + S_GAPO * n_gapo + S_GAPE * (n_gape + 1),
                         i, k, l, n_mm, n_gapo, n_gape + 1, n_ins + 1, n_del,
                         ST_I, true, ldp);
            } else if (state == ST_D) {
                if (n_gape < MAX_GAPE && (n_gape + n_gapo < cur_max_diff
                                          || occ < MAX_DEL_OCC)) {
                    for (int c = 0; c < 4; ++c)
                        if (sk[c] <= sl[c])
                            push(S_MM * n_mm + S_GAPO * n_gapo
                                     + S_GAPE * (n_gape + 1),
                                 i + 1, sk[c], sl[c], n_mm, n_gapo,
                                 n_gape + 1, n_ins, n_del + 1, ST_D, true,
                                 ldp);
                }
            }
        }

        if (allow_diff && allow_m) {
            for (int j = 1; j <= 4; ++j) {
                int c = (pat[i] + j) & 3;
                int is_mm = (j != 4 || pat[i] > 3) ? 1 : 0;
                if (sk[c] <= sl[c])
                    push(S_MM * (n_mm + is_mm) + S_GAPO * n_gapo
                             + S_GAPE * n_gape,
                         i, sk[c], sl[c], n_mm + is_mm, n_gapo, n_gape,
                         n_ins, n_del, ST_M, is_mm != 0, ldp);
            }
        } else if (pat[i] < 4) {
            int c = pat[i];
            if (sk[c] <= sl[c])
                push(S_MM * n_mm + S_GAPO * n_gapo + S_GAPE * n_gape, i,
                     sk[c], sl[c], n_mm, n_gapo, n_gape, n_ins, n_del, ST_M,
                     false, ldp);
        }
    }
    best_score_out = best_score;
}

// bwtaln.c:42-55 Poisson-tail threshold
static int cal_maxdiff(int length, double err, double thres) {
    double elambda = std::exp(-length * err);
    double s = elambda, y = 1.0, x = 1.0;
    for (int kk = 1; kk < 1000; ++kk) {
        y *= length * err;
        x *= kk;
        s += elambda * y / x;
        if (1.0 - s < thres) return kk;
    }
    return 2;
}

}  // namespace bwtaln

extern "C" {

// Per-read outputs: mapped, rev, pos (min SA coord of best hit),
// mm/gapo/gape/ins/del of the chosen hit, score (=-diffs), mapq.
void pt_bwt_aln(const uint8_t* bwt_f, const int64_t* C_f, const int32_t* sa_f,
                const uint8_t* bwt_r, const int64_t* C_r, int64_t n_text,
                const uint8_t* rbuf, const int64_t* roff, int64_t n_reads,
                double fnr, int threads, uint8_t* mapped, uint8_t* rev_out,
                int64_t* pos_out, int32_t* nmm, int32_t* ngapo,
                int32_t* ngape, int32_t* nins, int32_t* ndel,
                int32_t* score_out, int32_t* mapq_out) {
    using namespace bwtaln;
    Fm fm{bwt_f, n_text, {C_f[0], C_f[1], C_f[2], C_f[3], C_f[4]}, {}};
    Fm fmr{bwt_r, n_text, {C_r[0], C_r[1], C_r[2], C_r[3], C_r[4]}, {}};
    fm.build_cp();
    fmr.build_cp();
    // ASCII -> code LUT (encode() semantics: acgt/ACGT, else 4)
    uint8_t lut[256];
    std::memset(lut, 4, sizeof lut);
    lut['A'] = lut['a'] = 0; lut['C'] = lut['c'] = 1;
    lut['G'] = lut['g'] = 2; lut['T'] = lut['t'] = 3;
    static const int8_t g_log_n_thresh = 23;

    if (threads < 1) threads = 1;
    std::vector<std::thread> pool;
    std::atomic<int64_t> next{0};
    auto worker = [&]() {
        std::vector<uint8_t> pat[2];
        std::vector<int32_t> bid[2];
        std::vector<int64_t> wid[2];
        std::vector<Hit> hits[2], scratch;
        for (;;) {
            int64_t r = next.fetch_add(1);
            if (r >= n_reads) return;
            int64_t lo = roff[r], hi = roff[r + 1];
            int L = (int)(hi - lo);
            mapped[r] = 0;
            if (L == 0) continue;
            int max_diff = cal_maxdiff(L, 0.02, fnr);
            // oriented patterns: fwd and reverse complement
            pat[0].resize(L);
            pat[1].resize(L);
            for (int i = 0; i < L; ++i) {
                uint8_t c = lut[rbuf[lo + i]];
                pat[0][i] = c;
                pat[1][L - 1 - i] = c > 3 ? 4 : (uint8_t)(3 - c);
            }
            SeedBest seed{};
            for (int o = 0; o < 2; ++o) {
                bid[o].resize(L);
                wid[o].resize(L);
                cal_width(fmr, pat[o].data(), L, bid[o].data(),
                          wid[o].data());
            }
            auto best_of = [&](const std::vector<Hit>& hs, SeedBest& out) {
                out.has = false;
                if (hs.empty()) return;
                int bsc = 1 << 30;
                for (const Hit& h : hs) bsc = std::min(bsc, h.score);
                int bdiff = 1 << 30;
                int64_t bcnt = 0;
                for (const Hit& h : hs)
                    if (h.score == bsc) {
                        bdiff = std::min(bdiff, h.mm + h.gapo + h.gape);
                        bcnt += h.l - h.k + 1;
                    }
                out = SeedBest{bsc, bdiff, bcnt, true};
            };
            auto merge_seed = [&](const SeedBest& a, const SeedBest& b) {
                if (!a.has) return b;
                if (!b.has) return a;
                if (a.score != b.score) return a.score < b.score ? a : b;
                return SeedBest{a.score, std::min(a.diff, b.diff),
                                a.cnt + b.cnt, true};
            };
            int64_t c1s[2], c2s[2];
            int bs;
            for (int o = 0; o < 2; ++o) {
                match_gap(fm, pat[o].data(), L, bid[o].data(), wid[o].data(),
                          max_diff, seed.has ? &seed : nullptr, hits[o],
                          c1s[o], c2s[o], bs);
                SeedBest sb;
                best_of(hits[o], sb);
                seed = merge_seed(seed, sb);
            }
            SeedBest fwd_best;
            best_of(hits[0], fwd_best);
            if (seed.has && !hits[0].empty()
                    && (!fwd_best.has || seed.score < fwd_best.score)) {
                SeedBest rev_best;
                best_of(hits[1], rev_best);
                match_gap(fm, pat[0].data(), L, bid[0].data(), wid[0].data(),
                          max_diff, rev_best.has ? &rev_best : nullptr,
                          hits[0], c1s[0], c2s[0], bs);
            }
            // merge strands: global best hit (stable: fwd first, LIFO order
            // within a strand matches the python all_scored sort by score)
            int best_sc = 1 << 30;
            for (int o = 0; o < 2; ++o)
                for (const Hit& h : hits[o]) best_sc = std::min(best_sc, h.score);
            if (best_sc == (1 << 30)) continue;
            int64_t c1 = 0, c2 = 0;
            const Hit* pick = nullptr;
            int pick_o = 0;
            for (int o = 0; o < 2; ++o)
                for (const Hit& h : hits[o]) {
                    if (h.score == best_sc) {
                        c1 += h.l - h.k + 1;
                        if (!pick) { pick = &h; pick_o = o; }
                    } else {
                        c2 += h.l - h.k + 1;
                    }
                }
            int64_t pos = INT64_MAX;
            for (int64_t t = pick->k; t <= pick->l; ++t)
                pos = std::min(pos, (int64_t)sa_f[t]);
            mapped[r] = 1;
            rev_out[r] = (uint8_t)pick_o;
            pos_out[r] = pos;
            nmm[r] = pick->mm;
            ngapo[r] = pick->gapo;
            ngape[r] = pick->gape;
            nins[r] = pick->ins;
            ndel[r] = pick->del;
            score_out[r] = -(pick->mm + pick->gapo + pick->gape);
            int mq;
            if (c1 == 0) mq = 23;
            else if (c1 > 1) mq = 0;
            else if (pick->mm == max_diff) mq = 25;
            else if (c2 == 0) mq = 37;
            else {
                int64_t n2 = std::min<int64_t>(c2, 255);
                int g = (int)(4.343 * std::log((double)n2) + 0.5);
                mq = g > g_log_n_thresh ? 0 : 23 - g;
            }
            mapq_out[r] = mq;
        }
    };
    for (int t = 0; t < threads; ++t) pool.emplace_back(worker);
    for (auto& th : pool) th.join();
}

}  // extern "C"

// ======================================================================
// Index-builder hot kernels (index/builder.py::compute_state tail +
// _count_delta twins; the numpy implementations stay as oracles, cross-
// checked by tests/test_native.py).
// ======================================================================

extern "C" {

// linear merge of two sorted (hash, count) tables emitting rows whose
// counts differ (builder.py::_count_delta twin).  Returns n_rows.
int64_t pt_count_delta(const uint64_t* ph, const int64_t* pc, int64_t np_,
                       const uint64_t* ch, const int64_t* cc, int64_t nc,
                       uint64_t* oh, int16_t* op, int16_t* oc) {
    int64_t i = 0, j = 0, out = 0;
    while (i < np_ || j < nc) {
        if (j >= nc || (i < np_ && ph[i] < ch[j])) {
            oh[out] = ph[i];
            op[out] = (int16_t)pc[i];
            oc[out] = 0;
            ++out; ++i;
        } else if (i >= np_ || ch[j] < ph[i]) {
            oh[out] = ch[j];
            op[out] = 0;
            oc[out] = (int16_t)cc[j];
            ++out; ++j;
        } else {
            if (pc[i] != cc[j]) {
                oh[out] = ph[i];
                op[out] = (int16_t)pc[i];
                oc[out] = (int16_t)cc[j];
                ++out;
            }
            ++i; ++j;
        }
    }
    return out;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Incremental counts-mode node delta (builder._incremental_count_delta core).
//
// Replaces the per-node python path: change-site discovery (dropped members,
// pure insertion/deletion bridges), merged affected-window intervals on each
// side, canonical k-min-mer hashing of exactly those windows, and the net
// count delta — all in one call.  Bit-exact twin of
// index/builder.py::{_change_sites,_merged_affected_intervals,
// _affected_window_counts} (tests/test_native.py cross-checks).
// Reference analog: index_single_mode.cpp:2291-2571 runningCounts updates.
// ---------------------------------------------------------------------------

namespace {

struct IntervalAccum {
    // merged [a, b] inclusive window intervals, built from sorted pushes
    std::vector<std::pair<int64_t, int64_t>> iv;
    void push(int64_t a, int64_t b, int64_t nw) {
        if (a < 0) a = 0;
        if (b > nw - 1) b = nw - 1;
        if (a > b || nw <= 0) return;
        iv.emplace_back(a, b);
    }
    void merge() {
        if (iv.empty()) return;
        std::sort(iv.begin(), iv.end());
        size_t out = 0;
        for (size_t i = 1; i < iv.size(); ++i) {
            if (iv[i].first <= iv[out].second) {
                if (iv[i].second > iv[out].second) iv[out].second = iv[i].second;
            } else {
                iv[++out] = iv[i];
            }
        }
        iv.resize(out + 1);
    }
};

// canonical k-min-mer over window w of the syncmer hash array
inline void accum_windows(const uint64_t* H, const uint8_t* rev, int64_t n,
                          const std::vector<std::pair<int64_t, int64_t>>& iv,
                          int k, int l, int sign,
                          std::unordered_map<uint64_t, int>& net) {
    (void)n;
    if (l == 1) {
        for (const auto& ab : iv)
            for (int64_t w = ab.first; w <= ab.second; ++w)
                net[H[w]] += sign;  // l==1: always valid, hash = H itself
        (void)rev;
        return;
    }
    for (const auto& ab : iv) {
        for (int64_t w = ab.first; w <= ab.second; ++w) {
            uint64_t F = 0, R = 0;
            for (int i = 0; i < l; ++i) {
                int r = (k * (l - 1 - i)) & 63;
                F ^= rol(H[w + i], r);
                R ^= rol(H[w + l - 1 - i], r);
            }
            if (F != R) net[F < R ? F : R] += sign;
        }
    }
}

}  // namespace

extern "C" {

// Returns the number of nonzero delta rows (sorted by hash ascending),
// written to (out_h, out_d) up to cap; if the true count exceeds cap,
// returns the required count WITHOUT writing past cap (caller re-allocates).
int64_t pt_incr_count_delta(
    const int64_t* p_pos, const uint64_t* p_hash, const uint8_t* p_rev,
    int64_t np_, const uint8_t* keep,
    const int64_t* c_pos, const uint64_t* c_hash, const uint8_t* c_rev,
    int64_t nc, const int64_t* add_pos, int64_t nadd, int k, int l,
    uint64_t* out_h, int32_t* out_d, int64_t cap) {
    // ---- change sites (builder._change_sites) ----
    std::vector<int64_t> dropped;
    for (int64_t i = 0; i < np_; ++i)
        if (!keep[i]) dropped.push_back(i);

    IntervalAccum piv, civ;
    const int64_t pw = np_ - l + 1, cw = nc - l + 1;
    for (int64_t d : dropped) piv.push(d - (l - 1), d, pw);
    // added member indices on the child side
    for (int64_t a = 0; a < nadd; ++a) {
        int64_t j = std::lower_bound(c_pos, c_pos + nc, add_pos[a]) - c_pos;
        civ.push(j - (l - 1), j, cw);
    }
    if (l > 1) {
        // pure insertions bridge parent windows at their insertion point
        for (int64_t a = 0; a < nadd; ++a) {
            int64_t i = std::lower_bound(p_pos, p_pos + np_, add_pos[a]) - p_pos;
            bool pure = (i >= np_) || (p_pos[i] != add_pos[a]);
            if (pure) piv.push(i - (l - 1), i - 1, pw);
        }
        // pure deletions bridge child windows
        for (int64_t d : dropped) {
            int64_t j = std::lower_bound(c_pos, c_pos + nc, p_pos[d]) - c_pos;
            bool pure = (j >= nc) || (c_pos[j] != p_pos[d]);
            if (pure) civ.push(j - (l - 1), j - 1, cw);
        }
    }
    piv.merge();
    civ.merge();

    std::unordered_map<uint64_t, int> net;
    accum_windows(c_hash, c_rev, nc, civ.iv, k, l, +1, net);
    accum_windows(p_hash, p_rev, np_, piv.iv, k, l, -1, net);

    std::vector<std::pair<uint64_t, int>> rows;
    rows.reserve(net.size());
    for (const auto& kv : net)
        if (kv.second != 0) rows.emplace_back(kv.first, kv.second);
    int64_t need = (int64_t)rows.size();
    if (need > cap) return need;
    std::sort(rows.begin(), rows.end());
    for (int64_t i = 0; i < need; ++i) {
        out_h[i] = rows[i].first;
        out_d[i] = rows[i].second;
    }
    return need;
}

}  // extern "C"

extern "C" {

// Multi-range rolling-syncmer scan: one call scans R subranges
// [beg[i], end[i]] (inclusive, byte offsets into seq) and writes the
// concatenated per-window results at out_off[i] = sum of prior window
// counts.  Each range's scan equals pt_rolling_syncmers(seq+beg, len)
// exactly (window count = len - k + 1, clamped at 0).  Replaces the
// per-range python wrapper calls in builder.compute_state.
void pt_rolling_syncmers_multi(const uint8_t* seq, int64_t n,
                               const int64_t* beg, const int64_t* end,
                               int64_t nr, int k, int s, int t, int open_,
                               const int64_t* out_off, uint64_t* hashes,
                               uint8_t* is_rev, uint8_t* is_sync) {
    (void)n;
    for (int64_t r = 0; r < nr; ++r) {
        int64_t len = end[r] - beg[r] + 1;
        if (len < k) continue;
        pt_rolling_syncmers(seq + beg[r], len, k, s, t, open_,
                            hashes + out_off[r], is_rev + out_off[r],
                            is_sync + out_off[r]);
    }
}

}  // extern "C"

extern "C" {

// Mate-overlap entry matching (genotype/caller.py::_apply_overlap_tweaks_flat
// core): for each proper pair (mi[p], mj[p]) walk the two mates' flat pileup
// entry ranges (sorted by ref position within each read) with two pointers,
// emitting the qual-array indices (aqi) of entries at COMMON ref positions —
// 'a' mate (leftmost, a_read flag) first.  Replaces a stable argsort over
// every paired entry (~12M rows on the sars demo).
int64_t pt_pair_overlap_match(const int64_t* flat_p, const int64_t* aqi,
                              const int64_t* bounds, const int64_t* mi,
                              const int64_t* mj, int64_t npairs,
                              const uint8_t* a_read,
                              int64_t* out_ix, int64_t* out_iy,
                              int64_t* out_pair) {
    int64_t out = 0;
    for (int64_t p = 0; p < npairs; ++p) {
        int64_t ra = mi[p], rb = mj[p];
        int64_t ia = bounds[ra], ea = bounds[ra + 1];
        int64_t ib = bounds[rb], eb = bounds[rb + 1];
        bool a_is_ra = a_read[ra] != 0;
        while (ia < ea && ib < eb) {
            int64_t pa = flat_p[ia], pb = flat_p[ib];
            if (pa < pb) {
                ++ia;
            } else if (pb < pa) {
                ++ib;
            } else {
                out_ix[out] = aqi[a_is_ra ? ia : ib];
                out_iy[out] = aqi[a_is_ra ? ib : ia];
                out_pair[out] = p;
                ++out; ++ia; ++ib;
            }
        }
    }
    return out;
}

}  // extern "C"

extern "C" {

// BAM 4-bit sequence packing (io/bam.py::encode_bam_columnar nibble block):
// per record, LUT-map the ASCII bases and pack two per byte straight into
// the output BAM stream at dst_off[i] — replaces an 8-op fancy-index chain
// over the whole base blob.
void pt_pack_nibbles(const uint8_t* seq, const int64_t* seq_off, int64_t n,
                     const uint8_t* lut, uint8_t* dst,
                     const int64_t* dst_off) {
    for (int64_t i = 0; i < n; ++i) {
        int64_t s = seq_off[i], e = seq_off[i + 1], d = dst_off[i];
        for (int64_t j = s; j + 1 < e; j += 2)
            dst[d++] = (uint8_t)((lut[seq[j]] << 4) | lut[seq[j + 1]]);
        if ((e - s) & 1) dst[d] = (uint8_t)(lut[seq[e - 1]] << 4);
    }
}

}  // extern "C"

extern "C" {

// Positioned k-min-mer recombination over affected position ranges (meta
// builder's _incremental_meta_delta inner loop): for each range [t0, t1]
// find the child windows whose start position falls inside, emit canonical
// k-min-mer (hash, rev, pos, end) rows; ends walk k-1 steps on the non-gap
// grid nz when the last member's start sits on it (builder._km_ends).
// Returns the row count (caller sizes the buffers at sum of window spans).
int64_t pt_meta_kminmers(const int64_t* c_pos, const uint64_t* c_hash,
                         const uint8_t* c_rev, int64_t nc,
                         const int64_t* t0s, const int64_t* t1s, int64_t nr,
                         const int64_t* nz, int64_t nnz, int k, int l,
                         int64_t* out_pos, uint64_t* out_hash,
                         uint8_t* out_rev, int64_t* out_end) {
    int64_t out = 0;
    const int64_t nwc = nc - l + 1;
    if (nwc <= 0) return 0;
    for (int64_t r = 0; r < nr; ++r) {
        int64_t w0 = std::lower_bound(c_pos, c_pos + nc, t0s[r]) - c_pos;
        int64_t w1 = std::upper_bound(c_pos, c_pos + nc, t1s[r]) - c_pos - 1;
        if (w1 > nwc - 1) w1 = nwc - 1;
        for (int64_t w = w0; w <= w1; ++w) {
            uint64_t km;
            uint8_t rev;
            if (l == 1) {
                km = c_hash[w];
                rev = c_rev[w];
            } else {
                uint64_t F = 0, R = 0;
                for (int i = 0; i < l; ++i) {
                    int rr = (k * (l - 1 - i)) & 63;
                    F ^= rol(c_hash[w + i], rr);
                    R ^= rol(c_hash[w + l - 1 - i], rr);
                }
                if (F == R) continue;  // invalid (palindromic combine)
                km = F < R ? F : R;
                rev = R < F;
            }
            int64_t last = c_pos[w + l - 1];
            int64_t end = last + (k - 1);
            if (nnz) {
                int64_t ii = std::lower_bound(nz, nz + nnz, last) - nz;
                if (ii < nnz && nz[ii] == last && ii + k - 1 < nnz)
                    end = nz[ii + k - 1];
            }
            out_pos[out] = c_pos[w];
            out_hash[out] = km;
            out_rev[out] = rev;
            out_end[out] = end;
            ++out;
        }
    }
    return out;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// bcftools indel realignment over a batch of candidate sites: the per-site
// work of the JAX package's walk (panmap_tpu/genotype/indel.py::
// call_indels_realign; bam2bcf_indel.c bcf_call_gap_prep + the glfgen
// entries of bam2bcf.c), from the covering reads to the (q, strand, slot)
// entries, in that walk's order and double arithmetic (built -std=c++17: no
// FMA contraction).  The per-site tail (errmod, PL/GT, est_indelreg, the
// allele strings) stays in Python (genotype/indel.py::_site_record).
// ---------------------------------------------------------------------------

namespace {

// bcftools mpileup's defaults (mpileup.c:1363-1384)
constexpr int64_t IND_MIN_SUPPORT = 2;
constexpr double IND_MIN_FRAC = 0.05;
constexpr int64_t IND_WIN = 110;
constexpr int64_t IND_MAX_TYPES = 64;
constexpr int64_t IND_MAX_DEPTH = 250;
constexpr int64_t IND_OPEN_Q = 40, IND_EXT_Q = 20, IND_TANDEM_Q = 500;
constexpr int64_t IND_CAP_Q = 60, IND_MIN_BASEQ = 1;

inline bool ind_mop(int64_t op) { return op == 0 || op == 7 || op == 8; }
inline bool ind_qop(int64_t op) { return op == 1 || op == 4; }
inline bool ind_dop(int64_t op) { return op == 2 || op == 3; }
inline int64_t ind_min(int64_t a, int64_t b) { return a < b ? a : b; }
inline int64_t ind_max(int64_t a, int64_t b) { return a > b ? a : b; }
// a Python slice [a:b] (a, b >= 0) of a sequence of length len: [lo, hi)
inline void ind_slice(int64_t len, int64_t a, int64_t b, int64_t& lo,
                      int64_t& hi) {
    lo = ind_min(a, len);
    hi = ind_max(ind_min(b, len), lo);
}

// _tpos2qpos: query index aligned at ref tpos and the actual tpos
void ind_tpos2qpos(int64_t rs, const int64_t* ops, const int64_t* lns,
                   int64_t nop, int64_t tpos, bool is_left, int64_t& qpos,
                   int64_t& tact) {
    int64_t x = rs, y = 0, last_y = 0;
    for (int64_t k = 0; k < nop; ++k) {
        const int64_t op = ops[k], ln = lns[k];
        if (ind_mop(op)) {
            if (rs > tpos) { qpos = y; tact = rs; return; }
            if (x + ln > tpos) { qpos = y + (tpos - x); tact = tpos; return; }
            x += ln;
            y += ln;
            last_y = y;
        } else if (ind_qop(op)) {
            y += ln;
        } else if (ind_dop(op)) {
            if (x + ln > tpos) { qpos = y; tact = is_left ? x : x + ln; return; }
            x += ln;
        }
    }
    qpos = last_y;
    tact = x;
}

// _read_state_at: (covers, indel after pos, qpos) of a read at ref pos
bool ind_read_state_at(int64_t rs, const int64_t* ops, const int64_t* lns,
                       int64_t nop, int64_t pos, int64_t& indel,
                       int64_t& qpos) {
    int64_t x = rs, y = 0;
    for (int64_t k = 0; k < nop; ++k) {
        const int64_t op = ops[k], ln = lns[k];
        if (ind_mop(op)) {
            if (x <= pos && pos < x + ln) {
                indel = 0;
                if (pos == x + ln - 1 && k + 1 < nop) {
                    if (ops[k + 1] == 1) indel = lns[k + 1];
                    else if (ops[k + 1] == 2) indel = -lns[k + 1];
                }
                qpos = y + (pos - x);
                return true;
            }
            x += ln;
            y += ln;
        } else if (ind_qop(op)) {
            y += ln;
        } else if (ind_dop(op)) {
            if (x <= pos && pos < x + ln) { indel = 0; qpos = y; return true; }
            x += ln;
        }
    }
    return false;
}

struct IndRep { int64_t st, en, rlen; };

// find_str (bcftools str_finder.c find_STR over 0..4 codes, unpadded,
// lower_only=0): [(start, end, rep_len)] with the containment pruning
void ind_find_str(const uint8_t* c, int64_t n, std::vector<IndRep>& reps) {
    reps.clear();
    auto add_rep = [&](int64_t pos, int64_t rlen) {
        if (!reps.empty()) {
            const IndRep& b = reps.back();
            if (b.st <= pos - rlen * 2 + 1 && b.en >= pos) return;
        }
        int64_t i1 = pos + 1 - rlen, i2 = pos + 1;
        while (i2 < n && c[i1] == c[i2]) { ++i1; ++i2; }
        const int64_t end = pos + (i2 - (pos + 1));
        const int64_t start = pos - 2 * rlen + 1;
        while (!reps.empty()) {
            const IndRep& b = reps.back();
            if (b.en < start) break;
            if (b.st >= start) reps.pop_back();
            else break;
        }
        reps.push_back({start, end, rlen});
    };
    uint32_t w = 0;
    int64_t i = 0, j = 0;
    for (; i < n && j < 15; ++i, ++j) {
        w = (w << 2) | c[i];
        for (int r = 1; r < 8; ++r) {
            const uint32_t m = (1u << (2 * r)) - 1;
            if (j >= 2 * r - 1 && (w & m) == ((w >> (2 * r)) & m))
                add_rep(i, r);
        }
    }
    for (; i < n; ++i) {
        w = (w << 2) | c[i];
        for (int r = 8; r >= 1; --r) {  // longest first, one hit
            const uint32_t m = (1u << (2 * r)) - 1;
            if ((w & m) == ((w >> (2 * r)) & m)) { add_rep(i, r); break; }
        }
    }
}

int64_t ind_est_seqq(int64_t l, int64_t l_run) {
    const int64_t al = l < 0 ? -l : l;
    const int64_t q = IND_OPEN_Q + IND_EXT_Q * (al - 1);
    const int64_t qh = l_run >= 3
        ? (int64_t)((double)(IND_TANDEM_Q * al) / (double)l_run + 0.499)
        : 1000;
    return ind_min(q, qh);
}

// ref codes: 0..3 ACGT (either case), 4 N, 5 any other byte
int64_t ind_l_run(const uint8_t* ref, int64_t n, int64_t pos) {
    if (pos + 1 >= n) return 1;
    const uint8_t c = ref[pos + 1];
    if (c > 3) return 1;
    int64_t i = pos + 2;
    while (i < n && ref[i] == c) ++i;
    const int64_t l_run = i;
    i = pos;
    while (i >= 0 && ref[i] == c) --i;
    return l_run - (i + 1);
}

struct IndReads {
    const int64_t *rs, *ops, *lns, *opoff, *quals, *soff, *mapq;
    const uint8_t* codes;  // 0..4 per base of the oriented seq blob
    const int8_t* rev;
    int64_t nk, nseq;
    std::vector<int64_t> ends;  // rs + the ref-advancing ops' lengths
    std::vector<uint8_t> skip;  // the read has a ref skip (op 3)
    bool sorted = true;         // rs non-decreasing: windowed overlap scan
    int64_t max_span = 0;
    const uint8_t* ref;
    int64_t n;
};

struct IndOut {
    int8_t* status;
    int32_t *n_types, *types, *n_slots, *slot_types, *n_entries;
    const int64_t* ins_off;
    int64_t* ins_at;
    uint8_t *ins_codes, *e_q, *e_s, *e_b;
};

struct IndScratch {
    std::vector<int64_t> pr, pind, pq, types, cns_ref, cns_alt, cnt, ins_len,
        ins_pos, qbeg, tbeg0, qpos_t, qend, tend, score, aux, sc, sumq, order;
    std::vector<uint8_t> cons, ins, ref2, seg, qq;
    std::vector<IndRep> reps;
};

// one candidate site: status 1 with its types, slots, insertion consensus
// and entries, else 0 (where the JAX package's walk drops the site before
// its errmod); -1 if the insertion capacity was short.  Returns the jobs scored.
int64_t ind_site(const IndReads& R, int64_t s, int64_t pos, IndScratch& S,
                 const IndOut& O) {
    O.status[s] = 0;
    const int64_t n = R.n;
    const uint8_t* ref = R.ref;
    // ---- covering reads in row order, capped (bcftools --max-idepth) ----
    S.pr.clear(); S.pind.clear(); S.pq.clear();
    int64_t r0 = 0, r1 = R.nk;
    if (R.sorted) {
        r0 = std::lower_bound(R.rs, R.rs + R.nk, pos - R.max_span + 1) - R.rs;
        r1 = std::upper_bound(R.rs, R.rs + R.nk, pos) - R.rs;
    }
    for (int64_t r = r0; r < r1; ++r) {
        if (!(R.rs[r] <= pos && pos < R.ends[r])) continue;
        const int64_t a = R.opoff[r], b = R.opoff[r + 1];
        int64_t indel = 0, qpos = 0;
        if (ind_read_state_at(R.rs[r], R.ops + a, R.lns + a, b - a, pos,
                              indel, qpos)) {
            S.pr.push_back(r); S.pind.push_back(indel); S.pq.push_back(qpos);
            if ((int64_t)S.pr.size() >= IND_MAX_DEPTH) break;
        }
    }
    const int64_t N = S.pr.size();
    if (N == 0) return 0;
    // ---- bcf_cgp_find_types ----
    S.types.clear();
    int64_t n_alt = 0;
    for (int64_t K = 0; K < N; ++K)
        if (S.pind[K] != 0) { ++n_alt; S.types.push_back(S.pind[K]); }
    if (n_alt == 0) return 0;
    if (n_alt < IND_MIN_SUPPORT || (double)n_alt / (double)N < IND_MIN_FRAC)
        return 0;
    S.types.push_back(0);
    std::sort(S.types.begin(), S.types.end());
    S.types.erase(std::unique(S.types.begin(), S.types.end()), S.types.end());
    const int64_t T = S.types.size();
    if (T < 2 || T >= IND_MAX_TYPES) return 0;
    // N-run guard
    int64_t max_rd_len = 0;
    for (int64_t K = 0; K < N; ++K)
        max_rd_len = ind_max(max_rd_len, R.soff[S.pr[K] + 1] - R.soff[S.pr[K]]);
    {
        int64_t lo, hi;
        ind_slice(n, pos, ind_min(pos + ind_min(2 * IND_WIN, max_rd_len), n),
                  lo, hi);
        int64_t nn = 0;
        for (int64_t i = lo; i < hi; ++i) nn += ref[i] == 4;
        if (hi > lo && 2 * nn > hi - lo) return 0;
    }
    const int64_t ref_type =
        std::find(S.types.begin(), S.types.end(), 0) - S.types.begin();
    // ---- window ----
    const int64_t left = ind_max(pos - IND_WIN, 0);
    int64_t right = pos + IND_WIN;
    if (S.types[0] < 0) right -= S.types[0];
    right = ind_min(right, n);
    const int64_t L = right - left;
    // ---- per-sample consensus (bcf_cgp_ref_sample; one sample) ----
    S.cns_ref.assign(L, 0);
    S.cns_alt.assign(L, 0);
    for (int64_t K = 0; K < N; ++K) {
        const int64_t r = S.pr[K];
        int64_t x = R.rs[r], y = 0;
        const int64_t base = R.soff[r];
        for (int64_t k = R.opoff[r]; k < R.opoff[r + 1]; ++k) {
            const int64_t op = R.ops[k], ln = R.lns[k];
            if (ind_mop(op)) {
                if (x + ln >= left) {
                    const int64_t j0 = ind_max(left - x, 0);
                    const int64_t j1 = ind_min(right - x, ln);
                    for (int64_t j = j0; j < j1; ++j) {
                        const int64_t at = base + y + j;
                        const uint8_t code = at < R.nseq ? R.codes[at] : 4;
                        const int64_t i = x + j - left;
                        if (code < 4 && code == ref[left + i]) ++S.cns_ref[i];
                        else ++S.cns_alt[i];
                    }
                }
                x += ln;
                y += ln;
            } else if (ind_dop(op)) {
                x += ln;
            } else if (ind_qop(op)) {
                y += ln;
            }
            if (x > right) break;
        }
    }
    // deepest and 2nd-deepest ALT loci (>= comparisons as in the C walk)
    int64_t m_alt = 0, m_ref = 0, m_i = -1, m2_alt = 0, m2_ref = 0, m2_i = -1;
    for (int64_t i = 0; i < L; ++i) {
        if (S.cns_alt[i] >= m_alt) {
            m2_alt = m_alt; m2_ref = m_ref; m2_i = m_i;
            m_alt = S.cns_alt[i]; m_ref = S.cns_ref[i]; m_i = i;
        } else if (S.cns_alt[i] >= m2_alt) {
            m2_alt = S.cns_alt[i]; m2_ref = S.cns_ref[i]; m2_i = i;
        }
    }
    if (m_alt + m_ref > 0 && (double)m_ref / (double)(m_ref + m_alt) >= 0.7)
        m_i = -1;
    if (m2_alt + m2_ref > 0 &&
        (double)m2_ref / (double)(m2_ref + m2_alt) >= 0.7)
        m2_i = -1;
    S.cons.resize(L);
    for (int64_t i = 0; i < L; ++i)
        S.cons[i] = ref[left + i] < 4 ? ref[left + i] : 4;
    if (m_i >= 0) S.cons[m_i] = 4;
    if (m2_i >= 0) S.cons[m2_i] = 4;
    const int64_t l_run = ind_l_run(ref, n, pos);
    // ---- insertion consensus (bcf_cgp_calc_cons) ----
    const int64_t ins0 = O.ins_off[s], ins_cap = O.ins_off[s + 1] - ins0;
    S.ins.clear();
    S.ins_len.assign(T, 0);
    std::vector<int64_t>& ins_at = S.ins_pos;  // type t's string in S.ins
    ins_at.assign(T, 0);
    for (int64_t t = 0; t < T; ++t) {
        const int64_t ty = S.types[t];
        if (ty <= 0) continue;
        S.cnt.assign(ty * 5, 0);
        for (int64_t K = 0; K < N; ++K) {
            if (S.pind[K] != ty) continue;
            const int64_t r = S.pr[K], base = R.soff[r], end = R.soff[r + 1];
            for (int64_t k = 1; k <= ty; ++k) {
                const int64_t at = base + S.pq[K] + k;
                const int64_t c = at < end ? R.codes[at] : 4;
                ++S.cnt[(k - 1) * 5 + ind_min(c, 4)];
            }
        }
        const size_t at0 = S.ins.size();
        bool dead = false;
        for (int64_t j = 0; j < ty; ++j) {
            const int64_t* row = &S.cnt[j * 5];
            int64_t mk = 0;
            for (int64_t c = 1; c < 5; ++c)
                if (row[c] > row[mk]) mk = c;
            if (row[mk] <= 0) mk = 4;
            if (mk == 4) { S.types[t] = 0; dead = true; break; }  // holds N
            S.ins.push_back((uint8_t)mk);
        }
        if (dead) { S.ins.resize(at0); continue; }
        ins_at[t] = at0;
        S.ins_len[t] = ty;
    }
    if ((int64_t)S.ins.size() > ins_cap) { O.status[s] = -1; return 0; }
    // ---- per (read x type) realignment scores ----
    S.qbeg.resize(N); S.tbeg0.resize(N); S.qpos_t.resize(N);
    S.qend.resize(N); S.tend.resize(N);
    for (int64_t K = 0; K < N; ++K) {  // type-independent read geometry
        const int64_t r = S.pr[K], a = R.opoff[r], nop = R.opoff[r + 1] - a;
        int64_t q, tb, tmp;
        ind_tpos2qpos(R.rs[r], R.ops + a, R.lns + a, nop, left, false, q, tb);
        S.qbeg[K] = q;
        S.tbeg0[K] = tb;
        ind_tpos2qpos(R.rs[r], R.ops + a, R.lns + a, nop, pos, false, q, tmp);
        S.qpos_t[K] = q - S.qbeg[K];
        ind_tpos2qpos(R.rs[r], R.ops + a, R.lns + a, nop, right, true, q, tb);
        S.qend[K] = q;
        S.tend[K] = tb;
    }
    S.score.assign(N * T, 0xFFFFFF);
    int64_t jobs = 0;
    for (int64_t t = 0; t < T; ++t) {
        const int64_t ty = S.types[t];
        // ref2: the consensus with the type applied at pos
        S.ref2.assign(S.cons.begin(), S.cons.begin() + (pos - left + 1));
        int64_t j;
        if (ty > 0) {
            S.ref2.insert(S.ref2.end(), S.ins.begin() + ins_at[t],
                          S.ins.begin() + ins_at[t] + ty);
            j = pos + 1;
        } else {
            j = pos + 1 - ind_min(ty, 0);  // deletion skips -ty bases
        }
        int64_t lo, hi;
        ind_slice(L, j - left, L, lo, hi);
        S.ref2.insert(S.ref2.end(), S.cons.begin() + lo, S.cons.begin() + hi);
        const int64_t n2 = S.ref2.size();
        for (int64_t K = 0; K < N; ++K) {
            const int64_t r = S.pr[K];
            if (R.skip[r]) continue;  // BAM_CREF_SKIP
            const int64_t qbeg = S.qbeg[K], qend = S.qend[K], tend = S.tend[K];
            int64_t tbeg = S.tbeg0[K];
            if (ty < 0) tbeg = ind_max(tbeg + ty, left);
            if (qend <= qbeg) continue;
            const int64_t base = R.soff[r];
            int64_t qlo, qhi;
            ind_slice(R.nseq, base + qbeg, base + qend, qlo, qhi);
            if (tend <= tbeg) continue;  // read within a deletion: 0xffffff
            const int64_t seg_lo = tbeg - left, seg_len = tend - tbeg + ty;
            if (seg_len <= 0) continue;
            ind_slice(n2, seg_lo, seg_lo + seg_len, lo, hi);
            S.seg.assign(S.ref2.begin() + lo, S.ref2.begin() + hi);
            S.seg.resize(seg_len, 4);  // the C buffer's N padding
            S.qq.resize(qhi - qlo);
            for (int64_t i = qlo; i < qhi; ++i) {
                const int64_t v = R.quals[i];
                S.qq[i - qlo] = (uint8_t)(v < 7 ? 7 : (v > 30 ? 30 : v));
            }
            const int64_t sc = pt_glocal_score(
                S.seg.data(), (int)seg_len, R.codes + qlo, (int)(qhi - qlo),
                S.qq.data(), (int)((ty < 0 ? -ty : ty) + 3), 1e-4, 1e-2);
            ++jobs;
            if (sc < 0) continue;
            const int64_t lnorm =
                (int64_t)(100.0 * (double)sc / (double)(qend - qbeg) + 0.499);
            int64_t sp = (sc << 8) | ind_min(255, lnorm);
            // STR adjustment over the aligned consensus segment
            int64_t iscore = 0;
            const int64_t r_start = R.rs[r], r_end = R.ends[r] - 1;
            const int64_t qt = S.qpos_t[K];
            ind_find_str(S.seg.data(), seg_len, S.reps);
            for (const IndRep& p : S.reps) {
                if (p.st <= qt && qt <= p.en) {
                    iscore += (p.en - p.st) / p.rlen;
                    if (p.st + tbeg <= r_start || p.en + tbeg >= r_end)
                        iscore += 2 * (p.en - p.st);
                }
            }
            const int64_t l2 =
                (int64_t)((double)(sp & 0xFF) * 0.8 + (double)(iscore * 2));
            sp = (sp & ~(int64_t)0xFF) | ind_min(255, l2);
            S.score[K * T + t] = sp;
        }
    }
    // ---- compute_indelQ ----
    S.aux.assign(N, 0);
    S.sumq.assign(T, 0);
    std::vector<int64_t>& sc = S.sc;
    sc.resize(T);
    for (int64_t K = 0; K < N; ++K) {
        for (int64_t t = 0; t < T; ++t) sc[t] = S.score[K * T + t] << 6 | t;
        std::sort(sc.begin(), sc.end());
        int64_t indelq, seqq;
        if ((sc[0] & 0x3F) == ref_type) {
            indelq = (sc[1] >> 14) - (sc[0] >> 14);
            seqq = ind_est_seqq(S.types[sc[1] & 0x3F], l_run);
        } else {
            int64_t tt = 0;
            while ((sc[tt] & 0x3F) != ref_type) ++tt;
            indelq = (sc[tt] >> 14) - (sc[0] >> 14);
            seqq = ind_est_seqq(S.types[sc[0] & 0x3F], l_run);
        }
        const int64_t tmp = (sc[0] >> 6) & 0xFF;
        indelq = tmp > 111 ? 0
            : (int64_t)((1.0 - (double)tmp / 111.0) * (double)indelq + 0.499);
        indelq = ind_min(ind_min(indelq, seqq), 255);
        seqq = ind_min(seqq, 255);
        S.aux[K] = (sc[0] & 0x3F) << 16 | seqq << 8 | indelq;
        S.sumq[sc[0] & 0x3F] += ind_min(indelq, seqq);
    }
    // types by the packed key (sumq<<6 | t) descending, REF moved to slot 0
    S.order.resize(T);
    for (int64_t t = 0; t < T; ++t) S.order[t] = t;
    std::sort(S.order.begin(), S.order.end(), [&](int64_t a, int64_t b) {
        return ((S.sumq[a] << 6) | a) > ((S.sumq[b] << 6) | b);
    });
    S.order.erase(std::find(S.order.begin(), S.order.end(), ref_type));
    S.order.insert(S.order.begin(), ref_type);
    const int64_t n_slots = ind_min(4, T);
    int64_t n_alt_reads = 0;
    for (int64_t K = 0; K < N; ++K) {
        const int64_t t0 = S.aux[K] >> 16 & 0x3F;
        int64_t jj = 4;
        for (int64_t q = 0; q < n_slots; ++q)
            if (S.order[q] == t0) { jj = q; break; }
        S.aux[K] = jj << 16 | (jj == 4 ? 0 : (S.aux[K] & 0xFFFF));
        if (jj > 0) ++n_alt_reads;
    }
    if (n_alt_reads == 0) return jobs;
    // ---- glfgen entries (indel mode, bam2bcf.c:309-470) ----
    int64_t ne = 0;
    const int64_t e0 = s * IND_MAX_DEPTH;
    for (int64_t K = 0; K < N; ++K) {
        const int64_t r = S.pr[K];
        int64_t b_slot = S.aux[K] >> 16 & 0x3F;
        int64_t q = S.aux[K] & 0xFF, seqq = q;
        const int64_t base = R.soff[r], rl = R.soff[r + 1] - R.soff[r];
        if (S.pind[K] == 0 && (2 * q < N || N > 20)) {
            b_slot = 0;
            q = rl ? R.quals[base + ind_min(S.pq[K], rl - 1)] : 0;
            seqq = (3 * seqq + 2 * q) / 8;  // quals >= 0
        }
        if (N > 20 && seqq > 40) seqq = 40;
        if (q < IND_MIN_BASEQ) continue;
        const int64_t mapq = ind_min(R.mapq[r], IND_CAP_Q);
        q = ind_min(q, seqq);
        q = ind_min(q, mapq);
        q = ind_max(4, ind_min(q, 63));
        if (b_slot >= 4) continue;
        O.e_q[e0 + ne] = (uint8_t)q;
        O.e_s[e0 + ne] = (uint8_t)R.rev[r];
        O.e_b[e0 + ne] = (uint8_t)b_slot;
        ++ne;
    }
    if (ne == 0) return jobs;
    O.status[s] = 1;
    O.n_entries[s] = (int32_t)ne;
    O.n_types[s] = (int32_t)T;
    for (int64_t t = 0; t < T; ++t) {
        O.types[s * IND_MAX_TYPES + t] = (int32_t)S.types[t];
        O.ins_at[s * IND_MAX_TYPES + t] = ins0 + ins_at[t];
    }
    O.n_slots[s] = (int32_t)n_slots;
    for (int64_t q = 0; q < n_slots; ++q)
        O.slot_types[s * 4 + q] = (int32_t)S.types[S.order[q]];
    std::copy(S.ins.begin(), S.ins.end(), O.ins_codes + ins0);
    return jobs;
}

}  // namespace

extern "C" {

// The realignment of genotype/indel.py over the candidate positions cand
// (sorted, from call_indels_realign's array pass), across n_threads host
// threads that take chunks of consecutive sites; each site writes its own
// slots, so the output does not depend on the thread count.  Reads: the
// IndelInput arrays (codes: the seq blob as 0..4 codes, nseq long); ref:
// 0..3 ACGT, 4 N, 5 other.  Per site s: status (1: entries; 0: none; -1:
// ins_off's capacity was short), its types after the N discard (n_types,
// types[s*64..]), the types of its slots (REF first; n_slots,
// slot_types[s*4..]), each positive type's insertion consensus at
// ins_codes[ins_at[s*64+t]..+type] (inside [ins_off[s], ins_off[s+1])),
// and its entries (q, strand, slot) at [s*250, s*250+n_entries[s]).
// Returns the realignments scored.
int64_t pt_indel_sites(
    const int64_t* rs, const int64_t* ops, const int64_t* lns,
    const int64_t* opoff, int64_t nk, const uint8_t* codes,
    const int64_t* quals, const int64_t* soff, int64_t nseq,
    const int64_t* mapq, const int8_t* rev, const uint8_t* ref, int64_t n,
    const int64_t* cand, int64_t nc, const int64_t* ins_off, int n_threads,
    int8_t* status, int32_t* n_types, int32_t* types, int32_t* n_slots,
    int32_t* slot_types, int64_t* ins_at, uint8_t* ins_codes,
    int32_t* n_entries, uint8_t* e_q, uint8_t* e_s, uint8_t* e_b) {
    IndReads R;
    R.rs = rs; R.ops = ops; R.lns = lns; R.opoff = opoff; R.quals = quals;
    R.soff = soff; R.mapq = mapq; R.codes = codes; R.rev = rev; R.nk = nk;
    R.nseq = nseq; R.ref = ref; R.n = n;
    R.ends.resize(nk);
    R.skip.assign(nk, 0);
    for (int64_t r = 0; r < nk; ++r) {
        int64_t span = 0;
        for (int64_t k = opoff[r]; k < opoff[r + 1]; ++k) {
            if (ind_mop(ops[k]) || ind_dop(ops[k])) span += lns[k];
            if (ops[k] == 3) R.skip[r] = 1;
        }
        R.ends[r] = rs[r] + span;
        R.max_span = ind_max(R.max_span, span);
        if (r > 0 && rs[r] < rs[r - 1]) R.sorted = false;
    }
    IndOut O{status, n_types, types, n_slots, slot_types, n_entries,
             ins_off, ins_at, ins_codes, e_q, e_s, e_b};
    if (n_threads < 1) n_threads = 1;
    if (n_threads > nc) n_threads = nc > 0 ? (int)nc : 1;
    const int64_t CHUNK = 16;
    std::atomic<int64_t> next{0};
    std::vector<int64_t> jobs(n_threads, 0);
    auto work = [&](int ti) {
        IndScratch S;
        for (;;) {
            const int64_t c0 = next.fetch_add(CHUNK);
            if (c0 >= nc) break;
            const int64_t c1 = ind_min(c0 + CHUNK, nc);
            for (int64_t s = c0; s < c1; ++s)
                jobs[ti] += ind_site(R, s, cand[s], S, O);
        }
    };
    std::vector<std::thread> threads;
    for (int ti = 1; ti < n_threads; ++ti) threads.emplace_back(work, ti);
    work(0);
    for (auto& th : threads) th.join();
    int64_t total = 0;
    for (int64_t j : jobs) total += j;
    return total;
}

}  // extern "C"
