// Batched shifted-band dual-affine local DP for long reads (map-ont /
// map-hifi), for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel panmap_tpu/align/pallas_long.py::_long_call
// (body _make_kernel, batch entry long_dp_device_batch).  For each item (query,
// band) it computes every DP row of align/longread.py::banded_dp_shifted:
// row i covers the 0-based reference positions [dlo + i, dlo + i + worig),
// with minimap2's two gap tiers (-O q,q2 -E e,e2) as the insertion lanes F
// and F2 carried across rows and the deletion lanes E and E2 along the row.
// Per cell it writes a direction byte: bits 0-2 the H source in the host
// traceback's priority order (0 zero, 1 diag, 2 E, 3 E2, 4 F, 5 F2, 1 as the
// last resort), bits 3/4/5/6 the E/E2/F/F2 "run continues" flags.  Per row it
// writes (max H, first column of the max).  The host replays the z-drop rule
// over the row stats and walks the bytes for the CIGAR
// (align/long_dp.py::_finish_one).  Padded cells (rows >= lq, columns >=
// worig) are written as 0, stats rows >= lq as (0, 0).  The scoring constants
// are arguments, so one build serves both presets.
//
// What bounds it: int32 operations.  The recurrences, the source choice,
// the four run flags, the byte and the row max come to ~45 int32 operations a
// cell at the least (this source issues ~50) against one byte of output, so
// at the card's int32 rate the operations cost ~10x what the bytes cost at
// its memory rate.  The rows of an item are serial (row i needs row i - 1),
// so the parallelism is the band (~1,000 columns) times the items of a
// launch (600-800), and what a row costs beyond its cells' arithmetic is
// communication: the deletion lanes are a prefix scan along the row, the
// insertion lanes read the right neighbour of the row above, and the row's
// (max, argmax) is a reduction.
//
// Design, by what it does about that:
//  - A thread owns COLS consecutive band columns (8; 16 above 8,192 columns)
//    and keeps their H, F, F2 and reference codes in registers for the whole
//    item, so a block is W / 8 threads (5 warps at the usual W of
//    1,001-1,264; 80 registers a thread, no spills, 5 blocks an SM).  The
//    insertion neighbour (column c + 1 of the row above) is the thread's own
//    next register; the last one comes by one __shfl_down_sync, across warps
//    through one shared word per warp.
//  - E and E2 run as the recurrence e[c] = max(e[c-1] - ext, base[c-1] -
//    open) down the thread's own columns (exactly the prefix-max identity of
//    the Pallas kernel, in integers), in two passes: pass 1 finds what the
//    thread's columns alone hand on (its "tail" y_t = max_m(base[m] - open -
//    (last - m) * ext)), a max-scan over threads turns the tails into what
//    enters each thread (made a pure max by adding (t + 1) * COLS * ext: one
//    warp scan per tier per thread, 5 shuffle steps for 8 cells, then one
//    __reduce_max_sync over the warp totals in shared memory), pass 2 reruns
//    the recurrence from there.  The "run continues" flag e[c] == e[c-1] -
//    ext needs, for a thread's first column, the left thread's last e: it
//    travels with the same scan (one more shuffle), not through another
//    barrier.
//  - Only the thread that holds the band's last column, and the threads past
//    it, test for the band's edge (the MASKED instances of the two passes);
//    warps wholly past the item's band write their zeros and leave, and the
//    row loop's barriers count only the warps that stay (bar.sync 1, n).
//  - The reference slides in registers: each row shifts the thread's codes by
//    one and loads one byte from the item's reference slice ref[dlo, dlo + lq
//    + W), staged in shared memory once (code 0xFF outside [0, lr)); the query
//    is staged once too.  No global load sits on a row's critical path.
//  - Two barriers a row over the block's few warps (the scan's warp totals;
//    the row's new H for the neighbour exchange and the row max).  Shared
//    words need no double buffer: each is written on one side of a barrier
//    and read on the other.  A thread keeps its own (max H, first column) as
//    one word h * COLS + (COLS - 1 - k); the row's is one __reduce_max_sync
//    per warp on the packed word (h << 14) | (16383 - c), then one more over
//    the warps' words.
//  - Hopper DPX: __viaddmax_s32 for max(h - open, f - ext) and the E tails,
//    __vimax3_s32_relu for base, __vimax3_s32 for h.
//  - The flags go straight into the row's direction words; a thread's 8
//    direction bytes leave as one 8-byte store when W is a multiple of 8
//    (long_dp_batch rounds W to 16); the rows past lq are zeroed by the same
//    threads with the same stores.
//
// Envelope: W <= 16384; codes in q and ref are 0-3 and 4 (N / pad); H <
// 2^17 for the packed row max, i.e. match * LQ < 131072 (checked by the
// entry point); shared memory 2 * LQ + threads * COLS bytes.  int32 state:
// every H lies in [0, match * lq]; the lowest value formed is LNEG - ext2 -
// open2, about -2^30, far from int32's -2^31.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NEG = -(1 << 28);
// "no predecessor" in the E recurrences and scans: below every real value
// (those are >= NEG - open - W * ext), so it never wins a max against one
constexpr int LNEG = -(1 << 30);
constexpr int MAX_THREADS = 1024;
constexpr int MAX_WARPS = MAX_THREADS / 32;
constexpr int MAX_W = 16384;
constexpr unsigned FULL = 0xffffffffu;
constexpr unsigned ARG_MASK = 16383;  // packed row max: (h << 14) | (16383 - c)
constexpr unsigned char OUT_OF_REF = 0xFF;
constexpr unsigned char NO_BASE = 7;  // query code that equals no reference code

struct Scoring {
  int match, mismatch, go, ge, go2, ge2;
};

__device__ __forceinline__ int warp_scan_max(int v, int lane) {
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int t = __shfl_up_sync(FULL, v, off);
    if (lane >= off) v = max(v, t);
  }
  return v;
}

// Zero direction bytes of a thread's COLS columns of one row.
template <int COLS, bool ALIGNED>
__device__ __forceinline__ void store_zeros(int8_t* out, int c0, int W) {
  if (ALIGNED) {
#pragma unroll
    for (int g = 0; g < COLS / 8; ++g)
      if (c0 + 8 * g < W)
        *reinterpret_cast<uint2*>(out + 8 * g) = make_uint2(0u, 0u);
  } else {
#pragma unroll
    for (int k = 0; k < COLS; ++k)
      if (c0 + k < W) out[k] = 0;
  }
}

// Barrier of the row loop: the n threads of the warps that hold a band
// column (barrier 1; __syncthreads, barrier 0, is for the whole block).
__device__ __forceinline__ void row_barrier(int n) {
  asm volatile("bar.sync 1, %0;" ::"r"(n) : "memory");
}

// Pass 1 over a thread's columns of one row: the insertion lanes F and F2
// (kept in place of the row above's), diag, base, the F / F2 "run continues"
// bits (straight into the direction words), and the thread's E tails: y =
// what its columns alone would hand to the column after its last, z = the
// same without the last column's own base.  MASKED: the thread holds the
// band's last column or columns past it (k >= nrem); the others skip every
// test of that.
template <int COLS, bool MASKED>
__device__ __forceinline__ void pass1(
    const int (&H)[COLS], int (&F)[COLS], int (&F2)[COLS],
    const int (&R)[COLS], int (&base)[COLS], int (&diag)[COLS],
    unsigned (&words)[COLS / 4], int hnL, int fnL, int f2nL, int qc, int nrem,
    const Scoring& s, int negmm, int& z1, int& z2, int& y1, int& y2) {
  int le1 = LNEG, le2 = LNEG;
#pragma unroll
  for (int k = 0; k < COLS; ++k) {
    const int hn = k + 1 < COLS ? H[k + 1] : hnL;
    const int fn = k + 1 < COLS ? F[k + 1] : fnL;
    const int f2n = k + 1 < COLS ? F2[k + 1] : f2nL;
    const int tf = fn - s.ge, tf2 = f2n - s.ge2;
    int f = __viaddmax_s32(hn, -s.go, tf);
    int f2 = __viaddmax_s32(hn, -s.go2, tf2);
    bool run1 = f == tf, run2 = f2 == tf2;
    bool inb = R[k] != OUT_OF_REF;
    if (MASKED) {
      const bool nxt = k + 1 < nrem;  // column c + 1 is inside the band
      run1 = run1 && nxt;
      run2 = run2 && nxt;
      f = nxt ? f : NEG;
      f2 = nxt ? f2 : NEG;
      inb = inb && k < nrem;
    }
    if (k % 4 == 0) words[k / 4] = 0u;
    if (run1) words[k / 4] |= 0x20u << (8 * (k % 4));
    if (run2) words[k / 4] |= 0x40u << (8 * (k % 4));
    const int d = H[k] + (R[k] == qc ? s.match : negmm);
    const int bs = inb ? __vimax3_s32_relu(d, f, f2) : NEG;
    base[k] = bs;
    diag[k] = d;
    F[k] = f;
    F2[k] = f2;
    const int b1 = bs - s.go, b2 = bs - s.go2;
    if (k + 1 < COLS) {
      le1 = __viaddmax_s32(le1, -s.ge, b1);
      le2 = __viaddmax_s32(le2, -s.ge2, b2);
    } else {
      z1 = le1 - s.ge;
      z2 = le2 - s.ge2;
      y1 = max(z1, b1);
      y2 = max(z2, b2);
    }
  }
}

// Pass 2: E and E2 from what entered the thread (e: at its first column, t:
// e of the column before, less ext), H, and the rest of the direction
// bytes.  Returns max over the thread's columns of h * COLS + (COLS - 1 - k):
// its largest H and the first column that holds it.
template <int COLS, bool MASKED>
__device__ __forceinline__ int pass2(
    int (&H)[COLS], const int (&F)[COLS], const int (&F2)[COLS],
    const int (&base)[COLS], const int (&diag)[COLS],
    unsigned (&words)[COLS / 4], int e1, int e2, int t1, int t2, int nrem,
    const Scoring& s) {
  int lb = 0;
#pragma unroll
  for (int k = 0; k < COLS; ++k) {
    if (k > 0) {
      t1 = e1 - s.ge;
      t2 = e2 - s.ge2;
      e1 = max(t1, base[k - 1] - s.go);
      e2 = max(t2, base[k - 1] - s.go2);
    }
    int h = __vimax3_s32(base[k], e1, e2);
    h = base[k] >= 0 ? h : 0;  // base is NEG exactly outside the reference
    unsigned v = 1;
    v = h == F2[k] ? 5u : v;
    v = h == F[k] ? 4u : v;
    v = h == e2 ? 3u : v;
    v = h == e1 ? 2u : v;
    v = h == diag[k] ? 1u : v;
    v = h == 0 ? 0u : v;
    if (e1 == t1) v |= 8u;
    if (e2 == t2) v |= 16u;
    int hb = h;
    if (MASKED && k >= nrem) {  // past the band: byte 0, out of the row max
      v = 0u;
      hb = 0;
    }
    words[k / 4] |= v << (8 * (k % 4));
    H[k] = h;
    lb = max(lb, hb * COLS + (COLS - 1 - k));
  }
  return lb;
}

// ALIGNED: W is a multiple of 8, so every thread's 8-column groups start on
// an 8-byte boundary of dirs and lie wholly inside or outside a row.
// MAXT and MINB bound the block and the blocks an SM must hold (and so the
// registers a thread may take): the usual item is 5 warps, a band of
// thousands of columns up to 32.
template <int COLS, int MAXT, int MINB, bool ALIGNED>
__global__ void __launch_bounds__(MAXT, MINB)
banded_long_kernel(const int8_t* __restrict__ q,
                   const int8_t* __restrict__ ref,
                   const int32_t* __restrict__ meta,
                   int8_t* __restrict__ dirs, int32_t* __restrict__ stats,
                   int LQ, int W, int lr, Scoring s) {
  static_assert(COLS == 8 || COLS == 16, "COLS is 8 or 16");
  extern __shared__ unsigned char sbytes[];
  // per warp: the inclusive scan total of its threads' tails, and its last
  // thread's (e at its last column - ext), both tiers, in scaled form
  __shared__ int sTot1[MAX_WARPS], sTot2[MAX_WARPS];
  __shared__ int sTp1[MAX_WARPS], sTp2[MAX_WARPS];
  // per warp: its first column's H, F, F2 of the row just finished (read by
  // the last lane of the warp to its left); entry nwarps stays at its start
  __shared__ int sNH[MAX_WARPS + 1], sNF[MAX_WARPS + 1], sNF2[MAX_WARPS + 1];
  __shared__ unsigned sMax[MAX_WARPS];

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int T = blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = T >> 5;
  const int lq = min(max(meta[b * 3 + 0], 0), LQ);
  const int dlo = meta[b * 3 + 1];
  const int wo = min(max(meta[b * 3 + 2], 0), W);
  const int8_t* qrow = q + (size_t)b * LQ;
  int8_t* drow = dirs + (size_t)b * LQ * W;
  int32_t* srow = stats + (size_t)b * LQ * 2;

  // stage the query and the item's reference slice: sref[x] is the code at
  // 0-based reference position dlo + x, the cell (row i, column c) reads
  // x = c + i
  unsigned char* sq = sbytes;
  unsigned char* sref = sbytes + LQ;
  const int nref = lq + T * COLS;
  for (int x = tid; x < lq; x += T) {
    const int c = qrow[x];
    sq[x] = (c >= 0 && c < 4) ? (unsigned char)c : NO_BASE;
  }
  for (int x = tid; x < nref; x += T) {
    const int pos = dlo + x;
    sref[x] = (pos >= 0 && pos < lr) ? (unsigned char)ref[pos] : OUT_OF_REF;
  }
  for (int w = tid; w <= MAX_WARPS; w += T) {
    sNH[w] = 0;
    sNF[w] = NEG;
    sNF2[w] = NEG;
  }
  __syncthreads();

  const int c0 = tid * COLS;
  const int nrem = wo - c0;  // columns k < nrem are inside the item's band
  // rows past the query: zero stats (any thread, any time: no row of the
  // loop below touches them)
  for (int k = 2 * lq + tid; k < 2 * LQ; k += T) srow[k] = 0;
  // warps that hold a column of the item's band; the others only write
  // their zeros, never meet a barrier again and leave
  const int wact = lq > 0 ? min(nwarps, (wo + 32 * COLS - 1) / (32 * COLS)) : 0;
  if (warp >= wact) {
    for (int i = 0; i < LQ; ++i)
      store_zeros<COLS, ALIGNED>(drow + (size_t)i * W + c0, c0, W);
    return;
  }
  const int nact = wact * 32;  // threads at the row loop's barriers
  int H[COLS], F[COLS], F2[COLS], R[COLS];
#pragma unroll
  for (int k = 0; k < COLS; ++k) {
    H[k] = 0;
    F[k] = NEG;
    F2[k] = NEG;
    R[k] = sref[c0 + k];
  }
  const int negmm = -s.mismatch;
  // scales that turn the across-thread E recurrence into a plain max-scan
  const int sc1 = tid * COLS * s.ge, sc2 = tid * COLS * s.ge2;
  const int sc1n = sc1 + COLS * s.ge, sc2n = sc2 + COLS * s.ge2;

  for (int i = 0; i < lq; ++i) {
    const int qc = sq[i];
    // insertion neighbour of the thread's last column: the next thread's
    // first column of the row above
    int hnL = __shfl_down_sync(FULL, H[0], 1);
    int fnL = __shfl_down_sync(FULL, F[0], 1);
    int f2nL = __shfl_down_sync(FULL, F2[0], 1);
    if (lane == 31) {
      hnL = sNH[warp + 1];
      fnL = sNF[warp + 1];
      f2nL = sNF2[warp + 1];
    }

    // pass 1: F, F2, diag, base, the F run bits and the thread's E tails
    int base[COLS], diag[COLS];
    unsigned words[COLS / 4];
    int z1, z2, y1, y2;
    if (nrem > COLS)
      pass1<COLS, false>(H, F, F2, R, base, diag, words, hnL, fnL, f2nL, qc,
                         nrem, s, negmm, z1, z2, y1, y2);
    else
      pass1<COLS, true>(H, F, F2, R, base, diag, words, hnL, fnL, f2nL, qc,
                        nrem, s, negmm, z1, z2, y1, y2);
    // (in row 0 no F run continues, and none is marked: the row above is
    // H = 0, F = NEG, so h - open always beats f - ext)

    // max-scan of the scaled tails over the block's threads
    const int i1 = warp_scan_max(y1 + sc1n, lane);
    const int i2 = warp_scan_max(y2 + sc2n, lane);
    int x1 = __shfl_up_sync(FULL, i1, 1);  // exclusive, within the warp
    int x2 = __shfl_up_sync(FULL, i2, 1);
    if (lane == 0) x1 = x2 = LNEG;
    // (e at this thread's last column) - ext, warp-local and scaled
    const int tl1 = max(x1, z1 + sc1n), tl2 = max(x2, z2 + sc2n);
    int tp1 = __shfl_up_sync(FULL, tl1, 1);  // the left thread's
    int tp2 = __shfl_up_sync(FULL, tl2, 1);
    if (lane == 31) {
      sTot1[warp] = i1;
      sTot2[warp] = i2;
      sTp1[warp] = tl1;
      sTp2[warp] = tl2;
    }
    row_barrier(nact);
    int p1 = LNEG, p2 = LNEG;  // prefix over the warps to the left
    if (warp > 0) {            // (warp-uniform)
      const int v1 = lane < warp ? sTot1[lane] : LNEG;
      const int v2 = lane < warp ? sTot2[lane] : LNEG;
      p1 = __reduce_max_sync(FULL, v1);
      p2 = __reduce_max_sync(FULL, v2);
      // the same without the nearest warp: what its last lane saw
      const int pp1 = __reduce_max_sync(FULL, lane < warp - 1 ? v1 : LNEG);
      const int pp2 = __reduce_max_sync(FULL, lane < warp - 1 ? v2 : LNEG);
      if (lane == 0) {
        tp1 = max(pp1, sTp1[warp - 1]);
        tp2 = max(pp2, sTp2[warp - 1]);
      } else {
        tp1 = max(p1, tp1);
        tp2 = max(p2, tp2);
      }
    }
    // e at the thread's first column, and (e at the column before) - ext
    const int e1 = max(p1, x1) - sc1, e2 = max(p2, x2) - sc2;
    const int t1 = tp1 - sc1, t2 = tp2 - sc2;

    // pass 2: E, E2, H, the direction bytes, the thread's row max
    const int lb = nrem >= COLS
        ? pass2<COLS, false>(H, F, F2, base, diag, words, e1, e2, t1, t2,
                             nrem, s)
        : pass2<COLS, true>(H, F, F2, base, diag, words, e1, e2, t1, t2,
                            nrem, s);
    // the E run bits need a column before the one before: not columns 0, 1
    if (tid == 0) words[0] &= ~0x00001818u;
    // H >= 0: (0, column 0) is the floor of the packed row max
    const unsigned ub = (unsigned)lb;
    unsigned best = max(ARG_MASK, ((ub / COLS) << 14)
                                      | (ARG_MASK - (c0 + COLS - 1
                                                     - ub % COLS)));
    int8_t* out = drow + (size_t)i * W + c0;
    if (ALIGNED) {
#pragma unroll
      for (int g = 0; g < COLS / 8; ++g)
        if (c0 + 8 * g < W)
          *reinterpret_cast<uint2*>(out + 8 * g) =
              make_uint2(words[2 * g], words[2 * g + 1]);
    } else {
#pragma unroll
      for (int k = 0; k < COLS; ++k)
        if (c0 + k < W)
          out[k] = (int8_t)((words[k / 4] >> (8 * (k % 4))) & 0xff);
    }

    // the reference slides one position for the next row
#pragma unroll
    for (int k = 0; k + 1 < COLS; ++k) R[k] = R[k + 1];
    R[COLS - 1] = sref[c0 + COLS + i];

    best = __reduce_max_sync(FULL, best);
    if (lane == 0) {
      sMax[warp] = best;
      sNH[warp] = H[0];
      sNF[warp] = F[0];
      sNF2[warp] = F2[0];
    }
    row_barrier(nact);
    if (warp == 0) {
      unsigned m = lane < wact ? sMax[lane] : 0u;
      m = __reduce_max_sync(FULL, m);
      if (lane == 0) {
        srow[2 * i] = (int)(m >> 14);
        srow[2 * i + 1] = (int)(ARG_MASK - (m & ARG_MASK));
      }
    }
  }

  // rows past the query: zero, by the same threads with the same stores
  for (int i = lq; i < LQ; ++i)
    store_zeros<COLS, ALIGNED>(drow + (size_t)i * W + c0, c0, W);
}

template <int COLS, int MAXT, int MINB>
cudaError_t launch(const int8_t* q, const int8_t* ref, const int32_t* meta,
                   int8_t* dirs, int32_t* stats, int B, int LQ, int W, int lr,
                   Scoring s, int threads, cudaStream_t stream) {
  const size_t smem = (size_t)2 * LQ + (size_t)threads * COLS;
  const bool aligned = W % 8 == 0
                       && reinterpret_cast<uintptr_t>(dirs) % 8 == 0;
  auto kernel = aligned ? banded_long_kernel<COLS, MAXT, MINB, true>
                        : banded_long_kernel<COLS, MAXT, MINB, false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<B, threads, smem, stream>>>(q, ref, meta, dirs, stats, LQ, W, lr,
                                       s);
  return cudaGetLastError();
}

constexpr int SMALL_THREADS = 256;

}  // namespace

// q int8 [B, LQ] codes 0-3 (4 = N/pad), ref int8 [lr], meta int32 [B, 3] =
// (lq, dlo, worig) per item, dirs int8 [B, LQ, W], stats int32 [B, LQ, 2];
// all device pointers, row-major and contiguous.  A thread takes 8 band
// columns up to 8,192 columns, else 16.  Launches on `stream` and returns
// cudaGetLastError() (0 = launched).
extern "C" int panmap_banded_long(const void* q, const void* ref,
                                  const void* meta, void* dirs, void* stats,
                                  int B, int LQ, int W, int lr, int match,
                                  int mismatch, int gap_open, int gap_ext,
                                  int gap_open2, int gap_ext2, void* stream) {
  if (B <= 0) return 0;
  if (LQ <= 0 || W <= 0 || W > MAX_W || lr < 0 || match <= 0
      || (long long)match * LQ >= (1 << 17))
    return (int)cudaErrorInvalidValue;
  const Scoring s{match, mismatch, gap_open, gap_ext, gap_open2, gap_ext2};
  const int8_t* qp = (const int8_t*)q;
  const int8_t* rp = (const int8_t*)ref;
  const int32_t* mp = (const int32_t*)meta;
  int8_t* dp = (int8_t*)dirs;
  int32_t* sp = (int32_t*)stats;
  cudaStream_t st = (cudaStream_t)stream;
  const int cols = W <= 8 * MAX_THREADS ? 8 : 16;
  const int threads = ((W + cols - 1) / cols + 31) / 32 * 32;
#define PANMAP_LONG_LAUNCH(C, T, M) \
  (int)launch<C, T, M>(qp, rp, mp, dp, sp, B, LQ, W, lr, s, threads, st)
  if (cols == 16) return PANMAP_LONG_LAUNCH(16, MAX_THREADS, 1);
  return threads <= SMALL_THREADS ? PANMAP_LONG_LAUNCH(8, SMALL_THREADS, 2)
                                  : PANMAP_LONG_LAUNCH(8, MAX_THREADS, 1);
#undef PANMAP_LONG_LAUNCH
}
