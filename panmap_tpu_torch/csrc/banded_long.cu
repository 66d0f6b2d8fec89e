// Batched shifted-band dual-affine local DP for long reads (map-ont /
// map-hifi), for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel panmap_tpu/align/pallas_long.py::_long_call
// (body _make_kernel, batch entry long_dp_device_batch).  For each item (query,
// band) it computes every DP row of align/longread.py::banded_dp_shifted:
// row i covers the 0-based reference positions [dlo + i, dlo + i + worig),
// with minimap2's two gap tiers (-O q,q2 -E e,e2) as the insertion lanes F
// and F2 carried across rows and the deletion lanes E and E2 as two in-row
// prefix-max scans.  Per cell it writes a direction byte: bits 0-2 the H
// source in the host traceback's priority order (0 zero, 1 diag, 2 E, 3 E2,
// 4 F, 5 F2, 1 as the last resort), bits 3/4/5/6 the E/E2/F/F2 "run
// continues" flags.  Per row it writes (max H, first column of the max).
// The host replays the z-drop rule over the row stats and walks the bytes
// for the CIGAR (align/long_dp.py::_finish_one).
//
// Unlike the Pallas kernel it reads the reference directly at 0-based index
// c + dlo + i (code 4 outside [0, lr)), so there is no host-built band
// matrix, and it reads the query code by index, so there is no one-hot
// matrix product.  Nothing is padded to 512 rows or 128 columns: each item
// keeps its own (lq, dlo, worig) and the batch is laid out at its largest
// LQ and W.  Padded cells (rows >= lq, columns >= worig) are written as 0,
// stats rows >= lq as (0, 0).  The scoring constants are arguments, so one
// build serves both presets.
//
// Design: one thread block per item, looping over the rows.  The previous
// row's H, F and F2 live in dynamic shared memory (12 * W bytes).  The
// threads cover the band in chunks of blockDim.x consecutive columns, one
// column each, so the direction bytes of a warp go out as one coalesced
// store.  E and E2 use the Pallas kernel's prefix-max identity
// E[c] = max_{m<c}(base[m] + m*ext) - open - (c-1)*ext: a warp-shuffle
// inclusive scan of both tiers in one pass, one shared word per warp whose
// values every warp then scans again by shuffles, and a carry across
// chunks.  The E "continues" flag E[c] == E[c-1] - ext is the
// same identity read as "the exclusive prefix max did not rise at c - 1".
// A row ends with a block (max, first argmax) reduction.  One
// __syncthreads per chunk and one per row.
//
// Envelope: W <= 16384 columns (192 KB of shared memory, under the 227 KB
// opt-in limit; wider items stay on the host DP).  int32 state: every H lies
// in [0, match * lq]; F and F2 stay >= -open whenever they are read; the
// lowest value formed is NEG - open2 - (W - 1) * ext, about -2^28 - 33,000,
// far from int32's -2^31.
//
// What bounds it: the serial row loop with its barriers (a block does one
// row at a time), and one byte per cell written to device memory.  Hopper
// DPX intrinsics (__viaddmax_s32, packed s16x2 cells) and a traceback on the
// card (which would remove the direction bytes' write and their copy to the
// host) are later performance work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NEG = -(1 << 28);
constexpr int MAX_THREADS = 1024;
constexpr int MAX_WARPS = MAX_THREADS / 32;
constexpr int MAX_W = 16384;
constexpr unsigned FULL = 0xffffffffu;

struct Scoring {
  int match, mismatch, go, ge, go2, ge2;
};

__global__ void __launch_bounds__(MAX_THREADS)
banded_long_kernel(const int8_t* __restrict__ q,
                   const int8_t* __restrict__ ref,
                   const int32_t* __restrict__ meta,
                   int8_t* __restrict__ dirs, int32_t* __restrict__ stats,
                   int LQ, int W, int lr, Scoring s) {
  extern __shared__ int smem[];
  int* sH = smem;           // previous row's H, F and F2 by band column
  int* sF = smem + W;
  int* sF2 = smem + 2 * W;
  // per warp of a chunk, double-buffered by chunk parity so one barrier per
  // chunk suffices: inclusive totals and the last lane's exclusive prefix
  __shared__ int sTot1[2][MAX_WARPS], sTot2[2][MAX_WARPS];
  __shared__ int sEx1[2][MAX_WARPS], sEx2[2][MAX_WARPS];
  __shared__ int sMax[MAX_WARPS], sArg[MAX_WARPS];

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

  for (int c = tid; c < W; c += T) {
    sH[c] = 0;
    sF[c] = NEG;
    sF2[c] = NEG;
  }
  __syncthreads();

  int phase = 0;
  for (int i = 0; i < lq; ++i) {
    const int qc = qrow[i];
    int carry1 = NEG, carry2 = NEG;  // inclusive prefix max before the chunk
    int last1 = NEG, last2 = NEG;    // exclusive prefix of the column before
    int rmax = 0, rarg = 0;          // H >= 0: (0, column 0) is the floor
    for (int c0 = 0; c0 < W; c0 += T) {
      const int c = c0 + tid;
      const bool act = c < wo;
      const bool nxt = c + 1 < wo;
      int hp = 0, fn = NEG, f2n = NEG, f = NEG, f2 = NEG;
      if (act) hp = sH[c];
      if (nxt) {  // insertion: (i-1, j) is band column c + 1 of the row above
        const int hn = sH[c + 1];
        fn = sF[c + 1];
        f2n = sF2[c + 1];
        f = max(hn - s.go, fn - s.ge);
        f2 = max(hn - s.go2, f2n - s.ge2);
      }
      const int pos = c + dlo + i;  // 0-based reference index of the cell
      const bool inb = act && pos >= 0 && pos < lr;
      const int rj = inb ? (int)ref[pos] : 4;
      const int diag = hp + ((rj == qc && qc < 4) ? s.match : -s.mismatch);
      const int base = inb ? max(max(diag, max(f, f2)), 0) : NEG;

      // inclusive max-scan of base + c*ext, both tiers in one pass
      int w1 = base + c * s.ge, w2 = base + c * s.ge2;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int t1 = __shfl_up_sync(FULL, w1, off);
        const int t2 = __shfl_up_sync(FULL, w2, off);
        if (lane >= off) {
          w1 = max(w1, t1);
          w2 = max(w2, t2);
        }
      }
      int x1 = __shfl_up_sync(FULL, w1, 1);  // exclusive, within the warp
      int x2 = __shfl_up_sync(FULL, w2, 1);
      if (lane == 0) x1 = x2 = NEG;
      if (lane == 31) {
        sTot1[phase][warp] = w1;
        sTot2[phase][warp] = w2;
        sEx1[phase][warp] = x1;
        sEx2[phase][warp] = x2;
      }
      __syncthreads();
      // the warp totals, max-scanned across one warp: lane k holds the
      // prefix through warp k of this chunk
      int s1 = lane < nwarps ? sTot1[phase][lane] : NEG;
      int s2 = lane < nwarps ? sTot2[phase][lane] : NEG;
      const int xw1 = lane < nwarps ? sEx1[phase][lane] : NEG;
      const int xw2 = lane < nwarps ? sEx2[phase][lane] : NEG;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int t1 = __shfl_up_sync(FULL, s1, off);
        const int t2 = __shfl_up_sync(FULL, s2, off);
        if (lane >= off) {
          s1 = max(s1, t1);
          s2 = max(s2, t2);
        }
      }
      // prefix before this warp (p) and before the warp to its left (pl)
      const int wl = max(warp - 1, 0), wll = max(warp - 2, 0);
      const int u1 = __shfl_sync(FULL, s1, wl), u2 = __shfl_sync(FULL, s2, wl);
      const int v1 = __shfl_sync(FULL, s1, wll), v2 = __shfl_sync(FULL, s2, wll);
      const int y1 = __shfl_sync(FULL, xw1, wl), y2 = __shfl_sync(FULL, xw2, wl);
      const int p1 = warp > 0 ? max(carry1, u1) : carry1;
      const int p2 = warp > 0 ? max(carry2, u2) : carry2;
      const int pl1 = warp > 1 ? max(carry1, v1) : carry1;
      const int pl2 = warp > 1 ? max(carry2, v2) : carry2;
      const int ex1 = max(p1, x1), ex2 = max(p2, x2);
      // the exclusive prefix of column c - 1
      int l1 = __shfl_up_sync(FULL, ex1, 1);
      int l2 = __shfl_up_sync(FULL, ex2, 1);
      if (lane == 0) {
        if (warp > 0) {
          l1 = max(pl1, y1);
          l2 = max(pl2, y2);
        } else {
          l1 = last1;
          l2 = last2;
        }
      }
      const int e = c >= 1 ? ex1 - s.go - (c - 1) * s.ge : NEG;
      const int e2 = c >= 1 ? ex2 - s.go2 - (c - 1) * s.ge2 : NEG;
      const int h = inb ? max(base, max(e, e2)) : 0;
      if (act) {
        const int src = h == 0 ? 0
                        : h == diag ? 1
                        : h == e ? 2
                        : h == e2 ? 3
                        : h == f ? 4
                        : h == f2 ? 5
                        : 1;
        const int byte = src | ((c > 1 && ex1 == l1) << 3)
                         | ((c > 1 && ex2 == l2) << 4)
                         | ((nxt && i >= 1 && f == fn - s.ge) << 5)
                         | ((nxt && i >= 1 && f2 == f2n - s.ge2) << 6);
        drow[(size_t)i * W + c] = (int8_t)byte;
        sH[c] = h;
        sF[c] = f;
        sF2[c] = f2;
        if (h > rmax) {  // columns ascend: strict > keeps the first
          rmax = h;
          rarg = c;
        }
      } else if (c < W) {
        drow[(size_t)i * W + c] = 0;
      }
      // carries into the next chunk (the same in every thread)
      const int n1 = nwarps - 1, n2 = max(nwarps - 2, 0);
      const int a1 = __shfl_sync(FULL, s1, n1), a2 = __shfl_sync(FULL, s2, n1);
      const int b1 = __shfl_sync(FULL, s1, n2), b2 = __shfl_sync(FULL, s2, n2);
      const int z1 = __shfl_sync(FULL, xw1, n1), z2 = __shfl_sync(FULL, xw2, n1);
      last1 = max(nwarps > 1 ? max(carry1, b1) : carry1, z1);
      last2 = max(nwarps > 1 ? max(carry2, b2) : carry2, z2);
      carry1 = max(carry1, a1);
      carry2 = max(carry2, a2);
      phase ^= 1;
    }
    // row (max, first argmax) over the block
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const int om = __shfl_down_sync(FULL, rmax, off);
      const int oa = __shfl_down_sync(FULL, rarg, off);
      if (om > rmax || (om == rmax && oa < rarg)) {
        rmax = om;
        rarg = oa;
      }
    }
    if (lane == 0) {
      sMax[warp] = rmax;
      sArg[warp] = rarg;
    }
    __syncthreads();
    if (tid == 0) {
      int m = sMax[0], a = sArg[0];
      for (int w = 1; w < nwarps; ++w) {
        if (sMax[w] > m || (sMax[w] == m && sArg[w] < a)) {
          m = sMax[w];
          a = sArg[w];
        }
      }
      srow[2 * i] = m;
      srow[2 * i + 1] = a;
    }
  }
  // rows past the query: zero
  const size_t cells = (size_t)LQ * W;
  for (size_t k = (size_t)lq * W + tid; k < cells; k += T) drow[k] = 0;
  for (int k = 2 * lq + tid; k < 2 * LQ; k += T) srow[k] = 0;
}

}  // namespace

// q int8 [B, LQ] codes 0-3 (4 = N/pad), ref int8 [lr], meta int32 [B, 3] =
// (lq, dlo, worig) per item, dirs int8 [B, LQ, W], stats int32 [B, LQ, 2];
// all device pointers, row-major and contiguous.  Launches on `stream` and
// returns cudaGetLastError() (0 = launched).
extern "C" int panmap_banded_long(const void* q, const void* ref,
                                  const void* meta, void* dirs, void* stats,
                                  int B, int LQ, int W, int lr, int match,
                                  int mismatch, int gap_open, int gap_ext,
                                  int gap_open2, int gap_ext2, void* stream) {
  if (B <= 0) return 0;
  if (LQ <= 0 || W <= 0 || W > MAX_W || lr < 0)
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)12 * W;
  cudaError_t err = cudaFuncSetAttribute(
      banded_long_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  // as few chunks as 1024-thread blocks allow, spread evenly over the warps
  const int chunks = (W + MAX_THREADS - 1) / MAX_THREADS;
  const int threads = ((W + chunks - 1) / chunks + 31) / 32 * 32;
  const Scoring s{match, mismatch, gap_open, gap_ext, gap_open2, gap_ext2};
  banded_long_kernel<<<B, threads, smem, (cudaStream_t)stream>>>(
      (const int8_t*)q, (const int8_t*)ref, (const int32_t*)meta,
      (int8_t*)dirs, (int32_t*)stats, LQ, W, lr, s);
  return (int)cudaGetLastError();
}
