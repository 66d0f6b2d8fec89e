// Batched local affine-gap Smith-Waterman scoring over whole windows, for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel panmap_tpu/align/pallas_sw.py::_sw_call
// (body _make_sw_kernel).  For each (query, window) pair it returns
// (best score incl. end bonuses, query end i+1, window end j+1) with the tie
// order of panmap_tpu/align/core.py::banded_affine_dp: a row replaces the
// best only when its value is strictly greater, and a row's argmax is its
// first column.  sr scoring: match 2, mismatch 8, gap 12 + 2 * (len - 1),
// end bonus 10 on both query ends.
//
// What bounds it on this card: integer max/add throughput and the serial
// loop over query rows, not bytes (a pair's inputs are <= 2.5 KB).  The
// design keeps all DP state on chip:
//  - one thread block per pair; each thread owns COLS consecutive window
//    columns and keeps their H and F cells and reference codes in registers
//    (256 threads x 8 columns covers a 2048-column window);
//  - the left-gap state E, a serial scan in ksw2, uses the prefix-max
//    identity of the Pallas kernel: E[j] = max_{m<j}(base[m] + m*ext)
//    - open - (j-1)*ext, computed as a thread-local running max plus a
//    block-wide exclusive max-scan (warp shuffles + one shared word per
//    warp);
//  - the left neighbour's previous-row H comes by warp shuffle, or from one
//    shared word per warp at warp edges;
//  - a row ends with a block (max, first argmax) reduction, and every thread
//    updates the running best identically.
// Two __syncthreads per query row; rows past the query length are skipped
// (they can never update the best).
//
// Score envelope: every H lies in [0, 2*LQ + 2*END_BONUS]; with LQ <= 512
// and LW <= 2048, base + j*ext stays below 2^13 and the NEG floor
// -(1 << 28) leaves room for 512 rows of gap extension, so int32 state
// never overflows.  (The Pallas kernel's i16/i32 retry is not needed.)
// Hopper DPX intrinsics (__viaddmax_s32, packed s16x2) are left for a later
// performance change.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MATCH = 2;
constexpr int MISMATCH = 8;
constexpr int GAP_OPEN = 12;
constexpr int GAP_EXT = 2;
constexpr int END_BONUS = 10;
constexpr int NEG = -(1 << 28);
constexpr int COLS = 8;            // window columns per thread
constexpr int MAX_THREADS = 256;   // => windows of at most 2048 columns
constexpr int MAX_WARPS = MAX_THREADS / 32;
constexpr unsigned FULL = 0xffffffffu;

__global__ void __launch_bounds__(MAX_THREADS)
banded_sw_kernel(const int8_t* __restrict__ q, const int8_t* __restrict__ r,
                 const int32_t* __restrict__ qlens, int32_t* __restrict__ out,
                 int LQ, int LW) {
  __shared__ int s_scan[MAX_WARPS];  // warp totals of the E max-scan
  __shared__ int s_max[MAX_WARPS];   // warp row maxima
  __shared__ int s_arg[MAX_WARPS];   // their first columns
  __shared__ int s_edge[MAX_WARPS];  // H of each warp's last column

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  const int j0 = tid * COLS;

  const int8_t* qrow = q + (size_t)b * LQ;
  const int8_t* rrow = r + (size_t)b * LW;
  int rc[COLS], H[COLS], F[COLS];
#pragma unroll
  for (int c = 0; c < COLS; ++c) {
    const int j = j0 + c;
    rc[c] = j < LW ? (int)rrow[j] : 4;
    H[c] = END_BONUS;  // row 0: query-start bonus on every column
    F[c] = NEG;
  }
  if (lane == 31) s_edge[warp] = END_BONUS;
  __syncthreads();

  const int qlen = min(max(qlens[b], 0), LQ);
  int best = 0, best_i = 0, best_j = 0;
  for (int i = 0; i < qlen; ++i) {
    const int qc = qrow[i];
    // previous-row H of column j0 - 1 (boundary column: END_BONUS on the
    // first row, the local floor 0 after it)
    int hd = __shfl_up_sync(FULL, H[COLS - 1], 1);
    if (lane == 0) hd = warp ? s_edge[warp - 1] : (i == 0 ? END_BONUS : 0);

    int base[COLS], pre[COLS];
    int run = NEG;  // running max of base[m] + m*ext over this thread's m
#pragma unroll
    for (int c = 0; c < COLS; ++c) {
      const int sub = (rc[c] == qc && qc < 4) ? MATCH : -MISMATCH;
      const int f = max(H[c] - GAP_OPEN, F[c] - GAP_EXT);
      const int d = hd + sub;
      hd = H[c];
      F[c] = f;
      const int bs = max(max(d, f), 0);
      base[c] = bs;
      pre[c] = run;  // exclusive: columns before c in this thread
      run = max(run, bs + (j0 + c) * GAP_EXT);
    }

    // block-wide exclusive max-scan of the thread totals
    int incl = run;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int t = __shfl_up_sync(FULL, incl, off);
      if (lane >= off) incl = max(incl, t);
    }
    int excl = __shfl_up_sync(FULL, incl, 1);
    if (lane == 0) excl = NEG;
    if (lane == 31) s_scan[warp] = incl;
    __syncthreads();
    for (int w = 0; w < warp; ++w) excl = max(excl, s_scan[w]);

    int rmax = -1, rarg = 0;  // every H >= 0, so -1 loses to any column
#pragma unroll
    for (int c = 0; c < COLS; ++c) {
      const int j = j0 + c;
      const int e = max(excl, pre[c]) - GAP_OPEN - (j - 1) * GAP_EXT;
      const int h = max(base[c], e);
      H[c] = h;
      if (j < LW && h > rmax) {
        rmax = h;
        rarg = j;
      }
    }
    // (max, first argmax) over the block
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
      s_max[warp] = rmax;
      s_arg[warp] = rarg;
    }
    if (lane == 31) s_edge[warp] = H[COLS - 1];
    __syncthreads();
    int m = s_max[0], a = s_arg[0];
    for (int w = 1; w < nwarps; ++w) {
      if (s_max[w] > m) {  // warps in column order: strict > keeps the first
        m = s_max[w];
        a = s_arg[w];
      }
    }
    const int row_best = m + (i == qlen - 1 ? END_BONUS : 0);
    if (row_best > best) {
      best = row_best;
      best_i = i + 1;
      best_j = a + 1;
    }
  }
  if (tid == 0) {
    out[(size_t)b * 3 + 0] = best;
    out[(size_t)b * 3 + 1] = best_i;
    out[(size_t)b * 3 + 2] = best_j;
  }
}

}  // namespace

// q int8 [B, LQ] codes 0-3 (4 = N/pad), r int8 [B, LW], qlens int32 [B],
// out int32 [B, 3]; all device pointers, row-major and contiguous.  Launches
// on `stream` and returns cudaGetLastError() (0 = launched).
extern "C" int panmap_banded_sw(const void* q, const void* r,
                                const void* qlens, void* out, int B, int LQ,
                                int LW, void* stream) {
  if (B <= 0) return 0;
  if (LQ <= 0 || LW <= 0 || LW > MAX_THREADS * COLS)
    return (int)cudaErrorInvalidValue;
  int threads = ((LW + COLS - 1) / COLS + 31) / 32 * 32;
  banded_sw_kernel<<<B, threads, 0, (cudaStream_t)stream>>>(
      (const int8_t*)q, (const int8_t*)r, (const int32_t*)qlens,
      (int32_t*)out, LQ, LW);
  return (int)cudaGetLastError();
}
