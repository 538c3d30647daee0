// Nonzero winding maps of quadratic glyph outlines, for Hopper (sm_90a).
//
// Replaces the two TPU Pallas kernels of the glyph fill path and the one of
// the sharded path (fontrx_torch/engine/sharding.py):
//   K1  fontrx/kernels/winding_pallas_v2.py::_make_v2_kernel (tiles > 128 px)
//   K2  fontrx/kernels/winding_dense.py::_make_dense_kernel  (tiles <= 128 px)
//   K4  fontrx/kernels/winding_pallas.py::_winding_kernel (launcher
//       winding_pallas_batch; 8 x 128 tiles, one row at a time, with a sample
//       offset: winding_sharded, and winding_sharded_2d's bands of 8k rows)
// All three compute one function: for every pixel, the sum of the signs of
// the crossings of the horizontal line through its sample point with the
// glyph's quadratic segments that do not lie left of the sample, with the
// same root solve and IEEE '/' and sqrt. Their TPU-specific partitions
// (128-row strips, 8 x 128 tiles, column tiles, carry sweeps, lane packing)
// are not carried over; one kernel serves every tile size and band.
//
// Design: one block per (glyph, band of rows).
//   1. cx[c] = ((float)(min_x + c) + ox) / scale goes to shared memory.
//   2. Segments stream through shared memory in chunks. Each thread solves one
//      (segment, row) pair with the float program of
//      winding_pallas_v2.py::phase_a_roots (lines 89-124), op for op
//      (segment_crossings, crossings.cuh).
//   3. A live crossing at em-x xx covers the columns with !(xx < cx[c]), a
//      prefix [0, k) since cx is non-decreasing. k is found by binary search
//      with the same predicate, and the sign is added to bucket[row][k] with
//      a shared-memory atomic (deposit, crossings.cuh).
//   4. out[row][c] = sum of bucket[row][j] for j > c: one warp per row runs a
//      suffix scan (suffix_scan_row, crossings.cuh) and writes the row with
//      coalesced stores.
// Winding is an integer sum, so any order of the atomics gives the same map.
//
// Where its time goes on an H100: arithmetic per (segment, row) pair (two
// f32 divides and a square root, then a binary search over the row's columns)
// and shared-memory atomics. Bytes (24 B a segment in, 4 B a pixel out) set
// a floor far below that (fontrx_torch/bound.py). The design therefore
// solves each (segment, row) once, never per pixel, and turns the per-pixel
// work into one scan per row. Row culling by the segments' y-hull,
// cp.async/TMA staging and persistent blocks are left for later.
//
// A second entry, winding_windows(), replaces K3,
//   fontrx/kernels/winding_dense.py::winding_dense_win_batch (body
//   _make_dense_win_kernel), the window-packed route of the small-tile atlas
//   (RasterEngine.winding_batch(windows=...)). Its input is a window-major
//   stream (fontrx_torch/pack/windows.py): window w of glyph b holds
//   counts[b][w] copies of the segments whose hull can reach its rows
//   [w * win_rows, (w + 1) * win_rows). K3 solves each copy on its window's
//   rows and on no other, so a root that the float program finds outside a
//   segment's windows is dropped: the stream defines the function. One block
//   per (glyph, window) runs the same band body as winding() over the
//   window's live copies and its rows below H, and writes them straight into
//   [B, H, W]: the TPU's lane groups, its fold across them and the stitching
//   of windows are gone. The row cull is the pack's: on the CJK atlases
//   the copies' (segment, row) pairs are 0.54-0.65 of those winding() solves.
//   It cuts the root solves that find no crossing, not the crossings: each
//   is still placed by a binary search and a shared-memory atomic, and the
//   rows are still zeroed and scanned, so the time falls by less than the
//   pairs do (PERF.md).
//
// Float rules: the library is built with -fmad=false, so no multiply-add is
// contracted (the oracle's contract=False mode), and without fast math, so
// '/' and sqrtf round correctly and denormals are kept.

#include <cuda_runtime.h>
#include <stdint.h>

#include "crossings.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxRows = 16;        // rows per block, fewer when W is wide
constexpr int kSegChunk = 64;       // segments staged per shared-memory chunk
constexpr size_t kSmemLimit = 227 * 1024;

struct SegmentChunk {
  float v[kSegChunk * 6];           // p0x p0y p1x p1y p2x p2y per segment
};

// One block's work in both kernels: the winding of the rows [row0, row0 +
// rows) of one glyph from its segments gseg[0, S), written to out_rows (row
// major, W columns). smem holds the segment chunk, cy[rows], cx[W] and
// bucket[rows][W + 1].
__device__ __forceinline__ void band_winding(const float* __restrict__ gseg, int S, int mx,
                                             int my, float scale, float ox, float oy, int row0,
                                             int rows, int W, unsigned char* smem,
                                             int* __restrict__ out_rows) {
  SegmentChunk* chunk = reinterpret_cast<SegmentChunk*>(smem);
  float* cy = reinterpret_cast<float*>(smem + sizeof(SegmentChunk));  // [rows]
  float* cx = cy + rows;                            // [W]
  int* bucket = reinterpret_cast<int*>(cx + W);     // [rows][W + 1]
  const int tid = threadIdx.x;

  for (int c = tid; c < W; c += kThreads) cx[c] = ((float)(mx + c) + ox) / scale;
  for (int r = tid; r < rows; r += kThreads) cy[r] = ((float)(my - (row0 + r)) + oy) / scale;
  for (int i = tid; i < rows * (W + 1); i += kThreads) bucket[i] = 0;

  for (int s0 = 0; s0 < S; s0 += kSegChunk) {
    const int ns = min(kSegChunk, S - s0);
    __syncthreads();  // cx/bucket ready; the previous chunk fully consumed
    for (int i = tid; i < ns * 6; i += kThreads) chunk->v[i] = gseg[(size_t)s0 * 6 + i];
    __syncthreads();

    for (int p = tid; p < ns * rows; p += kThreads) {
      const int r = p % rows;
      int* brow = bucket + r * (W + 1);
      segment_crossings(chunk->v + (p / rows) * 6, cy[r], [&](float xx, int sign) {
        deposit(brow, cx, W, xx, sign);
      });
    }
  }
  __syncthreads();

  // out[row0 + r][c] = sum_{j > c} bucket[r][j]: one warp per row
  const int lane = tid & 31;
  for (int r = tid >> 5; r < rows; r += kThreads >> 5) {
    int* orow = out_rows + (size_t)r * W;
    suffix_scan_row(bucket + r * (W + 1), W, lane, [&](int c, int w) { orow[c] = w; });
  }
}

// winding(): one block per (glyph, band of `rows` rows), every segment.
__global__ void __launch_bounds__(kThreads)
winding_kernel(const float* __restrict__ seg, const int* __restrict__ min_x,
               const int* __restrict__ max_y, float scale, float ox, float oy,
               int S, int H, int W, int rows, int* __restrict__ out) {
  extern __shared__ unsigned char smem_raw[];
  const int b = blockIdx.x;
  const int row0 = blockIdx.y * rows;
  band_winding(seg + (size_t)b * S * 6, S, min_x[b], max_y[b], scale, ox, oy, row0,
               min(rows, H - row0), W, smem_raw, out + ((size_t)b * H + row0) * W);
}

// winding_windows(): one block per (glyph, window), the window's live copies
// on its rows below H.
__global__ void __launch_bounds__(kThreads)
winding_windows_kernel(const float* __restrict__ seg, const int* __restrict__ counts,
                       const int* __restrict__ min_x, const int* __restrict__ max_y,
                       float scale, float ox, float oy, int nw, int cap, int win_rows,
                       int H, int W, int* __restrict__ out) {
  extern __shared__ unsigned char smem_raw[];
  const int bw = blockIdx.x;  // b * nw + w, also the index of counts[b][w]
  const int b = bw / nw;
  const int row0 = (bw - b * nw) * win_rows;
  const int n = min(max(counts[bw], 0), cap);
  band_winding(seg + (size_t)bw * cap * 6, n, min_x[b], max_y[b], scale, ox, oy, row0,
               min(win_rows, H - row0), W, smem_raw, out + ((size_t)b * H + row0) * W);
}

}  // namespace

extern "C" cudaError_t winding(const float* seg, const int* min_x, const int* max_y,
                               float scale, float ox, float oy, int B, int S, int H,
                               int W, int* out, cudaStream_t stream) {
  if (B < 0 || S < 0 || H < 0 || W < 0 || !(scale > 0.0f)) return cudaErrorInvalidValue;
  if (B == 0 || H == 0 || W == 0) return cudaSuccess;

  const size_t fixed = sizeof(SegmentChunk) + (size_t)W * sizeof(float);
  const size_t per_row = sizeof(float) + (size_t)(W + 1) * sizeof(int);
  if (fixed + per_row > kSmemLimit) return cudaErrorInvalidValue;
  int rows = (int)((kSmemLimit - fixed) / per_row);
  if (rows > kMaxRows) rows = kMaxRows;
  if (rows > H) rows = H;
  const size_t smem = fixed + (size_t)rows * per_row;
  const int bands = (H + rows - 1) / rows;
  if (bands > 65535) return cudaErrorInvalidValue;

  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        winding_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  dim3 grid((unsigned)B, (unsigned)bands);
  winding_kernel<<<grid, kThreads, smem, stream>>>(seg, min_x, max_y, scale, ox, oy,
                                                   S, H, W, rows, out);
  return cudaGetLastError();
}

extern "C" cudaError_t winding_windows(const float* seg, const int* counts, const int* min_x,
                                       const int* max_y, float scale, float ox, float oy,
                                       int B, int nw, int cap, int win_rows, int H, int W,
                                       int* out, cudaStream_t stream) {
  if (B < 0 || nw < 1 || cap < 0 || win_rows < 1 || H < 0 || W < 0 || !(scale > 0.0f))
    return cudaErrorInvalidValue;
  if ((long long)nw * win_rows < H || (long long)B * nw > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  if (B == 0 || H == 0 || W == 0) return cudaSuccess;

  const int rows = win_rows < H ? win_rows : H;
  const size_t smem = sizeof(SegmentChunk) + (size_t)W * sizeof(float) +
                      (size_t)rows * (sizeof(float) + (size_t)(W + 1) * sizeof(int));
  if (smem > kSmemLimit) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        winding_windows_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  winding_windows_kernel<<<(unsigned)(B * nw), kThreads, smem, stream>>>(
      seg, counts, min_x, max_y, scale, ox, oy, nw, cap, win_rows, H, W, out);
  return cudaGetLastError();
}
