// Nonzero winding maps of quadratic glyph outlines, for Hopper (sm_90a).
//
// Replaces the two TPU Pallas kernels of the glyph fill path:
//   K1  fontrx/kernels/winding_pallas_v2.py::_make_v2_kernel (tiles > 128 px)
//   K2  fontrx/kernels/winding_dense.py::_make_dense_kernel  (tiles <= 128 px)
// Both compute one function: for every pixel, the sum of the signs of the
// crossings of the horizontal line through its sample point with the glyph's
// quadratic segments that do not lie left of the sample. Their TPU-specific
// partitions (128-row strips, column tiles, carry sweeps, lane packing) are
// not carried over; one kernel serves both tile sizes.
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

__global__ void __launch_bounds__(kThreads)
winding_kernel(const float* __restrict__ seg, const int* __restrict__ min_x,
               const int* __restrict__ max_y, float scale, float ox, float oy,
               int S, int H, int W, int rows, int* __restrict__ out) {
  extern __shared__ unsigned char smem_raw[];
  SegmentChunk* chunk = reinterpret_cast<SegmentChunk*>(smem_raw);
  float* cy = reinterpret_cast<float*>(smem_raw + sizeof(SegmentChunk));  // [rows]
  float* cx = cy + rows;                            // [W]
  int* bucket = reinterpret_cast<int*>(cx + W);     // [rows][W + 1]

  const int b = blockIdx.x;
  const int row0 = blockIdx.y * rows;
  const int tid = threadIdx.x;
  const int mx = min_x[b];
  const int my = max_y[b];

  for (int c = tid; c < W; c += kThreads) cx[c] = ((float)(mx + c) + ox) / scale;
  for (int r = tid; r < rows; r += kThreads) cy[r] = ((float)(my - (row0 + r)) + oy) / scale;
  for (int i = tid; i < rows * (W + 1); i += kThreads) bucket[i] = 0;

  const float* gseg = seg + (size_t)b * S * 6;
  for (int s0 = 0; s0 < S; s0 += kSegChunk) {
    const int ns = min(kSegChunk, S - s0);
    __syncthreads();  // cx/bucket ready; the previous chunk fully consumed
    for (int i = tid; i < ns * 6; i += kThreads) chunk->v[i] = gseg[(size_t)s0 * 6 + i];
    __syncthreads();

    for (int p = tid; p < ns * rows; p += kThreads) {
      const int r = p % rows;
      const int y = row0 + r;
      if (y >= H) continue;
      int* brow = bucket + r * (W + 1);
      segment_crossings(chunk->v + (p / rows) * 6, cy[r], [&](float xx, int sign) {
        deposit(brow, cx, W, xx, sign);
      });
    }
  }
  __syncthreads();

  // out[y][c] = sum_{j > c} bucket[r][j]: one warp per row
  const int lane = tid & 31;
  for (int r = tid >> 5; r < rows; r += kThreads >> 5) {
    const int y = row0 + r;
    if (y >= H) break;
    int* orow = out + ((size_t)b * H + y) * W;
    suffix_scan_row(bucket + r * (W + 1), W, lane, [&](int c, int w) { orow[c] = w; });
  }
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
