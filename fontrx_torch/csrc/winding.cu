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
//      winding_pallas_v2.py::phase_a_roots (lines 89-124), op for op.
//   3. A live crossing at em-x xx covers the columns with !(xx < cx[c]). cx is
//      non-decreasing in c (int -> float, + ox and / scale > 0 are monotone),
//      so those columns are a prefix [0, k). k is found by binary search with
//      the same predicate, and the sign is added to bucket[row][k] with a
//      shared-memory atomic.
//   4. out[row][c] = sum of bucket[row][j] for j > c: one warp per row runs a
//      suffix scan and writes the row with coalesced stores.
// Winding is an integer sum, so any order of the atomics gives the same map.
//
// What bounds it on an H100: arithmetic per (segment, row) pair (two f32
// divides and a square root, then a binary search over the row's columns) and
// shared-memory atomics, not bytes: a segment is 24 B of input and a pixel
// 4 B of output. The design therefore solves each (segment, row) once, never
// per pixel, and turns the per-pixel work into one scan per row. Row culling
// by the segments' y-hull, cp.async/TMA staging and persistent blocks are
// left for later.
//
// Float rules: the library is built with -fmad=false, so no multiply-add is
// contracted (the oracle's contract=False mode), and without fast math, so
// '/' and sqrtf round correctly and denormals are kept.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxRows = 16;        // rows per block, fewer when W is wide
constexpr int kSegChunk = 64;       // segments staged per shared-memory chunk
constexpr size_t kSmemLimit = 227 * 1024;

struct SegmentChunk {
  float v[kSegChunk * 6];           // p0x p0y p1x p1y p2x p2y per segment
};

// Number of columns c in [0, W) with !(xx < cx[c]): a prefix, by monotone cx.
__device__ __forceinline__ int covered_columns(const float* cx, int W, float xx) {
  int lo = 0, hi = W;
  while (lo < hi) {
    int mid = (lo + hi) >> 1;
    if (!(xx < cx[mid])) lo = mid + 1; else hi = mid;
  }
  return lo;
}

__device__ __forceinline__ void deposit(int* bucket_row, const float* cx, int W,
                                        float xx, int sign) {
  int k = covered_columns(cx, W, xx);
  if (k > 0) atomicAdd(&bucket_row[k], sign);
}

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
      const float* q = chunk->v + (p / rows) * 6;
      const float p0x = q[0], p0y = q[1], p1x = q[2], p1y = q[3], p2x = q[4], p2y = q[5];
      const float y_em = cy[r];
      int* brow = bucket + r * (W + 1);

      // phase_a_roots, op for op (left-to-right association as written)
      const float a = p0y - 2.0f * p1y + p2y;
      const float ax = p0x - 2.0f * p1x + p2x;
      const float bx = 2.0f * (p1x - p0x);
      if (a == 0.0f) {
        // linear in y; a zero-padded segment has denom == 0 and adds nothing
        const float denom = p2y - p0y;
        if (denom != 0.0f) {
          const float t = (y_em - p0y) / denom;
          if (t >= 0.0f && t < 1.0f) {
            const float xx = (ax * t + bx) * t + p0x;
            deposit(brow, cx, W, xx, p0y < p2y ? -1 : 1);
          }
        }
        continue;
      }
      const float delta = y_em * a + p1y * p1y - p0y * p2y;
      if (!(delta >= 0.0f)) continue;
      const float sq = sqrtf(delta);
      const float py01 = p0y - p1y;
      const float t0 = (py01 + sq) / a;
      if (t0 >= 0.0f && t0 < 1.0f) {
        const float xx = (ax * t0 + bx) * t0 + p0x;
        const float dy = a * t0 + (p1y - p0y);
        deposit(brow, cx, W, xx, dy > 0.0f ? -1 : 1);
      }
      const float t1 = (py01 - sq) / a;
      if (t1 >= 0.0f && t1 < 1.0f) {
        const float xx = (ax * t1 + bx) * t1 + p0x;
        const float dy = a * t1 + (p1y - p0y);
        deposit(brow, cx, W, xx, dy > 0.0f ? -1 : 1);
      }
    }
  }
  __syncthreads();

  // out[y][c] = sum_{j > c} bucket[r][j]: one warp per row, right to left in
  // 32-column pieces, each an inclusive suffix scan across the lanes
  const int lane = tid & 31;
  for (int r = tid >> 5; r < rows; r += kThreads >> 5) {
    const int y = row0 + r;
    if (y >= H) break;
    const int* brow = bucket + r * (W + 1);
    int* orow = out + ((size_t)b * H + y) * W;
    int carry = 0;
    for (int base = ((W - 1) >> 5) << 5; base >= 0; base -= 32) {
      const int c = base + lane;
      int s = c < W ? brow[c + 1] : 0;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int t = __shfl_down_sync(0xffffffffu, s, off);
        if (lane + off < 32) s += t;
      }
      if (c < W) orow[c] = s + carry;
      carry += __shfl_sync(0xffffffffu, s, 0);
    }
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
