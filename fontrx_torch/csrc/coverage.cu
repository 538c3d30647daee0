// k x k supersampled nonzero coverage of quadratic glyph outlines, for
// Hopper (sm_90a).
//
// Replaces the TPU Pallas kernel K9,
// fontrx/kernels/coverage_pallas.py::_make_coverage_kernel (launcher
// coverage_pallas_batch). It computes, for every pixel, the fraction of its
// k x k sample points whose nonzero winding is not 0: float32 [B, H, W] in
// [0, 1]. Sample (kx, ky) of pixel (x, y) lies at em-space
//   cx = ((float)(min_x + x) + o[kx]) / scale,
//   cy = ((float)(max_y - y) + o[ky]) / scale,
//   o[i] = ((float)i + 0.5f) / (float)k - 0.5f,
// the float32 lattice of fontrx/kernels/coverage.py::sample_offsets.
// The result is (float)count * inv_k2, with inv_k2 the host's
// np.float32(1 / (k*k)): the rounding of the plain version and of both JAX
// routes (the Pallas kernel multiplies by f32(1/k^2); jnp's mean of k^2
// {0, 1} rows rounds the same way). A correctly rounded count / k^2 differs
// at some counts for k = 5, 6 and 7.
//
// Design: one block per (glyph, band of rows), as in winding.cu.
//   1. cx[kx][c] for the k sub-columns goes to shared memory.
//   2. For each sub-row offset ky: cy of the band's rows at that offset; the
//      segments stream through shared memory in chunks, and each thread
//      solves one (segment, row) pair with the float program of
//      winding_pallas_v2.py::phase_a_roots (segment_crossings,
//      crossings.cuh). The solve is shared by the k sub-columns, as in K9:
//      each live crossing makes k binary searches and k shared-memory atomic
//      deposits, one into each sub-column's bucket row.
//   3. Then one warp per row runs one suffix scan per sub-column
//      (suffix_scan_row, crossings.cuh), which gives that sub-row's
//      windings, and adds (w != 0) to the row's count.
//   4. out = (float)count * inv_k2, with coalesced stores.
// Winding and count are integer sums, so any order of the atomics gives the
// same result.
//
// Where its time goes on an H100: as for winding.cu, arithmetic per (segment,
// sub-row) pair (two divides and a square root, then k binary searches) and
// shared-memory atomics, not bytes: the output is 4 B per pixel whatever k
// is. The design solves each (segment, sub-row) once, never per sample, and
// turns the per-sample work into k scans per sub-row. Row culling by the
// segments' y-hull and TMA staging are left for later.
//
// Float rules: built with -fmad=false and without fast math (see
// crossings.cuh).

#include <cuda_runtime.h>

#include "crossings.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxRows = 16;        // rows per block, fewer when k * W is wide
constexpr int kSegChunk = 64;       // segments staged per shared-memory chunk
constexpr size_t kSmemLimit = 227 * 1024;

__device__ __forceinline__ float lattice_offset(int i, int k) {
  return ((float)i + 0.5f) / (float)k - 0.5f;
}

__global__ void __launch_bounds__(kThreads)
coverage_kernel(const float* __restrict__ seg, const int* __restrict__ min_x,
                const int* __restrict__ max_y, float scale, float inv_k2, int k,
                int S, int H, int W, int rows, float* __restrict__ out) {
  extern __shared__ unsigned char smem_raw[];
  float* chunk = reinterpret_cast<float*>(smem_raw);  // [kSegChunk * 6]
  float* cy = chunk + kSegChunk * 6;                  // [rows]
  float* cx = cy + rows;                              // [k][W]
  int* bucket = reinterpret_cast<int*>(cx + k * W);   // [rows][k][W + 1]
  int* count = bucket + rows * k * (W + 1);           // [rows][W]

  const int b = blockIdx.x;
  const int row0 = blockIdx.y * rows;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int mx = min_x[b];
  const int my = max_y[b];
  const float* gseg = seg + (size_t)b * S * 6;

  for (int i = tid; i < k * W; i += kThreads) {
    const int c = i % W;
    cx[i] = ((float)(mx + c) + lattice_offset(i / W, k)) / scale;
  }
  for (int i = tid; i < rows * W; i += kThreads) count[i] = 0;

  for (int ky = 0; ky < k; ++ky) {
    const float oy = lattice_offset(ky, k);
    __syncthreads();  // the previous sub-row's scans are done with bucket
    for (int r = tid; r < rows; r += kThreads) cy[r] = ((float)(my - (row0 + r)) + oy) / scale;
    for (int i = tid; i < rows * k * (W + 1); i += kThreads) bucket[i] = 0;

    for (int s0 = 0; s0 < S; s0 += kSegChunk) {
      const int ns = min(kSegChunk, S - s0);
      __syncthreads();  // cx/cy/bucket ready; the previous chunk fully consumed
      for (int i = tid; i < ns * 6; i += kThreads) chunk[i] = gseg[(size_t)s0 * 6 + i];
      __syncthreads();

      for (int p = tid; p < ns * rows; p += kThreads) {
        const int r = p % rows;
        if (row0 + r >= H) continue;
        int* brow = bucket + r * k * (W + 1);
        segment_crossings(chunk + (p / rows) * 6, cy[r], [&](float xx, int sign) {
          for (int kx = 0; kx < k; ++kx) deposit(brow + kx * (W + 1), cx + kx * W, W, xx, sign);
        });
      }
    }
    __syncthreads();

    // count[r][c] += (w != 0) with w[c] = sum_{j > c} bucket[r][kx][j]: one
    // warp per row, one suffix scan per sub-column
    for (int r = tid >> 5; r < rows; r += kThreads >> 5) {
      if (row0 + r >= H) break;
      int* crow = count + r * W;
      for (int kx = 0; kx < k; ++kx)
        suffix_scan_row(bucket + (r * k + kx) * (W + 1), W, lane,
                        [&](int c, int w) { crow[c] += w != 0; });
    }
  }
  __syncthreads();

  for (int i = tid; i < rows * W; i += kThreads) {
    const int y = row0 + i / W;
    if (y < H) out[((size_t)b * H + y) * W + i % W] = (float)count[i] * inv_k2;
  }
}

}  // namespace

// Shared memory the kernel needs for `rows` rows per block.
static size_t coverage_smem(int k, int W, int rows) {
  const size_t fixed = (size_t)kSegChunk * 6 * sizeof(float) + (size_t)k * W * sizeof(float);
  const size_t per_row =
      sizeof(float) + (size_t)k * (W + 1) * sizeof(int) + (size_t)W * sizeof(int);
  return fixed + (size_t)rows * per_row;
}

extern "C" cudaError_t coverage(const float* seg, const int* min_x, const int* max_y,
                                float scale, float inv_k2, int k, int B, int S, int H,
                                int W, float* out, cudaStream_t stream) {
  if (B < 0 || S < 0 || H < 0 || W < 0 || k < 1 || !(scale > 0.0f))
    return cudaErrorInvalidValue;
  if (B == 0 || H == 0 || W == 0) return cudaSuccess;

  // one row must fit; then as many as fit, up to kMaxRows
  if (coverage_smem(k, W, 1) > kSmemLimit) return cudaErrorInvalidValue;
  int rows = kMaxRows < H ? kMaxRows : H;
  while (coverage_smem(k, W, rows) > kSmemLimit) --rows;
  const size_t smem = coverage_smem(k, W, rows);
  const int bands = (H + rows - 1) / rows;
  if (bands > 65535) return cudaErrorInvalidValue;

  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        coverage_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  dim3 grid((unsigned)B, (unsigned)bands);
  coverage_kernel<<<grid, kThreads, smem, stream>>>(seg, min_x, max_y, scale, inv_k2, k,
                                                    S, H, W, rows, out);
  return cudaGetLastError();
}
