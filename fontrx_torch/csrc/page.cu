// The direct page render: the winding of a whole text page from one
// page-space segment stream, for Hopper (sm_90a).
//
// Replaces the TPU page kernel
//   K7  fontrx/kernels/winding_page.py::_make_page_kernel (winding_page_batch)
// and serves every page width, so the reference's narrow-page route (the v2
// carry sweep in 128-row bands, fontrx/scene/page.py:224-248) is gone too.
//
// What it computes: rows [band_y0, band_y0 + out_h) of the page, as the
// reference's two TPU kernels compute them (kernels/page_ref.py states the
// function; route() there gives chunk, tile_w and x_cull for a width):
//   - row r samples y = top - r, top = page_h - 1 - band_y0, and column c
//     samples x = c;
//   - each em-space point goes to page pixels as p * s_px + offset[owner]
//     rounded once (fma_rn): the reference's flat_segments * s_px + offs, which
//     XLA compiles to a fused multiply-add;
//   - crossings come from crossings.cuh's segment_crossings, the float
//     program of winding_pallas_v2.py::phase_a_roots;
//   - the TPU kernels solve a chunk of `chunk` consecutive segments on a
//     128-row strip of the band only when the chunk's control hull, widened
//     by 1 px, meets the strip; a crossing at xx in column tile t adds its
//     sign to the tiles left of t, and to the columns c <= xx of tile t only
//     when the widened hull meets the row's 16-row window; one right of the
//     padded width pw adds to every column. With x_cull (K7's route) a chunk
//     whose widened x-hull ends left of column 0 is skipped, a crossing
//     counts only in the tiles within 2 px of that x-hull, and one right of
//     pw only when the x-hull reaches it.
// On a page whose roots all lie near their segments (any page whose
// transform is exact) that is the winding of every pair, csrc/winding.cu's
// at batch 1. After a zoom it is not: a nearly straight quadratic's rounded
// roots stray rows away, and the chunk cull decides which of them count.
//
// Design:
//   1. cudaMemsetAsync zeroes a global int32 bucket [out_h][W + 1].
//   2. page_hulls: one warp per chunk (a lane per segment) takes its control
//      hull; a last chunk that is not full gets the point (-1e7, -1e7) of the
//      reference's padding segments.
//   3. page_solve: one warp per segment (a grid-stride loop over segments).
//      The warp transforms the segment, widens its own control hull's
//      y-range by its margin (below), and its lanes walk the rows in that
//      range whose strip its chunk meets. Each crossing goes to
//      bucket[row][k] with a global atomicAdd, k the count of columns it
//      covers (binary search over cx in shared memory, then the tile rules).
//   4. page_scan: one warp per row turns the bucket row into the winding by
//      a suffix scan and writes the int32 winding, the 0/255 fill or the
//      debug gray clip(w * 20 + 100, 0, 255) directly.
// The TPU kernel's per-tile deferred carries exist because the TPU cannot
// scatter; the bucket and its atomics do their work here. Shared-memory
// strips and x-hull tiles are left for later.
//
// Where its time goes on an H100: the solves of the visited pairs (a divide,
// a square root, two more divides), the binary searches and atomics of the
// crossings, and the scan and store of every pixel; bytes are the em-space
// stream, the offsets and the output (fontrx_torch/bound.py: page_work,
// page_bytes).
//
// The margin drops only pairs without a root: a row outside the widened
// range gets no root in [0, 1) from the float program. Let u = 2^-24,
// M >= 1 bound |p0y|, |p1y|, |p2y| and |y| over the page's rows, a' the
// program's rounded a.
//   - Line, a' == 0: t = fl(fl(y - p0y) / fl(p2y - p0y)). Rounding is
//     monotone, so for y above max(p0y, p2y) either p2y > p0y and
//     fl(y - p0y) >= fl(p2y - p0y) > 0, t >= 1, or p2y < p0y and t < 0,
//     unless the quotient underflows to -0, which needs y - p0y below
//     2^-149 * 2M < 2^-19; the same below. So a line crosses no row more
//     than 2^-19 px off its hull; the margin is 1 pixel.
//   - Quadratic, a' != 0. With a = p0y - 2 p1y + p2y exact, the program's
//     operations give |a' - a| <= 7.01 M u, its discriminant is
//     delta = (p0y - p1y)^2 + a (y - p0y) to within 24.1 M^2 u, its square
//     root squared to within 12.2 M^2 u more, and fl(p0y - p1y) is within
//     2 M u. A root t = fl(n / a') in [0, 1) needs n / a' in [-2^-150, 1),
//     so tau = (q +- sq) / a' in [-2^-149, 1 + 2u]. Squaring
//     q +- sq = a' tau and subtracting the curve's own identity
//     a (y(tau) - p0y) = a^2 tau^2 - 2 a tau (p0y - p1y) leaves
//     |a| |y - y(tau)| <= 145.3 M^2 u, and y(tau) lies within 32 M u of the
//     hull. So the row lies within 145.3 M^2 u / (|a'| - 7.01 M u) + 32 M u
//     of the hull. The margin rounds the constants up:
//     max(1, 160 M^2 u / (|a'| - 8 M u) + 32 M u), and every row where
//     |a'| <= 8 M u: a nearly straight quadratic, whose roots stray.
// The margin is computed in double, with the operations and order of
// kernels/page_ref.py::margin, which the CPU tests prove conservative on
// slivers.
//
// Float rules: built with -fmad=false and without fast math: no
// multiply-add is contracted (the transform's one rounding is fma_rn's, in
// double), and '/' and sqrtf round correctly.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "crossings.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxSolveBlocks = 8 * 132;  // eight blocks (64 warps) per H100 SM
constexpr size_t kSmemLimit = 227 * 1024;
constexpr double kU = 0x1p-24;
constexpr int kStripRows = 128;
constexpr int kWindowRows = 16;
constexpr float kPadPoint = -1e7f;  // page_ref.PAD_POINT

enum Mode { kWinding = 0, kFill = 1, kGray = 2 };

__device__ __forceinline__ float row_y(int top, int r) { return (float)(top - r); }

// page_ref.meets: the hull (y_min, y_max, x_min, x_max), widened by 1 px,
// meets the rows from y_hi down to y_lo, in float32
__device__ __forceinline__ bool meets(float4 h, float y_hi, float y_lo) {
  return h.y + 1.0f >= y_lo && h.x - 1.0f <= y_hi;
}

// a * b + c rounded once, as page_ref.fma_rn computes it: a * b is exact in
// double, the double sum is rounded to odd (TwoSum's exact error decides the
// last bit), so the one rounding to float after it is the correct one.
__device__ __forceinline__ float fma_rn(float a, float b, float c) {
  const double p = (double)a * (double)b;
  const double cd = (double)c;
  double s = p + cd;
  const double v = s - p;
  const double err = (p - (s - v)) + (cd - v);
  const long long bits = __double_as_longlong(s);
  // to odd: one ulp toward the exact sum (s != 0 when err != 0)
  if (err != 0.0 && (bits & 1) == 0)
    s = __longlong_as_double(bits + ((err > 0.0) == (s > 0.0) ? 1 : -1));
  return (float)s;
}

// The segment in page pixels: q = fma_rn(p, s_px, offset), one rounding.
// False when its owner is no instance: such a segment adds nothing.
__device__ __forceinline__ bool transform(const float* seg, const int* owner,
                                          const float* offsets, int N, float s_px, int s,
                                          float q[6]) {
  const int o = owner[s];
  if (o < 0 || o >= N) return false;
#pragma unroll
  for (int i = 0; i < 6; ++i)
    q[i] = fma_rn(seg[(size_t)s * 6 + i], s_px, offsets[(size_t)o * 2 + (i & 1)]);
  return true;
}

// page_ref.margin, op for op
__device__ double segment_margin(float p0y, float p1y, float p2y, float a, double ymax) {
  if (a == 0.0f) return 1.0;
  double m = fmax(fmax(fabs((double)p0y), fabs((double)p1y)), fabs((double)p2y));
  m = fmax(fmax(m, ymax), 1.0);
  const double den = fabs((double)a) - 8.0 * m * kU;
  if (!(den > 0.0)) return INFINITY;
  return fmax(160.0 * m * m * kU / den + 32.0 * m * kU, 1.0);
}

__global__ void __launch_bounds__(kThreads)
page_hulls(const float* __restrict__ seg, const int* __restrict__ owner,
           const float* __restrict__ offsets, int S, int N, float s_px, int chunk,
           float4* __restrict__ hulls) {
  const int c = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (c >= (S + chunk - 1) / chunk) return;  // the whole warp leaves together
  const int lane = threadIdx.x & 31;
  const int s = c * chunk + lane;
  float4 h = make_float4(INFINITY, -INFINITY, INFINITY, -INFINITY);
  float q[6];
  if (lane < chunk && s < S && transform(seg, owner, offsets, N, s_px, s, q)) {
    for (int i = 0; i < 6; i += 2) {
      h.x = fminf(h.x, q[i + 1]);
      h.y = fmaxf(h.y, q[i + 1]);
      h.z = fminf(h.z, q[i]);
      h.w = fmaxf(h.w, q[i]);
    }
  }
  if (lane == 0 && S - c * chunk < chunk)
    h = make_float4(fminf(h.x, kPadPoint), fmaxf(h.y, kPadPoint), fminf(h.z, kPadPoint),
                    fmaxf(h.w, kPadPoint));
  for (int off = 16; off > 0; off >>= 1) {
    h.x = fminf(h.x, __shfl_xor_sync(0xffffffffu, h.x, off));
    h.y = fmaxf(h.y, __shfl_xor_sync(0xffffffffu, h.y, off));
    h.z = fminf(h.z, __shfl_xor_sync(0xffffffffu, h.z, off));
    h.w = fmaxf(h.w, __shfl_xor_sync(0xffffffffu, h.w, off));
  }
  if (lane == 0) hulls[c] = h;
}

__global__ void __launch_bounds__(kThreads)
page_solve(const float* __restrict__ seg, const int* __restrict__ owner,
           const float* __restrict__ offsets, const float4* __restrict__ hulls, int S, int N,
           float s_px, int top, int out_h, int W, int chunk, int tile_w, int x_cull,
           int* __restrict__ bucket) {
  extern __shared__ float cx[];  // [pw]
  const int pw = (W + 127) / 128 * 128;
  for (int c = threadIdx.x; c < pw; c += kThreads) cx[c] = (float)c;
  __syncthreads();
  const float cx_end = (float)pw;

  const int lane = threadIdx.x & 31;
  const double ymax = fmax(fabs((double)row_y(top, 0)), fabs((double)row_y(top, out_h - 1)));
  for (int s = blockIdx.x * kWarps + (threadIdx.x >> 5); s < S; s += gridDim.x * kWarps) {
    float q[6];
    if (!transform(seg, owner, offsets, N, s_px, s, q)) continue;
    const float4 h = hulls[s / chunk];
    if (x_cull && !(h.w + 1.0f >= 0.0f)) continue;  // the chunk ends left of column 0
    // K7's column tiles for the chunk (winding_page.py:225-236)
    const float t_lo = floorf(((h.z - 1.0f) - 2.0f) / (float)tile_w);
    const float t_hi = floorf(((h.w + 1.0f) + 2.0f) / (float)tile_w);
    const bool right_ok = !x_cull || h.w + 1.0f >= cx_end;

    const float hmin = fminf(fminf(q[1], q[3]), q[5]);
    const float hmax = fmaxf(fmaxf(q[1], q[3]), q[5]);
    const float a = q[1] - 2.0f * q[3] + q[5];
    const double m = segment_margin(q[1], q[3], q[5], a, ymax);
    const double lo = (double)hmin - m;
    const double hi = (double)hmax + m;
    if (!(lo <= hi)) continue;  // NaN hull: no root anywhere

    // rows r with lo <= y(r) <= hi; y(r) falls with r. A first guess from
    // real arithmetic, then trimmed and extended with the rounded y(r).
    const double r_first = (double)top - hi;
    const double r_last = (double)top - lo;
    if (r_last < -1.0 || r_first > (double)out_h) continue;
    int r0 = r_first <= 0.0 ? 0 : (int)ceil(r_first);
    int r1 = r_last >= (double)(out_h - 1) ? out_h - 1 : (int)floor(r_last);
    while (r0 > 0 && (double)row_y(top, r0 - 1) <= hi) --r0;
    while (r0 < out_h && (double)row_y(top, r0) > hi) ++r0;
    while (r1 < out_h - 1 && (double)row_y(top, r1 + 1) >= lo) ++r1;
    while (r1 >= 0 && (double)row_y(top, r1) < lo) --r1;

    for (int r = r0 + lane; r <= r1; r += 32) {
      const int strip_top = top - r / kStripRows * kStripRows;
      if (!meets(h, (float)strip_top, (float)(strip_top - (kStripRows - 1)))) continue;
      const int window_top = top - r / kWindowRows * kWindowRows;
      const bool window = meets(h, (float)window_top, (float)(window_top - (kWindowRows - 1)));
      int* brow = bucket + (size_t)r * (W + 1);
      segment_crossings(q, row_y(top, r), [&](float xx, int sign) {
        int k;
        if (xx >= cx_end) {
          if (!right_ok) return;
          k = W;
        } else {
          k = covered_columns(cx, pw, xx);
          if (k == 0) return;
          const int t = (k - 1) / tile_w;
          if (x_cull && !((float)t >= t_lo && (float)t <= t_hi)) return;
          if (!window) k = t * tile_w;
          k = min(k, W);
        }
        if (k > 0) atomicAdd(&brow[k], sign);
      });
    }
  }
}

__global__ void __launch_bounds__(kThreads)
page_scan(const int* __restrict__ bucket, int out_h, int W, int mode, void* out) {
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (r >= out_h) return;
  const int* brow = bucket + (size_t)r * (W + 1);
  if (mode == kWinding) {
    int* orow = static_cast<int*>(out) + (size_t)r * W;
    suffix_scan_row(brow, W, lane, [&](int c, int w) { orow[c] = w; });
  } else if (mode == kFill) {
    uint8_t* orow = static_cast<uint8_t*>(out) + (size_t)r * W;
    suffix_scan_row(brow, W, lane, [&](int c, int w) { orow[c] = w != 0 ? 255 : 0; });
  } else {
    uint8_t* orow = static_cast<uint8_t*>(out) + (size_t)r * W;
    suffix_scan_row(brow, W, lane, [&](int c, int w) {
      orow[c] = (uint8_t)min(max(w * 20 + 100, 0), 255);
    });
  }
}

}  // namespace

// seg: float32 [S][3][2] em space; owner: int32 [S]; offsets: float32 [N][2];
// chunk, tile_w, x_cull: the reference's route for the width (page_ref.route);
// hulls: float32 scratch [ceil(S / chunk)][4]; bucket: int32 scratch
// [out_h][W + 1]; out: [out_h][W], int32 for mode 0, uint8 for modes 1 (fill)
// and 2 (gray).
extern "C" cudaError_t page(const float* seg, const int* owner, const float* offsets,
                            int S, int N, float s_px, int top, int out_h, int W, int mode,
                            int chunk, int tile_w, int x_cull, float* hulls, int* bucket,
                            void* out, cudaStream_t stream) {
  const int pw = (W + 127) / 128 * 128;
  if (S < 0 || N < 0 || out_h < 0 || W < 0 || mode < kWinding || mode > kGray ||
      !(s_px > 0.0f) || chunk < 1 || chunk > 32 || tile_w < 1 || pw % tile_w != 0)
    return cudaErrorInvalidValue;
  if (out_h == 0 || W == 0) return cudaSuccess;
  const size_t smem = (size_t)pw * sizeof(float);
  if (smem > kSmemLimit) return cudaErrorInvalidValue;

  cudaError_t err =
      cudaMemsetAsync(bucket, 0, (size_t)out_h * (W + 1) * sizeof(int), stream);
  if (err != cudaSuccess) return err;
  if (S > 0) {
    const int n_chunks = (S + chunk - 1) / chunk;
    float4* h = reinterpret_cast<float4*>(hulls);
    page_hulls<<<(n_chunks + kWarps - 1) / kWarps, kThreads, 0, stream>>>(
        seg, owner, offsets, S, N, s_px, chunk, h);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    if (smem > 48 * 1024) {
      err = cudaFuncSetAttribute(page_solve, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)smem);
      if (err != cudaSuccess) return err;
    }
    int blocks = (S + kWarps - 1) / kWarps;
    if (blocks > kMaxSolveBlocks) blocks = kMaxSolveBlocks;
    page_solve<<<blocks, kThreads, smem, stream>>>(seg, owner, offsets, h, S, N, s_px, top,
                                                  out_h, W, chunk, tile_w, x_cull, bucket);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  page_scan<<<(out_h + kWarps - 1) / kWarps, kThreads, 0, stream>>>(bucket, out_h, W, mode,
                                                                    out);
  return cudaGetLastError();
}
