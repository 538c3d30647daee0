// The direct page render: the winding of a whole text page from one
// page-space segment stream, and its 2 x 2 MSAA page, for Hopper (sm_90a).
//
// Replaces the TPU page kernels
//   K7  fontrx/kernels/winding_page.py::_make_page_kernel (winding_page_batch,
//       :267), through the entry point page();
//   K8  fontrx/kernels/winding_page.py::_make_page_msaa_kernel
//       (winding_page_msaa_batch, :537; body :329), through page_msaa();
// and serves every page width, so the reference's narrow-page route (the v2
// carry sweep in 128-row bands, fontrx/scene/page.py:224-248, and its four
// MSAA passes, :491-506) is gone too.
//
// What it computes (kernels/page_ref.py states the function; route() there
// gives chunk, tile_w and x_cull for a width): rows [band_y0, band_y0 +
// out_h) of the page at a lattice of sample offsets, one int32 bucket plane
// per sample (oy_i, ox_j):
//   - row r samples y = f32(top - r) + oy, top = page_h - 1 - band_y0, and
//     column c samples x = f32(c) + ox;
//   - each em-space point goes to page pixels as p * s_px + offset[owner]
//     rounded once (fma_rn): the reference's flat_segments * s_px + offs, which
//     XLA compiles to a fused multiply-add;
//   - crossings come from crossings.cuh's segment_crossings, the float
//     program of winding_pallas_v2.py::phase_a_roots;
//   - the TPU kernels solve a chunk of `chunk` consecutive segments on a
//     128-row strip of the band only when the chunk's control hull, widened
//     by 1 px, meets the strip's sample rows; a crossing at xx in column tile
//     t adds its sign to the tiles left of t, and to the columns with
//     x <= xx of tile t only when the widened hull meets the row's 16-row
//     window; one at or right of x(pw) adds to every column. With x_cull
//     (K7's route) a chunk whose widened x-hull ends left of the smallest
//     x(0) of the lattice is skipped, a crossing counts only in the tiles
//     within 2 px of that x-hull, as the union over the lattice's ox (K8's
//     pair rule; one ox is K7's own), and one right of x(pw) only when the
//     x-hull reaches it.
// page() takes one sample (ox, oy) and writes the int32 winding, the 0/255
// fill or the debug gray. page_msaa() takes the 2 x 2 lattice of the whole
// page and writes the MSAA pixel: the four samples' fills summed as
// integers and divided by 4, rounding down (0, 63, 127, 191, 255). On
// K7's route its planes are K8's pair function, one per oy; below it, four
// single-sample pages, as the reference's two routes compute them.
// On a page whose roots all lie near their segments (any page whose
// transform is exact) that is the winding of every pair, csrc/winding.cu's
// at batch 1. After a zoom it is not: a nearly straight quadratic's rounded
// roots stray rows away, and the chunk cull decides which of them count.
//
// Design:
//   1. cudaMemsetAsync zeroes the global int32 buckets [planes][out_h][W + 1]
//      (1 plane for page(), 4 for page_msaa()).
//   2. page_hulls: one warp per chunk (a lane per segment) takes its control
//      hull; a last chunk that is not full gets the point (-1e7, -1e7) of the
//      reference's padding segments.
//   3. page_solve: one warp per segment (a grid-stride loop over segments).
//      The warp transforms the segment once. For each oy of the lattice it
//      widens its own control hull's y-range by its margin (below), and its
//      lanes walk the rows in that range whose strip its chunk meets. Each
//      (segment, row, oy) is solved ONCE, and each crossing goes to every
//      ox's plane: bucket[plane][row][k] with a global atomicAdd, k the
//      count of columns it covers (binary search over that ox's x in shared
//      memory, then the tile rules). K8 shares its phase A across the two
//      x samples of one oy the same way.
//   4. page_scan (one sample) or page_msaa_scan (the lattice): one warp per
//      row turns the bucket rows into windings by suffix scans and writes
//      the output pixel directly: the int32 winding, the fill or the gray,
//      or the MSAA pixel. No winding plane is written to device memory.
// So one call of an entry point is one frame; the wrapper counts it as one
// launch. The TPU kernel's per-tile deferred carries exist because the TPU
// cannot scatter; the bucket and its atomics do their work here.
// Shared-memory strips and x-hull tiles are left for later.
//
// Device memory: the em-space stream, the owners and the offsets (read),
// the chunk hulls (16 B a chunk), the buckets (4 B per plane and pixel:
// 133 MB for the MSAA page at 3840 x 2160, zeroed every frame) and the
// output (1 B a pixel, 4 for the winding).
//
// Where its time goes on an H100: the memset of the buckets, the solves of
// the visited pairs (a divide, a square root, two more divides), the binary
// searches and atomics of the crossings (one per ox), and the scans and
// store of every pixel; bytes are the em-space stream, the offsets and the
// output (fontrx_torch/bound.py: page_work, page_bytes, page_msaa_work,
// page_msaa_bytes).
//
// The margin drops only pairs without a root: a row outside the widened
// range gets no root in [0, 1) from the float program. Let u = 2^-24,
// M >= 1 bound |p0y|, |p1y|, |p2y| and |y| over the launch's sample rows of
// this oy (y = f32(top - r) + oy; the rows are monotone in r, so the first
// and last rows bound it), a' the program's rounded a. Nothing below
// depends on y being an integer: it holds for any float32 sample y.
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
// slivers, at oy = 0 and at oy = +-0.25.
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
constexpr int kMsaaPlanes = 4;     // the 2 x 2 lattice

enum Mode { kWinding = 0, kFill = 1, kGray = 2 };

// the sample lattice of one call: NY row offsets, NX column offsets; plane
// iy * NX + ix of the buckets holds sample (ox[ix], oy[iy])
template <int NY, int NX>
struct Lattice {
  float oy[NY];
  float ox[NX];
};

// page_ref.row_y: row r's sample y, f32(top - r) + oy
__device__ __forceinline__ float row_y(int top, int r, float oy) {
  return (float)(top - r) + oy;
}

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

template <int NY, int NX>
__global__ void __launch_bounds__(kThreads)
page_solve(const float* __restrict__ seg, const int* __restrict__ owner,
           const float* __restrict__ offsets, const float4* __restrict__ hulls, int S, int N,
           float s_px, int top, int out_h, int W, int chunk, int tile_w, int x_cull,
           Lattice<NY, NX> lat, int* __restrict__ bucket) {
  extern __shared__ float cx[];  // [NX][pw]: x of each column, per ox
  const int pw = (W + 127) / 128 * 128;
#pragma unroll
  for (int ix = 0; ix < NX; ++ix)
    for (int c = threadIdx.x; c < pw; c += kThreads) cx[ix * pw + c] = (float)c + lat.ox[ix];
  __syncthreads();
  float cx_end[NX];
  float x_first = INFINITY;  // the smallest x(0): K8's chunk test
#pragma unroll
  for (int ix = 0; ix < NX; ++ix) {
    cx_end[ix] = (float)pw + lat.ox[ix];
    x_first = fminf(x_first, 0.0f + lat.ox[ix]);
  }
  // the largest |y| of each row lattice: its first or last row
  double ymax[NY];
#pragma unroll
  for (int iy = 0; iy < NY; ++iy)
    ymax[iy] = fmax(fabs((double)row_y(top, 0, lat.oy[iy])),
                    fabs((double)row_y(top, out_h - 1, lat.oy[iy])));
  const size_t plane = (size_t)out_h * (W + 1);

  const int lane = threadIdx.x & 31;
  for (int s = blockIdx.x * kWarps + (threadIdx.x >> 5); s < S; s += gridDim.x * kWarps) {
    float q[6];
    if (!transform(seg, owner, offsets, N, s_px, s, q)) continue;
    const float4 h = hulls[s / chunk];
    if (x_cull && !(h.w + 1.0f >= x_first)) continue;  // the chunk ends left of x(0)
    // K7's column tiles for the chunk (winding_page.py:225-236), K8's union
    // over the ox (:480-505)
    const float g_lo = h.z - 1.0f, g_hi = h.w + 1.0f;
    float px_lo = g_lo - lat.ox[0], px_hi = g_hi - lat.ox[0];
#pragma unroll
    for (int ix = 1; ix < NX; ++ix) {
      px_lo = fminf(px_lo, g_lo - lat.ox[ix]);
      px_hi = fmaxf(px_hi, g_hi - lat.ox[ix]);
    }
    const float t_lo = floorf((px_lo - 2.0f) / (float)tile_w);
    const float t_hi = floorf((px_hi + 2.0f) / (float)tile_w);
    bool right_ok[NX];
#pragma unroll
    for (int ix = 0; ix < NX; ++ix) right_ok[ix] = !x_cull || g_hi >= cx_end[ix];

    const float hmin = fminf(fminf(q[1], q[3]), q[5]);
    const float hmax = fmaxf(fmaxf(q[1], q[3]), q[5]);
    const float a = q[1] - 2.0f * q[3] + q[5];
#pragma unroll
    for (int iy = 0; iy < NY; ++iy) {
      const float oy = lat.oy[iy];
      const double m = segment_margin(q[1], q[3], q[5], a, ymax[iy]);
      const double lo = (double)hmin - m;
      const double hi = (double)hmax + m;
      if (!(lo <= hi)) continue;  // NaN hull: no root anywhere

      // rows r with lo <= y(r) <= hi; y(r) falls with r. A first guess from
      // real arithmetic, then trimmed and extended with the rounded y(r).
      const double r_first = (double)top + (double)oy - hi;
      const double r_last = (double)top + (double)oy - lo;
      if (r_last < -1.0 || r_first > (double)out_h) continue;
      int r0 = r_first <= 0.0 ? 0 : (int)ceil(r_first);
      int r1 = r_last >= (double)(out_h - 1) ? out_h - 1 : (int)floor(r_last);
      while (r0 > 0 && (double)row_y(top, r0 - 1, oy) <= hi) --r0;
      while (r0 < out_h && (double)row_y(top, r0, oy) > hi) ++r0;
      while (r1 < out_h - 1 && (double)row_y(top, r1 + 1, oy) >= lo) ++r1;
      while (r1 >= 0 && (double)row_y(top, r1, oy) < lo) --r1;

      int* brow0 = bucket + (size_t)iy * NX * plane;
      for (int r = r0 + lane; r <= r1; r += 32) {
        const int s0 = r / kStripRows * kStripRows;
        if (!meets(h, row_y(top, s0, oy), row_y(top, s0 + kStripRows - 1, oy))) continue;
        const int w0 = r / kWindowRows * kWindowRows;
        const bool window = meets(h, row_y(top, w0, oy), row_y(top, w0 + kWindowRows - 1, oy));
        int* brow = brow0 + (size_t)r * (W + 1);
        segment_crossings(q, row_y(top, r, oy), [&](float xx, int sign) {
#pragma unroll
          for (int ix = 0; ix < NX; ++ix) {
            int k;
            if (xx >= cx_end[ix]) {
              if (!right_ok[ix]) continue;
              k = W;
            } else {
              k = covered_columns(cx + ix * pw, pw, xx);
              if (k == 0) continue;
              const int t = (k - 1) / tile_w;
              if (x_cull && !((float)t >= t_lo && (float)t <= t_hi)) continue;
              if (!window) k = t * tile_w;
              k = min(k, W);
            }
            if (k > 0) atomicAdd(&brow[ix * plane + k], sign);
          }
        });
      }
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

// One warp per row: the four planes' suffix scans side by side, the count
// of nonzero windings, and the MSAA pixel (count * 255) / 4, as the
// reference's uint16 sum of 0/255 fills floor-divided by 4 (page.py:490).
__global__ void __launch_bounds__(kThreads)
page_msaa_scan(const int* __restrict__ bucket, int H, int W, uint8_t* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (r >= H) return;
  const size_t plane = (size_t)H * (W + 1);
  const int* brow = bucket + (size_t)r * (W + 1);
  uint8_t* orow = out + (size_t)r * W;
  int carry[kMsaaPlanes] = {};
  for (int base = ((W - 1) >> 5) << 5; base >= 0; base -= 32) {
    const int c = base + lane;
    int count = 0;
#pragma unroll
    for (int p = 0; p < kMsaaPlanes; ++p) {
      const int s = warp_suffix_sum(c < W ? brow[p * plane + c + 1] : 0, lane);
      count += (s + carry[p]) != 0;
      carry[p] += __shfl_sync(0xffffffffu, s, 0);
    }
    if (c < W) orow[c] = (uint8_t)((count * 255) >> 2);
  }
}

// Zeroes the buckets, takes the chunk hulls and solves the lattice: steps 1-3.
template <int NY, int NX>
cudaError_t solve(const float* seg, const int* owner, const float* offsets, int S, int N,
                  float s_px, int top, int out_h, int W, int chunk, int tile_w, int x_cull,
                  const Lattice<NY, NX>& lat, float* hulls, int* bucket, cudaStream_t stream) {
  const int pw = (W + 127) / 128 * 128;
  const size_t smem = (size_t)NX * pw * sizeof(float);
  if (smem > kSmemLimit) return cudaErrorInvalidValue;
  const size_t planes = (size_t)NY * NX;
  cudaError_t err =
      cudaMemsetAsync(bucket, 0, planes * out_h * (W + 1) * sizeof(int), stream);
  if (err != cudaSuccess || S == 0) return err;
  const int n_chunks = (S + chunk - 1) / chunk;
  float4* h = reinterpret_cast<float4*>(hulls);
  page_hulls<<<(n_chunks + kWarps - 1) / kWarps, kThreads, 0, stream>>>(
      seg, owner, offsets, S, N, s_px, chunk, h);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(page_solve<NY, NX>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return err;
  }
  int blocks = (S + kWarps - 1) / kWarps;
  if (blocks > kMaxSolveBlocks) blocks = kMaxSolveBlocks;
  page_solve<NY, NX><<<blocks, kThreads, smem, stream>>>(seg, owner, offsets, h, S, N, s_px,
                                                         top, out_h, W, chunk, tile_w, x_cull,
                                                         lat, bucket);
  return cudaGetLastError();
}

bool bad_route(int chunk, int tile_w, int W) {
  const int pw = (W + 127) / 128 * 128;
  return chunk < 1 || chunk > 32 || tile_w < 1 || pw % tile_w != 0;
}

}  // namespace

// seg: float32 [S][3][2] em space; owner: int32 [S]; offsets: float32 [N][2];
// chunk, tile_w, x_cull: the reference's route for the width (page_ref.route);
// (ox, oy): the sample offset; hulls: float32 scratch [ceil(S / chunk)][4];
// bucket: int32 scratch [out_h][W + 1]; out: [out_h][W], int32 for mode 0,
// uint8 for modes 1 (fill) and 2 (gray).
extern "C" cudaError_t page(const float* seg, const int* owner, const float* offsets,
                            int S, int N, float s_px, int top, int out_h, int W, int mode,
                            int chunk, int tile_w, int x_cull, float ox, float oy,
                            float* hulls, int* bucket, void* out, cudaStream_t stream) {
  if (S < 0 || N < 0 || out_h < 0 || W < 0 || mode < kWinding || mode > kGray ||
      !(s_px > 0.0f) || bad_route(chunk, tile_w, W))
    return cudaErrorInvalidValue;
  if (out_h == 0 || W == 0) return cudaSuccess;
  const Lattice<1, 1> lat = {{oy}, {ox}};
  cudaError_t err = solve(seg, owner, offsets, S, N, s_px, top, out_h, W, chunk, tile_w,
                             x_cull, lat, hulls, bucket, stream);
  if (err != cudaSuccess) return err;
  page_scan<<<(out_h + kWarps - 1) / kWarps, kThreads, 0, stream>>>(bucket, out_h, W, mode,
                                                                    out);
  return cudaGetLastError();
}

// The 2 x 2 MSAA page of H rows: samples (ox0|ox1, oy0|oy1); bucket: int32
// scratch [4][H][W + 1]; out: uint8 [H][W]. Other arguments as page()'s.
extern "C" cudaError_t page_msaa(const float* seg, const int* owner, const float* offsets,
                                 int S, int N, float s_px, int H, int W, int chunk,
                                 int tile_w, int x_cull, float ox0, float ox1, float oy0,
                                 float oy1, float* hulls, int* bucket, uint8_t* out,
                                 cudaStream_t stream) {
  if (S < 0 || N < 0 || H < 0 || W < 0 || !(s_px > 0.0f) || bad_route(chunk, tile_w, W))
    return cudaErrorInvalidValue;
  if (H == 0 || W == 0) return cudaSuccess;
  const Lattice<2, 2> lat = {{oy0, oy1}, {ox0, ox1}};
  cudaError_t err = solve(seg, owner, offsets, S, N, s_px, H - 1, H, W, chunk, tile_w,
                             x_cull, lat, hulls, bucket, stream);
  if (err != cudaSuccess) return err;
  page_msaa_scan<<<(H + kWarps - 1) / kWarps, kThreads, 0, stream>>>(bucket, H, W, out);
  return cudaGetLastError();
}
