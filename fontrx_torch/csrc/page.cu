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
// Two designs stand here until K8's own redesign moves page_msaa() onto the
// first and deletes the second.
//
// page() (K7), redesigned for this card. What bounded the first port: the
// scan walked each row one warp 32 columns at a time, right to left, a
// dependent load and a five-step shuffle scan per step (60 steps a row at
// 1920 wide, 120 at 3840), so a band cost what the page cost; the solve gave
// a whole warp to every segment, most of them off the page or two to five
// rows tall, and each warp ran the FP64 transform and margin for one.
// Now a frame is four device operations:
//   1. cudaMemsetAsync zeroes the int32 buckets [out_h][stride], stride = W
//      rounded up to 4 (16-byte rows), and two counters after them. Cell c
//      of a row holds the crossings that cover columns [0, c + 1), so column
//      c's winding is the sum of cells c .. W - 1.
//   2. page_segments: a warp takes 32 consecutive segments, a lane each
//      (chunk is 16 or 32, so a warp holds whole chunks). Each lane
//      transforms its segment, the warp reduces the chunk hulls with
//      shuffles (a segment past S adds the padding point), and each lane
//      takes its x-cull, its column-tile window, its margin and its rows:
//      those within the margin of its y-hull, cut to the 128-row strips its
//      chunk meets (the strips met are a run, so two trims of the ends find
//      them). A segment of more than kLightRows rows is written to a list
//      of long segments (an atomic per warp reserves the slots). The short
//      ones' (segment, row) pairs are flattened over the warp by a prefix
//      over the lanes' row counts, and the lanes take them 32 at a time,
//      each finding its pair's segment by a binary search over the prefix in
//      shared memory.
//   3. page_long: the long segments' rows, a lane a row; work item g is
//      32-row block g / n of long segment g % n, so one segment's blocks go
//      to different warps. On config 5's and the 4K page's first views the
//      pairs lie almost all on such segments (a few hundred rows each: big
//      glyphs, and near-flat curves whose margin spans their strips).
//   A crossing's column count k comes from the sample x's own arithmetic (a
//   guess from xx - ox, moved while the predicate says so), its tile rules
//   are the first port's, and it adds its sign to cell k - 1 with a global
//   atomic.
//   4. page_rows_scan: a warp a row, 512 columns a step, right to left: each
//      lane loads 16 consecutive cells in four 16-byte loads (the next
//      step's loads issued before this step's arithmetic), scans them in
//      registers, and one warp suffix scan of the lane totals and the carry
//      of the steps to the right finish them (4 steps a row at 1920 wide, 8
//      at 3840). It writes the int32 winding, the fill or the gray as
//      16-byte words where the row's width allows, else narrower.
// The chunk hulls' kernel and scratch are gone. The wrapper counts one
// launch a frame. What bounds it now on an H100 (PERF.md): on the 4K page
// bytes, the memset and the scan of the dense buckets (33 MB written, 33 MB
// read and 8 MB written: two-thirds of the frame); on config 5 the two
// solve passes' latency (a few hundred warps, each lane's FP64 transform
// and margin, then its crossings) and the four operations back to back.
//
// page_msaa() (K8), the first port's design, unchanged:
//   1. cudaMemsetAsync zeroes the int32 buckets [4][out_h][W + 1].
//   2. page_hulls: one warp per chunk (a lane per segment) takes its control
//      hull; a last chunk that is not full gets the point (-1e7, -1e7) of the
//      reference's padding segments.
//   3. page_solve<2, 2>: one warp per segment (a grid-stride loop over
//      segments). The warp transforms the segment once. For each oy of the
//      lattice it widens its own control hull's y-range by its margin
//      (below), and its lanes walk the rows in that range whose strip its
//      chunk meets. Each (segment, row, oy) is solved ONCE, and each
//      crossing goes to both ox's planes: bucket[plane][row][k] with a
//      global atomicAdd, k the count of columns it covers (binary search
//      over that ox's x in shared memory, then the tile rules).
//   4. page_msaa_scan: one warp per row runs the four planes' suffix scans
//      side by side and writes the MSAA pixel directly.
// No winding plane is written to device memory. The TPU kernel's per-tile
// deferred carries exist because the TPU cannot scatter; the bucket and its
// atomics do their work here.
//
// Device memory: the em-space stream, the owners and the offsets (read),
// K8's chunk hulls (16 B a chunk), the buckets (4 B per plane and pixel:
// 33 MB for the page at 3840 x 2160, 133 MB for its MSAA page, zeroed every
// frame) and the output (1 B a pixel, 4 for the winding). Bytes are the
// em-space stream, the offsets and the output (fontrx_torch/bound.py:
// page_work, page_bytes, page_msaa_work, page_msaa_bytes); the memset and
// the scan's read of the buckets are the design's own.
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
constexpr int kSegmentWarps = 4;   // page_segments: warps a block, 32 segments each
constexpr int kScanCols = 16;      // page_rows_scan: bucket cells a lane holds a step
constexpr int kScanStep = 32 * kScanCols;

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
__device__ __forceinline__ bool meets(float y_min, float y_max, float y_hi, float y_lo) {
  return y_max + 1.0f >= y_lo && y_min - 1.0f <= y_hi;
}

__device__ __forceinline__ bool meets(float4 h, float y_hi, float y_lo) {
  return meets(h.x, h.y, y_hi, y_lo);
}

// The count of columns c in [0, pw) whose sample x = (float)c + ox is not
// right of xx, !(xx < x): a prefix, since x is non-decreasing in c. The same
// predicate as covered_columns over a table of the x, from a guess moved
// while the predicate says so; for |ox| < 2^23 the guess is off by at most
// one column.
__device__ __forceinline__ int covered_at(float xx, float ox, int pw) {
  const float g = xx - ox;
  if (!(g == g)) return pw;  // xx is NaN: !(xx < x) everywhere
  int c = g < 0.0f ? 0 : (g >= (float)pw ? pw : (int)g + 1);
  while (c < pw && !(xx < (float)c + ox)) ++c;
  while (c > 0 && xx < (float)(c - 1) + ox) --c;
  return c;
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

// The rows r in [0, out_h) whose sample y(r) = f32(top - r) + oy lies in
// [y_min - m, y_max + m]: [r0, r1], empty when r1 < r0. y(r) falls with r:
// a first guess from real arithmetic, then trimmed and extended with the
// rounded y(r). A NaN bound (a NaN hull) gives no row.
__device__ __forceinline__ void margin_rows(float y_min, float y_max, double m, int top,
                                            int out_h, float oy, int& r0, int& r1) {
  r0 = 0;
  r1 = -1;
  const double lo = (double)y_min - m;
  const double hi = (double)y_max + m;
  if (!(lo <= hi)) return;
  const double r_first = (double)top + (double)oy - hi;
  const double r_last = (double)top + (double)oy - lo;
  if (r_last < -1.0 || r_first > (double)out_h) return;
  r0 = r_first <= 0.0 ? 0 : (int)ceil(r_first);
  r1 = r_last >= (double)(out_h - 1) ? out_h - 1 : (int)floor(r_last);
  while (r0 > 0 && (double)row_y(top, r0 - 1, oy) <= hi) --r0;
  while (r0 < out_h && (double)row_y(top, r0, oy) > hi) ++r0;
  while (r1 < out_h - 1 && (double)row_y(top, r1 + 1, oy) >= lo) ++r1;
  while (r1 >= 0 && (double)row_y(top, r1, oy) < lo) --r1;
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
      int r0, r1;
      margin_rows(hmin, hmax, segment_margin(q[1], q[3], q[5], a, ymax[iy]), top, out_h, oy,
                  r0, r1);

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

// A segment page_segments leaves to page_long: in page pixels, its chunk's
// hull y-range and column tiles, its first row and row count, and whether a
// crossing right of the padded width counts.
struct alignas(16) LongSegment {
  float q[6];
  float y_min, y_max, t_lo, t_hi;
  int r0, count, right, pad;
};
static_assert(sizeof(LongSegment) == 16 * sizeof(int), "kernels/page.py sizes the records");
constexpr int kLightRows = 16;  // page_segments solves a segment of at most this many rows
constexpr int kCounters = 4;    // after the buckets: long segments, their most rows, 2 spare

// The crossings of segment q on row r, deposited with the chunk rules of
// its hull (y_min, y_max), column tiles [t_lo, t_hi] and right-edge rule.
__device__ __forceinline__ void solve_row(const float* q, float y_min, float y_max, float t_lo,
                                          float t_hi, bool right, int r, int top, float ox,
                                          float oy, int W, int pw, int tile_w, int x_cull,
                                          int* __restrict__ bucket, int stride) {
  const float cx_end = (float)pw + ox;
  const int w0 = r / kWindowRows * kWindowRows;
  const bool window =
      meets(y_min, y_max, row_y(top, w0, oy), row_y(top, w0 + kWindowRows - 1, oy));
  int* brow = bucket + (size_t)r * stride;
  segment_crossings(q, row_y(top, r, oy), [&](float xx, int sign) {
    int k;
    if (xx >= cx_end) {
      if (!right) return;
      k = W;
    } else {
      k = covered_at(xx, ox, pw);
      if (k == 0) return;
      const int t = (k - 1) / tile_w;
      if (x_cull && !((float)t >= t_lo && (float)t <= t_hi)) return;
      if (!window) k = t * tile_w;
      k = min(k, W);
    }
    if (k > 0) atomicAdd(&brow[k - 1], sign);
  });
}

// page(), step 2: a warp's 32 segments, a lane each; see the note at the top.
__global__ void __launch_bounds__(kSegmentWarps * 32)
page_segments(const float* __restrict__ seg, const int* __restrict__ owner,
              const float* __restrict__ offsets, int S, int N, float s_px, int top, int out_h,
              int W, int stride, int chunk, int tile_w, int x_cull, float ox, float oy,
              int* __restrict__ bucket, int* __restrict__ counters,
              LongSegment* __restrict__ longs) {
  __shared__ float s_q[kSegmentWarps][6][32];
  __shared__ float4 s_h[kSegmentWarps][32];  // hull y_min, y_max; column tiles t_lo, t_hi
  __shared__ int s_r0[kSegmentWarps][32];
  __shared__ int s_off[kSegmentWarps][32];
  __shared__ bool s_right[kSegmentWarps][32];
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const int s = (blockIdx.x * kSegmentWarps + w) * 32 + lane;
  if (s - lane >= S) return;  // the whole warp leaves together
  const int pw = (W + 127) / 128 * 128;

  // the segment in page pixels, and its chunk's hull (page_hulls' rule: a
  // segment past S is the padding point)
  float q[6];
  const bool live = s < S && transform(seg, owner, offsets, N, s_px, s, q);
  float4 h = make_float4(INFINITY, -INFINITY, INFINITY, -INFINITY);
  if (live) {
    for (int i = 0; i < 6; i += 2) {
      h.x = fminf(h.x, q[i + 1]);
      h.y = fmaxf(h.y, q[i + 1]);
      h.z = fminf(h.z, q[i]);
      h.w = fmaxf(h.w, q[i]);
    }
  } else if (s >= S) {
    h = make_float4(kPadPoint, kPadPoint, kPadPoint, kPadPoint);
  }
  for (int off = chunk >> 1; off > 0; off >>= 1) {
    h.x = fminf(h.x, __shfl_xor_sync(0xffffffffu, h.x, off));
    h.y = fmaxf(h.y, __shfl_xor_sync(0xffffffffu, h.y, off));
    h.z = fminf(h.z, __shfl_xor_sync(0xffffffffu, h.z, off));
    h.w = fmaxf(h.w, __shfl_xor_sync(0xffffffffu, h.w, off));
  }

  // the chunk's column tiles (winding_page.py:225-236) and the x-cull
  const float g_lo = h.z - 1.0f, g_hi = h.w + 1.0f;
  const float t_lo = floorf((g_lo - ox - 2.0f) / (float)tile_w);
  const float t_hi = floorf((g_hi - ox + 2.0f) / (float)tile_w);
  const bool right_ok = !x_cull || g_hi >= (float)pw + ox;

  // the rows within the margin of its y-hull, on the strips its chunk meets
  int r0 = 0, r1 = -1;
  if (live && !(x_cull && !(g_hi >= 0.0f + ox))) {
    const double ymax = fmax(fabs((double)row_y(top, 0, oy)),
                             fabs((double)row_y(top, out_h - 1, oy)));
    const float hmin = fminf(fminf(q[1], q[3]), q[5]);
    const float hmax = fmaxf(fmaxf(q[1], q[3]), q[5]);
    const float a = q[1] - 2.0f * q[3] + q[5];
    margin_rows(hmin, hmax, segment_margin(q[1], q[3], q[5], a, ymax), top, out_h, oy, r0,
                r1);
    if (r0 <= r1) {
      // the strips whose sample rows the chunk's widened hull meets: y falls
      // with the strip, so they are a run; trim both ends to it
      int k0 = r0 / kStripRows, k1 = r1 / kStripRows;
      while (k0 <= k1 && !meets(h, row_y(top, k0 * kStripRows, oy),
                                row_y(top, k0 * kStripRows + kStripRows - 1, oy)))
        ++k0;
      while (k1 >= k0 && !meets(h, row_y(top, k1 * kStripRows, oy),
                                row_y(top, k1 * kStripRows + kStripRows - 1, oy)))
        --k1;
      r0 = max(r0, k0 * kStripRows);
      r1 = min(r1, k1 * kStripRows + kStripRows - 1);
    }
  }
  const int count = max(r1 - r0 + 1, 0);

  // a long segment goes to page_long, whose lanes take a row each
  const bool is_long = count > kLightRows;
  const unsigned longs_here = __ballot_sync(0xffffffffu, is_long);
  if (longs_here != 0) {
    int base = 0;
    if (lane == 0) base = atomicAdd(&counters[0], __popc(longs_here));
    base = __shfl_sync(0xffffffffu, base, 0);
    const int most = (int)__reduce_max_sync(0xffffffffu, is_long ? (unsigned)count : 0u);
    if (lane == 0) atomicMax(&counters[1], most);
    if (is_long) {
      LongSegment& ls = longs[base + __popc(longs_here & ((1u << lane) - 1u))];
#pragma unroll
      for (int i = 0; i < 6; ++i) ls.q[i] = q[i];
      ls.y_min = h.x;
      ls.y_max = h.y;
      ls.t_lo = t_lo;
      ls.t_hi = t_hi;
      ls.r0 = r0;
      ls.count = count;
      ls.right = right_ok;
    }
  }

  // the short ones' (segment, row) pairs, flattened over the lanes: an
  // inclusive prefix over the lanes' rows
  const int rows = is_long ? 0 : count;
  int incl = rows;
  for (int off = 1; off < 32; off <<= 1) {
    const int t = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += t;
  }
  const int total = __shfl_sync(0xffffffffu, incl, 31);
  if (total == 0) return;
#pragma unroll
  for (int i = 0; i < 6; ++i) s_q[w][i][lane] = q[i];
  s_h[w][lane] = make_float4(h.x, h.y, t_lo, t_hi);
  s_r0[w][lane] = r0;
  s_off[w][lane] = incl - rows;
  s_right[w][lane] = right_ok;
  __syncwarp();

  for (int j = lane; j < total; j += 32) {
    // the pair's segment: the last lane whose first pair is at or before j
    int o = 0;
#pragma unroll
    for (int step = 16; step > 0; step >>= 1)
      if (s_off[w][o + step] <= j) o += step;
    float qo[6];
#pragma unroll
    for (int i = 0; i < 6; ++i) qo[i] = s_q[w][i][o];
    const float4 ho = s_h[w][o];
    solve_row(qo, ho.x, ho.y, ho.z, ho.w, s_right[w][o], s_r0[w][o] + (j - s_off[w][o]), top,
              ox, oy, W, pw, tile_w, x_cull, bucket, stride);
  }
}

// page(), step 3: the long segments' rows, a lane a row. Work item g is
// row block g / n (32 rows) of long segment g % n, so the blocks of one
// segment go to different warps; a warp strides over the items.
__global__ void __launch_bounds__(kThreads)
page_long(const LongSegment* __restrict__ longs, const int* __restrict__ counters, int top,
          int W, int stride, int tile_w, int x_cull, float ox, float oy,
          int* __restrict__ bucket) {
  const int n = counters[0];
  if (n == 0) return;
  const long long items = (long long)n * ((counters[1] + 31) / 32);
  const int lane = threadIdx.x & 31;
  const int pw = (W + 127) / 128 * 128;
  for (long long g = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5); g < items;
       g += (long long)gridDim.x * kWarps) {
    const LongSegment& ls = longs[g % n];
    const int row = (int)(g / n) * 32 + lane;
    if (row < ls.count)
      solve_row(ls.q, ls.y_min, ls.y_max, ls.t_lo, ls.t_hi, ls.right != 0, ls.r0 + row, top,
                ox, oy, W, pw, tile_w, x_cull, bucket, stride);
  }
}

// page_rows_scan's output value of a winding w
template <int M>
__device__ __forceinline__ uint32_t pixel(int w) {
  if constexpr (M == kFill) return w != 0 ? 255u : 0u;
  return (uint32_t)min(max(w * 20 + 100, 0), 255);
}

// page(), step 3: a warp a row, right to left, kScanStep cells a step; see
// the note at the top. The cells of a row past W are zero.
template <int M>
__global__ void __launch_bounds__(kThreads)
page_rows_scan(const int* __restrict__ bucket, int out_h, int W, int stride,
               void* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (r >= out_h) return;
  const int* row = bucket + (size_t)r * stride;
  const int steps = (W + kScanStep - 1) / kScanStep;
  int4 cur[kScanCols / 4], nxt[kScanCols / 4];
  auto load = [&](int4* v, int step) {
    const int c = step * kScanStep + lane * kScanCols;
#pragma unroll
    for (int g = 0; g < kScanCols / 4; ++g)
      v[g] = c + 4 * g < W ? *reinterpret_cast<const int4*>(row + c + 4 * g)
                           : make_int4(0, 0, 0, 0);
  };
  load(cur, steps - 1);
  int carry = 0;
  for (int step = steps - 1; step >= 0; --step) {
    if (step > 0) load(nxt, step - 1);
    int v[kScanCols];
#pragma unroll
    for (int g = 0; g < kScanCols / 4; ++g) {
      v[4 * g] = cur[g].x;
      v[4 * g + 1] = cur[g].y;
      v[4 * g + 2] = cur[g].z;
      v[4 * g + 3] = cur[g].w;
    }
#pragma unroll
    for (int i = kScanCols - 2; i >= 0; --i) v[i] += v[i + 1];
    const int incl = warp_suffix_sum(v[0], lane);
    const int add = incl - v[0] + carry;  // the lanes to the right, the steps to the right
    carry += __shfl_sync(0xffffffffu, incl, 0);
#pragma unroll
    for (int i = 0; i < kScanCols; ++i) v[i] += add;

    const int c = step * kScanStep + lane * kScanCols;
    if constexpr (M == kWinding) {
      int* orow = static_cast<int*>(out) + (size_t)r * W;
      if ((W & 3) == 0) {
#pragma unroll
        for (int g = 0; g < kScanCols / 4; ++g)
          if (c + 4 * g < W)
            *reinterpret_cast<int4*>(orow + c + 4 * g) =
                make_int4(v[4 * g], v[4 * g + 1], v[4 * g + 2], v[4 * g + 3]);
      } else {
#pragma unroll
        for (int i = 0; i < kScanCols; ++i)
          if (c + i < W) orow[c + i] = v[i];
      }
    } else {
      uint8_t* orow = static_cast<uint8_t*>(out) + (size_t)r * W;
      uint32_t word[kScanCols / 4];
#pragma unroll
      for (int g = 0; g < kScanCols / 4; ++g)
        word[g] = pixel<M>(v[4 * g]) | pixel<M>(v[4 * g + 1]) << 8 |
                  pixel<M>(v[4 * g + 2]) << 16 | pixel<M>(v[4 * g + 3]) << 24;
      if ((W & 15) == 0) {
        if (c < W)
          *reinterpret_cast<uint4*>(orow + c) = make_uint4(word[0], word[1], word[2], word[3]);
      } else if ((W & 3) == 0) {
#pragma unroll
        for (int g = 0; g < kScanCols / 4; ++g)
          if (c + 4 * g < W) *reinterpret_cast<uint32_t*>(orow + c + 4 * g) = word[g];
      } else {
#pragma unroll
        for (int i = 0; i < kScanCols; ++i)
          if (c + i < W) orow[c + i] = (uint8_t)(word[i / 4] >> (8 * (i % 4)));
      }
    }
#pragma unroll
    for (int g = 0; g < kScanCols / 4; ++g) cur[g] = nxt[g];
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

// page_msaa()'s steps 1-3: zeroes the buckets, takes the chunk hulls and
// solves the lattice.
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
// chunk, tile_w, x_cull: the reference's route for the width (page_ref.route;
// chunk 16 or 32); (ox, oy): the sample offset; stride >= W, a multiple of
// 4; scratch: int32 [out_h * stride + kCounters + 16 * S], the buckets
// [out_h][stride], kCounters counters and S LongSegment records; out:
// [out_h][W], int32 for mode 0, uint8 for modes 1 (fill) and 2 (gray).
extern "C" cudaError_t page(const float* seg, const int* owner, const float* offsets,
                            int S, int N, float s_px, int top, int out_h, int W, int mode,
                            int chunk, int tile_w, int x_cull, float ox, float oy,
                            int stride, int* scratch, void* out, cudaStream_t stream) {
  if (S < 0 || N < 0 || out_h < 0 || W < 0 || mode < kWinding || mode > kGray ||
      !(s_px > 0.0f) || bad_route(chunk, tile_w, W) || (32 % chunk) != 0 || stride < W ||
      stride % 4 != 0)
    return cudaErrorInvalidValue;
  if (out_h == 0 || W == 0) return cudaSuccess;
  const size_t cells = (size_t)out_h * stride;
  int* counters = scratch + cells;
  cudaError_t err =
      cudaMemsetAsync(scratch, 0, (cells + kCounters) * sizeof(int), stream);
  if (err != cudaSuccess) return err;
  if (S > 0) {
    LongSegment* longs = reinterpret_cast<LongSegment*>(counters + kCounters);
    const long long warps = ((long long)S + 31) / 32;
    page_segments<<<(unsigned)((warps + kSegmentWarps - 1) / kSegmentWarps), kSegmentWarps * 32, 0,
                    stream>>>(seg, owner, offsets, S, N, s_px, top, out_h, W, stride, chunk,
                              tile_w, x_cull, ox, oy, scratch, counters, longs);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    // enough warps for a row block of every segment, at most eight blocks an SM
    const long long items = (long long)S * ((out_h + 31) / 32);
    const long long blocks = (items + kWarps - 1) / kWarps;
    page_long<<<(unsigned)(blocks < kMaxSolveBlocks ? blocks : kMaxSolveBlocks), kThreads, 0,
                stream>>>(longs, counters, top, W, stride, tile_w, x_cull, ox, oy, scratch);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  const unsigned blocks = (unsigned)((out_h + kWarps - 1) / kWarps);
  if (mode == kWinding)
    page_rows_scan<kWinding><<<blocks, kThreads, 0, stream>>>(scratch, out_h, W, stride, out);
  else if (mode == kFill)
    page_rows_scan<kFill><<<blocks, kThreads, 0, stream>>>(scratch, out_h, W, stride, out);
  else
    page_rows_scan<kGray><<<blocks, kThreads, 0, stream>>>(scratch, out_h, W, stride, out);
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
