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
// One design serves both entries, templated on the lattice (NY row offsets,
// NX column offsets, P = NY * NX bucket planes): page() is the 1 x 1 case,
// page_msaa() the 2 x 2 case. What bounded the first port of both: the scan
// walked each row one warp 32 columns at a time, right to left, a dependent
// load and a five-step shuffle scan per step and plane (60 steps a row at
// 1920 wide, 120 at 3840; K8 four planes of them), so a band cost what the
// page cost; the solve gave a whole warp to every segment, most of them off
// the page or two to five rows tall, and each warp ran the FP64 transform
// and margin for one. Now a frame is four device operations:
//   1. cudaMemsetAsync zeroes the int32 buckets [out_h][P][stride], stride =
//      W rounded up to 4 (16-byte rows), and two counters after them. Cell c
//      of a row's plane p holds the crossings of sample p that cover columns
//      [0, c + 1), so column c's winding is the sum of cells c .. W - 1. A
//      row's planes lie one after another, so each of the scan's loads is a
//      warp's 512 contiguous bytes of one plane (interleaving a cell's four
//      planes made the MSAA frame 1.2x slower on an H100: PERF.md).
//   2. page_segments: a warp takes 32 consecutive segments, a lane each
//      (chunk is 16 or 32, so a warp holds whole chunks). Each lane
//      transforms its segment once, the warp reduces the chunk hulls with
//      shuffles (a segment past S adds the padding point), and each lane
//      takes its x-cull (against the smallest x(0) of the lattice), its
//      column-tile window (the union over the ox), its right-edge rule per
//      ox, and for each oy its margin and rows: those within the margin of
//      its y-hull (with that oy's largest |y|), cut to the 128-row strips its
//      chunk meets at that oy (the strips met are a run, so two trims of the
//      ends find them). A (segment, oy) of more than kLightRows rows (16,
//      and 4 on the 2 x 2 lattice, whose two oy double the pairs) is
//      written to a list of long segments (an atomic per warp and oy
//      reserves the slots). The short ones' (segment, oy, row) triples are
//      flattened over the warp by a prefix over the lanes' row counts, and
//      the lanes take them 32 at a time, each finding its triple's segment
//      and oy by a binary search over the prefix in shared memory.
//   3. page_long: the long (segment, oy) records' rows, a lane a row; work
//      item g is 32-row block g / n of record g % n, so one segment's blocks
//      go to different warps. On config 5's and the 4K page's first views the
//      pairs lie almost all on such segments (a few hundred rows each: big
//      glyphs, and near-flat curves whose margin spans their strips).
//   Each (segment, row, oy) is solved once, and each crossing is deposited
//   into every ox plane: its column count k comes from that sample x's own
//   arithmetic (a guess from xx - ox, moved while the predicate says so),
//   its tile rules are the first port's, and it adds its sign to cell k - 1
//   with a global atomic.
//   4. page_rows_scan: a warp a row, right to left: each lane loads its
//      cells (16 columns of the one plane, or 4 columns of each of four) in
//      16-byte loads (the next step's loads issued before this step's
//      arithmetic), scans each plane in registers, and one warp suffix scan
//      per plane of the lane totals and the carry of the steps to the right
//      finish them (4 steps a row at 1920 wide, 8 at 3840; the MSAA page 15
//      and 30). It writes the int32 winding, the fill, the gray or the MSAA
//      pixel as 16- or 4-byte words where the row's width allows, else
//      narrower.
// The wrapper counts one launch a frame of each entry.
//
// What bounds it on an H100 (PERF.md): bytes that the design adds, the
// memset and the scan of the dense int32 buckets: page() 8.3 MB written and
// read at config 5, 33 MB at 4K; page_msaa() four planes, 33 MB written and
// 33 MB read at config 5 and 133 + 133 MB at 4K, most of the MSAA frame.
// On page()'s config 5 frame the two solve passes' latency (a few hundred
// warps, each lane's FP64 transform and margin, then its crossings) and the
// four operations back to back. The buckets stay int32: a packed int16 cell
// could overflow on a zoomed-out page, and the page must be exact. A sparse
// bucket is later work.
//
// Device memory: the em-space stream, the owners and the offsets (read),
// the buckets (4 B per plane and pixel, zeroed every frame), the counters
// and the long-segment records (64 B per segment and oy) and the output (1 B
// a pixel, 4 for the winding). Bytes of the bound are the em-space stream,
// the offsets and the output (fontrx_torch/bound.py: page_work, page_bytes,
// page_msaa_work, page_msaa_bytes); the memset and the scan's read of the
// buckets are the design's own.
//
// The row cull's margin (segment_margin) and its proof are in
// crossings.cuh.
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
constexpr int kStripRows = 128;
constexpr int kWindowRows = 16;
constexpr float kPadPoint = -1e7f;  // page_ref.PAD_POINT
constexpr int kSegmentWarps = 4;   // page_segments: warps a block, 32 segments each

enum Mode { kWinding = 0, kFill = 1, kGray = 2, kMsaa = 3 };

// the sample lattice of one call: NY row offsets, NX column offsets; plane
// iy * NX + ix of a bucket row holds sample (ox[ix], oy[iy])
template <int NY, int NX>
struct Lattice {
  float oy[NY];
  float ox[NX];
};

// lat.oy[iy] without indexing the parameter by a register
template <int NY, int NX>
__device__ __forceinline__ float oy_of(const Lattice<NY, NX>& lat, int iy) {
  float oy = lat.oy[0];
#pragma unroll
  for (int i = 1; i < NY; ++i)
    if (iy == i) oy = lat.oy[i];
  return oy;
}

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

// A (segment, oy) that page_segments leaves to page_long: the segment in page
// pixels, its chunk's hull y-range and column tiles, its first row and row
// count at that oy, which ox count a crossing right of the padded width
// (bit ix), and the oy's index.
struct alignas(16) LongSegment {
  float q[6];
  float y_min, y_max, t_lo, t_hi;
  int r0, count, right, iy;
};
static_assert(sizeof(LongSegment) == 16 * sizeof(int), "kernels/page.py sizes the records");
// page_segments solves a (segment, oy) of at most this many rows; page_long
// takes the longer. Four for the 2 x 2 lattice: its two oy double a warp's
// flattened pairs, and the narrow page's frame fell from 0.022 to 0.017 ms
// with it on an H100 (PERF.md).
template <int NY>
constexpr int kLightRows = NY == 1 ? 16 : 4;
constexpr int kCounters = 4;    // after the buckets: long records, their most rows, 2 spare

// The crossings of segment q on row r at sample row offset oy (index iy),
// deposited into each ox plane with the chunk rules of its hull (y_min,
// y_max), column tiles [t_lo, t_hi] and right-edge rule (bit ix of right).
template <int NY, int NX>
__device__ __forceinline__ void solve_row(const float* q, float y_min, float y_max, float t_lo,
                                          float t_hi, int right, int r, int iy, int top,
                                          const Lattice<NY, NX>& lat, int W, int pw, int tile_w,
                                          int x_cull, int* __restrict__ bucket, int stride) {
  constexpr int P = NY * NX;
  const float oy = oy_of(lat, iy);
  const int w0 = r / kWindowRows * kWindowRows;
  const bool window =
      meets(y_min, y_max, row_y(top, w0, oy), row_y(top, w0 + kWindowRows - 1, oy));
  int* brow = bucket + ((size_t)r * P + iy * NX) * stride;
  segment_crossings(q, row_y(top, r, oy), [&](float xx, int sign) {
#pragma unroll
    for (int ix = 0; ix < NX; ++ix) {
      const float ox = lat.ox[ix];
      int k;
      if (xx >= (float)pw + ox) {
        if (!((right >> ix) & 1)) continue;
        k = W;
      } else {
        k = covered_at(xx, ox, pw);
        if (k == 0) continue;
        const int t = (k - 1) / tile_w;
        if (x_cull && !((float)t >= t_lo && (float)t <= t_hi)) continue;
        if (!window) k = t * tile_w;
        k = min(k, W);
      }
      if (k > 0) atomicAdd(&brow[(size_t)ix * stride + k - 1], sign);
    }
  });
}

// Step 2: a warp's 32 segments, a lane each; see the note at the top.
template <int NY, int NX>
__global__ void __launch_bounds__(kSegmentWarps * 32)
page_segments(const float* __restrict__ seg, const int* __restrict__ owner,
              const float* __restrict__ offsets, int S, int N, float s_px, int top, int out_h,
              int W, int stride, int chunk, int tile_w, int x_cull, Lattice<NY, NX> lat,
              int* __restrict__ bucket, int* __restrict__ counters,
              LongSegment* __restrict__ longs) {
  __shared__ float s_q[kSegmentWarps][6][32];
  __shared__ float4 s_h[kSegmentWarps][32];  // hull y_min, y_max; column tiles t_lo, t_hi
  __shared__ int s_right[kSegmentWarps][32];
  // per (oy, lane) unit u = iy * 32 + lane: its first row and first pair
  __shared__ int s_r0[kSegmentWarps][NY * 32];
  __shared__ int s_off[kSegmentWarps][NY * 32];
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const int s = (blockIdx.x * kSegmentWarps + w) * 32 + lane;
  if (s - lane >= S) return;  // the whole warp leaves together
  const int pw = (W + 127) / 128 * 128;

  // the segment in page pixels, and its chunk's hull (a segment past S is
  // the padding point)
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

  // the chunk's column tiles (winding_page.py:225-236), their union over the
  // ox (:480-505), the right-edge rule per ox and the x-cull against the
  // smallest x(0)
  const float g_lo = h.z - 1.0f, g_hi = h.w + 1.0f;
  float px_lo = g_lo - lat.ox[0], px_hi = g_hi - lat.ox[0];
  float x_first = 0.0f + lat.ox[0];
  int right = 0;
#pragma unroll
  for (int ix = 0; ix < NX; ++ix) {
    px_lo = fminf(px_lo, g_lo - lat.ox[ix]);
    px_hi = fmaxf(px_hi, g_hi - lat.ox[ix]);
    x_first = fminf(x_first, 0.0f + lat.ox[ix]);
    if (!x_cull || g_hi >= (float)pw + lat.ox[ix]) right |= 1 << ix;
  }
  const float t_lo = floorf((px_lo - 2.0f) / (float)tile_w);
  const float t_hi = floorf((px_hi + 2.0f) / (float)tile_w);
  const bool solved = live && !(x_cull && !(g_hi >= x_first));
  const float hmin = fminf(fminf(q[1], q[3]), q[5]);
  const float hmax = fmaxf(fmaxf(q[1], q[3]), q[5]);
  const float a = q[1] - 2.0f * q[3] + q[5];

  int first_row[NY], first_pair[NY];  // this lane's (oy, lane) units
  int incl_prev = 0;  // pairs of the (oy, lane) units before this oy's
#pragma unroll
  for (int iy = 0; iy < NY; ++iy) {
    const float oy = lat.oy[iy];
    // the rows within the margin of its y-hull, on the strips its chunk meets
    int r0 = 0, r1 = -1;
    if (solved) {
      const double ymax = fmax(fabs((double)row_y(top, 0, oy)),
                               fabs((double)row_y(top, out_h - 1, oy)));
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

    // a long one goes to page_long, whose lanes take a row each
    const bool is_long = count > kLightRows<NY>;
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
        ls.right = right;
        ls.iy = iy;
      }
    }

    // the short ones' (segment, row) pairs at this oy, after those of the
    // earlier oy: an inclusive prefix over the lanes' rows
    const int rows = is_long ? 0 : count;
    int incl = rows;
    for (int off = 1; off < 32; off <<= 1) {
      const int t = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl += t;
    }
    first_row[iy] = r0;
    first_pair[iy] = incl_prev + incl - rows;
    incl_prev += __shfl_sync(0xffffffffu, incl, 31);
  }
  const int total = incl_prev;
  if (total == 0) return;
#pragma unroll
  for (int iy = 0; iy < NY; ++iy) {
    s_r0[w][iy * 32 + lane] = first_row[iy];
    s_off[w][iy * 32 + lane] = first_pair[iy];
  }
#pragma unroll
  for (int i = 0; i < 6; ++i) s_q[w][i][lane] = q[i];
  s_h[w][lane] = make_float4(h.x, h.y, t_lo, t_hi);
  s_right[w][lane] = right;
  __syncwarp();

  for (int j = lane; j < total; j += 32) {
    // the pair's (oy, lane) unit: the last whose first pair is at or before j
    int u = 0;
#pragma unroll
    for (int step = 16 * NY; step > 0; step >>= 1)
      if (s_off[w][u + step] <= j) u += step;
    const int o = u & 31;
    float qo[6];
#pragma unroll
    for (int i = 0; i < 6; ++i) qo[i] = s_q[w][i][o];
    const float4 ho = s_h[w][o];
    solve_row(qo, ho.x, ho.y, ho.z, ho.w, s_right[w][o], s_r0[w][u] + (j - s_off[w][u]),
              NY == 1 ? 0 : u >> 5, top, lat, W, pw, tile_w, x_cull, bucket, stride);
  }
}

// Step 3: the long records' rows, a lane a row. Work item g is row block
// g / n (32 rows) of record g % n, so the blocks of one segment go to
// different warps; a warp strides over the items.
template <int NY, int NX>
__global__ void __launch_bounds__(kThreads)
page_long(const LongSegment* __restrict__ longs, const int* __restrict__ counters, int top,
          int W, int stride, int tile_w, int x_cull, Lattice<NY, NX> lat,
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
      solve_row(ls.q, ls.y_min, ls.y_max, ls.t_lo, ls.t_hi, ls.right, ls.r0 + row,
                NY == 1 ? 0 : ls.iy, top, lat, W, pw, tile_w, x_cull, bucket, stride);
  }
}

// page_rows_scan's output byte of a winding w (fill, gray)
template <int M>
__device__ __forceinline__ uint32_t pixel(int w) {
  if constexpr (M == kFill) return w != 0 ? 255u : 0u;
  return (uint32_t)min(max(w * 20 + 100, 0), 255);
}

// Step 4: a warp a row, right to left, 32 * kCols columns a step; see the
// note at the top. The cells of a row past W are zero. P planes a cell: one
// for the winding, fill and gray, four for the MSAA pixel, (count * 255) / 4
// of the planes' nonzero windings, as the reference's uint16 sum of 0/255
// fills floor-divided by 4 (page.py:490).
template <int M, int P>
__global__ void __launch_bounds__(kThreads)
page_rows_scan(const int* __restrict__ bucket, int out_h, int W, int stride,
               void* __restrict__ out) {
  static_assert((M == kMsaa) == (P == 4) && (P == 1 || P == 4), "a mode's planes");
  constexpr int kCols = P == 1 ? 16 : 4;  // columns a lane holds a step
  constexpr int kInts = kCols * P;
  constexpr int kVecs = kInts / 4;
  constexpr int kStep = 32 * kCols;
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (r >= out_h) return;
  const int* row = bucket + (size_t)r * stride * P;
  const int steps = (W + kStep - 1) / kStep;
  int4 cur[kVecs], nxt[kVecs];
  auto load = [&](int4* v, int step) {
    const int c = step * kStep + lane * kCols;
    // plane p's cells c .. c + kCols - 1: v[p * kCols / 4 + g]
#pragma unroll
    for (int p = 0; p < P; ++p)
#pragma unroll
      for (int g = 0; g < kCols / 4; ++g)
        v[p * (kCols / 4) + g] =
            c + 4 * g < W ? *reinterpret_cast<const int4*>(row + (size_t)p * stride + c + 4 * g)
                          : make_int4(0, 0, 0, 0);
  };
  load(cur, steps - 1);
  int carry[P] = {};
  for (int step = steps - 1; step >= 0; --step) {
    if (step > 0) load(nxt, step - 1);
    int v[kInts];  // v[i * P + p]: column i of the lane's, plane p
#pragma unroll
    for (int p = 0; p < P; ++p)
#pragma unroll
      for (int g = 0; g < kCols / 4; ++g) {
        const int4 t = cur[p * (kCols / 4) + g];
        v[(4 * g) * P + p] = t.x;
        v[(4 * g + 1) * P + p] = t.y;
        v[(4 * g + 2) * P + p] = t.z;
        v[(4 * g + 3) * P + p] = t.w;
      }
#pragma unroll
    for (int i = kCols - 2; i >= 0; --i)
#pragma unroll
      for (int p = 0; p < P; ++p) v[i * P + p] += v[(i + 1) * P + p];
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const int incl = warp_suffix_sum(v[p], lane);
      const int add = incl - v[p] + carry[p];  // the lanes to the right, the steps to the right
      carry[p] += __shfl_sync(0xffffffffu, incl, 0);
#pragma unroll
      for (int i = 0; i < kCols; ++i) v[i * P + p] += add;
    }

    const int c = step * kStep + lane * kCols;
    if constexpr (M == kWinding) {
      int* orow = static_cast<int*>(out) + (size_t)r * W;
      if ((W & 3) == 0) {
#pragma unroll
        for (int g = 0; g < kCols / 4; ++g)
          if (c + 4 * g < W)
            *reinterpret_cast<int4*>(orow + c + 4 * g) =
                make_int4(v[4 * g], v[4 * g + 1], v[4 * g + 2], v[4 * g + 3]);
      } else {
#pragma unroll
        for (int i = 0; i < kCols; ++i)
          if (c + i < W) orow[c + i] = v[i];
      }
    } else {
      uint8_t* orow = static_cast<uint8_t*>(out) + (size_t)r * W;
      uint32_t word[kCols / 4];
#pragma unroll
      for (int g = 0; g < kCols / 4; ++g) {
        word[g] = 0;
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          uint32_t px;
          if constexpr (M == kMsaa) {
            int count = 0;
#pragma unroll
            for (int p = 0; p < P; ++p) count += v[(4 * g + b) * P + p] != 0;
            px = (uint32_t)((count * 255) >> 2);
          } else {
            px = pixel<M>(v[4 * g + b]);
          }
          word[g] |= px << (8 * b);
        }
      }
      if ((W & (kCols - 1)) == 0) {
        if (c < W) {
          if constexpr (kCols == 16)
            *reinterpret_cast<uint4*>(orow + c) = make_uint4(word[0], word[1], word[2], word[3]);
          else if constexpr (kCols == 8)
            *reinterpret_cast<uint2*>(orow + c) = make_uint2(word[0], word[1]);
          else
            *reinterpret_cast<uint32_t*>(orow + c) = word[0];
        }
      } else if ((W & 3) == 0) {
#pragma unroll
        for (int g = 0; g < kCols / 4; ++g)
          if (c + 4 * g < W) *reinterpret_cast<uint32_t*>(orow + c + 4 * g) = word[g];
      } else {
#pragma unroll
        for (int i = 0; i < kCols; ++i)
          if (c + i < W) orow[c + i] = (uint8_t)(word[i / 4] >> (8 * (i % 4)));
      }
    }
#pragma unroll
    for (int g = 0; g < kVecs; ++g) cur[g] = nxt[g];
  }
}

// A frame of either entry: steps 1-4 on the lattice. scratch: the buckets
// [out_h][P][stride], kCounters counters, NY * S LongSegment records.
template <int M, int NY, int NX>
cudaError_t render(const float* seg, const int* owner, const float* offsets, int S, int N,
                   float s_px, int top, int out_h, int W, int chunk, int tile_w, int x_cull,
                   const Lattice<NY, NX>& lat, int stride, int* scratch, void* out,
                   cudaStream_t stream) {
  constexpr int P = NY * NX;
  const size_t cells = (size_t)out_h * stride * P;
  int* counters = scratch + cells;
  cudaError_t err = cudaMemsetAsync(scratch, 0, (cells + kCounters) * sizeof(int), stream);
  if (err != cudaSuccess) return err;
  if (S > 0) {
    LongSegment* longs = reinterpret_cast<LongSegment*>(counters + kCounters);
    const long long warps = ((long long)S + 31) / 32;
    page_segments<NY, NX><<<(unsigned)((warps + kSegmentWarps - 1) / kSegmentWarps),
                            kSegmentWarps * 32, 0, stream>>>(
        seg, owner, offsets, S, N, s_px, top, out_h, W, stride, chunk, tile_w, x_cull, lat,
        scratch, counters, longs);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    // enough warps for a row block of every record, at most eight blocks an SM
    const long long items = (long long)S * NY * ((out_h + 31) / 32);
    const long long blocks = (items + kWarps - 1) / kWarps;
    page_long<NY, NX><<<(unsigned)(blocks < kMaxSolveBlocks ? blocks : kMaxSolveBlocks),
                        kThreads, 0, stream>>>(longs, counters, top, W, stride, tile_w, x_cull,
                                               lat, scratch);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  page_rows_scan<M, P><<<(unsigned)((out_h + kWarps - 1) / kWarps), kThreads, 0, stream>>>(
      scratch, out_h, W, stride, out);
  return cudaGetLastError();
}

bool bad_args(int S, int N, int out_h, int W, float s_px, int chunk, int tile_w, int stride) {
  const int pw = (W + 127) / 128 * 128;
  return S < 0 || N < 0 || out_h < 0 || W < 0 || !(s_px > 0.0f) || chunk < 1 || chunk > 32 ||
         (32 % chunk) != 0 || tile_w < 1 || pw % tile_w != 0 || stride < W || stride % 4 != 0;
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
  if (bad_args(S, N, out_h, W, s_px, chunk, tile_w, stride) || mode < kWinding || mode > kGray)
    return cudaErrorInvalidValue;
  if (out_h == 0 || W == 0) return cudaSuccess;
  const Lattice<1, 1> lat = {{oy}, {ox}};
  if (mode == kWinding)
    return render<kWinding>(seg, owner, offsets, S, N, s_px, top, out_h, W, chunk, tile_w,
                            x_cull, lat, stride, scratch, out, stream);
  if (mode == kFill)
    return render<kFill>(seg, owner, offsets, S, N, s_px, top, out_h, W, chunk, tile_w, x_cull,
                         lat, stride, scratch, out, stream);
  return render<kGray>(seg, owner, offsets, S, N, s_px, top, out_h, W, chunk, tile_w, x_cull,
                       lat, stride, scratch, out, stream);
}

// The 2 x 2 MSAA page of H rows: samples (ox0|ox1, oy0|oy1); scratch: int32
// [H * stride * 4 + kCounters + 32 * S], the buckets [H][4][stride] (plane
// iy * 2 + ix), kCounters counters and 2 S LongSegment records (one per
// segment and oy); out: uint8 [H][W]. Other arguments as page()'s.
extern "C" cudaError_t page_msaa(const float* seg, const int* owner, const float* offsets,
                                 int S, int N, float s_px, int H, int W, int chunk,
                                 int tile_w, int x_cull, float ox0, float ox1, float oy0,
                                 float oy1, int stride, int* scratch, uint8_t* out,
                                 cudaStream_t stream) {
  if (bad_args(S, N, H, W, s_px, chunk, tile_w, stride)) return cudaErrorInvalidValue;
  if (H == 0 || W == 0) return cudaSuccess;
  const Lattice<2, 2> lat = {{oy0, oy1}, {ox0, ox1}};
  return render<kMsaa>(seg, owner, offsets, S, N, s_px, H - 1, H, W, chunk, tile_w, x_cull,
                       lat, stride, scratch, out, stream);
}
