// Signed distance fields of quadratic glyph outlines, for Hopper (sm_90a).
//
// Replaces the two TPU Pallas SDF kernels:
//   K10  fontrx/kernels/sdf_pallas.py::_make_sdf_kernel (launcher
//        sdf_pallas_batch; also _make_sdf_scalar_kernel, its scalar-segment
//        variant), which culls whole segment chunks against flat row spans;
//   K11  fontrx/kernels/sdf_pallas.py::_make_sdf_tiled_kernel (launcher
//        sdf_pallas_tiled_batch), which reads per-tile segment lists packed
//        on the host (pack_sdf_tiles).
// Both compute one function, K10's float program; they differ only in which
// (segment, pixel) pairs they skip. For every pixel, at em-space
//   px = (float)(min_x + c) / scale,  py = (float)(max_y - r) / scale,
// d2 is the least, over the live segments, of dist_sq(0), dist_sq(1) and
// dist_sq(refine(t0)) for the three start values t0 = f32((2s + 1) / 6),
// with refine = three clamped Newton steps on the stationary cubic (the TPU
// kernel's defaults, sdf_pallas.py:42-43), in the association of
// sdf_pallas.py:123-162. Then
//   out = (winding != 0 ? 1 : -1) * min(sqrtf(d2) * scale, spread).
// An all-zero segment is padding and is skipped (distance inf).
//
// The cull: a segment is skipped for a box of pixels when the box distance
// between its control hull and the box of the pixels' sample points exceeds
// spread + 1 px, K11's rule, in float64 as K11's host pack computes it. The
// curve lies inside its hull, so a skipped pair's distance exceeds spread
// and clamps; min commutes; every kept pair runs the same float program. So
// the result equals the plain version's, which culls nothing, bit for bit,
// for any box that holds the sample points of its pixels. The TPU's
// partition knobs (128-lane tiles, flat mode, segment chunks, sublane
// groups, sorted tiles, the host stream) are not carried over.
//
// What bounds it on an H100: instruction issue. Every kept (segment, pixel)
// pair runs a program with no data-dependent branch: about 180 FP32
// operations (bound.py counts the least of them, SDF_PAIR_OPS), nine of them
// correctly rounded divides of about ten instructions each; the first port
// issued ~350 instructions a pair. Bytes (24 B a segment, 4 B a pixel in and
// out) set a far lower floor. So the design cuts the pairs and the time a
// pair takes:
//   1. One warp per (glyph, kBoxH x kBoxW = 8 x 4 box of pixels), a pixel a
//      lane, kWarps warps a block, each on its own box.
//   2. The warp walks the glyph's segments 32 at a time, a lane each: the
//      lane tests its segment's hull against the warp's box, clipped to the
//      raster, and writes a near segment's terms to shared memory: what
//      depends on the segment alone or on it and a constant t (below). The
//      warp walks the set bits of the ballot: a warp-uniform skip. So the
//      Newton program runs only where the warp's 32 pixels lie near the
//      segment: 1.6-1.7x the pairs the function needs on the CJK atlases,
//      against 2.5-2.8x near a 16 x 16 tile (bound.sdf_kept_pairs counts
//      them). A warp waits on no other: a draft that compacted a 16 x 16
//      tile's segments for four such warps and culled again per warp left
//      its warps standing at the block's barriers.
//   3. A lane reads a near segment's terms with six 16-byte shared-memory
//      broadcasts. Each '/' keeps its slow path behind a branch that the
//      compiler schedules nothing across, so a thread runs one chain at a
//      time and the warps of an SM hide each other's latency: kWarps and
//      kMinBlocks set how many there are. Two pixels a lane, sharing the
//      terms and the row's products, measured slower on the CJK atlases,
//      where the time is (PERF.md, §6).
//   4. It reads its pixel's winding (from winding.cu) and writes the signed,
//      clamped distance.
// Folded into the segment's terms, each bit for bit the same for every
// float32 input: 0 * ax, 0 * bx2, 0 * ay and 0 * by2 of dist_sq(0) (t = 0,
// so 2t = t * t = +0: the products stay, since 0 * inf is NaN); 2 ax and
// 2 ay of dist_sq(1) (2t = 2, and 1 * bx2 is bx2); and per start t0 the
// first Newton step's (k3 t0 + k2) t0 and (3k3 t0 + 2k2) t0, so
// f = ((k3 t0 + k2) t0 + k1b) t0 + qa and df = (3k3 t0 + 2k2) t0 + k1b keep
// their association. bound.SDF_CULL_BOX is the warp's box, (kBoxH, kBoxW).
//
// Float rules: built with -fmad=false and without fast math, so no
// multiply-add is contracted and '/' and sqrtf round correctly. min and the
// [0, 1] clamp propagate NaN, as torch.minimum/torch.clamp and
// jnp.minimum/jnp.clip do (fminf/fmaxf would drop it); with finite segments
// no NaN arises.

#include <cuda_runtime.h>

namespace {

constexpr int kBoxW = 4;                   // a warp's box: kBoxH x kBoxW pixels, a pixel a lane
constexpr int kBoxH = 32 / kBoxW;
constexpr int kWarps = 4;                  // warps a block, each on a box of its own
constexpr int kThreads = 32 * kWarps;
constexpr int kMinBlocks = 8;              // blocks an SM (__launch_bounds__)
constexpr int kStarts = 3;                 // Newton starts and steps, sdf_pallas.py:42-43
constexpr int kIters = 3;
constexpr double kGuardPx = 1.0;           // K11's guard_px, sdf_pallas.py:350

// A near segment's terms, six float4s in shared memory:
//   [0] p0x, p0y, ax, ay      [1] bx2, by2, k1, k3      [2] k2, 3 k3, 2 k2, 2 ax
//   [3] 2 ay, 0 ax, 0 bx2, 0 ay                         [4] 0 by2, c0, d0, c1
//   [5] d1, c2, d2, -
// with cs = (k3 ts + k2) ts and ds = (3 k3 ts + 2 k2) ts at start value ts.
constexpr int kRec = 6;

__device__ __forceinline__ float min_nan(float a, float b) {
  return (a < b || a != a) ? a : b;
}

__device__ __forceinline__ float max_nan(float a, float b) {
  return (a > b || a != a) ? a : b;
}

__device__ __forceinline__ double max_nan(double a, double b) {
  return (a > b || a != a) ? a : b;
}

__device__ __forceinline__ float clamp01_nan(float x) {
  return x < 0.0f ? 0.0f : (x > 1.0f ? 1.0f : x);
}

// the Python float (2s + 1) / 6 rounded to float32 (sdf_pallas.py:154)
__device__ __forceinline__ float start_value(int si) {
  return (float)((double)(2 * si + 1) / (double)(2 * kStarts));
}

// Box distance between a hull (float4: x_min, x_max, y_min, y_max) and a
// pixel box, in float64 as pack_sdf_tiles computes it (sdf_pallas.py:
// 408-426): kept unless provably farther than the margin. A NaN coordinate
// keeps the segment.
__device__ __forceinline__ bool near_box(float4 h, double bx0, double bx1, double by0,
                                         double by1, double margin_sq) {
  const double dx = max_nan(max_nan((double)h.x - bx1, bx0 - (double)h.y), 0.0);
  const double dy = max_nan(max_nan((double)h.z - by1, by0 - (double)h.w), 0.0);
  return !(dx * dx + dy * dy > margin_sq);
}

// A near segment's terms, from its six float4s in shared memory.
struct Terms {
  float p0x, p0y, ax, ay, bx2, by2, k1, k3, k2, k3x3, k2x2, ax2, ay2, zax, zbx, zay, zby;
  float cs[kStarts], ds[kStarts];

  __device__ __forceinline__ explicit Terms(const float4* q) {
    const float4 q1 = q[0], q2 = q[1], q3 = q[2], q4 = q[3], q5 = q[4], q6 = q[5];
    p0x = q1.x; p0y = q1.y; ax = q1.z; ay = q1.w;
    bx2 = q2.x; by2 = q2.y; k1 = q2.z; k3 = q2.w;
    k2 = q3.x; k3x3 = q3.y; k2x2 = q3.z; ax2 = q3.w;
    ay2 = q4.x; zax = q4.y; zbx = q4.z; zay = q4.w;
    zby = q5.x;
    cs[0] = q5.y; ds[0] = q5.z; cs[1] = q5.w; ds[1] = q6.x; cs[2] = q6.y; ds[2] = q6.z;
  }
};

// The Newton program of one near segment at the sample point (px, py): the
// least d2 over dist_sq(0), dist_sq(1) and the three refined starts.
__device__ __forceinline__ float pixel_best(const Terms& T, float px, float py) {
  const float qx = T.p0x - px;
  const float qy = T.p0y - py;
  const float qa = qx * T.ax + qy * T.ay;
  const float qb = qx * T.bx2 + qy * T.by2;
  const float k1b = T.k1 + qb;
  const float dx0 = qx + T.zax + T.zbx;
  const float dy0 = qy + T.zay + T.zby;
  const float dx1 = qx + T.ax2 + T.bx2;
  const float dy1 = qy + T.ay2 + T.by2;
  float b = dx0 * dx0 + dy0 * dy0;               // dist_sq(0)
  b = min_nan(b, dx1 * dx1 + dy1 * dy1);         // dist_sq(1)
#pragma unroll
  for (int si = 0; si < kStarts; ++si) {
    const float t0 = start_value(si);
    float f = (T.cs[si] + k1b) * t0 + qa;
    float df = T.ds[si] + k1b;
    if (df == 0.0f) df = 1.0f;
    float t = clamp01_nan(t0 - f / df);
#pragma unroll
    for (int it = 1; it < kIters; ++it) {
      f = ((T.k3 * t + T.k2) * t + k1b) * t + qa;
      df = (T.k3x3 * t + T.k2x2) * t + k1b;
      if (df == 0.0f) df = 1.0f;
      t = clamp01_nan(t - f / df);
    }
    const float t2 = 2.0f * t;
    const float tt = t * t;
    const float dx = qx + t2 * T.ax + tt * T.bx2;
    const float dy = qy + t2 * T.ay + tt * T.by2;
    b = min_nan(b, dx * dx + dy * dy);           // dist_sq(t)
  }
  return b;
}

__global__ void __launch_bounds__(kThreads, kMinBlocks)
sdf_kernel(const float* __restrict__ seg, const int* __restrict__ min_x,
           const int* __restrict__ max_y, const int* __restrict__ winding,
           float scale, float spread, int B, int S, int H, int W, int boxes_x, int boxes,
           float* __restrict__ out) {
  __shared__ float4 recs[kWarps][32][kRec];

  const long long unit = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (unit >= (long long)B * boxes) return;  // the whole warp leaves together
  float4 (*rec)[kRec] = recs[threadIdx.x >> 5];
  const int b = (int)(unit / boxes);
  const int box = (int)(unit % boxes);
  const int lane = threadIdx.x & 31;
  const int c0 = (box % boxes_x) * kBoxW;
  const int r0 = (box / boxes_x) * kBoxH;
  const int mx = min_x[b];
  const int my = max_y[b];
  const double sc = (double)scale;
  const double margin = ((double)spread + kGuardPx) / sc;
  const double margin_sq = margin * margin;

  // the warp's box, clipped to the raster, in em units as pack_sdf_tiles
  // computes a tile's (sdf_pallas.py:408-426); this lane's pixel (r, c)
  const double bx0 = ((double)mx + (double)c0) / sc;
  const double bx1 = ((double)mx + (double)(min(c0 + kBoxW, W) - 1)) / sc;
  const double by1 = ((double)my - (double)r0) / sc;
  const double by0 = ((double)my - (double)(min(r0 + kBoxH, H) - 1)) / sc;
  const int r = r0 + lane / kBoxW;
  const int c = c0 + lane % kBoxW;
  const float px = (float)(mx + c) / scale;
  const float py = (float)(my - r) / scale;
  float d2 = INFINITY;

  const float* gseg = seg + (size_t)b * S * 6;
  for (int s0 = 0; s0 < S; s0 += 32) {
    // 1. a segment a lane: its hull against the warp's box; the near ones'
    //    terms to shared memory
    const int s = s0 + lane;
    float p[6];
    if (s < S) {
#pragma unroll
      for (int e = 0; e < 6; ++e) p[e] = gseg[(size_t)s * 6 + e];
    }
    const bool live = s < S && !(p[0] == 0.0f && p[1] == 0.0f && p[2] == 0.0f &&
                                 p[3] == 0.0f && p[4] == 0.0f && p[5] == 0.0f);
    bool near = false;
    if (live) {
      const float4 h = make_float4(
          min_nan(min_nan(p[0], p[2]), p[4]), max_nan(max_nan(p[0], p[2]), p[4]),
          min_nan(min_nan(p[1], p[3]), p[5]), max_nan(max_nan(p[1], p[3]), p[5]));
      near = near_box(h, bx0, bx1, by0, by1, margin_sq);
    }
    unsigned any = __ballot_sync(0xffffffffu, near);
    if (any == 0) continue;
    if (near) {
      const float p0x = p[0], p0y = p[1], p1x = p[2], p1y = p[3], p2x = p[4], p2y = p[5];
      const float ax = p1x - p0x;
      const float ay = p1y - p0y;
      const float bx2 = p0x - 2.0f * p1x + p2x;
      const float by2 = p0y - 2.0f * p1y + p2y;
      const float k3 = bx2 * bx2 + by2 * by2;
      const float k2 = 3.0f * (ax * bx2 + ay * by2);
      const float k1 = 2.0f * (ax * ax + ay * ay);
      const float k3x3 = 3.0f * k3;
      const float k2x2 = 2.0f * k2;
      float cs[kStarts], ds[kStarts];
#pragma unroll
      for (int si = 0; si < kStarts; ++si) {
        const float t0 = start_value(si);
        cs[si] = (k3 * t0 + k2) * t0;
        ds[si] = (k3x3 * t0 + k2x2) * t0;
      }
      float4* q = rec[lane];
      q[0] = make_float4(p0x, p0y, ax, ay);
      q[1] = make_float4(bx2, by2, k1, k3);
      q[2] = make_float4(k2, k3x3, k2x2, 2.0f * ax);
      q[3] = make_float4(2.0f * ay, 0.0f * ax, 0.0f * bx2, 0.0f * ay);
      q[4] = make_float4(0.0f * by2, cs[0], ds[0], cs[1]);
      q[5] = make_float4(ds[1], cs[2], ds[2], 0.0f);
    }
    __syncwarp();

    // 2. the Newton program of each near segment at this lane's pixel
    for (; any != 0; any &= any - 1) {
      const Terms T(rec[__ffs(any) - 1]);
      d2 = min_nan(d2, pixel_best(T, px, py));
    }
    __syncwarp();  // the terms are consumed before the next batch
  }

  // 3. sign and clamp
  if (r < H && c < W) {
    const size_t o = ((size_t)b * H + r) * W + c;
    const float dist = min_nan(sqrtf(d2) * scale, spread);
    out[o] = (winding[o] != 0 ? 1.0f : -1.0f) * dist;
  }
}

}  // namespace

extern "C" cudaError_t sdf(const float* seg, const int* min_x, const int* max_y,
                           const int* winding, float scale, float spread, int B,
                           int S, int H, int W, float* out,
                           cudaStream_t stream) {
  if (B < 0 || S < 0 || H < 0 || W < 0 || !(scale > 0.0f) || !(spread >= 0.0f))
    return cudaErrorInvalidValue;
  if (B == 0 || H == 0 || W == 0) return cudaSuccess;

  const int boxes_x = (W + kBoxW - 1) / kBoxW;
  const int boxes_y = (H + kBoxH - 1) / kBoxH;
  const long long boxes = (long long)boxes_x * boxes_y;
  const long long blocks = (boxes * B + kWarps - 1) / kWarps;
  if (boxes > 0x7fffffffLL || blocks > 0x7fffffffLL) return cudaErrorInvalidValue;

  sdf_kernel<<<(unsigned)blocks, kThreads, 0, stream>>>(
      seg, min_x, max_y, winding, scale, spread, B, S, H, W, boxes_x, (int)boxes, out);
  return cudaGetLastError();
}
