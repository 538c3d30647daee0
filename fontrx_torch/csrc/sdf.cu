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
// The cull: a segment is skipped for a tile when the box distance between
// its control hull and the tile's pixel box exceeds spread + 1 px, K11's
// rule, in float64 as K11's host pack computes it. The curve lies inside its
// hull, so a skipped pair's distance exceeds spread and clamps; min
// commutes; every kept pair runs the same float program. So the result
// equals the plain version's, which culls nothing, bit for bit. The TPU's
// partition knobs (128-lane tiles, flat mode, segment chunks, sublane
// groups, sorted tiles, the host stream) are not carried over.
//
// Design: one block per (glyph, 16 x 16 pixel tile), one thread per pixel.
//   1. 256 segments at a time: each thread loads one, tests it against the
//      tile box, and a warp ballot plus a prefix over the warps packs the
//      kept ones' constants (ax, bx2, k3, k2, k1, ...) into shared memory.
//   2. Every thread runs the Newton program over the kept list, reading the
//      constants as shared-memory broadcasts, and keeps a running min of d2
//      in a register.
//   3. It reads its pixel's winding (from winding.cu) and writes the signed,
//      clamped distance.
//
// Where its time goes on an H100: FP32 arithmetic, about 214 operations per
// kept (segment, pixel) pair, nine of them correctly rounded divides. Bytes
// (24 B a segment, 4 B a pixel in and out) set a far lower floor. The design
// therefore skips every pair the band rule allows at 16 x 16 granularity and
// keeps the per-segment terms out of the per-pixel loop. Register tiling
// (several pixels a thread), a finer cull, folding the constant-t terms and
// TMA staging are left for later.
//
// Float rules: built with -fmad=false and without fast math, so no
// multiply-add is contracted and '/' and sqrtf round correctly. min and the
// [0, 1] clamp propagate NaN, as torch.minimum/torch.clamp and
// jnp.minimum/jnp.clip do (fminf/fmaxf would drop it); with finite segments
// no NaN arises.

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 16;                  // a block's tile is kTile x kTile pixels
constexpr int kThreads = kTile * kTile;    // one thread per pixel
constexpr int kWarps = kThreads / 32;
constexpr int kStarts = 3;                 // Newton starts and steps, sdf_pallas.py:42-43
constexpr int kIters = 3;
constexpr double kGuardPx = 1.0;           // K11's guard_px, sdf_pallas.py:350

// the kept segments' terms, one row each in shared memory
enum { P0X, P0Y, AX, AY, BX2, BY2, K3, K2, K1, K3X3, K2X2, kTerms };

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

struct Pair {
  float qx, qy, ax, ay, bx2, by2;

  __device__ __forceinline__ float dist_sq(float t) const {
    const float t2 = 2.0f * t;
    const float tt = t * t;
    const float dx = qx + t2 * ax + tt * bx2;
    const float dy = qy + t2 * ay + tt * by2;
    return dx * dx + dy * dy;
  }
};

__global__ void __launch_bounds__(kThreads)
sdf_kernel(const float* __restrict__ seg, const int* __restrict__ min_x,
           const int* __restrict__ max_y, const int* __restrict__ winding,
           float scale, float spread, int S, int H, int W, int tiles_x, int tiles,
           float* __restrict__ out) {
  __shared__ float terms[kTerms][kThreads];
  __shared__ int warp_kept[kWarps];

  const int b = (int)(blockIdx.x / (unsigned)tiles);
  const int tile = (int)(blockIdx.x % (unsigned)tiles);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int c0 = (tile % tiles_x) * kTile;
  const int r0 = (tile / tiles_x) * kTile;
  const int c = c0 + tid % kTile;
  const int r = r0 + tid / kTile;
  const bool inside = r < H && c < W;
  const int mx = min_x[b];
  const int my = max_y[b];
  const float px = (float)(mx + c) / scale;
  const float py = (float)(my - r) / scale;

  // the tile's pixel box and the band, in em units, as pack_sdf_tiles
  // computes them (sdf_pallas.py:408-426)
  const double sc = (double)scale;
  const double bx0 = ((double)mx + (double)c0) / sc;
  const double bx1 = ((double)mx + (double)(min(c0 + kTile, W) - 1)) / sc;
  const double by1 = ((double)my - (double)r0) / sc;
  const double by0 = ((double)my - (double)(min(r0 + kTile, H) - 1)) / sc;
  const double margin = ((double)spread + kGuardPx) / sc;
  const double margin_sq = margin * margin;

  float d2 = INFINITY;
  const float* gseg = seg + (size_t)b * S * 6;
  for (int s0 = 0; s0 < S; s0 += kThreads) {
    // 1. test one segment a thread, pack the kept ones' terms
    const int s = s0 + tid;
    float p[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    bool keep = false;
    if (s < S) {
#pragma unroll
      for (int k = 0; k < 6; ++k) p[k] = gseg[(size_t)s * 6 + k];
      const bool dead = p[0] == 0.0f && p[1] == 0.0f && p[2] == 0.0f &&
                        p[3] == 0.0f && p[4] == 0.0f && p[5] == 0.0f;
      const double hx0 = (double)min_nan(min_nan(p[0], p[2]), p[4]);
      const double hx1 = (double)max_nan(max_nan(p[0], p[2]), p[4]);
      const double hy0 = (double)min_nan(min_nan(p[1], p[3]), p[5]);
      const double hy1 = (double)max_nan(max_nan(p[1], p[3]), p[5]);
      const double dx = max_nan(max_nan(hx0 - bx1, bx0 - hx1), 0.0);
      const double dy = max_nan(max_nan(hy0 - by1, by0 - hy1), 0.0);
      // kept unless provably far: a NaN coordinate keeps the segment
      keep = !dead && !(dx * dx + dy * dy > margin_sq);
    }
    const unsigned ballot = __ballot_sync(0xffffffffu, keep);
    if (lane == 0) warp_kept[warp] = __popc(ballot);
    __syncthreads();  // warp counts ready
    int base = 0, kept = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const int n = warp_kept[w];
      base += w < warp ? n : 0;
      kept += n;
    }
    if (keep) {
      const int slot = base + __popc(ballot & ((1u << lane) - 1u));
      const float p0x = p[0], p0y = p[1], p1x = p[2], p1y = p[3], p2x = p[4], p2y = p[5];
      const float ax = p1x - p0x;
      const float ay = p1y - p0y;
      const float bx2 = p0x - 2.0f * p1x + p2x;
      const float by2 = p0y - 2.0f * p1y + p2y;
      const float k3 = bx2 * bx2 + by2 * by2;
      const float k2 = 3.0f * (ax * bx2 + ay * by2);
      const float k1 = 2.0f * (ax * ax + ay * ay);
      terms[P0X][slot] = p0x;
      terms[P0Y][slot] = p0y;
      terms[AX][slot] = ax;
      terms[AY][slot] = ay;
      terms[BX2][slot] = bx2;
      terms[BY2][slot] = by2;
      terms[K3][slot] = k3;
      terms[K2][slot] = k2;
      terms[K1][slot] = k1;
      terms[K3X3][slot] = 3.0f * k3;
      terms[K2X2][slot] = 2.0f * k2;
    }
    __syncthreads();  // the kept list is ready

    // 2. the Newton program over the kept segments
    if (inside) {
      for (int j = 0; j < kept; ++j) {
        Pair q;
        q.ax = terms[AX][j];
        q.ay = terms[AY][j];
        q.bx2 = terms[BX2][j];
        q.by2 = terms[BY2][j];
        const float k3 = terms[K3][j], k2 = terms[K2][j], k1 = terms[K1][j];
        const float k3x3 = terms[K3X3][j], k2x2 = terms[K2X2][j];
        q.qx = terms[P0X][j] - px;
        q.qy = terms[P0Y][j] - py;
        const float qa = q.qx * q.ax + q.qy * q.ay;
        const float qb = q.qx * q.bx2 + q.qy * q.by2;
        const float k1b = k1 + qb;

        float best = q.dist_sq(0.0f);
        best = min_nan(best, q.dist_sq(1.0f));
#pragma unroll
        for (int si = 0; si < kStarts; ++si) {
          // the Python float (2s + 1) / 6 rounded to float32 (sdf_pallas.py:154)
          float t = (float)((double)(2 * si + 1) / (double)(2 * kStarts));
#pragma unroll
          for (int it = 0; it < kIters; ++it) {
            const float f = ((k3 * t + k2) * t + k1b) * t + qa;
            float df = (k3x3 * t + k2x2) * t + k1b;
            if (df == 0.0f) df = 1.0f;
            t = clamp01_nan(t - f / df);
          }
          best = min_nan(best, q.dist_sq(t));
        }
        d2 = min_nan(d2, best);
      }
    }
    __syncthreads();  // the kept list is consumed before the next chunk
  }

  // 3. sign and clamp
  if (inside) {
    const size_t i = ((size_t)b * H + r) * W + c;
    const float dist = min_nan(sqrtf(d2) * scale, spread);
    out[i] = (winding[i] != 0 ? 1.0f : -1.0f) * dist;
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

  const int tiles_x = (W + kTile - 1) / kTile;
  const int tiles_y = (H + kTile - 1) / kTile;
  const long long tiles = (long long)tiles_x * tiles_y;
  const long long blocks = tiles * B;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;

  sdf_kernel<<<(unsigned)blocks, kThreads, 0, stream>>>(
      seg, min_x, max_y, winding, scale, spread, S, H, W, tiles_x, (int)tiles, out);
  return cudaGetLastError();
}
