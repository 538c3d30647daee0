// Loop-Blinn triangle-mesh fill, for Hopper (sm_90a).
//
// Replaces the TPU Pallas kernel
//   K12  fontrx/kernels/loopblinn.py::_make_lb_kernel (launcher
//        loopblinn_pallas_batch),
// which computes the same function as the JAX package's jnp
// loopblinn_batch: for every pixel, at em-space
//   px = ((float)(min_x + c) + ox) / scale,  py = ((float)(max_y - r) + oy) / scale,
// the OR over the glyph's triangles of (inside && class test), where
//   e0 = (bx - ax)*(py - ay) - (by - ay)*(px - ax)   (e1: b->c, e2: c->a)
//   area = (bx - ax)*(cy - ay) - (by - ay)*(cx - ax),  sgn = sign(area)
//   inside = e0*sgn >= 0 && e1*sgn >= 0 && e2*sgn >= 0 && area != 0
//   inv = 1/area, la = e1*inv, lb = e2*inv, lc = (1 - la) - lb
//   u = (la*u0 + lb*u1) + lc*u2, v likewise, q = (1 + u) - v, f = q*q
//   class 0 (concave) keeps f >= 4u, 1 (convex) f <= 4u, 2 (solid) always,
//   any other class (3 = padding) never draws.
// The association is the reference's (loopblinn.py:93-113). The TPU's
// partition knobs (8 x 128 tiles, tile_h, triangle chunks, the SoA layout)
// are not carried over, nor is its cull (a chunk's bbox against
// tx0 + 128/scale, loopblinn.py:243-254).
//
// Design: one block per (glyph, 16 x 16 pixel tile), one thread per pixel.
//   1. 256 triangles at a time: each thread loads one, computes its area,
//      sign and reciprocal (once per triangle, the same operations as the
//      per-pixel program, so the same bits), and culls it for the tile (see
//      below). A warp ballot and a prefix over the warps pack the kept ones
//      into shared memory.
//   2. Each thread runs the per-pixel program over the kept list and stops
//      at its first covering triangle: OR commutes, so that is exact. When
//      every pixel of the block is covered, the block stops.
//   3. It writes one byte (0 or 1) per pixel.
//
// The cull is exact, whatever the triangle. A triangle is dropped for a tile
// when it cannot draw (a class other than 0, 1, 2; area 0 or NaN) or when,
// for one of its edges, e*sgn < 0 at all four corners of the tile's sample
// rectangle (the samples of its first and last valid row and column,
// computed with the pixels' own operations). In float32, e = fl(P(py) -
// Q(px)), where P = fl(D1 * fl(py - Y)) depends only on py and Q only on px,
// and each rounded operation is monotone; so e (and e*sgn, sgn = +-1) is
// monotone in px and in py separately, and its largest value over the tile's
// samples lies at a corner. A dropped triangle thus tests e*sgn < 0 (or NaN)
// at every pixel of the tile: it is inside at none. A NaN at a corner keeps
// the triangle.
//
// Where its time goes on an H100: the per-(triangle, pixel) edge tests of
// the kept triangles, about 20 FP32 operations each, and the block's set-up
// (the triangle loads and the cull, the barriers). Bytes (52 B a triangle,
// 1 B a pixel) set the floor (fontrx_torch/bound.py). The design therefore
// skips every triangle that provably misses the tile, runs the barycentric
// and class test only for pixels inside, and stops a pixel at its first hit.
// Several pixels a thread, fewer, larger blocks for sparse glyphs, and
// TMA staging are left for later.
//
// Float rules: built with -fmad=false and without fast math, so no
// multiply-add is contracted and 1/area rounds correctly.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 16;                  // a block's tile is kTile x kTile pixels
constexpr int kThreads = kTile * kTile;    // one thread per pixel
constexpr int kWarps = kThreads / 32;

// the kept triangles' terms, one row each in shared memory
enum { AX, AY, BX, BY, CX, CY, U0, V0, U1, V1, U2, V2, SGN, INV, CLS, kTerms };

__device__ __forceinline__ float pixel_x(int mx, int c, float ox, float scale) {
  return ((float)(mx + c) + ox) / scale;
}

__device__ __forceinline__ float pixel_y(int my, int r, float oy, float scale) {
  return ((float)(my - r) + oy) / scale;
}

// e = (x1 - x0)*(py - y0) - (y1 - y0)*(px - x0): the edge x0 -> x1
__device__ __forceinline__ float edge(float x0, float y0, float x1, float y1,
                                      float px, float py) {
  return (x1 - x0) * (py - y0) - (y1 - y0) * (px - x0);
}

// e*sgn < 0 at all four corners of the tile's sample rectangle
__device__ __forceinline__ bool edge_misses(float x0, float y0, float x1, float y1,
                                            float sgn, float tx0, float tx1,
                                            float ty0, float ty1) {
  return edge(x0, y0, x1, y1, tx0, ty0) * sgn < 0.0f &&
         edge(x0, y0, x1, y1, tx1, ty0) * sgn < 0.0f &&
         edge(x0, y0, x1, y1, tx0, ty1) * sgn < 0.0f &&
         edge(x0, y0, x1, y1, tx1, ty1) * sgn < 0.0f;
}

__global__ void __launch_bounds__(kThreads)
loopblinn_kernel(const float* __restrict__ tris, const int* __restrict__ classes,
                 const int* __restrict__ min_x, const int* __restrict__ max_y,
                 float scale, float ox, float oy, int M, int H, int W, int tiles_x,
                 int tiles, uint8_t* __restrict__ out) {
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
  const bool in_raster = r < H && c < W;
  const int mx = min_x[b];
  const int my = max_y[b];
  const float px = pixel_x(mx, c, ox, scale);
  const float py = pixel_y(my, r, oy, scale);

  // the tile's sample rectangle: its first and last valid column and row
  const float tx0 = pixel_x(mx, c0, ox, scale);
  const float tx1 = pixel_x(mx, min(c0 + kTile, W) - 1, ox, scale);
  const float ty0 = pixel_y(my, r0, oy, scale);
  const float ty1 = pixel_y(my, min(r0 + kTile, H) - 1, oy, scale);

  bool hit = false;
  const float* gtri = tris + (size_t)b * M * 12;
  const int* gcls = classes + (size_t)b * M;
  for (int m0 = 0; m0 < M; m0 += kThreads) {
    // 1. one triangle a thread: set-up, cull, pack the kept ones
    const int m = m0 + tid;
    float t[12];
    float sgn = 0.0f, inv = 0.0f;
    int cls = 3;
    bool keep = false;
    if (m < M) {
#pragma unroll
      for (int k = 0; k < 12; ++k) t[k] = gtri[(size_t)m * 12 + k];
      cls = gcls[m];
      const float ax = t[0], ay = t[1], bx = t[4], by = t[5], cx = t[8], cy = t[9];
      const float area = (bx - ax) * (cy - ay) - (by - ay) * (cx - ax);
      sgn = area > 0.0f ? 1.0f : -1.0f;
      inv = 1.0f / area;
      keep = (cls == 0 || cls == 1 || cls == 2) && (area > 0.0f || area < 0.0f) &&
             !edge_misses(ax, ay, bx, by, sgn, tx0, tx1, ty0, ty1) &&
             !edge_misses(bx, by, cx, cy, sgn, tx0, tx1, ty0, ty1) &&
             !edge_misses(cx, cy, ax, ay, sgn, tx0, tx1, ty0, ty1);
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
      terms[AX][slot] = t[0];
      terms[AY][slot] = t[1];
      terms[U0][slot] = t[2];
      terms[V0][slot] = t[3];
      terms[BX][slot] = t[4];
      terms[BY][slot] = t[5];
      terms[U1][slot] = t[6];
      terms[V1][slot] = t[7];
      terms[CX][slot] = t[8];
      terms[CY][slot] = t[9];
      terms[U2][slot] = t[10];
      terms[V2][slot] = t[11];
      terms[SGN][slot] = sgn;
      terms[INV][slot] = inv;
      terms[CLS][slot] = (float)cls;
    }
    __syncthreads();  // the kept list is ready

    // 2. the per-pixel program over the kept triangles, to the first hit
    if (in_raster && !hit) {
      for (int j = 0; j < kept; ++j) {
        const float ax = terms[AX][j], ay = terms[AY][j];
        const float bx = terms[BX][j], by = terms[BY][j];
        const float cx = terms[CX][j], cy = terms[CY][j];
        const float s = terms[SGN][j];
        const float e0 = edge(ax, ay, bx, by, px, py);
        const float e1 = edge(bx, by, cx, cy, px, py);
        const float e2 = edge(cx, cy, ax, ay, px, py);
        if (!(e0 * s >= 0.0f && e1 * s >= 0.0f && e2 * s >= 0.0f)) continue;
        const float k = terms[CLS][j];
        if (k == 2.0f) {
          hit = true;
          break;
        }
        const float iv = terms[INV][j];
        const float la = e1 * iv;
        const float lb = e2 * iv;
        const float lc = (1.0f - la) - lb;
        const float u = (la * terms[U0][j] + lb * terms[U1][j]) + lc * terms[U2][j];
        const float v = (la * terms[V0][j] + lb * terms[V1][j]) + lc * terms[V2][j];
        const float q = (1.0f + u) - v;
        const float f = q * q;
        const float u4 = 4.0f * u;
        if (k == 0.0f ? f >= u4 : f <= u4) {
          hit = true;
          break;
        }
      }
    }
    // the kept list is consumed; stop when every pixel is covered
    if (__syncthreads_and(hit || !in_raster)) break;
  }

  // 3. one byte a pixel
  if (in_raster) out[((size_t)b * H + r) * W + c] = hit ? 1 : 0;
}

}  // namespace

extern "C" cudaError_t loopblinn(const float* tris, const int* classes, const int* min_x,
                                 const int* max_y, float scale, float ox, float oy,
                                 int B, int M, int H, int W, uint8_t* out,
                                 cudaStream_t stream) {
  if (B < 0 || M < 0 || H < 0 || W < 0 || !(scale > 0.0f)) return cudaErrorInvalidValue;
  if (B == 0 || H == 0 || W == 0) return cudaSuccess;

  const int tiles_x = (W + kTile - 1) / kTile;
  const int tiles_y = (H + kTile - 1) / kTile;
  const long long tiles = (long long)tiles_x * tiles_y;
  const long long blocks = tiles * B;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;

  loopblinn_kernel<<<(unsigned)blocks, kThreads, 0, stream>>>(
      tris, classes, min_x, max_y, scale, ox, oy, M, H, W, tiles_x, (int)tiles, out);
  return cudaGetLastError();
}
