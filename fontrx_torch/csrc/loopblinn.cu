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
// What bounded the first port: one block per (glyph, 16 x 16 tile), a pixel
// a thread. Every block loaded and set up all of its glyph's triangles (12
// scalar loads, the area and a correctly rounded 1/area, a 12-edge cull), so
// config 3's atlas set each triangle up 64 times; 6,016 short blocks passed
// three barriers each around little work, and each pixel read 15 shared
// terms per triangle it tested, one chain a thread, first hit in mesh order.
//
// Design: one block per (glyph, band of rows, band of at most kMaxCols
// columns), from loopblinn_plan(), in a grid-stride loop.
//   0. The block's sample coordinates, px of its columns and py of its rows,
//      go to shared memory once: no warp divides again (a correctly rounded
//      '/' is a branch region that nothing is scheduled across).
//   1. Set-up, once per block and chunk of kChunk triangles, a thread a
//      triangle: three 16-byte loads, the area, its sign and 1/area (the
//      per-pixel program's operations, so the same bits), and the cull
//      against the block's sample rectangle. A warp ballot per kind and the
//      warps' counts pack the kept triangles into shared memory (four
//      float4 arrays), SOLID ONES FIRST: OR commutes, so the order is exact,
//      and an interior pixel meets a solid triangle before any curve.
//   2. A warp takes a 16 x kWarpRows tile of the block from a counter and
//      culls the block's list against it, 32 triangles a ballot, into a
//      warp-private index list. A solid triangle that covers the tile
//      (below) makes the tile ink with no per-pixel work.
//   3. Otherwise the warp tests kTriLanes listed triangles at a time, a lane
//      one triangle on one row of the tile (lane = slot * kWarpRows + row):
//      the y-halves of the edge functions, (x1 - x0)*(py - y0), once, the
//      x-halves for the row's 16 pixels, the class test only for the pixels
//      inside. Three shuffles OR a row's hits over the slots; a pixel that
//      has hit is not tested again, and the tile stops when all have hit.
//      Spreading a tile's triangles over the lanes shortens the chains of
//      the tiles with the most triangles, which bound the launch: a lane
//      a pixel group would test all of them one after the other.
//   4. A lane writes its row's kLaneCols bytes in one store where the
//      address allows, else byte by byte (ragged edges). With more than one
//      chunk, a later chunk reads the bytes back and skips a tile whose
//      pixels have all hit.
// Rows a block: whole warp-tile rows, as many as fill kMaxTiles warp tiles
// (at least one row), fewer where the batch would give fewer than
// kFillBlocksPerSM blocks for each of the card's SMs (down to one row of
// tiles: the CLI's one glyph is a block per 8 rows), spread evenly over the
// fewest bands.
//
// The cull is exact, whatever the triangle. A triangle is dropped for a band
// or a tile when it cannot draw (a class other than 0, 1, 2; area 0 or NaN)
// or when, for one of its edges, e*sgn < 0 at all four corners of the
// rectangle of samples (the samples of its first and last row and column,
// computed with the pixels' own operations). In float32, e = fl(P(py) -
// Q(px)), where P = fl(D1 * fl(py - Y)) depends only on py and Q only on px,
// and each rounded operation is monotone; so e (and e*sgn, sgn = +-1) is
// monotone in px, in a direction that does not depend on py, and in py, in
// a direction that does not depend on px, and its largest value over the
// rectangle's samples lies at a corner. A dropped triangle thus tests
// e*sgn < 0 (or NaN) at every pixel of the rectangle: it is inside at none.
// A NaN at a corner keeps the triangle.
//
// The covered tile is exact too. A live class-2 triangle with nonzero area
// whose three edges have e*sgn >= 0 at all four corners of the tile's
// rectangle draws every pixel of the tile. By the same monotonicity the
// least e*sgn over the rectangle's samples lies at a corner, so it is
// >= 0 at every pixel, if no pixel's e is NaN. And none is: e = fl(P - Q) is
// NaN only where P or Q is NaN, or both are infinite with one sign. P at an
// inner py lies between P at the two corner rows, so it is NaN, or
// infinite, only if a corner row's P is too (D1 * inf is NaN at every row
// where py - Y overflows, the corners' among them); likewise Q. Then a
// corner's e is NaN, and the test fails. So every pixel is inside
// (area != 0 and class 2: the class test keeps it), and the tile is ink.
//
// e*sgn >= 0 with sgn = +-1 is e >= 0 for sgn = 1 and e <= 0 for sgn = -1
// (-e is exact, -0 and NaN compare alike), which the per-pixel loop tests
// without the product; the edge functions' bits are the reference's.
//
// Where its time goes on an H100 (PERF.md): issue slots, and the chains of
// the tiles that keep the most triangles, which a design with a lane per
// group of pixels tested one triangle after the other and which then bound
// its launch. Each block's set-up (the triangle loads, the cull, three
// barriers) is a fixed latency that one glyph on few SMs pays in full: the
// CLI's glyph is latency. Bytes (52 B a triangle, 1 B a pixel) set the
// floor (fontrx_torch/bound.py).
//
// Float rules: built with -fmad=false and without fast math, so no
// multiply-add is contracted and 1/area rounds correctly.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 16;                 // a warp's tile: kTile columns x kWarpRows rows
constexpr int kWarpRows = 8;
constexpr int kTriLanes = 32 / kWarpRows;  // triangles a warp tests at once, a row each a lane
constexpr int kLaneCols = kTile / kTriLanes;  // columns a lane writes
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = kThreads;          // triangles set up at once, one a thread
constexpr int kMaxTiles = 32;             // warp tiles a block
constexpr int kMaxCols = 256;             // columns a block
constexpr int kMaxRows = kMaxTiles * kWarpRows;
constexpr int kFillBlocksPerSM = 2;       // a small batch is cut to fill this many blocks an SM
static_assert(kChunk <= 256, "a warp's list names a triangle in 8 bits");
static_assert(kTile == 16 && kTriLanes * kLaneCols == kTile && kLaneCols == 4,
              "a row's mask is 16 bits, a lane's columns one 4-byte word");
static_assert(kMaxCols % kTile == 0, "a block's columns are whole tiles");

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

// A rectangle of samples: its first and last column's px, row's py.
struct Rect {
  float x0, x1, y0, y1;
};

// The edge x0 -> x1 at the rectangle's four corners: whether e*sgn < 0 at
// all four (the edge misses the rectangle) and whether e*sgn >= 0 at all
// four. Every corner is evaluated, without branches.
struct Corners {
  bool misses, covers;
};

__device__ __forceinline__ Corners corners(float x0, float y0, float x1, float y1, float sgn,
                                           const Rect& s) {
  const float e00 = edge(x0, y0, x1, y1, s.x0, s.y0) * sgn;
  const float e10 = edge(x0, y0, x1, y1, s.x1, s.y0) * sgn;
  const float e01 = edge(x0, y0, x1, y1, s.x0, s.y1) * sgn;
  const float e11 = edge(x0, y0, x1, y1, s.x1, s.y1) * sgn;
  return {(bool)((e00 < 0.0f) & (e10 < 0.0f) & (e01 < 0.0f) & (e11 < 0.0f)),
          (bool)((e00 >= 0.0f) & (e10 >= 0.0f) & (e01 >= 0.0f) & (e11 >= 0.0f))};
}

// The block's kept triangles, four float4 arrays in shared memory:
//   kGeo (ax ay bx by), kGeo2 (cx cy sgn inv), kTexAB (u0 v0 u1 v1),
//   kTexC (u2 v2 class -)
enum { kGeo, kGeo2, kTexAB, kTexC, kRecords };

constexpr unsigned kLaneAll = (1u << kLaneCols) - 1u;

// Reads a lane's pixels at o (pixel i at o + i, bit i of `valid`) as bits: 1
// where the byte is nonzero; one 4-byte load where the address allows.
__device__ __forceinline__ unsigned load_bits(const uint8_t* o, unsigned valid) {
  unsigned bits = 0;
  if (valid == kLaneAll && ((uintptr_t)o & 3u) == 0) {
    const unsigned v = *reinterpret_cast<const unsigned*>(o);
#pragma unroll
    for (int i = 0; i < kLaneCols; ++i) bits |= ((v >> (8 * i)) & 0xffu) != 0 ? 1u << i : 0u;
  } else {
#pragma unroll
    for (int i = 0; i < kLaneCols; ++i)
      if ((valid >> i) & 1u) bits |= o[i] != 0 ? 1u << i : 0u;
  }
  return bits;
}

// Writes bit i of `bits` as byte o[i] (0 or 1) for each valid i; one 4-byte
// store where the address allows.
__device__ __forceinline__ void store_bits(uint8_t* o, unsigned valid, unsigned bits) {
  if (valid == kLaneAll && ((uintptr_t)o & 3u) == 0) {
    unsigned v = 0;
#pragma unroll
    for (int i = 0; i < kLaneCols; ++i) v |= ((bits >> i) & 1u) << (8 * i);
    *reinterpret_cast<unsigned*>(o) = v;
  } else {
#pragma unroll
    for (int i = 0; i < kLaneCols; ++i)
      if ((valid >> i) & 1u) o[i] = (uint8_t)((bits >> i) & 1u);
  }
}

// The OR of v over the lanes that hold the same row of the warp's tile
// (lane = slot * kWarpRows + row).
__device__ __forceinline__ unsigned row_or(unsigned v) {
#pragma unroll
  for (int off = kWarpRows; off < 32; off <<= 1) v |= __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__global__ void __launch_bounds__(kThreads, 3)
loopblinn_kernel(const float* __restrict__ tris, const int* __restrict__ classes,
                 const int* __restrict__ min_x, const int* __restrict__ max_y, float scale,
                 float ox, float oy, int M, int H, int W, int rows, int row_bands, int cols,
                 int col_bands, int chunks, bool vec, long long blocks,
                 uint8_t* __restrict__ out) {
  __shared__ float4 rec[kRecords][kChunk];
  __shared__ uint8_t warp_list[kWarps][kChunk];
  __shared__ float col_x[kMaxCols], row_y[kMaxRows];  // the block's sample coordinates
  __shared__ int warp_kept[2][kWarps];  // solid, curve
  __shared__ int next_tile;

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const unsigned below = (1u << lane) - 1u;
  const int slot = lane / kWarpRows, lrow = lane % kWarpRows;
  uint8_t* wl = warp_list[warp];

  for (long long blk = blockIdx.x; blk < blocks; blk += gridDim.x) {
    const long long bands = (long long)row_bands * col_bands;
    const int b = (int)(blk / bands);
    const int band = (int)(blk - b * bands);
    const int row0 = band / col_bands * rows, col0 = band % col_bands * cols;
    const int nrows = min(rows, H - row0), ncols = min(cols, W - col0);
    const int tiles_x = (ncols + kTile - 1) / kTile;
    const int tiles = (nrows + kWarpRows - 1) / kWarpRows * tiles_x;
    const int mx = min_x[b], my = max_y[b];
    __syncthreads();  // the previous block's warps are done with the samples
    for (int i = tid; i < ncols; i += kThreads) col_x[i] = pixel_x(mx, col0 + i, ox, scale);
    for (int i = tid; i < nrows; i += kThreads) row_y[i] = pixel_y(my, row0 + i, oy, scale);
    __syncthreads();
    const Rect band_rect{col_x[0], col_x[ncols - 1], row_y[0], row_y[nrows - 1]};
    const float* gtri = tris + (size_t)b * M * 12;
    const int* gcls = classes + (size_t)b * M;

    for (int chunk = 0; chunk < chunks; ++chunk) {
      // 1. one triangle a thread: set-up, the band's cull, pack the kept ones
      const int m = chunk * kChunk + tid;
      float4 geo = {}, geo2 = {}, tex_ab = {}, tex_c = {};
      bool keep = false, solid = false;
      if (m < M) {
        const float* t = gtri + (size_t)m * 12;
        float4 pa, pb, pc;
        if (vec) {
          pa = reinterpret_cast<const float4*>(t)[0];
          pb = reinterpret_cast<const float4*>(t)[1];
          pc = reinterpret_cast<const float4*>(t)[2];
        } else {
          pa = make_float4(t[0], t[1], t[2], t[3]);
          pb = make_float4(t[4], t[5], t[6], t[7]);
          pc = make_float4(t[8], t[9], t[10], t[11]);
        }
        const int cls = gcls[m];
        const float ax = pa.x, ay = pa.y, bx = pb.x, by = pb.y, cx = pc.x, cy = pc.y;
        const float area = (bx - ax) * (cy - ay) - (by - ay) * (cx - ax);
        const float sgn = area > 0.0f ? 1.0f : -1.0f;
        const float inv = 1.0f / area;
        const Corners e0 = corners(ax, ay, bx, by, sgn, band_rect);
        const Corners e1 = corners(bx, by, cx, cy, sgn, band_rect);
        const Corners e2 = corners(cx, cy, ax, ay, sgn, band_rect);
        keep = (cls >= 0) & (cls <= 2) & ((area > 0.0f) | (area < 0.0f)) &
               !(e0.misses | e1.misses | e2.misses);
        solid = cls == 2;
        geo = make_float4(ax, ay, bx, by);
        geo2 = make_float4(cx, cy, sgn, inv);
        tex_ab = make_float4(pa.z, pa.w, pb.z, pb.w);
        tex_c = make_float4(pc.z, pc.w, (float)cls, 0.0f);
      }
      const unsigned solid_bits = __ballot_sync(0xffffffffu, keep && solid);
      const unsigned curve_bits = __ballot_sync(0xffffffffu, keep && !solid);
      __syncthreads();  // the previous chunk's lists and tiles are consumed
      if (lane == 0) {
        warp_kept[0][warp] = __popc(solid_bits);
        warp_kept[1][warp] = __popc(curve_bits);
      }
      if (tid == 0) next_tile = kWarps;
      __syncthreads();  // the warps' counts are ready
      int n_solid = 0, n_curve = 0, solid_base = 0, curve_base = 0;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const int s = warp_kept[0][w], c = warp_kept[1][w];
        solid_base += w < warp ? s : 0;
        curve_base += w < warp ? c : 0;
        n_solid += s;
        n_curve += c;
      }
      if (keep) {
        const int at = solid ? solid_base + __popc(solid_bits & below)
                                : n_solid + curve_base + __popc(curve_bits & below);
        rec[kGeo][at] = geo;
        rec[kGeo2][at] = geo2;
        rec[kTexAB][at] = tex_ab;
        rec[kTexC][at] = tex_c;
      }
      const int kept = n_solid + n_curve;
      __syncthreads();  // the kept list is ready

      // 2-4. a warp a tile of the block, taken from a counter
      for (int t = warp; t < tiles;) {
        const int tr = t / tiles_x;
        const int r0 = tr * kWarpRows, c0 = (t - tr * tiles_x) * kTile;  // in the block
        const int r_last = min(r0 + kWarpRows, nrows) - 1, c_last = min(c0 + kTile, ncols) - 1;
        {
          int next = 0;
          if (lane == 0) next = atomicAdd(&next_tile, 1);
          t = __shfl_sync(0xffffffffu, next, 0);
        }
        // this lane's row of the tile, and the columns it writes
        const int r = r0 + lrow, lc = c0 + slot * kLaneCols;
        const unsigned valid =
            r <= r_last ? (c_last - c0 + 1 >= kTile ? 0xffffu : (1u << (c_last - c0 + 1)) - 1u)
                        : 0u;
        const unsigned lane_valid = (valid >> (slot * kLaneCols)) & kLaneAll;
        uint8_t* o = out + ((size_t)b * H + row0 + (r <= r_last ? r : r0)) * W + col0 + lc;
        unsigned done = 0;  // the row's pixels that have hit
        if (chunk > 0)
          done = row_or(lane_valid ? load_bits(o, lane_valid) << (slot * kLaneCols) : 0u);
        if (__all_sync(0xffffffffu, done == valid)) continue;  // a later chunk: all ink

        // 2. the block's list against the tile, 32 triangles a ballot
        const Rect tile{col_x[c0], col_x[c_last], row_y[r0], row_y[r_last]};
        int n = 0;
        bool covered = false;
        for (int j0 = 0; j0 < kept; j0 += 32) {
          const int j = j0 + lane;
          bool mine = false, covers = false;
          if (j < kept) {
            const float4 g = rec[kGeo][j], g2 = rec[kGeo2][j];
            const float s = g2.z;
            const Corners e0 = corners(g.x, g.y, g.z, g.w, s, tile);
            const Corners e1 = corners(g.z, g.w, g2.x, g2.y, s, tile);
            const Corners e2 = corners(g2.x, g2.y, g.x, g.y, s, tile);
            mine = !(e0.misses | e1.misses | e2.misses);
            covers = (j < n_solid) & e0.covers & e1.covers & e2.covers;
          }
          if (__any_sync(0xffffffffu, covers)) {
            covered = true;
            break;
          }
          const unsigned bits = __ballot_sync(0xffffffffu, mine);
          if (mine) wl[n + __popc(bits & below)] = (uint8_t)j;
          n += __popc(bits);
        }
        __syncwarp();  // the warp's list is written

        if (covered) {
          done = valid;
        } else {
          // 3. kTriLanes triangles at a time, a lane one triangle on one row
          // of the tile (its kTile pixels), to each pixel's first hit
          const float py = row_y[min(r, r_last)];
          float px[kTile];
#pragma unroll
          for (int i = 0; i < kTile; ++i) px[i] = col_x[min(c0 + i, c_last)];
          for (int k0 = 0; k0 < n; k0 += kTriLanes) {
            const int k = k0 + slot;
            unsigned hit = 0;
            if (k < n && done != valid) {
              const int j = wl[k];
              const float4 g = rec[kGeo][j], g2 = rec[kGeo2][j];
              const float ax = g.x, ay = g.y, bx = g.z, by = g.w, cx = g2.x, cy = g2.y;
              // the y-halves of e0, e1, e2 for this row, then the x-halves per pixel
              const float y0 = (bx - ax) * (py - ay), d0 = by - ay;
              const float y1 = (cx - bx) * (py - by), d1 = cy - by;
              const float y2 = (ax - cx) * (py - cy), d2 = ay - cy;
              const bool positive = g2.z > 0.0f;
              unsigned in = 0;
#pragma unroll
              for (int i = 0; i < kTile; ++i) {
                const float e0 = y0 - d0 * (px[i] - ax);
                const float e1 = y1 - d1 * (px[i] - bx);
                const float e2 = y2 - d2 * (px[i] - cx);
                const bool inside = positive ? (e0 >= 0.0f) & (e1 >= 0.0f) & (e2 >= 0.0f)
                                             : (e0 <= 0.0f) & (e1 <= 0.0f) & (e2 <= 0.0f);
                in |= inside ? 1u << i : 0u;
              }
              in &= valid & ~done;
              if (in) {
                const float4 tc = rec[kTexC][j];
                if (tc.z == 2.0f) {
                  hit = in;
                } else {
                  const float4 tab = rec[kTexAB][j];
                  const float iv = g2.w;
                  const bool concave = tc.z == 0.0f;
                  for (unsigned rest = in; rest; rest &= rest - 1u) {
                    const int i = __ffs(rest) - 1;
                    const float pxi = col_x[min(c0 + i, c_last)];
                    const float e1 = y1 - d1 * (pxi - bx);
                    const float e2 = y2 - d2 * (pxi - cx);
                    const float la = e1 * iv;
                    const float lb = e2 * iv;
                    const float lc = (1.0f - la) - lb;
                    const float u = (la * tab.x + lb * tab.z) + lc * tc.x;
                    const float v = (la * tab.y + lb * tab.w) + lc * tc.y;
                    const float q = (1.0f + u) - v;
                    const float f = q * q;
                    const float u4 = 4.0f * u;
                    if (concave ? f >= u4 : f <= u4) hit |= 1u << i;
                  }
                }
              }
            }
            done |= row_or(hit);
            if (__all_sync(0xffffffffu, done == valid)) break;
          }
        }
        // 4. the lane's bytes of its row
        if (lane_valid) store_bits(o, lane_valid, done >> (slot * kLaneCols));
        __syncwarp();  // the warp's list is consumed
      }
    }
  }
}

// A launch's shape: rows a band (whole warp-tile rows, or H) and row bands
// a glyph, columns a band (whole tiles, or W) and column bands, chunks of
// triangles.
struct Plan {
  int rows, row_bands, cols, col_bands, chunks;
};

// Columns a block: up to kMaxCols, spread evenly over the fewest bands, in
// whole tiles. Rows a block: whole warp-tile rows, as many as fill kMaxTiles
// warp tiles (at least one row), fewer where the batch would give fewer than
// kFillBlocksPerSM blocks for each of the card's `sms` SMs (down to one),
// spread evenly over the fewest bands.
Plan make_plan(long long B, int M, int H, int W, int sms) {
  const int col_bands = (W + kMaxCols - 1) / kMaxCols;
  const int cols = ((W + col_bands - 1) / col_bands + kTile - 1) / kTile * kTile;
  const int tiles_x = cols / kTile;
  const int tiles_y = (H + kWarpRows - 1) / kWarpRows;
  int trows = kMaxTiles / tiles_x;
  if (trows < 1) trows = 1;
  if (trows > tiles_y) trows = tiles_y;
  const long long units = B * col_bands;
  const long long fill = (long long)kFillBlocksPerSM * sms;
  if (units * ((tiles_y + trows - 1) / trows) < fill) {
    const long long per_unit = (fill + units - 1) / units;
    const int spread = (int)((tiles_y + per_unit - 1) / per_unit);
    if (spread < trows) trows = spread > 1 ? spread : 1;
  }
  const int bands = (tiles_y + trows - 1) / trows;
  trows = (tiles_y + bands - 1) / bands;
  const int rows = trows * kWarpRows < H ? trows * kWarpRows : H;
  const int chunks = M > 0 ? (M + kChunk - 1) / kChunk : 1;
  return {rows, (H + rows - 1) / rows, cols < W ? cols : W, (W + cols - 1) / cols, chunks};
}

cudaError_t sm_count(int& sms) {
  int dev = 0;
  const cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  return cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
}

}  // namespace

// The plan loopblinn() launches for B glyphs of M triangles on H x W rasters
// on a card of `sms` SMs into plan[6]: {rows a band, row bands, columns a
// band, column bands, triangles a chunk, chunks}; cudaErrorInvalidValue for
// an empty launch.
extern "C" cudaError_t loopblinn_plan(int B, int M, int H, int W, int sms, int* plan) {
  if (B < 1 || M < 0 || H < 1 || W < 1 || sms < 1) return cudaErrorInvalidValue;
  const Plan p = make_plan(B, M, H, W, sms);
  const int v[6] = {p.rows, p.row_bands, p.cols, p.col_bands, kChunk, p.chunks};
  for (int i = 0; i < 6; ++i) plan[i] = v[i];
  return cudaSuccess;
}

extern "C" cudaError_t loopblinn(const float* tris, const int* classes, const int* min_x,
                                 const int* max_y, float scale, float ox, float oy,
                                 int B, int M, int H, int W, uint8_t* out,
                                 cudaStream_t stream) {
  if (B < 0 || M < 0 || H < 0 || W < 0 || !(scale > 0.0f)) return cudaErrorInvalidValue;
  if (B == 0 || H == 0 || W == 0) return cudaSuccess;
  int sms = 0;
  const cudaError_t err = sm_count(sms);
  if (err != cudaSuccess) return err;
  const Plan p = make_plan(B, M, H, W, sms);
  const long long blocks = (long long)B * p.row_bands * p.col_bands;
  const bool vec = ((uintptr_t)tris & 15u) == 0;
  loopblinn_kernel<<<(unsigned)(blocks < 0x7fffffffLL ? blocks : 0x7fffffffLL), kThreads, 0,
                     stream>>>(tris, classes, min_x, max_y, scale, ox, oy, M, H, W, p.rows,
                               p.row_bands, p.cols, p.col_bands, p.chunks, vec, blocks, out);
  return cudaGetLastError();
}
