// Nonzero winding maps of quadratic glyph outlines, for Hopper (sm_90a).
//
// Replaces six TPU Pallas kernels: K1, K2 and K4 here (the glyph fill path
// and the sharded path, fontrx_torch/engine/sharding.py), K3 with the second
// entry and K5 and K6 with the third (below):
//   K1  fontrx/kernels/winding_pallas_v2.py::_make_v2_kernel (tiles > 128 px)
//   K2  fontrx/kernels/winding_dense.py::_make_dense_kernel  (tiles <= 128 px)
//   K4  fontrx/kernels/winding_pallas.py::_winding_kernel (launcher
//       winding_pallas_batch; 8 x 128 tiles, one row at a time, with a sample
//       offset: winding_sharded, and winding_sharded_2d's bands of 8k rows)
// All three compute one function: for every pixel, the sum of the signs of
// the crossings of the horizontal line through its sample point with the
// glyph's quadratic segments that do not lie left of the sample, with the
// same root solve and IEEE '/' and sqrt. Their TPU-specific partitions
// (128-row strips, 8 x 128 tiles, column tiles, carry sweeps, lane packing)
// are not carried over; one kernel serves every tile size and band.
//
// A second entry, winding_windows(), replaces K3,
//   fontrx/kernels/winding_dense.py::winding_dense_win_batch (body
//   _make_dense_win_kernel), the window-packed route of the small-tile atlas
//   (RasterEngine.winding_batch(windows=...)). Its input is a window-major
//   stream (fontrx_torch/pack/windows.py): window w of glyph b holds
//   counts[b][w] copies of the segments whose hull can reach its rows
//   [w * win_rows, (w + 1) * win_rows). K3 solves each copy on its window's
//   rows and on no other, so a root that the float program finds outside a
//   segment's windows is dropped: the stream defines the function. Its
//   blocks run the same band body over the window's live copies, on rows of
//   that window below H only, and write them straight into [B, H, W]: the
//   TPU's lane groups, its fold across them and the stitching of windows
//   are gone.
//
// What bounded the first port of both: one block per (glyph, 16 rows)
// solved EVERY (segment, row) pair of its band, zero padding included: two
// correctly rounded divides and a square root each. It placed each crossing
// by a binary search over the row's columns (6-8 dependent shared loads)
// before a shared-memory atomic, and scanned each row 32 columns a step, a
// dependent load and a five-step shuffle per step, with 4-byte stores. On
// cjk64 (64 x 64 tiles, 320 segment slots a glyph) it took 17x its bytes
// bound, and K4's shards and K3 paid the same per pair (PERF.md).
//
// Design (the tile coverage kernel's, coverage.cu, on the 1 x 1 lattice with
// a free sample offset): one block per (glyph, band of `rows` rows), or per
// (glyph, window, band of the window's rows) for winding_windows(), in a
// grid-stride loop over the blocks (so no grid limit binds a tall band).
//   1. cx[c] = ((float)(min_x + c) + ox) / scale and cy of the band's rows
//      go to shared memory (cy falls with the row), and the bucket rows
//      [rows][Wp] are zeroed (Wp = W rounded up to 4: 16-byte rows).
//   2. The segments are staged in chunks, a thread each, once for all the
//      band's rows. A segment that the root solve gives no crossing at all
//      (segment_crossings' own test: a == 0 and p2y == p0y; zero padding is
//      one) is dropped. Every other finds the run of rows whose cy lies in
//      its y-hull widened by segment_margin (crossings.cuh), with ymax the
//      band's largest |cy|: a row outside it gets no root from the float
//      program (the proof is in crossings.cuh and holds for any float32 row,
//      so for every oy). A near-straight quadratic's margin is infinite and
//      it keeps every row of the band. The band's rows are its window's, so
//      the cull never adds a row that K3's stream left out. A block prefix
//      lists the kept (segment, row) pairs in shared memory (16 bits a pair)
//      and the threads take them kThreads at a time.
//   3. A crossing at xx adds its sign to cell k - 1 of its row, k the count
//      of columns with !(xx < cx[c]) (a prefix): a guess from xx * scale -
//      min_x - ox, moved while the predicate says so, so the count is exact;
//      a NaN xx covers every column.
//   4. A warp a row scans it right to left: each lane holds kCols cells (4,
//      or 2 below 128 columns) from one 16- or 8-byte load, sums them in
//      registers, and a warp suffix sum of the lane totals plus the carry of
//      the steps to the right finishes them: out[c] = sum of cells j >= c.
//      A lane writes its columns with one vector store when W allows it.
// Rows a block: as many as fit kSmemTarget, up to kMaxRows, fewer (down to
// kMinRows) where a small batch would leave SMs idle, then spread evenly
// over the fewest bands (a 64-row tile: one band or two). When not
// one row fits beside a full chunk, one row a block with a 32-segment chunk
// and rows of exactly W cells: less than the first port needed for one row,
// so every width it served is served. winding_plan() exports the plan.
// Winding is an integer sum, so any order of the atomics gives the same map.
//
// What bounds it on an H100 (PERF.md): latency, not bytes or operations.
// ascii256 takes 1.7x its bytes bound (24.6 MB of int32 out); cjk64 6x,
// its kept pairs' chains (two correctly rounded divides and a square root,
// a placement and a shared-memory atomic a crossing) and each block's
// serial phases (tables, staging with the FP64 margin, the prefix, the
// scan), which short bands pay again: cjk64 took 0.085 ms in 8-row blocks,
// 0.046 in 32 and 0.041 in 64, but a 256-glyph K4 shard is faster in 32
// (0.016 ms) than in 64 (0.019: too few blocks), and ascii256 in 24 (0.0126)
// than in 64 (0.0157). The plan keeps what fits kSmemTarget. A small
// batch is the other way round: one 188-row glyph took 0.0055 ms in 32-row
// blocks and 0.0043 in 8, so a batch that would fill fewer than two blocks
// an SM is cut into bands of down to 8 rows.
//
// A third entry, winding_banded(), replaces K5 and K6, the row-banded strip
// atlas:
//   K5  fontrx/kernels/winding_pallas_v2.py::winding_pallas_banded_batch
//       (_make_v2_kernel(row_bands=R), row-major, W % 128 == 0)
//   K6  fontrx/kernels/winding_dense.py::winding_dense_banded_batch
//       (_make_dense_kernel(row_bands=R), column-major, W <= 128)
// R glyphs share each element's 128-row strip: rows [k * 128/R, (k + 1) *
// 128/R) are winding()'s map at band k's own anchors min_x[k][b], max_y[k][b]
// over the element's segments whose owner is k; any other segment, an owner
// outside [0, R) included, adds zero there. R is the anchors' first
// dimension, so it is part of the data, not a knob. The TPU kernels mask each
// foreign segment's crossings on every row; here one block per (element,
// band, chunk of rows) COMPACTS the element's segments owned by its band into
// the shared-memory chunk (a warp ballot and popc per 32 owners), so the
// solve loop sees only the band's own segments and no thread solves a
// foreign pair. Every owner is read once per band; there is no host regroup.
// Their chunk cull and K6's x-window cull are exact and not carried over, and
// neither are the TPU's lane layout and the transposed output: each band's
// rows are written straight into out[b][k * 128/R + row][:]. It still runs
// the first port's band body (namespace first_port below: every pair of the
// band solved, binary-search deposits, a 32-column scan) until its own
// redesign. Bound as winding() is: its pairs are those of the per-glyph
// winding() on the same glyphs.
//
// Float rules: the library is built with -fmad=false, so no multiply-add is
// contracted (the oracle's contract=False mode), and without fast math, so
// '/' and sqrtf round correctly and denormals are kept.

#include <cuda_runtime.h>
#include <stdint.h>

#include "crossings.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr size_t kSmemLimit = 227 * 1024;

// --- the culled band body: winding() and winding_windows() -----------------

constexpr int kMaxRows = 64;               // rows per block, fewer when W is wide
constexpr size_t kSmemTarget = 45 * 1024;  // five blocks an SM where the rows allow
constexpr int kMinBlocks = 5;              // blocks an SM: caps the registers at 51
constexpr int kSmallChunk = 32;            // the least block's chunk
constexpr int kFillBlocksPerSM = 2;        // a small batch is cut to fill this many blocks an SM
constexpr int kMinRows = 8;                // the shortest band a small batch is cut into
static_assert(kMaxRows <= 256, "a pair names its row in 8 bits");

// Shared memory of a block: the bucket rows, cx, cy, the staged chunk, the
// warps' pair counts and the chunk's pair list.
size_t block_smem(int chunk, int W, int Wp, int rows) {
  return (size_t)rows * Wp * sizeof(int) + (size_t)W * sizeof(float) +
         (size_t)rows * sizeof(float) + (size_t)chunk * 6 * sizeof(float) +
         kWarps * sizeof(int) + (size_t)chunk * rows * sizeof(uint16_t);
}

// One block's work in both entries: the winding of the rows [row0, row0 +
// rows) of one glyph from the segments gseg[0, S), written to out_rows (row
// major, W columns). rows_cap is the plan's rows, which sizes the shared
// memory; kCols the cells a lane holds in the scan; kChunk the segments
// staged at once.
template <int kCols, int kChunk>
__device__ __forceinline__ void culled_band(const float* __restrict__ gseg, int S, int mx,
                                            int my, float scale, float ox, float oy,
                                            int row0, int rows, int rows_cap, int W, int Wp,
                                            unsigned char* smem, int* __restrict__ out_rows) {
  static_assert(kChunk % 32 == 0 && kChunk <= kThreads && kChunk <= 256,
                "a chunk is whole warps, and a pair names its segment in 8 bits");
  int* bucket = reinterpret_cast<int*>(smem);                             // [rows_cap][Wp]
  float* cx = reinterpret_cast<float*>(bucket + (size_t)rows_cap * Wp);  // [W]
  float* cy = cx + W;                                                     // [rows_cap]
  float* sq = cy + rows_cap;                                              // [kChunk][6]
  int* s_warp = reinterpret_cast<int*>(sq + kChunk * 6);                 // [kWarps]
  // [kChunk * rows_cap]: a kept pair (segment t, row r) as t | r << 8
  uint16_t* s_pairs = reinterpret_cast<uint16_t*>(s_warp + kWarps);
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;

  __syncthreads();  // the previous block's scans are done with the buckets and cy
  for (int c = tid; c < W; c += kThreads) cx[c] = ((float)(mx + c) + ox) / scale;
  for (int r = tid; r < rows; r += kThreads) cy[r] = ((float)(my - (row0 + r)) + oy) / scale;
  if constexpr (kCols > 1) {  // Wp % 4 == 0
    int4* b4 = reinterpret_cast<int4*>(bucket);
    for (int i = tid; i < rows * Wp / 4; i += kThreads) b4[i] = make_int4(0, 0, 0, 0);
  } else {
    for (int i = tid; i < rows * Wp; i += kThreads) bucket[i] = 0;
  }
  __syncthreads();
  // the largest |y| of the band's rows: its first or last
  const double ymax = fmax(fabs((double)cy[0]), fabs((double)cy[rows - 1]));

  for (int s0 = 0; s0 < S; s0 += kChunk) {
    const int ns = min(kChunk, S - s0);
    // stage the chunk, a thread a segment, and take its run of rows
    int count = 0, first = 0;
    if (tid < ns) {
      float q[6];
#pragma unroll
      for (int i = 0; i < 6; ++i) {
        q[i] = gseg[(size_t)(s0 + tid) * 6 + i];
        sq[tid * 6 + i] = q[i];
      }
      const float a = q[1] - 2.0f * q[3] + q[5];
      // segment_crossings finds no root on any row of a line with p2y == p0y
      if (!(a == 0.0f && !(q[5] - q[1] != 0.0f))) {
        const float hmin = fminf(fminf(q[1], q[3]), q[5]);
        const float hmax = fmaxf(fmaxf(q[1], q[3]), q[5]);
        const double m = segment_margin(q[1], q[3], q[5], a, ymax);
        const double lo = (double)hmin - m, hi = (double)hmax + m;
        if (lo <= hi) {
          first = leading(cy, rows, [&](double y) { return y > hi; });
          count = max(leading(cy, rows, [&](double y) { return y >= lo; }) - first, 0);
        }
      }
    }
    // the block's exclusive prefix of the counts
    int incl = count;
    for (int off = 1; off < 32; off <<= 1) {
      const int t = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl += t;
    }
    if (lane == 31) s_warp[warp] = incl;
    __syncthreads();
    int base = 0, total = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const int t = s_warp[w];
      if (w < warp) base += t;
      total += t;
    }
    // the chunk's pairs, listed in the prefix's order
    for (int j = 0, off = base + incl - count; j < count; ++j)
      s_pairs[off + j] = (uint16_t)(tid | (first + j) << 8);
    __syncthreads();

    for (int p = tid; p < total; p += kThreads) {
      const int pair = s_pairs[p];
      const int t = pair & 255, r = pair >> 8;
      int* brow = bucket + (size_t)r * Wp;
      segment_crossings(sq + t * 6, cy[r], [&](float xx, int sign) {
        // cx[c] <= xx for c up to about xx * scale - mx - ox
        const float guess = xx * scale - (float)mx - ox;
        int c;
        if (!(guess == guess)) {
          c = W;  // xx is NaN: !(xx < cx) everywhere
        } else {
          c = guess < 0.0f ? 0 : (guess >= (float)W ? W : (int)guess + 1);
        }
        c = covered_from(xx, cx, W, c);
        if (c > 0) atomicAdd(&brow[c - 1], sign);
      });
    }
    __syncthreads();  // the chunk and its prefix are consumed
  }

  // a warp a row, right to left: out[c] = sum of cells j >= c
  constexpr int kStep = 32 * kCols;
  const int steps = (W + kStep - 1) / kStep;
  for (int r = warp; r < rows; r += kWarps) {
    const int* cells = bucket + (size_t)r * Wp;
    int* orow = out_rows + (size_t)r * W;
    int carry = 0;
    for (int step = steps - 1; step >= 0; --step) {
      const int c0 = step * kStep + lane * kCols;
      int v[kCols];
      if (c0 < Wp) {
        if constexpr (kCols == 4) {
          const int4 t = *reinterpret_cast<const int4*>(cells + c0);
          v[0] = t.x, v[1] = t.y, v[2] = t.z, v[3] = t.w;
        } else if constexpr (kCols == 2) {
          const int2 t = *reinterpret_cast<const int2*>(cells + c0);
          v[0] = t.x, v[1] = t.y;
        } else {
          v[0] = cells[c0];
        }
      } else {
#pragma unroll
        for (int i = 0; i < kCols; ++i) v[i] = 0;
      }
#pragma unroll
      for (int i = kCols - 2; i >= 0; --i) v[i] += v[i + 1];
      const int incl = warp_suffix_sum(v[0], lane);
      const int add = incl - v[0] + carry;  // the lanes and steps to the right
#pragma unroll
      for (int i = 0; i < kCols; ++i) v[i] += add;
      if (kCols > 1 && W % kCols == 0) {
        // a lane's columns in one store: the warp's are contiguous
        if (c0 < W) {
          if constexpr (kCols == 4)
            *reinterpret_cast<int4*>(orow + c0) = make_int4(v[0], v[1], v[2], v[3]);
          else if constexpr (kCols == 2)
            *reinterpret_cast<int2*>(orow + c0) = make_int2(v[0], v[1]);
        }
      } else {
#pragma unroll
        for (int i = 0; i < kCols; ++i)
          if (c0 + i < W) orow[c0 + i] = v[i];
      }
      carry += __shfl_sync(0xffffffffu, incl, 0);
    }
  }
}

// winding(): blocks (glyph, band of `rows` rows), every segment.
template <int kCols, int kChunk>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
winding_kernel(const float* __restrict__ seg, const int* __restrict__ min_x,
               const int* __restrict__ max_y, float scale, float ox, float oy, int S, int H,
               int W, int Wp, int rows, int bands, long long blocks, int* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  for (long long blk = blockIdx.x; blk < blocks; blk += gridDim.x) {
    const int b = (int)(blk / bands);
    const int row0 = (int)(blk - (long long)b * bands) * rows;
    culled_band<kCols, kChunk>(seg + (size_t)b * S * 6, S, min_x[b], max_y[b], scale, ox, oy,
                               row0, min(rows, H - row0), rows, W, Wp, smem_raw,
                               out + ((size_t)b * H + row0) * W);
  }
}

// winding_windows(): blocks (glyph, window, band of `rows` of the window's
// rows), the window's live copies, on its rows below H.
template <int kCols, int kChunk>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
winding_windows_kernel(const float* __restrict__ seg, const int* __restrict__ counts,
                       const int* __restrict__ min_x, const int* __restrict__ max_y,
                       float scale, float ox, float oy, int nw, int cap, int win_rows, int H,
                       int W, int Wp, int rows, int subs, long long blocks,
                       int* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  for (long long blk = blockIdx.x; blk < blocks; blk += gridDim.x) {
    const long long bw = blk / subs;  // b * nw + w, also the index of counts[b][w]
    const int b = (int)(bw / nw);
    const long long w0 = (bw - (long long)b * nw) * win_rows;  // the window's first row
    const long long row0 = w0 + (blk - bw * subs) * rows;
    const long long end = min(w0 + win_rows, (long long)H);
    if (row0 >= end) continue;  // a band past the last window's rows below H
    const int n = min(max(counts[bw], 0), cap);
    culled_band<kCols, kChunk>(seg + (size_t)bw * cap * 6, n, min_x[b], max_y[b], scale, ox,
                               oy, (int)row0, (int)min((long long)rows, end - row0), rows, W,
                               Wp, smem_raw, out + ((size_t)b * H + row0) * W);
  }
}

// A launch's shape: rows a block, segments a chunk, cells a lane in the scan,
// the bucket row's cells, shared memory.
struct Plan {
  int rows, chunk, cols, Wp;
  size_t smem;
};

// The plan for `units` bands (glyphs, or glyphs x windows) of at most `band`
// rows (the height, or a window's rows) of W columns: as many rows as fit
// kSmemTarget, up to kMaxRows; fewer, down to kMinRows, where that many
// would give fewer than kFillBlocksPerSM blocks for each of the card's `sms`
// SMs (a small batch: its blocks' serial phases are then shorter and run
// side by side); spread evenly over the fewest bands. When not one row fits
// beside a full chunk, the least block: one row, a 32-segment chunk, rows
// of exactly W cells, which needs less than the first port's block of one
// row. False when not even that fits.
bool make_plan(long long units, int band, int W, int sms, Plan& p) {
  const int Wp = (W + 3) / 4 * 4;
  if (block_smem(kThreads, W, Wp, 1) <= kSmemLimit) {
    const int cap = kMaxRows < band ? kMaxRows : band;
    int rows = 1;
    while (rows < cap && block_smem(kThreads, W, Wp, rows + 1) <= kSmemTarget) ++rows;
    const long long fill = (long long)kFillBlocksPerSM * sms;
    if (units * ((band + rows - 1) / rows) < fill) {
      const long long per_unit = (fill + units - 1) / units;
      const int spread = (int)((band + per_unit - 1) / per_unit);
      const int least = kMinRows < band ? kMinRows : band;
      const int spread_rows = spread > least ? spread : least;
      if (spread_rows < rows) rows = spread_rows;
    }
    const int bands = (band + rows - 1) / rows;
    rows = (band + bands - 1) / bands;
    p = {rows, kThreads, W >= 128 ? 4 : 2, Wp, block_smem(kThreads, W, Wp, rows)};
    return true;
  }
  p = {1, kSmallChunk, 1, W, block_smem(kSmallChunk, W, W, 1)};
  return p.smem <= kSmemLimit;
}

// The SM count of the current device, which make_plan's `sms` takes.
cudaError_t sm_count(int& sms) {
  int dev = 0;
  const cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  return cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
}

template <class Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

unsigned grid_of(long long blocks) {
  return (unsigned)(blocks < 0x7fffffffLL ? blocks : 0x7fffffffLL);
}

template <int kCols, int kChunk>
cudaError_t launch_winding(const Plan& p, const float* seg, const int* min_x,
                           const int* max_y, float scale, float ox, float oy, int B, int S,
                           int H, int W, int* out, cudaStream_t stream) {
  auto kernel = winding_kernel<kCols, kChunk>;
  const cudaError_t err = allow_smem(kernel, p.smem);
  if (err != cudaSuccess) return err;
  const int bands = (H + p.rows - 1) / p.rows;
  const long long blocks = (long long)B * bands;
  kernel<<<grid_of(blocks), kThreads, p.smem, stream>>>(seg, min_x, max_y, scale, ox, oy, S,
                                                        H, W, p.Wp, p.rows, bands, blocks, out);
  return cudaGetLastError();
}

cudaError_t run_winding(const Plan& p, const float* seg, const int* min_x, const int* max_y,
                        float scale, float ox, float oy, int B, int S, int H, int W, int* out,
                        cudaStream_t stream) {
  if (p.cols == 4)
    return launch_winding<4, kThreads>(p, seg, min_x, max_y, scale, ox, oy, B, S, H, W, out,
                                       stream);
  if (p.cols == 2)
    return launch_winding<2, kThreads>(p, seg, min_x, max_y, scale, ox, oy, B, S, H, W, out,
                                       stream);
  return launch_winding<1, kSmallChunk>(p, seg, min_x, max_y, scale, ox, oy, B, S, H, W, out,
                                        stream);
}

template <int kCols, int kChunk>
cudaError_t launch_windows(const Plan& p, const float* seg, const int* counts,
                           const int* min_x, const int* max_y, float scale, float ox, float oy,
                           int B, int nw, int cap, int win_rows, int H, int W, int* out,
                           cudaStream_t stream) {
  auto kernel = winding_windows_kernel<kCols, kChunk>;
  const cudaError_t err = allow_smem(kernel, p.smem);
  if (err != cudaSuccess) return err;
  const int band = win_rows < H ? win_rows : H;
  const int subs = (band + p.rows - 1) / p.rows;
  const long long blocks = (long long)B * nw * subs;
  kernel<<<grid_of(blocks), kThreads, p.smem, stream>>>(seg, counts, min_x, max_y, scale, ox,
                                                        oy, nw, cap, win_rows, H, W, p.Wp,
                                                        p.rows, subs, blocks, out);
  return cudaGetLastError();
}

// --- the first port's band body: winding_banded() -------------------------

namespace first_port {

constexpr int kMaxRows = 16;        // rows per block, fewer when W is wide
constexpr int kSegChunk = 64;       // segments staged per shared-memory chunk
constexpr int kStripRows = 128;     // rows of a banded element's strip

static_assert(kSegChunk % 32 == 0 && kSegChunk <= kThreads, "a chunk is whole warps");

struct SegmentChunk {
  float v[kSegChunk * 6];           // p0x p0y p1x p1y p2x p2y per segment
};

// Number of columns c in [0, W) with !(xx < cx[c]). cx is non-decreasing in
// c (int -> float, + offset and / scale > 0 are monotone), so they are a
// prefix, found by binary search with the same predicate.
__device__ __forceinline__ int covered_columns(const float* cx, int W, float xx) {
  int lo = 0, hi = W;
  while (lo < hi) {
    int mid = (lo + hi) >> 1;
    if (!(xx < cx[mid])) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// Adds sign to bucket_row[k], k the count of covered columns; a suffix scan
// of the row then gives every column its winding.
__device__ __forceinline__ void deposit(int* bucket_row, const float* cx, int W,
                                        float xx, int sign) {
  int k = covered_columns(cx, W, xx);
  if (k > 0) atomicAdd(&bucket_row[k], sign);
}

// Run by one whole warp over one bucket row of W + 1 entries: calls
// emit(c, w) for every column c in [0, W), w = sum of bucket_row[j] for
// j > c. Right to left in 32-column pieces, each an inclusive suffix scan
// across the lanes plus the carry of the pieces to its right.
template <class Emit>
__device__ __forceinline__ void suffix_scan_row(const int* bucket_row, int W, int lane,
                                                Emit&& emit) {
  int carry = 0;
  for (int base = ((W - 1) >> 5) << 5; base >= 0; base -= 32) {
    const int c = base + lane;
    const int s = warp_suffix_sum(c < W ? bucket_row[c + 1] : 0, lane);
    if (c < W) emit(c, s + carry);
    carry += __shfl_sync(0xffffffffu, s, 0);
  }
}

// Stages those of the segments [s0, s0 + n) whose owner is `band`, packed to
// the front of the chunk in their order; returns how many. Each of the first
// kSegChunk threads reads one owner; a ballot per warp and its popc give each
// owned segment its place. counts holds kSegChunk / 32 ints of shared memory.
struct OwnedBy {
  const float* gseg;
  const int* owners;
  int band;
  int* counts;

  __device__ __forceinline__ int operator()(float* v, int s0, int n) const {
    const int tid = threadIdx.x;
    const int lane = tid & 31, warp = tid >> 5;
    bool mine = false;
    int pos = 0;
    if (warp < kSegChunk / 32) {  // whole warps
      mine = tid < n && owners[s0 + tid] == band;
      const unsigned m = __ballot_sync(0xffffffffu, mine);
      if (lane == 0) counts[warp] = __popc(m);
      pos = __popc(m & ((1u << lane) - 1u));
    }
    __syncthreads();
    int ns = 0;
    for (int w = 0; w < kSegChunk / 32; ++w) {
      if (w < warp) pos += counts[w];
      ns += counts[w];
    }
    if (mine) {
      const float* src = gseg + (size_t)(s0 + tid) * 6;
      for (int i = 0; i < 6; ++i) v[pos * 6 + i] = src[i];
    }
    return ns;
  }
};

// The first port's band body: the winding of the rows [row0, row0 + rows)
// of one glyph from the segments that `stage` puts in the chunk from its
// array [0, S), written to out_rows (row major, W columns). smem holds the
// segment chunk, cy[rows], cx[W] and bucket[rows][W + 1]. Every thread calls
// stage, between two barriers.
template <class Stage>
__device__ __forceinline__ void band_winding(const Stage& stage, int S, int mx, int my,
                                             float scale, float ox, float oy, int row0,
                                             int rows, int W, unsigned char* smem,
                                             int* __restrict__ out_rows) {
  SegmentChunk* chunk = reinterpret_cast<SegmentChunk*>(smem);
  float* cy = reinterpret_cast<float*>(smem + sizeof(SegmentChunk));  // [rows]
  float* cx = cy + rows;                            // [W]
  int* bucket = reinterpret_cast<int*>(cx + W);     // [rows][W + 1]
  const int tid = threadIdx.x;

  for (int c = tid; c < W; c += kThreads) cx[c] = ((float)(mx + c) + ox) / scale;
  for (int r = tid; r < rows; r += kThreads) cy[r] = ((float)(my - (row0 + r)) + oy) / scale;
  for (int i = tid; i < rows * (W + 1); i += kThreads) bucket[i] = 0;

  for (int s0 = 0; s0 < S; s0 += kSegChunk) {
    __syncthreads();  // cx/bucket ready; the previous chunk fully consumed
    const int ns = stage(chunk->v, s0, min(kSegChunk, S - s0));
    __syncthreads();

    for (int p = tid; p < ns * rows; p += kThreads) {
      const int r = p % rows;
      int* brow = bucket + r * (W + 1);
      segment_crossings(chunk->v + (p / rows) * 6, cy[r], [&](float xx, int sign) {
        deposit(brow, cx, W, xx, sign);
      });
    }
  }
  __syncthreads();

  // out[row0 + r][c] = sum_{j > c} bucket[r][j]: one warp per row
  const int lane = tid & 31;
  for (int r = tid >> 5; r < rows; r += kThreads >> 5) {
    int* orow = out_rows + (size_t)r * W;
    suffix_scan_row(bucket + r * (W + 1), W, lane, [&](int c, int w) { orow[c] = w; });
  }
}

// The ballot counts of OwnedBy, ahead of band_winding's shared memory.
constexpr size_t kCountBytes = 16;
static_assert(kCountBytes >= kSegChunk / 32 * sizeof(int), "room for the ballot counts");

// winding_banded(): one block per (element, band, chunk of `rows` rows of
// the band's band_h), the element's segments owned by the band.
__global__ void __launch_bounds__(kThreads)
winding_banded_kernel(const float* __restrict__ seg, const int* __restrict__ owners,
                      const int* __restrict__ min_x, const int* __restrict__ max_y,
                      float scale, float ox, float oy, int B, int S, int band_h, int rows,
                      int chunks, int W, int* __restrict__ out) {
  extern __shared__ unsigned char smem_raw[];
  const int b = blockIdx.x;
  const int k = blockIdx.y / chunks;
  const int row0 = (blockIdx.y - k * chunks) * rows;  // in the band
  const OwnedBy stage{seg + (size_t)b * S * 6, owners + (size_t)b * S, k,
                      reinterpret_cast<int*>(smem_raw)};
  const size_t anchor = (size_t)k * B + b;
  band_winding(stage, S, min_x[anchor], max_y[anchor], scale, ox, oy, row0,
               min(rows, band_h - row0), W, smem_raw + kCountBytes,
               out + ((size_t)b * kStripRows + k * band_h + row0) * W);
}

cudaError_t winding_banded(const float* seg, const int* owners, const int* min_x,
                           const int* max_y, float scale, float ox, float oy, int B, int S,
                           int R, int W, int* out, cudaStream_t stream) {
  if (B < 0 || S < 0 || R < 1 || kStripRows % R != 0 || W < 0 || !(scale > 0.0f))
    return cudaErrorInvalidValue;
  if (B == 0 || W == 0) return cudaSuccess;

  const int band_h = kStripRows / R;
  const size_t fixed = kCountBytes + sizeof(SegmentChunk) + (size_t)W * sizeof(float);
  const size_t per_row = sizeof(float) + (size_t)(W + 1) * sizeof(int);
  if (fixed + per_row > kSmemLimit) return cudaErrorInvalidValue;
  int rows = (int)((kSmemLimit - fixed) / per_row);
  if (rows > kMaxRows) rows = kMaxRows;
  if (rows > band_h) rows = band_h;
  const size_t smem = fixed + (size_t)rows * per_row;
  const int chunks = (band_h + rows - 1) / rows;

  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        winding_banded_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  dim3 grid((unsigned)B, (unsigned)(R * chunks));
  winding_banded_kernel<<<grid, kThreads, smem, stream>>>(
      seg, owners, min_x, max_y, scale, ox, oy, B, S, band_h, rows, chunks, W, out);
  return cudaGetLastError();
}

}  // namespace first_port

}  // namespace

// The plan winding() (win_rows 0) or winding_windows() (its win_rows)
// launches for B glyphs of H rows of W columns on a card of `sms` SMs into
// plan[4]: {rows, chunk, cells a lane, shared bytes}; cudaErrorInvalidValue
// when no block fits.
extern "C" cudaError_t winding_plan(int B, int H, int W, int win_rows, int sms, int* plan) {
  Plan p;
  if (B < 1 || H < 1 || W < 1 || win_rows < 0 || sms < 1) return cudaErrorInvalidValue;
  const bool windows = win_rows > 0;
  const long long units = windows ? (long long)B * ((H + win_rows - 1) / win_rows) : B;
  if (!make_plan(units, windows && win_rows < H ? win_rows : H, W, sms, p))
    return cudaErrorInvalidValue;
  const int v[4] = {p.rows, p.chunk, p.cols, (int)p.smem};
  for (int i = 0; i < 4; ++i) plan[i] = v[i];
  return cudaSuccess;
}

extern "C" cudaError_t winding(const float* seg, const int* min_x, const int* max_y,
                               float scale, float ox, float oy, int B, int S, int H,
                               int W, int* out, cudaStream_t stream) {
  if (B < 0 || S < 0 || H < 0 || W < 0 || !(scale > 0.0f)) return cudaErrorInvalidValue;
  if (B == 0 || H == 0 || W == 0) return cudaSuccess;
  int sms = 0;
  const cudaError_t err = sm_count(sms);
  if (err != cudaSuccess) return err;
  Plan p;
  if (!make_plan(B, H, W, sms, p)) return cudaErrorInvalidValue;
  return run_winding(p, seg, min_x, max_y, scale, ox, oy, B, S, H, W, out, stream);
}

extern "C" cudaError_t winding_windows(const float* seg, const int* counts, const int* min_x,
                                       const int* max_y, float scale, float ox, float oy,
                                       int B, int nw, int cap, int win_rows, int H, int W,
                                       int* out, cudaStream_t stream) {
  if (B < 0 || nw < 1 || cap < 0 || win_rows < 1 || H < 0 || W < 0 || !(scale > 0.0f))
    return cudaErrorInvalidValue;
  if ((long long)nw * win_rows < H || (long long)B * nw > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  if (B == 0 || H == 0 || W == 0) return cudaSuccess;
  int sms = 0;
  const cudaError_t err = sm_count(sms);
  if (err != cudaSuccess) return err;
  Plan p;
  if (!make_plan((long long)B * nw, win_rows < H ? win_rows : H, W, sms, p))
    return cudaErrorInvalidValue;
  if (p.cols == 4)
    return launch_windows<4, kThreads>(p, seg, counts, min_x, max_y, scale, ox, oy, B, nw, cap,
                                       win_rows, H, W, out, stream);
  if (p.cols == 2)
    return launch_windows<2, kThreads>(p, seg, counts, min_x, max_y, scale, ox, oy, B, nw, cap,
                                       win_rows, H, W, out, stream);
  return launch_windows<1, kSmallChunk>(p, seg, counts, min_x, max_y, scale, ox, oy, B, nw,
                                        cap, win_rows, H, W, out, stream);
}

extern "C" cudaError_t winding_banded(const float* seg, const int* owners, const int* min_x,
                                      const int* max_y, float scale, float ox, float oy,
                                      int B, int S, int R, int W, int* out,
                                      cudaStream_t stream) {
  return first_port::winding_banded(seg, owners, min_x, max_y, scale, ox, oy, B, S, R, W, out,
                                    stream);
}
