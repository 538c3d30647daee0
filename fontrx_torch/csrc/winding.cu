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
// foreign segment's crossings on every row. Here the blocks run the same
// culled band body as winding(), one per (element, band, band of the band's
// rows) from make_plan(B x R, 128 / R, W, sms), in the same grid-stride loop,
// and only the staging differs (OwnedBy): a block first lists the indices of
// the element's segments whose owner is its band in shared memory, in their
// order, with a warp ballot and popc per 32 owners, and its chunk loop runs
// over that list. A foreign segment costs one owner read and no pair. Where
// the list would not fit the room the plan leaves below kSmemTarget, the
// owners are taken in windows of the list's capacity (banded_list_cap), each
// listed and then solved. Their chunk cull and K6's x-window cull are exact
// and not carried over, and neither are the TPU's lane layout and the
// transposed output: each band's rows are written straight into
// out[b][k * 128/R + row][:]. winding_banded_plan() exports the plan. Bound
// as winding() is: its pairs are those of the per-glyph winding() on the same
// glyphs, plus one owner read per (segment, band).
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

// --- the culled band body: all three entries -------------------------------

constexpr int kMaxRows = 64;               // rows per block, fewer when W is wide
constexpr size_t kSmemTarget = 45 * 1024;  // five blocks an SM where the rows allow
constexpr int kMinBlocks = 5;              // blocks an SM: caps the registers at 51
constexpr int kSmallChunk = 32;            // the least block's chunk
constexpr int kFillBlocksPerSM = 2;        // a small batch is cut to fill this many blocks an SM
constexpr int kMinRows = 8;                // the shortest band a small batch is cut into
static_assert(kMaxRows <= 256, "a pair names its row in 8 bits");

// Shared memory of a block: the bucket rows, cx, cy, the staged chunk, the
// warps' pair counts and the chunk's pair list. winding_banded()'s list of
// its band's segments follows it.
__host__ __device__ size_t block_smem(int chunk, int W, int Wp, int rows) {
  return (size_t)rows * Wp * sizeof(int) + (size_t)W * sizeof(float) +
         (size_t)rows * sizeof(float) + (size_t)chunk * 6 * sizeof(float) +
         kWarps * sizeof(int) + (size_t)chunk * rows * sizeof(uint16_t);
}

// The staging step of culled_band: it calls solve(seg, n) once per pass over
// the glyph's segments, where seg(i) points at the pass's i-th segment
// (p0x p0y p1x p1y p2x p2y in device memory), i in [0, n). Every thread of
// the block calls it; s_warp is kWarps ints of shared memory it may use
// between barriers.
//
// winding() and winding_windows(): the segments gseg[0, S), one pass.
struct AllSegments {
  const float* gseg;
  int S;

  template <class Solve>
  __device__ __forceinline__ void operator()(int* s_warp, Solve&& solve) const {
    solve([&](int i) { return gseg + (size_t)i * 6; }, S);
  }
};

// winding_banded(): the segments gseg[0, S) whose owner is `band`, in their
// order, listed in windows of `cap` owners. For each window the block reads
// its owners, kThreads at a time; a warp ballot, its popc and the warps'
// counts place each owned index in `list` (cap ints of shared memory); the
// pass then solves the listed segments.
struct OwnedBy {
  const float* gseg;
  const int* owners;
  int S, band, cap;
  int* list;

  template <class Solve>
  __device__ __forceinline__ void operator()(int* s_warp, Solve&& solve) const {
    const int tid = threadIdx.x;
    const int lane = tid & 31, warp = tid >> 5;
    for (int w0 = 0; w0 < S; w0 += cap) {
      const int end = min(S, w0 + cap);
      int n = 0;
      for (int o = w0 + tid; o - tid < end; o += kThreads) {
        const bool mine = o < end && owners[o] == band;
        const unsigned m = __ballot_sync(0xffffffffu, mine);
        if (lane == 0) s_warp[warp] = __popc(m);
        __syncthreads();
        int pos = n + __popc(m & ((1u << lane) - 1u));
#pragma unroll
        for (int w = 0; w < kWarps; ++w) {
          const int t = s_warp[w];
          if (w < warp) pos += t;
          n += t;
        }
        if (mine) list[pos] = o;
        __syncthreads();  // the counts are read; the window's list is whole
      }
      solve([&](int i) { return gseg + (size_t)list[i] * 6; }, n);
    }
  }
};

// One block's work in all three entries: the winding of the rows [row0, row0
// + rows) of one glyph from the segments that `stage` hands it, written to
// out_rows (row major, W columns). rows_cap is the plan's rows, which sizes
// the shared memory; kCols the cells a lane holds in the scan; kChunk the
// segments staged at once.
template <int kCols, int kChunk, class Stage>
__device__ __forceinline__ void culled_band(const Stage& stage, int mx, int my, float scale,
                                            float ox, float oy, int row0, int rows,
                                            int rows_cap, int W, int Wp, unsigned char* smem,
                                            int* __restrict__ out_rows) {
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

  // the segments, a chunk at a time, in each pass that the staging step makes
  stage(s_warp, [&](auto seg, int S) {
    for (int s0 = 0; s0 < S; s0 += kChunk) {
      const int ns = min(kChunk, S - s0);
      // stage the chunk, a thread a segment, and take its run of rows
      int count = 0, first = 0;
      if (tid < ns) {
        float q[6];
        const float* g = seg(s0 + tid);
#pragma unroll
        for (int i = 0; i < 6; ++i) {
          q[i] = g[i];
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
  });

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
    culled_band<kCols, kChunk>(AllSegments{seg + (size_t)b * S * 6, S}, min_x[b], max_y[b],
                               scale, ox, oy, row0, min(rows, H - row0), rows, W, Wp, smem_raw,
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
    culled_band<kCols, kChunk>(AllSegments{seg + (size_t)bw * cap * 6, n}, min_x[b], max_y[b],
                               scale, ox, oy, (int)row0, (int)min((long long)rows, end - row0),
                               rows, W, Wp, smem_raw, out + ((size_t)b * H + row0) * W);
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

// --- winding_banded(): the strips ---------------------------------------------

constexpr int kStripRows = 128;  // rows of a banded element's strip

// The capacity of winding_banded()'s list of a band's segments, in ints: the
// room the plan leaves below kSmemTarget, at least one pass of the owners
// (kThreads), at most S rounded up to whole warps, and no more than
// kSmemLimit leaves. 0 when not even one fits.
int banded_list_cap(const Plan& p, int S) {
  long long cap = ((long long)kSmemTarget - (long long)p.smem) / (long long)sizeof(int);
  if (cap < kThreads) cap = kThreads;
  const long long whole = ((long long)S + 31) / 32 * 32;
  if (cap > whole) cap = whole > 32 ? whole : 32;
  const long long room = ((long long)kSmemLimit - (long long)p.smem) / (long long)sizeof(int);
  if (cap > room) cap = room;
  return (int)(cap > 0 ? cap : 0);
}

// winding_banded(): blocks (element, band, band of `rows` of the band's
// band_h rows), the element's segments that the band owns.
template <int kCols, int kChunk>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
winding_banded_kernel(const float* __restrict__ seg, const int* __restrict__ owners,
                      const int* __restrict__ min_x, const int* __restrict__ max_y, float scale,
                      float ox, float oy, int B, int S, int R, int band_h, int W, int Wp,
                      int rows, int subs, int cap, long long blocks, int* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  int* list = reinterpret_cast<int*>(smem_raw + block_smem(kChunk, W, Wp, rows));
  for (long long blk = blockIdx.x; blk < blocks; blk += gridDim.x) {
    const long long bk = blk / subs;  // b * R + k
    const int b = (int)(bk / R);
    const int k = (int)(bk - (long long)b * R);
    const int row0 = (int)(blk - bk * subs) * rows;  // in the band
    const size_t anchor = (size_t)k * B + b;
    const OwnedBy stage{seg + (size_t)b * S * 6, owners + (size_t)b * S, S, k, cap, list};
    culled_band<kCols, kChunk>(stage, min_x[anchor], max_y[anchor], scale, ox, oy, row0,
                               min(rows, band_h - row0), rows, W, Wp, smem_raw,
                               out + ((size_t)b * kStripRows + k * band_h + row0) * W);
  }
}

// The plan of winding_banded() for B elements of S segments in R bands of W
// columns on a card of `sms` SMs: winding()'s plan for B x R glyphs of 128 /
// R rows, and the list's capacity.
bool banded_plan(int B, int S, int R, int W, int sms, Plan& p, int& cap) {
  if (!make_plan((long long)B * R, kStripRows / R, W, sms, p)) return false;
  cap = banded_list_cap(p, S);
  return cap > 0;
}

template <int kCols, int kChunk>
cudaError_t launch_banded(const Plan& p, int cap, const float* seg, const int* owners,
                          const int* min_x, const int* max_y, float scale, float ox, float oy,
                          int B, int S, int R, int W, int* out, cudaStream_t stream) {
  auto kernel = winding_banded_kernel<kCols, kChunk>;
  const size_t smem = p.smem + (size_t)cap * sizeof(int);
  const cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const int band_h = kStripRows / R;
  const int subs = (band_h + p.rows - 1) / p.rows;
  const long long blocks = (long long)B * R * subs;
  kernel<<<grid_of(blocks), kThreads, smem, stream>>>(seg, owners, min_x, max_y, scale, ox, oy,
                                                      B, S, R, band_h, W, p.Wp, p.rows, subs,
                                                      cap, blocks, out);
  return cudaGetLastError();
}

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

// The plan winding_banded() launches for B elements of S segments in R bands
// of W columns on a card of `sms` SMs into plan[5]: {rows, chunk, cells a
// lane, shared bytes with the list, the list's capacity in segments};
// cudaErrorInvalidValue when no block fits or R does not divide 128.
extern "C" cudaError_t winding_banded_plan(int B, int S, int R, int W, int sms, int* plan) {
  if (B < 1 || S < 0 || R < 1 || kStripRows % R != 0 || W < 1 || sms < 1)
    return cudaErrorInvalidValue;
  Plan p;
  int cap = 0;
  if (!banded_plan(B, S, R, W, sms, p, cap)) return cudaErrorInvalidValue;
  const int v[5] = {p.rows, p.chunk, p.cols, (int)(p.smem + (size_t)cap * sizeof(int)), cap};
  for (int i = 0; i < 5; ++i) plan[i] = v[i];
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
  if (B < 0 || S < 0 || R < 1 || kStripRows % R != 0 || W < 0 || !(scale > 0.0f))
    return cudaErrorInvalidValue;
  if (B == 0 || W == 0) return cudaSuccess;
  int sms = 0;
  const cudaError_t err = sm_count(sms);
  if (err != cudaSuccess) return err;
  Plan p;
  int cap = 0;
  if (!banded_plan(B, S, R, W, sms, p, cap)) return cudaErrorInvalidValue;
  if (p.cols == 4)
    return launch_banded<4, kThreads>(p, cap, seg, owners, min_x, max_y, scale, ox, oy, B, S, R,
                                      W, out, stream);
  if (p.cols == 2)
    return launch_banded<2, kThreads>(p, cap, seg, owners, min_x, max_y, scale, ox, oy, B, S, R,
                                      W, out, stream);
  return launch_banded<1, kSmallChunk>(p, cap, seg, owners, min_x, max_y, scale, ox, oy, B, S,
                                       R, W, out, stream);
}
