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
// Design: one block per (glyph, band of rows).
//   1. cx[c] = ((float)(min_x + c) + ox) / scale goes to shared memory.
//   2. Segments stream through shared memory in chunks. Each thread solves one
//      (segment, row) pair with the float program of
//      winding_pallas_v2.py::phase_a_roots (lines 89-124), op for op
//      (segment_crossings, crossings.cuh).
//   3. A live crossing at em-x xx covers the columns with !(xx < cx[c]), a
//      prefix [0, k) since cx is non-decreasing. k is found by binary search
//      with the same predicate, and the sign is added to bucket[row][k] with
//      a shared-memory atomic (deposit, crossings.cuh).
//   4. out[row][c] = sum of bucket[row][j] for j > c: one warp per row runs a
//      suffix scan (suffix_scan_row, crossings.cuh) and writes the row with
//      coalesced stores.
// Winding is an integer sum, so any order of the atomics gives the same map.
//
// Where its time goes on an H100: arithmetic per (segment, row) pair (two
// f32 divides and a square root, then a binary search over the row's columns)
// and shared-memory atomics. Bytes (24 B a segment in, 4 B a pixel out) set
// a floor far below that (fontrx_torch/bound.py). The design therefore
// solves each (segment, row) once, never per pixel, and turns the per-pixel
// work into one scan per row. Row culling by the segments' y-hull,
// cp.async/TMA staging and persistent blocks are left for later.
//
// A second entry, winding_windows(), replaces K3,
//   fontrx/kernels/winding_dense.py::winding_dense_win_batch (body
//   _make_dense_win_kernel), the window-packed route of the small-tile atlas
//   (RasterEngine.winding_batch(windows=...)). Its input is a window-major
//   stream (fontrx_torch/pack/windows.py): window w of glyph b holds
//   counts[b][w] copies of the segments whose hull can reach its rows
//   [w * win_rows, (w + 1) * win_rows). K3 solves each copy on its window's
//   rows and on no other, so a root that the float program finds outside a
//   segment's windows is dropped: the stream defines the function. One block
//   per (glyph, window) runs the same band body as winding() over the
//   window's live copies and its rows below H, and writes them straight into
//   [B, H, W]: the TPU's lane groups, its fold across them and the stitching
//   of windows are gone. The row cull is the pack's: on the CJK atlases
//   the copies' (segment, row) pairs are 0.54-0.65 of those winding() solves.
//   It cuts the root solves that find no crossing, not the crossings: each
//   is still placed by a binary search and a shared-memory atomic, and the
//   rows are still zeroed and scanned, so the time falls by less than the
//   pairs do (PERF.md).
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
// rows are written straight into out[b][k * 128/R + row][:]. Bound as
// winding() is: its pairs are those of the per-glyph winding() on the same
// glyphs.
//
// Float rules: the library is built with -fmad=false, so no multiply-add is
// contracted (the oracle's contract=False mode), and without fast math, so
// '/' and sqrtf round correctly and denormals are kept.

#include <cuda_runtime.h>
#include <stdint.h>

#include "crossings.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxRows = 16;        // rows per block, fewer when W is wide
constexpr int kSegChunk = 64;       // segments staged per shared-memory chunk
constexpr int kStripRows = 128;     // rows of a banded element's strip
constexpr size_t kSmemLimit = 227 * 1024;

static_assert(kSegChunk % 32 == 0 && kSegChunk <= kThreads, "a chunk is whole warps");

struct SegmentChunk {
  float v[kSegChunk * 6];           // p0x p0y p1x p1y p2x p2y per segment
};

// Stages the segments [s0, s0 + n) of a glyph's array into the chunk, as
// they are; returns n.
struct Contiguous {
  const float* gseg;

  __device__ __forceinline__ int operator()(float* v, int s0, int n) const {
    for (int i = threadIdx.x; i < n * 6; i += kThreads) v[i] = gseg[(size_t)s0 * 6 + i];
    return n;
  }
};

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

// One block's work in every kernel: the winding of the rows [row0, row0 +
// rows) of one glyph from the segments that `stage` puts in the chunk from
// its array [0, S), written to out_rows (row major, W columns). smem holds
// the segment chunk, cy[rows], cx[W] and bucket[rows][W + 1]. Every thread
// calls stage, between two barriers.
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

// winding(): one block per (glyph, band of `rows` rows), every segment.
__global__ void __launch_bounds__(kThreads)
winding_kernel(const float* __restrict__ seg, const int* __restrict__ min_x,
               const int* __restrict__ max_y, float scale, float ox, float oy,
               int S, int H, int W, int rows, int* __restrict__ out) {
  extern __shared__ unsigned char smem_raw[];
  const int b = blockIdx.x;
  const int row0 = blockIdx.y * rows;
  band_winding(Contiguous{seg + (size_t)b * S * 6}, S, min_x[b], max_y[b], scale, ox, oy,
               row0, min(rows, H - row0), W, smem_raw, out + ((size_t)b * H + row0) * W);
}

// winding_windows(): one block per (glyph, window), the window's live copies
// on its rows below H.
__global__ void __launch_bounds__(kThreads)
winding_windows_kernel(const float* __restrict__ seg, const int* __restrict__ counts,
                       const int* __restrict__ min_x, const int* __restrict__ max_y,
                       float scale, float ox, float oy, int nw, int cap, int win_rows,
                       int H, int W, int* __restrict__ out) {
  extern __shared__ unsigned char smem_raw[];
  const int bw = blockIdx.x;  // b * nw + w, also the index of counts[b][w]
  const int b = bw / nw;
  const int row0 = (bw - b * nw) * win_rows;
  const int n = min(max(counts[bw], 0), cap);
  band_winding(Contiguous{seg + (size_t)bw * cap * 6}, n, min_x[b], max_y[b], scale, ox, oy,
               row0, min(win_rows, H - row0), W, smem_raw, out + ((size_t)b * H + row0) * W);
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

}  // namespace

extern "C" cudaError_t winding(const float* seg, const int* min_x, const int* max_y,
                               float scale, float ox, float oy, int B, int S, int H,
                               int W, int* out, cudaStream_t stream) {
  if (B < 0 || S < 0 || H < 0 || W < 0 || !(scale > 0.0f)) return cudaErrorInvalidValue;
  if (B == 0 || H == 0 || W == 0) return cudaSuccess;

  const size_t fixed = sizeof(SegmentChunk) + (size_t)W * sizeof(float);
  const size_t per_row = sizeof(float) + (size_t)(W + 1) * sizeof(int);
  if (fixed + per_row > kSmemLimit) return cudaErrorInvalidValue;
  int rows = (int)((kSmemLimit - fixed) / per_row);
  if (rows > kMaxRows) rows = kMaxRows;
  if (rows > H) rows = H;
  const size_t smem = fixed + (size_t)rows * per_row;
  const int bands = (H + rows - 1) / rows;
  if (bands > 65535) return cudaErrorInvalidValue;

  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        winding_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  dim3 grid((unsigned)B, (unsigned)bands);
  winding_kernel<<<grid, kThreads, smem, stream>>>(seg, min_x, max_y, scale, ox, oy,
                                                   S, H, W, rows, out);
  return cudaGetLastError();
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

  const int rows = win_rows < H ? win_rows : H;
  const size_t smem = sizeof(SegmentChunk) + (size_t)W * sizeof(float) +
                      (size_t)rows * (sizeof(float) + (size_t)(W + 1) * sizeof(int));
  if (smem > kSmemLimit) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        winding_windows_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  winding_windows_kernel<<<(unsigned)(B * nw), kThreads, smem, stream>>>(
      seg, counts, min_x, max_y, scale, ox, oy, nw, cap, win_rows, H, W, out);
  return cudaGetLastError();
}

extern "C" cudaError_t winding_banded(const float* seg, const int* owners, const int* min_x,
                                      const int* max_y, float scale, float ox, float oy,
                                      int B, int S, int R, int W, int* out,
                                      cudaStream_t stream) {
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
