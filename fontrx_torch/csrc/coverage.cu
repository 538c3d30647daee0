// k x k supersampled nonzero coverage of quadratic glyph outlines, for
// Hopper (sm_90a).
//
// Replaces the TPU Pallas kernel K9,
// fontrx/kernels/coverage_pallas.py::_make_coverage_kernel (launcher
// coverage_pallas_batch). It computes, for every pixel, the fraction of its
// k x k sample points whose nonzero winding is not 0: float32 [B, H, W] in
// [0, 1]. Sample (kx, ky) of pixel (x, y) lies at em-space
//   cx = ((float)(min_x + x) + o[kx]) / scale,
//   cy = ((float)(max_y - y) + o[ky]) / scale,
//   o[i] = ((float)i + 0.5f) / (float)k - 0.5f,
// the float32 lattice of fontrx/kernels/coverage.py::sample_offsets, and its
// winding is the sum of the signs of the crossings of the row y = cy with
// every segment (crossings.cuh's float program) that do not lie right of cx.
// The result is (float)count * inv_k2, with inv_k2 the host's
// np.float32(1 / (k*k)): the rounding of the plain version and of both JAX
// routes (the Pallas kernel multiplies by f32(1/k^2); jnp's mean of k^2
// {0, 1} rows rounds the same way). A correctly rounded count / k^2 differs
// at some counts for k = 5, 6 and 7. The TPU kernel's chunk cull (+-1 unit,
// coverage_pallas.py:96-101) is exact and is not carried over.
//
// What bounded the first port: one block per (glyph, 16 rows) ran
// the k sub-rows one after another, staging every segment again for each
// (two barriers a chunk), solving every (segment, sub-row) pair with no
// y-hull cull, placing each crossing by k binary searches, and scanning
// each sub-row's k bucket rows 32 columns a step: k^2 scans of a row, each a
// dependent load and a five-step shuffle scan per 32 columns. At k = 2 it
// took 3.7-5.0x winding()'s time on the same glyphs (PERF.md).
//
// Design: one block per (glyph, band of `rows` rows), all k sub-rows of the
// band at once (a grid-stride loop over the blocks, so no grid limit binds).
//   1. cx[kx][c] for the k sub-columns and cy of the band's sub-rows go to
//      shared memory; the sub-rows are ordered so that cy falls with their
//      index, and the bucket planes [sub-row][kx][Wp] are zeroed (Wp = W
//      rounded up to 4: 16-byte rows).
//   2. The segments are staged in chunks of kChunk, a thread each, ONCE for
//      every sub-row. Each thread finds the run of sub-rows whose cy lies in
//      its segment's y-hull widened by segment_margin (crossings.cuh: the
//      same proof holds in em units, with the block's largest |cy|); a pair
//      outside it has no root, so the cull keeps every crossing. A block
//      prefix places each segment's kept (segment, sub-row) pairs in a list
//      in shared memory (16 bits a pair), and the threads take them
//      kThreads at a time (a binary search over the prefix instead made
//      cjk64 1.13x slower on an H100: PERF.md).
//   3. A crossing at xx adds its sign to cell c - 1 of each sub-column's
//      plane, c the count of columns with !(xx < cx[kx][c]): a guess from
//      xx * scale for kx = 0, then the previous sub-column's count (the
//      counts fall by at most one from kx to kx + 1), moved while the
//      predicate says so. The predicate decides, so the count is exact.
//   4. A warp a row makes one pass right to left over the row's k^2 planes:
//      each lane holds kCols (4, or 2 below 128 columns) consecutive cells
//      of a plane in one load, scans them in registers, and a warp suffix
//      scan of the lane totals finishes them; lane 0 folds the step's total
//      into the cell left of the step, so no carry is kept. The lane sums
//      (w != 0) over the planes in registers and stores (float)count *
//      inv_k2 for its columns in one 16- or 8-byte store: the warp's stores
//      are contiguous (scalar stores: ascii256 1.03x slower).
// When the k^2 planes of one row do not fit in shared memory, the block runs
// the sub-row offsets in groups (passes), staging the segments once a pass,
// and the output holds the count so far (an exact float) until the last
// pass; when not even one offset's planes fit beside a full chunk, one row
// a block with a 32-segment chunk and planes of exactly W cells, which
// needs less than the first port's block of one row. So every width the
// first port served is served. Winding and count are integer sums, so any
// order of the atomics gives the same result.
//
// What bounds it on an H100 (PERF.md): latency, not bytes or operations.
// On cjk64 the kept pairs' chains (the root solve's two correctly rounded
// divides and square root, then two searches and shared-memory atomics a
// crossing) take 0.12 of its 0.18 ms; without the y-hull cull it takes
// 2.4x as long (PERF.md). On ascii256 it is the block's serial phases
// (sample tables, staging with the FP64 margin, the pairs, the scan of 4
// planes a row and the output) over 7-row bands. Registers are capped for
// five blocks an SM; the bytes bound (segments in, coverage out) lies
// 6-25x below.
//
// Float rules: built with -fmad=false and without fast math (see
// crossings.cuh).

#include <cuda_runtime.h>
#include <stdint.h>

#include "crossings.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxRows = 16;                  // rows per block, fewer when the planes are wide
constexpr size_t kSmemTarget = 45 * 1024;     // five blocks an SM where the planes allow
constexpr size_t kSmemLimit = 227 * 1024;
constexpr int kMaxSubRows = 256;              // a pair names its sub-row in 8 bits
constexpr int kMinBlocks = 5;                 // blocks an SM: caps the registers at 51
constexpr int kSmallChunk = 32;               // the least block's chunk

__device__ __forceinline__ float lattice_offset(int i, int k) {
  return ((float)i + 0.5f) / (float)k - 0.5f;
}

// Shared memory of a block: the bucket planes, cx, cy, the staged chunk,
// the warps' pair counts and the chunk's pair list.
template <int kChunk>
size_t block_smem(int k, int W, int Wp, int rows, int group) {
  const size_t sub = (size_t)rows * group;
  return sub * k * Wp * sizeof(int) + (size_t)k * W * sizeof(float) + sub * sizeof(float) +
         (size_t)kChunk * 6 * sizeof(float) + kWarps * sizeof(int) +
         (size_t)kChunk * sub * sizeof(uint16_t);
}

// kCols: columns a lane holds in the scan; kChunk: segments staged at once.
template <int kCols, int kChunk>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
coverage_kernel(const float* __restrict__ seg, const int* __restrict__ min_x,
                const int* __restrict__ max_y, float scale, float inv_k2, int k, int S,
                int H, int W, int Wp, int rows, int group, int bands, long long blocks,
                float* __restrict__ out) {
  static_assert(kChunk % 32 == 0 && kChunk <= kThreads, "a chunk is whole warps");
  constexpr int kVec = kCols < 4 ? kCols : 4;  // ints a load
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int sub_max = rows * group;
  int* bucket = reinterpret_cast<int*>(smem_raw);  // [sub_max][k][Wp]
  float* cx = reinterpret_cast<float*>(bucket + (size_t)sub_max * k * Wp);  // [k][W]
  float* cy = cx + k * W;                           // [sub_max]
  float* sq = cy + sub_max;                         // [kChunk][6]
  int* s_warp = reinterpret_cast<int*>(sq + kChunk * 6);  // [kWarps]
  // [kChunk * sub_max]: a kept pair (segment t, sub-row s) as t | s << 8
  uint16_t* s_pairs = reinterpret_cast<uint16_t*>(s_warp + kWarps);

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int steps = (W + 32 * kCols - 1) / (32 * kCols);

  for (long long blk = blockIdx.x; blk < blocks; blk += gridDim.x) {
    const int b = (int)(blk / bands);
    const int row0 = (int)(blk - (long long)b * bands) * rows;
    const int live_rows = min(rows, H - row0);
    const int mx = min_x[b];
    const int my = max_y[b];
    const float* gseg = seg + (size_t)b * S * 6;
    const float o0 = lattice_offset(0, k);
    __syncthreads();  // the previous block's scans are done with cx
    for (int i = tid; i < k * W; i += kThreads) {
      const int c = i % W;
      cx[i] = ((float)(mx + c) + lattice_offset(i / W, k)) / scale;
    }

    for (int ky0 = 0; ky0 < k; ky0 += group) {
      const int g = min(group, k - ky0);
      const int n_sub = live_rows * g;
      const bool last = ky0 + g == k;
      const bool one_pass = ky0 == 0 && last;
      __syncthreads();  // the previous pass's scans are done with bucket and cy
      // sub-row s = r * g + j samples ky = ky0 + g - 1 - j: cy falls with s
      for (int s = tid; s < n_sub; s += kThreads) {
        const int r = s / g;
        const int ky = ky0 + g - 1 - (s - r * g);
        cy[s] = ((float)(my - (row0 + r)) + lattice_offset(ky, k)) / scale;
      }
      int4* b4 = reinterpret_cast<int4*>(bucket);
      for (int i = tid; i < n_sub * k * Wp / 4; i += kThreads) b4[i] = make_int4(0, 0, 0, 0);
      for (int i = n_sub * k * Wp / 4 * 4 + tid; i < n_sub * k * Wp; i += kThreads) bucket[i] = 0;
      __syncthreads();
      // the largest |y| of the pass's sub-rows: its first or last
      const double ymax = fmax(fabs((double)cy[0]), fabs((double)cy[n_sub - 1]));

      for (int s0 = 0; s0 < S; s0 += kChunk) {
        const int ns = min(kChunk, S - s0);
        // stage the chunk, a thread a segment, and take its run of sub-rows
        int count = 0, first = 0;
        if (tid < ns) {
          float q[6];
#pragma unroll
          for (int i = 0; i < 6; ++i) {
            q[i] = gseg[(size_t)(s0 + tid) * 6 + i];
            sq[tid * 6 + i] = q[i];
          }
          const float hmin = fminf(fminf(q[1], q[3]), q[5]);
          const float hmax = fmaxf(fmaxf(q[1], q[3]), q[5]);
          const float a = q[1] - 2.0f * q[3] + q[5];
          const double m = segment_margin(q[1], q[3], q[5], a, ymax);
          const double lo = (double)hmin - m, hi = (double)hmax + m;
          if (lo <= hi) {
            first = leading(cy, n_sub, [&](double y) { return y > hi; });
            count = max(leading(cy, n_sub, [&](double y) { return y >= lo; }) - first, 0);
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
          const int t = pair & 255, s = pair >> 8;
          int* brow = bucket + (size_t)s * k * Wp;
          segment_crossings(sq + t * 6, cy[s], [&](float xx, int sign) {
            // cx[0][c] <= xx for c up to about xx * scale - mx - o[0]
            const float guess = xx * scale - (float)mx - o0;
            int c;
            if (!(guess == guess)) {
              c = W;  // xx is NaN: !(xx < cx) everywhere
            } else {
              c = guess < 0.0f ? 0 : (guess >= (float)W ? W : (int)guess + 1);
            }
            for (int kx = 0; kx < k; ++kx) {
              c = covered_from(xx, cx + kx * W, W, c);
              if (c > 0) atomicAdd(&brow[kx * Wp + c - 1], sign);
            }
          });
        }
        __syncthreads();  // the chunk and its prefix are consumed
      }

      // a warp a row: one pass right to left over its g * k planes
      const int planes = g * k;
      for (int r = warp; r < live_rows; r += kWarps) {
        int* rb = bucket + (size_t)r * planes * Wp;
        float* orow = out + ((size_t)b * H + row0 + r) * W;
        for (int step = steps - 1; step >= 0; --step) {
          const int c0 = step * 32 * kCols + lane * kCols;
          int cnt[kCols] = {};
          for (int p = 0; p < planes; ++p) {
            int* cells = rb + (size_t)p * Wp;
            int v[kCols];
#pragma unroll
            for (int i = 0; i < kCols; i += kVec) {
              if (c0 + i < Wp) {
                if constexpr (kVec == 4) {
                  const int4 t = *reinterpret_cast<const int4*>(cells + c0 + i);
                  v[i] = t.x, v[i + 1] = t.y, v[i + 2] = t.z, v[i + 3] = t.w;
                } else if constexpr (kVec == 2) {
                  const int2 t = *reinterpret_cast<const int2*>(cells + c0 + i);
                  v[i] = t.x, v[i + 1] = t.y;
                } else {
                  v[i] = cells[c0 + i];
                }
              } else {
#pragma unroll
                for (int j = 0; j < kVec; ++j) v[i + j] = 0;
              }
            }
#pragma unroll
            for (int i = kCols - 2; i >= 0; --i) v[i] += v[i + 1];
            const int incl = warp_suffix_sum(v[0], lane);
            const int add = incl - v[0];  // the lanes to the right
#pragma unroll
            for (int i = 0; i < kCols; ++i) cnt[i] += (v[i] + add) != 0;
            // the step's total goes into the cell left of it, for the next step
            if (step > 0 && lane == 0) cells[c0 - 1] += incl;
          }
          __syncwarp();
          if (one_pass && kCols > 1 && W % kCols == 0) {
            // a lane's columns in one store: the warp's are contiguous
            if (c0 < W) {
              if constexpr (kCols == 4)
                *reinterpret_cast<float4*>(orow + c0) =
                    make_float4((float)cnt[0] * inv_k2, (float)cnt[1] * inv_k2,
                                (float)cnt[2] * inv_k2, (float)cnt[3] * inv_k2);
              else if constexpr (kCols == 2)
                *reinterpret_cast<float2*>(orow + c0) =
                    make_float2((float)cnt[0] * inv_k2, (float)cnt[1] * inv_k2);
            }
          } else {
#pragma unroll
            for (int i = 0; i < kCols; ++i) {
              const int c = c0 + i;
              if (c < W) {
                const float so_far = (ky0 > 0 ? orow[c] : 0.0f) + (float)cnt[i];
                orow[c] = last ? so_far * inv_k2 : so_far;
              }
            }
          }
        }
      }
    }
  }
}

template <int kCols, int kChunk>
cudaError_t launch(const float* seg, const int* min_x, const int* max_y, float scale,
                   float inv_k2, int k, int B, int S, int H, int W, int Wp, int rows, int group,
                   size_t smem, float* out, cudaStream_t stream) {
  auto kernel = coverage_kernel<kCols, kChunk>;
  if (smem > 48 * 1024) {
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const int bands = (H + rows - 1) / rows;
  const long long blocks = (long long)B * bands;
  const unsigned grid = (unsigned)(blocks < 0x7fffffffLL ? blocks : 0x7fffffffLL);
  kernel<<<grid, kThreads, smem, stream>>>(seg, min_x, max_y, scale, inv_k2, k, S, H, W, Wp,
                                           rows, group, bands, blocks, out);
  return cudaGetLastError();
}

// A launch's shape: columns a lane in the scan, segments a chunk, rows a
// block, sub-row offsets a pass, shared memory. All k sub-rows a pass where
// a row's k^2 planes fit, else as many as fit; as many rows as fit the
// target, up to kMaxRows. When not one offset fits beside a full chunk,
// the least a block can hold: one row, one offset a pass, planes of exactly
// W cells and a small chunk; never more than the first port needed for one
// row. False when not even that fits.
struct Plan {
  int cols, chunk, rows, group, Wp;
  size_t smem;
};

bool make_plan(int k, int H, int W, Plan& p) {
  const int Wp = (W + 3) / 4 * 4;
  constexpr int kChunk = kThreads;
  int group = k < kMaxSubRows ? k : kMaxSubRows;
  while (group > 0 && block_smem<kChunk>(k, W, Wp, 1, group) > kSmemLimit) --group;
  if (group > 0) {
    const int cap = kMaxRows < H ? kMaxRows : H;
    int rows = 1;
    while (rows < cap && (rows + 1) * group <= kMaxSubRows &&
           block_smem<kChunk>(k, W, Wp, rows + 1, group) <= kSmemTarget)
      ++rows;
    p = {W >= 128 ? 4 : 2, kChunk, rows, group, Wp, block_smem<kChunk>(k, W, Wp, rows, group)};
    return true;
  }
  p = {1, kSmallChunk, 1, 1, W, block_smem<kSmallChunk>(k, W, W, 1, 1)};
  return p.smem <= kSmemLimit;
}

}  // namespace

// The plan coverage() launches for k, H, W into plan[6]: {cols, chunk,
// rows, group, Wp, shared bytes}; cudaErrorInvalidValue when no block fits.
extern "C" cudaError_t coverage_plan(int k, int H, int W, int* plan) {
  Plan p;
  if (k < 1 || H < 1 || W < 1 || !make_plan(k, H, W, p)) return cudaErrorInvalidValue;
  const int v[6] = {p.cols, p.chunk, p.rows, p.group, p.Wp, (int)p.smem};
  for (int i = 0; i < 6; ++i) plan[i] = v[i];
  return cudaSuccess;
}

extern "C" cudaError_t coverage(const float* seg, const int* min_x, const int* max_y,
                                float scale, float inv_k2, int k, int B, int S, int H,
                                int W, float* out, cudaStream_t stream) {
  if (B < 0 || S < 0 || H < 0 || W < 0 || k < 1 || !(scale > 0.0f))
    return cudaErrorInvalidValue;
  if (B == 0 || H == 0 || W == 0) return cudaSuccess;
  Plan p;
  if (!make_plan(k, H, W, p)) return cudaErrorInvalidValue;
  if (p.cols == 4)
    return launch<4, kThreads>(seg, min_x, max_y, scale, inv_k2, k, B, S, H, W, p.Wp, p.rows,
                               p.group, p.smem, out, stream);
  if (p.cols == 2)
    return launch<2, kThreads>(seg, min_x, max_y, scale, inv_k2, k, B, S, H, W, p.Wp, p.rows,
                               p.group, p.smem, out, stream);
  return launch<1, kSmallChunk>(seg, min_x, max_y, scale, inv_k2, k, B, S, H, W, p.Wp, 1, 1,
                                p.smem, out, stream);
}
