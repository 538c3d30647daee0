// What the winding, coverage and page kernels share: the per-(segment, row)
// root solve, the placement of a crossing among a row's columns, the warp
// suffix sum of the row scans, and the margin around a segment's y-hull
// outside which the root solve finds no crossing.
//
// The root solve is the float program of fontrx/kernels/winding_pallas_v2.py::
// phase_a_roots (lines 89-124), op for op, with left-to-right association
// as written. Built with -fmad=false and without fast math, so no
// multiply-add is contracted and '/' and sqrtf round correctly: the
// crossings are those of oracle.winding_at(contract=False).
#pragma once

#include <math.h>

// Calls emit(xx, sign) for each crossing, t in [0, 1), of the horizontal
// line at em-space height y_em with the quadratic segment
// q = (p0x, p0y, p1x, p1y, p2x, p2y). A crossing at xx adds sign to every
// sample with !(xx < cx). A zero-padded segment has no crossing.
template <class Emit>
__device__ __forceinline__ void segment_crossings(const float* q, float y_em, Emit&& emit) {
  const float p0x = q[0], p0y = q[1], p1x = q[2], p1y = q[3], p2x = q[4], p2y = q[5];
  const float a = p0y - 2.0f * p1y + p2y;
  const float ax = p0x - 2.0f * p1x + p2x;
  const float bx = 2.0f * (p1x - p0x);
  if (a == 0.0f) {
    // linear in y
    const float denom = p2y - p0y;
    if (denom != 0.0f) {
      const float t = (y_em - p0y) / denom;
      if (t >= 0.0f && t < 1.0f) {
        const float xx = (ax * t + bx) * t + p0x;
        emit(xx, p0y < p2y ? -1 : 1);
      }
    }
    return;
  }
  const float delta = y_em * a + p1y * p1y - p0y * p2y;
  if (!(delta >= 0.0f)) return;
  const float sq = sqrtf(delta);
  const float py01 = p0y - p1y;
  const float t0 = (py01 + sq) / a;
  if (t0 >= 0.0f && t0 < 1.0f) {
    const float xx = (ax * t0 + bx) * t0 + p0x;
    const float dy = a * t0 + (p1y - p0y);
    emit(xx, dy > 0.0f ? -1 : 1);
  }
  const float t1 = (py01 - sq) / a;
  if (t1 >= 0.0f && t1 < 1.0f) {
    const float xx = (ax * t1 + bx) * t1 + p0x;
    const float dy = a * t1 + (p1y - p0y);
    emit(xx, dy > 0.0f ? -1 : 1);
  }
}

// The count of columns c in [0, W) with !(xx < cx[c]), from a guess c moved
// while the predicate says so. cx is non-decreasing (int -> float, + offset
// and / scale > 0 are monotone), so the columns it covers are a prefix.
__device__ __forceinline__ int covered_from(float xx, const float* cx, int W, int c) {
  while (c < W && !(xx < cx[c])) ++c;
  while (c > 0 && xx < cx[c - 1]) --c;
  return c;
}

// How many of the n leading entries of the non-increasing cy satisfy pred.
template <class Pred>
__device__ __forceinline__ int leading(const float* cy, int n, Pred pred) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (pred((double)cy[mid])) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// Run by one whole warp: the sum of v over this lane and the lanes above it.
__device__ __forceinline__ int warp_suffix_sum(int v, int lane) {
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int t = __shfl_down_sync(0xffffffffu, v, off);
    if (lane + off < 32) v += t;
  }
  return v;
}

// The margin drops only pairs without a root: a sample row y outside
// [y_min - m, y_max + m] of a segment's control hull gets no root in [0, 1)
// from segment_crossings. Let u = 2^-24, M >= 1 bound |p0y|, |p1y|, |p2y|
// and |y| over the rows the caller tests, a' the program's rounded a.
// Nothing below depends on y being an integer or on the unit: it holds for
// any float32 sample y, in page pixels (page.cu) as in em units
// (coverage.cu).
//   - Line, a' == 0: t = fl(fl(y - p0y) / fl(p2y - p0y)). Rounding is
//     monotone, so for y above max(p0y, p2y) either p2y > p0y and
//     fl(y - p0y) >= fl(p2y - p0y) > 0, t >= 1, or p2y < p0y and t < 0,
//     unless the quotient underflows to -0, which needs y - p0y below
//     2^-149 * 2M < 2^-19; the same below. So a line crosses no row more
//     than 2^-19 off its hull; the margin is 1.
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
// It is computed in double, with the operations and order of
// kernels/page_ref.py::margin, which the CPU tests prove conservative on
// slivers, near-lines and on-row segments: in page pixels at oy = 0 and
// +-0.25 (tests/test_torch_page.py, test_torch_page_msaa.py), in em units
// at the k x k lattice's sub-rows (tests/test_torch_coverage.py).
// a is the program's rounded p0y - 2 p1y + p2y; ymax bounds |y|.
__device__ double segment_margin(float p0y, float p1y, float p2y, float a, double ymax) {
  constexpr double kU = 0x1p-24;
  if (a == 0.0f) return 1.0;
  double m = fmax(fmax(fabs((double)p0y), fabs((double)p1y)), fabs((double)p2y));
  m = fmax(fmax(m, ymax), 1.0);
  const double den = fabs((double)a) - 8.0 * m * kU;
  if (!(den > 0.0)) return INFINITY;
  return fmax(160.0 * m * m * kU / den + 32.0 * m * kU, 1.0);
}
