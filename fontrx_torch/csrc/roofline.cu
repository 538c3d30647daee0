// The roofline probe's saturating elementwise microkernel, for Hopper (sm_90a).
//
// Replaces the TPU Pallas kernel
//   K13  tools/tpu_probes/tpu_roofline.py::_bench_elementwise,
// which applies one op K * UNROLL = 128 * 8 = 1024 times, each application
// depending on the last, to every element of a [16, 512, 128] block and
// writes the result once. The four mixes
// (tpu_roofline.py:122-138), with the reference's constants in float32:
//   0  f32 mul+add         x = x * 1.000001f + 1e-7f        (2 ops)
//   1  i32 add             x = x + 3                        (1 op)
//   2  i16 add             x = x + (int16)3                 (1 op)
//   3  f32 cmp+select+add  x = x + (x >= 0.5f ? 1e-7f : -1e-7f)  (3 ops)
// Its result is only the instrument; the time is the measurement. The plain
// version is fontrx_torch/kernels/roofline_ref.py.
//
// Design: one thread per element, 256 threads a block. Each thread reads its
// element once, keeps it in a register through the `iters` applications and
// writes it once, so the probe is bound by issue, not by bytes: 1024
// dependent applications for 8 bytes of traffic a 32-bit element. The
// [16, 512, 128] shape is 4096 blocks, about four waves of 8 resident blocks
// on 132 SMs; each scheduler holds 16 warps, more than the 4-cycle latency
// of a dependent FADD/FMUL needs to issue every cycle, so one element a
// thread is enough.
//
// The trap is the compiler, and only the SASS shows it: a folded or fused
// chain gives the same results. Each mix is checked in `cuobjdump -sass`
// (fontrx_torch/bench/roofline.py, run by chip_smoke.py), which fails when an
// application issues fewer than the modelled instructions:
//   - f32: built with -fmad=false, so x * a + b stays an FMUL and an FADD and
//     never becomes an FFMA; no fast math, so nothing is reassociated. The
//     compare and select are an FSETP and an FSEL.
//   - int: LLVM folds a chain of `x += 3` into one add (x += 3n, even for a
//     run-time n), so each add is inline PTX, `asm volatile`. That is not
//     enough: ptxas folded eight `add.s32 x, x, 3` into one VIADD of 0x18,
//     and with a register addend fused pairs into IMAD x = c * 2 + x (nvcc
//     12.9 for sm_90a). So each add is predicated, `@p add.s32`, on p = (n !=
//     0): true in every thread that runs (i < n), and not provable by ptxas,
//     which then keeps one add per application. It spreads them over two
//     pipes, VIADD and IADD3.
// int16 adds run in 32-bit registers (VIADD/IADD3); the load and the store
// are 16-bit, and the sum mod 2^16 is the same.
//
// A look at the SASS and a sweep changed the loop, not the launch (H100 80GB
// HBM3 at 700 W): each loop trip costs a counter add, a compare
// and a branch, so 32 applications a trip (the reference has 8) took f32
// mul+add from 0.0817 to 0.0724 ms and the i32 add from 0.0589 to 0.0423 ms.
// Blocks of 128, 256, 512 and 1024 threads were within 3.4% of each other
// (the widest spread, in cmp+select+add); 256 stayed.
//
// The loop count is a run-time argument, as `K + seed * 0` is in the
// reference, so the compiler cannot treat it as a constant.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 32;  // applications per loop trip

struct MulAdd {
  __device__ __forceinline__ float operator()(float x) const { return x * 1.000001f + 1e-7f; }
};

// x + 3 as one predicated add; live = n != 0 in every thread that runs
struct AddS32 {
  int live;
  __device__ __forceinline__ int operator()(int x) const {
    asm volatile("{ .reg .pred p; setp.ne.s32 p, %1, 0; @p add.s32 %0, %0, 3; }"
                 : "+r"(x) : "r"(live));
    return x;
  }
};

struct AddS16 {
  int live;
  __device__ __forceinline__ short operator()(short x) const {
    asm volatile("{ .reg .pred p; setp.ne.s32 p, %1, 0; @p add.s16 %0, %0, 3; }"
                 : "+h"(x) : "r"(live));
    return x;
  }
};

struct CmpSelectAdd {
  __device__ __forceinline__ float operator()(float x) const {
    return x + (x >= 0.5f ? 1e-7f : -1e-7f);
  }
};

template <typename T, typename Op>
__device__ __forceinline__ void saturate(const T* __restrict__ x, T* __restrict__ out, int n,
                                         int rounds, Op op) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  T v = x[i];
#pragma unroll 1  // one loop of kUnroll applications, no remainder loop
  for (int r = 0; r < rounds; ++r) {
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) v = op(v);
  }
  out[i] = v;
}

}  // namespace

// One kernel per mix, with unmangled names, so that `cuobjdump -sass` lists
// each loop under its mix's name.
extern "C" __global__ void __launch_bounds__(kThreads)
roofline_f32_mul_add(const float* x, float* out, int n, int rounds) {
  saturate(x, out, n, rounds, MulAdd{});
}

extern "C" __global__ void __launch_bounds__(kThreads)
roofline_i32_add(const int* x, int* out, int n, int rounds) {
  saturate(x, out, n, rounds, AddS32{n});
}

extern "C" __global__ void __launch_bounds__(kThreads)
roofline_i16_add(const short* x, short* out, int n, int rounds) {
  saturate(x, out, n, rounds, AddS16{n});
}

extern "C" __global__ void __launch_bounds__(kThreads)
roofline_f32_cmp_select_add(const float* x, float* out, int n, int rounds) {
  saturate(x, out, n, rounds, CmpSelectAdd{});
}

// Applications per loop trip: iters must be a multiple.
extern "C" int roofline_unroll() { return kUnroll; }

// mix: 0 f32 mul+add, 1 i32 add, 2 i16 add, 3 f32 cmp+select+add. x and out
// hold n elements of the mix's type; iters is a multiple of kUnroll, else
// cudaErrorInvalidValue.
extern "C" cudaError_t roofline(int mix, const void* x, void* out, int n, int iters,
                                cudaStream_t stream) {
  if (n < 0 || iters < 0 || iters % kUnroll != 0) return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  const unsigned blocks = (unsigned)((n + kThreads - 1) / kThreads);
  const int rounds = iters / kUnroll;
  switch (mix) {
    case 0:
      roofline_f32_mul_add<<<blocks, kThreads, 0, stream>>>(
          (const float*)x, (float*)out, n, rounds);
      break;
    case 1:
      roofline_i32_add<<<blocks, kThreads, 0, stream>>>((const int*)x, (int*)out, n, rounds);
      break;
    case 2:
      roofline_i16_add<<<blocks, kThreads, 0, stream>>>(
          (const short*)x, (short*)out, n, rounds);
      break;
    case 3:
      roofline_f32_cmp_select_add<<<blocks, kThreads, 0, stream>>>(
          (const float*)x, (float*)out, n, rounds);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}
