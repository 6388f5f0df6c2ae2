// localised_copy: R passes of y = fma(y, 1.0001f, 1.0f) over every element,
// in fp32 registers, one read and one write of the array.
//
// Replaces the TPU kernel src/repro/kernels/localised_copy.py::localised_copy
// (the paper's Fig-1 kernel).  The TPU kernel gives each (1, L) row one grid
// step and keeps the row in VMEM for the R passes; a 12.5 M-element row does
// not fit a block here, and the work is elementwise, so the grid is not
// carried over: each thread loads 16 bytes (4 f32 or 8 bf16 values) per
// vector, runs the R passes in registers and stores once.  A grid-stride
// loop covers the vectors; the tail (and a buffer not 16-byte aligned) goes
// element by element.
//
// Arithmetic: each pass is one correctly rounded fused multiply-add,
// __fmaf_rn(y, 1.0001f, 1.0f), which is what XLA emits for the reference's
// `y * 1.0001 + 1.0` (bit for bit on the CPU); 1.0001f is the f32-rounded
// constant.  bf16 is widened with __bfloat162float and narrowed once, with
// __float2bfloat16_rn, after the last pass.
//
// Bound on an H100 SXM: the larger of the bytes (n read + n written, each
// itemsize bytes, over 3.35 TB/s: 0.239 ms for 100 M f32) and the R * n
// FMAs (2 flops each over 67 TFLOP/s fp32: 0.382 ms for 100 M at R = 128).
// Below R ~ 80 (f32) the kernel is bound by bytes, above it by the fp32
// pipe; the passes never touch memory, which is the Fig-1 point.
#include <cuda_bf16.h>
//
// Launch plan: the host code is one template over the executors of
// launch_plan.cuh, so `repro_localised_copy_plan` is a dry run of exactly the
// launches `repro_localised_copy` makes (held equal to the Python
// `repro_torch.kernels.localised_copy.plan` on the card).
#include <cuda_runtime.h>
#include <stdint.h>

#include "launch_plan.cuh"

namespace {

constexpr int LC_THREADS = 256;
constexpr int LC_MAX_BLOCKS = 132 * 16;

__device__ __forceinline__ float passes(float y, int reps) {
  for (int r = 0; r < reps; ++r) y = __fmaf_rn(y, 1.0001f, 1.0f);
  return y;
}

__global__ void lc_f32(const float* __restrict__ x, float* __restrict__ y,
                       long long n, int reps, int vec) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long t0 = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long nv = vec ? n / 4 : 0;
  for (long long i = t0; i < nv; i += stride) {
    float4 v = reinterpret_cast<const float4*>(x)[i];
    v.x = passes(v.x, reps);
    v.y = passes(v.y, reps);
    v.z = passes(v.z, reps);
    v.w = passes(v.w, reps);
    reinterpret_cast<float4*>(y)[i] = v;
  }
  for (long long i = nv * 4 + t0; i < n; i += stride) y[i] = passes(x[i], reps);
}

__global__ void lc_bf16(const __nv_bfloat16* __restrict__ x,
                        __nv_bfloat16* __restrict__ y, long long n, int reps,
                        int vec) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long t0 = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long nv = vec ? n / 8 : 0;
  for (long long i = t0; i < nv; i += stride) {
    uint4 raw = reinterpret_cast<const uint4*>(x)[i];
    __nv_bfloat16* h = reinterpret_cast<__nv_bfloat16*>(&raw);
#pragma unroll
    for (int e = 0; e < 8; ++e)
      h[e] = __float2bfloat16_rn(passes(__bfloat162float(h[e]), reps));
    reinterpret_cast<uint4*>(y)[i] = raw;
  }
  for (long long i = nv * 8 + t0; i < n; i += stride)
    y[i] = __float2bfloat16_rn(passes(__bfloat162float(x[i]), reps));
}

}  // namespace

extern "C" const char* repro_localised_copy_error(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

namespace {

// The host code, once for launching and for planning (launch_plan.cuh).
// `vec`: both buffers 16-byte aligned, so the 16-byte vector loop runs.
template <class Exec>
int run(Exec& ex, const void* x, void* y, long long n, int reps, int is_bf16,
        int vec, cudaStream_t st) {
  if (n == 0) return 0;
  const long long per = is_bf16 ? 8 : 4;
  const long long work = vec ? (n + per - 1) / per : n;
  long long blocks = (work + LC_THREADS - 1) / LC_THREADS;
  if (blocks > LC_MAX_BLOCKS) blocks = LC_MAX_BLOCKS;
  const dim3 grid((unsigned)blocks);
  if (is_bf16)
    return ex("lc_bf16", (const void*)lc_bf16, grid, LC_THREADS, 0, [&] {
      lc_bf16<<<grid, LC_THREADS, 0, st>>>((const __nv_bfloat16*)x,
                                           (__nv_bfloat16*)y, n, reps, vec);
      return cudaSuccess;
    });
  return ex("lc_f32", (const void*)lc_f32, grid, LC_THREADS, 0, [&] {
    lc_f32<<<grid, LC_THREADS, 0, st>>>((const float*)x, (float*)y, n, reps,
                                        vec);
    return cudaSuccess;
  });
}

}  // namespace

// x, y: n contiguous f32 (is_bf16 = 0) or bf16 (is_bf16 = 1) values on the
// device.  Launches on `stream`, does not synchronise, returns the CUDA
// error code (0 if none).
extern "C" int repro_localised_copy(const void* x, void* y, long long n,
                                    int reps, int is_bf16, void* stream) {
  Launcher ex;
  const int vec = ((uintptr_t)x % 16 == 0) && ((uintptr_t)y % 16 == 0);
  return run(ex, x, y, n, reps, is_bf16, vec, (cudaStream_t)stream);
}

// The dry run of repro_localised_copy for buffers whose alignment gives
// `vec`: fills out[0..max) with the launches it would make, launches
// nothing; returns their count or minus a CUDA error.
extern "C" int repro_localised_copy_plan(long long n, int reps, int is_bf16,
                                         int vec, ReproLaunch* out, int max) {
  Planner ex{out, max, 0};
  const int err = run(ex, nullptr, nullptr, n, reps, is_bf16, vec,
                      (cudaStream_t)0);
  return plan_result(err, ex);
}
