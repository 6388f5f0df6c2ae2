// fixtures: four deliberately broken (rows, cols) float32 row copies, the
// mutants that the launch-plan rules R5 and R8 must flag.
//
// Replaces the TPU kernels of src/repro/analysis/fixtures.py:
//   overlapping  <- overlapping_index_map: block i writes output row i / 2,
//                   so blocks 2k and 2k + 1 race on row k (R5 ERROR);
//   gapped       <- gapped_index_map: the grid has rows / 2 blocks, the
//                   output rows past it are never written (R5 WARN);
//   oob          <- oob_index_map: block i reads input row i + rows / 2,
//                   past the input's end for the last rows / 2 blocks
//                   (R5 ERROR).  A Pallas block index is clamped into the
//                   array; a CUDA kernel has no such clamp, so the wrapper
//                   puts the input at the head of a buffer with a guard
//                   band of rows / 2 rows behind it and the read lands
//                   there, inside the allocation;
//   dead_lane    <- dead_lane_kernel: a copy plus a lane taken when
//                   blockIdx.x == lane, with lane = rows + 3 outside the
//                   grid (R8 WARN).  The lane doubles the row and counts
//                   the blocks that entered it in `entered`, which stays 0.
//
// Every block copies one row, one thread per column.  The row map
// (`out_div`, `in_shift`), the grid and the lane constant are arguments
// of the launch, given by the wrapper from the same launch plan that the
// rules replay (repro_torch.kernels.fixtures.plan), so the plan records
// what the kernel does and not a description beside it.
//
// Bound on an H100: 2 * rows * cols * 4 bytes (4 KiB at (4, 128)) over
// 3.35 TB/s, about 1.2 ns; the launch itself takes microseconds, so every
// one of these is launch-bound.  They are not meant to be fast.
#include <cuda_runtime.h>

#include "launch_plan.cuh"

namespace {

constexpr int FX_THREADS = 128;

__device__ __forceinline__ void copy_row(const float* __restrict__ src,
                                         float* __restrict__ dst, int cols) {
  for (int c = threadIdx.x; c < cols; c += blockDim.x) dst[c] = src[c];
}

__global__ void overlapping(const float* __restrict__ x, float* __restrict__ y,
                            int cols, int out_div) {
  const long long i = blockIdx.x;
  copy_row(x + i * cols, y + (i / out_div) * cols, cols);
}

__global__ void gapped(const float* __restrict__ x, float* __restrict__ y,
                       int cols) {
  const long long i = blockIdx.x;
  copy_row(x + i * cols, y + i * cols, cols);
}

__global__ void oob(const float* __restrict__ x, float* __restrict__ y,
                    int cols, int in_shift) {
  const long long i = blockIdx.x;
  copy_row(x + (i + in_shift) * cols, y + i * cols, cols);
}

__global__ void dead_lane(const float* __restrict__ x, float* __restrict__ y,
                          int cols, int lane, int* __restrict__ entered) {
  const long long i = blockIdx.x;
  float* dst = y + i * cols;
  copy_row(x + i * cols, dst, cols);
  if (blockIdx.x == (unsigned)lane) {
    if (threadIdx.x == 0) atomicAdd(entered, 1);
    for (int c = threadIdx.x; c < cols; c += blockDim.x) dst[c] *= 2.0f;
  }
}

// kind: 0 overlapping, 1 gapped, 2 oob, 3 dead lane.  `grid` blocks, `arg`
// the kind's constant (out_div, -, in_shift, lane).
template <class Exec>
int run(Exec& ex, int kind, const float* x, float* y, int* entered, int grid,
        int cols, int arg, cudaStream_t st) {
  if (grid <= 0 || cols <= 0) return 0;
  const dim3 g((unsigned)grid);
  switch (kind) {
    case 0:
      return ex("overlapping", (const void*)overlapping, g, FX_THREADS, 0, [&] {
        overlapping<<<g, FX_THREADS, 0, st>>>(x, y, cols, arg);
        return cudaSuccess;
      });
    case 1:
      return ex("gapped", (const void*)gapped, g, FX_THREADS, 0, [&] {
        gapped<<<g, FX_THREADS, 0, st>>>(x, y, cols);
        return cudaSuccess;
      });
    case 2:
      return ex("oob", (const void*)oob, g, FX_THREADS, 0, [&] {
        oob<<<g, FX_THREADS, 0, st>>>(x, y, cols, arg);
        return cudaSuccess;
      });
    case 3:
      return ex("dead_lane", (const void*)dead_lane, g, FX_THREADS, 0, [&] {
        dead_lane<<<g, FX_THREADS, 0, st>>>(x, y, cols, arg, entered);
        return cudaSuccess;
      });
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" const char* repro_fixtures_error(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// x: the input rows (for oob, the guarded buffer), y: (rows, cols) f32,
// entered: one int32 on the device (dead lane only).  Launches on `stream`,
// does not synchronise, returns the CUDA error code (0 if none).
extern "C" int repro_fixtures(int kind, const void* x, void* y, void* entered,
                              int grid, int cols, int arg, void* stream) {
  Launcher ex;
  return run(ex, kind, (const float*)x, (float*)y, (int*)entered, grid, cols,
             arg, (cudaStream_t)stream);
}

// The dry run of repro_fixtures: fills out[0..max) with the launches it
// would make, launches nothing; returns their count or minus a CUDA error.
extern "C" int repro_fixtures_plan(int kind, int grid, int cols, int arg,
                                   ReproLaunch* out, int max) {
  Planner ex{out, max, 0};
  const int err = run(ex, kind, nullptr, nullptr, nullptr, grid, cols, arg,
                      (cudaStream_t)0);
  return plan_result(err, ex);
}
