// One host code path that either launches a kernel or records the launch.
//
// Every C entry of the port writes its host code once, as a template over
// an executor `ex`, and calls `ex(name, kernel, grid, threads, smem, go)`
// for each launch, where `go` is a lambda that sets the kernel's
// attributes and launches it:
//
//   * `Launcher` runs `go` and returns the launch's error code;
//   * `Planner` runs nothing: it records the launch -- the kernel's name,
//     grid, threads, its static shared memory as the compiled kernel
//     reports it (cudaFuncGetAttributes) and the dynamic shared memory of
//     the launch -- into a caller's array.
//
// So the `repro_<kernel>_plan` entry of each source is a dry run of the
// very code that launches, and the Python launch plan of each wrapper
// (`repro_torch.kernels.*.plan`) can be held equal to it launch for launch.
#pragma once
#include <cuda_runtime.h>

#include <cstring>

struct ReproLaunch {
  char name[32];
  unsigned grid[3];
  int threads;
  int smem_static;
  int smem_dynamic;
};

struct Launcher {
  template <class Go>
  int operator()(const char*, const void*, dim3, int, size_t, Go&& go) {
    const cudaError_t err = go();
    if (err != cudaSuccess) return (int)err;
    return (int)cudaGetLastError();
  }
};

struct Planner {
  ReproLaunch* out;
  int max;
  int n;
  template <class Go>
  int operator()(const char* name, const void* kernel, dim3 grid, int threads,
                 size_t smem, Go&&) {
    if (n < max) {
      cudaFuncAttributes attr;
      const cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
      if (err != cudaSuccess) return (int)err;
      ReproLaunch& r = out[n];
      std::memset(r.name, 0, sizeof(r.name));
      std::strncpy(r.name, name, sizeof(r.name) - 1);
      r.grid[0] = grid.x;
      r.grid[1] = grid.y;
      r.grid[2] = grid.z;
      r.threads = threads;
      r.smem_static = (int)attr.sharedSizeBytes;
      r.smem_dynamic = (int)smem;
    }
    ++n;
    return 0;
  }
};

// The launches a Planner saw (more than `max` means the array was short),
// or minus a CUDA error code.
inline int plan_result(int err, const Planner& p) { return err ? -err : p.n; }
