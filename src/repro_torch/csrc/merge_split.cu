// merge_split: the kept half of the stable merge of two sorted runs.
//
// Replaces the TPU kernel src/repro/kernels/merge_split.py::merge_split.
// For each row r of a, b: (rows, C), both sorted ascending, it writes the C
// outputs of ranks [0, C) of merge(a[r], b[r]) when keep[r] != 0 and of
// ranks [C, 2C) otherwise.  The 2C merge is never materialised.
//
// Ties go to a, and comparisons are plain IEEE (-0.0 == +0.0), so the
// result is bit-identical to `merge_sorted(a, b)[:C]` / `[C:]` of
// `repro_torch.core.sort` (searchsorted with side="left").
//
// Design: merge-path partitioning.  Each block owns MS_TILE consecutive
// output ranks of one row.  Two threads binary-search the merge-path
// diagonals at the tile's first and one-past-last rank: for output rank k,
// the number of a-elements among the first k outputs is the first i with
// a[i] > b[k-1-i] (so a wins ties).  The block loads the two input windows
// the tile consumes (MS_TILE elements in all) into shared memory; each
// thread then searches its own diagonal inside the windows and merges
// MS_ITEMS outputs sequentially.
//
// Bound on an H100: both runs read once and the kept half written once,
// 3 * rows * C * 4 bytes over 3.35 TB/s; the compare work is O(rows * C).
//
// Launch plan: the host code is one template over the executors of
// launch_plan.cuh, so `repro_merge_split_plan` is a dry run of exactly the
// launches `repro_merge_split` makes (held equal to the Python
// `repro_torch.kernels.merge_split.plan` on the card).
#include <cuda_runtime.h>

#include "launch_plan.cuh"

namespace {

constexpr int MS_THREADS = 256;
constexpr int MS_ITEMS = 8;
constexpr int MS_TILE = MS_THREADS * MS_ITEMS;   // output ranks per block
constexpr long long MAX_ROWS = 65535;            // rows ride on gridDim.y

// Number of elements of a among the first k outputs of the stable merge.
template <typename T>
__device__ long long merge_path(const T* a, long long na, const T* b,
                                long long nb, long long k) {
  long long lo = k > nb ? k - nb : 0;
  long long hi = k < na ? k : na;
  while (lo < hi) {
    const long long mid = (lo + hi) >> 1;
    if (a[mid] <= b[k - 1 - mid]) lo = mid + 1; else hi = mid;
  }
  return lo;
}

template <typename T>
__global__ void merge_split_kernel(const T* __restrict__ a,
                                   const T* __restrict__ b,
                                   const int* __restrict__ keep,
                                   T* __restrict__ out, long long C) {
  __shared__ T s[MS_TILE];
  __shared__ long long diag[2];
  const long long row = blockIdx.y;
  const T* ar = a + row * C;
  const T* br = b + row * C;
  const long long t0 = (long long)blockIdx.x * MS_TILE;  // offset in kept half
  const long long rest = C - t0;
  const int n_out = rest < MS_TILE ? (int)rest : MS_TILE;
  const long long k0 = (keep[row] ? 0 : C) + t0;
  if (threadIdx.x < 2)
    diag[threadIdx.x] = merge_path(ar, C, br, C, k0 + threadIdx.x * n_out);
  __syncthreads();
  const long long i0 = diag[0];
  const int la = (int)(diag[1] - i0);
  const int lb = n_out - la;
  const long long j0 = k0 - i0;
  for (int x = threadIdx.x; x < la; x += blockDim.x) s[x] = ar[i0 + x];
  for (int x = threadIdx.x; x < lb; x += blockDim.x) s[la + x] = br[j0 + x];
  __syncthreads();
  const int r0 = threadIdx.x * MS_ITEMS;
  if (r0 >= n_out) return;
  const T* sa = s;
  const T* sb = s + la;
  int lo = r0 > lb ? r0 - lb : 0;
  int hi = r0 < la ? r0 : la;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (sa[mid] <= sb[r0 - 1 - mid]) lo = mid + 1; else hi = mid;
  }
  int ia = lo, ib = r0 - lo;
  T* o = out + row * C + t0 + r0;
  const int cnt = n_out - r0 < MS_ITEMS ? n_out - r0 : MS_ITEMS;
  for (int q = 0; q < cnt; ++q) {
    const bool take_a = ib >= lb || (ia < la && sa[ia] <= sb[ib]);
    o[q] = take_a ? sa[ia++] : sb[ib++];
  }
}

}  // namespace

extern "C" const char* repro_merge_split_error(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

namespace {

template <typename T, class Exec>
int run_typed(Exec& ex, const void* a, const void* b, const void* keep,
              void* out, long long rows, long long C, cudaStream_t st) {
  const dim3 grid((unsigned)((C + MS_TILE - 1) / MS_TILE), (unsigned)rows);
  return ex("merge_split_kernel", (const void*)merge_split_kernel<T>, grid,
            MS_THREADS, 0, [&] {
              merge_split_kernel<T><<<grid, MS_THREADS, 0, st>>>(
                  (const T*)a, (const T*)b, (const int*)keep, (T*)out, C);
              return cudaSuccess;
            });
}

// The host code, once for launching and for planning (launch_plan.cuh).
template <class Exec>
int run(Exec& ex, const void* a, const void* b, const void* keep, void* out,
        long long rows, long long C, int is_float, cudaStream_t st) {
  if (rows == 0 || C == 0) return 0;
  if (rows > MAX_ROWS) return (int)cudaErrorInvalidConfiguration;
  if (is_float) return run_typed<float>(ex, a, b, keep, out, rows, C, st);
  return run_typed<int>(ex, a, b, keep, out, rows, C, st);
}

}  // namespace

// a, b, out: (rows, C) contiguous int32 or float32; keep: (rows,) int32 on
// the device.  rows <= MAX_ROWS (gridDim.y).  Launches on `stream`, does not
// synchronise, returns the CUDA error code (0 if none).
extern "C" int repro_merge_split(const void* a, const void* b, const void* keep,
                                 void* out, long long rows, long long C,
                                 int is_float, void* stream) {
  Launcher ex;
  return run(ex, a, b, keep, out, rows, C, is_float, (cudaStream_t)stream);
}

// The dry run of repro_merge_split: fills out[0..max) with the launches it
// would make, launches nothing; returns their count or minus a CUDA error.
extern "C" int repro_merge_split_plan(long long rows, long long C, int is_float,
                                      ReproLaunch* out, int max) {
  Planner ex{out, max, 0};
  const int err = run(ex, nullptr, nullptr, nullptr, nullptr, rows, C, is_float,
                      (cudaStream_t)0);
  return plan_result(err, ex);
}
