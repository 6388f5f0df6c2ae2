// merge_split: the stable merge of two sorted runs, whole or the kept half.
//
// Replaces the TPU kernel src/repro/kernels/merge_split.py::merge_split, and
// runs the full merge of the constraint tree (src/repro/core/sort.py::
// merge_sorted, plain jnp in the reference).  Row r of a (rows, na) and b
// (rows, nb), both sorted ascending, gives row r of out in one of three
// modes:
//
//   * keep-low / keep-high (mode 1, na == nb == C): out (rows, C) holds
//     ranks [0, C) of merge(a[r], b[r]) where keep[r] != 0, else ranks
//     [C, 2C); the 2C merge is never materialised;
//   * full (mode 0): out (rows, na + nb) holds the whole merge.
//
// Rows of a and b may lie `sa` and `sb` elements apart (the last dim is
// contiguous), so the constraint tree's `runs[..., 0::2, :]` and
// `runs[..., 1::2, :]` come in as views, without a copy; out is contiguous.
//
// Ties go to a, and comparisons are IEEE in the widened type (merge_path.cuh:
// int8, int16, uint8 and uint16 widen to int32, uint32 maps onto int32 with
// its top bit flipped, float16 and bfloat16 widen to float32, exactly; the
// output is narrowed back, exactly), so -0.0 == +0.0 and the
// result is bit-identical to the plain versions, `merge_split_reference`
// and `merge_sorted_reference` (searchsorted with side="left").  The
// keep-low and keep-high halves are computed separately, so a pair may keep
// one sign of zero twice at a block boundary, as the reference does.
//
// Design (the merge-path pieces of merge_path.cuh, shared with
// local_sort.cu's merge passes): a flat grid of rows * ceil(n_row / TILE)
// blocks (n_row = C or na + nb), so the number of rows is not bounded by a
// grid dimension; block g writes TILE = 8192 consecutive outputs of row
// g / bpr.  Its first and one-past-last co-ranks cut the two windows it
// consumes; 256 threads bring them into padded shared memory (cp.async for
// 4-byte elements, 4 B a thread, coalesced; the narrow ones through a
// register, widened), each thread finds its own co-rank inside the windows
// and merges 32 outputs in registers, and the block stages them back
// through shared memory and stores them coalesced, narrowed.
//
// The block's co-ranks come from a partition launch,
// `merge_split_partition`, that first writes the co-rank of every block
// boundary of every row (rows * (bpr + 1) of them, one thread each, a
// binary search in device memory: ~24 dependent loads at 12.5 M keys a
// run) into `diag`; a merge block reads its two.  Merge blocks that found
// their own co-ranks by a 32-way warp search (~5 dependent loads) were
// slower on the card (PERF.md).
//
// Bound on an H100 (chip_smoke.py): what the outputs need read once and
// out written once over 3.35 TB/s -- 2 * rows * C * itemsize bytes for the
// keep modes (the kept ranks' sources, C elements of a and b together, and
// C outputs: 0.239 ms at (8, 12.5 M) int32), 2 * rows * (na + nb) *
// itemsize for the full mode (0.239 ms for one full-merge level of the
// constraint tree at n = 100 M); the compare work is one comparison per
// output plus the searches, far below the fp32 pipe's rate.
//
// Index width: array offsets are 64-bit; co-ranks inside a row are int32,
// so na + nb <= INT_MAX (the wrapper refuses longer rows).
//
// Launch plan: the host code is one template over the executors of
// launch_plan.cuh, so `repro_merge_split_plan` is a dry run of exactly the
// launches `repro_merge_split` makes (held equal to the Python
// `repro_torch.kernels.merge_split.plan` on the card).
#include <cuda_runtime.h>

#include <climits>

#include "launch_plan.cuh"
#include "merge_path.cuh"

namespace {

using merge_path::co_rank;
using merge_path::copy_async_wait;
using merge_path::ITEMS;
using merge_path::load_slot;
using merge_path::merge_windows;
using merge_path::pad_slot;
using merge_path::PART_THREADS;
using merge_path::SLOTS;
using merge_path::THREADS;
using merge_path::TILE;
using merge_path::Wide;

// The shape of one launch's rows.
struct Rows {
  long long sa, sb;  // row strides of a and b, in elements
  int na, nb;        // run lengths
  int n_row;         // outputs of a row: C (keep modes) or na + nb (full)
  long long bpr;     // merge blocks per row
};

// Merge rank of output o of row `row`: keep-high rows start at rank C.
__device__ __forceinline__ int rank_of(const int* keep, long long row,
                                       const Rows& r, long long o) {
  return (int)((keep && !keep[row] ? r.n_row : 0) + o);
}

// Co-rank of merge rank d of row (ar, br), one thread, in device memory.
template <typename T>
__device__ __forceinline__ int row_co_rank(const T* ar, const T* br,
                                           const Rows& r, int d) {
  using W = Wide<T>;
  return (int)co_rank<long long>([ar](long long i) { return W::widen(ar[i]); },
                                 r.na,
                                 [br](long long i) { return W::widen(br[i]); },
                                 r.nb, d);
}

// Step 1: diag[row * (bpr + 1) + q] = co-rank of output
// min(q TILE, n_row) of the row, for q = 0 .. bpr.
template <typename T>
__global__ void merge_split_partition(const T* __restrict__ a,
                                      const T* __restrict__ b,
                                      const int* __restrict__ keep,
                                      int* __restrict__ diag, Rows r,
                                      long long total) {
  const long long g = (long long)blockIdx.x * PART_THREADS + threadIdx.x;
  if (g >= total) return;
  const long long row = g / (r.bpr + 1);
  const long long q = g % (r.bpr + 1);
  const long long o = q * TILE < r.n_row ? q * TILE : r.n_row;
  diag[g] = row_co_rank(a + row * r.sa, b + row * r.sb, r,
                        rank_of(keep, row, r, o));
}

// Step 2: block g writes outputs [q TILE, q TILE + TILE) of row g / bpr
// (q = g % bpr), between the co-ranks diag holds for it.
template <typename T>
__global__ void __launch_bounds__(THREADS)
merge_split_kernel(const T* __restrict__ a, const T* __restrict__ b,
                   const int* __restrict__ keep, const int* __restrict__ diag,
                   T* __restrict__ out, Rows r) {
  using W = Wide<T>;
  using K = typename W::K;
  __shared__ K s[SLOTS];
  const long long g = blockIdx.x;
  const long long row = g / r.bpr;
  const long long q = g % r.bpr;
  const long long o0 = q * TILE;
  const int n_out = r.n_row - o0 < TILE ? (int)(r.n_row - o0) : TILE;
  const T* ar = a + row * r.sa;
  const T* br = b + row * r.sb;
  const int d0 = rank_of(keep, row, r, o0);
  const int* dg = diag + row * (r.bpr + 1) + q;
  const int a0 = dg[0];
  const int a1 = dg[1];
  // a1 - a0 lies in [0, n_out] for sorted runs; the clamp keeps both
  // windows inside their runs whatever the input (runs that are not sorted
  // give an output that is not sorted, never an access out of bounds)
  const int wa = min(max(a1 - a0, 0), n_out);
  const int wb = n_out - wa;
  const T* pa = ar + a0;
  const T* pb = br + (d0 - a0);
  for (int x = threadIdx.x; x < n_out; x += THREADS)  // coalesced
    load_slot<T>(&s[pad_slot(x)], x < wa ? pa + x : pb + (x - wa));
  if constexpr (W::raw) copy_async_wait();
  __syncthreads();
  merge_windows<K>(s, wa, wb);
  T* o = out + row * r.n_row + o0;
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    const int x = i * THREADS + threadIdx.x;
    if (x < n_out) o[x] = W::narrow(s[pad_slot(x)]);
  }
}

}  // namespace

extern "C" const char* repro_merge_split_error(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

namespace {

template <typename T, class Exec>
int run_typed(Exec& ex, const void* a, const void* b, const int* keep,
              int* diag, void* out, long long rows, const Rows& r,
              cudaStream_t st) {
  const unsigned blocks = (unsigned)(rows * r.bpr);
  const long long parts = rows * (r.bpr + 1);
  const unsigned part_blocks =
      (unsigned)((parts + PART_THREADS - 1) / PART_THREADS);
  const int err = ex("merge_split_partition",
                     (const void*)merge_split_partition<T>, dim3(part_blocks),
                     PART_THREADS, 0, [&] {
                       merge_split_partition<T>
                           <<<part_blocks, PART_THREADS, 0, st>>>(
                               (const T*)a, (const T*)b, keep, diag, r, parts);
                       return cudaSuccess;
                     });
  if (err) return err;
  return ex("merge_split_kernel", (const void*)merge_split_kernel<T>,
            dim3(blocks), THREADS, 0, [&] {
              merge_split_kernel<T><<<blocks, THREADS, 0, st>>>(
                  (const T*)a, (const T*)b, keep, diag, (T*)out, r);
              return cudaSuccess;
            });
}

// The host code, once for launching and for planning (launch_plan.cuh).
template <class Exec>
int run(Exec& ex, const void* a, long long sa, const void* b, long long sb,
        const void* keep, void* diag, void* out, long long rows, long long na,
        long long nb, int mode, int code, cudaStream_t st) {
  if (rows < 0 || na < 0 || nb < 0 || na + nb > INT_MAX ||
      (mode != 0 && mode != 1) || (mode == 1 && na != nb))
    return (int)cudaErrorInvalidValue;
  Rows r{sa, sb, (int)na, (int)nb, (int)(mode == 1 ? na : na + nb), 0};
  r.bpr = (r.n_row + TILE - 1) / TILE;
  if (rows == 0 || r.n_row == 0) return 0;
  if (rows * (r.bpr + 1) > INT_MAX) return (int)cudaErrorInvalidConfiguration;
  const int* k = mode == 1 ? (const int*)keep : nullptr;
  return merge_path::with_dtype(code, [&](auto tag) {
    using T = typename decltype(tag)::type;
    return run_typed<T>(ex, a, b, k, (int*)diag, out, rows, r, st);
  });
}

}  // namespace

// a: (rows, na) and b: (rows, nb) of dtype `code` (merge_path.cuh), rows
// `sa` and `sb` elements apart, each row sorted; out: (rows, n_row)
// contiguous, n_row = na (mode 1: keep per row, na == nb, keep a (rows,)
// int32 array) or na + nb (mode 0, keep unused).  diag: rows * (ceil(n_row
// / 8192) + 1) int32.  na + nb <= INT_MAX.
// Launches on `stream`, does not synchronise, returns the CUDA error code
// (0 if none).
extern "C" int repro_merge_split(const void* a, long long sa, const void* b,
                                 long long sb, const void* keep, void* diag,
                                 void* out, long long rows, long long na,
                                 long long nb, int mode, int code,
                                 void* stream) {
  Launcher ex;
  return run(ex, a, sa, b, sb, keep, diag, out, rows, na, nb, mode, code,
             (cudaStream_t)stream);
}

// The dry run of repro_merge_split: fills out[0..max) with the launches it
// would make, launches nothing; returns their count or minus a CUDA error.
extern "C" int repro_merge_split_plan(long long rows, long long na,
                                      long long nb, int mode, int code,
                                      ReproLaunch* out, int max) {
  Planner ex{out, max, 0};
  const int err = run(ex, nullptr, 0, nullptr, 0, nullptr, nullptr, nullptr,
                      rows, na, nb, mode, code, (cudaStream_t)0);
  return plan_result(err, ex);
}
