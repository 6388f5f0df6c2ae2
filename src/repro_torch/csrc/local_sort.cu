// local_sort: ascending sort of every row of a (rows, C) int32/float32 tensor.
//
// Replaces the TPU kernel src/repro/kernels/local_sort.py::local_sort (the
// fused VMEM-resident local phase of the merge-sort engine: leaf sorts and
// the whole local merge tree as one bitonic network, rows padded to the
// next power of two L with the BIG sentinel in scratch only).
//
// Order.  Elements are compared by a total-order key: int32 as is, float32
// as its bits k ^ ((k >> 31) & 0x7fffffff) compared as signed int32.  That
// puts -0.0 before +0.0, as XLA's min/max do in the reference network, so
// the result is bit-identical to the reference and to the plain version
// (`repro_torch.kernels.bitonic_sort.bitonic_stages`).  The key map is an
// involution: applying it again on the way out restores the bits.
//
// Design.  TILE = 16384 keys (64 KB of dynamic shared memory per block).
//   * L <= TILE: one block per row.  The row is loaded into shared memory,
//     the padding tail is filled with the sentinel key in shared memory
//     only, the whole network runs with __syncthreads() between substages,
//     and the first C entries are written back.  One launch.
//   * L > TILE: a 12.5 M-key chunk does not fit in one block's 227 KB, so
//     the wrapper passes a padded (rows, L) scratch in device memory; this
//     is the one place where padding reaches device memory.  Passes:
//       1. a shared-memory pass runs every stage k <= TILE on each TILE
//          segment (direction from bit k of the index within the row);
//       2. for each stage k > TILE: one global compare-exchange launch per
//          substage j >= TILE, then one shared-memory launch finishing the
//          substages j < TILE of every segment;
//       3. a copy writes the real prefix back.
//     1 + sum over log2(L/TILE) stages of (stage substages + 1) + 1 launches,
//     O(log^2(L/TILE)).
//
// Bound on an H100.  The function reads each input element once and writes
// each output once: 2 * rows * C * 4 bytes over 3.35 TB/s.  The network does
// rows * L/2 * log2(L) * (log2(L)+1) / 2 compare-exchanges, data-independent.
// This first version is plain: every global substage moves the whole
// scratch through device memory, and no warp shuffles are used.
//
// Launch plan: the host code is one template over the executors of
// launch_plan.cuh, so `repro_local_sort_plan` is a dry run of exactly the
// launches `repro_local_sort` makes (held equal to the Python
// `repro_torch.kernels.local_sort.plan` on the card).
#include <cuda_runtime.h>

#include <climits>

#include "launch_plan.cuh"

namespace {

constexpr int TILE = 16384;          // keys per shared-memory tile
constexpr int SORT_THREADS = 1024;   // threads of a shared-memory pass
constexpr int STEP_THREADS = 256;    // threads of a global substage / copy

__device__ __forceinline__ int flip_key(int v, int is_float) {
  return is_float ? (v ^ ((v >> 31) & 0x7fffffff)) : v;
}

// Substages of stages k_lo..k_hi on the n keys in s (n a power of two),
// whose first key sits at index `base` of its row.  For stages k > n only
// the substages j < n run here (the rest ran as global substages).
__device__ void bitonic_block(int* s, int n, long long base, long long k_lo,
                              long long k_hi) {
  const int half = n >> 1;
  for (long long k = k_lo; k <= k_hi; k <<= 1) {
    int j = (int)((k < n ? k : n) >> 1);
    for (; j >= 1; j >>= 1) {
      for (int p = threadIdx.x; p < half; p += blockDim.x) {
        const int i = 2 * j * (p / j) + (p % j);
        const int l = i + j;
        const bool asc = ((base + i) & k) == 0;
        const int a = s[i], b = s[l];
        if ((a > b) == asc) { s[i] = b; s[l] = a; }
      }
      __syncthreads();
    }
  }
}

// L <= TILE: one block sorts one row, padding in shared memory only.
__global__ void sort_rows_smem(const int* __restrict__ in, int* __restrict__ out,
                               long long C, int L, int is_float, int pad_key) {
  extern __shared__ int s[];
  const long long row = blockIdx.x;
  const int* src = in + row * C;
  for (int i = threadIdx.x; i < L; i += blockDim.x)
    s[i] = i < C ? flip_key(src[i], is_float) : pad_key;
  __syncthreads();
  bitonic_block(s, L, 0, 2, L);
  int* dst = out + row * C;
  for (int i = threadIdx.x; i < C; i += blockDim.x)
    dst[i] = flip_key(s[i], is_float);
}

// L > TILE, pass 1: every stage k <= TILE on each segment, input -> scratch.
__global__ void tile_sort(const int* __restrict__ in, int* __restrict__ scratch,
                          long long C, long long L, int is_float, int pad_key) {
  extern __shared__ int s[];
  const long long tiles = L / TILE;
  const long long row = blockIdx.x / tiles;
  const long long base = (blockIdx.x % tiles) * TILE;
  const int* src = in + row * C;
  for (int i = threadIdx.x; i < TILE; i += blockDim.x) {
    const long long g = base + i;
    s[i] = g < C ? flip_key(src[g], is_float) : pad_key;
  }
  __syncthreads();
  bitonic_block(s, TILE, base, 2, TILE);
  int* dst = scratch + row * L + base;
  for (int i = threadIdx.x; i < TILE; i += blockDim.x) dst[i] = s[i];
}

// L > TILE, pass 2a: one substage (k, j >= TILE) over all rows of scratch.
__global__ void global_step(int* scratch, long long pairs_per_row,
                            long long total, long long k, long long j) {
  const long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= total) return;
  const long long row = p / pairs_per_row;
  const long long q = p % pairs_per_row;
  const long long i = 2 * j * (q / j) + (q % j);
  const long long l = i + j;
  const bool asc = (i & k) == 0;
  int* r = scratch + row * (2 * pairs_per_row);
  const int a = r[i], b = r[l];
  if ((a > b) == asc) { r[i] = b; r[l] = a; }
}

// L > TILE, pass 2b: the substages j < TILE of stage k on each segment.
__global__ void tile_finish(int* scratch, long long L, long long k) {
  extern __shared__ int s[];
  const long long tiles = L / TILE;
  const long long row = blockIdx.x / tiles;
  const long long base = (blockIdx.x % tiles) * TILE;
  int* seg = scratch + row * L + base;
  for (int i = threadIdx.x; i < TILE; i += blockDim.x) s[i] = seg[i];
  __syncthreads();
  bitonic_block(s, TILE, base, k, k);
  for (int i = threadIdx.x; i < TILE; i += blockDim.x) seg[i] = s[i];
}

// L > TILE, pass 3: the real prefix of every row, keys back to values.
__global__ void copy_out(const int* __restrict__ scratch, int* __restrict__ out,
                         long long C, long long L, long long total,
                         int is_float) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const long long row = idx / C;
  out[idx] = flip_key(scratch[row * L + idx % C], is_float);
}

long long blocks_for(long long total, int threads) {
  return (total + threads - 1) / threads;
}

}  // namespace

extern "C" int repro_local_sort_tile(void) { return TILE; }

extern "C" const char* repro_local_sort_error(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

namespace {

// The host code, once for launching and for planning (launch_plan.cuh).
template <class Exec>
int run(Exec& ex, const int* x, int* y, int* sc, long long rows, long long C,
        long long L, int is_float, cudaStream_t st) {
  const int pad_key = is_float ? 0x7f800000 : INT_MAX;  // key of +inf / BIG
  int err;
  if (rows == 0) return 0;
  if (L <= TILE) {
    const size_t smem = (size_t)L * sizeof(int);
    const long long half = L / 2;
    const int threads = half >= SORT_THREADS ? SORT_THREADS
                        : (half > 32 ? (int)half : 32);
    return ex("sort_rows_smem", (const void*)sort_rows_smem,
              dim3((unsigned)rows), threads, smem, [&] {
                const cudaError_t e = cudaFuncSetAttribute(
                    sort_rows_smem, cudaFuncAttributeMaxDynamicSharedMemorySize,
                    (int)smem);
                if (e != cudaSuccess) return e;
                sort_rows_smem<<<(unsigned)rows, threads, smem, st>>>(
                    x, y, C, (int)L, is_float, pad_key);
                return cudaSuccess;
              });
  }
  const size_t smem = (size_t)TILE * sizeof(int);
  const long long tile_blocks = rows * (L / TILE);
  err = ex("tile_sort", (const void*)tile_sort, dim3((unsigned)tile_blocks),
           SORT_THREADS, smem, [&] {
             const cudaError_t e = cudaFuncSetAttribute(
                 tile_sort, cudaFuncAttributeMaxDynamicSharedMemorySize,
                 (int)smem);
             if (e != cudaSuccess) return e;
             tile_sort<<<(unsigned)tile_blocks, SORT_THREADS, smem, st>>>(
                 x, sc, C, L, is_float, pad_key);
             return cudaSuccess;
           });
  if (err) return err;
  const long long pairs = rows * (L / 2);
  const unsigned step_blocks = (unsigned)blocks_for(pairs, STEP_THREADS);
  for (long long k = 2LL * TILE; k <= L; k <<= 1) {
    for (long long j = k >> 1; j >= TILE; j >>= 1) {
      err = ex("global_step", (const void*)global_step, dim3(step_blocks),
               STEP_THREADS, 0, [&] {
                 global_step<<<step_blocks, STEP_THREADS, 0, st>>>(
                     sc, L / 2, pairs, k, j);
                 return cudaSuccess;
               });
      if (err) return err;
    }
    err = ex("tile_finish", (const void*)tile_finish,
             dim3((unsigned)tile_blocks), SORT_THREADS, smem, [&] {
               const cudaError_t e = cudaFuncSetAttribute(
                   tile_finish, cudaFuncAttributeMaxDynamicSharedMemorySize,
                   (int)smem);
               if (e != cudaSuccess) return e;
               tile_finish<<<(unsigned)tile_blocks, SORT_THREADS, smem, st>>>(
                   sc, L, k);
               return cudaSuccess;
             });
    if (err) return err;
  }
  const long long total = rows * C;
  const unsigned copy_blocks = (unsigned)blocks_for(total, STEP_THREADS);
  return ex("copy_out", (const void*)copy_out, dim3(copy_blocks), STEP_THREADS,
            0, [&] {
              copy_out<<<copy_blocks, STEP_THREADS, 0, st>>>(sc, y, C, L, total,
                                                             is_float);
              return cudaSuccess;
            });
}

}  // namespace

// in, out: (rows, C) contiguous int32 bits; scratch: (rows, L) int32 when
// L > TILE, else unused.  L is the next power of two >= C.  Launches on
// `stream`, does not synchronise, returns the first CUDA error (0 if none).
extern "C" int repro_local_sort(const void* in, void* out, void* scratch,
                                long long rows, long long C, long long L,
                                int is_float, void* stream) {
  Launcher ex;
  return run(ex, (const int*)in, (int*)out, (int*)scratch, rows, C, L,
             is_float, (cudaStream_t)stream);
}

// The dry run of repro_local_sort: fills out[0..max) with the launches it
// would make, launches nothing; returns their count or minus a CUDA error.
extern "C" int repro_local_sort_plan(long long rows, long long C, long long L,
                                     int is_float, ReproLaunch* out, int max) {
  Planner ex{out, max, 0};
  const int err = run(ex, nullptr, nullptr, nullptr, rows, C, L, is_float,
                      (cudaStream_t)0);
  return plan_result(err, ex);
}
