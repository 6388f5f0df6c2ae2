// local_sort: ascending sort of every row of a (rows, C) tensor of int8,
// int16, int32, uint8, uint16, uint32, float16, bfloat16 or float32.
//
// Replaces the TPU kernel src/repro/kernels/local_sort.py::local_sort (the
// fused VMEM-resident local phase of the merge-sort engine: leaf sorts and
// the whole local merge tree as one bitonic network, rows padded to the
// next power of two with the BIG sentinel in scratch only).
//
// Order.  Elements are compared by an int32 total-order key: int32 as is,
// float32 as its bits k ^ ((k >> 31) & 0x7fffffff) compared as signed
// int32.  A narrow dtype is widened on load (merge_path.cuh: integers
// extend to int32, float16 and bfloat16 convert exactly to float32) and
// takes the same key, uint32 takes its bits with the top bit flipped; its value is narrowed back, exactly, on store.  That
// puts -0.0 before +0.0, as XLA's min/max do in the reference network, and
// equal keys are equal bits, so any correct sort of the keys is bit-identical
// to the reference and to the plain version
// (`repro_torch.kernels.local_sort.local_sort_reference`).  The key map is
// an involution: applying it again on the way out restores the bits.  (A
// positive-NaN key sorts above the +inf padding, so in a padded tile, as in
// the plain version's padded row, such NaNs fall past the real keys and +inf
// is written in their place; only a tile of exactly N keys keeps them.  The
// sort entry points refuse NaN.)
//
// Bound on an H100.  The function reads each input element once and writes
// each output once: 2 * rows * C * 4 bytes over 3.35 TB/s (0.239 ms at
// (8, 12.5 M)); a comparison sort needs about C log2 C comparisons a row.
// On a TPU the whole row sat in VMEM; a block here has at most 227 KB of
// shared memory, so a 12.5 M-key row has to go through device memory
// between passes.  The design keeps the number of those passes small:
//
//   1. Tile sort (`block_sort`): a block of T threads sorts N = 16 T keys
//      (N = TILE = 16384 for the tile pass) with a bitonic network whose keys
//      live in registers, 16 per thread.  Substages with partners inside a
//      thread run in registers, those with partners inside a warp by
//      __shfl_xor_sync, and only those with partners in another warp
//      (j >= 512) go through shared memory: the block writes its keys out
//      once, reads them back in a layout that puts up to four such partner
//      bits inside each thread, runs those substages in registers and
//      writes back.  13 barriers at N = 16384 (the plain network has 105).
//      Partners and directions are bit operations, and every compare-
//      exchange is ascending: a key whose block runs descending in a stage
//      is held complemented (~key) for that stage, so a register substage
//      is one min and one max per pair.  The tile arrives by cp.async (all
//      of a thread's loads in flight, no registers held); a ragged tile is
//      padded with the sentinel key (INT_MAX, or the key of +inf) in shared
//      memory only, and only real keys are written.
//   2. Merge passes (C > TILE): the tile pass writes sorted TILE-key runs;
//      each pass merges neighbouring runs of width w into runs of 2w, until
//      one run covers the row: ceil(log2(ceil(C / TILE))) passes, each
//      reading and writing the row once.  A pass is two launches:
//      `merge_partition` finds, for the first output of every merge block,
//      its merge-path co-rank (how many of its outputs come from the left
//      run) by a binary search in device memory, one thread per block;
//      `merge_pass` loads the two input windows its MT = 8192 outputs
//      consume into shared memory with coalesced 4-byte cp.async copies
//      (rows start at any offset, so 16-byte loads would need a peeled
//      head), each thread finds its own co-rank inside them and merges
//      ITEMS outputs, and the block stores through shared memory,
//      coalesced (these pieces are merge_path.cuh's, shared with
//      merge_split.cu).  A run with no partner (an odd run count,
//      a short last run) is copied by the same code (its co-ranks are the
//      diagonal itself).  Merges compare the int32 keys, never IEEE values,
//      so -0.0 stays before +0.0 across a run boundary.
//   3. The passes ping-pong between `out` and one (rows, C) int32 scratch;
//      the tile pass writes whichever of the two makes the last pass land
//      in `out`, and the last pass undoes the key map.  No padded scratch, no
//      copy pass: 1 + 2 * passes launches (21 at (8, 12.5 M)).
//
// Measured on an NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py): 4.81 ms
// at (8, 12.5 M) int32 against torch.sort's 5.44 ms -- the tile pass
// 1.75 ms, the 10 partitions 0.21 ms, the 10 merge passes 2.82 ms (each
// 0.28 ms against the 0.239 ms its bytes need); 20x the byte bound, which
// no comparison sort that passes the row through device memory ten times
// can reach.
//
// Narrow dtypes: 4-byte keys are loaded by cp.async and stored as they are
// (float32 through the key map), so int32 and float32 take the code above
// unchanged; the narrow dtypes and uint32 are loaded and stored through
// registers, widened and narrowed (a branch on the dtype code, uniform over
// the grid).
// Scratch stays int32: between passes the keys live in the (rows, C)
// scratch and, where `out` is narrower than a key, in a second (rows, C)
// int32 scratch that takes `out`'s place in the ping-pong; only the last
// pass (or the one-block sort) writes `out`.
//
// Index width: array offsets are 64-bit; co-ranks inside a pair of runs are
// stored as int32, so C <= INT_MAX.
//
// Launch plan: the host code is one template over the executors of
// launch_plan.cuh, so `repro_local_sort_plan` is a dry run of exactly the
// launches `repro_local_sort` makes (held equal to the Python
// `repro_torch.kernels.local_sort.plan` on the card).
#include <cuda_runtime.h>

#include <climits>

#include "launch_plan.cuh"
#include "merge_path.cuh"

namespace {

using merge_path::co_rank;
using merge_path::copy_async;
using merge_path::copy_async_wait;
using merge_path::DT_BFLOAT16;
using merge_path::DT_FLOAT16;
using merge_path::DT_FLOAT32;
using merge_path::DT_INT16;
using merge_path::DT_INT32;
using merge_path::DT_INT8;
using merge_path::DT_UINT16;
using merge_path::DT_UINT32;
using merge_path::DT_UINT8;
using merge_path::ITEMS;
using merge_path::merge_windows;
using merge_path::pad_slot;
using merge_path::PART_THREADS;
using merge_path::SLOTS;
using merge_path::THREADS;

constexpr int KPT = 16;               // keys per thread of a block sort
constexpr int TILE = 16384;           // keys of a tile-pass block (1024 threads)
constexpr int MIN_N = 512;            // the smallest block sort: one warp
constexpr int WARP_BITS = 9;          // log2 of the keys one warp holds
constexpr int MT = merge_path::TILE;  // outputs of a merge block (8192)
constexpr int FLOAT_PAD_KEY = 0x7f800000;  // the key of +inf

__host__ __device__ constexpr int ilog2(int n) {
  return n > 1 ? 1 + ilog2(n / 2) : 0;
}

__device__ __forceinline__ int flip_key(int v, int is_float) {
  return is_float ? (v ^ ((v >> 31) & 0x7fffffff)) : v;
}

__device__ __forceinline__ int float_key(float f) {
  return flip_key(__float_as_int(f), 1);
}

__device__ __forceinline__ float key_float(int k) {
  return __int_as_float(flip_key(k, 1));
}

// The key of element i of a narrow `code` array, widened on load (uint32,
// 4 bytes but not its own key, takes this path too: its top bit flipped).
__device__ __forceinline__ int load_key(const void* p, long long i,
                                        int code) {
  switch (code) {
    case DT_INT16: return ((const short*)p)[i];
    case DT_INT8: return ((const signed char*)p)[i];
    case DT_UINT8: return ((const unsigned char*)p)[i];
    case DT_UINT16: return ((const unsigned short*)p)[i];
    case DT_UINT32: return (int)(((const unsigned*)p)[i] ^ 0x80000000u);
    case DT_FLOAT16: return float_key(__half2float(((const __half*)p)[i]));
    default: return float_key(__bfloat162float(((const __nv_bfloat16*)p)[i]));
  }
}

// Element i of a narrow `code` array from its key, narrowed on store.
__device__ __forceinline__ void store_key(void* p, long long i, int k,
                                          int code) {
  switch (code) {
    case DT_INT16: ((short*)p)[i] = (short)k; return;
    case DT_INT8: ((signed char*)p)[i] = (signed char)k; return;
    case DT_UINT8: ((unsigned char*)p)[i] = (unsigned char)k; return;
    case DT_UINT16: ((unsigned short*)p)[i] = (unsigned short)k; return;
    case DT_UINT32: ((unsigned*)p)[i] = (unsigned)k ^ 0x80000000u; return;
    case DT_FLOAT16: ((__half*)p)[i] = __float2half_rn(key_float(k)); return;
    default: ((__nv_bfloat16*)p)[i] = __float2bfloat16_rn(key_float(k));
  }
}

__device__ __forceinline__ bool is_narrow(int code) { return code > DT_FLOAT32; }

// Shared-memory slot of key i: XOR swizzle inside each 32-word row, so the
// layouts below read and write without bank conflicts.
__device__ __forceinline__ int swz(int i) { return i ^ ((i >> 5) & 31); }

// Index of register r of thread t in the layout whose in-thread bits are
// [lo, lo + 4): layout 0 holds 16 consecutive keys per thread.
__device__ __forceinline__ int elem(int t, int lo, int r) {
  return (t & ((1 << lo) - 1)) | (r << lo) | ((t >> lo) << (lo + 4));
}

__device__ __forceinline__ void store_layout(const int (&v)[KPT], int* s,
                                             int lo) {
#pragma unroll
  for (int r = 0; r < KPT; ++r) s[swz(elem(threadIdx.x, lo, r))] = v[r];
}

__device__ __forceinline__ void load_layout(int (&v)[KPT], const int* s,
                                            int lo) {
#pragma unroll
  for (int r = 0; r < KPT; ++r) v[r] = s[swz(elem(threadIdx.x, lo, r))];
}

// One ascending substage on register bit RB: pairs (r, r | 2^RB) of one
// thread, the smaller key to r.  (Stages run ascending everywhere: a key
// whose block of the stage runs descending is held complemented, ~key,
// which reverses the order without overflow.)
template <int RB>
__device__ __forceinline__ void reg_step(int (&v)[KPT]) {
#pragma unroll
  for (int r = 0; r < KPT; ++r) {
    if (r & (1 << RB)) continue;
    const int r2 = r | (1 << RB);
    const int lo_key = min(v[r], v[r2]);
    v[r2] = max(v[r], v[r2]);
    v[r] = lo_key;
  }
}

__device__ __forceinline__ void reg_substage(int (&v)[KPT], int rb) {
  switch (rb) {
    case 0: reg_step<0>(v); break;
    case 1: reg_step<1>(v); break;
    case 2: reg_step<2>(v); break;
    default: reg_step<3>(v); break;
  }
}

// Stage 2^ST < 16 of layout 0: inside each thread, the direction of each
// register's block known at compile time.
template <int ST>
__device__ __forceinline__ void small_stage(int (&v)[KPT]) {
#pragma unroll
  for (int b = ST - 1; b >= 0; --b) {
#pragma unroll
    for (int r = 0; r < KPT; ++r) {
      if (r & (1 << b)) continue;
      const int r2 = r | (1 << b);
      const int lo_key = min(v[r], v[r2]), hi_key = max(v[r], v[r2]);
      const bool asc = (r & (1 << ST)) == 0;
      v[r] = asc ? lo_key : hi_key;
      v[r2] = asc ? hi_key : lo_key;
    }
  }
}

// One substage with partner j = 2^b, 16 <= j < 512 (layout 0): the partner
// key sits in the same register of lane ^ (j / 16); the lower lane keeps
// the smaller key.
__device__ __forceinline__ void shfl_substage(int (&v)[KPT], int b) {
  const int m = 1 << (b - 4);
  const bool keep_min = (threadIdx.x & m) == 0;
#pragma unroll
  for (int r = 0; r < KPT; ++r) {
    const int o = __shfl_xor_sync(0xffffffffu, v[r], m);
    v[r] = keep_min ? min(v[r], o) : max(v[r], o);
  }
}

// The bitonic network over the N = 2^logn keys of the block, held in
// layout 0; s is N ints of shared memory.  Stage k sorts each aligned block
// of k keys ascending iff bit k of its index is 0.  Ends ascending.
__device__ __forceinline__ void sort_registers(int (&v)[KPT], int* s,
                                               int logn) {
  const int t = threadIdx.x;
  small_stage<1>(v);
  small_stage<2>(v);
  small_stage<3>(v);
  int held = 0;                      // the complement mask v is held under
  for (int st = 4; st <= logn; ++st) {
    // from stage 16 on, a thread's keys of layout 0 share one direction
    const int want = ((t << 4) >> st) & 1 ? -1 : 0;
#pragma unroll
    for (int r = 0; r < KPT; ++r) v[r] ^= held ^ want;
    held = want;
    if (st - 1 >= WARP_BITS) {       // partners in other warps: bits st-1..9
      store_layout(v, s, 0);
      for (int h = st - 1; h >= WARP_BITS; h -= 4) {
        const int lo = h - 3;        // bits lo..h inside each thread
        __syncthreads();
        load_layout(v, s, lo);
        const int low = lo > WARP_BITS ? lo : WARP_BITS;
        for (int b = h; b >= low; --b) reg_substage(v, b - lo);
        store_layout(v, s, lo);      // the slots this thread read
      }
      __syncthreads();
      load_layout(v, s, 0);
    }
    for (int b = min(st - 1, WARP_BITS - 1); b >= 4; --b) shfl_substage(v, b);
    for (int b = 3; b >= 0; --b) reg_substage(v, b);
  }
#pragma unroll
  for (int r = 0; r < KPT; ++r) v[r] ^= held;
}

// The keys of block_sort's block: n of them from element `offset` of the
// (rows, C) array (tile blockIdx.x % tiles of row blockIdx.x / tiles).
struct Tile {
  long long offset;
  int n;
};

__device__ __forceinline__ Tile tile_of(long long C, long long tiles, int N) {
  const long long base = (blockIdx.x % tiles) * N;
  const long long rest = C - base;
  return {blockIdx.x / tiles * C + base, rest < N ? (int)rest : N};
}

// Sort N = THREADS * 16 keys per block: tile (blockIdx.x % tiles) of row
// (blockIdx.x / tiles), keys [tile N, tile N + N) of the row, padded with
// pad_key past C in shared memory only.  `in` holds `in_code` elements;
// writes the real keys into `out` as `out_code` elements (DT_INT32: the
// keys as they are; DT_FLOAT32: float32 values; a narrow code: values
// narrowed).
template <int THREADS>
__global__ void __launch_bounds__(THREADS)
block_sort(const void* __restrict__ in, void* __restrict__ out, long long C,
           long long tiles, int in_code, int out_code, int pad_key) {
  extern __shared__ int s[];
  constexpr int N = THREADS * KPT;
  constexpr int LOGN = ilog2(N);
  const int t = threadIdx.x;
  {
    const Tile tile = tile_of(C, tiles, N);
    if (!is_narrow(in_code)) {
      const int* src = (const int*)in + tile.offset;
      for (int i = t; i < N; i += THREADS) {   // coalesced, all in flight
        if (i < tile.n) copy_async(&s[swz(i)], src + i);
        else s[swz(i)] = pad_key;              // its own key and value
      }
      copy_async_wait();
    } else {
      for (int i = t; i < N; i += THREADS)
        s[swz(i)] = i < tile.n ? load_key(in, tile.offset + i, in_code)
                               : pad_key;
    }
  }
  __syncthreads();
  int v[KPT];
  load_layout(v, s, 0);
  const int is_float = in_code == DT_FLOAT32;
#pragma unroll
  for (int r = 0; r < KPT; ++r) v[r] = flip_key(v[r], is_float);
  sort_registers(v, s, LOGN);
  store_layout(v, s, 0);
  __syncthreads();
  const Tile tile = tile_of(C, tiles, N);
  if (!is_narrow(out_code)) {
    int* dst = (int*)out + tile.offset;
    const int flip = out_code == DT_FLOAT32;
#pragma unroll
    for (int r = 0; r < KPT; ++r) {
      const int i = r * THREADS + t;
      if (i < tile.n) dst[i] = flip_key(s[swz(i)], flip);
    }
  } else {
#pragma unroll
    for (int r = 0; r < KPT; ++r) {
      const int i = r * THREADS + t;
      if (i < tile.n) store_key(out, tile.offset + i, s[swz(i)], out_code);
    }
  }
}

// The runs of width w that merge block q (outputs [q MT, q MT + MT) of its
// row) reads: the pair starting at ps, left run [ps, ps + la), right run
// [ps + w, ps + w + lb) (lb = 0: no partner, the block copies).
struct Pair {
  long long ps, la, lb;
};

__device__ __forceinline__ Pair pair_of(long long o0, long long C,
                                        long long w) {
  Pair p;
  p.ps = o0 / (2 * w) * (2 * w);
  p.la = C - p.ps < w ? C - p.ps : w;
  const long long r = C - p.ps - w;
  p.lb = r <= 0 ? 0 : (r < w ? r : w);
  return p;
}

// Merge pass, step 1: diag[g] = co-rank of the first output of merge block
// g (g = row * blocks_per_row + q) inside its pair.
__global__ void merge_partition(const int* __restrict__ src,
                                int* __restrict__ diag, long long C,
                                long long w, long long blocks_per_row,
                                long long total) {
  const long long g = (long long)blockIdx.x * PART_THREADS + threadIdx.x;
  if (g >= total) return;
  const long long row = g / blocks_per_row;
  const long long o0 = (g % blocks_per_row) * MT;
  const Pair p = pair_of(o0, C, w);
  const int* a = src + row * C + p.ps;
  const int* b = a + w;
  diag[g] = (int)co_rank<long long>([a](long long i) { return a[i]; }, p.la,
                                    [b](long long i) { return b[i]; }, p.lb,
                                    o0 - p.ps);
}

// Merge pass, step 2: block g writes outputs [q MT, q MT + MT) of its row
// of dst, merging the windows of its pair's two runs in src that diag says
// they consume; the keys are written as `out_code` elements (block_sort).
__global__ void __launch_bounds__(THREADS)
merge_pass(const int* __restrict__ src, void* __restrict__ dst,
           const int* __restrict__ diag, long long C, long long w,
           long long blocks_per_row, int out_code) {
  __shared__ int s[SLOTS];
  const long long g = blockIdx.x;
  const long long row = g / blocks_per_row;
  const long long o0 = (g % blocks_per_row) * MT;
  const int n_out = C - o0 < MT ? (int)(C - o0) : MT;
  const Pair p = pair_of(o0, C, w);
  const long long d0 = o0 - p.ps;
  const long long d1 = d0 + n_out;
  const long long a0 = diag[g];
  const long long a1 = d1 < p.la + p.lb ? diag[g + 1] : p.la;
  const int na = (int)(a1 - a0);
  const int nb = n_out - na;
  const int* a = src + row * C + p.ps + a0;
  const int* b = src + row * C + p.ps + w + (d0 - a0);
  for (int x = threadIdx.x; x < n_out; x += THREADS)  // coalesced
    copy_async(&s[pad_slot(x)], x < na ? a + x : b + (x - na));
  copy_async_wait();
  __syncthreads();
  merge_windows<int>(s, na, nb);
  const long long o = row * C + o0;
  if (!is_narrow(out_code)) {
    int* op = (int*)dst + o;
    const int flip = out_code == DT_FLOAT32;
#pragma unroll
    for (int q = 0; q < ITEMS; ++q) {
      const int x = q * THREADS + threadIdx.x;
      if (x < n_out) op[x] = flip_key(s[pad_slot(x)], flip);
    }
  } else {
#pragma unroll
    for (int q = 0; q < ITEMS; ++q) {
      const int x = q * THREADS + threadIdx.x;
      if (x < n_out) store_key(dst, o + x, s[pad_slot(x)], out_code);
    }
  }
}

}  // namespace

extern "C" int repro_local_sort_tile(void) { return TILE; }

extern "C" const char* repro_local_sort_error(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

namespace {

template <int THREADS, class Exec>
int launch_block_sort(Exec& ex, const char* name, long long blocks,
                      const void* x, void* y, long long C, long long tiles,
                      int in_code, int out_code, int pad_key,
                      cudaStream_t st) {
  const size_t smem = (size_t)THREADS * KPT * sizeof(int);
  return ex(name, (const void*)block_sort<THREADS>, dim3((unsigned)blocks),
            THREADS, smem, [&] {
              const cudaError_t e = cudaFuncSetAttribute(
                  block_sort<THREADS>,
                  cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
              if (e != cudaSuccess) return e;
              block_sort<THREADS><<<(unsigned)blocks, THREADS, smem, st>>>(
                  x, y, C, tiles, in_code, out_code, pad_key);
              return cudaSuccess;
            });
}

// One block per row for C <= TILE: N = max(512, next power of two >= C).
template <class Exec>
int sort_rows(Exec& ex, const void* x, void* y, long long rows, long long C,
              int code, int pad_key, cudaStream_t st) {
  long long n = MIN_N;
  while (n < C) n <<= 1;
  const char* name = "sort_rows_smem";
  switch (n / KPT) {
    case 32: return launch_block_sort<32>(ex, name, rows, x, y, C, 1, code, code, pad_key, st);
    case 64: return launch_block_sort<64>(ex, name, rows, x, y, C, 1, code, code, pad_key, st);
    case 128: return launch_block_sort<128>(ex, name, rows, x, y, C, 1, code, code, pad_key, st);
    case 256: return launch_block_sort<256>(ex, name, rows, x, y, C, 1, code, code, pad_key, st);
    case 512: return launch_block_sort<512>(ex, name, rows, x, y, C, 1, code, code, pad_key, st);
    default: return launch_block_sort<1024>(ex, name, rows, x, y, C, 1, code, code, pad_key, st);
  }
}

// The host code, once for launching and for planning (launch_plan.cuh).
template <class Exec>
int run(Exec& ex, const void* x, void* y, int* sc, int* sc2, int* diag,
        long long rows, long long C, int code, cudaStream_t st) {
  if (code < DT_INT32 || code > DT_UINT32) return (int)cudaErrorInvalidValue;
  const bool floaty = code == DT_FLOAT32 || code == DT_FLOAT16 ||
                      code == DT_BFLOAT16;
  const int pad_key = floaty ? FLOAT_PAD_KEY : INT_MAX;  // key of +inf / BIG
  if (rows == 0) return 0;
  if (C > INT_MAX) return (int)cudaErrorInvalidValue;
  if (C <= TILE) return sort_rows(ex, x, y, rows, C, code, pad_key, st);
  const long long tiles = (C + TILE - 1) / TILE;
  int passes = 0;
  while ((1LL << passes) < tiles) ++passes;
  // the keys ping-pong between sc and `ping`: y itself where its elements
  // are 4-byte, else the second scratch; the last pass writes y
  const bool narrow = code > DT_FLOAT32 && code != DT_UINT32;
  int* ping = narrow ? sc2 : (int*)y;
  // the tile pass writes the buffer that makes the last pass land in y
  int* src = passes % 2 ? sc : ping;
  int err = launch_block_sort<TILE / KPT>(ex, "tile_sort", rows * tiles, x,
                                          src, C, tiles, code, DT_INT32,
                                          pad_key, st);
  if (err) return err;
  const long long bpr = (C + MT - 1) / MT;
  const long long total = rows * bpr;
  const unsigned part_blocks =
      (unsigned)((total + PART_THREADS - 1) / PART_THREADS);
  long long w = TILE;
  for (int pass = 1; pass <= passes; ++pass, w *= 2) {
    const int last = pass == passes;
    void* dst = last ? y : ((passes - pass) % 2 ? sc : ping);
    const int out_code = last ? code : DT_INT32;
    err = ex("merge_partition", (const void*)merge_partition,
             dim3(part_blocks), PART_THREADS, 0, [&] {
               merge_partition<<<part_blocks, PART_THREADS, 0, st>>>(
                   src, diag, C, w, bpr, total);
               return cudaSuccess;
             });
    if (err) return err;
    err = ex("merge_pass", (const void*)merge_pass, dim3((unsigned)total),
             THREADS, 0, [&] {
               merge_pass<<<(unsigned)total, THREADS, 0, st>>>(
                   src, dst, diag, C, w, bpr, out_code);
               return cudaSuccess;
             });
    if (err) return err;
    src = (int*)dst;
  }
  return 0;
}

}  // namespace

// in, out: (rows, C) contiguous arrays of dtype `code` (merge_path.cuh).
// When C > TILE: scratch is a (rows, C) int32 buffer, scratch2 another one
// where the dtype is narrower than 4 bytes (else unused), and diag a
// rows * ceil(C / MT) int32 buffer (MT = 8192 outputs per merge block);
// else all three are unused.  Launches on `stream`, does not synchronise,
// returns the first CUDA error (0 if none).
extern "C" int repro_local_sort(const void* in, void* out, void* scratch,
                                void* scratch2, void* diag, long long rows,
                                long long C, int code, void* stream) {
  Launcher ex;
  return run(ex, in, out, (int*)scratch, (int*)scratch2, (int*)diag, rows, C,
             code, (cudaStream_t)stream);
}

// The dry run of repro_local_sort: fills out[0..max) with the launches it
// would make, launches nothing; returns their count or minus a CUDA error.
extern "C" int repro_local_sort_plan(long long rows, long long C, int code,
                                     ReproLaunch* out, int max) {
  Planner ex{out, max, 0};
  const int err = run(ex, nullptr, nullptr, nullptr, nullptr, nullptr, rows,
                      C, code, (cudaStream_t)0);
  return plan_result(err, ex);
}
