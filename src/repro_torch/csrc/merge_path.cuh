// The merge-path pieces shared by local_sort.cu's merge passes and
// merge_split.cu: the co-rank search, padded shared-memory slots, the
// cp.async window load, the per-thread window merge with a staged
// coalesced store, and the widening of the sort dtypes.
//
// A merge block writes TILE = THREADS * ITEMS consecutive outputs of the
// stable merge of two sorted runs (ties to the first run, a).  The block's
// first and one-past-last co-ranks (how many of the outputs before a rank
// come from a) cut the two input windows it consumes; the windows come into
// shared memory, each thread finds its own co-rank inside them by a binary
// search and merges ITEMS outputs in registers, and the block stages the
// results back through shared memory so that the store is coalesced.
//
// Keys are 32-bit in shared memory, of type K: comparisons are K's own
// `<=`.  local_sort merges int32 total-order keys; merge_split merges the
// widened values (int for the integer dtypes, float for the float ones, so
// -0.0 == +0.0 and ties go to a).
#pragma once
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace merge_path {

constexpr int THREADS = 256;               // threads of a merge block
constexpr int ITEMS = 32;                  // outputs each thread merges
constexpr int TILE = THREADS * ITEMS;      // outputs of a merge block
constexpr int SLOTS = TILE + TILE / 32;    // padded shared-memory slots
constexpr int PART_THREADS = 256;          // threads of a partition block

// dtype codes of the C entries (`DTYPE_CODES` in kernels/bitonic_sort.py)
enum DType {
  DT_INT32 = 0,
  DT_FLOAT32 = 1,
  DT_INT16 = 2,
  DT_INT8 = 3,
  DT_UINT8 = 4,
  DT_FLOAT16 = 5,
  DT_BFLOAT16 = 6,
  DT_UINT16 = 7,
  DT_UINT32 = 8,
};

// An element of type T widened to its 32-bit key type K, exactly, and back:
// signed integers sign-extend, uint8 and uint16 zero-extend, uint32 flips
// its top bit (an order-preserving map onto int), float16 and bfloat16
// convert to float32 (every value of theirs is a float32 value).  `raw`:
// the element is its own key, so a copy needs no register (cp.async).
template <typename T>
struct Wide {
  using K = int;
  static constexpr bool raw = sizeof(T) == 4;
  __device__ __forceinline__ static K widen(T v) { return (K)v; }
  __device__ __forceinline__ static T narrow(K k) { return (T)k; }
};
template <>
struct Wide<unsigned int> {
  using K = int;
  static constexpr bool raw = false;
  __device__ __forceinline__ static K widen(unsigned int v) {
    return (K)(v ^ 0x80000000u);
  }
  __device__ __forceinline__ static unsigned int narrow(K k) {
    return (unsigned int)k ^ 0x80000000u;
  }
};
template <>
struct Wide<float> {
  using K = float;
  static constexpr bool raw = true;
  __device__ __forceinline__ static K widen(float v) { return v; }
  __device__ __forceinline__ static float narrow(K k) { return k; }
};
template <>
struct Wide<__half> {
  using K = float;
  static constexpr bool raw = false;
  __device__ __forceinline__ static K widen(__half v) {
    return __half2float(v);
  }
  __device__ __forceinline__ static __half narrow(K k) {
    return __float2half_rn(k);
  }
};
template <>
struct Wide<__nv_bfloat16> {
  using K = float;
  static constexpr bool raw = false;
  __device__ __forceinline__ static K widen(__nv_bfloat16 v) {
    return __bfloat162float(v);
  }
  __device__ __forceinline__ static __nv_bfloat16 narrow(K k) {
    return __float2bfloat16_rn(k);
  }
};

// Host dispatch of a dtype code to f(Tag<T>{}).
template <typename T>
struct Tag {
  using type = T;
};

template <class F>
int with_dtype(int code, F&& f) {
  switch (code) {
    case DT_INT32: return f(Tag<int>{});
    case DT_FLOAT32: return f(Tag<float>{});
    case DT_INT16: return f(Tag<short>{});
    case DT_INT8: return f(Tag<signed char>{});
    case DT_UINT8: return f(Tag<unsigned char>{});
    case DT_FLOAT16: return f(Tag<__half>{});
    case DT_BFLOAT16: return f(Tag<__nv_bfloat16>{});
    case DT_UINT16: return f(Tag<unsigned short>{});
    case DT_UINT32: return f(Tag<unsigned int>{});
  }
  return (int)cudaErrorInvalidValue;
}

// A 4-byte copy from device memory into shared memory that holds no
// register (cp.async): a thread issues all of its copies, then waits.
__device__ __forceinline__ void copy_async(void* smem, const void* g) {
  const unsigned sa = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(sa),
               "l"(g)
               : "memory");
}

__device__ __forceinline__ void copy_async_wait() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Element x of a window into its shared-memory slot: elements that are
// their own keys by cp.async (cp.async has no 1- or 2-byte form), the
// others through a register, widened.
template <typename T>
__device__ __forceinline__ void load_slot(typename Wide<T>::K* slot,
                                          const T* g) {
  if constexpr (Wide<T>::raw) copy_async(slot, g);
  else *slot = Wide<T>::widen(*g);
}

// Of the first d outputs of the stable merge of a[0, na) and b[0, nb)
// (ties to a), how many come from a: a binary search, one thread.
template <typename I, typename GetA, typename GetB>
__device__ __forceinline__ I co_rank(GetA a, I na, GetB b, I nb, I d) {
  I lo = d > nb ? d - nb : 0;
  I hi = d < na ? d : na;
  while (lo < hi) {
    const I mid = (lo + hi) >> 1;
    if (a(mid) <= b(d - 1 - mid)) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// Shared-memory slot of window element i: one pad word every 32, so the
// staged writes below (32 consecutive slots a thread) miss no bank twice.
__device__ __forceinline__ int pad_slot(int i) { return i + (i >> 5); }

// The block's merge, after its windows s[0, na) (from a) and s[na, na + nb)
// (from b) are loaded and the block has synchronised: each thread finds its
// co-rank inside the windows, merges its ITEMS outputs in registers and
// stages them back into s, so that output x sits in s[pad_slot(x)] when it
// returns (the block synchronised again).
template <typename K>
__device__ __forceinline__ void merge_windows(K* s, int na, int nb) {
  const int n_out = na + nb;
  const int r0 = threadIdx.x * ITEMS;
  const int cnt = n_out - r0 < ITEMS ? (n_out - r0 > 0 ? n_out - r0 : 0)
                                     : ITEMS;
  K vals[ITEMS];
  if (cnt > 0) {
    const K* sp = s;
    int ia = co_rank<int>([sp](int i) { return sp[pad_slot(i)]; }, na,
                          [sp, na](int i) { return sp[pad_slot(na + i)]; },
                          nb, r0);
    int ib = r0 - ia;
#pragma unroll
    for (int q = 0; q < ITEMS; ++q) {
      if (q < cnt) {
        const K ka = ia < na ? s[pad_slot(ia)] : K();
        const K kb = ib < nb ? s[pad_slot(na + ib)] : K();
        const bool take_a = ib >= nb || (ia < na && ka <= kb);
        vals[q] = take_a ? ka : kb;
        ia += take_a;
        ib += !take_a;
      }
    }
  }
  __syncthreads();
#pragma unroll
  for (int q = 0; q < ITEMS; ++q)
    if (q < cnt) s[pad_slot(r0 + q)] = vals[q];
  __syncthreads();
}

}  // namespace merge_path
