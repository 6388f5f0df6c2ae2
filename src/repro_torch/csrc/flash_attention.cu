// flash_attention: blocked online-softmax attention, one block per
// (q tile, head, batch), a loop over the KV tiles inside the block.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py::flash_attention.
// q: (B, H, Sq, HD), k and v: (B, KV, Skv, HD), out: (B, H, Sq, HD), all
// contiguous, f32, bf16 or f16.  Head h reads KV head h / (H / KV).  The
// scores are scaled by `scale` (the wrapper's default: HD^-0.5).
//
// The TPU kernel walks the KV tiles as the last, sequential grid axis and
// keeps m, l and acc in VMEM scratch between grid steps.  Blocks run in
// parallel and in no order here, so the KV walk is a loop inside the block,
// and m, l and acc live in registers for the whole walk.
//
// Semantics kept from the TPU kernel by both kernels below: scores are f32
// products, times `scale` after the product; masked scores (causal, window,
// past Skv) are the finite -1e30, so a row whose first live tile is all
// masked takes p = exp(0) = 1 there and its first real score wipes that with
// corr = exp(-1e30 - m) = 0; a tile is skipped when causal masking or the
// window empties it; l is clamped at 1e-20; the output is cast to q's dtype.
// The sums run in another order than the TPU kernel's, so results agree
// within rounding, not bit for bit.
//
// Bound on an H100 SXM: the live tiles' 4 bq bk HD flops over the tensor
// cores' peak for the input type (989 TFLOP/s bf16; the f32 products of
// the reference are counted at the 67 TFLOP/s of the fp32 pipe), or the
// bytes of q, k, v and out over 3.35 TB/s, whichever is larger.  At the
// model shapes both are bound by operations.
//
// float32: `fa_kernel`, on the fp32 pipe (TF32 would miss the 2e-5
// tolerance), register-blocked as an SGEMM is.  bq / 16 warps (bq a multiple
// of 16, at most 128), warp w owning query rows [16 w, 16 w + 16) of the
// tile; a KV tile is BK = 64 keys.  Lane (rg, kg) = (lane / 8, lane % 8)
// holds rows rg + 4 i (i < 4) of its warp's slice:
//
//   * S = Q K^T: the lane scores its 4 rows against keys 8 kg .. 8 kg + 7,
//     a 4 x 8 micro-tile, taking hd in chunks of 4 floats: per chunk 4 + 8
//     float4 reads of shared memory feed 128 FMAs (the former kernel read 2
//     floats a FMA).  A warp's read of a q chunk touches 4 rows, of a k
//     chunk 8 rows: both are laid out row-major and XOR-swizzled by chunk
//     (q by row % 4, k by row / 8), so each read is free of bank conflicts
//     without padding.
//   * Online softmax on the micro-tile: the row max is a shuffle over the 8
//     lanes of a row (xor 1, 2, 4); each lane keeps its own part of the row
//     sum l, summed over the 8 lanes once at the end.
//   * O += P V: P leaves the registers through a 16 x 64 slice of shared
//     memory a warp (float4 along keys, swizzled by row % 4); the lane's O
//     is its 4 rows x hd / 8 dims (dims 4 kg + 32 e), so per 4 keys 4 float4
//     reads of P and hd / 8 of V feed 2 hd FMAs: 256 for 20 reads at hd 128.
//   * K and V tiles come by 16-byte cp.async into a ring of two stages, so
//     the next tile's loads overlap this tile's products; rows past Skv (or
//     Sq for q) are zero-filled by the copy.
//   * Shared memory: the q tile, two K+V stages and P, (bq + 4 BK) HD 4 +
//     bq BK 4 bytes: 229,376 B at bq = HD = 128, under the 232,448 B a block
//     may have, so one block of 256 threads an SM.  Blocks take their q tile
//     by `block_coords`, heaviest first, as `fa_wgmma` does; a warp skips a
//     tile in which causal masking hides every key from all its rows (what
//     it would add is exactly nothing).
//
// bfloat16 and float16: `fa_wgmma<T>`, one template over the 16-bit type T
// (wgmma and TMA take both; only the instruction's type, P's packing and the
// output's rounding differ), both products on the tensor cores (PTX wgmma), the
// tiles brought by the Tensor Memory Accelerator (TMA).  bq = 64 or 128
// query rows, bk = 64 or 128 keys.  A block is bq / 64 consumer warpgroups
// (64 query rows each) and one producer warpgroup, whose first thread
// issues every TMA load; `setmaxnreg` leaves the producer 24 registers a
// thread and gives the consumers 240 (at 384 threads, 65,536 registers are
// 168 a thread on average; a consumer holds S, 64 f32, O, 64, and P as hi
// and lo T pairs, 64).
//
//   * Shared memory: the q tile, loaded once, and a ring of STAGES = 3 K+V
//     stages, each signalled by mbarriers (full K, full V, empty), so the
//     loads of the next tiles overlap the products of this one.  1,024 B of
//     alignment slack + bq HD 2 + 3 (2 bk HD 2) + the barriers: 230,480 B at
//     bq = bk = HD = 128, under the 232,448 B a block may have.
//   * S = Q K^T: wgmma m64n{bk}k16, both operands in shared memory, K-major
//     (the reduction dim, hd, contiguous).  bf16 and f16 products are exact
//     in f32, so S differs from the plain version only in summation order.
//   * Softmax on the accumulator layout, in registers: a thread holds two
//     rows' slices; the row max is a quad shuffle (xor 1, 2); the scale is
//     folded with log2(e) into one multiply and exp2f.  Only the tiles cut
//     by the diagonal, the window's edge or Skv evaluate the mask.
//   * O += P V: wgmma m64n{HD}k16, A = P from registers, B = V in shared
//     memory with hd contiguous (the transposed, N-major descriptor).  P's
//     A fragment is S's accumulator fragment converted in place to T x2
//     pairs (no trip through shared memory).  P rounded once to bf16 misses
//     the kernel's tolerance (one bf16 step of the output, KERNEL_TOL) on
//     the long rows, so P is split into hi = T(p) and lo = T(p - hi) and
//     P V is two wgmmas a k-step: 2^-17 of relative error instead of 2^-9,
//     at 1.5x the tensor work.  One f16 rounding (2^-11) misses too: the
//     outputs near zero leave one f16 step plus 1e-5 by the thousand at
//     qwen3-0.6b's and the serve prefill's shapes (PERF.md), so f16
//     splits as well.
//   * The next tile's S = Q K^T is issued right behind this tile's P V
//     (into S's registers, free once P is formed), so the tensor cores
//     wait for the softmax only; the two consumer warpgroups fill each
//     other's softmax gaps.
//   * Order and skipping: a block computes its live KV range [lo, hi) up
//     front, so only live tiles are fetched; the grid's linear block index
//     takes the q tile last-first from its slowest-varying part, so the
//     heaviest causal tiles of every head start first.
//
// Where the trouble lies, and what the design does about it:
//   * TMA descriptors per head: q, k and v are encoded as 3-D tensors (hd,
//     S, B heads), not 2-D (B heads S, hd), so a ragged last KV tile reads
//     zeros past Skv (as the plain version pads) instead of the next head's
//     keys, and a q tile stops at Sq.  out is written by the consumer
//     threads from registers, rows past Sq skipped.
//   * Swizzle: a 128-byte swizzle limits a box row to 128 B (64 bf16), so
//     an hd = 128 tile is two 64-column boxes and the descriptors step from
//     one to the other (K-major: the start address; N-major: the leading
//     byte offset).  hd = 32 and 16 rows are 64 and 32 B and use the 64-
//     and 32-byte swizzles.  Tiles sit on 1,024-byte boundaries.
//   * cuTensorMapEncodeTiled is reached through cudaGetDriverEntryPoint, so
//     the library links the CUDA runtime only; descriptors are
//     __grid_constant__ parameters.
//   * TMA needs 16-byte aligned bases and strides: the wrapper raises on a
//     misaligned q, k or v.
//   * wgmma reads and writes registers asynchronously: every fragment is
//     fenced (fence_regs) on both sides of a commit and wait.
//
// Launch plan: the host code is one template over the executors of
// launch_plan.cuh, so `repro_flash_attention_plan` is a dry run of exactly the
// launches `repro_flash_attention` makes (held equal to the Python
// `repro_torch.kernels.flash_attention.plan` on the card).
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "launch_plan.cuh"

namespace {

constexpr float NEG_INF = -1e30f;
// dtype codes of the C entry (`DTYPE_CODES` in kernels/flash_attention.py)
constexpr int DT_F32 = 0, DT_BF16 = 1, DT_F16 = 2;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// Block (x, y, z) of the (nq, H, B) grid takes the linear index
// x + nq (y + H z); the q tile is taken from the slowest-varying part,
// last tile first, so the heaviest causal tiles of every head start in
// the first wave.
__device__ __forceinline__ void block_coords(int H, int& iq, int& h, int& b) {
  const int per = gridDim.y * gridDim.z;
  const int lin = blockIdx.x + gridDim.x * (blockIdx.y + gridDim.y * blockIdx.z);
  iq = gridDim.x - 1 - lin / per;
  h = (lin % per) % H;
  b = (lin % per) / H;
}

// ---------------------------------------------------------------------------
// f32: fa_kernel, register-blocked on the fp32 pipe (see the note at the top)
// ---------------------------------------------------------------------------
constexpr int F32_BK = 64;         // keys of a KV tile
constexpr int F32_WARP_ROWS = 16;  // query rows of a warp
constexpr int F32_RPT = 4;         // rows a lane holds: rg + 4 i
constexpr int F32_KPT = 8;         // keys a lane scores: 8 kg + j

// 16 bytes global -> shared, zeros when `in` is false (src-size 0)
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(in ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Rows [row0, row0 + rows) of a (*, HD) f32 matrix into shared memory, row
// r's 16-byte chunk c at chunk c ^ swz(r) of its row; rows at or past
// `limit` read as zeros.  Every thread of the block takes part.
template <int HD, class Swz>
__device__ __forceinline__ void load_rows(float* dst, const float* src,
                                          int row0, int rows, int limit,
                                          Swz swz) {
  constexpr int C = HD / 4;
  for (int i = threadIdx.x; i < rows * C; i += blockDim.x) {
    const int r = i / C, c = i % C;
    const bool in = row0 + r < limit;
    const float* g = src + (in ? (long long)(row0 + r) * HD + 4 * c : 0);
    cp_async16(smem_u32(dst + r * HD + 4 * (c ^ swz(r))), g, in);
  }
}

template <int N>
__device__ __forceinline__ void ld_vec(const float* p, float (&w)[N]) {
  if constexpr (N == 4) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    w[0] = x.x, w[1] = x.y, w[2] = x.z, w[3] = x.w;
  } else {
    const float2 x = *reinterpret_cast<const float2*>(p);
    w[0] = x.x, w[1] = x.y;
  }
}

template <int N>
__device__ __forceinline__ void st_vec(float* p, const float* w, float by) {
  if constexpr (N == 4)
    *reinterpret_cast<float4*>(p) =
        make_float4(w[0] / by, w[1] / by, w[2] / by, w[3] / by);
  else
    *reinterpret_cast<float2*>(p) = make_float2(w[0] / by, w[1] / by);
}

template <int HD>
__global__ void __launch_bounds__(256, 1)
fa_kernel(const float* __restrict__ q, const float* __restrict__ k,
          const float* __restrict__ v, float* __restrict__ out, int H, int KV,
          int Sq, int Skv, int causal, int window, float scale) {
  constexpr int C = HD / 4;                  // 16-byte chunks of a row
  constexpr int BK = F32_BK;
  constexpr int KSW = (C < 8 ? C : 8) - 1;   // K's swizzle mask
  constexpr int VEC = HD >= 32 ? 4 : 2;      // output dims side by side
  constexpr int NV = HD / (8 * VEC);         // such groups a lane holds
  const int nwarp = blockDim.x / 32, bq = nwarp * F32_WARP_ROWS;
  extern __shared__ float4 smem_f4[];
  float* const sq = reinterpret_cast<float*>(smem_f4);
  float* const skv = sq + bq * HD;           // stage s: K, then V
  float* const sp = skv + 2 * 2 * BK * HD;   // P: 16 x BK a warp

  int iq, h, b;
  block_coords(H, iq, h, b);
  const int kvh = h / (H / KV);
  const int q0 = iq * bq;
  // the live KV tiles [lo, hi) of rows [q0, q0 + bq), as in fa_wgmma
  const int nk = (Skv + BK - 1) / BK;
  const int hi = causal ? min(nk, (q0 + bq - 1) / BK + 1) : nk;
  const int first = q0 - window + 1;
  const int lo = window && first > 0 ? first / BK : 0;
  const int n = max(hi - lo, 0);
  const float* qb = q + (long long)(b * H + h) * Sq * HD;
  const float* kb = k + (long long)(b * KV + kvh) * Skv * HD;
  const float* vb = v + (long long)(b * KV + kvh) * Skv * HD;

  // q rows read together differ in row % 4, k rows in row / 8 (mod 8)
  auto q_swz = [](int r) { return r & 3; };
  auto k_swz = [](int r) { return (r >> 3) & KSW; };
  auto v_swz = [](int) { return 0; };
  auto load_kv = [&](int it) {
    float* sk = skv + (it & 1) * 2 * BK * HD;
    const int k0 = (lo + it) * BK;
    load_rows<HD>(sk, kb, k0, BK, Skv, k_swz);
    load_rows<HD>(sk + BK * HD, vb, k0, BK, Skv, v_swz);
  };
  // groups: q and tile 0, then one a tile (empty past the last), so that
  // waiting for all but the newest group always lands tile it
  load_rows<HD>(sq, qb, q0, bq, Sq, q_swz);
  if (n > 0) load_kv(0);
  cp_async_commit();
  if (n > 1) load_kv(1);
  cp_async_commit();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int rg = lane >> 3, kg = lane & 7;   // kg: also the dims group
  const int wrow0 = q0 + warp * F32_WARP_ROWS;
  const float* qs = sq + (warp * F32_WARP_ROWS + rg) * HD;  // + 4 i HD
  float* ps = sp + (warp * F32_WARP_ROWS + rg) * BK;        // + 4 i BK
  float o[F32_RPT][NV * VEC], m[F32_RPT], l[F32_RPT];
#pragma unroll
  for (int i = 0; i < F32_RPT; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int e = 0; e < NV * VEC; ++e) o[i][e] = 0.f;
  }

  for (int it = 0; it < n; ++it) {
    cp_async_wait<1>();
    __syncthreads();  // tile it is in, from every thread's copies
    const float* sk = skv + (it & 1) * 2 * BK * HD;
    const float* sv = sk + BK * HD;
    const int k0 = (lo + it) * BK;
    // causal masking hides every key of this tile from all the warp's rows
    if (!(causal && k0 > wrow0 + F32_WARP_ROWS - 1)) {
      // S = Q K^T, a 4 x 8 micro-tile, hd in 16-byte chunks
      float s[F32_RPT][F32_KPT];
#pragma unroll
      for (int i = 0; i < F32_RPT; ++i)
#pragma unroll
        for (int j = 0; j < F32_KPT; ++j) s[i][j] = 0.f;
      const float* ks = sk + 8 * kg * HD;  // key 8 kg + j: + j HD
#pragma unroll 8
      for (int c = 0; c < C; ++c) {
        float4 qv[F32_RPT], kv[F32_KPT];
#pragma unroll
        for (int i = 0; i < F32_RPT; ++i)
          qv[i] = *reinterpret_cast<const float4*>(qs + 4 * i * HD +
                                                   4 * (c ^ rg));
#pragma unroll
        for (int j = 0; j < F32_KPT; ++j)
          kv[j] = *reinterpret_cast<const float4*>(ks + j * HD +
                                                   4 * (c ^ (kg & KSW)));
#pragma unroll
        for (int i = 0; i < F32_RPT; ++i)
#pragma unroll
          for (int j = 0; j < F32_KPT; ++j) {
            s[i][j] = fmaf(qv[i].x, kv[j].x, s[i][j]);
            s[i][j] = fmaf(qv[i].y, kv[j].y, s[i][j]);
            s[i][j] = fmaf(qv[i].z, kv[j].z, s[i][j]);
            s[i][j] = fmaf(qv[i].w, kv[j].w, s[i][j]);
          }
      }

      // online softmax; only tiles cut by the diagonal, the window's edge
      // or Skv evaluate the mask
      const bool edge =
          k0 + BK > Skv || (causal && k0 + BK - 1 > wrow0) ||
          (window && wrow0 + F32_WARP_ROWS - 1 - k0 >= window);
#pragma unroll
      for (int i = 0; i < F32_RPT; ++i) {
        const int r = wrow0 + rg + 4 * i;
        float mx = NEG_INF;
#pragma unroll
        for (int j = 0; j < F32_KPT; ++j) {
          float x = s[i][j] * scale;
          if (edge) {
            const int c = k0 + 8 * kg + j;
            const bool ok = c < Skv && (!causal || c <= r) &&
                            (!window || r - c < window);
            x = ok ? x : NEG_INF;
          }
          s[i][j] = x;
          mx = fmaxf(mx, x);
        }
        mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 2));
        mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 4));
        const float m_new = fmaxf(m[i], mx);
        const float corr = expf(m[i] - m_new);
        m[i] = m_new;
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < F32_KPT; ++j) {
          s[i][j] = expf(s[i][j] - m_new);
          sum += s[i][j];
        }
        l[i] = l[i] * corr + sum;
#pragma unroll
        for (int e = 0; e < NV * VEC; ++e) o[i][e] *= corr;
        // P row rg + 4 i, keys 8 kg .. 8 kg + 7: chunks 2 kg and 2 kg + 1
        float* pr = ps + 4 * i * BK;
        *reinterpret_cast<float4*>(pr + 4 * ((2 * kg) ^ rg)) =
            make_float4(s[i][0], s[i][1], s[i][2], s[i][3]);
        *reinterpret_cast<float4*>(pr + 4 * ((2 * kg + 1) ^ rg)) =
            make_float4(s[i][4], s[i][5], s[i][6], s[i][7]);
      }
      __syncwarp();

      // O += P V: 4 keys a step, dims VEC kg + 8 VEC e of each
      const float* vs = sv + VEC * kg;
#pragma unroll 4
      for (int c = 0; c < BK / 4; ++c) {
        float4 pv[F32_RPT];
#pragma unroll
        for (int i = 0; i < F32_RPT; ++i)
          pv[i] = *reinterpret_cast<const float4*>(ps + 4 * i * BK +
                                                   4 * (c ^ rg));
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const float* vrow = vs + (4 * c + kk) * HD;
#pragma unroll
          for (int e = 0; e < NV; ++e) {
            float w[VEC];
            ld_vec<VEC>(vrow + 8 * VEC * e, w);
#pragma unroll
            for (int i = 0; i < F32_RPT; ++i) {
              const float p = kk == 0 ? pv[i].x : kk == 1 ? pv[i].y
                              : kk == 2 ? pv[i].z : pv[i].w;
#pragma unroll
              for (int t = 0; t < VEC; ++t)
                o[i][e * VEC + t] = fmaf(p, w[t], o[i][e * VEC + t]);
            }
          }
        }
      }
    }
    __syncthreads();  // stage it & 1 and every warp's P are consumed
    if (it + 2 < n) load_kv(it + 2);
    cp_async_commit();
  }

  // out = O / max(l, 1e-20), rows past Sq not written
  float* ob = out + (long long)(b * H + h) * Sq * HD;
#pragma unroll
  for (int i = 0; i < F32_RPT; ++i) {
    float li = l[i];
    li += __shfl_xor_sync(FULL, li, 1);
    li += __shfl_xor_sync(FULL, li, 2);
    li += __shfl_xor_sync(FULL, li, 4);
    li = fmaxf(li, 1e-20f);
    const int r = wrow0 + rg + 4 * i;
    if (r < Sq) {
#pragma unroll
      for (int e = 0; e < NV; ++e)
        st_vec<VEC>(ob + (long long)r * HD + VEC * kg + 8 * VEC * e,
                    &o[i][e * VEC], li);
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 and f16: fa_wgmma<T>, tensor cores fed by TMA (see the note at the top)
// ---------------------------------------------------------------------------
constexpr int WG = 128;           // threads of a warpgroup
constexpr int WG_ROWS = 64;       // query rows of one consumer warpgroup
constexpr int STAGES = 3;         // K/V stages of the ring
constexpr int SMEM_ALIGN = 1024;  // a swizzle pattern's period
constexpr float LOG2E = 1.4426950408889634f;

template <typename T>
constexpr bool IS_F16 = std::is_same<T, __half>::value;

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Wait until the phase of parity `parity` of the barrier has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// One TMA box of a 3-D tensor map (coordinates innermost first) into
// shared memory, completing `bar`'s transaction bytes.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1,
                                         int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"((uint64_t)map), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// A wgmma shared-memory matrix descriptor: start address, leading and
// stride byte offsets (16-byte units) and the swizzle (1 = 128 B, 2 = 64 B,
// 3 = 32 B).
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo, uint32_t swizzle) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | ((uint64_t)swizzle << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from touching registers an in-flight wgmma reads or
// writes: every use stays on its side of the fence.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// Two floats rounded to T, `lo` in the low half; and back.
template <typename T>
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  if constexpr (IS_F16<T>) {
    const __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&v);
  } else {
    const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&v);
  }
}
template <typename T>
__device__ __forceinline__ float2 unpack2(uint32_t x) {
  if constexpr (IS_F16<T>)
    return __half22float2(*reinterpret_cast<const __half2*>(&x));
  else
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&x));
}

// D (64 x N, f32) (+)= A (64 x 16) B (16 x N), A and B K-major in shared
// memory (S = Q K^T: A the q rows, B the key rows), of element type T.
// The instruction strings differ by type only: one macro a shape, TY its
// PTX type.
#define FA_WGMMA_SS64(TY)                                                                                        \
  asm volatile(                                                                                                  \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"                                                               \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " {"                                               \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "                                   \
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "                        \
      "%32, %33, p, 1, 1, 0, 0;\n}\n"                                                                            \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),          \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),    \
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),  \
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])   \
      : "l"(da), "l"(db), "r"(scale_d))

#define FA_WGMMA_SS128(TY)                                                                                       \
  asm volatile(                                                                                                  \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"                                                               \
      "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " {"                                              \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "                                   \
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "                         \
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "                         \
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "                        \
      "%64, %65, p, 1, 1, 0, 0;\n}\n"                                                                            \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),          \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),    \
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),  \
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),  \
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),  \
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),  \
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),  \
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])   \
      : "l"(da), "l"(db), "r"(scale_d))

#define FA_WGMMA_RS16(TY)                                                                               \
  asm volatile(                                                                                         \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"                                                      \
      "wgmma.mma_async.sync.aligned.m64n16k16.f32." TY "." TY " {"                                      \
      "%0, %1, %2, %3, %4, %5, %6, %7}, "                                                               \
      "{%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"                                                       \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])  \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1))

#define FA_WGMMA_RS32(TY)                                                                                     \
  asm volatile(                                                                                               \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"                                                            \
      "wgmma.mma_async.sync.aligned.m64n32k16.f32." TY "." TY " {"                                            \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "                               \
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"                                                           \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),       \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])  \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1))

#define FA_WGMMA_RS64(TY)                                                                                        \
  asm volatile(                                                                                                  \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"                                                               \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " {"                                               \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "                                   \
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "                        \
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"                                                              \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),          \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),    \
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),  \
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])   \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1))

#define FA_WGMMA_RS128(TY)                                                                                       \
  asm volatile(                                                                                                  \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"                                                               \
      "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " {"                                              \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "                                   \
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "                         \
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "                         \
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "                        \
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"                                                              \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),          \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),    \
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),  \
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),  \
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),  \
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),  \
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),  \
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])   \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1))

template <typename T, int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da,
                                         uint64_t db, int scale_d) {
  static_assert(N == 64 || N == 128, "wgmma_ss: N is 64 or 128");
  if constexpr (N == 64) {
    if constexpr (IS_F16<T>) FA_WGMMA_SS64("f16"); else FA_WGMMA_SS64("bf16");
  } else {
    if constexpr (IS_F16<T>) FA_WGMMA_SS128("f16"); else FA_WGMMA_SS128("bf16");
  }
}

// D (64 x N, f32) += A (64 x 16, T registers) B (16 x N), B N-major in
// shared memory (O += P V: B the value rows, transposed descriptor).
template <typename T, int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4], uint64_t db) {
  static_assert(N == 16 || N == 32 || N == 64 || N == 128,
                "wgmma_rs: N is 16, 32, 64 or 128");
  if constexpr (N == 16) {
    if constexpr (IS_F16<T>) FA_WGMMA_RS16("f16"); else FA_WGMMA_RS16("bf16");
  } else if constexpr (N == 32) {
    if constexpr (IS_F16<T>) FA_WGMMA_RS32("f16"); else FA_WGMMA_RS32("bf16");
  } else if constexpr (N == 64) {
    if constexpr (IS_F16<T>) FA_WGMMA_RS64("f16"); else FA_WGMMA_RS64("bf16");
  } else {
    if constexpr (IS_F16<T>) FA_WGMMA_RS128("f16"); else FA_WGMMA_RS128("bf16");
  }
}

template <typename T, int HD, int BK>
__global__ void __launch_bounds__(3 * WG, 1)
fa_wgmma(const __grid_constant__ CUtensorMap tq,
         const __grid_constant__ CUtensorMap tk,
         const __grid_constant__ CUtensorMap tv, T* __restrict__ out,
         int H, int KV, int Sq, int Skv, int causal, int window, float scale2,
         int p_split) {
  constexpr int ROWB = (HD < 64 ? HD : 64) * 2;  // bytes of one box row
  constexpr int NBOX = HD * 2 / ROWB;            // boxes across hd
  constexpr uint32_t SWZ = ROWB == 128 ? 1 : ROWB == 64 ? 2 : 3;
  constexpr uint32_t GROUP = 8 * ROWB;           // 8 rows: one swizzle period
  constexpr int TILE = BK * HD * 2;              // bytes of a K or V tile
  const int nwg = blockDim.x / WG - 1;           // consumer warpgroups
  const int bq = WG_ROWS * nwg;
  const int wg = threadIdx.x / WG;

  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t sq = (raw + SMEM_ALIGN - 1) & ~(uint32_t)(SMEM_ALIGN - 1);
  const uint32_t skv = sq + bq * HD * 2;          // stage s: K, then V
  const uint32_t bars = skv + STAGES * 2 * TILE;  // q, full_k, full_v, empty
  const uint32_t q_full = bars;
  auto full_k = [&](int s) { return bars + 8 * (1 + s); };
  auto full_v = [&](int s) { return bars + 8 * (1 + STAGES + s); };
  auto empty = [&](int s) { return bars + 8 * (1 + 2 * STAGES + s); };

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full_k(s), 1);
      mbar_init(full_v(s), 1);
      mbar_init(empty(s), 4 * nwg);  // lane 0 of every consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  int iq, h, b;
  block_coords(H, iq, h, b);
  const int kvh = h / (H / KV);
  const int q0 = iq * bq;
  // the live KV tiles [lo, hi): those neither causal masking nor the window
  // empties for rows [q0, q0 + bq)
  const int nk = (Skv + BK - 1) / BK;
  const int hi = causal ? min(nk, (q0 + bq - 1) / BK + 1) : nk;
  const int first = q0 - window + 1;  // the first key row q0 may see
  const int lo = window && first > 0 ? first / BK : 0;
  const int n = max(hi - lo, 0);

  if (wg == nwg) {
    // producer: one thread issues every TMA load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == nwg * WG) {
      mbar_expect_tx(q_full, bq * HD * 2);
      for (int x = 0; x < NBOX; ++x)
        tma_load(sq + x * bq * ROWB, &tq, q_full, x * ROWB / 2, q0, b * H + h);
      for (int it = 0; it < n; ++it) {
        const int s = it % STAGES;
        mbar_wait(empty(s), ((it / STAGES) & 1) ^ 1);
        const int k0 = (lo + it) * BK;
        const uint32_t sk = skv + s * 2 * TILE, sv = sk + TILE;
        mbar_expect_tx(full_k(s), TILE);
        for (int x = 0; x < NBOX; ++x)
          tma_load(sk + x * BK * ROWB, &tk, full_k(s), x * ROWB / 2, k0,
                   b * KV + kvh);
        mbar_expect_tx(full_v(s), TILE);
        for (int x = 0; x < NBOX; ++x)
          tma_load(sv + x * BK * ROWB, &tv, full_v(s), x * ROWB / 2, k0,
                   b * KV + kvh);
      }
    }
  } else {
    // consumer warpgroup `wg`: query rows [q0 + 64 wg, q0 + 64 wg + 64)
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int t = threadIdx.x % WG, warp = t / 32, lane = t % 32;
    const int qrow = q0 + WG_ROWS * wg + 16 * warp + lane / 4;  // and +8
    const int col = 2 * (lane % 4);
    const int wrow0 = q0 + WG_ROWS * wg;  // the warpgroup's first row
    float o[HD / 2], m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
    const uint32_t qa = sq + wg * WG_ROWS * ROWB;
    mbar_wait(q_full, 0);

    // S = Q K^T of tile `it` on the tensor cores, f32 (16-bit products are
    // exact), committed as one wgmma group
    float sc[BK / 2];
    auto issue_s = [&](int it) {
      const uint32_t sk = skv + (it % STAGES) * 2 * TILE;
      mbar_wait(full_k(it % STAGES), (it / STAGES) & 1);
      fence_regs(sc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const uint32_t x = kk * 32 / ROWB, off = kk * 32 % ROWB;
        wgmma_ss<T, BK>(sc, gmma_desc(qa + x * bq * ROWB + off, 16, GROUP, SWZ),
                     gmma_desc(sk + x * BK * ROWB + off, 16, GROUP, SWZ),
                     kk > 0);
      }
      wgmma_commit();
    };
    if (n > 0) {
      issue_s(0);
      wgmma_wait<0>();
      fence_regs(sc);
    }

    for (int it = 0; it < n; ++it) {
      const int s = it % STAGES;
      const int k0 = (lo + it) * BK;
      const uint32_t sv = skv + s * 2 * TILE + TILE;

      // online softmax in the log2 domain, on the accumulator layout:
      // sc[4 j + e] is row qrow + 8 (e >> 1), key k0 + 8 j + col + (e & 1)
      const bool edge = k0 + BK > Skv || (causal && k0 + BK - 1 > wrow0) ||
                        (window && wrow0 + WG_ROWS - 1 - k0 >= window);
      float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) {
        float x = sc[i] * scale2;
        if (edge) {
          const int r = qrow + 8 * ((i >> 1) & 1);
          const int c = k0 + 8 * (i >> 2) + col + (i & 1);
          const bool ok = c < Skv && (!causal || c <= r) &&
                          (!window || r - c < window);
          x = ok ? x : NEG_INF;
        }
        sc[i] = x;
        mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], x);
      }
      float corr[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        mx[e] = fmaxf(mx[e], __shfl_xor_sync(FULL, mx[e], 1));
        mx[e] = fmaxf(mx[e], __shfl_xor_sync(FULL, mx[e], 2));
        const float m_new = fmaxf(m[e], mx[e]);
        corr[e] = exp2f(m[e] - m_new);
        m[e] = m_new;
        l[e] *= corr[e];
      }
      // P = exp2(S - m) as T hi + lo pairs in the A-fragment layout
      // (elements 2i and 2i + 1 of the accumulator are one register)
      uint32_t ph[BK / 4], pl[BK / 4];
#pragma unroll
      for (int i = 0; i < BK / 4; ++i) {
        const int e = i & 1;
        const float p0 = exp2f(sc[2 * i] - m[e]);
        const float p1 = exp2f(sc[2 * i + 1] - m[e]);
        l[e] += p0 + p1;
        ph[i] = pack2<T>(p0, p1);
        const float2 hv = unpack2<T>(ph[i]);
        pl[i] = pack2<T>(p0 - hv.x, p1 - hv.y);
      }
#pragma unroll
      for (int i = 0; i < HD / 2; ++i) o[i] *= corr[(i >> 1) & 1];

      // O += P V on the tensor cores: V is (keys, hd), hd contiguous
      mbar_wait(full_v(s), (it / STAGES) & 1);
      fence_regs(o);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        const uint64_t dv = gmma_desc(sv + kk * 2 * GROUP, BK * ROWB, GROUP, SWZ);
        const uint32_t ah[4] = {ph[4 * kk], ph[4 * kk + 1], ph[4 * kk + 2],
                                ph[4 * kk + 3]};
        wgmma_rs<T, HD>(o, ah, dv);
        if (p_split) {
          const uint32_t al[4] = {pl[4 * kk], pl[4 * kk + 1], pl[4 * kk + 2],
                                  pl[4 * kk + 3]};
          wgmma_rs<T, HD>(o, al, dv);
        }
      }
      wgmma_commit();
      // the next tile's S goes to the tensor cores right behind this P V
      // (sc is free once P is formed), so they do not wait for the softmax
      const bool more = it + 1 < n;
      if (more) {
        issue_s(it + 1);
        wgmma_wait<1>();
      } else {
        wgmma_wait<0>();
      }
      fence_regs(o);
      fence_regs(ph);
      fence_regs(pl);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty(s));
      if (more) {
        wgmma_wait<0>();
        fence_regs(sc);
      }
    }

    // out = O / max(l, 1e-20), rows past Sq not written
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      l[e] += __shfl_xor_sync(FULL, l[e], 1);
      l[e] += __shfl_xor_sync(FULL, l[e], 2);
      l[e] = fmaxf(l[e], 1e-20f);
    }
    T* ob = out + (long long)(b * H + h) * Sq * HD;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int r = qrow + 8 * e;
      if (r < Sq) {
#pragma unroll
        for (int j = 0; j < HD / 8; ++j)
          *reinterpret_cast<uint32_t*>(ob + (long long)r * HD + 8 * j + col) =
              pack2<T>(o[4 * j + 2 * e] / l[e], o[4 * j + 2 * e + 1] / l[e]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// host code, once for launching and for planning (launch_plan.cuh)
// ---------------------------------------------------------------------------
template <int HD, class Exec>
int run_f32(Exec& ex, const void* q, const void* k, const void* v, void* out,
            int B, int H, int KV, int Sq, int Skv, int bq, int causal,
            int window, float scale, cudaStream_t st) {
  const size_t smem =
      ((size_t)(bq + 4 * F32_BK) * HD + (size_t)bq * F32_BK) * sizeof(float);
  const dim3 grid((unsigned)((Sq + bq - 1) / bq), (unsigned)H, (unsigned)B);
  const int threads = (bq / F32_WARP_ROWS) * 32;
  return ex("fa_kernel", (const void*)fa_kernel<HD>, grid, threads, smem,
            [&] {
              const cudaError_t e = cudaFuncSetAttribute(
                  fa_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                  (int)smem);
              if (e != cudaSuccess) return e;
              fa_kernel<HD><<<grid, threads, smem, st>>>(
                  (const float*)q, (const float*)k, (const float*)v,
                  (float*)out, H, KV, Sq, Skv, causal, window, scale);
              return cudaSuccess;
            });
}

// cuTensorMapEncodeTiled, a driver-API call, reached through the runtime so
// that the library links against nothing but cudart.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return e == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? (EncodeTiled)p
               : nullptr;
  }();
  return fn;
}

// A (hd, rows, heads) tensor of 16-bit `type` cut into (min(hd, 64),
// box_rows, 1) boxes, rows of a box swizzled across its width; reads past
// `rows` are zeros.
bool encode(CUtensorMap* map, CUtensorMapDataType type, const void* base,
            int hd, int rows, int heads, int box_rows) {
  const EncodeTiled fn = encode_tiled();
  if (!fn) return false;
  const int inner = hd < 64 ? hd : 64;
  const cuuint64_t dims[3] = {(cuuint64_t)hd, (cuuint64_t)rows,
                              (cuuint64_t)heads};
  const cuuint64_t strides[2] = {(cuuint64_t)hd * 2,
                                 (cuuint64_t)rows * hd * 2};
  const cuuint32_t box[3] = {(cuuint32_t)inner, (cuuint32_t)box_rows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUtensorMapSwizzle swizzle =
      inner == 64 ? CU_TENSOR_MAP_SWIZZLE_128B
      : inner == 32 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_32B;
  return fn(map, type, 3, const_cast<void*>(base),
            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename T, int HD, int BK, class Exec>
int run_wgmma(Exec& ex, const void* q, const void* k, const void* v,
              void* out, int B, int H, int KV, int Sq, int Skv, int bq,
              int causal, int window, float scale, int p_split,
              cudaStream_t st) {
  const size_t smem = SMEM_ALIGN + (size_t)bq * HD * 2 +
                      (size_t)STAGES * 2 * BK * HD * 2 + 8 * (1 + 3 * STAGES);
  const dim3 grid((unsigned)((Sq + bq - 1) / bq), (unsigned)H, (unsigned)B);
  const int threads = (bq / WG_ROWS + 1) * WG;
  const CUtensorMapDataType type = IS_F16<T>
                                       ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                                       : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  return ex("fa_wgmma", (const void*)fa_wgmma<T, HD, BK>, grid, threads, smem,
            [&] {
              CUtensorMap tq, tk, tv;
              if (!encode(&tq, type, q, HD, Sq, B * H, bq) ||
                  !encode(&tk, type, k, HD, Skv, B * KV, BK) ||
                  !encode(&tv, type, v, HD, Skv, B * KV, BK))
                return cudaErrorInvalidValue;
              const cudaError_t e = cudaFuncSetAttribute(
                  fa_wgmma<T, HD, BK>,
                  cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
              if (e != cudaSuccess) return e;
              fa_wgmma<T, HD, BK><<<grid, threads, smem, st>>>(
                  tq, tk, tv, (T*)out, H, KV, Sq, Skv, causal, window,
                  scale * LOG2E, p_split);
              return cudaSuccess;
            });
}

template <typename T, int HD, class Exec>
int run_16(Exec& ex, const void* q, const void* k, const void* v, void* out,
           int B, int H, int KV, int Sq, int Skv, int bq, int bk, int causal,
           int window, float scale, int p_split, cudaStream_t st) {
  if (bk == 64)
    return run_wgmma<T, HD, 64>(ex, q, k, v, out, B, H, KV, Sq, Skv, bq,
                                causal, window, scale, p_split, st);
  return run_wgmma<T, HD, 128>(ex, q, k, v, out, B, H, KV, Sq, Skv, bq,
                               causal, window, scale, p_split, st);
}

template <typename T, class Exec>
int run_hd16(Exec& ex, const void* q, const void* k, const void* v, void* out,
             int B, int H, int KV, int Sq, int Skv, int hd, int bq, int bk,
             int causal, int window, float scale, int p_split,
             cudaStream_t st) {
  if ((bq != 64 && bq != 128) || (bk != 64 && bk != 128))
    return (int)cudaErrorInvalidValue;
  switch (hd) {
    case 16: return run_16<T, 16>(ex, q, k, v, out, B, H, KV, Sq, Skv, bq, bk,
                                  causal, window, scale, p_split, st);
    case 32: return run_16<T, 32>(ex, q, k, v, out, B, H, KV, Sq, Skv, bq, bk,
                                  causal, window, scale, p_split, st);
    case 64: return run_16<T, 64>(ex, q, k, v, out, B, H, KV, Sq, Skv, bq, bk,
                                  causal, window, scale, p_split, st);
    case 128: return run_16<T, 128>(ex, q, k, v, out, B, H, KV, Sq, Skv, bq,
                                    bk, causal, window, scale, p_split, st);
  }
  return (int)cudaErrorInvalidValue;
}

template <class Exec>
int run(Exec& ex, const void* q, const void* k, const void* v, void* out,
        int B, int H, int KV, int Sq, int Skv, int hd, int bq, int bk,
        int causal, int window, int dtype, float scale, int p_split,
        cudaStream_t st) {
  if (H % KV || dtype < DT_F32 || dtype > DT_F16)
    return (int)cudaErrorInvalidValue;
  if (dtype == DT_BF16)
    return run_hd16<__nv_bfloat16>(ex, q, k, v, out, B, H, KV, Sq, Skv, hd,
                                   bq, bk, causal, window, scale, p_split, st);
  if (dtype == DT_F16)
    return run_hd16<__half>(ex, q, k, v, out, B, H, KV, Sq, Skv, hd, bq, bk,
                            causal, window, scale, p_split, st);
  if (bq % F32_WARP_ROWS || bq > 128 || bq < F32_WARP_ROWS || bk != F32_BK)
    return (int)cudaErrorInvalidValue;
  switch (hd) {
    case 16: return run_f32<16>(ex, q, k, v, out, B, H, KV, Sq, Skv, bq,
                                causal, window, scale, st);
    case 32: return run_f32<32>(ex, q, k, v, out, B, H, KV, Sq, Skv, bq,
                                causal, window, scale, st);
    case 64: return run_f32<64>(ex, q, k, v, out, B, H, KV, Sq, Skv, bq,
                                causal, window, scale, st);
    case 128: return run_f32<128>(ex, q, k, v, out, B, H, KV, Sq, Skv, bq,
                                  causal, window, scale, st);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" const char* repro_flash_attention_error(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// dtype: DT_F32, DT_BF16 or DT_F16.  Tile sides: float32 bq a multiple of
// 16 up to 128 and bk 64; bfloat16 and float16 bq and bk 64 or 128.  hd in
// {16, 32, 64, 128}; q, k, v 16-byte aligned (cp.async and TMA).  `p_split`
// 0 rounds P once to the 16-bit type before P V (a measurement of what the
// hi + lo split buys).
// Launches on `stream`, does not synchronise, returns a CUDA error code (0
// on success).
extern "C" int repro_flash_attention(const void* q, const void* k,
                                     const void* v, void* out, int B, int H,
                                     int KV, int Sq, int Skv, int hd, int bq,
                                     int bk, int causal, int window,
                                     int dtype, float scale, int p_split,
                                     void* stream) {
  Launcher ex;
  return run(ex, q, k, v, out, B, H, KV, Sq, Skv, hd, bq, bk, causal, window,
             dtype, scale, p_split, (cudaStream_t)stream);
}

// The dry run of repro_flash_attention: fills out[0..max) with the launches
// it would make, launches nothing; returns their count or minus a CUDA error.
extern "C" int repro_flash_attention_plan(int B, int H, int KV, int Sq,
                                          int Skv, int hd, int bq, int bk,
                                          int causal, int window, int dtype,
                                          ReproLaunch* out, int max) {
  Planner ex{out, max, 0};
  const int err = run(ex, nullptr, nullptr, nullptr, nullptr, B, H, KV, Sq, Skv,
                      hd, bq, bk, causal, window, dtype, 1.f, 1,
                      (cudaStream_t)0);
  return plan_result(err, ex);
}
