// flash_attention: blocked online-softmax attention, one block per
// (q tile, head, batch), a loop over the KV tiles inside the block.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py::flash_attention.
// q: (B, H, Sq, HD), k and v: (B, KV, Skv, HD), out: (B, H, Sq, HD), all
// contiguous, f32 or bf16.  Head h reads KV head h / (H / KV).
//
// The TPU kernel walks the KV tiles as the last, sequential grid axis and
// keeps m, l and acc in VMEM scratch between grid steps.  Blocks run in
// parallel and in no order here, so the KV walk is a loop inside the block,
// and m, l and acc live in registers for the whole walk.
//
// Layout of a block: bq / 16 warps (bq a multiple of 16, at most 128); warp
// w owns query rows [16 w, 16 w + 16) of the tile.  Shared memory holds the
// q tile and one K and one V tile as f32, rows padded by one word against
// bank conflicts: (bq + 2 bk) (HD + 1) 4 bytes -- 198,144 B at bq = bk = 128,
// HD = 128, above the 48 KB default, so the launch raises the limit with
// cudaFuncSetAttribute.  Per KV tile a warp takes its rows four at a time:
// lane t scores keys t, t + 32, ... of the tile (bk a multiple of 32, at most
// 128), the row max and sum are warp shuffles, and for P V each key's p is
// broadcast by shuffle while lane t accumulates output dims t, t + 32, ...
//
// Semantics kept from the TPU kernel: scores are f32 products of f32-cast
// inputs, times `scale` after the product; masked scores (causal, window,
// past Sq or Skv) are the finite -1e30, so a row whose first live tile is all
// masked takes p = exp(0) = 1 there and its first real score wipes that with
// corr = exp(-1e30 - m) = 0; a tile is skipped when causal masking or the
// window empties it; l is clamped at 1e-20; the output is cast to q's dtype.
// The sums run in another order than the TPU kernel's, so results agree
// within rounding, not bit for bit.
//
// Bound on an H100 SXM: the live tiles' 4 bq bk HD flops over the tensor
// cores' peak for the input type (989 TFLOP/s bf16; the f32 products of
// the reference are counted at the 67 TFLOP/s of the fp32 pipe), or the
// bytes of q, k, v and out over 3.35 TB/s, whichever is larger.  This kernel
// runs on the fp32 pipe from shared memory, without tensor cores
// (wgmma and TMA are later work), so it stays far from the bf16 bound.
#include <cuda_bf16.h>
//
// Launch plan: the host code is one template over the executors of
// launch_plan.cuh, so `repro_flash_attention_plan` is a dry run of exactly the
// launches `repro_flash_attention` makes (held equal to the Python
// `repro_torch.kernels.flash_attention.plan` on the card).
#include <cuda_runtime.h>

#include "launch_plan.cuh"

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int ROWS_PER_WARP = 16;
constexpr int ROWS_PER_STEP = 4;
constexpr int MAX_SLOTS = 4;  // bk <= 128 = MAX_SLOTS * 32
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(FULL, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(FULL, x, o);
  return x;
}

template <typename T, int HD>
__global__ void __launch_bounds__(256)
fa_kernel(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, T* __restrict__ out, int H, int KV, int Sq,
          int Skv, int bq, int bk, int causal, int window, float scale) {
  constexpr int LD = HD + 1;
  constexpr int DPL = (HD + 31) / 32;  // output dims per lane
  extern __shared__ float smem[];
  float* sq = smem;
  float* sk = sq + bq * LD;
  float* sv = sk + bk * LD;

  const int iq = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int lane = tid & 31;
  const int row0 = (tid >> 5) * ROWS_PER_WARP;
  const int q0 = iq * bq;
  const int nslots = bk / 32;
  const T* qb = q + (long long)(b * H + h) * Sq * HD;
  const T* kb = k + (long long)(b * KV + kvh) * Skv * HD;
  const T* vb = v + (long long)(b * KV + kvh) * Skv * HD;

  for (int i = tid; i < bq * HD; i += nthr) {
    const int r = i / HD, d = i % HD;
    sq[r * LD + d] =
        q0 + r < Sq ? to_f(qb[(long long)(q0 + r) * HD + d]) : 0.f;
  }

  float m[ROWS_PER_WARP], l[ROWS_PER_WARP], acc[ROWS_PER_WARP][DPL];
#pragma unroll
  for (int r = 0; r < ROWS_PER_WARP; ++r) {
    m[r] = NEG_INF;
    l[r] = 0.f;
#pragma unroll
    for (int e = 0; e < DPL; ++e) acc[r][e] = 0.f;
  }

  const int nk = (Skv + bk - 1) / bk;
  for (int ik = 0; ik < nk; ++ik) {
    const int k0 = ik * bk;
    if (causal && k0 > q0 + bq - 1) break;             // this and later: dead
    if (window && k0 + bk - 1 <= q0 - window) continue;  // left of the window
    __syncthreads();  // the previous tile is consumed (and sq is written)
    for (int i = tid; i < bk * HD; i += nthr) {
      const int r = i / HD, d = i % HD;
      const bool in = k0 + r < Skv;
      const long long g = (long long)(k0 + r) * HD + d;
      sk[r * LD + d] = in ? to_f(kb[g]) : 0.f;
      sv[r * LD + d] = in ? to_f(vb[g]) : 0.f;
    }
    __syncthreads();

#pragma unroll
    for (int grp = 0; grp < ROWS_PER_WARP / ROWS_PER_STEP; ++grp) {
      float s[ROWS_PER_STEP][MAX_SLOTS];
#pragma unroll
      for (int r = 0; r < ROWS_PER_STEP; ++r)
#pragma unroll
        for (int c = 0; c < MAX_SLOTS; ++c) s[r][c] = 0.f;
      const float* qrow = sq + (row0 + grp * ROWS_PER_STEP) * LD;
#pragma unroll 4
      for (int d = 0; d < HD; ++d) {
        float qd[ROWS_PER_STEP];
#pragma unroll
        for (int r = 0; r < ROWS_PER_STEP; ++r) qd[r] = qrow[r * LD + d];
#pragma unroll
        for (int c = 0; c < MAX_SLOTS; ++c) {
          if (c < nslots) {
            const float kd = sk[(c * 32 + lane) * LD + d];
#pragma unroll
            for (int r = 0; r < ROWS_PER_STEP; ++r)
              s[r][c] = fmaf(qd[r], kd, s[r][c]);
          }
        }
      }
#pragma unroll
      for (int r = 0; r < ROWS_PER_STEP; ++r) {
        const int ri = grp * ROWS_PER_STEP + r;
        const int qpos = q0 + row0 + ri;
        float mx = NEG_INF;
#pragma unroll
        for (int c = 0; c < MAX_SLOTS; ++c) {
          if (c < nslots) {
            const int kpos = k0 + c * 32 + lane;
            const bool ok = qpos < Sq && kpos < Skv &&
                            (!causal || kpos <= qpos) &&
                            (!window || qpos - kpos < window);
            s[r][c] = ok ? s[r][c] * scale : NEG_INF;
            mx = fmaxf(mx, s[r][c]);
          }
        }
        const float m_new = fmaxf(m[ri], warp_max(mx));
        const float corr = expf(m[ri] - m_new);
        float ps = 0.f;
#pragma unroll
        for (int c = 0; c < MAX_SLOTS; ++c) {
          if (c < nslots) {
            s[r][c] = expf(s[r][c] - m_new);
            ps += s[r][c];
          }
        }
        l[ri] = l[ri] * corr + warp_sum(ps);
        m[ri] = m_new;
#pragma unroll
        for (int e = 0; e < DPL; ++e) acc[ri][e] *= corr;
      }
#pragma unroll
      for (int c = 0; c < MAX_SLOTS; ++c) {
        if (c < nslots) {
          for (int src = 0; src < 32; ++src) {
            float pj[ROWS_PER_STEP];
#pragma unroll
            for (int r = 0; r < ROWS_PER_STEP; ++r)
              pj[r] = __shfl_sync(FULL, s[r][c], src);
            const float* vrow = sv + (c * 32 + src) * LD;
#pragma unroll
            for (int e = 0; e < DPL; ++e) {
              const int d = lane + 32 * e;
              if (d < HD) {
                const float vd = vrow[d];
#pragma unroll
                for (int r = 0; r < ROWS_PER_STEP; ++r)
                  acc[grp * ROWS_PER_STEP + r][e] =
                      fmaf(pj[r], vd, acc[grp * ROWS_PER_STEP + r][e]);
              }
            }
          }
        }
      }
    }
  }

  T* ob = out + (long long)(b * H + h) * Sq * HD;
#pragma unroll
  for (int r = 0; r < ROWS_PER_WARP; ++r) {
    const int qpos = q0 + row0 + r;
    if (qpos < Sq) {
      const float lc = fmaxf(l[r], 1e-20f);
#pragma unroll
      for (int e = 0; e < DPL; ++e) {
        const int d = lane + 32 * e;
        if (d < HD) store(&ob[(long long)qpos * HD + d], acc[r][e] / lc);
      }
    }
  }
}

// The host code, once for launching and for planning (launch_plan.cuh).
template <typename T, int HD, class Exec>
int run_typed(Exec& ex, const void* q, const void* k, const void* v, void* out,
              int B, int H, int KV, int Sq, int Skv, int bq, int bk, int causal,
              int window, float scale, cudaStream_t st) {
  const size_t smem = (size_t)(bq + 2 * bk) * (HD + 1) * sizeof(float);
  const dim3 grid((unsigned)((Sq + bq - 1) / bq), (unsigned)H, (unsigned)B);
  const int threads = (bq / ROWS_PER_WARP) * 32;
  return ex("fa_kernel", (const void*)fa_kernel<T, HD>, grid, threads, smem,
            [&] {
              const cudaError_t e = cudaFuncSetAttribute(
                  fa_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                  (int)smem);
              if (e != cudaSuccess) return e;
              fa_kernel<T, HD><<<grid, threads, smem, st>>>(
                  (const T*)q, (const T*)k, (const T*)v, (T*)out, H, KV, Sq,
                  Skv, bq, bk, causal, window, scale);
              return cudaSuccess;
            });
}

template <typename T, class Exec>
int dispatch(Exec& ex, const void* q, const void* k, const void* v, void* out,
             int B, int H, int KV, int Sq, int Skv, int hd, int bq, int bk,
             int causal, int window, float scale, cudaStream_t st) {
  switch (hd) {
    case 16: return run_typed<T, 16>(ex, q, k, v, out, B, H, KV, Sq, Skv, bq,
                                     bk, causal, window, scale, st);
    case 32: return run_typed<T, 32>(ex, q, k, v, out, B, H, KV, Sq, Skv, bq,
                                     bk, causal, window, scale, st);
    case 64: return run_typed<T, 64>(ex, q, k, v, out, B, H, KV, Sq, Skv, bq,
                                     bk, causal, window, scale, st);
    case 128: return run_typed<T, 128>(ex, q, k, v, out, B, H, KV, Sq, Skv, bq,
                                       bk, causal, window, scale, st);
  }
  return (int)cudaErrorInvalidValue;
}

template <class Exec>
int run(Exec& ex, const void* q, const void* k, const void* v, void* out,
        int B, int H, int KV, int Sq, int Skv, int hd, int bq, int bk,
        int causal, int window, int is_bf16, float scale, cudaStream_t st) {
  if (bq % ROWS_PER_WARP || bq > 128 || bq < 16 || bk % 32 || bk > 128 ||
      bk < 32 || H % KV)
    return (int)cudaErrorInvalidValue;
  if (is_bf16)
    return dispatch<__nv_bfloat16>(ex, q, k, v, out, B, H, KV, Sq, Skv, hd, bq,
                                   bk, causal, window, scale, st);
  return dispatch<float>(ex, q, k, v, out, B, H, KV, Sq, Skv, hd, bq, bk,
                         causal, window, scale, st);
}

}  // namespace

extern "C" const char* repro_flash_attention_error(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// Tile sides: bq a multiple of 16 and bk a multiple of 32, both <= 128;
// hd in {16, 32, 64, 128}.  Launches on `stream`, does not synchronise,
// returns a CUDA error code (0 on success).
extern "C" int repro_flash_attention(const void* q, const void* k,
                                     const void* v, void* out, int B, int H,
                                     int KV, int Sq, int Skv, int hd, int bq,
                                     int bk, int causal, int window,
                                     int is_bf16, float scale, void* stream) {
  Launcher ex;
  return run(ex, q, k, v, out, B, H, KV, Sq, Skv, hd, bq, bk, causal, window,
             is_bf16, scale, (cudaStream_t)stream);
}

// The dry run of repro_flash_attention: fills out[0..max) with the launches
// it would make, launches nothing; returns their count or minus a CUDA error.
extern "C" int repro_flash_attention_plan(int B, int H, int KV, int Sq,
                                          int Skv, int hd, int bq, int bk,
                                          int causal, int window, int is_bf16,
                                          ReproLaunch* out, int max) {
  Planner ex{out, max, 0};
  const int err = run(ex, nullptr, nullptr, nullptr, nullptr, B, H, KV, Sq, Skv,
                      hd, bq, bk, causal, window, is_bf16, 1.f,
                      (cudaStream_t)0);
  return plan_result(err, ex);
}
