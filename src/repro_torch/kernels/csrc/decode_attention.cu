// Flash-decode for Hopper (sm_90a), in CUDA C++: one new query token per
// head against a long KV cache.
//
// Replaces the TPU kernel `_decode_kernel` / `decode_attention_kernel` of
// src/repro/kernels/decode_attention.py (Pallas, grid (B*H, S/bk), online
// softmax in VMEM, kv_len as a scalar-prefetch operand, blocks past it
// skipped).
//
// What bounds it on the H100: bytes.  Each step reads kv_len rows of K and
// V (B=4, KV=2, D=128, bf16: 1 KB per position) and does ~2 FLOP per byte,
// far below the ~295 FLOP/byte at which Hopper's tensor cores would become
// the limit; so the kernel must read each cache row once and keep the card
// busy while it does.
//
// Design:
//   * the cache is read in place, [B, S, KV, D] through its strides (the
//     per-layer slice of the stacked cache): no transpose copy of the whole
//     cache per layer per step, which the JAX wrapper pays;
//   * one block handles the G = H / KV query heads of one KV head together,
//     so each K/V row is read from device memory once per group (G = 16 at
//     chatglm3-6b width);
//   * (batch, KV head) alone gives too few blocks for 132 SMs (4 x 2 = 8 at
//     the serving shape), so the cache length is split across blocks
//     (pass 1: partial m, l, acc per split, online softmax over 32-row
//     tiles staged in shared memory), and a second small pass merges the
//     partials per head;
//   * only the first kv_len rows are read: splits cover [0, kv_len);
//   * K and V arrive as f32, bf16 or fp8 e4m3 and are upcast to f32; all
//     arithmetic is f32 (the TPU kernel casts p to V's upcast f32), masked
//     slots use NEG_INF = -1e30, l is clamped at 1e-30 and the output is in
//     q's dtype.
//
// The launcher has a plain C interface (loaded with ctypes) and returns
// the cudaError_t of the launches.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int TK = 32;    // cache rows per tile (one per lane in the softmax)
constexpr int NT = 256;   // threads per block in pass 1

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f(__nv_fp8_e4m3 x) { return static_cast<float>(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// Pass 1.  grid (n_split, KV, B).  Split s covers cache rows
// [s * split_len, min((s + 1) * split_len, kv_len)).  Writes, per
// (b, kv head, split, g): acc[D] (unnormalised), m and l.
template <typename QT, typename KT>
__global__ void __launch_bounds__(NT) decode_split_kernel(
    const QT* __restrict__ q, const KT* __restrict__ k, const KT* __restrict__ v,
    float* __restrict__ part_acc, float* __restrict__ part_ml,
    int H, int KV, int D, int kv_len, int split_len, int n_split,
    int64_t q_sb, int64_t q_sh,
    int64_t k_sb, int64_t k_ss, int64_t k_sh,
    int64_t v_sb, int64_t v_ss, int64_t v_sh, float scale) {
  const int split = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int G = H / KV;
  const int DP = D + 1;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int nwarps = NT / 32;

  extern __shared__ float smem[];
  float* qs = smem;              // [G][D]
  float* ks = qs + G * D;        // [TK][DP]
  float* vs = ks + TK * DP;      // [TK][D]
  float* ps = vs + TK * D;       // [G][TK]
  float* acc = ps + G * TK;      // [G][D]
  float* ms = acc + G * D;       // [G]
  float* ls = ms + G;            // [G]
  float* cs = ls + G;            // [G] this tile's rescale factor

  const int s0 = split * split_len;
  const int s1 = min(s0 + split_len, kv_len);

  for (int idx = tid; idx < G * D; idx += NT) {
    const int g = idx / D, d = idx % D;
    qs[idx] = to_f(q[b * q_sb + (int64_t)(kvh * G + g) * q_sh + d]);
    acc[idx] = 0.f;
  }
  for (int g = tid; g < G; g += NT) {
    ms[g] = NEG_INF;
    ls[g] = 0.f;
  }
  const KT* kb = k + b * k_sb + kvh * k_sh;
  const KT* vb = v + b * v_sb + kvh * v_sh;

  for (int t0 = s0; t0 < s1; t0 += TK) {
    const int nt = min(TK, s1 - t0);
    __syncthreads();  // previous tile consumed (and q / state initialised)
    for (int idx = tid; idx < nt * D; idx += NT) {
      const int r = idx / D, d = idx % D;
      ks[r * DP + d] = to_f(kb[(int64_t)(t0 + r) * k_ss + d]);
      vs[r * D + d] = to_f(vb[(int64_t)(t0 + r) * v_ss + d]);
    }
    __syncthreads();
    // scores: one (g, t) dot product per thread and step
    for (int idx = tid; idx < G * TK; idx += NT) {
      const int g = idx / TK, t = idx % TK;
      float s = -CUDART_INF_F;  // rows past the tile: p = 0
      if (t < nt) {
        const float* qr = qs + g * D;
        const float* kr = ks + t * DP;
        float a = 0.f;
        for (int d = 0; d < D; ++d) a = fmaf(qr[d], kr[d], a);
        s = a * scale;
      }
      ps[idx] = s;
    }
    __syncthreads();
    // online softmax: one warp per head, one lane per cache row
    for (int g = warp; g < G; g += nwarps) {
      const float s = ps[g * TK + lane];
      float mx = s;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_prev = ms[g];
      const float m_new = fmaxf(m_prev, mx);
      const float p = expf(s - m_new);  // 0 for rows past the tile
      float sum = p;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      ps[g * TK + lane] = p;
      __syncwarp();
      if (lane == 0) {
        const float corr = expf(m_prev - m_new);
        cs[g] = corr;
        ls[g] = ls[g] * corr + sum;
        ms[g] = m_new;
      }
    }
    __syncthreads();
    for (int idx = tid; idx < G * D; idx += NT) {
      const int g = idx / D, d = idx % D;
      const float* pr = ps + g * TK;
      float a = acc[idx] * cs[g];
      for (int t = 0; t < nt; ++t) a = fmaf(pr[t], vs[t * D + d], a);
      acc[idx] = a;
    }
  }
  __syncthreads();
  const int64_t base = ((int64_t)(b * KV + kvh) * n_split + split) * G;
  for (int idx = tid; idx < G * D; idx += NT) part_acc[base * D + idx] = acc[idx];
  for (int g = tid; g < G; g += NT) {
    part_ml[(base + g) * 2] = ms[g];
    part_ml[(base + g) * 2 + 1] = ls[g];
  }
}

// Pass 2.  grid (H, B), D threads: merge the splits of one head.
template <typename QT>
__global__ void decode_merge_kernel(
    const float* __restrict__ part_acc, const float* __restrict__ part_ml,
    QT* __restrict__ o, int H, int KV, int D, int n_split) {
  const int h = blockIdx.x, b = blockIdx.y, d = threadIdx.x;
  const int G = H / KV, kvh = h / G, g = h % G;
  const int64_t row0 = ((int64_t)(b * KV + kvh) * n_split) * G + g;  // split 0
  float m = NEG_INF;
  for (int s = 0; s < n_split; ++s) m = fmaxf(m, part_ml[(row0 + (int64_t)s * G) * 2]);
  float l = 0.f, a = 0.f;
  for (int s = 0; s < n_split; ++s) {
    const int64_t row = row0 + (int64_t)s * G;
    const float w = expf(part_ml[row * 2] - m);
    l = fmaf(part_ml[row * 2 + 1], w, l);
    a = fmaf(part_acc[row * D + d], w, a);
  }
  o[((int64_t)b * H + h) * D + d] = from_f<QT>(a / fmaxf(l, 1e-30f));
}

template <typename QT, typename KT>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   void* part_acc, void* part_ml,
                   int B, int H, int KV, int D, int kv_len, int split_len, int n_split,
                   int64_t q_sb, int64_t q_sh,
                   int64_t k_sb, int64_t k_ss, int64_t k_sh,
                   int64_t v_sb, int64_t v_ss, int64_t v_sh,
                   float scale, cudaStream_t stream) {
  const int G = H / KV;
  const size_t smem =
      sizeof(float) * ((size_t)G * D + TK * (D + 1) + TK * D + G * TK + G * D + 3 * G);
  cudaError_t err = cudaFuncSetAttribute(
      decode_split_kernel<QT, KT>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  decode_split_kernel<QT, KT><<<dim3(n_split, KV, B), NT, smem, stream>>>(
      (const QT*)q, (const KT*)k, (const KT*)v, (float*)part_acc, (float*)part_ml,
      H, KV, D, kv_len, split_len, n_split,
      q_sb, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  decode_merge_kernel<QT><<<dim3(H, B), D, 0, stream>>>(
      (const float*)part_acc, (const float*)part_ml, (QT*)o, H, KV, D, n_split);
  return cudaGetLastError();
}

}  // namespace

// q_dtype: 0 = float32, 1 = bfloat16; kv_dtype: 0 = float32, 1 = bfloat16,
// 2 = float8_e4m3fn.  o is a contiguous [B, H, D] in q's dtype; part_acc is
// f32 [B, KV, n_split, G, D] and part_ml f32 [B, KV, n_split, G, 2] scratch.
// Strides are in elements; the last dim of q, k and v is contiguous.
extern "C" int decode_attention_fwd(
    int q_dtype, int kv_dtype, const void* q, const void* k, const void* v, void* o,
    void* part_acc, void* part_ml,
    int B, int H, int KV, int D, int kv_len, int split_len, int n_split,
    int64_t q_sb, int64_t q_sh,
    int64_t k_sb, int64_t k_ss, int64_t k_sh,
    int64_t v_sb, int64_t v_ss, int64_t v_sh,
    float scale, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
#define DA_ARGS q, k, v, o, part_acc, part_ml, B, H, KV, D, kv_len, split_len, n_split, \
                q_sb, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, scale, st
  if (q_dtype == 0 && kv_dtype == 0) return (int)launch<float, float>(DA_ARGS);
  if (q_dtype == 0 && kv_dtype == 1) return (int)launch<float, __nv_bfloat16>(DA_ARGS);
  if (q_dtype == 0 && kv_dtype == 2) return (int)launch<float, __nv_fp8_e4m3>(DA_ARGS);
  if (q_dtype == 1 && kv_dtype == 0) return (int)launch<__nv_bfloat16, float>(DA_ARGS);
  if (q_dtype == 1 && kv_dtype == 1) return (int)launch<__nv_bfloat16, __nv_bfloat16>(DA_ARGS);
  if (q_dtype == 1 && kv_dtype == 2) return (int)launch<__nv_bfloat16, __nv_fp8_e4m3>(DA_ARGS);
#undef DA_ARGS
  return (int)cudaErrorInvalidValue;
}
