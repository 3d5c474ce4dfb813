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
// busy while it does.  At the serving lengths (~0.5 k rows, ~1 MB) the
// bytes take well under a microsecond, so what is left is latency: the
// launch, one round trip to memory, and merging the splits.
//
// Two variants, chosen by the caller from the dtypes and the head dim:
//
//   * tensor cores (below): a bf16 query over a bf16 or fp8 e4m3 cache, D
//     64 or 128, one launch;
//   * CUDA cores: everything else (f32 query or cache, other head dims),
//     held to 1e-5 against the plain version in f32.
//
// Common to both:
//   * the cache is read in place, [B, S, KV, D] through its strides (the
//     per-layer slice of the stacked cache): no transpose copy of the whole
//     cache per layer per step, which the JAX wrapper pays;
//   * one block handles the G = H / KV query heads of one KV head together,
//     so each K/V row is read from device memory once per group (G = 16 at
//     chatglm3-6b width);
//   * (batch, KV head) alone gives too few blocks for 132 SMs (4 x 2 = 8 at
//     the serving shape), so the cache length is split across blocks and
//     the splits' (m, l, acc) are merged per head;
//   * kv_len is read from device memory (one int32, the TPU kernel's
//     scalar-prefetch operand; or one per batch row, kv_len[b * kv_stride],
//     as a continuous batcher's slots sit at their own positions), so one
//     launch, and one captured CUDA graph, serves every position and every
//     mix of lengths.  The splits are planned from the cache's capacity S,
//     so the grid is the same for every kv_len, as the Pallas grid over
//     S / bk is; a split that starts at or past its row's kv_len is empty
//     and its block returns at once, and only the row's live splits,
//     ceil(kv_len / split_len) of them (at least one), are merged.  Only
//     the first kv_len rows of each batch row are read.  kv_len is clamped
//     to [0, S] (the host cannot check a device value); 0 gives zeros, as
//     in the TPU kernel;
//   * p is kept in f32 (the TPU kernel casts p to V's upcast f32), masked
//     slots use NEG_INF = -1e30, l is clamped at 1e-30 and the output is in
//     q's dtype;
//   * on request (a non-null lse pointer) each head's f32 log-sum-exp of
//     its scaled scores over the live keys, m + log(l), goes to lse [B, H]:
//     what a caller needs to merge the outputs of several caches that split
//     one sequence (sharded serving merges the ranks' partials).  A row with
//     no live key gets NEG_INF, so its merge weight exp(NEG_INF - lse) is 0.
//     The output's arithmetic is the same with and without it.
//
// CUDA cores: pass 1 upcasts K and V to f32 in 32-row tiles staged in
// shared memory and writes each split's partial (m, l, acc); a second small
// pass merges the partials per head.
//
// The launchers have a plain C interface (loaded with ctypes) and return
// the cudaError_t of the launches.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_fp16.h>
#include <math_constants.h>
#include <stdint.h>

#include "hopper.cuh"
#include "mma_bf16.cuh"

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

// the live length of batch row b: kv_len_p[b * kv_stride] clamped to [0, S]
// (kv_stride 0: one length for every row)
__device__ __forceinline__ int live_len(const int* kv_len_p, int b, int kv_stride, int S) {
  return min(max(__ldg(kv_len_p + (int64_t)b * kv_stride), 0), S);
}

// a head's log-sum-exp from its (max, sum of exp(s - max)); NEG_INF where no
// key was live (l = 0)
__device__ __forceinline__ float row_lse(float m, float l) {
  return l > 0.f ? m + logf(l) : NEG_INF;
}

// the splits that hold keys (split 0 always counts, so kv_len 0 writes zeros)
__device__ __forceinline__ int live_splits(int kv_len, int split_len) {
  return max(1, (kv_len + split_len - 1) / split_len);
}

// Pass 1.  grid (n_split, KV, B).  Split s covers cache rows
// [s * split_len, min((s + 1) * split_len, kv_len)); a block past the live
// splits returns at once.  Writes, per (b, kv head, split, g): acc[D]
// (unnormalised), m and l.
template <typename QT, typename KT>
__global__ void __launch_bounds__(NT) decode_split_kernel(
    const QT* __restrict__ q, const KT* __restrict__ k, const KT* __restrict__ v,
    float* __restrict__ part_acc, float* __restrict__ part_ml, const int* __restrict__ kv_len_p,
    int kv_stride, int H, int KV, int D, int S, int split_len, int n_split,
    int64_t q_sb, int64_t q_sh,
    int64_t k_sb, int64_t k_ss, int64_t k_sh,
    int64_t v_sb, int64_t v_ss, int64_t v_sh, float scale) {
  const int split = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int kv_len = live_len(kv_len_p, b, kv_stride, S);
  if (split >= live_splits(kv_len, split_len)) return;
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

// Pass 2.  grid (H, B), D threads: merge the live splits of one head (and
// write its log-sum-exp where lse is not null).
template <typename QT>
__global__ void decode_merge_kernel(
    const float* __restrict__ part_acc, const float* __restrict__ part_ml,
    const int* __restrict__ kv_len_p, int kv_stride, QT* __restrict__ o,
    float* __restrict__ lse, int H, int KV, int D, int S, int split_len, int n_split) {
  const int h = blockIdx.x, b = blockIdx.y, d = threadIdx.x;
  const int G = H / KV, kvh = h / G, g = h % G;
  const int n_live = live_splits(live_len(kv_len_p, b, kv_stride, S), split_len);
  const int64_t row0 = ((int64_t)(b * KV + kvh) * n_split) * G + g;  // split 0
  float m = NEG_INF;
  for (int s = 0; s < n_live; ++s) m = fmaxf(m, part_ml[(row0 + (int64_t)s * G) * 2]);
  float l = 0.f, a = 0.f;
  for (int s = 0; s < n_live; ++s) {
    const int64_t row = row0 + (int64_t)s * G;
    const float w = expf(part_ml[row * 2] - m);
    l = fmaf(part_ml[row * 2 + 1], w, l);
    a = fmaf(part_acc[row * D + d], w, a);
  }
  o[((int64_t)b * H + h) * D + d] = from_f<QT>(a / fmaxf(l, 1e-30f));
  if (lse != nullptr && d == 0) lse[(int64_t)b * H + h] = row_lse(m, l);
}

template <typename QT, typename KT>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, float* lse,
                   void* part_acc, void* part_ml, const int* kv_len, int kv_stride,
                   int B, int H, int KV, int D, int S, int split_len, int n_split,
                   int64_t q_sb, int64_t q_sh,
                   int64_t k_sb, int64_t k_ss, int64_t k_sh,
                   int64_t v_sb, int64_t v_ss, int64_t v_sh,
                   float scale, cudaStream_t stream) {
  const int G = H / KV;
  const size_t smem =
      sizeof(float) * ((size_t)G * D + TK * (D + 1) + TK * D + G * TK + G * D + 3 * G);
  static int cap[64];
  cudaError_t err = hopper::smem_cap((const void*)decode_split_kernel<QT, KT>, (int)smem, cap);
  if (err != cudaSuccess) return err;
  decode_split_kernel<QT, KT><<<dim3(n_split, KV, B), NT, smem, stream>>>(
      (const QT*)q, (const KT*)k, (const KT*)v, (float*)part_acc, (float*)part_ml, kv_len,
      kv_stride, H, KV, D, S, split_len, n_split,
      q_sb, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  decode_merge_kernel<QT><<<dim3(H, B), D, 0, stream>>>(
      (const float*)part_acc, (const float*)part_ml, kv_len, kv_stride, (QT*)o, lse, H, KV, D,
      S, split_len, n_split);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Tensor-core variant: bf16 q over a bf16 or fp8 e4m3 cache, D in {64, 128}
// ---------------------------------------------------------------------------
//
// One block per (split, 16-head tile of a KV head, batch row): the G query
// heads of one KV head are packed into the 16 rows of an mma.sync m16n8k16
// A fragment (rows past G are zero and never written; G > 16 takes one
// tile per 16 heads), so S = Q K^T and O = P V run on the tensor cores with
// f32 accumulators.  bf16 x bf16 products are exact in f32 (fp8 e4m3 turns
// into bf16 exactly), so only the order of the sums differs from the
// CUDA-core kernel.
//
// Each of the block's 4 warps owns every 4th 16-key step of the split and
// streams its steps through its own 4-slot ring of K and V rows in shared
// memory with 16-byte cp.async (rows padded by 16 bytes, so ldmatrix is
// free of bank conflicts), so a warp never waits for another inside the
// loop and all of a short split's bytes are in flight at once.  The online
// softmax stays in registers.  p stays f32, as the TPU kernel keeps it:
// P = P_hi + P_lo with P_hi = bf16(p) and P_lo = bf16(p - P_hi), and
// O += P_hi V + P_lo V (relative error ~2^-17 per product; the kernel is
// bound by bytes, so the second product costs no time).
//
// One launch: the warps' (m, l, acc) merge in shared memory; with one
// live split the block writes o (and lse).  Otherwise it writes its f32
// partial, fences, and takes a ticket on the (batch, 16-head tile) counter;
// the last of the tile's live blocks to arrive copies every live split's
// partial (still in L2) into shared memory with two bulk copies, merges
// them, writes o (and lse) and resets the counter to 0, so the counters
// stay zero between launches (CUDA-graph replays included).  The blocks of
// empty splits return before they touch the counter, so a tile's tickets
// count its live blocks only; a tile lies in one batch row, so with a
// length per row each tile's ticket target is its own row's live splits.  Launches that
// share a counter buffer must be ordered (one stream), as the serving
// loop's are.

constexpr int MW = 4;            // warps per block
constexpr int MNT = 32 * MW;     // threads per block
constexpr int STEP = 16;         // keys per warp step (the k of the P V product)
constexpr int NSTAGE = 4;        // ring slots per warp

template <typename KT, int D>
struct MmaLayout {
  static constexpr int ROW = D * (int)sizeof(KT) + 16;          // staged row, bytes
  static constexpr int SLOT = 2 * STEP * ROW;                   // 16 K rows, 16 V rows
  static constexpr int LD = D + 8;                              // bf16 tile row, elements
  static constexpr int CONV = sizeof(KT) == 1 ? 2 * STEP * LD * 2 : 0;  // fp8 -> bf16 copy
  static constexpr int WARP = NSTAGE * SLOT + CONV;
  static constexpr int RINGS = MW * WARP + 16 * LD * 2;          // + the q tile
  static constexpr int MERGE = (MW * 16 * (D + 2) + 32) * 4;    // per warp; the block's M, L
  static constexpr int BYTES = RINGS > MERGE ? RINGS : MERGE;
};

__device__ __forceinline__ void cp_async_16b(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(hopper::smem_addr(dst)), "l"(src), "r"(valid ? 16 : 0));
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// grid (n_split, KV * n_mt, B); split s covers keys [s * split_len,
// min((s + 1) * split_len, kv_len)), split_len a multiple of STEP; the
// splits past kv_len return at once
template <typename KT, int D>
__global__ void __launch_bounds__(MNT) decode_mma_kernel(
    const __nv_bfloat16* __restrict__ q, const KT* __restrict__ k, const KT* __restrict__ v,
    __nv_bfloat16* __restrict__ o, float* __restrict__ lse, float* __restrict__ part,
    int* __restrict__ counters,
    const int* __restrict__ kv_len_p, int kv_stride, int H, int KV, int S, int split_len,
    int n_split, int64_t q_sb, int64_t q_sh,
    int64_t k_sb, int64_t k_ss, int64_t k_sh,
    int64_t v_sb, int64_t v_ss, int64_t v_sh, float scale) {
  using L = MmaLayout<KT, D>;
  constexpr int KT16 = D / 16;          // k-steps of Q K^T
  constexpr int NO = D / 8;             // n-tiles of O
  constexpr int CPR = D * (int)sizeof(KT) / 16;  // 16-byte chunks per cache row
  extern __shared__ __align__(16) unsigned char dsm[];

  const int G = H / KV;
  const int n_mt = (G + 15) / 16;
  const int split = blockIdx.x, kvh = blockIdx.y / n_mt, mt = blockIdx.y % n_mt;
  const int b = blockIdx.z;
  const int kv_len = live_len(kv_len_p, b, kv_stride, S);
  const int n_live = live_splits(kv_len, split_len);
  if (split >= n_live) return;  // no key of this split is live: no work, no ticket
  const int rows = min(16, G - mt * 16);          // live query heads in this tile
  const int head0 = kvh * G + mt * 16;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;

  const int key0 = split * split_len;
  const int key1 = min(key0 + split_len, kv_len);
  const int n_steps = (key1 - key0 + STEP - 1) / STEP;
  const int my_steps = n_steps > warp ? (n_steps - warp + MW - 1) / MW : 0;

  unsigned char* ring = dsm + warp * L::WARP;
  const KT* kb = k + b * k_sb + kvh * k_sh;
  const KT* vb = v + b * v_sb + kvh * v_sh;

  // start copying this warp's i-th step into its slot; rows past kv_len are
  // zero-filled without being read
  auto issue = [&](int i) {
    if (i < my_steps) {
      unsigned char* slot = ring + (i % NSTAGE) * L::SLOT;
      const int s0 = key0 + (warp + i * MW) * STEP;
#pragma unroll
      for (int c = lane; c < 2 * STEP * CPR; c += 32) {
        const int r = c / CPR, col = c % CPR;
        const int key = s0 + (r % STEP);
        const bool ok = key < key1;
        const KT* src = r < STEP ? kb + (int64_t)(ok ? key : 0) * k_ss
                                 : vb + (int64_t)(ok ? key : 0) * v_ss;
        cp_async_16b(slot + r * L::ROW + col * 16,
                     reinterpret_cast<const unsigned char*>(src) + col * 16, ok);
      }
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };
#pragma unroll
  for (int i = 0; i < NSTAGE - 1; ++i) issue(i);

  // the 16-head tile of q (rows past G zero) into shared memory, then as A
  // fragments into every warp's registers, once
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(dsm + MW * L::WARP);
  {
    constexpr int PER = 16 * D / MNT;
    __nv_bfloat16 qv[PER];  // every load in flight before the first store
#pragma unroll
    for (int e = 0; e < PER; ++e) {
      const int r = (tid + e * MNT) / D, d = (tid + e * MNT) % D;
      qv[e] = r < rows ? q[b * q_sb + (int64_t)(head0 + r) * q_sh + d] : __float2bfloat16_rn(0.f);
    }
#pragma unroll
    for (int e = 0; e < PER; ++e)
      qs[((tid + e * MNT) / D) * L::LD + (tid + e * MNT) % D] = qv[e];
  }
  __syncthreads();
  uint32_t qf[KT16][4];
#pragma unroll
  for (int kt = 0; kt < KT16; ++kt)
    mma::ldmatrix_x4(qf[kt], qs + (lane % 16) * L::LD + kt * 16 + (lane / 16) * 8);

  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};  // rows g, g + 8
  float acc[NO][4];
#pragma unroll
  for (int j = 0; j < NO; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  for (int i = 0; i < my_steps; ++i) {
    issue(i + NSTAGE - 1);
    cp_async_wait<NSTAGE - 1>();  // step i has landed for this lane
    __syncwarp();                 // ... and for every lane of the warp
    const unsigned char* slot = ring + (i % NSTAGE) * L::SLOT;
    const __nv_bfloat16* Ks;
    const __nv_bfloat16* Vs;
    if constexpr (sizeof(KT) == 1) {
      // fp8 e4m3 -> bf16 (exact) into the warp's bf16 tile
      __nv_bfloat16* conv = reinterpret_cast<__nv_bfloat16*>(ring + NSTAGE * L::SLOT);
      for (int c = lane; c < 2 * STEP * (D / 8); c += 32) {
        const int r = c / (D / 8), col = (c % (D / 8)) * 8;
        const uint2 raw = *reinterpret_cast<const uint2*>(slot + r * L::ROW + col);
        const __nv_fp8x2_storage_t* pr = reinterpret_cast<const __nv_fp8x2_storage_t*>(&raw);
        uint32_t out[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const __half2 h2 = __half2(__nv_cvt_fp8x2_to_halfraw2(pr[e], __NV_E4M3));
          const float2 f2 = __half22float2(h2);
          __nv_bfloat162 b2 = __floats2bfloat162_rn(f2.x, f2.y);
          out[e] = *reinterpret_cast<uint32_t*>(&b2);
        }
        *reinterpret_cast<uint4*>(conv + r * L::LD + col) = make_uint4(out[0], out[1], out[2], out[3]);
      }
      __syncwarp();
      Ks = conv;
      Vs = conv + STEP * L::LD;
    } else {
      Ks = reinterpret_cast<const __nv_bfloat16*>(slot);
      Vs = reinterpret_cast<const __nv_bfloat16*>(slot + STEP * L::ROW);
    }

    float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
    for (int kt = 0; kt < KT16; ++kt) {
      uint32_t kf[4];  // B fragments of keys 0-7 and 8-15
      mma::ldmatrix_x4(kf, Ks + (lane % 8 + (lane / 16) * 8) * L::LD + kt * 16 +
                               ((lane / 8) % 2) * 8);
      mma::mma_bf16(s[0], qf[kt], kf[0], kf[1]);
      mma::mma_bf16(s[1], qf[kt], kf[2], kf[3]);
    }
    // element e of n-tile n: row g + 8 (e / 2), key step0 + 8 n + 2 t + e % 2
    const int step0 = key0 + (warp + i * MW) * STEP;
    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = step0 + n * 8 + 2 * t + (e & 1);
        const float x = key < key1 ? s[n][e] * scale : -CUDART_INF_F;  // p = 0 past kv_len
        s[n][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float corr[2], m_new[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {  // the 4 lanes of a quad share a row
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      m_new[r] = fmaxf(m[r], mx[r]);
      corr[r] = expf(m[r] - m_new[r]);
    }
    float ps[2] = {0.f, 0.f};
    uint32_t phi[4], plo[4];  // P (16 heads x 16 keys) as A fragments, high and low parts
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float p0 = expf(s[n][2 * r] - m_new[r]), p1 = expf(s[n][2 * r + 1] - m_new[r]);
        ps[r] += p0 + p1;
        const __nv_bfloat162 hi = __floats2bfloat162_rn(p0, p1);
        const float2 hf = __bfloat1622float2(hi);
        const __nv_bfloat162 lo = __floats2bfloat162_rn(p0 - hf.x, p1 - hf.y);
        phi[2 * n + r] = *reinterpret_cast<const uint32_t*>(&hi);
        plo[2 * n + r] = *reinterpret_cast<const uint32_t*>(&lo);
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      ps[r] += __shfl_xor_sync(0xffffffffu, ps[r], 1);
      ps[r] += __shfl_xor_sync(0xffffffffu, ps[r], 2);
      l[r] = l[r] * corr[r] + ps[r];
      m[r] = m_new[r];
    }
#pragma unroll
    for (int j = 0; j < NO; ++j) {
      acc[j][0] *= corr[0];
      acc[j][1] *= corr[0];
      acc[j][2] *= corr[1];
      acc[j][3] *= corr[1];
    }
#pragma unroll
    for (int dp = 0; dp < NO / 2; ++dp) {
      uint32_t vf[4];  // B fragments of dims 16 dp .. 16 dp + 7 and + 8 .. + 15
      mma::ldmatrix_x4_trans(vf, Vs + (lane % 8 + ((lane / 8) % 2) * 8) * L::LD + dp * 16 +
                                     (lane / 16) * 8);
      mma::mma_bf16(acc[2 * dp], phi, vf[0], vf[1]);
      mma::mma_bf16(acc[2 * dp + 1], phi, vf[2], vf[3]);
      mma::mma_bf16(acc[2 * dp], plo, vf[0], vf[1]);
      mma::mma_bf16(acc[2 * dp + 1], plo, vf[2], vf[3]);
    }
    __syncwarp();  // every lane is done with the slot before it is refilled
  }
  cp_async_wait<0>();

  // merge the warps' states in shared memory: acc [MW][16][D], m and l
  // [MW][16] (m becomes each warp's weight), then the block's (M, L) per row
  __syncthreads();  // the rings are free
  float* wacc = reinterpret_cast<float*>(dsm);
  float* wm = wacc + MW * 16 * D;
  float* wl = wm + MW * 16;
  float* bml = wl + MW * 16;   // [16][2]
#pragma unroll
  for (int j = 0; j < NO; ++j) {
    float* r0 = wacc + (warp * 16 + g) * D + j * 8 + 2 * t;
    r0[0] = acc[j][0];
    r0[1] = acc[j][1];
    r0[8 * D] = acc[j][2];
    r0[8 * D + 1] = acc[j][3];
  }
  if (t == 0) {
    wm[warp * 16 + g] = m[0];
    wm[warp * 16 + g + 8] = m[1];
    wl[warp * 16 + g] = l[0];
    wl[warp * 16 + g + 8] = l[1];
  }
  __syncthreads();
  if (tid < 16) {
    float mm = NEG_INF, ll = 0.f;
#pragma unroll
    for (int w = 0; w < MW; ++w) mm = fmaxf(mm, wm[w * 16 + tid]);
#pragma unroll
    for (int w = 0; w < MW; ++w) {
      const float c = expf(wm[w * 16 + tid] - mm);
      ll = fmaf(wl[w * 16 + tid], c, ll);
      wm[w * 16 + tid] = c;
    }
    bml[2 * tid] = mm;
    bml[2 * tid + 1] = ll;
  }
  __syncthreads();

  // the splits' partials: acc [n_split][16][D] per tile, then after every
  // tile's acc, (M, L) [n_split][16][2] per tile
  const int unit = (b * KV + kvh) * n_mt + mt;
  const int n_units = gridDim.z * gridDim.y;
  float* pacc = part + (int64_t)unit * n_split * 16 * D;
  float* pml = part + (int64_t)n_units * n_split * 16 * D + (int64_t)unit * n_split * 32;
  constexpr int PER = 16 * D / MNT;  // elements per thread: row (tid + e MNT) / D
#pragma unroll
  for (int e = 0; e < PER; ++e) {
    const int idx = tid + e * MNT, r = idx / D, d = idx % D;
    float aa = 0.f;
#pragma unroll
    for (int w = 0; w < MW; ++w) aa = fmaf(wacc[(w * 16 + r) * D + d], wm[w * 16 + r], aa);
    if (n_live == 1) {
      if (r < rows)
        o[((int64_t)b * H + head0 + r) * D + d] =
            __float2bfloat16_rn(aa / fmaxf(bml[2 * r + 1], 1e-30f));
    } else {
      pacc[(int64_t)split * 16 * D + idx] = aa;
    }
  }
  if (n_live == 1) {
    if (lse != nullptr && tid < rows)
      lse[(int64_t)b * H + head0 + tid] = row_lse(bml[2 * tid], bml[2 * tid + 1]);
    return;
  }
  if (tid < 32) pml[split * 32 + tid] = bml[tid];

  // the last live block of this tile to arrive merges the live splits
  __shared__ int last;
  __threadfence();
  __syncthreads();
  if (tid == 0) last = atomicAdd(counters + unit, 1) == n_live - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  // every live split's (M, L) and partial accumulator into shared memory by
  // two bulk copies (one round trip to L2; CH splits at a time where they
  // do not all fit), then each split's weight per row and the weighted sum;
  // the shared layout is sized for all n_split splits
  float* sml = reinterpret_cast<float*>(dsm);  // [n_split][16][2]
  float* wsp = sml + n_split * 32;             // [16][n_split] weights
  float* lsum = wsp + 16 * n_split;            // [16]
  float* stage = lsum + 16;                    // [CH][16][D], 16-byte aligned
  const int CH = min(n_live, (int)((L::BYTES - (48 * n_split + 16) * 4) / (16 * D * 4)));
  __shared__ __align__(8) uint64_t gbar;
  if (tid == 0) {
    hopper::mbar_init(&gbar, 1);
    hopper::mbar_fence_init();
    // the partials were written through the generic proxy; the bulk copies
    // read them through the async proxy
    asm volatile("fence.proxy.async.global;\n" ::: "memory");
    hopper::mbar_expect_tx(&gbar, n_live * 32 * 4 + CH * 16 * D * 4);
    hopper::bulk_load(sml, pml, n_live * 32 * 4, &gbar);
    hopper::bulk_load(stage, pacc, CH * 16 * D * 4, &gbar);
  }
  __syncthreads();
  hopper::mbar_wait(&gbar, 0);
  if (tid < rows) {
    float mm = NEG_INF, ll = 0.f;
    for (int sp = 0; sp < n_live; ++sp) mm = fmaxf(mm, sml[sp * 32 + 2 * tid]);
    for (int sp = 0; sp < n_live; ++sp) {
      const float c = expf(sml[sp * 32 + 2 * tid] - mm);
      wsp[tid * n_split + sp] = c;
      ll = fmaf(sml[sp * 32 + 2 * tid + 1], c, ll);
    }
    lsum[tid] = ll;
    if (lse != nullptr) lse[(int64_t)b * H + head0 + tid] = row_lse(mm, ll);
  }
  float accv[PER];
#pragma unroll
  for (int e = 0; e < PER; ++e) accv[e] = 0.f;
  for (int sp0 = 0, chunk = 0; sp0 < n_live; sp0 += CH, ++chunk) {
    const int nch = min(CH, n_live - sp0);
    if (sp0 > 0) {
      __syncthreads();  // the previous chunk is summed
      if (tid == 0) {
        hopper::mbar_expect_tx(&gbar, nch * 16 * D * 4);
        hopper::bulk_load(stage, pacc + (int64_t)sp0 * 16 * D, nch * 16 * D * 4, &gbar);
      }
      hopper::mbar_wait(&gbar, chunk & 1);
    }
    __syncthreads();  // the weights are written
    for (int sp = 0; sp < nch; ++sp) {
#pragma unroll
      for (int e = 0; e < PER; ++e) {
        const int idx = tid + e * MNT, r = idx / D;
        if (r < rows) accv[e] = fmaf(stage[sp * 16 * D + idx], wsp[r * n_split + sp0 + sp], accv[e]);
      }
    }
  }
#pragma unroll
  for (int e = 0; e < PER; ++e) {
    const int idx = tid + e * MNT, r = idx / D, d = idx % D;
    if (r < rows)
      o[((int64_t)b * H + head0 + r) * D + d] =
          __float2bfloat16_rn(accv[e] / fmaxf(lsum[r], 1e-30f));
  }
  if (tid == 0) counters[unit] = 0;
}

template <typename KT, int D>
cudaError_t launch_mma(const void* q, const void* k, const void* v, void* o, float* lse,
                       void* part,
                       int* counters, const int* kv_len, int kv_stride, int B, int H, int KV,
                       int S, int split_len,
                       int n_split, int64_t q_sb, int64_t q_sh,
                       int64_t k_sb, int64_t k_ss, int64_t k_sh,
                       int64_t v_sb, int64_t v_ss, int64_t v_sh,
                       float scale, cudaStream_t stream) {
  constexpr int smem = MmaLayout<KT, D>::BYTES;
  // the split merge's (M, L), weights and at least one split's partial fit
  if ((48 * n_split + 16) * 4 + 16 * D * 4 > smem) return cudaErrorInvalidValue;
  static int cap[64];
  cudaError_t err = hopper::smem_cap((const void*)decode_mma_kernel<KT, D>, smem, cap);
  if (err != cudaSuccess) return err;
  const int n_mt = (H / KV + 15) / 16;
  decode_mma_kernel<KT, D><<<dim3(n_split, KV * n_mt, B), MNT, smem, stream>>>(
      (const __nv_bfloat16*)q, (const KT*)k, (const KT*)v, (__nv_bfloat16*)o, lse,
      (float*)part, counters, kv_len, kv_stride, H, KV, S, split_len, n_split,
      q_sb, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, scale);
  return cudaGetLastError();
}

}  // namespace

// q_dtype: 0 = float32, 1 = bfloat16; kv_dtype: 0 = float32, 1 = bfloat16,
// 2 = float8_e4m3fn.  o is a contiguous [B, H, D] in q's dtype; lse is null or
// a contiguous f32 [B, H] (each head's log-sum-exp over its live keys); part_acc is
// f32 [B, KV, n_split, G, D] and part_ml f32 [B, KV, n_split, G, 2] scratch.
// kv_len points to int32s in device memory, row b's length at kv_len[b *
// kv_stride] (kv_stride 0: one length for every row); S is the cache's
// capacity, which split_len * n_split covers.  Strides are in elements; the
// last dim of q, k and v is contiguous.
extern "C" int decode_attention_fwd(
    int q_dtype, int kv_dtype, const void* q, const void* k, const void* v, void* o, void* lse,
    void* part_acc, void* part_ml, const void* kv_len,
    int B, int H, int KV, int D, int S, int split_len, int n_split, int kv_stride,
    int64_t q_sb, int64_t q_sh,
    int64_t k_sb, int64_t k_ss, int64_t k_sh,
    int64_t v_sb, int64_t v_ss, int64_t v_sh,
    float scale, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
#define DA_ARGS q, k, v, o, (float*)lse, part_acc, part_ml, (const int*)kv_len, kv_stride, \
                B, H, KV, D, S, split_len, n_split, \
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

// The tensor-core variant.  kv_dtype: 1 = bfloat16, 2 = float8_e4m3fn; q and o
// are bfloat16, o a contiguous [B, H, D]; lse null or a contiguous f32 [B, H];
// D in {64, 128}.  part is f32
// scratch of B * KV * n_mt * n_split * 16 * (D + 2) words (the partial
// accumulators, then M and L; unused when n_split is 1) and counters int32
// [B * KV * n_mt], zero before the launch and zero after it (n_mt =
// ceil(G / 16)).  kv_len points to int32s in device memory, row b's length at
// kv_len[b * kv_stride] (kv_stride 0: one length for every row); S is the
// cache's capacity, which split_len * n_split covers, split_len a multiple of
// 16.  The cache rows (k, v data and strides) are 16-byte aligned.  Strides
// are in elements.
extern "C" int decode_attention_mma_fwd(
    int kv_dtype, const void* q, const void* k, const void* v, void* o, void* lse, void* part,
    void* counters, const void* kv_len, int B, int H, int KV, int D, int S, int split_len,
    int n_split, int kv_stride,
    int64_t q_sb, int64_t q_sh,
    int64_t k_sb, int64_t k_ss, int64_t k_sh,
    int64_t v_sb, int64_t v_ss, int64_t v_sh,
    float scale, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
#define DM_ARGS q, k, v, o, (float*)lse, part, (int*)counters, (const int*)kv_len, kv_stride, \
                B, H, KV, S, split_len, n_split, \
                q_sb, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, scale, st
  if (kv_dtype == 1 && D == 64) return (int)launch_mma<__nv_bfloat16, 64>(DM_ARGS);
  if (kv_dtype == 1 && D == 128) return (int)launch_mma<__nv_bfloat16, 128>(DM_ARGS);
  if (kv_dtype == 2 && D == 64) return (int)launch_mma<__nv_fp8_e4m3, 64>(DM_ARGS);
  if (kv_dtype == 2 && D == 128) return (int)launch_mma<__nv_fp8_e4m3, 128>(DM_ARGS);
#undef DM_ARGS
  return (int)cudaErrorInvalidValue;
}
