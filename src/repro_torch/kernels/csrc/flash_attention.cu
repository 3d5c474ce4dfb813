// Flash-attention forward for Hopper (sm_90a), in CUDA C++.
//
// Replaces the TPU kernel `_flash_kernel` / `flash_attention_kernel` of
// src/repro/kernels/flash_attention.py (Pallas, grid (B*H, Sq/bq, Sk/bk)
// with the KV axis walked in order and the online-softmax state in VMEM).
//
// What bounds it on the H100: at the serving shapes (prefill, B=4, S=512,
// H=32 over KV=2, D=128, bf16, causal) the function moves ~36 MB (q and o
// dominate, K/V are 16x smaller under GQA) and does ~8.6 GFLOP, so the
// card's floor is bytes: ~11 us at 3.35 TB/s against ~9 us of bf16 tensor
// work.  Both are far below what this kernel reaches: it issues its
// tensor-core products with mma.sync from 4 warps per block, at 2 blocks
// per SM (registers), and overlaps only the next K/V tile's load with
// them; wgmma, TMA and warp specialisation are later work.
//
// Design, common to both kernels below:
//   * one block per (q tile, head h, batch b): blocks run in parallel in no
//     order, so the TPU kernel's sequential KV grid axis becomes a loop
//     inside the block over K/V tiles staged in shared memory;
//   * q, k, v are read in the model layouts [B, Sq, H, D] and [B, Sk, KV, D]
//     through their strides, so the wrapper's head fold costs no copy; the
//     KV head of query head h is h / (H / KV) (GQA without repeating K/V);
//   * causal: tiles wholly above the diagonal (with q_offset) are skipped,
//     not computed masked as on the TPU;
//   * numerics follow the TPU kernel: scores in f32 times 1/sqrt(D), masked
//     entries set to NEG_INF = -1e30 (not -inf), P rounded to V's dtype
//     before the PV product while l sums the unrounded P, l clamped at
//     1e-30, o = acc / l in q's dtype and lse = m + log(l) in f32.
//
// bf16 (the serving path): tensor cores through mma.sync m16n8k16 with f32
// accumulation.  A block of 4 warps takes 64 query rows, 16 per warp; Q
// stays in registers as MMA fragments; K/V tiles of 64 rows are loaded
// into padded shared memory (row stride D + 8, so ldmatrix is free of bank
// conflicts) by cp.async, double-buffered so that the next tile streams in
// while this one is used; S = Q K^T stays in registers, and P is repacked from the S
// accumulators straight into the A fragments of the PV product, rounded to
// bf16 exactly where the TPU kernel rounds it.
//
// f32: products on the CUDA cores (SIMT) in f32, a 16 x 16 thread grid over
// 64 query rows and 32-row K/V tiles; the tensor cores' f32 input (TF32)
// would round the operands.
//
// The launcher has a plain C interface (loaded with ctypes) and returns
// the cudaError_t of the launch.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math_constants.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace {

using namespace mma;

constexpr float NEG_INF = -1e30f;

// ---------------------------------------------------------------------------
// bf16: tensor-core kernel
// ---------------------------------------------------------------------------

constexpr int MMA_BM = 64;     // query rows per block (16 per warp)
constexpr int MMA_BN = 64;     // key rows per tile
constexpr int MMA_NT = 128;    // 4 warps

// start copying 64 rows of an operand into a padded shared-memory tile
template <int D>
__device__ __forceinline__ void load64(bf16* dst, const bf16* src, int64_t stride,
                                          int row0, int nrows) {
  mma::load_tile<D, 64, MMA_NT>(dst, src, stride, row0, nrows);
}

template <int D>
__global__ void __launch_bounds__(MMA_NT) flash_fwd_mma_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    bf16* __restrict__ o, float* __restrict__ lse,
    int H, int KV, int Sq, int Sk,
    int64_t q_sb, int64_t q_ss, int64_t q_sh,
    int64_t k_sb, int64_t k_ss, int64_t k_sh,
    int64_t v_sb, int64_t v_ss, int64_t v_sh,
    int64_t o_sb, int64_t o_ss, int64_t o_sh,
    int causal, int q_offset, float scale) {
  constexpr int LD = D + 8;           // padded shared-memory row (elements)
  constexpr int KT = D / 16;          // k-steps of the QK^T product
  constexpr int NS = MMA_BN / 8;      // n-tiles of S (8 keys each)
  constexpr int NO = D / 8;           // n-tiles of O (8 dims each)
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* Kbuf = Qs + MMA_BM * LD;       // two K tiles: tile j in buffer j % 2
  bf16* Vbuf = Kbuf + 2 * MMA_BN * LD; // two V tiles

  const int q0 = blockIdx.x * MMA_BM;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;  // accumulator row and column pair

  int n_kv = (Sk + MMA_BN - 1) / MMA_BN;
  if (causal) {
    const int q_last = q_offset + min(q0 + MMA_BM, Sq) - 1;
    n_kv = min(n_kv, q_last / MMA_BN + 1);
  }

  const bf16* kb = k + b * k_sb + kvh * k_sh;
  const bf16* vb = v + b * v_sb + kvh * v_sh;
  load64<D>(Qs, q + b * q_sb + h * q_sh, q_ss, q0, Sq);
  load64<D>(Kbuf, kb, k_ss, 0, Sk);
  load64<D>(Vbuf, vb, v_ss, 0, Sk);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();
  uint32_t qf[KT][4];  // this warp's 16 query rows as A fragments
#pragma unroll
  for (int kt = 0; kt < KT; ++kt)
    ldmatrix_x4(qf[kt], Qs + (warp * 16 + lane % 16) * LD + kt * 16 + (lane / 16) * 8);

  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};  // rows g and g + 8
  float acc[NO][4];
#pragma unroll
  for (int j = 0; j < NO; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  const int qpos0 = q_offset + q0 + warp * 16 + g;

  for (int j = 0; j < n_kv; ++j) {
    const int k0 = j * MMA_BN;
    const bf16* Ks = Kbuf + (j % 2) * MMA_BN * LD;
    const bf16* Vs = Vbuf + (j % 2) * MMA_BN * LD;
    if (j + 1 < n_kv) {  // the next tile streams in while this one is used
      load64<D>(Kbuf + ((j + 1) % 2) * MMA_BN * LD, kb, k_ss, k0 + MMA_BN, Sk);
      load64<D>(Vbuf + ((j + 1) % 2) * MMA_BN * LD, vb, v_ss, k0 + MMA_BN, Sk);
      cp_async_commit();
    }

    float s[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int kt = 0; kt < KT; ++kt) {
#pragma unroll
      for (int np = 0; np < NS / 2; ++np) {
        uint32_t kf[4];  // B fragments of key n-tiles 2np and 2np + 1
        ldmatrix_x4(kf, Ks + (np * 16 + lane % 8 + (lane / 16) * 8) * LD + kt * 16 +
                            ((lane / 8) % 2) * 8);
        mma_bf16(s[2 * np], qf[kt], kf[0], kf[1]);
        mma_bf16(s[2 * np + 1], qf[kt], kf[2], kf[3]);
      }
    }

    // scale and mask; element e of n-tile n is (row g + 8 * (e / 2),
    // key k0 + 8 n + 2 t + e % 2)
    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int n = 0; n < NS; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kpos = k0 + n * 8 + 2 * t + (e & 1);
        float x = s[n][e] * scale;
        if (causal && kpos > qpos0 + (e >> 1) * 8) x = NEG_INF;
        if (kpos >= Sk) x = -CUDART_INF_F;  // ragged edge: contributes p = 0
        s[n][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float corr[2], m_new[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {  // the 4 lanes of a quad share a row
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      m_new[i] = fmaxf(m[i], mx[i]);
      corr[i] = expf(m[i] - m_new[i]);
    }
    float ps[2] = {0.f, 0.f};
    uint32_t pf[NS / 2][4];  // P as A fragments of the PV product (16 keys each)
#pragma unroll
    for (int n = 0; n < NS; ++n) {
      const float p0 = expf(s[n][0] - m_new[0]), p1 = expf(s[n][1] - m_new[0]);
      const float p2 = expf(s[n][2] - m_new[1]), p3 = expf(s[n][3] - m_new[1]);
      ps[0] += p0 + p1;
      ps[1] += p2 + p3;
      pf[n / 2][(n % 2) * 2] = pack_bf16(p0, p1);
      pf[n / 2][(n % 2) * 2 + 1] = pack_bf16(p2, p3);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      ps[i] += __shfl_xor_sync(0xffffffffu, ps[i], 1);
      ps[i] += __shfl_xor_sync(0xffffffffu, ps[i], 2);
      l[i] = l[i] * corr[i] + ps[i];
      m[i] = m_new[i];
    }
#pragma unroll
    for (int d = 0; d < NO; ++d) {
      acc[d][0] *= corr[0];
      acc[d][1] *= corr[0];
      acc[d][2] *= corr[1];
      acc[d][3] *= corr[1];
    }
#pragma unroll
    for (int kk = 0; kk < NS / 2; ++kk) {
#pragma unroll
      for (int dp = 0; dp < NO / 2; ++dp) {
        uint32_t vf[4];  // B fragments of dim n-tiles 2dp and 2dp + 1
        ldmatrix_x4_trans(vf, Vs + (kk * 16 + lane % 8 + ((lane / 8) % 2) * 8) * LD +
                                  dp * 16 + (lane / 16) * 8);
        mma_bf16(acc[2 * dp], pf[kk], vf[0], vf[1]);
        mma_bf16(acc[2 * dp + 1], pf[kk], vf[2], vf[3]);
      }
    }
    // tile j + 1 has landed for every thread, and no warp reads buffer
    // j % 2 any more, which the next iteration refills with tile j + 2
    cp_async_wait_all();
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qi = q0 + warp * 16 + g + i * 8;
    if (qi >= Sq) continue;
    const float ls = fmaxf(l[i], 1e-30f);
    bf16* orow = o + b * o_sb + qi * o_ss + h * o_sh;
#pragma unroll
    for (int d = 0; d < NO; ++d)
      *reinterpret_cast<__nv_bfloat162*>(orow + d * 8 + 2 * t) =
          __floats2bfloat162_rn(acc[d][2 * i] / ls, acc[d][2 * i + 1] / ls);
    if (t == 0) lse[((int64_t)b * H + h) * Sq + qi] = m[i] + logf(ls);
  }
}

// ---------------------------------------------------------------------------
// f32: SIMT kernel
// ---------------------------------------------------------------------------

constexpr int BQ = 64;        // query rows per block
constexpr int BK = 32;        // key rows per tile
constexpr int NT = 256;       // threads per block: a 16 x 16 grid
constexpr int TR = BQ / 16;   // score rows per thread
constexpr int TC = BK / 16;   // score columns per thread

template <int D>
__global__ void __launch_bounds__(NT) flash_fwd_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    float* __restrict__ o, float* __restrict__ lse,
    int H, int KV, int Sq, int Sk,
    int64_t q_sb, int64_t q_ss, int64_t q_sh,
    int64_t k_sb, int64_t k_ss, int64_t k_sh,
    int64_t v_sb, int64_t v_ss, int64_t v_sh,
    int64_t o_sb, int64_t o_ss, int64_t o_sh,
    int causal, int q_offset, float scale) {
  constexpr int DP = D + 1;     // padded row: conflict-free column reads
  constexpr int DC = D / 16;    // output columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;             // [BQ][DP]
  float* Ks = Qs + BQ * DP;     // [BK][DP]
  float* Vs = Ks + BK * DP;     // [BK][D]
  float* Ps = Vs + BK * D;      // [BQ][BK + 1]

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int tid = threadIdx.x;
  const int tx = tid % 16;      // column group; the 16 lanes of a half warp
  const int ty = tid / 16;      // row group

  const float* qb = q + b * q_sb + h * q_sh;
  const float* kb = k + b * k_sb + kvh * k_sh;
  const float* vb = v + b * v_sb + kvh * v_sh;

  for (int idx = tid; idx < BQ * D; idx += NT) {
    const int r = idx / D, d = idx % D;
    const int qi = q0 + r;
    Qs[r * DP + d] = qi < Sq ? qb[qi * q_ss + d] : 0.f;
  }

  float m[TR], l[TR], acc[TR][DC];
#pragma unroll
  for (int i = 0; i < TR; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
  }

  int n_kv = (Sk + BK - 1) / BK;
  if (causal) {
    // the last query position of this tile sees keys 0 .. q_offset + q_last
    const int q_last = q_offset + min(q0 + BQ, Sq) - 1;
    n_kv = min(n_kv, q_last / BK + 1);
  }

  for (int j = 0; j < n_kv; ++j) {
    const int k0 = j * BK;
    __syncthreads();  // the previous tile's Ks / Vs / Ps are consumed
    for (int idx = tid; idx < BK * D; idx += NT) {
      const int r = idx / D, d = idx % D;
      const int ki = k0 + r;
      const bool ok = ki < Sk;
      Ks[r * DP + d] = ok ? kb[ki * k_ss + d] : 0.f;
      Vs[r * D + d] = ok ? vb[ki * v_ss + d] : 0.f;
    }
    __syncthreads();

    float s[TR][TC];
#pragma unroll
    for (int i = 0; i < TR; ++i)
#pragma unroll
      for (int c = 0; c < TC; ++c) s[i][c] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qa[TR], kc[TC];
#pragma unroll
      for (int i = 0; i < TR; ++i) qa[i] = Qs[(ty * TR + i) * DP + d];
#pragma unroll
      for (int c = 0; c < TC; ++c) kc[c] = Ks[(tx + 16 * c) * DP + d];
#pragma unroll
      for (int i = 0; i < TR; ++i)
#pragma unroll
        for (int c = 0; c < TC; ++c) s[i][c] = fmaf(qa[i], kc[c], s[i][c]);
    }

#pragma unroll
    for (int i = 0; i < TR; ++i) {
      const int qpos = q_offset + q0 + ty * TR + i;
      float mx = NEG_INF;
#pragma unroll
      for (int c = 0; c < TC; ++c) {
        const int ki = k0 + tx + 16 * c;
        float x = s[i][c] * scale;
        if (causal && ki > qpos) x = NEG_INF;
        if (ki >= Sk) x = -CUDART_INF_F;  // ragged edge: contributes p = 0
        s[i][c] = x;
        mx = fmaxf(mx, x);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float corr = expf(m[i] - m_new);
      float ps = 0.f;
#pragma unroll
      for (int c = 0; c < TC; ++c) {
        const float p = expf(s[i][c] - m_new);
        ps += p;
        Ps[(ty * TR + i) * (BK + 1) + tx + 16 * c] = p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        ps += __shfl_xor_sync(0xffffffffu, ps, off);
      l[i] = l[i] * corr + ps;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[i][c] *= corr;
    }
    __syncthreads();

    const int kmax = min(BK, Sk - k0);
    for (int kk = 0; kk < kmax; ++kk) {
      float pa[TR];
#pragma unroll
      for (int i = 0; i < TR; ++i) pa[i] = Ps[(ty * TR + i) * (BK + 1) + kk];
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        const float vv = Vs[kk * D + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < TR; ++i) acc[i][c] = fmaf(pa[i], vv, acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < TR; ++i) {
    const int qi = q0 + ty * TR + i;
    if (qi >= Sq) continue;
    const float ls = fmaxf(l[i], 1e-30f);
    float* orow = o + b * o_sb + qi * o_ss + h * o_sh;
#pragma unroll
    for (int c = 0; c < DC; ++c) orow[tx + 16 * c] = acc[i][c] / ls;
    if (tx == 0) lse[((int64_t)b * H + h) * Sq + qi] = m[i] + logf(ls);
  }
}

struct Args {
  const void *q, *k, *v;
  void *o, *lse;
  int H, KV, Sq, Sk;
  int64_t q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, o_sb, o_ss, o_sh;
  int causal, q_offset;
  float scale;
};

template <typename T, typename Kernel>
cudaError_t launch(Kernel kernel, const Args& a, int B, int bm, int threads, size_t smem,
                   cudaStream_t stream) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((a.Sq + bm - 1) / bm, a.H, B);
  kernel<<<grid, threads, smem, stream>>>(
      (const T*)a.q, (const T*)a.k, (const T*)a.v, (T*)a.o, (float*)a.lse,
      a.H, a.KV, a.Sq, a.Sk, a.q_sb, a.q_ss, a.q_sh, a.k_sb, a.k_ss, a.k_sh,
      a.v_sb, a.v_ss, a.v_sh, a.o_sb, a.o_ss, a.o_sh, a.causal, a.q_offset, a.scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_bf16(const Args& a, int B, cudaStream_t stream) {
  const size_t smem = sizeof(bf16) * (MMA_BM + 4 * MMA_BN) * (D + 8);
  return launch<bf16>(flash_fwd_mma_kernel<D>, a, B, MMA_BM, MMA_NT, smem, stream);
}

template <int D>
cudaError_t launch_f32(const Args& a, int B, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (BQ * (D + 1) + BK * (D + 1) + BK * D + BQ * (BK + 1));
  return launch<float>(flash_fwd_f32_kernel<D>, a, B, BQ, NT, smem, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and o share it); D in {64, 128}.
// Strides are in elements; the last dim of every operand is contiguous.
// bf16 rows must start on 16-byte boundaries (checked by the caller).
extern "C" int flash_attention_fwd(
    int dtype, const void* q, const void* k, const void* v, void* o, void* lse,
    int B, int H, int KV, int Sq, int Sk, int D,
    int64_t q_sb, int64_t q_ss, int64_t q_sh,
    int64_t k_sb, int64_t k_ss, int64_t k_sh,
    int64_t v_sb, int64_t v_ss, int64_t v_sh,
    int64_t o_sb, int64_t o_ss, int64_t o_sh,
    int causal, int q_offset, float scale, void* stream) {
  const Args a{q, k, v, o, lse, H, KV, Sq, Sk, q_sb, q_ss, q_sh, k_sb, k_ss, k_sh,
               v_sb, v_ss, v_sh, o_sb, o_ss, o_sh, causal, q_offset, scale};
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0 && D == 64) return (int)launch_f32<64>(a, B, st);
  if (dtype == 0 && D == 128) return (int)launch_f32<128>(a, B, st);
  if (dtype == 1 && D == 64) return (int)launch_bf16<64>(a, B, st);
  if (dtype == 1 && D == 128) return (int)launch_bf16<128>(a, B, st);
  return (int)cudaErrorInvalidValue;
}
