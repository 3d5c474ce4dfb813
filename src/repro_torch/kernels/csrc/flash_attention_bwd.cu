// Flash-attention backward for Hopper (sm_90a), in CUDA C++: the dK/dV pass
// and the dQ pass of flash-attention 2.
//
// Replaces the TPU kernels `_dkdv_kernel` and `_dq_kernel` of
// `flash_attention_bwd_kernel` in src/repro/kernels/flash_attention_bwd.py
// (Pallas, grids (B*H, n_kv, n_q) and (B*H, n_q, n_kv), one query head per
// program, with dk/dv summed over each GQA group afterwards by the wrapper).
//
// Both passes recompute p = exp(s - lse) and ds = p * (dp - delta) * scale
// from q, k, v, do and the forward's f32 lse, with delta = rowsum(do * o)
// computed by the caller; scores, probabilities and ds never reach device
// memory.
//
// What bounds them on the H100: at the training shape (B=2, S=2048, H=32
// over KV=2, D=128, bf16, causal) the dK/dV pass does four products of the
// causal triangle (S, dP, dV, dK: ~138 GFLOP) against ~76 MB of traffic, the
// dQ pass three (S, dP, dQ: ~103 GFLOP) against ~106 MB, so both are bound
// by the tensor cores (0.14 and 0.10 ms at 989 TFLOP/s, against 0.02 and
// 0.03 ms of bytes).  This version runs mma.sync on 4 warps per block
// and double-buffers the streamed tiles with cp.async; wgmma, TMA and warp
// specialisation are later work.
//
// Design:
//   * dK/dV: one block per (kv tile of 64 keys, KV head, batch).  It walks
//     the G query heads of its KV head and, for each, the q tiles from the
//     causal diagonal on, so dK and dV of its 64 keys stay in f32 registers
//     over the whole group and are written once, in k's dtype.  That is the
//     TPU wrapper's GQA group sum done in f32 inside the kernel, instead of
//     after a rounding of each query head's dk, dv to k's dtype;
//   * dQ: one block per (q tile of 64 rows, query head, batch) walks the
//     kv tiles up to the diagonal, with dQ in f32 registers.  No atomics:
//     both passes are bitwise repeatable;
//   * q, k, v, do are read in the model layouts [B, S, H|KV, D] through
//     their strides; dq is written [B, Sq, H, D], dk and dv [B, Sk, KV, D];
//     lse and delta are [B*H, Sq], b-major, as the forward writes lse;
//   * any Sq and Sk: rows past either end are loaded as zeros and their p
//     is set to 0; tiles wholly above the causal diagonal are skipped;
//   * numerics follow the TPU kernels: scores in f32 times 1/sqrt(D),
//     masked entries NEG_INF = -1e30, P rounded to do's dtype for dV, dS
//     rounded to q's dtype for dK and to k's dtype for dQ, f32 sums.
//
// bf16: tensor cores through mma.sync m16n8k16 (mma_bf16.cuh).  In dK/dV a
// warp owns 16 keys: S^T = K Q^T and dP^T = V dO^T come out in
// accumulators whose rows are its keys, and P^T and dS^T repack in
// registers into the A fragments of dV += P^T dO and dK += dS^T Q.  In dQ
// a warp owns 16 query rows: S = Q K^T, dP = dO V^T, and dS repacks into
// the A fragments of dQ += dS K.  f32: the same passes on the CUDA cores
// (SIMT), since TF32 would round the operands.
//
// The launchers have a plain C interface (loaded with ctypes) and return
// the cudaError_t of the launch.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace {

using namespace mma;

constexpr float NEG_INF = -1e30f;

struct Args {
  const void *q, *k, *v, *dout;
  const float *lse, *delta;
  void *dq, *dk, *dv;
  int H, KV, Sq, Sk;
  int64_t q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, do_sb, do_ss, do_sh;
  int64_t dq_sb, dq_ss, dq_sh, dk_sb, dk_ss, dk_sh, dv_sb, dv_ss, dv_sh;
  int causal, q_offset;
  float scale;
};

// the first q tile (of `bq` rows) that holds a query at or past key k0
__device__ __forceinline__ int first_q_tile(const Args& a, int k0, int bq) {
  return a.causal ? max(0, (k0 - a.q_offset) / bq) : 0;
}

// the number of kv tiles (of `bk` keys) that the queries [q0, q0 + bq) see
__device__ __forceinline__ int kv_tiles(const Args& a, int q0, int bq, int bk) {
  int n = (a.Sk + bk - 1) / bk;
  if (a.causal) n = min(n, (a.q_offset + min(q0 + bq, a.Sq) - 1) / bk + 1);
  return n;
}

// ---------------------------------------------------------------------------
// bf16: tensor-core kernels
// ---------------------------------------------------------------------------

constexpr int BT = 64;    // rows of every tile (keys or queries); 16 per warp
constexpr int NT = 128;   // 4 warps

template <int D>
__global__ void __launch_bounds__(NT) dkdv_mma_kernel(const Args a) {
  constexpr int LD = D + 8;     // padded shared-memory row (elements)
  constexpr int KT = D / 16;    // k-steps of the S^T and dP^T products
  constexpr int NQ = BT / 8;    // n-tiles of S^T (8 queries each)
  constexpr int ND = D / 8;     // n-tiles of dK and dV (8 dims each)
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);
  bf16* Vs = Ks + BT * LD;
  bf16* Qbuf = Vs + BT * LD;          // two q tiles: step it in buffer it % 2
  bf16* Dbuf = Qbuf + 2 * BT * LD;    // two dO tiles
  float* Lbuf = reinterpret_cast<float*>(Dbuf + 2 * BT * LD);  // two lse rows
  float* Ebuf = Lbuf + 2 * BT;                                  // two delta rows

  const int k0 = blockIdx.x * BT;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int G = a.H / a.KV;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const bf16* q = static_cast<const bf16*>(a.q);
  const bf16* dout = static_cast<const bf16*>(a.dout);

  const int n_q = (a.Sq + BT - 1) / BT;
  const int i0 = first_q_tile(a, k0, BT);
  const int per_head = max(0, n_q - i0);
  const int n_it = G * per_head;  // (query head, q tile) steps

  load_tile<D, BT, NT>(Ks, static_cast<const bf16*>(a.k) + b * a.k_sb + kvh * a.k_sh,
                       a.k_ss, k0, a.Sk);
  load_tile<D, BT, NT>(Vs, static_cast<const bf16*>(a.v) + b * a.v_sb + kvh * a.v_sh,
                       a.v_ss, k0, a.Sk);
  // start the copies of step `it` into buffer `buf`
  auto fetch = [&](int it, int buf) {
    const int h = kvh * G + it / per_head;
    const int q0 = (i0 + it % per_head) * BT;
    load_tile<D, BT, NT>(Qbuf + buf * BT * LD, q + b * a.q_sb + h * a.q_sh, a.q_ss, q0, a.Sq);
    load_tile<D, BT, NT>(Dbuf + buf * BT * LD, dout + b * a.do_sb + h * a.do_sh, a.do_ss, q0,
                         a.Sq);
    const int64_t row = ((int64_t)b * a.H + h) * a.Sq;
    for (int r = threadIdx.x; r < BT; r += NT) {
      const bool ok = q0 + r < a.Sq;
      cp_async_4(Lbuf + buf * BT + r, a.lse + row + (ok ? q0 + r : 0), ok);
      cp_async_4(Ebuf + buf * BT + r, a.delta + row + (ok ? q0 + r : 0), ok);
    }
  };
  if (n_it > 0) fetch(0, 0);
  cp_async_commit();

  float dka[ND][4], dva[ND][4];
#pragma unroll
  for (int d = 0; d < ND; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[d][e] = dva[d][e] = 0.f;
  const int krow = k0 + warp * 16 + g;  // keys of accumulator rows g and g + 8

  for (int it = 0; it < n_it; ++it) {
    const int buf = it % 2;
    // step it has landed for every thread, and no warp reads the other
    // buffer any more (its last reader was step it - 1)
    cp_async_wait_all();
    __syncthreads();
    if (it + 1 < n_it) {  // the next step streams in while this one is used
      fetch(it + 1, 1 - buf);
      cp_async_commit();
    }
    const int q0 = (i0 + it % per_head) * BT;
    const bf16* Qs = Qbuf + buf * BT * LD;
    const bf16* Ds = Dbuf + buf * BT * LD;
    const float* Ls = Lbuf + buf * BT;
    const float* Es = Ebuf + buf * BT;

    // S^T = K Q^T and dP^T = V dO^T for this warp's 16 keys x 64 queries
    float st[NQ][4], dpt[NQ][4];
#pragma unroll
    for (int n = 0; n < NQ; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[n][e] = dpt[n][e] = 0.f;
#pragma unroll
    for (int kt = 0; kt < KT; ++kt) {
      uint32_t kf[4], vf[4];  // A fragments: this warp's keys, dims 16 kt ..
      ldmatrix_x4(kf, Ks + (warp * 16 + lane % 16) * LD + kt * 16 + (lane / 16) * 8);
      ldmatrix_x4(vf, Vs + (warp * 16 + lane % 16) * LD + kt * 16 + (lane / 16) * 8);
#pragma unroll
      for (int np = 0; np < NQ / 2; ++np) {
        uint32_t bfr[4];  // B fragments of query n-tiles 2np and 2np + 1
        const int off = (np * 16 + lane % 8 + (lane / 16) * 8) * LD + kt * 16 +
                        ((lane / 8) % 2) * 8;
        ldmatrix_x4(bfr, Qs + off);
        mma_bf16(st[2 * np], kf, bfr[0], bfr[1]);
        mma_bf16(st[2 * np + 1], kf, bfr[2], bfr[3]);
        ldmatrix_x4(bfr, Ds + off);
        mma_bf16(dpt[2 * np], vf, bfr[0], bfr[1]);
        mma_bf16(dpt[2 * np + 1], vf, bfr[2], bfr[3]);
      }
    }

    // P^T and dS^T; element e of n-tile n is (key krow + 8 (e / 2), query
    // q0 + 8 n + 2 t + e % 2), repacked as A fragments over 16 queries
    uint32_t pf[NQ / 2][4], sf[NQ / 2][4];
#pragma unroll
    for (int n = 0; n < NQ; ++n) {
      float p[4], ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kpos = krow + (e >> 1) * 8;
        const int c = n * 8 + 2 * t + (e & 1);
        const int qi = q0 + c;
        float x = st[n][e] * a.scale;
        if (a.causal && kpos > a.q_offset + qi) x = NEG_INF;
        float pe = __expf(x - Ls[c]);
        if (qi >= a.Sq || kpos >= a.Sk) pe = 0.f;
        p[e] = pe;
        ds[e] = pe * (dpt[n][e] - Es[c]) * a.scale;
      }
      pf[n / 2][(n % 2) * 2] = pack_bf16(p[0], p[1]);
      pf[n / 2][(n % 2) * 2 + 1] = pack_bf16(p[2], p[3]);
      sf[n / 2][(n % 2) * 2] = pack_bf16(ds[0], ds[1]);
      sf[n / 2][(n % 2) * 2 + 1] = pack_bf16(ds[2], ds[3]);
    }

    // dV += P^T dO and dK += dS^T Q over the 64 queries of this step
#pragma unroll
    for (int kk = 0; kk < NQ / 2; ++kk) {
#pragma unroll
      for (int dp = 0; dp < ND / 2; ++dp) {
        uint32_t bfr[4];  // B fragments of dim n-tiles 2dp and 2dp + 1
        const int off = (kk * 16 + lane % 8 + ((lane / 8) % 2) * 8) * LD + dp * 16 +
                        (lane / 16) * 8;
        ldmatrix_x4_trans(bfr, Ds + off);
        mma_bf16(dva[2 * dp], pf[kk], bfr[0], bfr[1]);
        mma_bf16(dva[2 * dp + 1], pf[kk], bfr[2], bfr[3]);
        ldmatrix_x4_trans(bfr, Qs + off);
        mma_bf16(dka[2 * dp], sf[kk], bfr[0], bfr[1]);
        mma_bf16(dka[2 * dp + 1], sf[kk], bfr[2], bfr[3]);
      }
    }
  }
  cp_async_wait_all();  // nothing in flight when the block ends

  bf16* dk = static_cast<bf16*>(a.dk);
  bf16* dv = static_cast<bf16*>(a.dv);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int kr = krow + i * 8;
    if (kr >= a.Sk) continue;
    bf16* dkrow = dk + b * a.dk_sb + kr * a.dk_ss + kvh * a.dk_sh;
    bf16* dvrow = dv + b * a.dv_sb + kr * a.dv_ss + kvh * a.dv_sh;
#pragma unroll
    for (int d = 0; d < ND; ++d) {
      *reinterpret_cast<__nv_bfloat162*>(dkrow + d * 8 + 2 * t) =
          __floats2bfloat162_rn(dka[d][2 * i], dka[d][2 * i + 1]);
      *reinterpret_cast<__nv_bfloat162*>(dvrow + d * 8 + 2 * t) =
          __floats2bfloat162_rn(dva[d][2 * i], dva[d][2 * i + 1]);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(NT) dq_mma_kernel(const Args a) {
  constexpr int LD = D + 8;
  constexpr int KT = D / 16;    // k-steps of the S and dP products
  constexpr int NS = BT / 8;    // n-tiles of S (8 keys each)
  constexpr int ND = D / 8;     // n-tiles of dQ
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* Ds = Qs + BT * LD;
  bf16* Kbuf = Ds + BT * LD;          // two K tiles: tile j in buffer j % 2
  bf16* Vbuf = Kbuf + 2 * BT * LD;    // two V tiles

  const int q0 = blockIdx.x * BT;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (a.H / a.KV);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const bf16* kb = static_cast<const bf16*>(a.k) + b * a.k_sb + kvh * a.k_sh;
  const bf16* vb = static_cast<const bf16*>(a.v) + b * a.v_sb + kvh * a.v_sh;

  const int n_kv = kv_tiles(a, q0, BT, BT);
  load_tile<D, BT, NT>(Qs, static_cast<const bf16*>(a.q) + b * a.q_sb + h * a.q_sh, a.q_ss,
                       q0, a.Sq);
  load_tile<D, BT, NT>(Ds, static_cast<const bf16*>(a.dout) + b * a.do_sb + h * a.do_sh,
                       a.do_ss, q0, a.Sq);
  load_tile<D, BT, NT>(Kbuf, kb, a.k_ss, 0, a.Sk);
  load_tile<D, BT, NT>(Vbuf, vb, a.v_ss, 0, a.Sk);
  cp_async_commit();

  const int qrow = q0 + warp * 16 + g;  // query rows g and g + 8 of this warp
  float lse_r[2], del_r[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qi = qrow + i * 8;
    const int64_t idx = ((int64_t)b * a.H + h) * a.Sq + min(qi, a.Sq - 1);
    lse_r[i] = a.lse[idx];
    del_r[i] = a.delta[idx];
  }
  float dqa[ND][4];
#pragma unroll
  for (int d = 0; d < ND; ++d) dqa[d][0] = dqa[d][1] = dqa[d][2] = dqa[d][3] = 0.f;
  cp_async_wait_all();
  __syncthreads();

  for (int j = 0; j < n_kv; ++j) {
    const int k0 = j * BT;
    const bf16* Ks = Kbuf + (j % 2) * BT * LD;
    const bf16* Vs = Vbuf + (j % 2) * BT * LD;
    if (j + 1 < n_kv) {  // the next tile streams in while this one is used
      load_tile<D, BT, NT>(Kbuf + ((j + 1) % 2) * BT * LD, kb, a.k_ss, k0 + BT, a.Sk);
      load_tile<D, BT, NT>(Vbuf + ((j + 1) % 2) * BT * LD, vb, a.v_ss, k0 + BT, a.Sk);
      cp_async_commit();
    }

    float s[NS][4], dp[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
    for (int kt = 0; kt < KT; ++kt) {
      uint32_t qf[4], df[4];  // A fragments: this warp's query rows
      ldmatrix_x4(qf, Qs + (warp * 16 + lane % 16) * LD + kt * 16 + (lane / 16) * 8);
      ldmatrix_x4(df, Ds + (warp * 16 + lane % 16) * LD + kt * 16 + (lane / 16) * 8);
#pragma unroll
      for (int np = 0; np < NS / 2; ++np) {
        uint32_t bfr[4];  // B fragments of key n-tiles 2np and 2np + 1
        const int off = (np * 16 + lane % 8 + (lane / 16) * 8) * LD + kt * 16 +
                        ((lane / 8) % 2) * 8;
        ldmatrix_x4(bfr, Ks + off);
        mma_bf16(s[2 * np], qf, bfr[0], bfr[1]);
        mma_bf16(s[2 * np + 1], qf, bfr[2], bfr[3]);
        ldmatrix_x4(bfr, Vs + off);
        mma_bf16(dp[2 * np], df, bfr[0], bfr[1]);
        mma_bf16(dp[2 * np + 1], df, bfr[2], bfr[3]);
      }
    }

    // dS; element e of n-tile n is (query qrow + 8 (e / 2), key
    // k0 + 8 n + 2 t + e % 2)
    uint32_t sf[NS / 2][4];
#pragma unroll
    for (int n = 0; n < NS; ++n) {
      float ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qi = qrow + (e >> 1) * 8;
        const int kpos = k0 + n * 8 + 2 * t + (e & 1);
        float x = s[n][e] * a.scale;
        if (a.causal && kpos > a.q_offset + qi) x = NEG_INF;
        float pe = __expf(x - lse_r[e >> 1]);
        if (kpos >= a.Sk) pe = 0.f;
        ds[e] = pe * (dp[n][e] - del_r[e >> 1]) * a.scale;
      }
      sf[n / 2][(n % 2) * 2] = pack_bf16(ds[0], ds[1]);
      sf[n / 2][(n % 2) * 2 + 1] = pack_bf16(ds[2], ds[3]);
    }

    // dQ += dS K over the 64 keys of this tile
#pragma unroll
    for (int kk = 0; kk < NS / 2; ++kk) {
#pragma unroll
      for (int dd = 0; dd < ND / 2; ++dd) {
        uint32_t bfr[4];  // B fragments of dim n-tiles 2dd and 2dd + 1
        ldmatrix_x4_trans(bfr, Ks + (kk * 16 + lane % 8 + ((lane / 8) % 2) * 8) * LD +
                                   dd * 16 + (lane / 16) * 8);
        mma_bf16(dqa[2 * dd], sf[kk], bfr[0], bfr[1]);
        mma_bf16(dqa[2 * dd + 1], sf[kk], bfr[2], bfr[3]);
      }
    }
    // tile j + 1 has landed for every thread, and no warp reads buffer
    // j % 2 any more, which the next iteration refills with tile j + 2
    cp_async_wait_all();
    __syncthreads();
  }

  bf16* dq = static_cast<bf16*>(a.dq);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qi = qrow + i * 8;
    if (qi >= a.Sq) continue;
    bf16* row = dq + b * a.dq_sb + qi * a.dq_ss + h * a.dq_sh;
#pragma unroll
    for (int d = 0; d < ND; ++d)
      *reinterpret_cast<__nv_bfloat162*>(row + d * 8 + 2 * t) =
          __floats2bfloat162_rn(dqa[d][2 * i], dqa[d][2 * i + 1]);
  }
}

// ---------------------------------------------------------------------------
// f32: SIMT kernels
// ---------------------------------------------------------------------------

constexpr int FB = 32;    // rows of every tile (keys or queries)
constexpr int FT = 256;   // threads per block: a 16 x 16 grid; thread (ty, tx)
                          // owns rows 2 ty, 2 ty + 1 and columns tx + 16 c

// load rows [row0, row0 + FB) of a [rows, D] f32 operand into shared
// memory with row stride D + 1; rows at or past `nrows` become zero
template <int D>
__device__ __forceinline__ void load_f32(float* dst, const float* src, int64_t stride,
                                         int row0, int nrows) {
  for (int idx = threadIdx.x; idx < FB * D; idx += FT) {
    const int r = idx / D, d = idx % D;
    const int gr = row0 + r;
    dst[r * (D + 1) + d] = gr < nrows ? src[gr * stride + d] : 0.f;
  }
}

template <int D>
__global__ void __launch_bounds__(FT) dkdv_f32_kernel(const Args a) {
  constexpr int DP = D + 1;     // padded row: conflict-free column reads
  constexpr int DC = D / 16;    // output columns per thread
  constexpr int PP = FB + 1;
  extern __shared__ float smem[];
  float* Ks = smem;             // [FB][DP]
  float* Vs = Ks + FB * DP;
  float* Qs = Vs + FB * DP;
  float* Ds = Qs + FB * DP;     // dO
  float* Pt = Ds + FB * DP;     // P^T  [FB keys][FB queries + 1]
  float* St = Pt + FB * PP;     // dS^T
  float* Ls = St + FB * PP;     // lse of the q tile
  float* Es = Ls + FB;          // delta of the q tile

  const int k0 = blockIdx.x * FB;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int G = a.H / a.KV;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const float* q = static_cast<const float*>(a.q);
  const float* dout = static_cast<const float*>(a.dout);

  load_f32<D>(Ks, static_cast<const float*>(a.k) + b * a.k_sb + kvh * a.k_sh, a.k_ss, k0, a.Sk);
  load_f32<D>(Vs, static_cast<const float*>(a.v) + b * a.v_sb + kvh * a.v_sh, a.v_ss, k0, a.Sk);
  float dka[2][DC], dva[2][DC];
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int c = 0; c < DC; ++c) dka[r][c] = dva[r][c] = 0.f;

  const int n_q = (a.Sq + FB - 1) / FB;
  for (int hh = 0; hh < G; ++hh) {
    const int h = kvh * G + hh;
    const int64_t row = ((int64_t)b * a.H + h) * a.Sq;
    for (int i = first_q_tile(a, k0, FB); i < n_q; ++i) {
      const int q0 = i * FB;
      __syncthreads();  // the previous step's tiles are consumed
      load_f32<D>(Qs, q + b * a.q_sb + h * a.q_sh, a.q_ss, q0, a.Sq);
      load_f32<D>(Ds, dout + b * a.do_sb + h * a.do_sh, a.do_ss, q0, a.Sq);
      if (threadIdx.x < FB) {
        const int qi = q0 + threadIdx.x;
        Ls[threadIdx.x] = qi < a.Sq ? a.lse[row + qi] : 0.f;
        Es[threadIdx.x] = qi < a.Sq ? a.delta[row + qi] : 0.f;
      }
      __syncthreads();

      float s[2][2] = {}, dp[2][2] = {};
#pragma unroll 8
      for (int d = 0; d < D; ++d) {
        const float k_0 = Ks[(2 * ty) * DP + d], k_1 = Ks[(2 * ty + 1) * DP + d];
        const float v_0 = Vs[(2 * ty) * DP + d], v_1 = Vs[(2 * ty + 1) * DP + d];
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const float qv = Qs[(tx + 16 * c) * DP + d], dv_ = Ds[(tx + 16 * c) * DP + d];
          s[0][c] = fmaf(k_0, qv, s[0][c]);
          s[1][c] = fmaf(k_1, qv, s[1][c]);
          dp[0][c] = fmaf(v_0, dv_, dp[0][c]);
          dp[1][c] = fmaf(v_1, dv_, dp[1][c]);
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int kpos = k0 + 2 * ty + r;
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int col = tx + 16 * c;
          const int qi = q0 + col;
          float x = s[r][c] * a.scale;
          if (a.causal && kpos > a.q_offset + qi) x = NEG_INF;
          float p = expf(x - Ls[col]);
          if (qi >= a.Sq || kpos >= a.Sk) p = 0.f;
          Pt[(2 * ty + r) * PP + col] = p;
          St[(2 * ty + r) * PP + col] = p * (dp[r][c] - Es[col]) * a.scale;
        }
      }
      __syncthreads();

      for (int qq = 0; qq < FB; ++qq) {
        const float p0 = Pt[(2 * ty) * PP + qq], p1 = Pt[(2 * ty + 1) * PP + qq];
        const float s0 = St[(2 * ty) * PP + qq], s1 = St[(2 * ty + 1) * PP + qq];
#pragma unroll
        for (int c = 0; c < DC; ++c) {
          const float dov = Ds[qq * DP + tx + 16 * c], qv = Qs[qq * DP + tx + 16 * c];
          dva[0][c] = fmaf(p0, dov, dva[0][c]);
          dva[1][c] = fmaf(p1, dov, dva[1][c]);
          dka[0][c] = fmaf(s0, qv, dka[0][c]);
          dka[1][c] = fmaf(s1, qv, dka[1][c]);
        }
      }
    }
  }

  float* dk = static_cast<float*>(a.dk);
  float* dv = static_cast<float*>(a.dv);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int kr = k0 + 2 * ty + r;
    if (kr >= a.Sk) continue;
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      dk[b * a.dk_sb + kr * a.dk_ss + kvh * a.dk_sh + tx + 16 * c] = dka[r][c];
      dv[b * a.dv_sb + kr * a.dv_ss + kvh * a.dv_sh + tx + 16 * c] = dva[r][c];
    }
  }
}

template <int D>
__global__ void __launch_bounds__(FT) dq_f32_kernel(const Args a) {
  constexpr int DP = D + 1;
  constexpr int DC = D / 16;
  constexpr int PP = FB + 1;
  extern __shared__ float smem[];
  float* Qs = smem;             // [FB][DP]
  float* Ds = Qs + FB * DP;     // dO
  float* Ks = Ds + FB * DP;
  float* Vs = Ks + FB * DP;
  float* Sm = Vs + FB * DP;     // dS  [FB queries][FB keys + 1]
  float* Ls = Sm + FB * PP;
  float* Es = Ls + FB;

  const int q0 = blockIdx.x * FB;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (a.H / a.KV);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const float* kb = static_cast<const float*>(a.k) + b * a.k_sb + kvh * a.k_sh;
  const float* vb = static_cast<const float*>(a.v) + b * a.v_sb + kvh * a.v_sh;

  load_f32<D>(Qs, static_cast<const float*>(a.q) + b * a.q_sb + h * a.q_sh, a.q_ss, q0, a.Sq);
  load_f32<D>(Ds, static_cast<const float*>(a.dout) + b * a.do_sb + h * a.do_sh, a.do_ss, q0,
              a.Sq);
  if (threadIdx.x < FB) {
    const int qi = q0 + threadIdx.x;
    const int64_t row = ((int64_t)b * a.H + h) * a.Sq;
    Ls[threadIdx.x] = qi < a.Sq ? a.lse[row + qi] : 0.f;
    Es[threadIdx.x] = qi < a.Sq ? a.delta[row + qi] : 0.f;
  }
  float dqa[2][DC];
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int c = 0; c < DC; ++c) dqa[r][c] = 0.f;

  const int n_kv = kv_tiles(a, q0, FB, FB);
  for (int j = 0; j < n_kv; ++j) {
    const int k0 = j * FB;
    __syncthreads();  // the previous tile's Ks, Vs and Sm are consumed
    load_f32<D>(Ks, kb, a.k_ss, k0, a.Sk);
    load_f32<D>(Vs, vb, a.v_ss, k0, a.Sk);
    __syncthreads();

    float s[2][2] = {}, dp[2][2] = {};
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      const float q_0 = Qs[(2 * ty) * DP + d], q_1 = Qs[(2 * ty + 1) * DP + d];
      const float d_0 = Ds[(2 * ty) * DP + d], d_1 = Ds[(2 * ty + 1) * DP + d];
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const float kv = Ks[(tx + 16 * c) * DP + d], vv = Vs[(tx + 16 * c) * DP + d];
        s[0][c] = fmaf(q_0, kv, s[0][c]);
        s[1][c] = fmaf(q_1, kv, s[1][c]);
        dp[0][c] = fmaf(d_0, vv, dp[0][c]);
        dp[1][c] = fmaf(d_1, vv, dp[1][c]);
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qr = 2 * ty + r;
      const int qi = q0 + qr;
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int kpos = k0 + tx + 16 * c;
        float x = s[r][c] * a.scale;
        if (a.causal && kpos > a.q_offset + qi) x = NEG_INF;
        float p = expf(x - Ls[qr]);
        if (qi >= a.Sq || kpos >= a.Sk) p = 0.f;
        Sm[qr * PP + tx + 16 * c] = p * (dp[r][c] - Es[qr]) * a.scale;
      }
    }
    __syncthreads();

    for (int kk = 0; kk < FB; ++kk) {
      const float s0 = Sm[(2 * ty) * PP + kk], s1 = Sm[(2 * ty + 1) * PP + kk];
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        const float kv = Ks[kk * DP + tx + 16 * c];
        dqa[0][c] = fmaf(s0, kv, dqa[0][c]);
        dqa[1][c] = fmaf(s1, kv, dqa[1][c]);
      }
    }
  }

  float* dq = static_cast<float*>(a.dq);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = q0 + 2 * ty + r;
    if (qi >= a.Sq) continue;
#pragma unroll
    for (int c = 0; c < DC; ++c)
      dq[b * a.dq_sb + qi * a.dq_ss + h * a.dq_sh + tx + 16 * c] = dqa[r][c];
  }
}

template <typename Kernel>
cudaError_t launch(Kernel kernel, const Args& a, dim3 grid, int threads, size_t smem,
                   cudaStream_t stream) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, threads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int D>
cudaError_t dkdv(int dtype, const Args& a, int B, cudaStream_t st) {
  if (dtype == 1) {
    const size_t smem = sizeof(bf16) * 6 * BT * (D + 8) + sizeof(float) * 4 * BT;
    return launch(dkdv_mma_kernel<D>, a, dim3((a.Sk + BT - 1) / BT, a.KV, B), NT, smem, st);
  }
  const size_t smem = sizeof(float) * (4 * FB * (D + 1) + 2 * FB * (FB + 1) + 2 * FB);
  return launch(dkdv_f32_kernel<D>, a, dim3((a.Sk + FB - 1) / FB, a.KV, B), FT, smem, st);
}

template <int D>
cudaError_t dq(int dtype, const Args& a, int B, cudaStream_t st) {
  if (dtype == 1) {
    const size_t smem = sizeof(bf16) * 6 * BT * (D + 8);
    return launch(dq_mma_kernel<D>, a, dim3((a.Sq + BT - 1) / BT, a.H, B), NT, smem, st);
  }
  const size_t smem = sizeof(float) * (4 * FB * (D + 1) + FB * (FB + 1) + 2 * FB);
  return launch(dq_f32_kernel<D>, a, dim3((a.Sq + FB - 1) / FB, a.H, B), FT, smem, st);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v, do and the gradients share
// it); D in {64, 128}.  Strides are in elements, in the order batch, seq,
// head; the last dim of every operand is contiguous, and bf16 rows start
// on 16-byte boundaries (checked by the caller).  lse and delta are f32
// [B*H, Sq], contiguous.
extern "C" int flash_attention_bwd_dkdv(
    int dtype, const void* q, const void* k, const void* v, const void* dout,
    const float* lse, const float* delta, void* dk, void* dv,
    int B, int H, int KV, int Sq, int Sk, int D,
    int64_t q_sb, int64_t q_ss, int64_t q_sh,
    int64_t k_sb, int64_t k_ss, int64_t k_sh,
    int64_t v_sb, int64_t v_ss, int64_t v_sh,
    int64_t do_sb, int64_t do_ss, int64_t do_sh,
    int64_t dk_sb, int64_t dk_ss, int64_t dk_sh,
    int64_t dv_sb, int64_t dv_ss, int64_t dv_sh,
    int causal, int q_offset, float scale, void* stream) {
  const Args a{q, k, v, dout, lse, delta, nullptr, dk, dv, H, KV, Sq, Sk,
               q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, do_sb, do_ss, do_sh,
               0, 0, 0, dk_sb, dk_ss, dk_sh, dv_sb, dv_ss, dv_sh, causal, q_offset, scale};
  cudaStream_t st = (cudaStream_t)stream;
  if ((dtype != 0 && dtype != 1) || H % KV) return (int)cudaErrorInvalidValue;
  if (D == 64) return (int)dkdv<64>(dtype, a, B, st);
  if (D == 128) return (int)dkdv<128>(dtype, a, B, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" int flash_attention_bwd_dq(
    int dtype, const void* q, const void* k, const void* v, const void* dout,
    const float* lse, const float* delta, void* dq_out,
    int B, int H, int KV, int Sq, int Sk, int D,
    int64_t q_sb, int64_t q_ss, int64_t q_sh,
    int64_t k_sb, int64_t k_ss, int64_t k_sh,
    int64_t v_sb, int64_t v_ss, int64_t v_sh,
    int64_t do_sb, int64_t do_ss, int64_t do_sh,
    int64_t dq_sb, int64_t dq_ss, int64_t dq_sh,
    int causal, int q_offset, float scale, void* stream) {
  const Args a{q, k, v, dout, lse, delta, dq_out, nullptr, nullptr, H, KV, Sq, Sk,
               q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, do_sb, do_ss, do_sh,
               dq_sb, dq_ss, dq_sh, 0, 0, 0, 0, 0, 0, causal, q_offset, scale};
  cudaStream_t st = (cudaStream_t)stream;
  if ((dtype != 0 && dtype != 1) || H % KV) return (int)cudaErrorInvalidValue;
  if (D == 64) return (int)dq<64>(dtype, a, B, st);
  if (D == 128) return (int)dq<128>(dtype, a, B, st);
  return (int)cudaErrorInvalidValue;
}
