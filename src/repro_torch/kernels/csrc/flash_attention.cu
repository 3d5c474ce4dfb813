// Flash-attention forward for Hopper (sm_90a), in CUDA C++.
//
// Replaces the TPU kernel `_flash_kernel` / `flash_attention_kernel` of
// src/repro/kernels/flash_attention.py (Pallas, grid (B*H, Sq/bq, Sk/bk)
// with the KV axis walked in order and the online-softmax state in VMEM).
//
// What bounds it on the H100: at the serving shape (prefill, B=4, S=512,
// H=32 over KV=2, D=128, bf16, causal) the function moves ~36 MB (q and o
// dominate, K/V are 16x smaller under GQA) and does ~8.6 GFLOP, so the
// card's floor is bytes: ~11 us at 3.35 TB/s against ~9 us of bf16 tensor
// work.  At the training shape (B=2, S=2048) it does ~69 GFLOP, ~70 us at
// 989 TFLOP/s: operations.  What this kernel meets first at both is the
// rate at which L2 feeds K/V tiles to the SMs and the softmax between the
// two products (see PERF.md).
//
// Common to both kernels below:
//   * q, k, v are read in the model layouts [B, Sq, H, D] and [B, Sk, KV, D]
//     through their strides, so the wrapper's head fold costs no copy; the
//     KV head of query head h is h / (H / KV) (GQA without repeating K/V);
//   * the TPU kernel's sequential KV grid axis becomes a loop inside a
//     block over K/V tiles staged in shared memory;
//   * causal: tiles wholly above the diagonal (with q_offset) are skipped,
//     not computed masked as on the TPU;
//   * numerics follow the TPU kernel: scores in f32 times 1/sqrt(D), masked
//     entries set to NEG_INF = -1e30 (not -inf), P rounded to V's dtype
//     before the PV product while l sums the unrounded P, l clamped at
//     1e-30, o = acc / l in q's dtype and lse = m + log(l) in f32.
//
// bf16 (the serving and training path): wgmma, TMA and warp specialisation,
// persistent.  One block per SM walks work items, heaviest causal q tiles
// first.  An item is 64 query rows of two query heads that share a KV head
// (or, with one query head per KV head, 128 rows of one head), so every
// K/V tile is loaded once for both.  A producer warp (its registers cut
// with setmaxnreg) keeps TMA loads in flight through tensor maps over the
// model strides, with 128-byte swizzle: Q into a double buffer, K and V
// tiles of 128 keys into a 2-stage ring whose K and V halves are released
// apart (K after Q K^T, V after P V).  Two consumer warpgroups, 64 rows
// each, run S = Q K^T as wgmma m64n128k16 from shared memory (both operands
// K-major), the online softmax on the accumulators in registers (the scale
// folded into the exponent, 2^x on the special-function unit, masks only on
// tiles that cross the diagonal or the ragged end), and O += P V as wgmma
// with P as register A fragments and V read MN-major from shared memory;
// tile j's softmax runs while tile j - 1's P V is on the tensor cores.
//
// CUDA cores (`flash_fwd_simt_kernel`): f32, and the bf16 head dims the
// tensor-core kernel cannot take.  Products on the CUDA cores (SIMT) in
// f32, one block per (64-row q tile, head, batch row), a 16 x 16 thread grid
// over 64 query rows and 32-row K/V tiles, tiles held in shared memory as
// f32 (the tensor cores' f32 input, TF32, would round the operands).  bf16
// is widened on load, P rounded to bf16 before P V (l sums it unrounded, as
// the tensor-core kernel does) and o rounded on store.
//
// Head dims: the tensor-core kernel is built for a padded head dim DP of 64
// or 128 and takes any bf16 D <= DP with D % 8 == 0, so that TMA's 16-byte
// strides hold.  It reads q, k, v through tensor maps whose first dim is
// the true D, so TMA fills the columns past D with zeros: Q K^T is
// unchanged and the extra columns of P V are zero; the epilogue stores D
// columns.  The CUDA-core kernel is built for DP = 64, 128 and 256 (the
// largest head dim of any config, recurrentgemma-2b's; its tiles take
// ~140 KB of shared memory there) and masks its loads and stores; the
// launcher sends it f32, and bf16 with D % 8 != 0 or 128 < D <= 1024: a
// dispatch by shape between two kernels, not a fallback.  A head dim past
// 256 (up to flash-decode's 1024) runs on the D = 256 build in pieces of
// 256 columns, since a wider build's tiles would not fit shared memory
// (~270 KB at 512): the scores sum over the pieces, reloading the Q and K
// columns of each, and each of ceil(D / 256) blocks per q tile writes one
// 256-column slab of the output, so the scores are computed once per slab.
// The scale is 1/sqrt(D) of the true D (the caller's).
//
// The launcher has a plain C interface (loaded with ctypes) and returns
// the cudaError_t of the launch.

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math_constants.h>
#include <stdint.h>

#include "convert.cuh"
#include "hopper.cuh"
#include "mma_bf16.cuh"

namespace {

using namespace hopper;
using mma::bf16;
using mma::pack_bf16;
using cvt::from_f32;
using cvt::round_to;
using cvt::to_f32;

constexpr float NEG_INF = -1e30f;

// ---------------------------------------------------------------------------
// bf16: warp-specialised wgmma kernel
// ---------------------------------------------------------------------------

constexpr int WS_BM = 64;     // query rows per consumer warpgroup
constexpr int WS_BN = 128;    // keys per K/V tile
constexpr int WS_NST = 2;     // K/V ring stages
constexpr int WS_NT = 384;    // producer warpgroup + two consumer warpgroups
constexpr int QSLAB = WS_BM * 128;   // one [64 rows][64 bf16] slab of a Q tile, bytes
constexpr int KVSLAB = WS_BN * 128;  // one [128 rows][64 bf16] slab of a K or V tile
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

template <int D>
struct WsLayout {
  static constexpr int QTILE = WS_BM * D * 2;        // D / 64 slabs
  static constexpr int KVTILE = WS_BN * D * 2;
  static constexpr int Q = 0;                        // [2 buffers][2 warpgroups] Q tiles
  static constexpr int K = 4 * QTILE;
  static constexpr int V = K + WS_NST * KVTILE;
  // barriers: q_full[2], q_empty[2], k_full[], v_full[], k_empty[], v_empty[]
  static constexpr int BAR = V + WS_NST * KVTILE;
  static constexpr int BYTES = BAR + 8 * (4 + 4 * WS_NST) + 1024;  // + alignment slack
};

// one work item: a q tile of one or two query heads that share a KV head
struct WsWork {
  int b, kvh, h[2], row0[2], valid[2], n_kv[2], n_kv_max;
};

// items in order of decreasing work (causal: the last q tiles first)
__device__ __forceinline__ WsWork ws_work(int item, int units, int n_qt, int KV, int G,
                                          int Sq, int Sk, int causal, int q_offset) {
  WsWork w;
  const int pairs = G >= 2 ? (G + 1) / 2 : 1;
  const int qt = n_qt - 1 - item / units;
  const int u = item % units;
  w.b = u / (KV * pairs);
  w.kvh = (u / pairs) % KV;
  const int pair = u % pairs;
  const int n_kv_all = (Sk + WS_BN - 1) / WS_BN;
  w.n_kv_max = 0;
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    if (G >= 2) {  // two heads, the same 64 rows
      w.h[c] = w.kvh * G + 2 * pair + c;
      w.row0[c] = qt * WS_BM;
      w.valid[c] = 2 * pair + c < G;
    } else {       // one head, 128 rows
      w.h[c] = w.kvh;
      w.row0[c] = qt * 2 * WS_BM + c * WS_BM;
      w.valid[c] = w.row0[c] < Sq;
    }
    int n = n_kv_all;
    if (causal) n = min(n, (q_offset + min(w.row0[c] + WS_BM, Sq) - 1) / WS_BN + 1);
    w.n_kv[c] = w.valid[c] ? n : 0;
    w.n_kv_max = max(w.n_kv_max, w.n_kv[c]);
  }
  return w;
}

// Persistent: block i takes items i, i + gridDim.x, ...; the K/V ring and
// its barrier phases run on across items, so the next item's Q and K/V
// loads overlap this item's last products and its epilogue.
template <int D>
__global__ void __launch_bounds__(WS_NT, 1) flash_fwd_ws_kernel(
    const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
    const __grid_constant__ CUtensorMap vmap,
    bf16* __restrict__ o, float* __restrict__ lse,
    int H, int KV, int Sq, int Sk, int Dt,
    int64_t o_sb, int64_t o_ss, int64_t o_sh,
    int causal, int q_offset, float scale, int units) {
  using L = WsLayout<D>;
  constexpr int NSLAB = D / 64;
  constexpr int NS = WS_BN / 8;  // n-tiles of S (8 keys each)
  constexpr int NO = D / 8;      // n-tiles of O (8 dims each); those at or past Dt are zero
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::BAR);
  uint64_t* q_full = bars;       // per Q buffer
  uint64_t* q_empty = bars + 2;
  uint64_t* k_full = bars + 4;
  uint64_t* v_full = k_full + WS_NST;
  uint64_t* k_empty = v_full + WS_NST;   // K and V stages are freed apart: K after
  uint64_t* v_empty = k_empty + WS_NST;  // Q K^T, V after P V

  const int G = H / KV;
  const int bm = G >= 2 ? WS_BM : 2 * WS_BM;
  const int n_qt = (Sq + bm - 1) / bm;
  const int n_items = n_qt * units;
  if (threadIdx.x == 0) {
    for (int i = 0; i < 2; ++i) {
      mbar_init(q_full + i, 1);
      mbar_init(q_empty + i, 8);  // one arrival per consumer warp
    }
    for (int i = 0; i < WS_NST; ++i) {
      mbar_init(k_full + i, 1);
      mbar_init(v_full + i, 1);
      mbar_init(k_empty + i, 8);
      mbar_init(v_empty + i, 8);
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // producer: one thread keeps the TMA loads in flight
    reg_dealloc<40>();
    if (threadIdx.x == 0) {
      tma_prefetch_map(&qmap);
      tma_prefetch_map(&kmap);
      tma_prefetch_map(&vmap);
      int it = 0;  // K/V tiles loaded so far
      for (int item = blockIdx.x, k = 0; item < n_items; item += gridDim.x, ++k) {
        const WsWork w = ws_work(item, units, n_qt, KV, G, Sq, Sk, causal, q_offset);
        // Q buffer k % 2: free once the Q K^T of item k - 2 are done
        const int qb = k & 1;
        if (k >= 2) mbar_wait(q_empty + qb, ((k >> 1) - 1) & 1);
        mbar_expect_tx(q_full + qb, (w.valid[0] + w.valid[1]) * L::QTILE);
#pragma unroll
        for (int c = 0; c < 2; ++c)
          if (w.valid[c])
            for (int sl = 0; sl < NSLAB; ++sl)
              tma_load_4d(smem + L::Q + (2 * qb + c) * L::QTILE + sl * QSLAB, &qmap,
                          q_full + qb, sl * 64, w.h[c], w.row0[c], w.b);
        for (int j = 0; j < w.n_kv_max; ++j, ++it) {
          const int st = it % WS_NST;
          const uint32_t free_ph = ((it / WS_NST) - 1) & 1;
          if (it >= WS_NST) mbar_wait(k_empty + st, free_ph);
          mbar_expect_tx(k_full + st, L::KVTILE);
          for (int sl = 0; sl < NSLAB; ++sl)
            tma_load_4d(smem + L::K + st * L::KVTILE + sl * KVSLAB, &kmap, k_full + st,
                        sl * 64, w.kvh, j * WS_BN, w.b);
          if (it >= WS_NST) mbar_wait(v_empty + st, free_ph);
          mbar_expect_tx(v_full + st, L::KVTILE);
          for (int sl = 0; sl < NSLAB; ++sl)
            tma_load_4d(smem + L::V + st * L::KVTILE + sl * KVSLAB, &vmap, v_full + st,
                        sl * 64, w.kvh, j * WS_BN, w.b);
        }
      }
    }
  } else {
    // consumers: warpgroup c takes 64 query rows of head w.h[c] of each item
    reg_alloc<232>();
    const int c = wg - 1;
    const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
    const int g = lane / 4, t = lane % 4;
    const float scale2 = scale * LOG2E;  // scores in log2 units: exp2 of them is exp
    float acc[4 * NO];
    float s[4 * NS];          // S of the newest tile; its P in f32 after the softmax
    uint32_t pf[NS / 2][4];   // P of the previous tile as register A fragments (16 keys each)
    float m[2], l[2];         // rows g, g + 8 of the warp

    // S = Q K^T of one tile into s: both operands K-major, 4 k16 steps per
    // 64-dim slab (issued, not waited for)
    auto issue_s = [&](const unsigned char* Qs, int st) {
      const unsigned char* Ks = smem + L::K + st * L::KVTILE;
#pragma unroll
      for (int sl = 0; sl < NSLAB; ++sl)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_m64n128k16_ss(s, desc_sw128(Qs + sl * QSLAB + kk * 32, 16, 1024),
                              desc_sw128(Ks + sl * KVSLAB + kk * 32, 16, 1024), sl | kk);
      wgmma_commit();
    };
    // O += P V: V MN-major ([key][d]), 64-dim slabs LBO apart, 8-key groups
    // SBO apart, a k16 step is 16 rows (issued, not waited for)
    auto issue_pv = [&](int st) {
      const unsigned char* Vs = smem + L::V + st * L::KVTILE;
#pragma unroll
      for (int kk = 0; kk < NS / 2; ++kk) {
        const uint64_t dv = desc_sw128(Vs + kk * 16 * 128, KVSLAB, 1024);
        if constexpr (D == 128) wgmma_m64n128k16_rs_t(acc, pf[kk], dv);
        else wgmma_m64n64k16_rs_t(acc, pf[kk], dv);
      }
      wgmma_commit();
    };
    // scale and mask tile j's scores, update m and l, leave P (f32) in s;
    // element 4 n + e is (row g + 8 (e / 2), key 64 j + 8 n + 2 t + e % 2)
    auto softmax = [&](int j, int qpos0, float (&corr)[2]) {
      const int k0 = j * WS_BN;
      // only tiles that cross the diagonal or the ragged end need masks
      // (the same for the whole warp: its rows are qpos0 - g + [0, 16));
      // the max is taken over the raw scores (scale > 0), the scale folded
      // into the exponent: p = 2^(s scale log2 e - m)
      const bool edge = (causal && k0 + WS_BN - 1 > qpos0 - g) || k0 + WS_BN > Sk;
      if (edge) {
#pragma unroll
        for (int n = 0; n < NS; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int kpos = k0 + n * 8 + 2 * t + (e & 1);
            if (causal && kpos > qpos0 + (e >> 1) * 8) s[4 * n + e] = NEG_INF;
            if (kpos >= Sk) s[4 * n + e] = -CUDART_INF_F;  // ragged edge: p = 0
          }
      }
      float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
      for (int n = 0; n < NS; ++n) {
        mx[0] = fmaxf(mx[0], fmaxf(s[4 * n], s[4 * n + 1]));
        mx[1] = fmaxf(mx[1], fmaxf(s[4 * n + 2], s[4 * n + 3]));
      }
      float m_new[2], ps[2] = {0.f, 0.f};
#pragma unroll
      for (int i = 0; i < 2; ++i) {  // the 4 lanes of a quad share a row
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
        m_new[i] = fmaxf(m[i], mx[i] * scale2);
        corr[i] = ex2(m[i] - m_new[i]);
      }
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = ex2(fmaf(s[4 * n + e], scale2, -m_new[e >> 1]));
          ps[e >> 1] += p;
          s[4 * n + e] = p;
        }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        ps[i] += __shfl_xor_sync(0xffffffffu, ps[i], 1);
        ps[i] += __shfl_xor_sync(0xffffffffu, ps[i], 2);
        l[i] = l[i] * corr[i] + ps[i];  // l sums the unrounded P
        m[i] = m_new[i];
      }
    };
    // P rounded to bf16 (where the TPU kernel rounds it) into the A fragments
    auto pack_p = [&]() {
#pragma unroll
      for (int n = 0; n < NS; ++n) {
        pf[n / 2][(n % 2) * 2] = pack_bf16(s[4 * n], s[4 * n + 1]);
        pf[n / 2][(n % 2) * 2 + 1] = pack_bf16(s[4 * n + 2], s[4 * n + 3]);
      }
    };
    auto release = [&](uint64_t* bar) {
      __syncwarp();
      if (lane == 0) mbar_arrive(bar);
    };

    int it = 0;  // K/V tiles consumed so far
    for (int item = blockIdx.x, k = 0; item < n_items; item += gridDim.x, ++k) {
      const WsWork w = ws_work(item, units, n_qt, KV, G, Sq, Sk, causal, q_offset);
      const int h = c ? w.h[1] : w.h[0], row0 = c ? w.row0[1] : w.row0[0];
      const int n_kv = c ? w.n_kv[1] : w.n_kv[0];  // 0 for a warpgroup without rows
      const int qpos0 = q_offset + row0 + warp * 16 + g;  // rows qpos0, qpos0 + 8
      m[0] = m[1] = NEG_INF;
      l[0] = l[1] = 0.f;
#pragma unroll
      for (int i = 0; i < 4 * NO; ++i) acc[i] = 0.f;
      const int qb = k & 1;
      const unsigned char* Qs = smem + L::Q + (2 * qb + c) * L::QTILE;
      mbar_wait(q_full + qb, (k >> 1) & 1);
      if (n_kv > 0) {
        // tile j's softmax runs while tile j - 1's P V is on the tensor cores
        float corr[2];
        mbar_wait(k_full + it % WS_NST, (it / WS_NST) & 1);
        wgmma_fence();
        issue_s(Qs, it % WS_NST);
        wgmma_wait<0>();
        fence_regs(s);
        release(k_empty + it % WS_NST);
        softmax(0, qpos0, corr);
        pack_p();
        for (int j = 1; j < n_kv; ++j) {
          const int st = (it + j) % WS_NST, pst = (it + j - 1) % WS_NST;
          mbar_wait(k_full + st, ((it + j) / WS_NST) & 1);
          mbar_wait(v_full + pst, ((it + j - 1) / WS_NST) & 1);
          wgmma_fence();
          issue_s(Qs, st);
          issue_pv(pst);
          wgmma_wait<1>();  // S of tile j
          fence_regs(s);
          release(k_empty + st);
          softmax(j, qpos0, corr);
          wgmma_wait<0>();  // P V of tile j - 1
          fence_regs(acc);
#pragma unroll
          for (int kk = 0; kk < NS / 2; ++kk) fence_regs(pf[kk]);
          release(v_empty + pst);
#pragma unroll
          for (int n = 0; n < NO; ++n) {
            acc[4 * n] *= corr[0];
            acc[4 * n + 1] *= corr[0];
            acc[4 * n + 2] *= corr[1];
            acc[4 * n + 3] *= corr[1];
          }
          pack_p();
        }
        release(q_empty + qb);  // every Q K^T of this item is done
        const int pst = (it + n_kv - 1) % WS_NST;
        mbar_wait(v_full + pst, ((it + n_kv - 1) / WS_NST) & 1);
        wgmma_fence();
        issue_pv(pst);
        wgmma_wait<0>();
        fence_regs(acc);
        release(v_empty + pst);
      } else {
        release(q_empty + qb);
      }
      // tiles only the other warpgroup needs
      for (int j = n_kv; j < w.n_kv_max; ++j) {
        const int st = (it + j) % WS_NST;
        mbar_wait(k_full + st, ((it + j) / WS_NST) & 1);
        mbar_wait(v_full + st, ((it + j) / WS_NST) & 1);
        release(k_empty + st);
        release(v_empty + st);
      }
      it += w.n_kv_max;

      if (n_kv > 0) {
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int qi = row0 + warp * 16 + g + i * 8;
          if (qi >= Sq) continue;
          const float ls = fmaxf(l[i], 1e-30f), inv = 1.f / ls;
          bf16* orow = o + w.b * o_sb + qi * o_ss + h * o_sh;
#pragma unroll
          for (int n = 0; n < NO; ++n)
            if (n * 8 < Dt)
              *reinterpret_cast<__nv_bfloat162*>(orow + n * 8 + 2 * t) =
                  __floats2bfloat162_rn(acc[4 * n + 2 * i] * inv, acc[4 * n + 2 * i + 1] * inv);
          if (t == 0) lse[((int64_t)w.b * H + h) * Sq + qi] = m[i] * LN2 + logf(ls);
        }
      }
    }
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

template <typename T, int D>
__global__ void __launch_bounds__(NT) flash_fwd_simt_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ o, float* __restrict__ lse,
    int H, int KV, int Sq, int Sk, int Dt,
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

  // a head dim past the build's D is walked in pieces of D columns: the
  // scores sum over every piece (in column order, as for one piece), and
  // the block writes the output columns of its slab only (blocks of one q
  // tile differ in slab and compute the same scores)
  const int pieces = (Dt + D - 1) / D;
  const int slab = blockIdx.x % pieces;
  const int q0 = (blockIdx.x / pieces) * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int tid = threadIdx.x;
  const int tx = tid % 16;      // column group; the 16 lanes of a half warp
  const int ty = tid / 16;      // row group

  const T* qb = q + b * q_sb + h * q_sh;
  const T* kb = k + b * k_sb + kvh * k_sh;
  const T* vb = v + b * v_sb + kvh * v_sh;

  // columns [d0, d0 + D) of the q tile (of a K tile) into Qs (Ks)
  auto load_q = [&](int d0) {
    for (int idx = tid; idx < BQ * D; idx += NT) {
      const int r = idx / D, d = idx % D;
      const int qi = q0 + r;
      Qs[r * DP + d] = qi < Sq && d0 + d < Dt ? to_f32(qb[qi * q_ss + d0 + d]) : 0.f;
    }
  };
  auto load_k = [&](int k0, int d0) {
    for (int idx = tid; idx < BK * D; idx += NT) {
      const int r = idx / D, d = idx % D;
      const int ki = k0 + r;
      Ks[r * DP + d] = ki < Sk && d0 + d < Dt ? to_f32(kb[ki * k_ss + d0 + d]) : 0.f;
    }
  };

  if (pieces == 1) load_q(0);  // resident for the whole KV walk

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
    float s[TR][TC];
#pragma unroll
    for (int i = 0; i < TR; ++i)
#pragma unroll
      for (int c = 0; c < TC; ++c) s[i][c] = 0.f;
    for (int pc = 0; pc < pieces; ++pc) {
      __syncthreads();  // the previous piece's (tile's) Qs, Ks, Vs, Ps are consumed
      if (pieces > 1) load_q(pc * D);
      load_k(k0, pc * D);
      if (pc == 0) {
        for (int idx = tid; idx < BK * D; idx += NT) {
          const int r = idx / D, d = slab * D + idx % D;
          const int ki = k0 + r;
          Vs[idx] = ki < Sk && d < Dt ? to_f32(vb[ki * v_ss + d]) : 0.f;
        }
      }
      __syncthreads();
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
        ps += p;  // l sums the unrounded p; P V takes p rounded to V's dtype
        Ps[(ty * TR + i) * (BK + 1) + tx + 16 * c] = round_to<T>(p);
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
    T* orow = o + b * o_sb + qi * o_ss + h * o_sh;
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      const int col = slab * D + tx + 16 * c;
      if (col < Dt) orow[col] = from_f32<T>(acc[i][c] / ls);
    }
    if (tx == 0 && slab == 0) lse[((int64_t)b * H + h) * Sq + qi] = m[i] + logf(ls);
  }
}

struct Args {
  const void *q, *k, *v;
  void *o, *lse;
  int H, KV, Sq, Sk, D;  // D: the true head dim (the kernels' is padded)
  int64_t q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, o_sb, o_ss, o_sh;
  int causal, q_offset;
  float scale;
};

template <typename T, int D>
cudaError_t launch_simt(const Args& a, int B, cudaStream_t stream) {
  const int smem = sizeof(float) * (BQ * (D + 1) + BK * (D + 1) + BK * D + BQ * (BK + 1));
  static int cap[64];
  cudaError_t err = hopper::smem_cap((const void*)flash_fwd_simt_kernel<T, D>, smem, cap);
  if (err != cudaSuccess) return err;
  const int pieces = (a.D + D - 1) / D;  // > 1 only on the D = 256 build
  dim3 grid((a.Sq + BQ - 1) / BQ * pieces, a.H, B);
  flash_fwd_simt_kernel<T, D><<<grid, NT, smem, stream>>>(
      (const T*)a.q, (const T*)a.k, (const T*)a.v, (T*)a.o, (float*)a.lse,
      a.H, a.KV, a.Sq, a.Sk, a.D, a.q_sb, a.q_ss, a.q_sh, a.k_sb, a.k_ss, a.k_sh,
      a.v_sb, a.v_ss, a.v_sh, a.o_sb, a.o_ss, a.o_sh, a.causal, a.q_offset, a.scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_bf16(const Args& a, int B, cudaStream_t stream) {
  CUtensorMap qmap, kmap, vmap;
  if (!encode_map(&qmap, a.q, B, a.Sq, a.H, a.D, a.q_sb, a.q_ss, a.q_sh, WS_BM) ||
      !encode_map(&kmap, a.k, B, a.Sk, a.KV, a.D, a.k_sb, a.k_ss, a.k_sh, WS_BN) ||
      !encode_map(&vmap, a.v, B, a.Sk, a.KV, a.D, a.v_sb, a.v_ss, a.v_sh, WS_BN))
    return cudaErrorInvalidValue;
  constexpr int smem = WsLayout<D>::BYTES;
  static int cap[64];
  cudaError_t err = hopper::smem_cap((const void*)flash_fwd_ws_kernel<D>, smem, cap);
  if (err != cudaSuccess) return err;
  const int G = a.H / a.KV;
  const int units = B * a.KV * (G >= 2 ? (G + 1) / 2 : 1);
  const int bm = G >= 2 ? WS_BM : 2 * WS_BM;
  const int n_items = ((a.Sq + bm - 1) / bm) * units;
  int n_sm = 0;
  err = sm_count(n_sm);
  if (err != cudaSuccess) return err;
  flash_fwd_ws_kernel<D><<<min(n_items, n_sm), WS_NT, smem, stream>>>(
      qmap, kmap, vmap, (bf16*)a.o, (float*)a.lse, a.H, a.KV, a.Sq, a.Sk, a.D,
      a.o_sb, a.o_ss, a.o_sh, a.causal, a.q_offset, a.scale, units);
  return cudaGetLastError();
}

// the CUDA-core kernel's build for head dim D: 64, 128 or 256, the last
// walking a head dim up to 1024 in pieces of 256
template <typename T>
cudaError_t simt_by_dim(const Args& a, int B, cudaStream_t st) {
  if (a.D <= 64) return launch_simt<T, 64>(a, B, st);
  if (a.D <= 128) return launch_simt<T, 128>(a, B, st);
  return launch_simt<T, 256>(a, B, st);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and o share it); 1 <= D <= 1024.
// bf16 with D % 8 == 0 and D <= 128 runs on the tensor cores (the D = 64
// build up to 64, the D = 128 build above), and its rows must start on
// 16-byte boundaries (checked by the caller); every other case on the CUDA
// cores (builds D = 64, 128, 256; past 256 the D = 256 build in pieces).
// Strides are in elements; the last dim
// of every operand is contiguous.
extern "C" int flash_attention_fwd(
    int dtype, const void* q, const void* k, const void* v, void* o, void* lse,
    int B, int H, int KV, int Sq, int Sk, int D,
    int64_t q_sb, int64_t q_ss, int64_t q_sh,
    int64_t k_sb, int64_t k_ss, int64_t k_sh,
    int64_t v_sb, int64_t v_ss, int64_t v_sh,
    int64_t o_sb, int64_t o_ss, int64_t o_sh,
    int causal, int q_offset, float scale, void* stream) {
  const Args a{q, k, v, o, lse, H, KV, Sq, Sk, D, q_sb, q_ss, q_sh, k_sb, k_ss, k_sh,
               v_sb, v_ss, v_sh, o_sb, o_ss, o_sh, causal, q_offset, scale};
  cudaStream_t st = (cudaStream_t)stream;
  if (D < 1 || D > 1024) return (int)cudaErrorInvalidValue;
  if (dtype == 0) return (int)simt_by_dim<float>(a, B, st);
  if (dtype != 1) return (int)cudaErrorInvalidValue;
  if (D % 8 || D > 128) return (int)simt_by_dim<bf16>(a, B, st);
  return (int)(D > 64 ? launch_bf16<128>(a, B, st) : launch_bf16<64>(a, B, st));
}
