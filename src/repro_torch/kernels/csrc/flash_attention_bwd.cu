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
// 0.03 ms of bytes).  Both bf16 passes are therefore built the way the
// forward is: a producer warp keeps TMA loads in flight through tensor maps
// over the model strides (128-byte swizzle), and two consumer warpgroups
// run every product as wgmma, so the tensor cores are fed without the
// ldmatrix and register traffic of mma.sync.
//
// bf16 dK/dV (`dkdv_ws_kernel`): a block owns 128 keys of one KV head (64
// per consumer warpgroup), loads K and V once, and streams the (Q, dO)
// tiles of 64 query rows, with their lse and delta rows, through a 3-stage
// ring, for its query heads and the q tiles from the causal diagonal on.
// Per step, S^T = K Q^T and dP^T = V dO^T are wgmma from shared memory
// (both operands K-major), P^T and dS^T are formed on the accumulators and
// repacked as register A fragments, and dV += P^T dO, dK += dS^T Q are
// wgmma with dO and Q read MN-major from the same tiles.  The two
// warpgroups take turns to issue their S^T and dP^T products (two named
// barriers), so that one's element-wise work runs while the other's
// products are on the tensor cores.  What held the
// mma.sync version back was the spread of its work: one block per (key
// tile, KV head, batch row) made 128 blocks for 132 SMs at the training
// shape, block 0 walking 512 (head, q tile) steps and the last 16.  Here
// the G query heads of a KV head are split over the `split` blocks of a
// thread-block cluster (block r takes heads r, r + split, ...), so the
// card gets split times as many blocks, launched heaviest key tiles first.
// Each block keeps its heads' dK and dV in f32 registers, writes them to
// its shared memory, and after a cluster barrier block r sums rows
// [r * 128 / split, ...) of every block's partial through distributed
// shared memory in rank order and rounds once to k's dtype: the GQA group
// sum stays in f32, in a fixed order, with no atomics.
//
// bf16 dQ (`dq_ws_kernel`): persistent, one block per SM walking work items
// heaviest causal q tiles first, as the forward does.  An item is 64 query
// rows of two query heads that share a KV head (or, with one query head
// per KV head, 128 rows of one head), so every K/V tile is loaded once for
// both.  K and V tiles of 128 keys come into a 2-stage ring, Q and dO
// into one buffer (the ring and a second buffer do not both fit in shared
// memory); the producer puts an item's first K/V tiles into the ring before
// its Q and dO, whose buffer frees only when the previous item is done.
// Per tile, S = Q K^T and dP = dO V^T are wgmma m64n128 from shared memory,
// dS is formed in registers from lse and delta (loaded once per item), and
// dQ += dS K is wgmma with dS as register A fragments and K read MN-major;
// tile j's S and dP are issued before tile j - 1's dQ product is waited
// for.  128-key tiles beat 64-key ones with a 3-stage ring and a double
// buffer: wider products and half the barrier round trips outweigh the
// wait for Q and dO at each item's start.
//
// What is left between these kernels and the card (PERF.md has the
// numbers): dQ recomputes S and dP, so the pair does seven products where
// a fused backward does five; fusing dQ into the dK/dV pass would sum each
// query row's dQ across blocks, which needs atomics or a second pass.  The
// S^T and dP^T products have 64-wide N (a 64-row Q tile: a wider one
// leaves no registers for dK and dV), which keeps them near the
// shared-memory rate, and registers leave no room to issue a step's
// products ahead of the last step's element-wise work within a warpgroup.
//
// Common to both passes:
//   * q, k, v, do are read in the model layouts [B, S, H|KV, D] through
//     their strides; dq is written [B, Sq, H, D], dk and dv [B, Sk, KV, D];
//     lse and delta are [B*H, Sq], b-major, as the forward writes lse;
//   * any Sq and Sk: rows past either end are loaded as zeros and their p
//     is set to 0; tiles wholly above the causal diagonal are skipped;
//   * numerics follow the TPU kernels: scores in f32 times 1/sqrt(D),
//     masked p = 0, P rounded to do's dtype for dV, dS rounded to q's dtype
//     for dK and to k's dtype for dQ, f32 sums; p = 2^(s scale log2 e - lse
//     log2 e) on the special-function unit;
//   * head dims: the tensor-core pair is built for a padded D of 64 or 128,
//     taking any bf16 D up to it with D % 8 == 0.  The tensor maps' first
//     dim is the true D, so TMA fills the columns past it with zeros and
//     the stores write D columns; the CUDA-core pair (below) masks its
//     loads and stores;
//   * bitwise repeatable: no atomics; every sum runs in a fixed order.
//
// CUDA cores (`dkdv_simt_kernel`, `dq_simt_kernel`): f32, since TF32 would
// round the operands, and the bf16 head dims the tensor-core pair cannot
// take (D % 8 != 0, or 128 < D <= 1024).  The same passes in f32 SIMT: one
// block per (32-key tile, KV head, batch row) walking its group's query
// heads, and one per (32-row q tile, head, batch row); built for D = 64,
// 128 and 256 (~140 KB of shared memory at 256), a head dim past 256 walked
// in pieces of 256 columns with one block per output slab (below).  bf16 is widened on load,
// P and dS rounded to bf16 where the TPU kernels round them, and the
// gradients rounded on store; the GQA group sum of dK and dV stays in f32.
//
// The launchers have a plain C interface (loaded with ctypes) and return
// the cudaError_t of the launch.

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
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
constexpr float LOG2E = 1.4426950408889634f;

struct Args {
  const void *q, *k, *v, *dout;
  const float *lse, *delta;
  void *dq, *dk, *dv;
  int H, KV, Sq, Sk, D;  // D: the true head dim (the kernels' is padded)
  int64_t q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, do_sb, do_ss, do_sh;
  int64_t dq_sb, dq_ss, dq_sh, dk_sb, dk_ss, dk_sh, dv_sb, dv_ss, dv_sh;
  int causal, q_offset;
  float scale;
};

// the first q tile (of `bq` rows) that holds a query at or past key k0
__device__ __forceinline__ int first_q_tile(int causal, int q_offset, int k0, int bq) {
  return causal ? max(0, (k0 - q_offset) / bq) : 0;
}

// the number of kv tiles (of `bk` keys) that the queries [q0, q0 + bq) see
__device__ __forceinline__ int kv_tiles(const Args& a, int q0, int bq, int bk) {
  int n = (a.Sk + bk - 1) / bk;
  if (a.causal) n = min(n, (a.q_offset + min(q0 + bq, a.Sq) - 1) / bk + 1);
  return n;
}

// ---------------------------------------------------------------------------
// bf16: warp-specialised wgmma kernels
// ---------------------------------------------------------------------------

constexpr int WS_NT = 384;   // producer warpgroup + two consumer warpgroups
constexpr int BM = 64;       // query rows of a streamed (dK/dV) or owned (dQ) tile
constexpr int QSLAB = BM * 128;  // one [64 rows][64 bf16] slab of a Q or dO tile, bytes

// dK/dV: 128 keys per block, a 3-stage ring of (Q, dO, lse, delta) steps
constexpr int KV_BN = 128;
constexpr int KV_NST = 3;
constexpr int KSLAB = KV_BN * 128;

template <int D>
struct DkdvLayout {
  static constexpr int KTILE = KV_BN * D * 2;
  static constexpr int QTILE = BM * D * 2;
  static constexpr int K = 0;
  static constexpr int V = K + KTILE;
  static constexpr int Q = V + KTILE;                 // [stage] Q tiles
  static constexpr int DO = Q + KV_NST * QTILE;       // [stage] dO tiles
  static constexpr int LSE = DO + KV_NST * QTILE;     // [stage][64] f32 lse * log2 e
  static constexpr int DEL = LSE + KV_NST * BM * 4;   // [stage][64] f32 delta
  static constexpr int RING_END = DEL + KV_NST * BM * 4;
  // after the last step the same bytes hold the block's f32 dK and dV
  // partials, [2][128 keys][LDR], for the cluster's sum
  static constexpr int LDR = D + 8;
  static constexpr int RED_END = 2 * KV_BN * LDR * 4;
  static constexpr int BAR = RING_END > RED_END ? RING_END : RED_END;
  // barriers: kv_full, full[], empty[]
  static constexpr int BYTES = BAR + 8 * (1 + 2 * KV_NST) + 1024;  // + alignment slack
};

// One block per (128-key tile, KV head, batch row, rank in the cluster),
// heaviest key tiles first; see the note at the top of the file.
template <int D>
__global__ void __launch_bounds__(WS_NT, 1) dkdv_ws_kernel(
    const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
    const __grid_constant__ CUtensorMap vmap, const __grid_constant__ CUtensorMap dmap,
    const float* __restrict__ lse, const float* __restrict__ delta,
    bf16* __restrict__ dk, bf16* __restrict__ dv,
    int H, int KV, int Sq, int Sk, int Dt,
    int64_t dk_sb, int64_t dk_ss, int64_t dk_sh, int64_t dv_sb, int64_t dv_ss, int64_t dv_sh,
    int causal, int q_offset, float scale, int units, int split) {
  using L = DkdvLayout<D>;
  constexpr int NSLAB = D / 64;
  constexpr int NQ = BM / 8;   // n-tiles of S^T (8 queries each)
  constexpr int ND = D / 8;    // n-tiles of dK and dV (8 dims each)
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::BAR);
  uint64_t* kv_full = bars;
  uint64_t* full = bars + 1;          // per stage: Q, dO (TMA) and lse, delta (32 lanes)
  uint64_t* empty = full + KV_NST;    // per stage: one arrival per consumer warp

  const int rank = blockIdx.x % split;
  const int item = blockIdx.x / split;
  const int k0 = (item / units) * KV_BN;
  const int b = (item % units) / KV, kvh = item % KV;
  const int G = H / KV;
  const int n_q = (Sq + BM - 1) / BM;
  const int i0 = first_q_tile(causal, q_offset, k0, BM);
  const int per_head = max(0, n_q - i0);
  const int n_heads = rank < G ? (G - rank + split - 1) / split : 0;  // rank, rank + split, ...
  const int n_it = n_heads * per_head;  // (query head, q tile) steps

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int i = 0; i < KV_NST; ++i) {
      mbar_init(full + i, 32);
      mbar_init(empty + i, 8);
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // producer: lane 0 of warp 0 issues the TMA loads, its 32 lanes copy
    // the step's lse (times log2 e) and delta rows
    reg_dealloc<40>();
    if (threadIdx.x < 32) {
      const int lane = threadIdx.x;
      if (lane == 0) {
        tma_prefetch_map(&qmap);
        tma_prefetch_map(&dmap);
        mbar_expect_tx(kv_full, 2 * L::KTILE);
        for (int sl = 0; sl < NSLAB; ++sl) {
          tma_load_4d(smem + L::K + sl * KSLAB, &kmap, kv_full, sl * 64, kvh, k0, b);
          tma_load_4d(smem + L::V + sl * KSLAB, &vmap, kv_full, sl * 64, kvh, k0, b);
        }
      }
      for (int it = 0; it < n_it; ++it) {
        const int st = it % KV_NST;
        if (it >= KV_NST) mbar_wait(empty + st, ((it / KV_NST) - 1) & 1);
        const int h = kvh * G + rank + split * (it / per_head);
        const int q0 = (i0 + it % per_head) * BM;
        const int64_t row = ((int64_t)b * H + h) * Sq + q0;
        float* ls = reinterpret_cast<float*>(smem + L::LSE) + st * BM;
        float* es = reinterpret_cast<float*>(smem + L::DEL) + st * BM;
        for (int r = lane; r < BM; r += 32) {
          const bool ok = q0 + r < Sq;
          ls[r] = ok ? lse[row + r] * LOG2E : 0.f;
          es[r] = ok ? delta[row + r] : 0.f;
        }
        if (lane == 0) {
          mbar_expect_tx(full + st, 2 * L::QTILE);
          for (int sl = 0; sl < NSLAB; ++sl) {
            tma_load_4d(smem + L::Q + st * L::QTILE + sl * QSLAB, &qmap, full + st, sl * 64, h,
                        q0, b);
            tma_load_4d(smem + L::DO + st * L::QTILE + sl * QSLAB, &dmap, full + st, sl * 64, h,
                        q0, b);
          }
        } else {
          mbar_arrive(full + st);
        }
      }
    }
  } else {
    // consumers: warpgroup c owns keys k0 + 64 c .. + 63
    reg_alloc<232>();
    const int c = wg - 1;
    const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
    const int g = lane / 4, t = lane % 4;
    const float scale2 = scale * LOG2E;
    const int kw0 = k0 + 64 * c;              // this warpgroup's first key
    const int krow = kw0 + warp * 16 + g;     // keys of accumulator rows g and g + 8
    const unsigned char* Ks = smem + L::K + c * 64 * 128;  // its 64 rows of each slab
    const unsigned char* Vs = smem + L::V + c * 64 * 128;
    float dka[4 * ND], dva[4 * ND];
#pragma unroll
    for (int i = 0; i < 4 * ND; ++i) dka[i] = dva[i] = 0.f;
    uint32_t pf[NQ / 2][4], sf[NQ / 2][4];  // P^T, dS^T as A fragments over 16 queries
    auto release = [&](uint64_t* bar) {
      __syncwarp();
      if (lane == 0) mbar_arrive(bar);
    };

    mbar_wait(kv_full, 0);
    if (c == 1) named_arrive(2, 256);  // warpgroup 0 issues first
    for (int it = 0; it < n_it; ++it) {
      const int st = it % KV_NST;
      const int q0 = (i0 + it % per_head) * BM;
      mbar_wait(full + st, (it / KV_NST) & 1);
      named_sync(2 + c, 256);  // this warpgroup's turn to issue
      const int qlast = q_offset + min(q0 + BM, Sq) - 1;  // the tile's last query position
      if (causal && kw0 > qlast) {  // every key of this warpgroup is past every query
        named_arrive(3 - c, 256);
        release(empty + st);
        continue;
      }
      const unsigned char* Qs = smem + L::Q + st * L::QTILE;
      const unsigned char* Ds = smem + L::DO + st * L::QTILE;
      const float* Ls = reinterpret_cast<const float*>(smem + L::LSE) + st * BM;
      const float* Es = reinterpret_cast<const float*>(smem + L::DEL) + st * BM;

      // S^T = K Q^T and dP^T = V dO^T: 64 keys x 64 queries, K-major operands
      float sa[4 * NQ], dpa[4 * NQ];
      wgmma_fence();
#pragma unroll
      for (int sl = 0; sl < NSLAB; ++sl)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_m64n64k16_ss(sa, desc_sw128(Ks + sl * KSLAB + kk * 32, 16, 1024),
                             desc_sw128(Qs + sl * QSLAB + kk * 32, 16, 1024), sl | kk);
#pragma unroll
      for (int sl = 0; sl < NSLAB; ++sl)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_m64n64k16_ss(dpa, desc_sw128(Vs + sl * KSLAB + kk * 32, 16, 1024),
                             desc_sw128(Ds + sl * QSLAB + kk * 32, 16, 1024), sl | kk);
      wgmma_commit();
      named_arrive(3 - c, 256);  // the other warpgroup's turn
      wgmma_wait<0>();
      fence_regs(sa);
      fence_regs(dpa);

      // P^T and dS^T; element 4 n + e is (key krow + 8 (e / 2), query
      // q0 + 8 n + 2 t + e % 2); masks only on tiles that cross the
      // diagonal or a ragged end
      const bool edge = (causal && kw0 + 63 > q_offset + q0) || q0 + BM > Sq || kw0 + 64 > Sk;
#pragma unroll
      for (int n = 0; n < NQ; ++n) {
        const float2 l2 = *reinterpret_cast<const float2*>(Ls + 8 * n + 2 * t);
        const float2 e2 = *reinterpret_cast<const float2*>(Es + 8 * n + 2 * t);
        float p[4], ds[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float pe = ex2(fmaf(sa[4 * n + e], scale2, -((e & 1) ? l2.y : l2.x)));
          if (edge) {
            const int kpos = krow + (e >> 1) * 8;
            const int qi = q0 + 8 * n + 2 * t + (e & 1);
            if ((causal && kpos > q_offset + qi) || qi >= Sq || kpos >= Sk) pe = 0.f;
          }
          p[e] = pe;
          ds[e] = pe * (dpa[4 * n + e] - ((e & 1) ? e2.y : e2.x)) * scale;
        }
        pf[n / 2][(n % 2) * 2] = pack_bf16(p[0], p[1]);
        pf[n / 2][(n % 2) * 2 + 1] = pack_bf16(p[2], p[3]);
        sf[n / 2][(n % 2) * 2] = pack_bf16(ds[0], ds[1]);
        sf[n / 2][(n % 2) * 2 + 1] = pack_bf16(ds[2], ds[3]);
      }

      // dV += P^T dO and dK += dS^T Q: dO and Q MN-major ([query][d]),
      // 64-dim slabs QSLAB apart, a k16 step is 16 rows
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < NQ / 2; ++kk) {
        const uint64_t bdo = desc_sw128(Ds + kk * 16 * 128, QSLAB, 1024);
        const uint64_t bq = desc_sw128(Qs + kk * 16 * 128, QSLAB, 1024);
        if constexpr (D == 128) {
          wgmma_m64n128k16_rs_t(dva, pf[kk], bdo);
          wgmma_m64n128k16_rs_t(dka, sf[kk], bq);
        } else {
          wgmma_m64n64k16_rs_t(dva, pf[kk], bdo);
          wgmma_m64n64k16_rs_t(dka, sf[kk], bq);
        }
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dva);
      fence_regs(dka);
#pragma unroll
      for (int kk = 0; kk < NQ / 2; ++kk) {
        fence_regs(pf[kk]);
        fence_regs(sf[kk]);
      }
      release(empty + st);
    }

    if (c == 0) named_sync(2, 256);  // warpgroup 1's last turn
    // both warpgroups are done with the ring and K, V: their bytes take
    // the block's partial dK and dV
    named_sync(1, 256);
    float* red = reinterpret_cast<float*>(smem);
    const int r0 = 64 * c + warp * 16 + g;
#pragma unroll
    for (int n = 0; n < ND; ++n)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = r0 + 8 * i;
        *reinterpret_cast<float2*>(red + r * L::LDR + 8 * n + 2 * t) =
            make_float2(dka[4 * n + 2 * i], dka[4 * n + 2 * i + 1]);
        *reinterpret_cast<float2*>(red + (KV_BN + r) * L::LDR + 8 * n + 2 * t) =
            make_float2(dva[4 * n + 2 * i], dva[4 * n + 2 * i + 1]);
      }
  }
  cluster_sync();  // every block of the cluster has its partial in shared memory
  if (wg > 0) {
    // block `rank` sums its share of the rows over the cluster, in rank order
    const float* red = reinterpret_cast<const float*>(smem);
    const int rows = KV_BN / split;
    constexpr int C4 = D / 4;
    for (int idx = threadIdx.x - 128; idx < 2 * rows * C4; idx += 256) {
      const int which = idx / (rows * C4);  // 0: dK, 1: dV
      const int row = rank * rows + (idx / C4) % rows;
      const int col = (idx % C4) * 4;
      const int key = k0 + row;
      if (key >= Sk || col >= Dt) continue;
      const float* src = red + (which * KV_BN + row) * L::LDR + col;
      float4 acc = *cluster_map(reinterpret_cast<const float4*>(src), 0);
      for (int r = 1; r < split; ++r) {
        const float4 x = *cluster_map(reinterpret_cast<const float4*>(src), r);
        acc.x += x.x;
        acc.y += x.y;
        acc.z += x.z;
        acc.w += x.w;
      }
      bf16* dst = which ? dv + b * dv_sb + key * dv_ss + kvh * dv_sh
                        : dk + b * dk_sb + key * dk_ss + kvh * dk_sh;
      uint2 out;
      out.x = pack_bf16(acc.x, acc.y);
      out.y = pack_bf16(acc.z, acc.w);
      *reinterpret_cast<uint2*>(dst + col) = out;
    }
  }
  cluster_sync();  // no block leaves while another reads its shared memory
}

// dQ: 128-key K/V tiles in a 2-stage ring, one Q and dO buffer
constexpr int DQ_BN = 128;
constexpr int DQ_NST = 2;
constexpr int DQ_KVSLAB = DQ_BN * 128;

template <int D>
struct DqLayout {
  static constexpr int QTILE = BM * D * 2;
  static constexpr int KVTILE = DQ_BN * D * 2;
  static constexpr int Q = 0;                  // [2 warpgroups] Q tiles
  static constexpr int DO = Q + 2 * QTILE;     // the same for dO
  static constexpr int K = DO + 2 * QTILE;
  static constexpr int V = K + DQ_NST * KVTILE;
  // barriers: q_full, q_empty, kv_full[], kv_empty[]
  static constexpr int BAR = V + DQ_NST * KVTILE;
  static constexpr int BYTES = BAR + 8 * (2 + 2 * DQ_NST) + 1024;  // + alignment slack
};
static_assert(DqLayout<128>::BYTES <= 232448, "dQ shared memory exceeds the H100's 227 KB");

// one work item: a q tile of one or two query heads that share a KV head
struct DqWork {
  int b, kvh, h[2], row0[2], valid[2], n_kv[2], n_kv_max;
};

// items in order of decreasing work (causal: the last q tiles first)
__device__ __forceinline__ DqWork dq_work(int item, int units, int n_qt, int KV, int G,
                                          int Sq, int Sk, int causal, int q_offset) {
  DqWork w;
  const int pairs = G >= 2 ? (G + 1) / 2 : 1;
  const int qt = n_qt - 1 - item / units;
  const int u = item % units;
  w.b = u / (KV * pairs);
  w.kvh = (u / pairs) % KV;
  const int pair = u % pairs;
  const int n_kv_all = (Sk + DQ_BN - 1) / DQ_BN;
  w.n_kv_max = 0;
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    if (G >= 2) {  // two heads, the same 64 rows
      w.h[c] = w.kvh * G + 2 * pair + c;
      w.row0[c] = qt * BM;
      w.valid[c] = 2 * pair + c < G;
    } else {       // one head, 128 rows
      w.h[c] = w.kvh;
      w.row0[c] = qt * 2 * BM + c * BM;
      w.valid[c] = w.row0[c] < Sq;
    }
    int n = n_kv_all;
    if (causal) n = min(n, (q_offset + min(w.row0[c] + BM, Sq) - 1) / DQ_BN + 1);
    w.n_kv[c] = w.valid[c] ? n : 0;
    w.n_kv_max = max(w.n_kv_max, w.n_kv[c]);
  }
  return w;
}

// Persistent: block i takes items i, i + gridDim.x, ...; the K/V ring and
// its barrier phases run on across items.
template <int D>
__global__ void __launch_bounds__(WS_NT, 1) dq_ws_kernel(
    const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
    const __grid_constant__ CUtensorMap vmap, const __grid_constant__ CUtensorMap dmap,
    const float* __restrict__ lse, const float* __restrict__ delta, bf16* __restrict__ dq,
    int H, int KV, int Sq, int Sk, int Dt, int64_t dq_sb, int64_t dq_ss, int64_t dq_sh,
    int causal, int q_offset, float scale, int units) {
  using L = DqLayout<D>;
  constexpr int NSLAB = D / 64;
  constexpr int NS = DQ_BN / 8;  // n-tiles of S (8 keys each)
  constexpr int NO = D / 8;      // n-tiles of dQ (8 dims each)
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::BAR);
  uint64_t* q_full = bars;
  uint64_t* q_empty = bars + 1;
  uint64_t* kv_full = bars + 2;
  uint64_t* kv_empty = kv_full + DQ_NST;

  const int G = H / KV;
  const int bm = G >= 2 ? BM : 2 * BM;
  const int n_qt = (Sq + bm - 1) / bm;
  const int n_items = n_qt * units;
  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    mbar_init(q_empty, 8);  // one arrival per consumer warp
    for (int i = 0; i < DQ_NST; ++i) {
      mbar_init(kv_full + i, 1);
      mbar_init(kv_empty + i, 8);
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
      tma_prefetch_map(&dmap);
      tma_prefetch_map(&kmap);
      tma_prefetch_map(&vmap);
      int it = 0;  // K/V tiles loaded so far
      for (int item = blockIdx.x, k = 0; item < n_items; item += gridDim.x, ++k) {
        const DqWork w = dq_work(item, units, n_qt, KV, G, Sq, Sk, causal, q_offset);
        // the item's first K/V tiles go into the ring before its Q/dO, whose
        // buffer frees only when the previous item's products are done
        auto load_kv = [&](int j) {
          const int st = (it + j) % DQ_NST;
          if (it + j >= DQ_NST) mbar_wait(kv_empty + st, (((it + j) / DQ_NST) - 1) & 1);
          mbar_expect_tx(kv_full + st, 2 * L::KVTILE);
          for (int sl = 0; sl < NSLAB; ++sl) {
            tma_load_4d(smem + L::K + st * L::KVTILE + sl * DQ_KVSLAB, &kmap, kv_full + st,
                        sl * 64, w.kvh, j * DQ_BN, w.b);
            tma_load_4d(smem + L::V + st * L::KVTILE + sl * DQ_KVSLAB, &vmap, kv_full + st,
                        sl * 64, w.kvh, j * DQ_BN, w.b);
          }
        };
        const int pre = min(DQ_NST, w.n_kv_max);
        for (int j = 0; j < pre; ++j) load_kv(j);
        if (k >= 1) mbar_wait(q_empty, (k - 1) & 1);
        mbar_expect_tx(q_full, (w.valid[0] + w.valid[1]) * 2 * L::QTILE);
#pragma unroll
        for (int c = 0; c < 2; ++c)
          if (w.valid[c])
            for (int sl = 0; sl < NSLAB; ++sl) {
              tma_load_4d(smem + L::Q + c * L::QTILE + sl * QSLAB, &qmap, q_full, sl * 64,
                          w.h[c], w.row0[c], w.b);
              tma_load_4d(smem + L::DO + c * L::QTILE + sl * QSLAB, &dmap, q_full, sl * 64,
                          w.h[c], w.row0[c], w.b);
            }
        for (int j = pre; j < w.n_kv_max; ++j) load_kv(j);
        it += w.n_kv_max;
      }
    }
  } else {
    // consumers: warpgroup c takes 64 query rows of head w.h[c] of each item
    reg_alloc<232>();
    const int c = wg - 1;
    const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
    const int g = lane / 4, t = lane % 4;
    const float scale2 = scale * LOG2E;
    float acc[4 * NO];
    uint32_t sf[NS / 2][4] = {};  // dS of the newest tile as A fragments (16 keys each)
    auto release = [&](uint64_t* bar) {
      __syncwarp();
      if (lane == 0) mbar_arrive(bar);
    };

    int it = 0;  // K/V tiles consumed so far
    for (int item = blockIdx.x, k = 0; item < n_items; item += gridDim.x, ++k) {
      const DqWork w = dq_work(item, units, n_qt, KV, G, Sq, Sk, causal, q_offset);
      const int h = c ? w.h[1] : w.h[0], row0 = c ? w.row0[1] : w.row0[0];
      const int n_kv = c ? w.n_kv[1] : w.n_kv[0];  // 0 for a warpgroup without rows
      const int qpos0 = q_offset + row0 + warp * 16 + g;  // rows qpos0, qpos0 + 8
      float lse2[2] = {0.f, 0.f}, del[2] = {0.f, 0.f};
      if (n_kv > 0) {
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int qi = min(row0 + warp * 16 + g + 8 * i, Sq - 1);
          const int64_t idx = ((int64_t)w.b * H + h) * Sq + qi;
          lse2[i] = lse[idx] * LOG2E;
          del[i] = delta[idx];
        }
      }
#pragma unroll
      for (int i = 0; i < 4 * NO; ++i) acc[i] = 0.f;
      const unsigned char* Qs = smem + L::Q + c * L::QTILE;
      const unsigned char* Ds = smem + L::DO + c * L::QTILE;
      mbar_wait(q_full, k & 1);
      for (int j = 0; j < n_kv; ++j) {
        const int st = (it + j) % DQ_NST;
        mbar_wait(kv_full + st, ((it + j) / DQ_NST) & 1);
        const unsigned char* Ks = smem + L::K + st * L::KVTILE;
        const unsigned char* Vs = smem + L::V + st * L::KVTILE;
        // S = Q K^T and dP = dO V^T: 64 rows x 128 keys, K-major operands
        float sa[4 * NS], dpa[4 * NS];
        wgmma_fence();
#pragma unroll
        for (int sl = 0; sl < NSLAB; ++sl)
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            wgmma_m64n128k16_ss(sa, desc_sw128(Qs + sl * QSLAB + kk * 32, 16, 1024),
                                desc_sw128(Ks + sl * DQ_KVSLAB + kk * 32, 16, 1024), sl | kk);
#pragma unroll
        for (int sl = 0; sl < NSLAB; ++sl)
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            wgmma_m64n128k16_ss(dpa, desc_sw128(Ds + sl * QSLAB + kk * 32, 16, 1024),
                                desc_sw128(Vs + sl * DQ_KVSLAB + kk * 32, 16, 1024), sl | kk);
        wgmma_commit();
        wgmma_wait<0>();  // these two, and tile j - 1's dQ product
        fence_regs(sa);
        fence_regs(dpa);
        fence_regs(acc);
#pragma unroll
        for (int kk = 0; kk < NS / 2; ++kk) fence_regs(sf[kk]);
        if (j > 0) release(kv_empty + (it + j - 1) % DQ_NST);

        // dS; element 4 n + e is (row g + 8 (e / 2), key 128 j + 8 n + 2 t +
        // e % 2); masks only on tiles that cross the diagonal or the ragged
        // end (the same for the whole warp: its rows are qpos0 - g + [0, 16))
        const int k0 = j * DQ_BN;
        const bool edge = (causal && k0 + DQ_BN - 1 > qpos0 - g) || k0 + DQ_BN > Sk;
#pragma unroll
        for (int n = 0; n < NS; ++n) {
          float ds[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = e >> 1;
            float pe = ex2(fmaf(sa[4 * n + e], scale2, -lse2[i]));
            if (edge) {
              const int kpos = k0 + n * 8 + 2 * t + (e & 1);
              if ((causal && kpos > qpos0 + 8 * i) || kpos >= Sk) pe = 0.f;
            }
            ds[e] = pe * (dpa[4 * n + e] - del[i]) * scale;
          }
          sf[n / 2][(n % 2) * 2] = pack_bf16(ds[0], ds[1]);
          sf[n / 2][(n % 2) * 2 + 1] = pack_bf16(ds[2], ds[3]);
        }
        // dQ += dS K: K MN-major ([key][d]), 64-dim slabs DQ_KVSLAB apart, a
        // k16 step is 16 keys (issued, waited for with the next tile's S)
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < NS / 2; ++kk) {
          const uint64_t bk = desc_sw128(Ks + kk * 16 * 128, DQ_KVSLAB, 1024);
          if constexpr (D == 128) wgmma_m64n128k16_rs_t(acc, sf[kk], bk);
          else wgmma_m64n64k16_rs_t(acc, sf[kk], bk);
        }
        wgmma_commit();
      }
      if (n_kv > 0) {
        wgmma_wait<0>();
        fence_regs(acc);
#pragma unroll
        for (int kk = 0; kk < NS / 2; ++kk) fence_regs(sf[kk]);
        release(kv_empty + (it + n_kv - 1) % DQ_NST);
      }
      release(q_empty);  // every product of this item that reads Q or dO is done
      // tiles only the other warpgroup needs
      for (int j = n_kv; j < w.n_kv_max; ++j) {
        const int st = (it + j) % DQ_NST;
        mbar_wait(kv_full + st, ((it + j) / DQ_NST) & 1);
        release(kv_empty + st);
      }
      it += w.n_kv_max;

      if (n_kv > 0) {
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int qi = row0 + warp * 16 + g + i * 8;
          if (qi >= Sq) continue;
          bf16* row = dq + w.b * dq_sb + qi * dq_ss + h * dq_sh;
#pragma unroll
          for (int n = 0; n < NO; ++n)
            if (n * 8 < Dt)
              *reinterpret_cast<__nv_bfloat162*>(row + n * 8 + 2 * t) =
                  __floats2bfloat162_rn(acc[4 * n + 2 * i], acc[4 * n + 2 * i + 1]);
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// f32: SIMT kernels
// ---------------------------------------------------------------------------

constexpr int FB = 32;    // rows of every tile (keys or queries)
constexpr int FT = 256;   // threads per block: a 16 x 16 grid; thread (ty, tx)
                          // owns rows 2 ty, 2 ty + 1 and columns tx + 16 c

// load rows [row0, row0 + FB) and columns [col0, col0 + D) of a [rows, Dt]
// operand into shared memory as f32 with row stride D + 1 (D, the build's
// head dim, is its piece width); rows at or past `nrows` and columns at or
// past Dt become zero
template <typename T, int D>
__device__ __forceinline__ void load_f32(float* dst, const T* src, int64_t stride, int row0,
                                         int nrows, int col0, int Dt) {
  for (int idx = threadIdx.x; idx < FB * D; idx += FT) {
    const int r = idx / D, d = idx % D;
    const int gr = row0 + r;
    dst[r * (D + 1) + d] =
        gr < nrows && col0 + d < Dt ? to_f32(src[gr * stride + col0 + d]) : 0.f;
  }
}

// A head dim Dt past the build's D (the D = 256 build, up to 1024) is walked
// in pieces of D columns, as the forward does: both products that make the
// scores (S and dP) sum over every piece in column order, reloading each
// piece's columns; then the tiles that the gradient products read are
// reloaded at the block's slab (its D columns of the output), unless the
// last piece is that slab.  Blocks of one row tile differ in slab only.

template <typename T, int D>
__global__ void __launch_bounds__(FT) dkdv_simt_kernel(const Args a) {
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

  const int pieces = (a.D + D - 1) / D;
  const int slab = blockIdx.x % pieces;
  const int k0 = (blockIdx.x / pieces) * FB;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int G = a.H / a.KV;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const T* q = static_cast<const T*>(a.q);
  const T* dout = static_cast<const T*>(a.dout);
  const T* kb = static_cast<const T*>(a.k) + b * a.k_sb + kvh * a.k_sh;
  const T* vb = static_cast<const T*>(a.v) + b * a.v_sb + kvh * a.v_sh;

  if (pieces == 1) {  // K and V resident for the whole walk
    load_f32<T, D>(Ks, kb, a.k_ss, k0, a.Sk, 0, a.D);
    load_f32<T, D>(Vs, vb, a.v_ss, k0, a.Sk, 0, a.D);
  }
  float dka[2][DC], dva[2][DC];
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int c = 0; c < DC; ++c) dka[r][c] = dva[r][c] = 0.f;

  const int n_q = (a.Sq + FB - 1) / FB;
  for (int hh = 0; hh < G; ++hh) {
    const int h = kvh * G + hh;
    const int64_t row = ((int64_t)b * a.H + h) * a.Sq;
    const T* qh = q + b * a.q_sb + h * a.q_sh;
    const T* dh = dout + b * a.do_sb + h * a.do_sh;
    for (int i = first_q_tile(a.causal, a.q_offset, k0, FB); i < n_q; ++i) {
      const int q0 = i * FB;
      float s[2][2] = {}, dp[2][2] = {};
      for (int pc = 0; pc < pieces; ++pc) {
        __syncthreads();  // the previous step's (piece's) tiles are consumed
        if (pieces > 1) {
          load_f32<T, D>(Ks, kb, a.k_ss, k0, a.Sk, pc * D, a.D);
          load_f32<T, D>(Vs, vb, a.v_ss, k0, a.Sk, pc * D, a.D);
        }
        load_f32<T, D>(Qs, qh, a.q_ss, q0, a.Sq, pc * D, a.D);
        load_f32<T, D>(Ds, dh, a.do_ss, q0, a.Sq, pc * D, a.D);
        if (pc == 0 && threadIdx.x < FB) {
          const int qi = q0 + threadIdx.x;
          Ls[threadIdx.x] = qi < a.Sq ? a.lse[row + qi] : 0.f;
          Es[threadIdx.x] = qi < a.Sq ? a.delta[row + qi] : 0.f;
        }
        __syncthreads();

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
      }
      if (slab != pieces - 1) {  // dV and dK read the slab's columns of dO and Q
        __syncthreads();
        load_f32<T, D>(Qs, qh, a.q_ss, q0, a.Sq, slab * D, a.D);
        load_f32<T, D>(Ds, dh, a.do_ss, q0, a.Sq, slab * D, a.D);
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
          // P in do's dtype for dV, dS in q's dtype for dK
          Pt[(2 * ty + r) * PP + col] = round_to<T>(p);
          St[(2 * ty + r) * PP + col] = round_to<T>(p * (dp[r][c] - Es[col]) * a.scale);
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

  T* dk = static_cast<T*>(a.dk);
  T* dv = static_cast<T*>(a.dv);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int kr = k0 + 2 * ty + r;
    if (kr >= a.Sk) continue;
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      const int col = slab * D + tx + 16 * c;
      if (col >= a.D) continue;
      dk[b * a.dk_sb + kr * a.dk_ss + kvh * a.dk_sh + col] = from_f32<T>(dka[r][c]);
      dv[b * a.dv_sb + kr * a.dv_ss + kvh * a.dv_sh + col] = from_f32<T>(dva[r][c]);
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(FT) dq_simt_kernel(const Args a) {
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

  const int pieces = (a.D + D - 1) / D;
  const int slab = blockIdx.x % pieces;
  const int q0 = (blockIdx.x / pieces) * FB;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (a.H / a.KV);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const T* qb = static_cast<const T*>(a.q) + b * a.q_sb + h * a.q_sh;
  const T* db = static_cast<const T*>(a.dout) + b * a.do_sb + h * a.do_sh;
  const T* kb = static_cast<const T*>(a.k) + b * a.k_sb + kvh * a.k_sh;
  const T* vb = static_cast<const T*>(a.v) + b * a.v_sb + kvh * a.v_sh;

  if (pieces == 1) {  // Q and dO resident for the whole walk
    load_f32<T, D>(Qs, qb, a.q_ss, q0, a.Sq, 0, a.D);
    load_f32<T, D>(Ds, db, a.do_ss, q0, a.Sq, 0, a.D);
  }
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
    float s[2][2] = {}, dp[2][2] = {};
    for (int pc = 0; pc < pieces; ++pc) {
      __syncthreads();  // the previous tile's (piece's) Ks, Vs and Sm are consumed
      if (pieces > 1) {
        load_f32<T, D>(Qs, qb, a.q_ss, q0, a.Sq, pc * D, a.D);
        load_f32<T, D>(Ds, db, a.do_ss, q0, a.Sq, pc * D, a.D);
      }
      load_f32<T, D>(Ks, kb, a.k_ss, k0, a.Sk, pc * D, a.D);
      load_f32<T, D>(Vs, vb, a.v_ss, k0, a.Sk, pc * D, a.D);
      __syncthreads();

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
    }
    if (slab != pieces - 1) {  // dQ reads the slab's columns of K
      __syncthreads();
      load_f32<T, D>(Ks, kb, a.k_ss, k0, a.Sk, slab * D, a.D);
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
        Sm[qr * PP + tx + 16 * c] = round_to<T>(p * (dp[r][c] - Es[qr]) * a.scale);  // k's dtype
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

  T* dq = static_cast<T*>(a.dq);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = q0 + 2 * ty + r;
    if (qi >= a.Sq) continue;
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      const int col = slab * D + tx + 16 * c;
      if (col < a.D) dq[b * a.dq_sb + qi * a.dq_ss + h * a.dq_sh + col] = from_f32<T>(dqa[r][c]);
    }
  }
}

template <int D>
cudaError_t dkdv_bf16(const Args& a, int B, int split, cudaStream_t stream) {
  CUtensorMap qmap, kmap, vmap, dmap;
  if (!encode_map(&qmap, a.q, B, a.Sq, a.H, a.D, a.q_sb, a.q_ss, a.q_sh, BM) ||
      !encode_map(&dmap, a.dout, B, a.Sq, a.H, a.D, a.do_sb, a.do_ss, a.do_sh, BM) ||
      !encode_map(&kmap, a.k, B, a.Sk, a.KV, a.D, a.k_sb, a.k_ss, a.k_sh, KV_BN) ||
      !encode_map(&vmap, a.v, B, a.Sk, a.KV, a.D, a.v_sb, a.v_ss, a.v_sh, KV_BN))
    return cudaErrorInvalidValue;
  constexpr int smem = DkdvLayout<D>::BYTES;
  static int cap[64];
  cudaError_t err = smem_cap((const void*)dkdv_ws_kernel<D>, smem, cap);
  if (err != cudaSuccess) return err;
  const int units = B * a.KV;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(((a.Sk + KV_BN - 1) / KV_BN) * units * split);
  cfg.blockDim = dim3(WS_NT);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = split;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, dkdv_ws_kernel<D>, qmap, kmap, vmap, dmap, a.lse, a.delta,
                           (bf16*)a.dk, (bf16*)a.dv, a.H, a.KV, a.Sq, a.Sk, a.D, a.dk_sb,
                           a.dk_ss, a.dk_sh, a.dv_sb, a.dv_ss, a.dv_sh, a.causal, a.q_offset,
                           a.scale, units, split);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <int D>
cudaError_t dq_bf16(const Args& a, int B, cudaStream_t stream) {
  CUtensorMap qmap, kmap, vmap, dmap;
  if (!encode_map(&qmap, a.q, B, a.Sq, a.H, a.D, a.q_sb, a.q_ss, a.q_sh, BM) ||
      !encode_map(&dmap, a.dout, B, a.Sq, a.H, a.D, a.do_sb, a.do_ss, a.do_sh, BM) ||
      !encode_map(&kmap, a.k, B, a.Sk, a.KV, a.D, a.k_sb, a.k_ss, a.k_sh, DQ_BN) ||
      !encode_map(&vmap, a.v, B, a.Sk, a.KV, a.D, a.v_sb, a.v_ss, a.v_sh, DQ_BN))
    return cudaErrorInvalidValue;
  constexpr int smem = DqLayout<D>::BYTES;
  static int cap[64];
  cudaError_t err = smem_cap((const void*)dq_ws_kernel<D>, smem, cap);
  if (err != cudaSuccess) return err;
  const int G = a.H / a.KV;
  const int units = B * a.KV * (G >= 2 ? (G + 1) / 2 : 1);
  const int bm = G >= 2 ? BM : 2 * BM;
  const int n_items = ((a.Sq + bm - 1) / bm) * units;
  int n_sm = 0;
  err = sm_count(n_sm);
  if (err != cudaSuccess) return err;
  dq_ws_kernel<D><<<min(n_items, n_sm), WS_NT, smem, stream>>>(
      qmap, kmap, vmap, dmap, a.lse, a.delta, (bf16*)a.dq, a.H, a.KV, a.Sq, a.Sk, a.D,
      a.dq_sb, a.dq_ss, a.dq_sh, a.causal, a.q_offset, a.scale, units);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t dkdv_simt(const Args& a, int B, cudaStream_t stream) {
  const int smem = sizeof(float) * (4 * FB * (D + 1) + 2 * FB * (FB + 1) + 2 * FB);
  static int cap[64];
  cudaError_t err = smem_cap((const void*)dkdv_simt_kernel<T, D>, smem, cap);
  if (err != cudaSuccess) return err;
  const int pieces = (a.D + D - 1) / D;  // > 1 only on the D = 256 build
  dkdv_simt_kernel<T, D><<<dim3((a.Sk + FB - 1) / FB * pieces, a.KV, B), FT, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t dq_simt(const Args& a, int B, cudaStream_t stream) {
  const int smem = sizeof(float) * (4 * FB * (D + 1) + FB * (FB + 1) + 2 * FB);
  static int cap[64];
  cudaError_t err = smem_cap((const void*)dq_simt_kernel<T, D>, smem, cap);
  if (err != cudaSuccess) return err;
  const int pieces = (a.D + D - 1) / D;
  dq_simt_kernel<T, D><<<dim3((a.Sq + FB - 1) / FB * pieces, a.H, B), FT, smem, stream>>>(a);
  return cudaGetLastError();
}

// the CUDA-core pair's build for head dim D (64, 128 or 256, the last
// walking a head dim up to 1024 in pieces of 256)
template <typename T>
cudaError_t dkdv_simt_by_dim(const Args& a, int B, cudaStream_t st) {
  if (a.D <= 64) return dkdv_simt<T, 64>(a, B, st);
  if (a.D <= 128) return dkdv_simt<T, 128>(a, B, st);
  return dkdv_simt<T, 256>(a, B, st);
}

template <typename T>
cudaError_t dq_simt_by_dim(const Args& a, int B, cudaStream_t st) {
  if (a.D <= 64) return dq_simt<T, 64>(a, B, st);
  if (a.D <= 128) return dq_simt<T, 128>(a, B, st);
  return dq_simt<T, 256>(a, B, st);
}

bool takes(int dtype, int D, int H, int KV) {
  return (dtype == 0 || dtype == 1) && D >= 1 && D <= 1024 && KV > 0 && H % KV == 0;
}

// the tensor-core pair takes bf16 with D % 8 == 0 (TMA's 16-byte strides)
// up to its D = 128 build; the CUDA-core pair takes everything else
bool on_tensor_cores(int dtype, int D) { return dtype == 1 && D % 8 == 0 && D <= 128; }

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v, do and the gradients share
// it); 1 <= D <= 1024.  bf16 with D % 8 == 0 and D <= 128 runs on the tensor
// cores, with bases and strides 16-byte aligned (checked by the caller);
// every other case on the CUDA cores.  Strides are in elements, in the
// order batch, seq, head; the last dim of every operand is contiguous.  lse
// and delta are f32 [B*H, Sq], contiguous.  `split` (1, 2, 4 or 8; used on
// the tensor cores only): the blocks of a thread-block cluster that share
// one 128-key tile, each taking every split-th query head of the group.
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
    int causal, int q_offset, float scale, int split, void* stream) {
  const Args a{q, k, v, dout, lse, delta, nullptr, dk, dv, H, KV, Sq, Sk, D,
               q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, do_sb, do_ss, do_sh,
               0, 0, 0, dk_sb, dk_ss, dk_sh, dv_sb, dv_ss, dv_sh, causal, q_offset, scale};
  cudaStream_t st = (cudaStream_t)stream;
  if (!takes(dtype, D, H, KV) || (split != 1 && split != 2 && split != 4 && split != 8))
    return (int)cudaErrorInvalidValue;
  if (dtype == 0) return (int)dkdv_simt_by_dim<float>(a, B, st);
  if (!on_tensor_cores(dtype, D)) return (int)dkdv_simt_by_dim<bf16>(a, B, st);
  return (int)(D > 64 ? dkdv_bf16<128>(a, B, split, st) : dkdv_bf16<64>(a, B, split, st));
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
  const Args a{q, k, v, dout, lse, delta, dq_out, nullptr, nullptr, H, KV, Sq, Sk, D,
               q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, do_sb, do_ss, do_sh,
               dq_sb, dq_ss, dq_sh, 0, 0, 0, 0, 0, 0, causal, q_offset, scale};
  cudaStream_t st = (cudaStream_t)stream;
  if (!takes(dtype, D, H, KV)) return (int)cudaErrorInvalidValue;
  if (dtype == 0) return (int)dq_simt_by_dim<float>(a, B, st);
  if (!on_tensor_cores(dtype, D)) return (int)dq_simt_by_dim<bf16>(a, B, st);
  return (int)(D > 64 ? dq_bf16<128>(a, B, st) : dq_bf16<64>(a, B, st));
}
