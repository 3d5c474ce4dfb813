// The RG-LRU linear recurrence for Hopper (sm_90a), in CUDA C++, in two
// forms that share one pipeline:
//
//   materialised (`rglru_scan_fwd`), the TPU kernel's contract:
//     h_t = a_t * h_{t-1} + g_t,   y_t = h_t            (h: [W] per batch row, f32)
//   fused (`rglru_gated_fwd`), the JAX model's whole `rglru_scan`
//   (src/repro/models/rglru.py:27), gates formed inside the kernel:
//     a_t = exp(c * r_t)                                 (c = -8 softplus(lam), [W] f32)
//     g_t = f32(i_t * x_t rounded) * sqrt(max(1 - a_t^2, 1e-12))
//     h_t = a_t * h_{t-1} + g_t,   y_t = h_t in x's dtype, h_S f32
//
// Replaces the TPU kernel `rglru_scan_kernel` of
// src/repro/kernels/rglru_scan.py (Pallas, grid (M / block_m, S / block_s)
// over the folded [S, B * W] layout with the sequence innermost: a channel
// block's state sits in VMEM scratch while sequence blocks stream past it,
// and starts at zero).  Here the inputs are read in the model's [B, S, W]
// layout (no fold, no copy) and the state may start from h0, which the
// model's decode needs.
//
// What bounds it on the H100: bytes.  Each input is read once and y written
// once: at the recurrentgemma-2b serving prefill (B=4, S=512, W=2560) the
// materialised form moves 63 MB in f32 (19 us at 3.35 TB/s), the fused one
// 42 MB in bf16 (12.5 us) and saves the ~10 eager passes over [B, S, W] f32
// that formed a and g.  The sequence order of the recurrence is kept (the
// f32 output is bitwise its plain version's), so the card's parallelism is
// B * W channel threads, 10,240 at that shape: the time is set by how many
// bytes are in flight while those few threads walk the sequence.
//
// Design:
//   * a block owns CPB = 32 channels of one batch row, 320 blocks at the
//     serving shape, so every SM holds two or three (one thread per (b, w)
//     in blocks of 256 made 40 blocks for 132 SMs); its warps specialise:
//   * warp 0 runs the recurrence, the only serial chain: one lane per
//     channel, a multiply and an add per step, reading a and g from shared
//     memory and writing h into a y tile in shared memory;
//   * NG = 8 gate warps do everything else: they stream the inputs through
//     a ring of NSTAGE tiles of [TT steps, CPB channels] in shared memory
//     (16-byte cp.async, NSTAGE - 1 tiles ahead), form each tile's a and g
//     in f32 (the fused form's exp and sqrt: the work that held one warp
//     per block back) into one of two buffers, and write the y tile the
//     recurrence finished one tile earlier back to device memory with
//     16-byte stores; one block barrier per tile hands over both buffers;
//     rows whose width or base is not a multiple of 16 bytes are copied
//     element by element instead (same ring, no cp.async);
//   * a single step (the decode) skips the ring: one thread per (b, w)
//     reads its inputs and state and writes y and the new state;
//   * every product and sum is rounded apart (`__fmul_rn`, `__fadd_rn`,
//     `__fsub_rn`, `__fsqrt_rn`: nothing contracted into an FMA), exp is
//     the accurate expf, and i * x is rounded to x's dtype first, as the
//     plain version (`ref.rglru_gated_scan_ref`, `ref.rglru_scan_ref`)
//     rounds them, so the two agree bit for bit in f32.
//
// The launchers have a plain C interface (loaded with ctypes) and return
// the cudaError_t of the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "convert.cuh"
#include "hopper.cuh"

namespace {

constexpr int CPB = 32;              // channels per block (the recurrence warp's lanes)
constexpr int NG = 8;                // gate warps per block
constexpr int NT = 32 * (1 + NG);    // threads per block
constexpr int GT = 32 * NG;          // gate threads per block
constexpr int TT = 32;               // steps per tile
constexpr int NSTAGE = 4;            // input tiles of the ring
constexpr int STEP_NT = 128;         // threads per block of the one-step kernel

using cvt::from_f32;
using cvt::round_to;
using cvt::to_f32;

__device__ __forceinline__ void cp_async_16b(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(hopper::smem_addr(dst)), "l"(src), "r"(valid ? 16 : 0));
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// the gate warps' own barrier (barrier 0 is the whole block's)
__device__ __forceinline__ void gate_barrier() {
  asm volatile("bar.sync 1, %0;\n" :: "n"(GT) : "memory");
}

// The NIN inputs of one tile of TT steps into ring stage `stage`, by gate
// thread `gt`: rows past S and channels past W read as zeros.  VEC: 16-byte
// chunks by cp.async (W * sizeof(T) and every base 16-byte aligned, so a
// chunk lies wholly inside or outside the row); else one element at a time.
template <typename T, int NIN, bool VEC>
__device__ __forceinline__ void load_tile(T* ring, const T* const* in, int stage, int tile,
                                          int64_t base, int w0, int S, int W, int gt) {
  constexpr int EPC = 16 / sizeof(T);  // elements per 16-byte chunk
  constexpr int CHUNKS = CPB / EPC;    // chunks per tile row
#pragma unroll
  for (int k = 0; k < NIN; ++k) {
    T* dst = ring + ((int64_t)stage * NIN + k) * TT * CPB;
    if constexpr (VEC) {
#pragma unroll
      for (int idx = gt; idx < TT * CHUNKS; idx += GT) {
        const int r = idx / CHUNKS, col = (idx % CHUNKS) * EPC;
        const int t = tile * TT + r;
        const bool ok = t < S && w0 + col < W;
        cp_async_16b(dst + r * CPB + col, ok ? in[k] + base + (int64_t)t * W + w0 + col : in[k],
                     ok);
      }
    } else {
#pragma unroll 4
      for (int idx = gt; idx < TT * CPB; idx += GT) {
        const int r = idx / CPB, col = idx % CPB;
        const int t = tile * TT + r;
        dst[idx] = t < S && w0 + col < W ? in[k][base + (int64_t)t * W + w0 + col]
                                         : from_f32<T>(0.f);
      }
    }
  }
  asm volatile("cp.async.commit_group;\n" ::);  // an empty group past the last tile
}

// rows [tile * TT, ...) of the y tile in shared memory back to y, by gate
// thread `gt`; 16-byte stores where VEC
template <typename T, bool VEC>
__device__ __forceinline__ void store_tile(T* __restrict__ y, const T* ytile, int tile,
                                           int64_t base, int w0, int S, int W, int gt) {
  if constexpr (VEC) {
    constexpr int EPC = 16 / sizeof(T);
    constexpr int CHUNKS = CPB / EPC;
#pragma unroll
    for (int idx = gt; idx < TT * CHUNKS; idx += GT) {
      const int r = idx / CHUNKS, col = (idx % CHUNKS) * EPC;
      const int t = tile * TT + r;
      if (t < S && w0 + col < W)
        *reinterpret_cast<uint4*>(y + base + (int64_t)t * W + w0 + col) =
            *reinterpret_cast<const uint4*>(ytile + r * CPB + col);
    }
  } else {
#pragma unroll 4
    for (int idx = gt; idx < TT * CPB; idx += GT) {
      const int r = idx / CPB, col = idx % CPB;
      const int t = tile * TT + r;
      if (t < S && w0 + col < W) y[base + (int64_t)t * W + w0 + col] = ytile[idx];
    }
  }
}

// the decay a and the gated input g of one step: the fused form forms them
// from x, r, i and c; the materialised form reads them
template <typename T, bool FUSED>
__device__ __forceinline__ void gates(T v0, T v1, T v2, float c, float& a, float& g) {
  if constexpr (FUSED) {
    const float xf = to_f32(v0), rf = to_f32(v1), inf = to_f32(v2);
    a = expf(__fmul_rn(c, rf));
    const float gx = round_to<T>(__fmul_rn(inf, xf));  // (i * x) in x's dtype
    g = __fmul_rn(gx, __fsqrt_rn(fmaxf(__fsub_rn(1.f, __fmul_rn(a, a)), 1e-12f)));
  } else {
    a = to_f32(v0);
    g = to_f32(v1);
  }
}

template <typename T, bool FUSED>
struct Smem {
  static constexpr int NIN = FUSED ? 3 : 2;
  static constexpr int RING = NSTAGE * NIN * TT * CPB * (int)sizeof(T);  // input tiles
  static constexpr int GATES = 2 * 2 * TT * CPB * 4;                    // [2][a, g] f32
  static constexpr int YT = 2 * TT * CPB * (int)sizeof(T);               // [2] y tiles
  static constexpr int BYTES = RING + GATES + YT;
};

// FUSED: in = {x, r, i}, cw = c; else in = {a, g}.  y [B, S, W]; h_out [B, W]
// f32 or null.
template <typename T, bool FUSED, bool VEC>
__global__ void __launch_bounds__(NT) rglru_kernel(
    const T* __restrict__ p0, const T* __restrict__ p1, const T* __restrict__ p2,
    const float* __restrict__ cw, const float* __restrict__ h0, T* __restrict__ y,
    float* __restrict__ h_out, int S, int W) {
  using L = Smem<T, FUSED>;
  constexpr int NIN = L::NIN;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ring = reinterpret_cast<T*>(smem_raw);                    // [NSTAGE][NIN][TT][CPB]
  float* gbuf = reinterpret_cast<float*>(smem_raw + L::RING);  // [2][2][TT][CPB]
  T* ybuf = reinterpret_cast<T*>(smem_raw + L::RING + L::GATES);  // [2][TT][CPB]
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int w0 = blockIdx.x * CPB;
  const int64_t b = blockIdx.y;
  const int64_t base = b * S * W;
  const int n_tiles = (S + TT - 1) / TT;

  if (warp == 0) {  // the recurrence
    const int w = w0 + lane;
    const bool live = w < W;
    float h = live && h0 != nullptr ? h0[b * W + w] : 0.f;
    for (int tile = 0; tile < n_tiles; ++tile) {
      __syncthreads();  // this tile's a, g are in; the y tile two back is out
      const float* a = gbuf + (tile % 2) * 2 * TT * CPB + lane;
      const float* g = a + TT * CPB;
      T* yt = ybuf + (tile % 2) * TT * CPB + lane;
      const int rows = min(TT, S - tile * TT);  // the same for every lane
#pragma unroll 8
      for (int r = 0; r < rows; ++r) {
        h = __fadd_rn(__fmul_rn(a[r * CPB], h), g[r * CPB]);
        yt[r * CPB] = from_f32<T>(h);
      }
    }
    __syncthreads();  // the last y tile is complete
    if (live && h_out != nullptr) h_out[b * W + w] = h;
    return;
  }

  // the gate warps
  const int gt = threadIdx.x - 32;
  const T* in[NIN];
  in[0] = p0;
  in[1] = p1;
  if constexpr (FUSED) in[2] = p2;
  const float c = FUSED && w0 + lane < W ? cw[w0 + lane] : 0.f;
#pragma unroll
  for (int s = 0; s < NSTAGE - 1; ++s)
    load_tile<T, NIN, VEC>(ring, in, s, s, base, w0, S, W, gt);
  for (int tile = 0; tile < n_tiles; ++tile) {
    cp_async_wait<NSTAGE - 2>();  // this thread's copies of `tile` have landed
    gate_barrier();               // and every gate thread's; the stage read last is free
    load_tile<T, NIN, VEC>(ring, in, (tile + NSTAGE - 1) % NSTAGE, tile + NSTAGE - 1, base, w0,
                           S, W, gt);
    const T* st = ring + (int64_t)(tile % NSTAGE) * NIN * TT * CPB + lane;
    float* a = gbuf + (tile % 2) * 2 * TT * CPB + lane;
    float* g = a + TT * CPB;
#pragma unroll
    for (int j = 0; j < TT / NG; ++j) {  // rows warp - 1, warp - 1 + NG, ...
      const int r = j * NG + warp - 1;
      float av, gv;
      gates<T, FUSED>(st[r * CPB], st[(TT + r) * CPB], FUSED ? st[(2 * TT + r) * CPB] : st[0],
                      c, av, gv);
      a[r * CPB] = av;
      g[r * CPB] = gv;
    }
    __syncthreads();  // hand the gates to warp 0, which is done with the last tile
    if (tile > 0)
      store_tile<T, VEC>(y, ybuf + ((tile - 1) % 2) * TT * CPB, tile - 1, base, w0, S, W, gt);
  }
  cp_async_wait<0>();  // no copy outlives the block
  __syncthreads();     // warp 0 has finished the last tile
  store_tile<T, VEC>(y, ybuf + ((n_tiles - 1) % 2) * TT * CPB, n_tiles - 1, base, w0, S, W, gt);
}

// one step (S = 1): one thread per (b, w), no ring
template <typename T, bool FUSED>
__global__ void __launch_bounds__(STEP_NT) rglru_step_kernel(
    const T* __restrict__ p0, const T* __restrict__ p1, const T* __restrict__ p2,
    const float* __restrict__ cw, const float* __restrict__ h0, T* __restrict__ y,
    float* __restrict__ h_out, int W) {
  const int w = blockIdx.x * STEP_NT + threadIdx.x;
  if (w >= W) return;
  const int64_t i = (int64_t)blockIdx.y * W + w;
  float a, g;
  gates<T, FUSED>(p0[i], p1[i], FUSED ? p2[i] : p0[i], FUSED ? cw[w] : 0.f, a, g);
  const float h = __fadd_rn(__fmul_rn(a, h0 != nullptr ? h0[i] : 0.f), g);
  y[i] = from_f32<T>(h);
  if (h_out != nullptr) h_out[i] = h;
}

template <typename T, bool FUSED, bool VEC>
cudaError_t launch(const void* p0, const void* p1, const void* p2, const float* cw,
                   const float* h0, void* y, float* h_out, int B, int S, int W,
                   cudaStream_t stream) {
  constexpr int smem = Smem<T, FUSED>::BYTES;
  static int cap[64];
  cudaError_t err = hopper::smem_cap((const void*)rglru_kernel<T, FUSED, VEC>, smem, cap);
  if (err != cudaSuccess) return err;
  dim3 grid((unsigned)((W + CPB - 1) / CPB), (unsigned)B);
  rglru_kernel<T, FUSED, VEC><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(p0), static_cast<const T*>(p1), static_cast<const T*>(p2), cw, h0,
      static_cast<T*>(y), h_out, S, W);
  return cudaGetLastError();
}

bool aligned16(const void* p) { return p == nullptr || (uintptr_t)p % 16 == 0; }

template <typename T, bool FUSED>
cudaError_t dispatch(const void* p0, const void* p1, const void* p2, const float* cw,
                     const float* h0, void* y, float* h_out, int B, int S, int W,
                     cudaStream_t st) {
  if (S == 1) {
    dim3 grid((unsigned)((W + STEP_NT - 1) / STEP_NT), (unsigned)B);
    rglru_step_kernel<T, FUSED><<<grid, STEP_NT, 0, st>>>(
        static_cast<const T*>(p0), static_cast<const T*>(p1), static_cast<const T*>(p2), cw, h0,
        static_cast<T*>(y), h_out, W);
    return cudaGetLastError();
  }
  const bool vec = (int64_t)W * sizeof(T) % 16 == 0 && aligned16(p0) && aligned16(p1) &&
                   aligned16(p2) && aligned16(y);
  if (vec) return launch<T, FUSED, true>(p0, p1, p2, cw, h0, y, h_out, B, S, W, st);
  return launch<T, FUSED, false>(p0, p1, p2, cw, h0, y, h_out, B, S, W, st);
}

}  // namespace

// a, g: [B, S, W] contiguous, of one dtype (dtype 0: f32, 1: bf16); h0:
// [B, W] f32 contiguous or null (zeros); y: [B, S, W] of the inputs' dtype.
// B <= 65,535, S >= 1 (checked by the caller).
extern "C" int rglru_scan_fwd(int dtype, const void* a, const void* g, const float* h0,
                              void* y, int B, int S, int W, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  switch (dtype) {
    case 0: return (int)dispatch<float, false>(a, g, nullptr, nullptr, h0, y, nullptr, B, S, W, st);
    case 1:
      return (int)dispatch<__nv_bfloat16, false>(a, g, nullptr, nullptr, h0, y, nullptr, B, S, W,
                                                 st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// x, r, i: [B, S, W] contiguous, of one dtype (dtype 0: f32, 1: bf16); c:
// [W] f32 (-8 softplus(lam)); h0: [B, W] f32 contiguous or null (zeros); y:
// [B, S, W] of x's dtype; h_out: [B, W] f32, the last state.  B <= 65,535,
// S >= 1 (checked by the caller).
extern "C" int rglru_gated_fwd(int dtype, const void* x, const void* r, const void* i,
                               const float* c, const float* h0, void* y, float* h_out, int B,
                               int S, int W, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  switch (dtype) {
    case 0: return (int)dispatch<float, true>(x, r, i, c, h0, y, h_out, B, S, W, st);
    case 1: return (int)dispatch<__nv_bfloat16, true>(x, r, i, c, h0, y, h_out, B, S, W, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
