// The mamba-1 selective-scan recurrence for Hopper (sm_90a), in CUDA C++:
//
//   h_t = dA_t * h_{t-1} + dBu_t        (h: [Ch, N] per batch row, f32)
//   y_t = sum_n h_t[:, n] * C_t[n]      (y: [Ch] per step)
//
// Replaces the TPU kernel `mamba_scan_kernel` of
// src/repro/kernels/mamba_scan.py (Pallas, grid (Ch / block_c, S / block_s)
// with the sequence innermost: one channel block's [block_c, N] state sits
// in VMEM scratch while the sequence blocks stream past it, starts at zero
// and is dropped at the end).  Here the state may start from h0 and the
// last state h_S may be written out, which the model's prefill and decode
// need (the TPU kernel has neither).
//
// What bounds it on the H100: bytes.  Every element of dA and dBu is read
// once and used in one multiply-add, so at the falcon-mamba-7b prefill
// shape (B=4, S=512, Ch=8192, N=16, f32) it moves 2.15 GB, 0.64 ms at
// 3.35 TB/s; a decode step (S=1) moves 4.2 MB of dA and dBu plus the 2.1 MB
// state read and written, a few microseconds.
//
// Design:
//   * on Hopper the blocks run in parallel, not in sequence as the TPU
//     grid does, so a thread owns one state element (b, c, n) for the whole
//     sequence and loops over t itself; nothing is carried between blocks;
//   * the NP = next power of two >= N lanes of one channel sit side by side
//     in a warp (N = 16: two channels per warp), so for each t the loads of
//     dA[b, t, c, :] and dBu[b, t, c, :] are contiguous across the warp, and
//     y_t is an NP-lane shuffle sum; lanes n >= N and channels c >= Ch run
//     the loop on identity steps (dA = 1, dBu = 0, C = 0: every lane must
//     take part in the shuffles) and write nothing, as do the steps past S
//     in the last chunk;
//   * the loop takes T_CHUNK steps at a time: it issues all their loads
//     first, then runs the recurrence on registers, so each thread keeps
//     3 * T_CHUNK loads in flight;
//   * at the falcon-mamba-7b prefill shape that is 524k threads, two waves
//     over the 132 SMs;
//   * the products and sums are rounded as the plain version rounds them
//     (dA * h, then + dBu: no fused multiply-add), in f32 for f32 and bf16
//     inputs alike; y is rounded once to the inputs' dtype.
// A chunked scan over S (more parallelism for small B * Ch) and fusing the
// discretisation (dA = exp(dt * A), dBu = dt * u * B) into the kernel, so
// that dA and dBu never reach device memory, are later work.
//
// The launcher has a plain C interface (loaded with ctypes) and returns
// the cudaError_t of the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;      // threads per block
constexpr int T_CHUNK = 8;   // time steps whose loads are issued together

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

template <typename T, int NP>
__global__ void __launch_bounds__(NT) mamba_scan_kernel(
    const T* __restrict__ dA, const T* __restrict__ dBu, const T* __restrict__ C,
    const float* __restrict__ h0, T* __restrict__ y, float* __restrict__ h_out,
    int S, int Ch, int N) {
  const int lane = threadIdx.x % NP;
  const int c = blockIdx.x * (NT / NP) + threadIdx.x / NP;
  const int64_t b = blockIdx.y;
  const bool live = c < Ch && lane < N;
  const int64_t step = (int64_t)Ch * N;                 // dA, dBu elements per t
  const int64_t state = (b * Ch + c) * N + lane;        // this thread's h element
  const T* pa = dA + b * S * step + (int64_t)c * N + lane;
  const T* pu = dBu + b * S * step + (int64_t)c * N + lane;
  const T* pc = C + b * S * N + lane;
  T* py = y + b * S * Ch + c;

  float h = (live && h0 != nullptr) ? h0[state] : 0.f;
  for (int t0 = 0; t0 < S; t0 += T_CHUNK) {
    float a[T_CHUNK], u[T_CHUNK], cm[T_CHUNK];
#pragma unroll
    for (int i = 0; i < T_CHUNK; ++i) {
      const int t = t0 + i;
      const bool ok = live && t < S;
      a[i] = ok ? to_f32(pa[t * step]) : 1.f;  // a step past S leaves h as it is
      u[i] = ok ? to_f32(pu[t * step]) : 0.f;
      cm[i] = ok ? to_f32(pc[(int64_t)t * N]) : 0.f;
    }
#pragma unroll
    for (int i = 0; i < T_CHUNK; ++i) {
      h = __fadd_rn(__fmul_rn(a[i], h), u[i]);
      float p = h * cm[i];
#pragma unroll
      for (int o = NP / 2; o > 0; o >>= 1) p += __shfl_xor_sync(0xffffffffu, p, o, NP);
      if (live && lane == 0 && t0 + i < S) py[(int64_t)(t0 + i) * Ch] = from_f32<T>(p);
    }
  }
  if (live && h_out != nullptr) h_out[state] = h;
}

template <typename T, int NP>
cudaError_t launch(const void* dA, const void* dBu, const void* C, const float* h0, void* y,
                   float* h_out, int B, int S, int Ch, int N, cudaStream_t stream) {
  constexpr int per_block = NT / NP;  // channels per block
  dim3 grid((unsigned)((Ch + per_block - 1) / per_block), (unsigned)B);
  mamba_scan_kernel<T, NP><<<grid, NT, 0, stream>>>(
      static_cast<const T*>(dA), static_cast<const T*>(dBu), static_cast<const T*>(C), h0,
      static_cast<T*>(y), h_out, S, Ch, N);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* dA, const void* dBu, const void* C, const float* h0, void* y,
                     float* h_out, int B, int S, int Ch, int N, cudaStream_t st) {
  if (N <= 1) return launch<T, 1>(dA, dBu, C, h0, y, h_out, B, S, Ch, N, st);
  if (N <= 2) return launch<T, 2>(dA, dBu, C, h0, y, h_out, B, S, Ch, N, st);
  if (N <= 4) return launch<T, 4>(dA, dBu, C, h0, y, h_out, B, S, Ch, N, st);
  if (N <= 8) return launch<T, 8>(dA, dBu, C, h0, y, h_out, B, S, Ch, N, st);
  if (N <= 16) return launch<T, 16>(dA, dBu, C, h0, y, h_out, B, S, Ch, N, st);
  if (N <= 32) return launch<T, 32>(dA, dBu, C, h0, y, h_out, B, S, Ch, N, st);
  return cudaErrorInvalidValue;
}

}  // namespace

// dA, dBu: [B, S, Ch, N] contiguous; C: [B, S, N] contiguous; all of one
// dtype (dtype 0: f32, 1: bf16).  h0: [B, Ch, N] f32 contiguous or null
// (zeros).  y: [B, S, Ch] of the inputs' dtype; h_out: [B, Ch, N] f32 or
// null (not written).  1 <= N <= 32, B <= 65,535, S >= 1 (checked by the
// caller).
extern "C" int mamba_scan_fwd(int dtype, const void* dA, const void* dBu, const void* C,
                              const float* h0, void* y, float* h_out, int B, int S, int Ch,
                              int N, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  switch (dtype) {
    case 0: return (int)dispatch<float>(dA, dBu, C, h0, y, h_out, B, S, Ch, N, st);
    case 1: return (int)dispatch<__nv_bfloat16>(dA, dBu, C, h0, y, h_out, B, S, Ch, N, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
