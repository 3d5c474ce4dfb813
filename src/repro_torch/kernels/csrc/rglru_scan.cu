// The RG-LRU linear recurrence for Hopper (sm_90a), in CUDA C++:
//
//   h_t = a_t * h_{t-1} + g_t,   y_t = h_t     (h: [W] per batch row, f32)
//
// Replaces the TPU kernel `rglru_scan_kernel` of
// src/repro/kernels/rglru_scan.py (Pallas, grid (M / block_m, S / block_s)
// over the folded [S, B * W] layout with the sequence innermost: a channel
// block's state sits in VMEM scratch while sequence blocks stream past it,
// and starts at zero).  Here a, g are read in the model's [B, S, W] layout
// (no fold, no copy) and the state may start from h0, which the model's
// decode needs.  With f32 inputs y[:, -1] is the last state exactly.
//
// What bounds it on the H100: bytes.  a and g are read once and y written
// once, one multiply-add per element; at the recurrentgemma-2b prefill
// shape (B=4, S=512, W=2560, f32) that is 63 MB, 19 us at 3.35 TB/s.
//
// Design:
//   * one thread per (b, w) owns that channel's state for the whole
//     sequence and loops over t; loads of a[b, t, :] and g[b, t, :] and the
//     store of y[b, t, :] are contiguous across a warp;
//   * the loop takes T_CHUNK steps at a time: it issues all their loads
//     first, then runs the recurrence on registers;
//   * the product and the sum are rounded apart (no fused multiply-add), as
//     the plain version rounds them, so the two agree bit for bit in f32.
// B * W = 10,240 threads at the serving shape: 40 blocks of 256 on a card
// of 132 SMs, so the card is underfilled and the loop's latency, not the
// bytes, sets the time.  A chunked two-pass scan over S (each chunk's
// local scan and its decay product in parallel, then the carries) is later
// work.
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

template <typename T>
__global__ void __launch_bounds__(NT) rglru_scan_kernel(
    const T* __restrict__ a, const T* __restrict__ g, const float* __restrict__ h0,
    T* __restrict__ y, int S, int W) {
  const int w = blockIdx.x * NT + threadIdx.x;
  if (w >= W) return;
  const int64_t b = blockIdx.y;
  const int64_t base = b * S * W + w;
  float h = h0 != nullptr ? h0[b * W + w] : 0.f;
  for (int t0 = 0; t0 < S; t0 += T_CHUNK) {
    float av[T_CHUNK], gv[T_CHUNK];
#pragma unroll
    for (int i = 0; i < T_CHUNK; ++i) {
      const int t = t0 + i;
      av[i] = t < S ? to_f32(a[base + (int64_t)t * W]) : 1.f;  // a step past S leaves h
      gv[i] = t < S ? to_f32(g[base + (int64_t)t * W]) : 0.f;
    }
#pragma unroll
    for (int i = 0; i < T_CHUNK; ++i) {
      h = __fadd_rn(__fmul_rn(av[i], h), gv[i]);
      if (t0 + i < S) y[base + (int64_t)(t0 + i) * W] = from_f32<T>(h);
    }
  }
}

template <typename T>
cudaError_t launch(const void* a, const void* g, const float* h0, void* y, int B, int S, int W,
                   cudaStream_t stream) {
  dim3 grid((unsigned)((W + NT - 1) / NT), (unsigned)B);
  rglru_scan_kernel<T><<<grid, NT, 0, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(g), h0, static_cast<T*>(y), S, W);
  return cudaGetLastError();
}

}  // namespace

// a, g: [B, S, W] contiguous, of one dtype (dtype 0: f32, 1: bf16); h0:
// [B, W] f32 contiguous or null (zeros); y: [B, S, W] of the inputs' dtype.
// B <= 65,535, S >= 1 (checked by the caller).
extern "C" int rglru_scan_fwd(int dtype, const void* a, const void* g, const float* h0,
                              void* y, int B, int S, int W, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  switch (dtype) {
    case 0: return (int)launch<float>(a, g, h0, y, B, S, W, st);
    case 1: return (int)launch<__nv_bfloat16>(a, g, h0, y, B, S, W, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
