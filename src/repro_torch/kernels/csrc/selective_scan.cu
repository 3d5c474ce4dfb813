// The mamba-1 selective scan for Hopper (sm_90a), in CUDA C++, with the
// discretisation formed inside the kernel:
//
//   dtu_t = dt_t * u_t                                  (rounded to u's dtype)
//   h_t   = exp(dt_t * A) * h_{t-1} + dtu_t * B_t       (h: [Ch, N] per batch row, f32)
//   y_t   = sum_n h_t[:, n] * C_t[n] + D * u_t          (rounded once to u's dtype)
//
// This is the JAX model's `selective_scan` (src/repro/models/ssm.py:35), a
// `lax.scan` that forms dA_t and dBu_t per step.  On the TPU its hot loop is
// the Pallas kernel `mamba_scan_kernel` of src/repro/kernels/mamba_scan.py,
// whose contract takes dA and dBu materialised as [B, S, Ch, N] tensors;
// `csrc/mamba_scan.cu` keeps that contract.  This kernel takes dt, u, A, B,
// C and D instead, so neither [B, S, Ch, N] tensor ever reaches device
// memory (1.07 GB of f32 apiece at the falcon-mamba-7b serving prefill, B=4,
// S=512, d_inner 8192, N=16, and the eager passes that wrote them).
//
// What bounds it on the H100: at that prefill in bf16 it reads u and dt and
// writes y (33.5 MB each) plus the 2.1 MB state: ~0.10 GB, ~31 us at
// 3.35 TB/s; it does ~7 f32 operations per state element and step (~1.9
// GFLOP, ~28 us at 67 TFLOP/s).  But one of those operations is an exp:
// the accurate expf is about nine instructions (range reduction, one ex2
// on the special-function unit, the scale), so by a hand count a state
// element's step issues ~19 instructions, and the 268 M of them at this
// shape would take ~0.17 ms of instruction issue on 132 SMs at 1.755 GHz.
// By that estimate (no profiler reading backs it) issue, not bytes, is
// what this kernel meets first (PERF.md has the measured time).
//
// Design (prefill, any S):
//   * `LANES` threads per channel (b, c), each holding NP / LANES of the
//     channel's states and the matching A[c, :] in registers for the whole
//     sequence; with one lane, y needs no shuffle; with 2 or 4, one
//     shuffle sum per step.  B * Ch = 32,768 channels at that prefill are
//     7.75 warps per SM with one lane, too few to hide the exp's latency;
//     the wrapper splits the states over lanes until every SM has 8 warps
//     (`selective_scan.scan_lanes`);
//   * B_t and C_t, the same for every channel of a batch row, are staged in
//     shared memory (as f32) TB steps at a time;
//   * dt and u are loaded coalesced across channels, TC steps at a time, one
//     chunk ahead of the steps that use them;
//   * numerics follow the plain version (`ref.selective_scan_ref`): dt * u
//     rounded to the inputs' dtype, dA = expf(dt * A) (no fast math), each
//     product and sum of h rounded apart (`__fmul_rn`, `__fadd_rn`: nothing
//     contracted into an FMA), y summed over n in f32 in the kernel's own
//     order plus D * u, rounded once; so y agrees with the plain version to
//     the order of a 16-term f32 sum, and h_S likewise.
// Decode (S = 1) has its own kernel: 4 lanes per channel, each reading and
// writing its states (and A) as float4 where the layout allows, so the
// step is a streaming pass over the 2.1 MB state; h_out may be h0 (the
// model updates its cache in place: each thread reads its own state
// elements before it writes them).
//
// The launcher has a plain C interface (loaded with ctypes) and returns
// the cudaError_t of the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "convert.cuh"

namespace {

constexpr int NT = 128;  // threads per block
constexpr int TC = 8;    // steps whose dt, u loads are issued together
constexpr int TB = 64;   // steps of B, C staged in shared memory at a time (a multiple of TC)
constexpr int STEP_LANES = 4;  // lanes per channel of the decode kernel

using cvt::from_f32;
using cvt::round_to;
using cvt::to_f32;

// the recurrence of one step over a thread's NS states, given the step's
// B_t and C_t at those states; returns its part of sum_n h[n] * C_t[n] (two
// partial sums, so the y sum is no NS-long chain)
template <typename T, int NS>
__device__ __forceinline__ float step(float (&h)[NS], const float (&a)[NS], float dtf, float uf,
                                      const float (&bv)[NS], const float (&cv)[NS]) {
  const float dtu = round_to<T>(__fmul_rn(dtf, uf));
  float acc[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < NS; ++j) {
    const float dA = expf(__fmul_rn(dtf, a[j]));
    h[j] = __fadd_rn(__fmul_rn(dA, h[j]), __fmul_rn(dtu, bv[j]));
    acc[j % 2] = fmaf(h[j], cv[j], acc[j % 2]);
  }
  return acc[0] + acc[1];
}

// NS floats of shared memory from p (16-byte aligned where NS % 4 == 0)
template <int NS>
__device__ __forceinline__ void load_shared(float (&v)[NS], const float* p) {
  if constexpr (NS % 4 == 0) {
#pragma unroll
    for (int j = 0; j < NS; j += 4) {
      const float4 q = *reinterpret_cast<const float4*>(p + j);
      v[j] = q.x; v[j + 1] = q.y; v[j + 2] = q.z; v[j + 3] = q.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < NS; ++j) v[j] = p[j];
  }
}

template <int LANES>
__device__ __forceinline__ float lane_sum(float x) {
#pragma unroll
  for (int o = LANES / 2; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o, LANES);
  return x;
}

template <typename T, int NP, int LANES>
__global__ void __launch_bounds__(NT) selective_scan_kernel(
    const T* __restrict__ u, const T* __restrict__ dt, const float* __restrict__ A,
    const T* __restrict__ Bm, const T* __restrict__ Cm, const float* __restrict__ Dv,
    const float* h0, T* __restrict__ y, float* h_out, int S, int Ch, int N,
    int64_t b_sb, int64_t b_ss, int64_t c_sb, int64_t c_ss) {
  constexpr int NS = NP / LANES;    // states per thread
  constexpr int CPB = NT / LANES;   // channels per block
  __shared__ __align__(16) float sB[TB][NP], sC[TB][NP];
  const int lane = threadIdx.x % LANES;
  const int c = blockIdx.x * CPB + threadIdx.x / LANES;
  const int64_t b = blockIdx.y;
  const bool live = c < Ch;
  const int cc = live ? c : Ch - 1;  // past Ch: the last channel's inputs, nothing written
  const int n0 = lane * NS;

  float a[NS], h[NS];
#pragma unroll
  for (int j = 0; j < NS; ++j) {
    const int n = n0 + j;
    const bool ok = n < N;  // states past N: A = 0 and B = C = 0, so h stays 0
    a[j] = ok ? A[(int64_t)cc * N + n] : 0.f;
    h[j] = ok && h0 != nullptr ? h0[(b * Ch + cc) * N + n] : 0.f;
  }
  const float dd = Dv[cc];
  const int64_t row = b * S * Ch + cc;  // element (b, 0, c) of u, dt and y
  float dtc[TC], uc[TC];
#pragma unroll
  for (int i = 0; i < TC; ++i) {
    dtc[i] = i < S ? to_f32(dt[row + (int64_t)i * Ch]) : 0.f;
    uc[i] = i < S ? to_f32(u[row + (int64_t)i * Ch]) : 0.f;
  }

  for (int t0 = 0; t0 < S; t0 += TC) {
    if (t0 % TB == 0) {
      __syncthreads();  // the previous stage's B, C are consumed
      for (int idx = threadIdx.x; idx < TB * NP; idx += NT) {
        const int r = idx / NP, n = idx % NP;
        const int t = t0 + r;
        const bool ok = t < S && n < N;
        sB[r][n] = ok ? to_f32(Bm[b * b_sb + t * b_ss + n]) : 0.f;
        sC[r][n] = ok ? to_f32(Cm[b * c_sb + t * c_ss + n]) : 0.f;
      }
      __syncthreads();
    }
    float dtn[TC], un[TC];  // the next chunk, in flight while this one runs
#pragma unroll
    for (int i = 0; i < TC; ++i) {
      const int t = t0 + TC + i;
      dtn[i] = t < S ? to_f32(dt[row + (int64_t)t * Ch]) : 0.f;
      un[i] = t < S ? to_f32(u[row + (int64_t)t * Ch]) : 0.f;
    }
    // a whole chunk runs as one straight block the compiler can interleave
    // across steps; the last, partial one step by step (S is the same for
    // every thread)
    const int n_steps = min(TC, S - t0);
    auto one = [&](int i) {
      const int r = (t0 + i) % TB;
      float bv[NS], cv[NS];
      load_shared<NS>(bv, &sB[r][n0]);
      load_shared<NS>(cv, &sC[r][n0]);
      const float acc = lane_sum<LANES>(step<T, NS>(h, a, dtc[i], uc[i], bv, cv));
      if (live && lane == 0)
        y[row + (int64_t)(t0 + i) * Ch] = from_f32<T>(__fadd_rn(acc, __fmul_rn(dd, uc[i])));
    };
    if (n_steps == TC) {
#pragma unroll
      for (int i = 0; i < TC; ++i) one(i);
    } else {
#pragma unroll
      for (int i = 0; i < TC; ++i)
        if (i < n_steps) one(i);
    }
#pragma unroll
    for (int i = 0; i < TC; ++i) {
      dtc[i] = dtn[i];
      uc[i] = un[i];
    }
  }
  if (live && h_out != nullptr) {
#pragma unroll
    for (int j = 0; j < NS; ++j)
      if (n0 + j < N) h_out[(b * Ch + c) * N + n0 + j] = h[j];
  }
}

// NS consecutive floats from p: as float4 where `vec` says the layout allows
template <int NS>
__device__ __forceinline__ void load_states(float (&v)[NS], const float* p, int nvalid,
                                            bool vec) {
  if constexpr (NS % 4 == 0) {
    if (vec) {
#pragma unroll
      for (int j = 0; j < NS; j += 4) {
        const float4 q = *reinterpret_cast<const float4*>(p + j);
        v[j] = q.x; v[j + 1] = q.y; v[j + 2] = q.z; v[j + 3] = q.w;
      }
      return;
    }
  }
#pragma unroll
  for (int j = 0; j < NS; ++j) v[j] = j < nvalid ? p[j] : 0.f;
}

template <int NS>
__device__ __forceinline__ void store_states(float* p, const float (&v)[NS], int nvalid,
                                             bool vec) {
  if constexpr (NS % 4 == 0) {
    if (vec) {
#pragma unroll
      for (int j = 0; j < NS; j += 4)
        *reinterpret_cast<float4*>(p + j) = make_float4(v[j], v[j + 1], v[j + 2], v[j + 3]);
      return;
    }
  }
#pragma unroll
  for (int j = 0; j < NS; ++j)
    if (j < nvalid) p[j] = v[j];
}

// one step (S = 1) from h0 into h_out, which may be h0 itself; `vec`: N ==
// NP and A, h0, h_out 16-byte aligned, so a lane's states are float4s
template <typename T, int NP>
__global__ void __launch_bounds__(NT) selective_step_kernel(
    const T* __restrict__ u, const T* __restrict__ dt, const float* __restrict__ A,
    const T* __restrict__ Bm, const T* __restrict__ Cm, const float* __restrict__ Dv,
    const float* h0, T* __restrict__ y, float* h_out, int Ch, int N,
    int64_t b_sb, int64_t c_sb, bool vec) {
  constexpr int NS = NP / STEP_LANES;
  constexpr int CPB = NT / STEP_LANES;
  const int lane = threadIdx.x % STEP_LANES;
  const int c = blockIdx.x * CPB + threadIdx.x / STEP_LANES;
  const int64_t b = blockIdx.y;
  const bool live = c < Ch;
  const int cc = live ? c : Ch - 1;
  const int n0 = lane * NS;
  const int nvalid = N - n0;  // of this lane's NS states (may be <= 0)

  float a[NS], h[NS], bt[NS], ct[NS];
  load_states<NS>(a, A + (int64_t)cc * N + n0, nvalid, vec);
  if (h0 != nullptr) {
    load_states<NS>(h, h0 + (b * Ch + cc) * N + n0, nvalid, vec);
  } else {
#pragma unroll
    for (int j = 0; j < NS; ++j) h[j] = 0.f;
  }
#pragma unroll
  for (int j = 0; j < NS; ++j) {
    bt[j] = j < nvalid ? to_f32(Bm[b * b_sb + n0 + j]) : 0.f;
    ct[j] = j < nvalid ? to_f32(Cm[b * c_sb + n0 + j]) : 0.f;
  }
  const float dtf = to_f32(dt[b * Ch + cc]), uf = to_f32(u[b * Ch + cc]);
  const float acc = lane_sum<STEP_LANES>(step<T, NS>(h, a, dtf, uf, bt, ct));
  if (!live) return;  // after the shuffle, which every lane joins
  if (lane == 0) y[b * Ch + c] = from_f32<T>(__fadd_rn(acc, __fmul_rn(Dv[c], uf)));
  store_states<NS>(h_out + (b * Ch + c) * N + n0, h, nvalid, vec);
}

struct Args {
  const void *u, *dt;
  const float* A;
  const void *Bm, *Cm;
  const float *D, *h0;
  void* y;
  float* h_out;
  int B, S, Ch, N;
  int64_t b_sb, b_ss, c_sb, c_ss;
};

template <typename T, int NP, int LANES>
cudaError_t launch_scan(const Args& a, cudaStream_t st) {
  constexpr int cpb = NT / LANES;
  dim3 grid((unsigned)((a.Ch + cpb - 1) / cpb), (unsigned)a.B);
  selective_scan_kernel<T, NP, LANES><<<grid, NT, 0, st>>>(
      (const T*)a.u, (const T*)a.dt, a.A, (const T*)a.Bm, (const T*)a.Cm, a.D, a.h0, (T*)a.y,
      a.h_out, a.S, a.Ch, a.N, a.b_sb, a.b_ss, a.c_sb, a.c_ss);
  return cudaGetLastError();
}

bool aligned16(const void* p) { return p == nullptr || (uintptr_t)p % 16 == 0; }

template <typename T, int NP>
cudaError_t launch_step(const Args& a, cudaStream_t st) {
  constexpr int cpb = NT / STEP_LANES;
  dim3 grid((unsigned)((a.Ch + cpb - 1) / cpb), (unsigned)a.B);
  const bool vec = a.N == NP && aligned16(a.A) && aligned16(a.h0) && aligned16(a.h_out);
  selective_step_kernel<T, NP><<<grid, NT, 0, st>>>(
      (const T*)a.u, (const T*)a.dt, a.A, (const T*)a.Bm, (const T*)a.Cm, a.D, a.h0, (T*)a.y,
      a.h_out, a.Ch, a.N, a.b_sb, a.c_sb, vec);
  return cudaGetLastError();
}

template <typename T, int NP>
cudaError_t by_lanes(const Args& a, int lanes, cudaStream_t st) {
  if (a.S == 1) return launch_step<T, NP>(a, st);
  switch (lanes) {
    case 1: return launch_scan<T, NP, 1>(a, st);
    case 2: return launch_scan<T, NP, 2>(a, st);
    case 4: return launch_scan<T, NP, 4>(a, st);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t by_state(const Args& a, int lanes, cudaStream_t st) {
  if (a.N <= 4) return by_lanes<T, 4>(a, lanes, st);
  if (a.N <= 8) return by_lanes<T, 8>(a, lanes, st);
  if (a.N <= 16) return by_lanes<T, 16>(a, lanes, st);
  if (a.N <= 32) return by_lanes<T, 32>(a, lanes, st);
  return cudaErrorInvalidValue;
}

}  // namespace

// u, dt: [B, S, Ch] contiguous, of one dtype (dtype 0: f32, 1: bf16); A:
// [Ch, N] f32 contiguous; Bm, Cm: [B, S, N] of u's dtype with strides
// (b_sb, b_ss) and (c_sb, c_ss) in elements and a contiguous last dim; D:
// [Ch] f32; h0: [B, Ch, N] f32 contiguous or null (zeros); y: [B, S, Ch] of
// u's dtype; h_out: [B, Ch, N] f32 contiguous, written with the last state
// (it may be h0).  1 <= N <= 32, B <= 65,535, S >= 1, lanes 1, 2 or 4
// (threads per channel for S > 1; S = 1 runs the decode kernel), checked by
// the caller.
extern "C" int selective_scan_fwd(int dtype, const void* u, const void* dt, const float* A,
                                  const void* Bm, const void* Cm, const float* D,
                                  const float* h0, void* y, float* h_out, int B, int S, int Ch,
                                  int N, int64_t b_sb, int64_t b_ss, int64_t c_sb,
                                  int64_t c_ss, int lanes, void* stream) {
  const Args a{u, dt, A, Bm, Cm, D, h0, y, h_out, B, S, Ch, N, b_sb, b_ss, c_sb, c_ss};
  cudaStream_t st = (cudaStream_t)stream;
  if (N < 1 || S < 1 || h_out == nullptr) return (int)cudaErrorInvalidValue;
  switch (dtype) {
    case 0: return (int)by_state<float>(a, lanes, st);
    case 1: return (int)by_state<__nv_bfloat16>(a, lanes, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
