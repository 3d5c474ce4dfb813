// Hint-driven row gather for Hopper (sm_90a), in CUDA C++: out[b] =
// table[idx[b]], the CAPre kernel.
//
// Replaces the TPU kernel `prefetch_gather_kernel` of
// src/repro/kernels/prefetch_gather.py (Pallas, grid (B, D / block_d), the
// indices as scalar-prefetch operands that steer each row's HBM->VMEM DMA;
// D must be a multiple of 128 there, and the JAX wrapper pads it).
//
// What bounds it on the H100: bytes.  It reads B rows and the B indices
// and writes B rows, with no arithmetic; at the decode shape (4 rows of
// 4096 bf16) that is 64 KB, nanoseconds at 3.35 TB/s, so the launch sets
// its time; at the prefill shape (2048 rows) 32 MB, about 10 us.
//
// Design:
//   * one block per (row b, chunk of the row); the block loads its own
//     index from device memory (int32 or int64, with any element stride),
//     so no index is read on the host and nothing synchronises;
//   * an index outside [0, N) is a device-side assert, as in PyTorch's own
//     CUDA indexing, never a read outside the table;
//   * the copy is of bytes, so any dtype and any D: the launcher picks the
//     widest unit (16, 8, 4, 2 or 1 bytes) that divides the row's bytes,
//     the table's row stride and both base addresses, so 16-byte vector
//     loads are used exactly where the layout allows them and narrower
//     ones otherwise (f32 at D = 130: 8 bytes); rows need no tail, since
//     the unit divides them;
//   * a thread copies one unit; a block covers NT units of its row.
// TMA or cp.async pipelining of the rows is later work.
//
// The launcher has a plain C interface (loaded with ctypes) and returns
// the cudaError_t of the launch.

#include <assert.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;  // threads per block; one unit each

template <typename U>
__global__ void __launch_bounds__(NT) gather_kernel(
    const char* __restrict__ table, const void* __restrict__ idx, int idx64,
    int64_t idx_stride, char* __restrict__ out, int64_t n_rows,
    int64_t row_units, int64_t table_row_bytes) {
  const int64_t b = blockIdx.x;
  const int64_t u = (int64_t)blockIdx.y * NT + threadIdx.x;
  const int64_t r = idx64 ? static_cast<const int64_t*>(idx)[b * idx_stride]
                          : static_cast<const int32_t*>(idx)[b * idx_stride];
  assert(r >= 0 && r < n_rows);
  if (u >= row_units) return;
  const U* src = reinterpret_cast<const U*>(table + r * table_row_bytes);
  U* dst = reinterpret_cast<U*>(out) + b * row_units;
  dst[u] = src[u];
}

template <typename U>
cudaError_t launch(const void* table, const void* idx, int idx64, int64_t idx_stride,
                   void* out, int64_t n_rows, int64_t B, int64_t row_bytes,
                   int64_t table_row_bytes, cudaStream_t stream) {
  const int64_t units = row_bytes / (int64_t)sizeof(U);
  dim3 grid((unsigned)B, (unsigned)((units + NT - 1) / NT));
  gather_kernel<U><<<grid, NT, 0, stream>>>(
      static_cast<const char*>(table), idx, idx64, idx_stride, static_cast<char*>(out),
      n_rows, units, table_row_bytes);
  return cudaGetLastError();
}

}  // namespace

// table: n_rows rows of row_bytes bytes, table_row_bytes apart; idx: B
// indices (int64 when idx64, else int32), idx_stride elements apart; out: B
// contiguous rows.  unit: the copy width in bytes (16, 8, 4, 2 or 1), which
// the caller has checked divides row_bytes, table_row_bytes and both base
// addresses.  B >= 1 and row_bytes >= 1 (checked by the caller); B and the
// number of NT-unit chunks of a row must fit a grid (2^31 - 1 and 65,535).
extern "C" int prefetch_gather(
    const void* table, const void* idx, int idx64, int64_t idx_stride, void* out,
    int64_t n_rows, int64_t B, int64_t row_bytes, int64_t table_row_bytes, int unit,
    void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  switch (unit) {
    case 16: return (int)launch<uint4>(table, idx, idx64, idx_stride, out, n_rows, B,
                                       row_bytes, table_row_bytes, st);
    case 8: return (int)launch<uint2>(table, idx, idx64, idx_stride, out, n_rows, B,
                                      row_bytes, table_row_bytes, st);
    case 4: return (int)launch<uint32_t>(table, idx, idx64, idx_stride, out, n_rows, B,
                                         row_bytes, table_row_bytes, st);
    case 2: return (int)launch<uint16_t>(table, idx, idx64, idx_stride, out, n_rows, B,
                                         row_bytes, table_row_bytes, st);
    case 1: return (int)launch<uint8_t>(table, idx, idx64, idx_stride, out, n_rows, B,
                                        row_bytes, table_row_bytes, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
