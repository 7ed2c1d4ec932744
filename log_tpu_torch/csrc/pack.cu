// K4: row pack of the sorted pair rows into the compositing kernel's input.
//
// Replaces the Pallas kernel `_pack_kernel` reached from
// log_tpu/ops/rasterize_tiled.py:_pack_rows_impl (pack_rows). It stacks
// n <= 16 one-dimensional 32-bit rows of length A into an (n_out, A + spare)
// array whose rows n..n_out-1 and whose spare tail columns are zero. Words
// are copied as raw 32 bits, so an int32 row (the gaussian ids) rides an
// f32 array without the f32 round trip the TPU version needed.
//
// Bound on the H100: device memory bandwidth. It reads n*A*4 bytes and
// writes n_out*(A+spare)*4 bytes, with no arithmetic (at A = 2^23 and
// n = 11 about 0.9 GB moved, ~0.3 ms at 3.35 TB/s).
// Design: one thread per output column, looping over the rows, so every
// warp reads and writes 128 contiguous bytes of each row (coalesced). The
// TPU kernel's staging through VMEM row buffers with DMA semaphores has no
// job here. Fusing the pack into the sort's gather is later work.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxRows = 16;

struct RowPtrs {
  const uint32_t* p[kMaxRows];
};

__global__ void pack_rows_kernel(RowPtrs rows, int n_in, int n_out,
                                 long long A, long long stride,
                                 uint32_t* __restrict__ out) {
  const long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= stride) return;
  const bool body = j < A;
#pragma unroll
  for (int r = 0; r < kMaxRows; ++r) {
    if (r >= n_out) break;
    uint32_t v = 0u;
    if (r < n_in && body) v = __ldg(rows.p[r] + j);
    out[(long long)r * stride + j] = v;
  }
}

}  // namespace

// rows: host array of n_in device pointers to (A,) 32-bit rows.
// out: device (n_out, A + spare) 32-bit array. Returns cudaGetLastError().
extern "C" int log_pack_rows(const void* const* rows, int n_in, int n_out,
                             long long A, long long spare, void* out,
                             void* stream) {
  if (n_in < 1 || n_in > n_out || n_out > kMaxRows || A < 0 || spare < 0)
    return (int)cudaErrorInvalidValue;
  RowPtrs rp;
  for (int r = 0; r < kMaxRows; ++r)
    rp.p[r] = r < n_in ? static_cast<const uint32_t*>(rows[r]) : nullptr;
  const long long stride = A + spare;
  const int threads = 256;
  const long long blocks = (stride + threads - 1) / threads;
  if (blocks > 0) {
    pack_rows_kernel<<<(unsigned)blocks, threads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
        rp, n_in, n_out, A, stride, static_cast<uint32_t*>(out));
  }
  return (int)cudaGetLastError();
}
