// K6: order-preserving stream compaction of 32-bit columns by a keep mask.
//
// Replaces the Pallas kernel `_compact_kernel` reached from
// log_tpu/ops/compact_pallas.py:stream_compact_cols (the render frame's
// slice compaction under LOG_TPU_COMPACT=pallas). The kept rows of up to 16
// columns move, in row order, to the first slots of (n_cols, k) outputs;
// index[s] is the source row of slot s. Slots past the kept count (or all
// of them when more than k rows are kept: the first k win) get zero words
// and index = cap, the contract of the sort compaction
// (train_step._compact_flat_cols_sort).
//
// Three launches:
//   1. count: each 1024-row block counts its kept rows (warp ballot +
//      popc, then a sum over the 32 warps);
//   2. scan: one block turns the block counts into exclusive block offsets
//      and the kept total (warp-shuffle scans, a running carry);
//   3. scatter: each block recomputes its ballots, ranks every kept row
//      (block offset + warp offset + popc of the lower lanes) and copies
//      its words to that slot; threads of rows [total, k) zero-fill those
//      slots.
// Words move as raw 32 bits, so NaN payloads and int32 values >= 2^24 stay
// exact (the TPU kernel carries them through f32 lanes and cannot).
//
// Bound on the H100: device memory bandwidth, the keep mask read twice
// and each column read once and written once at k rows; the scan is
// ~cap / 1024 words. A single pass with decoupled look-back is later work.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 1024;
constexpr int kWarps = kBlock / 32;
constexpr int kMaxCols = 16;

struct ColPtrs {
  const uint32_t* in[kMaxCols];
};

__device__ __forceinline__ bool kept(const uint8_t* keep, long long row,
                                     long long cap) {
  return row < cap && keep[row] != 0;
}

__global__ void __launch_bounds__(kBlock)
count_kernel(const uint8_t* __restrict__ keep, long long cap,
             int* __restrict__ block_counts) {
  __shared__ int s_warp[kWarps];
  const long long row = (long long)blockIdx.x * kBlock + threadIdx.x;
  const unsigned ballot = __ballot_sync(0xffffffffu, kept(keep, row, cap));
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) s_warp[warp] = __popc(ballot);
  __syncthreads();
  if (threadIdx.x < 32) {
    int v = s_warp[threadIdx.x];
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) v += __shfl_down_sync(0xffffffffu, v, d);
    if (threadIdx.x == 0) block_counts[blockIdx.x] = v;
  }
}

// inclusive scan of v over the 32 lanes of a warp
__device__ __forceinline__ int warp_scan(int v) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int u = __shfl_up_sync(0xffffffffu, v, d);
    if (lane >= d) v += u;
  }
  return v;
}

// one block: block_offsets[b] = sum of block_counts[:b]; *total = the sum
__global__ void __launch_bounds__(kBlock)
scan_kernel(const int* __restrict__ block_counts, int n_blocks,
            int* __restrict__ block_offsets, int* __restrict__ total) {
  __shared__ int s_warp[kWarps];
  __shared__ int s_carry;
  if (threadIdx.x == 0) s_carry = 0;
  __syncthreads();
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  for (int base = 0; base < n_blocks; base += kBlock) {
    const int b = base + threadIdx.x;
    const int v = b < n_blocks ? block_counts[b] : 0;
    const int incl = warp_scan(v);
    if (lane == 31) s_warp[warp] = incl;
    __syncthreads();
    if (warp == 0) s_warp[lane] = warp_scan(s_warp[lane]);
    __syncthreads();
    const int carry = s_carry;
    const int excl = carry + (warp > 0 ? s_warp[warp - 1] : 0) + incl - v;
    if (b < n_blocks) block_offsets[b] = excl;
    __syncthreads();  // every thread has read s_carry and s_warp
    if (threadIdx.x == kBlock - 1) s_carry = excl + v;
    __syncthreads();
  }
  if (threadIdx.x == 0) *total = s_carry;
}

__global__ void __launch_bounds__(kBlock)
scatter_kernel(const uint8_t* __restrict__ keep, long long cap, int k,
               const int* __restrict__ block_offsets,
               const int* __restrict__ total_ptr, ColPtrs cols, int n_cols,
               uint32_t* __restrict__ out, int* __restrict__ index) {
  __shared__ int s_warp[kWarps];
  const long long row = (long long)blockIdx.x * kBlock + threadIdx.x;
  const bool keep_row = kept(keep, row, cap);
  const unsigned ballot = __ballot_sync(0xffffffffu, keep_row);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  if (lane == 0) s_warp[warp] = __popc(ballot);
  __syncthreads();
  if (warp == 0) {
    const int v = s_warp[lane];
    s_warp[lane] = warp_scan(v) - v;  // exclusive warp offsets
  }
  __syncthreads();
  const long long sk = k;
  if (keep_row) {
    const int slot = block_offsets[blockIdx.x] + s_warp[warp] +
                     __popc(ballot & ((1u << lane) - 1u));
    if (slot < k) {
      for (int c = 0; c < n_cols; ++c)
        out[c * sk + slot] = __ldg(cols.in[c] + row);
      index[slot] = (int)row;
    }
  }
  if (row < k && row >= __ldg(total_ptr)) {
    for (int c = 0; c < n_cols; ++c) out[c * sk + row] = 0u;
    index[row] = (int)cap;
  }
}

}  // namespace

// keep: (cap,) bool bytes; cols: host array of n_cols device pointers to
// (cap,) 32-bit columns; out: (n_cols, k) 32-bit; index: (k,) int32;
// scratch: 2 * ceil(cap / 1024) + 1 int32 words of device memory (block
// counts, block offsets, the kept total, which is left in its last word).
// Needs k <= cap < 2^31. Returns cudaGetLastError().
extern "C" int log_stream_compact(const void* keep, long long cap, int k,
                                  const void* const* cols, int n_cols,
                                  void* out, void* index, void* scratch,
                                  void* stream) {
  if (n_cols < 1 || n_cols > kMaxCols || k < 0 || k > cap ||
      cap >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  if (cap == 0) return (int)cudaGetLastError();
  ColPtrs cp;
  for (int c = 0; c < kMaxCols; ++c)
    cp.in[c] = c < n_cols ? static_cast<const uint32_t*>(cols[c]) : nullptr;
  const int n_blocks = (int)((cap + kBlock - 1) / kBlock);
  int* counts = static_cast<int*>(scratch);
  int* offsets = counts + n_blocks;
  int* total = offsets + n_blocks;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint8_t* kp = static_cast<const uint8_t*>(keep);
  count_kernel<<<n_blocks, kBlock, 0, s>>>(kp, cap, counts);
  scan_kernel<<<1, kBlock, 0, s>>>(counts, n_blocks, offsets, total);
  scatter_kernel<<<n_blocks, kBlock, 0, s>>>(
      kp, cap, k, offsets, total, cp, n_cols, static_cast<uint32_t*>(out),
      static_cast<int*>(index));
  return (int)cudaGetLastError();
}
