// K6: order-preserving stream compaction of 32-bit columns by a keep mask.
//
// Replaces the Pallas kernel `_compact_kernel` reached from
// log_tpu/ops/compact_pallas.py:stream_compact_cols (the render frame's
// slice compaction under LOG_TPU_COMPACT=pallas). The kept rows of up to 16
// columns move, in row order, to the first slots of (n_cols, k) outputs;
// index[s] is the source row of slot s and valid[s] = (s < kept count).
// Slots past the kept count (or none when more than k rows are kept: the
// first k win) get zero words, index = cap and valid = 0, the contract of
// the sort compaction (train_step._compact_flat_cols_sort).
//
// One cooperative launch, every block resident (grid = SMs x blocks per
// SM, at most one block per 1024-row tile). Block b owns a contiguous run
// of tiles, one row per thread:
//   1. count: each thread loads its rows' keep bytes of up to 32 tiles (32
//      bits of a register, independent loads), warps ballot and popc, and
//      the block writes its kept count to scratch[b];
//   2. grid barrier; every block sums scratch[0, b) (its first slot) and
//      scratch[0, grid) (the kept total) itself, in a fixed order;
//   3. scatter, 8 tiles a step: the warps' counts of each tile are scanned
//      in shared memory; each kept row's slot is the block's running base +
//      its tile's offset + its warp's offset + the popc of the lower lanes.
//      Each warp queues its kept rows of the step (row and slot) in shared
//      memory and its lanes take them in turn, all of a row's loads issued
//      before its stores (the column loop unrolled to a bound of 8 or 16
//      columns). A thread walks a dozen tiles, and at the main path's
//      density (~16%) almost every warp holds a kept row in every tile:
//      without the queue each tile would cost the warp a full load
//      latency, with it a step of 8 tiles costs about two. Before it the
//      grid fills the [total, k) tail (zero words, index = cap, valid = 0)
//      in a grid-stride loop: those slots take no kept row, and spread
//      over every block the fill does not fall on the few blocks that own
//      rows [total, k).
// Every scratch word is written in phase 1 before any block reads it, so no
// state carries over from one call to the next; a group's keep bits stay
// in a register between the phases (the mask is read twice only when a
// block owns more than 32 tiles). Words move as raw 32 bits, so NaN
// payloads and int32 values >= 2^24 stay exact (the TPU kernel carries them
// through f32 lanes and cannot).
//
// Bound on the H100: device memory bandwidth: the keep mask read once, the
// kept rows' words read once and the (n_cols, k) outputs, index and valid
// written once. Reads move in 32-byte sectors: on the flat_slice frame the
// kept rows (16% of them) lie in 32% of the columns' sectors, so about
// twice the kept words' bytes are fetched. What the design works on is
// keeping enough loads in flight.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 1024;  // rows per tile, one per thread
constexpr int kWarps = kBlock / 32;
constexpr int kGroup = 32;  // tiles whose keep bits one register holds
constexpr int kSub = 8;  // tiles per scatter step (offsets fit 13 bits)
constexpr int kMaxCols = 16;

struct ColPtrs {
  const uint32_t* in[kMaxCols];
};

// bit i: the keep flag of this thread's row in tile g0 + i, i < n
__device__ __forceinline__ unsigned keep_bits(const uint8_t* keep,
                                              long long cap, int g0, int n) {
  unsigned bits = 0u;
#pragma unroll 8
  for (int i = 0; i < n; ++i) {
    const long long row = (long long)(g0 + i) * kBlock + threadIdx.x;
    if (row < cap && keep[row] != 0) bits |= 1u << i;
  }
  return bits;
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

__device__ __forceinline__ int warp_sum(int v) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) v += __shfl_xor_sync(0xffffffffu, v, d);
  return v;
}

// NC: a compile-time bound on n_cols, so that a kept row's loads are all
// issued before its stores and the column pointers stay in registers
template <int NC>
__global__ void __launch_bounds__(kBlock, 2)
compact_kernel(const uint8_t* __restrict__ keep, long long cap, int k,
               int n_tiles, int per_block, ColPtrs cols, int n_cols,
               uint32_t* __restrict__ out, int* __restrict__ index,
               uint8_t* __restrict__ valid, int* __restrict__ block_counts) {
  __shared__ int s_pop[kSub][kWarps];  // [tile of the step][warp]
  __shared__ int s_tile[32];
  // per warp: its kept rows of the step, (row - row0) << 16 | slot - base
  __shared__ unsigned s_q[kWarps][kSub * 32];
  __shared__ int s_red[2][kWarps];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int t0 = min((int)blockIdx.x * per_block, n_tiles);
  const int t1 = min(t0 + per_block, n_tiles);

  // 1. count this block's kept rows
  unsigned bits0 = 0u;
  int acc = 0;  // the warp's kept rows (the same in every lane)
  for (int g0 = t0; g0 < t1; g0 += kGroup) {
    const int n = min(kGroup, t1 - g0);
    const unsigned bits = keep_bits(keep, cap, g0, n);
    if (g0 == t0) bits0 = bits;
    for (int i = 0; i < n; ++i)
      acc += __popc(__ballot_sync(0xffffffffu, (bits >> i) & 1u));
  }
  if (lane == 0) s_red[0][warp] = acc;
  __syncthreads();
  if (warp == 0) {
    const int v = warp_sum(s_red[0][lane]);
    if (lane == 0) block_counts[blockIdx.x] = v;
  }

  // 2. every block's counts are written (the grid barrier orders memory)
  cooperative_groups::this_grid().sync();
  int before = 0, total = 0;
  for (int j = tid; j < (int)gridDim.x; j += kBlock) {
    const int v = __ldcg(block_counts + j);  // written in this launch: L2
    total += v;
    if (j < (int)blockIdx.x) before += v;
  }
  before = warp_sum(before);
  total = warp_sum(total);
  if (lane == 0) {
    s_red[0][warp] = before;
    s_red[1][warp] = total;
  }
  __syncthreads();
  before = warp_sum(s_red[0][lane]);
  total = warp_sum(s_red[1][lane]);

  // 3. the [total, k) tail, spread over the grid (stores only, disjoint
  // from the kept rows' slots), then the ranked scatter, kSub tiles a step
  const long long sk = k;
  for (long long slot = total + (long long)blockIdx.x * kBlock + tid;
       slot < k; slot += (long long)gridDim.x * kBlock) {
#pragma unroll
    for (int c = 0; c < NC; ++c)
      if (c < n_cols) out[c * sk + slot] = 0u;
    index[slot] = (int)cap;
    valid[slot] = 0;
  }
  int base = before;  // slot of the step's first kept row
  for (int g0 = t0; g0 < t1; g0 += kGroup) {
    const int n = min(kGroup, t1 - g0);
    const unsigned bits = g0 == t0 ? bits0 : keep_bits(keep, cap, g0, n);
    for (int s0 = 0; s0 < n; s0 += kSub) {
      const int m = min(kSub, n - s0);
      for (int i = 0; i < m; ++i) {
        const unsigned b = __ballot_sync(0xffffffffu, (bits >> (s0 + i)) & 1u);
        if (lane == 0) s_pop[i][warp] = __popc(b);
      }
      __syncthreads();
      if (warp < m) {  // warp w: exclusive warp offsets of tile w
        const int v = s_pop[warp][lane];
        const int incl = warp_scan(v);
        s_pop[warp][lane] = incl - v;
        if (lane == 31) s_tile[warp] = incl;
      }
      __syncthreads();
      if (warp == 0) {  // exclusive tile offsets inside the step
        const int v = lane < m ? s_tile[lane] : 0;
        const int incl = warp_scan(v);
        __syncwarp();
        s_tile[lane] = incl - v;
        if (lane == 31) s_red[0][0] = incl;  // the step's kept rows
      }
      __syncthreads();
      // queue the warp's kept rows (row and slot offsets, 13 bits each)
      int nq = 0;
      for (int i = 0; i < m; ++i) {
        const bool kept = (bits >> (s0 + i)) & 1u;
        const unsigned b = __ballot_sync(0xffffffffu, kept);
        const int below = __popc(b & ((1u << lane) - 1u));
        if (kept)
          s_q[warp][nq + below] =
              (unsigned)(i * kBlock + tid) << 16 |
              (unsigned)(s_tile[i] + s_pop[i][warp] + below);
        nq += __popc(b);
      }
      __syncwarp();
      // the queue's rows spread over the warp's lanes: a lane's loads are
      // all issued before its stores
      const long long row0 = (long long)(g0 + s0) * kBlock;
      for (int j = lane; j < nq; j += 32) {
        const unsigned e = s_q[warp][j];
        const long long row = row0 + (e >> 16);
        const int slot = base + (int)(e & 0xFFFFu);
        if (slot < k) {
          uint32_t v[NC];
#pragma unroll
          for (int c = 0; c < NC; ++c)
            if (c < n_cols) v[c] = __ldg(cols.in[c] + row);
#pragma unroll
          for (int c = 0; c < NC; ++c)
            if (c < n_cols) out[c * sk + slot] = v[c];
          index[slot] = (int)row;
          valid[slot] = 1;
        }
      }
      base += s_red[0][0];
      // before its first barrier the next step writes only s_pop[.][warp]
      // (and this warp's queue), which no other warp reads after this
      // step's second barrier; s_tile and s_red[0][0] only after that first
      // barrier, which every thread reaches after the reads above
    }
  }
}

template <int NC>
cudaError_t launch(const uint8_t* keep, long long cap, int k,
                   const ColPtrs& cols, int n_cols, uint32_t* out,
                   int* index, uint8_t* valid, int* scratch,
                   cudaStream_t stream) {
  int n_tiles = (int)((cap + kBlock - 1) / kBlock);
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, compact_kernel<NC>, kBlock, 0);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorLaunchOutOfResources;
  const int resident = sms * per_sm;
  int per_block = (n_tiles + resident - 1) / resident;
  const int grid = (n_tiles + per_block - 1) / per_block;
  ColPtrs cp = cols;
  void* args[] = {&keep, &cap, &k, &n_tiles, &per_block, &cp,
                  &n_cols, &out, &index, &valid, &scratch};
  return cudaLaunchCooperativeKernel((const void*)compact_kernel<NC>,
                                     dim3(grid), dim3(kBlock), args, 0,
                                     stream);
}

}  // namespace

// keep: (cap,) bool bytes; cols: host array of n_cols device pointers to
// (cap,) 32-bit columns; out: (n_cols, k) 32-bit; index: (k,) int32; valid:
// (k,) bool bytes; scratch: ceil(cap / 1024) int32 words of device memory
// (the blocks' kept counts; no contents are read before this call writes
// them). Needs k <= cap < 2^31. One cooperative launch; returns
// cudaGetLastError() (or the launch's own error).
extern "C" int log_stream_compact(const void* keep, long long cap, int k,
                                  const void* const* cols, int n_cols,
                                  void* out, void* index, void* valid,
                                  void* scratch, void* stream) {
  if (n_cols < 1 || n_cols > kMaxCols || k < 0 || k > cap ||
      cap >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  if (cap == 0) return (int)cudaGetLastError();
  ColPtrs cp;
  for (int c = 0; c < kMaxCols; ++c)
    cp.in[c] = c < n_cols ? static_cast<const uint32_t*>(cols[c]) : nullptr;
  const uint8_t* kp = static_cast<const uint8_t*>(keep);
  uint32_t* o = static_cast<uint32_t*>(out);
  int* ix = static_cast<int*>(index);
  uint8_t* va = static_cast<uint8_t*>(valid);
  int* counts = static_cast<int*>(scratch);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      n_cols <= 8
          ? launch<8>(kp, cap, k, cp, n_cols, o, ix, va, counts, s)
          : launch<kMaxCols>(kp, cap, k, cp, n_cols, o, ix, va, counts, s);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
