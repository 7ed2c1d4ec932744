// K3: piecewise-constant pair expansion with in-kernel sort-key decode.
//
// Replaces the Pallas kernel `_expand_kernel` reached from
// log_tpu/ops/expand_pallas.py:_expand_fwd_impl (expand_pallas_with_keys).
// Gaussian i owns the pair columns [offs[i], offs[i+1]) (the last run ends
// at A). Every column j receives a copy of its owner's 10 f32 value rows and
// 3 int32 rows (run offset, packed rect geometry x0 + 32*(y0 + 512*w),
// caller id), plus two sort keys:
//   tile_key  = (y0 + k / w) * tiles_x + x0 + k % w, with k = j - offs[i],
//               or num_tiles for columns >= total;
//   depth_key = the depth row, or 3e38 for columns >= total.
// The copy is exact, like the TPU kernel's one-hot matmul at HIGHEST
// precision; integer rows are int32 here, not f32 lanes.
//
// Bound on the H100: device memory bandwidth on the (13 + 2) x A output
// writes (~0.5 GB at A = 2^23); the per-column binary search over the
// P run starts reads ~log2(P) words that stay in L2.
// Design: one thread per output column. Large splats own thousands of
// columns, so a thread per gaussian would be badly imbalanced; a thread per
// column balances by construction, and neighbouring threads mostly share an
// owner, so the value reads coalesce or broadcast. The TPU's windowed
// one-hot matmul (an MXU device to avoid gathers) is not carried over.
// Dropping the row replication for index gathers is later work.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kValRows = 10;  // px py cxx cxy cyy opac r g b depth
constexpr int kRowDepth = 9;

__global__ void expand_keys_kernel(const float* __restrict__ vals,
                                   const int* __restrict__ ints, int P,
                                   const int* __restrict__ total_ptr, int A,
                                   int tiles_x,
                                   int num_tiles, float* __restrict__ out_vals,
                                   int* __restrict__ out_ints,
                                   int* __restrict__ tile_key,
                                   float* __restrict__ depth_key) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= A) return;
  const int* offs = ints;  // int row 0: ascending run starts
  // owner = the largest i with offs[i] <= j (zero-length runs share a start
  // with their successor, so the largest index is the run that covers j)
  int lo = 0, hi = P - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (__ldg(offs + mid) <= j) lo = mid; else hi = mid - 1;
  }
  const int i = lo;
  const int total = __ldg(total_ptr);
  const long long sP = P, sA = A;
#pragma unroll
  for (int r = 0; r < kValRows; ++r)
    out_vals[r * sA + j] = __ldg(vals + r * sP + i);
  const int off = __ldg(ints + i);
  const int geo = __ldg(ints + sP + i);
  const int gid = __ldg(ints + 2 * sP + i);
  out_ints[j] = off;
  out_ints[sA + j] = geo;
  out_ints[2 * sA + j] = gid;
  int tile = num_tiles;
  float dkey = 3.0e38f;
  if (j < total) {
    const int x0 = geo & 31;
    const int y0 = (geo >> 5) & 511;
    const int w = max(geo >> 14, 1);
    const int k = j - off;
    tile = (y0 + k / w) * tiles_x + x0 + k % w;
    dkey = __ldg(vals + kRowDepth * sP + i);
  }
  tile_key[j] = tile;
  depth_key[j] = dkey;
}

}  // namespace

// vals: (10, P) f32, ints: (3, P) int32 (row 0 = ascending run starts),
// total: device int32 scalar (columns >= total get the sentinel keys),
// outputs out_vals (10, A) f32, out_ints (3, A) int32, tile_key (A,) int32,
// depth_key (A,) f32. Returns cudaGetLastError().
extern "C" int log_expand_with_keys(const void* vals, const void* ints, int P,
                                    const void* total, int A, int tiles_x,
                                    int num_tiles, void* out_vals,
                                    void* out_ints, void* tile_key,
                                    void* depth_key, void* stream) {
  if (P < 1 || A < 0) return (int)cudaErrorInvalidValue;
  const int threads = 256;
  const int blocks = (A + threads - 1) / threads;
  if (blocks > 0) {
    expand_keys_kernel<<<blocks, threads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(vals), static_cast<const int*>(ints), P,
        static_cast<const int*>(total), A, tiles_x, num_tiles, static_cast<float*>(out_vals),
        static_cast<int*>(out_ints), static_cast<int*>(tile_key),
        static_cast<float*>(depth_key));
  }
  return (int)cudaGetLastError();
}
