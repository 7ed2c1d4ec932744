// K2: per-tile back-to-front gradient of the compositing, per pair.
//
// Replaces the Pallas kernel `_bwd_kernel` reached from
// log_tpu/ops/rasterize_tiled.py:_run_backward (the VJP of _raster_core).
// Inputs are K1's: the packed (16, A + 128) pair array, the tile runs, the
// per-tile chunk bound `cend` and the final transmittance `tfinal`, plus the
// cotangents dL/dcolor (3, Hp, Wp) and dL/dalpha (Hp, Wp) with alpha the
// per-pixel 1 - T composited alpha (the caller passes -dL/dtfinal).
// Output: rows 0..8 of the per-pair gradient array,
// d[px, py, cxx, cxy, cyy, opacity, r, g, b], for every pair of every tile;
// the caller zero-fills the array (rows 9..15, dead pairs, pairs past cend,
// pairs that no pixel's gate passes).
//
// One block of 1024 threads walks one 8 x 128 tile, one thread per pixel,
// over the chunks K1 composited (min(n_chunks, cend[t]), the same
// 128-pair chunk base), BACK to front. Every pixel runs the recurrence
// sequentially from its last pair to its first:
//   T  <- tfinal, u <- tfinal * (bg . dC) - dalpha * tfinal, with a
//        tfinal below the smallest normal f32 taken as 0 (the forward's
//        running T went denormal, so dividing it back up by the (1 - alpha)
//        amplifies its rounding without bound: that pixel gives its pairs
//        no gradient, as one whose T underflowed to 0);
//   per pair with alpha kept (power <= 0, alpha >= 1/255):
//     T_i = T / (1 - alpha)            (transmittance before the pair)
//     w   = alpha * T_i, weight kept iff T_i (1 - alpha) >= 1e-4
//     dL/dalpha = [kept] T_i (rgb . dC) - u / (1 - alpha)
//     passed to opacity and power only where op * exp(power) < 0.99;
//     u += [kept] w (rgb . dC);  T = T_i.
// The same gates as K1 and as the TPU kernel's math.
//
// Bound on the H100: FP32 operations, one expf and ~40 flops per (pair,
// pixel) whose gate passes (14.5% of the walked combinations on the main
// path), plus the reduction of nine sums per pair over the tile's pixels;
// the records are read once. Evaluating every pair at every pixel and
// reducing it with nine 5-step shuffle sums per touching warp spends most
// of its instructions on zeros and shuffles. What bounds this design is
// the instruction count of its pair loop (the gradient terms and the
// 16-shuffle reduction on every warp whose patch the box meets) and four
// barriers per chunk.
// Design:
// - footprint culling (footprint.cuh, shared with K1): each warp owns an
//   8 x 4 pixel patch and walks only the pairs whose conservative gate box
//   meets it; a skipped pixel has alpha 0, so T and u pass unchanged and
//   its gradient is 0;
// - a transpose (reduce-scatter) warp reduction: the nine components,
//   padded to 16, are halved over lanes 16, 8, 4, 2, 1 in 16 shuffles
//   (not 45); lane 2c ends with the warp's sum of component c;
// - only warps whose pixels pass a pair's gate write a partial, and set
//   their bit in the pair's touch mask (an integer atomicOr); the block sum
//   adds the partials of the set bits in ascending warp order. The order is
//   fixed, so the result is deterministic (no float atomics);
// - partials per 64-pair half chunk, [32 warps][9][64 + 1] floats: the
//   dynamic shared memory is 90,240 bytes, so two blocks fit on an SM; at
//   32 registers a thread (a few spills) they measured faster than one
//   block at 64 registers;
// - triple-buffered cp.async staging as in K1: chunk c - 2's records are
//   copied and chunk c - 1's masks computed while chunk c is walked.
// Not carried over from the TPU: the triangular MXU products in log space
// that computed the recurrence, and the read-modify-write of 128-lane
// chunks shared with neighbouring tiles (each block writes only its pairs).
#include "footprint.cuh"

namespace {

using namespace footprint;

constexpr int kRows = 9;  // px py cxx cxy cyy opac r g b
constexpr int kHalf = kChunk / 2;
constexpr int kPartStride = kHalf + 1;  // odd: the partial writes spread
constexpr int kRecFloats = 3 * kRows * kChunk;
constexpr int kPartFloats = kWarps * kRows * kPartStride;
constexpr size_t kSmemBytes =
    (size_t)(kRecFloats + kPartFloats) * sizeof(float) +
    (size_t)(2 * kChunk + kChunk) * sizeof(unsigned);

struct BwdRows {
  __device__ int operator()(int r) const { return r; }
};

// Reduce-scatter of nine per-lane values over the warp: returns, in lanes
// 2c and 2c + 1 (c < 9), the warp's sum of component c. Each step keeps
// the half of the values selected by one lane bit and adds the partner's
// copy of that half, so the order of every sum is fixed.
template <int N>
__device__ __forceinline__ void halve(float (&v)[16], int lane) {
  const bool upper = (lane & (2 * N)) != 0;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const float send = upper ? v[i] : v[i + N];
    const float keep = upper ? v[i + N] : v[i];
    v[i] = keep + __shfl_xor_sync(0xffffffffu, send, 2 * N);
  }
}

__device__ __forceinline__ float warp_transpose_sum(const float (&g)[kRows],
                                                    int lane) {
  float v[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) v[i] = i < kRows ? g[i] : 0.f;
  halve<8>(v, lane);
  halve<4>(v, lane);
  halve<2>(v, lane);
  halve<1>(v, lane);
  return v[0] + __shfl_xor_sync(0xffffffffu, v[0], 1);
}

__global__ void __launch_bounds__(kTilePix, 2)
rasterize_bwd_kernel(const float* __restrict__ pair, long long pstride,
                     bool vec16, const int* __restrict__ tile_start,
                     const int* __restrict__ tile_count,
                     const int* __restrict__ cend, int tiles_x, int Hp, int Wp,
                     const float* __restrict__ tfinal,
                     const float* __restrict__ dcolor,
                     const float* __restrict__ dalpha,
                     const float* __restrict__ bg, float* __restrict__ grad) {
  extern __shared__ __align__(16) float smem[];
  float* s_rec = smem;                      // [3][kRows][kChunk]
  float* s_part = smem + kRecFloats;        // [kWarps][kRows][kPartStride]
  unsigned* s_mask = reinterpret_cast<unsigned*>(s_part + kPartFloats);
  unsigned* s_touch = s_mask + 2 * kChunk;  // [kChunk]

  const int t = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int start = tile_start[t];
  const int count = tile_count[t];
  const long long off0 = (long long)(start / kChunk) * kChunk;
  int n_chunks = (int)((start + count - off0 + kChunk - 1) / kChunk);
  n_chunks = min(n_chunks, cend[t]);
  const int tile_y = t / tiles_x;
  const int tx0 = (t - tile_y * tiles_x) * kTileW;
  const int ty0 = tile_y * kTileH;
  int px, py;
  patch_pixel(warp, lane, tx0, ty0, &px, &py);
  const float fx = (float)px;
  const float fy = (float)py;

  const long long npix = (long long)Hp * Wp;
  const long long p = (long long)py * Wp + px;
  const float dc0 = dcolor[p];
  const float dc1 = dcolor[npix + p];
  const float dc2 = dcolor[2 * npix + p];
  const float tf_raw = tfinal[p];
  const float tf = tf_raw < kTNormalMin ? 0.f : tf_raw;
  float T = tf;
  float u = tf * (bg[0] * dc0 + bg[1] * dc1 + bg[2] * dc2) - dalpha[p] * tf;

  // step i walks chunk n_chunks - 1 - i; its run inside the chunk: [lo, hi)
  auto range = [&](int i, int* lo, int* hi) {
    const long long base = off0 + (long long)(n_chunks - 1 - i) * kChunk;
    const long long lo_ll = (long long)start - base;
    const long long hi_ll = (long long)start + count - base;
    *lo = lo_ll > 0 ? (int)lo_ll : 0;
    *hi = hi_ll < kChunk ? (int)hi_ll : kChunk;
  };
  auto stage = [&](int i) {
    if (i < n_chunks) {
      int lo, hi;
      range(i, &lo, &hi);
      stage_chunk<kRows>(s_rec + (i % 3) * kRows * kChunk, pair, pstride,
                         off0 + (long long)(n_chunks - 1 - i) * kChunk, lo,
                         hi, vec16, BwdRows(), tid);
    }
    cp_async_commit();
  };
  auto mask_of = [&](int i) {
    int lo, hi;
    range(i, &lo, &hi);
    if (tid < lo || tid >= hi) return 0u;
    const float* rec = s_rec + (i % 3) * kRows * kChunk + tid;
    const Box b = footprint_box(rec[0], rec[kChunk], rec[2 * kChunk],
                                rec[3 * kChunk], rec[4 * kChunk],
                                rec[5 * kChunk], rec[6 * kChunk],
                                rec[7 * kChunk], rec[8 * kChunk]);
    return patch_mask(b, tx0, ty0);
  };

  if (n_chunks > 0) {
    stage(0);
    stage(1);
    cp_async_wait_all();
    __syncthreads();
    if (tid < kChunk) {
      s_mask[tid] = mask_of(0);
      s_touch[tid] = 0u;
    }
    __syncthreads();
  }

  for (int i = 0; i < n_chunks; ++i) {
    // chunk i's records and masks are in place, chunk i + 1's records are
    // staged; buffer (i + 2) % 3 was last read in step i - 1
    stage(i + 2);
    if (tid < kChunk && i + 1 < n_chunks)
      s_mask[((i + 1) & 1) * kChunk + tid] = mask_of(i + 1);
    int lo, hi;
    range(i, &lo, &hi);
    const long long base = off0 + (long long)(n_chunks - 1 - i) * kChunk;
    const float* rec = s_rec + (i % 3) * kRows * kChunk;
    const unsigned* mask = s_mask + (i & 1) * kChunk;

    for (int h = 1; h >= 0; --h) {  // upper half first: back to front
      const int kb = h * kHalf;
      const int h_lo = max(lo, kb), h_hi = min(hi, kb + kHalf);
      for (int k1 = kb + kHalf; k1 > h_lo; k1 -= 32) {
        const int k0 = k1 - 32;
        unsigned mine = __ballot_sync(0xffffffffu,
                                      (mask[k0 + lane] >> warp) & 1u);
        while (mine) {  // warp-uniform: this warp's pairs, back to front
          const int j = 31 - __clz(mine);
          mine &= ~(1u << j);
          const int k = k0 + j;  // masks outside [lo, hi) are 0
          float g[kRows];
#pragma unroll
          for (int r = 0; r < kRows; ++r) g[r] = 0.f;
          bool touched = false;
          const float dx = rec[k] - fx;
          const float dy = rec[kChunk + k] - fy;
          const float cxx = rec[2 * kChunk + k];
          const float cxy = rec[3 * kChunk + k];
          const float cyy = rec[4 * kChunk + k];
          // rounded op by op as in K1 and the plain versions, so that the
          // gates decide as they did in the forward
          const float power = splat_power(dx, dy, cxx, cxy, cyy);
          if (power <= 0.f) {
            const float g_exp = expf(power);
            const float a_unc = __fmul_rn(rec[5 * kChunk + k], g_exp);
            const float alpha = fminf(kAlphaMax, a_unc);
            if (alpha >= kAlphaMin) {
              touched = true;
              const float one_minus = 1.f - alpha;
              const float t_i = T / one_minus;
              const bool kept = t_i * one_minus >= kTEps;
              const float w_m = kept ? alpha * t_i : 0.f;
              const float cdot = rec[6 * kChunk + k] * dc0 +
                                 rec[7 * kChunk + k] * dc1 +
                                 rec[8 * kChunk + k] * dc2;
              if (a_unc < kAlphaMax) {
                const float dl_da = (kept ? t_i * cdot : 0.f) - u / one_minus;
                const float dl_dpower = dl_da * a_unc;
                g[0] = dl_dpower * (-(cxx * dx + cxy * dy));
                g[1] = dl_dpower * (-(cyy * dy + cxy * dx));
                g[2] = dl_dpower * (-0.5f * dx * dx);
                g[3] = dl_dpower * (-dx * dy);
                g[4] = dl_dpower * (-0.5f * dy * dy);
                g[5] = dl_da * g_exp;
              }
              g[6] = w_m * dc0;
              g[7] = w_m * dc1;
              g[8] = w_m * dc2;
              u += w_m * cdot;
              T = t_i;
            }
          }
          if (__any_sync(0xffffffffu, touched)) {
            const float s = warp_transpose_sum(g, lane);
            if ((lane & 1) == 0 && lane < 2 * kRows)
              s_part[(warp * kRows + (lane >> 1)) * kPartStride + k - kb] = s;
            if (lane == 0) atomicOr(&s_touch[k], 1u << warp);
          }
        }
      }
      __syncthreads();

      // block sum of the half: the touching warps' partials, ascending
      for (int e = tid; e < kRows * kHalf; e += kTilePix) {
        const int r = e / kHalf;
        const int k = kb + e - r * kHalf;
        if (k < h_lo || k >= h_hi) continue;
        unsigned m = s_touch[k];
        if (m == 0u) continue;  // the caller zero-filled grad
        float s = 0.f;
        while (m) {
          const int w = __ffs(m) - 1;
          m &= m - 1u;
          s += s_part[(w * kRows + r) * kPartStride + k - kb];
        }
        grad[r * pstride + base + k] = s;
      }
      if (h == 0) cp_async_wait_all();
      // the next half overwrites the partials
      __syncthreads();
      // nobody reads or sets this half's touch masks before the next
      // chunk's walk of the same half, two barriers on
      if (tid < kHalf) s_touch[kb + tid] = 0u;
    }
  }
}

}  // namespace

// pair: (16, pstride) f32; tile_start, tile_count, cend: (num_tiles,) int32;
// tfinal, dalpha: (Hp, Wp) f32; dcolor: (3, Hp, Wp) f32; bg: (3,) f32;
// grad: (16, pstride) f32, zero-filled by the caller; rows 0..8 of the
// pairs inside each tile's composited chunks are written.
// Returns the first CUDA error (attribute setting or launch), else 0.
extern "C" int log_rasterize_bwd(const void* pair, long long pstride,
                                 const void* tile_start,
                                 const void* tile_count, const void* cend,
                                 int num_tiles, int tiles_x, int tiles_y,
                                 const void* tfinal, const void* dcolor,
                                 const void* dalpha, const void* bg,
                                 void* grad, void* stream) {
  if (num_tiles != tiles_x * tiles_y) return (int)cudaErrorInvalidValue;
  if (num_tiles == 0) return (int)cudaGetLastError();
  cudaError_t err = cudaFuncSetAttribute(
      rasterize_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  const int Hp = tiles_y * kTileH;
  const int Wp = tiles_x * kTileW;
  // 16-byte copies need every row start 16-byte aligned
  const bool vec16 = ((uintptr_t)pair % 16 == 0) && (pstride % 4 == 0);
  rasterize_bwd_kernel<<<num_tiles, kTilePix, kSmemBytes,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(pair), pstride, vec16,
      static_cast<const int*>(tile_start), static_cast<const int*>(tile_count),
      static_cast<const int*>(cend), tiles_x, Hp, Wp,
      static_cast<const float*>(tfinal), static_cast<const float*>(dcolor),
      static_cast<const float*>(dalpha), static_cast<const float*>(bg),
      static_cast<float*>(grad));
  return (int)cudaGetLastError();
}
