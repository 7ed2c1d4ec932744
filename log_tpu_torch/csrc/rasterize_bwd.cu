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
// the caller zero-fills the array (rows 9..15, dead pairs, pairs past cend).
//
// One block of 1024 threads walks one 8 x 128 tile, one thread per pixel,
// over the chunks K1 composited (min(n_chunks, cend[t]), the same
// 128-pair chunk base), BACK to front. Each chunk's 9 value rows are staged
// in shared memory. Every pixel runs the recurrence sequentially from its
// last pair to its first:
//   T  <- tfinal, u <- tfinal * (bg . dC) - dalpha * tfinal;
//   per pair with alpha kept (power <= 0, alpha >= 1/255):
//     T_i = T / (1 - alpha)            (transmittance before the pair)
//     w   = alpha * T_i, weight kept iff T_i (1 - alpha) >= 1e-4
//     dL/dalpha = [kept] T_i (rgb . dC) - u / (1 - alpha)
//     passed to opacity and power only where op * exp(power) < 0.99;
//     u += [kept] w (rgb . dC);  T = T_i.
// The same gates as K1 and as the TPU kernel's math.
//
// The nine components of a pair are sums over the tile's 1024 pixels. A
// pair belongs to exactly one tile, so no global atomics are needed: a warp
// shuffle sum per component (skipped when no lane of the warp touches the
// pair), per-warp partials in shared memory [32 warps][9][128 pairs], then
// a fixed-order sum over the 32 warps. The result is deterministic, so a
// training run and the comparison with the plain version are reproducible.
// The partials take 147,456 bytes: dynamic shared memory, one block per SM.
//
// Bound on the H100: FP32/SFU throughput and shuffles in the block (one expf
// and ~40 flops per (pair, pixel), 45 shuffles per (pair, touching warp));
// the pair records are read once per tile. Not carried over from the TPU:
// the triangular MXU products in log space that computed the recurrence,
// and the read-modify-write of 128-lane chunks shared with neighbouring
// tiles (each block writes only its own pairs here).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTileH = 8;
constexpr int kTileW = 128;
constexpr int kTilePix = kTileH * kTileW;
constexpr int kWarps = kTilePix / 32;
constexpr int kChunk = 128;
constexpr int kRows = 9;  // px py cxx cxy cyy opac r g b
constexpr float kAlphaMin = (float)(1.0 / 255.0);
constexpr float kAlphaMax = 0.99f;
constexpr float kTEps = (float)1e-4;
constexpr size_t kSmemBytes =
    (size_t)(kRows * kChunk + kWarps * kRows * kChunk) * sizeof(float);

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__global__ void __launch_bounds__(kTilePix, 1)
rasterize_bwd_kernel(const float* __restrict__ pair, long long pstride,
                     const int* __restrict__ tile_start,
                     const int* __restrict__ tile_count,
                     const int* __restrict__ cend, int tiles_x, int Hp, int Wp,
                     const float* __restrict__ tfinal,
                     const float* __restrict__ dcolor,
                     const float* __restrict__ dalpha,
                     const float* __restrict__ bg, float* __restrict__ grad) {
  extern __shared__ float smem[];
  float* s_rec = smem;                    // [kRows][kChunk]
  float* s_part = smem + kRows * kChunk;  // [kWarps][kRows][kChunk]

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
  const int tile_x = t - tile_y * tiles_x;
  const int py = tile_y * kTileH + tid / kTileW;
  const int px = tile_x * kTileW + tid % kTileW;
  const float fx = (float)px;
  const float fy = (float)py;

  const long long npix = (long long)Hp * Wp;
  const long long p = (long long)py * Wp + px;
  const float dc0 = dcolor[p];
  const float dc1 = dcolor[npix + p];
  const float dc2 = dcolor[2 * npix + p];
  const float tf = tfinal[p];
  float T = tf;
  float u = tf * (bg[0] * dc0 + bg[1] * dc1 + bg[2] * dc2) - dalpha[p] * tf;

  for (int c = n_chunks - 1; c >= 0; --c) {
    const long long base = off0 + (long long)c * kChunk;
    const long long lo_ll = (long long)start - base;
    const long long hi_ll = (long long)start + count - base;
    const int lo = lo_ll > 0 ? (int)lo_ll : 0;
    const int hi = hi_ll < kChunk ? (int)hi_ll : kChunk;
    for (int e = tid; e < kRows * kChunk; e += kTilePix) {
      const int r = e / kChunk;
      const int k = e - r * kChunk;
      if (k >= lo && k < hi) s_rec[e] = __ldg(pair + r * pstride + base + k);
    }
    __syncthreads();

    for (int k = hi - 1; k >= lo; --k) {
      float g[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) g[r] = 0.f;
      bool touched = false;
      const float dx = s_rec[0 * kChunk + k] - fx;
      const float dy = s_rec[1 * kChunk + k] - fy;
      const float cxx = s_rec[2 * kChunk + k];
      const float cxy = s_rec[3 * kChunk + k];
      const float cyy = s_rec[4 * kChunk + k];
      // rounded op by op as in K1 and the plain versions, so that the gates
      // decide as they did in the forward
      const float power = __fsub_rn(
          __fmul_rn(-0.5f, __fadd_rn(__fmul_rn(__fmul_rn(cxx, dx), dx),
                                     __fmul_rn(__fmul_rn(cyy, dy), dy))),
          __fmul_rn(__fmul_rn(cxy, dx), dy));
      if (power <= 0.f) {
        const float g_exp = expf(power);
        const float a_unc = __fmul_rn(s_rec[5 * kChunk + k], g_exp);
        const float alpha = fminf(kAlphaMax, a_unc);
        if (alpha >= kAlphaMin) {
          touched = true;
          const float one_minus = 1.f - alpha;
          const float t_i = T / one_minus;
          const bool kept = t_i * one_minus >= kTEps;
          const float w_m = kept ? alpha * t_i : 0.f;
          const float cr = s_rec[6 * kChunk + k];
          const float cg = s_rec[7 * kChunk + k];
          const float cb = s_rec[8 * kChunk + k];
          const float cdot = cr * dc0 + cg * dc1 + cb * dc2;
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
      // every lane iterates the same k, so the warp is converged here
      float* part = s_part + (warp * kRows) * kChunk + k;
      if (__any_sync(0xffffffffu, touched)) {
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const float s = warp_sum(g[r]);
          if (lane == 0) part[r * kChunk] = s;
        }
      } else if (lane == 0) {
#pragma unroll
        for (int r = 0; r < kRows; ++r) part[r * kChunk] = 0.f;
      }
    }
    __syncthreads();

    for (int e = tid; e < kRows * kChunk; e += kTilePix) {
      const int r = e / kChunk;
      const int k = e - r * kChunk;
      if (k >= lo && k < hi) {
        float s = 0.f;
        for (int w = 0; w < kWarps; ++w) s += s_part[(w * kRows + r) * kChunk + k];
        grad[r * pstride + base + k] = s;
      }
    }
    // the next chunk overwrites the staged rows and the partials
    __syncthreads();
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
  rasterize_bwd_kernel<<<num_tiles, kTilePix, kSmemBytes,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(pair), pstride,
      static_cast<const int*>(tile_start), static_cast<const int*>(tile_count),
      static_cast<const int*>(cend), tiles_x, Hp, Wp,
      static_cast<const float*>(tfinal), static_cast<const float*>(dcolor),
      static_cast<const float*>(dalpha), static_cast<const float*>(bg),
      static_cast<float*>(grad));
  return (int)cudaGetLastError();
}
