// K5: per-tile front-to-back compositing of depth-sorted PACKED pair records.
//
// Replaces the Pallas kernel `_fwd_kernel_packed` reached from
// log_tpu/ops/rasterize_tiled.py:_run_forward_packed (render_pairs_packed),
// the inference frame of the flat_slice and block-pruned paths. A pair
// record is 8 rows of 32-bit words in an (8, A + 128) array:
//   0 px, 1 py (f32); 2 cxx|cxy, 3 cyy|log(opacity), 4 r|g, 5 b|0, each a
//   u32 holding two bf16 halves (hi | lo); 6, 7 zero.
// A bf16 placed in the top half of an f32 word is that bf16's exact value,
// so the decode is bit operations: hi = u & 0xFFFF0000, lo = u << 16.
//
// Design: K1's. One block of 1024 threads per 8 x 128 tile, one thread per
// pixel; the tile's run is walked in 128-pair chunks from the floor-aligned
// offset, each chunk's records decoded once into shared memory by 768
// threads (one word each), then composited in order by every pixel:
//   alpha = min(0.99, exp(power + log op)), kept iff power <= 0 and
//           alpha >= 1/255;
//   w     = T * alpha if T * (1 - alpha) >= 1e-4, else 0;
//   color += w * rgb; T *= 1 - alpha.
// The block leaves after the first chunk at whose end every pixel has
// T < 1e-4 (the TPU kernel's chunk_cond). The power is rounded product by
// product (no FMA contraction) in the plain version's order, so the alpha
// gates decide as in the plain torch version. Outputs: color (3, Hp, Wp)
// with the background composited under T, and tfinal (Hp, Wp); no stats.
//
// Not carried over from the TPU kernel: the quadratic form on the MXU and
// its 1e-2 gate slack, the bf16 log-cumprod matmul and the bf16 color
// matmul (all f32 and sequential here).
//
// Bound on the H100: FP32 and SFU throughput, ~20 flops and one expf per
// (pair, pixel), as K1; the record read is 24 bytes per pair per tile.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTileH = 8;
constexpr int kTileW = 128;
constexpr int kTilePix = kTileH * kTileW;
constexpr int kChunk = 128;
constexpr int kWords = 6;  // stored rows of a record
// decoded shared rows: px py cxx cxy cyy logop r g b
constexpr int kDecoded = 9;
constexpr float kAlphaMin = (float)(1.0 / 255.0);
constexpr float kAlphaMax = 0.99f;
constexpr float kTEps = (float)1e-4;

__device__ __forceinline__ float splat_power(float dx, float dy, float cxx,
                                             float cxy, float cyy) {
  const float pxx = __fmul_rn(__fmul_rn(cxx, dx), dx);
  const float pyy = __fmul_rn(__fmul_rn(cyy, dy), dy);
  const float pxy = __fmul_rn(__fmul_rn(cxy, dx), dy);
  return __fsub_rn(__fmul_rn(-0.5f, __fadd_rn(pxx, pyy)), pxy);
}

__device__ __forceinline__ float bf16_hi(uint32_t u) {
  return __uint_as_float(u & 0xFFFF0000u);
}

__device__ __forceinline__ float bf16_lo(uint32_t u) {
  return __uint_as_float(u << 16);
}

__global__ void __launch_bounds__(kTilePix)
rasterize_fwd_packed_kernel(const uint32_t* __restrict__ pair,
                            long long pstride,
                            const int* __restrict__ tile_start,
                            const int* __restrict__ tile_count, int tiles_x,
                            int Hp, int Wp, const float* __restrict__ bg,
                            float* __restrict__ color,
                            float* __restrict__ tfinal) {
  __shared__ float s_rec[kDecoded][kChunk];

  const int t = blockIdx.x;
  const int tid = threadIdx.x;
  const int start = tile_start[t];
  const int count = tile_count[t];
  const long long off0 = (long long)(start / kChunk) * kChunk;
  const int n_chunks = (int)((start + count - off0 + kChunk - 1) / kChunk);
  const int tile_y = t / tiles_x;
  const int tile_x = t - tile_y * tiles_x;
  const int py = tile_y * kTileH + tid / kTileW;
  const int px = tile_x * kTileW + tid % kTileW;
  const float fx = (float)px;
  const float fy = (float)py;

  float T = 1.f, cr = 0.f, cg = 0.f, cb = 0.f;
  for (int c = 0; c < n_chunks; ++c) {
    const long long base = off0 + (long long)c * kChunk;
    const long long lo_ll = (long long)start - base;
    const long long hi_ll = (long long)start + count - base;
    const int lo = lo_ll > 0 ? (int)lo_ll : 0;
    const int hi = hi_ll < kChunk ? (int)hi_ll : kChunk;
    if (tid < kWords * kChunk) {
      const int r = tid / kChunk;
      const int k = tid - r * kChunk;
      if (k >= lo && k < hi) {
        const uint32_t u = __ldg(pair + r * pstride + base + k);
        switch (r) {
          case 0: s_rec[0][k] = __uint_as_float(u); break;
          case 1: s_rec[1][k] = __uint_as_float(u); break;
          case 2: s_rec[2][k] = bf16_hi(u); s_rec[3][k] = bf16_lo(u); break;
          case 3: s_rec[4][k] = bf16_hi(u); s_rec[5][k] = bf16_lo(u); break;
          case 4: s_rec[6][k] = bf16_hi(u); s_rec[7][k] = bf16_lo(u); break;
          default: s_rec[8][k] = bf16_hi(u); break;
        }
      }
    }
    __syncthreads();

    for (int k = lo; k < hi; ++k) {
      const float dx = s_rec[0][k] - fx;
      const float dy = s_rec[1][k] - fy;
      const float power = splat_power(dx, dy, s_rec[2][k], s_rec[3][k],
                                      s_rec[4][k]);
      float alpha = 0.f;
      if (power <= 0.f) {
        alpha = fminf(kAlphaMax, expf(__fadd_rn(power, s_rec[5][k])));
        if (!(alpha >= kAlphaMin)) alpha = 0.f;
      }
      const float t_after = T * (1.f - alpha);
      const float w = t_after >= kTEps ? T * alpha : 0.f;
      cr += w * s_rec[6][k];
      cg += w * s_rec[7][k];
      cb += w * s_rec[8][k];
      T = t_after;
    }
    // also orders this chunk's shared reads before the next chunk's staging
    if (!__syncthreads_or(T >= kTEps)) break;
  }

  const long long npix = (long long)Hp * Wp;
  const long long p = (long long)py * Wp + px;
  color[p] = cr + T * bg[0];
  color[npix + p] = cg + T * bg[1];
  color[2 * npix + p] = cb + T * bg[2];
  tfinal[p] = T;
}

}  // namespace

// pair: (8, pstride) 32-bit words; tile_start, tile_count: (num_tiles,)
// int32; bg: (3,) f32; color (3, Hp, Wp) and tfinal (Hp, Wp) f32.
// Returns cudaGetLastError().
extern "C" int log_rasterize_fwd_packed(const void* pair, long long pstride,
                                        const void* tile_start,
                                        const void* tile_count, int num_tiles,
                                        int tiles_x, int tiles_y,
                                        const void* bg, void* color,
                                        void* tfinal, void* stream) {
  if (num_tiles != tiles_x * tiles_y) return (int)cudaErrorInvalidValue;
  if (num_tiles == 0) return (int)cudaGetLastError();
  rasterize_fwd_packed_kernel<<<num_tiles, kTilePix, 0,
                                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(pair), pstride,
      static_cast<const int*>(tile_start), static_cast<const int*>(tile_count),
      tiles_x, tiles_y * kTileH, tiles_x * kTileW,
      static_cast<const float*>(bg), static_cast<float*>(color),
      static_cast<float*>(tfinal));
  return (int)cudaGetLastError();
}
