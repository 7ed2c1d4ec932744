// K1: per-tile front-to-back compositing of depth-sorted pairs.
//
// Replaces the Pallas kernel `_fwd_kernel` reached from
// log_tpu/ops/rasterize_tiled.py:_run_forward (wrapper _raster_core).
// One block of 1024 threads composites one 8 x 128 pixel tile, one thread
// per pixel. The tile's pair run [start, start + count) of the packed
// (16, A + 128) pair array is walked in 128-pair chunks from the
// floor-aligned offset floor(start / 128) * 128; each chunk's records are
// staged through shared memory, then every thread composites them in order:
//   alpha = min(0.99, op * exp(power)), kept iff power <= 0 and
//           alpha >= 1/255;
//   w     = T * alpha if T * (1 - alpha) >= 1e-4, else 0;
//   color += w * rgb; T *= 1 - alpha.
// After each chunk the block stops once every pixel has T < 1e-4
// (__syncthreads_or); cend records the chunks composited, in the TPU
// kernel's units. Stats (stats >= 1): per-pair max weight over the tile's
// pixels, a warp max (redux.sync) folded into shared memory with atomicMax
// and written once per pair, since each pair belongs to exactly one tile.
// Full stats (stats == 2) add the per-pixel max weight and the caller id
// of its pair (pair row 10, int32 bits), chunk by chunk with the TPU
// kernel's tie rule (largest id among equal chunk maxima, first chunk wins).
//
// Bound on the H100: FP32 and SFU issue inside the block, ~20 flops and
// one expf per (pair, pixel); the pair records are 40 bytes per pair per
// tile, read once. Design: sequential per-pixel compositing keeps registers
// small (no per-chunk transmittance matrices); shared-memory staging turns
// every record read into a broadcast. Not carried over from the TPU: the
// log/exp cumprod on the MXU (a TPU device for a sequential recurrence),
// the bf16 accumulation of the inference mode, and the read-modify-write of
// per-pair weights in chunks shared by neighbouring tiles (only needed by
// the TPU's 128-lane DMA alignment).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTileH = 8;
constexpr int kTileW = 128;
constexpr int kTilePix = kTileH * kTileW;
constexpr int kChunk = 128;
// staged rows: px py cxx cxy cyy opac r g b, then the caller id (row 10)
constexpr int kStaged = 10;
constexpr int kRowGid = 10;
constexpr float kAlphaMin = (float)(1.0 / 255.0);
constexpr float kAlphaMax = 0.99f;
constexpr float kTEps = (float)1e-4;

template <int STATS>
__global__ void __launch_bounds__(kTilePix)
rasterize_fwd_kernel(const float* __restrict__ pair, long long pstride,
                     const int* __restrict__ tile_start,
                     const int* __restrict__ tile_count, int tiles_x, int Hp,
                     int Wp, const float* __restrict__ bg,
                     float* __restrict__ color, float* __restrict__ tfinal,
                     int* __restrict__ pid, float* __restrict__ pwp,
                     float* __restrict__ pair_w, int* __restrict__ cend) {
  __shared__ float s_rec[kStaged][kChunk];
  __shared__ unsigned s_pw[kChunk];

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
  float best_w = 0.f;
  int best_id = -1;
  int c = 0;
  while (c < n_chunks) {
    const long long base = off0 + (long long)c * kChunk;
    // the tile's run inside this chunk: [lo, hi)
    const long long lo_ll = (long long)start - base;
    const long long hi_ll = (long long)start + count - base;
    const int lo = lo_ll > 0 ? (int)lo_ll : 0;
    const int hi = hi_ll < kChunk ? (int)hi_ll : kChunk;
    for (int e = tid; e < kStaged * kChunk; e += kTilePix) {
      const int r = e / kChunk;
      const int k = e - r * kChunk;
      if (k >= lo && k < hi) {
        const int row = r < 9 ? r : kRowGid;
        s_rec[r][k] = __ldg(pair + row * pstride + base + k);
      }
    }
    if (STATS > 0 && tid < kChunk) s_pw[tid] = 0u;
    __syncthreads();

    float cw = 0.f;
    int cid = -1;
    for (int k = lo; k < hi; ++k) {
      const float dx = s_rec[0][k] - fx;
      const float dy = s_rec[1][k] - fy;
      const float power =
          -0.5f * (s_rec[2][k] * dx * dx + s_rec[4][k] * dy * dy) -
          s_rec[3][k] * dx * dy;
      float alpha = 0.f;
      if (power <= 0.f) {
        alpha = fminf(kAlphaMax, s_rec[5][k] * expf(power));
        if (!(alpha >= kAlphaMin)) alpha = 0.f;
      }
      const float t_after = T * (1.f - alpha);
      const float w = t_after >= kTEps ? T * alpha : 0.f;
      cr += w * s_rec[6][k];
      cg += w * s_rec[7][k];
      cb += w * s_rec[8][k];
      T = t_after;
      if (STATS == 2) {
        const int gid = __float_as_int(s_rec[9][k]);
        if (w > cw) {
          cw = w;
          cid = gid;
        } else if (w == cw && w > 0.f && gid > cid) {
          cid = gid;
        }
      }
      if (STATS > 0) {
        // w >= 0, so its bit pattern orders like the value
        const unsigned m = __reduce_max_sync(0xffffffffu, __float_as_uint(w));
        if ((tid & 31) == 0 && m != 0u) atomicMax(&s_pw[k], m);
      }
    }
    if (STATS == 2 && cw > best_w) {
      best_w = cw;
      best_id = cid;
    }
    if (STATS > 0) {
      __syncthreads();
      if (tid >= lo && tid < hi) pair_w[base + tid] = __uint_as_float(s_pw[tid]);
    }
    ++c;
    // also orders this chunk's shared reads before the next chunk's staging
    if (!__syncthreads_or(T >= kTEps)) break;
  }

  const long long npix = (long long)Hp * Wp;
  const long long p = (long long)py * Wp + px;
  color[p] = cr + T * bg[0];
  color[npix + p] = cg + T * bg[1];
  color[2 * npix + p] = cb + T * bg[2];
  tfinal[p] = T;
  pid[p] = best_id;
  pwp[p] = best_w;
  if (tid == 0) cend[t] = c;
}

}  // namespace

// pair: (16, pstride) f32 (row 10 = int32 caller ids); tile_start,
// tile_count, cend: (num_tiles,) int32; bg: (3,) f32; color (3, Hp, Wp),
// tfinal/pwp (Hp, Wp) f32, pid (Hp, Wp) int32; pair_w (pstride,) f32,
// zero-initialized by the caller and written only when stats > 0.
// stats: 0 = none, 1 = per-pair weights, 2 = full. Returns cudaGetLastError().
extern "C" int log_rasterize_fwd(const void* pair, long long pstride,
                                 const void* tile_start,
                                 const void* tile_count, int num_tiles,
                                 int tiles_x, int tiles_y, const void* bg,
                                 int stats, void* color, void* tfinal,
                                 void* pid, void* pwp, void* pair_w,
                                 void* cend, void* stream) {
  if (num_tiles != tiles_x * tiles_y || stats < 0 || stats > 2)
    return (int)cudaErrorInvalidValue;
  if (num_tiles == 0) return (int)cudaGetLastError();
  const int Hp = tiles_y * kTileH;
  const int Wp = tiles_x * kTileW;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* pr = static_cast<const float*>(pair);
  const int* ts = static_cast<const int*>(tile_start);
  const int* tc = static_cast<const int*>(tile_count);
  const float* b = static_cast<const float*>(bg);
  float* co = static_cast<float*>(color);
  float* tf = static_cast<float*>(tfinal);
  int* pi = static_cast<int*>(pid);
  float* pp = static_cast<float*>(pwp);
  float* pw = static_cast<float*>(pair_w);
  int* ce = static_cast<int*>(cend);
  if (stats == 0) {
    rasterize_fwd_kernel<0><<<num_tiles, kTilePix, 0, s>>>(
        pr, pstride, ts, tc, tiles_x, Hp, Wp, b, co, tf, pi, pp, pw, ce);
  } else if (stats == 1) {
    rasterize_fwd_kernel<1><<<num_tiles, kTilePix, 0, s>>>(
        pr, pstride, ts, tc, tiles_x, Hp, Wp, b, co, tf, pi, pp, pw, ce);
  } else {
    rasterize_fwd_kernel<2><<<num_tiles, kTilePix, 0, s>>>(
        pr, pstride, ts, tc, tiles_x, Hp, Wp, b, co, tf, pi, pp, pw, ce);
  }
  return (int)cudaGetLastError();
}
