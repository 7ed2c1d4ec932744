// K1 and K5: per-tile front-to-back compositing of depth-sorted pairs.
//
// K1 replaces the Pallas kernel `_fwd_kernel` reached from
// log_tpu/ops/rasterize_tiled.py:_run_forward (wrapper _raster_core); K5
// replaces `_fwd_kernel_packed` reached from
// log_tpu/ops/rasterize_tiled.py:_run_forward_packed (render_pairs_packed,
// the inference frame of the flat_slice and block-pruned paths). Both are
// one kernel template; PACKED changes only the records staged, their
// decode and the alpha line.
//
// One block of 1024 threads composites one 8 x 128 pixel tile, one thread
// per pixel. The tile's pair run [start, start + count) of the pair array
// is walked in 128-pair chunks from the floor-aligned offset
// floor(start / 128) * 128; every pixel composites the chunk's pairs in
// order:
//   K1: alpha = min(0.99, op * exp(power)),
//   K5: alpha = min(0.99, exp(power + log op)),
//       kept iff power <= 0 and alpha >= 1/255;
//   w     = T * alpha if T * (1 - alpha) >= 1e-4, else 0;
//   color += w * rgb; T *= 1 - alpha.
// After each chunk the block stops once every pixel has T < 1e-4
// (__syncthreads_or); cend records the chunks composited, in the TPU
// kernel's units.
// K1's records: the (16, A + 128) f32 array of pack_sorted_pairs. Stats
// (stats >= 1): per-pair max weight over the tile's pixels, a warp max
// (redux.sync) folded into shared memory with atomicMax and written once
// per pair, since each pair belongs to exactly one tile. Full stats
// (stats == 2) add the per-pixel max weight and the caller id of its pair
// (pair row 10, int32 bits), chunk by chunk with the TPU kernel's tie rule
// (largest id among equal chunk maxima, first chunk wins).
// K5's records: 8 rows of 32-bit words in an (8, A + 128) array,
//   0 px, 1 py (f32); 2 cxx|cxy, 3 cyy|log(opacity), 4 r|g, 5 b|0, each a
//   u32 holding two bf16 halves (hi | lo); 6, 7 zero (not read).
// A bf16 placed in the top half of an f32 word is that bf16's exact value,
// so the decode is bit operations (hi = u & 0xFFFF0000, lo = u << 16),
// done once per pair. K5 writes color and tfinal only (no stats).
//
// Bound on the H100: FP32 operations. The pair records are 24 (K5) or 40
// (K1) bytes per pair, read once; the work is ~20 flops and one expf per
// (pair, pixel) whose alpha gate passes, and the gate passes on only 13-23%
// of a tile's (pair, pixel) combinations on the main path, so evaluating
// every pair at every pixel spends most of its instructions on alphas of 0.
// What bounds this design is the instruction count of its pair loop: ~45
// instructions per pair on every warp whose patch the pair's box meets.
// Design:
// - footprint culling (footprint.cuh): each warp owns an 8 x 4 pixel patch
//   (not a 1 x 32 row); each pair gets a conservative pixel box of its gate
//   set (K5: the log-opacity box) and a 32-bit mask of the patches it
//   meets, once per chunk; a warp ballots the masks of the chunk and walks
//   only its own pairs, in order. A skipped pixel would have had alpha 0,
//   so every output is bit-identical to evaluating all pairs;
// - triple-buffered staging: chunk c + 2 is copied with cp.async (16-byte
//   copies where the pointer and pstride allow) and chunk c + 1's masks and
//   pair-major copy (three float4 per pair, read as broadcasts; K5 decodes
//   its bf16 words into it) are made while chunk c composites, with one
//   barrier per chunk;
// - two blocks per SM (__launch_bounds__ min 2): 32 registers a thread,
//   with a few spills, measured faster than one block at 62 registers;
// - sequential per-pixel compositing keeps registers small.
// Not carried over from the TPU: the log/exp cumprod on the MXU, the bf16
// accumulation of the inference mode, K5's quadratic form on the MXU with
// its 1e-2 gate slack and its bf16 color matmul, and the read-modify-write
// of per-pair weights in chunks shared by neighbouring tiles (only needed by
// the TPU's 128-lane DMA alignment).
#include "footprint.cuh"

namespace {

using namespace footprint;

// staged rows: K1 px py cxx cxy cyy opac r g b, then the caller id (row 10);
// K5 the six stored words of its record
constexpr int kRowGid = 10;

template <bool PACKED>
struct StagedRows {
  static constexpr int kCount = PACKED ? 6 : 10;
  __device__ int operator()(int r) const {
    return PACKED || r < 9 ? r : kRowGid;
  }
};

__device__ __forceinline__ float bf16_hi(float w) {
  return __uint_as_float(__float_as_uint(w) & 0xFFFF0000u);
}

__device__ __forceinline__ float bf16_lo(float w) {
  return __uint_as_float(__float_as_uint(w) << 16);
}

template <int STATS, bool PACKED>
__global__ void __launch_bounds__(kTilePix, 2)
rasterize_fwd_kernel(const float* __restrict__ pair, long long pstride,
                     bool vec16, const int* __restrict__ tile_start,
                     const int* __restrict__ tile_count, int tiles_x, int Hp,
                     int Wp, const float* __restrict__ bg,
                     float* __restrict__ color, float* __restrict__ tfinal,
                     int* __restrict__ pid, float* __restrict__ pwp,
                     float* __restrict__ pair_w, int* __restrict__ cend) {
  static_assert(!(PACKED && STATS), "the packed records carry no stats");
  constexpr int kStaged = StagedRows<PACKED>::kCount;
  __shared__ __align__(16) float s_rec[3][kStaged][kChunk];
  // chunk c's records once more, decoded and pair-major: px py cxx cxy |
  // cyy opac r g | b id (K5: log-opacity, no id), so a pair is three
  // broadcast 16-byte reads
  __shared__ float4 s_pair[2][kChunk][3];
  __shared__ unsigned s_mask[2][kChunk];
  __shared__ unsigned s_pw[2][kChunk];

  const int t = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int start = tile_start[t];
  const int count = tile_count[t];
  const long long off0 = (long long)(start / kChunk) * kChunk;
  const int n_chunks = (int)((start + count - off0 + kChunk - 1) / kChunk);
  const int tile_y = t / tiles_x;
  const int tx0 = (t - tile_y * tiles_x) * kTileW;
  const int ty0 = tile_y * kTileH;
  int px, py;
  patch_pixel(warp, lane, tx0, ty0, &px, &py);
  const float fx = (float)px;
  const float fy = (float)py;

  // the tile's run inside chunk c: [lo, hi)
  auto range = [&](int c, int* lo, int* hi) {
    const long long base = off0 + (long long)c * kChunk;
    const long long lo_ll = (long long)start - base;
    const long long hi_ll = (long long)start + count - base;
    *lo = lo_ll > 0 ? (int)lo_ll : 0;
    *hi = hi_ll < kChunk ? (int)hi_ll : kChunk;
  };
  auto stage = [&](int c) {
    if (c < n_chunks) {
      int lo, hi;
      range(c, &lo, &hi);
      stage_chunk<kStaged>(&s_rec[c % 3][0][0], pair, pstride,
                           off0 + (long long)c * kChunk, lo, hi, vec16,
                           StagedRows<PACKED>(), tid);
    }
    cp_async_commit();
  };
  // thread k < kChunk: the patch mask of pair k of chunk c, and its
  // pair-major copy
  auto mask_of = [&](int c) {
    int lo, hi;
    range(c, &lo, &hi);
    if (tid < lo || tid >= hi) return 0u;
    const float(*rec)[kChunk] = s_rec[c % 3];
    float4* q = s_pair[c & 1][tid];
    Box b;
    if constexpr (PACKED) {
      const float w2 = rec[2][tid], w3 = rec[3][tid], w4 = rec[4][tid];
      const float cxx = bf16_hi(w2), cxy = bf16_lo(w2);
      const float cyy = bf16_hi(w3), lop = bf16_lo(w3);
      const float r = bf16_hi(w4), g = bf16_lo(w4), bl = bf16_hi(rec[5][tid]);
      q[0] = make_float4(rec[0][tid], rec[1][tid], cxx, cxy);
      q[1] = make_float4(cyy, lop, r, g);
      q[2] = make_float4(bl, 0.f, 0.f, 0.f);
      b = footprint_box<true>(rec[0][tid], rec[1][tid], cxx, cxy, cyy, lop,
                              r, g, bl);
    } else {
      q[0] = make_float4(rec[0][tid], rec[1][tid], rec[2][tid], rec[3][tid]);
      q[1] = make_float4(rec[4][tid], rec[5][tid], rec[6][tid], rec[7][tid]);
      q[2] = make_float4(rec[8][tid], rec[9][tid], 0.f, 0.f);
      b = footprint_box(rec[0][tid], rec[1][tid], rec[2][tid], rec[3][tid],
                        rec[4][tid], rec[5][tid], rec[6][tid], rec[7][tid],
                        rec[8][tid]);
    }
    return patch_mask(b, tx0, ty0);
  };
  auto write_pair_w = [&](int c) {
    int lo, hi;
    range(c, &lo, &hi);
    if (tid >= lo && tid < hi)
      pair_w[off0 + (long long)c * kChunk + tid] =
          __uint_as_float(s_pw[c & 1][tid]);
  };

  if (n_chunks > 0) {
    stage(0);
    stage(1);
    cp_async_wait_all();
    __syncthreads();
    if (tid < kChunk) {
      s_mask[0][tid] = mask_of(0);
      if (STATS > 0) s_pw[0][tid] = 0u;
    }
    __syncthreads();
  }

  float T = 1.f, cr = 0.f, cg = 0.f, cb = 0.f;
  float best_w = 0.f;
  int best_id = -1;
  int c = 0;
  while (c < n_chunks) {
    // chunk c's records and masks are in place; chunk c + 1's records are
    // staged; buffer (c + 2) % 3 was last read in chunk c - 1
    stage(c + 2);
    if (tid < kChunk) {
      if (c + 1 < n_chunks) s_mask[(c + 1) & 1][tid] = mask_of(c + 1);
      if (STATS > 0) {
        if (c > 0) write_pair_w(c - 1);
        s_pw[(c + 1) & 1][tid] = 0u;
      }
    }

    int lo, hi;
    range(c, &lo, &hi);
    const float4(*rec)[3] = s_pair[c & 1];
    const unsigned* mask = s_mask[c & 1];
    unsigned* spw = s_pw[c & 1];
    float cw = 0.f;
    int cid = -1;
    for (int k0 = lo & ~31; k0 < hi; k0 += 32) {
      unsigned mine = __ballot_sync(0xffffffffu,
                                    (mask[k0 + lane] >> warp) & 1u);
      while (mine) {  // warp-uniform: this warp's pairs, in order
        const int k = k0 + __ffs(mine) - 1;
        mine &= mine - 1u;
        const float4 q0 = rec[k][0], q1 = rec[k][1], q2 = rec[k][2];
        const float dx = q0.x - fx;
        const float dy = q0.y - fy;
        const float power = splat_power(dx, dy, q0.z, q0.w, q1.x);
        float alpha = 0.f;
        if (power <= 0.f) {
          if constexpr (PACKED)
            alpha = fminf(kAlphaMax, expf(__fadd_rn(power, q1.y)));
          else
            alpha = fminf(kAlphaMax, __fmul_rn(q1.y, expf(power)));
          if (!(alpha >= kAlphaMin)) alpha = 0.f;
        }
        const float t_after = T * (1.f - alpha);
        const float w = t_after >= kTEps ? T * alpha : 0.f;
        cr += w * q1.z;
        cg += w * q1.w;
        cb += w * q2.x;
        T = t_after;
        if (STATS == 2) {
          const int gid = __float_as_int(q2.y);
          if (w > cw) {
            cw = w;
            cid = gid;
          } else if (w == cw && w > 0.f && gid > cid) {
            cid = gid;
          }
        }
        if (STATS > 0) {
          // w >= 0, so its bit pattern orders like the value
          const unsigned m = __reduce_max_sync(0xffffffffu,
                                               __float_as_uint(w));
          if (lane == 0 && m != 0u) atomicMax(&spw[k], m);
        }
      }
    }
    if (STATS == 2 && cw > best_w) {
      best_w = cw;
      best_id = cid;
    }
    cp_async_wait_all();
    ++c;
    // orders this chunk's reads and atomics before the next chunk's
    // staging, masks and pair_w write
    if (!__syncthreads_or(T >= kTEps)) break;
  }
  if (STATS > 0 && c > 0 && tid < kChunk) write_pair_w(c - 1);

  const long long npix = (long long)Hp * Wp;
  const long long p = (long long)py * Wp + px;
  color[p] = cr + T * bg[0];
  color[npix + p] = cg + T * bg[1];
  color[2 * npix + p] = cb + T * bg[2];
  tfinal[p] = T;
  if constexpr (!PACKED) {
    pid[p] = best_id;
    pwp[p] = best_w;
    if (tid == 0) cend[t] = c;
  }
}

// 16-byte copies need every row start 16-byte aligned
bool rows_vec16(const void* pair, long long pstride) {
  return ((uintptr_t)pair % 16 == 0) && (pstride % 4 == 0);
}

}  // namespace

// K1. pair: (16, pstride) f32 (row 10 = int32 caller ids); tile_start,
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
  const bool vec16 = rows_vec16(pair, pstride);
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
    rasterize_fwd_kernel<0, false><<<num_tiles, kTilePix, 0, s>>>(
        pr, pstride, vec16, ts, tc, tiles_x, Hp, Wp, b, co, tf, pi, pp, pw,
        ce);
  } else if (stats == 1) {
    rasterize_fwd_kernel<1, false><<<num_tiles, kTilePix, 0, s>>>(
        pr, pstride, vec16, ts, tc, tiles_x, Hp, Wp, b, co, tf, pi, pp, pw,
        ce);
  } else {
    rasterize_fwd_kernel<2, false><<<num_tiles, kTilePix, 0, s>>>(
        pr, pstride, vec16, ts, tc, tiles_x, Hp, Wp, b, co, tf, pi, pp, pw,
        ce);
  }
  return (int)cudaGetLastError();
}

// K5. pair: (8, pstride) 32-bit words; tile_start, tile_count: (num_tiles,)
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
  rasterize_fwd_kernel<0, true><<<num_tiles, kTilePix, 0,
                                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(pair), pstride, rows_vec16(pair, pstride),
      static_cast<const int*>(tile_start), static_cast<const int*>(tile_count),
      tiles_x, tiles_y * kTileH, tiles_x * kTileW,
      static_cast<const float*>(bg), static_cast<float*>(color),
      static_cast<float*>(tfinal), nullptr, nullptr, nullptr, nullptr);
  return (int)cudaGetLastError();
}
