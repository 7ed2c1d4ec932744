// Shared by K1 and K5 (rasterize_fwd.cu) and K2 (rasterize_bwd.cu): the
// tile and chunk geometry, the splat power in the plain version's op order,
// the conservative pixel box of a pair's alpha gate, the warp-to-pixel-patch
// map, and the cp.async chunk staging.
//
// The footprint box. A pair's alpha gate passes where power <= 0 and
// min(0.99, op * exp(power)) >= 1/255 (f32). With Q = -power =
// 0.5 cxx dx^2 + cxy dx dy + 0.5 cyy dy^2, det = cxx cyy - cxy^2 > 0 and
// tau = ln(op / f32(1/255)), the exact gate set lies in the ellipse
// Q <= tau, whose extent is |dx| <= sqrt(2 tau cyy / det) and
// |dy| <= sqrt(2 tau cxx / det). The f32 power differs from -Q by at most
// ~4 u S (u = 2^-24, S = Q plus twice |cxy dx dy|) and S <= kappa Q with
// kappa = (sqrt(cxx cyy) + |cxy|) / (sqrt(cxx cyy) - |cxy|); expf and the
// opacity product add a few ulp. So tau gets an absolute margin of 1e-5
// and is divided by (1 - 16 u kappa) (four times the bound), and the box a
// pixel on each side, which also covers the rounding of dx = px - x. The
// box is computed in double from the f32 record.
//   op < f32(1/255): empty box (op * e <= op for e = exp(power <= 0) <= 1);
//   any non-finite field, cxx <= 0, det <= 0, 16 u kappa > 1/4, or a centre
//   or extent past 2^22 px: no box (every pixel evaluates the pair).
// The log-opacity box (K5's packed records, LOG_OP). There the gate is
// power <= 0 and min(0.99, expf(s)) >= A with s = fl(power + lop), A =
// f32(1/255) and lop a bf16 log-opacity. expf errs by at most 2 ulp
// (2^-22 relative), so a passing pixel has s >= ln A - 2.4e-7; the sum
// rounds by at most u |power + lop|, and |power + lop| < 5.6 wherever
// s >= ln A - 2.4e-7 and the sum is negative (a non-negative sum already
// gives power >= -lop), so power >= ln A - lop - 5.8e-7; and
// power <= -Q (1 - 4 u kappa) as above. Hence Q <= (lop - ln A + 5.8e-7) /
// (1 - 4 u kappa), which tau = (lop - ln A + 1e-5) / (1 - 16 u kappa)
// covers with K1's margins (1e-5 absolute, four times the relative bound),
// the same pixel of padding and the same "no box" rules.
//   lop < ln A - 1e-5: empty box (for power <= 0, s <= lop because rounding
//   is monotone, and expf(s) <= e^lop (1 + 2^-22) < A (1 - 1e-5 + 2.4e-7)).
// A pixel outside the box has alpha 0 in the kernels and in the plain
// versions, so skipping it changes no output bit. The plain torch mirror
// is ops/rasterize_tiled.py:footprint_box (log_opacity=True for K5).
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace footprint {

constexpr int kTileH = 8;
constexpr int kTileW = 128;
constexpr int kTilePix = kTileH * kTileW;
constexpr int kWarps = kTilePix / 32;
constexpr int kChunk = 128;
constexpr float kAlphaMin = (float)(1.0 / 255.0);
constexpr float kAlphaMax = 0.99f;
constexpr float kTEps = (float)1e-4;
// the smallest normal f32: a final transmittance below it went through the
// denormal range and lost its precision (see K2)
constexpr float kTNormalMin = 1.17549435e-38f;
// ln(kAlphaMin) in double (the plain mirror's math.log of the same f32)
constexpr double kLnAlphaMin = -5.541263486019444;

// Each warp owns a compact pixel patch of the tile: kPatchW columns by
// kPatchH rows, patches laid out row-major over the tile. The warp skips a
// pair whose box misses its patch (a warp-uniform branch).
// 8 rows x 4 columns measured a few percent faster than 4 rows x 8 columns
// for K1 and K2; the plain mirror is ops/rasterize_tiled.py:PATCH_W /
// PATCH_H
constexpr int kPatchW = 4;
constexpr int kPatchH = 32 / kPatchW;
constexpr int kPatchesX = kTileW / kPatchW;
static_assert(kPatchW * kPatchH == 32 && kTileH % kPatchH == 0 &&
                  kTileW % kPatchW == 0,
              "a patch holds one warp and patches tile the tile");

constexpr int kNoBoxLo = -(1 << 30);
constexpr int kNoBoxHi = 1 << 30;

struct Box {
  int x0, x1, y0, y1;  // inclusive pixel bounds; x0 > x1 is empty
};

// -0.5 (cxx dx^2 + cyy dy^2) - cxy dx dy, every product and sum rounded on
// its own (no FMA contraction) in the plain version's order: the alpha
// gates then decide exactly as in the plain torch versions.
__device__ __forceinline__ float splat_power(float dx, float dy, float cxx,
                                             float cxy, float cyy) {
  const float pxx = __fmul_rn(__fmul_rn(cxx, dx), dx);
  const float pyy = __fmul_rn(__fmul_rn(cyy, dy), dy);
  const float pxy = __fmul_rn(__fmul_rn(cxy, dx), dy);
  return __fsub_rn(__fmul_rn(-0.5f, __fadd_rn(pxx, pyy)), pxy);
}

// LOG_OP: `op` is a log-opacity (K5's records), else an opacity (K1, K2).
template <bool LOG_OP = false>
__device__ __forceinline__ Box footprint_box(float px, float py, float cxx,
                                             float cxy, float cyy, float op,
                                             float r, float g, float b) {
  const Box none = {kNoBoxLo, kNoBoxHi, kNoBoxLo, kNoBoxHi};
  const Box empty = {kNoBoxHi, kNoBoxLo, kNoBoxHi, kNoBoxLo};
  // a non-finite color turns 0 * rgb into NaN: such pairs stay evaluated
  if (!(isfinite(px) && isfinite(py) && isfinite(cxx) && isfinite(cxy) &&
        isfinite(cyy) && isfinite(op) && isfinite(r) && isfinite(g) &&
        isfinite(b)))
    return none;
  if (LOG_OP ? (double)op - kLnAlphaMin + 1e-5 < 0.0 : op < kAlphaMin)
    return empty;
  const double dxx = cxx, dxy = cxy, dyy = cyy;
  const double det = dxx * dyy - dxy * dxy;  // products exact in double
  if (!(dxx > 0.0) || !(det > 0.0)) return none;
  const double s = sqrt(dxx * dyy);
  const double kappa = (s + fabs(dxy)) / (s - fabs(dxy));
  const double rel = 16.0 * 5.9604644775390625e-8 * kappa;  // 16 u kappa
  if (!(rel <= 0.25)) return none;
  const double tau = ((LOG_OP ? (double)op - kLnAlphaMin
                              : log((double)op / (double)kAlphaMin)) +
                      1e-5) /
                     (1.0 - rel);
  const double rx = sqrt(2.0 * tau * dyy / det);
  const double ry = sqrt(2.0 * tau * dxx / det);
  const double lim = 4194304.0;  // 2^22
  if (!(fabs((double)px) <= lim && fabs((double)py) <= lim && rx <= lim &&
        ry <= lim))
    return none;
  Box bx;
  bx.x0 = (int)floor((double)px - rx) - 1;
  bx.x1 = (int)ceil((double)px + rx) + 1;
  bx.y0 = (int)floor((double)py - ry) - 1;
  bx.y1 = (int)ceil((double)py + ry) + 1;
  return bx;
}

// Bit w set iff the box meets warp w's patch of the tile at (tx0, ty0).
__device__ __forceinline__ unsigned patch_mask(const Box& b, int tx0,
                                               int ty0) {
  const int cx0 = b.x0 - tx0, cx1 = b.x1 - tx0;
  const int cy0 = b.y0 - ty0, cy1 = b.y1 - ty0;
  if (cx0 > cx1 || cy0 > cy1 || cx1 < 0 || cx0 >= kTileW || cy1 < 0 ||
      cy0 >= kTileH)
    return 0u;
  const int pa = max(cx0, 0) / kPatchW, pb = min(cx1, kTileW - 1) / kPatchW;
  const int ra = max(cy0, 0) / kPatchH, rb = min(cy1, kTileH - 1) / kPatchH;
  // bits pa..pb of one patch row (2u << 31 wraps to 0: all bits from pa)
  const unsigned cols = (2u << pb) - (1u << pa);
  unsigned m = 0u;
  for (int rr = ra; rr <= rb; ++rr) m |= cols << (rr * kPatchesX);
  return m;
}

// Pixel of lane `lane` of warp `warp` in the tile at (tx0, ty0).
__device__ __forceinline__ void patch_pixel(int warp, int lane, int tx0,
                                            int ty0, int* x, int* y) {
  *x = tx0 + (warp % kPatchesX) * kPatchW + lane % kPatchW;
  *y = ty0 + (warp / kPatchesX) * kPatchH + lane / kPatchW;
}

// ---- cp.async staging of one chunk's rows into shared memory ----
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Copies columns [lo, hi) of NROWS pair rows (row r of the dst is source row
// row_of(r)) at column `base` into dst[NROWS][kChunk], with the block's
// kTilePix threads. vec16: the source rows are 16-byte aligned at every
// multiple of 4 columns (pointer and pstride checked by the launcher), so
// whole 4-column groups that meet [lo, hi) move as 16 bytes; `base` is a
// multiple of kChunk. The columns of a group outside [lo, hi) lie inside
// the same row and are never read as pairs.
template <int NROWS, typename RowOf>
__device__ __forceinline__ void stage_chunk(float* dst, const float* pair,
                                            long long pstride, long long base,
                                            int lo, int hi, bool vec16,
                                            RowOf row_of, int tid) {
  if (lo >= hi) return;
  if (vec16) {
    const int g0 = lo >> 2, g1 = (hi + 3) >> 2;
    const int ng = g1 - g0;
    for (int e = tid; e < NROWS * ng; e += kTilePix) {
      const int r = e / ng;
      const int k = (g0 + e - r * ng) << 2;
      cp_async16(dst + r * kChunk + k,
                 pair + (long long)row_of(r) * pstride + base + k);
    }
  } else {
    const int n = hi - lo;
    for (int e = tid; e < NROWS * n; e += kTilePix) {
      const int r = e / n;
      const int k = lo + e - r * n;
      cp_async4(dst + r * kChunk + k,
                pair + (long long)row_of(r) * pstride + base + k);
    }
  }
}

}  // namespace footprint
