"""The footprint box of K1, K2 and K5 (csrc/footprint.cuh) through its
plain mirror `rasterize_tiled.footprint_box`.

1. The box is conservative: every pixel whose alpha gate passes, evaluated
   in `rasterize_forward_plain`'s op order in float32, lies inside it, for
   thin, rotated and near-degenerate conics, opacities at and just above
   f32(1/255) and centres on patch borders; degenerate or non-finite
   records give "no box" and op < 1/255 an empty box. The same for K5's
   log-opacity box against the packed gate (power + log op) on bf16
   conics and log-opacities at and next to ln f32(1/255).
2. Skipping, per warp patch, the pairs whose box misses the patch (the
   kernels' culling, emulated here on the plain versions by forcing the
   gate off there) leaves `rasterize_forward_plain`'s (K1 and packed K5
   records) and `rasterize_backward_plain`'s outputs unchanged bit for bit.
Inputs come from numpy seeds; everything runs on the CPU.
"""
import math

import numpy as np
import pytest
import torch

from log_tpu_torch.ops import rasterize_tiled as rt
from log_tpu_torch.ops.projection import ALPHA_MAX, ALPHA_MIN

A_MIN = np.float32(ALPHA_MIN)


def _conics(rng, n, family):
    """(cxx, cxy, cyy) f32 of n splats of one family."""
    ang = rng.uniform(0, np.pi, n)
    if family == "round":
        s1 = rng.uniform(0.5, 6.0, n)
        s2 = s1 * rng.uniform(0.8, 1.0, n)
    elif family == "thin":
        s1 = rng.uniform(4.0, 12.0, n)
        s2 = s1 / rng.uniform(10.0, 40.0, n)
    else:  # near-degenerate: axis ratio 100-400, conic kappa up to 1.6e5
        s1 = rng.uniform(3.0, 10.0, n)
        s2 = s1 / rng.uniform(100.0, 400.0, n)
    c, s = np.cos(ang), np.sin(ang)
    # conic = R diag(1/s1^2, 1/s2^2) R^T
    a, b = 1.0 / s1 ** 2, 1.0 / s2 ** 2
    cxx = a * c * c + b * s * s
    cyy = a * s * s + b * c * c
    cxy = (a - b) * c * s
    return [np.asarray(v, np.float32) for v in (cxx, cxy, cyy)]


def _opacities(rng, n):
    op = rng.uniform(A_MIN, 0.99, n).astype(np.float32)
    op[::5] = A_MIN
    op[1::5] = np.nextafter(A_MIN, np.float32(1))
    op[2::7] = rng.uniform(0.5, 1.0, len(op[2::7]))
    return op


def _gate(px, py, cxx, cxy, cyy, op, gx, gy, log_opacity=False):
    """The plain version's alpha gate at integer pixels (gx, gy), f32;
    log_opacity: the packed records' gate, op a log-opacity."""
    dx = px[:, None] - gx
    dy = py[:, None] - gy
    cxx, cxy, cyy, op = (t[:, None] for t in (cxx, cxy, cyy, op))
    power = -0.5 * (cxx * dx * dx + cyy * dy * dy) - cxy * dx * dy
    if log_opacity:
        alpha = torch.clamp(torch.exp(power + op), max=ALPHA_MAX)
    else:
        alpha = torch.clamp(op * torch.exp(power), max=ALPHA_MAX)
    return (power <= 0.0) & (alpha >= ALPHA_MIN)


def _bf16(*rows):
    """An even number of f32 rows rounded to bf16 through the pipeline's
    own words (pack2_bf16, two rows a word), back as f32 tensors."""
    out = []
    for hi, lo in zip(rows[::2], rows[1::2]):
        out += rt.unpack2_bf16(rt.pack2_bf16(torch.as_tensor(hi),
                                             torch.as_tensor(lo)))
    return out


def _lop_near_gate():
    """bf16 log-opacities (f32) below, at (nearest) and above ln f32(1/255):
    the nearest bf16 word and its two neighbours."""
    at = int(rt.pack2_bf16(torch.tensor([math.log(A_MIN)]),
                           torch.zeros(1))[0]) >> 16 & 0xFFFF
    # negative values: a larger magnitude word is the smaller value
    words = np.array([(at + 1) << 16, at << 16, (at - 1) << 16], np.uint32)
    below, at_, above = words.view(np.float32)
    assert below < math.log(A_MIN) - 1e-5 < math.log(A_MIN) < at_ < above
    return below, at_, above


@pytest.mark.parametrize("family", ["round", "thin", "degenerate"])
def test_footprint_box_is_conservative(family):
    rng = np.random.default_rng({"round": 0, "thin": 1, "degenerate": 2}[family])
    n = 256
    cxx, cxy, cyy = _conics(rng, n, family)
    op = _opacities(rng, n)
    # centres: integers, half pixels, patch borders (multiples of 4 and 8)
    px = rng.uniform(-50, 50, n).astype(np.float32)
    py = rng.uniform(-50, 50, n).astype(np.float32)
    px[::4] = np.round(px[::4] / 4) * 4
    py[::4] = np.round(py[::4] / 8) * 8
    px[1::4] = np.round(px[1::4]) + 0.5
    py[2::4] = np.round(py[2::4])
    t = [torch.from_numpy(v) for v in (px, py, cxx, cxy, cyy, op)]
    rgb = [torch.full((n,), 0.5)] * 3
    x0, x1, y0, y1 = rt.footprint_box(*t, *rgb)
    assert bool((x0 <= x1).all() and (y0 <= y1).all())
    assert bool((x1 - x0 < 2 * rt.FOOT_NONE - 1).all())  # every one boxed

    # the gate on a window well past every box (extents <= ~40 px here)
    win = torch.arange(-48, 49, dtype=torch.float32)
    cx = torch.round(t[0])[:, None]
    cy = torch.round(t[1])[:, None]
    gx = (cx + win).repeat_interleave(len(win), dim=1)
    gy = (cy + win).repeat(1, len(win))
    passed = _gate(*t, gx, gy)
    inside = ((gx >= x0[:, None]) & (gx <= x1[:, None])
              & (gy >= y0[:, None]) & (gy <= y1[:, None]))
    assert int(passed.sum()) > n  # the gate passes somewhere
    assert not bool((passed & ~inside).any())
    assert int((x1 - x0).max()) < 96 and int((y1 - y0).max()) < 96

    # tight: the exact ellipse's extent, the pads and the rounding margin
    c64 = [v.astype(np.float64) for v in (cxx, cxy, cyy, op)]
    det = c64[0] * c64[2] - c64[1] ** 2
    tau = np.log(c64[3] / np.float64(A_MIN))
    rx = np.sqrt(2 * tau * c64[2] / det)
    ry = np.sqrt(2 * tau * c64[0] / det)
    assert bool(((x1 - x0).numpy() <= 2.2 * rx + 4).all())
    assert bool(((y1 - y0).numpy() <= 2.2 * ry + 4).all())


def test_footprint_box_special_records():
    f = np.float32
    nan, inf = f(np.nan), f(np.inf)
    recs = [
        # px, py, cxx, cxy, cyy, op, r   -> expected
        ((5.0, 3.0, 0.5, 0.0, 0.5, nan, 0.5), "none"),
        ((5.0, 3.0, nan, 0.0, 0.5, 0.5, 0.5), "none"),
        ((inf, 3.0, 0.5, 0.0, 0.5, 0.5, 0.5), "none"),
        ((5.0, 3.0, 0.5, 0.0, 0.5, 0.5, nan), "none"),  # color
        ((5.0, 3.0, 0.5, 0.0, 0.5, inf, 0.5), "none"),
        ((5.0, 3.0, -0.5, 0.0, 0.5, 0.5, 0.5), "none"),  # cxx <= 0
        ((5.0, 3.0, 0.0, 0.0, 0.5, 0.5, 0.5), "none"),
        ((5.0, 3.0, 0.5, 0.5, 0.5, 0.5, 0.5), "none"),  # det = 0
        ((5.0, 3.0, 0.5, 0.6, 0.5, 0.5, 0.5), "none"),  # det < 0
        ((5.0, 3.0, 1.0, 0.99999994, 1.0, 0.5, 0.5), "none"),  # kappa 3e7
        ((5e6, 3.0, 0.5, 0.0, 0.5, 0.5, 0.5), "none"),  # centre past 2^22
        ((5.0, 3.0, 0.5, 0.0, 0.5, np.nextafter(A_MIN, f(0)), 0.5), "empty"),
        ((5.0, 3.0, nan, 0.0, 0.5, 0.001, 0.5), "none"),  # non-finite first
        ((5.0, 3.0, -1.0, 0.0, 0.5, 0.001, 0.5), "empty"),
        ((5.0, 3.0, 0.5, 0.0, 0.5, A_MIN, 0.5), "box"),
        ((5.0, 3.0, 0.5, 0.0, 0.5, np.nextafter(A_MIN, f(1)), 0.5), "box"),
    ]
    cols = np.array([r for r, _ in recs], np.float32).T
    t = [torch.from_numpy(np.ascontiguousarray(c)) for c in cols]
    x0, x1, y0, y1 = rt.footprint_box(*t[:6], t[6], t[6], t[6])
    big = rt.FOOT_NONE
    for i, (_, want) in enumerate(recs):
        box = (int(x0[i]), int(x1[i]), int(y0[i]), int(y1[i]))
        if want == "none":
            assert box == (-big, big, -big, big), i
        elif want == "empty":
            assert box[0] > box[1] and box[2] > box[3], i
        else:  # op at the gate: the centre pixel passes, the box is small
            assert box[0] <= 5 <= box[1] and box[2] <= 3 <= box[3], i
            assert box[1] - box[0] <= 4 and box[3] - box[2] <= 4, i


@pytest.mark.parametrize("family", ["round", "thin", "degenerate"])
def test_log_footprint_box_is_conservative(family):
    """K5's box: bf16 conics and log-opacities (through pack2_bf16), the
    packed gate min(0.99, exp(power + lop)) >= f32(1/255)."""
    rng = np.random.default_rng({"round": 10, "thin": 11,
                                 "degenerate": 12}[family])
    n = 270
    cxx, cxy, cyy = _conics(rng, n, family)
    lop = np.log(_opacities(rng, n)).astype(np.float32)
    below, at, above = _lop_near_gate()
    lop[3::9], lop[4::9], lop[5::9] = below, at, above
    px = rng.uniform(-50, 50, n).astype(np.float32)
    py = rng.uniform(-50, 50, n).astype(np.float32)
    px[::4] = np.round(px[::4] / 4) * 4
    py[::4] = np.round(py[::4] / 8) * 8
    px[1::4] = np.round(px[1::4]) + 0.5
    py[2::4] = np.round(py[2::4])
    cxx, cxy, cyy, lop = _bf16(cxx, cxy, cyy, lop)
    t = [torch.from_numpy(px), torch.from_numpy(py), cxx, cxy, cyy, lop]
    rgb = [torch.full((n,), 0.5)] * 3
    x0, x1, y0, y1 = rt.footprint_box(*t, *rgb, log_opacity=True)
    empty = torch.zeros(n, dtype=torch.bool)
    empty[3::9] = True  # lop below ln f32(1/255) by more than the margin
    assert torch.equal((x0 > x1) & (y0 > y1), empty)
    # unboxed exactly where bf16 rounding left det <= 0 (thin, degenerate)
    det = cxx.double() * cyy.double() - cxy.double() ** 2
    unboxed = x1 - x0 >= 2 * rt.FOOT_NONE - 1
    assert torch.equal(unboxed, (det <= 0) & ~empty)
    assert int(unboxed.sum()) < n // 2

    win = torch.arange(-48, 49, dtype=torch.float32)
    cx = torch.round(t[0])[:, None]
    cy = torch.round(t[1])[:, None]
    gx = (cx + win).repeat_interleave(len(win), dim=1)
    gy = (cy + win).repeat(1, len(win))
    passed = _gate(*t, gx, gy, log_opacity=True)
    inside = ((gx >= x0[:, None]) & (gx <= x1[:, None])
              & (gy >= y0[:, None]) & (gy <= y1[:, None]))
    assert int(passed.sum()) > n
    assert int(passed[4::9].sum()) > 0  # the bf16 at the gate passes
    assert not bool((passed & ~inside).any())
    # bf16 can leave a thin conic's det tiny: its box (and gate set) may
    # reach past the window, where it is not checked
    sized = ~unboxed & ~empty
    in_win = (x1 - x0 < 96) & (y1 - y0 < 96)
    assert float(in_win[sized].float().mean()) > 0.8

    # tight: the exact ellipse's extent, the pads and the rounding margin
    c64 = [v.numpy().astype(np.float64) for v in (cxx, cxy, cyy, lop)]
    det = c64[0] * c64[2] - c64[1] ** 2
    tau = np.maximum(c64[3] - math.log(A_MIN), 0.0)
    keep = sized.numpy()
    rx = np.sqrt(2 * tau[keep] * c64[2][keep] / det[keep])
    ry = np.sqrt(2 * tau[keep] * c64[0][keep] / det[keep])
    assert bool(((x1 - x0).numpy()[keep] <= 2.2 * rx + 4).all())
    assert bool(((y1 - y0).numpy()[keep] <= 2.2 * ry + 4).all())


def test_log_footprint_box_special_records():
    f = np.float32
    nan, inf = f(np.nan), f(np.inf)
    below, at, above = _lop_near_gate()
    recs = [
        # px, py, cxx, cxy, cyy, lop, r   -> expected
        ((5.0, 3.0, 0.5, 0.0, 0.5, nan, 0.5), "none"),
        ((5.0, 3.0, 0.5, 0.0, 0.5, inf, 0.5), "none"),  # exp(inf) -> 0.99
        ((5.0, 3.0, 0.5, 0.0, 0.5, -inf, 0.5), "none"),
        ((5.0, 3.0, nan, 0.0, 0.5, -0.5, 0.5), "none"),
        ((5.0, 3.0, 0.5, 0.0, 0.5, -0.5, nan), "none"),  # color
        ((5.0, 3.0, -0.5, 0.0, 0.5, -0.5, 0.5), "none"),  # cxx <= 0
        ((5.0, 3.0, 0.5, 0.5, 0.5, -0.5, 0.5), "none"),  # det = 0
        ((5e6, 3.0, 0.5, 0.0, 0.5, -0.5, 0.5), "none"),  # centre past 2^22
        ((5.0, 3.0, 0.5, 0.0, 0.5, below, 0.5), "empty"),
        ((5.0, 3.0, -1.0, 0.0, 0.5, below, 0.5), "empty"),
        # log(1e-38): the port's zero-opacity lanes
        ((5.0, 3.0, 0.5, 0.0, 0.5, -87.5, 0.5), "empty"),
        ((5.0, 3.0, 0.5, 0.0, 0.5, at, 0.5), "box"),
        ((5.0, 3.0, 0.5, 0.0, 0.5, above, 0.5), "box"),
    ]
    cols = np.array([r for r, _ in recs], np.float32).T
    t = [torch.from_numpy(np.ascontiguousarray(c)) for c in cols]
    x0, x1, y0, y1 = rt.footprint_box(*t[:6], t[6], t[6], t[6],
                                      log_opacity=True)
    big = rt.FOOT_NONE
    for i, (_, want) in enumerate(recs):
        box = (int(x0[i]), int(x1[i]), int(y0[i]), int(y1[i]))
        if want == "none":
            assert box == (-big, big, -big, big), i
        elif want == "empty":
            assert box[0] > box[1] and box[2] > box[3], i
        else:  # lop just past the gate: the centre passes, the box is small
            assert box[0] <= 5 <= box[1] and box[2] <= 3 <= box[3], i
            assert box[1] - box[0] <= 6 and box[3] - box[2] <= 6, i


# ------------------------------------------------- the per-patch skip
def _tile_pairs(seed):
    """(16, A + 128 + 37) pair records of 2 x 2 tiles: runs of 150, 1100
    (past 8 chunks, saturating mid-chunk), 40 and 0 pairs from column 37,
    with thin, degenerate, faint (op at f32(1/255)), tile-wide and NaN
    splats and centres on patch borders."""
    rng = np.random.default_rng(seed)
    tiles_x, tiles_y = 2, 2
    counts = [150, 1100, 40, 0]
    start0 = 37
    total = sum(counts)
    A = (start0 + total + 127) // 128 * 128
    pstride = A + 128 + 37
    pair = np.zeros((rt.N_ROWS, pstride), np.float32)
    col = start0
    starts = []
    for t, n in enumerate(counts):
        starts.append(col)
        if n == 0:
            continue
        ox, oy = (t % tiles_x) * rt.TILE_W, (t // tiles_x) * rt.TILE_H
        fam = rng.choice(["round", "thin", "degenerate"], n, p=[0.6, 0.3, 0.1])
        cxx = np.empty(n, np.float32)
        cxy = np.empty(n, np.float32)
        cyy = np.empty(n, np.float32)
        for name in ("round", "thin", "degenerate"):
            sel = fam == name
            if sel.any():
                a, b, c = _conics(rng, int(sel.sum()), name)
                cxx[sel], cxy[sel], cyy[sel] = a, b, c
        px = rng.uniform(ox - 8, ox + rt.TILE_W + 8, n).astype(np.float32)
        py = rng.uniform(oy - 6, oy + rt.TILE_H + 6, n).astype(np.float32)
        px[::3] = ox + 4 * rng.integers(0, 33, len(px[::3]))  # patch borders
        op = _opacities(rng, n)
        op[3::11] = np.nextafter(A_MIN, np.float32(0))  # below the gate
        if t == 1:  # tile-wide opaque splats from pair 700 on: saturation
            big = slice(700, None, 9)
            px[big], py[big] = ox + 64, oy + 4
            cxx[big], cxy[big], cyy[big] = 1e-4, 0.0, 1e-4
            op[big] = 0.99
        # boxes that end on the last column (row) of a patch or start on
        # its first: integer shifts of the centre shift the box alike
        rgb = torch.full((n,), 0.5)
        x0, x1, y0, y1 = (b.numpy() for b in rt.footprint_box(
            *(torch.from_numpy(v) for v in (px, py, cxx, cxy, cyy, op)),
            rgb, rgb, rgb))
        j = np.arange(n)
        pw, ph = rt.PATCH_W, rt.PATCH_H
        px -= np.where(j % 3 == 1, (x1 - ox) % pw - (pw - 1), 0).astype(
            np.float32)
        px -= np.where(j % 3 == 2, (x0 - ox) % pw, 0).astype(np.float32)
        py -= np.where(j % 5 == 1, (y1 - oy) % ph - (ph - 1), 0).astype(
            np.float32)
        cxx[17::97] = np.nan
        sl = slice(col, col + n)
        pair[0, sl], pair[1, sl] = px, py
        pair[2, sl], pair[3, sl], pair[4, sl] = cxx, cxy, cyy
        pair[5, sl] = op
        pair[6:9, sl] = rng.uniform(0, 1, (3, n))
        pair[9, sl] = rng.uniform(1, 10, n)
        pair[10, sl] = np.arange(col, col + n).astype(np.int32).view(np.float32)
        col += n
    tile_start = torch.tensor(starts, dtype=torch.int32)
    tile_count = torch.tensor(counts, dtype=torch.int32)
    return torch.from_numpy(pair), tile_start, tile_count, tiles_x, tiles_y


def _packed_tile_pairs(seed):
    """`_tile_pairs`' records as K5's (8, pstride) packed words (px, py f32;
    cxx|cxy, cyy|log op, r|g, b|0 bf16 pairs through pack2_bf16), every
    11th pair's log-opacity at, below and above ln f32(1/255) in bf16."""
    pair, ts, tc, tiles_x, tiles_y = _tile_pairs(seed)
    lop = torch.log(pair[rt.ROW_OPAC])  # -inf outside the runs
    below, at, above = _lop_near_gate()
    lop[4::11], lop[6::11], lop[8::11] = float(below), float(at), float(above)
    zero = torch.zeros_like(lop)
    packed = torch.zeros((rt.P_N_ROWS, pair.shape[1]), dtype=torch.float32)
    packed[rt.P_ROW_PX] = pair[rt.ROW_PX]
    packed[rt.P_ROW_PY] = pair[rt.ROW_PY]
    for row, (hi, lo) in ((rt.P_ROW_CXX_CXY, (pair[rt.ROW_CXX],
                                              pair[rt.ROW_CXY])),
                          (rt.P_ROW_CYY_OPAC, (pair[rt.ROW_CYY], lop)),
                          (rt.P_ROW_R_G, (pair[rt.ROW_R], pair[rt.ROW_G])),
                          (rt.P_ROW_B, (pair[rt.ROW_B], zero))):
        packed[row] = rt.pack2_bf16(hi, lo).view(torch.float32)
    return packed, ts, tc, tiles_x, tiles_y


def _keep_mask(pair, tile_start, tile_count, tiles_x, packed=False):
    """(pstride, TILE_PIX) bool: pixel lane of the pair's tile lies in a
    warp patch that the pair's box meets (True outside every run); packed:
    K5's records and its log-opacity box."""
    pstride = pair.shape[1]
    keep = torch.ones((pstride, rt.TILE_PIX), dtype=torch.bool)
    lane = torch.arange(rt.TILE_PIX)
    lx, ly = lane % rt.TILE_W, lane // rt.TILE_W
    qx0 = lx // rt.PATCH_W * rt.PATCH_W
    qy0 = ly // rt.PATCH_H * rt.PATCH_H
    rows = rt._decode_packed(pair) if packed else pair[:9]
    x0, x1, y0, y1 = rt.footprint_box(*rows, log_opacity=packed)
    for t in range(tile_start.numel()):
        s, n = int(tile_start[t]), int(tile_count[t])
        if n == 0:
            continue
        ox, oy = (t % tiles_x) * rt.TILE_W, (t // tiles_x) * rt.TILE_H
        c = slice(s, s + n)
        keep[c] = ((x0[c, None] <= ox + qx0 + rt.PATCH_W - 1)
                   & (x1[c, None] >= ox + qx0)
                   & (y0[c, None] <= oy + qy0 + rt.PATCH_H - 1)
                   & (y1[c, None] >= oy + qy0))
    return keep


class _SkipTorch:
    """`torch` as rasterize_tiled's plain versions see it, with the
    kernels' per-patch skip: the first 3-D boolean `where` after each
    integer `clamp` (the gate, right after the chunk's columns are
    gathered) is also false where the pixel's patch misses the pair's
    box."""

    def __init__(self, keep):
        self.keep, self.cols, self.armed, self.hits = keep, None, False, 0

    def __getattr__(self, name):
        return getattr(torch, name)

    def clamp(self, x, *args, **kwargs):
        if not x.is_floating_point():
            self.cols, self.armed = x, True
        return torch.clamp(x, *args, **kwargs)

    def where(self, cond, *args):
        if self.armed and cond.dtype == torch.bool and cond.dim() == 3:
            self.armed = False
            self.hits += 1
            cols = torch.clamp(self.cols, max=self.keep.shape[0] - 1)
            cond = cond & self.keep[cols]
        return torch.where(cond, *args)


def _bits(t):
    return t.contiguous().view(-1).view(torch.int32)


@pytest.mark.parametrize("with_stats", [False, "weights", True])
def test_patch_skip_keeps_forward_plain(with_stats, monkeypatch):
    pair, ts, tc, tiles_x, tiles_y = _tile_pairs(3)
    bg = torch.tensor([0.1, 0.2, 0.3])
    args = (pair, ts, tc, bg, tiles_x, tiles_y, with_stats)
    want = rt.rasterize_forward_plain(*args)
    keep = _keep_mask(pair, ts, tc, tiles_x)
    in_run = torch.zeros(pair.shape[1], dtype=torch.bool)
    for s, n in zip(ts.tolist(), tc.tolist()):
        in_run[s:s + n] = True
    assert float((~keep[in_run]).float().mean()) > 0.5  # most work skipped
    skip = _SkipTorch(keep)
    monkeypatch.setattr(rt, "torch", skip)
    got = rt.rasterize_forward_plain(*args)
    monkeypatch.undo()
    assert skip.hits > 0
    n_chunks = (int(ts[1]) % 128 + 1100 + 127) // 128
    assert int(want[5][1]) < n_chunks  # tile 1 saturated mid-run
    assert float(want[1].min()) < 1e-4
    for a, b in zip(got, want):
        assert torch.equal(_bits(a), _bits(b))


@pytest.mark.parametrize("seed", [3, 4])
def test_patch_skip_keeps_packed_forward_plain(seed, monkeypatch):
    """K5's per-patch skip with the log-opacity box, on packed adversarial
    records: the plain packed compositing is unchanged bit for bit."""
    pair, ts, tc, tiles_x, tiles_y = _packed_tile_pairs(seed)
    bg = torch.tensor([0.1, 0.2, 0.3])
    args = (pair, ts, tc, bg, tiles_x, tiles_y, False)
    want = rt.rasterize_forward_plain(*args, packed=True)
    keep = _keep_mask(pair, ts, tc, tiles_x, packed=True)
    in_run = torch.zeros(pair.shape[1], dtype=torch.bool)
    for s, n in zip(ts.tolist(), tc.tolist()):
        in_run[s:s + n] = True
    assert float((~keep[in_run]).float().mean()) > 0.5  # most work skipped
    skip = _SkipTorch(keep)
    monkeypatch.setattr(rt, "torch", skip)
    got = rt.rasterize_forward_plain(*args, packed=True)
    monkeypatch.undo()
    assert skip.hits > 0
    n_chunks = (int(ts[1]) % 128 + 1100 + 127) // 128
    assert int(want[5][1]) < n_chunks  # tile 1 saturated mid-run
    assert float(want[1].min()) < 1e-4
    for a, b in zip(got, want):
        assert torch.equal(_bits(a), _bits(b))
    # the wrapper's plain version is the same compositing
    plain = rt.rasterize_forward_packed_plain(*args[:6])
    for a, b in zip(plain, want[:2]):
        assert torch.equal(_bits(a), _bits(b))


def test_patch_skip_keeps_backward_plain(monkeypatch):
    pair, ts, tc, tiles_x, tiles_y = _tile_pairs(4)
    bg = torch.tensor([0.1, 0.2, 0.3])
    fwd = rt.rasterize_forward_plain(pair, ts, tc, bg, tiles_x, tiles_y, True)
    rng = np.random.default_rng(5)
    dcolor = torch.from_numpy(rng.normal(size=fwd[0].shape).astype(np.float32))
    dalpha = torch.from_numpy(rng.normal(size=fwd[1].shape).astype(np.float32))
    args = (pair, ts, tc, fwd[5], fwd[1], dcolor, dalpha, bg, tiles_x,
            tiles_y)
    want = rt.rasterize_backward_plain(*args)
    skip = _SkipTorch(_keep_mask(pair, ts, tc, tiles_x))
    monkeypatch.setattr(rt, "torch", skip)
    got = rt.rasterize_backward_plain(*args)
    monkeypatch.undo()
    assert skip.hits > 0
    # (NaN conics give NaN rows in the plain version; compared as bits)
    assert float(torch.nan_to_num(want[:9]).abs().max()) > 0
    assert torch.equal(_bits(got), _bits(want))


def test_source_tag_hashes_headers(tmp_path, monkeypatch):
    """An edited shared header (footprint.cuh) changes the library's name,
    so the kernels rebuild."""
    from log_tpu_torch.ops import kernels

    (tmp_path / "k.cu").write_text('#include "h.cuh"\n')
    (tmp_path / "h.cuh").write_text("constexpr int a = 1;\n")
    monkeypatch.setattr(kernels, "CSRC", tmp_path)
    before = kernels._source_tag()
    (tmp_path / "h.cuh").write_text("constexpr int a = 2;\n")
    assert kernels._source_tag() != before
    assert kernels._source_tag() == kernels._source_tag()
