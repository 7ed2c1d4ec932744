"""K1 in isolation: microseconds per 128-pair chunk, with and without the
saturation exit; counterpart of scripts/bench_kernel.py.

The pair tables are synthetic and already sorted, so no binning runs:
every one of the 1920x1088 frame's 2,040 8x128 tiles holds `cpt` chunks of
128 pairs, each pair a gaussian of sigma 6 px centred near its tile's
middle with opacity 0.05 (nothing saturates: every chunk composites, "no
exit") or 0.9 (the tile saturates within a few pairs: "fast exit"). The
rows go through K4 (`pack_rows`) into K1's (16, A + 128) record, as the
JAX script packs them; the same rows as bf16-packed words (log-opacity)
through K4 into K5's (8, A + 128) record. K1 runs without stats. Reports
ms per launch (CUDA events on the card, the host clock elsewhere), us per
chunk and the chunks K1 composited before its exit (`cend`).

    python -m log_tpu_torch.scripts.bench_kernel [--reps R]
"""
from __future__ import annotations

import argparse
import time

import torch

from . import _common as C

H, W = 1088, 1920
SIGMA = 6.0


def tile_tables(num_tiles: int, cpt: int, dev):
    """(tile_of (A,), starts, counts) of cpt chunks per tile, A =
    num_tiles * cpt * 128 pairs in tile order (int32)."""
    from ..ops.rasterize_tiled import PAIR_CHUNK

    per = cpt * PAIR_CHUNK
    A = num_tiles * per
    tile_of = torch.arange(A, dtype=torch.int32, device=dev) // per
    starts = torch.arange(num_tiles, dtype=torch.int32, device=dev) * per
    counts = torch.full((num_tiles,), per, dtype=torch.int32, device=dev)
    return tile_of, starts, counts


def make_pairs(tiles_x: int, tiles_y: int, cpt: int, opacity: float, gen,
               dev):
    """The JAX script's rows: px, py (jittered around the tile centre),
    conic (1/36, 0, 1/36), opacity, rgb (0.7, 0.4, 0.2), depth = the pair
    index (already sorted), gid 0; each padded to a multiple of 2^15.
    Returns (rows (11 tensors of A2), starts, counts, A)."""
    from ..ops.rasterize_tiled import TILE_H, TILE_W

    tile_of, starts, counts = tile_tables(tiles_x * tiles_y, cpt, dev)
    A = tile_of.shape[0]
    ty, tx = tile_of // tiles_x, tile_of % tiles_x
    f32 = dict(dtype=torch.float32, device=dev)
    px = (tx.float() * TILE_W + 64.0
          + (torch.rand(A, generator=gen, **f32) * 80.0 - 40.0))
    py = (ty.float() * TILE_H + 4.0
          + (torch.rand(A, generator=gen, **f32) * 6.0 - 3.0))
    inv = 1.0 / SIGMA ** 2

    def full(v):
        return torch.full((A,), v, **f32)

    rows = [px, py, full(inv), full(0.0), full(inv), full(opacity),
            full(0.7), full(0.4), full(0.2),
            torch.arange(A, **f32), full(0.0)]
    A2 = -(-A // (1 << 15)) * (1 << 15)
    rows = [torch.nn.functional.pad(r, (0, A2 - A)) for r in rows]
    return rows, starts, counts, A


def packed_records(rows):
    """K5's (8, A2 + 128) record of the same rows (K4)."""
    from ..ops import rasterize_tiled as rt

    px, py, cxx, cxy, cyy, op, r, g, b = rows[:9]
    words = [px, py, rt.pack2_bf16(cxx, cxy),
             rt.pack2_bf16(cyy, torch.log(torch.clamp(op, min=1e-38))),
             rt.pack2_bf16(r, g), rt.pack2_bf16(b, torch.zeros_like(b))]
    return rt.pack_rows([w.contiguous().view(torch.float32) for w in words],
                        rt.P_N_ROWS, rt.PAIR_CHUNK)


def launch_ms(fn, reps: int, dev) -> float:
    """ms per call of fn over reps calls after one: CUDA events on the
    card, the host clock elsewhere."""
    fn()
    if dev.type == "cuda":
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize(dev)
        e0.record()
        for _ in range(reps):
            fn()
        e1.record()
        torch.cuda.synchronize(dev)
        return e0.elapsed_time(e1) / reps
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) * 1e3 / reps


def run(cpts=(4, 12), opacities=(0.05, 0.9), reps: int = 10, h: int = H,
        w: int = W, device=None, hold=None) -> dict:
    """One row per (cpt, opacity): K1 (no stats) and K5 on the same table.
    hold(label) wraps each table's packs (K4) and first K1 and K5 launch
    (chip_smoke.py holds them against the plain versions)."""
    from ..ops import rasterize_tiled as rt

    dev = C.resolve_device(device)
    tiles_x, tiles_y = -(-w // rt.TILE_W), -(-h // rt.TILE_H)
    bg = torch.zeros(3, device=dev)
    out = {"metric": "kernel_isolation", "card": C.card_line(dev),
           "h": h, "w": w, "tiles": tiles_x * tiles_y, "reps": reps,
           "rows": []}
    for cpt in cpts:
        for opac in opacities:
            gen = torch.Generator(device=dev).manual_seed(C.SEED)
            rows, starts, counts, A = make_pairs(tiles_x, tiles_y, cpt, opac,
                                                 gen, dev)
            with C.held(hold, f"bench_kernel cpt{cpt} op{opac:g}"):
                pair_data = rt.pack_rows(rows)
                packed = packed_records(rows)
                cend = rt.rasterize_forward(pair_data, starts, counts, bg,
                                            tiles_x, tiles_y, False)[5]
                rt.rasterize_forward_packed(packed, starts, counts, bg,
                                            tiles_x, tiles_y)

            def k1():
                return rt.rasterize_forward(pair_data, starts, counts, bg,
                                            tiles_x, tiles_y, False)

            def k5():
                return rt.rasterize_forward_packed(packed, starts, counts, bg,
                                                   tiles_x, tiles_y)
            n_chunks = tiles_x * tiles_y * cpt
            ms1, ms5 = launch_ms(k1, reps, dev), launch_ms(k5, reps, dev)
            out["rows"].append({
                "chunks_per_tile": cpt, "opacity": opac,
                "exit": "fast exit" if opac >= 0.5 else "no exit",
                "pairs": A, "chunks": n_chunks,
                "chunks_composited_mean": float(cend.float().mean()),
                "k1_ms": ms1, "k1_us_per_chunk": ms1 * 1e3 / n_chunks,
                "k5_ms": ms5, "k5_us_per_chunk": ms5 * 1e3 / n_chunks})
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=10)
    C.emit(run(reps=ap.parse_args(argv).reps))


if __name__ == "__main__":
    main()
