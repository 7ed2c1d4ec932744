"""The reference's compositing against the port's, on splats dense enough
that every tile saturates over many chunks of pairs: the final
transmittance, the image and the gradients agree to float32 rounding,
and the same splats get a gradient on both sides."""
from __future__ import annotations

import pytest
import torch

H, W = 64, 256


def _splats(n: int, seed: int):
    g = torch.Generator().manual_seed(seed)

    def u(*shape):
        return torch.rand(*shape, generator=g)

    px, py = u(n) * (W + 20) - 10, u(n) * (H + 20) - 10
    sx, sy = 2 + 10 * u(n), 2 + 10 * u(n)
    rho = (u(n) - 0.5) * 1.2
    cxx, cyy, cxy = sx * sx, sy * sy, rho * sx * sy
    det = cxx * cyy - cxy * cxy
    s = {"px": px, "py": py, "a": cyy / det, "b": -cxy / det,
         "c": cxx / det, "op": 0.3 + 0.69 * u(n), "depth": 1 + 10 * u(n),
         "radius": torch.ceil(3 * torch.maximum(sx, sy)),
         "valid": torch.ones(n, dtype=torch.bool)}
    return s, u(n, 3), u(3, H, W)


@pytest.mark.parametrize("seed", [3, 4])
def test_composite_matches_port(cpu_tiled, seed):
    from log_tpu_torch.ops import rasterize_tiled as rt
    from log_tpu_torch.ops.projection import Splats

    from benchmark.reference import raster

    s, rgb, probe = _splats(4000, seed)
    bg = torch.tensor([0.3, 0.6, 0.9])

    op_r = s["op"].clone().requires_grad_(True)
    rgb_r = rgb.clone().requires_grad_(True)
    ref = raster.composite(dict(s, op=op_r), rgb_r, H, W, bg)
    (ref["image"] * probe).sum().backward()

    op_p = s["op"].clone().requires_grad_(True)
    rgb_p = rgb.clone().requires_grad_(True)
    sp = Splats(torch.stack([s["px"], s["py"]], 1),
                torch.stack([s["a"], s["b"], s["c"]], 1), op_p, s["depth"],
                s["radius"], s["valid"])
    pairs = rt.build_pairs(sp, rgb_p, H, W, 1 << 20)
    color, tfinal, *_ = rt.RasterCore.apply(
        pairs["pair_data"], pairs["tile_start"], pairs["tile_count"], bg,
        pairs["tiles_x"], pairs["tiles_y"], False)
    (color[:, :H, :W] * probe).sum().backward()

    assert int(pairs["total"]) == ref["pairs"]
    assert int(pairs["tile_count"].min()) > 4 * raster.CHUNK
    assert float(tfinal.detach().max()) < 1e-4   # every pixel saturated
    assert (tfinal[:H, :W] - ref["t_final"]).abs().max() < 1e-9
    assert (color[:, :H, :W] - ref["image"]).abs().max() < 1e-5
    assert torch.equal(op_p.grad != 0, op_r.grad != 0)
    scale = op_r.grad.abs().max()
    assert (op_p.grad - op_r.grad).abs().max() < 1e-6 * scale
    assert (rgb_p.grad - rgb_r.grad).abs().max() < 1e-6 * rgb_r.grad.abs().max()
