"""The viewer on 2,000 random Gaussians (a BaseGaussian, SH 0, 360x480, white
background): no data needed.

    python -m log_tpu_torch.apps.check_viewer [--oneshot] [--device cuda|cpu]
        [--out debug/check_viewer.jpg]

--oneshot renders one frame to --out and returns its JPEG bytes; without it
the viewer serves on port 8008.
"""
from __future__ import annotations

import argparse
import os

import numpy as np

H, W, FOCAL = 360, 480, 500.0
PORT = 8008
ONESHOT_VIEW = (0.3, 0.4, 4.0)  # yaw, pitch, dist


def make_state(device):
    """The check's ViewerState: the seeded scene on `device`."""
    from ..dataset.synthetic import random_gaussians
    from ..model.base_gaussian import BaseGaussian
    from ..render.renderer import NaiveRendererAndLoss
    from .viewer import ViewerState

    scene = random_gaussians(2000, np.random.default_rng(0))
    model = BaseGaussian.create_from_record(scene, sh_degree=0, device=device)
    model.eval()
    renderer = NaiveRendererAndLoss(split="demo", background=(1.0, 1.0, 1.0),
                                    device=device)
    return ViewerState(model, renderer, H=H, W=W, focal=FOCAL,
                       center=(0, 0, 0), znear=0.01, zfar=100.0)


def main(argv=None):
    parser = argparse.ArgumentParser(usage=__doc__)
    parser.add_argument("--oneshot", action="store_true")
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--out", default="debug/check_viewer.jpg")
    args = parser.parse_args(argv)

    from .train import resolve_device
    from .viewer import make_handler

    state = make_state(resolve_device(args.device))
    if args.oneshot:
        jpeg = state.render_jpeg(*ONESHOT_VIEW, np.zeros(3))
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "wb") as f:
            f.write(jpeg)
        print(f"wrote {args.out} ({len(jpeg)} bytes)")
        return jpeg
    from http.server import ThreadingHTTPServer

    server = ThreadingHTTPServer(("0.0.0.0", PORT), make_handler(state))
    print(f"[check_viewer] http://localhost:{PORT}")
    try:
        server.serve_forever()
    finally:
        server.server_close()


if __name__ == "__main__":
    main()
