"""The interactive viewer over HTTP; counterpart of apps/viewer.py.

A browser page with orbit / pan / dolly controls asks for /render?...; per
request the server runs the model's visibility pass and `render_one` and
answers a JPEG.

    python -m log_tpu_torch.apps.viewer --cfg X.yml [--device cuda|cpu] \
        ckptname <ckpt> [port 8008] [key value ...]

`cfg.viewer` may set H, W, focal and center (defaults 720, 1280, 1.2 W and
the mean point). The model runs on cuda unless --device cpu is passed; one
frame is rendered before the server starts, so that the kernels build
outside the first request. JPEGs need cv2 or PIL: without either, a request
fails instead of answering no image.
"""
from __future__ import annotations

import math
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

import numpy as np
import torch

from ..utils import image_io

JPEG_QUALITY = 85

PAGE = """<!doctype html>
<html><head><title>log_tpu viewer</title><style>
body{margin:0;background:#111;color:#ddd;font-family:monospace}
#hud{position:fixed;top:8px;left:8px;background:#0008;padding:6px}
img{display:block;margin:auto}
</style></head><body>
<div id="hud">drag: orbit | shift-drag: pan | wheel: dolly | fps <span id="fps">-</span></div>
<img id="view" width="%W%" height="%H%"/>
<script>
let yaw=0, pitch=0.5, dist=4, cx=0, cy=0, cz=0, busy=false, t0=0;
const img=document.getElementById('view');
function refresh(){
  if(busy) return; busy=true; t0=performance.now();
  const u=`/render?yaw=${yaw}&pitch=${pitch}&dist=${dist}&cx=${cx}&cy=${cy}&cz=${cz}&_=${Math.random()}`;
  const pre=new Image();
  pre.onload=()=>{img.src=pre.src; busy=false;
    document.getElementById('fps').textContent=(1000/(performance.now()-t0)).toFixed(1);};
  pre.src=u;
}
let drag=null;
img.onmousedown=e=>{drag=[e.clientX,e.clientY,e.shiftKey];e.preventDefault()};
window.onmouseup=()=>{drag=null};
window.onmousemove=e=>{
  if(!drag) return;
  const dx=e.clientX-drag[0], dy=e.clientY-drag[1];
  if(drag[2]){cx-=dx*dist*0.002; cy+=dy*dist*0.002;}
  else {yaw-=dx*0.01; pitch=Math.min(1.5,Math.max(-1.5,pitch+dy*0.01));}
  drag=[e.clientX,e.clientY,drag[2]]; refresh();
};
window.onwheel=e=>{dist*=Math.exp(e.deltaY*0.001); refresh();};
refresh(); setInterval(refresh, 250);
</script></body></html>"""


class ViewerState:
    """The model, the renderer and the screen; one frame at a time."""

    def __init__(self, model, renderer, H, W, focal, center, znear, zfar):
        self.model = model
        self.renderer = renderer
        self.H, self.W = H, W
        self.focal = focal
        self.center = np.asarray(center, np.float64)
        self.znear, self.zfar = znear, zfar
        self.lock = threading.Lock()

    def camera(self, yaw, pitch, dist, offset):
        """The prepared camera `dist` from center + offset at (yaw, pitch),
        looking at that point with +z up."""
        from ..dataset.base import prepare_camera

        eye = self.center + offset + dist * np.array([
            math.cos(yaw) * math.cos(pitch),
            math.sin(yaw) * math.cos(pitch),
            math.sin(pitch),
        ])
        fwd = (self.center + offset) - eye
        fwd = fwd / np.linalg.norm(fwd)
        up = np.array([0.0, 0.0, 1.0])
        right = np.cross(fwd, up)
        n = np.linalg.norm(right)
        right = right / (n if n > 1e-6 else 1.0)
        down = np.cross(fwd, right)
        R = np.stack([right, down, fwd], axis=0)
        T = -R @ eye[:, None]
        K = np.array([[self.focal, 0, self.W / 2], [0, self.focal, self.H / 2],
                      [0, 0, 1]])
        cam = {"K": K, "R": R, "T": T, "W": self.W, "H": self.H,
               "center": eye.reshape(3, 1)}
        return prepare_camera(cam, 1, self.znear, self.zfar)

    @torch.no_grad()
    def render_bgr(self, yaw, pitch, dist, offset):
        """The frame of one view as BGR uint8 (H, W, 3), over white."""
        with self.lock:
            camera = self.camera(yaw, pitch, dist, offset)
            self.model.clear()
            self.model.prepare_from_camera(camera)
            out = self.renderer.render_one(self.model, camera,
                                           np.ones(3, np.float32))
            return self.renderer.tensor_to_bgr(out["render"])

    def render_jpeg(self, yaw, pitch, dist, offset):
        return image_io.encode_jpeg(self.render_bgr(yaw, pitch, dist, offset),
                                    JPEG_QUALITY)


def make_handler(state: ViewerState):
    """The request handler class: GET / (the page), GET /render?yaw=&pitch=
    &dist=&cx=&cy=&cz= (a JPEG), 404 otherwise."""

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *args):
            pass

        def do_GET(self):
            parsed = urlparse(self.path)
            if parsed.path == "/":
                body = (PAGE.replace("%W%", str(state.W))
                        .replace("%H%", str(state.H))).encode()
                self.send_response(200)
                self.send_header("Content-Type", "text/html")
                self.end_headers()
                self.wfile.write(body)
            elif parsed.path == "/render":
                q = parse_qs(parsed.query)

                def f(name, default=0.0):
                    return float(q.get(name, [default])[0])

                jpeg = state.render_jpeg(
                    f("yaw"), f("pitch", 0.5), f("dist", 4.0),
                    np.array([f("cx"), f("cy"), f("cz")]),
                )
                self.send_response(200)
                self.send_header("Content-Type", "image/jpeg")
                self.send_header("Content-Length", str(len(jpeg)))
                self.end_headers()
                self.wfile.write(jpeg)
            else:
                self.send_response(404)
                self.end_headers()

    return Handler


def make_state(cfg, device) -> ViewerState:
    """The viewer of a config: its model (with cfg.ckptname loaded) in
    eval mode at full SH, its training renderer as a demo renderer, and
    the screen of cfg.viewer."""
    from ..utils.command import load_statedict
    from ..utils.config import load_object

    model = load_object(cfg.model.module, cfg.model.args, device=device)
    if "ckptname" in cfg:
        model.load_state_dict(load_statedict(cfg.ckptname))
    model.eval()
    model.set_state(enable_sh=True)
    renderer = load_object(cfg.train.render.module, cfg.train.render.args,
                           device=device)
    renderer.split = "demo"
    vc = cfg.get("viewer", {})
    xyz = model.gaussian.to_numpy(["xyz"])["xyz"]
    center = vc.get("center", xyz.mean(axis=0).tolist())
    H = int(vc.get("H", 720))
    W = int(vc.get("W", 1280))
    return ViewerState(model, renderer, H, W,
                       focal=float(vc.get("focal", 1.2 * W)), center=center,
                       znear=0.01, zfar=100.0)


def main(argv=None):
    from ..utils.command import update_global_variable
    from ..utils.config import Config
    from .train import resolve_device

    args, cfg = Config.load_args(argv, usage="viewer")
    cfg = update_global_variable(cfg, cfg)
    state = make_state(cfg, resolve_device(args.device))
    state.render_jpeg(0.0, 0.5, 4.0, np.zeros(3))  # the first page's view
    port = int(cfg.get("port", 8008))
    server = ThreadingHTTPServer(("0.0.0.0", port), make_handler(state))
    print(f"[viewer] serving on http://localhost:{port} "
          f"({state.model.num_points} pts)")
    try:
        server.serve_forever()
    finally:
        server.server_close()


if __name__ == "__main__":
    main()
