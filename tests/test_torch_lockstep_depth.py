"""The lockstep run with the depth loss: every step draws its 64 depth
patch corners as the JAX step does, `jax.random.randint` from the two keys
of `split(PRNGKey(global step))`, which the port draws with
utils/jax_random.py. The scene of tests/test_torch_lockstep_host.py plus a
16-bit depth map per view (uniform noise from a numpy seed) read through
DepthDataset at depth_scale 1; both stages train at scale 1, so that the
64x80 renders hold a 64-pixel patch. 3 + 1 loader iterations (32 steps:
the init densify at step 15; the tree stage's 8 steps reach no update).
Same limits as the host run; no densify flipped.
"""
import os

import numpy as np

import lockstep_runs as L
from log_tpu_torch.apps import make_synthetic_scene
from log_tpu_torch.utils import image_io

DEPTH_OPTS = ["dataset.module", "LoG.dataset.colmap.DepthDataset",
              "dataset.args.depth_scale", "1",
              "RGB_RENDER_L1_SSIM.args.render_depth", "True",
              "NAIVE_STAGE.init.dataset_state.scale", "1",
              "NAIVE_STAGE.tree.dataset_state.scale", "1",
              "NAIVE_STAGE.tree.loader.args.iterations", "1"]


def _depth_scene(scene):
    make_synthetic_scene.main([str(scene), "300", str(L.VIEWS), "64", "80",
                               ".png", "--device", "cpu"])
    rng = np.random.default_rng(9)
    for i in range(L.VIEWS):
        name = scene / "cache" / "1" / "depth" / "cam" / f"{i:04d}.png.png"
        os.makedirs(name.parent, exist_ok=True)
        image_io.imwrite(str(name), rng.integers(0, 2 ** 16, (64, 80))
                         .astype(np.uint16))


def test_cli_lockstep_depth_patches(tmp_path):
    runs = L.run_both(tmp_path, DEPTH_OPTS, scene_maker=_depth_scene)
    gaps = L.compare(runs)
    assert len(runs["port"]["steps"]) == 32
    assert [e[0] for e in runs["port"]["events"]] == [15]
    print(gaps)
