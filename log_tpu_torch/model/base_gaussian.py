"""The vanilla 3DGS model (no LoD tree); counterpart of
log_tpu/model/base_gaussian.py.

A `GaussianPoint` with the minimal LoG surface that the renderer, the
viewer and the point-cloud check drive: `gaussian`, `tree`, train / eval,
`set_state`, and a frustum-only `prepare_from_camera`. Its frame is the
two-phase render of `NaiveRendererAndLoss` (no `render_fused`): the keep
mask, then `render_one`, whose pair budget comes from the capacity since
the mask carries no counts.
"""
from __future__ import annotations

import numpy as np
import torch

from ..ops import gaussian_math as gm
from ..ops.sh import C0 as SH_C0
from .gaussian import GaussianPoint


class BaseGaussian(GaussianPoint):
    """GaussianPoint + standalone visibility preparation."""

    def __init__(self, init_ply=None, sh_degree=1, xyz_scale=1.0,
                 device="cuda", **kwargs):
        super().__init__(init_ply=init_ply, sh_degree=sh_degree,
                         xyz_scale=xyz_scale, device=device)
        self.current_depth = 0
        self.base_iter = 1
        self.training = False
        self.view_correction = None
        self.visibility_flag = None

    # the minimal LoG surface the renderer and the trainer read
    class _Tree:
        num_nodes = 0
        num_points = 0
        min_resolution_pixel = 3.0
        log_query = False

    tree = _Tree()

    @property
    def gaussian(self):
        """The renderer addresses `model.gaussian`; here it is the model."""
        return self

    def train(self):
        self.training = True

    def eval(self):
        self.training = False

    def clear(self):
        self.visibility_flag = None

    def set_state(self, enable_sh=None, active_sh_degree=None, **kwargs):
        if enable_sh:
            self.active_sh_degree = self.max_sh_degree
        elif active_sh_degree is not None:
            self.active_sh_degree = min(int(active_sh_degree),
                                        self.max_sh_degree)

    @torch.no_grad()
    def prepare_from_camera(self, camera: dict):
        """Frustum-only visibility: the alive rows whose NDC position lies
        inside the frustum padded by 0.5."""
        from ..render.renderer import camera_device

        cam = camera_device(camera, self.device)
        p_ndc, _ = gm.project_ndc(self.get("xyz"), cam["full_proj"])
        keep = gm.frustum_flag(p_ndc, padding=0.5) & self.alive_mask
        self.visibility_flag = {"keep_mask": keep}
        return self.visibility_flag

    prepare = prepare_from_camera

    @classmethod
    def create_from_record(cls, record: dict, sh_degree=1, device="cuda"):
        """Build from a dict of activated attributes (xyz, colors in [0, 1],
        scaling, opacity; rotation and shs optional), inverting the
        activations in numpy as the JAX package does."""
        model = cls(sh_degree=sh_degree, device=device)
        n = record["xyz"].shape[0]
        opacity = np.asarray(record["opacity"], np.float32).reshape(n, 1)
        arrays = {
            "xyz": np.asarray(record["xyz"], np.float32),
            "colors": (np.asarray(record["colors"], np.float32) - 0.5)
            / SH_C0,
            "scaling": np.log(np.asarray(record["scaling"], np.float32)),
            "opacity": np.log(opacity / (1 - opacity)),
            "rotation": np.asarray(
                record.get("rotation", cls.init_rotation(n)), np.float32),
        }
        model.keys = ["scaling", "colors", "xyz", "opacity", "rotation"]
        if sh_degree > 0:
            n_coef = (sh_degree + 1) ** 2 - 1
            arrays["shs"] = np.asarray(
                record.get("shs", np.zeros((n, n_coef, 3))), np.float32)
            model.keys.append("shs")
        model.set_numpy(arrays)
        return model

    def load_state_dict(self, state_dict, strict=True, split="demo"):
        """Take the parameter arrays of any checkpoint that has them (a
        prefix before the first '.' is dropped), whatever their count."""
        arrays = {}
        for key, val in state_dict.items():
            name = key.split(".", 1)[1] if "." in key else key
            if isinstance(val, torch.Tensor):
                val = val.detach().cpu().numpy()
            arrays[name] = np.asarray(val)
        known = [k for k in ("scaling", "colors", "xyz", "opacity",
                             "rotation", "shs") if k in arrays]
        self.keys = known
        self.set_numpy({k: arrays[k] for k in known})
        return True
