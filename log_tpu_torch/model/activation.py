"""Parameter-space <-> physical-space activations; counterpart of
log_tpu/model/activation.py (scaling exp/sigmoid/tanh; opacity sigmoid;
rotation L2-normalize; colors SH-DC + optional view-dependent SH)."""
from __future__ import annotations

import numpy as np
import torch

from ..ops.sh import eval_sh, rgb_to_sh, sh_to_rgb


def logit(x):
    return torch.log(x / (1.0 - x))


def normalize(x, dim=-1, eps=1e-12):
    n = torch.sqrt(torch.sum(x * x, dim=dim, keepdim=True))
    return x / torch.clamp(n, min=eps)


class Activation:
    """Configurable activation container (LoG/model/activation.py)."""

    def __init__(self, scaling_activation: str = "exp"):
        if scaling_activation == "exp":
            self.scaling_activation = torch.exp
            self.scaling_inverse_activation = torch.log
        elif scaling_activation == "sigmoid":
            self.scaling_activation = torch.sigmoid
            self.scaling_inverse_activation = logit
        elif scaling_activation == "tanh":
            self.scaling_activation = torch.tanh
            self.scaling_inverse_activation = torch.atanh
        else:
            raise ValueError(scaling_activation)
        self.opacity_activation = torch.sigmoid
        self.opacity_inverse_activation = logit
        self.rotation_activation = normalize
        self.rgb_inverse = rgb_to_sh

    @staticmethod
    def init_rotation(num_points):
        rot = np.zeros((num_points, 4), dtype=np.float32)
        rot[:, 0] = 1.0
        return rot

    def colors_activation(self, params, camera_center, active_sh_degree: int):
        colors = sh_to_rgb(params["colors"])
        if active_sh_degree > 0 and camera_center is not None and "shs" in params:
            dirs = normalize(params["xyz"] - camera_center[None])
            colors = colors + eval_sh(dirs, params["shs"], degree=active_sh_degree)
        return colors

    def activate(self, params, camera_center, active_sh_degree: int):
        """Param-space dict -> physical dict."""
        return {
            "xyz": params["xyz"],
            "scaling": self.scaling_activation(params["scaling"]),
            "opacity": self.opacity_activation(params["opacity"]),
            "rotation": self.rotation_activation(params["rotation"]),
            "colors": self.colors_activation(params, camera_center,
                                             active_sh_degree),
        }
