"""Per-training-view RGB gain: the host state of its AMSGrad Adam;
counterpart of log_tpu/model/corrector.py.

Gain (num_views, 3) initialized to 1.0. The training step updates one view
per step on the device (model/train_step.py: log-lerp LR 0.1 -> 0.001 over
100 per-view steps, AMSGrad, eps 1e-15); this container holds the values
and moments between the device copies and checkpoints.
"""
from __future__ import annotations

import numpy as np


class Corrector:
    def __init__(self, use_view_correction):
        self.use_view_correction = use_view_correction
        self.values = np.ones((0, 3), np.float32)
        self._setup = False

    def init(self, num_views: int):
        if self.use_view_correction:
            self.values = np.ones((num_views, 3), np.float32)
            print(f"[{self.__class__.__name__}] init view correction: "
                  f"{num_views}")

    def training_setup(self):
        if self._setup:
            print(f"[{self.__class__.__name__}] optimizer is already setup")
            return
        self._setup = True
        n = self.values.shape[0]
        self.exp_avg = np.zeros((n, 3), np.float32)
        self.exp_avg_sq = np.zeros((n, 3), np.float32)
        self.max_exp_avg_sq = np.zeros((n, 3), np.float32)
        self.steps = np.zeros((n,), np.int64)
        print(f"[{self.__class__.__name__}] view correction optimizer setup")

    def set_values(self, values):
        self.values = np.asarray(values, np.float32)
