"""Per-training-view RGB gain: the host state of its AMSGrad Adam;
counterpart of log_tpu/model/corrector.py.

Gain (num_views, 3) initialized to 1.0. The training step updates one view
per step on the device (model/train_step.py: log-lerp LR 0.1 -> 0.001 over
100 per-view steps, AMSGrad, eps 1e-15); this container holds the values
and moments between the device copies and checkpoints. `get` and `step`
are the same update on the host, for callers that keep the gain there.
"""
from __future__ import annotations

import numpy as np


class Corrector:
    def __init__(self, use_view_correction, start_step=0, lr_init=0.1,
                 lr_final=0.001):
        self.lr_init = lr_init
        self.lr_final = lr_final
        self.start_step = start_step
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

    def get(self, index: int) -> np.ndarray:
        if self.values.shape[0] == 0:
            return np.ones(3, np.float32)
        return self.values[index]

    def step(self, index: int, grad: np.ndarray, eps=1e-15, beta1=0.9,
             beta2=0.999):
        """One AMSGrad step of view `index`'s gain on the host, the learning
        rate log-lerped from lr_init to lr_final over 100 per-view steps
        counted from start_step."""
        if not self.use_view_correction or self.values.shape[0] == 0:
            return
        if not self._setup:
            self.training_setup()
        if index >= self.values.shape[0]:
            return
        self.steps[index] += 1
        step = self.steps[index] - self.start_step
        if step < 0:
            return
        t = np.clip(step / 100.0, 0, 1)
        lr = float(np.exp(np.log(self.lr_init) * (1 - t)
                          + np.log(self.lr_final) * t))
        m1 = self.exp_avg[index] = (beta1 * self.exp_avg[index]
                                    + (1 - beta1) * grad)
        m2 = self.exp_avg_sq[index] = (beta2 * self.exp_avg_sq[index]
                                       + (1 - beta2) * grad * grad)
        self.max_exp_avg_sq[index] = np.maximum(self.max_exp_avg_sq[index],
                                                m2)
        bias1 = 1 - beta1 ** step
        bias2 = 1 - beta2 ** step
        denom = np.sqrt(self.max_exp_avg_sq[index]) / np.sqrt(bias2) + eps
        self.values[index] = self.values[index] - (lr / bias1) * (m1 / denom)
