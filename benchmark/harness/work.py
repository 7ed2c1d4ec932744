"""The work a frame or a step needs, counted from the reference's
projection of the reference's cut (so the count does not depend on what
implements the frame), and the published peaks of one NVIDIA H100 SXM
(NVIDIA's data sheet, dense, at its 700 W limit).

Operation counts are float32 operations:
- compositing, forward: 20 per contributing (splat, pixel) combination
  (the offset, the quadratic form, the exponential, the gates, the
  transmittance update and three colour channels);
- compositing, backward: 40 per combination (the recurrence back to
  front and the seven splat gradients);
- projection of a splat (3D covariance, EWA screen covariance, its
  inverse, radius and pixel centre): 150; its backward: 300;
- SH of degree 1 (view direction and one band, three channels): 30;
  degree 0: 3;
- the LoD cut's radius of a row (covariance, screen covariance,
  eigenvalue): 120;
- SSIM of a pixel (five images blurred by 11 + 11 taps, three channels,
  the map): 700; its backward twice that.
Bytes of a compositing call: each splat record read once (position,
conic, opacity, colour: 9 float32) and each output pixel written once
(colour and transmittance: 4 float32); the backward also reads the image
gradient (3) and writes the splat gradients (9).
"""
from __future__ import annotations

PEAK_FP32 = 67e12       # FLOP/s, float32 outside the tensor cores
PEAK_BYTES = 3.35e12    # bytes/s of HBM3
OPS_COMPOSITE = 20
OPS_COMPOSITE_BWD = 40
OPS_PROJECT = 150
OPS_PROJECT_BWD = 300
OPS_CUT_RADIUS = 120
OPS_SSIM = 700
SPLAT_BYTES = 9 * 4
PIXEL_BYTES = 4 * 4


def ops_sh(degree: int) -> int:
    return 30 if degree >= 1 else 3


def bound_s(ops: float, nbytes: float) -> float:
    """The least time the card could take: the larger of the operations
    over the float32 peak and the bytes over the memory rate."""
    return max(ops / PEAK_FP32, nbytes / PEAK_BYTES)


def composite_bound_s(w: dict) -> float:
    """A frame's compositing call (`w` from the reference frame)."""
    return bound_s(OPS_COMPOSITE * w["combos"],
                   SPLAT_BYTES * w["splats"] + PIXEL_BYTES * w["pixels"])


def backward_bound_s(w: dict) -> float:
    """A step's compositing backward."""
    return bound_s(OPS_COMPOSITE_BWD * w["combos"],
                   2 * SPLAT_BYTES * w["splats"] + (3 + 1) * 4 * w["pixels"])


def frame_ops(w: dict, sh_degree: int) -> float:
    """A served frame's useful operations: the cull's check render, the
    cut's radius over every row, projection and SH of the cut's points,
    and the compositing."""
    return (OPS_COMPOSITE * (w["combos"] + w["check_combos"])
            + OPS_CUT_RADIUS * w["rows"]
            + (OPS_PROJECT + ops_sh(sh_degree)) * w["cut"])


def step_ops(w: dict, sh_degree: int) -> float:
    """A training step's useful operations: the frame's (with the cut's
    points rendered forward and backward) plus the loss and its
    backward."""
    return (frame_ops(w, sh_degree)
            + OPS_COMPOSITE_BWD * w["combos"]
            + OPS_PROJECT_BWD * w["cut"]
            + 3 * OPS_SSIM * w["pixels"])
