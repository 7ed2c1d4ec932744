"""The whole training step's share of the card's float32 peak, in %: the
useful operations of the traced steps (benchmark/harness/work.py
step_ops: the frame's work with the render's backward, the projection's
backward and the SSIM loss, counted from the reference) over the traced
window times 67 TFLOP/s (moves step_ms)."""
from benchmark.harness import work


def read(lay):
    if not lay.works:
        return None
    ops = sum(work.step_ops(w, lay.sh_degree) for w in lay.works)
    return 100.0 * ops / (lay.traced_s * work.PEAK_FP32)
