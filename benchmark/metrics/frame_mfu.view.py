"""The whole frame's share of the card's float32 peak, in %: the useful
operations of the traced frames (benchmark/harness/work.py frame_ops: the
cull's check render, the cut's radius over every row, the projection and
SH of the cut's points and the compositing, counted from the reference)
over the traced window times 67 TFLOP/s (moves frame_ms)."""
from benchmark.harness import work


def read(lay):
    if not lay.works:
        return None
    ops = sum(work.frame_ops(w, lay.sh_degree) for w in lay.works)
    return 100.0 * ops / (lay.traced_s * work.PEAK_FP32)
