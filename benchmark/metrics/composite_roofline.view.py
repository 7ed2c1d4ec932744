"""The frame's compositing kernel against its roofline, in %: the least
time its work could take on the card (benchmark/harness/work.py: 20
float32 operations per contributing (splat, pixel) combination of the
reference's cut, each splat record read and each pixel written once,
against 67 TFLOP/s and 3.35 TB/s) over the profiler's device time of the
kernels below, summed over the traced frames (moves frame_ms). The
kernels: K5 (the packed records) and K1 without statistics, the
compositing of a frame on a path without K5."""
from benchmark.harness import work

KERNELS = ("rasterize_fwd_kernel<0, true>", "rasterize_fwd_kernel<0, false>")


def read(lay):
    if not lay.works:
        return None
    t = lay.trace.kernel_seconds(lay.window, KERNELS)
    if t <= 0:
        return None
    return 100.0 * sum(work.composite_bound_s(w) for w in lay.works) / t
