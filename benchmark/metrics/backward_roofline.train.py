"""The step's compositing backward (K2) against its roofline, in %: 40
float32 operations per contributing (splat, pixel) combination of the
reference's render of each traced step's view, splat records and their
gradients read and written once, pixel gradients read once
(benchmark/harness/work.py), over the profiler's device time of K2 in
the traced steps (moves step_ms)."""
from benchmark.harness import work

KERNELS = ("rasterize_bwd_kernel",)


def read(lay):
    if not lay.works:
        return None
    t = lay.trace.kernel_seconds(lay.window, KERNELS)
    if t <= 0:
        return None
    return 100.0 * sum(work.backward_bound_s(w) for w in lay.works) / t
