"""Device kernel launches a training step, from the profiler's trace: the
kernels in the traced window over the steps (the host's dispatch; moves
step_ms). None where the window holds no kernel."""


def read(lay):
    n = len(lay.trace.kernels(lay.window))
    return n / len(lay.steps) if n else None
