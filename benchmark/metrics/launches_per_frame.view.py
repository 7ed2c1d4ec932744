"""Device kernel launches a served frame, from the profiler's trace: the
kernels in the traced window over the frames (the host's dispatch;
moves frame_ms)."""


def read(lay):
    return len(lay.trace.kernels(lay.window)) / len(lay.frames)
