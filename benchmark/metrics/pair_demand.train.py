"""The binning's unclamped pair demand a training step: the mean over the
traced steps of the `pair_total` that each step returns in its metrics, a
counter of the program (moves step_ms). None where a step reports no
demand."""


def read(lay):
    vals = [s.get("pair_total", -1.0) for s in lay.step_stats]
    if not vals or min(vals) < 0:
        return None
    return sum(vals) / len(vals)
