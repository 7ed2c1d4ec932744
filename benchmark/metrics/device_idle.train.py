"""The device's idle share of the traced steps, in %: 1 - the union of
the device operations' intervals over the traced window (moves
step_ms)."""


def read(lay):
    return 100.0 * (1.0 - lay.busy_s / lay.traced_s)
