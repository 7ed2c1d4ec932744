"""The binning's unclamped pair demand a frame: the mean over the traced
frames of LoG.frame_stats()'s pair_total, a counter of the program (moves
frame_ms). None where the frame reports no demand."""


def read(lay):
    vals = [f[3]["pair_total"] for f in lay.frames]
    if not vals or min(vals) < 0:
        return None
    return sum(vals) / len(vals)
