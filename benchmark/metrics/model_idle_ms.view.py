"""Device idle a served frame, in ms, while the innermost open span of the
program is `render_fused` or any span nested in it (its inputs and
buckets, the root cull, the frame's stages down to the binning and the
kernels): the model's host work and dispatch (benchmark/harness/spans.py;
moves frame_ms). None where the program opens no such span."""
from benchmark.harness import spans


def read(lay):
    return spans.idle_ms(lay, spans.within("render_fused"),
                         len(lay.frames))
