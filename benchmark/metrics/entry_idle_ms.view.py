"""Device idle a served frame, in ms, while the innermost open span of the
program is `vis` or one of its own parts (`vis.camera`, `vis.quantize`,
`vis.to_numpy`, and the `sync.vis_copy` waits in it): the entry's host
work around the frame (benchmark/harness/spans.py; moves frame_ms). None
where the program opens no such span."""
from benchmark.harness import spans


def read(lay):
    return spans.idle_ms(lay, spans.named("vis"), len(lay.frames))
