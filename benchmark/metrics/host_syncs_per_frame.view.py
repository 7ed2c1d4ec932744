"""Host syncs a served frame: the `sync.<site>` spans that the program
opens inside its `vis` span, one around each statement that waits for the
device, over the traced frames (benchmark/harness/spans.py; moves
frame_ms). None where the program opens no `vis` span."""
from benchmark.harness import spans


def read(lay):
    return spans.syncs_per(lay, "vis", len(lay.frames))
