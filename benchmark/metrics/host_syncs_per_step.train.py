"""Host syncs a training step: the `sync.<site>` spans that the program
opens inside its `trainer.training_step` span, one around each statement
that waits for the device, over the traced steps
(benchmark/harness/spans.py; moves step_ms). None where the program
opens no `trainer.training_step` span."""
from benchmark.harness import spans


def read(lay):
    return spans.syncs_per(lay, "trainer.training_step", len(lay.steps))
