"""Device idle a training step, in ms, while the innermost open span of
the program is `trainer.training_step` or one of its own parts
(`trainer.camera`, `trainer.gt`, `trainer.output`, and the `sync.*` waits
in them): the trainer's host work around the step
(benchmark/harness/spans.py; moves step_ms). None where the program opens
no such span."""
from benchmark.harness import spans


def read(lay):
    return spans.idle_ms(lay, spans.named("trainer"), len(lay.steps))
