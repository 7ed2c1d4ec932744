"""Device idle a training step, in ms, while the innermost open span of
the program is `train_step.visibility` or any span nested in it: the
visibility pass and the LoD cut in front of the step
(benchmark/harness/spans.py; moves step_ms). None where the program opens
no such span."""
from benchmark.harness import spans


def read(lay):
    return spans.idle_ms(lay, spans.within("train_step.visibility"),
                         len(lay.steps))
