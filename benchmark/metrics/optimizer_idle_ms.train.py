"""Device idle a training step, in ms, while the innermost open span of
the program is `train_step.update` or any span nested in it: the
counters, sparse Adam, the scale clamp and the per-view gain
(benchmark/harness/spans.py; moves step_ms). None where the program opens
no such span."""
from benchmark.harness import spans


def read(lay):
    return spans.idle_ms(lay, spans.within("train_step.update"),
                         len(lay.steps))
