"""Profiling hooks; counterpart of log_tpu/utils/profiler.py.

`span(name)` is how the port marks a stretch of its host work: while
torch.profiler records, a `record_function` range, which lands in the
profiler's trace on the clock of the device's kernels, copies and fills,
so that each idle gap of the device can be put down to the host work
behind it; otherwise one shared null context. A span's name is its root
(SPAN_ROOTS) or `<root>.<part>`; the spans of a frame or a step nest in
its top-level span (`vis`, `trainer.training_step`), and a statement that
blocks the host until the device catches up sits alone in a
`sync.<site>` span, whose duration is the host's wait.

`profile_if(enabled, logdir)` wraps a block in torch.profiler (CPU and, on
a CUDA machine, CUDA activities) and writes a Chrome trace, spans
included, and a table of device time by kernel into logdir. `Timer`
accumulates the time of a block and prints the demo and val loops'
"Average time: ... ms, fps: ..." line: on a CUDA device between two CUDA
events (the stream's time from the block's first launch to its last,
host gaps included), else on the host clock.
"""
from __future__ import annotations

import contextlib
import os
import time

import torch
from torch.profiler import record_function

# the first word of every span name the port opens
SPAN_ROOTS = ("vis", "trainer", "render_fused", "training_iteration", "cull",
              "frame", "block", "raster", "train_step", "sync")
_OFF = contextlib.nullcontext()


def span(name: str):
    """A `record_function(name)` range while torch.profiler records, else
    the shared null context: with no profiler, one check and nothing
    allocated."""
    if torch.autograd._profiler_enabled():
        return record_function(name)
    return _OFF


def is_span(name: str) -> bool:
    """Whether a trace record's name is one of the port's spans."""
    return name.split(".", 1)[0] in SPAN_ROOTS


@contextlib.contextmanager
def profile_if(enabled: bool, logdir: str = "output/torch_trace"):
    if not enabled:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield
    os.makedirs(logdir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
    sort = "self_cuda_time_total" if len(acts) > 1 else "self_cpu_time_total"
    with open(os.path.join(logdir, "kernels.txt"), "w") as f:
        f.write(prof.key_averages().table(sort_by=sort, row_limit=60))
    print(f"[profiler] trace written to {logdir}")


class Timer:
    """Accumulates the time of measured blocks."""

    def __init__(self, device="cpu"):
        self.cuda = torch.device(device).type == "cuda"
        self.total_ms = 0.0
        self.count = 0

    @contextlib.contextmanager
    def measure(self):
        if self.cuda:
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            yield
            e1.record()
            e1.synchronize()
            self.total_ms += e0.elapsed_time(e1)
        else:
            t0 = time.perf_counter()
            yield
            self.total_ms += (time.perf_counter() - t0) * 1000.0
        self.count += 1

    @property
    def mean_ms(self) -> float:
        return self.total_ms / max(self.count, 1)

    def report(self, prefix: str = "") -> str:
        avg = self.mean_ms
        line = (f"{prefix}Average time: {avg:.2f} ms, fps: "
                f"{1000.0 / max(avg, 1e-9):.1f}")
        print(line)
        return line
