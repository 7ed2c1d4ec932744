"""The traced window: torch.profiler over the device and the benchmark's
own spans, read back from its Chrome trace.

`Trace` holds the device operations (kernels, copies, memsets) with
their intervals and the host spans (record_function ranges: the
benchmark's `bench.*` spans and the program's own) of the window, and
gives the device's busy time as the union of the device intervals, the
device operations that took most time and the idle gaps by the host span
that was open during them.
"""
from __future__ import annotations

import json
import os
import shutil
import tempfile
from collections import defaultdict
from contextlib import contextmanager

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
TOP = 10


@contextmanager
def profiled():
    """Profile CPU and CUDA activity; yields a holder whose `.trace` is
    the parsed Trace once the block has exited."""
    from torch.profiler import ProfilerActivity, profile

    holder = type("Holder", (), {"trace": None})()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) \
            as prof:
        yield holder
    tmp = tempfile.mkdtemp(prefix="bench_trace_")
    try:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            holder.trace = Trace(json.load(f)["traceEvents"])
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _short(name: str) -> str:
    """A kernel's name without its argument list."""
    name = name.replace("(anonymous namespace)", "{anonymous}")
    cut = name.find("(")
    return (name[:cut] if cut > 0 else name).strip()[:120]


def union_length(intervals):
    """Total length covered by (start, end) intervals."""
    total, end = 0.0, None
    for a, b in sorted(intervals):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


class Trace:
    def __init__(self, events):
        self.device = []   # (name, start_us, end_us, category)
        self.spans = []    # (name, start_us, end_us) of host ranges
        for e in events:
            if e.get("ph") != "X" or "dur" not in e:
                continue
            cat = e.get("cat", "")
            t0, t1 = float(e["ts"]), float(e["ts"]) + float(e["dur"])
            if cat in DEVICE_CATS:
                self.device.append((e.get("name", "?"), t0, t1, cat))
            elif cat == "user_annotation":
                self.spans.append((e.get("name", "?"), t0, t1))

    def window(self, prefix: str):
        """(start, end) in us from the first to the last host span whose
        name starts with prefix."""
        sp = [s for s in self.spans if s[0].startswith(prefix)]
        if not sp:
            raise RuntimeError(f"no span {prefix!r} in the trace")
        return min(s[1] for s in sp), max(s[2] for s in sp)

    def clipped(self, win):
        a, b = win
        return [(n, max(t0, a), min(t1, b), c) for n, t0, t1, c in self.device
                if t1 > a and t0 < b]

    def busy_s(self, win) -> float:
        return union_length([(t0, t1) for _, t0, t1, _ in self.clipped(win)]) \
            / 1e6

    def kernels(self, win):
        return [(n, t0, t1) for n, t0, t1, c in self.clipped(win)
                if c == "kernel"]

    def kernel_seconds(self, win, patterns) -> float:
        """Device seconds of the kernels whose name holds any pattern."""
        return sum(t1 - t0 for n, t0, t1 in self.kernels(win)
                   if any(p in n for p in patterns)) / 1e6

    def top_ops(self, win):
        by = defaultdict(float)
        for n, t0, t1, _ in self.clipped(win):
            by[_short(n)] += (t1 - t0) / 1e6
        return sorted(([k, v] for k, v in by.items()),
                      key=lambda kv: -kv[1])[:TOP]

    def idle_gaps(self, win):
        """Idle device time in the window, summed by the innermost host
        span open at each gap's middle ('between spans' where none)."""
        a, b = win
        iv = sorted((t0, t1) for _, t0, t1, _ in self.clipped(win))
        gaps, end = [], a
        for t0, t1 in iv:
            if t0 > end:
                gaps.append((end, t0))
            end = max(end, t1)
        if b > end:
            gaps.append((end, b))
        by = defaultdict(float)
        spans = sorted(self.spans, key=lambda s: s[1])
        active, j = [], 0
        for g0, g1 in gaps:   # in time order: one sweep over the spans
            mid = 0.5 * (g0 + g1)
            while j < len(spans) and spans[j][1] <= mid:
                active.append(spans[j])
                j += 1
            active = [s for s in active if s[2] >= mid]
            name = (max(active, key=lambda s: s[1])[0] if active
                    else "between spans")
            by[name] += (g1 - g0) / 1e6
        return sorted(([k, v] for k, v in by.items()),
                      key=lambda kv: -kv[1])[:TOP]
