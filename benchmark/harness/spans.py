"""The program's spans in a traced window, read against the device.

`lay.trace.spans` holds the host ranges of the window: the harness's
`bench.*` spans and the program's own (log_tpu_torch/utils/profiler.py
`span`: `vis`, `render_fused`, `trainer.training_step`, their stages and
the `sync.<site>` spans around each statement that waits for the device),
on the profiler's clock, which is also the clock of `lay.trace.device`.
Spans of one thread nest, so each instant of the window has an innermost
open span. Here each stretch of device idle is put down to the innermost
span open during it, split where the innermost span changes, with no cut
to the largest; a `sync.*` span passes what falls in it to the span it
sits in (its own duration is the host's wait, not a layer's work). The
host syncs of a frame or a step are the `sync.*` spans nested in the
frame's or step's top-level span.
"""
from __future__ import annotations

from bisect import bisect_right


class Node:
    __slots__ = ("name", "t0", "t1", "parent")

    def __init__(self, name, t0, t1, parent):
        self.name, self.t0, self.t1, self.parent = name, t0, t1, parent

    def chain(self):
        """This span's name and those of the spans it sits in, innermost
        first."""
        node, names = self, []
        while node is not None:
            names.append(node.name)
            node = node.parent
        return names


def nest(spans, win):
    """The spans that lie in the window, each with the span it sits in."""
    a, b = win
    inside = sorted((s for s in spans if s[1] >= a and s[2] <= b),
                    key=lambda s: (s[1], -s[2]))
    nodes, stack = [], []
    for name, t0, t1 in inside:
        while stack and stack[-1].t1 <= t0:
            stack.pop()
        node = Node(name, t0, t1, stack[-1] if stack else None)
        nodes.append(node)
        stack.append(node)
    return nodes


def idle_gaps(trace, win):
    """The device's idle intervals (start, end) in the window, in order."""
    a, b = win
    gaps, end = [], a
    for t0, t1 in sorted((t0, t1) for _, t0, t1, _ in trace.clipped(win)):
        if t0 > end:
            gaps.append((end, t0))
        end = max(end, t1)
    if b > end:
        gaps.append((end, b))
    return gaps


class IdleClock:
    """Idle device time (us) between any two instants of the window."""

    def __init__(self, gaps):
        self.starts = [g0 for g0, _ in gaps]
        self.gaps = gaps
        self.before = [0.0]
        for g0, g1 in gaps:
            self.before.append(self.before[-1] + (g1 - g0))

    def upto(self, t):
        i = bisect_right(self.starts, t)
        if i == 0:
            return 0.0
        g0, g1 = self.gaps[i - 1]
        return self.before[i - 1] + min(t, g1) - g0

    def between(self, t0, t1):
        return self.upto(t1) - self.upto(t0)


def owned_idle(lay):
    """{node: idle seconds}: the device idle of the window while each span
    was the innermost open one, a `sync.*` span's passed to the span it
    sits in (and dropped where it sits in none)."""
    nodes = nest(lay.trace.spans, lay.window)
    clock = IdleClock(idle_gaps(lay.trace, lay.window))
    own = {n: clock.between(n.t0, n.t1) for n in nodes}
    for n in nodes:
        if n.parent is not None:
            own[n.parent] -= clock.between(n.t0, n.t1)
    out = {}
    for n in nodes:
        owner = n
        while owner is not None and owner.name.startswith("sync."):
            owner = owner.parent
        if owner is not None:
            out[owner] = out.get(owner, 0.0) + own[n] / 1e6
    return out


def idle_ms(lay, owns, per):
    """The idle ms per frame or step (`per` of them) put down to spans for
    which owns(names: the span's and its enclosing spans', innermost
    first) holds; None where no span of the window satisfies it."""
    hits = [s for n, s in owned_idle(lay).items() if owns(n.chain())]
    if not hits:
        return None
    return 1e3 * sum(hits) / per


def named(*names):
    """owns(): the innermost span is one of `names` or `<name>.*`."""
    def owns(chain):
        return any(chain[0] == n or chain[0].startswith(n + ".")
                   for n in names)
    return owns


def within(name):
    """owns(): the span is `name` or sits, at any depth, in one."""
    return lambda chain: name in chain


def syncs_per(lay, top, per):
    """The `sync.*` spans nested in a `top` span, per frame or step; None
    where the window has no `top` span."""
    nodes = nest(lay.trace.spans, lay.window)
    if not any(n.name == top for n in nodes):
        return None
    return sum(n.name.startswith("sync.") and top in n.chain()[1:]
               for n in nodes) / per
