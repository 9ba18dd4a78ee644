"""The program's own spans and counters in the traced run, and their
reduction against the device's timeline.

The port marks its host work with spans (its ``utils/profiling``):
``<layer>/<what>`` around loops and host-tail stages, ``read/<site>``
around each wait for a device value and ``upload/<site>`` around each
copy of host data that waits for the stream to drain.  They are
``record_function`` spans, so they lie in the profiler's Chrome trace on
the clock of the device's activity.  ``Tracing`` turns them on for the
profiler's window only and takes the growth of the program's counters
over it; ``reduce_program`` reduces the window's events to a
``ProgramSummary``:

- each program span's count, host seconds and self seconds (less the
  program spans nested in it on the same thread);
- host seconds inside ``read/*`` and inside ``upload/*`` spans;
- the device's idle time: each gap between busy intervals (the union
  of the window's device operations, as ``trace.reduce_events`` takes
  it) is charged to the innermost program span open on the driver's
  thread when the gap began, or to ``"none"``;
- runtime calls that block the host (stream, device and event
  synchronizes) in the window outside every read and upload span, the
  harness's own closing synchronize left out.

Like the rest of the yardstick it imports nothing of the program: the
caller hands ``Tracing`` the program's profiling module, and
``loaded_profiling`` finds it among the loaded modules for the readers
of its counters.  A program without spans (no ``enable`` there) leaves
the summary None, one without counters the readers' values.
"""

from __future__ import annotations

import dataclasses
import sys

from yardstick.guard import PORT
from yardstick.trace import (
    DEVICE_CATS,
    DEVICE_PART,
    LAUNCH_CATS,
    WINDOW_SPAN,
    _intervals_union,
)

WAITS = ("read", "upload")
BLOCKING = frozenset({"cudaStreamSynchronize", "cudaDeviceSynchronize",
                      "cudaEventSynchronize"})
#: the harness's synchronize as the profiler's window closes
CLOSING = "cudaDeviceSynchronize"
NONE = "none"
#: entry function whose calls in the window divide each layer's numbers
#: into a block's (as trace.Summary.per_block_ms divides device time)
PER_CALL = {"front_end": DEVICE_PART, "symdemod": DEVICE_PART,
            "decode": DEVICE_PART, "host_tail": "_finish", "driver": "_finish"}
_COUNTERS = (("reads", "HOST_READS"), ("uploads", "HOST_UPLOADS"),
             ("work", "COUNTS"))


def loaded_profiling():
    """The loaded program's profiling module where it counts reads, else
    None (a program without the counters, or none loaded)."""
    mod = sys.modules.get(PORT + ".utils.profiling")
    return mod if hasattr(mod, "HOST_READS") else None


class Tracing:
    """The program's spans on over the profiler's window, and the growth
    of its counters over the same window (``counts``)."""

    def __init__(self, profiling):
        self.mod = profiling if hasattr(profiling, "enable") else None
        self.before = None
        self.counts = None

    def _snapshot(self) -> dict:
        return {key: dict(getattr(self.mod, attr, {})) for key, attr in _COUNTERS}

    def start(self) -> None:
        if self.mod is not None:
            self.before = self._snapshot()
            self.mod.enable(True)

    def stop(self) -> None:
        if self.mod is None:
            return
        self.mod.enable(False)
        after = self._snapshot()
        self.counts = {key: {k: v - self.before[key].get(k, 0)
                             for k, v in after[key].items()
                             if v != self.before[key].get(k, 0)}
                       for key in after}


@dataclasses.dataclass
class ProgramSummary:
    """What the program's spans and counters read over a traced window;
    seconds unless named otherwise."""

    spans: dict  # span name → [spans begun in the window, host seconds]
    self_s: dict  # span name → host seconds less nested program spans
    wait_s: dict  # "read", "upload" → host seconds in such spans
    idle_s: dict  # innermost program span at a gap's start, or "none" → idle
    layer_idle_s: dict  # layer key of that span (outward to one), or "none"
    idle_total_s: float  # the window's gaps: window less busy
    blocking_outside: dict  # innermost program span or "none" → blocking calls
    counts: dict | None  # {"reads", "uploads", "work"} → growth over the window

    def per_block(self, value, summary, layer: str):
        """``value`` over the calls that enclose ``layer``'s work in the
        window (``PER_CALL``)."""
        return summary.per_call(value, PER_CALL[layer])

    def idle_ms(self, summary, layer: str):
        return self.per_block(self.layer_idle_s.get(layer, 0.0) * 1e3, summary, layer)


def _program_span(name: str, keys) -> bool:
    head = name.split("/", 1)[0]
    return "/" in name and (head in keys or head in WAITS)


def _layer(name: str, keys):
    """The layer key a span names, or None for a read or upload site of
    an op several layers call."""
    parts = name.split("/")
    key = parts[1] if parts[0] in WAITS and len(parts) > 2 else parts[0]
    return key if key in keys else None


def _self_seconds(spans: list) -> list:
    """Each span's duration less its direct children's, for one thread's
    spans sorted outer first ((start, -end))."""
    own = [e - s for s, e, _ in spans]
    stack: list = []
    for i, (s, e, _) in enumerate(spans):
        while stack and spans[stack[-1]][1] <= s:
            stack.pop()
        if stack:
            own[stack[-1]] -= min(e, spans[stack[-1]][1]) - s
        stack.append(i)
    return own


def reduce_program(events: list, layer_keys, counts: dict | None = None):
    """A traced window's Chrome events → ProgramSummary, or None where the
    window holds no program span.  Times in the trace are µs."""
    keys = set(layer_keys)
    window = None
    by_tid: dict = {}
    device = []
    blocking = []
    for ev in events:
        if ev.get("ph") != "X":
            continue
        cat, name = ev.get("cat", ""), ev.get("name", "")
        ts, dur = float(ev["ts"]), float(ev.get("dur", 0.0))
        if cat == "user_annotation":
            if name == WINDOW_SPAN:
                window = (ts, ts + dur)
            elif _program_span(name, keys):
                by_tid.setdefault(ev.get("tid"), []).append((ts, ts + dur, name))
        elif cat in DEVICE_CATS:
            device.append((ts, ts + dur))
        elif cat in LAUNCH_CATS and name in BLOCKING:
            blocking.append((ts, ev.get("tid"), name))
    if window is None:
        raise RuntimeError("the trace holds no window span")
    if not by_tid:
        return None
    w0, w1 = window
    spans_s: dict = {}
    self_s: dict = {}
    wait_s = {w: 0.0 for w in WAITS}
    for spans in by_tid.values():
        spans.sort(key=lambda sp: (sp[0], -sp[1]))
        for (s, e, name), own in zip(spans, _self_seconds(spans)):
            if not w0 <= s <= w1:
                continue
            entry = spans_s.setdefault(name, [0, 0.0])
            entry[0] += 1
            entry[1] += (e - s) * 1e-6
            self_s[name] = self_s.get(name, 0.0) + own * 1e-6
            head = name.split("/", 1)[0]
            if head in WAITS:
                wait_s[head] += (e - s) * 1e-6

    busy = _intervals_union([(max(s, w0), min(e, w1)) for s, e in device
                             if e > w0 and s < w1])
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    gaps = [(g0, g1) for g0, g1 in zip(edges[0::2], edges[1::2]) if g1 > g0]
    main = max(by_tid, key=lambda t: len(by_tid[t]))
    spans = by_tid[main]
    idle_s: dict = {}
    layer_idle_s: dict = {}
    for (g0, g1), stack in zip(gaps, _open_stacks(spans, [g0 for g0, _ in gaps])):
        sec = (g1 - g0) * 1e-6
        inner = stack[-1] if stack else NONE
        idle_s[inner] = idle_s.get(inner, 0.0) + sec
        layer = next((k for k in (_layer(n, keys) for n in reversed(stack)) if k),
                     NONE)
        layer_idle_s[layer] = layer_idle_s.get(layer, 0.0) + sec

    found = []
    for tid in {b[1] for b in blocking}:
        calls = [b for b in blocking if b[1] == tid and w0 <= b[0] <= w1]
        stacks = _open_stacks(by_tid.get(tid, []), [ts for ts, _, _ in calls])
        found += [(ts, name, stack[-1] if stack else NONE)
                  for (ts, _, name), stack in zip(calls, stacks)
                  if not any(n.split("/", 1)[0] in WAITS for n in stack)]
    found.sort()
    if found and found[-1][1] == CLOSING and found[-1][2] == NONE:
        found.pop()
    outside: dict = {}
    for _, _, inner in found:
        outside[inner] = outside.get(inner, 0) + 1
    return ProgramSummary(
        spans=spans_s, self_s=self_s, wait_s=wait_s, idle_s=idle_s,
        layer_idle_s=layer_idle_s,
        idle_total_s=sum(g1 - g0 for g0, g1 in gaps) * 1e-6,
        blocking_outside=outside, counts=counts)


def _open_stacks(spans: list, times: list) -> list:
    """For each time, the names of ``spans`` (one thread's, nested as its
    calls are, sorted outer first) open then, outermost first: one sweep
    with a stack of the open spans, as trace._innermost."""
    out: list = [None] * len(times)
    stack: list = []
    j = 0
    for i in sorted(range(len(times)), key=times.__getitem__):
        t = times[i]
        while j < len(spans) and spans[j][0] <= t:
            while stack and stack[-1][1] < spans[j][0]:
                stack.pop()
            stack.append(spans[j])
            j += 1
        while stack and stack[-1][1] < t:
            stack.pop()
        out[i] = [name for _, _, name in stack]
    return out


def describe(p: ProgramSummary, summary) -> str:
    """One log line: idle ms a block by program span and the share of the
    window's idle charged to none; the per-layer idle ms a block and read
    ms a host tail; reads and uploads by site; self ms a block by span;
    the blocking calls outside read and upload spans."""
    n = summary.calls.get(DEVICE_PART, 0) or 1

    def ms(d):
        return {k: round(v * 1e3 / n, 4)
                for k, v in sorted(d.items(), key=lambda kv: -kv[1])}

    none = p.idle_s.get(NONE, 0.0) / p.idle_total_s if p.idle_total_s else 0.0
    layers = {f"{k}.idle_ms": p.idle_ms(summary, k)
              for k in ("front_end", "symdemod", "decode", "host_tail")}
    layers["read_wait_ms"] = p.per_block(p.wait_s["read"] * 1e3, summary, "driver")
    counts = p.counts or {}
    return (f"program: idle ms a block by span {ms(p.idle_s)}; idle charged to none "
            f"{100 * none:.4f} % of {p.idle_total_s:.6f} s; {layers}; reads "
            f"{counts.get('reads')}; uploads {counts.get('uploads')}; work "
            f"{counts.get('work')}; self ms a block by span {ms(p.self_s)}; blocking "
            f"calls outside read and upload spans {sum(p.blocking_outside.values())} "
            f"{p.blocking_outside}")
