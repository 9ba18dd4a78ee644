"""The traced run: spans at each layer's entry functions, a profiler
window over a few steady blocks, and its reduction to per-layer
numbers.

Spans.  For the traced run the harness wraps every entry function that
a file in ``benchmark/layers/`` names in a ``torch.profiler.
record_function`` span ``layer:<key>:<function>``, in every module of
the program that holds it.  A device operation is charged to the
innermost such span open on the host thread when it was launched (its
runtime call, found by the profiler's correlation id), which is the
innermost layer-entry function on the Python stack of its launch.  So
a layer keeps its numbers when a later change replaces a kernel under
it.  The spans are the benchmark's own; untraced runs carry none.

Reduction.  From the profiler's Chrome trace: device operations
(kernels, copies, fills), the runtime calls that launched them, the
spans.  Busy time is the union of the device operations' intervals
inside the window; an idle gap is named by the innermost span the host
was in when it began.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import importlib
import inspect
import json
import os
import sys
import tempfile

import torch
from torch.profiler import ProfilerActivity, profile

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
#: characters of a device operation's name kept in the breakdown (a
#: templated kernel's full signature runs to hundreds)
NAME_CHARS = 120
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
WINDOW_SPAN = "bench:window"
#: the entry function that runs once a block around its device part
#: (front end, symbol demod, decode)
DEVICE_PART = "receive_block_device_soft"


def _wrap(fn, label: str):
    """fn inside a span; a generator function's body inside one span
    each time it resumes, since calling it only makes the generator."""
    if inspect.isgeneratorfunction(fn):
        @functools.wraps(fn)
        def wrapped_gen(*args, **kwargs):
            gen = fn(*args, **kwargs)
            while True:
                with torch.profiler.record_function(label):
                    try:
                        item = next(gen)
                    except StopIteration:
                        return
                yield item

        return wrapped_gen

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with torch.profiler.record_function(label):
            return fn(*args, **kwargs)

    return wrapped


@contextlib.contextmanager
def spans_installed(layers: dict, package: str):
    """Wrap each layer's entry functions (``"module:function"``) in a
    span wherever a module of ``package`` refers to them, for as long as
    the block lasts."""
    undo = []
    try:
        for key, layer in layers.items():
            for entry in layer.get("entries", []):
                modname, fname = entry.split(":")
                orig = getattr(importlib.import_module(modname), fname)
                span = _wrap(orig, f"layer:{key}:{fname}")
                for name, m in list(sys.modules.items()):
                    if m is None or not (name == package or name.startswith(package + ".")):
                        continue
                    for attr, val in list(vars(m).items()):
                        if val is orig:
                            setattr(m, attr, span)
                            undo.append((m, attr, orig))
        yield
    finally:
        for m, attr, orig in reversed(undo):
            setattr(m, attr, orig)


class ProfilerWindow:
    """torch.profiler over CPU and CUDA activity, started and stopped by
    hand around the traced blocks, with a WINDOW_SPAN span that marks
    the window."""

    def __init__(self):
        self.prof = None
        self.span = None
        self.events = None

    def start(self) -> None:
        torch.cuda.synchronize()
        self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self.prof.__enter__()
        self.span = torch.profiler.record_function(WINDOW_SPAN)
        self.span.__enter__()

    def stop(self) -> None:
        torch.cuda.synchronize()
        self.span.__exit__(None, None, None)
        self.prof.__exit__(None, None, None)
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                self.events = json.load(f)["traceEvents"]
        finally:
            os.unlink(path)
        self.prof = None


@dataclasses.dataclass
class Summary:
    """What a traced window reads, per block where it says so."""

    calls: dict  # entry function → its spans begun in the window
    window_s: float
    busy_s: float
    device_s: float  # summed durations of every device operation
    unattributed_s: float  # of those, charged to no layer
    layer_s: dict  # layer key → device seconds charged
    layer_kernels: dict  # layer key → kernels charged
    kernels: int  # device kernels in the window
    top_ops: list  # [[name, seconds]] by summed time, at most 10
    idle_gaps: list  # [[what the host was in, seconds]], at most 10
    block_ms: list  # host ms of the run's unprofiled blocks
    least_s: dict  # layer key → least seconds a block, from shapes
    period_ms: float | None = None  # mean ms between unprofiled blocks' yields

    def per_call(self, value, fn: str):
        """value over the calls of entry function ``fn`` in the window: a
        block's share, where ``fn`` runs once a block."""
        n = self.calls.get(fn, 0)
        return None if value is None or not n else value / n

    def per_block_ms(self, layer: str, fn: str = DEVICE_PART):
        """Device ms of ``layer`` a block; ``fn`` runs once a block
        around all of the layer's work.  The window holds more device
        parts than host tails (the driver submits DEPTH blocks ahead), so
        each layer is divided by the calls that enclose it."""
        s = self.layer_s.get(layer)
        return self.per_call(None if s is None else s * 1e3, fn)


def _intervals_union(iv: list) -> list:
    out = []
    for s, e in sorted(iv):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _innermost(spans: list, times: list) -> list:
    """For each time, the label of the innermost span of ``spans``
    ((start, end, label), nested as one thread's calls are) open then,
    or None: one sweep with a stack of the open spans."""
    order = sorted(range(len(times)), key=lambda i: times[i])
    out = [None] * len(times)
    stack: list = []
    j = 0
    for i in order:
        t = times[i]
        while j < len(spans) and spans[j][0] <= t:
            while stack and stack[-1][1] < spans[j][0]:
                stack.pop()
            stack.append(spans[j])
            j += 1
        while stack and stack[-1][1] < t:
            stack.pop()
        out[i] = stack[-1][2] if stack else None
    return out


def reduce_events(events: list, block_ms: list, least_s: dict,
                  period_ms: float | None = None) -> Summary:
    """A Chrome trace's events → Summary.  Times in the trace are µs."""
    window = None
    spans_by_tid: dict = {}
    launches = {}
    device = []
    for ev in events:
        if ev.get("ph") != "X":
            continue
        cat = ev.get("cat", "")
        ts, dur = float(ev["ts"]), float(ev.get("dur", 0.0))
        if cat == "user_annotation":
            name = ev.get("name", "")
            if name == WINDOW_SPAN:
                window = (ts, ts + dur)
            elif name.startswith("layer:"):
                spans_by_tid.setdefault(ev.get("tid"), []).append((ts, ts + dur, name))
        elif cat in LAUNCH_CATS:
            corr = ev.get("args", {}).get("correlation")
            if corr is not None:
                launches[corr] = (ts, ev.get("tid"))
        elif cat in DEVICE_CATS:
            device.append((ts, ts + dur, ev.get("name", ""), cat,
                           ev.get("args", {}).get("correlation")))
    if window is None:
        raise RuntimeError("the trace holds no window span")
    w0, w1 = window
    for spans in spans_by_tid.values():
        spans.sort(key=lambda sp: (sp[0], -sp[1]))  # an outer span first
    inside = [d for d in device if d[1] > w0 and d[0] < w1]
    calls: dict = {}
    for spans in spans_by_tid.values():
        for s0, _, label in spans:
            if w0 <= s0 <= w1:
                fn = label.rsplit(":", 1)[1]
                calls[fn] = calls.get(fn, 0) + 1
    layer_s: dict = {}
    layer_kernels: dict = {}
    per_name: dict = {}
    unattributed = 0.0
    total = 0.0
    kernels = 0
    labels = [None] * len(inside)
    by_tid: dict = {}
    for i, d in enumerate(inside):
        launch = launches.get(d[4])
        if launch is not None:
            by_tid.setdefault(launch[1], []).append((i, launch[0]))
    for tid, items in by_tid.items():
        found = _innermost(spans_by_tid.get(tid, []), [t for _, t in items])
        for (i, _), label in zip(items, found):
            labels[i] = label
    for (s, e, name, cat, corr), label in zip(inside, labels):
        dur = (min(e, w1) - max(s, w0)) * 1e-6
        total += dur
        short = name[:NAME_CHARS]
        per_name[short] = per_name.get(short, 0.0) + dur
        if cat == "kernel":
            kernels += 1
        if label is None:
            unattributed += dur
            continue
        key = label.split(":")[1]
        layer_s[key] = layer_s.get(key, 0.0) + dur
        if cat == "kernel":
            layer_kernels[key] = layer_kernels.get(key, 0) + 1
    busy_iv = _intervals_union([(max(s, w0), min(e, w1)) for s, e, *_ in inside])
    busy = sum(e - s for s, e in busy_iv) * 1e-6
    gaps = []
    edges = [w0] + [x for iv in busy_iv for x in iv] + [w1]
    main = max(spans_by_tid, key=lambda t: len(spans_by_tid[t]), default=None)
    pairs = [(g0, g1) for g0, g1 in zip(edges[0::2], edges[1::2]) if g1 > g0]
    found = _innermost(spans_by_tid.get(main, []), [g0 for g0, _ in pairs])
    for (g0, g1), label in zip(pairs, found):
        name = label.split(":", 1)[1] if label else "outside the layers' entries"
        gaps.append([name, (g1 - g0) * 1e-6])
    gaps.sort(key=lambda g: -g[1])
    top = sorted(([k, v] for k, v in per_name.items()), key=lambda kv: -kv[1])[:10]
    return Summary(
        calls=calls, window_s=(w1 - w0) * 1e-6, busy_s=busy, device_s=total,
        unattributed_s=unattributed, layer_s=layer_s, layer_kernels=layer_kernels,
        kernels=kernels, top_ops=top, idle_gaps=gaps[:10], block_ms=block_ms,
        least_s=least_s, period_ms=period_ms)

