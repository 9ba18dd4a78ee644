"""Light timing and profiling helpers (the JAX package's
utils/profiling.py).

The reference's measurement machinery (SURVEY.md §5.1): getrusage-style
wall timing around decode calls (vtest224.c:115-120), bits-per-second
reporting and Fano cycle accounting, plus a torch.profiler trace for
kernel-level inspection.

Work on the card is asynchronous, so a wall-clock section must wait for
it before it stops the clock: ``sync`` synchronizes the device of a CUDA
tensor and returns a host scalar of it.
"""

from __future__ import annotations

import contextlib
import os
import time
from dataclasses import dataclass, field

import numpy as np
import torch


def _first_tensor(x):
    if isinstance(x, torch.Tensor):
        return x
    if isinstance(x, dict):
        x = list(x.values())
    if isinstance(x, (list, tuple)):
        for item in x:
            found = _first_tensor(item)
            if found is not None:
                return found
    return None


def sync(x) -> float:
    """Wait for the device of the first tensor in ``x`` (a tensor, or
    nested tuples, lists and dicts of them) and return its first element
    as a host float."""
    leaf = _first_tensor(x)
    if leaf is None:
        raise ValueError("sync: no tensor in its argument")
    if leaf.is_cuda:
        torch.cuda.synchronize(leaf.device)
    return float(leaf.reshape(-1)[0])


@dataclass
class Timer:
    """Accumulating section timer (the rusage pattern, vtest224.c)."""

    sections: dict = field(default_factory=dict)

    @contextlib.contextmanager
    def section(self, name: str, sync_on=None):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if sync_on is not None:
                sync(sync_on)
            self.sections[name] = self.sections.get(name, 0.0) + (
                time.perf_counter() - t0
            )

    def report(self) -> str:
        total = sum(self.sections.values())
        lines = [f"total {total:.3f}s"]
        for k, v in sorted(self.sections.items(), key=lambda kv: -kv[1]):
            lines.append(f"  {k:<24} {v:8.3f}s {100*v/max(total,1e-12):5.1f}%")
        return "\n".join(lines)

    def bits_per_second(self, name: str, bits: int) -> float:
        """decoder-speed reporting (vtest224.c:180-182)."""
        return bits / max(self.sections.get(name, 0.0), 1e-12)


@contextlib.contextmanager
def torch_trace(logdir: str):
    """Profile the block with torch.profiler (host ops, and the card's
    kernels where there is a card) and write its Chrome trace to
    ``logdir/trace.json``; yields the profiler."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def cycle_histogram(cycles: np.ndarray, nbits: int, nbuckets: int = 8) -> dict:
    """Fano cycles-per-bit histogram (the fanotest.c:178-179 cost metric)
    of a lane's cycle counts (an array, or a tensor on any device)."""
    if isinstance(cycles, torch.Tensor):
        cycles = cycles.cpu().numpy()
    per_bit = np.asarray(cycles, np.float64) / nbits
    edges = [1, 1.5, 2, 3, 5, 10, 25, 50, 1e9][: nbuckets + 1]
    out = {}
    for lo, hi in zip(edges[:-1], edges[1:]):
        out[f"[{lo},{hi})"] = int(((per_bit >= lo) & (per_bit < hi)).sum())
    return out
