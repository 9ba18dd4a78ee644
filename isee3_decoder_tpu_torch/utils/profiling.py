"""Spans and counters inside the receive chain, and the Fano cycle
histogram.

Spans.  ``span(name)`` marks a stretch of the chain's host work (a
loop, a stage of the host tail) as a ``torch.profiler.record_function``,
so it lands in the profiler's Chrome trace on the same clock as the
card's activity.  Spans are on only between ``enable(True)`` and
``enable(False)``; off, ``span`` returns one shared no-op context after
a single global test.  Names are ``<layer>/<what>``, the layer being the
benchmark's layer key (``driver``, ``front_end``, ``symdemod``,
``decode``, ``host_tail``); a read or upload site in an op that several
layers call (``encode``, ``fano``, ``viterbi``) is named by the op.

Reads.  ``read(site, x)`` is the one path by which the chain waits on
the card for a value: a 0-dim bool tensor comes back as a ``bool``,
any other tensor as a numpy array, and a ``torch.cuda.Event`` is waited
on.  Each call adds one to ``HOST_READS[site]``, whether spans are on or
not, and, with spans on, runs inside a ``read/<site>`` span.

Uploads.  A copy of host data to the card from pageable memory waits
for the stream to drain as a read does.  ``upload(site, x, device)``
is the chain's path for such copies: ``torch.as_tensor`` counted in
``HOST_UPLOADS[site]`` and, with spans on, inside an ``upload/<site>``
span.

``COUNTS`` counts work by name (blocks, host tails, lanes sent to a
host-tail stage).
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

#: read site → device-to-host reads since the last reset()
HOST_READS: dict[str, int] = {}
#: upload site → host-to-device copies of host data since the last reset()
HOST_UPLOADS: dict[str, int] = {}
#: what was counted → how much since the last reset(): "driver/blocks"
#: device parts submitted, "host_tail/calls" host tails run,
#: "host_tail/tier2_lanes" and "host_tail/viterbi_lanes" lanes sent to
#: the tier-2 Fano re-run and to the Viterbi fallback
COUNTS: dict[str, int] = {}

_on = False
_OFF = contextlib.nullcontext()


def enable(on: bool) -> None:
    """Turn the chain's spans on or off (counters always count)."""
    global _on
    _on = bool(on)


def enabled() -> bool:
    return _on


def span(name: str, block: int | None = None):
    """A ``record_function`` span ``name`` (``block``: the block's
    sequence number, in the span's args) while spans are on; else a
    shared no-op context."""
    if not _on:
        return _OFF
    return torch.profiler.record_function(
        name, None if block is None else f"block={block}")


def count(what: str, n: int = 1) -> None:
    COUNTS[what] = COUNTS.get(what, 0) + n


def _fetch(x):
    if isinstance(x, torch.Tensor):
        if x.ndim == 0 and x.dtype == torch.bool:
            return bool(x)
        return x.cpu().numpy()
    x.synchronize()
    return None


def read(site: str, x):
    """Wait for ``x`` on the host: a 0-dim bool tensor → bool, another
    tensor → numpy array, an event → None once it has completed."""
    HOST_READS[site] = HOST_READS.get(site, 0) + 1
    if not _on:
        return _fetch(x)
    with torch.profiler.record_function("read/" + site):
        return _fetch(x)


def upload(site: str, x, device, dtype: torch.dtype | None = None) -> torch.Tensor:
    """``torch.as_tensor(x, dtype, device)`` of host data ``x`` (a number,
    a list or a numpy array); a tensor passes through uncounted."""
    if isinstance(x, torch.Tensor):
        return torch.as_tensor(x, dtype=dtype, device=device)
    HOST_UPLOADS[site] = HOST_UPLOADS.get(site, 0) + 1
    if not _on:
        return torch.as_tensor(x, dtype=dtype, device=device)
    with torch.profiler.record_function("upload/" + site):
        return torch.as_tensor(x, dtype=dtype, device=device)


def reset() -> None:
    HOST_READS.clear()
    HOST_UPLOADS.clear()
    COUNTS.clear()


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
