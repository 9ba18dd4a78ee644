"""What decides ``correct``, and what counts as a failed operation.

``correct``: every block the window completed is compared, on channels
drawn from the seed, with the plain reference run on the same raw IQ.
The numbers, each held to the limit the cell's file gives it (a number
the file gives no limit is printed, not compared):

- ``lanes_differ_pct``: the share of (completion, lane) pairs whose
  frame bytes, good flag, decoder label or start symbol differ;
- ``viterbi_lanes_differ_pct``: the same, over the lanes the reference
  decodes by Viterbi (0 where it decodes none);
- ``soft_differ_pct``: the share of the sampled channels' soft symbols,
  as the timed path handed them to the decode, that differ from the
  reference's by a level or more.

A completion with the wrong number of lanes, or soft symbols of another
length, counts all of its sampled lanes, or symbols, as differing.

An operation is one frame that a pool block holds whole: the window
replays the pool, so a block completed again repeats the same
operations.  ``attempted`` counts the frames of the pool blocks the
window completed, ``failed`` those of them that came back, in any of
their block's completions, not good, or good with bytes other than the
frame sent there.  Both are fixed by the seed, not by how many times
the window's length let the pool go round.
"""

from __future__ import annotations

import numpy as np

from reference.decode import VITERBI
from yardstick.traffic import sent_frame_index, sub_seed

FIELDS = ("data", "good", "decoder", "start_symbol")


def sample_channels(seed: int, channels: int, count: int, blocks: int) -> dict:
    """Pool block → ``count`` distinct channels of it, drawn from the
    seed, in order."""
    rng = np.random.default_rng(sub_seed(seed, 1 << 20, 3))
    return {p: np.sort(rng.choice(channels, size=min(count, channels), replace=False))
            for p in range(blocks)}


def lanes_of(channels: np.ndarray, nframes: int) -> np.ndarray:
    """Lane indices (channel-major) of the frames of ``channels``."""
    return (channels[:, None] * nframes + np.arange(nframes)[None, :]).reshape(-1)


def take_lanes(rec, lanes: np.ndarray, total_lanes: int):
    """The sampled lanes' fields of one record of the program, or None
    where the record does not hold every lane of the block."""
    fields = {f: np.asarray(getattr(rec, f)) for f in FIELDS}
    if any(v.shape[0] != total_lanes for v in fields.values()):
        return None
    return {f: v[lanes] for f, v in fields.items()}


def lanes_differ(got, want: dict) -> int:
    """Lanes where ``got`` (take_lanes' rows, or None) differs from the
    reference's rows of the same lanes."""
    n = len(want[FIELDS[0]])
    if got is None:
        return n
    bad = np.zeros(n, bool)
    for f in FIELDS:
        g, w = np.asarray(got[f]), np.asarray(want[f])
        if g.shape != w.shape:
            return n
        bad |= (g != w).reshape(n, -1).any(axis=1)
    return int(bad.sum())


def soft_differ(got, want: np.ndarray) -> int:
    """Soft symbols of ``got`` ((channels, S) uint8, or None) that differ
    from the reference's ``want``."""
    if got is None or np.shape(got) != want.shape:
        return want.size
    return int((np.asarray(got) != want).sum())


def compare(completions: list, refs: dict, limits: dict) -> dict:
    """completions: [(pool block, sampled rows, sampled soft symbols)];
    refs: pool block → the reference's rows of the same lanes, with its
    soft symbols of the same channels under ``"soft"`` and its decoder
    labels under ``"decoder"``.  Returns {"numbers", "limits",
    "correct"}: every number, the cell's limits, and whether each
    number with a limit is within it."""
    pairs = differ = vpairs = vdiffer = syms = sdiffer = 0
    for p, got, soft in completions:
        want = refs[p]
        pairs += len(want[FIELDS[0]])
        differ += lanes_differ(got, want)
        vit = np.asarray(want["decoder"]) == VITERBI
        if vit.any():
            vpairs += int(vit.sum())
            vdiffer += lanes_differ(None if got is None else {f: np.asarray(v)[vit]
                                                              for f, v in got.items()},
                                    {f: np.asarray(want[f])[vit] for f in FIELDS})
        syms += want["soft"].size
        sdiffer += soft_differ(soft, want["soft"])
    numbers = {
        "lanes_differ_pct": 100.0 * differ / pairs if pairs else 100.0,
        "viterbi_lanes_differ_pct": 100.0 * vdiffer / vpairs if vpairs else 0.0,
        "soft_differ_pct": 100.0 * sdiffer / syms if syms else 100.0,
    }
    correct = bool(completions) and all(numbers[k] <= limits[k] for k in limits)
    return {"numbers": numbers, "limits": dict(limits), "correct": correct}


def failed_lanes(rec, frames: np.ndarray, nframes: int, lead: int,
                 cyclic: bool) -> np.ndarray:
    """Per lane of one completed block: not good, or good with bytes
    other than the frame its channel sent at that position.  Every lane
    where the record does not hold every lane of the block."""
    L = frames.shape[0] * nframes
    good = np.asarray(rec.good)
    if good.shape[0] != L:
        return np.ones(L, bool)
    idx = sent_frame_index(rec.start_symbol, lead, frames.shape[1], cyclic)
    chan = np.arange(L) // nframes
    sent = frames[chan, np.maximum(idx, 0)]
    match = (idx >= 0) & (np.asarray(rec.data) == sent).all(axis=1)
    return ~(good & match)


def operations(failed_by_completion: list) -> dict:
    """failed_by_completion: [(pool block, failed_lanes' mask)], one a
    completion.  Returns {"attempted", "failed", "unsteady"}: the frames
    of the pool blocks completed, those failed in any completion of
    their block, and those failed in some completions and not others."""
    anyf, allf = {}, {}
    for p, mask in failed_by_completion:
        anyf[p] = anyf[p] | mask if p in anyf else mask.copy()
        allf[p] = allf[p] & mask if p in allf else mask.copy()
    return {
        "attempted": sum(m.size for m in anyf.values()),
        "failed": int(sum(m.sum() for m in anyf.values())),
        "unsteady": int(sum((anyf[p] & ~allf[p]).sum() for p in anyf)),
    }
