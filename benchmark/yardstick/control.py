"""The controls of the correctness comparison: the plain reference in
the next precision below the float32 the configurations state, put in
the program's place (reference/chain.CONTROLS):

- ``bf16_carrier``: the carrier demod, its estimate too, in bfloat16;
- ``bf16_baseband``: the carrier estimate in float32, the spin-down,
  the baseband and the symbol integrators in bfloat16.

They are run by the tests (benchmark/tests/test_bench_control.py), at
a small size here and at the cells' own size on the card, never by the
benchmark's runs.  A control builds the cell's pool from the seed as a
run does, draws the same channels, decodes them with the reference in
float32 and in the lower precision, and compares the lower precision's
frames and soft symbols with the float32 ones as a run compares the
program's: one completion of every pool block.
"""

from __future__ import annotations

import torch

from reference.chain import receive
from yardstick import check, traffic


def control_verdict(manifest, name: str, seed: int, device,
                    control: str = "bf16_carrier") -> dict:
    """check.compare's verdict of the reference under ``control``
    against the float32 one on cell ``name``'s pool from ``seed``."""
    cfg = manifest.config(manifest.workload(name)["config"])
    cell = manifest.cell(name)
    nframes = cell["frames_whole"]
    pool = traffic.make_pool(cfg, cell, seed, device)
    sampled = check.sample_channels(seed, pool.channels, cell["check_channels"],
                                    len(pool.blocks))
    completions, refs = [], {}
    for p, block in enumerate(pool.blocks):
        rows = block[torch.as_tensor(sampled[p], device=block.device)]
        refs[p] = receive(rows, cfg, nframes)
        low = receive(rows, cfg, nframes, control)
        completions.append((p, {f: low[f] for f in check.FIELDS}, low["soft"]))
    return check.compare(completions, refs, cell["limits"])
