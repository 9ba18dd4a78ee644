"""simtest CLI — channel simulator sanity check (simtest.c:11-33): print
simulated soft receive samples for transmit symbols 0 and 1 at a given
Es/N0 for eyeball inspection.

Same flags and output format as the JAX package's tool.  The samples
come from utils/sim.simulate with a ``torch.Generator`` seeded --seed + tx
on the run device, so they differ from the JAX tool's ``jax.random``
draws for the same seed (utils/sim.sample_channel gives parity on shared
uniforms).  --device picks the card (default) or the CPU.

    python -m isee3_decoder_tpu_torch.cli.simtest -n 100 -e 3
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from isee3_decoder_tpu_torch import _kernels
from isee3_decoder_tpu_torch.cli._io import run_main
from isee3_decoder_tpu_torch.utils.sim import simulate


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="simtest")
    p.add_argument("-n", type=int, default=1000, dest="count")
    p.add_argument("-s", type=float, default=100.0, dest="signal")
    p.add_argument("-e", type=float, default=3.0, dest="esn0_db")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="run on the card (default) or on the CPU")
    a = p.parse_args(argv)

    dev = _kernels.run_device(a.device)
    noise = a.signal / (10 ** (a.esn0_db / 20.0)) / np.sqrt(2.0)
    for tx in (0, 1):
        print(f"tx symbol {tx}:")
        gen = torch.Generator(device=dev)
        gen.manual_seed(a.seed + tx)
        rx = simulate(gen, torch.full((a.count,), tx, dtype=torch.uint8,
                                      device=dev), a.signal, noise)
        rx = rx.cpu().numpy()
        for i in range(0, a.count, 20):
            print(" ".join(f"{v:3d}" for v in rx[i : i + 20]))
        print(f"mean {rx.mean():.2f} std {rx.std():.2f}")
    return 0


if __name__ == "__main__":
    run_main(main)
