"""spindown CLI — offline fixed-frequency complex mixer (spindown.c).

Reads int16 I,Q pairs from a file (or stdin), shifts them by -c Hz in
blocks of 131,072 samples, the mixer's phase restarting at 0 each block
(spindown.c:131-137), and writes the baseband as float64 I,Q pairs on
stdout (spindown.c:138-145).  The mix is float64 on the run device:
the mixer's samples are numpy's exp(-1j·step·i), made once (every block
uses the same), and each product (a + bi)(c + di) is taken as numpy
takes it on a CPU with fused multiply-add, fma(a, c, -(b·d)) and
fma(a, d, b·c) (torch.addcmul, fused on the CPU and on the card), so the
bytes equal the JAX package's tool's.  --device picks the card (default)
or the CPU.

    python -m isee3_decoder_tpu_torch.cli.spindown -c 20000 input.iq > bb.f8
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from isee3_decoder_tpu_torch import _kernels
from isee3_decoder_tpu_torch.cli._io import open_input, read_iq_block, run_main

BLOCK = 131072  # samples a block (spindown.c:31)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="spindown")
    p.add_argument("-c", type=float, default=0.0, dest="shift")
    p.add_argument("-r", type=float, default=250000.0, dest="samprate")
    p.add_argument("-f", action="store_true", dest="flip")
    p.add_argument("-q", action="store_true", dest="quiet")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="run on the card (default) or on the CPU")
    p.add_argument("input", nargs="?", default=None)
    a = p.parse_args(argv)

    dev = _kernels.run_device(a.device)
    f = open_input(a.input)
    cstep = 2 * np.pi * a.shift / a.samprate
    lo = np.exp(-1j * cstep * np.arange(BLOCK))
    lo_re = torch.as_tensor(lo.real.copy(), device=dev)
    lo_im = torch.as_tensor(lo.imag.copy(), device=dev)
    while True:
        raw = read_iq_block(f, BLOCK)
        if raw is None:
            break
        iq = torch.as_tensor(raw, device=dev).view(-1, 2).to(torch.float64)
        i, q = (iq[:, 1], iq[:, 0]) if a.flip else (iq[:, 0], iq[:, 1])
        re = torch.addcmul(-(q * lo_im), i, lo_re)
        im = torch.addcmul(q * lo_re, i, lo_im)
        out = torch.stack([re, im], dim=1).reshape(-1)
        sys.stdout.buffer.write(out.cpu().numpy().astype("<f8").tobytes())
    sys.stdout.buffer.flush()
    return 0


if __name__ == "__main__":
    run_main(main)
