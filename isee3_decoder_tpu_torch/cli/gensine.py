"""gensine CLI — synthetic complex sinusoid generator (gensine.c).

Writes int16 I,Q pairs on stdout: 2 kHz at 32,768 sps, amplitude 20000,
10 seconds — the reference's fixed parameters, made adjustable.  Same
flags, text and bytes as the JAX package's tool: the samples come from
utils/testsignal.gensine, numpy on the host.  --device is the tools'
common option (the card by default, or the CPU); nothing here runs on
the device.

    python -m isee3_decoder_tpu_torch.cli.gensine -s 1 > tone.iq
"""

from __future__ import annotations

import argparse

from isee3_decoder_tpu_torch import _kernels
from isee3_decoder_tpu_torch.cli._io import run_main, status, write_int16
from isee3_decoder_tpu_torch.utils.testsignal import gensine


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="gensine")
    p.add_argument("-c", type=float, default=2000.0, dest="carrier")
    p.add_argument("-r", type=float, default=32768.0, dest="samprate")
    p.add_argument("-a", type=float, default=20000.0, dest="amplitude")
    p.add_argument("-s", type=float, default=10.0, dest="seconds")
    p.add_argument("-p", type=float, default=0.0, dest="phase")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="the card (default) or the CPU")
    a = p.parse_args(argv)
    _kernels.run_device(a.device)
    n = int(a.seconds * a.samprate)
    status(
        f"gensine: carrier {a.carrier} Hz, sample rate {a.samprate} Hz, "
        f"amplitude {a.amplitude}, {n} samples"
    )
    write_int16(gensine(n, a.carrier, a.samprate, a.amplitude, a.phase))
    return 0


if __name__ == "__main__":
    run_main(main)
