"""autocorrelate CLI — whole-file spectrum and autocorrelation dumps
(autocorrelate.c): writes spectrum.plot, autospect.plot and
autocorr.plot in the working directory.

Same flags, text and plot files as the JAX package's tool.  The
transforms are torch.fft in float64 on the run device (the JAX tool's
are numpy's): the real FFT of the int16 samples zero-padded to a power
of two, its power spectrum, and the inverse real FFT of that.  --device
picks the card (default) or the CPU.

    python -m isee3_decoder_tpu_torch.cli.autocorrelate -r 32768 bb.i16
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from isee3_decoder_tpu_torch import _kernels
from isee3_decoder_tpu_torch.cli._io import run_main, status


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="autocorrelate")
    p.add_argument("-r", type=float, default=250000.0, dest="samprate")
    p.add_argument("-o", type=int, default=0, dest="offset")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="run on the card (default) or on the CPU")
    p.add_argument("input")
    a = p.parse_args(argv)

    dev = _kernels.run_device(a.device)
    raw = np.fromfile(a.input, "<i2")[a.offset :]
    samples = torch.as_tensor(raw, device=dev).to(torch.float64)
    n = len(raw)
    status(f"{a.input}: {n:,} samples, {n / a.samprate:,.3f} seconds @ {a.samprate:.1f} Hz")
    size = 1 << int(np.ceil(np.log2(max(n, 2))))
    status(f"Correlator size = {size:,}")
    spec = torch.fft.rfft(samples, size)
    power = spec * spec.conj()
    corr = torch.fft.irfft(power, size).cpu().numpy()
    spec_abs = spec.abs().cpu().numpy()
    power_abs = power.abs().cpu().numpy()

    with open("spectrum.plot", "w") as f:
        f.write("double double\ntitle\nSpectrum\nxlabel\nHz\n")
        for i in range(size // 2):
            f.write(f"dot {i * a.samprate / size:f} {spec_abs[i]:f}\n")
    status("spectrum plot in spectrum.plot")

    with open("autospect.plot", "w") as f:
        f.write("double double\ntitle\nAutocorr spectrum\nxlabel\nHz\n")
        for i in range(size // 2):
            f.write(f"dot {i * a.samprate / size:f} {power_abs[i]:f}\n")
    status("autocorrelation spectrum plot in autospect.plot")

    with open("autocorr.plot", "w") as f:
        f.write("double double\ntitle\nAutocorrelation\nxlabel\nsec\n")
        for i in range(1, size // 2):
            f.write(f"dot {i / a.samprate:f} {corr[i]:f}\n")
    status("autocorrelation plot in autocorr.plot")
    return 0


if __name__ == "__main__":
    run_main(main)
