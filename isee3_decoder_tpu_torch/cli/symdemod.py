"""symdemod CLI — Manchester symbol demodulator (symdemod.c).

Reads int16 baseband samples on stdin, writes 8-bit offset-128 soft
decisions on stdout (one byte per symbol), status on stderr — the
second stage of ``pmdemod | symdemod | decode``.  Each window takes one
prefix sum of the buffered baseband (kernel K3) and reads the timing
search and the integrate-and-dump from it (ops/symbols
``timesearch_from_csum``, ``integrate_from_csum``).

    python -m isee3_decoder_tpu_torch.cli.symdemod -c 1024. < bb.raw > soft.bin

Flags (README.txt:30-33, symdemod.c:56-84):
  -c symbol rate Hz (scaled by the measured spacecraft clock unless a
     decimal point is given; rates < 1000 switch to subcarrier mode)
  -r sample rate Hz   -w window seconds   -C clocks/symbol   -q quiet
  -t clock tracking: not in the port yet (exits with status 2)
--device picks the card (default) or the CPU.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from isee3_decoder_tpu_torch import _kernels
from isee3_decoder_tpu_torch.cli._io import (
    read_exact,
    run_main,
    status,
    write_bytes,
)
from isee3_decoder_tpu_torch.config import ACTUALCLOCK, NOMINALCLOCK
from isee3_decoder_tpu_torch.models.symdemod import initial_firstsample
from isee3_decoder_tpu_torch.ops import symbols as sym_ops
from isee3_decoder_tpu_torch.ops.symbols import SymConfig
from isee3_decoder_tpu_torch.utils.timeformat import format_hms


def parse_symrate(arg: str | None) -> tuple[float, int]:
    """The -c semantics of symdemod.c:67-77: no decimal point → scale by
    the measured spacecraft clock; < 1000 Hz → subcarrier mode."""
    if arg is None:
        return ACTUALCLOCK, 1
    try:
        value = float(arg)
    except ValueError:
        raise SystemExit(f"symdemod: invalid symbol rate {arg!r}")
    if "." not in arg:
        symrate = value * ACTUALCLOCK / NOMINALCLOCK
    else:
        symrate = value
    clocks = 1
    if symrate < 1000:
        clocks = int(round(NOMINALCLOCK / symrate))
    return symrate, clocks


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="symdemod")
    p.add_argument("-c", default=None, dest="symrate")
    p.add_argument("-r", type=int, default=250000, dest="samprate")
    p.add_argument("-w", type=float, default=1.0, dest="window")
    p.add_argument("-C", type=int, default=None, dest="symbolclocks")
    p.add_argument("-t", action="store_true", dest="track")
    p.add_argument("-q", action="store_true", dest="quiet")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="run on the card (default) or on the CPU")
    a = p.parse_args(argv)
    if a.track:
        status("symdemod: -t (clock tracking) is not ported yet")
        return 2
    dev = _kernels.run_device(a.device)

    symrate, clocks = parse_symrate(a.symrate)
    if a.symbolclocks is not None:
        clocks = a.symbolclocks
    cfg = SymConfig(
        samprate=float(a.samprate),
        symrate=symrate,
        symbolclocks=clocks,
        window=a.window,
    )
    if not a.quiet:
        status(
            f"symdemod: sample rate {a.samprate:,} Hz; estimation window "
            f"{a.window:.3f} sec; clocks/symbol {clocks}; symbol rate "
            f"{symrate:.3f} Hz; tracking off"
        )

    f = sys.stdin.buffer
    fullwater = int(cfg.window * 2.0 * cfg.samprate)  # symdemod.c:90
    symbolsamples = cfg.symbolsamples
    # the buffered baseband lives on the run device; a refill copies only
    # the new samples there
    buf = torch.zeros(0, dtype=torch.int16, device=dev)
    firstsample = initial_firstsample(cfg)
    total_samples = 0
    total_symbols = 0
    eof = False
    while True:
        # purge (symdemod.c:101-112)
        if firstsample >= cfg.window * cfg.samprate:
            slide = int(firstsample - 2 * symbolsamples)
            slide = min(slide, len(buf))
            buf = buf[slide:]
            firstsample -= slide
            total_samples += slide
        # refill (symdemod.c:114-123)
        if not eof and len(buf) < fullwater:
            raw = read_exact(f, (fullwater - len(buf)) * 2)
            if len(raw) < (fullwater - len(buf)) * 2:
                eof = True
            if raw:
                new = torch.from_numpy(np.frombuffer(raw, "<i2").astype(np.int16))
                buf = torch.cat([buf, new.to(dev)])
        if len(buf) < cfg.window * cfg.samprate:
            break

        # one prefix sum (kernel K3) serves the search and the integration;
        # both clamp reads past its end to the total
        nsym = cfg.nsymbols
        csum = sym_ops.samples_csum(buf, sym_ops.SEARCH_PAD)
        ts = sym_ops.timesearch_from_csum(csum, firstsample, cfg.halfclock,
                                          nsym, cfg.symbolclocks, cfg.noffsets)
        symphase = int(ts.symphase[0])
        firstsample += symphase
        energy = float(ts.maxenergy[0])
        gain = 100.0 / np.sqrt(energy)
        integ = sym_ops.integrate_from_csum(csum, firstsample, cfg.halfclock,
                                            nsym, cfg.symbolclocks)
        soft, _ = sym_ops.finish_demod(integ, gain)
        write_bytes(soft[0].cpu().numpy())

        if not a.quiet:
            t = (firstsample + total_samples) / cfg.samprate
            status(
                f"symdemod: sample {firstsample + total_samples:,} "
                f"({t:,.3f} sec, {format_hms(t)}) symbol {total_symbols:,}: "
                f"clock {cfg.samprate / symbolsamples:,.4f} Hz; "
                f"{symbolsamples:,.4f} samp/sym; timing adj {symphase:+d} "
                f"samples; energy {10 * np.log10(energy):.3f} dB"
            )
        total_symbols += nsym
        firstsample = int(firstsample + nsym * symbolsamples)
    return 0


if __name__ == "__main__":
    run_main(main)
