"""pmdemod CLI — PM carrier demodulator (pmdemod.c).

Reads interleaved little-endian int16 I,Q samples from a file or stdin,
writes int16 baseband PM samples on stdout, status on stderr — the
first stage of ``pmdemod | symdemod | decode``.  Each FFT block goes
through ops/carrier.pm_demod_block_raw: kernel K1 once the carrier is
locked, the FFT search and kernel K2 before.

    python -m isee3_decoder_tpu_torch.cli.pmdemod -W 100 in.iq > bb.raw

Flags as the reference's (README.txt:19-28) and the JAX package's tool:
  -S start carrier estimate Hz   -W search width Hz (when locked)
  -D doppler rate Hz/s           -t C/N0 lock threshold dB
  -b FFT bin size Hz             -r sample rate Hz
  -f flip I/Q                    -q quiet
--device picks the card (default) or the CPU (the kernels' plain
versions).
"""

from __future__ import annotations

import argparse

import torch

from isee3_decoder_tpu_torch import _kernels
from isee3_decoder_tpu_torch.cli._io import (
    open_input,
    read_iq_block,
    run_main,
    status,
    write_int16,
)
from isee3_decoder_tpu_torch.ops.carrier import (
    PMConfig,
    init_carry,
    pm_demod_block_raw,
)
from isee3_decoder_tpu_torch.utils.timeformat import format_hms


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="pmdemod", add_help=True)
    p.add_argument("-S", type=float, default=0.0, dest="start_freq")
    p.add_argument("-W", type=float, default=0.0, dest="search_width")
    p.add_argument("-D", type=float, default=0.0, dest="doppler_rate")
    p.add_argument("-t", type=float, default=21.0, dest="cn0_threshold")
    p.add_argument("-b", type=float, default=4.0, dest="binsize")
    p.add_argument("-r", type=float, default=250000.0, dest="samprate")
    p.add_argument("-f", action="store_true", dest="flip")
    p.add_argument("-q", action="store_true", dest="quiet")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="run on the card (default) or on the CPU")
    p.add_argument("input", nargs="?", default=None)
    a = p.parse_args(argv)
    dev = _kernels.run_device(a.device)

    if abs(a.start_freq) > a.samprate / 2:
        status(f"pmdemod: carrier estimate outside Nyquist ±{a.samprate/2:.1f} Hz")
        return 1
    a.search_width = abs(a.search_width)
    if a.search_width > a.samprate / 2:
        status(f"pmdemod: search width reduced to ±{a.samprate/2:.1f} Hz")
        a.search_width = a.samprate / 2

    cfg = PMConfig(
        samprate=a.samprate,
        binsize=a.binsize,
        search_width=a.search_width,
        doppler_rate=a.doppler_rate,
        cn0_threshold=a.cn0_threshold,
    )
    if not a.quiet:
        status(
            f"pmdemod: FFT bin size {cfg.actual_binsize:.4f} Hz; start carrier "
            f"{a.start_freq:.4f} Hz; Doppler {a.doppler_rate:.6f} Hz/s; "
            f"search range +/-{a.search_width:.1f} Hz"
        )

    f = open_input(a.input)
    carry = init_carry(1, cfg, a.start_freq, device=dev)
    total = 0
    while True:
        blk = read_iq_block(f, cfg.fftsize)
        if blk is None:
            break
        raw = torch.from_numpy(blk).to(dev)[None, :]
        carry, out = pm_demod_block_raw(carry, raw, cfg, a.flip)
        write_int16(out.baseband[0].cpu().numpy())
        if not a.quiet:
            lock = " locked" if bool(out.locked[0]) else ""
            secs = total / a.samprate
            status(
                f"pmdemod: sample {total:,} ({secs:,.3f} sec, {format_hms(secs)}); "
                f"carrier {float(out.carrier_freq[0]):,.1f} Hz; "
                f"C/No = {float(out.cn0[0]):,.2f} dB{lock}"
            )
        total += cfg.fftsize
    return 0


if __name__ == "__main__":
    run_main(main)
