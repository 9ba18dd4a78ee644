"""icesync CLI — waveform-domain FFT frame sync + block Viterbi
(icesync.c) over a whole int16 baseband file.  Same flags and output as
the JAX package's tool; the frames decode with the classic API (kernel
K10) on the card, or on the CPU with --device cpu.

    python -m isee3_decoder_tpu_torch.cli.icesync -r 250000 baseband.i16
"""

from __future__ import annotations

import argparse

import numpy as np

from isee3_decoder_tpu_torch.cli._io import run_main
from isee3_decoder_tpu_torch.models.legacy import icesync_frames


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="icesync")
    p.add_argument("-c", type=float, default=1024.475, dest="symrate")
    p.add_argument("-r", type=float, default=250000.0, dest="samprate")
    p.add_argument("-o", type=int, default=0, dest="begin")
    p.add_argument("-t", type=float, default=5.0, dest="clock_tolerance")
    p.add_argument(
        "--no-plots",
        action="store_true",
        help="suppress the per-acquisition sync.N.plot correlation dumps"
        " the reference writes unconditionally (icesync.c:173-186)",
    )
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="run on the card (default) or on the CPU")
    p.add_argument("input")
    a = p.parse_args(argv)

    samples = np.fromfile(a.input, "<i2")[a.begin :]
    print(
        f"{a.input}: {len(samples):,} samples, "
        f"{len(samples) / a.samprate:,.3f} seconds @ {a.samprate:.1f} Hz"
    )
    frames = icesync_frames(
        samples, a.samprate, a.symrate, a.clock_tolerance,
        plot_dir=None if a.no_plots else ".", device=a.device,
    )
    for n, fr in enumerate(frames, start=1):
        t = fr.start_sample / a.samprate
        print(f"Frame {n:,} @ sample {fr.start_sample:,} ({int(t)//60:,}:{int(t)%60:02d})")
        for i in range(0, len(fr.data), 16):
            print(" ".join(f"{b:02x}" for b in fr.data[i : i + 16]))
        print(
            f"Viterbi path metric range {fr.min_metric:,} - {fr.max_metric:,}, "
            f"diff {fr.max_metric - fr.min_metric:,}"
        )
        if fr.ebn0_db is None:
            print("No re-encode symbol errors; estimated Eb/No > 10.50 dB")
        else:
            print(
                f"re-encode symbol errors: {fr.symbol_errors:,}/{2048:,}; "
                f"estimated Eb/No = {fr.ebn0_db:.2f} dB"
            )
        print()
    return 0


if __name__ == "__main__":
    run_main(main)
