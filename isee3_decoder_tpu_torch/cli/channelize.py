"""channelize CLI — split a wideband int16 IQ capture into per-channel
baseband files (the many-channel front end; no reference equivalent).

    python -m isee3_decoder_tpu_torch.cli.channelize [flags] capture.iq

Each output channel k is written to <outdir>/chan<k>.iq as interleaved
int16 I,Q at rate oversample·fs_in/M, centred at k*fs_in/M (aliased to
±fs/2), ready for the pmdemod | symdemod | decode pipeline.  Flags as in
the JAX package's CLI, whose files this one reproduces: -M channels, -r
input rate, -t taps per branch, -O oversample, -o output directory, -c
channel list, -g gain.  --device picks where the bank runs: "cuda"
(default) or "cpu".
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from isee3_decoder_tpu_torch import _kernels
from isee3_decoder_tpu_torch.cli._io import run_main, status
from isee3_decoder_tpu_torch.ops.channelizer import channel_center, channelize


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="channelize")
    p.add_argument("-M", type=int, default=8, dest="nchan")
    p.add_argument("-r", type=float, default=2_000_000.0, dest="samprate")
    p.add_argument("-t", type=int, default=8, dest="taps_per_branch")
    p.add_argument("-O", type=int, default=1, choices=(1, 2), dest="oversample",
                   help="2 = 2x oversampled bank (rate 2*fs/M; recovers "
                        "channel-edge carriers the critical bank aliases)")
    p.add_argument("-o", default="channels", dest="outdir")
    p.add_argument("-c", default=None, dest="channels",
                   help="comma-separated channel indices (default: all)")
    p.add_argument("-g", type=float, default=1.0, dest="gain")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="run on the card (default) or on the CPU")
    p.add_argument("input")
    a = p.parse_args(argv)

    raw = np.fromfile(a.input, "<i2").astype(np.float32)
    iq = (raw[0::2] + 1j * raw[1::2]).astype(np.complex64)
    status(
        f"channelize: {len(iq):,} samples @ {a.samprate:,.0f} Hz -> "
        f"{a.nchan} channels @ "
        f"{a.oversample * a.samprate / a.nchan:,.0f} Hz"
    )
    y = channelize(
        _kernels.place(iq, a.device), a.nchan, a.taps_per_branch,
        oversample=a.oversample,
    )[0].cpu().numpy()
    os.makedirs(a.outdir, exist_ok=True)
    sel = (
        [int(c) for c in a.channels.split(",")]
        if a.channels
        else range(a.nchan)
    )
    for k in sel:
        out = np.empty((y.shape[1], 2), np.int16)
        # saturate on the float, then convert: the cast alone would wrap
        out[:, 0] = np.clip(y[k].real * a.gain, -32768, 32767).astype(np.int16)
        out[:, 1] = np.clip(y[k].imag * a.gain, -32768, 32767).astype(np.int16)
        path = os.path.join(a.outdir, f"chan{k}.iq")
        out.tofile(path)
        status(
            f"channelize: wrote {path} (center "
            f"{channel_center(k, a.samprate, a.nchan):,.0f} Hz, "
            f"{y.shape[1]:,} samples)"
        )
    return 0


if __name__ == "__main__":
    run_main(main)
