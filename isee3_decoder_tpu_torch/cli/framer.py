"""framer CLI — syncword framer over decoded ASCII bits (framer.c).
Same flags and output as the JAX package's tool; --device picks the card
(default) or the CPU.

    python -m isee3_decoder_tpu_torch.cli.framer < bits.txt
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from isee3_decoder_tpu_torch.cli._io import run_main
from isee3_decoder_tpu_torch.models.legacy import frame_bits
from isee3_decoder_tpu_torch.utils.timeformat import format_hms


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="framer")
    p.add_argument("-r", type=int, default=512, dest="bitrate")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="run on the card (default) or on the CPU")
    a = p.parse_args(argv)

    text = sys.stdin.read()
    bits = np.array([1 if c == "1" else 0 for c in text if c in "01"], np.uint8)
    res = frame_bits(bits, device=a.device)
    for n, (frame, pos) in enumerate(zip(res.frames, res.positions), start=1):
        print(f"Frame {n:,} at bit {pos:,} ({format_hms(pos / a.bitrate)})")
        for i in range(0, len(frame), 16):
            print(" ".join(f"{b:02x}" for b in frame[i : i + 16]))
        print()
    sys.stdout.flush()
    return 0


if __name__ == "__main__":
    run_main(main)
