"""qdecode CLI — quick-look-in decoder (qdecode.c): reads soft symbol
bytes on stdin, writes '0'/'1' ASCII bits on stdout, with automatic
symbol-pair phase flipping unless -F.  Same flags and output as the JAX
package's tool; --device picks the card (default) or the CPU.

    python -m isee3_decoder_tpu_torch.cli.qdecode < soft.bin > bits.txt
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from isee3_decoder_tpu_torch.cli._io import run_main, status
from isee3_decoder_tpu_torch.models.legacy import auto_phase_flip, qdecode_stream


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="qdecode")
    p.add_argument("-F", action="store_true", dest="dontflip")
    p.add_argument("-p", action="store_true", dest="opposite_phase")
    p.add_argument("-q", action="store_true", dest="quiet")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="run on the card (default) or on the CPU")
    a = p.parse_args(argv)

    symbols = np.frombuffer(sys.stdin.buffer.read(), np.uint8)[None, :]
    if a.opposite_phase:
        # qdecode.c:76-80: -p starts the pair counter at 1, so the first
        # input byte pairs with a phantom zero-initialized symbol
        symbols = np.concatenate([np.zeros((1, 1), np.uint8), symbols], axis=1)
    if not a.dontflip and symbols.shape[1] >= 2082:
        symbols, extra = auto_phase_flip(symbols, device=a.device)
        if int(extra[0]) and not a.quiet:
            status("qdecode: flipping phase")
    bits = qdecode_stream(symbols, device=a.device)[0].cpu().numpy()
    sys.stdout.write("".join("1" if b else "0" for b in bits))
    sys.stdout.flush()
    return 0


if __name__ == "__main__":
    run_main(main)
