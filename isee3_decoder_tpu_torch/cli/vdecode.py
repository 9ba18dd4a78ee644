"""vdecode CLI — streaming Viterbi decoder (vdecode.c): reads soft symbol
bytes on stdin, writes '0'/'1' ASCII bits with a fixed decode delay, and
reports the re-encode symbol error rate on stderr.  Same flags and output
as the JAX package's tool: --backend jnp (default; the classic API,
kernel K10) or fused (K5/K6), the same bits; --device picks the card
(default) or the CPU.

    python -m isee3_decoder_tpu_torch.cli.vdecode < soft.bin > bits.txt
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from isee3_decoder_tpu_torch.cli._io import run_main, status
from isee3_decoder_tpu_torch.config import DEFAULT_CODE
from isee3_decoder_tpu_torch.models.legacy import auto_phase_flip, vdecode_stream
from isee3_decoder_tpu_torch.ops.encode import encode_bits


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="vdecode")
    p.add_argument("-d", type=int, default=200, dest="decode_delay")
    p.add_argument("-p", action="store_true", dest="opposite_phase")
    p.add_argument("-i", type=int, default=1024, dest="status_interval")
    p.add_argument("-F", action="store_true", dest="dontflip")
    p.add_argument("-q", action="store_true", dest="quiet")
    p.add_argument("--backend", choices=("jnp", "fused"), default="jnp",
                   help="Viterbi decoder: classic (K10) or fused-cycle "
                   "(K5/K6), bit-identical")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="run on the card (default) or on the CPU")
    a = p.parse_args(argv)

    if a.decode_delay < 24:
        status("vdecode: decoder delay too small, using 200")
        a.decode_delay = 200

    symbols = np.frombuffer(sys.stdin.buffer.read(), np.uint8)[None, :]
    if a.opposite_phase:
        # vdecode.c:74-77: -p starts the pair counter at 1, so the first
        # input byte pairs with a phantom zero-initialized symbol
        symbols = np.concatenate([np.zeros((1, 1), np.uint8), symbols], axis=1)
    if not a.dontflip and symbols.shape[1] >= 2082:
        symbols, extra = auto_phase_flip(symbols, device=a.device)
        if int(extra[0]) and not a.quiet:
            status("vdecode: flipping phase")
    res = vdecode_stream(symbols, a.decode_delay, backend=a.backend,
                         device=a.device)
    bits = res.bits[0]
    sys.stdout.write("".join("1" if b else "0" for b in bits))
    sys.stdout.flush()
    if not a.quiet and a.status_interval:
        # periodic symbol-error-rate statuses (vdecode.c:180-184), from
        # the per-interval re-encode comparison
        lag = DEFAULT_CODE.k - 2
        if bits.shape[0] > lag:
            data_bits = bits[lag:]
            re_syms = encode_bits(torch.from_numpy(data_bits), 0)[0].numpy()
            hard = (symbols[0, : re_syms.shape[0]] > 128).astype(np.uint8)
            errs = re_syms != hard[: re_syms.shape[0]]
            for i in range(a.status_interval, len(data_bits), a.status_interval):
                seg = errs[2 * (i - a.status_interval) : 2 * i]
                status(
                    f"vdecode: bits {i:,}; symerrs {int(seg.sum()):,}"
                    f"/{len(seg):,} {100.0 * seg.mean():.3g}%"
                )
    if not a.quiet:
        nsym = 2 * bits.shape[0]
        nerr = int(res.symbol_errors[0])
        status(f"vdecode: bits {bits.shape[0]:,}; symerrs {nerr:,}"
               f"/{nsym:,} {100.0 * nerr / max(nsym, 1):.3g}%")
    return 0


if __name__ == "__main__":
    run_main(main)
