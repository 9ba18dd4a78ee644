"""decode CLI — frame sync + hybrid Fano/Viterbi decoder (decode.c).

Reads 8-bit soft symbols on stdin, prints decoded 128-byte frames in hex.

    python -m isee3_decoder_tpu_torch.cli.decode [flags] < soft.bin

Flags (decode.c:75-107): -F fano only, -V viterbi only, -p persistent,
-n suppress bad frames, -r symrate, -s fano scale, -m fano maxcycles,
-d fano delta, -v verbose; --strict-labels, --no-quicklook and --backend
as in the JAX package's CLI, whose output text this one reproduces
(--backend defaults to the port's "fused"; "jnp" takes the classic
decoder, kernel K10; all give the same bits).  --device picks where it
runs: "cuda" (default; the port's kernels) or "cpu" (their plain
versions).
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from isee3_decoder_tpu_torch.cli._io import read_exact, run_main
from isee3_decoder_tpu_torch.config import FRAMESYMBOLS, SYNCBITS
from isee3_decoder_tpu_torch.models.decode import (
    DecodeConfig,
    DecodeStreamState,
    decode_stream,
    format_frame,
)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="decode")
    p.add_argument("-F", action="store_true", help="disable Viterbi (Fano only)")
    p.add_argument("-V", action="store_true", help="disable Fano (Viterbi only)")
    p.add_argument("-p", action="store_true", dest="persistent")
    p.add_argument("-n", action="store_true", dest="no_bad_frames")
    p.add_argument("-v", action="count", default=0, dest="verbose")
    p.add_argument("-r", type=float, default=1024.0, dest="symrate")
    p.add_argument("-s", type=float, default=8.0, dest="fano_scale")
    p.add_argument("-m", type=int, default=100, dest="fano_maxcycles")
    p.add_argument("-d", type=int, default=None, dest="fano_delta")
    p.add_argument("--backend", default="fused",
                   choices=["jnp", "inplace", "fused"],
                   help="Viterbi decoder (bit-identical outputs)")
    p.add_argument("--strict-labels", action="store_true",
                   help="disable the quicklook-EC middle tier so decoder"
                   " labels match decode.c exactly (frame bytes are"
                   " identical either way)")
    p.add_argument("--no-quicklook", action="store_true",
                   help="disable the quick-look fast tier (output is"
                   " identical either way)")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="run on the card (default) or on the CPU")
    a = p.parse_args(argv)

    fano_enabled = not a.V
    viterbi_enabled = not a.F
    if not fano_enabled and not viterbi_enabled:
        print("decode: Specify only one of -F or -V")
        return 1
    delta = a.fano_delta if a.fano_delta is not None else int(4 * a.fano_scale)
    cfg = DecodeConfig(
        fano_enabled=fano_enabled,
        viterbi_enabled=viterbi_enabled,
        persistent=a.persistent,
        fano_scale=a.fano_scale,
        fano_delta=delta,
        # reference quirk: decode.c:202 passes a literal 100 to fano(); the
        # parsed -m value is only ever displayed
        fano_maxcycles=100,
        viterbi_backend=a.backend,
        quicklook=not a.no_quicklook,
        qlec=not a.strict_labels,
    )
    print(
        f"decode: Fano {'enabled' if fano_enabled else 'disabled'}; "
        f"Viterbi {'enabled' if viterbi_enabled else 'disabled'}"
    )
    if a.no_bad_frames:
        print("decode: Not displaying bad frames")

    f = sys.stdin.buffer
    state = DecodeStreamState(1)
    buf = np.zeros(0, np.uint8)
    frame_no = 1
    chunk = FRAMESYMBOLS + SYNCBITS
    eof = False
    while True:
        if not eof:
            raw = read_exact(f, 4 * chunk)
            if len(raw) < 4 * chunk:
                eof = True
            if raw:
                buf = np.concatenate([buf, np.frombuffer(raw, np.uint8)])
        recs, state = decode_stream(buf[None, :], cfg, state, device=a.device)
        for r in recs:
            if r.good[0] or not a.no_bad_frames:
                sys.stdout.write(format_frame(r, 0, frame_no, a.symrate) + "\n")
                sys.stdout.flush()
            frame_no += 1
        if eof and not recs:
            break
    return 0


if __name__ == "__main__":
    run_main(main)
