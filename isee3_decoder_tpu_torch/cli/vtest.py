"""vtest CLI — Viterbi BER/throughput harness (vtest224.c).

Modes:
  with -e EbN0: encode random frames → AWGN channel → decode → BER/FER
  without -e:   pure-throughput timing on all-erasure symbols

Same flags and output format as the JAX package's tool.  Runs are
reproducible from --seed, which seeds numpy (the data bits) and a
``torch.Generator`` (the channel); the JAX tool draws its channel from
``jax.random``, so its BER/FER lines differ from these for the same seed.
--backend jnp (default; the classic API, kernel K10), fused (K5/K6) or
inplace (K5/K6 too) give the same bits; --device picks the card (default)
or the CPU.

    python -m isee3_decoder_tpu_torch.cli.vtest -l 1024 -n 8 -e 5
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from isee3_decoder_tpu_torch import _kernels
from isee3_decoder_tpu_torch.cli._io import run_main
from isee3_decoder_tpu_torch.config import DEFAULT_CODE
from isee3_decoder_tpu_torch.ops import viterbi
from isee3_decoder_tpu_torch.ops.encode import encode_bits
from isee3_decoder_tpu_torch.utils.sim import ebn0_to_noise, simulate


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="vtest")
    p.add_argument("-l", "--frame-length", type=int, default=1024, dest="framebits")
    p.add_argument("-n", "--frame-count", type=int, default=10, dest="trials")
    p.add_argument("-e", "--ebn0", type=float, default=None)
    p.add_argument("-g", "--gain", type=float, default=24.0)
    p.add_argument("-b", "--batch", type=int, default=8)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--backend", default="jnp",
                   choices=["jnp", "inplace", "fused"],
                   help="Viterbi decoder (bit-identical outputs)")
    p.add_argument("-v", "--verbose", action="count", default=0)
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="run on the card (default) or on the CPU")
    a = p.parse_args(argv)

    dev = _kernels.run_device(a.device)
    code = DEFAULT_CODE
    nbits = a.framebits
    rng = np.random.default_rng(a.seed)

    if a.ebn0 is not None:
        noise = ebn0_to_noise(a.gain, a.ebn0)
        print(
            f"nframes = {a.trials} framesize = {nbits} ebn0 = {a.ebn0:.2f} dB "
            f"Gain = {a.gain:g} noise = {noise:g}"
        )
        gen = torch.Generator(device=dev)
        gen.manual_seed(a.seed)
        tot_errs = 0
        badframes = 0
        done = 0
        t_decode = 0.0
        while done < a.trials:
            B = min(a.batch, a.trials - done)
            bits = rng.integers(0, 2, (B, nbits), dtype=np.uint8)
            bits[:, -code.k :] = 0  # zero tail (vtest224.c:105)
            syms, _ = encode_bits(torch.as_tensor(bits, device=dev), 0, code)
            rx = simulate(gen, syms, a.gain, noise)
            if rx.is_cuda:
                torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            # the host copy waits for the device
            decoded = viterbi.decode_frames(rx, nbits, 0, 0, code,
                                            a.backend).cpu().numpy()
            t_decode += time.perf_counter() - t0
            errs = (decoded != bits).sum(axis=1)
            tot_errs += int(errs.sum())
            badframes += int((errs != 0).sum())
            done += B
            if a.verbose:
                print(
                    f"BER {tot_errs}/{nbits * done} ({tot_errs / (nbits * done):10.3g}) "
                    f"FER {badframes}/{done} ({badframes / done:10.3g}) "
                    f"time {t_decode:.6g} s ({nbits * done / t_decode:.2f} b/s)"
                )
        print(
            f"BER {tot_errs}/{nbits * a.trials} ({tot_errs / (nbits * a.trials):.3g}) "
            f"FER {badframes}/{a.trials} ({badframes / a.trials:.3g})"
        )
    else:
        print("Starting time trials")
        syms = torch.full((a.batch, 2 * nbits), 128, dtype=torch.uint8,
                          device=dev)  # erasures
        # warm-up
        viterbi.decode_frames(syms, nbits, 0, 0, code, a.backend).cpu()
        t0 = time.perf_counter()
        done = 0
        while done < a.trials:
            viterbi.decode_frames(syms, nbits, 0, 0, code, a.backend).cpu()
            done += a.batch
        extime = time.perf_counter() - t0
        print(f"Execution time for {done} {nbits}-bit frames: {extime:.2f} sec")
        print(f"decoder speed: {done * nbits / extime:g} bits/s")
    return 0


if __name__ == "__main__":
    run_main(main)
