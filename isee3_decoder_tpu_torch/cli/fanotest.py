"""fanotest CLI — Fano decoder statistics harness (fanotest.c).

Encode random frames with known start/tail states, pass them through the
AWGN channel, decode with Fano (kernel K4 on the card), and report
good/bad/undetected frame counts and average cycles per bit against the
theoretical BER.

Same flags and output format as the JAX package's tool.  Runs are
reproducible from --seed, which seeds numpy (the data bits) and a
``torch.Generator`` (the channel); the JAX tool draws its channel from
``jax.random``, so its counts differ from these for the same seed
(utils/sim.sample_channel gives parity on shared uniforms).  --device
picks the card (default) or the CPU.

    python -m isee3_decoder_tpu_torch.cli.fanotest -l 1024 -n 256 -e 3
"""

from __future__ import annotations

import argparse
import math

import numpy as np
import torch

from isee3_decoder_tpu_torch import _kernels
from isee3_decoder_tpu_torch.cli._io import run_main
from isee3_decoder_tpu_torch.config import DEFAULT_CODE
from isee3_decoder_tpu_torch.ops.encode import encode_bits
from isee3_decoder_tpu_torch.ops.fano import FanoParams, fano_decode
from isee3_decoder_tpu_torch.utils.metrics import gen_met
from isee3_decoder_tpu_torch.utils.sim import ebn0_to_noise, simulate

TAIL = 0x12345  # fanotest.c:36-37
START = 0x54321


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="fanotest")
    p.add_argument("-d", "--delta", type=int, default=4)
    p.add_argument("-S", "--scale", type=int, default=8)
    p.add_argument("-m", "--max-cycles", type=int, default=1000, dest="maxcycles")
    p.add_argument("-l", "--frame-length", type=int, default=1024, dest="nbits")
    p.add_argument("-n", "--frame-count", type=int, default=1000, dest="trials")
    p.add_argument("-e", "--ebn0", type=float, default=2.0)
    p.add_argument("-s", "--signal", type=float, default=30.0)
    p.add_argument("-b", "--batch", type=int, default=64)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("-v", "--verbose", action="count", default=0)
    p.add_argument("-z", "--zerodata", action="store_true")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="run on the card (default) or on the CPU")
    a = p.parse_args(argv)

    dev = _kernels.run_device(a.device)
    code = DEFAULT_CODE
    nbits = a.nbits
    rate = 0.5
    delta = a.delta * a.scale
    noise_amp = ebn0_to_noise(a.signal, a.ebn0, rate)
    mettab = torch.as_tensor(gen_met(a.signal, noise_amp, rate, a.scale),
                             device=dev)
    print(f"Code rate {rate:.2f}, Nbits = {nbits}, Maxcycles/bit {a.maxcycles}")
    print(
        f"Eb/N0 = {a.ebn0:.3f} dB, Signal = {a.signal:g}, Noise = {noise_amp:g}, "
        f"BER@Eb/N0 = {0.5 * math.erfc(10 ** (a.ebn0 / 20)):g}, "
        f"BER@Es/N0 = {0.5 * math.erfc(math.sqrt(rate * 10 ** (a.ebn0 / 10))):g}"
    )

    rng = np.random.default_rng(a.seed)
    gen = torch.Generator(device=dev)
    gen.manual_seed(a.seed)
    params = FanoParams(delta=delta, maxcycles=a.maxcycles)
    good = bad = undetected = 0
    totcycles = 0
    done = 0
    while done < a.trials:
        B = min(a.batch, a.trials - done)
        bits = np.zeros((B, nbits), np.uint8)
        if not a.zerodata:
            bits[:, : nbits - 64] = rng.integers(0, 2, (B, nbits - 64))
        for j in range(code.k - 1):  # tail forcing (fanotest.c:117-119)
            bits[:, nbits - 1 - j] = (TAIL >> j) & 1
        syms, _ = encode_bits(torch.as_tensor(bits, device=dev), START, code)
        rx = simulate(gen, syms, a.signal, noise_amp)
        res = fano_decode(rx, mettab, nbits, START, TAIL, code, params)
        goodbits = res.goodbits.cpu().numpy()
        decoded = res.bits.cpu().numpy()
        cycles = res.cycles.cpu().numpy()
        metric = res.metric.cpu().numpy()
        totcycles += int(cycles.astype(np.int64).sum())
        ok = goodbits == nbits
        mismatch = (decoded != bits).any(axis=1)
        bad += int(mismatch.sum())
        good += int((~mismatch).sum())
        undetected += int((ok & mismatch).sum())
        done += B
        if a.verbose:
            for i in range(B):
                if a.verbose > 1 or goodbits[i] != nbits:
                    print(
                        f"trial {done - B + i} fano returns {goodbits[i]}, "
                        f"metric = {int(metric[i])}, cycles = {int(cycles[i])}"
                    )
    print(
        f"trials {done} avg cycles/bit {totcycles / (done * nbits):g} good {good} "
        f"bad {bad} undetected {undetected} deletion rate {100.0 * bad / done:g}%"
    )
    return 0


if __name__ == "__main__":
    run_main(main)
