"""PyTorch port: the channel and decoder statistics on the port's own
channel, against theory and the JAX suite's asserts.

Counterparts of tests/test_ber_regression.py (the 8-bit channel's hard
symbol error rate against 0.5·erfc(√(Es/N0)), and the MCQLI-24 Fano
operating point at 3.5 dB) and tests/test_mode16bps_and_fer.py's seeded
FER sweep (Fano at 2.5, 3.0 and 4.0 dB, then the classic Viterbi decoder
on frames Fano deleted at 3.0 dB), with the same Es/N0 and Eb/N0
points, trial counts, ``FanoParams`` and asserts.  The channel is
``utils/sim.simulate`` on a ``torch.Generator``, so its draws are not
JAX's: each assert was checked to hold for generator seeds 0-4, and the
tests run seed 0.  The bits come from numpy generators seeded as the
JAX tests seed theirs.  Fano and Viterbi run their kernels' plain
versions (K4's ``fano_walk_plain``, K10's plain ACS step) on the CPU.
"""

from __future__ import annotations

import math

import numpy as np
import pytest
import torch

from isee3_decoder_tpu.utils import metrics as jmetrics
from isee3_decoder_tpu_torch.config import (
    FRAMEBITS,
    MCQLI24,
    SYNC_STATE,
    SYNCWORD,
)
from isee3_decoder_tpu_torch.ops import viterbi as vit
from isee3_decoder_tpu_torch.ops.encode import encode_bits
from isee3_decoder_tpu_torch.ops.fano import FanoParams, fano_decode
from isee3_decoder_tpu_torch.utils.metrics import gen_met
from isee3_decoder_tpu_torch.utils.sim import ebn0_to_noise, simulate

SEED = 0


def _generator(seed: int) -> torch.Generator:
    g = torch.Generator()
    g.manual_seed(seed)
    return g


def hard_ber(seed: int) -> list[tuple[float, float, float]]:
    """(Es/N0 dB, symbol error rate, theory) of 400,000 all-zero symbols
    at -1, 1 and 3 dB (test_ber_regression.py:20)."""
    signal = 60.0
    n = 400_000
    gen = _generator(seed)
    out = []
    for esn0_db in (-1.0, 1.0, 3.0):
        noise = signal / (10 ** (esn0_db / 20.0)) / math.sqrt(2.0)
        rx = simulate(gen, torch.zeros(n, dtype=torch.uint8), signal, noise)
        ser = float((rx > 128).double().mean())
        want = 0.5 * math.erfc(signal / (noise * math.sqrt(2.0)))
        out.append((esn0_db, ser, want))
    return out


def test_channel_hard_ber_matches_theory():
    """The hard-decision symbol error rate of the 8-bit quantized channel
    tracks Q(signal/noise), within test_ber_regression.py's bound."""
    for esn0_db, ser, want in hard_ber(SEED):
        assert abs(ser - want) < 0.25 * want + 2e-4, (esn0_db, ser, want)


def fano_operating_point(seed: int):
    """24 MCQLI-24 frames of 1024 bits (960 random, 64 zero) at Eb/N0
    3.5 dB through the Fano decoder at FanoParams(32, 200)
    (test_ber_regression.py:36): (finished, errors, cycles) per frame."""
    nbits = 1024
    signal = 100.0
    noise = ebn0_to_noise(signal, 3.5)
    mettab = torch.as_tensor(gen_met(signal, noise, 0.5, 8.0))
    rng = np.random.default_rng(0)
    trials = 24
    bits = np.zeros((trials, nbits), np.uint8)
    bits[:, : nbits - 64] = rng.integers(0, 2, (trials, nbits - 64))
    syms, _ = encode_bits(torch.from_numpy(bits), 0, MCQLI24)
    rx = simulate(_generator(seed), syms, signal, noise)
    res = fano_decode(rx, mettab, nbits, 0, 0, MCQLI24, FanoParams(32, 200))
    finished = res.goodbits.numpy() == nbits
    errs = (res.bits.numpy() != bits).any(axis=1)
    return finished, errs, res.cycles.numpy()


def test_fano_operating_point_mcqli24():
    """At 3.5 dB (above the ~2.5 dB Fano threshold) the frames decode
    with no undetected error, a deletion rate of at most 25 % and under
    10 cycles a bit on the finished ones.  (A frame the walk deleted
    would run the plain lockstep walk to its 204,800-step budget, minutes
    on the CPU; at seeds 0-4 every frame finishes, in 2-4 s.)"""
    finished, errs, cycles = fano_operating_point(SEED)
    assert (finished & errs).sum() == 0
    assert finished.mean() >= 0.75, f"deletion rate {1 - finished.mean():.2f}"
    cycles_per_bit = cycles[finished].mean() / 1024
    assert cycles_per_bit < 10, cycles_per_bit


def fer_sweep(seed: int):
    """16 full frames (the sync word's tail forced) from the sync state
    at Eb/N0 2.5, 3.0 and 4.0 dB through Fano at FanoParams(32, 100)
    (test_mode16bps_and_fer.py:80): (bits, the deletion rate a point,
    undetected errors a point, the 3.0 dB point's deleted frames and
    their indices)."""
    signal = 100.0
    trials = 16
    nbits = FRAMEBITS
    rng = np.random.default_rng(31)
    tail = SYNCWORD & ((1 << (MCQLI24.k - 1)) - 1)
    bits = np.zeros((trials, nbits), np.uint8)
    bits[:, : nbits - 64] = rng.integers(0, 2, (trials, nbits - 64))
    for j in range(MCQLI24.k - 1):
        bits[:, nbits - 1 - j] = (tail >> j) & 1
    syms, _ = encode_bits(torch.from_numpy(bits), SYNC_STATE, MCQLI24)
    gen = _generator(seed)
    deletion, undetected = {}, {}
    failed_rx = failed_idx = None
    for ebn0 in (2.5, 3.0, 4.0):
        noise = ebn0_to_noise(signal, ebn0)
        mettab = torch.as_tensor(gen_met(signal, noise, 0.5, 8.0))
        rx = simulate(gen, syms, signal, noise)
        res = fano_decode(rx, mettab, nbits, SYNC_STATE, tail, MCQLI24,
                          FanoParams(32, 100))
        finished = res.goodbits.numpy() == nbits
        errs = (res.bits.numpy() != bits).any(axis=1)
        undetected[ebn0] = int((finished & errs).sum())
        deletion[ebn0] = 1.0 - finished.mean()
        if ebn0 == 3.0 and (~finished).any():
            failed_rx = rx[torch.from_numpy(~finished)]
            failed_idx = np.nonzero(~finished)[0]
    return bits, deletion, undetected, failed_rx, failed_idx


@pytest.mark.slow
def test_fer_sweep_fano_viterbi():
    """Fano's deletion rate falls with Eb/N0, finished frames carry no
    undetected error, and the classic Viterbi decoder gives the sent bits
    of (up to two of) the frames Fano deleted at 3.0 dB, the hybrid
    policy of decode.c:209-231.  Slow, as in the JAX suite: deleted
    frames walk the plain Fano loop to its budget, and a K=24 Viterbi
    frame takes minutes on the CPU."""
    bits, deletion, undetected, failed_rx, failed_idx = fer_sweep(SEED)
    assert sum(undetected.values()) == 0, undetected
    assert deletion[4.0] <= deletion[3.0] <= deletion[2.5] + 1e-9, deletion
    assert deletion[4.0] <= 2 / 16, deletion
    assert deletion[2.5] < 1.0, "every frame deleted at 2.5 dB"
    if failed_rx is not None:
        got = vit.decode_frame(failed_rx[:2], FRAMEBITS, SYNC_STATE,
                               SYNC_STATE, MCQLI24, device="cpu")
        np.testing.assert_array_equal(got.numpy(), bits[failed_idx[:2]])


@pytest.mark.parametrize("ebn0", [2.5, 3.0, 3.5, 4.0])
def test_gen_met_matches_jax_at_the_sweep_points(ebn0):
    """The Fano metric table of every point above equals the JAX
    package's, entry for entry."""
    signal = 100.0
    noise = ebn0_to_noise(signal, ebn0)
    np.testing.assert_array_equal(gen_met(signal, noise, 0.5, 8.0),
                                  jmetrics.gen_met(signal, noise, 0.5, 8.0))
