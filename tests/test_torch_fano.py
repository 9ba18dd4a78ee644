"""PyTorch port vs the JAX package: the Fano walk (kernel K4).

On the CPU the port's walk is K4's plain version (the lockstep walk in
PyTorch).  It must match the JAX package's Pallas walk (interpret mode)
and its XLA walk bit for bit: bits, goodbits, metric and cycles —
timed-out lanes' partial results included."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isee3_decoder_tpu.config import DEFAULT_CODE, SYNC_STATE, SYNCWORD, CodeSpec
from isee3_decoder_tpu.ops import fano_pallas
from isee3_decoder_tpu.ops.encode import encode_bits
from isee3_decoder_tpu.ops.fano import FanoParams, _fano_decode_packed
from isee3_decoder_tpu.utils.metrics import decoder_amplitudes, gen_met
from isee3_decoder_tpu_torch.config import CODES
from isee3_decoder_tpu_torch.ops import fano as tf

K7 = CodeSpec("TESTK7", 0o171, 0o133, 7, 0, 0)


def _noisy_batch(rng, code, nbits, B, sigma, start, tail):
    softs = []
    for _ in range(B):
        bits = rng.integers(0, 2, nbits, dtype=np.uint8)
        for j in range(code.k - 1):
            bits[nbits - 1 - j] = (tail >> j) & 1
        syms, _ = encode_bits(jnp.asarray(bits[None, :]), start, code)
        s = np.asarray(syms[0], np.int32)
        noisy = (s * 2 - 1) * 100 + rng.normal(0, sigma, 2 * nbits)
        softs.append(np.clip(np.round(noisy) + 128, 0, 255).astype(np.uint8))
    return np.stack(softs)


def _port(softs, mettab, nbits, start, tail, code, params, skip=None):
    return tf._fano_decode_packed(
        torch.from_numpy(softs), torch.from_numpy(np.asarray(mettab)), nbits,
        start, tail, code,
        tf.FanoParams(params.delta, params.maxcycles),
        None if skip is None else torch.from_numpy(skip),
    )


def _assert_equal(r_t, r_j, lanes=slice(None)):
    for f in ("bits", "goodbits", "metric", "cycles"):
        np.testing.assert_array_equal(
            getattr(r_t, f).numpy()[lanes], np.asarray(getattr(r_j, f))[lanes], f
        )


@pytest.mark.parametrize(
    "seed,sigma,noise,maxcycles,skip",
    [
        # heavy noise: deep pop-runs, toggles, relaxes and timeouts
        (23, 85.0, 60.0, 6, [False] * 6),
        # moderate noise, two lanes skipped (they start done)
        (31, 47.0, 47.0, 12, [False, True, False, False, True]),
    ],
    ids=["cliff", "moderate_skip"],
)
def test_k4_plain_matches_pallas_walk_k7(seed, sigma, noise, maxcycles, skip):
    rng = np.random.default_rng(seed)
    nbits = 64
    mettab = gen_met(100.0, noise, 0.5, 8.0)
    softs = _noisy_batch(rng, K7, nbits, len(skip), sigma, 0x2A, 0x15)
    params = FanoParams(delta=32, maxcycles=maxcycles, unroll=2)
    skip_np = np.asarray(skip)
    r_p = fano_pallas.fano_decode_pallas(
        jnp.asarray(softs), jnp.asarray(mettab), nbits, 0x2A, 0x15, K7, params,
        jnp.asarray(skip_np), interpret=True,
    )
    r_t = _port(softs, mettab, nbits, 0x2A, 0x15, K7, params, skip_np)
    live = ~skip_np
    _assert_equal(r_t, r_p, live)
    good = r_t.goodbits.numpy()[live] == nbits
    assert good.any()
    if not skip_np.any():
        assert (~good).any(), "no lane timed out"


def test_k4_plain_matches_xla_walk_mcqli24():
    """The mission code at the full frame length: 1024 bits from the sync
    state with the syncword tail, a low cycle cap so some lanes time out."""
    rng = np.random.default_rng(5)
    nbits = 1024
    tail = SYNCWORD & ((1 << (DEFAULT_CODE.k - 1)) - 1)
    sig, noise = decoder_amplitudes(100.0, 1.0)
    mettab = gen_met(sig, noise, 0.5, 8.0)
    softs = np.concatenate([
        _noisy_batch(rng, DEFAULT_CODE, nbits, 3, sigma, SYNC_STATE, tail)
        for sigma in (62.0, 90.0)
    ])
    params = FanoParams(delta=32, maxcycles=2, unroll=2)
    r_j = _fano_decode_packed(jnp.asarray(softs), jnp.asarray(mettab), nbits,
                              SYNC_STATE, tail, DEFAULT_CODE, params)
    r_t = _port(softs, mettab, nbits, SYNC_STATE, tail, DEFAULT_CODE, params)
    _assert_equal(r_t, r_j)
    good = r_t.goodbits.numpy() == nbits
    assert good.any() and (~good).any(), r_t.goodbits
    assert r_t.cycles.numpy()[good].max() > nbits  # real backtracking


def test_wide_code_is_refused():
    softs = torch.zeros((1, 128), dtype=torch.uint8)
    with pytest.raises(NotImplementedError, match="wide"):
        tf.fano_decode(softs, torch.zeros((2, 256), dtype=torch.int32), 64,
                       code=CODES["MCQLI32"])
