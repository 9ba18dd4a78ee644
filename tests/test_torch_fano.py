"""PyTorch port vs the JAX package: the Fano walk (kernel K4).

On the CPU the port's walk is K4's plain version (the lockstep walk in
PyTorch).  It must match the JAX package's Pallas walk (interpret mode)
and its XLA walk bit for bit: bits, goodbits, metric and cycles —
timed-out lanes' partial results included.  The wide codes (30 to 60
state bits) take the plain version of K4's wide variant, held against
the JAX package's split-word walk the same way."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isee3_decoder_tpu.config import CODES as JCODES
from isee3_decoder_tpu.config import DEFAULT_CODE, SYNC_STATE, SYNCWORD, CodeSpec
from isee3_decoder_tpu.ops import fano_pallas
from isee3_decoder_tpu.ops.encode import encode_bits
from isee3_decoder_tpu.ops.fano import FanoParams, _fano_decode_packed, fano_decode
from isee3_decoder_tpu.utils.metrics import decoder_amplitudes, gen_met
from isee3_decoder_tpu.utils.sim import ebn0_to_noise
from isee3_decoder_tpu_torch.config import CODES
from isee3_decoder_tpu_torch.ops import fano as tf
from isee3_decoder_tpu_torch.ops import fano_cuda
from isee3_decoder_tpu_torch.ops.encode import encode_bits as tencode_bits

K7 = CodeSpec("TESTK7", 0o171, 0o133, 7, 0, 0)


def _noisy_batch(rng, code, nbits, B, sigma, start, tail, amp=100.0):
    softs = []
    for _ in range(B):
        bits = rng.integers(0, 2, nbits, dtype=np.uint8)
        for j in range(code.k - 1):
            bits[nbits - 1 - j] = (tail >> j) & 1
        syms, _ = encode_bits(jnp.asarray(bits[None, :]), start, code)
        s = np.asarray(syms[0], np.int32)
        noisy = (s * 2 - 1) * amp + rng.normal(0, sigma, 2 * nbits)
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


# ---------------------------------------------------------------- wide walk
# codes of 30 or more state bits: the port's int64 walk against the JAX
# package's split-word walk (_fano_decode_wide), bits, goodbits, metric
# and cycles bit for bit


def _wide_pair(softs, mettab, nbits, start, tail, name, maxcycles, skip=None):
    code = JCODES[name]
    r_j = fano_decode(jnp.asarray(softs), jnp.asarray(mettab), nbits, start,
                      tail, code, FanoParams(delta=32, maxcycles=maxcycles),
                      None if skip is None else jnp.asarray(skip))
    r_t = tf.fano_decode(
        torch.from_numpy(softs), torch.from_numpy(np.asarray(mettab)), nbits,
        start, tail, CODES[name], tf.FanoParams(32, maxcycles),
        None if skip is None else torch.from_numpy(skip))
    return r_t, r_j


def test_wide_mcqli32_matches_jax():
    """MCQLI32 at 64 bits from state 0x2A with tail 0x15, 4 noisy lanes
    (the JAX package's oracle test's frame, tests/test_fano.py:220)."""
    rng = np.random.default_rng(11)
    mettab = gen_met(30.0, ebn0_to_noise(30.0, 3.0), 0.5, 8.0)
    softs = _noisy_batch(rng, JCODES["MCQLI32"], 64, 4, 38.0, 0x2A, 0x15, 30.0)
    r_t, r_j = _wide_pair(softs, mettab, 64, 0x2A, 0x15, "MCQLI32", 50)
    _assert_equal(r_t, r_j)
    assert (r_t.cycles.numpy() > 64).any()  # real backtracking


@pytest.mark.parametrize("name,nbits,tail", [
    ("J50", 80, 0x1ABCDEF0123),  # 41 significant bits, above the int32 word
    ("J60", 96, 0x155AA55AA55AA),  # 51 significant bits; POLY1 = 1
])
def test_wide_tail_roundtrip(name, nbits, tail):
    """A frame whose known tail reaches past bit 31 decodes to the bits
    sent, as in JAX (tests/test_fano.py:254-288), bit for bit with it."""
    rng = np.random.default_rng(13)
    code = JCODES[name]
    bits = rng.integers(0, 2, nbits, dtype=np.uint8)
    for j in range(code.k - 1):
        bits[nbits - 1 - j] = (tail >> j) & 1
    syms, _ = encode_bits(jnp.asarray(bits[None, :]), 0, code)
    soft = np.where(np.asarray(syms) > 0, 200, 56).astype(np.uint8)
    mettab = gen_met(80.0, ebn0_to_noise(80.0, 6.0), 0.5, 8.0)
    r_t, r_j = _wide_pair(soft, mettab, nbits, 0, tail, name, 100)
    _assert_equal(r_t, r_j)
    assert int(r_t.goodbits[0]) == nbits
    np.testing.assert_array_equal(r_t.bits.numpy()[0], bits)


@pytest.mark.parametrize("name,skip,maxcycles,sigma", [
    ("MCQLI48", [False, True, False, True, False], 30, 60.0),
    ("BLLF47", [False] * 5, 3, 80.0),
], ids=["skip", "timeout"])
def test_wide_batch_skip_and_timeout(name, skip, maxcycles, sigma):
    """A batch with lanes skipped (they start done) and one whose cap
    makes lanes time out: JAX's results on every live lane."""
    rng = np.random.default_rng(17)
    nbits = 64
    mettab = gen_met(100.0, 60.0, 0.5, 8.0)
    softs = _noisy_batch(rng, JCODES[name], nbits, len(skip), sigma, 5, 0x3C)
    skip_np = np.asarray(skip)
    r_t, r_j = _wide_pair(softs, mettab, nbits, 5, 0x3C, name, maxcycles,
                          skip_np if skip_np.any() else None)
    _assert_equal(r_t, r_j, ~skip_np)
    good = r_t.goodbits.numpy()[~skip_np] == nbits
    if skip_np.any():
        assert good.any()
    else:
        assert (~good).any(), "no lane timed out"


@pytest.mark.parametrize("name", sorted(CODES))
def test_every_catalog_code_decodes(name):
    """No code of the catalog is refused: a clean frame of each decodes
    to the bits sent (the wide ones by the int64 walk)."""
    code = CODES[name]
    rng = np.random.default_rng(len(name))
    nbits = 2 * code.k + 8
    bits = rng.integers(0, 2, nbits, dtype=np.uint8)
    bits[nbits - (code.k - 1):] = 0
    syms, _ = tencode_bits(torch.from_numpy(bits[None, :]), 0, code)
    soft = torch.where(syms > 0, 200, 56).to(torch.uint8)
    mettab = torch.from_numpy(np.asarray(gen_met(80.0, 40.0, 0.5, 8.0)))
    r = tf.fano_decode(soft, mettab, nbits, 0, 0, code, tf.FanoParams(32, 20))
    assert int(r.goodbits[0]) == nbits
    np.testing.assert_array_equal(r.bits.numpy()[0], bits)


@pytest.mark.parametrize("code,nbits,sigma,maxcycles", [
    (K7, 64, 85.0, 6),
    (DEFAULT_CODE, 128, 70.0, 3),
], ids=["K7", "MCQLI24"])
def test_wide_plain_matches_the_collapsed_walk(code, nbits, sigma, maxcycles):
    """The wide plain walk (one backtrack step a micro-step, int64 state)
    and the packed walk (a whole backtrack run a micro-step, the
    collapse K4 makes) end in the same bits and [np, gamma, cycles, t]
    on a code both take."""
    rng = np.random.default_rng(9)
    softs = _noisy_batch(rng, code, nbits, 12, sigma, 0x2A, 0x15)
    m4, regs = tf._walk_inputs(torch.from_numpy(softs),
                               torch.from_numpy(np.asarray(
                                   gen_met(100.0, 60.0, 0.5, 8.0))),
                               nbits, 0x2A, 0x15, code, None)
    b_p, s_p = fano_cuda.fano_walk_plain(m4, regs, code, 32, maxcycles)
    b_w, s_w = fano_cuda.fano_walk_wide_plain(m4, regs.to(torch.int64), code,
                                              32, maxcycles)
    assert torch.equal(b_p, b_w) and torch.equal(s_p, s_w)
    assert (s_p[:, 0] + 1 != nbits).any()  # a lane timed out
