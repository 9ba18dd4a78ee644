"""PyTorch port vs the JAX package: the pm carrier stage.

Kernels K1 (locked pm block) and K2 (spin-down) run here in their plain
PyTorch versions (CPU tensors) against the JAX package's Pallas kernels
in interpret mode.  Tolerances are those of tests/test_carrier_raw.py:
f32 sum order differs, so peak bins and locks are equal, frequency
within 5e-3 Hz, amplitude within rtol 1e-5, C/N0 within 1e-2 dB and the
int16 baseband within 1 LSB (a moment ulp can move a trunc boundary).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isee3_decoder_tpu.ops import carrier as jc
from isee3_decoder_tpu.ops import carrier_pallas as jp
from isee3_decoder_tpu_torch.ops import carrier as tc
from isee3_decoder_tpu_torch.ops import carrier_cuda as tk
from isee3_decoder_tpu_torch.utils import convert
from tests.test_pmdemod import pm_signal

CFG = jc.PMConfig(samprate=32768.0, binsize=4.0, search_width=100.0)
NCH = 8


def _raw_int16(iq: np.ndarray) -> np.ndarray:
    ri = np.stack([iq.real, iq.imag], axis=-1).reshape(iq.shape[0], -1)
    return np.trunc(np.clip(ri, -32767, 32767)).astype(np.int16)


def _signal(seed: int, nblocks: int = 1):
    rng = np.random.default_rng(seed)
    n = CFG.fftsize * nblocks
    data = rng.integers(0, 2, 128 * nblocks) * 2 - 1
    freqs = 2000.0 + 137.0 * np.arange(NCH)
    iq = np.stack([
        pm_signal(n, CFG.samprate, f, 1.1, data, 32.0, amp=12000)
        + rng.normal(0, 300, n) + 1j * rng.normal(0, 300, n)
        for f in freqs
    ])
    return _raw_int16(iq), freqs


def _assert_close_block(bb_t, f_t, a_t, c_t, bb_j, f_j, a_j, c_j):
    np.testing.assert_allclose(f_t.numpy(), np.asarray(f_j), atol=5e-3)
    np.testing.assert_allclose(a_t.numpy(), np.asarray(a_j), rtol=1e-5)
    np.testing.assert_allclose(c_t.numpy(), np.asarray(c_j), atol=1e-2)
    diff = np.abs(bb_t.numpy().astype(np.int32) - np.asarray(bb_j, np.int32))
    assert diff.max() <= 1, diff.max()


def test_k1_plain_matches_pallas_locked_kernel():
    raw, freqs = _signal(9)
    carry = jc.PMCarry(search_center=jnp.asarray(freqs, jnp.float32),
                       cn0=jnp.full((NCH,), 60.0, jnp.float32))
    first, last = jc._search_window(carry.search_center, carry.cn0, CFG)
    K = jc._window_bins(CFG)
    kp = -(-K // 128) * 128
    bb_j, f_j, a_j, c_j = jp.pm_locked_fused(
        jp.pack_raw(jnp.asarray(raw)), first - 1, last - first, CFG.fftsize,
        kp, CFG.samprate, CFG.actual_binsize, interpret=True,
    )
    tcfg = convert.pm_config(CFG)
    tcarry = convert.pm_carry(carry)
    tf, tl = tc._search_window(tcarry.search_center, tcarry.cn0, tcfg)
    np.testing.assert_array_equal(tf.numpy(), np.asarray(first))
    np.testing.assert_array_equal(tl.numpy(), np.asarray(last))
    assert tc._window_bins(tcfg) == K
    assert tc._fast_search_ok(tcarry, tcfg) == bool(jc._fast_search_ok(carry, CFG))
    bb_t, f_t, a_t, c_t = tk.pm_locked_fused(
        tc.pack_raw(torch.from_numpy(raw)), tf - 1, tl - tf, K,
        tcfg.samprate, tcfg.actual_binsize,
    )
    # peak bins equal ⇔ the Quinn offsets land on the same bins
    np.testing.assert_array_equal(
        np.round(f_t.numpy() / CFG.actual_binsize),
        np.round(np.asarray(f_j) / CFG.actual_binsize),
    )
    _assert_close_block(bb_t, f_t, a_t, c_t, bb_j, f_j, a_j, c_j)


def test_k2_plain_matches_pallas_spin_kernel():
    raw, freqs = _signal(10)
    f = np.asarray(freqs, np.float32) + np.float32(0.125)
    bb_j, a_j, c_j = jp.spin_down_fused(jnp.asarray(raw), jnp.asarray(f),
                                        CFG.samprate, interpret=True)
    bb_t, a_t, c_t = tk.spin_down_fused(
        tc.pack_raw(torch.from_numpy(raw)), torch.from_numpy(f), CFG.samprate
    )
    _assert_close_block(bb_t, torch.from_numpy(f), a_t, c_t, bb_j, f, a_j, c_j)


def test_pm_demod_scan_raw_matches_jax_over_three_blocks():
    """Cold start (block 0: full FFT search + K2) then locked blocks (K1),
    carry threaded across blocks, against the JAX raw fast path with its
    Pallas kernels interpreted."""
    T = 3
    raw, _ = _signal(11, nblocks=T)
    blocks = raw.reshape(NCH, T, 2 * CFG.fftsize)
    jcfg = jc.PMConfig(samprate=32768.0, binsize=4.0, search_width=100.0,
                       search_backend="pallas_interpret")
    c_j, out_j = jc.pm_demod_scan(jc.init_carry(NCH, jcfg), jnp.asarray(blocks),
                                  jcfg)
    tcfg = convert.pm_config(jcfg)
    c_t, out_t = tc.pm_demod_scan(tc.init_carry(NCH, tcfg),
                                  torch.from_numpy(blocks), tcfg)
    assert np.asarray(out_j.locked).all()
    np.testing.assert_array_equal(out_t.locked.numpy(), np.asarray(out_j.locked))
    np.testing.assert_allclose(out_t.carrier_freq.numpy(),
                               np.asarray(out_j.carrier_freq), atol=5e-3)
    np.testing.assert_allclose(out_t.cn0.numpy(), np.asarray(out_j.cn0),
                               atol=1e-2)
    np.testing.assert_allclose(c_t.search_center.numpy(),
                               np.asarray(c_j.search_center), atol=5e-3)
    diff = np.abs(out_t.baseband.numpy().astype(np.int32)
                  - np.asarray(out_j.baseband, np.int32))
    assert diff.max() <= 1, diff.max()


def test_pm_demod_block_complex_matches_jax():
    """The complex-IQ block step (plain PyTorch: windowed search when
    locked, FFT otherwise) against the JAX XLA block step."""
    raw, freqs = _signal(12)
    iq = raw.astype(np.float32).reshape(NCH, -1, 2)
    iq = (iq[..., 0] + 1j * iq[..., 1]).astype(np.complex64)
    for cn0 in (60.0, -999.0):  # locked (windowed) and cold (full FFT)
        carry = jc.PMCarry(search_center=jnp.asarray(freqs, jnp.float32),
                           cn0=jnp.full((NCH,), cn0, jnp.float32))
        c_j, o_j = jc.pm_demod_block(carry, jnp.asarray(iq), CFG)
        c_t, o_t = tc.pm_demod_block(convert.pm_carry(carry),
                                     torch.from_numpy(iq), convert.pm_config(CFG))
        np.testing.assert_array_equal(o_t.locked.numpy(), np.asarray(o_j.locked))
        np.testing.assert_allclose(o_t.carrier_freq.numpy(),
                                   np.asarray(o_j.carrier_freq), atol=5e-3)
        np.testing.assert_allclose(o_t.cn0.numpy(), np.asarray(o_j.cn0),
                                   atol=1e-2)
        diff = np.abs(o_t.baseband.numpy().astype(np.int32)
                      - np.asarray(o_j.baseband, np.int32))
        assert diff.max() <= 1, diff.max()


@pytest.mark.parametrize("cn0", [60.0, -999.0], ids=["locked_k1", "cold_k2"])
def test_pm_demod_block_raw_doppler_matches_jax(cn0):
    """A chirping downlink: K1 and K2 fold the de-chirp into their mix
    angle (and K1 rotates the search data by host tables), as the JAX
    kernels do (tests/test_carrier_raw.py doppler case, same bounds)."""
    jcfg = jc.PMConfig(samprate=32768.0, binsize=4.0, search_width=100.0,
                       search_backend="pallas_interpret", doppler_rate=50.0)
    n = jcfg.fftsize
    rng = np.random.default_rng(21)
    data = rng.integers(0, 2, 128) * 2 - 1
    freqs = 2000.0 + 137.0 * np.arange(NCH)
    i = np.arange(n, dtype=np.float64)
    chirp = np.exp(2j * np.pi * (jcfg.doppler_rate / jcfg.samprate**2)
                   * (i * (i + 1) / 2))
    iq = np.stack([
        (pm_signal(n, jcfg.samprate, f, 1.1, data, 32.0, amp=12000)
         + rng.normal(0, 300, n) + 1j * rng.normal(0, 300, n)) * chirp
        for f in freqs
    ])
    raw = _raw_int16(iq)
    carry = jc.PMCarry(search_center=jnp.asarray(freqs, jnp.float32),
                       cn0=jnp.full((NCH,), cn0, jnp.float32))
    c_j, o_j = jc.pm_demod_block_raw(carry, jnp.asarray(raw), jcfg)
    c_t, o_t = tc.pm_demod_block_raw(convert.pm_carry(carry),
                                     torch.from_numpy(raw),
                                     convert.pm_config(jcfg))
    assert np.asarray(o_j.locked).all()
    np.testing.assert_array_equal(o_t.locked.numpy(), np.asarray(o_j.locked))
    np.testing.assert_allclose(o_t.carrier_freq.numpy(),
                               np.asarray(o_j.carrier_freq), atol=5e-3)
    np.testing.assert_allclose(o_t.cn0.numpy(), np.asarray(o_j.cn0), atol=2e-2)
    diff = np.abs(o_t.baseband.numpy().astype(np.int32)
                  - np.asarray(o_j.baseband, np.int32))
    assert diff.max() <= 1, diff.max()
