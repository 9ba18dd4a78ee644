"""The port's CUDA kernels against their plain PyTorch versions, on the
card, at small and ragged shapes (chip_smoke.py checks the bench shapes).

Needs an NVIDIA GPU; skipped without one.  The machine with the card has
no JAX, so run this file without tests/conftest.py (which configures
JAX):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from isee3_decoder_tpu_torch import _kernels
from isee3_decoder_tpu_torch.config import CodeSpec, DEFAULT_CODE, SYNC_STATE
from isee3_decoder_tpu_torch.models.decode import DecodeConfig
from isee3_decoder_tpu_torch.ops import carrier, carrier_cuda, prefix_cuda
from isee3_decoder_tpu_torch.ops import channelizer, channelizer_cuda
from isee3_decoder_tpu_torch.ops import viterbi_cuda, viterbi_fused
from isee3_decoder_tpu_torch.ops.encode import encode_bits
from isee3_decoder_tpu_torch.ops.fano import FanoParams, _fano_decode_packed
from isee3_decoder_tpu_torch.utils.devicesignal import (
    random_frames,
    synthesize_iq_device,
    to_raw_int16,
)

pytestmark = pytest.mark.cuda

K7 = CodeSpec("TESTK7", 0o171, 0o133, 7, 0, 0)
K15 = CodeSpec("TESTK15", 0o46321, 0o51445, 15, 0, 1)
K18 = CodeSpec("TESTK18", 0o654321, 0o735271, 18, 0, 1)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _raw(dev, B: int, cfg: carrier.PMConfig, seed: int):
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    frames = torch.as_tensor(random_frames(np.random.default_rng(seed), B),
                             device=dev)[:, None, :]
    freqs = torch.as_tensor(2000.0 + 137.0 * np.arange(B), dtype=torch.float32,
                            device=dev)
    iq = synthesize_iq_device(frames, freqs, gen, cfg.fftsize,
                              samprate=cfg.samprate, symrate=512.0,
                              noise_std=300.0)
    return to_raw_int16(iq), freqs


@pytest.mark.parametrize("B,flip,doppler", [(5, False, 0.0), (8, True, 0.0),
                                             (8, False, 50.0)])
def test_k1_k2_match_plain(dev, B, flip, doppler):
    cfg = carrier.PMConfig(samprate=32768.0, binsize=4.0, search_width=100.0)
    dop = doppler / cfg.samprate**2
    raw, freqs = _raw(dev, B, cfg, seed=B)
    packed = carrier.pack_raw(raw)
    carry = carrier.PMCarry(search_center=freqs, cn0=torch.full_like(freqs, 60.0))
    first, last = carrier._search_window(carry.search_center, carry.cn0, cfg)
    args = (packed, first - 1, last - first, carrier._window_bins(cfg),
            cfg.samprate, cfg.actual_binsize, False, dop)
    n0 = _kernels.LAUNCHES["pm_locked"]
    bb_k, f_k, a_k, c_k = carrier_cuda.pm_locked_fused(*args)
    torch.cuda.synchronize()
    assert _kernels.LAUNCHES["pm_locked"] == n0 + 1
    bb_p, f_p, a_p, c_p = carrier_cuda.pm_locked_plain(*args)
    torch.testing.assert_close(f_k, f_p, atol=5e-3, rtol=0)
    torch.testing.assert_close(a_k, a_p, rtol=1e-5, atol=0)
    torch.testing.assert_close(c_k, c_p, atol=1e-2, rtol=0)
    assert int((bb_k.int() - bb_p.int()).abs().max()) <= 1

    # swapping I and Q mirrors the spectrum: the carrier sits at -f
    f = (-1.0 if flip else 1.0) * (freqs + 0.125)
    bb_k, a_k, c_k = carrier_cuda.spin_down_fused(packed, f, cfg.samprate,
                                                  flip, dop)
    bb_p, a_p, c_p = carrier_cuda.spin_down_plain(packed, f, cfg.samprate,
                                                  flip, dop)
    torch.testing.assert_close(a_k, a_p, rtol=1e-5, atol=0)
    torch.testing.assert_close(c_k, c_p, atol=1e-2, rtol=0)
    assert int((bb_k.int() - bb_p.int()).abs().max()) <= 1


@pytest.mark.parametrize("T,B,n,tail", [(3, 5, 1000, 2), (2, 130, 4096, 0)])
def test_k3_exact(dev, T, B, n, tail):
    gen = torch.Generator(device=dev)
    gen.manual_seed(T * n)
    bb = torch.randint(-32768, 32768, (T, B, n), generator=gen, device=dev,
                       dtype=torch.int32).to(torch.int16)
    assert torch.equal(prefix_cuda.prefix_sum_blocks(bb, tail),
                       prefix_cuda.prefix_sum_blocks_plain(bb, tail))


@pytest.mark.parametrize(
    "code,nbits,lanes,sigma,maxcycles",
    [(K7, 64, 37, 85.0, 6), (DEFAULT_CODE, 1024, 12, 80.0, 3)],
    ids=["K7", "MCQLI24"],
)
def test_k4_exact(dev, code, nbits, lanes, sigma, maxcycles):
    rng = np.random.default_rng(nbits)
    bits = torch.as_tensor(rng.integers(0, 2, (lanes, nbits)), device=dev)
    start = SYNC_STATE & ((1 << (code.k - 1)) - 1)
    syms, _ = encode_bits(bits, start, code)
    noise = torch.as_tensor(rng.normal(0, sigma, syms.shape), device=dev)
    soft = torch.clamp(torch.round((syms.double() * 2 - 1) * 100 + noise) + 128,
                       0, 255).to(torch.uint8)
    mettab = torch.as_tensor(DecodeConfig().mettab(), device=dev)
    skip = torch.as_tensor(rng.random(lanes) < 0.2, device=dev)
    params = FanoParams(32, maxcycles)
    r_k = _fano_decode_packed(soft, mettab, nbits, start, 0, code, params, skip)
    with _kernels.plain_reference():
        r_p = _fano_decode_packed(soft, mettab, nbits, start, 0, code, params,
                                  skip)
    live = ~skip
    for field in ("bits", "goodbits", "metric", "cycles"):
        assert torch.equal(getattr(r_k, field)[live], getattr(r_p, field)[live])
    assert (r_k.goodbits[live] != nbits).any()


def test_wrappers_refuse_what_the_kernels_do_not_take(dev):
    raw = torch.zeros((4, 2 * 1000), dtype=torch.int16, device=dev)
    with pytest.raises(ValueError, match="multiple of 256"):
        carrier_cuda.spin_down_fused(carrier.pack_raw(raw),
                                     torch.zeros(4, device=dev), 32768.0)
    with pytest.raises(ValueError, match="int16"):
        prefix_cuda.prefix_sum_blocks(torch.zeros((1, 2, 8), dtype=torch.int32,
                                                  device=dev))


@pytest.mark.parametrize("code", [K15, K18, DEFAULT_CODE],
                         ids=["K15", "K18", "MCQLI24"])
def test_k5_k6_one_cycle_exact(dev, code):
    """One whole cycle through K5 (with a non-zero base) and K6 against
    the plain versions: metrics, decision words and per-row minima."""
    w, rowb, _ = viterbi_cuda._geometry(code)
    B = 2
    gen = torch.Generator(device=dev)
    gen.manual_seed(code.k)
    m0 = torch.randint(0, 12000, (B, code.nstates), generator=gen, device=dev,
                       dtype=torch.int32).to(torch.int16)
    syms = torch.randint(0, 256, (B, 2 * w), generator=gen, device=dev,
                         dtype=torch.int32)
    base = torch.randint(0, 600, (B,), generator=gen, device=dev,
                         dtype=torch.int32)
    sa, sb = syms[:, : 2 * rowb].contiguous(), syms[:, 2 * rowb :].contiguous()
    mk, mp = m0.clone(), m0.clone()
    na = _kernels.LAUNCHES["viterbi_a"]
    _, dk = viterbi_cuda.cycle_a(mk, sa, code, rowb, base)
    _, dp = viterbi_cuda.cycle_a_plain(mp, sa, code, rowb, base)
    torch.cuda.synchronize()
    assert _kernels.LAUNCHES["viterbi_a"] == na + 1
    assert torch.equal(mk, mp) and torch.equal(dk, dp)
    _, dk, nk = viterbi_cuda.cycle_b(mk, sb, code, w - rowb)
    _, dp, np_ = viterbi_cuda.cycle_b_plain(mp, sb, code, w - rowb)
    torch.cuda.synchronize()
    assert torch.equal(mk, mp) and torch.equal(dk, dp) and torch.equal(nk, np_)


def test_decode_frame_fused_kernels_exact(dev):
    """A full 1024-bit K18 frame batch: bits through K5/K6 equal the
    plain path's, and the decoder recovers the sent bits."""
    rng = np.random.default_rng(18)
    nbits, B = 1024, 3
    bits = torch.as_tensor(rng.integers(0, 2, (B, nbits)), device=dev)
    bits[:, -(K18.k - 1):] = 0
    syms, _ = encode_bits(bits, 0, K18)
    noise = torch.as_tensor(rng.normal(0, 60, syms.shape), device=dev)
    soft = torch.clamp(torch.round((syms.double() * 2 - 1) * 100 + noise) + 128,
                       0, 255).to(torch.uint8)
    got = viterbi_fused.decode_frame_fused(soft, nbits, 0, 0, K18)
    with _kernels.plain_reference():
        want = viterbi_fused.decode_frame_fused(soft, nbits, 0, 0, K18)
    assert torch.equal(got, want)
    assert torch.equal(got, bits.to(torch.uint8))


def test_viterbi_wrappers_refuse_what_the_kernels_do_not_take(dev):
    m = torch.zeros((1, K15.nstates), dtype=torch.int16, device=dev)
    with pytest.raises(ValueError, match="syms"):
        viterbi_cuda.cycle_a(m, torch.zeros((1, 2), dtype=torch.int64,
                                            device=dev), K15, 1)
    with pytest.raises(ValueError, match="nsteps"):
        viterbi_cuda.cycle_b(m, torch.zeros((1, 2 * 14), dtype=torch.int32,
                                            device=dev), K15, 14)


def _packed(dev, nwords: int, seed: int, lo: int = -20000, hi: int = 20000):
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    iq = torch.randint(lo, hi, (2, nwords), generator=gen, device=dev,
                       dtype=torch.int32)
    return (iq[0] & 0xFFFF) | (iq[1] << 16)


def _assert_raw_close(got: torch.Tensor, want: torch.Tensor) -> None:
    """At most 1 LSB apart on under 1 % of the samples: float32 rounding
    at truncation boundaries (the kernel's FFT and the library's sum in
    other orders)."""
    assert got.shape == want.shape and got.dtype == want.dtype == torch.int16
    d = (got.int() - want.int()).abs()
    assert int(d.max()) <= 1
    assert float((d > 0).float().mean()) < 0.01


@pytest.mark.parametrize(
    "nchan,oversample,nframes,extra",
    [(128, 1, 3 * 64 + 7, 0),  # whole tiles
     (128, 1, 1000, 3),  # partial last tile, partial last frame
     (128, 2, 1001, 70),
     (64, 1, 777, 0),
     (256, 2, 300, 5),
     (32, 2, 515, 0)],
)
def test_k7_matches_plain(dev, nchan, oversample, nframes, extra):
    packed = _packed(dev, nframes * nchan + extra, seed=nframes)
    name = "channelize" if oversample == 1 else "channelize2"
    n0 = _kernels.LAUNCHES[name]
    got = channelizer_cuda.channelize_raw_fused(packed, nchan, 8,
                                                oversample=oversample)
    torch.cuda.synchronize()
    assert _kernels.LAUNCHES[name] == n0 + 1
    assert _kernels.backend_used["channelizer"] == "cuda"
    want = channelizer_cuda.channelize_raw_plain(packed, nchan, 8,
                                                 oversample=oversample)
    # the odd stream gains a frame when half a frame or more trails
    nout = (nframes - 8 + 1 if oversample == 1
            else 2 * (nframes - 8 + (extra >= nchan // 2)))
    assert tuple(got.shape) == (nchan, 2 * nout)
    _assert_raw_close(got, want)
    with _kernels.plain_reference():
        again = channelizer_cuda.channelize_raw_fused(packed, nchan, 8,
                                                      oversample=oversample)
    assert torch.equal(again, want)
    assert _kernels.LAUNCHES[name] == n0 + 1


@pytest.mark.parametrize("oversample", [1, 2])
def test_k7_saturates_like_plain(dev, oversample):
    """Full-scale input through taps of gain 4: both clip at ±32767, never
    at −32768, and never wrap."""
    nchan, P = 128, 8
    taps = 4.0 * channelizer.default_taps(nchan, P, oversample)
    for lo, hi, want0 in ((32000, 32768, 32767), (-32767, -32000, -32767)):
        packed = _packed(dev, 300 * nchan, seed=1, lo=lo, hi=hi)
        got = channelizer_cuda.channelize_raw_fused(packed, nchan, P, taps,
                                                    oversample)
        want = channelizer_cuda.channelize_raw_plain(packed, nchan, P, taps,
                                                     oversample)
        _assert_raw_close(got, want)
        assert bool((got[0, 0::2] == want0).all())
        assert int(got.min()) >= -32767


def test_k7_other_tap_counts(dev):
    """taps_per_branch other than 8, with a prototype of the caller's."""
    nchan, P = 64, 5
    rng = np.random.default_rng(0)
    taps = (rng.normal(0, 0.05, nchan * P)).astype(np.float32)
    packed = _packed(dev, 400 * nchan, seed=2)
    got = channelizer_cuda.channelize_raw_fused(packed, nchan, P, taps)
    want = channelizer_cuda.channelize_raw_plain(packed, nchan, P, taps)
    _assert_raw_close(got, want)


def test_k7_wrapper_refuses_what_the_kernel_does_not_take(dev):
    words = torch.zeros(2 * 128 * 100, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="power of two"):
        channelizer_cuda.channelize_raw_fused(words, 96)
    with pytest.raises(ValueError, match="contiguous"):
        channelizer_cuda.channelize_raw_fused(words[::2], 128)
    with pytest.raises(ValueError, match="shared memory"):
        channelizer_cuda.channelize_raw_fused(words, 256, 100)
    with pytest.raises(ValueError, match="taps must have"):
        channelizer_cuda.channelize_raw_fused(words, 128, 8,
                                              np.zeros(100, np.float32))
