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
from isee3_decoder_tpu_torch.ops.encode import encode_bits
from isee3_decoder_tpu_torch.ops.fano import FanoParams, _fano_decode_packed
from isee3_decoder_tpu_torch.utils.devicesignal import (
    random_frames,
    synthesize_iq_device,
    to_raw_int16,
)

pytestmark = pytest.mark.cuda

K7 = CodeSpec("TESTK7", 0o171, 0o133, 7, 0, 0)


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
