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
from isee3_decoder_tpu_torch.ops import viterbi, viterbi_acs_cuda
from isee3_decoder_tpu_torch.models import legacy
from isee3_decoder_tpu_torch.ops.encode import encode_bits
from isee3_decoder_tpu_torch.ops.fano import FanoParams, _fano_decode_packed
from isee3_decoder_tpu_torch.utils.devicesignal import (
    random_frames,
    synthesize_iq_device,
    to_raw_int16,
)

pytestmark = pytest.mark.cuda

K7 = CodeSpec("TESTK7", 0o171, 0o133, 7, 0, 0)
K9F = CodeSpec("TESTK9F", 0o713, 0o715, 9, 0, 1)
K15 = CodeSpec("TESTK15", 0o46321, 0o51445, 15, 0, 1)
K18 = CodeSpec("TESTK18", 0o654321, 0o735271, 18, 0, 1)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _raw(dev, B: int, cfg: carrier.PMConfig, seed: int, nblocks: int = 1):
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    frames = torch.as_tensor(random_frames(np.random.default_rng(seed), B),
                             device=dev)[:, None, :]
    freqs = torch.as_tensor(2000.0 + 137.0 * np.arange(B), dtype=torch.float32,
                            device=dev)
    iq = synthesize_iq_device(frames, freqs, gen, nblocks * cfg.fftsize,
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


@pytest.mark.parametrize("code", [K7, K9F, K15, DEFAULT_CODE],
                         ids=["K7", "K9F", "K15", "MCQLI24"])
@pytest.mark.parametrize("dtype", [torch.int16, torch.int32],
                         ids=["int16", "int32"])
def test_k10_step_exact(dev, code, dtype):
    """One K10 step (non-zero adjust) against its plain version: new
    metrics, decision words and the global minimum, bit for bit."""
    B = 3
    gen = torch.Generator(device=dev)
    gen.manual_seed(code.k)
    m = torch.randint(-3000, 9000, (B, code.nstates), generator=gen,
                      device=dev, dtype=torch.int32).to(dtype)
    syms = torch.randint(0, 256, (B, 2), generator=gen, device=dev,
                         dtype=torch.int32)
    adj = torch.randint(0, 600, (B,), generator=gen, device=dev,
                        dtype=torch.int32)
    n0 = _kernels.LAUNCHES["viterbi_acs"]
    got = viterbi_acs_cuda.acs_step(m, syms, adj, code)
    want = viterbi_acs_cuda.acs_step_plain(m, syms, adj, code)
    torch.cuda.synchronize()
    assert _kernels.LAUNCHES["viterbi_acs"] == n0 + 1
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)


@pytest.mark.parametrize("code", [K9F, K15], ids=["K9F", "K15"])
@pytest.mark.parametrize("dtype", [torch.int16, torch.int32],
                         ids=["int16", "int32"])
def test_update_blk_on_the_card_equals_the_cpu(dev, code, dtype):
    """update_blk through K10 (the three rotating minimum buffers, the
    renorm folded in the kernel) on a wrapping tape, in two calls, equals
    the plain update_blk on the CPU: metrics, tape, dp and renorm.  The
    input state's metrics and renorm are left as they were."""
    rng = np.random.default_rng(code.k)
    B, tape = 2, 50
    soft = rng.integers(0, 256, (B, 2 * 70)).astype(np.uint8)
    st_k = viterbi.create(tape, B, code, 5, dtype, device=dev)
    st_p = viterbi.create(tape, B, code, 5, dtype, device="cpu")
    st0, m0, r0 = st_k, st_k.metrics.clone(), st_k.renorm.clone()
    _kernels.reset_launches()
    for part in (soft[:, :80], soft[:, 80:]):
        st_k = viterbi.update_blk(st_k, part, code)
    torch.cuda.synchronize()
    assert torch.equal(st0.metrics, m0) and torch.equal(st0.renorm, r0)
    assert _kernels.LAUNCHES["viterbi_acs"] == 70
    assert _kernels.backend_used == {"viterbi": "cuda", "viterbi_path": "classic"}
    for part in (soft[:, :80], soft[:, 80:]):
        st_p = viterbi.update_blk(st_p, part, code)
    for f in ("metrics", "decisions", "renorm"):
        assert torch.equal(getattr(st_k, f).cpu(), getattr(st_p, f)), f
    assert st_k.dp == st_p.dp == 70 % tape


def test_decode_frame_k10_equals_fused_mcqli24(dev):
    """Four noisy 1024-bit MCQLI-24 frames: the classic decoder through
    K10 gives the fused K5/K6 decoder's bits, and the sent ones."""
    rng = np.random.default_rng(24)
    nbits, B = 1024, 4
    bits = torch.as_tensor(rng.integers(0, 2, (B, nbits)), device=dev)
    bits[:, -(DEFAULT_CODE.k - 1):] = 0
    syms, _ = encode_bits(bits, SYNC_STATE, DEFAULT_CODE)
    noise = torch.as_tensor(rng.normal(0, 60, syms.shape), device=dev)
    soft = torch.clamp(torch.round((syms.double() * 2 - 1) * 100 + noise) + 128,
                       0, 255).to(torch.uint8)
    n0 = _kernels.LAUNCHES["viterbi_acs"]
    got = viterbi.decode_frame(soft, nbits, SYNC_STATE, 0)
    torch.cuda.synchronize()
    assert _kernels.LAUNCHES["viterbi_acs"] == n0 + nbits
    want = viterbi_fused.decode_frame_fused(soft, nbits, SYNC_STATE, 0)
    assert torch.equal(got, want)
    assert torch.equal(got, bits.to(torch.uint8))


def test_vdecode_stream_backends_agree_on_the_card(dev):
    rng = np.random.default_rng(15)
    bits = torch.as_tensor(rng.integers(0, 2, (2, 3000)), device=dev)
    syms, _ = encode_bits(bits, 0, K15)
    noise = torch.as_tensor(rng.normal(0, 50, syms.shape), device=dev)
    soft = torch.clamp(torch.round((syms.double() * 2 - 1) * 100 + noise) + 128,
                       0, 255).to(torch.uint8)
    a = legacy.vdecode_stream(soft, 100, K15, "jnp")
    b = legacy.vdecode_stream(soft, 100, K15, "fused")
    with _kernels.plain_reference():
        c = legacy.vdecode_stream(soft, 100, K15, "jnp")
    for r in (b, c):
        np.testing.assert_array_equal(a.bits, r.bits)
        np.testing.assert_array_equal(a.symbol_errors, r.symbol_errors)
    lag = K15.k - 2
    np.testing.assert_array_equal(a.bits[:, lag:],
                                  bits[:, : a.bits.shape[1] - lag].cpu().numpy())


def test_k10_wrapper_refuses_what_the_kernel_does_not_take(dev):
    def args(code=K15, dtype=torch.int16, B=2, sym_dtype=torch.int32):
        return (torch.zeros((B, code.nstates), dtype=dtype, device=dev),
                torch.zeros((B, 2), dtype=sym_dtype, device=dev),
                torch.zeros(B, dtype=torch.int32, device=dev), code)

    k6 = CodeSpec("TESTK6", 0o75, 0o53, 6, 0, 0)
    with pytest.raises(ValueError, match="7 <= K"):
        viterbi_acs_cuda.acs_step(*args(code=k6))
    with pytest.raises(ValueError, match="int16 or int32"):
        viterbi_acs_cuda.acs_step(*args(dtype=torch.int64))
    with pytest.raises(ValueError, match="syms"):
        viterbi_acs_cuda.acs_step(*args(sym_dtype=torch.int64))
    m, s, a, code = args()
    with pytest.raises(ValueError, match="out"):
        viterbi_acs_cuda.acs_step(m, s, a, code, out=m)
    with pytest.raises(ValueError, match="dec"):
        viterbi_acs_cuda.acs_step(m, s, a, code, dec=torch.zeros(
            (2, 3), dtype=torch.int32, device=dev))
    with pytest.raises(ValueError, match="metrics"):
        viterbi_acs_cuda.acs_step(m[:, :100], s, a, code)


def test_update_blk_raises_when_the_library_fails(dev, monkeypatch):
    """A CUDA state never falls back to the plain step."""
    def broken():
        raise RuntimeError("nvcc failed")

    monkeypatch.setattr(_kernels, "lib", broken)
    st = viterbi.create(8, 1, K15, 0, device=dev)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        viterbi.update_blk(st, np.full(16, 128, np.uint8), K15)


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


@pytest.mark.parametrize("B,binsize,flip", [(5, 8.0, False), (8, 4.0, True)])
def test_k8_matches_plain(dev, B, binsize, flip):
    """K8's bins against the plain einsum form: relative to the largest
    bin within 1e-5 (float32 sums in another order), equal peak bins;
    K8 with its peak pass (one launch) gives the same bins and the plain
    peak's bin and frequency (within 5e-3 Hz)."""
    cfg = carrier.PMConfig(samprate=32768.0, binsize=binsize, search_width=100.0)
    raw, freqs = _raw(dev, B, cfg, seed=B)
    packed = carrier.pack_raw(raw)
    # swapping I and Q mirrors the carriers to -f: search there
    center = -freqs if flip else freqs
    carry = carrier.PMCarry(search_center=center,
                            cn0=torch.full_like(freqs, 60.0))
    first, last = carrier._search_window(carry.search_center, carry.cn0, cfg)
    K = carrier._window_bins(cfg)
    n0 = _kernels.LAUNCHES["windowed_dft"]
    got = carrier_cuda.windowed_dft_raw(packed, first - 1, K, flip)
    torch.cuda.synchronize()
    assert _kernels.LAUNCHES["windowed_dft"] == n0 + 1
    assert _kernels.backend_used["search"] == "cuda"
    want = carrier_cuda.windowed_dft_raw_plain(packed, first - 1, K, flip)
    assert got.shape == (B, K) and got.dtype == torch.complex64
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())
    args = (first - 1, last - first, cfg.actual_binsize, cfg.samprate)
    f_k, pk_k = carrier.windowed_peak(got, *args)
    f_p, pk_p = carrier.windowed_peak(want, *args)
    assert torch.equal(pk_k, pk_p)
    torch.testing.assert_close(f_k, f_p, atol=5e-3, rtol=0)
    s_k, f_s, pk_s = carrier_cuda.windowed_search_raw(
        packed, first - 1, last - first, K, cfg.samprate, cfg.actual_binsize,
        flip)
    torch.cuda.synchronize()
    assert _kernels.LAUNCHES["windowed_dft"] == n0 + 2
    assert torch.equal(s_k, got)
    assert torch.equal(pk_s, pk_p)
    torch.testing.assert_close(f_s, f_p, atol=5e-3, rtol=0)


def _scan_inputs(dev, B: int, T: int, cfg, seed: int, lost: int | None = None):
    raw, _ = _raw(dev, B, cfg, seed, nblocks=T)
    if lost is not None:  # channel `lost` carries nothing after block 0
        n = cfg.fftsize
        raw[lost, 2 * n:] = torch.randint(-300, 300, (2 * (T - 1) * n,),
                                          device=dev, dtype=torch.int16)
    return raw.reshape(B, T, 2 * cfg.fftsize)


@pytest.mark.parametrize("B,T,flip", [(6, 3, False), (9, 4, True)])
def test_k9_matches_plain(dev, B, T, flip):
    """K9 against its plain version from the same cold start: ok lanes
    and locks equal, frequency and centre within 5e-3 Hz, C/N0 within
    1e-2 dB, each baseband sample (the prefix sum's differences) within
    1 LSB, the tail columns holding the totals."""
    cfg = carrier.PMConfig(samprate=32768.0, binsize=4.0, search_width=100.0)
    blocks = _scan_inputs(dev, B, T, cfg, seed=10 + B)
    n = cfg.fftsize
    if flip:  # I and Q swapped in the data, swapped back by flip
        blocks = blocks.view(B, T, n, 2).flip(-1).reshape(B, T, 2 * n)
    carry1, out0 = carrier.pm_demod_block_raw(
        carrier.init_carry(B, cfg, device=dev), blocks[:, 0], cfg, flip=flip)
    init = torch.stack([torch.zeros_like(out0.cn0), out0.cn0,
                        out0.carrier_freq, carry1.search_center], dim=1)
    args = (carrier.pack_raw(blocks), out0.baseband, init,
            cfg.samprate, cfg.actual_binsize, cfg.search_width,
            cfg.cn0_threshold, carrier._window_bins(cfg), flip)
    n0 = _kernels.LAUNCHES["pm_scan"]
    cs_k, st_k, tot_k = carrier_cuda.pm_scan_locked_fused(*args, tail=2)
    torch.cuda.synchronize()
    assert _kernels.LAUNCHES["pm_scan"] == n0 + 1
    cs_p, st_p, tot_p = carrier_cuda.pm_scan_locked_plain(*args, tail=2)
    assert cs_k.shape == (B, T * n + 2) and st_k.shape == (B, T, 6)
    assert bool((st_k[:, 1:, 3] > 0).all())
    assert torch.equal(st_k[..., 3], st_p[..., 3])
    thr = cfg.cn0_threshold
    assert torch.equal(st_k[..., 1] > thr, st_p[..., 1] > thr)
    for lane, tol in ((2, 5e-3), (5, 5e-3), (1, 1e-2)):
        torch.testing.assert_close(st_k[..., lane], st_p[..., lane], atol=tol,
                                   rtol=0)
    bb_k = (cs_k[:, 1 : T * n + 1] - cs_k[:, : T * n]).int()
    bb_p = (cs_p[:, 1 : T * n + 1] - cs_p[:, : T * n]).int()
    assert int((bb_k - bb_p).abs().max()) <= 1
    assert torch.equal(cs_k[:, :n], cs_p[:, :n])  # block 0: exact
    assert torch.equal(cs_k[:, T * n:], tot_k[:, None].expand(B, 2))


def test_k9_fallback_on_the_card(dev):
    """A channel that loses lock after block 0 fails its window in block
    2: pm_demod_scan_csum launches K9 once, discards it, and returns the
    block scan + K3 result exactly."""
    cfg = carrier.PMConfig(samprate=32768.0, binsize=4.0, search_width=100.0)
    B, T = 6, 3
    blocks = _scan_inputs(dev, B, T, cfg, seed=3, lost=2)
    _kernels.reset_launches()
    c, cs, st, tot = carrier.pm_demod_scan_csum(
        carrier.init_carry(B, cfg, device=dev), blocks, cfg, tail=1)
    torch.cuda.synchronize()
    assert _kernels.backend_used["pm_scan"] == "fallback"
    assert _kernels.LAUNCHES["pm_scan"] == 1
    assert _kernels.LAUNCHES["prefix_sum"] == 1
    assert _kernels.LAUNCHES["pm_locked"] + _kernels.LAUNCHES["spin_down"] >= T
    c2, out = carrier.pm_demod_scan(carrier.init_carry(B, cfg, device=dev),
                                    blocks, cfg)
    assert torch.equal(cs, prefix_cuda.prefix_sum_blocks(out.baseband, tail=1))
    assert torch.equal(tot, cs[:, -1])
    assert torch.equal(st.carrier_freq, out.carrier_freq)
    assert not bool(st.locked[1:, 2].any())


def test_k8_k9_wrappers_refuse_what_the_kernels_do_not_take(dev):
    cfg = carrier.PMConfig(samprate=32768.0, binsize=4.0, search_width=100.0)
    B, T, n = 2, 3, cfg.fftsize
    packed = torch.zeros((B, T, n), dtype=torch.int32, device=dev)
    bb0 = torch.zeros((B, n), dtype=torch.int16, device=dev)
    init = torch.zeros((B, 4), dtype=torch.float32, device=dev)
    rest = (32768.0, 4.0, 100.0, 21.0, 53)
    with pytest.raises(ValueError, match="Doppler"):
        carrier_cuda.pm_scan_locked_fused(packed, bb0, init, *rest,
                                          dop=1e-9)
    with pytest.raises(ValueError, match="T >= 2"):
        carrier_cuda.pm_scan_locked_fused(packed[:, :1], bb0, init, *rest)
    with pytest.raises(ValueError, match="int32"):
        carrier_cuda.pm_scan_locked_fused(packed.view(torch.float32), bb0,
                                          init, *rest)
    with pytest.raises(ValueError, match="contiguous"):
        carrier_cuda.pm_scan_locked_fused(packed[:, :, ::2], bb0[:, ::2],
                                          init, *rest)
    with pytest.raises(ValueError, match="bb0"):
        carrier_cuda.pm_scan_locked_fused(packed, bb0.cpu(), init, *rest)
    with pytest.raises(ValueError, match="init"):
        carrier_cuda.pm_scan_locked_fused(packed, bb0, init.double(), *rest)
    first1 = torch.zeros(B, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="int32"):
        carrier_cuda.windowed_dft_raw(bb0, first1, 53)
    with pytest.raises(ValueError, match="contiguous"):
        carrier_cuda.windowed_dft_raw(packed[:, 0, ::2], first1, 53)
    with pytest.raises(ValueError, match="first1"):
        carrier_cuda.windowed_dft_raw(packed[:, 0], first1[:1], 53)
    with pytest.raises(ValueError, match="wlen"):
        carrier_cuda.windowed_search_raw(packed[:, 0], first1, first1[:1], 53,
                                         32768.0, 4.0)
    with pytest.raises(ValueError, match="out of range 3"):
        carrier_cuda.windowed_search_raw(packed[:, 0], first1, first1, 2,
                                         32768.0, 4.0)
