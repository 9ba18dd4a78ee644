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
from isee3_decoder_tpu_torch.config import CODES, CodeSpec, DEFAULT_CODE, SYNC_STATE
from isee3_decoder_tpu_torch.models.decode import DecodeConfig
from isee3_decoder_tpu_torch.ops import carrier, carrier_cuda, fano_cuda
from isee3_decoder_tpu_torch.ops import prefix_cuda
from isee3_decoder_tpu_torch.ops import channelizer, channelizer_cuda
from isee3_decoder_tpu_torch.ops import viterbi_cuda, viterbi_fused
from isee3_decoder_tpu_torch.ops import viterbi, viterbi_acs_cuda, viterbi_inplace
from isee3_decoder_tpu_torch.models import legacy
from isee3_decoder_tpu_torch.ops.encode import encode_bits
from isee3_decoder_tpu_torch.ops.fano import (
    FanoParams,
    _fano_decode_packed,
    _walk_inputs,
    fano_decode,
)
from isee3_decoder_tpu_torch.parallel import decode_frame_sharded, make_mesh
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
K14 = CodeSpec("TESTK14", 0o21645, 0o35661, 14, 0, 1)
# the largest metric K6 is given: a cycle starts within the (K-1)*510
# spread above the subtracted minimum and K5's 8 row steps add at most
# 510 each, at K = 24
K6_TOP = 23 * 510 + 8 * 510


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


@pytest.mark.parametrize("spin", ["cluster", "two_pass"])
@pytest.mark.parametrize("samprate,binsize,B,flip,doppler,design", [
    (32768.0, 4.0, 5, False, 0.0, "columns"),     # n = 8192
    (32768.0, 4.0, 8, True, 0.0, "columns"),
    (32768.0, 4.0, 8, False, 50.0, "columns"),
    (250000.0, 4.0, 133, True, -30.0, "columns"),  # n = 65,536, 133 > 132 SMs
    (32768.0, 8.0, 7, False, 50.0, "direct"),      # n = 4096
    (32768.0, 8.0, 6, True, -40.0, "direct"),
])
def test_k1_k2_match_plain(dev, samprate, binsize, B, flip, doppler, design,
                           spin):
    """K1 and K2 on both spin-down designs ("cluster", one cluster of
    blocks per row, and "two_pass"), pinned as fano_walk(design=...) is,
    against their plain versions; B = 133 at n = 65,536 gives more
    clusters than the card holds at once."""
    cfg = carrier.PMConfig(samprate=samprate, binsize=binsize,
                           search_width=100.0)
    dop = doppler / cfg.samprate**2
    raw, freqs = _raw(dev, B, cfg, seed=B)
    packed = carrier.pack_raw(raw)
    # swapping I and Q mirrors the spectrum: the carrier sits at -f
    f = (-1.0 if flip else 1.0) * freqs
    carry = carrier.PMCarry(search_center=f, cn0=torch.full_like(f, 60.0))
    first, last = carrier._search_window(carry.search_center, carry.cn0, cfg)
    K = carrier._window_bins(cfg)
    args = (packed, first - 1, last - first, K, cfg.samprate,
            cfg.actual_binsize, flip, dop)
    n0 = _kernels.LAUNCHES["pm_locked"]
    bb_k, f_k, a_k, c_k = carrier_cuda.pm_locked_fused(*args, spin_design=spin)
    torch.cuda.synchronize()
    assert _kernels.LAUNCHES["pm_locked"] == n0 + 1
    assert _kernels.backend_used["pm_locked"] == design
    assert _kernels.backend_used["spin"] == spin
    assert carrier_cuda.pm_locked_plan(cfg.fftsize, K)["design"] == design
    bb_p, f_p, a_p, c_p = carrier_cuda.pm_locked_plain(*args)
    torch.testing.assert_close(f_k, f_p, atol=5e-3, rtol=0)
    torch.testing.assert_close(a_k, a_p, rtol=1e-5, atol=0)
    torch.testing.assert_close(c_k, c_p, atol=1e-2, rtol=0)
    assert int((bb_k.int() - bb_p.int()).abs().max()) <= 1

    f = (-1.0 if flip else 1.0) * (freqs + 0.125)
    n0 = _kernels.LAUNCHES["spin_down"]
    bb_k, a_k, c_k = carrier_cuda.spin_down_fused(packed, f, cfg.samprate,
                                                  flip, dop, design=spin)
    torch.cuda.synchronize()
    assert _kernels.LAUNCHES["spin_down"] == n0 + 1
    assert _kernels.backend_used["spin"] == spin
    bb_p, a_p, c_p = carrier_cuda.spin_down_plain(packed, f, cfg.samprate,
                                                  flip, dop)
    torch.testing.assert_close(a_k, a_p, rtol=1e-5, atol=0)
    torch.testing.assert_close(c_k, c_p, atol=1e-2, rtol=0)
    assert int((bb_k.int() - bb_p.int()).abs().max()) <= 1


@pytest.mark.parametrize("dop", [0.0, 40.0 / 32768.0**2])
def test_k1_windows_that_wrap_match_plain(dev, dop):
    """Carriers next to 0 Hz, searched by windows that start below bin 0
    or run past bin n (the "columns" design takes bins mod n): the same
    peak, frequency, amplitude, C/N0 and baseband as the plain version."""
    cfg = carrier.PMConfig(samprate=32768.0, binsize=4.0, search_width=100.0)
    n, K = cfg.fftsize, 53
    gen = torch.Generator(device=dev)
    gen.manual_seed(17)
    frames = torch.as_tensor(random_frames(np.random.default_rng(17), 4),
                             device=dev)[:, None, :]
    freqs = torch.tensor([6.0, -9.0, 20.0, -30.0], device=dev)
    raw = to_raw_int16(synthesize_iq_device(frames, freqs, gen, n,
                                            samprate=cfg.samprate,
                                            symrate=512.0, noise_std=300.0))
    first1 = torch.tensor([-20, n - 30, -10, n - 40], device=dev)
    wlen = torch.full((4,), K - 2, device=dev)
    args = (carrier.pack_raw(raw), first1, wlen, K, cfg.samprate,
            cfg.actual_binsize, False, dop)
    bb_k, f_k, a_k, c_k = carrier_cuda.pm_locked_fused(*args)
    torch.cuda.synchronize()
    assert _kernels.backend_used["pm_locked"] == "columns"
    bb_p, f_p, a_p, c_p = carrier_cuda.pm_locked_plain(*args)
    torch.testing.assert_close(f_k, f_p, atol=5e-3, rtol=0)
    # found the carriers (the de-chirp of an unchirped tone spreads it)
    assert float((f_p - freqs).abs().max()) < (8.0 if dop else 2.0)
    torch.testing.assert_close(a_k, a_p, rtol=1e-5, atol=0)
    torch.testing.assert_close(c_k, c_p, atol=1e-2, rtol=0)
    assert int((bb_k.int() - bb_p.int()).abs().max()) <= 1


@pytest.mark.parametrize("n", [4096, 8192, 12288, 65536, 131072])
def test_k1_wrapper_reports_the_plans_design(dev, n):
    """The designs pm_locked_fused records (backend_used["pm_locked"] and
    ["spin"]) are the ones pm_locked_plan and spin_plan pick for the
    shape."""
    B, K = 3, 53
    raw = torch.randint(-3000, 3000, (B, 2 * n), device=dev,
                        dtype=torch.int32).to(torch.int16)
    first1 = torch.full((B,), 100, device=dev)
    carrier_cuda.pm_locked_fused(carrier.pack_raw(raw), first1,
                                 torch.full((B,), K - 2, device=dev), K,
                                 32768.0, 32768.0 / n)
    torch.cuda.synchronize()
    want = "columns" if n % 8192 == 0 else "direct"
    assert carrier_cuda.pm_locked_plan(n, K)["design"] == want
    assert _kernels.backend_used["pm_locked"] == want
    spin = "cluster" if n <= 65536 else "two_pass"
    assert carrier_cuda.spin_plan(n, B)["design"] == spin
    assert _kernels.backend_used["spin"] == spin


@pytest.mark.parametrize("n", [256, 4096, 8192, 12288, 65536, 65792, 131072])
def test_k2_wrapper_reports_the_plans_design(dev, n):
    """The spin-down design spin_down_fused records (backend_used["spin"])
    is the one spin_plan picks for the shape, and the result is the plain
    version's."""
    B = 3
    raw = torch.randint(-3000, 3000, (B, 2 * n), device=dev,
                        dtype=torch.int32).to(torch.int16)
    packed = carrier.pack_raw(raw)
    f = torch.tensor([100.0, -2500.5, 7000.25], device=dev)
    bb_k, a_k, c_k = carrier_cuda.spin_down_fused(packed, f, 32768.0)
    torch.cuda.synchronize()
    want = "cluster" if n <= 65536 else "two_pass"
    assert carrier_cuda.spin_plan(n, B)["design"] == want
    assert _kernels.backend_used["spin"] == want
    bb_p, a_p, c_p = carrier_cuda.spin_down_plain(packed, f, 32768.0)
    torch.testing.assert_close(a_k, a_p, rtol=1e-5, atol=0)
    torch.testing.assert_close(c_k, c_p, atol=1e-2, rtol=0)
    assert int((bb_k.int() - bb_p.int()).abs().max()) <= 1


@pytest.mark.parametrize("samprate,binsize", [(250000.0, 4.0),
                                              (32768.0, 8.0)])
def test_k1_k2_unaligned_rows_match_plain(dev, samprate, binsize):
    """Rows of a strided view that are not 16-byte aligned (row stride n +
    1 words, first row at word 1): the spin-down takes 4-byte loads and
    2-byte stores there, and gives the plain version's result."""
    cfg = carrier.PMConfig(samprate=samprate, binsize=binsize,
                           search_width=100.0)
    B, n = 6, cfg.fftsize
    raw, freqs = _raw(dev, B, cfg, seed=31)
    packed = carrier.pack_raw(raw)
    buf = torch.zeros((B, n + 1), dtype=torch.int32, device=dev)
    buf[:, 1:] = packed
    view = buf[:, 1:]
    assert view.data_ptr() % 16 != 0 and view.stride(0) % 4 != 0
    f = freqs + 0.125
    bb_k, a_k, c_k = carrier_cuda.spin_down_fused(view, f, cfg.samprate)
    torch.cuda.synchronize()
    assert _kernels.backend_used["spin"] == "cluster"
    bb_p, a_p, c_p = carrier_cuda.spin_down_plain(packed, f, cfg.samprate)
    torch.testing.assert_close(a_k, a_p, rtol=1e-5, atol=0)
    torch.testing.assert_close(c_k, c_p, atol=1e-2, rtol=0)
    assert int((bb_k.int() - bb_p.int()).abs().max()) <= 1
    carry = carrier.PMCarry(search_center=freqs,
                            cn0=torch.full_like(freqs, 60.0))
    first, last = carrier._search_window(carry.search_center, carry.cn0, cfg)
    K = carrier._window_bins(cfg)
    rest = (first - 1, last - first, K, cfg.samprate, cfg.actual_binsize)
    bb_k, f_k, a_k, c_k = carrier_cuda.pm_locked_fused(view, *rest)
    torch.cuda.synchronize()
    bb_p, f_p, a_p, c_p = carrier_cuda.pm_locked_plain(packed, *rest)
    torch.testing.assert_close(f_k, f_p, atol=5e-3, rtol=0)
    torch.testing.assert_close(a_k, a_p, rtol=1e-5, atol=0)
    torch.testing.assert_close(c_k, c_p, atol=1e-2, rtol=0)
    assert int((bb_k.int() - bb_p.int()).abs().max()) <= 1


def test_k1_k2_cluster_design_is_deterministic(dev):
    """Two calls give the same bits: the moments are summed in a fixed
    order (threads, warps, then the cluster's ranks in rank order), no
    atomics."""
    cfg = carrier.PMConfig(samprate=250000.0, binsize=4.0, search_width=100.0)
    raw, freqs = _raw(dev, 16, cfg, seed=41)
    packed = carrier.pack_raw(raw)
    dop = -30.0 / cfg.samprate**2
    runs = [carrier_cuda.spin_down_fused(packed, freqs + 0.125, cfg.samprate,
                                         True, dop) for _ in range(2)]
    assert _kernels.backend_used["spin"] == "cluster"
    for a, b in zip(*runs):
        assert torch.equal(a, b)
    carry = carrier.PMCarry(search_center=freqs,
                            cn0=torch.full_like(freqs, 60.0))
    first, last = carrier._search_window(carry.search_center, carry.cn0, cfg)
    args = (packed, first - 1, last - first, carrier._window_bins(cfg),
            cfg.samprate, cfg.actual_binsize)
    runs = [carrier_cuda.pm_locked_fused(*args) for _ in range(2)]
    for a, b in zip(*runs):
        assert torch.equal(a, b)


def test_k2_refuses_a_pinned_design_it_cannot_run(dev):
    raw = torch.zeros((2, 2 * 131072), dtype=torch.int16, device=dev)
    with pytest.raises(ValueError, match="at most 65536"):
        carrier_cuda.spin_down_fused(carrier.pack_raw(raw),
                                     torch.zeros(2, device=dev), 32768.0,
                                     design="cluster")


def _k3_input(dev, T, B, n, seed=None):
    gen = torch.Generator(device=dev)
    gen.manual_seed(T * n if seed is None else seed)
    return torch.randint(-32768, 32768, (T, B, n), generator=gen, device=dev,
                         dtype=torch.int32).to(torch.int16)


# 16-byte loads (n % 8 == 0) and 2-byte ones; one tile a row and many
# (67 x 4096: a tile spans two pm blocks, 34 tiles a row, look-backs past
# 32 predecessors at B = 1); every row phase of the output (tail 0, 1, 3)
@pytest.mark.parametrize("T,B,n,tail", [
    (3, 5, 1000, 2), (2, 130, 4096, 0), (1, 1, 1, 0), (1, 3, 7, 1),
    (67, 1, 1000, 1), (3, 130, 1001, 3), (67, 5, 4096, 1), (3, 1, 8195, 0),
    (1, 130, 8195, 3), (67, 1, 4096, 0), (32, 3, 65536, 1)])
def test_k3_exact(dev, T, B, n, tail):
    bb = _k3_input(dev, T, B, n)
    assert torch.equal(prefix_cuda.prefix_sum_blocks(bb, tail),
                       prefix_cuda.prefix_sum_blocks_plain(bb, tail))


@pytest.mark.parametrize("T,B,n,tail", [(3, 2, 32768, 1), (1, 3, 100_001, 2)])
def test_k3_exact_where_int32_wraps(dev, T, B, n, tail):
    # a run of 32767s long enough that the sums pass 2^31 and wrap
    bb = torch.full((T, B, n), 32767, dtype=torch.int16, device=dev)
    bb[:, 1:] = _k3_input(dev, T, B - 1, n).clamp(min=30000)
    got = prefix_cuda.prefix_sum_blocks(bb, tail)
    assert int(got[0, -1]) < 0  # wrapped
    assert torch.equal(got, prefix_cuda.prefix_sum_blocks_plain(bb, tail))


def test_k3_input_views_and_flat(dev):
    # an input at an offset of 2 bytes takes the 2-byte loads, one at 16
    # the 16-byte ones; prefix_sum_flat is one pm block of L samples
    base = _k3_input(dev, 1, 1, 3 * 5 * 4096 + 8)
    for off in (1, 8):
        bb = base.reshape(-1)[off:off + 3 * 5 * 4096].view(3, 5, 4096)
        assert torch.equal(prefix_cuda.prefix_sum_blocks(bb, 1),
                           prefix_cuda.prefix_sum_blocks_plain(bb, 1))
    flat = _k3_input(dev, 1, 16, 20_000)[0]
    assert torch.equal(prefix_cuda.prefix_sum_flat(flat),
                       prefix_cuda.prefix_sum_blocks_plain(flat[None]))


def test_k3_calls_in_a_row_and_on_two_streams(dev):
    # every call clears its own workspace: a second call, and calls on two
    # streams at once, never read another call's status words
    a = _k3_input(dev, 32, 128, 4096, seed=1)
    b = _k3_input(dev, 67, 64, 4096, seed=2)
    want_a = prefix_cuda.prefix_sum_blocks_plain(a, 1)
    want_b = prefix_cuda.prefix_sum_blocks_plain(b, 1)
    for _ in range(2):
        assert torch.equal(prefix_cuda.prefix_sum_blocks(a, 1), want_a)
        assert torch.equal(prefix_cuda.prefix_sum_blocks(b, 1), want_b)
    s1, s2 = torch.cuda.Stream(dev), torch.cuda.Stream(dev)
    torch.cuda.synchronize(dev)
    outs = []
    for _ in range(3):
        with torch.cuda.stream(s1):
            outs.append((prefix_cuda.prefix_sum_blocks(a, 1), want_a))
        with torch.cuda.stream(s2):
            outs.append((prefix_cuda.prefix_sum_blocks(b, 1), want_b))
    torch.cuda.synchronize(dev)
    for got, want in outs:
        assert torch.equal(got, want)


# K4 cases: code, nbits, lanes, sigma, cycles/bit, share of lanes skipped
# (decoded by a cheaper tier), whether the data ends in the zero tail the
# walk forces (else no lane can finish and every live lane times out)
K4_CASES = {
    "K7": (K7, 64, 37, 85.0, 6, 0.2, False),
    "MCQLI24": (DEFAULT_CODE, 1024, 12, 80.0, 3, 0.2, False),
    # the full budget: some lanes decode after thousands of steps, others
    # walk all 12,800
    "full-budget": (DEFAULT_CODE, 128, 8, 95.0, 100, 0.2, True),
    # 137 lanes: 2 a block on 132 SMs, the last block half empty
    "ragged": (K7, 64, 137, 85.0, 6, 0.2, False),
    "all-skipped": (K7, 64, 5, 85.0, 6, 1.0, False),
    # a lane too long for shared memory: the plan picks "thread"
    "long": (K7, 7300, 3, 40.0, 1, 0.0, False),
}
_K4_PLAIN: dict = {}


def _k4_case(dev, name):
    """(code, maxcycles, metrics4, regs, skip, plain bits, plain stats) of
    a K4 case; the plain walk runs once per case."""
    code, nbits, lanes, sigma, maxcycles, pskip, tail = K4_CASES[name]
    rng = np.random.default_rng(nbits + lanes)
    bits = torch.as_tensor(rng.integers(0, 2, (lanes, nbits)), device=dev)
    if tail:
        bits[:, nbits - code.k + 1:] = 0
    start = SYNC_STATE & ((1 << (code.k - 1)) - 1)
    syms, _ = encode_bits(bits, start, code)
    noise = torch.as_tensor(rng.normal(0, sigma, syms.shape), device=dev)
    soft = torch.clamp(torch.round((syms.double() * 2 - 1) * 100 + noise) + 128,
                       0, 255).to(torch.uint8)
    mettab = torch.as_tensor(DecodeConfig().mettab(), device=dev)
    skip = torch.as_tensor(rng.random(lanes) < pskip, device=dev)
    m4, regs = _walk_inputs(soft, mettab, nbits, start, 0, code, skip)
    if name not in _K4_PLAIN:
        _K4_PLAIN[name] = fano_cuda.fano_walk_plain(m4, regs, code, 32,
                                                    maxcycles)
    return (code, maxcycles, m4, regs, skip, *_K4_PLAIN[name])


@pytest.mark.parametrize("design", ["warp", "thread"])
@pytest.mark.parametrize("case", list(K4_CASES))
def test_k4_exact(dev, case, design):
    """Both designs give the plain walk's bits and [np, gamma, cycles, t]
    on every lane, skipped ones included; "warp" pinned where a lane
    does not fit in shared memory raises."""
    code, maxcycles, m4, regs, skip, bits_p, st_p = _k4_case(dev, case)
    B, N, _ = m4.shape
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    if design == "warp" and fano_cuda.fano_walk_plan(
            B, N, code, maxcycles, sms=sms)["design"] == "thread":
        with pytest.raises(ValueError, match="shared memory"):
            fano_cuda.fano_walk(m4, regs, code, 32, maxcycles, design)
        return
    n0 = _kernels.LAUNCHES["fano_walk"]
    bits_k, st_k = fano_cuda.fano_walk(m4, regs, code, 32, maxcycles, design)
    torch.cuda.synchronize()
    assert _kernels.LAUNCHES["fano_walk"] == n0 + 1
    assert _kernels.backend_used["fano_walk"] == design
    assert torch.equal(bits_k, bits_p)
    assert torch.equal(st_k, st_p)
    if case == "all-skipped":
        assert bool(skip.all()) and not bool(st_k.any())
    else:
        live = ~skip
        assert (st_k[live, 0] + 1 != N).any()  # a live lane timed out
    if case == "full-budget":
        assert (st_k[~skip, 0] + 1 == N).any()  # and one decoded
    if case == "ragged" and design == "warp":
        plan = fano_cuda.fano_walk_plan(B, N, code, maxcycles, sms=sms)
        assert B % plan["lanes"] != 0


@pytest.mark.parametrize("code,nbits,lanes,sigma,maxcycles", [
    (K7, 64, 37, 85.0, 6), (DEFAULT_CODE, 1024, 12, 80.0, 3),
], ids=["K7", "MCQLI24"])
def test_k4_decode_matches_plain(dev, code, nbits, lanes, sigma, maxcycles):
    """The decoder around K4 (``_fano_decode_packed``: root setup, walk,
    the bytes decode.c copies out) on the card == under plain_reference()."""
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
    assert _kernels.backend_used["fano_walk"] == "warp"
    with _kernels.plain_reference():
        r_p = _fano_decode_packed(soft, mettab, nbits, start, 0, code, params,
                                  skip)
    live = ~skip
    for field in ("bits", "goodbits", "metric", "cycles"):
        assert torch.equal(getattr(r_k, field)[live], getattr(r_p, field)[live])
    assert (r_k.goodbits[live] != nbits).any()


@pytest.mark.parametrize("design", ["warp", "thread"])
@pytest.mark.parametrize("name,nbits,lanes,sigma,maxcycles", [
    ("MCQLI32", 256, 37, 80.0, 3),  # 37 lanes: a ragged last block
    ("J50", 128, 20, 75.0, 4),
    ("J60", 1024, 8, 70.0, 2),
    ("BLLF47", 5811, 3, 70.0, 1),  # one lane too long for shared memory
])
def test_k4_wide_exact(dev, name, nbits, lanes, sigma, maxcycles, design):
    """K4's wide variant (64-bit state word) on both designs == its plain
    twin (the step-by-step int64 walk) on every lane, skipped ones
    included; each launch counts as a fano_walk launch and records
    "warp64" / "thread64"; "warp" pinned where a lane does not fit
    raises."""
    code = CODES[name]
    rng = np.random.default_rng(nbits + lanes)
    tail = int(rng.integers(0, 1 << (code.k - 1)))
    bits = torch.as_tensor(rng.integers(0, 2, (lanes, nbits)), device=dev)
    for j in range(code.k - 1):
        bits[:, nbits - 1 - j] = (tail >> j) & 1
    syms, _ = encode_bits(bits, 0x2A, code)
    noise = torch.as_tensor(rng.normal(0, sigma, syms.shape), device=dev)
    soft = torch.clamp(torch.round((syms.double() * 2 - 1) * 100 + noise) + 128,
                       0, 255).to(torch.uint8)
    mettab = torch.as_tensor(DecodeConfig().mettab(), device=dev)
    skip = torch.as_tensor(rng.random(lanes) < 0.15, device=dev)
    m4, regs = _walk_inputs(soft, mettab, nbits, 0x2A, tail, code, skip)
    assert regs.dtype == torch.int64
    fits = fano_cuda.lane_bytes(nbits, fano_cuda.WIDE_RECORD_BYTES) <= 232_448
    if design == "warp" and not fits:
        with pytest.raises(ValueError, match="shared memory"):
            fano_cuda.fano_walk_wide(m4, regs, code, 32, maxcycles, design)
        return
    n0 = _kernels.LAUNCHES["fano_walk"]
    bits_k, st_k = fano_cuda.fano_walk_wide(m4, regs, code, 32, maxcycles,
                                            design)
    torch.cuda.synchronize()
    assert _kernels.LAUNCHES["fano_walk"] == n0 + 1
    assert _kernels.backend_used["fano_walk"] == design + "64"
    bits_p, st_p = fano_cuda.fano_walk_wide_plain(m4, regs, code, 32,
                                                  maxcycles)
    assert torch.equal(bits_k, bits_p)
    assert torch.equal(st_k, st_p)


def test_k4_wide_decode_matches_plain(dev):
    """fano_decode on J60 frames (root setup, the wide walk, the bytes
    decode.c copies out) on the card == under plain_reference(), and the
    decoded frames are the ones sent."""
    code = CODES["J60"]
    rng = np.random.default_rng(60)
    nbits, lanes, tail = 512, 16, 0x155AA55AA55AA
    bits = torch.as_tensor(rng.integers(0, 2, (lanes, nbits)), device=dev)
    for j in range(code.k - 1):
        bits[:, nbits - 1 - j] = (tail >> j) & 1
    syms, _ = encode_bits(bits, 7, code)
    noise = torch.as_tensor(rng.normal(0, 65, syms.shape), device=dev)
    soft = torch.clamp(torch.round((syms.double() * 2 - 1) * 100 + noise) + 128,
                       0, 255).to(torch.uint8)
    mettab = torch.as_tensor(DecodeConfig().mettab(), device=dev)
    params = FanoParams(32, 4)
    r_k = fano_decode(soft, mettab, nbits, 7, tail, code, params)
    assert _kernels.backend_used["fano_walk"] == "warp64"
    with _kernels.plain_reference():
        r_p = fano_decode(soft, mettab, nbits, 7, tail, code, params)
    for field in ("bits", "goodbits", "metric", "cycles"):
        assert torch.equal(getattr(r_k, field), getattr(r_p, field))
    good = r_k.goodbits == nbits
    assert good.any()
    assert torch.equal(r_k.bits[good], bits[good].to(torch.uint8))


def test_sharded_viterbi_on_logical_shards_of_the_card(dev):
    """decode_frame_sharded on (1, 4) and (2, 2) meshes of cuda:0 ==
    ops/viterbi.decode_frame (K10) at K = 18."""
    rng = np.random.default_rng(18)
    nbits, B = 200, 2
    bits = torch.as_tensor(rng.integers(0, 2, (B, nbits)), device=dev)
    bits[:, -(K18.k - 1):] = 0
    syms, _ = encode_bits(bits, 0, K18)
    noise = torch.as_tensor(rng.normal(0, 55, syms.shape), device=dev)
    soft = torch.clamp(torch.round((syms.double() * 2 - 1) * 100 + noise) + 128,
                       0, 255).to(torch.uint8)
    want = viterbi.decode_frame(soft, nbits, 0, 0, K18)
    for ch, st in ((1, 4), (2, 2)):
        mesh = make_mesh(ch, st, devices=[dev] * (ch * st))
        got = decode_frame_sharded(soft, mesh, nbits, 0, 0, K18)
        assert got.device == dev
        assert torch.equal(got, want)


@pytest.mark.parametrize("nbits", [64, 1024, 7263, 7264])
def test_k4_wrapper_reports_the_plans_design(dev, nbits):
    """The design fano_walk records (backend_used["fano_walk"]) is the one
    fano_walk_plan picks for the shape."""
    B = 3
    gen = torch.Generator(device=dev)
    gen.manual_seed(nbits)
    m4 = torch.randint(-40, 8, (B, nbits, 4), generator=gen, device=dev,
                       dtype=torch.int32)
    regs = torch.zeros((B, 5), dtype=torch.int32, device=dev)
    fano_cuda.fano_walk(m4, regs, K7, 32, 1)
    torch.cuda.synchronize()
    want = "warp" if (2 * nbits + 1) * 16 <= 232_448 else "thread"
    assert fano_cuda.fano_walk_plan(B, nbits, K7, 1)["design"] == want
    assert _kernels.backend_used["fano_walk"] == want


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


@pytest.mark.parametrize("data", ["random", "ties"])
@pytest.mark.parametrize("B", [1, 3, 10])
@pytest.mark.parametrize("code,nsteps", [(K14, 1), (K15, 1), (K18, 2),
                                         (K18, 1), (DEFAULT_CODE, 8),
                                         (DEFAULT_CODE, 5), (DEFAULT_CODE, 1)],
                         ids=["K14", "K15", "K18", "K18-1", "MCQLI24",
                              "MCQLI24-5", "MCQLI24-1"])
def test_k5_exact(dev, code, nsteps, B, data):
    """K5 alone against cycle_a_plain, metrics and decision words bit for
    bit, in whole and partial row phases (nsteps < ROWB), on random
    metrics and on metrics with many equal values and symbols 127/128,
    where the ties (a0 kept at lo, a2 at hi) decide."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(code.k * 100 + nsteps * 10 + B)

    def ri(lo, hi, shape):
        return torch.randint(lo, hi, shape, generator=gen, device=dev,
                             dtype=torch.int32)

    if data == "random":
        m0 = ri(0, 12000, (B, code.nstates)).to(torch.int16)
        syms = ri(0, 256, (B, 2 * nsteps))
    else:
        m0 = (ri(0, 3, (B, code.nstates)) * 255).to(torch.int16)
        syms = ri(127, 129, (B, 2 * nsteps))
    base = ri(0, 600, (B,))
    mk, mp = m0.clone(), m0.clone()
    # the decision planes land in a strided view, as the tape gives them
    tape = torch.zeros((nsteps + 1, B, code.nstates // 32), dtype=torch.int32,
                       device=dev)
    dk = tape[1:].transpose(0, 1)
    na = _kernels.LAUNCHES["viterbi_a"]
    viterbi_cuda.cycle_a(mk, syms, code, nsteps, base, dk)
    _, dp = viterbi_cuda.cycle_a_plain(mp, syms, code, nsteps, base)
    torch.cuda.synchronize()
    assert _kernels.LAUNCHES["viterbi_a"] == na + 1
    assert torch.equal(mk, mp)
    assert torch.equal(dk, dp)
    assert not bool(tape[0].any())


def test_k5_refuses_unaligned_buffers(dev):
    n = K15.nstates
    flat = torch.zeros(n + 4, dtype=torch.int16, device=dev)
    syms = torch.zeros((1, 2), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="16-byte aligned"):
        viterbi_cuda.cycle_a(flat[4:].view(1, n), syms, K15, 1)


@pytest.mark.parametrize("data", ["random", "ties", "top"])
@pytest.mark.parametrize("B", [1, 3, 10])
@pytest.mark.parametrize("code,nsteps", [
    (K14, None), (K14, 4), (K14, 1), (K15, None), (K15, 4), (K15, 1),
    (K18, None), (K18, 4), (K18, 1), (DEFAULT_CODE, None), (DEFAULT_CODE, 4),
    (DEFAULT_CODE, 1)],
    ids=["K14", "K14-4", "K14-1", "K15", "K15-4", "K15-1", "K18", "K18-4",
         "K18-1", "MCQLI24", "MCQLI24-4", "MCQLI24-1"])
def test_k6_exact(dev, code, nsteps, B, data):
    """K6 alone against cycle_b_plain, metrics, decision words and row
    minima bit for bit, in whole and partial column phases (nsteps =
    COLB, 4 as in a frame's tail, 1), on random metrics and on metrics
    with many equal values and symbols 127/128, where the ties (a0 kept
    at lo, a2 at hi) decide, and on metrics within 255 below the largest
    that reaches K6 at K = 24 with symbols 0/255, where the int16 sums
    are largest."""
    _, _, colb = viterbi_cuda._geometry(code)
    nsteps = colb if nsteps is None else nsteps
    gen = torch.Generator(device=dev)
    gen.manual_seed(code.k * 100 + nsteps * 10 + B)

    def ri(lo, hi, shape):
        return torch.randint(lo, hi, shape, generator=gen, device=dev,
                             dtype=torch.int32)

    if data == "random":
        m0 = ri(0, 12000, (B, code.nstates)).to(torch.int16)
        syms = ri(0, 256, (B, 2 * nsteps))
    elif data == "ties":
        m0 = (ri(0, 3, (B, code.nstates)) * 255).to(torch.int16)
        syms = ri(127, 129, (B, 2 * nsteps))
    else:
        m0 = (K6_TOP - ri(0, 256, (B, code.nstates))).to(torch.int16)
        syms = ri(0, 2, (B, 2 * nsteps)) * 255
    mk, mp = m0.clone(), m0.clone()
    # the decision planes land in a strided view, as the tape gives them
    tape = torch.zeros((nsteps + 1, B, code.nstates // 32), dtype=torch.int32,
                       device=dev)
    dk = tape[1:].transpose(0, 1)
    nb = _kernels.LAUNCHES["viterbi_b"]
    _, _, mins_k = viterbi_cuda.cycle_b(mk, syms, code, nsteps, dk)
    _, dp, mins_p = viterbi_cuda.cycle_b_plain(mp, syms, code, nsteps)
    torch.cuda.synchronize()
    assert _kernels.LAUNCHES["viterbi_b"] == nb + 1
    assert torch.equal(mk, mp)
    assert torch.equal(dk, dp)
    assert torch.equal(mins_k, mins_p)
    assert not bool(tape[0].any())
    if data == "top":
        assert int(mp.max()) > K6_TOP + nsteps * 100


def test_k6_refuses_unaligned_buffers(dev):
    n = K15.nstates
    flat = torch.zeros(n + 4, dtype=torch.int16, device=dev)
    syms = torch.zeros((1, 2), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="16-byte aligned"):
        viterbi_cuda.cycle_b(flat[4:].view(1, n), syms, K15, 1)


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


@pytest.mark.parametrize("ends", ["int", "tensor"])
@pytest.mark.parametrize("nbits", [5, 1000, 1024])
@pytest.mark.parametrize("code,B", [(K15, 1), (K15, 13), (K15, 33),
                                    (DEFAULT_CODE, 1), (DEFAULT_CODE, 2)],
                         ids=["K15-1", "K15-13", "K15-33", "MCQLI24-1",
                              "MCQLI24-2"])
def test_traceback_kernel_matches_plain(dev, code, B, nbits, ends):
    """The traceback kernel against its plain twin chainback_inplace, bit
    for bit, on random tapes (any tape is a valid input), from one end
    state or one a frame, at nbits a multiple of W or not; one launch a
    call.  K = 24 takes 1 GiB of tape a 1024-bit frame, hence B <= 2."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(code.k * 10000 + B * 100 + nbits)
    dec = torch.empty((B, nbits, code.nstates // 32), dtype=torch.int32,
                      device=dev)
    for b in range(B):  # the low 32 bits of each int64: any uint32 word
        dec[b] = torch.randint(0, 2**32, dec.shape[1:], generator=gen,
                               device=dev, dtype=torch.int64).to(torch.int32)
    end = (torch.randint(0, 2**31, (B,), generator=gen, device=dev)
           if ends == "tensor" else 0x5A5A5A5 & code.state_mask)
    n0 = _kernels.LAUNCHES["viterbi_traceback"]
    got = viterbi_cuda.traceback(dec, nbits, end, code)
    torch.cuda.synchronize()
    assert _kernels.LAUNCHES["viterbi_traceback"] == n0 + 1
    assert _kernels.backend_used["traceback"] == "cuda"
    want = viterbi_inplace.chainback_inplace(dec.transpose(0, 1), nbits, end,
                                             code)
    assert got.shape == (B, nbits) and got.dtype == torch.uint8
    assert torch.equal(got, want)


def test_decode_frame_fused_traceback_kernel_mcqli24(dev):
    """Two noisy 1024-bit MCQLI-24 frames from SYNC_STATE to state 0 (the
    zero tail): the kernel path (K5, K6, one traceback launch) gives the
    plain path's bits and the sent ones."""
    rng = np.random.default_rng(25)
    nbits, B = 1024, 2
    bits = torch.as_tensor(rng.integers(0, 2, (B, nbits)), device=dev)
    bits[:, -(DEFAULT_CODE.k - 1):] = 0
    syms, _ = encode_bits(bits, SYNC_STATE, DEFAULT_CODE)
    noise = torch.as_tensor(rng.normal(0, 60, syms.shape), device=dev)
    soft = torch.clamp(torch.round((syms.double() * 2 - 1) * 100 + noise) + 128,
                       0, 255).to(torch.uint8)
    n0 = _kernels.LAUNCHES["viterbi_traceback"]
    got = viterbi_fused.decode_frame_fused(soft, nbits, SYNC_STATE, 0)
    torch.cuda.synchronize()
    assert _kernels.LAUNCHES["viterbi_traceback"] == n0 + 1
    assert _kernels.backend_used["traceback"] == "cuda"
    with _kernels.plain_reference():
        want = viterbi_fused.decode_frame_fused(soft, nbits, SYNC_STATE, 0)
    assert _kernels.backend_used["traceback"] == "torch"
    assert _kernels.LAUNCHES["viterbi_traceback"] == n0 + 1
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
     (64, 2, 501, 33),
     (256, 1, 301, 0),
     (256, 2, 300, 5),
     (32, 1, 1203, 17),
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
    # rows of pitch_words(nout) words: 16-byte aligned
    assert got.stride() == (2 * channelizer_cuda.pitch_words(nout), 1)
    assert got.data_ptr() % 16 == 0
    _assert_raw_close(got, want)
    with _kernels.plain_reference():
        again = channelizer_cuda.channelize_raw_fused(packed, nchan, 8,
                                                      oversample=oversample)
    assert torch.equal(again, want)
    assert _kernels.LAUNCHES[name] == n0 + 1


@pytest.mark.parametrize("off", [1, 2, 3])
@pytest.mark.parametrize("oversample", [1, 2])
def test_k7_takes_a_capture_at_any_word_offset(dev, oversample, off):
    """A capture that starts 4·off bytes past a 16-byte boundary: the
    kernel's bulk copies start on the boundary below each tile and end on
    the one above it."""
    nchan = 128
    packed = _packed(dev, 700 * nchan + 9 + off, seed=off)[off:]
    assert packed.data_ptr() % 16 == 4 * off
    got = channelizer_cuda.channelize_raw_fused(packed, nchan, 8,
                                                oversample=oversample)
    want = channelizer_cuda.channelize_raw_plain(packed, nchan, 8,
                                                 oversample=oversample)
    _assert_raw_close(got, want)


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


@pytest.mark.parametrize("P", [5, 12, 16])
def test_k7_other_tap_counts(dev, P):
    """taps_per_branch other than 8, with a prototype of the caller's: a
    ring of 8 with zero taps past P, and rings of 16."""
    nchan = 64
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


@pytest.mark.parametrize("flip", [False, True], ids=["iq", "flip"])
@pytest.mark.parametrize("B", [1, 5, 128])
@pytest.mark.parametrize("n", [4096, 8192, 12288])
def test_k8_search_one_launch_matches_plain(dev, n, B, flip):
    """K8 with its peak pass at n = 4096 (the narrowband path), 8192 and
    12288 (not a power of two: 24,576 sps at 2 Hz bins) against the plain
    version: one launch, bins within 1e-5 of the largest bin, equal peak
    bins, frequency within 5e-3 Hz."""
    samprate, width = 2.0 * n, 100.0
    binsize = samprate / n
    gen = torch.Generator(device=dev)
    gen.manual_seed(n + B)
    frames = torch.as_tensor(random_frames(np.random.default_rng(B), B),
                             device=dev)[:, None, :]
    # carriers a quarter bin off a bin, spread over 300 Hz .. fs/2 - 300
    spread = np.linspace(300.0, samprate / 2 - 300.0, B)
    freqs = torch.as_tensor((np.round(spread / binsize) + 0.25) * binsize,
                            dtype=torch.float32, device=dev)
    iq = synthesize_iq_device(frames, freqs, gen, n, samprate=samprate,
                              symrate=512.0, noise_std=300.0)
    packed = carrier.pack_raw(to_raw_int16(iq))
    center = -freqs if flip else freqs
    first = torch.trunc((center - width) / binsize).to(torch.int32)
    last = torch.trunc((center + width) / binsize).to(torch.int32)
    K = int(2 * width / binsize) + 3
    args = (packed, first - 1, last - first, K, samprate, binsize, flip)
    n0 = _kernels.LAUNCHES["windowed_dft"]
    s_k, f_k, pk_k = carrier_cuda.windowed_search_raw(*args)
    torch.cuda.synchronize()
    assert _kernels.LAUNCHES["windowed_dft"] == n0 + 1
    assert _kernels.backend_used["search"] == "cuda"
    s_p, f_p, pk_p = carrier_cuda.windowed_search_raw_plain(*args)
    assert s_k.shape == (B, K) and s_k.dtype == torch.complex64
    assert float((s_k - s_p).abs().max()) <= 1e-5 * float(s_p.abs().max())
    assert pk_k.dtype == torch.int64 and torch.equal(pk_k, pk_p)
    torch.testing.assert_close(f_k, f_p, atol=5e-3, rtol=0)


def test_k8_unaligned_rows_match_plain(dev):
    """Rows that do not start on 16 bytes are staged by 4-byte copies
    instead of the bulk copy: the same bins as the plain version."""
    cfg = carrier.PMConfig(samprate=32768.0, binsize=8.0, search_width=200.0)
    B, n, K = 3, cfg.fftsize, carrier._window_bins(cfg)
    raw, freqs = _raw(dev, B, cfg, seed=5)
    wide = torch.empty((B, n + 1), dtype=torch.int32, device=dev)
    packed = wide[:, 1:]  # each row starts 4 bytes past a 16-byte boundary
    packed.copy_(carrier.pack_raw(raw))
    assert packed.data_ptr() % 16 != 0 and packed.stride(1) == 1
    carry = carrier.PMCarry(search_center=freqs,
                            cn0=torch.full_like(freqs, 60.0))
    first, last = carrier._search_window(carry.search_center, carry.cn0, cfg)
    first1, wlen = first - 1, last - first
    args = (packed, first1, wlen, K, cfg.samprate, cfg.actual_binsize)
    s_k, f_k, pk_k = carrier_cuda.windowed_search_raw(*args)
    s_p, f_p, pk_p = carrier_cuda.windowed_search_raw_plain(*args)
    assert float((s_k - s_p).abs().max()) <= 1e-5 * float(s_p.abs().max())
    assert torch.equal(pk_k, pk_p)
    torch.testing.assert_close(f_k, f_p, atol=5e-3, rtol=0)


def test_k8_refuses_rows_it_cannot_stage(dev):
    """K8 stages a whole row in one block's shared memory: a row too long
    for it raises, with no fallback to another kernel."""
    packed = torch.zeros((2, 18944), dtype=torch.int32, device=dev)
    first1 = torch.zeros(2, dtype=torch.int32, device=dev)
    n0 = _kernels.LAUNCHES["windowed_dft"]
    with pytest.raises(ValueError, match="shared memory"):
        carrier_cuda.windowed_search_raw(packed, first1, first1 + 10, 53,
                                         37888.0, 2.0)
    assert _kernels.LAUNCHES["windowed_dft"] == n0


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


@pytest.mark.parametrize("samprate,B,T,aligned",
                         [(32768.0, 8, 3, True), (250_000.0, 4, 3, True),
                          (32768.0, 3, 2, False)],
                         ids=["n8192", "n65536", "n8192-unaligned"])
def test_k9_column_dft_matches_plain(dev, samprate, B, T, aligned):
    """K9's window bins by 256-point column DFTs (one pass of 32 columns at
    n = 8192, eight at the bench's n = 65,536, K = 53 and 107; and rows
    that start 4 bytes past a 16-byte boundary) against the
    plain version, with chip_smoke.py's tolerances: ok lanes and locks
    equal, frequency and centre within 5e-3 Hz, C/N0 within 1e-2 dB,
    amplitude within rtol 1e-5, baseband within 1 LSB, totals equal to
    the edge column."""
    cfg = carrier.PMConfig(samprate=samprate, binsize=4.0, search_width=100.0)
    n, K = cfg.fftsize, carrier._window_bins(cfg)
    assert carrier_cuda.pm_scan_plan(n, K)["passes"] == n // 8192
    blocks = _scan_inputs(dev, B, T, cfg, seed=21)
    carry1, out0 = carrier.pm_demod_block_raw(
        carrier.init_carry(B, cfg, device=dev), blocks[:, 0], cfg)
    init = torch.stack([torch.zeros_like(out0.cn0), out0.cn0,
                        out0.carrier_freq, carry1.search_center], dim=1)
    packed = carrier.pack_raw(blocks)
    if not aligned:  # each channel's blocks start 4 bytes past a 16-byte boundary
        wide = torch.empty((B, T * n + 1), dtype=torch.int32, device=dev)
        wide[:, 1:] = packed.reshape(B, T * n)
        packed = wide[:, 1:].view(B, T, n)
        assert packed.data_ptr() % 16 != 0 and packed.stride(1) == n
    args = (packed, out0.baseband, init, cfg.samprate,
            cfg.actual_binsize, cfg.search_width, cfg.cn0_threshold, K)
    cs_k, st_k, tot_k = carrier_cuda.pm_scan_locked_fused(*args, tail=1)
    cs_p, st_p, tot_p = carrier_cuda.pm_scan_locked_plain(*args, tail=1)
    thr = cfg.cn0_threshold
    assert bool((st_k[:, 1:, 3] > 0).all())
    assert torch.equal(st_k[..., 3], st_p[..., 3])
    assert torch.equal(st_k[..., 1] > thr, st_p[..., 1] > thr)
    for lane, tol in ((2, 5e-3), (5, 5e-3), (1, 1e-2)):
        torch.testing.assert_close(st_k[..., lane], st_p[..., lane], atol=tol,
                                   rtol=0)
    torch.testing.assert_close(st_k[..., 0], st_p[..., 0], rtol=1e-5, atol=0)
    bb_k = (cs_k[:, 1:] - cs_k[:, :-1]).to(torch.int16).int()
    bb_p = (cs_p[:, 1:] - cs_p[:, :-1]).to(torch.int16).int()
    assert int((bb_k - bb_p).abs().max()) <= 1
    assert torch.equal(tot_k, cs_k[:, -1])


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
    with pytest.raises(ValueError, match="multiple of 8192"):
        carrier_cuda.pm_scan_locked_fused(
            torch.zeros((B, T, 4096), dtype=torch.int32, device=dev),
            torch.zeros((B, 4096), dtype=torch.int16, device=dev), init, *rest)
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


def _stream_block(dev, B: int, seconds: float, noise: float, seed: int):
    """(B, 2n) int16 raw IQ of the bench configuration (250 ksps, 1024
    sym/s, carriers 20 kHz + 137 Hz·i) made on the card."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    frames = random_frames(np.random.default_rng(seed), 3)
    frames = torch.as_tensor(np.ascontiguousarray(
        np.broadcast_to(frames, (B, *frames.shape))), device=dev)
    carriers = torch.as_tensor(20_000.0 + 137.0 * np.arange(B),
                               dtype=torch.float32, device=dev)
    iq = synthesize_iq_device(frames, carriers, gen, int(seconds * 250_000),
                              noise_std=noise)
    return to_raw_int16(iq)


def _stream_cfg():
    from isee3_decoder_tpu_torch.models.pipeline import PipelineConfig
    from isee3_decoder_tpu_torch.ops.symbols import SymConfig

    return PipelineConfig(
        pm=carrier.PMConfig(samprate=250_000.0, binsize=4.0,
                            search_width=200.0),
        sym=SymConfig(samprate=250_000.0, symrate=1024.0))


def _flat(records):
    return [(int(r.start_symbol[b]), bool(r.good[b]), int(r.decoder[b]),
             bytes(r.data[b])) for r in records for b in range(r.data.shape[0])]


def test_receive_stream_chunked_equals_one_call(dev):
    """receive_stream on the card in ragged chunks (one shorter than a pm
    block) gives one call's frames, and with trim=False the soft symbols
    of demod_to_symbols bit for bit; K1, K2 and K3 run."""
    from isee3_decoder_tpu_torch.models.pipeline import (
        demod_to_symbols,
        receive_stream,
    )

    cfg = _stream_cfg()
    iq = _stream_block(dev, 8, 6.5, 2500.0, seed=41)
    one, _ = receive_stream(iq, cfg)
    soft1 = demod_to_symbols(iq, cfg)[0]
    cuts = [0, 500_000, 506_000, 1_500_000, iq.shape[1]]
    _kernels.reset_launches()
    carry, recs = None, []
    for lo, hi in zip(cuts[:-1], cuts[1:]):
        r, carry = receive_stream(iq[:, lo:hi], cfg, carry, trim=False)
        recs.extend(r)
    assert _flat(recs) == _flat(one) and any(f[1] for f in _flat(one))
    for k in ("pm_locked", "spin_down", "prefix_sum"):
        assert _kernels.LAUNCHES[k] > 0, k
    assert carry.bb.is_cuda and carry.soft.is_cuda and carry.first.is_cuda
    n = min(carry.soft.shape[1], soft1.shape[1])
    assert n >= soft1.shape[1] - cfg.sym.nsymbols
    assert torch.equal(carry.soft[:, :n], soft1[:, :n])


def test_receive_stream_checkpoint_resume_on_the_card(dev, tmp_path):
    """Stopped after two chunks, saved, restored onto a fresh template on
    the card and resumed: the uninterrupted stream's frames."""
    from isee3_decoder_tpu_torch.models.pipeline import (
        chain_carry_template,
        receive_stream,
    )
    from isee3_decoder_tpu_torch.utils import checkpoint

    cfg = _stream_cfg()
    iq = _stream_block(dev, 4, 6.5, 2500.0, seed=42)
    cuts = [0, 500_000, 506_000, 1_500_000, iq.shape[1]]
    chunks = list(zip(cuts[:-1], cuts[1:]))
    carry, want = None, []
    for lo, hi in chunks:
        r, carry = receive_stream(iq[:, lo:hi], cfg, carry)
        want.extend(r)
    carry, got = None, []
    for lo, hi in chunks[:2]:
        r, carry = receive_stream(iq[:, lo:hi], cfg, carry)
        got.extend(r)
    path = tmp_path / "carry.npz"
    checkpoint.save_pytree(path, carry)
    restored = checkpoint.restore_pytree(path, chain_carry_template(
        checkpoint.load_manifest(path), cfg, device=dev))
    assert restored.bb.is_cuda and torch.equal(restored.bb, carry.bb)
    for lo, hi in chunks[2:]:
        r, restored = receive_stream(iq[:, lo:hi], cfg, restored)
        got.extend(r)
    assert _flat(got) == _flat(want) and len(_flat(want)) >= 4


def _manchester_bb(seed: int, symrates, seconds: float,
                   samprate: float = 32768.0) -> np.ndarray:
    """(B, L) int16 Manchester baseband of random symbols, one row per
    sent clock in ``symrates``."""
    from isee3_decoder_tpu_torch.utils.testsignal import manchester_waveform

    rng = np.random.default_rng(seed)
    rows = []
    for f in symrates:
        syms = rng.integers(0, 2, int(seconds * f) + 8).astype(np.uint8)
        wave = manchester_waveform(syms, samprate / f)
        rows.append((2000.0 * wave + rng.normal(0, 150.0, len(wave)))
                    [: int(seconds * samprate)])
    return np.stack(rows).astype(np.int16)


def test_batched_tracker_on_the_card_equals_the_cpu(dev):
    """symdemod_tracked_batched on the card (K3's prefix sum, the climb's
    torch ops there) gives the CPU run's soft symbols and infos; the
    energies are exact sums, so bit for bit."""
    from isee3_decoder_tpu_torch.models import symdemod
    from isee3_decoder_tpu_torch.models.symdemod_tracked import (
        symdemod_tracked_batched,
    )
    from isee3_decoder_tpu_torch.ops.symbols import SymConfig

    cfg = SymConfig(samprate=32768.0, symrate=1024.0)
    x = _manchester_bb(3, (1024.0, 1024.4, 1023.7, 1024.545), 3.2)
    _kernels.reset_launches()
    symdemod.reset_track_stats()
    soft_g, infos_g = symdemod_tracked_batched(x, cfg, 3)
    assert _kernels.LAUNCHES["prefix_sum"] == 1
    assert _kernels.backend_used["csum"] == "cuda"
    assert len(symdemod.track_stats["iterations"]) == 3
    soft_c, infos_c = symdemod_tracked_batched(x, cfg, 3, device="cpu")
    np.testing.assert_array_equal(soft_g, soft_c)
    for wg, wc in zip(infos_g, infos_c):
        for key in wc:
            np.testing.assert_array_equal(np.asarray(wg[key]),
                                          np.asarray(wc[key]), err_msg=key)


def _run_tool(main, argv, stdin: bytes = b"") -> bytes:
    import io
    import sys
    from unittest import mock

    out = io.BytesIO()
    fake_out = io.TextIOWrapper(out, write_through=True)
    fake_in = io.TextIOWrapper(io.BytesIO(stdin))
    with mock.patch.object(sys, "stdout", fake_out), \
            mock.patch.object(sys, "stdin", fake_in):
        assert main(argv) == 0
        fake_out.flush()
    return out.getvalue()


def test_symdemod_tracking_cli_on_the_card_equals_the_cpu(dev):
    """symdemod -t on the card writes the bytes of --device cpu; K3 runs
    once a window."""
    from isee3_decoder_tpu_torch.cli import symdemod as symdemod_cli

    x = _manchester_bb(5, (1024.545,), 3.3)[0]
    args = ["-q", "-r", "32768", "-c", "1024.", "-t"]
    _kernels.reset_launches()
    got = _run_tool(symdemod_cli.main, args, x.tobytes())
    assert _kernels.LAUNCHES["prefix_sum"] == 3
    want = _run_tool(symdemod_cli.main, args + ["--device", "cpu"],
                     x.tobytes())
    assert len(got) == 3 * 1023 and got == want


def test_spindown_cli_on_the_card_equals_the_cpu(dev, tmp_path):
    """spindown's float64 mix on the card: the CPU's bytes (the fused
    products of torch.addcmul on both)."""
    from isee3_decoder_tpu_torch.cli import spindown as spindown_cli

    rng = np.random.default_rng(6)
    raw = rng.integers(-9000, 9000, 2 * (2 * 131072 + 77)).astype(np.int16)
    path = tmp_path / "in.iq"
    raw.tofile(path)
    for flip in ([], ["-f"]):
        args = ["-c", "20000.5", "-r", "250000", *flip, str(path)]
        got = _run_tool(spindown_cli.main, args)
        want = _run_tool(spindown_cli.main, args + ["--device", "cpu"])
        assert len(got) == 2 * 131072 * 16 and got == want


def test_fanotest_cli_on_the_card(dev):
    """fanotest walks its frames with K4 on the card."""
    from isee3_decoder_tpu_torch.cli import fanotest as fanotest_cli

    _kernels.reset_launches()
    out = _run_tool(fanotest_cli.main, ["-l", "256", "-n", "32", "-e", "4"])
    last = out.decode().splitlines()[-1]
    assert last.startswith("trials 32 ")
    assert int(last.split(" good ")[1].split()[0]) >= 30
    assert _kernels.LAUNCHES["fano_walk"] >= 1


def test_float64_pm_branch_on_the_card_equals_the_cpu(dev):
    """The float64 pm branch (plain torch in complex128: cuFFT search,
    two-pass spin-down) on the card against the same on the CPU
    (pocketfft): the baseband within 1 LSB, carrier and C/N0 within rtol
    1e-9, locks exact; no pm kernel runs (K1, K2, K8, K9)."""
    cfg = carrier.PMConfig(samprate=32768.0, binsize=4.0, search_width=100.0,
                           dtype=torch.float64)
    B, T = 5, 3
    raw, _ = _raw(dev, B, cfg, seed=61, nblocks=T)
    blocks = raw.reshape(B, T, 2 * cfg.fftsize)
    _kernels.reset_launches()
    c_d, o_d = carrier.pm_demod_scan(carrier.init_carry(B, cfg, device=dev),
                                     blocks, cfg)
    assert _kernels.backend_used.get("pm") == "plain_f64"
    for k in ("pm_locked", "spin_down", "windowed_dft", "pm_scan"):
        assert _kernels.LAUNCHES[k] == 0, k
    c_h, o_h = carrier.pm_demod_scan(carrier.init_carry(B, cfg, device="cpu"),
                                     blocks.cpu(), cfg)
    assert o_d.carrier_freq.dtype == torch.float64
    assert torch.equal(o_d.locked.cpu(), o_h.locked) and bool(o_h.locked[1:].all())
    np.testing.assert_allclose(o_d.carrier_freq.cpu().numpy(),
                               o_h.carrier_freq.numpy(), rtol=1e-9)
    np.testing.assert_allclose(o_d.cn0.cpu().numpy(), o_h.cn0.numpy(), rtol=1e-9)
    diff = (o_d.baseband.cpu().to(torch.int32) - o_h.baseband.to(torch.int32)).abs()
    print(f"float64 baseband samples that differ card vs CPU: "
          f"{int((diff > 0).sum())} of {diff.numel()}")
    assert int(diff.max()) <= 1


def test_receive_block_sharded_on_logical_shards_of_the_card(dev):
    """receive_block_sharded on [cuda:0] * 4 (each shard's kernels on the
    card, one shard after another): the buffer is the unsharded one byte
    for byte."""
    from isee3_decoder_tpu_torch.models.pipeline import receive_block_device
    from isee3_decoder_tpu_torch.parallel import receive_block_sharded

    cfg = _stream_cfg()
    iq = _stream_block(dev, 8, 6.5, 2500.0, seed=43)
    want = receive_block_device(iq, 1, 2048, cfg)
    got = receive_block_sharded(iq, 1, cfg, make_mesh(4, 1, devices=[dev] * 4))
    assert got.device == want.device
    assert torch.equal(got, want)
