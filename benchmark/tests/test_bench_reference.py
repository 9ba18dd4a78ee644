"""The frozen plain reference against the program's own plain path at a
tiny size, on the CPU."""

import numpy as np
import pytest
import torch

from isee3_decoder_tpu_torch.config import CodeSpec as PortCode
from isee3_decoder_tpu_torch.config import MCQLI24 as PORT_MCQLI24
from isee3_decoder_tpu_torch.models import decode as port_decode
from isee3_decoder_tpu_torch.models import pipeline as port_pipeline
from isee3_decoder_tpu_torch.ops import fano as port_fano
from isee3_decoder_tpu_torch.ops import viterbi as port_viterbi
from reference import chain, codec, decode, pm, symbols, viterbi
from yardstick import traffic
from yardstick.manifest import Manifest

import run


@pytest.fixture(scope="module")
def block():
    """Two channels of one 512 bps bench block at each noise level."""
    m = Manifest()
    cfg = m.config("isee3_512bps")
    cell = dict(m.cell("isee3_512bps.clean"), channels=2, pool_blocks=1)
    out = {}
    for noise in (2500.0, 50000.0, 110000.0):
        out[noise] = traffic.make_pool(cfg, dict(cell, noise_std=noise), 4242, "cpu").blocks[0]
    return cfg, out


def _port_symbols(cfg, raw):
    soft, bb, _, _ = port_pipeline.demod_to_symbols(raw, run.pipeline_config(cfg))
    return soft, bb


@pytest.mark.parametrize("noise", [2500.0, 110000.0])
def test_carrier_demod_within_a_few_lsb(block, noise):
    """The reference spins down with a float64 phase ramp after a full
    complex64 FFT search; the program with a float32 ramp after its
    windowed DFT.  Their basebands differ by a few LSB (2 clean and 6
    at noise 110,000 measured here): 8 allows for the noisier seeds."""
    cfg, raws = block
    _, bb = _port_symbols(cfg, raws[noise])
    diff = (pm.pm_demod(raws[noise], cfg).int() - bb.int()).abs()
    assert int(diff.max()) <= 8


@pytest.mark.parametrize("noise", [2500.0, 110000.0])
def test_symbol_demod_equals_the_programs_on_its_baseband(block, noise):
    cfg, raws = block
    soft, bb = _port_symbols(cfg, raws[noise])
    assert torch.equal(symbols.symdemod(bb, cfg), soft)


def test_sync_and_the_device_tiers_equal_the_programs(block):
    """Quicklook, QLEC and Fano on the program's soft symbols at noise
    50,000 (no lane reaches Viterbi there)."""
    cfg, raws = block
    soft, _ = _port_symbols(cfg, raws[50000.0])
    rec, ss = port_decode.decode_block(soft, 2, port_decode.DecodeConfig(), device="cpu")
    ref = decode.decode_block(soft, 2, cfg["decode"])
    assert np.array_equal(ss, ref["sync_start"])
    for f in ("data", "good", "decoder", "start_symbol", "fano_cycles"):
        assert np.array_equal(getattr(rec, f), ref[f]), f
    assert set(ref["decoder"]) - {decode.QUICKLOOK} and decode.VITERBI not in ref["decoder"]


def _noisy_frames(code, nbits, lanes, sigma, seed):
    rng = np.random.default_rng(seed)
    bits = torch.as_tensor(rng.integers(0, 2, (lanes, nbits)), dtype=torch.uint8)
    syms = codec.encode_bits(bits, codec.SYNC_STATE, code).to(torch.int32)
    soft = 128 + (2 * syms - 1) * 60 + torch.as_tensor(rng.normal(0, sigma, syms.shape)).int()
    return bits, soft.clamp(0, 255).to(torch.uint8)


@pytest.mark.parametrize("sigma", [40.0, 90.0, 120.0])
def test_fano_walk_equals_the_programs(sigma):
    """Bits, success and cycle counts, a timed-out walk among them."""
    n = 256
    _, soft = _noisy_frames(codec.MCQLI24, n, 6, sigma, int(sigma))
    mettab = codec.fano_mettab(8.0)
    tail = codec.SYNCWORD & ((1 << 23) - 1)
    want = port_fano.fano_decode(soft, torch.as_tensor(mettab), n, codec.SYNC_STATE, tail,
                                 PORT_MCQLI24, port_fano.FanoParams(delta=32, maxcycles=20))
    for lane in range(soft.shape[0]):
        bits, goodbits, cycles = decode.fano_frame(
            bytes(soft[lane].numpy()), mettab.tolist(), n, codec.SYNC_STATE, tail,
            codec.MCQLI24, 32, 20)
        assert goodbits == int(want.goodbits[lane]) and cycles == int(want.cycles[lane])
        assert bits == want.bits[lane].tolist()


@pytest.mark.parametrize("poly1,poly2,k,f1,f2,backend", [
    (0o171, 0o133, 7, 0, 0, "jnp"),
    (0o2473, 0o3217, 11, 1, 0, "jnp"),
    (0o75063, 0o65457, 15, 0, 1, "fused"),
])
def test_viterbi_equals_the_programs(poly1, poly2, k, f1, f2, backend):
    ours = codec.CodeSpec("t", poly1, poly2, k, f1, f2)
    theirs = PortCode("t", poly1, poly2, k, f1, f2)
    _, soft = _noisy_frames(ours, 160, 5, 90.0, k)
    start, end = 5, 0x1234 & ours.state_mask
    got = viterbi.viterbi_frames(soft, 160, start, end, ours)
    want = port_viterbi.decode_frames(soft, 160, start, end, theirs, backend)
    assert torch.equal(got, want)


def test_whole_chain_equals_the_programs(block):
    cfg, raws = block
    rec, ss = port_pipeline.receive_block(raws[2500.0], 2, run.pipeline_config(cfg),
                                          device="cpu")
    ref = chain.receive(raws[2500.0], cfg, 2)
    assert np.array_equal(ss, ref["sync_start"])
    for f in ("data", "good", "decoder", "start_symbol", "fano_cycles"):
        assert np.array_equal(getattr(rec, f), ref[f]), f
