"""The frozen traffic generator against the program's own synthesis at
a tiny size: a later change to the program must not move the
yardstick unseen."""

import numpy as np
import pytest
import torch

from isee3_decoder_tpu_torch.ops import encode as port_encode
from isee3_decoder_tpu_torch.utils import devicesignal, testsignal
from reference import codec
from yardstick import traffic
from yardstick.manifest import Manifest


def test_codec_equals_the_programs():
    from isee3_decoder_tpu_torch import config as port_config

    assert codec.sync_vector() == port_config.sync_vector(port_config.MCQLI24)
    assert (codec.FRAMEBITS, codec.SYNCWORD, codec.SYNC_STATE) == (
        port_config.FRAMEBITS, port_config.SYNCWORD, port_config.SYNC_STATE)
    bits = torch.as_tensor(np.random.default_rng(1).integers(0, 2, (3, 300)), dtype=torch.uint8)
    got = codec.encode_bits(bits, codec.SYNC_STATE)
    want, _ = port_encode.encode_bits(bits, port_config.SYNC_STATE, port_config.MCQLI24)
    assert torch.equal(got, want)
    assert torch.equal(codec.bits_to_bytes(bits[:, :296]), port_encode.bits_to_bytes(bits[:, :296]))
    fr = codec.random_frames(np.random.default_rng(5), 3)
    assert np.array_equal(fr, testsignal.random_frames(np.random.default_rng(5), 3))
    assert np.array_equal(codec.frames_to_symbols(fr), testsignal.frames_to_symbols(fr))


def test_synthesis_equals_the_programs():
    frames = torch.as_tensor(np.stack([codec.random_frames(np.random.default_rng(c), 2)
                                       for c in range(3)]))
    carriers = torch.tensor([20000.0, 20137.0, 20274.0])
    args = dict(samprate=250_000.0, symrate=1024.0, mod_index=1.1, amplitude=12_000.0,
                noise_std=2500.0)
    g1, g2 = torch.Generator(), torch.Generator()
    g1.manual_seed(7)
    g2.manual_seed(7)
    ours = traffic.synthesize_iq_device(frames, carriers, g1, 5000, **args)
    theirs = devicesignal.synthesize_iq_device(frames, carriers, g2, 5000, **args)
    assert torch.equal(ours, theirs)
    assert torch.equal(traffic.to_raw_int16(ours), devicesignal.to_raw_int16(theirs))


@pytest.mark.parametrize("symrate,clocks", [(32.0, 32), (4096.0, 1)])
def test_mode_capture_equals_the_host_synthesis(symrate, clocks):
    """At noise 0 on 0.3 s, within one LSB after truncation of the
    float64 numpy waveform (utils/testsignal.synthesize_iq)."""
    frames = codec.random_frames(np.random.default_rng(3), 1)
    n = int(0.3 * 250_000)
    syms = traffic.mode_symbols(frames, 0, 20, np.random.default_rng(4))
    want = testsignal.synthesize_iq(frames, samprate=250_000.0, symrate=symrate,
                                    carrier=20_000.0, mod_index=0.7, symbolclocks=clocks,
                                    lead_symbols=20, rng=np.random.default_rng(4))[:n]
    got = traffic.mode_capture("cpu", syms[None], n, 250_000.0, symrate, clocks, 0.7,
                               0.0, torch.Generator(), 12_000.0, np.array([20_000.0]))
    w = np.stack([want.real, want.imag], axis=-1).reshape(-1)
    err = np.abs(got[0].numpy().astype(np.float64) - np.trunc(w))
    assert err.max() <= 1.0 and (err > 0).mean() < 1e-4


def test_block_sizes_and_frame_positions():
    m = Manifest()
    cfg5, cfg16 = m.config("isee3_512bps"), m.config("isee3_16bps_sub")
    assert traffic.block_samples(cfg5, m.cell("isee3_512bps.clean")) == 2_097_656
    n16 = traffic.block_samples(cfg16, m.cell("isee3_16bps_sub.clean"))
    assert n16 == 741 * 65536
    assert traffic.sent_frame_index(np.array([2068, 4116, 6164, 8212]), 0, 4, True).tolist() \
        == [1, 2, 3, 0]
    assert traffic.sent_frame_index(np.array([2068, 4116, 6164, 8212]), 20, 3, False).tolist() \
        == [1, 2, -1, -1]


def test_the_same_seed_gives_the_same_pool(tiny_root):
    m = Manifest(tiny_root("isee3_512bps.tiny", "isee3_512bps.clean", channels=2,
                           pool_blocks=2, slack_symbols=0, frames_sent=1))
    cfg = m.config("isee3_512bps")
    cell = m.cell("isee3_512bps.tiny")
    a = traffic.make_pool(cfg, cell, 2**31 + 5, "cpu")
    b = traffic.make_pool(cfg, cell, 2**31 + 5, "cpu")
    c = traffic.make_pool(cfg, cell, 2**31 + 6, "cpu")
    assert all(torch.equal(x, y) for x, y in zip(a.blocks, b.blocks))
    assert not torch.equal(a.blocks[0], a.blocks[1])
    assert not torch.equal(a.blocks[0], c.blocks[0])
    assert a.blocks[0].shape == c.blocks[0].shape
