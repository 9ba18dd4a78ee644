"""PyTorch port vs the JAX package: the wideband path as a whole.

One wide capture (the 2-slot capture of tests/test_wideband.py, built by
the JAX package's synthesis) goes through both packages'
``receive_block_wideband`` in all three input forms — interleaved int16,
packed int32, complex64.  Frame bytes, good flags, decoder labels, start
symbols and sync starts must be equal.  The port's own wideband
synthesis is held to the JAX one without noise (the generators differ),
and ``receive_blocks_pipelined`` to ``receive_block`` block by block.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isee3_decoder_tpu.models import pipeline as jpipe
from isee3_decoder_tpu.models.decode import DecodeConfig
from isee3_decoder_tpu.ops.carrier import PMConfig
from isee3_decoder_tpu.ops.channelizer_pallas import channelize_raw_fused
from isee3_decoder_tpu.ops.symbols import SymConfig
from isee3_decoder_tpu.utils import devicesignal as jsignal
from isee3_decoder_tpu.utils import testsignal
from isee3_decoder_tpu_torch import _kernels
from isee3_decoder_tpu_torch.models import pipeline as tpipe
from isee3_decoder_tpu_torch.utils import convert
from isee3_decoder_tpu_torch.utils import devicesignal as tsignal

SAMPRATE, SYMRATE = 250_000.0, 1024.0


def _cfg():
    return jpipe.PipelineConfig(
        pm=PMConfig(samprate=SAMPRATE, binsize=4.0, search_width=200.0),
        sym=SymConfig(samprate=SAMPRATE, symrate=SYMRATE),
    )


def _capture(nchan, nsynth, distinct_frames=False):
    """The recipe of tests/test_wideband.py: (per-channel frames, complex64
    capture, its int16 recording)."""
    seconds = (nsynth * 2048 + 400) / SYMRATE
    L = int(seconds * SAMPRATE)
    rng = np.random.default_rng(0)
    if distinct_frames:
        per_chan = np.stack([testsignal.random_frames(rng, nsynth)
                             for _ in range(nchan)])
    else:
        frames = testsignal.random_frames(rng, nsynth)
        per_chan = np.broadcast_to(frames, (nchan, *frames.shape))
    carriers = jnp.asarray(20_000.0 + 137.0 * np.arange(nchan), jnp.float32)
    amp = min(12_000.0, 30_000.0 / nchan)
    wide = np.asarray(jsignal.synthesize_wideband_device(
        jnp.asarray(per_chan), carriers, jax.random.PRNGKey(0), L, nchan,
        samprate=SAMPRATE, symrate=SYMRATE, amplitude=amp,
        noise_std=1500.0 * amp / 12_000.0,
    ))
    ri = np.stack([wide.real, wide.imag], -1).reshape(-1)
    raw = np.clip(np.trunc(ri), -32767, 32767).astype(np.int16)
    return per_chan, wide, raw


def _assert_same(rec_t, ss_t, rec_j, ss_j):
    np.testing.assert_array_equal(ss_t, ss_j)
    for f in ("data", "good", "decoder", "start_symbol"):
        np.testing.assert_array_equal(getattr(rec_t, f), getattr(rec_j, f), f)


@pytest.fixture(scope="module")
def two_slots():
    return _capture(nchan=2, nsynth=3)


@pytest.mark.parametrize("form", ["int16", "packed", "complex"])
def test_receive_block_wideband_matches_jax(two_slots, form):
    """2 channel slots in one capture, each input form: the port's frames
    are the JAX package's, and every one decodes and was transmitted."""
    per_chan, wide, raw = two_slots
    x = {"int16": raw, "packed": raw.view(np.int32), "complex": wide}[form]
    cfg = _cfg()
    rec_j, ss_j = jpipe.receive_block_wideband(x, 2, 1, cfg)
    _kernels.reset_launches()
    rec_t, ss_t = tpipe.receive_block_wideband(
        torch.from_numpy(x), 2, 1, convert.pipeline_config(cfg), device="cpu")
    _assert_same(rec_t, ss_t, rec_j, ss_j)
    assert _kernels.backend_used["channelizer"] == "torch"
    assert rec_t.good.all()
    for c, row in enumerate(rec_t.data):
        assert any(np.array_equal(row, f) for f in per_chan[c])


def test_wideband_raw_forms_agree(two_slots):
    """The front end alone: the int16 and packed forms of one recording
    give the same per-channel raw, of the plain bank's length."""
    _, _, raw = two_slots
    a = tpipe.wideband_raw(torch.from_numpy(raw), 2)
    b = tpipe.wideband_raw(torch.from_numpy(raw.view(np.int32)), 2)
    assert a.dtype == torch.int16
    assert tuple(a.shape) == (2, 2 * (raw.size // 4 - 8 + 1))
    assert torch.equal(a, b)


def test_wideband_fused_front_end_feeds_demod_like_jax():
    """Packed input at a channel count inside the kernel's gate takes the
    fused front end (its plain version here, on the CPU); its raw drives
    the per-channel demod to the soft symbols the JAX kernel's raw
    (interpret mode) gives, at a small rate."""
    nchan = 128
    cfg = jpipe.PipelineConfig(
        pm=PMConfig(samprate=8192.0, binsize=8.0, search_width=400.0),
        sym=SymConfig(samprate=8192.0, symrate=64.0, window=0.25),
    )
    rng = np.random.default_rng(3)
    nfr = 7 * 1024
    i = rng.integers(-20000, 20000, nfr * nchan).astype(np.int32)
    q = rng.integers(-20000, 20000, nfr * nchan).astype(np.int32)
    packed = (i & 0xFFFF) | (q << 16)
    _kernels.reset_launches()
    raw_t = tpipe.wideband_raw(torch.from_numpy(packed), nchan)
    assert _kernels.backend_used["channelizer"] == "torch"
    assert _kernels.LAUNCHES["channelize"] == 0  # no kernel on a CPU tensor
    raw_j = np.asarray(channelize_raw_fused(jnp.asarray(packed), nchan, 8,
                                            tile=256, interpret=True))
    n = raw_j.shape[1]
    soft_j, _, _, _ = jpipe.demod_to_symbols(jnp.asarray(raw_j), cfg)
    soft_t, _, _, _ = tpipe.demod_to_symbols(raw_t[:, :n].contiguous(),
                                             convert.pipeline_config(cfg))
    a = soft_t.numpy().astype(np.int32)
    b = np.asarray(soft_j, np.int32)
    assert a.shape == b.shape and a.size > 0
    # ±1 LSB front-end differences perturb the demod gain marginally
    assert np.abs(a - b).max() <= 3
    assert (a != b).mean() < 0.02


def test_synthesize_wideband_matches_jax_without_noise():
    """The spectrum splice: the port's capture equals the JAX package's to
    1e-3 of the amplitude (float32 phase and two FFT libraries; short
    enough that the float32 phase ramp stays fine-grained)."""
    nchan, L = 4, 4096
    frames = testsignal.random_frames(np.random.default_rng(1), 1)
    per_chan = np.ascontiguousarray(np.broadcast_to(frames, (nchan, 1, 128)))
    carriers = (2000.0 + 137.0 * np.arange(nchan)).astype(np.float32)
    want = np.asarray(jsignal.synthesize_wideband_device(
        jnp.asarray(per_chan), jnp.asarray(carriers), jax.random.PRNGKey(0), L,
        nchan, samprate=32768.0, symrate=512.0, amplitude=5000.0))
    got = tsignal.synthesize_wideband_device(
        torch.from_numpy(per_chan), torch.from_numpy(carriers), None, L, nchan,
        samprate=32768.0, symrate=512.0, amplitude=5000.0)
    assert got.dtype == torch.complex64 and tuple(got.shape) == (nchan * L,)
    assert np.abs(got.numpy() - want).max() <= 1e-3 * 5000.0
    # with noise: the generator's draw differs, its level does not
    gen = torch.Generator().manual_seed(0)
    noisy = tsignal.synthesize_wideband_device(
        torch.from_numpy(per_chan), torch.from_numpy(carriers), gen, L, nchan,
        samprate=32768.0, symrate=512.0, amplitude=5000.0, noise_std=700.0)
    resid = noisy.numpy() - got.numpy()
    # nchan slots of noise, each of std 700 per component, add in power
    assert abs(resid.real.std() / (700.0 * np.sqrt(nchan)) - 1.0) < 0.1


def _blocks(nblocks: int):
    cfg = jpipe.PipelineConfig(
        pm=PMConfig(samprate=32768.0, binsize=4.0, search_width=100.0),
        sym=SymConfig(samprate=32768.0, symrate=512.0, window=0.5),
        decode=DecodeConfig(viterbi_enabled=False, fano_tier1_maxcycles=1,
                            fano_maxcycles=3),
    )
    rng = np.random.default_rng(21)
    frames = testsignal.random_frames(rng, 3)
    out = []
    for b in range(nblocks):
        iqs = [testsignal.iq_to_int16(testsignal.synthesize_iq(
            frames, samprate=32768.0, symrate=512.0,
            carrier=5000.0 + 1100.0 * c, noise_std=900.0,
            lead_symbols=30 + 7 * b, rng=rng)) for c in range(2)]
        L = min(len(q) for q in iqs)
        out.append(np.stack([q[:L] for q in iqs]))
    return convert.pipeline_config(cfg), out


@pytest.mark.parametrize("depth", [1, 2])
def test_receive_blocks_pipelined_equals_receive_block(depth):
    """Three different blocks: the pipelined generator yields, in order, what
    receive_block gives for each."""
    cfg, blocks = _blocks(3)
    want = [tpipe.receive_block(b, 1, cfg, device="cpu") for b in blocks]
    gen = tpipe.receive_blocks_pipelined(iter(blocks), 1, cfg, depth=depth,
                                         device="cpu")
    got = list(gen)
    assert len(got) == len(want)
    for (rec_g, ss_g), (rec_w, ss_w) in zip(got, want):
        _assert_same(rec_g, ss_g, rec_w, ss_w)
        np.testing.assert_array_equal(rec_g.fano_cycles, rec_w.fano_cycles)
    # the three blocks differ, so order matters
    assert not np.array_equal(want[0][1], want[2][1])


def test_pipelined_first_block_matches_jax():
    """Against the JAX package's pipelined generator: block 0 of the same
    stream."""
    cfg, blocks = _blocks(1)
    jcfg = jpipe.PipelineConfig(
        pm=PMConfig(samprate=32768.0, binsize=4.0, search_width=100.0),
        sym=SymConfig(samprate=32768.0, symrate=512.0, window=0.5),
        decode=DecodeConfig(viterbi_enabled=False, fano_tier1_maxcycles=1,
                            fano_maxcycles=3),
    )
    (rec_j, ss_j), = list(jpipe.receive_blocks_pipelined(blocks, 1, jcfg))
    (rec_t, ss_t), = list(tpipe.receive_blocks_pipelined(blocks, 1, cfg,
                                                         device="cpu"))
    _assert_same(rec_t, ss_t, rec_j, ss_j)


def test_run_wideband_and_run_pipeline_decode_a_slot():
    """run_wideband (complex capture → plain bank → stream decode) finds
    the transmitted frames in the selected slot, as the JAX one does."""
    nchan, L = 2, int((3 * 2048 + 400) / 512.0 * 32768.0)
    frames = testsignal.random_frames(np.random.default_rng(2), 3)
    per_chan = np.ascontiguousarray(np.broadcast_to(frames, (nchan, 3, 128)))
    carriers = np.array([3000.0, 3137.0], np.float32)
    wide = tsignal.synthesize_wideband_device(
        torch.from_numpy(per_chan), torch.from_numpy(carriers),
        torch.Generator().manual_seed(1), L, nchan, samprate=32768.0,
        symrate=512.0, amplitude=6000.0, noise_std=300.0).numpy()
    jcfg = jpipe.PipelineConfig(
        pm=PMConfig(samprate=32768.0, binsize=4.0, search_width=100.0),
        sym=SymConfig(samprate=32768.0, symrate=512.0, window=0.5),
        decode=DecodeConfig(viterbi_enabled=False),
    )
    res_j = jpipe.run_wideband(wide, 65536.0, nchan, channels=[1], cfg=jcfg)
    res_t = tpipe.run_wideband(wide, 65536.0, nchan, channels=[1],
                               cfg=convert.pipeline_config(jcfg), device="cpu")
    assert res_t.soft_symbols.shape == res_j.soft_symbols.shape
    assert len(res_t.frames) == len(res_j.frames) >= 1
    for rt, rj in zip(res_t.frames, res_j.frames):
        np.testing.assert_array_equal(rt.data, rj.data)
        np.testing.assert_array_equal(rt.good, rj.good)
        np.testing.assert_array_equal(rt.decoder, rj.decoder)
    good = [r for r in res_t.frames if r.good[0]]
    assert good and all(any(np.array_equal(r.data[0], f) for f in frames)
                        for r in good)


def test_wideband_entry_points_need_a_card_or_cpu():
    """No silent CPU run: without a card the entry points raise unless
    device="cpu" is passed."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tpipe.receive_block_wideband(np.zeros(64, np.int32), 2, 1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        next(tpipe.receive_blocks_pipelined([np.zeros((1, 64), np.int16)], 1))


@pytest.mark.slow
def test_wideband_distinct_channels_full_block_matches_jax():
    """4 slots carrying different frame streams, 2 frames per channel:
    the port's frames equal the JAX package's, and a neighbour's frames
    never appear in a slot."""
    nchan, ndec = 4, 2
    per_chan, _, raw = _capture(nchan, nsynth=4, distinct_frames=True)
    cfg = _cfg()
    rec_j, ss_j = jpipe.receive_block_wideband(raw, nchan, ndec, cfg)
    rec_t, ss_t = tpipe.receive_block_wideband(
        torch.from_numpy(raw), nchan, ndec, convert.pipeline_config(cfg),
        device="cpu")
    _assert_same(rec_t, ss_t, rec_j, ss_j)
    assert rec_t.good.all()
    d = rec_t.data.reshape(nchan, ndec, 128)
    for c in range(nchan):
        for f in range(ndec):
            assert any(np.array_equal(d[c, f], fr) for fr in per_chan[c])
