"""PyTorch port vs the JAX package: the reference's other two operational
modes (SURVEY.md:48-49, CHANGES:37-41) through the port's chain on the
CPU — 2048 bps (4096 sym/s, 0.5 s frames) and 16 bps on the 1024 Hz
subcarrier (32 sym/s, 32 clocks a symbol, 64 s frames).

Counterparts of tests/test_subcarrier_mode.py and
tests/test_mode_2048bps.py at reduced sample rates; the port runs its
kernels' plain versions (K1/K2 carrier, K3 prefix sum, K4 Fano walk).

Summation trap: the JAX package's timing search takes its grouped tier
in every one of these modes (ops/symbols._symbol_group_plan) and sums
each offset's energy group by group, in float32 unless x64 is on; the
port sums over all symbols at once in float64.  The suite runs JAX with
x64 on (tests/conftest.py), so both sums are float64 and exact while
they stay below 2^53; the tests below hold symphase and energy exactly
and would show it if the order moved an argmax.
"""

from __future__ import annotations

import io
import sys
from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isee3_decoder_tpu.models import pipeline as jpipe
from isee3_decoder_tpu.models.decode import (
    DECODER_FANO,
    DECODER_QLEC,
    DECODER_VITERBI,
    DecodeConfig,
)
from isee3_decoder_tpu.ops import prefix_pallas as jpp
from isee3_decoder_tpu.ops import symbols as jsym
from isee3_decoder_tpu.ops.carrier import PMConfig
from isee3_decoder_tpu.ops.symbols import SymConfig
from isee3_decoder_tpu.utils import testsignal
from isee3_decoder_tpu_torch.cli import symdemod as tsd_cli
from isee3_decoder_tpu_torch.config import (
    ACTUALCLOCK,
    FRAMESYMBOLS,
    NOMINALCLOCK,
)
from isee3_decoder_tpu_torch.models import pipeline as tpipe
from isee3_decoder_tpu_torch.models import symdemod as tsd
from isee3_decoder_tpu_torch.models.decode import decode_stream
from isee3_decoder_tpu_torch.ops import prefix_cuda as tpp
from isee3_decoder_tpu_torch.ops import symbols as tsym
from isee3_decoder_tpu_torch.utils import convert

# test_subcarrier_mode.py's shape: 32,768 sps, 32 sym/s, 32 clocks
SUB_FS = 32768.0
SUB_CFG = jpipe.PipelineConfig(
    pm=PMConfig(samprate=SUB_FS, binsize=8.0, search_width=100.0),
    sym=SymConfig(samprate=SUB_FS, symrate=32.0, symbolclocks=32),
)
# test_mode_2048bps.py's configuration at 65,536 sps (16 samples a
# symbol): binsize 4 → 16,384-sample pm blocks, the search window on
FAST_FS = 65536.0
FAST_CFG = jpipe.PipelineConfig(
    pm=PMConfig(samprate=FAST_FS, binsize=4.0, search_width=200.0),
    sym=SymConfig(samprate=FAST_FS, symrate=4096.0, window=0.5),
    decode=DecodeConfig(fano_tier1_maxcycles=1, fano_maxcycles=3),
)


def _subcarrier_iq() -> np.ndarray:
    """test_subcarrier_mode.py's signal: 160 random symbols (5 s), carrier
    4096 Hz, mod index 0.7, noise 300."""
    rng = np.random.default_rng(0)
    syms = rng.integers(0, 2, 160).astype(np.uint8)
    wave = testsignal.manchester_waveform(syms, SUB_FS / 32.0, symbolclocks=32)
    t = np.arange(len(wave))
    iq = 9000 * np.exp(1j * (2 * np.pi * 4096.0 * t / SUB_FS + 0.7 * wave
                             + 0.4))
    iq = iq + rng.normal(0, 300, len(wave)) + 1j * rng.normal(0, 300,
                                                             len(wave))
    return iq, syms


def test_subcarrier_demod_to_symbols_matches_jax():
    """demod_to_symbols in the 16 bps subcarrier mode: soft symbols equal
    JAX's, the baseband within 1 LSB (the package's own tolerance), the
    carrier found; and on one prefix sum both symbol demodulators give
    the same phases, energies and window starts."""
    iq, syms = _subcarrier_iq()
    tcfg = convert.pipeline_config(SUB_CFG)
    soft_j, bb_j, freq_j, _ = jpipe.demod_to_symbols(jnp.asarray(iq), SUB_CFG)
    soft_t, bb_t, freq_t, _ = tpipe.demod_to_symbols(
        torch.from_numpy(iq.astype(np.complex64)), tcfg)
    diff = np.abs(bb_t.numpy().astype(np.int32) - np.asarray(bb_j, np.int32))
    assert diff.max() <= 1
    np.testing.assert_array_equal(soft_t.numpy(), np.asarray(soft_j))
    assert abs(float(freq_t[-1, 0]) - 4096.0) < 2.0
    hard = (soft_t.numpy()[0] > 128).astype(np.uint8)
    # aligned within 2 symbols, as test_subcarrier_mode.py allows
    assert max((hard[: syms.size - off] == syms[off : off + hard.size]).mean()
               for off in range(3)) > 0.95

    # the symbol stage alone on JAX's baseband gives JAX's soft symbols
    # (a second JAX program in this mode would cost its ~20 s compile)
    bb = torch.from_numpy(np.array(bb_j, np.int16))
    _, out_t = tsd.symdemod_scan(bb, tcfg.sym, soft_t.shape[1] // 32)
    np.testing.assert_array_equal(
        out_t.soft.transpose(0, 1).reshape(1, -1).numpy(), np.asarray(soft_j))


def _mode_baseband(jcfg, seed: int = 5) -> tuple[np.ndarray, np.ndarray]:
    """Two channels of Manchester baseband (int16) for one window of
    ``jcfg`` plus the timing search's reach, and their start samples."""
    rng = np.random.default_rng(seed)
    clocks = jcfg.symbolclocks
    nsamples = int(jcfg.window * jcfg.samprate) + 2 * jcfg.noffsets + 64
    syms = rng.integers(0, 2, int(nsamples / jcfg.symbolsamples) + 2)
    wave = testsignal.manchester_waveform(syms, jcfg.symbolsamples, nsamples,
                                          symbolclocks=clocks)
    bb = np.stack([np.round(3000 * wave + rng.normal(0, 900, nsamples)),
                   np.round(-2500 * np.roll(wave, 37)
                            + rng.normal(0, 900, nsamples))]).astype(np.int16)
    return bb, np.array([jcfg.noffsets // 2 + 3, jcfg.noffsets])


def _timesearch_and_integrate(jcfg, search: bool = True) -> None:
    """The port's timesearch and integrate_symbols against JAX's on
    _mode_baseband: phases, energies, soft symbols and integrators
    exact.  Without ``search`` the integration runs at the start samples
    with a fixed gain."""
    bb, first = _mode_baseband(jcfg)
    args = (jcfg.halfclock, jcfg.nsymbols, jcfg.symbolclocks)
    at = first
    gain = np.full(2, 0.02)
    if search:
        ts_j = jsym.timesearch(jnp.asarray(bb), jnp.asarray(first), *args,
                               jcfg.noffsets)
        ts_t = tsym.timesearch(torch.from_numpy(bb), torch.from_numpy(first),
                               *args, jcfg.noffsets)
        np.testing.assert_array_equal(ts_t.symphase.numpy(),
                                      np.asarray(ts_j.symphase))
        np.testing.assert_array_equal(ts_t.maxenergy.numpy(),
                                      np.asarray(ts_j.maxenergy))
        at = first + ts_t.symphase.numpy()
        gain = 100.0 / np.sqrt(ts_t.maxenergy.numpy())
    res_j = jsym.integrate_symbols(jnp.asarray(bb), jnp.asarray(at), *args,
                                   jnp.asarray(gain))
    res_t = tsym.integrate_symbols(torch.from_numpy(bb), torch.from_numpy(at),
                                   *args, torch.from_numpy(gain))
    for f in ("soft", "integrators", "energy"):
        np.testing.assert_array_equal(getattr(res_t, f).numpy(),
                                      np.asarray(getattr(res_j, f)), f)


def test_timesearch_and_integrate_match_jax_2048bps():
    """ops/symbols timesearch and integrate_symbols against JAX's at
    SymConfig(symrate=4096.0, window=0.5), 65,536 sps, two channels at
    different starts."""
    _timesearch_and_integrate(SymConfig(samprate=FAST_FS, symrate=4096.0,
                                        window=0.5))


def test_integrate_symbols_matches_jax_16bps_250ksps():
    """integrate_symbols against JAX's at SymConfig(symrate=32.0,
    symbolclocks=32), 250 ksps: a 7812.5-sample symbol of 64 half-cycles
    of 122.07 samples (the absolute edge rounding's half-sample ties)."""
    _timesearch_and_integrate(SymConfig(samprate=250_000.0, symrate=32.0,
                                        symbolclocks=32), search=False)


@pytest.mark.slow
@pytest.mark.parametrize("fs", [32768.0, 250_000.0])
def test_timesearch_and_integrate_match_jax_16bps(fs):
    """timesearch and integrate_symbols against JAX's in the 16 bps
    subcarrier mode.  Slow: JAX compiles its grouped tier here as ~65
    edge terms for each of ~70-130 offset pieces of a symbol group, 20 s
    to minutes of XLA compile (the port's gather takes a second)."""
    _timesearch_and_integrate(SymConfig(samprate=fs, symrate=32.0,
                                        symbolclocks=32, window=0.25))


def test_k3_plain_wraps_past_2_31_as_jax():
    """K3 at the 16 bps row length wraps its exclusive int32 prefix past
    2^31 (a row of ~48 M samples).  The plain twin (what the kernel is
    held to on the card) wraps as the JAX prefix sum and the JAX kernel
    do, and the integrators, differences of the wrapped sums, stay exact
    mod 2^32: here a row of 32767s and -32768s passes 2^31 and -2^31."""
    T, B, n = 3, 8, 32768  # the JAX kernel takes channels in eights
    rng = np.random.default_rng(2)
    blocks = rng.integers(-32768, 32768, (T, B, n)).astype(np.int16)
    blocks[:, 0] = 32767
    blocks[:, 1] = -32768
    flat = np.swapaxes(blocks, 0, 1).reshape(B, T * n)
    want = np.asarray(jsym.prefix_sum(jnp.asarray(flat), pad_to=T * n + 2))
    got = tpp.prefix_sum_blocks(torch.from_numpy(blocks), tail=3)
    np.testing.assert_array_equal(got.numpy(), want)
    exact = np.concatenate([np.zeros((B, 1)), np.cumsum(flat, axis=1,
                                                         dtype=np.int64)],
                           axis=1)
    assert exact[0, -1] > 2**31 and exact[1, -1] < -(2**31)
    np.testing.assert_array_equal(
        np.asarray(jpp.prefix_sum_blocks(jnp.asarray(blocks), interpret=True)),
        got.numpy()[:, : T * n])
    cfg = SymConfig(samprate=SUB_FS, symrate=32.0, symbolclocks=32)
    first = 100 + 4111 * np.arange(B)
    args = (cfg.halfclock, 2, 32)
    integ_t = tsym.integrate_from_csum(got, torch.from_numpy(first), *args)
    integ_j = jsym.integrate_from_csum(jnp.asarray(want), jnp.asarray(first),
                                       *args)
    np.testing.assert_array_equal(integ_t.numpy(), np.asarray(integ_j))
    # the same integrators from the exact (int64) prefix sum
    integ_x = tsym.integrate_from_csum(torch.from_numpy(exact), torch.from_numpy(
        first), *args)
    np.testing.assert_array_equal(integ_t.numpy(), integ_x.numpy())


def _fast_recording(nframes_tx: int, noises, seed: int = 1):
    """2048 bps at 65,536 sps: random frames after a 20-symbol lead (the
    first sync inside the first search window), one channel per noise
    level, carriers 9 kHz + 1.1 kHz·i."""
    rng = np.random.default_rng(seed)
    frames = testsignal.random_frames(rng, nframes_tx)
    iqs = [testsignal.iq_to_int16(testsignal.synthesize_iq(
        frames, samprate=FAST_FS, symrate=4096.0, carrier=9000.0 + 1100.0 * i,
        noise_std=ns, lead_symbols=20, rng=rng)) for i, ns in enumerate(noises)]
    L = min(len(q) for q in iqs)
    return frames, np.stack([q[:L] for q in iqs])


def test_receive_block_2048bps_matches_jax():
    """receive_block in the 2048 bps mode at 65,536 sps: the port's frame
    bytes, good flags, decoder labels, start symbols and sync starts equal
    JAX's, every good frame a sent one, the clean channel's frames all
    decoded; the noisy channel's lanes take quicklook, QLEC and Fano."""
    frames, iq = _fast_recording(8, [600.0, 14000.0])
    tcfg = convert.pipeline_config(FAST_CFG)
    soft = tpipe.demod_to_symbols(torch.from_numpy(iq), tcfg)[0]
    # whole frames after the first sync (20 lead symbols + frame 0)
    nframes = (soft.shape[1] - 20 - FRAMESYMBOLS) // FRAMESYMBOLS
    assert nframes >= 3
    rec_j, ss_j = jpipe.receive_block(iq, nframes, FAST_CFG)
    rec_t, ss_t = tpipe.receive_block(torch.from_numpy(iq), nframes, tcfg,
                                      device="cpu")
    np.testing.assert_array_equal(ss_t, ss_j)
    for f in ("data", "good", "decoder", "start_symbol"):
        np.testing.assert_array_equal(getattr(rec_t, f), getattr(rec_j, f), f)
    sent = {f.tobytes() for f in frames}
    assert all(d.tobytes() in sent for g, d in zip(rec_t.good, rec_t.data)
               if g)
    assert rec_t.good[:nframes].all()
    assert {DECODER_QLEC, DECODER_FANO} <= set(rec_t.decoder.tolist())
    # run_pipeline (the stream decode of the whole recording), as
    # test_mode_2048bps.py drives it
    res_j = jpipe.run_pipeline(iq, FAST_CFG)
    res_t = tpipe.run_pipeline(torch.from_numpy(iq), tcfg, device="cpu")
    assert len(res_t.frames) == len(res_j.frames) >= nframes
    for rt, rj in zip(res_t.frames, res_j.frames):
        for f in ("data", "good", "decoder", "start_symbol"):
            np.testing.assert_array_equal(getattr(rt, f), getattr(rj, f), f)


# 2048 bps at the bench's threshold Eb/N0: noise 110,000 at 1024 sym/s
# and 61 samples a symbol is 55,000 at 4x the symbol rate, ~28,000 at 16
# samples a symbol; at 30,000 the noisy channel's last lane fails the Fano
# walk under FAST_CFG's caps (1 and 3 cycles a bit) after a good frame, so
# the gated Viterbi fallback takes it
FAST_NOISE_THRESHOLD = 30_000.0


def _receive_block_threshold(viterbi: bool):
    """receive_block at 2048 bps on a clean and a threshold channel through
    both packages, with the Viterbi fallback on or off: equal records and
    sync starts, every good frame a sent one.  Returns the port's
    records."""
    import dataclasses

    frames, iq = _fast_recording(8, [600.0, FAST_NOISE_THRESHOLD])
    jcfg = dataclasses.replace(FAST_CFG, decode=dataclasses.replace(
        FAST_CFG.decode, viterbi_enabled=viterbi))
    tcfg = convert.pipeline_config(jcfg)
    nframes = 4  # whole frames after the first sync, as the clean test's
    rec_j, ss_j = jpipe.receive_block(iq, nframes, jcfg)
    rec_t, ss_t = tpipe.receive_block(torch.from_numpy(iq), nframes, tcfg,
                                      device="cpu")
    np.testing.assert_array_equal(ss_t, ss_j)
    for f in ("data", "good", "decoder", "start_symbol"):
        np.testing.assert_array_equal(getattr(rec_t, f), getattr(rec_j, f), f)
    sent = {f.tobytes() for f in frames}
    assert all(d.tobytes() in sent for g, d in zip(rec_t.good, rec_t.data)
               if g)
    assert rec_t.good[:nframes].all()
    return rec_t


def test_receive_block_2048bps_threshold_matches_jax():
    """The threshold channel with the Viterbi fallback off: the lane the
    Fano walk deletes is a bad frame labeled Fano in both packages, the
    other lanes decode."""
    rec = _receive_block_threshold(viterbi=False)
    bad = ~rec.good
    assert bad.sum() == 1 and (rec.decoder[bad] == DECODER_FANO).all()
    assert DECODER_FANO in rec.decoder[4:] and DECODER_VITERBI not in \
        rec.decoder


@pytest.mark.slow
def test_receive_block_2048bps_threshold_viterbi_matches_jax():
    """The same with the Viterbi fallback on: the deleted lane decodes by
    Viterbi (K5/K6's plain versions at K=24, minutes on the CPU; JAX's
    "jnp" decoder), to the sent frame, in both packages."""
    rec = _receive_block_threshold(viterbi=True)
    assert rec.good.all()
    assert DECODER_VITERBI in rec.decoder


def _stream_chunked_vs_one_call(raw: np.ndarray, cfg, cuts) -> tuple:
    """receive_stream over consecutive cuts against demod_to_symbols +
    decode_stream on the whole recording: the flat records and the soft
    symbols of both."""
    soft1 = tpipe.demod_to_symbols(torch.from_numpy(raw[None, :]), cfg)[0]
    recs1, _ = decode_stream(soft1, cfg.decode, device="cpu")
    carry = tpipe.init_chain_carry(1, cfg, device="cpu")
    recs2 = []
    for lo, hi in zip(cuts[:-1], cuts[1:]):
        recs, carry = tpipe.receive_stream(torch.from_numpy(raw[None, lo:hi]),
                                           cfg, carry, trim=False)
        recs2.extend(recs)

    def flat(records):
        return [(int(r.start_symbol[b]), bool(r.good[b]), int(r.decoder[b]),
                 bytes(r.data[b])) for r in records
                for b in range(r.data.shape[0])]

    return flat(recs1), flat(recs2), soft1.numpy(), carry


def test_receive_stream_chunked_equals_one_call_2048bps():
    """The streaming chain in the 2048 bps mode: ragged chunks (one
    shorter than a pm block, one that ends inside a window) give one
    call's frames and soft symbols."""
    frames, iq = _fast_recording(6, [600.0])
    raw = iq[0]
    cfg = convert.pipeline_config(FAST_CFG)
    cuts = [0, 5000, 5000 + 2 * 65536, 5000 + 2 * 65536 + 77777, len(raw)]
    flat1, flat2, soft1, carry = _stream_chunked_vs_one_call(raw, cfg, cuts)
    assert flat2 == flat1
    assert sum(g for _, g, _, _ in flat1) >= 2
    assert carry.soft_base == 0
    np.testing.assert_array_equal(carry.soft.numpy(), soft1)


def test_receive_stream_chunked_equals_one_call_16bps():
    """The streaming chain in the 16 bps subcarrier mode (7812.5-sample
    symbols at 250 ksps: the window rule and the even baseband slide at a
    half-sample symbol): ragged chunks give one call's soft symbols, window
    by window.  No whole 64 s frame fits a tier-1 run; the frames of this
    mode are the slow test below and chip_smoke.py phase 20."""
    fs = 250_000.0
    jcfg = jpipe.PipelineConfig(
        pm=PMConfig(samprate=fs, binsize=4.0, search_width=100.0),
        sym=SymConfig(samprate=fs, symrate=32.0, symbolclocks=32),
    )
    cfg = convert.pipeline_config(jcfg)
    rng = np.random.default_rng(8)
    frames = testsignal.random_frames(rng, 1)
    iq = testsignal.synthesize_iq(frames, samprate=fs, symrate=32.0,
                                  carrier=20_000.0, mod_index=0.7,
                                  noise_std=2500.0, symbolclocks=32,
                                  lead_symbols=20, rng=rng)
    raw = testsignal.iq_to_int16(iq[: int(6.5 * fs)])
    cuts = [0, 3000, 3000 + 2 * 65536 * 3 + 1234, 2 * int(3.7 * fs),
            len(raw)]
    flat1, flat2, soft1, carry = _stream_chunked_vs_one_call(raw, cfg, cuts)
    assert flat2 == flat1
    assert soft1.shape[1] == 5 * 32
    assert carry.windows_done == 5
    np.testing.assert_array_equal(carry.soft.numpy(), soft1)


@pytest.mark.slow
def test_16bps_full_frames_match_jax():
    """test_mode16bps_and_fer.py's full-frame case (8192 sps, 3 frames,
    frame 0 before the first usable sync) through both packages: the same
    soft symbols, and the port's decode_stream gives JAX's frames, frame
    1 among them."""
    from isee3_decoder_tpu.models.decode import decode_stream as jdecode

    fs = 8192.0
    rng = np.random.default_rng(42)
    frames = testsignal.random_frames(rng, 3)
    iq = testsignal.synthesize_iq(frames, samprate=fs, symrate=32.0,
                                  carrier=1700.0, mod_index=0.7,
                                  amplitude=9000.0, noise_std=350.0,
                                  symbolclocks=32, lead_symbols=20, rng=rng)
    jcfg = jpipe.PipelineConfig(
        pm=PMConfig(samprate=fs, binsize=8.0, search_width=100.0),
        sym=SymConfig(samprate=fs, symrate=32.0, symbolclocks=32),
    )
    tcfg = convert.pipeline_config(jcfg)
    soft_j = np.asarray(jpipe.demod_to_symbols(jnp.asarray(iq), jcfg)[0])
    soft_t = tpipe.demod_to_symbols(torch.from_numpy(iq.astype(np.complex64)),
                                    tcfg)[0]
    np.testing.assert_array_equal(soft_t.numpy(), soft_j)
    recs_j, _ = jdecode(soft_j, jcfg.decode)
    recs_t, _ = decode_stream(soft_t, tcfg.decode, device="cpu")
    assert len(recs_t) == len(recs_j)
    for rt, rj in zip(recs_t, recs_j):
        for f in ("data", "good", "decoder", "start_symbol"):
            np.testing.assert_array_equal(getattr(rt, f), getattr(rj, f), f)
    assert any(r.good[0] and bytes(r.data[0]) == bytes(frames[1])
               for r in recs_t)


@pytest.mark.slow
def test_16bps_window_inversion_matches_jax():
    """test_mode16bps_and_fer.py's full-frame case at noise 16,000 (Es/N0
    ≈ 12 dB) through both packages.  The window-start search of window 64
    takes a start +4 samples off (half a cycle of the 8-sample
    subcarrier), which inverts every symbol of the window and loses
    almost no energy; window 65 takes -4 back.  So symbols 2048-2079 come
    out inverted and no other symbol is wrong.  The inverted window holds
    the sync word before frame 1: the sync search takes a false start
    (symbol 1125), where the Fano walk fails.  The port gives JAX's soft
    symbols, symbol phases and records; a change that mends or moves the
    inversion in one package shows here.  Slow: JAX compiles its 16 bps
    programs for minutes, and the plain Fano walk runs the false start to
    its budget."""
    from isee3_decoder_tpu.models import symdemod as jsymdemod
    from isee3_decoder_tpu.models.decode import decode_stream as jdecode

    fs = 8192.0
    rng = np.random.default_rng(42)
    frames = testsignal.random_frames(rng, 3)
    lead = np.random.default_rng(42)
    testsignal.random_frames(lead, 3)
    sent = np.concatenate([lead.integers(0, 2, 20).astype(np.uint8),
                           testsignal.frames_to_symbols(frames)])
    iq = testsignal.synthesize_iq(frames, samprate=fs, symrate=32.0,
                                  carrier=1700.0, mod_index=0.7,
                                  amplitude=9000.0, noise_std=16_000.0,
                                  symbolclocks=32, lead_symbols=20, rng=rng)
    jcfg = jpipe.PipelineConfig(
        pm=PMConfig(samprate=fs, binsize=8.0, search_width=100.0),
        sym=SymConfig(samprate=fs, symrate=32.0, symbolclocks=32),
    )
    tcfg = convert.pipeline_config(jcfg)
    soft_j, bb_j, _, _ = jpipe.demod_to_symbols(jnp.asarray(iq), jcfg)
    soft_t, bb_t, _, _ = tpipe.demod_to_symbols(
        torch.from_numpy(iq.astype(np.complex64)), tcfg)
    soft_j, soft_t = np.asarray(soft_j), soft_t.numpy()
    np.testing.assert_array_equal(soft_t, soft_j)
    nwin = soft_t.shape[1] // 32
    _, out_j = jsymdemod.symdemod_scan(bb_j, jcfg.sym, nwin)
    _, out_t = tsd.symdemod_scan(bb_t, tcfg.sym, nwin)
    phase_j = np.asarray(out_j.symphase)[:, 0]
    phase_t = out_t.symphase[:, 0].numpy()
    np.testing.assert_array_equal(phase_t, phase_j)
    assert phase_t[63:67].tolist() == [0, 4, -4, 0]
    for soft in (soft_j, soft_t):
        wrong = np.nonzero((soft[0] > 128).astype(np.uint8)
                           != sent[: soft.shape[1]])[0]
        np.testing.assert_array_equal(wrong, np.arange(2048, 2080))
    recs_j, _ = jdecode(soft_j, jcfg.decode)
    recs_t, _ = decode_stream(soft_t, tcfg.decode, device="cpu")
    assert len(recs_t) == len(recs_j) == 1
    for rt, rj in zip(recs_t, recs_j):
        for f in ("data", "good", "decoder", "start_symbol"):
            np.testing.assert_array_equal(getattr(rt, f), getattr(rj, f), f)
    r = recs_t[0]
    assert (int(r.start_symbol[0]), bool(r.good[0]), int(r.decoder[0])) == (
        1125, False, DECODER_FANO)


@pytest.mark.parametrize("arg,want", [
    ("32", (32.0 * ACTUALCLOCK / NOMINALCLOCK, 32)),
    ("32.", (32.0, 32)),
    ("4096.", (4096.0, 1)),
    ("2048", (2048.0 * ACTUALCLOCK / NOMINALCLOCK, 1)),
])
def test_symdemod_cli_picks_the_mode(arg, want):
    """symdemod's -c (symdemod.c:67-77): no decimal point scales by the
    measured clock, under 1000 Hz is subcarrier mode at 1024 / rate
    clocks a symbol — as the JAX CLI's parse_symrate."""
    from isee3_decoder_tpu.cli.symdemod import parse_symrate as jparse

    got = tsd_cli.parse_symrate(arg)
    assert got == jparse(arg)
    assert got[1] == want[1]
    assert got[0] == pytest.approx(want[0], rel=1e-12)


def _run_cli(main, argv, stdin: bytes) -> tuple[int, bytes]:
    """A CLI's main in this process with stdin fed and stdout caught."""
    fake_out = io.TextIOWrapper(io.BytesIO())
    fake_in = io.TextIOWrapper(io.BytesIO(stdin))
    with mock.patch.object(sys, "stdout", fake_out), \
            mock.patch.object(sys, "stdin", fake_in):
        rc = main(argv)
        fake_out.flush()
        return rc, fake_out.buffer.getvalue()


def _cli_baseband(samprate: float, symrate: float, clocks: int,
                  seconds: float) -> bytes:
    rng = np.random.default_rng(int(symrate))
    nsamples = int(seconds * samprate)
    syms = rng.integers(0, 2, int(seconds * symrate) + 2)
    wave = testsignal.manchester_waveform(syms, samprate / symrate, nsamples,
                                          symbolclocks=clocks)
    return np.round(2000 * wave + rng.normal(0, 300, nsamples)).astype(
        "<i2").tobytes()


CLI_CASES = {
    # 2048 bps: -c 4096. -w 0.5 (tests/test_mode_2048bps.py's window)
    "2048bps": (FAST_FS, 4096.0, 1, 2.3, ["-c", "4096.", "-w", "0.5"]),
    # 16 bps: -c 32 picks 32 clocks a symbol at the measured clock
    "16bps": (SUB_FS, 32.0 * ACTUALCLOCK / NOMINALCLOCK, 32, 5.2,
              ["-c", "32"]),
}


def test_symdemod_cli_bytes_match_jax_2048bps():
    """symdemod -c 4096. -w 0.5: the same soft-symbol bytes on stdout as
    the JAX tool, fed the same baseband."""
    from isee3_decoder_tpu.cli import symdemod as jsd_cli

    fs, symrate, clocks, seconds, args = CLI_CASES["2048bps"]
    bb = _cli_baseband(fs, symrate, clocks, seconds)
    argv = ["-q", "-r", str(int(fs))] + args
    rc_j, want = _run_cli(jsd_cli.main, argv, bb)
    rc_t, got = _run_cli(tsd_cli.main, argv + ["--device", "cpu"], bb)
    assert rc_j == rc_t == 0
    assert len(got) >= (seconds - 1.5) * symrate
    assert got == want


def test_symdemod_cli_16bps_equals_the_library():
    """symdemod -r 32768 -c 32 (subcarrier mode, 32 clocks at the
    measured clock): its window-by-window bytes are symdemod_scan's on the
    whole baseband, which test_subcarrier_demod_to_symbols_matches_jax
    holds to JAX's.  The JAX tool is not run here: on these 5 s of
    subcarrier baseband it did not end within 15 minutes on the CPU."""
    fs, symrate, clocks, seconds, args = CLI_CASES["16bps"]
    bb = _cli_baseband(fs, symrate, clocks, seconds)
    rc, got = _run_cli(tsd_cli.main, ["-q", "-r", str(int(fs))] + args
                       + ["--device", "cpu"], bb)
    assert rc == 0
    symrate_c, clocks_c = tsd_cli.parse_symrate("32")
    cfg = tsym.SymConfig(samprate=fs, symrate=symrate_c, symbolclocks=clocks_c)
    assert clocks_c == 32 and len(got) == 5 * cfg.nsymbols
    x = torch.from_numpy(np.frombuffer(bb, "<i2").copy())[None]
    _, out = tsd.symdemod_scan(x, cfg, len(got) // cfg.nsymbols)
    assert out.soft.transpose(0, 1).reshape(-1).numpy().tobytes() == got
