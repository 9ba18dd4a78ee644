"""PyTorch port vs the JAX package: the decode entry points (block, batch,
stream, CLI), fed identical soft symbols.  Sync start, frame bytes, good
flags, decoder labels, start symbols and Fano cycles must all be exact —
quicklook, QLEC, tier-1 Fano, the host tier-2 re-run and the Viterbi
fallback (with and without the previous-frame gating) included.  The
Viterbi cases use a K=15 code, whose 2^14-state trellis the plain K5/K6
run quickly on the CPU; each of them runs with both of the port's
decoders (``viterbi_backend`` "jnp", the classic API, and "fused", K5/K6)
against the JAX package's default "jnp"."""

import dataclasses
import io
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isee3_decoder_tpu.cli import decode as jcli
from isee3_decoder_tpu.config import CodeSpec
from isee3_decoder_tpu.models import decode as jd
from isee3_decoder_tpu.utils import testsignal
from isee3_decoder_tpu.utils.sim import simulate
from isee3_decoder_tpu_torch import _kernels
from isee3_decoder_tpu_torch.cli import decode as tcli
from isee3_decoder_tpu_torch.models import decode as td
from isee3_decoder_tpu_torch.models import pipeline as tpipe
from isee3_decoder_tpu_torch.ops.viterbi_inplace import stream_create
from isee3_decoder_tpu_torch.utils import convert

NFRAMES = 2
K15 = CodeSpec("TESTK15", 0o46321, 0o51445, 15, 0, 1)
FIELDS = ("data", "good", "decoder", "start_symbol", "fano_cycles")
BACKENDS = pytest.mark.parametrize("backend", ["jnp", "fused"])


def _port_config(cfg, backend=None):
    """The JAX config carried across, with the port's Viterbi decoder
    ``backend`` in place of the JAX one when given."""
    tcfg = convert.decode_config(cfg)
    if backend is None:
        return tcfg
    return dataclasses.replace(tcfg, viterbi_backend=backend)


def _streams(seed: int, sigmas, offs, code=jd.DEFAULT_CODE,
             nframes: int = NFRAMES + 1):
    """Per-channel soft-symbol streams: ``nframes`` frames after a lead of
    erasures, symbol noise sigma per channel (amplitude 100)."""
    rng = np.random.default_rng(seed)
    frames = testsignal.random_frames(rng, nframes)
    syms = testsignal.frames_to_symbols(frames, code)
    key = jax.random.PRNGKey(seed)
    rows = []
    for sigma, off in zip(sigmas, offs):
        key, sub = jax.random.split(key)
        if sigma:
            soft = np.asarray(simulate(sub, jnp.asarray(syms), 100.0, sigma))
        else:
            soft = np.where(syms > 0, 228, 28).astype(np.uint8)
        rows.append(np.concatenate([np.full(off, 128, np.uint8), soft]))
    L = max(len(r) for r in rows)
    return frames, np.stack([np.pad(r, (0, L - len(r)), constant_values=128)
                             for r in rows])


def _same(rec_t, rec_j):
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(rec_t, f), getattr(rec_j, f), f)


def _compare(soft, cfg, backend=None):
    rec_j, ss_j = jd.decode_block(jnp.asarray(soft), NFRAMES, cfg)
    rec_t, ss_t = td.decode_block(torch.from_numpy(soft), NFRAMES,
                                  _port_config(cfg, backend), device="cpu")
    np.testing.assert_array_equal(ss_t, ss_j)
    _same(rec_t, rec_j)
    return rec_t


def test_decode_block_matches_jax_all_tiers():
    """Clean, scattered-error and noisy channels: quicklook, QLEC and
    Fano lanes in one block; a tier-1 cap of 1 cycle/bit sends the
    backtracking Fano lanes through the host tier-2 re-run."""
    frames, soft = _streams(3, [0.0, 28.0, 38.0, 44.0], [5, 20, 33, 12])
    cfg = jd.DecodeConfig(viterbi_enabled=False, fano_tier1_maxcycles=1,
                          fano_maxcycles=5)
    rec = _compare(soft, cfg)
    labels = set(rec.decoder.tolist())
    assert {td.DECODER_QUICKLOOK, td.DECODER_QLEC, td.DECODER_FANO} <= labels, labels
    fano = rec.decoder == td.DECODER_FANO
    assert (rec.fano_cycles[fano] > 1024).any(), "no lane reached tier 2"
    good = rec.good.reshape(-1, NFRAMES)
    data = rec.data.reshape(-1, NFRAMES, 128)
    for ch, f in zip(*np.nonzero(good)):
        np.testing.assert_array_equal(data[ch, f], frames[f + 1])


def test_decode_block_strict_labels_matches_jax():
    """Reference labels (no QLEC tier): scattered errors go to Fano."""
    _, soft = _streams(4, [0.0, 30.0, 40.0], [7, 3, 25])
    cfg = jd.DecodeConfig.strict_labels(viterbi_enabled=False,
                                        fano_tier1_maxcycles=2, fano_maxcycles=4)
    rec = _compare(soft, cfg)
    assert td.DECODER_QLEC not in rec.decoder
    assert (rec.decoder == td.DECODER_FANO).sum() >= 2


@BACKENDS
def test_decode_block_viterbi_lanes_match_jax(backend):
    """Lanes the tier-2 Fano walk leaves undecoded go to the Viterbi
    fallback (the plain K10 or K5/K6 here): σ=90 lanes come out good and
    equal to the JAX package's Viterbi output."""
    frames, soft = _streams(5, [90.0, 0.0, 95.0], [9, 3, 17], code=K15)
    cfg = jd.DecodeConfig(code=K15, fano_tier1_maxcycles=1, fano_maxcycles=2)
    _kernels.reset_launches()
    rec = _compare(soft, cfg, backend)
    assert _kernels.backend_used["viterbi_path"] == (
        "classic" if backend == "jnp" else "fused")
    vit = rec.decoder == td.DECODER_VITERBI
    assert vit.sum() >= 2 and (vit & rec.good).any(), rec.decoder
    # at σ=90 a Viterbi frame may carry bit errors and still end in the
    # syncword; at least one comes out exactly as transmitted
    sent = np.tile(frames[1:], (len(rec.good) // NFRAMES, 1))
    assert (vit & (rec.data == sent).all(axis=1)).any()


def test_viterbi_chunks_by_the_decision_budget(monkeypatch):
    """A budget of one K15 frame's tape decodes the fallback lanes one
    frame per chunk, with the same result."""
    _, soft = _streams(5, [90.0, 95.0], [9, 17], code=K15)
    cfg = td.DecodeConfig(code=convert.code_spec(K15), fano_tier1_maxcycles=1,
                          fano_maxcycles=2)
    whole, _ = td.decode_block(torch.from_numpy(soft), NFRAMES, cfg, device="cpu")
    monkeypatch.setenv("ISEE3_FUSED_DEC_BYTES", str(1024 * K15.nstates // 8))
    chunked, _ = td.decode_block(torch.from_numpy(soft), NFRAMES, cfg,
                                 device="cpu")
    assert (whole.decoder == td.DECODER_VITERBI).sum() >= 2
    _same(chunked, whole)


@pytest.mark.slow
def test_decode_block_viterbi_lane_mcqli24_matches_jax():
    _, soft = _streams(6, [95.0], [11])
    cfg = jd.DecodeConfig(fano_tier1_maxcycles=1, fano_maxcycles=2)
    rec = _compare(soft, cfg)
    assert (rec.decoder == td.DECODER_VITERBI).any()


@BACKENDS
@pytest.mark.parametrize("persistent", [False, True], ids=["gated", "persistent"])
def test_decode_frames_batch_matches_jax(persistent, backend):
    """Channels × frames as one batch; without -p a failed frame goes to
    Viterbi only after a decoded frame of its channel (prev_lock enters
    frame 0), with -p every failed frame does."""
    nfr = 3
    _, soft = _streams(7, [0.0, 90.0, 95.0, 100.0], [0, 0, 0, 0], code=K15,
                       nframes=nfr + 1)
    cfg = jd.DecodeConfig(code=K15, fano_tier1_maxcycles=1, fano_maxcycles=2,
                          persistent=persistent)
    ss = np.full(4, 2 * 1024 - 34)  # the sync ending frame 0
    lock = np.array([True, False, True, True])
    rec_j = jd.decode_frames_batch(soft, ss, nfr, cfg, prev_lock=lock)
    rec_t = td.decode_frames_batch(torch.from_numpy(soft), ss, nfr,
                                   _port_config(cfg, backend), prev_lock=lock,
                                   device="cpu")
    _same(rec_t, rec_j)
    assert (rec_t.decoder == td.DECODER_VITERBI).any()
    if not persistent:
        assert (rec_t.decoder != td.DECODER_VITERBI).sum() > 4


@BACKENDS
def test_decode_stream_and_format_frame_match_jax(backend):
    """The stream walk (sync search, lock, -p Viterbi, purge) in two
    calls carrying the state, and the printed frames."""
    _, soft = _streams(8, [0.0, 90.0], [21, 40], code=K15, nframes=4)
    cfg = jd.DecodeConfig(code=K15, fano_tier1_maxcycles=1, fano_maxcycles=2,
                          persistent=True)
    tcfg = _port_config(cfg, backend)
    recs_j, st_j = jd.decode_stream(soft, cfg, max_frames=1)
    recs_t, st_t = td.decode_stream(soft, tcfg, max_frames=1, device="cpu")
    more_j, st_j = jd.decode_stream(soft, cfg, st_j)
    more_t, st_t = td.decode_stream(torch.from_numpy(soft), tcfg, st_t,
                                    device="cpu")
    recs_j += more_j
    recs_t += more_t
    assert len(recs_t) == len(recs_j) == 3
    for rt, rj in zip(recs_t, recs_j):
        _same(rt, rj)
        for ch in range(2):
            assert td.format_frame(rt, ch, 7) == jd.format_frame(rj, ch, 7)
    np.testing.assert_array_equal(st_t.pos, st_j.pos)
    np.testing.assert_array_equal(st_t.lock, st_j.lock)
    labels = np.concatenate([r.decoder for r in recs_t])
    assert td.DECODER_VITERBI in labels and td.DECODER_FANO in labels


def _run_cli(main, argv, data: bytes, monkeypatch, capsys) -> str:
    monkeypatch.setattr(sys, "stdin", io.TextIOWrapper(io.BytesIO(data)))
    assert main(argv) == 0
    return capsys.readouterr().out


def test_decode_cli_output_matches_jax(monkeypatch, capsys):
    """The port's decode CLI (--device cpu) prints the JAX CLI's text on
    clean MCQLI-24 soft symbols."""
    rng = np.random.default_rng(9)
    frames = testsignal.random_frames(rng, 4)
    syms = testsignal.frames_to_symbols(frames)
    # a lead of 30 erasures keeps frame 0's sync inside the first search
    # window, so no frame walks the full Fano budget (slow in plain torch)
    soft = np.concatenate([np.full(30, 128, np.uint8),
                           np.where(syms > 0, 228, 28).astype(np.uint8)])
    want = _run_cli(jcli.main, [], soft.tobytes(), monkeypatch, capsys)
    got = _run_cli(tcli.main, ["--device", "cpu"], soft.tobytes(), monkeypatch,
                   capsys)
    assert got == want
    assert got.count("with Quicklook") == 3


def test_entry_points_need_a_card_or_device_cpu(monkeypatch):
    """Without a card an entry point raises unless asked for the CPU; it
    never falls back by itself."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    soft = np.full((1, 3 * 2048), 128, np.uint8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        td.decode_block(soft, 1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        td.decode_stream(soft)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        td.decode_frames_batch(soft, [0], 1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tpipe.receive_block(np.zeros((1, 2 * 65536), np.int16), 1)
    monkeypatch.setattr(sys, "stdin", io.TextIOWrapper(io.BytesIO(soft.tobytes())))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tcli.main([])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        stream_create(28, 1, convert.code_spec(K15))
    assert _kernels.place(soft, "cpu").device.type == "cpu"
