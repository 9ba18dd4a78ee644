"""PyTorch port vs the JAX package: the legacy tools (models/legacy.py,
utils/sim.py, the framer and phasing helpers of ops/syncword.py) and the
qdecode, framer, decode, vtest and hybridtest CLIs.  The same seeded
numpy inputs go into both packages; integer outputs are compared
exactly."""

import io
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isee3_decoder_tpu import config as jcfg
from isee3_decoder_tpu.cli import decode as jdecode_cli
from isee3_decoder_tpu.cli import framer as jframer_cli
from isee3_decoder_tpu.cli import qdecode as jqdecode_cli
from isee3_decoder_tpu.models import legacy as jl
from isee3_decoder_tpu.ops import encode_bits
from isee3_decoder_tpu.ops import syncword as jsw
from isee3_decoder_tpu.utils import sim as jsim
from isee3_decoder_tpu.utils import testsignal
from isee3_decoder_tpu_torch import _kernels
from isee3_decoder_tpu_torch.cli import decode as tdecode_cli
from isee3_decoder_tpu_torch.cli import framer as tframer_cli
from isee3_decoder_tpu_torch.cli import hybridtest as thybrid_cli
from isee3_decoder_tpu_torch.cli import icesync as ticesync_cli
from isee3_decoder_tpu_torch.cli import qdecode as tqdecode_cli
from isee3_decoder_tpu_torch.cli import vdecode as tvdecode_cli
from isee3_decoder_tpu_torch.cli import vtest as tvtest_cli
from isee3_decoder_tpu_torch.models import legacy as tl
from isee3_decoder_tpu_torch.ops import syncword as tsw
from isee3_decoder_tpu_torch.utils import convert
from isee3_decoder_tpu_torch.utils import sim as tsim

K7 = jcfg.CodeSpec("TESTK7", 0o171, 0o133, 7, 0, 0)
K15 = jcfg.CodeSpec("TESTK15", 0o46321, 0o51445, 15, 0, 1)


def _soft(rng, nframes: int, code=jcfg.MCQLI24, spread: int = 0):
    """Frames and their soft symbols (hard levels 200/56, plus uniform
    noise of ±spread)."""
    frames = testsignal.random_frames(rng, nframes)
    syms = testsignal.frames_to_symbols(frames, code)
    soft = np.where(syms > 0, 200, 56).astype(np.int32)
    if spread:
        soft = soft + rng.integers(-spread, spread, soft.shape)
    return frames, np.clip(soft, 0, 255).astype(np.uint8)


def _stream(rng, code, nbits: int, spread: int):
    bits = rng.integers(0, 2, nbits, dtype=np.uint8)
    syms, _ = encode_bits(jnp.asarray(bits), 0, code)
    soft = np.where(np.asarray(syms) > 0, 180, 76).astype(np.int32)
    soft = soft + rng.integers(-spread, spread + 1, soft.shape)
    return bits, np.clip(soft, 0, 255).astype(np.uint8)


def test_qdecode_and_framer_match_jax():
    rng = np.random.default_rng(0)
    frames, soft = _soft(rng, 3, spread=100)
    soft = np.stack([soft, soft[::-1].copy()])
    want = np.asarray(jl.qdecode_stream(jnp.asarray(soft)))
    got = tl.qdecode_stream(soft, device="cpu")
    np.testing.assert_array_equal(got.numpy(), want)
    clean = np.array(jl.qdecode_stream(jnp.asarray(_soft(rng, 3)[1])))
    np.testing.assert_array_equal(
        tsw.framer_positions(torch.from_numpy(clean)).numpy(),
        np.asarray(jsw.framer_positions(jnp.asarray(clean))))
    fj = jl.frame_bits(clean)
    ft = tl.frame_bits(clean, device="cpu")
    assert ft.positions == fj.positions and len(fj.frames) >= 2
    for a, b in zip(ft.frames, fj.frames):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", ["MCQLI24", "K15"])
def test_auto_phase_flip_per_channel_matches_jax(name):
    """Three streams, one starting mid-pair: per-channel phases, the
    aligned batch and the even/odd sync peaks all equal the JAX
    package's."""
    code = {"MCQLI24": jcfg.MCQLI24, "K15": K15}[name]
    rng = np.random.default_rng(1)
    _, soft = _soft(rng, 2, code, spread=60)
    rows = [soft[:-1], np.concatenate([[128], soft[:-2]]), soft[1:]]
    batch = np.stack(rows).astype(np.uint8)
    head = batch[:, : jcfg.FRAMESYMBOLS + jcfg.SYNCBITS]
    tcode = convert.code_spec(code)
    for got, want in zip(tsw.phase_sync_peaks(torch.from_numpy(head), tcode),
                         jsw.phase_sync_peaks(jnp.asarray(head), code)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    aj, pj = jl.auto_phase_flip(batch, code)
    at, pt = tl.auto_phase_flip(batch, tcode, device="cpu")
    np.testing.assert_array_equal(pt, pj)
    np.testing.assert_array_equal(at, aj)
    assert sorted(pt.tolist()) == [0, 1, 1]


@pytest.mark.parametrize("name,nbits,delay,spread,backend", [
    ("K7", 300, 30, 70, "jnp"),
    ("K7", 4500, 40, 90, "jnp"),  # two update chunks on a circular tape
    ("K15", 140, 40, 60, "jnp"),
    ("K15", 140, 40, 60, "fused"),
    ("K15", 30, 40, 60, "jnp"),  # shorter than the delay: no bits
])
def test_vdecode_stream_matches_jax(name, nbits, delay, spread, backend):
    code = {"K7": K7, "K15": K15}[name]
    rng = np.random.default_rng(nbits + delay)
    bits, soft = _stream(rng, code, nbits, spread)
    soft = np.stack([soft, soft[::-1].copy()])
    want = jl.vdecode_stream(jnp.asarray(soft), delay, code, backend=backend)
    _kernels.reset_launches()
    got = tl.vdecode_stream(soft, delay, convert.code_spec(code), backend,
                            device="cpu")
    assert _kernels.backend_used["viterbi_path"] == (
        "classic" if backend == "jnp" else "fused")
    np.testing.assert_array_equal(got.bits, want.bits)
    np.testing.assert_array_equal(got.symbol_errors, want.symbol_errors)
    lag = code.k - 2
    if name == "K15" and got.bits.shape[1] > lag:
        # the data at lag delay + K - 2, through hard symbol errors
        np.testing.assert_array_equal(got.bits[0, lag:],
                                      bits[: got.bits.shape[1] - lag])
        assert got.symbol_errors[0] > 0


def test_vdecode_stream_backends_agree():
    rng = np.random.default_rng(4)
    _, soft = _stream(rng, K15, 700, 90)
    tcode = convert.code_spec(K15)
    a = tl.vdecode_stream(soft, 50, tcode, "jnp", device="cpu")
    b = tl.vdecode_stream(soft, 50, tcode, "fused", device="cpu")
    np.testing.assert_array_equal(a.bits, b.bits)
    np.testing.assert_array_equal(a.symbol_errors, b.symbol_errors)
    # "inplace" names the fused decoder, as in the decode stage
    c = tl.vdecode_stream(soft, 50, tcode, "inplace", device="cpu")
    np.testing.assert_array_equal(c.bits, b.bits)
    with pytest.raises(ValueError, match="unknown Viterbi backend"):
        tl.vdecode_stream(soft, 50, tcode, "xla", device="cpu")


def test_icesync_helpers_match_jax():
    for ss in (16.0, 244.0326):
        np.testing.assert_array_equal(tl.manchester_sync_template(ss),
                                      jl.manchester_sync_template(ss))
    rng = np.random.default_rng(5)
    tmpl = jl.manchester_sync_template(16.0)
    x = rng.normal(0, 1, 3000)
    x[1234 : 1234 + len(tmpl)] += 3 * tmpl
    for low, high in ((0, 3000), (1200, 1300), (0, 100)):
        assert (tl.fft_sync_search(x, tmpl, low, high)
                == jl.fft_sync_search(x, tmpl, low, high))
    assert tl.fft_sync_search(np.zeros(500), tmpl, 0, 500) is None
    for errs, n in ((0, 2048), (7, 2048), (300, 2048), (5000, 10**6)):
        assert tl.ebn0_from_symbol_errors(errs, n) == jl.ebn0_from_symbol_errors(errs, n)
    assert tl.inverse_erf(0.3) == jl.inverse_erf(0.3)


def _manchester(code, seed: int, nframes: int = 3, samprate: float = 16384.0):
    rng = np.random.default_rng(seed)
    frames = testsignal.random_frames(rng, nframes)
    syms = testsignal.frames_to_symbols(frames, code)
    wave = testsignal.manchester_waveform(syms, samprate / 1024.0)
    return frames, (60.0 * wave + rng.normal(0, 8, len(wave))).astype(np.int64)


def _same_icesync(got, want):
    assert len(got) == len(want) >= 1
    for g, w in zip(got, want):
        assert g.start_sample == w.start_sample
        np.testing.assert_array_equal(g.data, w.data)
        assert (g.symbol_errors, g.ebn0_db, g.min_metric, g.max_metric) == (
            w.symbol_errors, w.ebn0_db, w.min_metric, w.max_metric)


def test_icesync_frames_matches_jax_k15(tmp_path):
    """icesync on synthetic Manchester baseband of K15-encoded frames:
    sync positions, frame bytes, re-encode errors, Eb/N0 and path metric
    range equal the JAX package's; the acquisition writes its plot."""
    frames, samples = _manchester(K15, 3)
    want = jl.icesync_frames(samples, 16384.0, 1024.0, max_frames=2, code=K15)
    got = tl.icesync_frames(samples, 16384.0, 1024.0, max_frames=2,
                            code=convert.code_spec(K15), plot_dir=str(tmp_path),
                            device="cpu")
    _same_icesync(got, want)
    assert any(any(np.array_equal(g.data, f) for f in frames) for g in got)
    plots = sorted(tmp_path.glob("sync.*.plot"))
    assert plots and plots[0].read_text().startswith("signed double\ndot 0 ")


@pytest.mark.slow
def test_icesync_frames_matches_jax_mcqli24():
    """The K=24 counterpart (the card runs it in chip_smoke.py)."""
    frames, samples = _manchester(jcfg.MCQLI24, 3)
    want = jl.icesync_frames(samples, 16384.0, 1024.0, max_frames=2)
    got = tl.icesync_frames(samples, 16384.0, 1024.0, max_frames=2, device="cpu")
    _same_icesync(got, want)
    assert got[0].symbol_errors < 50


def test_sim_matches_jax_given_the_same_uniforms():
    """The CDF lookup equals JAX's simulate on the uniforms its key draws;
    the table and the Eb/N0 → noise rule are equal too."""
    for sig, noise in ((24.0, 17.0), (100.0, 60.0)):
        np.testing.assert_array_equal(tsim.channel_cdf(sig, noise),
                                      jsim.channel_cdf(sig, noise))
        key = jax.random.PRNGKey(7)
        tx = np.random.default_rng(2).integers(0, 2, (4, 500)).astype(np.uint8)
        want = np.asarray(jsim.simulate(key, jnp.asarray(tx), sig, noise))
        u = np.array(jax.random.uniform(key, tx.shape, dtype=jnp.float32))
        got = tsim.sample_channel(torch.from_numpy(u), torch.from_numpy(tx),
                                  sig, noise)
        np.testing.assert_array_equal(got.numpy(), want)
    assert tsim.ebn0_to_noise(24.0, 5.0) == jsim.ebn0_to_noise(24.0, 5.0)
    gen = torch.Generator().manual_seed(3)
    tx = torch.randint(0, 2, (20000,), generator=gen)
    rx = tsim.simulate(gen, tx, 24.0, 17.0).to(torch.float64)
    assert abs(float(rx[tx == 1].mean()) - 152.0) < 1.0
    rx = tsim.addnoise(gen, tx, 24.0, 17.0).to(torch.float64)
    assert abs(float(rx[tx == 0].mean()) - 104.0) < 1.0
    assert abs(float(rx[tx == 0].std()) - 17.0) < 1.0


def _run(main, argv, data, monkeypatch, capsys) -> str:
    stdin = io.TextIOWrapper(io.BytesIO(data))
    monkeypatch.setattr(sys, "stdin", stdin)
    assert main(argv) == 0
    return capsys.readouterr().out


def test_qdecode_framer_cli_text_matches_jax(monkeypatch, capsys):
    """qdecode | framer, with a stream that starts mid-pair (auto flip)."""
    rng = np.random.default_rng(8)
    _, soft = _soft(rng, 3, spread=60)  # no hard symbol errors
    data = np.concatenate([[77], soft]).astype(np.uint8).tobytes()
    bits_j = _run(jqdecode_cli.main, [], data, monkeypatch, capsys)
    bits_t = _run(tqdecode_cli.main, ["--device", "cpu"], data, monkeypatch,
                  capsys)
    assert bits_t == bits_j
    text_j = _run(jframer_cli.main, ["-r", "512"], bits_j.encode(), monkeypatch,
                  capsys)
    text_t = _run(tframer_cli.main, ["-r", "512", "--device", "cpu"],
                  bits_t.encode(), monkeypatch, capsys)
    assert text_t == text_j and text_t.count("Frame ") >= 2


def test_decode_cli_backend_jnp_text_matches_jax(monkeypatch, capsys):
    """decode --backend jnp on clean MCQLI-24 frames (no lane reaches the
    Viterbi decoder: a K=24 frame takes minutes on the CPU)."""
    rng = np.random.default_rng(9)
    _, soft = _soft(rng, 3)
    data = np.concatenate([np.full(30, 128, np.uint8), soft]).tobytes()
    want = _run(jdecode_cli.main, ["--backend", "jnp"], data, monkeypatch, capsys)
    got = _run(tdecode_cli.main, ["--backend", "jnp", "--device", "cpu"], data,
               monkeypatch, capsys)
    assert got == want and got.count("with Quicklook") == 2


def test_vdecode_cli_runs_on_the_cpu(monkeypatch, capsys):
    """The vdecode CLI at K15 (its code swapped in for the MCQLI-24
    default, which takes minutes on the CPU): the printed bits are
    vdecode_stream's."""
    tcode = convert.code_spec(K15)
    monkeypatch.setattr(tvdecode_cli, "DEFAULT_CODE", tcode)
    real = tl.vdecode_stream
    monkeypatch.setattr(tvdecode_cli, "vdecode_stream",
                        lambda s, d, backend, device: real(s, d, tcode, backend,
                                                           device))
    rng = np.random.default_rng(10)
    _, soft = _stream(rng, K15, 600, 60)
    for backend in ("jnp", "fused"):
        out = _run(tvdecode_cli.main, ["-d", "40", "-F", "--backend", backend,
                                       "--device", "cpu"], soft.tobytes(),
                   monkeypatch, capsys)
        want = real(soft, 40, tcode, backend, device="cpu").bits[0]
        assert out == "".join("1" if b else "0" for b in want)


@pytest.mark.parametrize("backend", ["jnp", "fused"])
def test_vtest_cli_on_the_cpu(backend, monkeypatch, capsys):
    """vtest at K15 (its code swapped in): both modes print their lines;
    at 6 dB every frame decodes."""
    monkeypatch.setattr(tvtest_cli, "DEFAULT_CODE", convert.code_spec(K15))
    out = _run(tvtest_cli.main, ["-l", "96", "-n", "6", "-b", "4", "-e", "6",
                                 "--backend", backend, "--device", "cpu"],
               b"", monkeypatch, capsys)
    assert "nframes = 6 framesize = 96 ebn0 = 6.00 dB" in out
    assert "BER 0/576 (0) FER 0/6 (0)" in out
    out = _run(tvtest_cli.main, ["-l", "64", "-n", "4", "-b", "2", "--backend",
                                 backend, "--device", "cpu"], b"", monkeypatch,
               capsys)
    assert "Execution time for 4 64-bit frames" in out and "decoder speed" in out


def test_hybridtest_cli_on_the_cpu(monkeypatch, capsys):
    """hybridtest at K15 with a Fano budget of 1 cycle/bit, so frames go
    to the Viterbi retry."""
    monkeypatch.setattr(thybrid_cli, "DEFAULT_CODE", convert.code_spec(K15))
    out = _run(thybrid_cli.main, ["-l", "128", "-n", "4", "-b", "4", "-e", "3",
                                  "-m", "1", "--device", "cpu"], b"",
               monkeypatch, capsys)
    assert "Code rate 0.50, Nbits = 128, Maxcycles/bit 1" in out
    assert "Fano good frames:" in out and "Viterbi attempts" in out


@pytest.mark.slow
def test_vtest_cli_mcqli24_on_the_cpu(monkeypatch, capsys):
    """The K=24 harness as users run it (the card runs it in
    chip_smoke.py)."""
    out = _run(tvtest_cli.main, ["-l", "96", "-n", "2", "-b", "2", "-e", "5",
                                 "--device", "cpu"], b"", monkeypatch, capsys)
    assert "FER 0/2" in out


def test_icesync_cli_runs_on_the_cpu(tmp_path, monkeypatch, capsys):
    """The icesync CLI prints the reference's report for what
    icesync_frames finds (the frame decode itself mocked to K15 rows of
    the JAX package's result, since MCQLI-24 takes minutes here)."""
    _, samples = _manchester(K15, 3)
    want = jl.icesync_frames(samples, 16384.0, 1024.0, max_frames=2, code=K15)
    path = tmp_path / "bb.i16"
    samples.astype("<i2").tofile(path)
    monkeypatch.setattr(ticesync_cli, "icesync_frames",
                        lambda *a, **kw: tl.icesync_frames(
                            *a, max_frames=2, code=convert.code_spec(K15),
                            **kw))
    monkeypatch.chdir(tmp_path)
    out = _run(ticesync_cli.main, ["-r", "16384", "-c", "1024", "--no-plots",
                                   "--device", "cpu", str(path)], b"",
               monkeypatch, capsys)
    assert out.count("Frame ") == len(want)
    assert f"Viterbi path metric range {want[0].min_metric:,}" in out
    assert " ".join(f"{b:02x}" for b in want[0].data[:16]) in out
