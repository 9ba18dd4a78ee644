"""PyTorch port: the reference's stage tools against the JAX package on
the CPU — ``ops/symbols.timesearch`` / ``integrate_symbols`` (bit for
bit), ``models/legacy.bitsync_frames`` and the ``bitsync`` CLI, the
``pmdemod`` CLI (stdout within 1 LSB) and the ``symdemod`` CLI (stdout
bytes identical), each CLI run in-process beside the JAX package's on the
same input; and ``pmdemod | symdemod | decode`` as three processes with
``--device cpu``."""

from __future__ import annotations

import io
import os
import subprocess
import sys
from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isee3_decoder_tpu.cli import bitsync as jbitsync_cli
from isee3_decoder_tpu.cli import pmdemod as jpmdemod_cli
from isee3_decoder_tpu.cli import symdemod as jsymdemod_cli
from isee3_decoder_tpu.config import FRAMEBITS, CodeSpec
from isee3_decoder_tpu.models import legacy as jlegacy
from isee3_decoder_tpu.ops import symbols as jsym
from isee3_decoder_tpu.utils import testsignal
from isee3_decoder_tpu_torch.cli import bitsync as tbitsync_cli
from isee3_decoder_tpu_torch.cli import pmdemod as tpmdemod_cli
from isee3_decoder_tpu_torch.cli import symdemod as tsymdemod_cli
from isee3_decoder_tpu_torch.models import legacy as tlegacy
from isee3_decoder_tpu_torch.ops import prefix_cuda
from isee3_decoder_tpu_torch.ops import symbols as tsym
from isee3_decoder_tpu_torch.utils import convert

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JK7 = CodeSpec("TESTK7", 0o171, 0o133, 7, 0, 0)


def _manchester(rng, samprate: float, symrate: float, nsym: int, B: int,
                amp: float = 900.0, noise: float = 120.0) -> np.ndarray:
    """(B, L) int16 Manchester baseband of random symbols."""
    rows = []
    for _ in range(B):
        syms = rng.integers(0, 2, nsym).astype(np.uint8)
        wave = testsignal.manchester_waveform(syms, samprate / symrate)
        rows.append(amp * wave + rng.normal(0, noise, len(wave)))
    L = min(len(r) for r in rows)
    return np.stack([r[:L] for r in rows]).astype(np.int16)


# (samprate, symrate, symbolclocks): the small test rate, the bench rate
# at the measured clock, and subcarrier mode (two clocks a symbol)
SHAPES = [(32768.0, 512.0, 1), (250_000.0, 1024.545058, 1),
          (32768.0, 256.0, 2)]


@pytest.mark.parametrize("samprate,symrate,clocks", SHAPES)
def test_timesearch_and_integrate_match_jax(samprate, symrate, clocks):
    cfg = jsym.SymConfig(samprate=samprate, symrate=symrate,
                         symbolclocks=clocks, window=0.25)
    rng = np.random.default_rng(int(samprate) + clocks)
    bb = _manchester(rng, samprate, symrate, int(0.6 * symrate), B=3)
    nsym = cfg.nsymbols
    # the search reads from first - noffsets // 2 on, as the tools call it
    for first in (int(cfg.symbolsamples / 2), cfg.noffsets // 2 + 5,
                  3 * int(cfg.symbolsamples)):
        want = jsym.timesearch(jnp.asarray(bb), first, cfg.halfclock, nsym,
                               clocks, cfg.noffsets)
        got = tsym.timesearch(torch.from_numpy(bb), first, cfg.halfclock,
                              nsym, clocks, cfg.noffsets)
        np.testing.assert_array_equal(got.symphase.numpy(),
                                      np.asarray(want.symphase))
        np.testing.assert_array_equal(got.maxenergy.numpy(),
                                      np.asarray(want.maxenergy))
        firsts = first + got.symphase.numpy()
        gain = 100.0 / np.sqrt(got.maxenergy.numpy())
        for g in (0.0, gain):
            want_i = jsym.integrate_symbols(
                jnp.asarray(bb), jnp.asarray(firsts), cfg.halfclock, nsym,
                clocks, jnp.asarray(g))
            got_i = tsym.integrate_symbols(
                torch.from_numpy(bb), torch.from_numpy(firsts), cfg.halfclock,
                nsym, clocks, torch.as_tensor(g))
            for f in ("soft", "integrators", "energy"):
                np.testing.assert_array_equal(
                    getattr(got_i, f).numpy(), np.asarray(getattr(want_i, f)),
                    f)


@pytest.mark.parametrize("L,pad", [(1, 0), (1001, 8), (4096, 8), (8195, 3)])
def test_samples_csum_is_the_padded_prefix_sum(L, pad):
    """K3 on the samples as one block with pad + 1 tail columns (its plain
    version here) is prefix_sum(samples, pad_to=L + pad), column for
    column, a run of 32767s that wraps int32 included."""
    rng = np.random.default_rng(L)
    x = rng.integers(-32768, 32768, (3, L)).astype(np.int16)
    x[1] = 32767
    t = torch.from_numpy(x)
    got = tsym.samples_csum(t, pad)
    want = tsym.prefix_sum(t, pad_to=L + pad)
    assert got.shape == (3, L + pad + 1) and got.dtype == torch.int32
    assert torch.equal(got, want)
    assert torch.equal(prefix_cuda.prefix_sum_blocks_plain(t[None], pad + 1),
                       want)


@pytest.mark.parametrize("x", [np.zeros((2, 16), np.int32),
                               np.zeros((2, 16), np.float32),
                               np.zeros((2, 0), np.int16)])
def test_samples_csum_refuses_what_k3_does_not_take(x):
    """samples_csum takes the prefix sum from K3 alone: samples that are
    not int16, or an empty block, raise on the CPU as on the card."""
    with pytest.raises(ValueError, match="int16"):
        tsym.samples_csum(torch.from_numpy(x), 8)


def _k7_baseband(seed: int, nframes: int = 4):
    rng = np.random.default_rng(seed)
    frames = testsignal.random_frames(rng, nframes)
    syms = testsignal.frames_to_symbols(frames, JK7)
    wave = testsignal.manchester_waveform(syms, 16384.0 / 1024.0)
    samples = (900.0 * wave + rng.normal(0, 60, len(wave))).astype(np.int16)
    return frames, samples


def test_bitsync_frames_matches_jax():
    """The K7 case of tests/test_checkpoint_and_more.py: the same frames,
    bits and per-window timing and energy as the JAX package."""
    frames, samples = _k7_baseband(2)
    want = jlegacy.bitsync_frames(samples, 16384.0, 1024.0, decode_delay=100,
                                  code=JK7)
    got = tlegacy.bitsync_frames(samples, 16384.0, 1024.0, decode_delay=100,
                                 code=convert.code_spec(JK7), device="cpu")
    assert len(got.frames) == len(want.frames) >= 2
    for a, b in zip(got.frames, want.frames):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(got.bits, want.bits)
    assert got.infos == want.infos
    assert any(np.array_equal(fr, f) for fr in got.frames for f in frames)


def _run_cli(main, argv, stdin: bytes = b"") -> tuple[int, bytes]:
    """A CLI's main in this process with stdin fed and stdout caught."""
    out = io.BytesIO()
    fake_out = io.TextIOWrapper(out, write_through=True)
    fake_in = io.TextIOWrapper(io.BytesIO(stdin))
    with mock.patch.object(sys, "stdout", fake_out), \
            mock.patch.object(sys, "stdin", fake_in):
        rc = main(argv)
        fake_out.flush()
    return rc, out.getvalue()


def test_bitsync_cli_matches_jax(tmp_path):
    _, samples = _k7_baseband(7)
    path = tmp_path / "bb.i16"
    samples.tofile(path)
    args = ["-r", "16384", "-s", "1024.0", "-d", "100", "--code", "TESTK7",
            str(path)]
    rc_j, want = _run_cli(jbitsync_cli.main, args)
    rc_t, got = _run_cli(tbitsync_cli.main, args + ["--device", "cpu"])
    assert rc_j == rc_t == 0
    assert b"Frame 1 starting at sample" in got
    assert got == want


@pytest.fixture(scope="module")
def small_recording(tmp_path_factory):
    """8 s of 32,768 sps IQ with 2 frames, written as the int16 file the
    pmdemod tools read, and the frames sent."""
    rng = np.random.default_rng(21)
    frames = testsignal.random_frames(rng, 2)
    iq = testsignal.synthesize_iq(frames, samprate=32768.0, symrate=512.0,
                                  carrier=3000.0, noise_std=600.0,
                                  lead_symbols=40, rng=rng)
    path = tmp_path_factory.mktemp("rec") / "input.iq"
    testsignal.iq_to_int16(iq).tofile(path)
    return path, frames


PM_ARGS = ["-q", "-W", "100", "-r", "32768", "-b", "4"]
SYM_ARGS = ["-q", "-r", "32768", "-c", "512.", "-C", "1", "-w", "0.5"]


def test_pmdemod_cli_matches_jax(small_recording):
    """pmdemod: the same number of int16 baseband samples on stdout as the
    JAX tool, each within 1 LSB (locked blocks on K1's plain version)."""
    path, _ = small_recording
    rc_j, want = _run_cli(jpmdemod_cli.main, PM_ARGS + [str(path)])
    rc_t, got = _run_cli(tpmdemod_cli.main,
                         PM_ARGS + ["--device", "cpu", str(path)])
    assert rc_j == rc_t == 0
    w = np.frombuffer(want, "<i2").astype(np.int32)
    g = np.frombuffer(got, "<i2").astype(np.int32)
    nblocks = path.stat().st_size // 4 // 8192
    assert g.shape == w.shape and g.size == nblocks * 8192
    assert np.abs(g - w).max() <= 1


def test_symdemod_cli_bytes_match_jax(small_recording):
    """symdemod: the same soft-symbol bytes on stdout as the JAX tool,
    fed the same baseband (the port's pmdemod output)."""
    path, _ = small_recording
    _, bb = _run_cli(tpmdemod_cli.main, PM_ARGS + ["--device", "cpu",
                                                   str(path)])
    rc_j, want = _run_cli(jsymdemod_cli.main, SYM_ARGS, stdin=bb)
    rc_t, got = _run_cli(tsymdemod_cli.main, SYM_ARGS + ["--device", "cpu"],
                         stdin=bb)
    assert rc_j == rc_t == 0
    assert len(got) > 3 * 256
    assert got == want
    assert tsymdemod_cli.parse_symrate("1024.") == (1024.0, 1)
    assert tsymdemod_cli.parse_symrate("1024") == jsymdemod_cli.parse_symrate(
        "1024")
    assert tsymdemod_cli.parse_symrate("512") == jsymdemod_cli.parse_symrate(
        "512")


def test_stage_tools_refuse_a_missing_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tpmdemod_cli.main([str(tmp_path / "none.iq")])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tsymdemod_cli.main([])


def _hex_frames(text: str) -> list[np.ndarray]:
    out, cur = [], []
    for line in text.splitlines():
        if line.startswith("Frame "):
            cur = []
        elif line.strip() and all(len(t) == 2 for t in line.split()):
            cur.extend(int(t, 16) for t in line.split())
            if len(cur) == FRAMEBITS // 8:
                out.append(np.array(cur, np.uint8))
    return out


@pytest.mark.slow
def test_cli_three_stage_pipeline_on_the_cpu(tmp_path):
    """pmdemod | symdemod | decode as three port processes over pipes,
    --device cpu (tests/test_cli_and_legacy.py's case: the first frame
    walks the plain Fano loop for ~2 minutes)."""
    rng = np.random.default_rng(4)
    frames = testsignal.random_frames(rng, 5)
    iq = testsignal.synthesize_iq(frames, samprate=250_000.0, symrate=1024.0,
                                  carrier=20_000.0, noise_std=500.0,
                                  lead_symbols=50, rng=rng)
    path = tmp_path / "input.iq"
    testsignal.iq_to_int16(iq).tofile(path)
    mod = "isee3_decoder_tpu_torch.cli."
    cpu = ["--device", "cpu"]
    pm = subprocess.Popen([sys.executable, "-m", mod + "pmdemod", "-q", "-W",
                           "100", *cpu, str(path)],
                          stdout=subprocess.PIPE, cwd=ROOT)
    sd = subprocess.Popen([sys.executable, "-m", mod + "symdemod", "-q", "-c",
                           "1024.", *cpu],
                          stdin=pm.stdout, stdout=subprocess.PIPE, cwd=ROOT)
    dc = subprocess.Popen([sys.executable, "-m", mod + "decode", *cpu],
                          stdin=sd.stdout, stdout=subprocess.PIPE, cwd=ROOT)
    pm.stdout.close()
    sd.stdout.close()
    out, _ = dc.communicate(timeout=900)
    assert pm.wait() == sd.wait() == dc.returncode == 0
    text = out.decode()
    assert "Fano enabled" in text
    good = [hf for hf, line in zip(_hex_frames(text), [
        ln for ln in text.splitlines() if ln.startswith("Frame ")])
        if "(bad)" not in line]
    sent = [hf for hf in good if any(np.array_equal(hf, f) for f in frames)]
    assert len(good) == len(sent) >= 2, text
