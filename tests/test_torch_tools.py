"""PyTorch port: the small tools against the JAX package on the CPU —
``utils/testsignal`` (bit for bit), ``ops/encode.encode_bytes`` and
``reencode_symbol_errors``, ``utils/profiling``, and the CLIs
``gensine`` and ``spindown`` (stdout bytes identical), ``autocorrelate``
(plot values within rtol 1e-9), ``simtest`` and ``fanotest`` (held to the
JAX package on the same channel, through ``utils/sim.sample_channel``),
and ``symdemod -t`` (the bytes of the JAX package's library host tracker
over the same windows).  Each CLI's ``main`` runs in this process with
``--device cpu``."""

from __future__ import annotations

import io
import math
import sys
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isee3_decoder_tpu.cli import autocorrelate as jautocorrelate_cli
from isee3_decoder_tpu.cli import gensine as jgensine_cli
from isee3_decoder_tpu.cli import spindown as jspindown_cli
from isee3_decoder_tpu.config import DEFAULT_CODE, CodeSpec
from isee3_decoder_tpu.models import symdemod as jsymdemod
from isee3_decoder_tpu.ops import encode as jencode
from isee3_decoder_tpu.ops import fano as jfano
from isee3_decoder_tpu.ops import symbols as jsym
from isee3_decoder_tpu.utils import metrics as jmetrics
from isee3_decoder_tpu.utils import profiling as jprofiling
from isee3_decoder_tpu.utils import sim as jsim
from isee3_decoder_tpu.utils import testsignal as jtestsignal
from isee3_decoder_tpu_torch.cli import autocorrelate as tautocorrelate_cli
from isee3_decoder_tpu_torch.cli import fanotest as tfanotest_cli
from isee3_decoder_tpu_torch.cli import gensine as tgensine_cli
from isee3_decoder_tpu_torch.cli import simtest as tsimtest_cli
from isee3_decoder_tpu_torch.cli import spindown as tspindown_cli
from isee3_decoder_tpu_torch.cli import symdemod as tsymdemod_cli
from isee3_decoder_tpu_torch.models import symdemod as tsymdemod
from isee3_decoder_tpu_torch.ops import encode as tencode
from isee3_decoder_tpu_torch.ops import symbols as tsym
from isee3_decoder_tpu_torch.utils import convert
from isee3_decoder_tpu_torch.utils import profiling as tprofiling
from isee3_decoder_tpu_torch.utils import sim as tsim
from isee3_decoder_tpu_torch.utils import testsignal as ttestsignal

JK7 = CodeSpec("TESTK7", 0o171, 0o133, 7, 0, 0)


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


# ---------------------------------------------------------------- testsignal


def test_testsignal_arrays_match_jax():
    np.testing.assert_array_equal(
        ttestsignal.gensine(5000, 1234.5, 32768.0, 15000.0, 0.3),
        jtestsignal.gensine(5000, 1234.5, 32768.0, 15000.0, 0.3))
    frames_t = ttestsignal.random_frames(np.random.default_rng(3), 3)
    frames_j = jtestsignal.random_frames(np.random.default_rng(3), 3)
    np.testing.assert_array_equal(frames_t, frames_j)
    for code in (DEFAULT_CODE, JK7):
        syms = ttestsignal.frames_to_symbols(frames_t, convert.code_spec(code))
        want = jtestsignal.frames_to_symbols(frames_j, code)
        assert syms.dtype == np.asarray(want).dtype
        np.testing.assert_array_equal(syms, np.asarray(want))
    for ss, clocks in ((244.140625, 1), (31.99, 1), (64.0, 2)):
        np.testing.assert_array_equal(
            ttestsignal.manchester_waveform(syms[:300], ss,
                                            symbolclocks=clocks),
            jtestsignal.manchester_waveform(syms[:300], ss,
                                            symbolclocks=clocks))
    kw = dict(samprate=32768.0, symrate=512.0, carrier=3000.0,
              noise_std=600.0, lead_symbols=40, symbolclocks=2)
    iq_t = ttestsignal.synthesize_iq(frames_t[:2],
                                     rng=np.random.default_rng(21), **kw)
    iq_j = jtestsignal.synthesize_iq(frames_j[:2],
                                     rng=np.random.default_rng(21), **kw)
    np.testing.assert_array_equal(iq_t, iq_j)
    np.testing.assert_array_equal(ttestsignal.iq_to_int16(iq_t * 4),
                                  jtestsignal.iq_to_int16(iq_j * 4))
    # the default rngs too
    np.testing.assert_array_equal(
        ttestsignal.synthesize_iq(frames_t[:1], noise_std=10.0,
                                  lead_symbols=8),
        jtestsignal.synthesize_iq(frames_j[:1], noise_std=10.0,
                                  lead_symbols=8))


# -------------------------------------------------------------------- encode


@pytest.mark.parametrize("code", [DEFAULT_CODE, JK7], ids=lambda c: c.name)
def test_encode_bytes_and_reencode_match_jax(code):
    rng = np.random.default_rng(7)
    data = rng.integers(0, 256, (3, 16), dtype=np.uint8)
    tcode = convert.code_spec(code)
    state = 0x5A5A & ((1 << (code.k - 1)) - 1)
    syms_t, fin_t = tencode.encode_bytes(torch.from_numpy(data), state, tcode)
    syms_j, fin_j = jencode.encode_bytes(jnp.asarray(data), state, code)
    np.testing.assert_array_equal(syms_t.numpy(), np.asarray(syms_j))
    np.testing.assert_array_equal(fin_t.numpy(), np.asarray(fin_j))
    # soft symbols of the encoded stream with some hard errors
    bits = rng.integers(0, 2, (3, 128), dtype=np.uint8)
    enc = np.asarray(jencode.encode_bits(jnp.asarray(bits), state, code)[0])
    soft = np.where(enc > 0, 200, 50).astype(np.uint8)
    flip = rng.random(soft.shape) < 0.05
    soft[flip] = 255 - soft[flip]
    soft[0, :4] = 128  # erasures slice to 0
    got = tencode.reencode_symbol_errors(torch.from_numpy(bits),
                                         torch.from_numpy(soft), state, tcode)
    want = jencode.reencode_symbol_errors(jnp.asarray(bits),
                                          jnp.asarray(soft), state, code)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got.numpy() > 0).all()


# ----------------------------------------------------------------- profiling


def test_profiling_matches_jax():
    cycles = np.random.default_rng(2).integers(200, 40_000, 300)
    assert tprofiling.cycle_histogram(cycles, 1024) == \
        jprofiling.cycle_histogram(cycles, 1024)
    assert tprofiling.cycle_histogram(torch.from_numpy(cycles), 256, 5) == \
        jprofiling.cycle_histogram(cycles, 256, 5)


# --------------------------------------------------------- gensine, spindown


def test_gensine_cli_bytes_match_jax():
    args = ["-c", "1500", "-r", "8000", "-a", "12000", "-s", "0.75",
            "-p", "0.4"]
    rc_j, want = _run_cli(jgensine_cli.main, args)
    rc_t, got = _run_cli(tgensine_cli.main, args + ["--device", "cpu"])
    assert rc_j == rc_t == 0
    assert len(got) == int(0.75 * 8000) * 4
    assert got == want


@pytest.mark.parametrize("flip", [False, True])
def test_spindown_cli_bytes_match_jax(tmp_path, flip):
    """Two whole blocks of 131,072 samples and a partial one, which both
    tools drop; the mixer's phase restarts each block."""
    rng = np.random.default_rng(11)
    n = 2 * 131072 + 5000
    iq = ttestsignal.synthesize_iq(rng.integers(0, 256, (1, 128),
                                                dtype=np.uint8),
                                   samprate=250_000.0, carrier=20_000.0,
                                   noise_std=900.0, rng=rng)
    raw = ttestsignal.iq_to_int16(np.resize(iq, n))
    path = tmp_path / "in.iq"
    raw.tofile(path)
    args = ["-c", "20000.5", "-r", "250000"] + (["-f"] if flip else [])
    rc_j, want = _run_cli(jspindown_cli.main, args + [str(path)])
    rc_t, got = _run_cli(tspindown_cli.main,
                         args + ["--device", "cpu", str(path)])
    assert rc_j == rc_t == 0
    assert len(got) == 2 * 131072 * 16
    assert got == want


# ------------------------------------------------------------- autocorrelate


def _plot_values(path) -> tuple[list[str], np.ndarray]:
    lines = path.read_text().splitlines()
    head = lines[:5]
    vals = np.array([[float(v) for v in ln.split()[1:]] for ln in lines[5:]])
    return head, vals


def test_autocorrelate_cli_plots_match_jax(tmp_path, monkeypatch):
    rng = np.random.default_rng(4)
    syms = rng.integers(0, 2, 700).astype(np.uint8)
    bb = 900 * ttestsignal.manchester_waveform(syms, 32.0)
    bb = (bb + rng.normal(0, 200, len(bb))).astype(np.int16)
    path = tmp_path / "bb.i16"
    bb.tofile(path)
    args = ["-r", "32768", "-o", "37", str(path)]
    for name, main, extra in (("jax", jautocorrelate_cli.main, []),
                              ("torch", tautocorrelate_cli.main,
                               ["--device", "cpu"])):
        (tmp_path / name).mkdir()
        monkeypatch.chdir(tmp_path / name)
        assert main(args[:-1] + extra + args[-1:]) == 0
    for plot in ("spectrum.plot", "autospect.plot", "autocorr.plot"):
        head_j, vals_j = _plot_values(tmp_path / "jax" / plot)
        head_t, vals_t = _plot_values(tmp_path / "torch" / plot)
        assert head_t == head_j
        assert vals_t.shape == vals_j.shape and len(vals_t) > 10_000
        np.testing.assert_array_equal(vals_t[:, 0], vals_j[:, 0])
        # values printed with %f: 1e-6 is the last digit either tool wrote
        np.testing.assert_allclose(vals_t[:, 1], vals_j[:, 1], rtol=1e-9,
                                   atol=1e-6, err_msg=plot)


# ----------------------------------------------------------- simtest, fanotest


def test_simtest_cli_and_channel_match_jax():
    """The CLI prints the port's simulate draws; on JAX's own uniforms the
    port's channel gives the JAX package's samples."""
    signal, esn0 = 100.0, 3.0
    noise = signal / (10 ** (esn0 / 20.0)) / np.sqrt(2.0)
    rc, out = _run_cli(tsimtest_cli.main, ["-n", "45", "-e", "3", "--seed",
                                           "2", "--device", "cpu"])
    assert rc == 0
    lines = out.decode().splitlines()
    for tx, at in ((0, 0), (1, 5)):
        assert lines[at] == f"tx symbol {tx}:"
        gen = torch.Generator().manual_seed(2 + tx)
        want = tsim.simulate(gen, torch.full((45,), tx, dtype=torch.uint8),
                             signal, noise).numpy()
        got = np.array([int(v) for ln in lines[at + 1 : at + 4]
                        for v in ln.split()])
        np.testing.assert_array_equal(got, want)
        assert lines[at + 4] == f"mean {want.mean():.2f} std {want.std():.2f}"
        key = jax.random.PRNGKey(5 + tx)
        tx_j = jnp.full(45, tx, jnp.uint8)
        u = np.asarray(jax.random.uniform(key, tx_j.shape, dtype=jnp.float32))
        np.testing.assert_array_equal(
            tsim.sample_channel(torch.tensor(u),
                                torch.full((45,), tx), signal, noise).numpy(),
            np.asarray(jsim.simulate(key, tx_j, signal, noise)))


def test_fanotest_cli_matches_jax_on_the_same_channel():
    """-l 256 -n 16 -e 4 -vv: every trial's goodbits, metric and cycles,
    and the summary, equal the JAX package's Fano decoder on the port's
    channel (the CLI's draws, through sample_channel)."""
    nbits, trials, seed, ebn0, signal = 256, 16, 3, 4.0, 30.0
    rc, out = _run_cli(tfanotest_cli.main,
                       ["-l", str(nbits), "-n", str(trials), "-e", str(ebn0),
                        "-vv", "--seed", str(seed), "--device", "cpu"])
    assert rc == 0
    lines = out.decode().splitlines()
    code = DEFAULT_CODE
    noise = signal / math.sqrt(2 * 0.5 * 10 ** (ebn0 / 10))
    # the CLI's data bits and channel uniforms, drawn again
    rng = np.random.default_rng(seed)
    bits = np.zeros((trials, nbits), np.uint8)
    bits[:, : nbits - 64] = rng.integers(0, 2, (trials, nbits - 64))
    for j in range(code.k - 1):
        bits[:, nbits - 1 - j] = (tfanotest_cli.TAIL >> j) & 1
    syms, _ = jencode.encode_bits(jnp.asarray(bits), tfanotest_cli.START,
                                  code)
    syms = np.asarray(syms)
    u = torch.rand(syms.shape, generator=torch.Generator().manual_seed(seed),
                   dtype=torch.float32)
    rx = tsim.sample_channel(u, torch.tensor(syms), signal, noise)
    mettab = jnp.asarray(jmetrics.gen_met(signal, noise, 0.5, 8))
    res = jfano.fano_decode(jnp.asarray(rx.numpy()), mettab, nbits,
                            tfanotest_cli.START, tfanotest_cli.TAIL, code,
                            jfano.FanoParams(delta=32, maxcycles=1000))
    goodbits, cycles = np.asarray(res.goodbits), np.asarray(res.cycles)
    want = [f"trial {i} fano returns {goodbits[i]}, metric = "
            f"{int(res.metric[i])}, cycles = {int(cycles[i])}"
            for i in range(trials)]
    assert lines[2 : 2 + trials] == want
    mismatch = (np.asarray(res.bits) != bits).any(axis=1)
    good, bad = int((~mismatch).sum()), int(mismatch.sum())
    undetected = int(((goodbits == nbits) & mismatch).sum())
    assert lines[-1] == (
        f"trials {trials} avg cycles/bit "
        f"{int(cycles.sum()) / (trials * nbits):g} good {good} bad {bad} "
        f"undetected {undetected} deletion rate {100.0 * bad / trials:g}%")
    assert good >= trials - 2
    assert lines[0] == f"Code rate 0.50, Nbits = {nbits}, Maxcycles/bit 1000"


def test_tools_refuse_a_missing_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    for main, argv in ((tfanotest_cli.main, ["-n", "1"]),
                       (tsimtest_cli.main, []),
                       (tgensine_cli.main, []),
                       (tspindown_cli.main, [str(tmp_path / "x.iq")]),
                       (tautocorrelate_cli.main, [str(tmp_path / "x.i16")]),
                       (tsymdemod_cli.main, ["-t"])):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            main(argv)


# ------------------------------------------------------------- symdemod -t

TRACK_ARGS = ["-r", "32768", "-c", "1024.", "-t", "--device", "cpu"]
CFG_J = jsym.SymConfig(samprate=32768.0, symrate=1024.0)


def _baseband(seed: int, symrate: float, seconds: float | None = None,
              nframes: int | None = None) -> np.ndarray:
    """int16 Manchester baseband at 32,768 sps, amplitude 2000, noise 150:
    ``nframes`` encoded frames (the JAX package's tracker tests' signal),
    or random symbols ``seconds`` long."""
    rng = np.random.default_rng(seed)
    if nframes is not None:
        syms = ttestsignal.frames_to_symbols(
            ttestsignal.random_frames(rng, nframes))
    else:
        syms = rng.integers(0, 2, int(seconds * symrate) + 8).astype(np.uint8)
    wave = ttestsignal.manchester_waveform(syms, 32768.0 / symrate)
    x = (2000.0 * wave + rng.normal(0, 150.0, len(wave))).astype(np.int16)
    return x if seconds is None else x[: int(seconds * 32768)]


def _buffer_slides(infos, cfg) -> list[int]:
    """The samples the CLI has purged from its buffer before each window
    (symdemod.c:101-112), replayed on the library tracker's per-window
    starts and clocks."""
    wsamples = cfg.window * cfg.samprate
    first = int(cfg.symbolsamples / 2)
    ss = cfg.symbolsamples
    total, out = 0, []
    for info in infos:
        if first >= wsamples:
            slide = int(first - 2 * ss)
            first -= slide
            total += slide
        out.append(total)
        ss = float(info["symbolsamples"][0])
        nsym = int(wsamples / ss)
        first = int(int(info["firstsample"][0]) - total + nsym * ss)
    return out


def _tracked_cli(x: np.ndarray, capsys) -> tuple[np.ndarray, list, str]:
    """symdemod -t on x in this process → (bytes, the JAX library host
    tracker's soft symbols and infos over the windows the CLI wrote, its
    status text)."""
    rc, out = _run_cli(tsymdemod_cli.main, TRACK_ARGS, x.tobytes())
    assert rc == 0
    got = np.frombuffer(out, np.uint8)
    nwin = -(-got.size // 1024)
    want, infos = jsymdemod.symdemod_tracked(x[None], CFG_J, nwin,
                                             backend="host")
    return got, (np.asarray(want)[0], infos), capsys.readouterr().err


def test_symdemod_tracking_cli_matches_the_library_tracker(capsys):
    """3 windows of a recording sent at 1024.545 Hz, demodulated from
    1024.0: the buffer is purged before window 2 (by an even count); the
    bytes are those of the JAX package's library host tracker on the
    whole recording, window by window."""
    x = _baseband(2, 1024.545, seconds=3.3)
    got, (want, infos), err = _tracked_cli(x, capsys)
    slides = _buffer_slides(infos, CFG_J)
    assert len(infos) == 3 and slides[:2] == [0, 0] and slides[2] > 0
    assert slides[2] % 2 == 0
    nsyms = [int(32768 / float(i["symbolsamples"][0])) for i in infos]
    assert got.size == sum(nsyms) == want.size
    np.testing.assert_array_equal(got, want)
    assert "tracking on" in err
    assert [ln.split()[2] for ln in err.splitlines()[1:]] == [
        f"{int(i['firstsample'][0]):,}" for i in infos]


def test_symdemod_tracking_cli_ends_where_the_next_window_starts_inside_the_buffer(capsys):
    """The recording on which the JAX package's CLI never leaves its first
    window (2 frames sent at 1024.4 Hz, 4.0 s, seed 5): after window 0,
    firstsample + nsym·ss stays under one window, so the buffer is not
    purged.  The port's CLI carries firstsample on from there, writes
    each of the 4 windows once and ends, with the library's bytes."""
    x = _baseband(5, 1024.4, nframes=2)
    got, (want, infos), err = _tracked_cli(x, capsys)
    ss0 = float(infos[0]["symbolsamples"][0])
    assert int(infos[0]["firstsample"][0]) + int(32768 / ss0) * ss0 < 32768
    assert _buffer_slides(infos, CFG_J)[1] == 0
    nsyms = [int(32768 / float(i["symbolsamples"][0])) for i in infos]
    assert len(infos) == 4 and got.size == sum(nsyms)
    np.testing.assert_array_equal(got, want)
    samples = [int(ln.split()[2].replace(",", ""))
               for ln in err.splitlines()[1:]]
    assert len(samples) == 4 and all(np.diff(samples) > 30_000)


def test_symdemod_tracking_cli_follows_buffer_relative_ties(capsys):
    """The one place the CLI and the library part: a purge slides the
    buffer by int(firstsample - 2·ss) samples, and an odd slide flips a
    round-half-to-even tie between the library's absolute edges and the
    buffer's.  Sent at 1023.7 Hz, the climb settles at ss = 32.0009765625,
    whose edge 1024 (16384.5 samples in) is a tie; the purge before
    window 2 slides 65,421 samples, an odd count, so in windows 2 and 3
    the CLI rounds that edge as the C's buffer-relative integrator does
    and the symbols on either side of it (511 and 512 of the window)
    differ from the library's.  Every other byte is equal."""
    x = _baseband(8, 1023.7, seconds=4.0)
    got, (want, infos), _ = _tracked_cli(x, capsys)
    slides = _buffer_slides(infos, CFG_J)
    assert slides[:3] == [0, 0, 65421] and slides[3] % 2 == 1
    expect = set()
    start = 0
    for info, slide in zip(infos, slides):
        ss = float(info["symbolsamples"][0])
        nsym = int(32768 / ss)
        if slide % 2:
            rel = tsym.trial_edges(ss / 2, nsym, 1)
            for j in np.nonzero(rel - np.floor(rel) == 0.5)[0]:
                # edge j bounds the segments of symbols (j-1)//2 and j//2
                expect.update(start + m for m in ((j - 1) // 2, j // 2)
                              if 0 <= m < nsym)
        start += nsym
    assert got.size == want.size == start
    diff = set(np.nonzero(got != want)[0].tolist())
    assert diff and diff <= expect
    assert sorted(diff) == [2046 + 511, 2046 + 512, 3069 + 511, 3069 + 512]


def test_symdemod_tracking_cli_reads_per_window(capsys):
    """Each tracked window adds its probes and reads to the trackers'
    counts: one read a probe, two of the search, one of the soft
    symbols."""
    tsymdemod.reset_track_stats()
    x = _baseband(2, 1024.545, seconds=2.2)
    rc, out = _run_cli(tsymdemod_cli.main, ["-q"] + TRACK_ARGS, x.tobytes())
    assert rc == 0 and len(out) == 2 * 1023
    stats = tsymdemod.track_stats
    assert len(stats["iterations"]) == 2
    assert all(r == i + 3 and i >= 4 for r, i in zip(stats["host_reads"],
                                                     stats["iterations"]))


def test_symdemod_tracking_cli_matches_the_library_tracker_16bps(capsys):
    """symdemod -r 8192 -c 32. -t: the 16 bps subcarrier mode (32 clocks a
    symbol, 256 samples a symbol) on 5.5 s of baseband sent at 32 sym/s
    on the measured clock, off the nominal 32 the clock estimate starts
    from.  Its bytes are the port's library host tracker's on the whole
    recording, window by window, and the JAX package's batched tracker's
    (which the climb matches here: it stays inside one grid step of the
    host's clock).  The JAX package's host tracker gives the same bytes
    but compiles for ~2 minutes in this mode, so it is not run here."""
    from isee3_decoder_tpu.config import ACTUALCLOCK, NOMINALCLOCK
    from isee3_decoder_tpu.models import symdemod_tracked as jtracked

    symrate = 32.0 * ACTUALCLOCK / NOMINALCLOCK
    rng = np.random.default_rng(16)
    syms = rng.integers(0, 2, int(5.5 * symrate) + 8).astype(np.uint8)
    wave = ttestsignal.manchester_waveform(syms, 8192.0 / symrate,
                                           symbolclocks=32)
    x = (2000.0 * wave + rng.normal(0, 150.0, len(wave))).astype(
        np.int16)[: int(5.5 * 8192)]
    rc, out = _run_cli(tsymdemod_cli.main,
                       ["-r", "8192", "-c", "32.", "-t", "--device", "cpu"],
                       x.tobytes())
    assert rc == 0
    got = np.frombuffer(out, np.uint8)
    nwin = -(-got.size // 32)
    tcfg = tsym.SymConfig(samprate=8192.0, symrate=32.0, symbolclocks=32)
    want, infos = tsymdemod.symdemod_tracked(x[None], tcfg, nwin,
                                             backend="host", device="cpu")
    assert nwin == 5 and got.size >= nwin * 31
    np.testing.assert_array_equal(got, np.asarray(want)[0])
    jcfg = jsym.SymConfig(samprate=8192.0, symrate=32.0, symbolclocks=32)
    soft_j, infos_j = jtracked.symdemod_tracked_batched(x[None], jcfg, nwin)
    np.testing.assert_array_equal(got, np.asarray(soft_j)[0])
    for it, ij in zip(infos, infos_j):
        for key in ("firstsample", "symbolsamples"):
            np.testing.assert_array_equal(np.asarray(it[key]),
                                          np.asarray(ij[key]), err_msg=key)
    assert float(infos[-1]["symbolsamples"][0]) < tcfg.symbolsamples
    assert "clocks/symbol 32" in capsys.readouterr().err
