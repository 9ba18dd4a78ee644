"""PyTorch port vs the JAX package: the float64 pm branch, the JAX
package's C-matching golden mode (``PMConfig(dtype=float64)``).

The JAX package computes float64 outside every Pallas kernel (its gates
``_fast_search_capable``, ``_raw_fast_capable``, ``_scan_fused_capable``
demand float32), so the port's float64 branch is plain torch and never
reaches K1, K2, K8 or K9; the int16 baseband then goes through K3, K4
(and K5/K6) as a float32 run's does.

Tolerances: the baseband within 1 LSB of JAX's, and byte for byte on the
golden test's own signal (tests/test_golden_c.py, seed 42); carrier
frequency and C/N0 within rtol 1e-9; locks, frames, flags, decoder
labels and start symbols exact.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isee3_decoder_tpu.models import pipeline as jpipe
from isee3_decoder_tpu.models.decode import DecodeConfig
from isee3_decoder_tpu.ops import carrier as jc
from isee3_decoder_tpu.ops.symbols import SymConfig
from isee3_decoder_tpu.utils import checkpoint as jckpt
from isee3_decoder_tpu.utils import testsignal
from isee3_decoder_tpu_torch import _kernels
from isee3_decoder_tpu_torch.models import pipeline as tpipe
from isee3_decoder_tpu_torch.ops import carrier as tc
from isee3_decoder_tpu_torch.utils import checkpoint, convert
from tests.test_pmdemod import pm_signal

CFG64 = jc.PMConfig(samprate=32768.0, binsize=4.0, search_width=100.0,
                    dtype=jnp.float64)
NCH = 4
RTOL = 1e-9
#: the stages a kernel of the pm step would note (K1/K2 "pm" as "cuda",
#: K8 "search", K9 "pm_scan", their designs "pm_locked" and "spin")
KERNEL_STAGES = ("search", "pm_scan", "pm_locked", "spin")


def _assert_plain_f64():
    assert _kernels.backend_used.get("pm") == "plain_f64", _kernels.backend_used
    assert not set(KERNEL_STAGES) & _kernels.backend_used.keys(), \
        _kernels.backend_used


def _assert_block(o_t, o_j, exact: bool = False):
    assert o_t.carrier_freq.dtype == torch.float64
    assert o_t.cn0.dtype == torch.float64
    np.testing.assert_array_equal(o_t.locked.numpy(), np.asarray(o_j.locked))
    np.testing.assert_allclose(o_t.carrier_freq.numpy(),
                               np.asarray(o_j.carrier_freq), rtol=RTOL)
    np.testing.assert_allclose(o_t.cn0.numpy(), np.asarray(o_j.cn0), rtol=RTOL)
    diff = np.abs(o_t.baseband.numpy().astype(np.int32)
                  - np.asarray(o_j.baseband, np.int32))
    assert diff.max() <= (0 if exact else 1), diff.max()
    return int((diff > 0).sum())


def _raw_blocks(seed: int, nblocks: int, doppler: float = 0.0) -> np.ndarray:
    """(NCH, nblocks, 2n) int16 interleaved PM channels, 2000 + 137·c Hz."""
    rng = np.random.default_rng(seed)
    n = CFG64.fftsize
    L = n * nblocks
    data = rng.integers(0, 2, 128 * nblocks) * 2 - 1
    i = np.arange(L, dtype=np.float64) % n
    chirp = np.exp(2j * np.pi * (doppler / CFG64.samprate**2) * (i * (i + 1) / 2))
    iq = np.stack([
        (pm_signal(L, CFG64.samprate, 2000.0 + 137.0 * c, 1.1, data, 32.0,
                   amp=12000)
         + rng.normal(0, 300, L) + 1j * rng.normal(0, 300, L)) * chirp
        for c in range(NCH)
    ])
    ri = np.stack([iq.real, iq.imag], axis=-1).reshape(NCH, -1)
    raw = np.trunc(np.clip(ri, -32767, 32767)).astype(np.int16)
    return raw.reshape(NCH, nblocks, 2 * n)


def test_golden_signal_block_by_block_is_byte_equal():
    """tests/test_golden_c.py's pmdemod recipe (seed 42, 32,768 sps,
    binsize 4, W 100, noise 1200; the compiled pmdemod's bytes there):
    every block's int16 baseband equals the JAX float64 branch's."""
    rng = np.random.default_rng(42)
    frames = testsignal.random_frames(rng, 2)
    iq = testsignal.synthesize_iq(
        frames, samprate=32768.0, symrate=1024.0, carrier=4000.0,
        noise_std=1200.0, lead_symbols=30, rng=rng,
    )
    raw = testsignal.iq_to_int16(iq)
    tcfg = convert.pm_config(CFG64)
    assert tcfg.dtype == torch.float64 and tcfg.cdtype == torch.complex128
    n = CFG64.fftsize
    z = raw[0::2].astype(np.float64) + 1j * raw[1::2].astype(np.float64)
    c_j, c_t = jc.init_carry(1, CFG64), tc.init_carry(1, tcfg)
    assert c_t.search_center.dtype == torch.float64
    nblocks = len(z) // n
    assert nblocks >= 10
    _kernels.reset_launches()
    for b in range(nblocks):
        x = z[b * n:(b + 1) * n][None, :]
        c_j, o_j = jc.pm_demod_block(c_j, jnp.asarray(x), CFG64)
        c_t, o_t = tc.pm_demod_block(c_t, torch.from_numpy(x), tcfg)
        _assert_block(o_t, o_j, exact=True)
    assert bool(o_t.locked.all())
    _assert_plain_f64()


@pytest.mark.parametrize("case", ["locked", "unlocked", "doppler"])
def test_pm_demod_block_raw_matches_jax(case):
    """One raw int16 block, locked (carry on the carriers at 60 dB-Hz),
    unlocked (cold carry) and with a -30 Hz/s Doppler rate, against the
    JAX float64 branch's block step on the same block (its scan's
    iq_from_interleaved → pm_demod_block)."""
    dop = -30.0 if case == "doppler" else 0.0
    jcfg = jc.PMConfig(samprate=32768.0, binsize=4.0, search_width=100.0,
                       doppler_rate=dop, dtype=jnp.float64)
    tcfg = convert.pm_config(jcfg)
    raw = _raw_blocks(30, 1, doppler=dop)[:, 0]
    freqs = 2000.0 + 137.0 * np.arange(NCH)
    cn0 = -999.0 if case == "unlocked" else 60.0
    c_j = jc.PMCarry(search_center=jnp.asarray(freqs, jnp.float64),
                     cn0=jnp.full((NCH,), cn0, jnp.float64))
    c_j, o_j = jc.pm_demod_block(c_j, jc.iq_from_interleaved(jnp.asarray(raw)),
                                 jcfg)
    carry = convert.pm_carry(jc.PMCarry(search_center=np.asarray(freqs),
                                        cn0=np.full((NCH,), cn0)))
    out = torch.empty((NCH, jcfg.fftsize), dtype=torch.int16)
    _kernels.reset_launches()
    c_t, o_t = tc.pm_demod_block_raw(carry, torch.from_numpy(raw), tcfg,
                                     out=out)
    _assert_plain_f64()
    assert o_t.baseband is out
    _assert_block(o_t, o_j)
    assert bool(o_t.locked.all())
    np.testing.assert_allclose(c_t.search_center.numpy(),
                               np.asarray(c_j.search_center), rtol=RTOL)


def test_pm_demod_scan_raw_matches_jax():
    """Three raw blocks from a cold carry: the JAX float64 scan and the
    port's, carry threaded across blocks."""
    tcfg = convert.pm_config(CFG64)
    blocks = _raw_blocks(31, 3)
    c_j, o_j = jc.pm_demod_scan(jc.init_carry(NCH, CFG64), jnp.asarray(blocks),
                                CFG64)
    _kernels.reset_launches()
    c_t, o_t = tc.pm_demod_scan(tc.init_carry(NCH, tcfg),
                                torch.from_numpy(blocks), tcfg)
    _assert_plain_f64()
    _assert_block(o_t, o_j)
    assert np.asarray(o_j.locked)[1:].all()
    for f in ("search_center", "cn0"):
        assert getattr(c_t, f).dtype == torch.float64
        np.testing.assert_allclose(getattr(c_t, f).numpy(),
                                   np.asarray(getattr(c_j, f)), rtol=RTOL)


def _iq(seed: int, noises) -> np.ndarray:
    rng = np.random.default_rng(seed)
    frames = testsignal.random_frames(rng, 3)
    iqs = [
        testsignal.iq_to_int16(testsignal.synthesize_iq(
            frames, samprate=32768.0, symrate=512.0, carrier=5000.0 + 1100.0 * i,
            noise_std=ns, lead_symbols=30, rng=rng,
        ))
        for i, ns in enumerate(noises)
    ]
    L = min(len(q) for q in iqs)
    return frames, np.stack([q[:L] for q in iqs])


@pytest.mark.parametrize("pm_backend", ["auto", "fused_scan"])
def test_receive_block_float64_matches_jax(pm_backend):
    """receive_block and demod_to_symbols with a float64 PMConfig (the
    locked 2-channel recipe of tests/test_torch_pipeline.py): frames,
    flags, labels, start symbols and sync starts exact, the baseband
    within 1 LSB, carrier and C/N0 within rtol 1e-9.  The fused scan's
    gate refuses float64, as JAX's does, so both backends run the block
    scan."""
    cfg = jpipe.PipelineConfig(
        pm=CFG64,
        sym=SymConfig(samprate=32768.0, symrate=512.0, window=0.5),
        decode=DecodeConfig(viterbi_enabled=False, fano_tier1_maxcycles=1,
                            fano_maxcycles=3),
        pm_backend=pm_backend,
    )
    frames, iq = _iq(11, [900.0, 900.0])
    tcfg = convert.pipeline_config(cfg)
    assert not tc._scan_fused_capable(tcfg.pm, tcfg.pm.fftsize, 8)
    rec_j, ss_j = jpipe.receive_block(iq, 1, cfg)
    _kernels.reset_launches()
    rec_t, ss_t = tpipe.receive_block(torch.from_numpy(iq), 1, tcfg,
                                      device="cpu")
    _assert_plain_f64()
    assert _kernels.backend_used.get("csum") == "torch"
    np.testing.assert_array_equal(ss_t, ss_j)
    for f in ("data", "good", "decoder", "start_symbol"):
        np.testing.assert_array_equal(getattr(rec_t, f), getattr(rec_j, f), f)
    assert rec_t.good.all()
    for d in rec_t.data:
        assert any(np.array_equal(d, fr) for fr in frames)

    soft_j, bb_j, f_j, c_j = jpipe.demod_to_symbols(jnp.asarray(iq), cfg)
    soft_t, bb_t, f_t, c_t = tpipe.demod_to_symbols(torch.from_numpy(iq), tcfg)
    diff = np.abs(bb_t.numpy().astype(np.int32) - np.asarray(bb_j, np.int32))
    assert diff.max() <= 1, diff.max()
    assert f_t.dtype == torch.float64 and c_t.dtype == torch.float64
    np.testing.assert_allclose(f_t.numpy(), np.asarray(f_j), rtol=RTOL)
    np.testing.assert_allclose(c_t.numpy(), np.asarray(c_j), rtol=RTOL)
    assert soft_t.shape == soft_j.shape
    nsoft = int((soft_t.numpy() != np.asarray(soft_j)).sum())
    print(f"baseband samples off by 1 LSB: {int((diff > 0).sum())}; "
          f"soft symbols that differ: {nsoft} of {soft_t.numel()}")


STREAM_CFG = jpipe.PipelineConfig(
    pm=jc.PMConfig(samprate=32768.0, binsize=32.0, search_width=100.0,
                   dtype=jnp.float64),
    sym=SymConfig(samprate=32768.0, symrate=512.0, window=0.5),
    decode=DecodeConfig(fano_tier1_maxcycles=1, fano_maxcycles=3),
)


def _stream_recording() -> np.ndarray:
    rng = np.random.default_rng(6)
    frames = testsignal.random_frames(rng, 4)
    iq = testsignal.synthesize_iq(
        frames, samprate=32768.0, symrate=512.0, carrier=5000.0,
        noise_std=600.0, lead_symbols=50, rng=rng,
    )
    return testsignal.iq_to_int16(iq)


def _flatten(records):
    return [(int(r.start_symbol[b]), bool(r.good[b]), int(r.decoder[b]),
             bytes(r.data[b]))
            for r in records for b in range(r.data.shape[0])]


def test_receive_stream_float64_matches_jax_chunk_by_chunk(tmp_path):
    """The streaming chain with a float64 pm carry, chunk by chunk against
    the JAX receive_stream: records and every carry field after each
    chunk (the carry's pm fields float64 within rtol 1e-9); then the
    carry goes through a checkpoint and finishes the stream as the live
    one does."""
    tcfg = convert.pipeline_config(STREAM_CFG)
    raw = _stream_recording()
    cuts = [0, 1536, 1536 + 2 * 32768, 1536 + 2 * 32768 + 99000, len(raw)]
    cj = jpipe.init_chain_carry(1, STREAM_CFG)
    ct = tpipe.init_chain_carry(1, tcfg, device="cpu")
    assert ct.pm.search_center.dtype == torch.float64
    assert np.asarray(cj.pm.search_center).dtype == np.float64
    nrec = 0
    for lo, hi in zip(cuts[:-2], cuts[1:-1]):
        rj, cj = jpipe.receive_stream(raw[None, lo:hi], STREAM_CFG, cj)
        rt, ct = tpipe.receive_stream(torch.from_numpy(raw[None, lo:hi]), tcfg,
                                      ct)
        where = f"chunk {lo}:{hi}"
        assert _flatten(rt) == _flatten(rj), where
        nrec += len(rt)
        np.testing.assert_array_equal(ct.iq_rem.numpy(), cj.iq_rem, where)
        for f in ("bb_base", "bb_total", "windows_done", "soft_base"):
            assert getattr(ct, f) == getattr(cj, f), (where, f)
        assert ct.bb.shape == cj.bb.shape, where
        if cj.bb.size:
            diff = np.abs(ct.bb.numpy().astype(np.int32) - cj.bb.astype(np.int32))
            assert diff.max() <= 1, (where, diff.max())
        np.testing.assert_array_equal(ct.first.numpy(), cj.first, where)
        np.testing.assert_array_equal(ct.soft.numpy(), cj.soft, where)
        for f in ("lock", "pos", "sync_start"):
            np.testing.assert_array_equal(getattr(ct.dec, f),
                                          getattr(cj.dec, f), (where, f))
        for f in ("search_center", "cn0"):
            assert getattr(ct.pm, f).dtype == torch.float64
            np.testing.assert_allclose(getattr(ct.pm, f).numpy(),
                                       np.asarray(getattr(cj.pm, f)), rtol=RTOL)

    path = tmp_path / "carry64.npz"
    checkpoint.save_pytree(path, ct)
    manifest = checkpoint.load_manifest(path)
    assert manifest["leaves"][0]["dtype"] == "float64"
    restored = checkpoint.restore_pytree(path, tpipe.chain_carry_template(
        manifest, tcfg, device="cpu"))
    last = torch.from_numpy(raw[None, cuts[-2]:])
    recs_a, carry_a = tpipe.receive_stream(last, tcfg, ct)
    recs_b, carry_b = tpipe.receive_stream(last, tcfg, restored)
    rj, cj = jpipe.receive_stream(raw[None, cuts[-2]:], STREAM_CFG, cj)
    assert _flatten(recs_a) == _flatten(recs_b) == _flatten(rj)
    nrec += len(recs_a)
    for f in ("search_center", "cn0"):
        assert torch.equal(getattr(carry_a.pm, f), getattr(carry_b.pm, f))
    assert nrec >= 2


def test_float64_pm_carry_crosses_packages(tmp_path):
    """A float64 pm carry saved by the port restores in the JAX package
    onto its float64 template, and the reverse, under the dtype name
    "float64" in the manifest."""
    tcfg = convert.pm_config(CFG64)
    blocks = _raw_blocks(32, 2)
    c_t, _ = tc.pm_demod_scan(tc.init_carry(NCH, tcfg), torch.from_numpy(blocks),
                              tcfg)
    c_j, _ = jc.pm_demod_scan(jc.init_carry(NCH, CFG64), jnp.asarray(blocks),
                              CFG64)

    port_file = tmp_path / "port.npz"
    checkpoint.save_pytree(port_file, {"pm": c_t, "first": torch.arange(NCH)})
    assert [(m["path"], m["dtype"]) for m in
            jckpt.load_manifest(port_file)["leaves"]] == [
        ("['first']", "int64"), ("['pm'].search_center", "float64"),
        ("['pm'].cn0", "float64")]
    got = jckpt.restore_pytree(port_file, {
        "pm": jc.init_carry(NCH, CFG64), "first": np.zeros(NCH, np.int64)})
    np.testing.assert_array_equal(np.asarray(got["pm"].search_center),
                                  c_t.search_center.numpy())
    np.testing.assert_array_equal(np.asarray(got["pm"].cn0), c_t.cn0.numpy())

    jax_file = tmp_path / "jax.npz"
    jckpt.save_pytree(jax_file, {"pm": c_j})
    got = checkpoint.restore_pytree(jax_file, {"pm": tc.init_carry(NCH, tcfg)})
    assert got["pm"].search_center.dtype == torch.float64
    np.testing.assert_array_equal(got["pm"].search_center.numpy(),
                                  np.asarray(c_j.search_center))
    np.testing.assert_array_equal(got["pm"].cn0.numpy(), np.asarray(c_j.cn0))
    # a float32 template refuses the float64 file
    with pytest.raises(ValueError, match="dtype"):
        checkpoint.restore_pytree(jax_file, {"pm": tc.init_carry(NCH, tc.PMConfig())})


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.float64])
def test_pm_carry_keeps_the_dtype(dtype):
    cfg = jc.PMConfig(dtype=dtype)
    c = convert.pm_carry(jc.init_carry(3, cfg, 1500.0))
    want = convert.torch_dtype(dtype)
    assert c.search_center.dtype == want and c.cn0.dtype == want
    assert c.search_center.tolist() == [1500.0] * 3
    t = tc.init_carry(3, convert.pm_config(cfg), 1500.0)
    assert t.search_center.dtype == want and t.cn0.dtype == want


GATE_CASES = {
    "n8192": dict(samprate=32768.0, binsize=4.0, search_width=100.0),
    "n65536": dict(samprate=250_000.0, binsize=4.0, search_width=100.0),
    "n4096": dict(samprate=32768.0, binsize=8.0, search_width=100.0),
    "doppler": dict(samprate=32768.0, binsize=4.0, search_width=100.0,
                    doppler_rate=40.0),
    "no_window": dict(samprate=32768.0, binsize=4.0),
    "always_fft": dict(samprate=32768.0, binsize=4.0, search_width=100.0,
                       fast_locked_search=False),
}


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.float64],
                         ids=["float32", "float64"])
@pytest.mark.parametrize("case", list(GATE_CASES))
def test_gates_follow_jax(case, dtype):
    """The port's static gates against the JAX package's on the same
    config (its search backend set to the kernels, so its gates read the
    shapes and the dtype rather than the host platform; 8 channels, the
    JAX kernels' batch tile): the windowed search, and the one-launch pm
    scan (JAX ``_raw_fast_capable`` and ``_scan_fused_capable``)."""
    jcfg = jc.PMConfig(**GATE_CASES[case], dtype=dtype,
                       search_backend="pallas_interpret")
    tcfg = convert.pm_config(jcfg)
    n, B, T = jcfg.fftsize, 8, 4
    assert tc._fast_search_capable(tcfg) == jc._fast_search_capable(jcfg)
    # the port's K1 takes every n, where JAX's raw path needs its
    # spin-down chunk: compare the scan gate where JAX's chunk divides n
    if n % 8192 == 0:
        assert (tc._fast_search_capable(tcfg) and tcfg.fast_locked_search) \
            == jc._raw_fast_capable(jcfg, B, n)
    assert tc._scan_fused_capable(tcfg, n, T) == jc._scan_fused_capable(
        jcfg, B, n, T)
    if dtype == jnp.float64:
        assert not tc._fast_search_capable(tcfg)
        assert not tc._scan_fused_capable(tcfg, n, T)


@pytest.mark.parametrize("dtype", [torch.float16, torch.bfloat16, torch.int32])
def test_other_precisions_are_refused(dtype):
    """Only float32 (the kernels) and float64 (the plain golden branch)
    exist: any other PMConfig.dtype is refused when the config is made,
    so no entry point takes it quietly down the plain branch."""
    with pytest.raises(ValueError, match="float32 .* or float64"):
        tc.PMConfig(samprate=32768.0, dtype=dtype)
    with pytest.raises(ValueError, match="float32 .* or float64"):
        convert.pm_config(jc.PMConfig(samprate=32768.0, dtype=jnp.float16))
