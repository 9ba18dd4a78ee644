"""PyTorch port vs the JAX package: the polyphase channelizer.

ops/channelizer (the plain bank) against the JAX bank on identical
numpy inputs, and ops/channelizer_cuda — the module of kernels K7a/K7b —
through its plain version against the JAX Pallas kernel in interpret
mode.  Tolerances: complex bank outputs within 1e-5 of the peak (two
float32 FFT libraries); int16 raw within 1 LSB on under 1 % of the
samples, the JAX package's own bound for its kernel against its bank
(float32 rounding at truncation boundaries).  The JAX kernel emits whole
tiles only, so raw outputs are compared on their common prefix.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isee3_decoder_tpu.cli import channelize as jcli
from isee3_decoder_tpu.ops import channelizer as jchan
from isee3_decoder_tpu.ops import channelizer_pallas as jfused
from isee3_decoder_tpu_torch.cli import channelize as tcli
from isee3_decoder_tpu_torch.ops import channelizer as tchan
from isee3_decoder_tpu_torch.ops import channelizer_cuda as tfused
from isee3_decoder_tpu_torch.utils.devicesignal import to_packed_wide

M, P = 128, 8


def _random_capture(rng, nframes, lo=-20000, hi=20000, nchan=M):
    i = rng.integers(lo, hi, (nframes, nchan)).astype(np.int32)
    q = rng.integers(lo, hi, (nframes, nchan)).astype(np.int32)
    packed = ((i & 0xFFFF) | (q << 16)).reshape(-1)
    wide_c = (i.astype(np.float32) + 1j * q.astype(np.float32)).reshape(-1)
    return packed, wide_c.astype(np.complex64)


def _tone_packed(freq_cycles_per_sample, amplitude, nframes):
    n = np.arange(nframes * M)
    tone = amplitude * np.exp(2j * np.pi * freq_cycles_per_sample * n)
    i = np.round(tone.real).astype(np.int32)
    q = np.round(tone.imag).astype(np.int32)
    return torch.from_numpy((i & 0xFFFF) | (q << 16))


@pytest.mark.parametrize("nchan,taps,cutoff", [(128, 8, 1.0), (128, 8, 1.2),
                                               (16, 4, 1.0), (8, 12, 1.2)])
def test_prototype_lowpass_equal(nchan, taps, cutoff):
    """Nothing to carry across but the taps: the same float32 array."""
    a = tchan.prototype_lowpass(nchan, taps, cutoff_scale=cutoff)
    b = jchan.prototype_lowpass(nchan, taps, cutoff_scale=cutoff)
    assert a.dtype == b.dtype == np.float32
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("oversample", [1, 2])
@pytest.mark.parametrize("nchan,batch", [(16, None), (6, 2)])
def test_channelize_matches_jax(oversample, nchan, batch):
    rng = np.random.default_rng(10 * nchan + oversample)
    shape = (nchan * 203 + 5,) if batch is None else (batch, nchan * 203 + 5)
    x = (rng.normal(0, 3000, shape) + 1j * rng.normal(0, 3000, shape)
         ).astype(np.complex64)
    want = np.asarray(jchan.channelize(jnp.asarray(x), nchan,
                                       oversample=oversample))
    got = tchan.channelize(torch.from_numpy(x), nchan, oversample=oversample)
    assert got.dtype == torch.complex64
    assert tuple(got.shape) == want.shape
    assert np.abs(got.numpy() - want).max() <= 1e-5 * np.abs(want).max()


def test_channelize_custom_taps_and_errors():
    rng = np.random.default_rng(3)
    x = (rng.normal(0, 1, 8 * 40) + 1j * rng.normal(0, 1, 8 * 40)
         ).astype(np.complex64)
    taps = rng.normal(0, 1, 8 * 4).astype(np.float32)
    want = np.asarray(jchan.channelize(jnp.asarray(x), 8, 4, jnp.asarray(taps)))
    got = tchan.channelize(torch.from_numpy(x), 8, 4, taps).numpy()
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    with pytest.raises(ValueError, match="oversample"):
        tchan.channelize(torch.from_numpy(x), 8, oversample=3)
    with pytest.raises(ValueError, match="even"):
        tchan.channelize(torch.from_numpy(x), 5, oversample=2)
    for k in range(8):
        assert tchan.channel_center(k, 2.0e6, 8) == jchan.channel_center(
            k, 2.0e6, 8)


def test_packing_round_trip():
    """to_packed_wide gives the words the tests' numpy recipe gives, with
    saturation at ±32767 and truncation toward zero; unpack_wide inverts
    it."""
    vals = np.array([0.0, 1.9, -1.9, 32767.4, 40000.0, -32768.0, -50000.0,
                     123.0], np.float32)
    wide = (vals + 1j * vals[::-1]).astype(np.complex64)
    packed = to_packed_wide(torch.from_numpy(wide))
    assert packed.dtype == torch.int32
    i = np.clip(np.trunc(vals), -32767, 32767).astype(np.int32)
    q = i[::-1]
    np.testing.assert_array_equal(packed.numpy(), (i & 0xFFFF) | (q << 16))
    back = tfused.unpack_wide(packed).numpy()
    np.testing.assert_array_equal(back, (i + 1j * q).astype(np.complex64))


@pytest.mark.parametrize("oversample,nframes", [(1, 3 * 128 + P + 5),
                                                (2, 2 * 128 + P + 4)])
def test_raw_plain_matches_jax_kernel(oversample, nframes):
    """The plain version of K7a / K7b against the JAX Pallas kernel
    (interpret mode): |Δ| <= 1 LSB, under 1 % of samples differ.  The
    port emits the plain bank's full length; the JAX kernel whole tiles."""
    rng = np.random.default_rng(42 + oversample)
    packed, wide_c = _random_capture(rng, nframes)
    want = np.asarray(jfused.channelize_raw_fused(
        jnp.asarray(packed), M, P, tile=128, oversample=oversample,
        interpret=True))
    got = tfused.channelize_raw_fused(torch.from_numpy(packed), M, P,
                                      oversample=oversample)
    assert got.dtype == torch.int16
    nout = nframes - P + 1 if oversample == 1 else 2 * (nframes - P)
    assert tuple(got.shape) == (M, 2 * nout)
    n = want.shape[1]
    assert 0 < n <= got.shape[1]
    d = np.abs(got.numpy()[:, :n].astype(np.int32) - want.astype(np.int32))
    assert d.max() <= 1
    assert (d > 0).mean() < 0.01
    # and the bank's own length: the JAX bank + trunc∘clip, whole output
    chans = jchan.channelize(jnp.asarray(wide_c), M, P, oversample=oversample)[0]
    ri = jnp.stack([chans.real, chans.imag], axis=-1).reshape(M, -1)
    ref = np.asarray(jnp.trunc(jnp.clip(ri, -32767.0, 32767.0)).astype(jnp.int16))
    assert ref.shape == tuple(got.shape)
    d = np.abs(got.numpy().astype(np.int32) - ref.astype(np.int32))
    assert d.max() <= 1
    assert (d > 0).mean() < 0.01


def test_raw_plain_saturates():
    """Full-scale input of one sign through taps of gain 4: the DC channel
    clips at ±32767 (not −32768, and no wrap)."""
    taps = 4.0 * tchan.prototype_lowpass(M, P)
    packed, _ = _random_capture(np.random.default_rng(0), 40, 32000, 32767)
    raw = tfused.channelize_raw_plain(torch.from_numpy(packed), M, P, taps)
    assert (raw[0, 0::2] == 32767).all()
    neg, _ = _random_capture(np.random.default_rng(0), 40, -32767, -32000)
    raw = tfused.channelize_raw_plain(torch.from_numpy(neg), M, P, taps)
    assert (raw[0, 0::2] == -32767).all()


def test_raw_recovers_a_tone():
    """A pure carrier in channel k lands in output row k."""
    k = 37
    raw = tfused.channelize_raw_fused(_tone_packed(k / M, 8000.0, 2 * 128 + P),
                                      M, P).numpy()
    iq = raw.astype(np.float32).reshape(M, -1, 2)
    power = (iq[..., 0] ** 2 + iq[..., 1] ** 2).mean(axis=1)
    assert power.argmax() == k
    # critically sampled bank: everything else ≥ 40 dB down
    assert np.delete(power, k).max() < power[k] * 1e-4


def test_raw_oversample2_edge_tone():
    """A tone halfway between channels k and k+1 survives in the 2x bank:
    both neighbours see it at ±fs_out/4."""
    k = 21
    raw = tfused.channelize_raw_fused(
        _tone_packed((k + 0.5) / M, 9000.0, 2 * 128 + P), M, P, oversample=2
    ).numpy()
    iq = raw.astype(np.float64).reshape(M, -1, 2)
    z = iq[..., 0] + 1j * iq[..., 1]
    power = (np.abs(z) ** 2).mean(axis=1)
    assert set(np.argsort(power)[-2:]) == {k, k + 1}
    for row, want in ((k, 0.25), (k + 1, -0.25)):
        zk = z[row][P:]  # skip filter warm-up
        freq = np.angle((zk[1:] * np.conj(zk[:-1])).mean()) / (2 * np.pi)
        assert abs(freq - want) < 0.01


@pytest.mark.parametrize("nchan", [16, 24, 96, 384, 512])
def test_fused_rejects_counts_outside_the_gate(nchan):
    assert not tfused.supports(nchan)
    with pytest.raises(ValueError, match="power of two"):
        tfused.channelize_raw_fused(torch.zeros(nchan * 100, dtype=torch.int32),
                                    nchan, P)


def test_fused_rejects_bad_input():
    with pytest.raises(ValueError, match="int32"):
        tfused.channelize_raw_fused(torch.zeros(M * 100, dtype=torch.int16), M)
    with pytest.raises(ValueError, match="too short"):
        tfused.channelize_raw_fused(torch.zeros(M * P, dtype=torch.int32), M, P,
                                    oversample=2)
    with pytest.raises(ValueError, match="oversample"):
        tfused.channelize_raw_fused(torch.zeros(M * 100, dtype=torch.int32), M,
                                    oversample=4)


@pytest.mark.parametrize("nchan", [32, 64, 128, 256])
@pytest.mark.parametrize("oversample", [1, 2])
def test_kernel_tile_fits_shared_memory(nchan, oversample):
    """The launch geometry the wrapper hands the kernel, checked where no
    card is needed: a power-of-two even tile whose shared memory fits."""
    assert tfused.supports(nchan)
    plan = tfused.pfb_plan(nchan, P, oversample, 1000)
    tile = plan["tile"]
    assert tile >= 32 and tile & (tile - 1) == 0
    assert plan["smem"] <= tfused._SMEM_MAX
    L = 1000
    want = L - P + 1 if oversample == 1 else 2 * (L - P)
    assert tfused._nsamp(L * nchan + 3, nchan, P, oversample) == want
    # half a frame or more behind the last whole one feeds the odd stream
    for extra in (nchan // 2, nchan // 2 + 1):
        words = torch.zeros(20 * nchan + extra, dtype=torch.int32)
        raw = tfused.channelize_raw_plain(words, nchan, P, oversample=oversample)
        assert raw.shape[1] == 2 * tfused._nsamp(words.shape[0], nchan, P,
                                                 oversample)
        assert raw.shape[1] == 2 * (13 if oversample == 1 else 26)


@pytest.mark.parametrize("oversample,channels", [(1, None), (2, "1,3")])
def test_channelize_cli_writes_the_jax_files(tmp_path, oversample, channels):
    """Same options, same files: int16 I,Q per channel within 1 LSB of the
    JAX CLI's (the gain drives some samples into the ±32768/32767 clip)."""
    rng = np.random.default_rng(5)
    nchan = 4
    raw = rng.integers(-30000, 30000, 2 * nchan * 300).astype("<i2")
    src = tmp_path / "wide.iq"
    raw.tofile(src)
    args = ["-M", str(nchan), "-r", "1000000", "-t", "6", "-O", str(oversample),
            "-g", "3.0"]
    if channels:
        args += ["-c", channels]
    assert jcli.main(args + ["-o", str(tmp_path / "j"), str(src)]) == 0
    assert tcli.main(args + ["-o", str(tmp_path / "t"), "--device", "cpu",
                             str(src)]) == 0
    names = sorted(p.name for p in (tmp_path / "j").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "t").iterdir())
    assert len(names) == (2 if channels else nchan)
    for name in names:
        a = np.fromfile(tmp_path / "j" / name, "<i2").astype(np.int32)
        b = np.fromfile(tmp_path / "t" / name, "<i2").astype(np.int32)
        assert a.shape == b.shape and a.size > 0
        assert np.abs(a - b).max() <= 1
        assert np.abs(a).max() >= 32767  # the clip is exercised
