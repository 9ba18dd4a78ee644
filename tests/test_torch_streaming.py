"""PyTorch port: the streaming receive chain ``receive_stream`` and its
carry, against the JAX package on the CPU.

Counterparts of tests/test_streaming_carry.py (chunked calls give one
call's frames and soft symbols; the carry checkpoints) and of
tests/test_soak.py, plus a chunk-by-chunk comparison with the JAX
``receive_stream``: records and every carry field after each chunk, a
chunk shorter than one pm block among them.  The port's plain versions
of K1/K2 (carrier), K3 (prefix sum) and K4 (Fano walk) run here.

The plain Fano walk is a Python loop: a frame that fails quicklook walks
its whole budget, minutes at the default 100 cycles a bit.  So the
decode configurations here lower the cycle caps (alike on both sides);
what the stream carries does not depend on them.
"""

from __future__ import annotations

import os
import resource

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isee3_decoder_tpu.models import pipeline as jpipe
from isee3_decoder_tpu.models.decode import DecodeConfig
from isee3_decoder_tpu.ops.carrier import PMConfig
from isee3_decoder_tpu.ops.symbols import SymConfig
from isee3_decoder_tpu.utils import testsignal
from isee3_decoder_tpu_torch.models import pipeline as tpipe
from isee3_decoder_tpu_torch.models.decode import decode_stream
from isee3_decoder_tpu_torch.ops.symbols import SymConfig
from isee3_decoder_tpu_torch.utils import checkpoint, convert

LOW_CAPS = DecodeConfig(fano_tier1_maxcycles=1, fano_maxcycles=3)
# the configuration of tests/test_streaming_carry.py (fftsize 1024, every
# block a full FFT search and K2)
JCFG = jpipe.PipelineConfig(
    pm=PMConfig(samprate=32768.0, binsize=32.0),
    sym=SymConfig(samprate=32768.0, symrate=512.0, window=0.5),
    decode=LOW_CAPS,
)
# the same with a search window: locked blocks take K1's path
JCFG_LOCKED = jpipe.PipelineConfig(
    pm=PMConfig(samprate=32768.0, binsize=32.0, search_width=100.0),
    sym=JCFG.sym,
    decode=LOW_CAPS,
)
CFG = convert.pipeline_config(JCFG)


def _recording(nframes: int, seed: int = 3) -> np.ndarray:
    rng = np.random.default_rng(seed)
    frames = testsignal.random_frames(rng, nframes)
    iq = testsignal.synthesize_iq(
        frames, samprate=32768.0, symrate=512.0, carrier=5000.0,
        noise_std=600.0, lead_symbols=50, rng=rng,
    )
    return testsignal.iq_to_int16(iq)


def _flatten(records):
    return [
        (int(r.start_symbol[b]), bool(r.good[b]), int(r.decoder[b]),
         bytes(r.data[b]))
        for r in records
        for b in range(r.data.shape[0])
    ]


def _run(raw: np.ndarray, cuts, cfg=CFG, carry=None, trim=True):
    """receive_stream over raw[lo:hi] for consecutive cuts → (flat
    records, carry)."""
    carry = carry or tpipe.init_chain_carry(1, cfg, device="cpu")
    flat = []
    for lo, hi in zip(cuts[:-1], cuts[1:]):
        recs, carry = tpipe.receive_stream(torch.from_numpy(raw[None, lo:hi]),
                                           cfg, carry, trim=trim)
        flat.extend(_flatten(recs))
    return flat, carry


def _cuts(raw: np.ndarray) -> list[int]:
    # ragged: a chunk shorter than one pm block (2048 values) first
    return [0, 1536, 1536 + 2 * 32768, 1536 + 2 * 32768 + 99000, len(raw)]


@pytest.mark.slow
def test_chunked_stream_equals_one_call():
    raw = _recording(5)
    soft1 = tpipe.demod_to_symbols(torch.from_numpy(raw[None, :]), CFG)[0]
    recs1, _ = decode_stream(soft1, CFG.decode, device="cpu")
    flat1 = _flatten(recs1)
    assert len(flat1) >= 3
    flat2, _ = _run(raw, _cuts(raw))
    assert flat2 == flat1


def test_stream_soft_symbols_bit_exact():
    """The demod path alone: chunked soft symbols == one-shot bytes."""
    raw = _recording(3, seed=4)
    soft1 = tpipe.demod_to_symbols(torch.from_numpy(raw[None, :]), CFG)[0]
    cuts = list(range(0, len(raw), 81920)) + [len(raw)]
    _, carry = _run(raw, cuts, trim=False)
    got = carry.soft.numpy()
    assert carry.soft_base == 0
    n = min(got.shape[1], soft1.shape[1])
    assert n >= soft1.shape[1] - CFG.sym.nsymbols  # at most one pending window
    np.testing.assert_array_equal(got[:, :n], soft1.numpy()[:, :n])


def test_carry_is_a_checkpointable_pytree(tmp_path):
    """The carry goes through save_pytree / restore_pytree (onto a fresh
    template of the file's shapes) and the restored carry finishes the
    stream as the live one does."""
    raw = _recording(2, seed=5)
    half = len(raw) // 2
    _, carry = _run(raw, [0, half])
    assert all(isinstance(t, torch.Tensor) and t.device.type == "cpu"
               for t in (carry.iq_rem, carry.bb, carry.first, carry.soft,
                         *carry.pm))
    path = tmp_path / "carry.npz"
    checkpoint.save_pytree(path, carry)
    manifest = checkpoint.load_manifest(path)
    paths = [m["path"] for m in manifest["leaves"]]
    assert paths[:3] == [".pm.search_center", ".pm.cn0", ".iq_rem"]
    assert paths[-4:] == [".dec.batch", ".dec.lock", ".dec.pos",
                          ".dec.sync_start"]
    template = tpipe.chain_carry_template(manifest, CFG, device="cpu")
    restored = checkpoint.restore_pytree(path, template)

    recs_a, carry_a = tpipe.receive_stream(torch.from_numpy(raw[None, half:]),
                                           CFG, carry)
    recs_b, carry_b = tpipe.receive_stream(torch.from_numpy(raw[None, half:]),
                                           CFG, restored)
    assert _flatten(recs_a) == _flatten(recs_b)
    for f in ("iq_rem", "bb", "first", "soft"):
        assert torch.equal(getattr(carry_a, f), getattr(carry_b, f)), f
    for f in ("bb_base", "bb_total", "windows_done", "soft_base"):
        assert getattr(carry_a, f) == getattr(carry_b, f), f
    np.testing.assert_array_equal(carry_a.dec.pos, carry_b.dec.pos)
    np.testing.assert_array_equal(carry_a.dec.lock, carry_b.dec.lock)


def _assert_carry_matches_jax(ct, cj, where: str):
    np.testing.assert_array_equal(ct.iq_rem.numpy(), cj.iq_rem, where)
    for f in ("bb_base", "bb_total", "windows_done", "soft_base"):
        assert getattr(ct, f) == getattr(cj, f), (where, f)
    # the baseband within the 1-LSB rule of the pm stage
    assert ct.bb.shape == cj.bb.shape, where
    if cj.bb.size:
        diff = np.abs(ct.bb.numpy().astype(np.int32) - cj.bb.astype(np.int32))
        assert diff.max() <= 1, (where, diff.max())
    np.testing.assert_array_equal(ct.first.numpy(), cj.first, where)
    np.testing.assert_array_equal(ct.soft.numpy(), cj.soft, where)
    for f in ("lock", "pos", "sync_start"):
        np.testing.assert_array_equal(getattr(ct.dec, f), getattr(cj.dec, f),
                                      (where, f))
    assert ct.dec.batch == cj.dec.batch
    np.testing.assert_allclose(ct.pm.search_center.numpy(),
                               np.asarray(cj.pm.search_center), atol=5e-3)
    # C/N0 in dB from float32 moments summed in another order
    np.testing.assert_allclose(ct.pm.cn0.numpy(), np.asarray(cj.pm.cn0),
                               atol=1e-2)


@pytest.mark.parametrize("locked", [False, True], ids=["unlocked", "locked"])
def test_receive_stream_matches_jax_chunk_by_chunk(locked):
    """Port and JAX receive_stream on the same chunks: the same records
    and carry after every chunk (the baseband within 1 LSB, soft symbols,
    timing and decode state exact)."""
    jcfg = JCFG_LOCKED if locked else JCFG
    tcfg = convert.pipeline_config(jcfg)
    raw = _recording(4, seed=6)
    cuts = [0, 1536, 1536 + 2 * 32768, 1536 + 2 * 32768 + 99000,
            1536 + 2 * 32768 + 99000 + 1000, len(raw)]
    cj = jpipe.init_chain_carry(1, jcfg)
    ct = tpipe.init_chain_carry(1, tcfg, device="cpu")
    nrec = 0
    for lo, hi in zip(cuts[:-1], cuts[1:]):
        rj, cj = jpipe.receive_stream(raw[None, lo:hi], jcfg, cj)
        rt, ct = tpipe.receive_stream(torch.from_numpy(raw[None, lo:hi]), tcfg,
                                      ct)
        assert _flatten(rt) == _flatten(rj), (lo, hi)
        _assert_carry_matches_jax(ct, cj, f"chunk {lo}:{hi}")
        nrec += len(rt)
    assert nrec >= 2


def test_receive_stream_complex_chunks_match_jax():
    """Complex IQ chunks (the plain pm block step): the same records and
    soft symbols as the JAX stream, and as the port's raw-int16 stream
    within the soft symbols the 1-LSB rule lets differ."""
    raw = _recording(2, seed=7)
    iq = raw.astype(np.float32).reshape(-1, 2)
    iq = (iq[:, 0] + 1j * iq[:, 1]).astype(np.complex64)
    cuts = [0, 700, 700 + 40000, len(iq)]
    cj = jpipe.init_chain_carry(1, JCFG_LOCKED)
    tcfg = convert.pipeline_config(JCFG_LOCKED)
    ct = tpipe.init_chain_carry(1, tcfg, device="cpu")
    for lo, hi in zip(cuts[:-1], cuts[1:]):
        rj, cj = jpipe.receive_stream(iq[None, lo:hi], JCFG_LOCKED, cj,
                                      trim=False)
        rt, ct = tpipe.receive_stream(torch.from_numpy(iq[None, lo:hi]), tcfg,
                                      ct, trim=False)
        assert _flatten(rt) == _flatten(rj)
        assert ct.iq_rem.dtype == torch.complex64
        assert ct.soft.shape == cj.soft.shape
    assert ct.soft.shape[1] > 0
    np.testing.assert_array_equal(ct.soft.numpy(), cj.soft)


def test_receive_stream_refuses_a_missing_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tpipe.receive_stream(np.zeros((1, 4096), np.int16), CFG)


def _rss_mb() -> float:
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024.0


@pytest.mark.slow
def test_receive_stream_soak_30min(tmp_path):
    """tests/test_soak.py for the port: 31 minutes of 250 ksps signal in
    30-second chunks — bounded host memory, no carrier or timing drift
    over ~6,900 pm blocks, a mid-soak checkpoint (save_pytree /
    restore_pytree) that replays its chunk bit for bit, every frame after
    acquisition recovered.  ~10 GB of host memory for the synthesis, and
    the first frame walks the plain Fano loop (~90 s)."""
    minutes = float(os.environ.get("SOAK_MINUTES", "31"))
    samprate, symrate = 250_000.0, 1024.0
    rng = np.random.default_rng(5)
    frames = testsignal.random_frames(rng, 16)
    total_frames = int(minutes * 60 * symrate / 2048) + 2
    tx = np.tile(frames, (total_frames // 16 + 1, 1))
    iq = testsignal.synthesize_iq(
        tx, samprate=samprate, symrate=symrate, carrier=20_000.0,
        noise_std=1500.0, lead_symbols=60, rng=rng,
    )
    raw = testsignal.iq_to_int16(iq[: int(minutes * 60 * samprate)])
    del iq

    # decoded at the sent symbol rate (the tools' -c 1024.): tests/
    # test_soak.py's PipelineConfig() decodes at the measured clock,
    # 1024.545 Hz, where the timing drifts ~133 samples a 1-second window
    # and every frame fails, in the JAX package as here
    cfg = tpipe.PipelineConfig(sym=SymConfig(symrate=symrate))
    carry = tpipe.init_chain_carry(1, cfg, device="cpu")
    chunk_vals = int(30.0 * samprate) * 2
    nchunks = len(raw) // chunk_vals
    assert nchunks >= 60, "soak shorter than intended"
    got, rss = [], []
    for c in range(nchunks):
        part = torch.from_numpy(raw[None, c * chunk_vals: (c + 1) * chunk_vals])
        if c == nchunks // 2:
            path = tmp_path / "soak.npz"
            checkpoint.save_pytree(path, carry)
            saved = checkpoint.restore_pytree(path, tpipe.chain_carry_template(
                checkpoint.load_manifest(path), cfg, device="cpu"))
            recs_a, carry_a = tpipe.receive_stream(part, cfg, carry)
            recs_b, carry_b = tpipe.receive_stream(part, cfg, saved)
            assert _flatten(recs_a) == _flatten(recs_b)
            pa = tmp_path / "a.npz"
            pb = tmp_path / "b.npz"
            checkpoint.save_pytree(pa, carry_a)
            checkpoint.save_pytree(pb, carry_b)
            with np.load(pa) as a, np.load(pb) as b:
                for k in a.files:
                    np.testing.assert_array_equal(a[k], b[k])
            recs, carry = recs_a, carry_a
        else:
            recs, carry = tpipe.receive_stream(part, cfg, carry)
        got.extend(recs)
        rss.append(_rss_mb())

    ngood = sum(int(r.good[0]) for r in got)
    # whole frames in the recording (total_frames is what was synthesized,
    # two more than it holds); the first is lost to acquisition and the
    # last window waits for more signal
    assert len(got) >= int(minutes * 60 * symrate / 2048) - 4
    assert ngood >= len(got) - 2, f"lost lock mid-soak: {ngood}/{len(got)}"
    tx_set = {f.tobytes() for f in frames}
    for r in got[1:]:
        if r.good[0]:
            assert r.data[0].tobytes() in tx_set
    assert got[-1].good[0] and got[-2].good[0]
    assert rss[-1] <= rss[len(rss) // 3] * 1.2 + 256.0, (
        f"RSS grew through the soak: {rss[len(rss) // 3]:.0f} -> "
        f"{rss[-1]:.0f} MB")


def test_receive_block_device_is_the_buffer_of_the_soft_form():
    """receive_block_device: the packed buffer of receive_block_device_soft
    and of the JAX package's receive_block_device on the same IQ."""
    raw = _recording(2, seed=8)
    tcfg = convert.pipeline_config(JCFG_LOCKED)
    iq = torch.from_numpy(raw[None, :])
    buf = tpipe.receive_block_device(iq, 1, 32, tcfg)
    buf2, _ = tpipe.receive_block_device_soft(iq, 1, 32, tcfg)
    assert torch.equal(buf, buf2)
    want = np.asarray(jpipe.receive_block_device(jnp.asarray(raw[None, :]), 1,
                                                 32, JCFG_LOCKED))
    np.testing.assert_array_equal(buf.numpy(), want)
