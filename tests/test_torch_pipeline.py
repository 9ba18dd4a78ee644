"""PyTorch port vs the JAX package: the whole slice, ``receive_block``.

Raw int16 IQ in, decoded frames out, through all four kernels' plain
versions on the CPU (K1/K2 carrier, K3 prefix sum, K4 Fano walk).  Frame
bytes, good flags, decoder labels, start symbols and sync starts must be
exact.  The int16 baseband is within 1 LSB (f32 sums run in another
order); a 1-LSB step can move a soft symbol, so the number of differing
soft symbols is reported rather than required to be 0, and Fano cycles
are compared only in tests/test_torch_decode.py, which feeds both
decoders identical soft symbols.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isee3_decoder_tpu.models import pipeline as jpipe
from isee3_decoder_tpu.models.decode import DECODER_FANO, DecodeConfig
from isee3_decoder_tpu.ops.carrier import PMConfig
from isee3_decoder_tpu.ops.symbols import SymConfig
from isee3_decoder_tpu.utils import testsignal
from isee3_decoder_tpu_torch.models import pipeline as tpipe
from isee3_decoder_tpu_torch.utils import convert


def _iq(seed: int, noises, nframes_tx: int = 3) -> tuple[np.ndarray, np.ndarray]:
    rng = np.random.default_rng(seed)
    frames = testsignal.random_frames(rng, nframes_tx)
    iqs = [
        testsignal.iq_to_int16(testsignal.synthesize_iq(
            frames, samprate=32768.0, symrate=512.0, carrier=5000.0 + 1100.0 * i,
            noise_std=ns, lead_symbols=30, rng=rng,
        ))
        for i, ns in enumerate(noises)
    ]
    L = min(len(q) for q in iqs)
    return frames, np.stack([q[:L] for q in iqs])


def _compare(iq: np.ndarray, cfg, nframes: int = 1):
    rec_j, ss_j = jpipe.receive_block(iq, nframes, cfg)
    tcfg = convert.pipeline_config(cfg)
    rec_t, ss_t = tpipe.receive_block(torch.from_numpy(iq), nframes, tcfg,
                                      device="cpu")
    np.testing.assert_array_equal(ss_t, ss_j)
    for f in ("data", "good", "decoder", "start_symbol"):
        np.testing.assert_array_equal(getattr(rec_t, f), getattr(rec_j, f), f)

    soft_j, bb_j, _, _ = jpipe.demod_to_symbols(jnp.asarray(iq), cfg)
    soft_t, bb_t, _, _ = tpipe.demod_to_symbols(torch.from_numpy(iq), tcfg)
    diff = np.abs(bb_t.numpy().astype(np.int32) - np.asarray(bb_j, np.int32))
    assert diff.max() <= 1, diff.max()
    assert soft_t.shape == soft_j.shape
    nsoft = int((soft_t.numpy() != np.asarray(soft_j)).sum())
    print(f"baseband samples off by 1 LSB: {int((diff > 0).sum())}; "
          f"soft symbols that differ: {nsoft} of {soft_t.numel()}")
    return rec_t


def test_receive_block_matches_jax_unlocked_config():
    """The small config of tests/test_pipeline.py (no search window: every
    block is a full FFT search + K2).  Its frames carry error bursts, so
    lanes walk Fano; the cycle caps are lowered alike on both sides to
    keep the plain walk short."""
    cfg = jpipe.PipelineConfig(
        pm=PMConfig(samprate=32768.0, binsize=32.0),
        sym=SymConfig(samprate=32768.0, symrate=512.0, window=0.5),
        decode=DecodeConfig(viterbi_enabled=False, fano_tier1_maxcycles=1,
                            fano_maxcycles=3),
    )
    _, iq = _iq(9, [900.0, 900.0])
    rec = _compare(iq, cfg)
    assert (rec.decoder == DECODER_FANO).any()


def test_receive_block_matches_jax_locked_noisy():
    """Search window on (locked blocks run K1), one clean and three noisy
    channels: quicklook, QLEC and Fano-decoded lanes, every good frame a
    transmitted one."""
    cfg = jpipe.PipelineConfig(
        pm=PMConfig(samprate=32768.0, binsize=4.0, search_width=100.0),
        sym=SymConfig(samprate=32768.0, symrate=512.0, window=0.5),
        decode=DecodeConfig(viterbi_enabled=False),
    )
    frames, iq = _iq(11, [900.0, 30000.0, 40000.0, 50000.0])
    rec = _compare(iq, cfg)
    fano = rec.decoder == DECODER_FANO
    assert (fano & rec.good).any(), rec.decoder
    assert rec.good.all()
    for d in rec.data:
        assert any(np.array_equal(d, f) for f in frames)


@pytest.mark.parametrize("noise", [900.0])
def test_demod_complex_input_matches_jax(noise):
    """Complex IQ input takes the plain block step (no kernel); the soft
    symbols still agree with the JAX chain within the 1-LSB rule."""
    cfg = jpipe.PipelineConfig(
        pm=PMConfig(samprate=32768.0, binsize=4.0, search_width=100.0),
        sym=SymConfig(samprate=32768.0, symrate=512.0, window=0.5),
    )
    _, iq16 = _iq(12, [noise])
    iq = iq16.astype(np.float32).reshape(1, -1, 2)
    iq = (iq[..., 0] + 1j * iq[..., 1]).astype(np.complex64)
    soft_j, bb_j, f_j, _ = jpipe.demod_to_symbols(jnp.asarray(iq), cfg)
    soft_t, bb_t, f_t, _ = tpipe.demod_to_symbols(torch.from_numpy(iq),
                                                  convert.pipeline_config(cfg))
    np.testing.assert_allclose(f_t.numpy(), np.asarray(f_j), atol=5e-3)
    diff = np.abs(bb_t.numpy().astype(np.int32) - np.asarray(bb_j, np.int32))
    assert diff.max() <= 1
    assert soft_t.shape == soft_j.shape
