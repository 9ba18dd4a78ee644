"""PyTorch port vs the JAX package: the block decoder, fed identical soft
symbols.  Sync start, frame bytes, good flags, decoder labels and Fano
cycles must all be exact — quicklook, QLEC, tier-1 Fano and the host
tier-2 re-run included."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isee3_decoder_tpu.models import decode as jd
from isee3_decoder_tpu.utils import testsignal
from isee3_decoder_tpu.utils.sim import simulate
from isee3_decoder_tpu_torch.models import decode as td
from isee3_decoder_tpu_torch.utils import convert

NFRAMES = 2


def _streams(seed: int, sigmas, offs):
    """Per-channel soft-symbol streams: NFRAMES+1 frames after a lead of
    erasures, symbol noise sigma per channel (amplitude 100)."""
    rng = np.random.default_rng(seed)
    frames = testsignal.random_frames(rng, NFRAMES + 1)
    syms = testsignal.frames_to_symbols(frames)
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


def _compare(soft, cfg):
    rec_j, ss_j = jd.decode_block(jnp.asarray(soft), NFRAMES, cfg)
    rec_t, ss_t = td.decode_block(torch.from_numpy(soft), NFRAMES,
                                  convert.decode_config(cfg))
    np.testing.assert_array_equal(ss_t, ss_j)
    for f in ("data", "good", "decoder", "start_symbol", "fano_cycles"):
        np.testing.assert_array_equal(getattr(rec_t, f), getattr(rec_j, f), f)
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


def test_viterbi_lane_raises_not_implemented():
    """A lane that needs the Viterbi fallback is refused, never decoded
    by something else."""
    _, soft = _streams(5, [90.0], [9])
    cfg = td.DecodeConfig(fano_tier1_maxcycles=1, fano_maxcycles=2)
    with pytest.raises(NotImplementedError, match="Viterbi"):
        td.decode_block(torch.from_numpy(soft), NFRAMES, cfg)
    rec, _ = td.decode_block(torch.from_numpy(soft), NFRAMES,
                             td.DecodeConfig(viterbi_enabled=False,
                                             fano_tier1_maxcycles=1,
                                             fano_maxcycles=2))
    assert not rec.good.all()
