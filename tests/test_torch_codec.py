"""PyTorch port vs the JAX package: code tables, encoder, syncword,
metric tables and the tie rules of the index reductions.  All exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isee3_decoder_tpu import config as jcfg
from isee3_decoder_tpu.ops import encode as jenc
from isee3_decoder_tpu.ops import reductions as jred
from isee3_decoder_tpu.ops import syncword as jsync
from isee3_decoder_tpu.utils import metrics as jmet
from isee3_decoder_tpu.utils import timeformat as jtime
from isee3_decoder_tpu_torch import config as tcfg
from isee3_decoder_tpu_torch.ops import encode as tenc
from isee3_decoder_tpu_torch.ops import syncword as tsync
from isee3_decoder_tpu_torch.utils import metrics as tmet
from isee3_decoder_tpu_torch.utils import timeformat as ttime

K7 = tcfg.CodeSpec("TESTK7", 0o171, 0o133, 7, 0, 0)


CONSTANTS = ("FRAMEBITS", "FRAMESYMBOLS", "SYNCBITS", "SYNCWORD", "SYNC_STATE",
             "NOMINALCLOCK", "ACTUALCLOCK")
FIELDS = ("name", "poly1", "poly2", "k", "g1flip", "g2flip")


def test_config_is_the_jax_config_reexported():
    """The port keeps its own copy of the JAX package's config (it
    imports nothing of that package); the copy must equal it: every
    CodeSpec field of every catalogued code, the derived widths, the
    default code and the framing constants."""
    assert list(tcfg.CODES) == list(jcfg.CODES)
    for name, code in jcfg.CODES.items():
        mine = tcfg.CODES[name]
        for f in FIELDS:
            assert getattr(mine, f) == getattr(code, f), (name, f)
        for prop in ("nstates", "kbits", "state_mask", "encstate_mask"):
            assert getattr(mine, prop) == getattr(code, prop), (name, prop)
    for f in FIELDS:
        assert getattr(tcfg.DEFAULT_CODE, f) == getattr(jcfg.DEFAULT_CODE, f)
    for name in CONSTANTS:
        assert getattr(tcfg, name) == getattr(jcfg, name), name
    assert tcfg.CodeSpec is not jcfg.CodeSpec
    for x in (0, 1, 0o073665667, 2**70 + 5):
        assert tcfg.parity(x) == jcfg.parity(x)


@pytest.mark.parametrize("name", list(jcfg.CODES))
def test_sync_vector_copy_matches_jax(name):
    assert tcfg.sync_vector(tcfg.CODES[name]) == jcfg.sync_vector(jcfg.CODES[name])


@pytest.mark.parametrize(
    "args", [(100.0, 60.0, 0.5, 8.0), (81.65, 57.7, 0.0, 1.0), (1.0, 0.5, 0.5, 4.0)]
)
def test_gen_met_and_amplitudes_copy_exact(args):
    np.testing.assert_array_equal(tmet.gen_met(*args), jmet.gen_met(*args))
    assert tmet.decoder_amplitudes(100.0, 1.0) == jmet.decoder_amplitudes(100.0, 1.0)


@pytest.mark.parametrize("code", [jcfg.DEFAULT_CODE, K7], ids=["MCQLI24", "K7"])
def test_encode_bits_matches_jax(code):
    rng = np.random.default_rng(1)
    data = rng.integers(0, 256, (3, 16), dtype=np.uint8)
    tbits = tenc.bytes_to_bits(torch.from_numpy(data))
    jbits = jenc.bytes_to_bits(jnp.asarray(data))
    np.testing.assert_array_equal(tbits.numpy(), np.asarray(jbits))
    np.testing.assert_array_equal(tenc.bits_to_bytes(tbits).numpy(), data)
    start = jcfg.SYNC_STATE & ((1 << code.kbits) - 1)
    ts, tf = tenc.encode_bits(tbits, start, code)
    js, jf = jenc.encode_bits(jbits, start, code)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    # per-row tensor encoder states
    states = rng.integers(0, 1 << (code.kbits - 1), 3)
    ts, tf = tenc.encode_bits(tbits, torch.from_numpy(states), code)
    js, jf = jenc.encode_bits(jbits, jnp.asarray(states, jnp.int32), code)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))


def test_syncword_ops_match_jax():
    rng = np.random.default_rng(2)
    npos = 300
    soft = rng.integers(0, 256, (4, npos + jcfg.SYNCBITS), dtype=np.uint8)
    # plant the sync vector twice in row 1 (tie: the first must win) and
    # once in row 2
    sv = np.asarray(jcfg.sync_vector(), np.uint8) * 200 + 28
    soft[1, 40 : 40 + jcfg.SYNCBITS] = sv
    soft[1, 200 : 200 + jcfg.SYNCBITS] = sv
    soft[2, 123 : 123 + jcfg.SYNCBITS] = sv
    np.testing.assert_array_equal(tsync.sync_taps(), jsync.sync_taps())
    tc = tsync.sync_correlate(torch.from_numpy(soft), npos)
    jc = jsync.sync_correlate(jnp.asarray(soft), npos)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    tb, tv = tsync.find_sync(torch.from_numpy(soft), npos)
    jb, jv = jsync.find_sync(jnp.asarray(soft), npos)
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    assert int(tb[1]) == 40 and int(tb[2]) == 123

    bits = rng.integers(0, 2, (3, jcfg.FRAMEBITS), dtype=np.uint8)
    sw = [(jcfg.SYNCWORD >> (39 - i)) & 1 for i in range(40)]
    bits[0, -40:] = sw
    bits[2, -40:] = sw
    bits[2, -1] ^= 1
    np.testing.assert_array_equal(
        tsync.verify_frame(torch.from_numpy(bits)).numpy(),
        np.asarray(jsync.verify_frame(jnp.asarray(bits))),
    )


def test_argmax_tie_rules_match_jax():
    x = np.array([[1, 5, 5, 2, 5], [0, 0, 0, 0, 0], [3, 1, 2, 1, 0]], np.int32)
    np.testing.assert_array_equal(
        tsync.argmax_first(torch.from_numpy(x)).numpy(),
        np.asarray(jred.argmax_first(jnp.asarray(x))),
    )
    np.testing.assert_array_equal(
        tsync.argmax_last(torch.from_numpy(x)).numpy(),
        np.asarray(jred.argmax_last(jnp.asarray(x))),
    )


@pytest.mark.parametrize("t", [0.0, 3.25, 61.0009, 3599.9996, 86400.0 * 2 + 3725.5])
def test_timeformat_copy_matches_jax(t):
    assert ttime.hms(t) == jtime.hms(t)
    assert ttime.format_hms(t) == jtime.format_hms(t)
