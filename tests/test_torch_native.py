"""The port's native loader (isee3_decoder_tpu_torch/utils/native.py)
against the JAX package's, and its golden codecs against the port's
encoder and Viterbi decoder (the cross-implementation checks of
tests/test_native.py)."""

import os

import numpy as np
import pytest
import torch

from isee3_decoder_tpu.utils import native as jnative
from isee3_decoder_tpu_torch.config import CODES, MCQLI24, CodeSpec
from isee3_decoder_tpu_torch.ops import viterbi
from isee3_decoder_tpu_torch.ops.encode import bytes_to_bits, encode_bits
from isee3_decoder_tpu_torch.utils import native

K9F = CodeSpec("TESTK9F", 0o713, 0o715, 9, 0, 1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def lib():
    if not native.available():
        pytest.fail(f"the native library did not build: {native.build_error}")
    return native


@pytest.mark.parametrize("flip", [False, True])
def test_iq_deinterleave_matches_jax_loader(lib, flip):
    rng = np.random.default_rng(0)
    raw = rng.integers(-32768, 32767, 4096, dtype=np.int16)
    got = lib.iq_deinterleave(raw, flip=flip)
    np.testing.assert_array_equal(got, jnative.iq_deinterleave(raw, flip=flip))
    b = raw.astype(np.float32).reshape(-1, 2)
    i, q = (b[:, 1], b[:, 0]) if flip else (b[:, 0], b[:, 1])
    np.testing.assert_array_equal(got, (i + 1j * q).astype(np.complex64))


@pytest.mark.parametrize("name,state", [("TESTK9F", 0), ("MCQLI24", 0x819FBE),
                                        ("J60", (1 << 59) | 0x123456789)])
def test_conv_encode_matches_port_encoder(lib, name, state):
    """The golden encoder's symbols and final state == the port's
    encode_bits (J60: a 60-bit start state, POLY1 = 1)."""
    code = K9F if name == "TESTK9F" else CODES[name]
    rng = np.random.default_rng(1)
    data = rng.integers(0, 256, 64, dtype=np.uint8)
    got_syms, got_state = lib.conv_encode(data, code, state)
    want_syms, want_state = encode_bits(
        bytes_to_bits(torch.from_numpy(data)), state & ((1 << code.kbits) - 1),
        code)
    np.testing.assert_array_equal(got_syms, want_syms.numpy())
    assert got_state == int(want_state) & ((1 << code.k) - 1)


def test_viterbi_decode_frame_matches_port_decoder(lib):
    """K=9: the golden Viterbi == ops/viterbi.decode_frame on a noisy
    frame (tests/test_native.py:44-57)."""
    rng = np.random.default_rng(2)
    nbits = 96
    bits = rng.integers(0, 2, nbits, dtype=np.uint8)
    bits[-(K9F.k - 1):] = 0
    syms, _ = encode_bits(torch.from_numpy(bits), 0, K9F)
    noisy = np.clip(
        np.where(syms.numpy() > 0, 170, 86).astype(np.int32)
        + rng.integers(-70, 70, 2 * nbits), 0, 255).astype(np.uint8)
    got = lib.viterbi_decode_frame(noisy, nbits, 0, 0, K9F)
    want = viterbi.decode_frame(noisy, nbits, 0, 0, K9F, device="cpu")[0]
    np.testing.assert_array_equal(got, want.numpy())
    with pytest.raises(ValueError, match="symbols"):
        lib.viterbi_decode_frame(noisy[:-2], nbits, 0, 0, K9F)


def test_stream_reader_pipe(lib):
    """1 MiB through a pipe from a child process, read in 37,123-byte
    pieces through a 64 KiB ring (tests/test_native.py:60-81)."""
    rng = np.random.default_rng(3)
    payload = rng.integers(0, 256, 1 << 20, dtype=np.uint8).tobytes()
    r, w = os.pipe()
    pid = os.fork()
    if pid == 0:  # child: writer
        os.close(r)
        with os.fdopen(w, "wb") as f:
            f.write(payload)
        os._exit(0)
    os.close(w)
    got = b""
    with lib.StreamReader(r, capacity=1 << 16) as reader:
        while True:
            chunk = reader.read(37_123)
            got += chunk
            if len(chunk) < 37_123:
                break
    os.waitpid(pid, 0)
    os.close(r)
    assert got == payload


def test_build_goes_under_build_and_not_native(tmp_path):
    """The loader compiles native/isee3_io.cpp into the build directory it
    is given (build/native_io/ by default), under a name with the source
    hash, and writes nothing into native/."""
    native_dir = os.path.join(ROOT, "native")
    before = {f: os.stat(os.path.join(native_dir, f)).st_mtime_ns
              for f in os.listdir(native_dir)}
    path = native.build_library(tmp_path)
    assert path.parent == tmp_path and path.exists()
    assert path.name.startswith("libisee3_io_") and path.suffix == ".so"
    assert native.build_library(tmp_path) == path  # built once
    assert native.library_path().parent == native.BUILD_DIR
    assert native.BUILD_DIR == native._ROOT / "build" / "native_io"
    after = {f: os.stat(os.path.join(native_dir, f)).st_mtime_ns
             for f in os.listdir(native_dir)}
    assert after == before
    assert native.SOURCE.parent.name == "native"


def test_numpy_paths_without_the_library(monkeypatch):
    """Without the library, iq_deinterleave and StreamReader take their
    numpy paths and the golden codecs raise."""
    monkeypatch.setattr(native, "_load", lambda: None)
    raw = np.arange(-8, 8, dtype=np.int16)
    b = raw.astype(np.float32).reshape(-1, 2)
    np.testing.assert_array_equal(native.iq_deinterleave(raw),
                                  (b[:, 0] + 1j * b[:, 1]).astype(np.complex64))
    with pytest.raises(RuntimeError, match="unavailable"):
        native.conv_encode(np.zeros(2, np.uint8), K9F)
    with pytest.raises(RuntimeError, match="unavailable"):
        native.viterbi_decode_frame(np.zeros(16, np.uint8), 8, 0, 0, K9F)
    r, w = os.pipe()
    os.write(w, b"abcdef")
    os.close(w)
    with native.StreamReader(r) as reader:
        assert reader.read(4) == b"abcd" and reader.read(4) == b"ef"
    os.close(r)
