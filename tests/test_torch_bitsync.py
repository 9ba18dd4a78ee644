"""bitsync on the stage tools' recording of chip_smoke.py phase 14, the
port against the JAX package on the CPU.

On the card ``bitsync -c 1024`` prints 3 frames of that recording, 2 of
them sent ones.  The same recording made on the CPU (the port's
synthesis: the same waveform, other noise samples), demodulated by the
port's ``pmdemod`` on its plain path, gives the same through both
packages' ``bitsync_frames``: the same decoded bits, frames 1 and 2
the sent ones, and frame 0 the sent frame 0 but for its first bits.
The recording starts with frame 0's first symbol, so the Viterbi
decoder, started in state 0 while the encoder sat in the sync state,
has no history for those bits: the frame the tool prints first is wrong
at its head in both packages alike, not by a fault of the port.
"""

from __future__ import annotations

import io
import sys
from unittest import mock

import numpy as np
import pytest
import torch

from isee3_decoder_tpu.models import legacy as jlegacy
from isee3_decoder_tpu_torch.cli import pmdemod as tpmdemod_cli
from isee3_decoder_tpu_torch.models import legacy as tlegacy
from isee3_decoder_tpu_torch.utils.devicesignal import (
    random_frames,
    synthesize_iq_device,
    to_raw_int16,
)


@pytest.mark.slow
def test_bitsync_first_frame_is_the_decoders_start(tmp_path):
    """8-18 minutes: two K = 24 Viterbi decodes of 4096 bits on the CPU."""
    frames = random_frames(np.random.default_rng(31), 5)
    gen = torch.Generator()
    gen.manual_seed(31)
    iq = synthesize_iq_device(torch.as_tensor(frames[None]),
                              torch.tensor([20_000.0]), gen, 2_500_000,
                              samprate=250_000.0, symrate=1024.0,
                              noise_std=2500.0)
    path = tmp_path / "input.iq"
    to_raw_int16(iq)[0].numpy().tofile(path)
    out = io.TextIOWrapper(io.BytesIO())
    with mock.patch.object(sys, "stdout", out):
        assert tpmdemod_cli.main(["-q", "-W", "100", "--device", "cpu",
                                  str(path)]) == 0
        out.flush()
    bb = np.frombuffer(out.buffer.getvalue(), "<i2")

    res_j = jlegacy.bitsync_frames(bb, 250_000.0, 1024.0)
    res_t = tlegacy.bitsync_frames(bb, 250_000.0, 1024.0, device="cpu")
    np.testing.assert_array_equal(np.asarray(res_t.bits),
                                  np.asarray(res_j.bits))
    got = [np.asarray(f, np.uint8) for f in res_t.frames]
    assert len(got) == len(res_j.frames) == 3
    for f, fj in zip(got, res_j.frames):
        np.testing.assert_array_equal(f, np.asarray(fj, np.uint8))
    np.testing.assert_array_equal(got[1], frames[1])
    np.testing.assert_array_equal(got[2], frames[2])
    assert np.asarray(res_t.bits).size == 3896
    wrong = np.nonzero(np.unpackbits(got[0] ^ frames[0]))[0]
    assert wrong.tolist() == [0, 1, 4, 8]
