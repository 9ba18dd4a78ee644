"""The port's spans and counters (utils/profiling): which spans a CPU
torch.profiler run of the pipelined chain holds with the chain's tracing
off and on, where the reads sit, and what the counters count."""

import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from isee3_decoder_tpu_torch.config import CodeSpec
from isee3_decoder_tpu_torch.models import decode as td
from isee3_decoder_tpu_torch.models import pipeline as tpipe
from isee3_decoder_tpu_torch.models.decode import DecodeConfig
from isee3_decoder_tpu_torch.ops.carrier import PMConfig
from isee3_decoder_tpu_torch.ops.symbols import SymConfig
from isee3_decoder_tpu_torch.utils import profiling, sim, testsignal

LAYERS = ("driver/", "front_end/", "symdemod/", "decode/", "host_tail/")
PROGRAM = LAYERS + ("read/", "upload/")
CFG = tpipe.PipelineConfig(
    pm=PMConfig(samprate=32768.0, binsize=2.0, search_width=100.0),
    sym=SymConfig(samprate=32768.0, symrate=512.0, window=0.5),
    # the plain Fano walk adds hundreds of thousands of profiled ops
    decode=DecodeConfig(fano_enabled=False, viterbi_enabled=False),
)
K15 = CodeSpec("TESTK15", 0o46321, 0o51445, 15, 0, 1)


@pytest.fixture(scope="module")
def blocks():
    """Two blocks of two channels of 32,768 sps int16 IQ."""
    rng = np.random.default_rng(21)
    frames = testsignal.random_frames(rng, 3)
    out = []
    for b in range(2):
        iqs = [testsignal.iq_to_int16(testsignal.synthesize_iq(
            frames, samprate=32768.0, symrate=512.0,
            carrier=5000.0 + 1100.0 * c, noise_std=900.0,
            lead_symbols=30 + 7 * b, rng=rng)) for c in range(2)]
        L = min(len(q) for q in iqs)
        out.append(np.stack([q[:L] for q in iqs]))
    return out


def _traced(blocks, on: bool, tmp_path):
    """(the Chrome trace's program spans as (start, end, name) µs,
    HOST_READS) of a CPU profiler over receive_blocks_pipelined of
    ``blocks`` with the chain's tracing ``on``."""
    profiling.reset()
    profiling.enable(on)
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            got = list(tpipe.receive_blocks_pipelined(iter(blocks), 1, CFG,
                                                      device="cpu"))
    finally:
        profiling.enable(False)
    assert len(got) == len(blocks)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    spans = [(e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
             if e.get("ph") == "X" and e["name"].startswith(PROGRAM)]
    return spans, dict(profiling.HOST_READS)


def _pm_blocks(block) -> int:
    return block.shape[1] // 2 // CFG.pm.fftsize


def test_no_program_span_with_tracing_off(blocks, tmp_path):
    spans, reads = _traced(blocks, False, tmp_path)
    assert spans == []
    # the counters count all the same
    assert reads["front_end/lock_check"] == sum(_pm_blocks(b) for b in blocks)
    assert reads["driver/fetch"] == reads["decode/frame_bound"] == len(blocks)


def test_spans_and_reads_with_tracing_on(blocks, tmp_path):
    spans, reads = _traced(blocks, True, tmp_path)
    names = {n for _, _, n in spans}
    assert {"driver/submit", "front_end/pm_blocks", "symdemod/windows",
            "decode/tiers"} <= names
    assert sum(n == "driver/submit" for _, _, n in spans) == len(blocks)
    assert reads["front_end/lock_check"] == sum(_pm_blocks(b) for b in blocks)
    enclosing = {"front_end": "front_end/pm_blocks", "decode": "decode/tiers",
                 "symdemod": "symdemod/windows"}

    def inside(s, outer_name):
        return any(o[0] <= s[0] and s[1] <= o[1]
                   for o in spans if o[2] == outer_name)

    waits = [s for s in spans if s[2].startswith(("read/", "upload/"))]
    assert {s[2] for s in waits} >= {
        "read/front_end/lock_check", "read/decode/frame_bound", "read/driver/fetch",
        "upload/symdemod/trial_edges", "upload/symdemod/search_edges"}
    for s in waits:
        kind, layer, site = s[2].split("/")
        if kind == "read" and layer in enclosing:
            assert inside(s, enclosing[layer]), s
        if site.endswith("_edges"):  # the window loop's uploads
            assert inside(s, "symdemod/windows"), s
        # the fetch waits outside the submission: no span across a yield
        if s[2] == "read/driver/fetch":
            assert not inside(s, "driver/submit"), s


def test_lane_counters_match_the_labels():
    """Two channels at σ=45 and σ=95 (K=15, tier-1 cap 1, tier 2 at 2
    cycles a bit): the lanes sent to tier 2 are those it labels FANO
    (past the tier-1 cap of 1024 cycles) and those labelled VITERBI
    after it; the Viterbi lanes are those labelled VITERBI."""
    rng = np.random.default_rng(5)
    frames = testsignal.random_frames(rng, 3)
    tx = torch.from_numpy(testsignal.frames_to_symbols(frames, K15))
    gen = torch.Generator().manual_seed(5)
    L = len(tx) + 9
    soft = torch.stack([
        torch.nn.functional.pad(sim.simulate(gen, tx, 100.0, sigma),
                                (off, L - off - len(tx)), value=128)
        for sigma, off in ((45.0, 3), (95.0, 9))])
    cfg = DecodeConfig(code=K15, fano_tier1_maxcycles=1, fano_maxcycles=2)
    profiling.reset()
    rec, _ = td.decode_block(soft, 2, cfg, device="cpu")
    vit = int((rec.decoder == td.DECODER_VITERBI).sum())
    tier2_fano = int(((rec.decoder == td.DECODER_FANO) & (rec.fano_cycles > 1024)).sum())
    assert vit and tier2_fano
    assert profiling.COUNTS["host_tail/viterbi_lanes"] == vit
    assert profiling.COUNTS["host_tail/tier2_lanes"] == vit + tier2_fano
    assert profiling.COUNTS["host_tail/calls"] == 1
    assert profiling.HOST_READS["host_tail/fano_tier2"] == 4
    assert profiling.HOST_READS["host_tail/viterbi"] == 2


def test_span_is_shared_and_free_when_off():
    profiling.enable(False)
    assert not profiling.enabled()
    assert profiling.span("a") is profiling.span("b", 3)
    profiling.enable(True)
    try:
        assert profiling.enabled()
        assert isinstance(profiling.span("a", 3), torch.profiler.record_function)
    finally:
        profiling.enable(False)


def test_read_and_upload_return_what_they_fetch():
    profiling.reset()
    assert profiling.read("t/flag", torch.tensor([True, False]).any()) is True
    np.testing.assert_array_equal(profiling.read("t/arr", torch.arange(3)), [0, 1, 2])
    x = profiling.upload("t/up", np.arange(4), torch.device("cpu"), torch.int32)
    assert x.dtype == torch.int32 and x.tolist() == [0, 1, 2, 3]
    assert profiling.upload("t/up", x, "cpu") is x  # a tensor is no upload
    assert profiling.HOST_READS == {"t/flag": 1, "t/arr": 1}
    assert profiling.HOST_UPLOADS == {"t/up": 1}
    profiling.reset()
    assert not (profiling.HOST_READS or profiling.HOST_UPLOADS or profiling.COUNTS)
