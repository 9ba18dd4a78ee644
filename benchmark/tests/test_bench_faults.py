"""A whole run past the harness's look for a card: sound, it comes out
correct; with the timed path broken underneath, not.  On the CPU at two
channels of the clean cell, and on the card at the threshold cell's own
size for the fault its Viterbi lanes exist to catch."""

import json

import numpy as np
import pytest

import run
from isee3_decoder_tpu_torch.models import pipeline
from isee3_decoder_tpu_torch.ops import viterbi_fused
from yardstick.manifest import Manifest


def _alter_answer(monkeypatch):
    """A frame's bytes altered where the host tail produces them."""
    finish = pipeline._finish

    def broken(*a, **k):
        rec, ss = finish(*a, **k)
        rec.data[:, 3] ^= 0x10
        return rec, ss

    monkeypatch.setattr(pipeline, "_finish", broken)


def _drop_half(monkeypatch):
    """Half of the block's lanes left out of its record."""
    finish = pipeline._finish

    def broken(*a, **k):
        rec, ss = finish(*a, **k)
        half = rec.good.shape[0] // 2
        return rec._replace(**{f: getattr(rec, f)[:half] for f in rec._fields}), ss

    monkeypatch.setattr(pipeline, "_finish", broken)


def _shift_symbols(monkeypatch):
    """The symbol demod's output one symbol late."""
    scan = pipeline.symdemod_scan_csum

    def broken(*a, **k):
        first, out = scan(*a, **k)
        return first, out._replace(soft=out.soft.roll(1, dims=-1))

    monkeypatch.setattr(pipeline, "symdemod_scan_csum", broken)


def _nudge_symbols(monkeypatch):
    """Every tenth soft symbol one level up, as a coarser integrator
    would leave it: no frame changes at the clean cell's noise."""
    scan = pipeline.symdemod_scan_csum

    def broken(*a, **k):
        first, out = scan(*a, **k)
        soft = out.soft.clone()
        soft[..., ::10] = (soft[..., ::10].int() + 1).clamp(max=255).to(soft.dtype)
        return first, out._replace(soft=soft)

    monkeypatch.setattr(pipeline, "symdemod_scan_csum", broken)


def _delay_baseband(monkeypatch):
    """The front end's baseband one symbol (250 samples) late.  Faults
    that leave frames undecodable are not planted here: the program's
    plain Fano and Viterbi at K = 24 take hours on the CPU."""
    demod = pipeline.pm_demod_scan

    def broken(*a, **k):
        carry, out = demod(*a, **k)
        T, B, n = out.baseband.shape
        flat = out.baseband.transpose(0, 1).reshape(B, T * n).roll(250, dims=1)
        return carry, out._replace(baseband=flat.reshape(B, T, n).transpose(0, 1).contiguous())

    monkeypatch.setattr(pipeline, "pm_demod_scan", broken)


def _break_traceback(monkeypatch):
    """The Viterbi traceback's bits altered where it produces them: bit
    512 of every frame it decodes flipped."""
    chainback = viterbi_fused.chainback_planes

    def broken(*a, **k):
        bits = chainback(*a, **k).clone()
        bits[:, 512] ^= 1
        return bits

    monkeypatch.setattr(viterbi_fused, "chainback_planes", broken)


@pytest.fixture
def root(tiny_root):
    """Two channels of the clean 512 bps cell, every channel checked."""
    return tiny_root("isee3_512bps.tiny", "isee3_512bps.clean", channels=2,
                     pool_blocks=2, check_channels=2)


def _run(root):
    return run.run_cell(Manifest(root), "isee3_512bps.tiny", 2**31 + 11, 0.1, False,
                        device="cpu")


def test_a_sound_run_is_correct(root):
    r = _run(root)
    assert r["correct"] and r["failed"] == 0 and r["attempted"] >= 4
    assert list(r)[-1] == "checks"
    assert r["checks"]["lanes_differ_pct"] == {"value": 0.0, "limit": 0.0}
    assert r["checks"]["soft_differ_pct"]["value"] <= r["checks"]["soft_differ_pct"]["limit"]
    assert set(r["metrics"]) == {"realtime_channels", "setup_s"}
    assert np.isfinite(r["metrics"]["realtime_channels"]["value"])


@pytest.mark.parametrize("fault", [_alter_answer, _drop_half, _shift_symbols, _delay_baseband])
def test_a_broken_path_is_not_correct(root, monkeypatch, fault):
    fault(monkeypatch)
    r = _run(root)
    assert r["correct"] is False
    assert r["checks"]["lanes_differ_pct"]["value"] > 0


def test_soft_symbols_one_level_off_are_not_correct(root, monkeypatch):
    """Frames alone would pass this fault; the soft symbols catch it."""
    _nudge_symbols(monkeypatch)
    r = _run(root)
    assert r["checks"]["lanes_differ_pct"]["value"] == 0.0
    assert r["checks"]["soft_differ_pct"]["value"] > r["checks"]["soft_differ_pct"]["limit"]
    assert r["correct"] is False


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [2**31 + 505, 2**31 + 606, 2**31 + 707])
def test_a_broken_traceback_is_not_correct_at_the_threshold_cell(cuda, monkeypatch, seed):
    """At the threshold cell's own size and limits, a 10 s window."""
    _break_traceback(monkeypatch)
    r = run.run_cell(Manifest(), "isee3_512bps.threshold", seed, 10.0, False)
    print(json.dumps({"fault": "traceback", "seed": seed, "failed": r["failed"],
                      "attempted": r["attempted"], "checks": r["checks"]}))
    assert r["correct"] is False
    v = r["checks"]["viterbi_lanes_differ_pct"]
    assert v["value"] > v["limit"]
