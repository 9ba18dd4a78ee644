"""The controls: the plain reference in the next precision below the
float32 the configurations state, in the program's place, have to come
out not correct — at a small size here and at every cell's own size on
the card."""

import json

import pytest
import torch

import reference.decode
from reference.chain import CONTROLS
from yardstick.control import control_verdict
from yardstick.manifest import Manifest

CELLS = [w["name"] for w in Manifest().data["workloads"]]


@pytest.fixture
def tiny(tiny_root, monkeypatch):
    """Two channels of the clean 512 bps cell.  The K = 24 Viterbi takes
    minutes a frame on the CPU, so it is stubbed here: a frame a control
    sends to Viterbi carries the Viterbi label whatever its bits, and
    the float32 chain decodes every frame by quicklook."""
    monkeypatch.setattr(reference.decode, "viterbi_frames",
                        lambda syms, *a: torch.zeros((syms.shape[0], 1024), dtype=torch.uint8))
    return Manifest(tiny_root("isee3_512bps.tiny", "isee3_512bps.clean", channels=2,
                              pool_blocks=1, check_channels=2))


def test_bf16_carrier_control_fails_the_frames_on_the_cpu(tiny):
    v = control_verdict(tiny, "isee3_512bps.tiny", 2**31 + 3, "cpu", "bf16_carrier")
    assert v["correct"] is False
    assert v["numbers"]["lanes_differ_pct"] > 3 * v["limits"]["lanes_differ_pct"]


def test_bf16_baseband_control_fails_the_soft_symbols_on_the_cpu(tiny):
    """The frames survive a bfloat16 baseband at the clean cell's noise;
    its soft symbols do not."""
    v = control_verdict(tiny, "isee3_512bps.tiny", 2**31 + 3, "cpu", "bf16_baseband")
    assert v["correct"] is False
    assert v["numbers"]["soft_differ_pct"] > 3 * v["limits"]["soft_differ_pct"]


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [2**31 + 101, 2**31 + 202, 2**31 + 303])
@pytest.mark.parametrize("control", sorted(CONTROLS))
@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct_at_the_cells_size(cuda, cell, control, seed):
    v = control_verdict(Manifest(), cell, seed, cuda, control)
    print(json.dumps({"control": control, "cell": cell, "seed": seed, **v}))
    assert v["correct"] is False
