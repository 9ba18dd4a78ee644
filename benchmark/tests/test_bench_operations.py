"""``attempted`` and ``failed`` count the pool's frames once each, so
two runs of one seed agree on them whatever their windows' lengths."""

import numpy as np
import pytest

import run
from yardstick import check
from yardstick.manifest import Manifest


def test_a_frame_failed_in_any_completion_of_its_block_fails_once():
    m = lambda *bits: np.array(bits, bool)  # noqa: E731
    ops = check.operations([(0, m(0, 1, 0, 0)), (1, m(0, 0, 0, 0)),
                            (0, m(0, 1, 1, 0)), (1, m(0, 0, 0, 0)),
                            (0, m(0, 1, 0, 0))])
    assert ops == {"attempted": 8, "failed": 2, "unsteady": 1}


def test_a_record_without_every_lane_fails_every_frame_of_its_block():
    frames = np.zeros((2, 4, 128), np.uint8)

    class Rec:
        good = np.ones(3, bool)

    assert check.failed_lanes(Rec, frames, 2, 0, True).tolist() == [True] * 4


@pytest.mark.parametrize("seconds", [0.1, 4.0])
def test_operations_do_not_depend_on_the_window(tiny_root, seconds):
    """The pool goes round once in the short window, more often in the
    long one: the same frames are attempted, every one of them good."""
    root = tiny_root("isee3_512bps.tiny", "isee3_512bps.clean", channels=2,
                     pool_blocks=2, check_channels=1)
    r = run.run_cell(Manifest(root), "isee3_512bps.tiny", 2**31 + 23, seconds, False,
                     device="cpu")
    assert (r["attempted"], r["failed"]) == (2 * 2 * 2, 0)
    assert r["correct"]
