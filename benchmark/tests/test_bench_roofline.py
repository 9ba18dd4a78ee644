"""The roofline arithmetic and the readers that use it."""

import pytest

from yardstick import roofline
from yardstick.manifest import Manifest
from yardstick.trace import Summary


def test_bound_picks_the_larger_term():
    t, by = roofline.bound_s(3.35e12, 67e12)
    assert (t, by) == (pytest.approx(1.0), "bytes")
    t, by = roofline.bound_s(3.35e9, 134e12)
    assert (t, by) == (pytest.approx(2.0), "operations")


def test_dft_ops_takes_the_cheaper_form():
    assert roofline.dft_ops(65536, 107) == 5.0 * 65536 * 16  # the FFT
    assert roofline.dft_ops(4096, 3) == 8.0 * 4096 * 3  # the direct sum


def test_front_end_least_time_of_the_512_bps_block():
    cfg = Manifest().config("isee3_512bps")
    n, T, B = 65536, 32, 128
    assert roofline.window_bins(cfg, n) == 107
    t, by = roofline.front_end_least_s(cfg, B, T, n)
    nbytes = B * (T * n * 4 + (T * n + 1) * 4)
    assert by == "bytes" and t == pytest.approx(nbytes / 3.35e12)
    assert t * 1e3 == pytest.approx(0.6410, abs=1e-4)


def _summary(**kw):
    base = dict(calls={"receive_block_device_soft": 2, "_finish": 4}, window_s=1.0, busy_s=0.25, device_s=0.3,
                unattributed_s=0.0, layer_s={"front_end": 0.004}, layer_kernels={},
                kernels=10, top_ops=[], idle_gaps=[], block_ms=[], least_s={"front_end": 0.0005})
    base.update(kw)
    return Summary(**base)


def test_readers():
    m = Manifest()
    s = _summary()
    assert m.reader("front_end.device_ms")(s) == pytest.approx(2.0)
    assert m.reader("front_end_roofline")(s) == pytest.approx(25.0)
    # busy 0.25 s over 2 device parts against a block every 500 ms
    assert m.reader("device_idle_pct")(_summary(period_ms=500.0)) == pytest.approx(75.0)
    assert m.reader("device_idle_pct")(s) is None
    assert m.reader("kernels_per_block")(s) == pytest.approx(5.0)
    tail = _summary(layer_kernels={"host_tail": 8}, layer_s={"host_tail": 0.04})
    assert m.reader("kernels_per_block")(tail) == pytest.approx(1.0 + 2.0)
    assert m.reader("host_tail.kernels")(tail) == pytest.approx(2.0)
    assert m.reader("host_tail.device_ms")(tail) == pytest.approx(10.0)
    # a layer with nothing to read gives nothing, never 0
    assert m.reader("host_tail.device_ms")(s) is None
    assert m.reader("host_tail.kernels")(s) is None
    assert m.reader("front_end_roofline")(_summary(layer_s={})) is None
    assert m.reader("block_ms_p95")(s) is None
    assert m.reader("block_ms_p95")(_summary(block_ms=list(range(101)))) == pytest.approx(95.0)
