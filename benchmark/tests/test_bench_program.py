"""The program's spans in the traced run (yardstick/program.py) on a
synthetic trace: idle charged to the innermost program span, self time,
blocking calls outside the read and upload spans, the counters' growth
over the window, and the layer reduction left as it was."""

import dataclasses
import sys
import types

import pytest

from test_bench_trace import _events, _x
from yardstick import program, trace

KEYS = ("driver", "front_end", "symdemod", "decode", "host_tail", "device")


def _program_events():
    """Window [100, 200] µs, thread 1.  Program spans: driver/submit
    [102, 170] holding front_end/pm_blocks [104, 130] (its lock check
    read [110, 118]), symdemod/windows [132, 160] (an edge upload [140,
    146], an op's upload, upload/encode/state, [150, 152]) and
    decode/tiers [161, 168]; the fetch's read [180, 190].  Device busy
    [105, 112], [120, 135], [147, 150], [153, 162], [185, 195]: 44 of
    100 µs.  Blocking calls: in the lock check (111), the edge upload
    (141), decode/tiers outside any wait (165), the fetch (181), before
    the window (50) and the harness's closing one (199)."""
    return [
        _x("user_annotation", trace.WINDOW_SPAN, 100, 100),
        _x("user_annotation", "layer:driver:receive_block_device_soft", 101, 70),
        _x("user_annotation", "driver/submit", 102, 68),
        _x("user_annotation", "front_end/pm_blocks", 104, 26),
        _x("user_annotation", "read/front_end/lock_check", 110, 8),
        _x("user_annotation", "symdemod/windows", 132, 28),
        _x("user_annotation", "upload/symdemod/trial_edges", 140, 6),
        _x("user_annotation", "upload/encode/state", 150, 2),
        _x("user_annotation", "decode/tiers", 161, 7),
        _x("user_annotation", "read/driver/fetch", 180, 10),
        _x("kernel", "k1", 105, 7, tid=7),
        _x("kernel", "k2", 120, 15, tid=7),
        _x("kernel", "k3", 147, 3, tid=7),
        _x("kernel", "k4", 153, 9, tid=7),
        _x("gpu_memcpy", "Memcpy DtoH", 185, 10, tid=8),
        _x("cuda_runtime", "cudaStreamSynchronize", 111, 5),
        _x("cuda_runtime", "cudaStreamSynchronize", 141, 4),
        _x("cuda_runtime", "cudaStreamSynchronize", 165, 1),
        _x("cuda_runtime", "cudaEventSynchronize", 181, 8),
        _x("cuda_runtime", "cudaDeviceSynchronize", 50, 1),
        _x("cuda_runtime", "cudaDeviceSynchronize", 199, 1),
    ]


def test_idle_goes_to_the_innermost_program_span():
    p = program.reduce_program(_program_events(), KEYS)
    # gaps: [100, 105) none, [112, 120) lock check, [135, 147) windows,
    # [150, 153) the op's upload, [162, 185) decode/tiers, [195, 200) none
    assert p.idle_s == pytest.approx({
        "none": 10e-6, "read/front_end/lock_check": 8e-6, "symdemod/windows": 12e-6,
        "upload/encode/state": 3e-6, "decode/tiers": 23e-6})
    # an op's site is charged to the layer of the span around it
    assert p.layer_idle_s == pytest.approx({
        "none": 10e-6, "front_end": 8e-6, "symdemod": 15e-6, "decode": 23e-6})


def test_idle_charged_adds_up_to_the_window_less_busy():
    events = _program_events()
    s = trace.reduce_events(events, [], {})
    p = program.reduce_program(events, KEYS)
    assert s.window_s - s.busy_s == pytest.approx(56e-6)
    assert sum(p.idle_s.values()) == pytest.approx(s.window_s - s.busy_s)
    assert sum(p.layer_idle_s.values()) == pytest.approx(p.idle_total_s)
    assert p.idle_total_s == pytest.approx(s.window_s - s.busy_s)


def test_self_time_subtracts_nested_spans():
    p = program.reduce_program(_program_events(), KEYS)
    assert p.self_s["driver/submit"] == pytest.approx(7e-6)  # 68 - 26 - 28 - 7
    assert p.self_s["front_end/pm_blocks"] == pytest.approx(18e-6)
    assert p.self_s["symdemod/windows"] == pytest.approx(20e-6)
    assert p.self_s["read/driver/fetch"] == pytest.approx(10e-6)
    assert p.spans["upload/symdemod/trial_edges"] == [1, pytest.approx(6e-6)]
    assert p.wait_s == pytest.approx({"read": 18e-6, "upload": 8e-6})


def test_a_blocking_call_outside_the_waits_is_counted():
    p = program.reduce_program(_program_events(), KEYS)
    # the one in decode/tiers; not those in waits, before the window, or
    # the harness's closing synchronize
    assert p.blocking_outside == {"decode/tiers": 1}
    line = program.describe(p, trace.reduce_events(_program_events(), [], {}))
    assert "upload spans 1 {'decode/tiers': 1}" in line


def test_program_spans_leave_the_layer_reduction_as_it_was():
    base = _events()
    extra = [ev for ev in _program_events()
             if ev["cat"] == "user_annotation" and "/" in ev["name"]]
    want = trace.reduce_events(base, [1.0], {"front_end": 5e-6})
    got = trace.reduce_events(base + extra, [1.0], {"front_end": 5e-6})
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_a_program_without_spans_reads_nothing():
    assert program.reduce_program(_events(), KEYS) is None
    t = program.Tracing(types.SimpleNamespace(HOST_READS={"x": 1}))  # no enable
    t.start()
    t.stop()
    assert t.counts is None


def test_tracing_takes_the_counters_growth_over_the_window():
    mod = types.SimpleNamespace(HOST_READS={"front_end/lock_check": 5}, HOST_UPLOADS={},
                                COUNTS={"driver/blocks": 1}, on=[])
    mod.enable = mod.on.append
    t = program.Tracing(mod)
    t.start()
    mod.HOST_READS["front_end/lock_check"] += 64
    mod.HOST_READS["driver/fetch"] = 2
    mod.COUNTS["driver/blocks"] += 2
    t.stop()
    assert mod.on == [True, False]
    assert t.counts == {"reads": {"front_end/lock_check": 64, "driver/fetch": 2},
                        "uploads": {}, "work": {"driver/blocks": 2}}
    p = program.reduce_program(_program_events(), KEYS, t.counts)
    assert p.counts is t.counts
    s = trace.reduce_events(_program_events(), [], {})  # one device part
    assert p.idle_ms(s, "symdemod") == pytest.approx(0.015)


def test_counter_readers(monkeypatch):
    from yardstick.manifest import Manifest

    m = Manifest()
    s = trace.reduce_events(_program_events(), [], {})
    name = program.PORT + ".utils.profiling"
    monkeypatch.setitem(sys.modules, name, types.SimpleNamespace(
        HOST_READS={"front_end/lock_check": 64, "decode/pre_ok": 2, "driver/fetch": 2},
        HOST_UPLOADS={"symdemod/trial_edges": 42},
        COUNTS={"driver/blocks": 2, "host_tail/calls": 2, "host_tail/viterbi_lanes": 18}))
    assert m.reader("host_reads_per_block")(s) == pytest.approx(34.0)
    assert m.reader("host_uploads_per_block")(s) == pytest.approx(21.0)
    assert m.reader("host_tail.viterbi_lanes")(s) == pytest.approx(9.0)
    # a program without the counters (the parent of the change) reads nothing
    monkeypatch.setitem(sys.modules, name, types.SimpleNamespace(cycle_histogram=None))
    for metric in ("host_reads_per_block", "host_uploads_per_block",
                   "host_tail.viterbi_lanes"):
        assert m.reader(metric)(s) is None
