"""Layer charging and the trace reduction on a synthetic trace, and the
spans the traced run puts around entry functions."""

import sys
import types

import pytest

from yardstick import trace


def _x(cat, name, ts, dur, tid=1, corr=None):
    ev = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid}
    if corr is not None:
        ev["args"] = {"correlation": corr}
    return ev


def _events():
    """Window [100, 200] µs.  Host thread 1: the device part of one
    block, layer:driver:receive_block_device_soft, over
    [105, 190], inside it layer:front_end:pm_demod_scan over [110, 130]
    and layer:symdemod:symdemod_scan_csum over [140, 150].  Launches:
    c1 at 112 (front end), c2 at 145 (symbol demod), c3 at 160 (driver
    only), c4 at 195 (no span), c5 at 50 (before the window).  Device:
    c1 [120, 140], c2 [150, 155] and a copy c3 [150, 170] overlapping
    it, c4 [196, 210] clipped at 200, c5 [60, 90] outside."""
    return [
        _x("user_annotation", trace.WINDOW_SPAN, 100, 100),
        _x("user_annotation", "layer:driver:receive_block_device_soft", 105, 85),
        _x("user_annotation", "layer:front_end:pm_demod_scan", 110, 20),
        _x("user_annotation", "layer:symdemod:symdemod_scan_csum", 140, 10),
        _x("cuda_runtime", "cudaLaunchKernel", 112, 1, corr=1),
        _x("cuda_runtime", "cudaLaunchKernel", 145, 1, corr=2),
        _x("cuda_runtime", "cudaMemcpyAsync", 160, 1, corr=3),
        _x("cuda_driver", "cuLaunchKernel", 195, 1, corr=4),
        _x("cuda_runtime", "cudaLaunchKernel", 50, 1, corr=5),
        _x("kernel", "k1", 120, 20, tid=7, corr=1),
        _x("kernel", "k2", 150, 5, tid=7, corr=2),
        _x("gpu_memcpy", "Memcpy DtoH", 150, 20, tid=8, corr=3),
        _x("kernel", "k4", 196, 14, tid=7, corr=4),
        _x("kernel", "k5", 60, 30, tid=7, corr=5),
        {"ph": "i", "cat": "kernel", "name": "instant", "ts": 150},
    ]


def test_layer_charging_and_window():
    s = trace.reduce_events(_events(), block_ms=[1.0], least_s={"front_end": 5e-6})
    assert s.window_s == pytest.approx(100e-6)
    assert s.layer_s == pytest.approx({"front_end": 20e-6, "symdemod": 5e-6, "driver": 20e-6})
    assert s.layer_kernels == {"front_end": 1, "symdemod": 1}
    assert s.kernels == 3  # k1, k2, k4: k5 lies outside, the copy is no kernel
    assert s.device_s == pytest.approx(49e-6)
    assert s.unattributed_s == pytest.approx(4e-6)  # k4 from 196 to the window's end
    # busy: [120, 140] + [150, 170] + [196, 200]
    assert s.busy_s == pytest.approx(44e-6)
    assert s.calls == {"receive_block_device_soft": 1, "pm_demod_scan": 1,
                       "symdemod_scan_csum": 1}
    assert s.per_block_ms("front_end") == pytest.approx(0.02)
    assert s.per_block_ms("host_tail") is None
    assert [op for op, _ in s.top_ops] == ["k1", "Memcpy DtoH", "k2", "k4"]
    # idle gaps: [100, 120] in the driver, [140, 150] in the symbol demod
    # (it opens at 140), [170, 196] in the driver, none at the edges after 200
    gaps = {name: sec for name, sec in s.idle_gaps}
    assert gaps["symdemod:symdemod_scan_csum"] == pytest.approx(10e-6)
    assert [g for g in s.idle_gaps][0] == ["driver:receive_block_device_soft", pytest.approx(26e-6)]
    assert sum(sec for _, sec in s.idle_gaps) == pytest.approx(56e-6)


def test_innermost_span_sweep():
    spans = [(0, 10, "a"), (2, 5, "b"), (3, 4, "c"), (6, 8, "d"), (12, 13, "e")]
    times = [1, 3.5, 4.5, 7, 9, 11, 12.5, 2]
    assert trace._innermost(spans, times) == ["a", "c", "b", "d", "a", None, "e", "b"]


def test_a_trace_without_the_window_is_refused():
    with pytest.raises(RuntimeError):
        trace.reduce_events(_events()[1:], [], {})


def test_spans_wrap_and_restore(monkeypatch):
    pkg = types.ModuleType("fakepkg")
    mod = types.ModuleType("fakepkg.mod")
    user = types.ModuleType("fakepkg.user")

    def f(x):
        return x + 1

    def g(n):
        yield from range(n)

    mod.f, mod.g = f, g
    user.f, user.g = f, g  # as "from fakepkg.mod import f, g" leaves them
    for name, m in (("fakepkg", pkg), ("fakepkg.mod", mod), ("fakepkg.user", user)):
        monkeypatch.setitem(sys.modules, name, m)
    layers = {"L": {"name": "l", "entries": ["fakepkg.mod:f", "fakepkg.mod:g"]}}
    with trace.spans_installed(layers, "fakepkg"):
        assert user.f is not f and mod.f is not f and user.f(1) == 2
        assert list(user.g(3)) == [0, 1, 2]
    assert user.f is f and mod.g is g
