"""Share of an untraced block's time with no device operation running:
one less the device's busy time a block (the union of the traced
window's device operations, over the device parts begun in it) over
the mean time between the unprofiled blocks' yields.  The profiler
about doubles a block's host time, so the traced window's own idle
share (``device.window_s`` against ``busy_s``) reads high."""

from yardstick.trace import DEVICE_PART


def read(s):
    busy_ms = s.per_call(s.busy_s * 1e3, DEVICE_PART)
    if busy_ms is None or not s.period_ms:
        return None
    return 100.0 * (1.0 - busy_ms / s.period_ms)
