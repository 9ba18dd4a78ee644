"""Time formatting helpers (timeformat.c:9-62 capability parity)."""

from __future__ import annotations


def hms(t: float) -> tuple[int, int, int, float]:
    """Split seconds into (days, hours, minutes, seconds) — timeformat.c:9-22."""
    days = int(t / 86400.0)
    t -= days * 86400
    hours = int(t / 3600.0)
    t -= hours * 3600
    minutes = int(t / 60.0)
    t -= minutes * 60
    return days, hours, minutes, t


def format_hms(t: float) -> str:
    """Pretty-print seconds as [d:]hh:mm:ss.sss — timeformat.c:26-62.

    Unlike the reference this is pure (no internal static buffer).
    """
    days, hours, minutes, seconds = hms(t)
    out = []
    if days > 0:
        out.append(f"{days}:")
    if days > 0 or hours > 0:
        out.append(f"{hours:02d}:")
    out.append(f"{minutes:02d}:")
    if seconds < 10.0:
        out.append("0")
    out.append(f"{seconds:.3f}")
    return "".join(out)
