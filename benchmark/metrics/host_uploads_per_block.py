"""Copies of host data to the device a block that wait for the stream to
drain: the program's upload counters (utils/profiling.HOST_UPLOADS) over
the blocks whose device part it ran, since the program was loaded."""

from yardstick.program import loaded_profiling


def read(s):
    prof = loaded_profiling()
    blocks = prof.COUNTS.get("driver/blocks") if prof else None
    if not blocks:
        return None
    return sum(getattr(prof, "HOST_UPLOADS", {}).values()) / blocks
