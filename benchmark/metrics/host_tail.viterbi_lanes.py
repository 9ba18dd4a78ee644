"""Lanes a host tail sends to the Viterbi fallback: the program's lane
counter (utils/profiling.COUNTS["host_tail/viterbi_lanes"]) over its
host tails (COUNTS["host_tail/calls"]), since the program was loaded."""

from yardstick.program import loaded_profiling


def read(s):
    prof = loaded_profiling()
    calls = prof.COUNTS.get("host_tail/calls") if prof else None
    if not calls:
        return None
    return prof.COUNTS.get("host_tail/viterbi_lanes", 0) / calls
