"""Device-to-host reads a block on the receive chain: the program's read
counters (its utils/profiling.HOST_READS, one a read, by site) over the
blocks whose device part it ran (COUNTS["driver/blocks"]), since the
program was loaded: the warm-up block and every block of the run, each
finished by its host tail."""

from yardstick.program import loaded_profiling


def read(s):
    prof = loaded_profiling()
    blocks = prof.COUNTS.get("driver/blocks") if prof else None
    if not blocks:
        return None
    return sum(prof.HOST_READS.values()) / blocks
