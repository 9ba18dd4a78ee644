"""The front end's least time a block (yardstick/roofline.py: the raw
IQ read once, the prefix sum written once, the search's operations)
over its device time a block, in %."""


def read(s):
    ms = s.per_block_ms("front_end")
    if not ms or "front_end" not in s.least_s:
        return None
    return 100.0 * s.least_s["front_end"] * 1e3 / ms
