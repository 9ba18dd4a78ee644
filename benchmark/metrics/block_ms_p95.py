"""95th percentile of a block's host time, the driver taking it to
yielding its frames, over the traced run's unprofiled blocks."""

import numpy as np


def read(s):
    if len(s.block_ms) < 20:
        return None
    return float(np.percentile(s.block_ms, 95))
