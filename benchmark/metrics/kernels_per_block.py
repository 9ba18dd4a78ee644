"""Device kernels a block, all layers and none: the host tail's over
its calls, the rest over the blocks' device parts."""


def read(s):
    tail = s.layer_kernels.get("host_tail", 0)
    rest = s.per_call(s.kernels - tail or None, "receive_block_device_soft")
    if rest is None:
        return None
    return rest + (s.per_call(tail, "_finish") or 0.0)
