"""Device ms a block of the kernels launched under the host tail's
entry function, over its calls in the window."""


def read(s):
    return s.per_block_ms("host_tail", "_finish")
