"""Device ms a block of the kernels launched under the layer's entry
functions, over the blocks' device parts in the window."""


def read(s):
    return s.per_block_ms("front_end")
