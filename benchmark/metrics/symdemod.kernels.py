"""Device kernels a block launched under the symbol demod's entry
function."""


def read(s):
    return s.per_call(s.layer_kernels.get("symdemod"), "receive_block_device_soft")
