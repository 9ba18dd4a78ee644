"""Multi-device layer of the port: channel sharding, the state-sharded
Viterbi and time sharding over a (ch, state) mesh of torch devices."""

from isee3_decoder_tpu_torch.parallel.mesh import (
    Mesh,
    channel_sharding,
    init_multihost,
    make_mesh,
)
from isee3_decoder_tpu_torch.parallel.sharding import (
    demod_to_symbols_sharded,
    receive_block_sharded,
    shard_channels,
)
from isee3_decoder_tpu_torch.parallel.timeshard import (
    demod_time_sharded,
    plan_time_shards,
    shard_views,
    stitch_shards,
)
from isee3_decoder_tpu_torch.parallel.viterbi_sharded import (
    decode_frame_sharded,
    update_blk_sharded,
)

__all__ = [
    "Mesh",
    "channel_sharding",
    "decode_frame_sharded",
    "demod_time_sharded",
    "demod_to_symbols_sharded",
    "init_multihost",
    "make_mesh",
    "plan_time_shards",
    "receive_block_sharded",
    "shard_channels",
    "shard_views",
    "stitch_shards",
    "update_blk_sharded",
]
