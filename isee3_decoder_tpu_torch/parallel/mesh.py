"""Device mesh helpers (the port of isee3_decoder_tpu/parallel/mesh.py).

The reference's only parallelism is OS pipes and SSE lanes; here the
structure is explicit: a 2-axis mesh with ``ch`` (channels — data
parallel demod and decode) and ``state`` (the 2^(K-1) Viterbi state
lattice — its ACS split across devices, parallel/viterbi_sharded.py).

A ``Mesh`` is an (ch, state) array of ``torch.device``s.  A device may
appear more than once: a mesh of ``[cuda:0] * 4`` has four logical
shards on one card, which exercises the partitioning, the exchange and
the stitch exactly as four cards would (the JAX package's tests do the
same with forced host devices).  Shards run one after another.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

AXES = ("ch", "state")


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """An (ch, state) grid of devices; ``shape`` maps axis name → size,
    as a JAX mesh's does."""

    devices: np.ndarray  # (ch, state) object array of torch.device

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(AXES, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)


def make_mesh(
    n_channels_axis: int | None = None,
    n_state_axis: int = 1,
    devices: list | None = None,
) -> Mesh:
    """Create a (ch, state) mesh over ``devices`` (default: every CUDA
    device of this process; raises when there is none).  The first
    ``n_channels_axis * n_state_axis`` devices fill the grid row by row;
    ``n_channels_axis`` defaults to as many rows as the devices fill."""
    if devices is None:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if n == 0:
            raise RuntimeError("no CUDA device: pass devices=[...] (e.g. "
                               "[torch.device('cpu')] * 8) to build a mesh")
        devices = [torch.device("cuda", i) for i in range(n)]
    devices = [torch.device(d) for d in devices]
    if n_state_axis < 1:
        raise ValueError(f"n_state_axis = {n_state_axis} must be positive")
    if n_channels_axis is None:
        n_channels_axis = len(devices) // n_state_axis
    if n_channels_axis < 1 or n_channels_axis * n_state_axis > len(devices):
        raise ValueError(f"a {n_channels_axis} x {n_state_axis} mesh needs "
                         f"more than {len(devices)} devices")
    grid = np.empty((n_channels_axis, n_state_axis), dtype=object)
    for i, d in enumerate(devices[: n_channels_axis * n_state_axis]):
        grid[i // n_state_axis, i % n_state_axis] = d
    return Mesh(grid)


@dataclasses.dataclass(frozen=True)
class ChannelSharding:
    """The leading (channel) axis split over the mesh's ``ch`` axis, the
    other ``ndim - 1`` axes whole (JAX ``P("ch", None, ...)``)."""

    mesh: Mesh
    ndim: int

    def shards(self, n_channels: int) -> list[tuple[torch.device, slice]]:
        """(device, channel slice) for each row of the mesh: equal
        contiguous blocks; a count the row number does not divide raises,
        as a JAX sharding does."""
        return [(dev, rows) for dev, rows in zip(
            self.mesh.devices[:, 0], channel_blocks(n_channels,
                                                    self.mesh.shape["ch"]))]


def channel_sharding(mesh: Mesh, ndim: int) -> ChannelSharding:
    """Shard the leading (channel) axis, replicate the rest."""
    return ChannelSharding(mesh, ndim)


def channel_blocks(n_channels: int, nshards: int) -> list[slice]:
    """``nshards`` equal contiguous blocks of ``n_channels`` channels."""
    if nshards < 1 or n_channels % nshards:
        raise ValueError(f"{n_channels} channels do not split into "
                         f"{nshards} equal shards")
    per = n_channels // nshards
    return [slice(i * per, (i + 1) * per) for i in range(nshards)]


def init_multihost(
    coordinator: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
) -> None:
    """Join a multi-process world (torch.distributed): gloo without a
    card, nccl with one, ``init_method=f"tcp://{coordinator}"``.  Channel
    data parallelism needs no collectives: rank r owns its contiguous
    block of channels (``process_channels``) and builds its mesh from its
    own devices; the Viterbi state axis stays inside one process's
    devices.  Call this before make_mesh in each process.  Without
    arguments it reads the environment (MASTER_ADDR/PORT, WORLD_SIZE,
    RANK), as torch.distributed does."""
    import torch.distributed as dist

    backend = "nccl" if torch.cuda.is_available() else "gloo"
    kwargs = {}
    if coordinator is not None:
        kwargs["init_method"] = f"tcp://{coordinator}"
    if num_processes is not None:
        kwargs["world_size"] = num_processes
    if process_id is not None:
        kwargs["rank"] = process_id
    dist.init_process_group(backend=backend, **kwargs)


def process_channels(n_channels: int) -> slice:
    """The block of channels this process owns in a multi-process world
    (all of them outside one)."""
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()):
        return slice(0, n_channels)
    return channel_blocks(n_channels, dist.get_world_size())[dist.get_rank()]
