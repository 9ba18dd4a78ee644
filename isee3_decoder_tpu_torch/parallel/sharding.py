"""Channel-axis sharding of the demod/decode pipeline (the port of
isee3_decoder_tpu/parallel/sharding.py).

The per-channel receive chain has no cross-channel data flow, so channel
parallelism is pure data parallelism: each row of the mesh takes an
equal contiguous block of channels, runs the unsharded stage function on
it on its device (under ``torch.cuda.device(dev)``, so the ctypes
launches take that device's stream), and the results are concatenated
on the mesh's first device in the unsharded layout.  Shards run one
after another; overlapping them on distinct cards is not done yet.
"""

from __future__ import annotations

import contextlib

import torch

from isee3_decoder_tpu_torch.config import FRAMEBITS, FRAMESYMBOLS
from isee3_decoder_tpu_torch.models.pipeline import (
    PipelineConfig,
    demod_to_symbols,
    receive_block_device,
)
from isee3_decoder_tpu_torch.parallel.mesh import Mesh, channel_sharding


def on_device(dev: torch.device):
    """The context a shard's calls run in: ``dev`` as the current CUDA
    device, nothing for a CPU device."""
    return (torch.cuda.device(dev) if dev.type == "cuda"
            else contextlib.nullcontext())


def as_rows(x) -> torch.Tensor:
    x = torch.as_tensor(x)
    return x[None, :] if x.ndim == 1 else x


def shard_channels(x, mesh: Mesh) -> list[torch.Tensor]:
    """The leading (channel) axis of ``x`` split into equal row blocks,
    block i on the device of mesh row i; a count the rows do not divide
    raises."""
    x = as_rows(x)
    return [x[rows].to(dev)
            for dev, rows in channel_sharding(mesh, x.ndim).shards(x.shape[0])]


def _first(mesh: Mesh) -> torch.device:
    return mesh.devices.flat[0]


def demod_to_symbols_sharded(
    iq, cfg: PipelineConfig, mesh: Mesh
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Channel-sharded ``demod_to_symbols``: each mesh row demodulates its
    block of channels; soft symbols and baseband are concatenated along
    the channel axis (0), carrier freq and cn0 (T, B) along axis 1, on
    the mesh's first device."""
    outs = []
    for dev, block in zip(mesh.devices[:, 0], shard_channels(iq, mesh)):
        with on_device(dev):
            outs.append(demod_to_symbols(block, cfg))
    first = _first(mesh)
    soft, bb, freq, cn0 = zip(*outs)
    return (torch.cat([s.to(first) for s in soft], 0),
            torch.cat([b.to(first) for b in bb], 0),
            torch.cat([f.to(first) for f in freq], 1),
            torch.cat([c.to(first) for c in cn0], 1))


def merge_block_buffers(bufs: list[torch.Tensor], nchans: list[int],
                        nframes: int) -> torch.Tensor:
    """Channel-block decode buffers (models/decode.decode_block_device
    layout) → the one buffer of all the channels: each section (frame
    bytes, good, decoder, ok, cycles, sync start) concatenated across the
    blocks in channel order."""
    def sections(buf: torch.Tensor, B: int):
        L = B * nframes
        return torch.split(buf, [L * FRAMEBITS // 8, L, L, L, 4 * L, 4 * B])

    parts = [sections(buf, B) for buf, B in zip(bufs, nchans)]
    return torch.cat([sec for group in zip(*parts) for sec in group])


def receive_block_sharded(
    iq,
    nframes: int,
    cfg: PipelineConfig,
    mesh: Mesh,
    npos: int | None = None,
) -> torch.Tensor:
    """Channel-sharded fused receive chain: ``receive_block_device`` on
    each mesh row's block of channels; returns the packed result buffer
    of all the channels on the mesh's first device, byte for byte the
    unsharded one (decode.unpack_block_buffer decodes it)."""
    npos = FRAMESYMBOLS if npos is None else npos
    bufs, nchans = [], []
    for dev, block in zip(mesh.devices[:, 0], shard_channels(iq, mesh)):
        with on_device(dev):
            bufs.append(receive_block_device(block, nframes, npos, cfg))
        nchans.append(block.shape[0])
    first = _first(mesh)
    return merge_block_buffers([b.to(first) for b in bufs], nchans, nframes)
