"""State-sharded Viterbi ACS over a device mesh (the port of
isee3_decoder_tpu/parallel/viterbi_sharded.py).

The 2^(K-1)-state lattice is split across the mesh's ``state`` axis and
the frames across its ``ch`` axis.  With S shards and new-state blocks
B_p = [pM, (p+1)M) (M = 2^(K-1)/S), shard p computes the butterflies i in
[pM/2, (p+1)M/2), which read old states i and i + 2^(K-2): as new-state
indices those live on shards floor(p/2) and S/2 + floor(p/2), and each
shard's block splits into two half-blocks each bound for one shard.  The
exchange after every step is therefore four half-block moves (a de
Bruijn perfect shuffle), where the JAX package makes four ``ppermute``
calls; the step's minimum over the shards takes the place of ``pmin``.

The shard-local butterfly step is plain torch, as the JAX package
computes it in jnp: K10 (ops/viterbi_acs_cuda) computes a whole step,
not a slice of one.  Decisions come out in the port's tape layout,
(nbits, B, 2^(K-1)/32) int32 words in standard state order, so
``ops/viterbi.chainback`` decodes them.  Shards run one after another
(a mesh of one card repeated gives logical shards).
"""

from __future__ import annotations

import torch

from isee3_decoder_tpu_torch.config import DEFAULT_CODE, CodeSpec
from isee3_decoder_tpu_torch.ops import viterbi as vit
from isee3_decoder_tpu_torch.ops.viterbi_acs_cuda import _pack
from isee3_decoder_tpu_torch.parallel.mesh import Mesh, channel_blocks
from isee3_decoder_tpu_torch.parallel.sharding import as_rows, on_device


def _shuffle_perms(S: int) -> tuple[list, list, list, list]:
    """The four half-block moves as (source shard, destination shard)
    pairs: low half to even shards, high half to odd shards, from the
    lower and the upper half of the shards (see the module docstring)."""
    p1 = [(q, 2 * q) for q in range(S // 2)]
    p2 = [(q, 2 * q + 1) for q in range(S // 2)]
    p3 = [(q + S // 2, 2 * q) for q in range(S // 2)]
    p4 = [(q + S // 2, 2 * q + 1) for q in range(S // 2)]
    return p1, p2, p3, p4


def _exchange(blocks: list[torch.Tensor], devs) -> list[torch.Tensor]:
    """New-state metric blocks → each shard's butterfly inputs [low,
    high]: the four moves of ``_shuffle_perms``, chosen on the
    destination's parity as the JAX exchange does."""
    S = len(blocks)
    if S == 1:
        return blocks  # already [states < 2^(K-2), states >= 2^(K-2)]
    half = blocks[0].shape[1] // 2
    low: dict[int, torch.Tensor] = {}
    high: dict[int, torch.Tensor] = {}
    p1, p2, p3, p4 = _shuffle_perms(S)
    for moves, part, dest in ((p1, 0, low), (p2, 1, low), (p3, 0, high),
                              (p4, 1, high)):
        for src, dst in moves:
            dest[dst] = blocks[src][:, part * half:(part + 1) * half]
    return [torch.cat([low[d].to(devs[d]), high[d].to(devs[d])], dim=1)
            for d in range(S)]


def _local_step(inputs: torch.Tensor, sym_t: torch.Tensor, b0: torch.Tensor,
                b1: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """One ACS step on a shard's butterflies: inputs (B, M) = [low,
    high] old metrics, sym_t (B, 2) int32, b0/b1 (M/2,) int32 branch
    bits → (new-state metrics (B, M), decision words (B, M/32) int32)."""
    B, M = inputs.shape
    low, high = inputs[:, : M // 2], inputs[:, M // 2:]
    s0, s1 = sym_t[:, 0:1], sym_t[:, 1:2]
    metric = (s0 + b0 * (255 - 2 * s0)) + (s1 + b1 * (255 - 2 * s1))
    m_metric = 510 - metric
    m0, m3 = low + metric, high + metric
    m1, m2 = high + m_metric, low + m_metric
    new = torch.stack([torch.minimum(m0, m1), torch.minimum(m2, m3)],
                      dim=-1).reshape(B, M)
    dec = torch.stack([m0 > m1, m2 > m3], dim=-1).reshape(B, M)
    return new, _pack(dec)


def _update_row(metrics: torch.Tensor, syms3: torch.Tensor, devs, nbits: int,
                code: CodeSpec) -> tuple[list[torch.Tensor], list[torch.Tensor]]:
    """nbits steps of one mesh row (one block of frames) over its S state
    shards → (each shard's final new-state block, each shard's decision
    words (nbits, B, M/32))."""
    S = len(devs)
    M = code.nstates // S
    b0_np, b1_np = vit.branch_bits(code)
    b0 = [torch.as_tensor(b0_np[p * M // 2:(p + 1) * M // 2]).to(d, torch.int32)
          for p, d in enumerate(devs)]
    b1 = [torch.as_tensor(b1_np[p * M // 2:(p + 1) * M // 2]).to(d, torch.int32)
          for p, d in enumerate(devs)]
    syms = [syms3.to(d) for d in devs]
    B = metrics.shape[0]
    decs = [torch.empty((nbits, B, M // 32), dtype=torch.int32, device=d)
            for d in devs]
    # the initial arrangement: shard p holds new-state block p of the
    # initial metrics and takes its butterfly inputs as after a step
    news = [metrics[:, p * M:(p + 1) * M].to(d) for p, d in enumerate(devs)]
    inputs = _exchange(news, devs)
    for t in range(nbits):
        news, mins = [], []
        for p, d in enumerate(devs):
            with on_device(d):
                new, packed = _local_step(inputs[p], syms[p][:, t], b0[p],
                                          b1[p])
                decs[p][t] = packed
            news.append(new)
            mins.append(new.amin(dim=1, keepdim=True).to(devs[0]))
        gmin = torch.stack(mins).amin(dim=0)  # pmin over the state axis
        news = [n - gmin.to(d) for n, d in zip(news, devs)]
        inputs = _exchange(news, devs)
    return news, decs


def update_blk_sharded(
    metrics,
    syms,
    mesh: Mesh,
    nbits: int,
    code: CodeSpec = DEFAULT_CODE,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Run nbits ACS steps with the metrics split over the mesh's state
    axis and the frames over its ch axis.

    Args:
      metrics: (B, 2^(K-1)) int32 path metrics.
      syms: (B, 2*nbits) uint8 soft symbols.

    Returns (new metrics (B, 2^(K-1)) int32, decisions (nbits, B,
    2^(K-1)/32) int32), both on the mesh's first device.
    """
    S = mesh.shape["state"]
    if code.nstates % (32 * S):
        raise ValueError(f"{code.nstates} states do not split into {S} "
                         "shards of whole decision words")
    metrics = as_rows(metrics).to(torch.int32)
    syms3 = as_rows(syms).to(torch.int32).reshape(-1, nbits, 2)
    first = mesh.devices.flat[0]
    out_m, out_d = [], []
    for r, rows in enumerate(channel_blocks(metrics.shape[0],
                                            mesh.shape["ch"])):
        devs = list(mesh.devices[r])
        news, decs = _update_row(metrics[rows], syms3[rows], devs, nbits, code)
        out_m.append(torch.cat([n.to(first) for n in news], dim=1))
        out_d.append(torch.cat([d.to(first) for d in decs], dim=2))
        del news, decs
    return torch.cat(out_m, dim=0), torch.cat(out_d, dim=1)


def decode_frame_sharded(
    syms,
    mesh: Mesh,
    nbits: int,
    start_state: int = 0,
    end_state: int = 0,
    code: CodeSpec = DEFAULT_CODE,
) -> torch.Tensor:
    """Sharded frame decode: init → sharded ACS → chainback on the mesh's
    first device; (B, nbits) uint8 bits, those of ops/viterbi.decode_frame
    bit for bit."""
    first = mesh.devices.flat[0]
    syms = as_rows(syms).to(first)
    B = syms.shape[0]
    metrics = torch.full((B, code.nstates), vit.START_BIAS, dtype=torch.int32,
                         device=first)
    metrics[:, start_state & code.state_mask] = 0
    new_metrics, decisions = update_blk_sharded(metrics, syms, mesh, nbits,
                                                code)
    state = vit.ViterbiState(
        metrics=new_metrics, decisions=decisions, dp=0,
        renorm=torch.zeros(B, dtype=torch.int32, device=first))
    return vit.chainback(state, nbits, end_state, code)
