"""Kernel K3: exclusive int32 prefix sum of the pm scan's baseband with
the (T, B, n) → (B, T·n) transpose fused in, and its plain version.

Replaces the TPU kernel ``_kernel`` of isee3_decoder_tpu/ops/
prefix_pallas.py:65 (entries ``prefix_sum_blocks`` and
``prefix_sum_flat``); CUDA source csrc/prefix.cu, ``prefix_tile_kernel``:
tiles along each channel, a decoupled look-back for the carry, launch
plan ``prefix_plan``.  The result is exact: int32 sums wrap exactly as
the JAX package's do, and the symbol demodulator only reads differences.

``tail`` appends that many columns holding each channel's grand total —
an edge extension of the prefix sum (the same values the JAX package's
``symbols.prefix_sum(pad_to=...)`` produces past the last sample), so
the timing search may read past the final sample without a copy.
"""

from __future__ import annotations

import functools

import torch

from isee3_decoder_tpu_torch import _kernels

# csrc/prefix.cu: samples a tile, threads a block, samples a thread, the
# registers a thread may use (__launch_bounds__ asks for three blocks an
# SM), predecessors a look-back round reads
PREFIX_TILE = 8192
PREFIX_THREADS = 512
PREFIX_ITEMS = 16
PREFIX_REGS = 40
PREFIX_LOOKBACK = 32
_SMEM_MAX = 232_448  # bytes of shared memory one block may use on sm_90
_SM_SMEM = 233_472  # bytes of shared memory on one SM; a block reserves 1 KB
_SM_REGS = 65_536
_SM_THREADS = 2048


@functools.lru_cache(maxsize=64)
def prefix_plan(T: int, B: int, n: int, tail: int, sms: int = 132) -> dict:
    """The launch plan of K3 (csrc/prefix.cu ``prefix_tile_kernel``):

    - ``tile`` samples a tile along a channel of L = T·n samples,
      ``tiles_per_row`` = ⌈L / tile⌉ of them, the last one partial when
      tile does not divide L; ``ntiles`` = B · tiles_per_row, handed out
      by ticket k → tile (b, i) = (k % B, k // B);
    - ``threads`` a block, ``items`` samples a thread, ``lookback``
      predecessors a look-back round reads;
    - ``load``: ``"cp.async"`` (16-byte groups, every group of 8 samples
      in one pm block) when n % 8 == 0, else ``"scalar"`` (2-byte loads;
      the launch also takes it for an input that is not 16-byte aligned);
    - ``stages`` = 2 int16 input stages of a tile, an output staging
      buffer of tile + tile/32 words (a pad word after every 32), the warp
      totals, the tile's prefix and total, two tickets: ``smem`` bytes;
      ``blocks_per_sm`` by shared memory, by ``regs`` registers a thread
      and by threads; ``grid`` = min(ntiles, blocks_per_sm · sms)
      persistent blocks;
    - ``workspace`` bytes: the ticket counter (two words) and one 8-byte
      status word a tile;
    - ``row_heads`` / ``row_tails``: per output row, the words a tile
      writes singly before its first 16-byte boundary (every tile of a row
      has its row's head, since tile % 4 == 0) and the words the row's last
      tile writes singly after its last one, for an output that starts on a
      16-byte boundary; the rest go as 16-byte words.

    Raises ValueError for a shape the kernel does not take."""
    L = T * n
    if min(T, B, n) < 1 or tail < 0 or L + tail >= 2**31:
        raise ValueError(f"unsupported shape T={T} B={B} n={n} tail={tail}")
    per_row = -(-L // PREFIX_TILE)
    ntiles = B * per_row
    warps = PREFIX_THREADS // 32
    smem = (2 * 2 * PREFIX_TILE + 4 * (PREFIX_TILE + PREFIX_TILE // 32)
            + 4 * (warps + 4))
    assert smem <= _SMEM_MAX
    blocks = min(_SM_SMEM // (smem + 1024),
                 _SM_REGS // (PREFIX_THREADS * PREFIX_REGS),
                 _SM_THREADS // PREFIX_THREADS)
    grid = min(ntiles, blocks * sms)
    if ntiles + 2 * grid >= 2**31:
        raise ValueError(f"unsupported shape T={T} B={B} n={n} tail={tail}: "
                         f"{ntiles} tiles")
    last = L - (per_row - 1) * PREFIX_TILE
    heads, tails = [], []
    for b in range(B):
        h = (-b * (L + tail)) % 4
        heads.append(min(h, PREFIX_TILE, L))
        tails.append((last - min(h, last)) % 4)
    return {"tile": PREFIX_TILE, "tiles_per_row": per_row, "ntiles": ntiles,
            "threads": PREFIX_THREADS, "items": PREFIX_ITEMS,
            "lookback": PREFIX_LOOKBACK,
            "load": "cp.async" if n % 8 == 0 else "scalar", "stages": 2,
            "smem": smem, "regs": PREFIX_REGS, "blocks_per_sm": blocks,
            "grid": grid, "workspace": 8 * (2 + ntiles),
            "row_heads": tuple(heads), "row_tails": tuple(tails)}


def prefix_sum_blocks_plain(blocks: torch.Tensor, tail: int = 0) -> torch.Tensor:
    """Plain version of K3: (T, B, n) int16 → (B, T·n + tail) int32."""
    T, B, n = blocks.shape
    x = blocks.permute(1, 0, 2).reshape(B, T * n).to(torch.int64)
    inc = torch.cumsum(x, dim=1)
    exc = torch.cat([torch.zeros((B, 1), dtype=torch.int64,
                                 device=blocks.device), inc[:, :-1]], dim=1)
    total = inc[:, -1:].expand(B, tail)
    # int64 → int32 keeps the low 32 bits: two's-complement wraparound
    return torch.cat([exc, total], dim=1).to(torch.int32)


def prefix_sum_blocks(blocks: torch.Tensor, tail: int = 0) -> torch.Tensor:
    """K3: (T, B, n) int16 scan-layout baseband → (B, T·n + tail) int32
    exclusive prefix sum; columns past T·n hold the grand total."""
    if not _kernels.use_kernel(blocks):
        _kernels.note_backend("csum", "torch")
        return prefix_sum_blocks_plain(blocks, tail)
    if blocks.dtype != torch.int16 or blocks.ndim != 3:
        raise ValueError(f"blocks must be (T, B, n) int16, got {blocks.dtype} "
                         f"{tuple(blocks.shape)}")
    if not blocks.is_contiguous():
        raise ValueError("blocks must be contiguous")
    T, B, n = blocks.shape
    plan = prefix_plan(T, B, n, tail)
    out = torch.empty((B, T * n + tail), dtype=torch.int32,
                      device=blocks.device)
    # the ticket counter and the status words; the launch clears them on
    # this stream, and the allocator hands a block to no other stream
    ws = torch.empty(plan["workspace"] // 8, dtype=torch.int64,
                     device=blocks.device)
    err = _kernels.lib().prefix_sum_launch(
        blocks.data_ptr(), T, B, n, tail, out.data_ptr(), ws.data_ptr(),
        plan["tile"], plan["threads"], plan["grid"], plan["smem"],
        _kernels.stream_ptr(blocks.device),
    )
    _kernels.check(err, "prefix_sum_launch")
    _kernels.count_launch("prefix_sum")
    _kernels.note_backend("csum", "cuda")
    return out


def prefix_sum_flat(samples: torch.Tensor) -> torch.Tensor:
    """K3 at the JAX package's second call site: (B, L) int16 → (B, L)
    int32 exclusive prefix sum of each row (one pm block of L samples, no
    tail columns)."""
    return prefix_sum_blocks(samples[None], tail=0)
