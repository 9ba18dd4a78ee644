"""Kernel K4: the collapsed-backtrack Fano walk, and its plain version.

Replaces the TPU kernel ``kernel`` inside ``_fano_walk_pallas``
(isee3_decoder_tpu/ops/fano_pallas.py:106, entry ``fano_decode_pallas``);
CUDA source csrc/fano.cu.  The plain version is the JAX package's
lockstep walk (``ops/fano._fano_decode_packed``) in PyTorch: every lane
makes one micro-step per loop iteration, a violating lane resolves its
whole backtrack run in the same step through two masked reductions over
a dense (gamma << 1) | ibr mirror of the tape.

Both take the per-lane root setup computed by ops/fano.py:
  metrics4 (B, N, 4) int32 branch metrics per node,
  regs (B, 5) int32 [tm0, tm1, enc, done, tailbits],
and return (bits (B, N) uint8 — node bits up to the final np, 0 above —
and stats (B, 4) int32 [np, gamma, cycles, t]).
"""

from __future__ import annotations

import torch

from isee3_decoder_tpu_torch import _kernels
from isee3_decoder_tpu_torch.config import CodeSpec
from isee3_decoder_tpu_torch.ops.fano import _makesyms


def _sel4(m4: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    return m4.gather(1, s[:, None].to(torch.int64))[:, 0]


def fano_walk_plain(
    metrics4: torch.Tensor,
    regs: torch.Tensor,
    code: CodeSpec,
    delta: int,
    maxcycles: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K4 (the JAX package's packed lockstep walk)."""
    B, N, _ = metrics4.shape
    dev = metrics4.device
    kb = code.kbits
    tail_start = N - (code.k - 1)
    max_total = maxcycles * N
    encmask = (1 << kb) - 1
    i32 = dict(dtype=torch.int32, device=dev)

    tm0, tm1, enc = regs[:, 0].clone(), regs[:, 1].clone(), regs[:, 2].clone()
    done = regs[:, 3] != 0
    tailbits = regs[:, 4]
    np_idx = torch.zeros(B, **i32)
    t = torch.zeros(B, **i32)
    cycles = torch.zeros(B, **i32)
    g = torch.zeros(B, **i32)
    ibr = torch.zeros(B, **i32)
    # push-down tape (B, N+1, 4): gamma, tm0, tm1, (ibr << kb) | enc, plus
    # a dump node N that lanes not advancing write; D = (gamma << 1) | ibr
    S = torch.zeros((B, N + 1, 4), **i32)
    D = torch.zeros((B, N + 1), **i32)
    node_j = torch.arange(N + 1, **i32)[None, :]
    lanes = torch.arange(B, device=dev)
    m4 = metrics4.to(torch.int32)

    while not bool(done.all()):
        active = ~done
        new_np = np_idx + 1

        # ---------- forward look (fano.c:117-166) ----------
        ngamma = g + torch.where(ibr == 0, tm0, tm1)
        ok = ngamma >= t
        tighten = ok & (g < t + delta)
        t_fwd = torch.where(
            tighten, t + delta * torch.div(ngamma - t, delta, rounding_mode="floor"), t
        )
        at_last = np_idx == N - 1
        newly_done = active & ok & at_last
        advance = active & ok & ~at_last
        violate = active & ~ok

        # ---------- pop-run collapse (fano.c:169-188) ----------
        below = node_j < np_idx[:, None]
        jr = torch.where(below & (D < (t << 1)[:, None]), node_j, -1).amax(1)
        jt = torch.where(
            below & (node_j < tail_start) & ((D & 1) == 0), node_j, -1
        ).amax(1)
        do_toggle = violate & (jt > jr)
        do_relax = violate & ~(jt > jr)
        target = torch.where(do_toggle, jt, jr + 1)
        from_regs = do_relax & (target == np_idx)

        rec = S[lanes, target.clamp(0, N - 1).to(torch.int64)]  # (B, 4)
        base_g = torch.where(from_regs, g, rec[:, 0])
        base_tm0 = torch.where(from_regs, tm0, rec[:, 1])
        base_tm1 = torch.where(from_regs, tm1, rec[:, 2])
        base_enc = torch.where(from_regs, enc, rec[:, 3] & encmask)
        base_ibr = torch.where(from_regs, ibr, rec[:, 3] >> kb)

        # ---------- advance: the next node's freshly sorted record ----------
        nm = m4[lanes, new_np.clamp(0, N - 1).to(torch.int64)]  # (B, 4)
        adv_enc = (enc << 1) & encmask
        lsym = _makesyms(adv_enc, code)
        in_tail = new_np >= tail_start
        tbit = (tailbits >> (N - new_np - 1).clamp(0, 31)) & 1
        tail_tm0 = _sel4(nm, (tbit * 3) ^ lsym)
        a0 = _sel4(nm, lsym)
        a1 = _sel4(nm, 3 ^ lsym)
        better1 = a1 >= a0
        adv_tm0 = torch.where(in_tail, tail_tm0, torch.where(better1, a1, a0))
        adv_tm1 = torch.where(in_tail, tail_tm0, torch.where(better1, a0, a1))
        adv_bit = torch.where(in_tail, tbit, better1.to(torch.int32))

        # ---------- push (before the registers change) ----------
        slot = torch.where(advance, np_idx, N).to(torch.int64)
        S[lanes, slot] = torch.stack([g, tm0, tm1, (ibr << kb) | enc], dim=1)
        D[lanes, slot] = (g << 1) | ibr

        # ---------- merge updates ----------
        np_next = torch.where(advance, new_np, torch.where(violate, target, np_idx))
        t_next = torch.where(
            active & ok, t_fwd, torch.where(do_relax, t - delta, t)
        )
        cycles = cycles + active.to(torch.int32)
        done_next = done | newly_done
        done_next = done_next | (~done_next & active & (cycles >= max_total))

        g_next = torch.where(advance, ngamma, torch.where(violate, base_g, g))
        tm0 = torch.where(advance, adv_tm0, torch.where(violate, base_tm0, tm0))
        tm1 = torch.where(advance, adv_tm1, torch.where(violate, base_tm1, tm1))
        enc = torch.where(
            advance,
            adv_enc | adv_bit,
            torch.where(
                do_toggle,
                base_enc ^ 1,
                torch.where(do_relax, base_enc ^ (base_ibr != 0).to(torch.int32), enc),
            ),
        )
        ibr = torch.where(
            advance, 0, torch.where(do_toggle, base_ibr + 1,
                                    torch.where(do_relax, 0, ibr))
        ).to(torch.int32)
        g, np_idx, t, done = g_next, np_next, t_next, done_next

    node = torch.arange(N, **i32)[None, :]
    bits = torch.where(
        node < np_idx[:, None],
        S[:, :N, 3] & 1,
        torch.where(node == np_idx[:, None], (enc & 1)[:, None], 0),
    ).to(torch.uint8)
    stats = torch.stack([np_idx, g, cycles, t], dim=1)
    return bits, stats


def fano_walk(
    metrics4: torch.Tensor,
    regs: torch.Tensor,
    code: CodeSpec,
    delta: int,
    maxcycles: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """K4: the whole Fano walk, one CUDA thread per lane."""
    if not _kernels.use_kernel(metrics4):
        _kernels.note_backend("fano", "torch")
        return fano_walk_plain(metrics4, regs, code, delta, maxcycles)
    if metrics4.dtype != torch.int32 or metrics4.ndim != 3 or metrics4.shape[2] != 4:
        raise ValueError("metrics4 must be (B, N, 4) int32")
    B, N, _ = metrics4.shape
    if (regs.dtype != torch.int32 or tuple(regs.shape) != (B, 5)
            or regs.device != metrics4.device):
        raise ValueError("regs must be (B, 5) int32 on metrics4's device")
    if not (metrics4.is_contiguous() and regs.is_contiguous()):
        raise ValueError("metrics4 and regs must be contiguous")
    if code.kbits + 1 >= 31:
        raise ValueError(f"{code.name}: the packed walk carries < 30 state bits")
    if B < 1 or N < code.k or maxcycles * N >= 2**31:
        raise ValueError(f"unsupported lanes={B} nbits={N} maxcycles={maxcycles}")
    dev = metrics4.device
    tape = torch.empty((B, N + 1, 4), dtype=torch.int32, device=dev)
    bits = torch.empty((B, N), dtype=torch.uint8, device=dev)
    stats = torch.empty((B, 4), dtype=torch.int32, device=dev)
    err = _kernels.lib().fano_walk_launch(
        metrics4.data_ptr(), regs.data_ptr(), B, N, N - (code.k - 1),
        code.kbits, delta, maxcycles * N, code.poly1, code.poly2,
        code.g1flip, code.g2flip, tape.data_ptr(), bits.data_ptr(),
        stats.data_ptr(), _kernels.stream_ptr(dev),
    )
    _kernels.check(err, "fano_walk_launch")
    _kernels.count_launch("fano_walk")
    _kernels.note_backend("fano", "cuda")
    return bits, stats
