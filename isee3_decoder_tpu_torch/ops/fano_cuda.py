"""Kernel K4: the collapsed-backtrack Fano walk, and its plain version.

Replaces the TPU kernel ``kernel`` inside ``_fano_walk_pallas``
(isee3_decoder_tpu/ops/fano_pallas.py:106, entry ``fano_decode_pallas``);
CUDA source csrc/fano.cu, in the design ``fano_walk_plan`` picks on
shape: ``"warp"`` (one warp per lane, its metrics and tape in shared
memory) wherever a lane fits there, ``"thread"`` (one thread per lane,
the tape in global memory) for longer lanes.  The plain version is the
JAX package's lockstep walk (``ops/fano._fano_decode_packed``) in
PyTorch: every lane makes one micro-step per loop iteration, a violating
lane resolves its whole backtrack run in the same step through two
masked reductions over a dense (gamma << 1) | ibr mirror of the tape.

The wide variant (``fano_walk_wide``, codes of 30 to 60 state bits:
MCQLI32 ... J60) is the same kernel source instantiated with a 64-bit
state word (``"warp64"`` / ``"thread64"``); it replaces no Pallas
kernel but the JAX package's XLA wide walk ``_fano_decode_wide``
(isee3_decoder_tpu/ops/fano.py:528), whose lockstep loop
``fano_walk_wide_plain`` ports as its plain version: one backtrack step
per micro-step, as the JAX walk takes them.  Both walks count one cycle
per forward look, so the collapsed kernel and the step-by-step plain
version end in the same [np, gamma, cycles, t].

Both take the per-lane root setup computed by ops/fano.py:
  metrics4 (B, N, 4) int32 branch metrics per node,
  regs (B, 5) [tm0, tm1, enc, done, tailbits], int32 (packed) or int64
    (wide),
and return (bits (B, N) uint8 — node bits up to the final np, 0 above —
and stats (B, 4) int32 [np, gamma, cycles, t]).
"""

from __future__ import annotations

import torch

from isee3_decoder_tpu_torch import _kernels
from isee3_decoder_tpu_torch.config import CodeSpec
from isee3_decoder_tpu_torch.ops.fano import _makesyms, is_wide


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


#: micro-steps the wide plain walk takes between two reads of "all lanes
#: done" (a done lane's registers and tape stay as they are, so extra
#: steps change nothing; the JAX walk unrolls its loop body alike)
WIDE_PLAIN_STEPS = 16


def fano_walk_wide_plain(
    metrics4: torch.Tensor,
    regs: torch.Tensor,
    code: CodeSpec,
    delta: int,
    maxcycles: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K4's wide variant: the JAX package's wide walk
    (ops/fano._fano_decode_wide, fano.py:528-797) in PyTorch, with the
    encoder state in one int64 word where JAX splits it into two int32
    words (torch has int64, and kbits <= 60).  Every lane makes one
    micro-step per iteration: a forward look, or ONE backtrack step
    (fano.c:169-188); ``cycles`` counts forward looks only (JAX :723).
    regs (B, 5) int64 [tm0, tm1, enc, done, tailbits]."""
    B, N, _ = metrics4.shape
    dev = metrics4.device
    kb = code.kbits
    if kb > 60:
        raise ValueError(f"{code.name}: the wide walk carries at most 60 "
                         "encoder bits")
    tail_start = N - (code.k - 1)
    max_total = maxcycles * N
    encmask = (1 << kb) - 1
    i32 = dict(dtype=torch.int32, device=dev)

    tm0, tm1 = regs[:, 0].to(torch.int32), regs[:, 1].to(torch.int32)
    enc = regs[:, 2].to(torch.int64)
    done = regs[:, 3] != 0
    tail = regs[:, 4].to(torch.int64)
    np_idx = torch.zeros(B, **i32)
    t = torch.zeros(B, **i32)
    cycles = torch.zeros(B, **i32)
    mode = torch.zeros(B, **i32)  # 0 forward, 1 backtracking
    g = torch.zeros(B, **i32)
    ibr = torch.zeros(B, **i32)
    # push-down tape: (B, N+1, 4) int32 [gamma, tm0, tm1, ibr] and the
    # (B, N+1) int64 encoder states; node N is the dump slot that lanes
    # not advancing write
    S = torch.zeros((B, N + 1, 4), **i32)
    E = torch.zeros((B, N + 1), dtype=torch.int64, device=dev)
    lanes = torch.arange(B, device=dev)
    m4 = metrics4.to(torch.int32)

    def step():
        nonlocal np_idx, t, cycles, mode, done, g, tm0, tm1, enc, ibr
        fwd = (mode == 0) & ~done
        bwd = (mode == 1) & ~done
        back_np = np_idx - 1
        back_c = back_np.clamp(min=0).to(torch.int64)
        new_np = np_idx + 1
        rec = S[lanes, back_c]  # backtrack lanes: the record below
        g_prev, tm0_b, tm1_b, back_ibr = rec.unbind(1)
        enc_back = E[lanes, back_c]
        nm = m4[lanes, new_np.clamp(max=N - 1).to(torch.int64)]  # forward

        # ---------- forward look (fano.c:117-166) ----------
        ngamma = g + torch.where(ibr == 0, tm0, tm1)
        ok = ngamma >= t
        tighten = ok & (g < t + delta)
        t_fwd = torch.where(
            tighten, t + delta * torch.div(ngamma - t, delta, rounding_mode="floor"), t
        )
        at_last = np_idx == N - 1
        newly_done = fwd & ok & at_last
        advance = fwd & ok & ~at_last

        adv_enc = (enc << 1) & encmask
        lsym = _makesyms(adv_enc, code)
        # tail zone (fano.c:141-147): tail bit j up to 58, one int64 shift
        in_tail = new_np >= tail_start
        j = (N - new_np - 1).clamp(0, 63).to(torch.int64)
        tbit = (tail >> j) & 1
        tail_tm0 = _sel4(nm, (tbit * 3) ^ lsym)
        a0 = _sel4(nm, lsym)
        a1 = _sel4(nm, 3 ^ lsym)
        better1 = a1 >= a0
        adv_tm0 = torch.where(in_tail, tail_tm0, torch.where(better1, a1, a0))
        adv_tm1 = torch.where(in_tail, tail_tm0, torch.where(better1, a0, a1))
        adv_bit = torch.where(in_tail, tbit, better1.to(torch.int64))
        to_bwd = fwd & ~ok

        # ---------- one backtrack step (fano.c:169-188) ----------
        cant_back = (np_idx == 0) | (g_prev < t)
        relax = bwd & cant_back
        stepback = bwd & ~cant_back
        toggle = stepback & (back_np < tail_start) & (back_ibr != 1)
        relax_flip = relax & (ibr != 0)

        # ---------- push (before the registers change) ----------
        slot = torch.where(advance, np_idx, N).to(torch.int64)
        S[lanes, slot] = torch.stack([g, tm0, tm1, ibr], dim=1)
        E[lanes, slot] = enc

        # ---------- merge updates ----------
        np_next = torch.where(advance, new_np,
                              torch.where(stepback, back_np, np_idx))
        t_next = torch.where(fwd & ok, t_fwd, torch.where(relax, t - delta, t))
        mode_next = torch.where(to_bwd, 1,
                                torch.where(relax | toggle, 0, mode))
        done_next = done | newly_done
        cycles = cycles + fwd.to(torch.int32)
        done_next = done_next | (
            ~done_next & (cycles >= max_total) & (mode_next == 0))
        g_next = torch.where(advance, ngamma,
                             torch.where(stepback, g_prev, g))
        tm0 = torch.where(advance, adv_tm0, torch.where(stepback, tm0_b, tm0))
        tm1 = torch.where(advance, adv_tm1, torch.where(stepback, tm1_b, tm1))
        enc = torch.where(
            advance, adv_enc | adv_bit,
            torch.where(toggle, enc_back ^ 1,
                        torch.where(stepback, enc_back,
                                    torch.where(relax_flip, enc ^ 1, enc))))
        ibr = torch.where(
            advance, 0,
            torch.where(toggle, back_ibr + 1,
                        torch.where(stepback, back_ibr,
                                    torch.where(relax, 0, ibr)))).to(torch.int32)
        g, np_idx, t, mode, done = g_next, np_next, t_next, mode_next, done_next

    while not bool(done.all()):
        for _ in range(WIDE_PLAIN_STEPS):
            step()

    node = torch.arange(N, **i32)[None, :]
    bits = torch.where(
        node < np_idx[:, None],
        E[:, :N] & 1,
        torch.where(node == np_idx[:, None], (enc & 1)[:, None], 0),
    ).to(torch.uint8)
    stats = torch.stack([np_idx, g, cycles, t], dim=1)
    return bits, stats


#: shared memory one block may take on the H100 (above 48 KB only as
#: dynamic shared memory, after cudaFuncSetAttribute)
SMEM_MAX = 232_448
#: lanes a block of the "thread" design walks, one a thread
THREAD_LANES = 32
#: the most warps (lanes) a block of the "warp" design takes
WARP_LANES_MAX = 32
#: SMs of an H100 SXM, the plan's default
NUM_SMS = 132


#: bytes of one tape record of K4: the packed walk's int4 {gamma, tm0,
#: tm1, (ibr << kb) | enc}; the wide variant's {gamma, tm0, tm1, pad,
#: 64-bit (ibr << kb) | enc}
RECORD_BYTES = 16
WIDE_RECORD_BYTES = 24


def lane_bytes(N: int, rec_bytes: int) -> int:
    """Shared memory of one lane of the "warp" design: N int4 metric
    records and N + 1 tape records, rounded up to 16 bytes so the next
    lane's metrics stay 16-byte aligned; (2N + 1) x 16 for 16-byte
    records."""
    return -(-(16 * N + rec_bytes * (N + 1)) // 16) * 16


def fano_walk_plan(B: int, N: int, code: CodeSpec, maxcycles: int,
                   design: str | None = None, sms: int = NUM_SMS,
                   rec_bytes: int = RECORD_BYTES) -> dict:
    """K4's launch plan (csrc/fano.cu ``fano_walk_launch``, and
    ``fano_walk_wide_launch`` for the wide variant) for B lanes of N
    nodes, chosen on shape:

    - ``"warp"`` when one lane's branch metrics (N int4 records) and tape
      (N + 1 records of ``rec_bytes``) fit in one block's shared memory,
      ``lane_bytes(N, rec_bytes)``: (2N + 1) x 16 bytes on the packed walk
      (N up to 7263; the main path's frames are N = 1024, 32 KB), 40N +
      24 rounded to 16 on the wide one (N up to 5810; 40 KB at N =
      1024): one warp walks one lane, ``lanes`` warps a block, as many
      as spread the B lanes evenly over ``sms`` SMs (at most what shared
      memory and 1024 threads allow), so no SM holds more lanes than it
      must;
    - ``"thread"`` otherwise (e.g. hybridtest's long frames): one thread
      walks one lane, 32 lanes a block, its tape in global memory.

    ``design`` pins one of the two, for checks that hold both against the
    plain version; "warp" raises where a lane does not fit.
    ``rec_bytes`` is 16 for the packed walk, 24 for the wide variant.
    Returns
    ``design``, ``lanes`` (lanes a block), ``threads``, ``grid`` and
    ``smem`` (dynamic shared bytes a block).  Lane b is
    warp (or thread) b % lanes of block b // lanes.  Raises ValueError
    on what K4 does not take: B < 1, N < K, maxcycles * N >= 2^31 (the
    cycle count is int32), codes of more than 60 state bits, and a wide
    code (30 or more state bits) on 16-byte records."""
    if rec_bytes not in (RECORD_BYTES, WIDE_RECORD_BYTES):
        raise ValueError(f"K4 records are 16 or 24 bytes, not {rec_bytes}")
    if rec_bytes == RECORD_BYTES and is_wide(code):
        raise ValueError(f"{code.name}: the packed walk carries < 30 state bits")
    if code.kbits > 60:
        raise ValueError(f"{code.name}: the wide walk carries at most 60 "
                         "state bits")
    if B < 1 or N < code.k or maxcycles * N >= 2**31:
        raise ValueError(f"unsupported lanes={B} nbits={N} maxcycles={maxcycles}")
    lane_smem = lane_bytes(N, rec_bytes)
    if design is None:
        design = "warp" if lane_smem <= SMEM_MAX else "thread"
    if design == "thread":
        return {"design": "thread", "lanes": THREAD_LANES,
                "threads": THREAD_LANES, "grid": -(-B // THREAD_LANES),
                "smem": 0}
    if design != "warp":
        raise ValueError(f"unknown K4 design {design!r}")
    if lane_smem > SMEM_MAX:
        raise ValueError(f"nbits={N}: a lane's metrics and tape, {lane_smem} "
                         f"bytes, exceed one block's shared memory")
    lanes = max(1, min(-(-B // sms), SMEM_MAX // lane_smem, WARP_LANES_MAX))
    return {"design": "warp", "lanes": lanes, "threads": 32 * lanes,
            "grid": -(-B // lanes), "smem": lanes * lane_smem}


def fano_walk(
    metrics4: torch.Tensor,
    regs: torch.Tensor,
    code: CodeSpec,
    delta: int,
    maxcycles: int,
    design: str | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """K4: the whole Fano walk, in the design ``fano_walk_plan`` picks for
    the shape (recorded in ``_kernels.backend_used["fano_walk"]``).
    ``design`` pins one, for checks against the plain version only."""
    if not _kernels.use_kernel(metrics4):
        _kernels.note_backend("fano", "torch")
        return fano_walk_plain(metrics4, regs, code, delta, maxcycles)
    return _launch(metrics4, regs, code, delta, maxcycles, design, wide=False)


def fano_walk_wide(
    metrics4: torch.Tensor,
    regs: torch.Tensor,
    code: CodeSpec,
    delta: int,
    maxcycles: int,
    design: str | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """K4's wide variant: the whole Fano walk with a 64-bit state word,
    for codes of 30 to 60 state bits, regs (B, 5) int64.  Counts as a
    ``fano_walk`` launch; ``_kernels.backend_used["fano_walk"]`` reads
    ``"warp64"`` or ``"thread64"``.  ``design`` ("warp" or "thread")
    pins one, for checks against the plain version only."""
    if not _kernels.use_kernel(metrics4):
        _kernels.note_backend("fano", "torch")
        return fano_walk_wide_plain(metrics4, regs, code, delta, maxcycles)
    return _launch(metrics4, regs, code, delta, maxcycles, design, wide=True)


def _launch(metrics4: torch.Tensor, regs: torch.Tensor, code: CodeSpec,
            delta: int, maxcycles: int, design: str | None,
            wide: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """One launch of K4 (``fano_walk_launch``) or of its wide variant
    (``fano_walk_wide_launch``: int64 regs, 24-byte records)."""
    word = torch.int64 if wide else torch.int32
    if metrics4.dtype != torch.int32 or metrics4.ndim != 3 or metrics4.shape[2] != 4:
        raise ValueError("metrics4 must be (B, N, 4) int32")
    B, N, _ = metrics4.shape
    if (regs.dtype != word or tuple(regs.shape) != (B, 5)
            or regs.device != metrics4.device):
        raise ValueError(f"regs must be (B, 5) {word} on metrics4's device")
    if not (metrics4.is_contiguous() and regs.is_contiguous()):
        raise ValueError("metrics4 and regs must be contiguous")
    if delta < 1:
        raise ValueError(f"delta = {delta} must be positive")
    dev = metrics4.device
    rec_bytes = WIDE_RECORD_BYTES if wide else RECORD_BYTES
    plan = fano_walk_plan(
        B, N, code, maxcycles, design,
        torch.cuda.get_device_properties(dev).multi_processor_count,
        rec_bytes)
    warp = plan["design"] == "warp"
    tape = (None if warp else torch.empty((B, (N + 1) * rec_bytes),
                                          dtype=torch.uint8, device=dev))
    bits = torch.empty((B, N), dtype=torch.uint8, device=dev)
    stats = torch.empty((B, 4), dtype=torch.int32, device=dev)
    name = "fano_walk_wide_launch" if wide else "fano_walk_launch"
    err = getattr(_kernels.lib(), name)(
        metrics4.data_ptr(), regs.data_ptr(), B, N, N - (code.k - 1),
        code.kbits, delta, maxcycles * N, code.poly1, code.poly2,
        code.g1flip, code.g2flip, plan["lanes"] if warp else 0, plan["smem"],
        None if warp else tape.data_ptr(), bits.data_ptr(), stats.data_ptr(),
        _kernels.stream_ptr(dev),
    )
    _kernels.check(err, name)
    _kernels.count_launch("fano_walk")
    _kernels.note_backend("fano", "cuda")
    _kernels.note_backend("fano_walk", plan["design"] + ("64" if wide else ""))
    return bits, stats
