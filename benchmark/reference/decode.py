"""Plain block decode (decode.c:42-289): frame sync, then each frame
through the tiers in order — quicklook, QLEC, Fano, Viterbi.

- sync: the soft correlation of the 34 invariant sync symbols at each
  of a frame's positions, the earliest maximum (decode.c:162-193);
- quicklook: hard(s1)^hard(s2)^1 gives the bits; accepted when
  re-encoding them reproduces every hard decision and the frame ends in
  the syncword (qdecode.c:129-134);
- QLEC: the quicklook bits with the starts of the residual's bursts
  flipped, two rounds, accepted when the residual left is explained by
  the flips and the frame ends in the syncword;
- Fano at ``fano_maxcycles`` looks a bit from the sync state with the
  known tail;
- Viterbi on every frame Fano left undecoded (the persistent-hybrid
  policy of the block decode).

Decoder labels follow decode.c: a frame Fano walked is FANO whether or
not the walk finished, VITERBI once Viterbi decoded it.
"""

from __future__ import annotations

import numpy as np
import torch

from reference.codec import (
    CODES,
    FRAMEBITS,
    FRAMESYMBOLS,
    SYNC_STATE,
    SYNCBITS,
    SYNCWORD,
    bits_to_bytes,
    encode_bits,
    fano_mettab,
    sync_vector,
    verify_frame,
)
from reference.fano import fano_frame
from reference.viterbi import viterbi_frames

NONE, VITERBI, FANO, QUICKLOOK, QLEC = 0, 1, 2, 3, 4

#: frames one Viterbi call decodes together
VITERBI_BATCH = 4


def find_sync(soft: torch.Tensor, npos: int, code) -> torch.Tensor:
    """(B, S) soft symbols → (B,) earliest position of the largest sync
    correlation among the first npos."""
    taps = torch.as_tensor(2 * np.asarray(sync_vector(code)) - 1,
                           dtype=torch.int64, device=soft.device)
    s = soft[:, : npos + SYNCBITS - 1].to(torch.int64) - 128
    win = s.unfold(1, SYNCBITS, 1)[:, :npos]  # (B, npos, SYNCBITS)
    corr = (win * taps).sum(dim=-1)
    top = corr.amax(dim=1, keepdim=True)
    idx = torch.arange(npos, device=soft.device)
    return torch.where(corr == top, idx[None, :], npos).amin(dim=1)


def quicklook(fsyms: torch.Tensor, code):
    L = fsyms.shape[0]
    hard = (fsyms.to(torch.int32) > 128).to(torch.uint8)
    pairs = hard.reshape(L, -1, 2)
    ql = pairs[..., 0] ^ pairs[..., 1] ^ 1  # bit t-1 at pair t
    last = torch.full((L, 1), SYNCWORD & 1, dtype=torch.uint8, device=fsyms.device)
    bits = torch.cat([ql[:, 1:], last], dim=1)
    ok = (encode_bits(bits, SYNC_STATE, code) == hard).all(dim=-1) & verify_frame(bits)
    return bits, ok


def qlec(fsyms: torch.Tensor, bits: torch.Tensor, code, rounds: int = 2):
    L = fsyms.shape[0]
    w = code.k - 1
    hard = (fsyms.to(torch.int32) > 128).to(torch.uint8)

    def pair_bad(b):
        return (encode_bits(b, SYNC_STATE, code) ^ hard).reshape(L, FRAMEBITS, 2).amax(dim=-1)

    def prev_any(pb):
        padded = torch.nn.functional.pad(pb, (w, 0))
        acc = torch.zeros_like(pb)
        for d in range(1, w + 1):
            acc = acc | padded[:, w - d: w - d + FRAMEBITS]
        return acc

    def explained(flips):
        return torch.nn.functional.pad(flips[:, :-1], (1, 0))

    flips = torch.zeros((L, FRAMEBITS), dtype=torch.uint8, device=fsyms.device)
    for _ in range(rounds):
        bad = pair_bad(bits) & (1 - explained(flips))
        start = bad & (1 - prev_any(bad))
        start[:, FRAMEBITS - 1] = 0  # the last bit is the syncword's
        bits = bits ^ start
        flips = flips | start
    left = (pair_bad(bits) & (1 - explained(flips))).sum(dim=-1)
    return bits, (flips.sum(dim=-1) > 0) & (left == 0) & verify_frame(bits)


def decode_block(soft: torch.Tensor, nframes: int, dcfg: dict) -> dict:
    """(B, S) soft symbols → the block's frames, lane order channel-major:
    data (L, 128) uint8, good, decoder, start_symbol, fano_cycles and the
    channels' sync positions."""
    code = CODES[dcfg["code"]]
    B = soft.shape[0]
    dev = soft.device
    ss = find_sync(soft, FRAMESYMBOLS, code)
    starts = (ss[:, None] + SYNCBITS
              + FRAMESYMBOLS * torch.arange(nframes, device=dev)[None, :])
    idx = (starts[..., None] + torch.arange(FRAMESYMBOLS, device=dev)).reshape(B, -1)
    if int(idx.max()) >= soft.shape[1]:
        raise ValueError("a frame runs past the end of the soft symbols")
    fsyms = soft.gather(1, idx).reshape(B * nframes, FRAMESYMBOLS)
    L = fsyms.shape[0]
    bits, ql_ok = quicklook(fsyms, code)
    ec_bits, ec_ok = qlec(fsyms, bits, code)
    ec_ok = ec_ok & ~ql_ok
    bits = torch.where(ec_ok[:, None], ec_bits, bits).cpu().numpy()
    ql_ok, ec_ok = ql_ok.cpu().numpy(), ec_ok.cpu().numpy()
    good = ql_ok | ec_ok
    decoder = np.where(ql_ok, QUICKLOOK, np.where(ec_ok, QLEC, FANO)).astype(np.int32)
    cycles = np.zeros(L, np.int32)
    undecoded = []
    host_syms = fsyms.cpu().numpy()
    mettab = fano_mettab(dcfg["fano_scale"]).tolist()
    tail = SYNCWORD & ((1 << (code.k - 1)) - 1)
    for lane in np.nonzero(~good)[0]:
        fb, goodbits, cyc = fano_frame(bytes(host_syms[lane]), mettab, FRAMEBITS,
                                       SYNC_STATE, tail, code, dcfg["fano_delta"],
                                       dcfg["fano_maxcycles"])
        bits[lane] = fb
        cycles[lane] = cyc
        if goodbits == FRAMEBITS:
            good[lane] = bool(verify_frame(torch.as_tensor(bits[lane])))
        else:
            undecoded.append(lane)
    for lo in range(0, len(undecoded), VITERBI_BATCH):
        lanes = undecoded[lo: lo + VITERBI_BATCH]
        vb = viterbi_frames(fsyms[lanes], FRAMEBITS, SYNC_STATE, SYNC_STATE, code)
        bits[lanes] = vb.cpu().numpy()
        good[lanes] = verify_frame(vb).cpu().numpy()
        decoder[lanes] = VITERBI
    return {
        "data": bits_to_bytes(torch.as_tensor(bits)).numpy(),
        "good": good,
        "decoder": decoder,
        "start_symbol": starts.reshape(-1).cpu().numpy(),
        "fano_cycles": cycles,
        "sync_start": ss.cpu().numpy(),
    }
