"""Plain soft-decision Fano sequential decoder (fano.c), one frame at a
time in Python integers.

The reference's loop: look forward along the better branch while the
path metric stays above the threshold (tightening the threshold on a
node's first visit), otherwise back up to the last node whose other
branch is untried and above the threshold, or relax the threshold by
delta where none is.  The encoder starts from a known state, the last
K-1 nodes are forced to the known tail bits, and the walk gives up
after ``maxcycles`` looks a bit.  Ties between the two branches take
the 1-branch first (the reference's ``m0 > m1``).
"""

from __future__ import annotations

from reference.codec import CodeSpec, parity


def fano_frame(symbols: bytes, mettab, nbits: int, encstate: int, tailbits: int,
               code: CodeSpec, delta: int, maxcycles: int):
    """One frame of 2·nbits soft symbols → (bits list of nbits, goodbits,
    cycles).  goodbits == nbits on success; a frame that timed out keeps
    the first goodbits//8 whole bytes of its path, the rest zero."""
    m0t, m1t = mettab
    metrics = []
    for j in range(nbits):
        a, b = symbols[2 * j], symbols[2 * j + 1]
        metrics.append((m0t[a] + m0t[b], m0t[a] + m1t[b],
                        m1t[a] + m0t[b], m1t[a] + m1t[b]))
    encmask = (1 << code.kbits) - 1
    tail_start = nbits - (code.k - 1)
    p1, p2, f1, f2 = code.poly1, code.poly2, code.g1flip, code.g2flip

    def lsym(e: int) -> int:
        return (((p1 & e).bit_count() & 1) << 1 ^ f1) | (((p2 & e).bit_count() & 1) ^ f2)

    gamma = [0] * nbits
    tm0 = [0] * nbits
    tm1 = [0] * nbits
    enc = [0] * nbits
    br = [0] * nbits  # 0: the better branch is in use, 1: the other

    def setup(j: int, e: int) -> None:
        ls = lsym(e)
        m = metrics[j]
        if j >= tail_start:
            tb = (tailbits >> (nbits - j - 1)) & 1
            tm0[j] = tm1[j] = m[(tb * 3) ^ ls]
            enc[j] = e | tb
        else:
            a0, a1 = m[ls], m[3 ^ ls]
            if a1 >= a0:
                tm0[j], tm1[j], enc[j] = a1, a0, e | 1
            else:
                tm0[j], tm1[j], enc[j] = a0, a1, e
        br[j] = 0

    setup(0, (encstate << 1) & encmask)
    np_, t, cycles = 0, 0, 0
    total = maxcycles * nbits
    done = False
    while True:
        cycles += 1
        ngamma = gamma[np_] + (tm1[np_] if br[np_] else tm0[np_])
        if ngamma >= t:
            if gamma[np_] < t + delta:
                t += delta * ((ngamma - t) // delta)
            if np_ == nbits - 1:
                done = True
                break
            np_ += 1
            gamma[np_] = ngamma
            setup(np_, (enc[np_ - 1] << 1) & encmask)
        else:
            while True:
                if np_ == 0 or gamma[np_ - 1] < t:
                    t -= delta
                    if br[np_]:
                        br[np_] = 0
                        enc[np_] ^= 1
                    break
                np_ -= 1
                if np_ < tail_start and br[np_] != 1:
                    br[np_] = 1
                    enc[np_] ^= 1
                    break
        if cycles >= total:
            break
    goodbits = nbits if done else np_ + 1
    keep = (goodbits // 8) * 8
    bits = [(enc[j] & 1) if j < keep and j <= np_ else 0 for j in range(nbits)]
    return bits, goodbits, cycles
