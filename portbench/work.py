"""The yardstick of the kernels: published H100 peaks and the work each
kernel's call needs, counted from shapes (frozen here, so a roofline reads
the same work whatever implements the kernel).  A bound is the least time
the card could take: the larger of the bytes over the memory rate and the
operations over the peak rate of their type.  Each input is counted read
once and each output written once.
"""

from __future__ import annotations

# H100 SXM peaks (NVIDIA's datasheet, dense, at the 700 W limit)
HBM_BPS = 3.35e12
F32_FLOPS = 67e12              # float32 outside the tensor cores
BF16_FLOPS = 989e12            # bf16 in the tensor cores


def bound_s(nbytes: float, nops: float, flops: float = F32_FLOPS) -> float:
    return max(nbytes / HBM_BPS, nops / flops)


def pfb_block(m: int, p: int, rows: int) -> tuple[float, float]:
    """Kernel P, one block: the 2P+1-tap branch filter down `rows` rows of
    the hop-row view (hop = M/2), writing the (rows, 4 hop) activation.
    (bytes, operations)."""
    hop = m // 2
    nbytes = 4 * ((rows + 2 * p) * hop * 2 + 2 * (2 * p + 1) * hop
                  + rows * 4 * hop)
    return float(nbytes), float(rows * hop * 4 * p * 2)


def dft_block(m: int, rows: int) -> tuple[float, float]:
    """The channel DFT, one block: (rows, 2M) float32 activation times the
    (2M, 2M) bf16 table into the (rows, 2M) float32 bank; the activation
    read once, the table once, the bank written once.  (bytes, ops)."""
    k = 2 * m
    return float(4 * rows * k + 2 * k * k + 4 * rows * k), \
        float(2.0 * rows * k * k)


# Viterbi trellises the traffic needs, by burst kind: (steps T, states S,
# outputs a step n, trellises a burst)
TRELLIS = {
    "bcch": (212, 16, 2, 1),      # K5 r1/2, 208 bits + 4 flush
    "ccch": (212, 16, 2, 1),
    "speech": (48, 64, 2, 2),     # K7 r1/2 tail-biting, two AMBE frames
    "facch3": (96, 16, 4, 1),     # K5 r1/4, 92 + 4, once a 4-burst group
    "facch9": (320, 16, 2, 1),    # K5 r1/2, 316 + 4
    "csd": (484, 16, 2, 1),       # K5 r1/2, 480 + 4, 9k6
}


def viterbi(counts: dict) -> tuple[float, float]:
    """Kernel V over bursts {kind: count}: soft symbols in (float32), bits
    and a metric out; two adds and a compare a state a step plus the 2^n
    branch metrics.  (bytes, operations)."""
    nbytes = nops = 0.0
    for kind, cnt in counts.items():
        t, s, n, per = TRELLIS[kind]
        b = cnt * per
        nbytes += b * (t * (4 * n + 1) + 4)
        nops += b * t * (3 * s + 2 * n * 2 ** n)
    return nbytes, nops
