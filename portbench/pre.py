"""The plain reference of the receiver's off-grid pre-resampler, and its
control.

A capture at a rate fs off the 31.25 kHz grid of its M channels lands on
that grid (M x 31250 samples a second) through the fractional polyphase
resampler of the reference front end's role (utils/gmr1_rx_sdr.py:
411-417): L = 32 branches of GNU Radio's firdes.low_pass_2 design (gain
L, rate L, cutoff half the slower side's rate, transition a fifth of the
cutoff, 80 dB, Blackman-Harris window), the ratio M x 31250 / fs = num /
den exact for an integral-Hz fs.  Output n is, as in rrc.py with this
ratio and these taps,

    s[n] = (1 - frac) sum_i b[ip % L, i] x[ip // L - i]
           + frac     sum_i b[(ip + 1) % L, i] x[(ip + 1) // L - i],

ip = floor(n L den / num), frac = (n L den mod num) / num, with x = 0
before the capture's start and past its end.  Computed here in float64
with integer geometry from taps this module designs itself: it shares
nothing with the program.  The control is the same product with both of
its operands (the capture's samples and each output's weights) rounded
to TF32, the precision below the float32 the configuration states.
"""

from __future__ import annotations

from fractions import Fraction

import numpy as np

from . import rrc

ATT_DB = 80.0
GRID = 31250.0


def ratio(fs: float, m: int) -> Fraction:
    """The exact output-over-input rate of an integral-Hz capture."""
    if fs != int(fs):
        raise ValueError(f"an off-grid rate must be integral Hz, not {fs}")
    return Fraction(int(m * GRID), int(fs))


def taps(r: Fraction) -> np.ndarray:
    """firdes.low_pass_2(L, L, c, c / 5, 80 dB, Blackman-Harris) with
    c = min(1, r) / 2, float64 (gr-filter firdes.cc: odd length, the
    window's four terms over n - 1, scaled to a DC gain of L)."""
    ll = rrc.L
    cutoff = 0.5 * min(1.0, float(r))
    ntaps = int(ATT_DB * ll / (22.0 * 0.2 * cutoff)) | 1
    n = np.arange(ntaps)
    m = n - (ntaps - 1) / 2.0
    h = 2.0 * cutoff / ll * np.sinc(2.0 * cutoff / ll * m)
    a = 2 * np.pi * n / (ntaps - 1)
    h *= (0.35875 - 0.48829 * np.cos(a) + 0.14128 * np.cos(2 * a)
          - 0.01168 * np.cos(3 * a))
    return h * ll / h.sum()


def resample(x: np.ndarray, n: np.ndarray, r: Fraction,
             tf32: bool = False) -> np.ndarray:
    """Outputs n (absolute, (N,)) of the capture x (planar (K, 2)
    float32, read only where the outputs reach), complex128.  The
    geometry repeats every num outputs while the input advances den
    samples, so one period's weights serve every output.  With tf32 the
    control: both operands rounded to TF32."""
    k_per, w_per = rrc.weights(np.arange(r.numerator), r,
                               rrc.branches(taps(r)))
    q, phi = np.divmod(np.asarray(n, np.int64), r.numerator)
    w = w_per[phi]
    idx = (k_per[phi] + q * r.denominator)[:, None] \
        - np.arange(w.shape[1])                           # (N, taps + 1)
    ok = (idx >= 0) & (idx < x.shape[0])
    seg = x[np.where(ok, idx, 0)].astype(np.float64)     # (N, taps + 1, 2)
    seg[~ok] = 0.0
    if tf32:
        seg = rrc._tf32(seg).astype(np.float64)
        w = rrc._tf32(w).astype(np.float64)
    return np.einsum("nt,nt->n", seg[..., 0], w) \
        + 1j * np.einsum("nt,nt->n", seg[..., 1], w)


def reader(x: np.ndarray, r: Fraction):
    """read(lo, hi): the resampled samples [lo, hi), complex128 (the
    reader bank.fold takes)."""
    return lambda lo, hi: resample(x, np.arange(lo, hi), r)
