"""The plain reference of the receiver's per-carrier resampling (the RRC
window product of the ingest step, which makes the streams the block
phase reads from the channel bank), and its control.

Each carrier's stream at 4 samples a symbol is its bank column (2x
oversampled: 62.5 kHz a channel) through GNU Radio's
pfb_arb_resampler_ccf with L = 32 branches and the root-raised-cosine
taps of the reference front end, firdes.root_raised_cosine(32, 32 f_in,
f_sym, 0.35, int(11 * 32 f_in / f_sym)).  Output n sits at up = n L /
ratio on the L-times upsampled grid (ratio = 4 f_sym / f_in = num / den),
ip = floor(up), frac = up - ip, and is

    s[n] = (1 - frac) sum_i b[ip % L, i] y[ip // L - i]
           + frac     sum_i b[(ip + 1) % L, i] y[(ip + 1) // L - i],

with b[p, i] = h[L i + p] and y = 0 before the stream's start.  Computed
here in float64 with integer geometry from taps this module designs
itself: it shares nothing with the program.  The control is the same
product with both of its operands (the bank rows and each output's
weights) rounded to TF32, the precision below the float32 the
configuration states.
"""

from __future__ import annotations

from fractions import Fraction

import numpy as np

L = 32                      # polyphase branches
ALPHA = 0.35                # roll-off
SPAN = 11                   # filter length in symbols


def taps(f_in: float, f_sym: float) -> np.ndarray:
    """firdes.root_raised_cosine(L, L f_in, f_sym, ALPHA, ntaps), float64
    (gr-filter firdes.cc: odd length, scaled to sum to the gain)."""
    ntaps = int(SPAN * L * f_in / f_sym) | 1
    spb = L * f_in / f_sym
    x = np.arange(ntaps) - ntaps // 2
    x1 = np.pi * x / spb
    x2 = 4 * ALPHA * x / spb
    x3 = x2 * x2 - 1
    if np.any(np.abs(x3) < 1e-6):
        raise ValueError("a tap falls on the filter's singular point")
    with np.errstate(divide="ignore", invalid="ignore"):
        num = np.cos((1 + ALPHA) * x1) + np.sin((1 - ALPHA) * x1) / x2
    num[x == 0] = np.cos(0.0) + (1 - ALPHA) * np.pi / (4 * ALPHA)
    h = 4 * ALPHA * num / (x3 * np.pi)
    return h * L / h.sum()


def branches(h: np.ndarray) -> np.ndarray:
    """(L, taps a branch): b[p, i] = h[L i + p], zero-padded."""
    tpb = -(-len(h) // L)
    out = np.zeros(tpb * L)
    out[:len(h)] = h
    return out.reshape(tpb, L).T


def weights(n: np.ndarray, ratio: Fraction,
            b: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(k_hi, w): output n[j] = sum_t w[j, t] y[k_hi[j] - t], t = 0..tpb
    (both branches' taps at each input row, as the program's window
    matrix holds them)."""
    tpb = b.shape[1]
    a = n.astype(np.int64) * L * ratio.denominator
    ip = a // ratio.numerator
    frac = (a % ratio.numerator) / ratio.numerator
    k1, p1 = ip // L, ip % L
    k2, p2 = (ip + 1) // L, (ip + 1) % L
    w = np.zeros((len(n), tpb + 1))
    i = np.arange(tpb)
    rows = np.arange(len(n))[:, None]
    w[rows, i] += frac[:, None] * b[p2]                   # rows k2 - i
    w[rows, (k2 - k1)[:, None] + i] += (1 - frac)[:, None] * b[p1]
    return k2, w


def _tf32(a: np.ndarray) -> np.ndarray:
    """Round float32 values to TF32 (10 mantissa bits), to nearest even."""
    u = np.ascontiguousarray(a, np.float32).view(np.uint32)
    u = (u + np.uint32(0x0FFF) + ((u >> np.uint32(13)) & np.uint32(1))) \
        & np.uint32(0xFFFFE000)
    return u.view(np.float32)


def streams(y: np.ndarray, k0: int, n: np.ndarray, f_in: float,
            f_sym: float, sps: int, tf32: bool = False) -> np.ndarray:
    """Outputs n (absolute, (N,)) of every channel of y (C, K) complex,
    whose column c is the bank row k0 + c.  With tf32 the control: both
    operands rounded to TF32."""
    ratio = Fraction(round(sps * f_sym), round(f_in))
    k_hi, w = weights(n, ratio, branches(taps(f_in, f_sym)))
    t = np.arange(w.shape[1])
    idx = (k_hi - k0)[:, None] - t                        # (N, tpb + 1)
    if idx.min() < 0 or idx.max() >= y.shape[1]:
        raise ValueError("an output reaches past the rows given")
    if tf32:
        y = _tf32(y.real).astype(np.float64) \
            + 1j * _tf32(y.imag).astype(np.float64)
        w = _tf32(w).astype(np.float64)
    return np.einsum("cnt,nt->cn", y[:, idx], w)
